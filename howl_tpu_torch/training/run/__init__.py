"""CLI entry points: ``python -m howl_tpu_torch.training.run.<tool>``
(counterpart of ``howl_tpu/training/run``). Ported: ``train``,
``refactored_train``, ``eval_wake_word_detection`` (and its alias
``run_exp``), ``generate_roc``, ``generate_precise_roc`` and
``import_workspace``. GSC pretraining (``pretrain_gsc``, ``pretrain``,
``eval_commands_recognition``), the dataset tools and the demo wait for
ROADMAP Queue 1, item 12."""
