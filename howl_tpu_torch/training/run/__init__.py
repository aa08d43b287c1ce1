"""CLI entry points: ``python -m howl_tpu_torch.training.run.<tool>``
(counterpart of ``howl_tpu/training/run``). Ported: ``train``,
``refactored_train``, ``eval_wake_word_detection`` (and its alias
``run_exp``), ``generate_roc``, ``generate_precise_roc``,
``import_workspace``, GSC pretraining (``pretrain_gsc``,
``eval_commands_recognition``) and the dataset tools of
``generate_dataset.sh`` (``generate_raw_audio_dataset``,
``attach_alignment``, ``stitch_vocab_samples``). ``pretrain``,
``export_honkling``, ``generate_precise_dataset`` and the demo wait for
ROADMAP Queue 1, item 12."""
