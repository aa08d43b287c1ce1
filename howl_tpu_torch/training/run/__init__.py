"""CLI entry points: ``python -m howl_tpu_torch.training.run.<tool>``
(counterpart of ``howl_tpu/training/run``), every one of the JAX package's:
``train`` (``--num-devices N``: data parallelism over N ranks),
``refactored_train``, ``eval_wake_word_detection`` (and its alias
``run_exp``), ``generate_roc``, ``generate_precise_roc``,
``import_workspace``, GSC pretraining (``pretrain_gsc``,
``eval_commands_recognition``), vision pretraining (``pretrain``), the
exports (``export_honkling``, ``generate_precise_dataset``), the live
``demo`` and the dataset tools of ``generate_dataset.sh``
(``generate_raw_audio_dataset``, ``attach_alignment``,
``stitch_vocab_samples``)."""
