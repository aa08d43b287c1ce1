"""Training (counterpart of ``howl_tpu/training``): the train state, the
objectives (frame cross-entropy and CTC), the train and eval steps for every
model of the zoo, the entry point
``python -m howl_tpu_torch.training.run.train`` with its checkpoints
(``howl_tpu_torch/workspace.py``), the config-driven ``Trainer``
(``howl_tpu_torch/trainer.py``, ``config.py``), the wake-word experiment
harness with its seed sweep on one card or across cards (``training/run/
eval_wake_word_detection.py``, ``parallel/seed_sweep.py``), GSC keyword
pretraining with the commands-recognition protocol (``training/run/
pretrain_gsc.py``, ``eval_commands_recognition.py``), vision pretraining
(``training/run/pretrain.py``) and data parallelism over several cards
(``--num-devices``, ``parallel/data_parallel.py``)."""
