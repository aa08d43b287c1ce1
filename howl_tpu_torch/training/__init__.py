"""Training (counterpart of ``howl_tpu/training``): the train state, the
objectives (frame cross-entropy and CTC), the train and eval steps for every
model of the zoo, and the entry point
``python -m howl_tpu_torch.training.run.train`` with its checkpoints
(``howl_tpu_torch/workspace.py``). ``trainer.py`` and ``config.py`` wait for
ROADMAP Queue 1, item 14."""
