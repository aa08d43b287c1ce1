"""Training (counterpart of ``howl_tpu/training``): the train state, the
objectives, the train and eval steps, and the entry point
``python -m howl_tpu_torch.training.run.train`` with its checkpoints
(``howl_tpu_torch/workspace.py``). CTC and the models other than res8 wait
for ROADMAP Queue 1, item 8; ``trainer.py`` and ``config.py`` for item 14."""
