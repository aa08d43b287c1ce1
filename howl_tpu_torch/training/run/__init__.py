"""CLI entry points: ``python -m howl_tpu_torch.training.run.<tool>``
(counterpart of ``howl_tpu/training/run``). ``train`` and
``import_workspace`` are ported; the other tools wait for ROADMAP Queue 1,
item 12."""
