"""howl_tpu_torch: the PyTorch + CUDA port of howl_tpu, for NVIDIA Hopper.

The JAX package ``howl_tpu`` is the reference this package is held against,
module for module: each module here mirrors the name of its JAX counterpart
(``ops/frontend.py``, ``models/cnn.py``, ``inference/engine.py``, ...).

This package imports ``torch`` and never ``jax``, ``flax`` or ``howl_tpu``.
The hand-written Hopper kernels live in ``csrc/`` and are compiled with
``nvcc`` on first use (``ops/_build.py``); nothing is built at import.

Ported so far: the offline fused-trunk res8 scoring path
(``inference.engine.StreamingEngine``), whose log-mel frontend
(``ops/frontend_cuda.py``) and conv0 + ReLU + AvgPool stem
(``ops/stem_cuda.py``) run as CUDA kernels on a CUDA device and as their
plain PyTorch versions on the CPU; the whole model zoo (``models/``),
served offline and live (``inference/online.py``; res8 also by
``inference/streaming_trunk.py``); the train steps, frame and CTC, whose
noise-bank mix (``ops/augment_cuda.py``) is the third kernel; the training
entry point ``python -m howl_tpu_torch.training.run.train`` for every model
with its settings, datasets, batchifiers, noise banks, workspace and batched
evaluator; the config-driven ``Trainer`` and the wake-word experiment
harness (N seeds trained at once on one card, a threshold sweep, reports
and ROC tools); the serving surface (``hub``, ``client``, ``native``); the
bench (``python -m howl_tpu_torch.bench``) and the kernel studies
(``tools/``).
"""

__version__ = "0.1.0"

import os as _os
from pathlib import Path as _Path


def root_path() -> _Path:
    """The repository root (the parent of the package), the JAX package's
    ``root_path()``: the two packages sit side by side."""
    return _Path(_os.path.dirname(_os.path.realpath(__file__))).parent


def datasets_path() -> _Path:
    return root_path() / "datasets"


def workspaces_path() -> _Path:
    return root_path() / "workspaces"
