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
plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"
