"""Measurement tools of the port: Hopper counterparts of ``tools/`` in the
JAX package, with the hand-written kernels they measure. Each runs as
``python -m howl_tpu_torch.tools.<name>``; the root ``tools/_path.py``, a
``sys.path`` bootstrap for running those scripts by path, has no
counterpart, since the package import makes it unnecessary."""
