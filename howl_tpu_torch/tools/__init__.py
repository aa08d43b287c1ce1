"""Measurement tools of the port: Hopper counterparts of ``tools/`` in the
JAX package, with the hand-written kernels they measure."""
