"""TF32 off for the port's float32 paths.

PyTorch leaves ``torch.backends.cudnn.allow_tf32`` on by default, and a
caller may turn ``torch.backends.cuda.matmul.allow_tf32`` on too: a float32
convolution or matrix product on a card then rounds its operands to TF32.
The port's float32 engines and train step are its exact paths, so they run
under :func:`exact_float32`, whatever the caller's global flags; the bf16
paths leave the flags as the caller set them.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def exact_float32(enabled: bool = True):
    """Float32 convolutions and matrix products in full float32 inside the
    block (TF32 off on a card) when ``enabled``, the caller's settings
    restored after it."""
    if not enabled:
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def is_float32(compute_dtype) -> bool:
    """A compute dtype that serves or trains in float32 (None is float32)."""
    return compute_dtype in (None, torch.float32)


def exact_if_float32(method):
    """An engine method run under :func:`exact_float32` when the engine's
    ``compute_dtype`` is float32."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with exact_float32(is_float32(self.compute_dtype)):
            return method(self, *args, **kwargs)

    return run
