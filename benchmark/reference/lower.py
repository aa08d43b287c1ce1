"""Rounding to a precision below the configuration's, for the controls.

``fp8`` rounds a tensor to float8 e4m3 with one scale for the tensor (its
largest magnitude at 448, the format's largest finite value), as an fp8 path
with per-tensor scales would store it. ``int_levels`` is the symmetric
integer grid the int8 (127 levels) and int4 (7 levels) trunks quantize to.
"""

import torch

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with a per-tensor scale, back in float32."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def identity(x: torch.Tensor) -> torch.Tensor:
    return x.float()


ROUNDINGS = {"float32": identity, "fp8": fp8}
