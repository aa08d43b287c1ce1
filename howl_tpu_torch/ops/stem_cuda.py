"""Fused res8 stem: the CUDA kernel ``csrc/stem.cu`` and its plain PyTorch
version (counterpart of ``howl_tpu/ops/stem_pallas.py``).

Both compute ``avg_pool(relu(conv0(mel)), (pool_t, pool_f), VALID)`` for
res8's (3 x 3, 1 -> ch) stem on time-major ZMUV'd log-mels: zero SAME
padding in time and frequency, ReLU at full resolution, T' = T // pool_t.
Input (B, T, n_mels); output (B, T', n_mels // pool_f, ch), channels-last,
in the input's dtype. In bf16 the inputs and taps are bf16 values, every sum
is float32 and the result is rounded to bf16 once, as ``res8_stem_pallas``
does. The CUDA kernel keeps the full-resolution pre-pool activation out of
device memory; see the note at the top of ``csrc/stem.cu``.

``res8_stem_cuda`` runs the plain version for a tensor on the CPU and the
kernel for a tensor on a CUDA device; it has no other route.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from howl_tpu_torch.ops import _build


def stem_geometry(n_mels: int, pool_f: int) -> int:
    """Pooled mel bins f_out; n_mels must divide into whole pool windows."""
    if n_mels % pool_f:
        raise ValueError(f"n_mels {n_mels} not divisible by pool_f {pool_f}")
    return n_mels // pool_f


def fold_stem_weights(kernel, n_mels: int = 40, pool_f: int = 4) -> torch.Tensor:
    """A (3, 3, 1, ch) HWIO conv0 kernel (H = time taps, W = freq taps) ->
    the kernel's (3, 3, ch) float32 tap table: taps[dt + 1, df + 1, c]
    weighs mel[t + dt, f + df] for output channel c.

    Counterpart of the JAX package's banded-fold weight prep; the Hopper
    kernel reads the taps directly, so only the checks and the geometry
    carry over.
    """
    if not torch.is_tensor(kernel):
        kernel = torch.from_numpy(np.array(kernel, np.float32))
    if kernel.ndim != 4 or tuple(kernel.shape[:3]) != (3, 3, 1):
        raise ValueError(f"expected a (3, 3, 1, ch) stem kernel, got {tuple(kernel.shape)}")
    stem_geometry(n_mels, pool_f)
    return kernel[:, :, 0].to(torch.float32).contiguous()


def _check(mel_tm: torch.Tensor, taps: torch.Tensor, pool) -> None:
    if mel_tm.ndim != 3:
        raise ValueError(f"expected (B, T, n_mels) mels, got shape {tuple(mel_tm.shape)}")
    if mel_tm.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mels must be float32 or bfloat16, got {mel_tm.dtype}")
    if taps.ndim != 3 or tuple(taps.shape[:2]) != (3, 3) or taps.dtype != torch.float32:
        raise ValueError(f"expected (3, 3, ch) float32 taps, got {tuple(taps.shape)} {taps.dtype}")
    if taps.device != mel_tm.device:
        raise ValueError(f"taps on {taps.device}, mels on {mel_tm.device}")
    stem_geometry(mel_tm.shape[-1], pool[1])
    if mel_tm.shape[1] < pool[0]:
        raise ValueError(f"{mel_tm.shape[1]} frames: the stem needs at least one pool window of {pool[0]}")


def res8_stem_plain(mel_tm: torch.Tensor, taps: torch.Tensor, pool=(3, 4)) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``F.conv2d`` + ReLU +
    ``F.avg_pool2d`` in float32, rounded to the input's dtype once."""
    _check(mel_tm, taps, pool)
    x = mel_tm.to(torch.float32)[:, None]  # (B, 1, T, F): time is H
    w = taps.permute(2, 0, 1)[:, None]  # (ch, 1, 3, 3)
    y = F.avg_pool2d(F.relu(F.conv2d(x, w, padding=1)), pool, stride=pool)
    return y.permute(0, 2, 3, 1).to(mel_tm.dtype).contiguous()  # (B, T', F', ch)


def res8_stem_cuda(mel_tm: torch.Tensor, taps: torch.Tensor, pool=(3, 4)) -> torch.Tensor:
    """(B, T, n_mels) mels + (3, 3, ch) taps -> (B, T // pool_t,
    n_mels // pool_f, ch) pooled stem activations in the mels' dtype.

    On a CPU tensor this is :func:`res8_stem_plain`. On a CUDA tensor it
    launches ``howl_res8_stem_forward`` or raises.
    """
    if mel_tm.device.type == "cpu":
        return res8_stem_plain(mel_tm, taps, pool)
    if mel_tm.device.type != "cuda":
        raise ValueError(f"res8_stem_cuda takes CPU or CUDA tensors, got {mel_tm.device}")
    _check(mel_tm, taps, pool)
    if not (mel_tm.is_contiguous() and taps.is_contiguous()):
        raise ValueError("mels and taps must be contiguous")
    b, t, n_mels = mel_tm.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's 65535 clips")
    pool_t, pool_f = pool
    ch = taps.shape[-1]
    out = torch.empty((b, t // pool_t, n_mels // pool_f, ch), dtype=mel_tm.dtype, device=mel_tm.device)
    lib = _build.kernel_library()
    with torch.cuda.device(mel_tm.device):
        status = lib.howl_res8_stem_forward(
            mel_tm.data_ptr(), taps.data_ptr(), out.data_ptr(),
            b, t, n_mels, ch, pool_t, pool_f, int(mel_tm.dtype == torch.bfloat16),
            torch.cuda.current_stream(mel_tm.device).cuda_stream,
        )
    _build.check_launch(status, "res8 stem")
    res8_stem_cuda.launches += 1
    return out


res8_stem_cuda.launches = 0
