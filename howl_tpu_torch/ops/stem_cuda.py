"""Fused res8 stem: the CUDA kernels ``csrc/stem_tc.cu`` and ``csrc/stem.cu``
and their plain PyTorch version (counterpart of ``howl_tpu/ops/stem_pallas.py``).

All compute ``avg_pool(relu(conv0(mel)), (pool_t, pool_f), VALID)`` for
res8's (3 x 3, 1 -> ch) stem on time-major ZMUV'd log-mels: zero SAME
padding in time and frequency, ReLU at full resolution, T' = T // pool_t.
Input (B, T, n_mels); output (B, T', n_mels // pool_f, ch), channels-last,
in the input's dtype. In bf16 the inputs and taps are bf16 values, every sum
is float32 and the result is rounded to bf16 once, as ``res8_stem_pallas``
does. The CUDA kernels keep the full-resolution pre-pool activation out of
device memory; see the notes at the top of the two sources.

``res8_stem_cuda`` runs the plain version for a tensor on the CPU and a
kernel for a tensor on a CUDA device. Which kernel is decided by the dtype
and the geometry alone (``stem_route``), never by a failure:

    "tc"   ``csrc/stem_tc.cu``: conv0 on the tensor cores (``mma.sync``),
           the pool in registers. bf16 mels with pool (3, 4), n_mels a
           multiple of 4 up to 128 and ch <= 48. The taps are rounded to
           bf16 (``pack_tap_image``).
    "fma"  ``csrc/stem.cu``: float32 FMA on the CUDA cores. float32 mels
           always, and every geometry the "tc" kernel does not serve.

``route=`` forces one of the two and raises where it cannot serve.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from howl_tpu_torch.ops import _build

ROUTES = ("tc", "fma")
# the "tc" kernel's geometry (csrc/stem_tc.cu); at its largest a block needs ~94 KB of shared memory
TC_POOL = (3, 4)  # the pool it serves
TC_K = 16  # the nine taps padded to the depth of one mma.sync.m16n8k16
TC_N = 48  # channels padded to three m16 tiles
TC_MAX_BINS = 128  # a warp per 8 bins, at most 16 warps a block
# (dt, df) of row k of the tap image, as the kernel's kTapDt / kTapDf
TC_TAP_ORDER = ((-1, -1), (-1, 0), (0, -1), (0, 0), (1, -1), (1, 0), (-1, 1), (0, 1), (1, 1))


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


def stem_route(dtype, n_mels: int, ch: int, pool=(3, 4)) -> str:
    """The kernel that serves a dtype and geometry on a CUDA tensor: "tc" or
    "fma", by the rule in the module's docstring."""
    fits = (
        dtype == torch.bfloat16
        and tuple(pool) == TC_POOL
        and 4 <= n_mels <= TC_MAX_BINS and n_mels % 4 == 0
        and 1 <= ch <= TC_N
    )
    return "tc" if fits else "fma"


def pack_tap_image(taps: torch.Tensor) -> torch.Tensor:
    """(3, 3, ch) float32 taps -> the (16, 48) bf16 tap image the "tc"
    kernel's A fragments come from: row k holds tap ``TC_TAP_ORDER[k]`` of
    every channel, rounded to bf16; rows 9-15 and columns ch-47 are zero."""
    ch = taps.shape[-1]
    if ch > TC_N:
        raise ValueError(f"the tap image holds at most {TC_N} channels, got {ch}")
    img = torch.zeros((TC_K, TC_N), dtype=torch.bfloat16, device=taps.device)
    rows = [(dt + 1) * 3 + (df + 1) for dt, df in TC_TAP_ORDER]
    img[: len(rows), :ch] = taps.reshape(9, ch)[rows].to(torch.bfloat16)
    return img


def unpack_tap_image(img: torch.Tensor, ch: int) -> torch.Tensor:
    """The inverse of :func:`pack_tap_image`: (3, 3, ch) float32 taps."""
    taps = torch.empty((9, ch), dtype=torch.float32, device=img.device)
    rows = [(dt + 1) * 3 + (df + 1) for dt, df in TC_TAP_ORDER]
    taps[rows] = img[: len(rows), :ch].float()
    return taps.reshape(3, 3, ch)


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


def res8_stem_cuda(mel_tm: torch.Tensor, taps: torch.Tensor, pool=(3, 4), route: str = None) -> torch.Tensor:
    """(B, T, n_mels) mels + (3, 3, ch) taps -> (B, T // pool_t,
    n_mels // pool_f, ch) pooled stem activations in the mels' dtype.

    On a CPU tensor this is :func:`res8_stem_plain`. On a CUDA tensor it
    launches the kernel that :func:`stem_route` names for the dtype and
    geometry, ``howl_res8_stem_tc_forward`` ("tc") or
    ``howl_res8_stem_forward`` ("fma"), or raises. ``route`` forces one of
    the two on a CUDA tensor and raises where that kernel cannot serve. The
    kernels have no backward, so inputs that require grad raise on every
    device while grad mode is on; a trained stem runs ``Res8``'s
    differentiable conv chain. ``launches`` counts every kernel launch,
    ``launches_tc`` those of the "tc" kernel.
    """
    _build.refuse_grad("res8_stem_cuda", mel_tm, taps)
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    if mel_tm.device.type == "cpu":
        if route is not None:
            raise ValueError(f"route={route!r} names a CUDA kernel: a CPU tensor takes the plain version")
        return res8_stem_plain(mel_tm, taps, pool)
    if mel_tm.device.type != "cuda":
        raise ValueError(f"res8_stem_cuda takes CPU or CUDA tensors, got {mel_tm.device}")
    _check(mel_tm, taps, pool)
    if not (mel_tm.is_contiguous() and taps.is_contiguous()):
        raise ValueError("mels and taps must be contiguous")
    b, t, n_mels = mel_tm.shape
    pool_t, pool_f = pool
    ch = taps.shape[-1]
    served = stem_route(mel_tm.dtype, n_mels, ch, pool)
    if route == "tc" and served != "tc":
        raise ValueError(f"route='tc' cannot serve {mel_tm.dtype} mels of {n_mels} bins, {ch} channels and pool "
                         f"{tuple(pool)}: see stem_route")
    route = route or served
    if route == "tc" and mel_tm.data_ptr() % 8:
        raise ValueError("the tensor-core stem kernel reads the mels 8 bytes at a time: they must be 8-byte aligned")
    out = torch.empty((b, t // pool_t, n_mels // pool_f, ch), dtype=mel_tm.dtype, device=mel_tm.device)
    stream = torch.cuda.current_stream(mel_tm.device).cuda_stream
    lib = _build.kernel_library()
    with torch.cuda.device(mel_tm.device):
        if route == "tc":
            img = _build.packed_operand(pack_tap_image, taps)
            status = lib.howl_res8_stem_tc_forward(
                mel_tm.data_ptr(), img.data_ptr(), out.data_ptr(), b, t, n_mels, ch, stream,
            )
        else:
            status = lib.howl_res8_stem_forward(
                mel_tm.data_ptr(), taps.data_ptr(), out.data_ptr(),
                b, t, n_mels, ch, pool_t, pool_f, int(mel_tm.dtype == torch.bfloat16), stream,
            )
    _build.check_launch(status, f"res8 stem ({route})")
    res8_stem_cuda.launches += 1
    if route == "tc":
        res8_stem_cuda.launches_tc += 1
    return out


res8_stem_cuda.launches = 0
res8_stem_cuda.launches_tc = 0
