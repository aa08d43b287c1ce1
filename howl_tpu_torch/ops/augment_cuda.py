"""Noise-bank gather + mix: the CUDA kernel ``csrc/augment.cu`` and its plain
PyTorch version (counterpart of ``howl_tpu/ops/augment_pallas.py``).

Both compute, per example b of a (B, n) float32 batch,

    out[b] = audio[b]                                                 if alpha[b] == 0
    out[b] = audio[b] * (1 - alpha[b]) + ext[rows[b], offs[b]:offs[b] + n] * alpha[b]

from the wrap-extended bank ``ext`` of ``ops/augment.py``'s
``prepare_noise_bank``, with rows and window starts clamped into the bank as
``jax.lax.dynamic_slice`` clamps them. The plain version is the JAX
fallback's arithmetic as separate PyTorch ops, and the kernel rounds each op
on its own, so the two agree bit for bit. A row whose alpha is 0 passes its
audio through verbatim (``-0.0`` included), as ``timeshift`` passes its
skipped rows; the JAX fallback's ``a * 1 + noise * 0`` equals it except that
it can turn ``-0.0`` into ``+0.0``.

``mix_noise_bank_cuda`` runs the plain version for a tensor on the CPU and
the kernel for a tensor on a CUDA device; it has no other route, for any
bank width, window length or batch size.
"""

from __future__ import annotations

import torch

from howl_tpu_torch.ops import _build


def _check(audio, extended, rows, offs, alpha) -> None:
    if audio.ndim != 2 or audio.dtype != torch.float32:
        raise ValueError(f"expected (B, n) float32 audio, got {tuple(audio.shape)} {audio.dtype}")
    b, n = audio.shape
    if extended.ndim != 2 or extended.dtype != torch.float32:
        raise ValueError(f"expected an (N, W) float32 bank, got {tuple(extended.shape)} {extended.dtype}")
    if extended.shape[0] < 1 or extended.shape[1] < n:
        raise ValueError(f"bank {tuple(extended.shape)} cannot hold a {n}-sample window")
    for name, t in (("rows", rows), ("offs", offs)):
        if t.shape != (b,) or t.dtype != torch.int64:
            raise ValueError(f"expected ({b},) int64 {name}, got {tuple(t.shape)} {t.dtype}")
    if alpha.numel() != b or alpha.dtype != torch.float32:
        raise ValueError(f"expected {b} float32 mix weights, got {tuple(alpha.shape)} {alpha.dtype}")
    for name, t in (("bank", extended), ("rows", rows), ("offs", offs), ("alpha", alpha)):
        if t.device != audio.device:
            raise ValueError(f"{name} on {t.device}, audio on {audio.device}")


def mix_noise_bank_plain(audio, extended, rows, offs, alpha) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same contract, any device."""
    _check(audio, extended, rows, offs, alpha)
    n = audio.shape[1]
    rows = rows.clamp(0, extended.shape[0] - 1)
    offs = offs.clamp(0, extended.shape[1] - n)
    noise = extended.unfold(1, n, 1)[rows, offs]  # (B, n): one window per example
    a = alpha.reshape(-1, 1)
    return torch.where(a == 0, audio, audio * (1.0 - a) + noise * a)


def mix_noise_bank_cuda(audio, extended, rows, offs, alpha) -> torch.Tensor:
    """(B, n) audio, (N, W) wrap-extended bank, (B,) int64 rows and window
    starts, (B,) or (B, 1) float32 mix weights -> (B, n) mixed audio.

    On a CPU tensor this is :func:`mix_noise_bank_plain`. On a CUDA tensor
    it launches ``howl_mix_noise_bank_forward`` or raises.
    """
    _build.refuse_grad("mix_noise_bank_cuda", audio, extended, alpha)
    if audio.device.type == "cpu":
        return mix_noise_bank_plain(audio, extended, rows, offs, alpha)
    if audio.device.type != "cuda":
        raise ValueError(f"mix_noise_bank_cuda takes CPU or CUDA tensors, got {audio.device}")
    _check(audio, extended, rows, offs, alpha)
    if not all(t.is_contiguous() for t in (audio, extended, rows, offs, alpha)):
        raise ValueError("audio, bank, rows, offs and alpha must be contiguous")
    b, n = audio.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's 65535 examples")
    out = torch.empty_like(audio)
    lib = _build.kernel_library()
    with torch.cuda.device(audio.device):
        status = lib.howl_mix_noise_bank_forward(
            audio.data_ptr(), extended.data_ptr(), rows.data_ptr(), offs.data_ptr(), alpha.data_ptr(),
            out.data_ptr(), b, n, extended.shape[0], extended.shape[1],
            torch.cuda.current_stream(audio.device).cuda_stream,
        )
    _build.check_launch(status, "noise-bank mix")
    mix_noise_bank_cuda.launches += 1
    return out


mix_noise_bank_cuda.launches = 0
