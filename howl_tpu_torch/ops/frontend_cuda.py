"""Fused log-mel frontend: the CUDA kernel ``csrc/frontend.cu`` and its plain
PyTorch version (counterpart of ``howl_tpu/ops/frontend_pallas.py``).

Both compute ``(log(mel + log_offset) - mean) / std`` of the center
reflect-padded, Hann-windowed, HTK-mel power spectrum, with the Nyquist bin
cropped, as ``log_mel_spectrogram_pallas`` does. The plain version is the
polyphase sum of the JAX kernel written with ``torch.matmul``: the audio is
viewed as hop rows H and ``frames @ W == sum_j H[t + j] @ W_j``. The CUDA
kernel keeps the overlapping frames and the re/im tensor out of device
memory; see the note at the top of ``csrc/frontend.cu``.

Precision grades round operands to bf16 and accumulate in float32:

    grade     precision                        audio  W     power, filterbank
    "f32"     None, "f32", "high", "highest"   f32    f32   f32
    "bf16x2"  "bf16x2"                         bf16   f32   bf16
    "bf16"    "bf16"                           bf16   bf16  bf16

With ``out_dtype=torch.bfloat16`` the pre-log mel is rounded to bf16 before
the log, as the TPU kernel's bf16 output tiles are.

``log_mel_spectrogram_cuda`` runs the plain version for a tensor on the CPU
and the kernel for a tensor on a CUDA device; it has no other route.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from howl_tpu_torch.ops import _build
from howl_tpu_torch.ops.frontend import (
    FrontendConfig,
    center_pad,
    mel_filterbank,
    nyquist_crop_bins,
    round_bf16,
    windowed_dft_matrix,
)

_GRADES = {
    None: "f32", "f32": "f32", "high": "f32", "highest": "f32",
    "bf16x2": "bf16x2", "bf16": "bf16",
}
_LAYOUTS = ("tm", "fm")
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def frontend_grade(precision) -> str:
    """Map a precision request to its grade; an unknown request raises."""
    key = precision.lower() if isinstance(precision, str) else precision
    if key not in _GRADES:
        raise ValueError(
            f"unsupported frontend precision {precision!r}: expected one of {sorted(map(str, _GRADES))}"
        )
    return _GRADES[key]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=32)
def frontend_bases(config: FrontendConfig, grade: str, device: torch.device):
    """(W, fb) on ``device`` for one geometry and grade, built once.

    W is (n_fft, 2*n_bins_pad) [cos | -sin] with the Hann window folded in;
    fb is (n_bins_pad, n_mels). n_bins is padded to a multiple of 4 with
    zero columns and rows, which add exact zeros to the power and the mel.
    """
    n_bins = nyquist_crop_bins(config)
    nbp = _round_up(n_bins, 4)
    w = windowed_dft_matrix(config.n_fft, n_bins)
    w_pad = np.zeros((config.n_fft, 2 * nbp), np.float32)
    w_pad[:, :n_bins] = w[:, :n_bins]
    w_pad[:, nbp : nbp + n_bins] = w[:, n_bins:]
    fb = mel_filterbank(config.n_freqs, config.n_mels, config.sample_rate, config.f_min, config.f_max)
    fb_pad = np.zeros((nbp, config.n_mels), np.float32)
    fb_pad[:n_bins] = fb[:n_bins]
    w_t, fb_t = torch.from_numpy(w_pad), torch.from_numpy(fb_pad)
    if grade == "bf16":
        w_t = round_bf16(w_t)
    if grade != "f32":
        fb_t = round_bf16(fb_t)
    return w_t.to(device), fb_t.to(device)


def _zmuv_scalars(zmuv_mean, zmuv_std) -> tuple[float, float]:
    """(mean, 1/std) rounded to float32, as the JAX kernel forms them."""
    mean = np.float32(zmuv_mean)
    inv_std = np.float32(1.0) / np.float32(zmuv_std)
    return float(mean), float(inv_std)


def _check(audio: torch.Tensor, config: FrontendConfig, out_dtype, layout) -> torch.Tensor:
    if audio.ndim == 1:
        audio = audio[None, :]
    if audio.ndim != 2:
        raise ValueError(f"expected (B, samples) audio, got shape {tuple(audio.shape)}")
    if audio.dtype != torch.float32:
        raise TypeError(f"expected float32 audio, got {audio.dtype}")
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}, got {layout!r}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if config.center and audio.shape[-1] <= config.n_fft // 2:
        raise ValueError(
            f"reflect padding needs more than n_fft // 2 = {config.n_fft // 2} samples, "
            f"got {audio.shape[-1]}"
        )
    return audio


def log_mel_spectrogram_plain(
    audio: torch.Tensor,
    config: FrontendConfig = FrontendConfig(),
    zmuv_mean=0.0,
    zmuv_std=1.0,
    precision=None,
    out_dtype=torch.float32,
    layout: str = "fm",
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same contract, any device."""
    grade = frontend_grade(precision)
    audio = _check(audio, config, out_dtype, layout)
    b, num_samples = audio.shape
    hop, n_fft = config.hop_length, config.n_fft
    n_frames = config.num_frames(num_samples)
    if grade != "f32":
        audio = round_bf16(audio)  # commutes with the reflect and zero padding
    padded = center_pad(audio, config)
    n_sub = -(-n_fft // hop)
    rows = n_frames + n_sub - 1
    extra = rows * hop - padded.shape[-1]
    if extra > 0:
        padded = torch.nn.functional.pad(padded, (0, extra))
    hview = padded[:, : rows * hop].reshape(b, rows, hop)

    w, fb = frontend_bases(config, grade, audio.device)
    acc = None
    for j in range(n_sub):
        width = min(hop, n_fft - j * hop)
        # rows past the block's true width multiply the next hop row by zero
        wj = torch.nn.functional.pad(w[j * hop : j * hop + width], (0, 0, 0, hop - width))
        term = hview[:, j : j + n_frames] @ wj
        acc = term if acc is None else acc + term
    nbp = fb.shape[0]
    re, im = acc[..., :nbp], acc[..., nbp:]
    power = re * re + im * im
    if grade != "f32":
        power = round_bf16(power)
    mel = power @ fb  # (B, T, n_mels)
    if out_dtype == torch.bfloat16:
        mel = round_bf16(mel)
    mean, inv_std = _zmuv_scalars(zmuv_mean, zmuv_std)
    res = (torch.log(mel + config.log_offset) - mean) * inv_std
    if layout == "fm":
        res = res.transpose(-1, -2)
    return res.to(out_dtype).contiguous()


def log_mel_spectrogram_cuda(
    audio: torch.Tensor,
    config: FrontendConfig = FrontendConfig(),
    zmuv_mean=0.0,
    zmuv_std=1.0,
    precision=None,
    out_dtype=torch.float32,
    layout: str = "fm",
) -> torch.Tensor:
    """(B, samples) float32 -> ZMUV'd log-mels, (B, n_mels, frames) for
    ``layout="fm"`` or (B, frames, n_mels) for ``"tm"``, in ``out_dtype``.

    On a CPU tensor this is :func:`log_mel_spectrogram_plain`. On a CUDA
    tensor it launches ``howl_logmel_forward`` or raises.
    """
    if audio.device.type == "cpu":
        return log_mel_spectrogram_plain(audio, config, zmuv_mean, zmuv_std, precision, out_dtype, layout)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel_spectrogram_cuda takes CPU or CUDA tensors, got {audio.device}")
    grade = frontend_grade(precision)
    audio = _check(audio, config, out_dtype, layout)
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    b, num_samples = audio.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's 65535 clips")
    n_frames = config.num_frames(num_samples)
    n_mels = config.n_mels
    shape = (b, n_mels, n_frames) if layout == "fm" else (b, n_frames, n_mels)
    out = torch.empty(shape, dtype=out_dtype, device=audio.device)
    w, fb = frontend_bases(config, grade, audio.device)
    mean, inv_std = _zmuv_scalars(zmuv_mean, zmuv_std)
    lib = _build.kernel_library()
    with torch.cuda.device(audio.device):
        status = lib.howl_logmel_forward(
            audio.data_ptr(), w.data_ptr(), fb.data_ptr(), out.data_ptr(),
            b, num_samples, n_frames, config.n_fft, config.hop_length, int(config.center),
            fb.shape[0], n_mels,
            int(grade != "f32"), int(grade != "f32"), int(out_dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), int(layout == "fm"),
            config.log_offset, mean, inv_std,
            torch.cuda.current_stream(audio.device).cuda_stream,
        )
    _build.check_launch(status, "log-mel")
    log_mel_spectrogram_cuda.launches += 1
    return out


log_mel_spectrogram_cuda.launches = 0
