"""Log-mel features as howl computes them: torchaudio's ``MelSpectrogram``
(periodic Hann window, centred frames with reflect padding, power 2, an HTK
mel filterbank without normalisation) and ``log(mel + 1e-7)``, then the ZMUV
statistics. Written here with ``torch.stft``; no code of the program.
"""

import numpy as np
import torch

from benchmark.reference.lower import identity


def htk_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0, f_max=None) -> np.ndarray:
    """(n_freqs, n_mels) triangular filters on the HTK mel scale, float64."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    mel = np.linspace(2595.0 * np.log10(1.0 + f_min / 700.0), 2595.0 * np.log10(1.0 + f_max / 700.0), n_mels + 2)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    lo, mid, hi = hz[:-2], hz[1:-1], hz[2:]
    rise = (freqs[:, None] - lo) / (mid - lo)
    fall = (hi - freqs[:, None]) / (hi - mid)
    return np.maximum(0.0, np.minimum(rise, fall))


def log_mels(audio: torch.Tensor, audio_cfg: dict, rnd=identity) -> torch.Tensor:
    """(B, samples) float32 -> (B, n_mels, frames) ZMUV'd log-mels, float32;
    ``rnd`` rounds the audio, the power, the filterbank and the output (a
    control's lower precision)."""
    n_fft, hop = audio_cfg["n_fft"], audio_cfg["hop_length"]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=audio.device)
    spec = torch.stft(rnd(audio), n_fft, hop_length=hop, win_length=n_fft, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real.square() + spec.imag.square()  # (B, n_freqs, T)
    fb = htk_filterbank(n_fft // 2 + 1, audio_cfg["n_mels"], audio_cfg["sample_rate"], audio_cfg["f_min"],
                        audio_cfg["f_max"])
    fb = torch.from_numpy(fb.astype(np.float32)).to(audio.device)
    mel = torch.einsum("bft,fm->bmt", rnd(power), rnd(fb))
    out = torch.log(mel + audio_cfg["log_offset"])
    return rnd((out - audio_cfg["zmuv_mean"]) / audio_cfg["zmuv_std"])
