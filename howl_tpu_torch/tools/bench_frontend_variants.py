"""Log-mel frontend variants on the card: the fused kernel at each frame
tile and grade against chains of library matrix products (counterpart of
``tools/bench_frontend_variants.py``).

The kernel legs are the JAX tool's three grades, "f32" (six bf16 passes),
"bf16x3" and "bf16x2", on the tensor-core kernel (``csrc/frontend_tc.cu``,
route "tc") at each of its tiles at 40 mels, 64, 128 and 256 frames: the
counterparts of the JAX tool's ``FRAME_BLOCK`` loop over 128, 256 and 512.
A grade whose block does not fit a block's shared memory at a tile is
reported from the reckoning before any launch.

The library legs are the JAX tool's chains under the same names, as
PyTorch chains of cuBLAS products through ``torch.matmul``: they never
stand in for the kernel. "xla chain" frames the audio, multiplies by the
windowed (n_fft, n_fft / 2 + 1) cosine and sine matrices, forms the power
and the float32 mel product and takes the log; "combined512" and "twomat
crop" multiply by the windowed matrices with the Nyquist bin cropped,
"twomat crop 2d" on the frames flattened to one matrix. The DFT products'
precision levels map to this card as:

    HIGHEST   float32 with TF32 off
    HIGH      torch.set_float32_matmul_precision("high"): TF32
    DEFAULT   both operands rounded to bf16, a bf16 product with float32
              sums (its output rounded to bf16 too, as torch returns it)

Each leg restores the process's matmul settings after it, so the port's
float32 paths stay off TF32 (ROADMAP F13). Every leg is slope-timed: chains
of N and 4N calls, each bumped by the last output, (t_4N - t_N) / 3N, the
median of three. The tool ends with the JAX tool's two accuracy lines: the
HIGH and DEFAULT chains against HIGHEST on 8 clips, the largest error above
the log floor (HIGHEST > -10) and the largest anywhere.

    python -m howl_tpu_torch.tools.bench_frontend_variants [--device cuda|cpu]
        [--skip-kernels]

``--skip-kernels`` times the library legs alone (the JAX tool's
``HOWL_BENCH_SKIP_PALLAS=1``). It runs on the card at 512 clips of 8 s and
chains of 16 and 64: with ``--device cuda`` (the default) and no CUDA
device it raises. With ``--device cpu`` it runs the plain version and the
chains at the JAX tool's CPU size, 4 clips of 2 s and chains of 2 and 8.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from howl_tpu_torch.ops.frontend import (
    FrontendConfig, _hann_window, frame_signal, mel_filterbank, nyquist_crop_bins, windowed_dft_matrix,
)
from howl_tpu_torch.ops.frontend_cuda import TC_TILES
from howl_tpu_torch.ops.tf32 import exact_float32
from howl_tpu_torch.tools._study import (
    CPU_SIZE, REPEATS, bumped_chain, device_parser, k1_leg, k1_refusal, pick_device, slope_ms, study_audio,
)

N_MELS = 40
CARD_SIZE = (512, 8.0, 16)  # batch, clip seconds, iterations: the JAX tool's TPU size
# the kernel legs: (the JAX tool's label, the grade)
KERNEL_GRADES = (("f32(6-pass)", "f32"), ("bf16x3", "bf16x3"), ("bf16x2", "bf16x2"))
LOG_FLOOR_OFFSET = 1e-7  # the chains' log(mel + 1e-7), as the JAX tool's
ACCURACY_CLIPS = 8


@contextlib.contextmanager
def dft_precision(level: str):
    """Float32 matrix products at a JAX precision level inside the block:
    "HIGH" with TF32 on, "HIGHEST" and "DEFAULT" with it off; the process's
    settings restored after it."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("high" if level == "HIGH" else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]


def dft_matmul(x: torch.Tensor, w: torch.Tensor, level: str) -> torch.Tensor:
    """``x @ w`` at a precision level (see the module's docstring)."""
    if level == "DEFAULT":
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
    with dft_precision(level):
        return x @ w


class Chains:
    """The library chains' matrices for one geometry on one device."""

    def __init__(self, cfg: FrontendConfig, dev: torch.device):
        self.cfg = cfg
        n = cfg.n_fft
        t = np.arange(n)[:, None] * np.arange(cfg.n_freqs)[None, :]
        ang = 2.0 * np.pi * t / n
        win = _hann_window(n)[:, None]
        self.cosw = torch.from_numpy((np.cos(ang).astype(np.float32) * win)).to(dev)
        self.sinw = torch.from_numpy(((-np.sin(ang)).astype(np.float32) * win)).to(dev)
        self.fb = torch.from_numpy(
            mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)).to(dev)
        n_bins = nyquist_crop_bins(cfg)
        w_all = torch.from_numpy(windowed_dft_matrix(n, n_bins)).to(dev)
        self.cw, self.sw, self.fbc = w_all[:, :n_bins].contiguous(), w_all[:, n_bins:].contiguous(), self.fb[:n_bins]

    def _log_mel(self, frames, cw, sw, fb, level, offset):
        re, im = dft_matmul(frames, cw, level), dft_matmul(frames, sw, level)
        with exact_float32():  # the mel product at HIGHEST, as the JAX chains'
            mel = (re * re + im * im) @ fb
        return torch.log(mel + offset)

    def xla_chain(self, audio: torch.Tensor, level: str) -> torch.Tensor:
        """(B, T, n_mels): the frames against the whole windowed basis."""
        return self._log_mel(frame_signal(audio, self.cfg), self.cosw, self.sinw, self.fb, level, LOG_FLOOR_OFFSET)

    def combined512(self, audio: torch.Tensor, level: str) -> torch.Tensor:
        """(B, n_mels, T): the JAX package's ``log_mel_spectrogram`` chain."""
        out = self._log_mel(frame_signal(audio, self.cfg), self.cw, self.sw, self.fbc, level, self.cfg.log_offset)
        return out.transpose(-1, -2)

    def twomat(self, audio: torch.Tensor, level: str, flat: bool = False) -> torch.Tensor:
        """The cropped matrices; ``flat``: the frames as one (B * T, n_fft) matrix."""
        frames = frame_signal(audio, self.cfg)
        if flat:
            frames = frames.reshape(-1, frames.shape[-1])
        return self._log_mel(frames, self.cw, self.sw, self.fbc, level, LOG_FLOOR_OFFSET)

    def legs(self) -> list:
        """(name, fn(audio)) of every library leg, in the JAX tool's order."""
        out = [(f"xla chain {lv} dft", lambda a, lv=lv: self.xla_chain(a, lv)) for lv in ("HIGHEST", "HIGH", "DEFAULT")]
        out += [(f"combined512 {lv} dft", lambda a, lv=lv: self.combined512(a, lv))
                for lv in ("HIGHEST", "HIGH", "DEFAULT")]
        for lv in ("HIGHEST", "HIGH"):
            out += [(f"twomat crop {lv} dft", lambda a, lv=lv: self.twomat(a, lv)),
                    (f"twomat crop 2d {lv} dft", lambda a, lv=lv: self.twomat(a, lv, flat=True))]
        return out


def kernel_legs(cfg: FrontendConfig, dev: torch.device) -> list:
    """(name, fn(audio) or the reason it does not run) of every kernel leg:
    each "tc" tile, each of the JAX tool's grades."""
    out = []
    for tile in TC_TILES[cfg.n_mels]:
        for label, grade in KERNEL_GRADES:
            name = f"kernel {label:12s} tile={tile}"
            out.append((name, k1_refusal(cfg, grade, "tc", tile) or k1_leg(cfg, grade, "tc", tile, dev, torch.float32)))
    return out


def run(audio: torch.Tensor, cfg: FrontendConfig, iters: int, dev: torch.device, skip_kernels: bool = False) -> dict:
    """Times every leg (printing each), then prints the accuracy lines.
    Returns {leg name: ms per iteration, or the reason it did not run} and
    {"accuracy": {level: (above-floor max, global max)}}."""
    chains = Chains(cfg, dev)
    legs = ([] if skip_kernels else kernel_legs(cfg, dev)) + chains.legs()
    results = {}
    with torch.no_grad():
        for name, fn in legs:
            if isinstance(fn, str):
                print(f"{name:42s}: {fn}", flush=True)
                results[name] = fn
                continue
            ms, _ = slope_ms(bumped_chain(fn, audio), iters, 4 * iters, REPEATS, dev)
            print(f"{name:42s}: {ms:8.3f} ms/iter", flush=True)
            results[name] = ms
        small = audio[:ACCURACY_CLIPS]
        hi = chains.xla_chain(small, "HIGHEST")
        mask = hi > -10.0
        results["accuracy"] = {}
        for level in ("HIGH", "DEFAULT"):
            err = (chains.xla_chain(small, level) - hi).abs()
            above, top = float(err[mask].max()), float(err.max())
            print(f"xla {level} vs HIGHEST: above-floor max err {above:.2e}, global max {top:.2e}")
            results["accuracy"][level] = (above, top)
    return results


def main(argv=None) -> dict:
    p = device_parser(__doc__)
    p.add_argument("--skip-kernels", action="store_true")
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    batch, clip_s, iters = CARD_SIZE if dev.type == "cuda" else CPU_SIZE
    torch.backends.cuda.matmul.allow_tf32 = False
    audio = study_audio(batch, clip_s, 0, dev)  # the JAX tool's seed
    return run(audio, FrontendConfig(n_mels=N_MELS), iters, dev, args.skip_kernels)


if __name__ == "__main__":
    main()
