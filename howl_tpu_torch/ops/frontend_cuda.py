"""Fused log-mel frontend: the CUDA kernels ``csrc/frontend.cu`` and
``csrc/frontend_tc.cu`` and their plain PyTorch version (counterpart of
``howl_tpu/ops/frontend_pallas.py``).

All compute ``(log(mel + log_offset) - mean) / std`` of the center
reflect-padded, Hann-windowed, HTK-mel power spectrum, with the Nyquist bin
cropped, as ``log_mel_spectrogram_pallas`` does. The plain version is the
polyphase sum of the JAX kernel written with ``torch.matmul``: the audio is
viewed as hop rows H and ``frames @ W == sum_j H[t + j] @ W_j``. The CUDA
kernels keep the overlapping frames and the re/im tensor out of device
memory; see the notes at the top of the two sources.

Precision grades round operands to bf16 and accumulate in float32:

    grade     precision                audio       W            power, filterbank
    "f32"     "f32", "highest"         f32         f32          f32
    "bf16x3"  None, "high", "bf16x3"   bf16 hi+lo  bf16 hi+lo   bf16 hi+lo
    "bf16x2"  "bf16x2"                 bf16        bf16 hi+lo   bf16
    "bf16"    "bf16"                   bf16        bf16         bf16

"bf16x2" is the JAX kernel's two-pass grade: W is split into its bf16 part
and the bf16 rounding of the rest (``split_bf16``) and the product is
``x @ W_hi + x @ W_lo``. "bf16x3" is its three-pass grade, the JAX kernel's
default (``precision=None`` and ``Precision.HIGH`` there, as here): the audio
is split the same way and the product is ``x_hi @ W_hi + x_hi @ W_lo + x_lo @
W_hi``; the power is split too and the mel product is ``p_hi @ fb_hi + p_lo @
fb_hi + p_hi @ fb_lo``. Only the lo x lo terms are dropped, ~2^-17 relative.
With ``out_dtype=torch.bfloat16`` the pre-log mel is rounded to bf16 before
the log, as the TPU kernel's bf16 output tiles are.

The plain "f32" is the float32 product, as the JAX package computes it on
the CPU. The JAX kernel's "f32" (``Precision.HIGHEST``) is six bf16 products
on the TPU's matrix unit, and so is the "tc" kernel's: every operand is split
into three bf16 parts, ``hi + mid + lo`` (``split_bf16(a, 3)``), and the
products of order at most lo are kept, ``x_hi W_hi + x_hi W_mid + x_mid W_hi
+ x_hi W_lo + x_mid W_mid + x_lo W_hi``, and the same six on the power and
the filterbank: the float32 product within ~2^-24 relative.

``log_mel_spectrogram_cuda`` runs the plain version for a tensor on the CPU
and a kernel for a tensor on a CUDA device. Which kernel is decided by the
grade and the geometry alone (``frontend_route``), never by a failure:

    "tc"   ``csrc/frontend_tc.cu``: both products on the tensor cores
           (``wgmma``), W streamed by bulk asynchronous copies. Every grade,
           when n_fft is a multiple of 16, hop is even, n_mels is a multiple
           of 8 and at most 80, and the tile's audio span, the ring and the
           filterbank fit a block's shared memory (``tc_shared_bytes``).
           "bf16x3" holds two spans (the bf16 part and the remainder) and
           fb_hi and fb_lo beside a ring of two slots: it fits at 512 / 200
           and 400 / 160 with 40 mels and at 400 / 160 with 80, not at 512 /
           200 with 80. "f32" holds the span in float32 and fb's three parts
           beside the same ring: it fits at 512 / 200 and 400 / 160 with 40
           mels, and with 80 where n_fft is at most 256 (fb one 128-bin
           half), as at 256 / 80 and 256 / 128.
    "fma"  ``csrc/frontend.cu``: float32 FMA on the CUDA cores. Every
           geometry the "tc" kernel does not serve ("f32" as the float32
           product; for "bf16x3": a product of two bf16 values is exact in
           float32, so FMA on the rounded operands computes each pass).

``route=`` forces one of the two and raises where it cannot serve.

Each kernel is compiled for a few frame tiles, the frames a block owns (the
counterpart of the JAX kernel's ``fb_block``; its ``row_block`` has none,
since a block here owns one clip): "tc" for 64, 128 and 256 frames at 40
mels and 128 at 80 (``TC_TILES``), "fma" for 16, 32 and 64 (``FMA_TILES``).
``frame_tile=None`` takes the default, 128 on "tc" and 32 on "fma". A
frame's sums run in the same order whatever tile holds it, so the output
does not depend on the tile. A tile that the route has no instance of, or
whose block does not fit, raises before any launch (``route_and_tile``).
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
    "f32": "f32", "highest": "f32",
    None: "bf16x3", "high": "bf16x3", "bf16x3": "bf16x3",
    "bf16x2": "bf16x2", "bf16": "bf16",
}
GRADES = ("f32", "bf16x3", "bf16x2", "bf16")
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


def split_bf16(a: np.ndarray, parts: int = 2) -> tuple[torch.Tensor, ...]:
    """bf16 split of a float32 array into ``parts`` bf16 tensors, each the
    bf16 rounding of what the ones before leave (each difference exact in
    float32): hi and lo, ``a ~ hi + lo``; with ``parts=3`` hi, mid and lo,
    ``a ~ hi + mid + lo`` within ~2^-24 relative."""
    rest = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    out = []
    for _ in range(parts):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].to(torch.float32)
    return tuple(out)


def _padded_bases(config: FrontendConfig, nbp: int) -> tuple[np.ndarray, np.ndarray]:
    """float32 W (n_fft, 2*nbp) [cos | -sin] and fb (nbp, n_mels), n_bins
    padded to nbp with zero columns and rows, which add exact zeros to the
    power and the mel."""
    n_bins = nyquist_crop_bins(config)
    w = windowed_dft_matrix(config.n_fft, n_bins)
    w_pad = np.zeros((config.n_fft, 2 * nbp), np.float32)
    w_pad[:, :n_bins] = w[:, :n_bins]
    w_pad[:, nbp : nbp + n_bins] = w[:, n_bins:]
    fb = mel_filterbank(config.n_freqs, config.n_mels, config.sample_rate, config.f_min, config.f_max)
    fb_pad = np.zeros((nbp, config.n_mels), np.float32)
    fb_pad[:n_bins] = fb[:n_bins]
    return w_pad, fb_pad


@functools.lru_cache(maxsize=32)
def frontend_bases(config: FrontendConfig, grade: str, device: torch.device):
    """(W, fb) on ``device`` for one geometry and grade, built once: the
    float32 operands of the plain version and of the "fma" kernel.

    W is (n_fft, 2*n_bins_pad) [cos | -sin] with the Hann window folded in;
    fb is (n_bins_pad, n_mels); n_bins is padded to a multiple of 4. For
    "bf16" W is rounded to bf16; for "bf16x2" it is hi + lo of
    ``split_bf16``, which float32 holds exactly (the two parts themselves:
    :func:`frontend_split_bases`). For "bf16x3" they are W_hi and fb_hi, the
    parts the three passes share (all four: :func:`frontend_split_bases`).
    """
    if grade == "bf16x3":
        w_hi, _, fb_hi, _ = frontend_split_bases(config, device)
        return w_hi, fb_hi
    w_pad, fb_pad = _padded_bases(config, _round_up(nyquist_crop_bins(config), 4))
    w_t, fb_t = torch.from_numpy(w_pad), torch.from_numpy(fb_pad)
    if grade == "bf16":
        w_t = round_bf16(w_t)
    elif grade == "bf16x2":
        hi, lo = split_bf16(w_pad)
        w_t = hi.to(torch.float32) + lo.to(torch.float32)
    if grade != "f32":
        fb_t = round_bf16(fb_t)
    return w_t.to(device), fb_t.to(device)


@functools.lru_cache(maxsize=8)
def frontend_split_bases(config: FrontendConfig, device: torch.device):
    """(W_hi, W_lo, fb_hi, fb_lo) as float32 on ``device``, shaped like
    :func:`frontend_bases`' W and fb: the ``split_bf16`` parts of both
    matrices: the operands of the plain version's passes ("bf16x2": W_hi
    and W_lo; "bf16x3": all four) and of the "fma" kernel's three."""
    w_pad, fb_pad = _padded_bases(config, _round_up(nyquist_crop_bins(config), 4))
    parts = (*split_bf16(w_pad), *split_bf16(fb_pad))
    return tuple(p.to(torch.float32).to(device) for p in parts)


# ---- the "tc" route's geometry and operand images (csrc/frontend_tc.cu) ----

TC_TILE = 128  # frames a block owns by default
TC_TILES = {40: (64, 128, 256), 80: (128,)}  # the tiles compiled at each mel width
FMA_TILE = 32  # the "fma" kernel's default tile
FMA_TILES = (16, 32, 64)  # its compiled tiles
FMA_CHUNK = 16  # rows of W its blocks stage at a time
TC_HALF_BINS = 128  # bins of one N = 256 tile of W: [re | im]
TC_STAGE_BYTES = 32768  # 64 rows of k of a tile
TC_SLOTS = 3  # stages of the ring
TC_SLOTS_X3 = 2  # stages of the ring of the split grades, "bf16x3" and "f32"
TC_MEL_WIDTHS = (40, 80)  # the mel product's N, compiled in
TC_MAX_SHARED = 232448  # 227 KB a block
ROUTES = ("tc", "fma")


def _tc_mel_width(n_mels: int):
    return next((n for n in TC_MEL_WIDTHS if n_mels <= n), None)


TC_PARTS = {"bf16": 1, "bf16x2": 1, "bf16x3": 2, "f32": 3}  # the bf16 parts of the split operands
TC_PASSES = {"bf16": 1, "bf16x2": 2, "bf16x3": 3, "f32": 6}  # the kernel's n_passes, its name for the grade


def tc_shared_bytes(config: FrontendConfig, grade: str = "bf16", frame_tile: int = None) -> int:
    """Shared memory of one block of the "tc" kernel with a tile of
    ``frame_tile`` frames (``TC_TILE`` for None): the ring, the filterbank's
    image, the tile's audio span in bf16, a full and an empty barrier a
    slot and the filterbank's. "bf16x3" has a ring of ``TC_SLOTS_X3`` slots
    and two of the rest: fb_hi and fb_lo, the span's bf16 part and its
    remainder. "f32" has the same ring, fb_hi, fb_mid and fb_lo, and the
    span once in float32. Only the span grows with the tile."""
    n_halves = -(-nyquist_crop_bins(config) // TC_HALF_BINS)
    span = ((frame_tile or TC_TILE) - 1) * config.hop_length + config.n_fft
    fb = n_halves * TC_HALF_BINS * _tc_mel_width(config.n_mels) * 2
    parts = TC_PARTS[grade]
    slots = TC_SLOTS if parts == 1 else TC_SLOTS_X3
    span_bytes = _round_up(span * 4, 16) if grade == "f32" else parts * _round_up(span * 2, 16)
    return slots * TC_STAGE_BYTES + parts * fb + span_bytes + (2 * slots + 1) * 8


def fma_shared_bytes(config: FrontendConfig, grade: str = "bf16", frame_tile: int = None) -> int:
    """Shared memory of one block of the "fma" kernel with a tile of
    ``frame_tile`` frames (``FMA_TILE`` for None), in float32 words times 4:
    the tile's span, FMA_CHUNK rows of W, the tile's power; "bf16x3" holds
    two spans (hi, lo) and two of W's rows (W_hi's, W_lo's)."""
    tile = frame_tile or FMA_TILE
    nbp = _round_up(nyquist_crop_bins(config), 4)
    parts = 2 if grade == "bf16x3" else 1
    span = (tile - 1) * config.hop_length + config.n_fft
    return 4 * (parts * _round_up(span, 4) + parts * FMA_CHUNK * 2 * nbp + tile * nbp)


def _tc_mel_n(config: FrontendConfig):
    """The mel width of the "tc" kernel that serves the geometry, shared
    memory aside, or None: n_fft a multiple of 16, hop even, n_mels a
    multiple of 8 and at most the widest compiled width."""
    ok = (config.n_fft >= 16 and config.n_fft % 16 == 0 and config.hop_length >= 2 and config.hop_length % 2 == 0
          and config.n_mels >= 8 and config.n_mels % 8 == 0)
    return _tc_mel_width(config.n_mels) if ok else None


def frontend_route(config: FrontendConfig, grade: str, frame_tile: int = None) -> str:
    """The kernel that serves a geometry and grade on a CUDA tensor with a
    tile of ``frame_tile`` frames (the default tile for None): "tc" where the
    tensor-core kernel has that tile at the geometry's mel width and its
    block fits, by the rule in the module's docstring, otherwise "fma"."""
    if grade not in GRADES:
        raise ValueError(f"unknown grade {grade!r}")
    tile, mel_n = frame_tile or TC_TILE, _tc_mel_n(config)
    fits = mel_n is not None and tile in TC_TILES[mel_n] and tc_shared_bytes(config, grade, tile) <= TC_MAX_SHARED
    return "tc" if fits else "fma"


def route_and_tile(config: FrontendConfig, grade: str, frame_tile: int = None, route: str = None) -> tuple:
    """(route, tile) of a launch: ``route`` if forced, else what
    :func:`frontend_route` settles for the tile; ``frame_tile=None`` takes
    the route's default tile. Raises ``ValueError`` before any launch for a
    forced "tc" that cannot serve the geometry, grade and tile, for a tile
    the route has no instance of, and for a block that does not fit a
    block's shared memory (saying how many bytes it would take)."""
    served = frontend_route(config, grade, frame_tile)  # raises on an unknown grade
    route = route or served
    mel_n = _tc_mel_n(config)
    tiles = FMA_TILES if route == "fma" else TC_TILES.get(mel_n, ())
    tile = frame_tile or (TC_TILE if route == "tc" else FMA_TILE)
    if tile not in tiles:
        raise ValueError(f"route={route!r} cannot serve grade {grade!r} with a {tile}-frame tile and {config}: "
                         f"its tiles are {tiles} (see frontend_route)")
    need = tc_shared_bytes(config, grade, tile) if route == "tc" else fma_shared_bytes(config, grade, tile)
    if need > TC_MAX_SHARED:
        raise ValueError(f"route={route!r} at grade {grade!r} with a {tile}-frame tile does not fit ({need} bytes "
                         f"of shared memory, {TC_MAX_SHARED} a block) with {config}")
    return route, tile


def tc_tile_columns(n_bins: int) -> np.ndarray:
    """For every column of W's tiles, the column of the (n_fft, 2*n_bins)
    [cos | -sin] matrix it holds, or -1 for a zero column: tile h is [re of
    bins 128h .. 128h + 127 | im of the same bins]."""
    n_halves = -(-n_bins // TC_HALF_BINS)
    bins = np.arange(n_halves * TC_HALF_BINS).reshape(n_halves, 1, TC_HALF_BINS)
    cols = np.concatenate([bins, bins + n_bins], axis=1)  # (n_halves, [re, im], 128)
    return np.where(bins < n_bins, cols, -1).reshape(-1)


def pack_w_image(w: torch.Tensor) -> torch.Tensor:
    """(n_passes, n_fft, n_halves * 256) tiles of W -> the flat image the
    kernel's ring copies and its ``wgmma`` descriptor reads.

    Element (p, k, 256h + n) goes to
    ``((((h * n_passes + p) * n_fft/16 + k // 16) * 2 + (k % 16) // 8) * 32 + n // 8) * 64 + (n % 8) * 8 + k % 8``:
    per half and pass, per 16 rows of k, two by 32 core matrices (8 columns
    by 8 consecutive k, 128 contiguous bytes); a stage of the ring is four
    such steps, 32 KB, one contiguous copy.
    """
    n_passes, n_fft, cols = w.shape
    n_halves = cols // (2 * TC_HALF_BINS)
    v = w.reshape(n_passes, n_fft // 16, 2, 8, n_halves, 32, 8)  # p, k16, kc, e, h, ng, r
    return v.permute(4, 0, 1, 2, 5, 6, 3).contiguous().reshape(-1)


def unpack_w_image(img: torch.Tensor, n_passes: int, n_fft: int, n_halves: int) -> torch.Tensor:
    """The inverse of :func:`pack_w_image`."""
    v = img.reshape(n_halves, n_passes, n_fft // 16, 2, 32, 8, 8)  # h, p, k16, kc, ng, r, e
    return v.permute(1, 2, 3, 6, 0, 4, 5).contiguous().reshape(n_passes, n_fft, n_halves * 2 * TC_HALF_BINS)


def pack_fb_image(fb: torch.Tensor) -> torch.Tensor:
    """(bins, mel_n) filterbank, bins a multiple of 16 and mel_n of 8 -> the
    flat image of the mel product's B operand, k the bin: element (k, n) goes
    to ``((k // 16 * 2 + (k % 16) // 8) * mel_n/8 + n // 8) * 64 + (n % 8) * 8 + k % 8``."""
    bins, mel_n = fb.shape
    v = fb.reshape(bins // 16, 2, 8, mel_n // 8, 8)  # k16, kc, e, ng, r
    return v.permute(0, 1, 3, 4, 2).contiguous().reshape(-1)


def unpack_fb_image(img: torch.Tensor, mel_n: int) -> torch.Tensor:
    """The inverse of :func:`pack_fb_image`."""
    v = img.reshape(-1, 2, mel_n // 8, 8, 8)  # k16, kc, ng, r, e
    return v.permute(0, 1, 4, 2, 3).contiguous().reshape(-1, mel_n)


def frontend_bases_tc(config: FrontendConfig, grade: str, device: torch.device, frame_tile: int = None):
    """The "tc" kernel's operands for a geometry and grade, :func:`_tc_images`;
    raises where that kernel does not serve them with a tile of
    ``frame_tile`` frames (the default tile for None)."""
    if frontend_route(config, grade, frame_tile) != "tc":
        raise ValueError(f"the tensor-core frontend kernel does not serve {config} at grade {grade!r}")
    return _tc_images(config, grade, device)


@functools.lru_cache(maxsize=32)
def _tc_images(config: FrontendConfig, grade: str, device: torch.device):
    """(W image, fb image, n_halves, n_passes, mel_n) on ``device`` for the
    "tc" kernel, built once per geometry and grade: bf16 W in tiles of 128
    bins (one pass for "bf16", hi then lo for "bf16x2" and "bf16x3", whose
    kernel multiplies W_hi by the audio's remainder too: n_passes 3 names
    that, over the same two passes of W; hi, mid and lo for "f32", n_passes
    6 for its six products) and the bf16 filterbank ("bf16x3": fb_hi's
    image, then fb_lo's; "f32": fb_hi's, fb_mid's and fb_lo's), its bins
    padded to whole tiles and its mels to mel_n with zeros, both packed as
    the kernel reads them, whatever the tile."""
    n_bins = nyquist_crop_bins(config)
    cols = tc_tile_columns(n_bins)
    w, fb = _padded_bases(config, n_bins)
    tiles = np.where(cols >= 0, w[:, np.maximum(cols, 0)], np.float32(0.0))
    passes = split_bf16(tiles, {"bf16": 1, "f32": 3}.get(grade, 2))  # W's parts: W, hi + lo or hi + mid + lo
    mel_n = _tc_mel_width(config.n_mels)
    fb_pad = np.zeros((len(cols) // 2, mel_n), np.float32)
    fb_pad[:n_bins, : config.n_mels] = fb
    w_img = pack_w_image(torch.stack(passes))
    fb_img = torch.cat([pack_fb_image(part) for part in split_bf16(fb_pad, TC_PARTS[grade])])
    return w_img.to(device), fb_img.to(device), len(cols) // (2 * TC_HALF_BINS), TC_PASSES[grade], mel_n


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
    frame_tile: int = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same contract, any device.
    ``frame_tile`` is checked as a launch would check it with no route
    forced (:func:`route_and_tile`); the output does not depend on it."""
    grade = frontend_grade(precision)
    audio = _check(audio, config, out_dtype, layout)
    if frame_tile is not None:
        route_and_tile(config, grade, frame_tile)
    b, num_samples = audio.shape
    hop, n_fft = config.hop_length, config.n_fft
    n_frames = config.num_frames(num_samples)
    n_sub = -(-n_fft // hop)
    rows = n_frames + n_sub - 1

    def hop_rows(x):
        padded = center_pad(x, config)
        extra = rows * hop - padded.shape[-1]
        if extra > 0:
            padded = torch.nn.functional.pad(padded, (0, extra))
        return padded[:, : rows * hop].reshape(b, rows, hop)

    w, fb = frontend_bases(config, grade, audio.device)
    # (hop rows, W) of each pass; a rounding to bf16 commutes with the reflect and zero padding
    if grade == "bf16x3":
        # x_hi @ W_hi + x_hi @ W_lo + x_lo @ W_hi, as the JAX kernel's three passes
        hi = round_bf16(audio)
        x_hi, x_lo = hop_rows(hi), hop_rows(round_bf16(audio - hi))
        w_hi, w_lo, fb_hi, fb_lo = frontend_split_bases(config, audio.device)
        passes = ((x_hi, w_hi), (x_hi, w_lo), (x_lo, w_hi))
    elif grade == "bf16x2":
        # W's bf16 part, then the bf16 rounding of the rest
        x = hop_rows(round_bf16(audio))
        passes = tuple((x, wp) for wp in frontend_split_bases(config, audio.device)[:2])
    else:
        passes = ((hop_rows(audio if grade == "f32" else round_bf16(audio)), w),)
    acc = None
    for j in range(n_sub):
        width = min(hop, n_fft - j * hop)
        term = None
        for hview, wp in passes:
            # rows past the block's true width multiply the next hop row by zero
            wj = torch.nn.functional.pad(wp[j * hop : j * hop + width], (0, 0, 0, hop - width))
            part = hview[:, j : j + n_frames] @ wj
            term = part if term is None else term + part
        acc = term if acc is None else acc + term
    nbp = fb.shape[0]
    re, im = acc[..., :nbp], acc[..., nbp:]
    power = re * re + im * im
    if grade == "bf16x3":
        p_hi = round_bf16(power)
        p_lo = round_bf16(power - p_hi)
        mel = p_hi @ fb_hi + (p_lo @ fb_hi + p_hi @ fb_lo)  # (B, T, n_mels)
    else:
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
    route: str = None,
    frame_tile: int = None,
) -> torch.Tensor:
    """(B, samples) float32 -> ZMUV'd log-mels, (B, n_mels, frames) for
    ``layout="fm"`` or (B, frames, n_mels) for ``"tm"``, in ``out_dtype``.

    On a CPU tensor this is :func:`log_mel_spectrogram_plain`. On a CUDA
    tensor it launches the kernel that :func:`frontend_route` names for the
    geometry and grade, ``howl_logmel_tc_forward`` ("tc") or
    ``howl_logmel_forward`` ("fma"), or raises. ``route`` forces one of the
    two on a CUDA tensor and raises where that kernel cannot serve.
    ``frame_tile`` picks the kernel's tile (None: the route's default); a
    tile the route has no instance of or cannot hold raises before any
    launch (:func:`route_and_tile`). The kernels have no backward: audio
    that requires grad raises while grad mode is on. ``launches`` counts every kernel launch, ``launches_tc``
    those of the "tc" kernel, ``launches_by_tile[route, tile]`` those of
    each instance.
    """
    _build.refuse_grad("log_mel_spectrogram_cuda", audio)
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    if audio.device.type == "cpu":
        if route is not None:
            raise ValueError(f"route={route!r} names a CUDA kernel: a CPU tensor takes the plain version")
        return log_mel_spectrogram_plain(audio, config, zmuv_mean, zmuv_std, precision, out_dtype, layout,
                                         frame_tile)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel_spectrogram_cuda takes CPU or CUDA tensors, got {audio.device}")
    grade = frontend_grade(precision)
    audio = _check(audio, config, out_dtype, layout)
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    b, num_samples = audio.shape
    route, tile = route_and_tile(config, grade, frame_tile, route)
    n_frames = config.num_frames(num_samples)
    n_mels = config.n_mels
    shape = (b, n_mels, n_frames) if layout == "fm" else (b, n_frames, n_mels)
    out = torch.empty(shape, dtype=out_dtype, device=audio.device)
    mean, inv_std = _zmuv_scalars(zmuv_mean, zmuv_std)
    out_bf16, stream = int(out_dtype == torch.bfloat16), torch.cuda.current_stream(audio.device).cuda_stream
    lib = _build.kernel_library()
    with torch.cuda.device(audio.device):
        if route == "tc":
            w_img, fb_img, n_halves, n_passes, mel_n = frontend_bases_tc(config, grade, audio.device, tile)
            status = lib.howl_logmel_tc_forward(
                audio.data_ptr(), w_img.data_ptr(), fb_img.data_ptr(), out.data_ptr(),
                b, num_samples, n_frames, config.n_fft, config.hop_length, int(config.center),
                n_halves, n_passes, n_mels, mel_n, tile, out_bf16, int(layout == "fm"),
                config.log_offset, mean, inv_std, stream,
            )
        else:
            w, fb = frontend_bases(config, grade, audio.device)
            # "bf16x3" passes the lo parts too, and the kernel splits the audio and the power itself
            w_lo, fb_lo = frontend_split_bases(config, audio.device)[1::2] if grade == "bf16x3" else (None, None)
            rounds = int(grade in ("bf16x2", "bf16"))
            status = lib.howl_logmel_forward(
                audio.data_ptr(), w.data_ptr(), fb.data_ptr(),
                None if w_lo is None else w_lo.data_ptr(), None if fb_lo is None else fb_lo.data_ptr(),
                out.data_ptr(), b, num_samples, n_frames, config.n_fft, config.hop_length, int(config.center),
                fb.shape[0], n_mels, rounds, rounds, out_bf16, out_bf16, int(layout == "fm"),
                config.log_offset, mean, inv_std, tile, stream,
            )
    _build.check_launch(status, f"log-mel ({route})")
    log_mel_spectrogram_cuda.launches += 1
    if route == "tc":
        log_mel_spectrogram_cuda.launches_tc += 1
    by_tile = log_mel_spectrogram_cuda.launches_by_tile
    by_tile[route, tile] = by_tile.get((route, tile), 0) + 1
    return out


log_mel_spectrogram_cuda.launches = 0
log_mel_spectrogram_cuda.launches_tc = 0
log_mel_spectrogram_cuda.launches_by_tile = {}  # {(route, tile): launches}
