"""The res8 trunk-kernel study's two kernels, their plain PyTorch versions and
their geometry (counterpart of ``tools/bench_trunk_kernel_micro.py``).

T1, the fused six-layer residual trunk proto (``csrc/trunk_proto.cu``,
replacing the Pallas ``kernel`` of ``make_proto``): activations are
position-major, (B, pos_pad, 48) bf16 with position p = t * 10 + f and the
45 res8 channels padded to 48. For layer L = 0..5

    acc = sum over the 9 taps (dt, df) of x[p + 10 dt + df] @ W_L[tap rows]

in float32, rows of W_L ordered (tap, c_in) with tap = 3 (dt + 1) + (df + 1);
reads outside [0, pos_pad) are zero, taps with df = -1 are masked where
p % 10 == 0 and taps with df = +1 where p % 10 == 9. Then y = relu(acc),
r = y + res for odd L (else y); for L < 5 the next x is
bf16(where(p < pos, (r - shift[L]) * scale[L], 0)), and res = x after odd L;
r6 = r at L = 5. res starts as the layer-0 input, whose tail rows
[pos, pos_pad) are used as given. The output is
(pool_t @ bf16(r6) - shift[6]) * scale[7], (B, n_win_pad, 48) float32.
With ``full_build=False`` (the tool's gemm-only variant) every layer's GEMM
reads the taps of the layer-0 input; the updated x feeds only res. The kernel
reads W as the image ``pack_trunk_w_image`` builds (each layer the K-major
operand of a ``wgmma`` descriptor) and pool_t as ``pack_trunk_pool_image``
builds it (each thread's A fragments over a tile's slot rows, 12 rows a
pooled frame: ``trunk_slot_rows``).

T2, the banded-fold stem proto (``csrc/stem_fold.cu``, replacing
``stem_kernel``): for xpre (B, 3, 224, 120) and w0fold (120, 4 * 512), both
bf16, out[b, q, n] = (1/12) sum_{j<4} sum_{r<3} relu(xpre[b, r, q] @
w0fold[:, 512 j + n]), float32 sums, in bf16 or float32. The kernel reads
w0fold as the image ``pack_fold_image`` builds: per slice of 32 columns of
each j-block, the (128, 128) operand of one ``wgmma`` in its descriptor's
K-major 128-byte-swizzled layout.

Neither is res8's function: the proto adds the post-affine x as its
residual, sums each window's positions instead of averaging and applies
layer 6's affine after the pool, and ``w0fold`` is random. They model the
cost of res8's trunk and stem, as the JAX tool's kernels do.

Each ``*_cuda`` wrapper runs its plain version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device, or raises; it refuses
inputs that require grad, since neither kernel has a backward.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from howl_tpu_torch.ops import _build
from howl_tpu_torch.ops.frontend import FrontendConfig

# trunk geometry at the serving recipe (hey-firefox defaults)
F_OUT = 10  # pooled mel bins (40 mels / pool_f 4)
CH = 45  # res8 num_maps
CH_PAD = 48  # channels padded to a multiple of 16
TAPS = [(dt, df) for dt in (-1, 0, 1) for df in (-1, 0, 1)]
K_ROWS = 9 * CH_PAD  # 432 rows of each layer's weight
N_WIN = 121  # (641 - 41) // 5 + 1 windows at the serving geometry
SPAN = 13  # 41-frame window / pool_t 3
Q_ROWS = 224  # the stem proto's pooled rows q (t' = q - 1), padded
STEM_K = 120  # [mel(dt=-1) | mel(0) | mel(+1)] lanes of the banded fold
STEM_N = 512  # one f-pool block of the fold's columns; w0fold has 4
FOLD_SLICE = 32  # columns of each j-block one block of the T2 kernel owns
FOLD_SLICES = STEM_N // FOLD_SLICE  # 16
FOLD_K_PAD = 128  # STEM_K padded to whole k16 steps
TRUNK_SLOTS = 12  # rows of a pooled frame in the T1 kernel's shared memory: a zero slot each side of its 10
TRUNK_TILE = 44  # pooled frames a T1 tile keeps (kT in csrc/trunk_proto.cu)
TRUNK_POOL_WINDOWS = 128  # windows the T1 kernel's pool product covers: two warpgroups of 64
TRUNK_POOL_STEPS = TRUNK_TILE * TRUNK_SLOTS // 16  # k16 steps of a tile's pool product (33)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class TrunkGeometry:
    """The tool's geometry for clips of ``clip_seconds`` at 16 kHz, 40 mels."""

    n_frames: int  # log-mel frames (641 at 8 s)
    t_out: int  # pooled trunk frames (213)
    pos: int  # flattened (t, f) positions (2130)
    pos_pad: int  # padded to a multiple of 128 (2176)
    n_win: int = N_WIN
    n_win_pad: int = _round_up(N_WIN, 128)
    span: int = SPAN


def trunk_geometry(clip_seconds: float) -> TrunkGeometry:
    n_frames = FrontendConfig(n_mels=40).num_frames(int(clip_seconds * 16000))
    t_out = n_frames // 3
    pos = t_out * F_OUT
    return TrunkGeometry(n_frames, t_out, pos, _round_up(pos, 128))


def build_pool_matrix(geom: TrunkGeometry) -> np.ndarray:
    """(pos_pad, n_win_pad) float32: column w is 1 on the positions of window
    w's ``span`` pooled frames, which start at round(5 w / 3) clipped to
    [0, t_out - span] (clips shorter than 8 s clip many starts)."""
    m = np.zeros((geom.pos_pad, geom.n_win_pad), np.float32)
    starts = np.clip(np.round(np.arange(geom.n_win) * 5 / 3).astype(np.int32), 0, geom.t_out - geom.span)
    for w in range(geom.n_win):
        lo, hi = starts[w] * F_OUT, (starts[w] + geom.span) * F_OUT
        m[lo:hi, w] = 1.0
    return m


def stem_prep(mel: torch.Tensor) -> torch.Tensor:
    """(B, n_frames, 40) -> X_pre (B, 3, 224, 120): X_pre[b, r, q, 40 (dt + 1) + f]
    = mel[b, 3 (q - 1) + r + dt, f], zeros outside the clip."""
    b, n_frames, _ = mel.shape
    mel_big = F.pad(mel, (0, 0, 4, 676 - 4 - n_frames))
    parts = []
    for dt in (-1, 0, 1):
        bdt = mel_big[:, dt + 1 : dt + 1 + 3 * Q_ROWS].reshape(b, Q_ROWS, 3, 40)
        parts.append(bdt.transpose(1, 2))  # (B, 3, 224, 40)
    return torch.cat(parts, dim=-1)


# ---- T1: the fused six-layer trunk proto ----


def _check_proto(x, ws, pool_t, bn_scale, bn_shift, pos) -> None:
    if x.ndim != 3 or x.shape[2] != CH_PAD or x.dtype != torch.bfloat16:
        raise ValueError(f"expected (B, pos_pad, {CH_PAD}) bf16 activations, got {tuple(x.shape)} {x.dtype}")
    pos_pad = x.shape[1]
    if tuple(ws.shape) != (6, K_ROWS, CH_PAD) or ws.dtype != torch.bfloat16:
        raise ValueError(f"expected 6 x ({K_ROWS}, {CH_PAD}) bf16 weights, got {tuple(ws.shape)} {ws.dtype}")
    if pool_t.ndim != 2 or pool_t.shape[1] != pos_pad or pool_t.dtype != torch.bfloat16:
        raise ValueError(f"expected (n_win_pad, {pos_pad}) bf16 pool_t, got {tuple(pool_t.shape)} {pool_t.dtype}")
    for name, t in (("bn_scale", bn_scale), ("bn_shift", bn_shift)):
        if tuple(t.shape) != (8, CH_PAD) or t.dtype != torch.float32:
            raise ValueError(f"expected (8, {CH_PAD}) float32 {name}, got {tuple(t.shape)} {t.dtype}")
    for t in (ws, pool_t, bn_scale, bn_shift):
        if t.device != x.device:
            raise ValueError(f"an operand on {t.device}, activations on {x.device}")
    if not 0 <= pos <= pos_pad:
        raise ValueError(f"pos {pos} outside [0, {pos_pad}]")


def _taps_im2col(x: torch.Tensor) -> torch.Tensor:
    """(B, P, 48) -> (B, P, 432): the 9 shifted, f-edge-masked tap reads,
    zero outside [0, P)."""
    p_len = x.shape[1]
    xh = F.pad(x, (0, 0, 11, 11))
    fidx = torch.arange(p_len, device=x.device) % F_OUT
    cols = []
    for dt, df in TAPS:
        off = dt * F_OUT + df
        src = xh[:, 11 + off : 11 + off + p_len]
        if df == -1:
            src = torch.where((fidx > 0)[:, None], src, torch.zeros((), dtype=x.dtype, device=x.device))
        elif df == 1:
            src = torch.where((fidx < F_OUT - 1)[:, None], src, torch.zeros((), dtype=x.dtype, device=x.device))
        cols.append(src)
    return torch.cat(cols, dim=-1)


def trunk_proto_plain(x, ws, pool_t, bn_scale, bn_shift, pos: int, full_build: bool = True) -> torch.Tensor:
    """The plain version of T1: a 9-tap im2col and one matmul per layer.
    x and res are bf16, every GEMM sums bf16 products in float32 (inputs
    widened to float32: on a card this needs TF32 off), ReLU, the residual
    and the affine run in float32 and r6 is rounded to bf16 before the
    pool GEMM."""
    _check_proto(x, ws, pool_t, bn_scale, bn_shift, pos)
    keep = (torch.arange(x.shape[1], device=x.device) < pos)[:, None]
    w32 = ws.float()
    im = _taps_im2col(x).float()
    res = x
    for layer in range(6):
        if full_build and layer > 0:
            im = _taps_im2col(x).float()
        r = torch.relu(im @ w32[layer])
        if layer % 2 == 1:
            r = r + res.float()
        if layer < 5:
            xa = (r - bn_shift[layer]) * bn_scale[layer]
            x = torch.where(keep, xa, torch.zeros((), device=x.device)).to(torch.bfloat16)
            if layer % 2 == 1:
                res = x
    pooled = pool_t.float() @ r.to(torch.bfloat16).float()
    return (pooled - bn_shift[6]) * bn_scale[7]


def pack_trunk_w_image(ws: torch.Tensor) -> torch.Tensor:
    """(6, 432, 48) weights -> the flat image the T1 kernel's ``wgmma`` B
    descriptors read, 41,472 bytes a layer: element (k, n) of layer L at
    element ``L * 20736 + (k // 8) * 384 + (n // 8) * 64 + (n % 8) * 8 + k % 8``,
    cores of 8 n by 8 consecutive k (K-major, no swizzle)."""
    return ws.reshape(6, K_ROWS // 8, 8, CH_PAD // 8, 8).permute(0, 1, 3, 4, 2).contiguous().reshape(-1)


def unpack_trunk_w_image(img: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_trunk_w_image`: (6, 432, 48)."""
    return img.reshape(6, K_ROWS // 8, CH_PAD // 8, 8, 8).permute(0, 1, 4, 2, 3).reshape(6, K_ROWS, CH_PAD)


def trunk_tiles(pos_pad: int) -> int:
    """Tiles of ``TRUNK_TILE`` pooled frames the T1 kernel walks a clip in."""
    n_frames = -(-pos_pad // F_OUT)
    return -(-n_frames // TRUNK_TILE)


def trunk_slot_rows(pos_pad: int, device=None) -> tuple:
    """(position, valid) of each slot row of the T1 kernel's tiles, for all
    ``trunk_tiles(pos_pad) * TRUNK_TILE * 12`` of them: row q is slot q % 12
    of pooled frame q // 12 and holds position 10 (q // 12) + q % 12 - 1
    when its slot is 1-10 and that position is below pos_pad; otherwise it
    is zero."""
    q = torch.arange(trunk_tiles(pos_pad) * TRUNK_TILE * TRUNK_SLOTS, device=device)
    slot = q % TRUNK_SLOTS
    p = q // TRUNK_SLOTS * F_OUT + slot - 1
    return p, (slot >= 1) & (slot <= F_OUT) & (p < pos_pad)


def pack_trunk_pool_image(pool_t: torch.Tensor) -> torch.Tensor:
    """(n_win_pad, pos_pad) pool_t -> the A fragments of the T1 kernel's pool
    product, flat. A is pool_t over the slot rows of :func:`trunk_slot_rows`
    (zero columns at the slots and past pos_pad, zero rows past n_win_pad,
    128 rows). For tile j, k16 step ks, warpgroup wg and thread 32 w + 4 g + t
    of it, 16 bytes hold its four registers e = 0..3, two bf16 each:
    A[64 wg + 16 w + g + 8 (e % 2), 528 j + 16 ks + 2 t + 8 (e // 2) + h] at
    h = 0, 1, the order of the ``wgmma`` A fragment."""
    n_win_pad, pos_pad = pool_t.shape
    n_tiles = trunk_tiles(pos_pad)
    p, valid = trunk_slot_rows(pos_pad, pool_t.device)
    a = torch.zeros((TRUNK_POOL_WINDOWS, p.numel()), dtype=pool_t.dtype, device=pool_t.device)
    a[:n_win_pad, valid] = pool_t[:, p[valid]]
    # rows (wg, w, e % 2, g), columns (tile, ks, e // 2, t, h) -> (tile, ks, wg, w, g, t, e // 2, e % 2, h)
    v = a.reshape(2, 4, 2, 8, n_tiles, TRUNK_POOL_STEPS, 2, 4, 2).permute(4, 5, 0, 1, 3, 7, 6, 2, 8)
    return v.contiguous().reshape(-1)


def unpack_trunk_pool_image(img: torch.Tensor, pos_pad: int) -> torch.Tensor:
    """The inverse of :func:`pack_trunk_pool_image` on the clip's positions:
    (128, pos_pad), the rows past n_win_pad zero."""
    n_tiles = trunk_tiles(pos_pad)
    v = img.reshape(n_tiles, TRUNK_POOL_STEPS, 2, 4, 8, 4, 2, 2, 2).permute(2, 3, 7, 4, 0, 1, 6, 5, 8)
    a = v.reshape(TRUNK_POOL_WINDOWS, -1)
    p, valid = trunk_slot_rows(pos_pad, img.device)
    out = torch.zeros((TRUNK_POOL_WINDOWS, pos_pad), dtype=img.dtype, device=img.device)
    out[:, p[valid]] = a[:, valid]
    return out


def trunk_proto_cuda(x, ws, pool_t, bn_scale, bn_shift, pos: int, full_build: bool = True) -> torch.Tensor:
    """x (B, pos_pad, 48) bf16, ws (6, 432, 48) bf16, pool_t (n_win_pad,
    pos_pad) bf16, bn_scale and bn_shift (8, 48) float32 -> (B, n_win_pad,
    48) float32. On a CPU tensor this is :func:`trunk_proto_plain`; on a CUDA
    tensor it launches ``howl_trunk_proto_forward`` or raises."""
    _build.refuse_grad("trunk_proto_cuda", x, ws, pool_t, bn_scale, bn_shift)
    if x.device.type == "cpu":
        return trunk_proto_plain(x, ws, pool_t, bn_scale, bn_shift, pos, full_build)
    if x.device.type != "cuda":
        raise ValueError(f"trunk_proto_cuda takes CPU or CUDA tensors, got {x.device}")
    _check_proto(x, ws, pool_t, bn_scale, bn_shift, pos)
    b, pos_pad, _ = x.shape
    n_win_pad = pool_t.shape[0]
    if pos_pad % 16 or n_win_pad % 16 or n_win_pad > 128:
        raise ValueError(f"the kernel takes pos_pad a multiple of 16 and n_win_pad a multiple of 16 up to 128, "
                         f"got {pos_pad} and {n_win_pad}")
    if not all(t.is_contiguous() for t in (x, ws, pool_t, bn_scale, bn_shift)):
        raise ValueError("trunk_proto_cuda's operands must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("the trunk proto kernel copies x in 16-byte pieces: x must be 16-byte aligned")
    out = torch.empty((b, n_win_pad, CH_PAD), dtype=torch.float32, device=x.device)
    lib = _build.kernel_library()
    with torch.cuda.device(x.device):
        w_img = _build.packed_operand(pack_trunk_w_image, ws)
        pool_img = _build.packed_operand(pack_trunk_pool_image, pool_t)
        status = lib.howl_trunk_proto_forward(
            x.data_ptr(), w_img.data_ptr(), pool_img.data_ptr(), bn_scale.data_ptr(), bn_shift.data_ptr(),
            out.data_ptr(), b, pos, pos_pad, n_win_pad, int(full_build),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check_launch(status, "trunk proto")
    trunk_proto_cuda.launches += 1
    return out


trunk_proto_cuda.launches = 0


# ---- T2: the banded-fold stem proto ----


def _check_stem(xpre, w0fold, out_dtype) -> None:
    if xpre.ndim != 4 or xpre.shape[1] != 3 or xpre.shape[3] != STEM_K or xpre.dtype != torch.bfloat16:
        raise ValueError(f"expected (B, 3, q_rows, {STEM_K}) bf16 xpre, got {tuple(xpre.shape)} {xpre.dtype}")
    if tuple(w0fold.shape) != (STEM_K, 4 * STEM_N) or w0fold.dtype != torch.bfloat16:
        raise ValueError(f"expected ({STEM_K}, {4 * STEM_N}) bf16 w0fold, got {tuple(w0fold.shape)} {w0fold.dtype}")
    if w0fold.device != xpre.device:
        raise ValueError(f"w0fold on {w0fold.device}, xpre on {xpre.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")


def stem_fold_plain(xpre: torch.Tensor, w0fold: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version of T2: one float32 matmul of all three planes, the
    relu'd planes summed in order, then the four column blocks, times 1/12."""
    _check_stem(xpre, w0fold, out_dtype)
    g = torch.relu(xpre.float() @ w0fold.float())  # (B, 3, q_rows, 2048)
    acc = g[:, 0] + g[:, 1] + g[:, 2]
    n = STEM_N
    pooled = (acc[..., :n] + acc[..., n : 2 * n] + acc[..., 2 * n : 3 * n] + acc[..., 3 * n :]) * (1.0 / 12.0)
    return pooled.to(out_dtype)


def _swizzle_index(device) -> torch.Tensor:
    """(128, 8): for row n of a 128-byte-swizzled image, the 16-byte chunk
    stored at each place, c ^ (n % 8); the map is its own inverse."""
    n = torch.arange(4 * FOLD_SLICE, device=device)[:, None]
    return torch.arange(8, device=device)[None, :] ^ (n % 8)


def pack_fold_image(w0fold: torch.Tensor) -> torch.Tensor:
    """(120, 2048) bf16 w0fold -> the flat image the T2 kernel's ``wgmma``
    descriptor reads, 16 slices of 32 KB.

    Slice s is the B operand (k, n) of one product, k < 128 (rows 120-127
    zero) and n = 32 j + nl holding w0fold[k, 512 j + 32 s + nl]. Element (k,
    n) of slice s lies at byte ``s * 32768 + (k // 64) * 16384 + n * 128 +
    16 * ((k % 64 // 8) ^ (n % 8)) + 2 * (k % 8)``: rows of 64 k, 128 bytes,
    their 16-byte chunks permuted by the row's place in its 1,024-byte atom.
    """
    w = F.pad(w0fold, (0, 0, 0, FOLD_K_PAD - STEM_K))
    v = w.reshape(FOLD_K_PAD, 4, FOLD_SLICES, FOLD_SLICE).permute(2, 1, 3, 0)  # s, j, nl, k
    v = v.reshape(FOLD_SLICES, 4 * FOLD_SLICE, FOLD_K_PAD // 64, 8, 8).permute(0, 2, 1, 3, 4)  # s, kb, n, chunk, e
    idx = _swizzle_index(w.device)[None, None, :, :, None].expand(v.shape)
    return v.gather(3, idx).contiguous().reshape(-1)


def unpack_fold_image(img: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_fold_image`, the K padding included:
    (128, 2048)."""
    v = img.reshape(FOLD_SLICES, FOLD_K_PAD // 64, 4 * FOLD_SLICE, 8, 8)  # s, kb, n, place, e
    v = v.gather(3, _swizzle_index(img.device)[None, None, :, :, None].expand(v.shape))
    v = v.permute(0, 2, 1, 3, 4).reshape(FOLD_SLICES, 4, FOLD_SLICE, FOLD_K_PAD)  # s, j, nl, k
    return v.permute(3, 1, 0, 2).reshape(FOLD_K_PAD, 4 * STEM_N)


def stem_fold_cuda(xpre: torch.Tensor, w0fold: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """xpre (B, 3, q_rows, 120) and w0fold (120, 2048), bf16 -> (B, q_rows,
    512) in ``out_dtype``. On a CPU tensor this is :func:`stem_fold_plain`;
    on a CUDA tensor it launches ``howl_stem_fold_forward`` or raises."""
    _build.refuse_grad("stem_fold_cuda", xpre, w0fold)
    if xpre.device.type == "cpu":
        return stem_fold_plain(xpre, w0fold, out_dtype)
    if xpre.device.type != "cuda":
        raise ValueError(f"stem_fold_cuda takes CPU or CUDA tensors, got {xpre.device}")
    _check_stem(xpre, w0fold, out_dtype)
    if not (xpre.is_contiguous() and w0fold.is_contiguous()):
        raise ValueError("stem_fold_cuda's operands must be contiguous")
    if xpre.data_ptr() % 16:
        raise ValueError("the stem fold kernel copies xpre's rows in bulk: xpre must be 16-byte aligned")
    b, _, q_rows, _ = xpre.shape
    out = torch.empty((b, q_rows, STEM_N), dtype=out_dtype, device=xpre.device)
    lib = _build.kernel_library()
    with torch.cuda.device(xpre.device):
        w_img = _build.packed_operand(pack_fold_image, w0fold)
        status = lib.howl_stem_fold_forward(
            xpre.data_ptr(), w_img.data_ptr(), out.data_ptr(), b, q_rows, int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(xpre.device).cuda_stream,
        )
    _build.check_launch(status, "stem fold")
    stem_fold_cuda.launches += 1
    return out


stem_fold_cuda.launches = 0
