"""The frontend cost study's three kernels, their plain PyTorch versions and
their geometry (counterpart of what ``tools/bench_pallas_micro.py`` defines
inside ``main``).

The study takes the log-mel frontend's shape apart: what it costs to move
the frames, and what the DFT product on top of that costs. Its operands are
the materialised frames tensor x (total, 512) float32, a random W (512, 512)
in bf16, the hop-row view of the audio H (B, rows, 200) float32, and a scalar
s that is added to the large operand before anything else.

M1, the stream leg (``csrc/micro_stream.cu``, replacing ``stream_kernel``):
every row of x is staged on chip whole; out = x[:, :128] + s, (total, 128).

M2, the GEMM legs (``csrc/micro_gemm.cu``, replacing ``gemm_kernel``):
xb = bf16(x + s); acc = the sum over ``n_dots`` of xb @ W, float32 sums, the
whole 512-wide product; out = acc[:, :128], (total, 128) float32. The kernel
reads W as the image ``pack_gemm_w_image`` builds: stages of 64 k by 256 n,
each the operand of a ``wgmma`` descriptor in the 128-byte swizzle.

M3, the polyphase legs (``csrc/micro_poly.cu``, replacing ``poly_kernel``):
hb = bf16(H + s); acc[t] = sum over j < 3 of hb[t + j] @ W_j for t < t_pad,
W_j the rows [200 j, 200 j + 200) of W, zero below row 512; repeated
``n_dots`` times, every pass from zero; out = acc[..., :128], (B, t_pad, 128)
float32. Frame t of a clip is the 512 samples from hop row t on, so M3 on H
equals M2 on those frames (up to the order of the sums) without the frames
tensor ever being written. The kernel holds a tile's hop rows chunk-major
and reads W as the image ``pack_poly_w_image`` builds: per pass of 256
columns the 33 k16 steps of ``POLY_STEPS``, each the operand of a ``wgmma``
descriptor without swizzle.

None of them is a function the frontend calls: they model its costs, as the
JAX tool's kernels do. Each ``*_cuda`` wrapper runs its plain version for a
tensor on the CPU and launches its kernel for a tensor on a CUDA device, or
raises; it refuses inputs that require grad, since no kernel has a backward.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from howl_tpu_torch.ops import _build
from howl_tpu_torch.ops.frontend import FrontendConfig

STREAM_FB = 256  # frame rows per block of the stream and GEMM legs: `total` is a multiple of it
POLY_FB = 128  # frames per block of the polyphase legs: `t_pad` is a multiple of it
OUT_COLS = 128  # columns every leg stores
GEMM_PASS_N = 256  # columns of one pass of the M2 kernel, and of a stage of its W image
GEMM_STAGE_K = 64  # k of a stage of the M2 kernel's W image: one 128-byte row of the swizzle
POLY_PASS_N = 256  # columns of one pass of the M3 kernel, and of a pass of its W image
# k16 steps of an M3 pass per W_j: a hop row's 200 samples and a chunk of zeros for W_0 and W_1, W_2's 112
# nonzero rows alone
POLY_STEPS = (13, 13, 7)
POLY_CHUNKS = 26  # 16-byte chunks of a hop row in the M3 kernel's A: 25 of samples, one of zeros


@dataclass(frozen=True)
class MicroGeometry:
    """The study's geometry for ``batch`` clips of ``clip_seconds`` at 16 kHz."""

    batch: int
    samples: int  # per clip
    n_fft: int  # 512
    hop: int  # 200
    n_frames: int  # frames per clip, center-padded (641 at 8 s)
    total: int  # frame rows of the stream and GEMM legs: batch * n_frames cut to whole blocks
    n_blocks: int  # total // STREAM_FB
    n_sub: int  # hop rows a frame spans (3)
    t_pad: int  # frames per clip of the polyphase legs (640 at 8 s)
    rows: int  # hop rows per clip of H: t_pad plus one block, so every tile's halo exists


def micro_geometry(batch: int, clip_seconds: float, config: FrontendConfig = FrontendConfig(n_mels=40)) -> MicroGeometry:
    samples = int(clip_seconds * config.sample_rate)
    t = config.num_frames(samples)
    total = batch * t - (batch * t) % STREAM_FB
    t_pad = t - t % POLY_FB if t % POLY_FB else t
    return MicroGeometry(
        batch, samples, config.n_fft, config.hop_length, t, total, total // STREAM_FB,
        -(-config.n_fft // config.hop_length), t_pad, t_pad + POLY_FB,
    )


def hop_view(audio: torch.Tensor, geom: MicroGeometry) -> torch.Tensor:
    """(B, samples) -> H (B, rows, hop): the audio as it is (no center
    padding), zero-padded to ``rows`` whole hop rows."""
    need = geom.rows * geom.hop
    return F.pad(audio, (0, need - audio.shape[-1])).reshape(audio.shape[0], geom.rows, geom.hop)


def poly_weight_blocks(w: torch.Tensor, hop: int) -> torch.Tensor:
    """W (n_fft, n) -> (n_sub, hop, n): block j holds W's rows [hop j,
    hop j + hop), zero-padded below row n_fft, so that a whole hop row
    multiplies every block."""
    n_fft = w.shape[0]
    n_sub = -(-n_fft // hop)
    return F.pad(w, (0, 0, 0, n_sub * hop - n_fft)).reshape(n_sub, hop, w.shape[1])


def _scalar(s) -> float:
    if isinstance(s, torch.Tensor):
        raise TypeError("s is a Python number: it is passed to the launch by value")
    return float(s)


def _check_frames(what: str, x: torch.Tensor) -> None:
    if x.ndim != 2 or x.shape[1] < OUT_COLS or x.dtype != torch.float32:
        raise ValueError(f"{what}: expected (total, n_fft) float32 frames, got {tuple(x.shape)} {x.dtype}")


def _check_w(what: str, w: torch.Tensor, n_fft: int, like: torch.Tensor) -> None:
    if tuple(w.shape) != (n_fft, n_fft) or w.dtype != torch.bfloat16:
        raise ValueError(f"{what}: expected ({n_fft}, {n_fft}) bf16 w, got {tuple(w.shape)} {w.dtype}")
    if w.device != like.device:
        raise ValueError(f"{what}: w on {w.device}, the large operand on {like.device}")


def _check_n_dots(what: str, n_dots: int) -> None:
    if not isinstance(n_dots, int) or n_dots < 1:
        raise ValueError(f"{what}: n_dots must be a positive int, got {n_dots!r}")


def _check_kernel_operands(what: str, n_fft: int, *tensors) -> None:
    """What the kernels take beyond the plain versions: the default frame
    width, contiguous and 16-byte aligned operands."""
    if n_fft != 512:
        raise ValueError(f"{what}: the kernel is built for n_fft 512, got {n_fft}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}'s operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}'s operands must be 16-byte aligned")


# ---- M1: the stream leg ----


def stream_plain(x: torch.Tensor, s: float) -> torch.Tensor:
    """The plain version of M1: the slice and one float32 add. It reads the
    first 128 columns only, a quarter of what the kernel stages."""
    _check_frames("stream_plain", x)
    return x[:, :OUT_COLS] + _scalar(s)


def stream_cuda(x: torch.Tensor, s: float) -> torch.Tensor:
    """x (total, 512) float32 -> x[:, :128] + s, (total, 128) float32. On a
    CPU tensor this is :func:`stream_plain`; on a CUDA tensor it launches
    ``howl_micro_stream_forward``, which stages every row whole, or raises."""
    _build.refuse_grad("stream_cuda", x)
    if x.device.type == "cpu":
        return stream_plain(x, s)
    if x.device.type != "cuda":
        raise ValueError(f"stream_cuda takes CPU or CUDA tensors, got {x.device}")
    _check_frames("stream_cuda", x)
    _check_kernel_operands("stream_cuda", x.shape[1], x)
    out = torch.empty((x.shape[0], OUT_COLS), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = _build.kernel_library()
    with torch.cuda.device(x.device):
        status = lib.howl_micro_stream_forward(
            x.data_ptr(), out.data_ptr(), x.shape[0], _scalar(s), torch.cuda.current_stream(x.device).cuda_stream
        )
    _build.check_launch(status, "micro stream")
    stream_cuda.launches += 1
    return out


stream_cuda.launches = 0


# ---- M2: the GEMM legs ----


def gemm_plain(x: torch.Tensor, w: torch.Tensor, s: float, n_dots: int = 1) -> torch.Tensor:
    """The plain version of M2: float32 add, round to bf16, widen to float32,
    ``@`` in float32 (on a card this needs TF32 off), the ``n_dots`` products
    added in order, then the slice."""
    _check_frames("gemm_plain", x)
    _check_w("gemm_plain", w, x.shape[1], x)
    _check_n_dots("gemm_plain", n_dots)
    xb = (x + _scalar(s)).to(torch.bfloat16).float()
    w32 = w.float()
    acc = xb @ w32
    for _ in range(n_dots - 1):
        acc = acc + xb @ w32
    return acc[:, :OUT_COLS].contiguous()


def _swizzle_index(rows: int, device) -> torch.Tensor:
    """(rows, 8): for row n of a 128-byte-swizzled image, the 16-byte chunk
    stored at each place, c ^ (n % 8); the map is its own inverse."""
    return torch.arange(8, device=device)[None, :] ^ (torch.arange(rows, device=device)[:, None] % 8)


def pack_gemm_w_image(w: torch.Tensor) -> torch.Tensor:
    """(512, 512) bf16 W -> the flat image the M2 kernel's ``wgmma``
    descriptors read, 16 stages of 32 KB.

    Stage 8 h + kb is the B operand of the pass over columns [256 h, 256 h +
    256) and rows k in [64 kb, 64 kb + 64): element (k, n) lies at byte
    ``(8 h + kb) * 32768 + nl * 128 + 16 * ((k % 64 // 8) ^ (nl % 8)) +
    2 * (k % 8)``, nl = n - 256 h: K-major rows of 128 bytes, their 16-byte
    chunks permuted by the row's place in its 1,024-byte atom (T2's layout).
    """
    n_k, n_n = w.shape
    v = w.t().reshape(n_n // GEMM_PASS_N, GEMM_PASS_N, n_k // GEMM_STAGE_K, 8, 8).permute(0, 2, 1, 3, 4)
    idx = _swizzle_index(GEMM_PASS_N, w.device)[None, None, :, :, None].expand(v.shape)
    return v.gather(3, idx).contiguous().reshape(-1)


def unpack_gemm_w_image(img: torch.Tensor, n_fft: int = 512) -> torch.Tensor:
    """The inverse of :func:`pack_gemm_w_image`: (n_fft, n_fft)."""
    v = img.reshape(n_fft // GEMM_PASS_N, n_fft // GEMM_STAGE_K, GEMM_PASS_N, 8, 8)
    v = v.gather(3, _swizzle_index(GEMM_PASS_N, img.device)[None, None, :, :, None].expand(v.shape))
    return v.permute(0, 2, 1, 3, 4).reshape(n_fft, n_fft).t()


def gemm_cuda(x: torch.Tensor, w: torch.Tensor, s: float, n_dots: int = 1) -> torch.Tensor:
    """x (total, 512) float32 and w (512, 512) bf16 -> (total, 128) float32.
    On a CPU tensor this is :func:`gemm_plain`; on a CUDA tensor it launches
    ``howl_micro_gemm_forward`` or raises."""
    _build.refuse_grad("gemm_cuda", x, w)
    if x.device.type == "cpu":
        return gemm_plain(x, w, s, n_dots)
    if x.device.type != "cuda":
        raise ValueError(f"gemm_cuda takes CPU or CUDA tensors, got {x.device}")
    _check_frames("gemm_cuda", x)
    _check_w("gemm_cuda", w, x.shape[1], x)
    _check_n_dots("gemm_cuda", n_dots)
    _check_kernel_operands("gemm_cuda", x.shape[1], x, w)
    out = torch.empty((x.shape[0], OUT_COLS), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = _build.kernel_library()
    with torch.cuda.device(x.device):
        w_img = _build.packed_operand(pack_gemm_w_image, w)
        status = lib.howl_micro_gemm_forward(
            x.data_ptr(), w_img.data_ptr(), out.data_ptr(), x.shape[0], _scalar(s), n_dots, 0,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check_launch(status, "micro gemm")
    gemm_cuda.launches += 1
    return out


gemm_cuda.launches = 0


# ---- M3: the polyphase legs ----


def _check_poly(what: str, h: torch.Tensor, w: torch.Tensor, t_pad: int, n_dots: int) -> int:
    """Returns n_sub, the hop rows a frame spans."""
    if h.ndim != 3 or h.dtype != torch.float32:
        raise ValueError(f"{what}: expected (B, rows, hop) float32 hop rows, got {tuple(h.shape)} {h.dtype}")
    if w.ndim != 2:
        raise ValueError(f"{what}: expected a square bf16 w, got {tuple(w.shape)}")
    _check_w(what, w, w.shape[0], h)
    _check_n_dots(what, n_dots)
    n_sub = -(-w.shape[0] // h.shape[2])
    if not 0 <= t_pad <= h.shape[1] - (n_sub - 1):
        raise ValueError(f"{what}: t_pad {t_pad} frames need {t_pad + n_sub - 1} hop rows, h has {h.shape[1]}")
    return n_sub


def poly_plain(h: torch.Tensor, w: torch.Tensor, s: float, t_pad: int, n_dots: int = 1) -> torch.Tensor:
    """The plain version of M3: float32 add, round to bf16, widen, one
    float32 ``@`` per W_j block with the ``j`` sums added in order, every
    pass from zero, then the slice."""
    n_sub = _check_poly("poly_plain", h, w, t_pad, n_dots)
    hb = (h + _scalar(s)).to(torch.bfloat16).float()
    w_js = poly_weight_blocks(w, h.shape[2]).float()
    for _ in range(n_dots):
        acc = hb[:, :t_pad] @ w_js[0]
        for j in range(1, n_sub):
            acc = acc + hb[:, j : j + t_pad] @ w_js[j]
    return acc[..., :OUT_COLS].contiguous()


def poly_k_rows(w: torch.Tensor, hop: int = 200) -> torch.Tensor:
    """W (512, n) -> (528, n), the rows of K in the order the M3 kernel's
    k16 steps take them: W_0 and W_1 each with 8 zero rows below (the zero
    chunk of a hop row), then W_2's first 112 rows, the only nonzero ones."""
    blocks = F.pad(poly_weight_blocks(w, hop), (0, 0, 0, 16 * max(POLY_STEPS) - hop))
    return torch.cat([blocks[j, : 16 * n] for j, n in enumerate(POLY_STEPS)])


def pack_poly_w_image(w: torch.Tensor) -> torch.Tensor:
    """(512, 512) bf16 W -> the flat image the M3 kernel's ``wgmma``
    descriptors read, 2 passes x 33 steps of 8 KB.

    Row k of :func:`poly_k_rows` and column n lie at byte ``(33 hp + k // 16)
    * 8192 + (k % 16 // 8) * 4096 + nl * 16 + 2 * (k % 8)``, hp = n // 256,
    nl = n % 256: each step is 16 k by 256 n, K-major without swizzle, two
    k-cores of 4 KB whose 8-n cores are 128 bytes (T1's layout)."""
    kr = poly_k_rows(w)
    n_steps = kr.shape[0] // 16
    v = kr.reshape(n_steps, 2, 8, w.shape[1] // POLY_PASS_N, POLY_PASS_N).permute(3, 0, 1, 4, 2)
    return v.contiguous().reshape(-1)


def unpack_poly_w_image(img: torch.Tensor, n_fft: int = 512, hop: int = 200) -> torch.Tensor:
    """The inverse of :func:`pack_poly_w_image`: (n_fft, n_fft)."""
    n_steps = sum(POLY_STEPS)
    kr = img.reshape(n_fft // POLY_PASS_N, n_steps, 2, POLY_PASS_N, 8).permute(1, 2, 4, 0, 3).reshape(-1, n_fft)
    starts = [16 * sum(POLY_STEPS[:j]) for j in range(len(POLY_STEPS))]
    return torch.cat([kr[a : a + hop] for a in starts])[:n_fft]


def poly_cuda(h: torch.Tensor, w: torch.Tensor, s: float, t_pad: int, n_dots: int = 1) -> torch.Tensor:
    """h (B, rows, 200) float32 and w (512, 512) bf16 -> (B, t_pad, 128)
    float32, t_pad + 2 <= rows. On a CPU tensor this is :func:`poly_plain`;
    on a CUDA tensor it launches ``howl_micro_poly_forward`` or raises. The
    kernel reads W as :func:`pack_poly_w_image`, packed once per tensor."""
    _build.refuse_grad("poly_cuda", h, w)
    if h.device.type == "cpu":
        return poly_plain(h, w, s, t_pad, n_dots)
    if h.device.type != "cuda":
        raise ValueError(f"poly_cuda takes CPU or CUDA tensors, got {h.device}")
    _check_poly("poly_cuda", h, w, t_pad, n_dots)
    _check_kernel_operands("poly_cuda", w.shape[0], h, w)
    b, rows, hop = h.shape
    if hop != 200:
        raise ValueError(f"poly_cuda: the kernel is built for hop 200, got {hop}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's 65535 clips")
    out = torch.empty((b, t_pad, OUT_COLS), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = _build.kernel_library()
    with torch.cuda.device(h.device):
        w_img = _build.packed_operand(pack_poly_w_image, w)
        status = lib.howl_micro_poly_forward(
            h.data_ptr(), w_img.data_ptr(), out.data_ptr(), b, rows, t_pad, _scalar(s), n_dots, 0,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    _build.check_launch(status, "micro poly")
    poly_cuda.launches += 1
    return out


poly_cuda.launches = 0
