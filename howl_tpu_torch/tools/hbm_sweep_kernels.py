"""The device-memory bandwidth sweep's kernels, their plain PyTorch versions
and the sweep's geometry (counterpart of what ``tools/bench_hbm_sweep.py``
defines inside ``main``).

The sweep asks what a read, a copy and a whole-array copy of a large array
reach on the device. Its operand is x (rows, 512), float32 or bf16, and a
scalar s that is cast to x's dtype before it is added, so in bf16 the add is
a bf16 add of a bf16 scalar. A block is ``bn`` rows of x.

Auto read (``csrc/hbm_auto_read.cu``, replacing ``make_auto_read``): every
block is brought on chip whole; block i writes x[i bn : i bn + 8, :128] + s.
out (rows / bn * 8, 128) in x's dtype.

Auto copy (``csrc/hbm_auto_copy.cu``, replacing ``make_auto_copy``):
out = x + s over the whole array, block by block.

Stream repro (``csrc/micro_stream.cu``, second entry, replacing
``make_stream_repro``): every block is brought on chip whole and
x[:, :128] + s is written; out (rows, 128) in x's dtype.

Whole-array copy (``csrc/hbm2hbm.cu``, replacing ``hbm2hbm``): out = x, moved
by asynchronous copies alone, and ``done`` = (8, 128) float32 filled with s.

Manual read, write and copy (``csrc/hbm_manual_read.cu``,
``csrc/hbm_manual_write.cu``, ``csrc/hbm_manual_copy.cu``, replacing
``make_manual_read``, ``make_manual_write`` and ``make_manual_copy``): x is
cut into chunks of ``cb`` rows, and every chunk moves through a ring of ``k``
slots by asynchronous copies that the kernel starts and waits for itself.

  read   out (8, 128) float32 starts as s; chunk i adds the float32 of its
         corner x[i cb : i cb + 8, :128], in chunk order. The sum is
         sequential in float32, so its order is part of the function.
  write  no array is read: every row of chunk i of out is
         ``dtype(float32(s) + float32(i))``; ``done`` = (8, 128) float32 of s.
  copy   out = x bit for bit, and ``done``.

On the TPU one core walks the whole array through one ring whose slots hold a
chunk each (1-4 MB). On the card a chunk does not fit an SM. The read and the
write keep one CTA per chunk, so cb sets the CTA count as bn does for the
auto legs, and each CTA walks its chunk through a ring of k slots of
``STAGE_BYTES`` in shared memory, whatever k, so that depth and stage size
stay apart. The copy cuts every chunk into stages of ``STAGE_BYTES`` (the
last one of a chunk short) and sweeps them with a persistent grid, as many
CTAs as fit the card at depth k: stage j, in address order, to CTA j % CTAs,
so neighbouring CTAs copy neighbouring stages; each CTA keeps a ring of k
slots, one chain read -> write -> read per slot, and cb only says where a
stage must end. k is a run-time number from ``MIN_K`` to ``MAX_K`` (8 slots
are 128 KB of the 227 KB an SM has); it also sets how many CTAs share an SM.
:func:`ring_geometry` gives what a leg's (k, cb) means on the card.

The whole-array copy sweeps the array the same way in stages of 32 KB, two
CTAs an SM, three slots each, a slot refilled once its store has read it.

The JAX tool's grids drop a remainder of rows silently; here rows that are
no whole number of blocks or chunks raise. Each ``*_cuda`` wrapper runs its plain
version for a tensor on the CPU and launches its kernel for a tensor on a
CUDA device, or raises; it refuses inputs that require grad, since no kernel
has a backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from howl_tpu_torch.ops import _build

COLS = 512  # columns of the sweep's array
CORNER_ROWS = 8  # rows of the corner a read block writes; a block is a multiple of it high
OUT_COLS = 128  # columns of the corner and of the stream leg's output
DONE_SHAPE = (8, 128)  # the second output of the whole-array copy and of the manual write and copy; the read's output
STAGE_BYTES = 16384  # one slot of a manual leg's ring: 8 float32 rows, so a chunk's corner lies in its first stage
MIN_K, MAX_K = 2, 8  # ring depths the manual kernels take: the read runs k - 1 copies ahead, so 1 would deadlock it


@dataclass(frozen=True)
class SweepGeometry:
    """The sweep's arrays for ``mb`` MB: the same bytes in both dtypes."""

    mb: int
    rows_f32: int  # rows of the float32 array: mb MB of 2 KB rows, cut to a multiple of 4096
    rows_bf16: int  # twice as many rows of 1 KB

    @property
    def bytes_total(self) -> int:
        """The array size the JAX tool's GB/s count: ``mb`` MB, whatever the cut."""
        return self.mb * (1 << 20)


def sweep_geometry(mb: int) -> SweepGeometry:
    rows_f32 = mb * (1 << 20) // (COLS * 4)
    rows_f32 -= rows_f32 % 4096
    return SweepGeometry(mb, rows_f32, 2 * rows_f32)


def _scalar(s) -> float:
    if isinstance(s, torch.Tensor):
        raise TypeError("s is a Python number: it is passed to the launch by value")
    return float(s)


@lru_cache(maxsize=64)
def _rounded(s: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(s, dtype=torch.float32).to(dtype))


def _scalar_in(x: torch.Tensor, s) -> float:
    """s, a float32 scalar as the launch takes it, rounded to x's dtype; as a
    Python number. Rounded once per (s, dtype): a timed chain passes the same s
    at every launch."""
    return _rounded(_scalar(s), x.dtype)


def _check_array(what: str, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: expected a float32 or bfloat16 array, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != COLS:
        raise ValueError(f"{what}: expected a (rows, {COLS}) array, got {tuple(x.shape)}")


def _check_bn(what: str, x: torch.Tensor, bn: int) -> None:
    if not isinstance(bn, int) or bn < CORNER_ROWS or bn % CORNER_ROWS:
        raise ValueError(f"{what}: bn must be a positive multiple of {CORNER_ROWS}, got {bn!r}")
    if x.shape[0] % bn:
        raise ValueError(f"{what}: {x.shape[0]} rows are no whole number of blocks of bn={bn}")


def _check_kernel_operand(what: str, x: torch.Tensor) -> None:
    """What the kernels take beyond the plain versions; a wrapper holds a
    CPU tensor to it as well, so that it takes the same operands everywhere."""
    if not x.is_contiguous():
        raise ValueError(f"{what}'s operand must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}'s operand must be 16-byte aligned")


def _launch(entry: str, what: str, x: torch.Tensor, *args) -> None:
    lib = _build.kernel_library()
    with torch.cuda.device(x.device):
        status = getattr(lib, entry)(x.data_ptr(), *args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(status, what)


def _block_leg(name: str, entry: str, plain, out_shape):
    """The wrapper of one of the three legs that walk x in blocks of bn rows."""

    def wrapper(x: torch.Tensor, bn: int, s: float) -> torch.Tensor:
        _build.refuse_grad(name, x)
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")
        _check_array(name, x)
        _check_bn(name, x, bn)
        _check_kernel_operand(name, x)
        if x.device.type == "cpu":
            return plain(x, bn, s)
        out = torch.empty(out_shape(x, bn), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out  # nothing to launch
        _launch(entry, name, x, out.data_ptr(), x.shape[0], bn, int(x.dtype == torch.bfloat16), _scalar_in(x, s))
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.launches = 0
    return wrapper


# ---- auto read ----


def auto_read_plain(x: torch.Tensor, bn: int, s: float) -> torch.Tensor:
    """The plain version of the read leg: the corners and one add. It reads
    8 x 128 elements of every block, not the block the kernel stages."""
    _check_array("auto_read_plain", x)
    _check_bn("auto_read_plain", x, bn)
    return x.view(x.shape[0] // bn, bn, COLS)[:, :CORNER_ROWS, :OUT_COLS].reshape(-1, OUT_COLS) + _scalar_in(x, s)


auto_read_cuda = _block_leg(
    "auto_read_cuda", "howl_hbm_auto_read_forward", auto_read_plain,
    lambda x, bn: (x.shape[0] // bn * CORNER_ROWS, OUT_COLS),
)
auto_read_cuda.__doc__ = """x (rows, 512) float32 or bf16 -> (rows / bn * 8, 128) in x's dtype. On a
CPU tensor this is :func:`auto_read_plain`; on a CUDA tensor it launches
``howl_hbm_auto_read_forward``, which stages every block whole, or raises."""


# ---- auto copy ----


def auto_copy_plain(x: torch.Tensor, s: float) -> torch.Tensor:
    """The plain version of the copy leg: one add over the array, whatever
    the block height."""
    _check_array("auto_copy_plain", x)
    return x + _scalar_in(x, s)


auto_copy_cuda = _block_leg(
    "auto_copy_cuda", "howl_hbm_auto_copy_forward", lambda x, bn, s: auto_copy_plain(x, s),
    lambda x, bn: tuple(x.shape),
)
auto_copy_cuda.__doc__ = """x (rows, 512) float32 or bf16 -> x + s. On a CPU tensor this is
:func:`auto_copy_plain`; on a CUDA tensor it launches
``howl_hbm_auto_copy_forward`` or raises."""


# ---- stream repro ----


def stream_repro_plain(x: torch.Tensor, s: float) -> torch.Tensor:
    """The plain version of the stream leg: the slice and one add, whatever
    the block height. It reads the first 128 columns only, a quarter of what
    the kernel stages."""
    _check_array("stream_repro_plain", x)
    return x[:, :OUT_COLS] + _scalar_in(x, s)


stream_repro_cuda = _block_leg(
    "stream_repro_cuda", "howl_hbm_stream_repro_forward", lambda x, bn, s: stream_repro_plain(x, s),
    lambda x, bn: (x.shape[0], OUT_COLS),
)
stream_repro_cuda.__doc__ = """x (rows, 512) float32 or bf16 -> x[:, :128] + s. On a CPU tensor this is
:func:`stream_repro_plain`; on a CUDA tensor it launches
``howl_hbm_stream_repro_forward``, which stages every row whole, or raises."""


# ---- the whole-array copy ----


def hbm2hbm_plain(x: torch.Tensor, s: float) -> tuple:
    """The plain version of the whole-array copy: (a copy of x, ``done``)."""
    _check_array("hbm2hbm_plain", x)
    return x.clone(), torch.full(DONE_SHAPE, _scalar(s), dtype=torch.float32, device=x.device)


def hbm2hbm_cuda(x: torch.Tensor, s: float) -> tuple:
    """x (rows, 512) float32 or bf16 -> (a copy of x, ``done`` (8, 128)
    float32 filled with s). On a CPU tensor this is :func:`hbm2hbm_plain`; on
    a CUDA tensor it launches ``howl_hbm2hbm_forward``, which sweeps x's
    stages through shared memory with bulk asynchronous copies alone, or
    raises."""
    _build.refuse_grad("hbm2hbm_cuda", x)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hbm2hbm_cuda takes CPU or CUDA tensors, got {x.device}")
    _check_array("hbm2hbm_cuda", x)
    _check_kernel_operand("hbm2hbm_cuda", x)
    if x.device.type == "cpu":
        return hbm2hbm_plain(x, s)
    out = torch.empty_like(x)
    done = torch.empty(DONE_SHAPE, dtype=torch.float32, device=x.device)
    # a row is 1 or 2 KB, so the bytes are a multiple of the bulk copies' 16; an empty x still fills done
    _launch("howl_hbm2hbm_forward", "hbm2hbm_cuda", x, out.data_ptr(), done.data_ptr(),
            x.numel() * x.element_size(), _scalar(s))
    hbm2hbm_cuda.launches += 1
    return out, done


hbm2hbm_cuda.launches = 0


# ---- the manual legs: k-deep rings of bulk copies ----


def _check_ring(what: str, x: torch.Tensor, k: int, cb: int, max_k: int | None = None) -> None:
    if not isinstance(cb, int) or cb < CORNER_ROWS or cb % CORNER_ROWS:
        raise ValueError(f"{what}: cb must be a positive multiple of {CORNER_ROWS}, got {cb!r}")
    if x.shape[0] % cb:
        raise ValueError(f"{what}: {x.shape[0]} rows are no whole number of chunks of cb={cb}")
    if not isinstance(k, int) or k < MIN_K:
        raise ValueError(f"{what}: the ring depth k must be an integer of at least {MIN_K}, got {k!r}")
    if max_k is not None and k > max_k:
        raise ValueError(f"{what}: the kernels take ring depths k from {MIN_K} to {max_k}, got {k}")


def ring_geometry(x: torch.Tensor, k: int, cb: int, mode: str) -> dict:
    """What (k, cb) means on the card for the manual leg ``mode`` ("read",
    "write" or "copy") on x. The read and the write: one CTA per chunk
    ("chunk"), which walks the chunk's stages through k slots; a CTA keeps k
    slots in flight, or fewer when its chunk has fewer stages. The copy: the
    stages of every chunk swept by a persistent grid ("sweep"), stage j to
    CTA j % CTAs, each slot one chain with one stage in flight; the grid is
    every CTA that fits the card, known there only (``ctas`` and
    ``stages_per_cta`` None until :func:`ring_on_card` fills them)."""
    chunk_bytes = cb * COLS * x.element_size()
    per_chunk = -(-chunk_bytes // STAGE_BYTES)
    chunks = x.shape[0] // cb
    ring = {"k": k, "cb": cb, "bf16": x.dtype == torch.bfloat16, "stage_bytes": STAGE_BYTES,
            "stages": chunks * per_chunk, "stages_per_chunk": per_chunk}
    if mode == "copy":
        return dict(ring, schedule="sweep", ctas=None, stages_per_cta=None, bytes_in_flight_per_cta=k * STAGE_BYTES)
    return dict(ring, schedule="chunk", ctas=chunks, stages_per_cta=per_chunk,
                bytes_in_flight_per_cta=min(k, per_chunk) * STAGE_BYTES)


def ring_on_card(ring: dict, ctas_per_sm: int, sms: int) -> dict:
    """``ring`` with the CTAs that share an SM, and for the copy's sweep the
    grid its entry launches on a card of ``sms`` SMs: every CTA that fits,
    no more than there are stages, one for an empty array."""
    ring = dict(ring, ctas_per_sm=ctas_per_sm)
    if ring["schedule"] == "sweep":
        ctas = max(1, min(ring["stages"], ctas_per_sm * sms))
        ring.update(ctas=ctas, stages_per_cta=-(-ring["stages"] // ctas))
    return ring


def _done(x: torch.Tensor, s) -> torch.Tensor:
    return torch.full(DONE_SHAPE, _scalar(s), dtype=torch.float32, device=x.device)


def manual_read_plain(x: torch.Tensor, k: int, cb: int, s: float) -> torch.Tensor:
    """The plain version of the manual read: s, then every chunk's corner
    added in chunk order, one float32 add per chunk. k changes nothing."""
    _check_array("manual_read_plain", x)
    _check_ring("manual_read_plain", x, k, cb)
    corners = x.view(x.shape[0] // cb, cb, COLS)[:, :CORNER_ROWS, :OUT_COLS].float()
    out = _done(x, s)
    for corner in corners:
        out += corner
    return out


def chunk_values(x: torch.Tensor, cb: int, s: float) -> torch.Tensor:
    """(n_chunks,) in x's dtype: the value the write leg fills chunk i with,
    a float32 add of s and the chunk index, cast afterwards."""
    n = x.shape[0] // cb
    base = torch.full((), _scalar(s), dtype=torch.float32, device=x.device)
    return (base + torch.arange(n, dtype=torch.float32, device=x.device)).to(x.dtype)


def manual_write_plain(x: torch.Tensor, k: int, cb: int, s: float) -> tuple:
    """The plain version of the manual write: (the array whose chunk i holds
    ``dtype(float32(s) + float32(i))``, ``done``). x gives shape, dtype and
    device only."""
    _check_array("manual_write_plain", x)
    _check_ring("manual_write_plain", x, k, cb)
    return chunk_values(x, cb, s)[:, None, None].expand(-1, cb, COLS).reshape(x.shape), _done(x, s)


def manual_copy_plain(x: torch.Tensor, k: int, cb: int, s: float) -> tuple:
    """The plain version of the manual copy: (a copy of x, ``done``)."""
    _check_array("manual_copy_plain", x)
    _check_ring("manual_copy_plain", x, k, cb)
    return x.clone(), _done(x, s)


def _ring_leg(name: str, plain, launch):
    """The wrapper of one of the three manual legs. ``launch(x, k, cb, s)``
    allocates the outputs, calls the entry and returns what the leg returns."""

    def wrapper(x: torch.Tensor, k: int, cb: int, s: float):
        _build.refuse_grad(name, x)
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")
        _check_array(name, x)
        _check_ring(name, x, k, cb, MAX_K)
        _check_kernel_operand(name, x)
        s = _scalar(s)
        if x.device.type == "cpu":
            return plain(x, k, cb, s)
        result = launch(x, k, cb, s)  # rows = 0 launches too: it still fills the (8, 128) output
        wrapper.launches += 1
        return result

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.launches = 0
    return wrapper


def _ring_args(x: torch.Tensor, k: int, cb: int, s: float) -> tuple:
    return x.shape[0], cb, k, int(x.dtype == torch.bfloat16), s


def _launch_read(x, k, cb, s):
    # every CTA leaves its chunk's corner here as float32; a second kernel of the entry adds them in chunk order
    corners = torch.empty((x.shape[0] // cb, *DONE_SHAPE), dtype=torch.float32, device=x.device)
    out = torch.empty(DONE_SHAPE, dtype=torch.float32, device=x.device)
    _launch("howl_hbm_manual_read_forward", "manual_read_cuda", x, corners.data_ptr(), out.data_ptr(), *_ring_args(x, k, cb, s))
    return out


def _launch_write(x, k, cb, s):
    out, done = torch.empty_like(x), torch.empty(DONE_SHAPE, dtype=torch.float32, device=x.device)
    _launch("howl_hbm_manual_write_forward", "manual_write_cuda", out, done.data_ptr(), *_ring_args(x, k, cb, s))
    return out, done


def _launch_copy(x, k, cb, s):
    out, done = torch.empty_like(x), torch.empty(DONE_SHAPE, dtype=torch.float32, device=x.device)
    _launch("howl_hbm_manual_copy_forward", "manual_copy_cuda", x, out.data_ptr(), done.data_ptr(), *_ring_args(x, k, cb, s))
    return out, done


manual_read_cuda = _ring_leg("manual_read_cuda", manual_read_plain, _launch_read)
manual_read_cuda.__doc__ = """x (rows, 512) float32 or bf16 -> (8, 128) float32: s plus every chunk's
corner in chunk order. On a CPU tensor this is :func:`manual_read_plain`; on
a CUDA tensor it launches ``howl_hbm_manual_read_forward``, which brings
every chunk on chip whole through a ring of k slots filled by bulk
asynchronous copies, or raises. One count of ``launches`` is one call of that
entry, which starts two kernels: the ring's and the one that sums the
corners in chunk order."""

manual_write_cuda = _ring_leg("manual_write_cuda", manual_write_plain, _launch_write)
manual_write_cuda.__doc__ = """x (rows, 512) float32 or bf16, for its shape and dtype -> (out, ``done``),
chunk i of out filled with ``dtype(float32(s) + float32(i))``. On a CPU
tensor this is :func:`manual_write_plain`; on a CUDA tensor it launches
``howl_hbm_manual_write_forward``, which fills a slot anew before each bulk
copy to device memory, or raises."""

manual_copy_cuda = _ring_leg("manual_copy_cuda", manual_copy_plain, _launch_copy)
manual_copy_cuda.__doc__ = """x (rows, 512) float32 or bf16 -> (a copy of x, ``done``). On a CPU tensor
this is :func:`manual_copy_plain`; on a CUDA tensor it launches
``howl_hbm_manual_copy_forward``, a persistent grid that sweeps the chunks'
stages with k chains of bulk copies load -> store (landed) -> load per CTA,
or raises."""


def ring_ctas_per_sm(wrapper, k: int, bf16: bool, dev: torch.device) -> int:
    """How many CTAs of a manual leg's kernel share an SM at ring depth k on
    ``dev``, by the CUDA occupancy calculator: part of what the leg measures."""
    entry = f"howl_hbm_{wrapper.__name__.removesuffix('_cuda')}_ctas_per_sm"
    with torch.cuda.device(dev):
        n = getattr(_build.kernel_library(), entry)(k, int(bf16))
    if n < 0:
        raise RuntimeError(f"{wrapper.__name__}: the occupancy query failed: cudaError_t {-n}")
    return n
