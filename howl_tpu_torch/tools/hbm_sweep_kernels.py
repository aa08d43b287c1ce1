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

The JAX tool's grids drop a remainder of rows silently; here rows that are
no whole number of blocks raise. Each ``*_cuda`` wrapper runs its plain
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
DONE_SHAPE = (8, 128)  # the whole-array copy's second output


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
    a CUDA tensor it launches ``howl_hbm2hbm_forward``, which moves x through
    shared memory with bulk asynchronous copies alone, or raises."""
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
