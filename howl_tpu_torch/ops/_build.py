"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by one ``nvcc`` call into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/libhowl_kernels_<hash>.so csrc/*.cu

The library name carries a hash of the sources, so an edited kernel is never
served from a stale build. Nothing is built when a module is imported: the
first kernel launch calls :func:`kernel_library`. That takes seconds, because
no source includes PyTorch's headers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# argtypes of every C entry point: each pointer and the stream is a
# c_void_p (ctypes would otherwise pass a Python int as a 32-bit int and cut
# the pointer), each size or flag a c_int, each scalar a c_float
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # audio, w, fb, out, B, S, n_frames, n_fft, hop, center, n_bins_pad,
    # n_mels, round_audio, round_power, round_mel, out_bf16, layout_fm,
    # log_offset, mean, inv_std, stream
    "howl_logmel_forward": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
    # mel, taps, out, B, T, n_mels, ch, pool_t, pool_f, in_bf16, stream
    "howl_res8_stem_forward": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhowl_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a build of these exact sources exists.
    Raises RuntimeError with nvcc's output when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call; ``argtypes`` and
    ``restype`` (the launch's cudaError_t as an int) set on every entry."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _library = lib
        return _library


def check_launch(status: int, what: str) -> None:
    """Raise if the C entry's ``cudaGetLastError()`` after the launch was not 0."""
    if status != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {status}")
