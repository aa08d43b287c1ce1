"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c csrc/<name>.cu -o <name>.o                        (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libhowl_kernels_<hash>.so *.o

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
import tempfile
import threading
import weakref
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# argtypes of every C entry point: each pointer and the stream is a
# c_void_p (ctypes would otherwise pass a Python int as a 32-bit int and cut
# the pointer), each size or flag a c_int, a size in bytes a c_longlong, each
# scalar a c_float
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # audio, w, fb, w_lo, fb_lo, out, B, S, n_frames, n_fft, hop, center,
    # n_bins_pad, n_mels, round_audio, round_power, round_mel, out_bf16,
    # layout_fm, log_offset, mean, inv_std, stream
    "howl_logmel_forward": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
    # audio, w_img, fb_img, out, B, S, n_frames, n_fft, hop, center, n_halves,
    # n_passes, n_mels, mel_n, out_bf16, layout_fm, log_offset, mean, inv_std,
    # stream
    "howl_logmel_tc_forward": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
    # x, w_img, w_scale, bn_scale, bn_shift, res, out, pre, B, T, F, C, tt, inv_s, s_a, is_bf16, stream
    "howl_int8_conv_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P),
    # y, w_img[6], w_scale[6], bn_scale[6], bn_shift[6] (host arrays of device pointers), s_a[6], inv_s[6] (host
    # arrays of floats), out, B, T, F, C, is_bf16, stream
    "howl_int8_trunk_fused_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # F, C, is_bf16, want_tile -> the tile's frames, or the shared memory in bytes (-1: not served)
    "howl_int8_trunk_fused_geometry": (_I, _I, _I, _I),
    # mel, taps, out, B, T, n_mels, ch, pool_t, pool_f, in_bf16, stream
    "howl_res8_stem_forward": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # mel, img, out, B, T, n_mels, ch, stream
    "howl_res8_stem_tc_forward": (_P, _P, _P, _I, _I, _I, _I, _P),
    # audio, bank, rows, offs, alpha, out, B, n, n_rows, w_cols, stream
    "howl_mix_noise_bank_forward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, w_img, pool_img, scale, shift, out, B, pos, pos_pad, n_win_pad, full_build, stream
    "howl_trunk_proto_forward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # xpre, w_img, out, B, q_rows, out_bf16, stream
    "howl_stem_fold_forward": (_P, _P, _P, _I, _I, _I, _P),
    # x, out, total, s, stream
    "howl_micro_stream_forward": (_P, _P, _I, _F, _P),
    # x, w_img, out, total, s, n_dots, keep, stream
    "howl_micro_gemm_forward": (_P, _P, _P, _I, _F, _I, _I, _P),
    # h, w_img, out, B, rows, t_pad, s, n_dots, keep, stream
    "howl_micro_poly_forward": (_P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
    # x, out, rows, bn, is_bf16, s, stream
    "howl_hbm_auto_read_forward": (_P, _P, _I, _I, _I, _F, _P),
    "howl_hbm_auto_copy_forward": (_P, _P, _I, _I, _I, _F, _P),
    "howl_hbm_stream_repro_forward": (_P, _P, _I, _I, _I, _F, _P),
    # x, out, done, n_bytes, s, stream
    "howl_hbm2hbm_forward": (_P, _P, _P, _L, _F, _P),
    # x, corners, out, rows, cb, k, is_bf16, s, stream
    "howl_hbm_manual_read_forward": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    # out, done, rows, cb, k, is_bf16, s, stream
    "howl_hbm_manual_write_forward": (_P, _P, _I, _I, _I, _I, _F, _P),
    # x, out, done, rows, cb, k, is_bf16, s, stream
    "howl_hbm_manual_copy_forward": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    # k, is_bf16 -> the CTAs that share an SM, or minus a cudaError_t
    "howl_hbm_manual_read_ctas_per_sm": (_I, _I),
    "howl_hbm_manual_write_ctas_per_sm": (_I, _I),
    "howl_hbm_manual_copy_ctas_per_sm": (_I, _I),
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


def _failure(cmd, returncode, stdout, stderr) -> str:
    return f"nvcc failed ({returncode}): {' '.join(map(str, cmd))}\n{stdout}\n{stderr}"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a build of these exact sources exists:
    one ``nvcc`` per source, all at once, then one link. Raises
    RuntimeError with nvcc's output when a compile or the link fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj_dir = Path(tempfile.mkdtemp(prefix="objs.", dir=BUILD_DIR))
    try:
        jobs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj_dir / f"{src.stem}.o")]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failures = []
        for cmd, proc in jobs:  # wait for every compile, failed or not
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failures.append(_failure(cmd, proc.returncode, stdout, stderr))
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *sorted(obj_dir.glob("*.o"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(_failure(cmd, proc.returncode, proc.stdout, proc.stderr))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
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


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and any input requires grad: the kernels have
    no backward, so a gradient would silently stop at them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad() or on inputs that do not require grad"
        )


_packed: dict = {}


def packed_operand(pack, tensor: torch.Tensor) -> torch.Tensor:
    """``pack(tensor)``, the image of an operand that a kernel reads, packed
    again only when ``tensor`` was changed in place (a weight served for many
    launches is packed once). Images are kept per function and tensor, so
    that calls which alternate two weights do not pack each time; an image
    goes when its tensor does."""
    key = (pack, id(tensor))
    ref, version, image = _packed.get(key, (None, None, None))
    if ref is None or ref() is not tensor or version != tensor._version:
        image = pack(tensor)
        _packed[key] = (weakref.ref(tensor, lambda _, key=key: _packed.pop(key, None)), tensor._version, image)
    return image
