"""ctypes bindings of the native serving runtime, ``native/howl_native.cpp``
(counterpart of ``howl_tpu/native/__init__.py``): the client's PCM ring and
the multi-stream mux that feeds the batched live engines.

The C++ source is the repository's, shared with the JAX package; this
package builds its own library from it, on first use, with the host's C++
compiler (``$CXX``, else ``g++``):

    g++ -O3 -fPIC -std=c++17 -shared -o howl_tpu_torch/_build/libhowl_native_<hash>.so native/howl_native.cpp

The name carries a hash of the source, so an edited source is never served
from a stale build; the library is written under a temporary name and
renamed, so processes that build at once do not tear it. Where no compiler
or source is found every class falls back to numpy with the same semantics
(``available()`` says which path is active). This is host code: no device
kernel runs here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "howl_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None
_load_failed = False
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhowl_native_{digest}.so"


def build() -> Path:
    """Compile the source into ``_build/`` unless this source's library is
    there; returns its path. Raises if the compiler fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=path.stem, suffix=".tmp")
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, f32p, i16p, i8p, vp = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
                                ctypes.POINTER(ctypes.c_int8), ctypes.c_void_p)
    signatures = {
        "ring_create": (vp, [i64]),
        "ring_destroy": (None, [vp]),
        "ring_push_i16": (None, [vp, i16p, i64]),
        "ring_push_f32": (None, [vp, f32p, i64]),
        "ring_total_written": (i64, [vp]),
        "ring_latest": (i64, [vp, f32p, i64]),
        "mux_create": (vp, [i64, i64]),
        "mux_destroy": (None, [vp]),
        "mux_push_f32": (None, [vp, i64, f32p, i64]),
        "mux_push_i16": (None, [vp, i64, i16p, i64]),
        "mux_pending": (i64, [vp, i64]),
        "mux_gather": (i64, [vp, f32p, i64, i8p]),
        "mux_gather_range": (i64, [vp, f32p, i64, i8p, i64, i64]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ensure_built() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None where it cannot be built
    or loaded (the numpy fallback then serves)."""
    global _lib, _load_failed
    with _lock:
        if _lib is None and not _load_failed:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, subprocess.SubprocessError, AttributeError):
                _load_failed = True
        return _lib


def available() -> bool:
    return _ensure_built() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


class NativeRingBuffer:
    """A single-producer single-consumer PCM ring; ``latest(n)`` returns the
    trailing n samples, zero-padded on the left while the ring fills (the
    client's scoring window)."""

    def __init__(self, capacity: int):
        lib = _ensure_built()
        self._lib = lib
        self.capacity = capacity
        if lib is not None:
            self._handle = lib.ring_create(capacity)
        else:
            self._handle = None
            self._buf = np.zeros(capacity, np.float32)
            self._total = 0

    def push_int16(self, pcm: bytes):
        arr = np.frombuffer(pcm, dtype="<i2")
        if self._lib is not None:
            self._lib.ring_push_i16(self._handle, _i16p(arr), len(arr))
        else:
            self.push_float(arr.astype(np.float32) / 32768.0)

    def push_float(self, audio: np.ndarray):
        audio = np.ascontiguousarray(audio, np.float32)
        if self._lib is not None:
            self._lib.ring_push_f32(self._handle, _f32p(audio), len(audio))
        else:
            idx = (self._total + np.arange(len(audio))) % self.capacity
            self._buf[idx] = audio
            self._total += len(audio)

    @property
    def total_written(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_total_written(self._handle))
        return self._total

    def latest(self, n: int) -> np.ndarray:
        if n > self.capacity:
            # only `capacity` samples still exist; older slots hold newer audio
            raise ValueError(f"latest({n}) exceeds ring capacity {self.capacity}")
        out = np.zeros(n, np.float32)
        if self._lib is not None:
            self._lib.ring_latest(self._handle, _f32p(out), n)
        else:
            avail = min(self._total, n)
            idx = (self._total - avail + np.arange(avail)) % self.capacity
            out[n - avail :] = self._buf[idx]
        return out

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.ring_destroy(self._handle)
            self._handle = None


class NativeStreamMux:
    """N per-stream single-producer rings drained in lockstep into (N, hop)
    float32 batches, the host-side feeder of the batched live engines. One
    producer thread per stream may ``push``; one consumer calls ``gather``.

    A tick's policy (``mux_gather`` in ``native/howl_native.cpp``): a stream
    with fewer than ``hop`` unread samples gives zeros and is not consumed
    (late audio serves on a later tick: latency, never corruption); a stream
    whose producer lapped its ring skips to its oldest live sample (the
    oldest audio dropped, status -1)."""

    def __init__(self, n_streams: int, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be positive")
        lib = _ensure_built()
        self._lib = lib
        self.n_streams = int(n_streams)
        self.capacity = int(capacity)
        if lib is not None:
            self._handle = lib.mux_create(self.n_streams, self.capacity)
        else:  # single-threaded semantics
            self._handle = None
            self._buf = np.zeros((self.n_streams, self.capacity), np.float32)
            self._write = np.zeros(self.n_streams, np.int64)
            self._read = np.zeros(self.n_streams, np.int64)

    def push(self, stream: int, pcm):
        """Append one stream's newest audio: a float32 array or int16 PCM bytes."""
        if not 0 <= stream < self.n_streams:
            raise IndexError(f"stream {stream} out of range [0, {self.n_streams})")
        if isinstance(pcm, (bytes, bytearray)):
            arr = np.frombuffer(pcm, dtype="<i2")
            if self._lib is not None:
                self._lib.mux_push_i16(self._handle, stream, _i16p(arr), len(arr))
                return
            audio = arr.astype(np.float32) / 32768.0
        else:
            audio = np.ascontiguousarray(pcm, np.float32)
        if self._lib is not None:
            self._lib.mux_push_f32(self._handle, stream, _f32p(audio), len(audio))
        else:
            idx = (self._write[stream] + np.arange(len(audio))) % self.capacity
            self._buf[stream, idx] = audio
            self._write[stream] += len(audio)

    def pending(self, stream: int) -> int:
        if self._lib is not None:
            return int(self._lib.mux_pending(self._handle, stream))
        return max(int(self._write[stream] - self._read[stream]), 0)

    def gather(self, hop: int, threads: int = 1):
        """The next ``hop`` samples of every stream: ((N, hop) float32 batch,
        (N,) int8 status: 1 ok, 0 underrun, -1 overrun skip). ``threads`` > 1
        splits the native gather by stream range over that many threads
        (ctypes releases the GIL; the rows are independent)."""
        if hop > self.capacity:
            raise ValueError(f"gather({hop}) exceeds per-stream capacity {self.capacity}")
        out = np.zeros((self.n_streams, hop), np.float32)
        status = np.zeros(self.n_streams, np.int8)
        if self._lib is not None:
            out_p, st_p = _f32p(out), status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
            if threads <= 1 or self.n_streams < 2 * threads:
                self._lib.mux_gather(self._handle, out_p, hop, st_p)
            else:
                bounds = np.linspace(0, self.n_streams, threads + 1).astype(int)
                workers = [threading.Thread(target=self._lib.mux_gather_range,
                                            args=(self._handle, out_p, hop, st_p, int(lo), int(hi)))
                           for lo, hi in zip(bounds[:-1], bounds[1:])]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join()
            return out, status
        for s in range(self.n_streams):  # mux_gather_range's rule, one thread
            wp, rp = int(self._write[s]), int(self._read[s])
            st = 1
            if wp - rp > self.capacity:
                rp, st = wp - self.capacity, -1
            if wp - rp < hop:  # an underrun, possibly just after a skip
                self._read[s] = rp  # keep the skip
                status[s] = -1 if st == -1 else 0
                continue
            out[s] = self._buf[s, (rp + np.arange(hop)) % self.capacity]
            self._read[s] = rp + hop
            status[s] = st
        return out, status

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.mux_destroy(self._handle)
            self._handle = None
