"""The port's native serving runtime (howl_tpu_torch/native) against the JAX
package's (howl_tpu/native).

Both bind the same C++ source, ``native/howl_native.cpp``; the port builds
its own library into ``howl_tpu_torch/_build/`` and keeps the numpy
fallback. On the same seeded pushes the port's ``NativeStreamMux`` gives
JAX's gathered batches and statuses (1 ok, 0 underrun, -1 overrun) exactly,
through its compiled library and through its fallback, and its
``NativeRingBuffer`` JAX's windows. The thread-level cases (torn reads,
threaded gathers, producer threads) run on the compiled library.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import howl_tpu.native as jax_native
import howl_tpu_torch.native as native


def _seq(stream: int, start: int, n: int) -> np.ndarray:
    """Recognizable per-stream samples: stream * 1000 + sample index."""
    return (stream * 1000.0 + start + np.arange(n)).astype(np.float32)


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    """The port's compiled library, or its numpy fallback."""
    if request.param == "fallback":
        monkeypatch.setattr(native, "_ensure_built", lambda: None)
    else:
        assert native.available(), "the native library must build here (g++ and native/howl_native.cpp)"
    return request.param


def _schedule(seed: int, n_streams: int, n_pushes: int):
    """Seeded pushes of float32 and int16 audio, a gather every 7th."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pushes):
        s = int(rng.integers(0, n_streams))
        pcm = rng.standard_normal(int(rng.integers(1, 60))).astype(np.float32) * 0.3
        if i % 5 == 4:
            pcm = (pcm * 32767).astype("<i2").tobytes()
        out.append((s, pcm))
    return out


@pytest.mark.parametrize("seed,capacity,hop", [(3, 128, 20), (4, 48, 16), (5, 512, 64)])
def test_mux_gathers_as_jaxs(path, seed, capacity, hop):
    """Underruns (too little pending), overruns (a lapped ring) and in-sync
    ticks, as JAX's compiled mux gives them."""
    pushes = _schedule(seed, 4, 300)

    def run(mux):
        outs = []
        for i, (s, pcm) in enumerate(pushes):
            mux.push(s, pcm)
            if i % 7 == 6:
                outs.append(mux.gather(hop))
        outs.append(mux.gather(hop))
        return outs, [mux.pending(s) for s in range(4)]

    assert jax_native.available()
    (want, want_pending), (got, got_pending) = run(jax_native.NativeStreamMux(4, capacity)), run(
        native.NativeStreamMux(4, capacity))
    statuses = np.stack([st for _, st in got])
    assert {0, 1} <= set(statuses.ravel().tolist())
    if capacity < 100:
        assert -1 in statuses
    for (wb, ws), (gb, gs) in zip(want, got):
        assert gs.dtype == np.int8 and gb.dtype == np.float32
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gb, wb)
    assert got_pending == want_pending


def test_gather_lockstep_and_underrun(path):
    mux = native.NativeStreamMux(n_streams=3, capacity=64)
    mux.push(0, _seq(0, 0, 16))
    mux.push(1, _seq(1, 0, 8))  # half a hop: an underrun
    mux.push(2, _seq(2, 0, 40))
    batch, status = mux.gather(16)
    np.testing.assert_array_equal(status, [1, 0, 1])
    np.testing.assert_array_equal(batch[1], np.zeros(16))  # silence, not consumed
    assert mux.pending(1) == 8
    mux.push(1, _seq(1, 8, 24))
    batch, status = mux.gather(16)
    np.testing.assert_array_equal(status, [0, 1, 1])
    np.testing.assert_array_equal(batch[1], _seq(1, 0, 16))
    np.testing.assert_array_equal(batch[2], _seq(2, 16, 16))


def test_gather_overrun_drops_oldest(path):
    mux = native.NativeStreamMux(n_streams=1, capacity=32)
    mux.push(0, _seq(0, 0, 100))
    batch, status = mux.gather(16)
    assert status[0] == -1
    np.testing.assert_array_equal(batch[0], _seq(0, 68, 16))
    batch, status = mux.gather(16)
    assert status[0] == 1
    np.testing.assert_array_equal(batch[0], _seq(0, 84, 16))


def test_gather_and_push_check_their_arguments(path):
    mux = native.NativeStreamMux(n_streams=2, capacity=32)
    with pytest.raises(ValueError, match="capacity"):
        mux.gather(64)
    with pytest.raises(IndexError):
        mux.push(5, np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="positive"):
        native.NativeStreamMux(2, 0)


@pytest.mark.parametrize("capacity,n", [(64, 40), (64, 64), (32, 10)])
def test_ring_buffer_windows_as_jaxs(path, capacity, n):
    rng = np.random.default_rng(capacity + n)
    ours, theirs = native.NativeRingBuffer(capacity), jax_native.NativeRingBuffer(capacity)
    for i in range(12):
        chunk = rng.standard_normal(int(rng.integers(1, 30))).astype(np.float32)
        pcm = (chunk * 20000).astype("<i2").tobytes()
        for ring in (ours, theirs):
            ring.push_float(chunk) if i % 3 else ring.push_int16(pcm)
        assert ours.total_written == theirs.total_written
        np.testing.assert_array_equal(ours.latest(n), theirs.latest(n))
    with pytest.raises(ValueError, match="capacity"):
        ours.latest(capacity + 1)


def test_the_library_is_the_ports_own_build():
    """Built from the shared source into howl_tpu_torch/_build/, named by its
    hash; never the JAX binding's native/libhowl_native.so."""
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR and path.name.startswith("libhowl_native_")
    assert native.SOURCE.name == "howl_native.cpp" and native.SOURCE.parent.name == "native"
    assert native._ensure_built()._name == str(path)


def test_a_failed_build_falls_back_to_numpy(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    mux = native.NativeStreamMux(2, 32)
    mux.push(0, _seq(0, 0, 16))
    _, status = mux.gather(16)
    np.testing.assert_array_equal(status, [1, 0])


def test_threaded_gather_matches_single():
    a, b = native.NativeStreamMux(7, 256), native.NativeStreamMux(7, 256)
    rng = np.random.default_rng(5)
    for s in range(7):
        pcm = rng.standard_normal(int(rng.integers(10, 200))).astype(np.float32)
        a.push(s, pcm)
        b.push(s, pcm)
    for _ in range(3):
        ba, sa = a.gather(32, threads=1)
        bb, sb = b.gather(32, threads=3)
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(ba, bb)


def test_no_torn_reads_under_a_lapping_producer():
    """A producer lapping the ring while the consumer copies: every hop read
    is one contiguous run of the pushed sequence."""
    hop, cap = 64, 256
    mux = native.NativeStreamMux(1, cap)
    stop = threading.Event()

    def producer():
        sent = 0
        while not stop.is_set():
            mux.push(0, _seq(0, sent, 48))
            sent += 48

    t = threading.Thread(target=producer)
    t.start()
    try:
        real = torn = 0
        for _ in range(4000):
            batch, status = mux.gather(hop)
            row = batch[0]
            if status[0] == 0 or not row.any():
                continue
            real += 1
            torn += not np.array_equal(row, row[0] + np.arange(hop, dtype=np.float32))
        assert torn == 0, f"{torn}/{real} gathered hops were torn"
        assert real >= 10, f"too few real gathers ({real})"
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
