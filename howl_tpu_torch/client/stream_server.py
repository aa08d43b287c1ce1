"""Bulk live serving: N concurrent streams through one batched engine
(counterpart of ``howl_tpu/client/stream_server.py``).

The reference client serves one microphone (ref howl/client/howl_client.py:14).
The live engines score tens of thousands of streams a card, so the serving
shape is many ingest feeds drained into one batched step a tick:

    producers (a thread per network or microphone feed)
        -> NativeStreamMux (N lock-free single-producer rings, C++, howl_tpu_torch.native)
        -> gather: one contiguous (N, hop) float32 batch a 62.5 ms tick
        -> engine.push(batch)  (IncrementalOnlineEngine or FusedStreamingOnlineEngine,
           hop-blocked too: one gather covers the whole hop_block)
        -> per-stream fire callbacks

A late producer gives silence for a tick (its audio serves later: bounded
latency, never corruption); a lapped producer loses its oldest audio (the
status codes of ``NativeStreamMux.gather``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, NamedTuple

import numpy as np

from howl_tpu_torch.native import NativeStreamMux


class TickResult(NamedTuple):
    fired: np.ndarray  # (N,) bool — wakeword fired this tick (any hop of a block)
    status: np.ndarray  # (N,) int8 — 1 ok / 0 underrun(silence) / -1 overrun-skip
    any_fired: bool


class CadenceAlarm(NamedTuple):
    """What the alarm listeners get on a sustained cadence breach: the step
    (gather and engine push) took longer than the tick for ``consecutive``
    ticks in a row, so the configuration is unsustainable
    (``howl_tpu_torch/inference/capacity.py``) and the streams fall behind."""

    tick: int
    step_seconds: float
    tick_seconds: float
    consecutive: int


class MultiStreamServer:
    """Drives a push-based batched online engine from a NativeStreamMux.

    ``engine`` must be push-based with per-stream state — an
    ``IncrementalOnlineEngine`` or ``FusedStreamingOnlineEngine`` (any
    ``hop_block``); the whole-window ``OnlineEngine.infer`` contract doesn't
    consume incremental hops. ``capacity_ticks`` sizes each stream's ring in
    ticks of audio (jitter tolerance before audio is dropped).
    """

    def __init__(
        self, engine, capacity_ticks: int = 16, gather_threads: int = 1,
        alarm_after: int = 8,
    ):
        if not hasattr(engine, "push") or not hasattr(engine, "hop_samples"):
            raise ValueError(
                "MultiStreamServer needs a push-based online engine "
                "(IncrementalOnlineEngine or FusedStreamingOnlineEngine); "
                f"got {type(engine).__name__}"
            )
        self.engine = engine
        self.gather_threads = int(gather_threads)  # cores to shard the gather over
        self.num_streams = engine.num_streams
        self.hop_block = getattr(engine, "hop_block", 1)
        self.samples_per_tick = engine.hop_samples * self.hop_block
        self.tick_seconds = self.samples_per_tick / float(engine.cfg.sample_rate)
        self.mux = NativeStreamMux(self.num_streams, capacity_ticks * self.samples_per_tick)
        self._listeners: List[Callable] = []
        self.ticks = 0
        self.detections = np.zeros(self.num_streams, np.int64)
        self.underruns = np.zeros(self.num_streams, np.int64)
        self.overruns = np.zeros(self.num_streams, np.int64)
        # cadence-breach alarm: a step (gather + engine dispatch) longer than
        # the tick budget means every stream falls one tick behind; sustained
        # breaches are an unsustainable configuration, not jitter. After
        # ``alarm_after`` consecutive late ticks the alarm listeners fire
        # (once per episode; re-arms after a on-budget tick).
        self.alarm_after = int(alarm_after)
        self.late_ticks = 0            # total ticks over budget
        self.consecutive_late = 0
        self.alarms = 0                # breach episodes alarmed
        self.last_alarm = None         # most recent CadenceAlarm
        self._alarm_listeners: List[Callable] = []
        self._alarm_armed = True
        self._stop = threading.Event()
        self._thread = None

    # ---- producer side (any thread; one producer per stream) ----

    def push(self, stream: int, pcm) -> None:
        """Append a stream's newest audio: float32 array or int16 PCM bytes."""
        self.mux.push(stream, pcm)

    # ---- consumer side (the serving loop) ----

    def add_listener(self, listener: Callable) -> "MultiStreamServer":
        """listener(stream_indices: np.ndarray, tick: int) on each firing tick."""
        self._listeners.append(listener)
        return self

    def add_alarm_listener(self, listener: Callable) -> "MultiStreamServer":
        """listener(alarm: CadenceAlarm) when the step overruns the tick
        budget ``alarm_after`` ticks in a row (once per breach episode)."""
        self._alarm_listeners.append(listener)
        return self

    def _track_cadence(self, step_seconds: float) -> None:
        if step_seconds <= self.tick_seconds:
            self.consecutive_late = 0
            self._alarm_armed = True
            return
        self.late_ticks += 1
        self.consecutive_late += 1
        if self.consecutive_late >= self.alarm_after and self._alarm_armed:
            self._alarm_armed = False  # one alarm per breach episode
            self.alarms += 1
            self.last_alarm = CadenceAlarm(
                tick=self.ticks, step_seconds=step_seconds,
                tick_seconds=self.tick_seconds, consecutive=self.consecutive_late,
            )
            for listener in self._alarm_listeners:
                try:
                    listener(self.last_alarm)
                except Exception:  # noqa: BLE001 — alarms must not kill serving
                    import traceback

                    traceback.print_exc()

    def tick(self) -> TickResult:
        """Gather one tick of audio from every stream and score it."""
        step_start = time.perf_counter()
        batch, status = self.mux.gather(self.samples_per_tick, threads=self.gather_threads)
        any_fired = bool(self.engine.push(batch))
        last = np.asarray(self.engine.last_fired)
        fired = last.any(axis=1) if last.ndim == 2 else last  # blocked: any hop
        self.ticks += 1
        self._track_cadence(time.perf_counter() - step_start)
        self.detections += fired
        self.underruns += status == 0
        self.overruns += status == -1
        if any_fired:
            idx = np.flatnonzero(fired)
            for listener in self._listeners:
                try:
                    listener(idx, self.ticks)
                except Exception:  # noqa: BLE001 — a user callback must not
                    # kill the serving loop (start() runs tick() on a thread)
                    import traceback

                    traceback.print_exc()
        return TickResult(fired=fired, status=status, any_fired=any_fired)

    def run_ticks(self, n: int, realtime: bool = False) -> None:
        """Run ``n`` ticks on the calling thread; ``realtime`` paces them at
        the engine cadence (sleeping off time the device step didn't use)."""
        for _ in range(n):
            start = time.perf_counter()
            self.tick()
            if realtime:
                budget = self.tick_seconds - (time.perf_counter() - start)
                if budget > 0:
                    time.sleep(budget)

    def start(self) -> "MultiStreamServer":
        """Serve on a background thread at the real-time cadence until stop()."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                start = time.perf_counter()
                self.tick()
                budget = self.tick_seconds - (time.perf_counter() - start)
                if budget > 0:
                    self._stop.wait(budget)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
