"""Live wake-word client (counterpart of ``howl_tpu/client/howl_client.py``;
ref howl/client/howl_client.py:14-164).

The reference's cadence: 16 kHz mono int16 in 500-sample chunks, a ring of
PCM re-scored every 2 chunks (the 62.5 ms hop), a fire reported once until
a hop does not fire, and listener callbacks. The ring is sized from the
engine's scoring window (the reference fixes it at 16 chunks, 500 ms) and
is the native one (``howl_tpu_torch.native``). An engine with ``push``
(incremental, streaming trunk) gets only each hop's new samples; the
``OnlineEngine`` gets the window ending at each hop.

The audio source is any iterator of int16 byte chunks:
``MicrophoneAudioSource`` reads a microphone through pyaudio (imported when
it starts, since it is not a dependency of the package);
``FileAudioSource`` replays WAV files.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np

from howl_tpu_torch.utils import audio_utils
from howl_tpu_torch.utils.logger import Logger


class MicrophoneAudioSource:
    """A PortAudio microphone stream -> int16 chunks (needs pyaudio)."""

    def __init__(self, sample_rate: int = 16000, chunk_size: int = 500):
        self.sample_rate = sample_rate
        self.chunk_size = chunk_size
        self._audio = None
        self._stream = None

    def __iter__(self) -> Iterator[bytes]:
        try:
            import pyaudio
        except ImportError as e:
            raise RuntimeError("pyaudio is not installed; use FileAudioSource or provide your own chunk iterator") from e
        self._audio = pyaudio.PyAudio()
        chosen_idx = 0
        for idx in range(self._audio.get_device_count()):
            if self._audio.get_device_info_by_index(idx)["name"] in ("pulse", "sysdefault"):
                chosen_idx = idx
                break
        self._stream = self._audio.open(format=pyaudio.paInt16, channels=1, rate=self.sample_rate, input=True,
                                        input_device_index=chosen_idx, frames_per_buffer=self.chunk_size)
        while True:
            yield self._stream.read(self.chunk_size, exception_on_overflow=False)

    def close(self):
        if self._stream is not None:
            self._stream.stop_stream()
            self._stream.close()
        if self._audio is not None:
            self._audio.terminate()


class FileAudioSource:
    """Replays WAV file(s) as int16 chunks (tests and offline runs)."""

    def __init__(self, paths, sample_rate: int = 16000, chunk_size: int = 500, realtime: bool = False):
        self.paths = [paths] if isinstance(paths, (str, Path)) else list(paths)
        self.sample_rate = sample_rate
        self.chunk_size = chunk_size
        self.realtime = realtime

    def __iter__(self) -> Iterator[bytes]:
        for path in self.paths:
            audio = audio_utils.silent_load(path, self.sample_rate)
            pcm = np.clip(audio * 32768.0, -32768, 32767).astype("<i2")
            for start in range(0, len(pcm) - self.chunk_size + 1, self.chunk_size):
                if self.realtime:
                    time.sleep(self.chunk_size / self.sample_rate)
                yield pcm[start : start + self.chunk_size].tobytes()

    def close(self):
        pass


def _reject_blocked(engine):
    """The client serves one hop at a time (ref howl_client.py:85-94); a
    hop-blocked engine takes hop_block hops a push and would fail mid-stream,
    so it is refused when the client is built."""
    if engine is not None and getattr(engine, "hop_block", 1) > 1:
        raise ValueError(
            f"HowlClient serves per-hop; hop-blocked engines (hop_block={engine.hop_block}) are the bulk/capacity "
            "mode: load the workspace with hop_block=1 for live client serving"
        )
    return engine


class HowlClient:
    """The wake-word serving loop over a live engine::

        client = HowlClient.from_workspace("workspaces/hey-ff", "res8")
        client.add_listener(lambda words: print("detected:", words))
        client.start().join()
    """

    def __init__(self, engine=None, context=None, source: Optional[Iterable[bytes]] = None, chunk_size: int = 500):
        self.engine = _reject_blocked(engine)
        self.ctx = context
        self.source = source
        self.chunk_size = chunk_size
        self.listeners: List[Callable] = []
        self._infer_detected = False
        self._running = False
        self.detections = 0
        # sized from the engine's window once there is an engine (the
        # reference's fixed 500 ms would left-pad a longer window with silence)
        self._ring = None
        self._audio_buf_len = None
        self._chunks_since_infer = 0
        self._chunks_total = 0

    def _ensure_ring(self):
        """The native PCM ring, once the engine is known: it holds four of the
        engine's scoring windows (16 chunks for an engine without one)."""
        if self._ring is not None:
            return
        window = getattr(self.engine, "window_samples", None) or self.chunk_size * 16
        self._audio_buf_len = max(-(-window // self.chunk_size), 1)
        from howl_tpu_torch.native import NativeRingBuffer

        self._ring = NativeRingBuffer(capacity=self.chunk_size * self._audio_buf_len * 4)

    # ---- construction ----

    @classmethod
    def from_workspace(cls, workspace_path, model_name: str = None, source=None, incremental: bool = False,
                       streaming_trunk: bool = False, device="cuda", **kwargs) -> "HowlClient":
        from howl_tpu_torch.hub import load_workspace_engine

        engine, ctx = load_workspace_engine(workspace_path, model_name, incremental=incremental,
                                            streaming_trunk=streaming_trunk, device=device)
        return cls(engine=engine, context=ctx, source=source, **kwargs)

    def from_pretrained(self, name: str, models_path=None, device="cuda"):
        """Load a published model by name (ref howl_client.py:148) from
        ``models_path`` or ``$HOWL_MODELS_PATH``, a checkout of a
        howl-models-style repository of workspaces."""
        from howl_tpu_torch.hub import load_pretrained

        engine, self.ctx = load_pretrained(name, models_path, device=device)
        self.engine = _reject_blocked(engine)
        return self

    def add_listener(self, listener: Callable):
        self.listeners.append(listener)
        return self

    # ---- the loop ----

    def ingest_chunk(self, chunk: bytes) -> bool:
        """Feed one chunk; scores every 2 chunks once the window is full (the
        reference's cadence, howl_client.py:85-94), or every hop for a push
        engine. True when the wake word fired on this hop."""
        self._ensure_ring()
        self._ring.push_int16(chunk)
        self._chunks_total += 1
        self._chunks_since_infer += 1
        if hasattr(self.engine, "push"):
            # the engine keeps its own features: only the new hop's samples,
            # from the first hop on (its ring starts as silence)
            hop = self.engine.hop_samples
            if hop % self.chunk_size:
                raise ValueError(
                    f"chunk_size={self.chunk_size} must divide the incremental engine's hop ({hop} samples); "
                    "other chunks would hand the engine short or overlapping windows"
                )
            if self._chunks_since_infer < hop // self.chunk_size:
                return False
            self._chunks_since_infer = 0
            fired = self.engine.push(self._ring.latest(hop))
        else:
            if self._chunks_total < self._audio_buf_len:
                return False  # the ring is still filling to the first window
            if self._chunks_total > self._audio_buf_len and self._chunks_since_infer < 2:
                return False  # re-score every 2 chunks (62.5 ms)
            self._chunks_since_infer = 0
            window = getattr(self.engine, "window_samples", self.chunk_size * self._audio_buf_len)
            fired = self.engine.ingest(self._ring.latest(window))
        if fired:
            if self._infer_detected:
                return False
            self._infer_detected = True
            self.detections += 1
            seq = list(self.engine.cfg.inference_sequence)
            phrase = " ".join(str(self.ctx.vocab[x]) for x in seq).title() if self.ctx is not None else f"sequence {seq}"
            Logger.info(f"{phrase} detected")
            for listener in self.listeners:
                listener(list(seq))
            return True
        self._infer_detected = False
        return False

    def start(self) -> "HowlClient":
        if self.engine is None:
            raise AttributeError("provide an engine or initialize via from_pretrained/from_workspace")
        if self.source is None:
            self.source = MicrophoneAudioSource(chunk_size=self.chunk_size)
        self._running = True
        Logger.info("starting howl_tpu_torch inference client...")
        return self

    def join(self):
        """Consume the audio source until it ends (a microphone never does)."""
        try:
            for chunk in self.source:
                if not self._running:
                    break
                self.ingest_chunk(chunk)
        finally:
            close = getattr(self.source, "close", None)
            if close:
                close()

    def stop(self):
        self._running = False
