"""The port's live client and multi-stream server
(howl_tpu_torch/client/) against the JAX package's (howl_tpu/client/).

* ``HowlClient.from_workspace`` over ``FileAudioSource`` replays of the tone
  corpus, on the port workspace, counts the detections JAX's client counts
  on the JAX workspace of the same weights (``tests/torch_serving.py``:
  res8, a word and threshold every decision of which sits 0.01 from
  flipping), for the ``OnlineEngine``, the incremental and the
  streaming-trunk engines, the positives' WAVs and the negatives'; its
  listeners hear the sequence; a hop-blocked engine is refused.
* ``MultiStreamServer.tick`` over the same pushes (late streams that
  underrun, a lapped one that overruns) gives JAX's per-tick ``fired`` and
  statuses and its ``detections``, ``underruns`` and ``overruns``.
* The cadence alarm fires after ``alarm_after`` late ticks of a slow
  engine, once an episode, as tests/test_capacity.py holds JAX's.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch

from howl_tpu import hub as jax_hub
from howl_tpu.client.howl_client import FileAudioSource as JaxFileAudioSource
from howl_tpu.client.howl_client import HowlClient as JaxHowlClient
from howl_tpu.client.stream_server import MultiStreamServer as JaxMultiStreamServer
from howl_tpu.settings import SETTINGS as JAX_SETTINGS
from howl_tpu_torch import hub
from howl_tpu_torch.client import FileAudioSource, HowlClient, MicrophoneAudioSource
from howl_tpu_torch.client.howl_client import _reject_blocked
from howl_tpu_torch.client.stream_server import CadenceAlarm, MultiStreamServer
from howl_tpu_torch.settings import SETTINGS
from tests.torch_serving import family_setup

torch.set_num_threads(1)

KINDS = {"online": {}, "incremental": {"incremental": True}, "trunk": {"streaming_trunk": True}}


@pytest.fixture(scope="module")
def res8(tmp_path_factory):
    yield family_setup(tmp_path_factory.mktemp("res8"), "res8")
    SETTINGS.reset()


@pytest.fixture(autouse=True)
def _reset_settings():
    yield
    SETTINGS.reset()
    JAX_SETTINGS.reset()


@pytest.mark.parametrize("kind", list(KINDS))
def test_client_counts_the_jax_clients_detections(res8, kind):
    counts = {}
    for clip_set in ("pos", "neg"):
        heard = []
        jx = JaxHowlClient.from_workspace(res8["jax"], source=JaxFileAudioSource(res8[clip_set]), **KINDS[kind])
        pt = HowlClient.from_workspace(res8["port"], source=FileAudioSource(res8[clip_set]), device="cpu",
                                       **KINDS[kind])
        pt.add_listener(heard.append)
        for client in (jx, pt):
            client.start().join()
        assert pt.detections == jx.detections
        assert heard == [[res8["pick"]["word"]]] * pt.detections
        counts[clip_set] = pt.detections
    assert sorted(counts.values())[0] == 0 and sum(counts.values()) > 0, f"one replay fires, one does not: {counts}"


def test_client_refuses_a_blocked_engine_and_sizes_its_ring_from_the_engine(res8):
    blocked, _ = hub.load_workspace_engine(res8["port"], streaming_trunk=True, hop_block=3, device="cpu")
    with pytest.raises(ValueError, match="hop-blocked"):
        HowlClient(engine=blocked)
    with pytest.raises(ValueError, match="hop-blocked"):
        _reject_blocked(blocked)
    engine, ctx = hub.load_workspace_engine(res8["port"], device="cpu")
    client = HowlClient(engine=engine, context=ctx)
    client.ingest_chunk(np.zeros(500, "<i2").tobytes())
    assert client._audio_buf_len == engine.window_samples // 500 == 16
    assert client._ring.capacity == 4 * engine.window_samples
    with pytest.raises(AttributeError):
        HowlClient().start()


def test_microphone_source_needs_pyaudio():
    source = MicrophoneAudioSource(chunk_size=500)
    assert (source.sample_rate, source.chunk_size) == (16000, 500)
    try:
        import pyaudio  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="pyaudio"):
            next(iter(source))
    source.close()


def _pushes(audio: np.ndarray, hop: int, ticks: int):
    """Per tick, the (stream, samples) pushes: stream 0 one hop a tick;
    stream 1 nothing on ticks 3-5 (three underruns), then those hops late,
    and on tick 12 six hops at once (the ring of 4 hops overruns)."""
    plan, sent = [], [0, 0]
    for t in range(ticks):
        tick = [(0, 1)]
        if t not in (3, 4, 5):
            tick.append((1, 4 if t == 6 else (6 if t == 12 else 1)))
        out = []
        for s, n in tick:
            out.append((s, audio[s, sent[s] * hop : (sent[s] + n) * hop]))
            sent[s] += n
        plan.append(out)
    return plan


def test_server_ticks_as_jaxs(res8):
    jx, _ = jax_hub.load_workspace_engine(res8["jax"], num_streams=2, incremental=True)
    pt, _ = hub.load_workspace_engine(res8["port"], num_streams=2, incremental=True, device="cpu")
    servers = (JaxMultiStreamServer(jx, capacity_ticks=4), MultiStreamServer(pt, capacity_ticks=4))
    plan = _pushes(res8["audio"], pt.hop_samples, res8["audio"].shape[1] // pt.hop_samples - 6)
    for tick in plan:
        for server in servers:
            for s, pcm in tick:
                server.push(s, pcm)
        want, got = (server.tick() for server in servers)
        np.testing.assert_array_equal(got.fired, want.fired)
        np.testing.assert_array_equal(got.status, want.status)
        assert got.any_fired == want.any_fired
    jaxs, ours = servers
    for name in ("detections", "underruns", "overruns"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(jaxs, name))
    assert ours.ticks == len(plan) and ours.underruns[1] >= 3 and ours.overruns[1] >= 1
    assert ours.detections.sum() > 0


def test_server_rejects_a_whole_window_engine(res8):
    engine, _ = hub.load_workspace_engine(res8["port"], num_streams=2, device="cpu")
    with pytest.raises(ValueError, match="push-based"):
        MultiStreamServer(engine)


class _SlowEngine:
    """A push engine whose step takes ``step_seconds``."""

    def __init__(self, num_streams=4, step_seconds=0.0):
        self.num_streams = num_streams
        self.hop_samples = 1000
        self.cfg = types.SimpleNamespace(sample_rate=16000)
        self.last_fired = np.zeros(num_streams, bool)
        self.step_seconds = step_seconds

    def push(self, batch):
        if self.step_seconds:
            time.sleep(self.step_seconds)
        return False


def test_server_alarms_on_a_sustained_cadence_breach():
    engine = _SlowEngine(step_seconds=0.075)  # over the 62.5 ms tick
    server = MultiStreamServer(engine, alarm_after=3)
    alarms = []
    server.add_alarm_listener(alarms.append)
    server.run_ticks(5)
    assert server.late_ticks == 5 and server.alarms == 1 and len(alarms) == 1
    assert isinstance(alarms[0], CadenceAlarm) and alarms[0].consecutive == 3
    assert alarms[0].step_seconds > alarms[0].tick_seconds
    engine.step_seconds = 0.0
    server.run_ticks(2)
    assert server.consecutive_late == 0
    engine.step_seconds = 0.075
    server.run_ticks(3)
    assert server.alarms == 2 and len(alarms) == 2


def test_server_does_not_alarm_on_jitter():
    engine = _SlowEngine()
    server = MultiStreamServer(engine, alarm_after=3)
    alarms = []
    server.add_alarm_listener(alarms.append)
    for slow in (True, False, True, False, True, False):
        engine.step_seconds = 0.075 if slow else 0.0
        server.run_ticks(1)
    assert server.late_ticks == 3 and server.alarms == 0 and alarms == []


def test_server_survives_a_raising_listener(capsys):
    engine = _SlowEngine(num_streams=2)
    engine.last_fired = np.array([True, False])
    engine.push = lambda batch: True
    server = MultiStreamServer(engine)
    server.add_listener(lambda idx, tick: 1 / 0)
    heard = []
    server.add_listener(lambda idx, tick: heard.append((idx.tolist(), tick)))
    server.run_ticks(2)
    assert heard == [([0], 1), ([0], 2)] and "ZeroDivisionError" in capsys.readouterr().err
    server.start()
    time.sleep(0.2)
    server.stop()
    assert server._thread is None and server.ticks > 2
