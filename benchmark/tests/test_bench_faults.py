"""A run with the timed path broken underneath comes out not correct: each
fault that a cell can have, planted in the program, on the CPU at a tiny
size (the look for a card is the command's alone; ``run_cell`` drives the
rest of a run). The cells run on one card, so no exchange between cards
can be left out."""

import pytest
import torch
from bench_tiny import run_tiny


def _engine_classes():
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.inference.online import OnlineEngine
    from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine

    return StreamingEngine, OnlineEngine, FusedStreamingOnlineEngine


def _failed(result, name):
    assert result["correct"] is False
    check = result["checks"][name]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("cell", ["res8-offline-long", "mobilenet-offline-clips"])
def test_offline_answer_altered(monkeypatch, cell):
    cls = _engine_classes()[0]
    infer = cls.infer_batch

    def altered(self, audio, *a, **kw):
        out = infer(self, audio, *a, **kw)
        out["fired"] = out["fired"].clone()
        out["fired"][:, -1] = ~out["fired"][:, -1]  # the last window's decision of every recording
        return out

    monkeypatch.setattr(cls, "infer_batch", altered)
    _failed(run_tiny(cell)[0], "decision_mismatches")


@pytest.mark.parametrize("cell", ["res8-offline-long", "mobilenet-offline-clips"])
def test_offline_posteriors_altered(monkeypatch, cell):
    cls = _engine_classes()[0]
    infer = cls.infer_batch

    def altered(self, audio, *a, **kw):
        out = infer(self, audio, *a, **kw)
        out["probs"] = out["probs"].roll(1, dims=-1)
        return out

    monkeypatch.setattr(cls, "infer_batch", altered)
    _failed(run_tiny(cell)[0], "probs_gap_mean")


@pytest.mark.parametrize("cell", ["res8-offline-long", "mobilenet-offline-clips"])
def test_offline_half_of_the_batch_left_out(monkeypatch, cell):
    """The first half scored, the second half given the first half's mean."""
    cls = _engine_classes()[0]
    score = cls._score

    def half(self, audio, n_windows):
        b = audio.shape[0] // 2
        probs = score(self, audio[:b], n_windows)
        return torch.cat([probs, probs.mean(dim=0, keepdim=True).expand(audio.shape[0] - b, -1, -1)])

    monkeypatch.setattr(cls, "_score", half)
    _failed(run_tiny(cell, pool_batches=1)[0], "probs_gap_worst" if "mobilenet" in cell else "probs_gap_mean")


def test_live_trunk_step_returns_its_state_unchanged(monkeypatch):
    cls = _engine_classes()[2]
    step = cls._hop_step

    def unchanged(self, phase, new_audio, tail, mel_cache, rings, s6_ring, state, t_now, valid):
        out = step(self, phase, new_audio, tail, mel_cache, rings, s6_ring, state, t_now, valid)
        return (tail, mel_cache, rings, s6_ring, state) + tuple(out[5:])

    monkeypatch.setattr(cls, "_hop_step", unchanged)
    _failed(run_tiny("res8-live-65k", seconds=0.6)[0], "probs_gap")


def test_live_window_step_returns_its_state_unchanged(monkeypatch):
    """The OnlineEngine scores each hop's whole window, so a stale state
    shows in the decisions: the FSM never sees the earlier hops' labels."""
    cls = _engine_classes()[1]
    step = cls._step

    def unchanged(self, audio, state, t_now, carry=None):
        return (state,) + tuple(step(self, audio, state, t_now, carry)[1:])

    monkeypatch.setattr(cls, "_step", unchanged)
    # sixteen streams over a ring of eight windows: some stream's labels walk the wake sequence
    result, _ = run_tiny("mobilenet-live-4k", seconds=1.5, streams=16, check_streams=16, ring_hops=8)
    _failed(result, "decision_mismatches")


@pytest.mark.parametrize("cell", ["res8-live-65k", "mobilenet-live-4k"])
def test_live_answer_altered(monkeypatch, cell):
    cls = _engine_classes()[1].__mro__[1]  # _HopEngine: both live engines fetch through it
    fetch = cls._fetch

    def altered(self, label, fired):
        return fetch(self, label, ~fired)

    monkeypatch.setattr(cls, "_fetch", altered)
    _failed(run_tiny(cell)[0], "decision_mismatches")
