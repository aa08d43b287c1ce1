"""The port's capacity model (howl_tpu_torch/inference/capacity.py) against
the JAX package's (howl_tpu/inference/capacity.py).

Given the same profile points and margin, the two modules compute the same
fits, step predictions, sustainable counts, reports, recommendations and
tables, over the engine kinds, hop blocks and stream counts below (floats
within 1e-12 relative). The port's own ``PROFILES`` are the card's
(``tools/gen_capacity_table.py --calibrate``); they are checked for their
form only, since their numbers are measurements. Where a scaled profile has
no base, the port reports the configuration as unprofiled, where JAX's
``_profile`` raises ``KeyError``.
"""

from __future__ import annotations

import numpy as np
import pytest

from howl_tpu.inference import capacity as jax_capacity
from howl_tpu_torch.inference import capacity

# two profile sets in JAX's form: its round-4 points, and a second with a
# negative intercept (the fit re-anchors) and ceilings that bind
POINT_SETS = {
    "jax-round-4": {
        ("online", 1): (((0, 0.0), (75210, 62.5)), 75210, 1, 0),
        ("incremental", 1): (((1024, 1.04), (16384, 14.185), (65536, 59.018)), 100410, 1, 0),
        ("streaming_trunk", 1): (((16384, 5.999), (65536, 24.765)), 170703, 1, 4),
        ("streaming_trunk", 3): (((16384, 5.301), (65536, 20.377)), 201012, 3, 6),
    },
    "re-anchored": {
        ("online", 1): (((1024, 0.5), (65536, 180.0)), 20000, 1, 0),
        ("incremental", 1): (((1024, 0.2), (16384, 40.0), (65536, 150.0)), 15000, 1, 0),
        ("streaming_trunk", 1): (((1024, 9.0), (65536, 120.0)), 40000, 1, 4),
        ("streaming_trunk", 3): (((1024, 20.0), (65536, 200.0)), 30000, 3, 6),
    },
}
COUNTS = (1, 512, 4096, 16384, 30000, 65536, 100000, 160000, 1_000_000)


def _profiles(module, points: dict) -> dict:
    return {key: module.EngineProfile(key[0], f"{key[0]} {key[1]}", pts, ceiling, hops_per_step=hops,
                                      extra_latency_hops=lag)
            for key, (pts, ceiling, hops, lag) in points.items()}


@pytest.fixture(params=list(POINT_SETS))
def same_profiles(request, monkeypatch):
    points = POINT_SETS[request.param]
    monkeypatch.setattr(jax_capacity, "PROFILES", _profiles(jax_capacity, points))
    monkeypatch.setattr(capacity, "PROFILES", _profiles(capacity, points))
    monkeypatch.setattr(capacity, "VARIANCE_MARGIN", jax_capacity.VARIANCE_MARGIN)
    return points


@pytest.mark.parametrize("kind,hop_block", [("online", 1), ("incremental", 1), ("streaming_trunk", 1),
                                            ("streaming_trunk", 3), ("streaming_trunk", 6), ("streaming_trunk", 9)])
def test_profiles_predict_as_jaxs(same_profiles, kind, hop_block):
    ours, theirs = capacity._profile(kind, hop_block), jax_capacity._profile(kind, hop_block)
    assert (ours.label, ours.points, ours.ceiling, ours.hops_per_step, ours.extra_latency_hops) == (
        theirs.label, theirs.points, theirs.ceiling, theirs.hops_per_step, theirs.extra_latency_hops)
    np.testing.assert_allclose(ours.fit(), theirs.fit(), rtol=1e-12)
    assert ours.budget_ms() == theirs.budget_ms()
    for hop_ms in (62.5, 125.0):
        assert ours.sustainable_streams(hop_ms) == theirs.sustainable_streams(hop_ms)
    for n in COUNTS:
        assert ours.predict_step_ms(n) == pytest.approx(theirs.predict_step_ms(n), rel=1e-12)
        r, j = capacity.check_capacity(kind, n, hop_block), jax_capacity.check_capacity(kind, n, hop_block)
        assert (r.ok, r.kind, r.hop_block, r.num_streams, r.budget_ms, r.sustainable_streams) == (
            j.ok, j.kind, j.hop_block, j.num_streams, j.budget_ms, j.sustainable_streams)
        assert r.predicted_step_ms == pytest.approx(j.predicted_step_ms, rel=1e-12)
        assert ("cannot sustain" in r.message) == ("cannot sustain" in j.message) == (not r.ok)


@pytest.mark.parametrize("supports_trunk", [True, False])
def test_recommend_as_jax(same_profiles, supports_trunk):
    for n in COUNTS:
        try:
            want = jax_capacity.recommend(n, supports_trunk=supports_trunk)
        except jax_capacity.CapacityError:
            with pytest.raises(capacity.CapacityError, match="no single-card engine sustains"):
                capacity.recommend(n, supports_trunk=supports_trunk)
            continue
        assert capacity.recommend(n, supports_trunk=supports_trunk) == want


def test_capacity_table_as_jaxs(same_profiles):
    assert capacity.capacity_table() == jax_capacity.capacity_table()
    assert capacity.capacity_table(125.0) == jax_capacity.capacity_table(125.0)


def test_an_unprofiled_configuration_reports_as_unprofiled(monkeypatch):
    points = dict(POINT_SETS["jax-round-4"])
    del points[("streaming_trunk", 3)]
    monkeypatch.setattr(capacity, "PROFILES", _profiles(capacity, points))
    monkeypatch.setattr(jax_capacity, "PROFILES", _profiles(jax_capacity, points))
    with pytest.raises(KeyError):  # JAX's _profile reads the base profile directly
        jax_capacity.check_capacity("streaming_trunk", 100, hop_block=6)
    for kind, hop_block in (("streaming_trunk", 6), ("streaming_trunk", 3), ("mystery", 1)):
        report = capacity.check_capacity(kind, 100, hop_block)
        assert report.ok and report.sustainable_streams == 100 and "no capacity profile" in report.message
    # recommend skips what is not profiled
    assert capacity.recommend(10) == {"incremental": True}
    monkeypatch.setattr(capacity, "PROFILES", {})
    with pytest.raises(capacity.CapacityError, match="no capacity profile"):
        capacity.recommend(10)


def test_the_ports_profiles_are_whole_measurements():
    """Every profile the calibration measures is there, with at least two
    points of rising stream counts, a positive ceiling and a positive margin;
    the hub's checks have something to check (each sustains streams)."""
    from howl_tpu_torch.tools.gen_capacity_table import ENGINES, markdown_table

    assert set(capacity.PROFILES) == set(ENGINES)
    assert 0.0 < capacity.VARIANCE_MARGIN < 0.5
    for (kind, hop_block), prof in capacity.PROFILES.items():
        assert (prof.kind, prof.hops_per_step, prof.label) == (kind, hop_block, ENGINES[kind, hop_block][1])
        counts = [n for n, _ in prof.points]
        assert len(counts) >= 2 and counts == sorted(counts) and all(ms > 0 for _, ms in prof.points)
        assert prof.ceiling > 0 and prof.sustainable_streams() > 0
    assert markdown_table().count("\n") == len(capacity.PROFILES) + 1
