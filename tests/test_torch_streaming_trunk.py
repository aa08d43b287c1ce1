"""The port's streaming-trunk engine (howl_tpu_torch/inference/
streaming_trunk.py) and res8's streaming methods against the JAX package's,
and against the port's own offline fused-trunk scorer.

* ``TrunkSchedule``: every constant (period, n_new, lag, the cache and ring
  lengths, the per-phase delta, slab start and gap, and the blocked
  constants) equals JAX's over tests/test_streaming_trunk.py's fuzzed
  geometries, and the two refuse the same ones.
* ``Res8.trunk_intermediates`` and ``Res8.trunk_stream_step`` against JAX's
  on the same weights and inputs (float32: 1e-5).
* The engine, pushed hop by hop at ``hop_block`` 1 and at the schedule's
  period, against the port's offline ``StreamingEngine.score_batch`` /
  ``infer_batch`` on (preroll + the pushed audio): every window's
  posteriors within 1e-5 (float32), labels and fire flags equal, at the
  default geometry and at 125 ms / 750 ms; and against its JAX twin:
  posteriors within 1e-4 in float32 and 2e-2 in bf16, labels and fire flags
  equal.
* ``make_chained_runner`` replays ``push``; the prefill in blocks equals
  one block; shapes and arguments are checked as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.inference import EngineConfig as JaxEngineConfig
from howl_tpu.inference.streaming_trunk import FusedStreamingOnlineEngine as JaxFusedStreamingOnlineEngine
from howl_tpu.inference.streaming_trunk import TrunkSchedule as JaxTrunkSchedule
from howl_tpu.models import create_model as jax_create_model
from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.inference import EngineConfig, StreamingEngine
from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine, TrunkSchedule, make_chained_runner
from howl_tpu_torch.models import create_model
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

ZMUV = (-6.0, 4.0)
BASE = dict(inference_sequence=(0, 1, 2), max_window_size_ms=500.0, eval_stride_size_ms=62.5, negative_label=3,
            num_labels=4, inference_threshold=0.0)
OTHER = dict(max_window_size_ms=750.0, eval_stride_size_ms=125.0)


def _variables(seed):
    rng = np.random.default_rng(seed)
    variables = jax_create_model("res8", num_labels=4).init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 1, 40, 41)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    for i in range(1, 7):
        variables["batch_stats"][f"bn{i}"] = {"mean": rng.normal(0.0, 0.1, 45).astype(np.float32),
                                              "var": rng.uniform(0.5, 1.5, 45).astype(np.float32)}
    return variables


@pytest.fixture(scope="module")
def variables():
    return _variables(61)


def _engine(variables, cfg_kw, dtype=None, **kw):
    return FusedStreamingOnlineEngine(create_model("res8", num_labels=4), res8_variables_to_state_dict(variables),
                                      EngineConfig(**cfg_kw), FrontendConfig(n_mels=40), *ZMUV,
                                      num_streams=kw.pop("num_streams", 2), compute_dtype=dtype, device="cpu", **kw)


def _offline(variables, cfg_kw, dtype=None):
    return StreamingEngine(create_model("res8", num_labels=4), res8_variables_to_state_dict(variables),
                           EngineConfig(**cfg_kw), FrontendConfig(n_mels=40), *ZMUV, compute_dtype=dtype,
                           frontend_precision="auto", device="cpu")


def _jax_engine(variables, cfg_kw, dtype=None, **kw):
    return JaxFusedStreamingOnlineEngine(jax_create_model("res8", num_labels=4), variables, JaxEngineConfig(**cfg_kw),
                                         JaxFrontendConfig(n_mels=40), *ZMUV, num_streams=kw.pop("num_streams", 2),
                                         compute_dtype=dtype, **kw)


def _hops(engine, seed, n_hops, amp=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_hops, engine.num_streams, engine.hop_samples)) * amp).astype(np.float32)


def _clip(engine, hops):
    """The stream the offline scorer sees: the engine's silent preroll, then the hops."""
    preroll = np.zeros((engine.num_streams, engine.window_frames * engine.frontend.hop_length), np.float32)
    return np.concatenate([preroll] + list(hops), axis=1)


def _stream(engine, hops):
    """Push ``hops`` (blocked engines take hop_block of them a push);
    {window k: (posteriors, labels, fire flags)} for every decided window."""
    lag, H = engine.schedule.lag, engine.hop_block
    out = {}
    for b in range(len(hops) // H):
        engine.push(np.concatenate(list(hops[b * H : (b + 1) * H]), axis=1))
        probs = np.asarray(engine.last_probs.float() if torch.is_tensor(engine.last_probs) else engine.last_probs)
        labels, fired = np.asarray(engine.last_labels), np.asarray(engine.last_fired)
        if H == 1:
            probs, labels, fired = probs[:, None], labels[:, None], fired[:, None]
        for h in range(H):
            k = b * H + h + 1 - lag
            if k >= 0:
                out[k] = probs[:, h], labels[:, h], fired[:, h]
    return out


def _firing_kw(offline, clip, cfg_kw):
    """A one-word configuration on the offline scorer's most frequent top
    label at threshold 0, so that windows fire."""
    probs = offline.score_batch(clip)["probs"].numpy()
    word = int(np.bincount(probs.argmax(-1).ravel(), minlength=4).argmax())
    return dict(cfg_kw, inference_sequence=(word,), negative_label=(word + 1) % 4, inference_threshold=0.0)


# ---- the schedule ----


def test_trunk_schedule_equals_jax_over_the_fuzzed_geometries():
    built = refused = 0
    for pool_t in (2, 3, 4):
        for stride in (2, 3, 4, 5, 6, 8, 10):
            for span in (8, 13, 21):
                m0 = 40 + pool_t * (span + 10)
                try:
                    want = JaxTrunkSchedule(m0, stride, pool_t, span)
                except ValueError:
                    with pytest.raises(ValueError, match="no decision lag"):
                        TrunkSchedule(m0, stride, pool_t, span)
                    refused += 1
                    continue
                got = TrunkSchedule(m0, stride, pool_t, span)
                for name in ("period", "n_new", "slab_frames", "mel_cache_len", "lag", "s6_ring_len", "by_phase"):
                    assert getattr(got, name) == getattr(want, name), (name, pool_t, stride, span)
                for hop_block in range(1, 4 * got.period + 1):
                    try:
                        blocked = want.blocked(hop_block)
                    except ValueError:
                        with pytest.raises(ValueError, match="multiple of the schedule"):
                            got.blocked(hop_block)
                        continue
                    assert got.blocked(hop_block) == blocked, (pool_t, stride, span, hop_block)
                built += 1
    assert built >= 50 and built + refused == 63


def test_default_geometry_schedule():
    s = TrunkSchedule(40, 5, 3, 13)
    assert (s.period, s.n_new, s.lag, s.slab_frames) == (3, 2, 4, 8)
    assert round(2.5) == 2 and round(3.5) == 4  # the half-to-even rounding r(k) relies on


# ---- res8's streaming methods ----


def _models(variables):
    from howl_tpu.models.cnn import Res8 as JaxRes8

    model = create_model("res8", num_labels=4)
    model.load_state_dict(res8_variables_to_state_dict(variables))
    return JaxRes8(num_labels=4), model.eval()


def test_trunk_intermediates_match_jax(variables):
    jmodel, model = _models(variables)
    feats = (np.random.default_rng(3).standard_normal((2, 1, 40, 40)) * 1.5).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(feats), method="trunk_intermediates")
    with torch.no_grad():
        got = model.trunk_intermediates(torch.from_numpy(feats))
    assert sorted(got) == sorted(want) == ["r2", "r4", "s0", "s1", "s2", "s3", "s4", "s5", "s6"]
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5, atol=1e-5, err_msg=name)
    with torch.no_grad():  # the whole-clip trunk's last stage is the offline trunk
        np.testing.assert_allclose(got["s6"].numpy(), model.trunk_features(torch.from_numpy(feats)).numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("delta", [1, 2])
def test_trunk_stream_step_matches_jax(variables, delta):
    jmodel, model = _models(variables)
    rng = np.random.default_rng(4 + delta)
    n_new = 2
    slab = rng.standard_normal((2, n_new * 3 + 2, 40, 1)).astype(np.float32)
    rings = {name: (rng.standard_normal((2, n_new + 2, 10, 45)) * 0.5).astype(np.float32)
             for name in ("s0", "s1", "s2", "s3", "s4", "s5", "r2", "r4")}
    want_rings, want_s6 = jmodel.apply(variables, jnp.asarray(slab), {k: jnp.asarray(v) for k, v in rings.items()},
                                       delta, method="trunk_stream_step")
    with torch.no_grad():
        got_rings, got_s6 = model.trunk_stream_step(torch.from_numpy(slab),
                                                    {k: torch.from_numpy(v) for k, v in rings.items()}, delta)
    assert got_s6.dtype == torch.float32 and tuple(got_s6.shape) == (2, n_new, 45)
    np.testing.assert_allclose(got_s6.numpy(), np.asarray(want_s6), rtol=1e-5, atol=1e-5)
    for name in rings:
        assert tuple(got_rings[name].shape) == rings[name].shape
        np.testing.assert_allclose(got_rings[name].numpy(), np.asarray(want_rings[name]), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# ---- the engine against the offline scorer ----


@pytest.mark.parametrize("geometry", ["default", "125ms-750ms"])
@pytest.mark.parametrize("blocked", [False, True], ids=["per-hop", "hop_block=period"])
def test_engine_matches_the_offline_fused_scorer(variables, blocked, geometry):
    cfg_kw = dict(BASE, **(OTHER if geometry != "default" else {}))
    probe = _engine(variables, cfg_kw)
    n_hops = 6 * probe.schedule.period + probe.schedule.lag + 2
    hops = _hops(probe, 7, n_hops)
    offline = _offline(variables, cfg_kw)
    cfg_kw = _firing_kw(offline, _clip(probe, hops), cfg_kw)
    offline = _offline(variables, cfg_kw)
    engine = _engine(variables, cfg_kw, hop_block=probe.schedule.period if blocked else 1)
    if geometry == "default":
        assert (engine.schedule.lag, engine.schedule.period) == (4, 3)
    out = offline.infer_batch(_clip(engine, hops))
    got = _stream(engine, hops)
    # the offline scorer's last windows clamp their spans at the clip's edge
    n_compare = n_hops - engine.schedule.lag - 2
    assert n_compare >= 12 and all(k in got for k in range(n_compare))
    for k in range(n_compare):
        probs, labels, fired = got[k]
        np.testing.assert_allclose(probs, out["probs"][:, k].numpy(), rtol=1e-5, atol=1e-5, err_msg=f"window {k}")
        np.testing.assert_array_equal(labels, out["labels"][:, k].numpy(), err_msg=f"window {k}")
        np.testing.assert_array_equal(fired, out["fired"][:, k].numpy(), err_msg=f"window {k}")
    assert out["fired"][:, :n_compare].any(), "no window fires: the comparison would not cover the FSM"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hop_block", [1, 3])
def test_engine_matches_its_jax_twin(variables, hop_block, dtype):
    jdt, tdt = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    probe = _engine(variables, BASE)
    hops = _hops(probe, 8, 21)
    cfg_kw = _firing_kw(_offline(variables, BASE), _clip(probe, hops), BASE)
    want = _stream(_jax_engine(variables, cfg_kw, jdt, hop_block=hop_block), hops)
    got = _stream(_engine(variables, cfg_kw, tdt, hop_block=hop_block), hops)
    assert sorted(got) == sorted(want) and len(got) == 21 - 4 + 1
    for k in want:
        np.testing.assert_allclose(got[k][0], want[k][0], atol=1e-4 if dtype == "float32" else 2e-2, err_msg=f"{k}")
        np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=f"window {k} labels")
        np.testing.assert_array_equal(got[k][2], want[k][2], err_msg=f"window {k} fire flags")
    assert any(v[2].any() for v in got.values())


# ---- the runner, the prefill, the arguments ----


@pytest.mark.parametrize("hop_block", [1, 3])
def test_chained_runner_replays_push(variables, hop_block):
    cfg_kw = dict(BASE, inference_sequence=(0,))
    eng_push, eng_run = (_engine(variables, cfg_kw, hop_block=hop_block) for _ in range(2))
    period = eng_run.schedule.period
    ring_hops, super_steps = (period + 1, 4) if hop_block == 1 else (3, 5)
    step_samples = hop_block * eng_run.hop_samples
    buf = (np.random.default_rng(9).standard_normal((2, ring_hops * step_samples)) * 0.4).astype(np.float32)
    run, chain = make_chained_runner(eng_run, ring_hops, super_steps)
    carry, last_fired = run(torch.from_numpy(buf), *chain)
    n_steps = super_steps * (period if hop_block == 1 else 1)
    for j in range(1, n_steps + 1):
        off = (j if hop_block == 1 else j - 1) % ring_hops * step_samples
        eng_push.push(buf[:, off : off + step_samples])
    fired = eng_push.last_fired if hop_block == 1 else eng_push.last_fired[:, -1]
    np.testing.assert_array_equal(last_fired.numpy(), fired)
    state = carry[4]
    for name in state._fields:
        torch.testing.assert_close(getattr(state, name), getattr(eng_push.state, name), rtol=0, atol=0)
    torch.testing.assert_close(carry[3], eng_push.s6_ring, rtol=0, atol=0)
    if hop_block == 1:
        with pytest.raises(ValueError, match="multiple of the schedule period"):
            make_chained_runner(eng_run, period * 2, 1)
    else:
        with pytest.raises(ValueError, match="ring_hops must be >= 2"):
            make_chained_runner(eng_run, 1, 1)


def test_prefill_in_blocks_equals_one_block(variables):
    preroll = (np.random.default_rng(11).standard_normal((5, 8200)) * 0.1).astype(np.float32)
    one, blocked = _engine(variables, BASE, num_streams=5), _engine(variables, BASE, num_streams=5, prefill_block=2)
    one.reset(preroll)
    blocked.reset(preroll)
    torch.testing.assert_close(blocked.mel_cache, one.mel_cache, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(blocked.s6_ring, one.s6_ring, rtol=1e-5, atol=1e-6)
    for name in one.rings:
        torch.testing.assert_close(blocked.rings[name], one.rings[name], rtol=1e-5, atol=1e-6, msg=name)
    hops = _hops(one, 12, 8, amp=0.1)
    for h in hops:
        one.push(h)
        blocked.push(h)
    torch.testing.assert_close(blocked.last_probs, one.last_probs, rtol=1e-5, atol=1e-6)


def test_shapes_and_arguments_are_checked_as_in_jax(variables, monkeypatch):
    with pytest.raises(ValueError, match="window too short"):
        _engine(variables, dict(BASE, max_window_size_ms=250.0))
    period = _engine(variables, BASE).schedule.period
    with pytest.raises(ValueError, match="multiple of the schedule period"):
        _engine(variables, BASE, hop_block=period + 1)
    with pytest.raises(ValueError, match="mel"):
        _engine(variables, BASE, hop_block=period * 4)
    eng = _engine(variables, BASE)
    with pytest.raises(ValueError, match="push expects"):
        eng.push(np.zeros((2, eng.hop_samples + 1), np.float32))
    with pytest.raises(ValueError, match="preroll"):
        eng.reset(np.zeros((3, 8200), np.float32))
    eng.reset(np.zeros(8200, np.float32))  # one preroll for every stream
    assert eng.push(np.zeros((2, eng.hop_samples), np.float32)) is False and eng._j == 1
    with pytest.raises(ValueError, match="hop_block=3"):
        _engine(variables, BASE, hop_block=3).push(np.zeros((2, eng.hop_samples), np.float32))
    with pytest.raises(ValueError, match="num_streams=2 must be divisible by the mesh's 3 devices"):
        eng.shard_streams(make_mesh(data=3, devices=["cpu"] * 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedStreamingOnlineEngine(create_model("res8", num_labels=4), res8_variables_to_state_dict(variables),
                                   EngineConfig(**BASE), FrontendConfig(n_mels=40))


def test_blocked_clock_counts_valid_hops_only(variables):
    """The hops before the lag are pushed as invalid and add no time: the
    blocked engine's clock after n hops is (n - lag + 1) strides, as the
    per-hop engine's."""
    per_hop, blocked = _engine(variables, BASE), _engine(variables, BASE, hop_block=3)
    hops = _hops(per_hop, 13, 9, amp=0.1)
    for h in hops:
        per_hop.push(h)
    for b in range(3):
        blocked.push(np.concatenate(list(hops[3 * b : 3 * b + 3]), axis=1))
    assert blocked.curr_time == per_hop.curr_time == (9 - 4 + 1) * 62.5
    for name in per_hop.state._fields:
        torch.testing.assert_close(getattr(blocked.state, name), getattr(per_hop.state, name), rtol=0, atol=1e-6)
