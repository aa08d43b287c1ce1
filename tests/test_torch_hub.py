"""The port's hub (howl_tpu_torch/hub.py) against the JAX package's
(howl_tpu/hub.py), and ROADMAP F4.

* Parity. Each family's seeded weights are written as a JAX workspace, a
  port workspace and a reference (castorini/howl) one
  (``tests/torch_serving.py``). The JAX hub serves the JAX workspace and the
  port's hub the port workspace; both hubs serve the reference one (the
  JAX hub through its converter, las's input permutation included; the
  port's by loading the state dict as it is). For every engine kind (the
  ``OnlineEngine``, incremental, streaming trunk, ``hop_block`` = the
  schedule's period, ``auto``) at 2 streams of tone audio fed at the
  client's cadence: per-hop posteriors within 1e-4 (float32 on both sides:
  the JAX engines' jnp chain, the port's plain versions of its kernels) and
  every hop's fire flags equal, one stream firing and one not.
* The offline engine (``load_workspace_streaming_engine``) and
  ``training.run.import_workspace`` on the same workspaces.
* F4: every invalid flag combination raises before a file of the workspace
  is read (the JAX hub reads the weights before it refuses ``carry_hops``
  with ``streaming_trunk``), and every check that needs the model before the
  weights or ZMUV stats are read; ``test_hub_errors`` and
  ``test_hub_hop_block_passthrough`` of tests/test_client_serving.py
  mirrored; the capacity guardrail and ``auto`` as the JAX hub decides them
  on the same profiles.
"""

import json
import shutil
import warnings

import numpy as np
import pytest
import torch

from howl_tpu import hub as jax_hub
from howl_tpu.inference import capacity as jax_capacity
from howl_tpu.settings import SETTINGS as JAX_SETTINGS
from howl_tpu_torch import compat, hub
from howl_tpu_torch.inference import capacity
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.workspace import Workspace
from tests.torch_serving import HUB_FLAGS, family_setup, feed_like_client

torch.set_num_threads(1)

FLAGS = {**HUB_FLAGS, "blocked": {"streaming_trunk": True, "hop_block": 3}, "auto": {"auto": True}}
CASES = [("res8", kind) for kind in ("online", "incremental", "trunk", "blocked", "auto")] + [
    ("lstm", kind) for kind in ("online", "incremental", "auto")] + [("las", "online")]


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = family_setup(tmp_path_factory.mktemp(name), name)
        return cache[name]

    yield get
    SETTINGS.reset()


@pytest.fixture(autouse=True)
def _reset_settings():
    yield
    SETTINGS.reset()
    JAX_SETTINGS.reset()


def _tiny_profiles(module) -> dict:
    """tests/test_capacity.py's profiles with tiny ceilings, built from
    ``module``'s ``EngineProfile``: the guardrails trip at toy counts."""
    p, hop = module.EngineProfile, module.HOP_MS
    return {
        ("online", 1): p("online", "online", ((0, 0.0), (4, hop)), 4),
        ("incremental", 1): p("incremental", "inc", ((0, 0.0), (8, hop)), 8),
        ("streaming_trunk", 1): p("streaming_trunk", "trunk", ((0, 0.0), (16, hop)), 16),
        ("streaming_trunk", 3): p("streaming_trunk", "blocked", ((0, 0.0), (32, 3 * hop)), 32, hops_per_step=3),
    }


@pytest.fixture
def tiny_profiles(monkeypatch):
    """The same tiny profiles and JAX's margin in both packages."""
    monkeypatch.setattr(jax_capacity, "PROFILES", _tiny_profiles(jax_capacity))
    monkeypatch.setattr(capacity, "PROFILES", _tiny_profiles(capacity))
    monkeypatch.setattr(capacity, "VARIANCE_MARGIN", jax_capacity.VARIANCE_MARGIN)


@pytest.mark.parametrize("layout", ["native", "reference"])
@pytest.mark.parametrize("name,kind", CASES)
def test_hub_engine_matches_the_jax_hubs(families, tiny_profiles, name, kind, layout):
    fam = families(name)
    jax_ws, port_ws = (fam["jax"], fam["port"]) if layout == "native" else (fam["reference"], fam["reference"])
    jx, jctx = jax_hub.load_workspace_engine(jax_ws, num_streams=2, **FLAGS[kind])
    pt, ctx = hub.load_workspace_engine(port_ws, num_streams=2, device="cpu", **FLAGS[kind])
    assert type(pt).__name__ == type(jx).__name__
    assert getattr(pt, "hop_block", 1) == getattr(jx, "hop_block", 1)
    assert (ctx.num_labels, list(pt.cfg.inference_sequence)) == (jctx.num_labels, [fam["pick"]["word"]])
    assert pt.cfg.inference_threshold == jx.cfg.inference_threshold == pytest.approx(fam["pick"]["threshold"])
    (jp, jf), (tp, tf) = feed_like_client(jx, fam["audio"]), feed_like_client(pt, fam["audio"])
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_array_equal(tf, jf)
    assert tf.any(0).tolist().count(True) == 1, "one stream fires and one does not"


@pytest.mark.parametrize("layout", ["native", "reference"])
def test_offline_engine_matches_the_jax_hubs(families, layout):
    fam = families("res8")
    jax_ws, port_ws = (fam["jax"], fam["port"]) if layout == "native" else (fam["reference"], fam["reference"])
    jx, _ = jax_hub.load_workspace_streaming_engine(jax_ws)
    pt, _ = hub.load_workspace_streaming_engine(port_ws, device="cpu", frontend_precision="f32")
    want, got = jx.infer_batch(fam["audio"]), pt.infer_batch(fam["audio"])
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4)
    np.testing.assert_array_equal(got["detected"].numpy(), np.asarray(want["detected"]))


def test_imported_reference_workspace_serves_as_the_reference_one(families, tmp_path):
    from howl_tpu_torch.training.run import import_workspace

    fam = families("lstm")
    out = tmp_path / "imported"
    import_workspace.run(["-i", str(fam["reference"]), "-o", str(out)])
    assert {p.name for p in out.iterdir()} >= {"model-best.pt", "zmuv.json", "settings.json", "cmd-args.json"}
    assert json.loads((out / "cmd-args.json").read_text()) == {"model": "lstm"}
    # the reference's "cuda:0" is dropped: the port's default stands
    assert json.loads((out / "settings.json").read_text())["training"]["device"] == "cuda"
    ref_sd = torch.load(fam["reference"] / "model-best.pt.bin", weights_only=True)
    assert all(torch.equal(v, ref_sd[k]) for k, v in Workspace(out, delete_existing=False).load_model().items())
    (rp, rf), (ip, i_f) = (feed_like_client(hub.load_workspace_engine(ws, num_streams=2, device="cpu")[0],
                                            fam["audio"]) for ws in (fam["reference"], out))
    np.testing.assert_array_equal(ip, rp)  # the same tensors: bit for bit
    np.testing.assert_array_equal(i_f, rf)


def test_reference_settings_and_workspaces_are_read_as_jax_reads_them(families):
    from howl_tpu import compat as jax_compat

    fam = families("res8")
    data = json.loads((fam["reference"] / "settings.json").read_text())
    assert compat.reference_settings_to_dict(data) == jax_compat.reference_settings_to_dict(data)
    for ws in ("port", "jax", "reference"):
        assert compat.is_reference_workspace(fam[ws]) == jax_compat.is_reference_workspace(fam[ws]) == (
            ws == "reference")
    name, _, state_dicts, zmuv = compat.load_reference_workspace(fam["reference"])
    jname, _, jvars, jzmuv = jax_compat.load_reference_workspace(fam["reference"])
    assert name == jname == "res8" and (zmuv.mean, zmuv.std) == pytest.approx((jzmuv.mean, jzmuv.std))
    assert set(state_dicts) == set(jvars) == {True}
    back = compat.state_dict_to_variables("res8", state_dicts[True])
    np.testing.assert_array_equal(back["params"]["conv3"]["kernel"], jvars[True]["params"]["conv3"]["kernel"])
    with pytest.raises(NotImplementedError, match="mobilenet"):
        compat.reference_model_name(fam["reference"], "mobilenet")


# ---- F4 and the hub's refusals ----


BAD_FLAGS = [
    dict(auto=True, incremental=True), dict(auto=True, streaming_trunk=True), dict(auto=True, hop_block=3),
    dict(streaming_trunk=True, incremental=True), dict(hop_block=3), dict(hop_block=3, incremental=True),
    dict(carry_hops=True, streaming_trunk=True),
]


@pytest.mark.parametrize("flags", BAD_FLAGS, ids=lambda f: "+".join(sorted(f)))
def test_flag_combinations_raise_before_any_file_is_read(tmp_path, flags):
    """On a path that does not exist: the refusal, not FileNotFoundError."""
    with pytest.raises(ValueError):
        hub.load_workspace_engine(tmp_path / "missing", "res8", device="cpu", **flags)
    assert not (tmp_path / "missing").exists()


def test_the_jax_hub_reads_the_workspace_before_refusing_carry_hops_with_the_trunk(tmp_path):
    """F4 as it stands in the JAX package (howl_tpu/hub.py:185): the same
    call reaches the workspace first."""
    with pytest.raises(FileNotFoundError):
        jax_hub.load_workspace_engine(tmp_path / "missing", "res8", carry_hops=True, streaming_trunk=True)


@pytest.fixture
def unreadable_weights(monkeypatch):
    """Any read of weights or ZMUV stats fails the test."""
    def refuse(*_a, **_k):
        raise AssertionError("the hub read the weights or the ZMUV stats before refusing")

    monkeypatch.setattr(Workspace, "load_model", refuse)
    monkeypatch.setattr(Workspace, "load_zmuv", refuse)
    monkeypatch.setattr(compat, "_torch_load", refuse)


MODEL_REFUSALS = [
    ("res8", dict(carry_hops=True), ValueError, "recurrent"),
    ("lstm", dict(streaming_trunk=True), ValueError, "trunk"),
    ("res8", dict(streaming_trunk=True, hop_block=2), ValueError, "period"),
    ("las", dict(incremental=True), ValueError, "delta"),
    ("res8", dict(incremental=True, num_streams=12, strict_capacity=True), capacity.CapacityError, "cannot sustain"),
    ("res8", dict(auto=True, num_streams=1000), capacity.CapacityError, "shard"),
    ("lstm", dict(auto=True, num_streams=12), capacity.CapacityError, "no single-card"),
]


@pytest.mark.parametrize("layout", ["port", "reference"])
@pytest.mark.parametrize("name,flags,error,match", MODEL_REFUSALS)
def test_model_checks_raise_before_the_weights_are_read(families, tiny_profiles, unreadable_weights, layout, name,
                                                        flags, error, match):
    with pytest.raises(error, match=match):
        hub.load_workspace_engine(families(name)[layout], device="cpu", **flags)


def test_the_card_is_asked_for_before_anything_is_read(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hub.load_workspace_engine(tmp_path / "missing", "res8")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hub.load_workspace_streaming_engine(tmp_path / "missing", "res8")


def test_hub_errors(tmp_path, monkeypatch):
    monkeypatch.delenv("HOWL_MODELS_PATH", raising=False)
    with pytest.raises(ValueError):
        hub.load_pretrained("not_a_model")
    with pytest.raises(ValueError):
        hub.load_pretrained("hey_fire_fox", models_path=None)
    with pytest.raises(FileNotFoundError):
        hub.load_workspace_engine(tmp_path / "empty_ws", "res8", device="cpu")
    (tmp_path / "no_zmuv").mkdir()
    (tmp_path / "no_zmuv" / "settings.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="zmuv"):
        hub.load_workspace_engine(tmp_path / "no_zmuv", "res8", device="cpu")


def test_load_pretrained_resolves_against_the_models_path(families, tmp_path, monkeypatch):
    shutil.copytree(families("res8")["port"], tmp_path / "howl" / "hey-fire-fox")
    monkeypatch.setenv("HOWL_MODELS_PATH", str(tmp_path))
    engine, ctx = hub.hey_fire_fox(device="cpu", incremental=True)
    assert type(engine).__name__ == "IncrementalOnlineEngine" and ctx.num_labels == 4


def test_hub_hop_block_passthrough(families):
    ws = families("res8")["port"]
    engine, _ = hub.load_workspace_engine(ws, streaming_trunk=True, device="cpu")
    period = engine.schedule.period
    blocked, _ = hub.load_workspace_engine(ws, streaming_trunk=True, hop_block=period, device="cpu")
    assert blocked.hop_block == period
    with pytest.raises(ValueError, match="streaming_trunk"):
        hub.load_workspace_engine(ws, hop_block=period, device="cpu")
    from howl_tpu_torch.client import HowlClient

    with pytest.raises(ValueError, match="hop-blocked"):
        HowlClient(engine=blocked)


def test_capacity_guardrail_warns_as_jax(families, tiny_profiles):
    fam = families("res8")
    for load, ws, kw, warning in ((jax_hub.load_workspace_engine, fam["jax"], {}, jax_capacity.CapacityWarning),
                                  (hub.load_workspace_engine, fam["port"], {"device": "cpu"}, capacity.CapacityWarning)):
        with pytest.warns(warning, match="cannot sustain"):
            load(ws, num_streams=12, incremental=True, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            load(ws, num_streams=4, incremental=True, **kw)


@pytest.mark.parametrize("n", [4, 12, 20])
def test_auto_picks_the_jax_hubs_engine(families, tiny_profiles, n):
    fam = families("res8")
    jx, _ = jax_hub.load_workspace_engine(fam["jax"], num_streams=n, auto=True)
    pt, _ = hub.load_workspace_engine(fam["port"], num_streams=n, auto=True, device="cpu")
    assert (type(pt).__name__, getattr(pt, "hop_block", 1)) == (type(jx).__name__, getattr(jx, "hop_block", 1))
