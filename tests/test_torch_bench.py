"""The port's bench (howl_tpu_torch/bench.py) against the JAX package's
``bench.py``, its oracle for what is counted and printed.

* The analytic FLOP counts equal ``bench.py``'s functions called on the
  port's own engine and frontend.
* ``python -m howl_tpu_torch.bench --device cpu`` prints one JSON line whose
  keys are exactly those of ``bench.py``'s ``json.dumps`` (parsed from its
  source) plus ``spread``, ``rungs`` and ``device``; ``mfu`` and
  ``train_mfu`` 0.0 off the card as in ``bench.py``, every other measured
  key finite and positive, the seven online keys included (their latencies
  by stream count, as ``bench.py`` gives them).
* Without ``--device cpu`` and without a card it raises and names the flag;
  a card with no bf16 peak on record gives ``mfu: null``.
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jax_bench
from howl_tpu_torch import bench
from howl_tpu_torch.compat import res8_variables_to_state_dict
from howl_tpu_torch.ops.frontend import FrontendConfig

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
MEASURED = ("value", "mfu", "legacy_realtime_factor", "train_examples_per_sec", "train_mfu",
            "train_noise_examples_per_sec", "train_examples_per_sec_f32")


def _bench_py_keys() -> set:
    """The keys of the dict ``bench.py``'s ``main`` passes to ``json.dumps``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps":
            (arg,) = node.args
            return {key.value for key in arg.keys}
    raise AssertionError("bench.py has no json.dumps call")


@pytest.fixture(scope="module")
def cpu_record():
    # one thread, as this file's own torch: the live engines' hops are thousands of tiny ops, and a process
    # that spreads them over every core beside the other test workers can slow a hop past 0.5 s, which the
    # stream rates' int() (as bench.py gives them) would print as 0
    proc = subprocess.run(
        [sys.executable, "-m", "howl_tpu_torch.bench", "--device", "cpu", "--repeats", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


@pytest.mark.parametrize("clip_seconds", [0.5, 2.0, 8.0])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-window"])
def test_path_flops_equal_bench_py_on_the_ports_engine(clip_seconds, fused):
    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(0), 4))
    engine = bench.serving_engines("cpu", state)[0 if fused else 1]
    clip_samples = int(clip_seconds * bench.SAMPLE_RATE)
    got = bench.path_flops_per_clip(clip_samples, engine, 4)
    assert got == jax_bench.path_flops_per_clip(clip_samples, engine, 4)
    if clip_seconds == 8.0:
        assert got == 837_203_296  # frontend 0.351 + conv0 0.021 + trunk 0.466 GFLOP + the head


@pytest.mark.parametrize("window,n_mels", [(8000, 40), (16000, 40), (8000, 80)])
def test_train_flops_equal_bench_py(window, n_mels):
    frontend = FrontendConfig(n_mels=n_mels)
    assert bench.train_flops_per_example(window, frontend) == jax_bench.train_flops_per_example(window, frontend)


def test_cpu_run_prints_bench_py_keys_and_three_of_its_own(cpu_record):
    assert set(cpu_record) == _bench_py_keys() | {"spread", "rungs", "device"}
    assert cpu_record["metric"] == "mel_res8_streaming_realtime_factor"
    assert cpu_record["unit"] == "x_realtime_per_cpu_chip" and cpu_record["device"] is None


def test_cpu_run_has_null_online_keys_and_finite_positive_rates(cpu_record):
    """(The name is the test's earlier claim: since the online engines are
    ported, the seven online keys are measured too.) Every key finite and
    positive at the CPU sizes, with its spread."""
    for key in bench.ONLINE_KEYS:
        value, spread = cpu_record[key], cpu_record["spread"][key]
        if key.startswith("online_streams"):
            assert isinstance(value, int) and value > 0 and 0 < spread[0] <= spread[1], key
            continue
        assert list(value) == ["8"] and list(spread) == ["8"], key  # bench.py's CPU stream count
        lat = value["8"]
        assert math.isfinite(lat["p50"]) and 0 < lat["p50"] <= lat["p99"], key
        assert 0 < spread["8"][0] <= spread["8"][1], key
        assert lat.get("hop_block") == (3 if key.endswith("_blocked") else None), key
    for key in MEASURED:
        value, spread = cpu_record[key], cpu_record["spread"][key]
        assert math.isfinite(value) and len(spread) == 2 and spread[0] <= spread[1], key
        if key in ("mfu", "train_mfu"):
            assert value == 0.0 and spread == [0.0, 0.0], key  # bench.py's 0.0 off the accelerator
        else:
            assert value > 0 and spread[0] > 0, key
    assert cpu_record["vs_baseline"] == pytest.approx(cpu_record["value"] / 1000, abs=1e-3)
    assert set(cpu_record["spread"]) == set(MEASURED) | set(bench.ONLINE_KEYS)


def test_cpu_run_names_its_rungs(cpu_record):
    rungs = cpu_record["rungs"]
    assert rungs["headline"]["scorer"] == "fused trunk" and rungs["legacy"]["scorer"] == "per-window mega-batch"
    for scorer, layout in (("headline", "tm"), ("legacy", "fm")):
        assert rungs[scorer]["compute_dtype"] == "bfloat16"
        assert rungs[scorer]["frontend"] == {"kernel": "K1", "route": "plain", "grade": "bf16", "layout": layout,
                                             "launches_per_batch": 0}
        assert rungs[scorer]["stem"] == {"kernel": "K2", "route": "plain", "launches_per_batch": 0}
    # the headline's trunk, as bench.HEADLINE_TRUNK names it, and both trunks' batch times from the same run
    int8 = rungs["int8"]
    assert int8["value_trunk"] == bench.HEADLINE_TRUNK and int8["calibration_clips"] == bench.CPU.batch
    assert set(int8["batch_ms"]) == set(bench.TRUNKS) and all(ms > 0 for ms in int8["batch_ms"].values())
    # the int8 trunk's route and both int8 kernels' counters: the plain version off the card counts nothing
    launches = {"int8_fused": 0, "int8_layer": 0}
    assert int8["route"] == "plain" and int8["launches_per_batch"] == launches
    want = ({"kernel": "int8 trunk", "route": "plain", "launches_per_batch": launches}
            if bench.HEADLINE_TRUNK == "int8" else "F.conv2d")
    assert rungs["headline"]["residual_convs"] == want and rungs["legacy"]["residual_convs"] == "F.conv2d"
    online = rungs["online"]
    assert online["full_window"]["frontend"] == {"kernel": "K1", "route": "plain", "launches_per_step": 0,
                                                 "grade": "bf16", "layout": "fm"}
    for kind in ("full_window", "incremental"):
        assert online[kind]["stem"] == {"kernel": "K2", "route": "plain", "launches_per_step": 0}
    assert online["trunk"]["hop_block"] == {"per-hop": 1, "blocked": 3}
    assert rungs["train"]["noise_bank_mix"]["route"] == "plain"


def test_bench_refuses_to_run_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main([])


def test_peak_is_known_for_the_h100_sxm_only():
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "NVIDIA GeForce RTX 4090"):
        assert bench.peak_bf16_flops(name) is None


def test_unknown_card_gives_null_utilizations():
    serve = {"batch_ms": [20.0, 18.0, 22.0], "legacy_batch_ms": [50.0, 60.0, 55.0], "rungs": {},
             "audio_seconds": 4096.0, "flops_per_batch": 428.6e9}
    train = {key: [11.0, 12.0, 10.0] for key in
             ("train_examples_per_sec", "train_noise_examples_per_sec", "train_examples_per_sec_f32")}
    unknown = bench.make_record(serve, train, bench.CARD, True, None, 1.0, "a card, 700.00 W")
    assert unknown["mfu"] is None and unknown["train_mfu"] is None
    assert unknown["spread"]["mfu"] is None and unknown["spread"]["train_mfu"] is None
    assert unknown["value"] == round(4096.0 / 0.020, 1) and unknown["spread"]["value"] == [4096.0 / 0.022, 4096.0 / 0.018]
    known = bench.make_record(serve, train, bench.CARD, True, 989e12, 1.0, "a card, 700.00 W")
    assert known["mfu"] == round(428.6e9 / 0.020 / 989e12, 4) and known["unit"] == "x_realtime_per_gpu_chip"
    assert known["train_examples_per_sec"] == round(1024 / 0.011, 1)
    assert known["train_mfu"] == round(bench.train_flops_per_example(8000, FrontendConfig(n_mels=40)) * 1024 / 0.011
                                       / 989e12, 4)
