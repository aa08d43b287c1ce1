"""The port's decision gate and its three ablation tools
(howl_tpu_torch/tools/) at their CPU size, against the JAX tools they port.

* ``validate_tpu_decisions``: the JAX tool's comparison rule, its thirteen
  rows (res8's eight and the five other families of the JAX tool's list,
  each on weights and a threshold ``family_setup`` picks), and exit code 0
  on the CPU, where the plain versions score every row.
* ``ablate_serving_slope``: the JAX tool's legs by their counterparts' names,
  the int8 leg included, every timed leg finite and positive.
* ``ablate_train_step``: the JAX tool's five variants.
* ``reconcile_train_f32``: both precisions through the bench, one JSON line,
  and none of the JAX tool's recorded TPU rates.
"""

import json
import math

import numpy as np
import pytest
import torch

from howl_tpu_torch.tools import _study, ablate_serving_slope, ablate_train_step, reconcile_train_f32, validate_tpu_decisions

torch.set_num_threads(1)


def _out(detected, first_fire, labels):
    return {"detected": torch.tensor(detected), "first_fire_step": torch.tensor(first_fire),
            "labels": torch.tensor(labels)}


def test_compare_online_holds_the_jax_tools_rule_for_the_live_engines():
    fired, labels = np.zeros((100, 2), bool), np.zeros((100, 2), np.int32)
    fired[5, 1] = True
    assert validate_tpu_decisions.compare_online((fired, labels), (fired.copy(), labels.copy()))["ok"]
    moved = fired.copy()
    moved[6, 1], moved[5, 1] = True, False
    assert not validate_tpu_decisions.compare_online((fired, labels), (moved, labels))["ok"]
    one_off = labels.copy()
    one_off[:2, 0] = 3  # 198 of 200 labels agree: 0.99
    assert validate_tpu_decisions.compare_online((fired, labels), (fired, one_off))["ok"]
    one_off[:3, 0] = 3  # 0.985
    assert not validate_tpu_decisions.compare_online((fired, labels), (fired, one_off))["ok"]


def test_margin_word_threshold_keeps_every_decision_off_its_edge():
    """Two loud streams whose word 1 peaks at 0.9 and 0.8, two quiet ones at
    0.45 on word 1 and a near tie (0.41 / 0.40) on word 2: word 1, the
    threshold in the widest gap between the halves' top posteriors that no
    near tie reaches."""
    probs = np.full((3, 4, 3), 0.05)
    probs[:, 0] = [0.05, 0.9, 0.05]
    probs[:, 1] = [0.1, 0.8, 0.1]
    probs[:, 2] = [0.35, 0.45, 0.2]
    probs[:, 3] = [0.19, 0.40, 0.41]
    pick = validate_tpu_decisions.margin_word_threshold(probs, 0.01)
    assert pick["word"] == 1 and 0.45 + 0.01 <= pick["threshold"] <= 0.8 - 0.01
    assert pick["distance"] == pytest.approx(min(pick["threshold"] - 0.45, 0.8 - pick["threshold"]))
    assert pick["threshold"] == pytest.approx(0.625, abs=0.002)  # the middle of the widest gap
    with pytest.raises(ValueError, match="no word"):
        validate_tpu_decisions.margin_word_threshold(probs[:, ::-1], 0.01)  # the quiet half peaks higher


def test_margin_word_threshold_without_halves_splits_the_streams_any_way():
    """The same streams with the quiet half first: no word splits the halves,
    but without halves word 1 splits the streams where the halves do, the
    threshold again in the widest gap that no near tie reaches; two streams
    that score alike split nothing."""
    probs = np.full((3, 4, 3), 0.05)
    probs[:, 0] = [0.35, 0.45, 0.2]
    probs[:, 1] = [0.19, 0.40, 0.41]
    probs[:, 2] = [0.05, 0.9, 0.05]
    probs[:, 3] = [0.1, 0.8, 0.1]
    with pytest.raises(ValueError, match="no word"):
        validate_tpu_decisions.margin_word_threshold(probs, 0.01)
    pick = validate_tpu_decisions.margin_word_threshold(probs, 0.01, halves=False)
    assert pick["word"] == 1 and pick["fires"] == 2
    assert pick["threshold"] == pytest.approx(0.625, abs=0.005)
    with pytest.raises(ValueError, match="no word"):
        validate_tpu_decisions.margin_word_threshold(probs[:, [2, 2]], 0.01, halves=False)


def test_compare_holds_the_jax_tools_rule():
    labels = [[0] * 100, [1] * 100]
    exact = _out([True, False], [3, -1], labels)
    assert validate_tpu_decisions.compare(exact, _out([True, False], [3, -1], labels))["ok"]
    assert not validate_tpu_decisions.compare(exact, _out([True, True], [3, 7], labels))["ok"]
    assert not validate_tpu_decisions.compare(exact, _out([True, False], [4, -1], labels))["ok"]
    one_off = [[0] * 99 + [2], [1] * 100]  # 199 of 200 labels agree: 0.995
    assert validate_tpu_decisions.compare(exact, _out([True, False], [3, -1], one_off))["label_agreement"] == 0.995
    assert validate_tpu_decisions.compare(exact, _out([True, False], [3, -1], one_off))["ok"]
    three_off = [[0] * 97 + [2] * 3, [1] * 100]  # 0.985
    assert not validate_tpu_decisions.compare(exact, _out([True, False], [3, -1], three_off))["ok"]


def test_decision_gate_runs_on_the_cpu_and_names_what_is_not_ported(capsys):
    """Every row runs now, the families' too: fourteen rows (lstm's live
    engine the last), all OK, none printed as not ported."""
    assert validate_tpu_decisions.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = validate_tpu_decisions.run(torch.device("cpu"), 2, 1.0)
    ran = list(rows)
    assert ran == ["res8+k1[bf16]+k2", "res8+k1[bf16x2]+k2", "res8+k1[bf16x3]+k2", "res8+k1[bf16]+k2+int8",
                   "res8 legacy[bf16]", "res8+online[bf16]", "res8+trunk[bf16]", "res8+full-window[bf16]",
                   *validate_tpu_decisions.FAMILIES, "lstm+full-window[bf16]"]
    assert all(rows[tag]["ok"] for tag in ran)
    # the live engines' rows hold the JAX tool's rule for them: fire flags equal, labels 99 %
    for tag in [*ran[5:8], ran[-1]]:
        assert set(rows[tag]) == {"fired_eq", "label_agreement", "ok"}
    for name in validate_tpu_decisions.FAMILIES:  # the families hold the offline rule
        assert set(rows[name]) == {"detected_eq", "first_fire_eq", "label_agreement", "ok"}
    assert out.count("-> OK") == 14 and "not ported" not in out and out.rstrip().endswith("ALL OK")


def test_decision_gate_exits_1_on_a_mismatch(monkeypatch, capsys):
    monkeypatch.setattr(validate_tpu_decisions, "compare", lambda exact, fast: {
        "detected_eq": False, "first_fire_eq": True, "label_agreement": 1.0, "ok": False})
    assert validate_tpu_decisions.main(["--device", "cpu"]) == 1
    assert capsys.readouterr().out.rstrip().endswith("MISMATCHES FOUND")


def test_serving_ablation_runs_its_legs_on_the_cpu():
    legs = ablate_serving_slope.main(["--device", "cpu"])
    assert list(legs) == [
        "full fused step (frontend kernel + stem kernel)",
        "full fused step (torch frontend + stem kernel)",
        ablate_serving_slope.INT8_LEG,
        "frontend: kernel K1 bf16 (time-major, bf16 out)",
        "frontend: torch gemm chain (float32)",
        "trunk alone (on precomputed features)",
        "post-frontend remainder (stem kernel + trunk + pool + head)",
        "head: frequency mean, cumsum window pooling + dense",
    ]
    for name, ms in legs.items():
        assert math.isfinite(ms) and ms > 0, name


def test_serving_ablation_chain_feeds_each_output_back_into_the_input():
    x = torch.zeros(3, 2, dtype=torch.bfloat16)
    calls = []

    def fn(t):
        calls.append(float(t[0, 0]))
        return torch.full((2,), 1e30)

    _study.bumped_chain(fn, x)(3)()  # the chain the ablation times its legs with
    assert calls == [0.0, 1.0, 2.0] and float(x[0, 0]) == 3.0 and not x.view(-1)[1:].any()


def test_train_ablation_runs_its_variants_on_the_cpu():
    rates = ablate_train_step.main(["--device", "cpu"])
    assert list(rates) == ["full step", "no wave/spec aug", "static frontend (no VTLP)",
                           "forward only (no grad/opt)", "model fwd/bwd only"]
    assert all(math.isfinite(r) and r > 0 for r in rates.values())


def test_reconcile_prints_both_precisions_and_no_tpu_numbers(capsys):
    record = reconcile_train_f32.main(["--device", "cpu", "--repeats", "1"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == record
    assert set(record) == {"train_examples_per_sec_bf16", "spread_bf16", "train_examples_per_sec_f32", "spread_f32",
                           "device"}
    assert record["device"] is None
    for name in ("bf16", "f32"):
        assert record[f"train_examples_per_sec_{name}"] > 0
        assert record[f"spread_{name}"][0] == pytest.approx(record[f"train_examples_per_sec_{name}"])
