"""The live-engine tools of the port (howl_tpu_torch/tools/:
``bench_stream_mux``, ``_trunk_setup``, ``bench_streaming_trunk``,
``bench_trunk_blocked``, ``ablate_trunk_step``,
``bench_online_dft_precision``, ``gen_capacity_table``).

* Each runs with ``--device cpu`` at its CPU size and returns finite,
  positive times; without a card each refuses its default ``--device
  cuda`` (F7's rule).
* The chains the tools time are the engines' own hops: after the trunk
  runner (per hop and hop-blocked) and the bench's incremental chain
  (``bench.hop_chain``), the last fire flags and the smoothing ring equal
  those of the same engine fed the same chunks by ``push`` (the JAX tools
  expose no function to call, so the engine stepped hop by hop is the
  reference).
* The live chain's three-pass grade "bf16x3", which
  ``bench_online_dft_precision`` times against "bf16", is the frontend
  kernel's plain "bf16x3" (``inference.online.chain_log_mels``; the plain
  log-mel chain has no such grade) and sits nearer the float32 chain than
  the one-pass grade does; its "f32" and "bf16" grades are the plain
  chain's.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from howl_tpu_torch.tools import (
    _trunk_setup,
    ablate_trunk_step,
    bench_online_dft_precision,
    bench_stream_mux,
    bench_streaming_trunk,
    bench_trunk_blocked,
    gen_capacity_table,
)

torch.set_num_threads(1)


def _finite_positive(*values) -> bool:
    return all(math.isfinite(v) and v > 0 for v in values)


def test_bench_stream_mux_on_the_cpu():
    out = bench_stream_mux.main(["--device", "cpu", "32", "400"])
    assert out["streams"] == 32 and out["hop"] == 400 and out["native"]
    assert _finite_positive(out["push_ms"], out["gather_ms"], out["headroom"])


def test_bench_streaming_trunk_on_the_cpu():
    out = bench_streaming_trunk.main(["--device", "cpu", "4", "6"])
    assert out["steps"] == 6 and _finite_positive(out["trunk_ms"], out["incremental_ms"], out["speedup"])
    assert out["trunk_streams"] == pytest.approx(4 * 6 / (out["trunk_ms"] / 1e3) / 16)


def test_bench_trunk_blocked_on_the_cpu():
    out = bench_trunk_blocked.main(["--device", "cpu", "4", "2"])
    assert out["period"] == 3 and set(out["blocked"]) == {3, 6}
    assert _finite_positive(out["per_hop"], *out["blocked"].values())


def test_ablate_trunk_step_on_the_cpu():
    out = ablate_trunk_step.main(["--device", "cpu", "4", "2"])
    assert out["steps"] == 6 and _finite_positive(*(out[leg] for leg in ablate_trunk_step.LEGS))
    assert out["sum of parts"] == pytest.approx(sum(out[leg] for leg in ablate_trunk_step.LEGS[1:]))


def test_bench_online_dft_precision_on_the_cpu():
    out = bench_online_dft_precision.main(["--device", "cpu", "--counts", "4"])
    assert set(out) == {(e, 4, g) for e in ("incremental", "trunk") for g in ("bf16x3", "bf16")}
    assert all(_finite_positive(r["p50"], r["p99"]) and r["p99"] >= r["p50"] for r in out.values())


def test_gen_capacity_table_calibrates_on_the_cpu(capsys):
    out = gen_capacity_table.main(["--device", "cpu", "--calibrate", "2,4", "--steps", "3"])
    assert set(out) == {f"{k} {h}" for k, h in gen_capacity_table.ENGINES}
    for rec in out.values():
        assert [n for n, _ in rec["points"]] == [2, 4] and _finite_positive(*(ms for _, ms in rec["points"]))
        assert rec["ceiling"] > 0
    assert out["streaming_trunk 3"]["extra_latency_hops"] == out["streaming_trunk 1"]["extra_latency_hops"] + 2 == 6
    assert '"calibration"' in capsys.readouterr().out
    gen_capacity_table.main([])  # the table alone needs no device


@pytest.mark.parametrize("tool,argv", [
    (bench_stream_mux, []), (bench_streaming_trunk, []), (bench_trunk_blocked, []), (ablate_trunk_step, []),
    (bench_online_dft_precision, []), (gen_capacity_table, ["--calibrate", "2"]),
])
def test_tools_refuse_to_run_without_a_card(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(argv)


def _setup(streams: int = 4):
    return _trunk_setup.trunk_bench_setup("cpu", streams, 2, 0, 0)


@pytest.mark.parametrize("hop_block", [1, 3])
def test_the_trunk_runner_chain_is_the_engine_pushed_hop_by_hop(hop_block):
    from howl_tpu_torch.inference.streaming_trunk import make_chained_runner

    s = _setup()
    chained, pushed = (_trunk_setup.engine(s, "trunk", hop_block=hop_block) for _ in range(2))
    period, hop = chained.schedule.period, chained.hop_samples
    ring_hops, steps = (period + 1, 3) if hop_block == 1 else (2, 4)
    width = hop * hop_block
    buf = _trunk_setup.noise(s, ring_hops * width)
    run, carry = make_chained_runner(chained, ring_hops, steps)
    carry, fired = run(buf, *carry)
    if hop_block == 1:
        offsets = [(j % ring_hops) * hop for j in range(1, steps * period + 1)]
    else:
        offsets = [(m % ring_hops) * width for m in range(steps)]
    for off in offsets:
        pushed.push(buf[:, off : off + width])
    want = pushed.last_fired if hop_block == 1 else pushed.last_fired[:, -1]
    np.testing.assert_array_equal(fired.numpy(), want)
    torch.testing.assert_close(carry[-1].pred_ring, pushed.state.pred_ring, rtol=0, atol=0)


def test_the_incremental_chain_is_the_engine_pushed_hop_by_hop():
    from howl_tpu_torch.bench import hop_chain

    s = _setup()
    chained, pushed = (_trunk_setup.engine(s, "incremental") for _ in range(2))
    hop, ring_hops, steps = chained.hop_samples, 4, 7
    buf = _trunk_setup.noise(s, ring_hops * hop)
    hop_chain(chained, buf, steps, ring_hops)()
    for k in range(steps):
        pushed.push(buf[:, (k % ring_hops) * hop : (k % ring_hops + 1) * hop])
    torch.testing.assert_close(chained.state.pred_ring, pushed.state.pred_ring, rtol=0, atol=0)
    torch.testing.assert_close(chained.state.fired, pushed.state.fired, rtol=0, atol=0)
    torch.testing.assert_close(chained.mel_ring, pushed.mel_ring, rtol=0, atol=0)


@pytest.mark.parametrize("center", [True, False])
def test_the_chains_three_pass_grade(center):
    from howl_tpu_torch.inference.online import chain_log_mels
    from howl_tpu_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_plain

    cfg = FrontendConfig(n_mels=40, center=center)
    audio = torch.from_numpy((np.random.default_rng(3).standard_normal((3, 4800)) * 0.1).astype(np.float32))
    x3 = chain_log_mels(audio, cfg, "bf16x3")
    exact = log_mel_spectrogram(audio, cfg)
    one = log_mel_spectrogram(audio, cfg, precision="bf16")
    kernel_plain = log_mel_spectrogram_plain(audio, cfg, precision="bf16x3", layout="fm")
    torch.testing.assert_close(x3, kernel_plain, rtol=0, atol=0)
    torch.testing.assert_close(chain_log_mels(audio, cfg, "f32"), exact, rtol=0, atol=0)
    torch.testing.assert_close(chain_log_mels(audio, cfg, "bf16"), one, rtol=0, atol=0)
    assert float((x3 - exact).abs().max()) < 1e-3 < float((one - exact).abs().max())
    with pytest.raises(ValueError, match="bf16x3"):
        log_mel_spectrogram(audio, cfg, precision="bf16x3")
