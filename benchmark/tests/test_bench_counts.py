"""Each count the benchmark's metrics divide by, against hand-worked values
and against the program's own arithmetic where it has one."""

import math

import torch

from benchmark import harness, port

RES8, MOBILENET = harness.load_config("res8-hey-ff"), harness.load_config("mobilenet-hey-ff")


def test_res8_count_is_the_programs_bench_count():
    from howl_tpu_torch.bench import path_flops_per_clip
    from howl_tpu_torch.inference import StreamingEngine

    c = RES8.data
    model = RES8.module.model(c)
    eng = StreamingEngine(model, model.state_dict(), port.engine_config(c), port.frontend_config(c),
                          device="cpu")
    for samples in (128_000, 4_800_000):
        n = eng.n_windows(samples)
        assert RES8.module.flops_per_recording(c, samples, n) == path_flops_per_clip(samples, eng, 4)


def test_res8_count_by_hand():
    # an audio second: 80 frames; DFT 2 x 512 x 257 and mel 257 x 40 a frame; conv0 40 x 45 x 9 a frame;
    # six convs 45 x 45 x 9 on 80 / 3 x 10 pooled positions; 16 windows x 45 x 4; 2 FLOPs a multiply-add
    hand = 2 * (80 * (2 * 512 * 257 + 257 * 40) + 80 * 40 * 45 * 9 + 80 / 3 * 10 * 45 * 45 * 9 * 6 + 16 * 45 * 4)
    assert math.isclose(RES8.module.flops_per_audio_second(RES8.data), hand)
    assert math.isclose(hand, 104.669e6, rel_tol=1e-4)
    assert math.isclose(RES8.module.flops_per_hop(RES8.data), hand / 16)


def test_mobilenet_count_is_torchs_flop_counter_on_the_programs_model():
    from torch.utils.flop_counter import FlopCounterMode

    c = MOBILENET.data
    model = MOBILENET.module.model(c).eval()
    x = torch.zeros(1, 1, 80, 61)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    assert MOBILENET.module.flops_per_window(c) == counter.get_total_flops()


def test_roofline_bounds_by_hand():
    k1 = harness.load_metric("k1_roofline.offline")
    k2 = harness.load_metric("k2_roofline.offline")
    trunk = harness.load_metric("trunk_roofline.offline")
    c = RES8.data
    # 512 x 8 s: 641 frames a clip; K1 179.5 GFLOP at 989 TFLOP/s (the bytes, 288 MB, take 0.086 ms)
    frames = 512 * 641
    assert math.isclose(k1.bound_s(c, 512, 128_000), 2 * frames * (2 * 512 * 257 + 257 * 40) / 989e12)
    assert math.isclose(k1.bound_s(c, 512, 128_000), 1.815e-4, rel_tol=1e-3)
    # K2: 10.6 GFLOP (0.011 ms) against 26.3 MB in and 98.2 MB out: bound by bytes
    k2_bytes = frames * 40 * 2 + 512 * 213 * 10 * 45 * 2
    assert math.isclose(k2.bound_s(c, 512, 128_000), k2_bytes / 3.35e12)
    # the trunk: 238.5 GOP at 1,979 TOP/s against 196 MB: bound by operations
    ops = 2 * 6 * 512 * 213 * 10 * 45 * 45 * 9
    assert math.isclose(ops, 238.5e9, rel_tol=1e-3)
    assert math.isclose(trunk.bound_s(c, 512, 128_000), ops / 1979e12)


def test_slice_busy_time_is_the_union_of_device_intervals():
    device = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0), ("d", 32.0, 35.0), ("e", 55.0, 57.0)]
    sl = harness.Slice(1.0, 2, device, [], [("cudaMemcpyAsync", 18.0, 31.0)])
    assert math.isclose(sl.busy_s(), 32e-6)
    out = harness.breakdown(sl)
    # each gap named by the runtime call in flight at its middle, or "host" where none was
    assert out["device_ops"][0] == ["b", 15e-6] and out["idle_gaps"] == [["host", 15e-6], ["cudaMemcpyAsync", 10e-6]]


def test_window_metrics_come_from_the_untraced_window():
    # the slice: 2 calls, the device busy 1 s of them; the window: 10 calls in 10 s of the host's clock
    sl = harness.Slice(1.5, 2, [("k", 0.0, 1e6)], [], [], run_calls=10, run_window_s=10.0, config=RES8,
                       traffic={"streams": 4})
    assert math.isclose(harness.idle_untraced(sl), 50.0)
    assert math.isclose(harness.load_metric("idle_share.live").read(sl), 100.0 / 3)
    hop = RES8.module.flops_per_hop(RES8.data)
    assert math.isclose(harness.load_metric("mfu.live").read(sl), 100.0 * 10 * 4 * hop / 10.0 / 989e12)
    sl.device = []  # no card: no share of its peak
    assert harness.load_metric("mfu.live").read(sl) is None and harness.idle_untraced(sl) is None


def test_the_control_is_judged_by_the_cells_limits():
    limits = {"probs_gap": 0.5, "probs_gap_mean": 0.06, "decision_mismatches": 0}
    ok = harness.control_verdict({"probs_gap": 0.4, "probs_gap_mean": 0.01, "probs_gap_worst": 0.02}, limits)
    assert ok["correct"] is True and set(ok["checks"]) == set(limits)
    bad = harness.control_verdict({"probs_gap": 0.4, "probs_gap_mean": 0.07, "probs_gap_worst": 0.02}, limits)
    assert bad["correct"] is False and bad["checks"]["probs_gap_mean"] == {"value": 0.07, "limit": 0.06}
    nan = harness.control_verdict({"probs_gap": float("nan"), "probs_gap_mean": 0.0, "probs_gap_worst": 0.0}, limits)
    assert nan["correct"] is False


def test_percentile_interpolates_between_order_statistics():
    assert math.isclose(harness.percentile(list(range(1, 101)), 95), 95.05)
    assert harness.percentile([3.0], 95) == 3.0
