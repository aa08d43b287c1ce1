"""What the benchmark takes from the program under test, ``howl_tpu_torch``,
that every configuration shares: the engine's and the frontend's settings,
the shapes of a model's weights, the kernel library's build and the launch
counters of its kernels. Each configuration builds its own model
(``configs/<name>.py``'s ``model``). Imported
only inside a run, so that a checkout without the program fails there.
"""

from __future__ import annotations

import time


def build_library(device) -> float:
    """Build (first run in a checkout) or load the program's CUDA kernels;
    the seconds it took. Nothing on the CPU."""
    if device.type != "cuda":
        return 0.0
    from howl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.kernel_library()
    return time.perf_counter() - t0


def engine_config(cfg: dict):
    from howl_tpu_torch.inference import EngineConfig

    e, a = cfg["engine"], cfg["audio"]
    return EngineConfig(
        inference_sequence=tuple(e["inference_sequence"]), inference_window_ms=e["inference_window_ms"],
        smoothing_window_ms=e["smoothing_window_ms"], tolerance_window_ms=e["tolerance_window_ms"],
        inference_threshold=e["inference_threshold"], inference_weights=None,
        max_window_size_ms=e["max_window_size_ms"], eval_stride_size_ms=e["eval_stride_size_ms"],
        sample_rate=a["sample_rate"], negative_label=e["negative_label"], num_labels=cfg["num_labels"],
    )


def frontend_config(cfg: dict):
    from howl_tpu_torch.ops.frontend import FrontendConfig

    a = cfg["audio"]
    return FrontendConfig(sample_rate=a["sample_rate"], n_fft=a["n_fft"], hop_length=a["hop_length"],
                          n_mels=a["n_mels"], f_min=a["f_min"], f_max=a["f_max"], center=True,
                          log_offset=a["log_offset"])


def state_shapes(model) -> dict:
    """{name: (shape, dtype)} of ``model``'s state dict (a configuration's
    ``model(cfg)`` builds it)."""
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


def compute_dtype(cfg: dict):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": None}[cfg["precision"]["compute_dtype"]]


def counters() -> dict:
    """The program's launch counters by kernel: {name: (function, has a tc count)}."""
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.int8_trunk import int8_conv_layer_cuda, int8_trunk_fused_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    return {"K1": (log_mel_spectrogram_cuda, True), "K2": (res8_stem_cuda, True),
            "int8_fused": (int8_trunk_fused_cuda, False), "int8_layer": (int8_conv_layer_cuda, False)}


def count_launches(fn) -> tuple:
    """(``fn()``, {kernel: launches, kernel_tc: launches on the tensor-core route}) around one call."""
    import torch

    table = counters()
    for f, tc in table.values():
        f.launches = 0
        if tc:
            f.launches_tc = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    counts = {}
    for name, (f, tc) in table.items():
        counts[name] = f.launches
        if tc:
            counts[f"{name}_tc"] = f.launches_tc
    return out, counts
