"""Package-level guarantees of the port (howl_tpu_torch).

* It imports without jax, flax or howl_tpu: every module is imported in a
  fresh interpreter whose import hook refuses them.
* It never quietly runs on the CPU what was asked of a CUDA device, and its
  entry points ask for the card unless the caller names the CPU.
* The ctypes signatures the wrappers use agree with the CUDA sources' C
  entry points, and a build without nvcc raises.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from howl_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent

_NO_JAX = r"""
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "howl_tpu"):
            raise ImportError(f"{name} is refused in this process")
        return None

sys.meta_path.insert(0, Refuse())
import howl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(howl_tpu_torch.__path__, "howl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "howl_tpu"))
assert not bad, bad
print(" ".join(names))
"""


def test_imports_without_jax_or_flax():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 89  # every module of every slice, training, its entry points, serving and the tools, was imported
    for module in ("inference.engine", "training.step", "tools.bench_pallas_micro", "tools.bench_hbm_sweep",
                   "tools.hbm_sweep_kernels", "tools._study", "bench", "tools.validate_tpu_decisions",
                   "tools.ablate_serving_slope", "tools.ablate_train_step", "tools.reconcile_train_f32",
                   "inference.online", "inference.streaming_trunk", "inference.detect",
                   "training.run.train", "workspace", "settings", "context", "models.metric", "data.noise_bank",
                   "data.transform.batchifier", "data.dataset.dataset", "data.dataset.dataset_loader",
                   "data.common.labeler", "data.common.searcher", "utils.audio_utils", "utils.tb_events",
                   "utils.parallel", "utils.hash_utils", "utils.logger", "utils.args_utils",
                   # the live serving surface and its tools
                   "hub", "client", "client.howl_client", "client.stream_server", "native", "inference.capacity",
                   "training.run.import_workspace", "tools.bench_stream_mux", "tools._trunk_setup",
                   "tools.bench_streaming_trunk", "tools.bench_trunk_blocked", "tools.ablate_trunk_step",
                   "tools.bench_online_dft_precision", "tools.gen_capacity_table"):
        assert f"howl_tpu_torch.{module}" in names


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    imports = re.findall(r"^\s*(?:import|from)\s+([\w.]+)", (REPO / "chip_smoke.py").read_text(), flags=re.M)
    assert "howl_tpu_torch.tools" in imports  # the pattern finds the function-level imports too
    roots = {name.split(".")[0] for name in imports}
    assert not roots & {"jax", "jaxlib", "flax", "howl_tpu", "tools"}


def test_cuda_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    model = create_model("res8", num_labels=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(model, model.state_dict(), EngineConfig(), FrontendConfig(n_mels=40), device="cuda")


def test_entry_points_ask_for_the_card_unless_given_the_cpu(monkeypatch):
    """``StreamingEngine`` and ``create_train_state`` default to the card:
    without one they raise and pick no CPU by themselves; ``device="cpu"``
    runs them here."""
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.training.state import create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = create_model("res8", num_labels=2)
    engine_args = (model, model.state_dict(), EngineConfig(num_labels=2), FrontendConfig(n_mels=40))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(*engine_args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(create_model("res8", num_labels=2), 0.01, generator=torch.Generator().manual_seed(0))
    engine = StreamingEngine(*engine_args, device="cpu")
    assert engine.device.type == "cpu" and next(engine.model.parameters()).device.type == "cpu"
    assert tuple(engine.score_batch(torch.zeros((1, 16000)))["probs"].shape[::2]) == (1, 2)
    state = create_train_state(
        create_model("res8", num_labels=2), 0.01, generator=torch.Generator().manual_seed(0), device="cpu"
    )
    assert next(state.model.parameters()).device.type == "cpu" and state.step == 0


def test_wrappers_refuse_devices_they_have_no_route_for():
    from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    with pytest.raises(ValueError, match="CPU or CUDA"):
        log_mel_spectrogram_cuda(torch.zeros((1, 4000), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        res8_stem_cuda(torch.zeros((1, 9, 40), device="meta"), torch.zeros((3, 3, 45), device="meta"))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mix_noise_bank_cuda(
            torch.zeros((2, 100), **meta), torch.zeros((3, 300), **meta), torch.zeros(2, dtype=torch.long, **meta),
            torch.zeros(2, dtype=torch.long, **meta), torch.zeros(2, **meta),
        )


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_ctypes_signatures_match_the_cuda_sources():
    sources = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu")}
    assert set(sources) == {"frontend.cu", "frontend_tc.cu", "stem.cu", "stem_tc.cu", "augment.cu", "trunk_proto.cu", "stem_fold.cu",
                            "micro_stream.cu", "micro_gemm.cu", "micro_poly.cu", "hbm_auto_read.cu",
                            "hbm_auto_copy.cu", "hbm2hbm.cu", "hbm_manual_read.cu", "hbm_manual_write.cu",
                            "hbm_manual_copy.cu", "int8_trunk.cu", "int8_trunk_fused.cu"}
    entries = {}
    for text in sources.values():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            entries[name] = [p.strip() for p in params.split(",")]
    assert set(entries) == set(_build.SIGNATURES)
    for name, params in entries.items():
        argtypes = _build.SIGNATURES[name]
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            ctype = param.rsplit(" ", 1)[0]
            want = {"void*": _build._P, "const void*": _build._P, "const void* const*": _build._P,
                    "const float*": _build._P, "int": _build._I, "long long": _build._L, "float": _build._F}[ctype]
            assert argtype is want, (name, param)
    # the tensor-core frontend takes the packed images and their shape in place of W, fb and the rounding flags
    assert entries["howl_logmel_tc_forward"] == [
        "const void* audio", "const void* w_img", "const void* fb_img", "void* out", "int B", "int S", "int n_frames",
        "int n_fft", "int hop", "int center", "int n_halves", "int n_passes", "int n_mels", "int mel_n", "int out_bf16",
        "int layout_fm", "float log_offset", "float mean", "float inv_std", "void* stream",
    ]
    # the tensor-core stem takes the packed tap image and has one pool
    assert entries["howl_res8_stem_tc_forward"] == [
        "const void* mel", "const void* img", "void* out", "int B", "int T", "int n_mels", "int ch", "void* stream",
    ]
    # audio, bank, rows, offs, alpha, out, B, n, n_rows, w_cols, stream
    assert entries["howl_mix_noise_bank_forward"] == [
        "const void* audio", "const void* bank", "const void* rows", "const void* offs", "const void* alpha",
        "void* out", "int B", "int n", "int n_rows", "int w_cols", "void* stream",
    ]
    # the int8 layer: null pointers for the optional BN, residual and pre-BN store; the scale and its inverse
    assert entries["howl_int8_conv_forward"] == [
        "const void* x", "const void* w_img", "const void* w_scale", "const void* bn_scale", "const void* bn_shift",
        "const void* res", "void* out", "void* pre", "int B", "int T_len", "int F", "int C", "int tt", "float inv_s",
        "float s_a", "int is_bf16", "void* stream",
    ]
    # the fused int8 trunk: host arrays of the six layers' device pointers and scales, one launch a trunk
    assert entries["howl_int8_trunk_fused_forward"] == [
        "const void* y", "const void* const* w_img", "const void* const* w_scale", "const void* const* bn_scale",
        "const void* const* bn_shift", "const float* s_a", "const float* inv_s", "void* out", "int B", "int T_len",
        "int F", "int C", "int is_bf16", "void* stream",
    ]
    # the FMA frontend takes the three-pass grade's lo parts after W and fb (null for the other grades)
    assert entries["howl_logmel_forward"][:6] == [
        "const void* audio", "const void* w", "const void* fb", "const void* w_lo", "const void* fb_lo", "void* out"]
    # the sweep's three block legs share one signature; the whole-array copy counts its bytes in 64 bits
    assert entries["howl_hbm_auto_read_forward"] == entries["howl_hbm_auto_copy_forward"] == [
        "const void* x", "void* out", "int rows", "int bn", "int is_bf16", "float s", "void* stream",
    ]
    assert entries["howl_hbm_stream_repro_forward"] == entries["howl_hbm_auto_read_forward"]
    assert entries["howl_hbm2hbm_forward"] == [
        "const void* x", "void* out", "void* done", "long long n_bytes", "float s", "void* stream",
    ]
    # the manual legs take the ring depth k at run time, after the chunk height
    ring = ["int rows", "int cb", "int k", "int is_bf16", "float s", "void* stream"]
    assert entries["howl_hbm_manual_read_forward"] == ["const void* x", "void* corners", "void* out", *ring]
    assert entries["howl_hbm_manual_write_forward"] == ["void* out", "void* done", *ring]
    assert entries["howl_hbm_manual_copy_forward"] == ["const void* x", "void* out", "void* done", *ring]
    for leg in ("read", "write", "copy"):
        assert entries[f"howl_hbm_manual_{leg}_ctas_per_sm"] == ["int k", "int is_bf16"]
    # sm_90a, the target wgmma and setmaxnreg exist for
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_ring_constants_of_the_wrappers_are_the_cuda_headers():
    """The manual legs' wrappers print bytes in flight and refuse ring depths
    from their own copies of the ring's constants: they must be the numbers
    the kernels are compiled with."""
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    header = (_build.CSRC / "hbm_common.cuh").read_text()
    constants = {name: int(value) for name, value in re.findall(r"^constexpr int (k\w+) = (\d+);", header, flags=re.M)}
    assert constants["kRingStageBytes"] == hk.STAGE_BYTES
    assert (constants["kMinRingSlots"], constants["kMaxRingSlots"]) == (hk.MIN_K, hk.MAX_K)
    assert (constants["kCols"], constants["kCornerRows"], constants["kCornerCols"]) == (
        hk.COLS, hk.CORNER_ROWS, hk.OUT_COLS)
