"""Package-level guarantees of the port (howl_tpu_torch).

* It imports without jax, flax or howl_tpu: every module is imported in a
  fresh interpreter whose import hook refuses them.
* It never quietly runs on the CPU what was asked of a CUDA device, and its
  entry points ask for the card unless the caller names the CPU.
* The ctypes signatures the wrappers use agree with the CUDA sources' C
  entry points, and a build without nvcc raises.
"""

import json
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
    assert len(names) >= 132  # every module of every slice, training, its entry points, serving, the tools, the dataset pipeline and scale-out, was imported
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
                   "tools.bench_online_dft_precision", "tools.gen_capacity_table",
                   # the config-driven trainer and the experiment harness
                   "config", "trainer", "utils.platform", "ops.timestretch", "parallel", "parallel.seed_sweep",
                   "training.run.refactored_train", "training.run.eval_wake_word_detection", "training.run.run_exp",
                   "training.run.generate_roc", "training.run.generate_precise_roc", "inference.oracle",
                   # GSC pretraining and the dataset pipeline
                   "data.dataset.gsc_loader", "training.run.pretrain_gsc", "training.run.eval_commands_recognition",
                   "data.dataset.constants", "data.dataset.common_voice_loader", "data.dataset.hey_snips_loader",
                   "data.dataset.factory", "data.dataset.dataset_writer", "align", "align.base", "align.textgrid",
                   "align.mfa", "align.stub", "align.vad", "etl", "etl.raw_generator", "etl.aligned_generator",
                   "etl.stitcher", "etl.stitched_generator", "utils.keyword_detector",
                   "training.run.generate_raw_audio_dataset", "training.run.attach_alignment",
                   "training.run.stitch_vocab_samples",
                   # the exports, vision pretraining, the demo, profiling and scale-out
                   "ops.meyda", "utils.profiling", "training.run.pretrain", "training.run.export_honkling",
                   "training.run.generate_precise_dataset", "training.run.demo", "parallel.mesh",
                   "parallel.data_parallel",
                   # the last root tools
                   "tools.sweep_frontend_blocks", "tools.bench_frontend_variants", "tools.bench_frontend_tail_1pass",
                   "bench_train"):
        assert f"howl_tpu_torch.{module}" in names


def test_every_module_of_the_jax_package_has_its_counterpart():
    """A file at the same path for every .py file of howl_tpu, but the three
    Pallas kernels (``ops/*_cuda.py`` replace them)."""
    jax_files = {p.relative_to(REPO / "howl_tpu") for p in (REPO / "howl_tpu").rglob("*.py")}
    port_files = {p.relative_to(REPO / "howl_tpu_torch") for p in (REPO / "howl_tpu_torch").rglob("*.py")}
    assert sorted(str(p) for p in jax_files - port_files) == [
        "ops/augment_pallas.py", "ops/frontend_pallas.py", "ops/stem_pallas.py"]


# the public top-level names of howl_tpu that the port leaves out, each with its reason
_NOT_PORTED = {
    ("parallel/mesh.py", "batch_sharding"): "the port places a batch by rank (shard_batch with a DataGroup), "
                                            "not by a sharding object",
    ("parallel/mesh.py", "replicate_sharding"): "the port replicates weights by broadcast (replicate), not by a "
                                                "sharding object",
}


def _top_level(path: Path, public_defs: bool) -> set:
    """The module's public top-level defs and classes, or every top-level
    name it binds (defs, classes, assignments, imports)."""
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif public_defs:
            continue
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")} if public_defs else names


def test_every_public_function_and_class_of_the_jax_package_has_its_counterpart():
    """Every public top-level def and class of a ``howl_tpu`` module is bound
    at the top level of its port module (parsed with ``ast``), but the
    listed exceptions, each with its reason."""
    missing = set()
    for path in (REPO / "howl_tpu").rglob("*.py"):
        rel = path.relative_to(REPO / "howl_tpu")
        port = REPO / "howl_tpu_torch" / rel
        if not port.exists():  # the three Pallas files (the test above)
            continue
        missing |= {(str(rel), name) for name in _top_level(path, True) - _top_level(port, False)}
    assert sorted(missing) == sorted(_NOT_PORTED)
    assert all(reason for reason in _NOT_PORTED.values())


def test_every_root_tool_and_bench_train_has_its_counterpart():
    """A file of the same name under howl_tpu_torch/tools/ for every root
    ``tools/*.py`` but ``_path.py`` (a ``sys.path`` bootstrap that the
    package import makes unnecessary), and ``howl_tpu_torch/bench_train.py``
    for the root ``bench_train.py``."""
    root_tools = {p.name for p in (REPO / "tools").glob("*.py")} - {"_path.py"}
    port_tools = {p.name for p in (REPO / "howl_tpu_torch" / "tools").glob("*.py")}
    assert sorted(root_tools - port_tools) == []
    assert (REPO / "bench_train.py").is_file() and (REPO / "howl_tpu_torch" / "bench_train.py").is_file()
    assert (REPO / "bench.py").is_file() and (REPO / "howl_tpu_torch" / "bench.py").is_file()


@pytest.mark.parametrize("entry", ["pretrain", "export_honkling", "generate_precise_dataset", "demo"])
def test_new_entry_points_print_their_help_without_jax(entry):
    code = _NO_JAX.split("import howl_tpu_torch")[0] + (
        f"import runpy, sys\nsys.argv = ['{entry}', '--help']\n"
        f"runpy.run_module('howl_tpu_torch.training.run.{entry}', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout and ("--device" in proc.stdout) == (entry in ("pretrain", "demo"))


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
    # the seed sweep's states and the device resolver behind every entry point's --device
    from howl_tpu_torch.parallel import create_seed_states
    from howl_tpu_torch.utils.platform import ensure_platform, resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_seed_states(create_model("res8", num_labels=2), [0, 1], learning_rate=0.01)
    assert [s.step for s in create_seed_states(create_model("res8", num_labels=2), [0, 1], learning_rate=0.01,
                                               device="cpu")] == [0, 0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ensure_platform()  # SETTINGS.training.device, "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert ensure_platform("cpu") == resolve_device("cpu") == torch.device("cpu")


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
        "int n_fft", "int hop", "int center", "int n_halves", "int n_passes", "int n_mels", "int mel_n",
        "int frame_tile", "int out_bf16", "int layout_fm", "float log_offset", "float mean", "float inv_std",
        "void* stream",
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
    # both frontend kernels take the frames a block owns, the tile the host picks among the instances
    assert entries["howl_logmel_forward"][-2:] == ["int frame_tile", "void* stream"]
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


@pytest.mark.parametrize("entry", ["train", "refactored_train", "eval_wake_word_detection", "run_exp"])
def test_new_entry_points_ask_for_the_card_unless_given_the_cpu(entry, tmp_path, monkeypatch):
    """Each entry point that runs a model raises without a card, before it
    reads or writes anything, unless given ``--device cpu``; given it, it
    runs on the CPU until it finds the empty corpus."""
    import importlib

    mod = importlib.import_module(f"howl_tpu_torch.training.run.{entry}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for split in ("training", "dev", "test"):
        (tmp_path / f"aligned-metadata-{split}.jsonl").write_text("")
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"train_datasets": [{"path": str(tmp_path)}], "workspace_path": str(tmp_path / "ws"),
                                  "context_config": {"vocab": ["hey"], "sequence": [0]}}))
    args = {"train": ["--model", "res8", "--workspace", str(tmp_path / "ws"), "-i", str(tmp_path)],
            "refactored_train": ["--config", str(config)]}.get(
        entry, ["--workspace", str(tmp_path / "ws"), "-i", str(tmp_path), "--sharded-seeds"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.run(args)
    assert not (tmp_path / "ws").exists()
    with pytest.raises(SystemExit, match="no training clips"):
        mod.run(args + ["--device", "cpu"])
