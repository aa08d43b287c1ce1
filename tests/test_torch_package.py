"""Package-level guarantees of the port (howl_tpu_torch).

* It imports without jax, flax or howl_tpu: every module is imported in a
  fresh interpreter whose import hook refuses them.
* It never quietly runs on the CPU what was asked of a CUDA device.
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
print(len(names))
"""


def test_imports_without_jax_or_flax():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 12  # every module of the slice was imported


def test_cuda_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    model = create_model("res8", num_labels=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(model, model.state_dict(), EngineConfig(), FrontendConfig(n_mels=40), device="cuda")


def test_wrappers_refuse_devices_they_have_no_route_for():
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    with pytest.raises(ValueError, match="CPU or CUDA"):
        log_mel_spectrogram_cuda(torch.zeros((1, 4000), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        res8_stem_cuda(torch.zeros((1, 9, 40), device="meta"), torch.zeros((3, 3, 45), device="meta"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_ctypes_signatures_match_the_cuda_sources():
    sources = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu")}
    assert set(sources) == {"frontend.cu", "stem.cu"}
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
            want = {"void*": _build._P, "const void*": _build._P, "int": _build._I, "float": _build._F}[ctype]
            assert argtype is want, (name, param)
    # sm_90a, the target wgmma and setmaxnreg exist for
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
