"""The port's last root tools: the three frontend tools
(howl_tpu_torch/tools/sweep_frontend_blocks.py, bench_frontend_variants.py,
bench_frontend_tail_1pass.py) and howl_tpu_torch/bench_train.py, on the CPU.

Each runs every leg under ``--device cpu`` at the JAX tools' CPU size; its
leg names, grades and tiles are held against the JAX tool's source, parsed
here (no JAX tool runs); the library chains' HIGHEST output is held against
JAX's HIGHEST chain on the same numpy audio; the tools leave TF32 off.
``bench_train``'s metric names and keys are the root script's, parsed from
its source as tests/test_torch_bench.py parses ``bench.py``.
"""

import ast
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.ops import frontend as jfe
from howl_tpu_torch import bench_train
from howl_tpu_torch.ops import frontend as tfe
from howl_tpu_torch.ops import frontend_cuda as fc
from howl_tpu_torch.tools import bench_frontend_tail_1pass as tail_tool
from howl_tpu_torch.tools import bench_frontend_variants as variants_tool
from howl_tpu_torch.tools import sweep_frontend_blocks as sweep_tool

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TOOLS = {"sweep_frontend_blocks": sweep_tool, "bench_frontend_variants": variants_tool,
         "bench_frontend_tail_1pass": tail_tool, "bench_train": bench_train}


def _source(name: str) -> str:
    return (REPO / ("bench_train.py" if name == "bench_train" else f"tools/{name}.py")).read_text()


def _string_tuples(node) -> list:
    """The first string of each tuple in a literal tuple of tuples."""
    return [elt.elts[0].value for elt in node.elts]


def _jax_library_legs() -> list:
    """The library legs' names of tools/bench_frontend_variants.py, in its
    order: each ``timed(f"...{name}...")`` inside a ``for name, prec in
    ((...), ...)`` loop, the f-string expanded for each name."""
    tree = ast.parse(_source("bench_frontend_variants"))
    names = []
    for loop in (n for n in ast.walk(tree) if isinstance(n, ast.For)):
        if not (isinstance(loop.target, ast.Tuple) and loop.target.elts[0].id == "name"):
            continue
        levels = _string_tuples(loop.iter)
        calls = [c for c in loop.body if isinstance(c, ast.Expr) and getattr(c.value.func, "id", None) == "timed"]
        for level in levels:
            for call in calls:
                parts = call.value.args[0].values
                names.append("".join(p.value if isinstance(p, ast.Constant) else level for p in parts))
    return names


def test_library_legs_and_kernel_grades_are_the_jax_tools():
    src = _source("bench_frontend_variants")
    assert [name for name, _ in variants_tool.Chains(tfe.FrontendConfig(n_mels=40), torch.device("cpu")).legs()] == (
        _jax_library_legs())
    assert len(_jax_library_legs()) == 10
    grades = re.findall(r'f"pallas (\S+)\s+FRAME_BLOCK=\{fb_block\}"', src)
    assert [label for label, _ in variants_tool.KERNEL_GRADES] == grades == ["f32(6-pass)", "bf16x3", "bf16x2"]
    # the JAX labels' grades: HIGHEST (six passes), None (the kernel's default, three), "bf16x2"
    assert [fc.frontend_grade(p) for p in ("highest", None, "bf16x2")] == [g for _, g in variants_tool.KERNEL_GRADES]
    # three frame blocks there, three "tc" tiles here
    assert len(re.search(r"for fb_block in \(\) if skip_pallas else \(([^)]*)\)", src).group(1).split(",")) == len(
        fc.TC_TILES[40])


def test_sweep_grade_and_tail_tool_grades_and_tiles_are_the_jax_tools():
    sweep_src = _source("sweep_frontend_blocks")
    assert re.search(r'add_argument\("--precision", default="(\w+)"\)', sweep_src).group(1) == "bf16x2"
    assert "--precision" in sweep_tool.__doc__ and "bf16x2" in sweep_tool.__doc__
    tail_src = _source("bench_frontend_tail_1pass")
    loops = re.findall(r"for prec in \(([^)]*)\):", tail_src)
    assert all(tuple(ast.literal_eval(f"({grades},)")) == tail_tool.GRADES for grades in loops) and len(loops) == 2
    combos = ast.literal_eval(re.search(r"combos = (\[[^\]]*\]) if on_tpu", tail_src).group(1))
    assert sorted({fb for _, fb in combos}) == list(tail_tool.TILES) == [128, 256]


@pytest.fixture(scope="module")
def audio():
    return (np.random.default_rng(0).standard_normal((3, 16000)) * 0.1).astype(np.float32)


def _jax_xla_chain(a, cfg, precision):
    """tools/bench_frontend_variants.py's ``xla_chain``, from the JAX package's pieces."""
    cos_m, sin_m = jfe.dft_matrices(cfg.n_fft)
    win = jfe._hann_window(cfg.n_fft)[:, None]
    fb = jnp.asarray(jfe.mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max))
    frames = jfe.frame_signal(jnp.asarray(a), cfg)
    re_ = jnp.dot(frames, jnp.asarray(cos_m * win), precision=precision, preferred_element_type=jnp.float32)
    im = jnp.dot(frames, jnp.asarray(sin_m * win), precision=precision, preferred_element_type=jnp.float32)
    mel = jnp.dot(re_ * re_ + im * im, fb, precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32)
    return np.asarray(jnp.log(mel + 1e-7))


def test_highest_chains_equal_the_jax_chains(audio):
    """Float32 on both sides, the sums in another order: 1e-3 in log-mel
    units, where the values span about 20 (the floor log(1e-7) is -16)."""
    chains = variants_tool.Chains(tfe.FrontendConfig(n_mels=40), torch.device("cpu"))
    x = torch.from_numpy(audio)
    want = _jax_xla_chain(audio, jfe.FrontendConfig(n_mels=40), jax.lax.Precision.HIGHEST)
    got = chains.xla_chain(x, "HIGHEST").numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-3
    want = np.asarray(jfe.log_mel_spectrogram(audio, jfe.FrontendConfig(n_mels=40)))
    for got in (chains.combined512(x, "HIGHEST"), chains.twomat(x, "HIGHEST").transpose(-1, -2),
                chains.twomat(x, "HIGHEST", flat=True).reshape(3, -1, 40).transpose(-1, -2)):
        assert got.shape == want.shape and np.abs(got.numpy() - want).max() <= 1e-3
    # DEFAULT rounds both operands to bf16: further from HIGHEST than HIGH, which is float32 on the CPU
    default = chains.xla_chain(x, "DEFAULT").numpy()
    assert np.abs(default - want.transpose(0, 2, 1)).max() > 10 * np.abs(
        chains.xla_chain(x, "HIGH").numpy() - want.transpose(0, 2, 1)).max()


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()


def test_precision_levels_restore_the_settings():
    assert _flags() == (False, "highest")
    with variants_tool.dft_precision("HIGH"):
        assert _flags() == (True, "high")
    assert _flags() == (False, "highest")
    with pytest.raises(RuntimeError):
        with variants_tool.dft_precision("HIGH"):
            raise RuntimeError("a leg that fails")
    assert _flags() == (False, "highest")


def test_sweep_runs_every_leg_on_the_cpu(capsys):
    results = sweep_tool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    want = [("tc", t) for t in fc.TC_TILES[40]] + [("fma", t) for t in fc.FMA_TILES]
    assert list(results) == want and all(math.isfinite(ms) for ms in results.values())
    for route, tile in want:
        assert re.search(rf"route={route}\s+tile=\s*{tile}: +-?\d+\.\d+ ms/iter", out)
    assert re.search(r"^best: route=(tc|fma) tile=\d+ \(", out, flags=re.M)
    assert _flags() == (False, "highest")


def test_variants_run_every_leg_on_the_cpu(capsys):
    results = variants_tool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    kernel = [f"kernel {label:12s} tile={t}" for t in fc.TC_TILES[40] for label, _ in variants_tool.KERNEL_GRADES]
    assert list(results) == kernel + _jax_library_legs() + ["accuracy"]
    for name in kernel + _jax_library_legs():
        assert name in out
    # the split grades' 256-frame block does not fit: reckoned before any launch
    assert results["kernel f32(6-pass)  tile=256"] == "does not fit (333064 bytes of shared memory)"
    assert results["kernel bf16x3       tile=256"] == "does not fit (312584 bytes of shared memory)"
    assert sum(isinstance(v, str) for v in results.values()) == 2
    assert re.search(r"xla HIGH vs HIGHEST: above-floor max err \S+, global max \S+", out)
    assert re.search(r"xla DEFAULT vs HIGHEST: above-floor max err \S+, global max \S+", out)
    above, top = results["accuracy"]["DEFAULT"]
    assert 0 < above <= top < 1.0
    assert _flags() == (False, "highest")
    skipped = variants_tool.main(["--device", "cpu", "--skip-kernels"])
    assert list(skipped) == _jax_library_legs() + ["accuracy"]
    capsys.readouterr()


def test_tail_tool_runs_every_leg_on_the_cpu(capsys):
    results = tail_tool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for grade in tail_tool.GRADES:
        assert re.search(rf"precision={grade}\s+max\|err\| vs f32 oracle: \d\.\d{{4}} \(log-mel units\)", out)
        for tile in tail_tool.TILES:
            assert re.search(rf"{grade}\s+route=tc tile={tile}: +-?\d+\.\d+ ms/iter", out)
    # one pass of W is further from the float32 chain than two; both within the bf16 audio's rounding
    assert 0 < results["max_abs_err"]["bf16x2"] <= results["max_abs_err"]["bf16"] < 0.1
    assert _flags() == (False, "highest")


def _root_bench_train() -> tuple:
    """(the metric names, the keys of the dict passed to ``json.dumps``) of the root ``bench_train.py``."""
    tree = ast.parse(_source("bench_train"))
    keys = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps":
            keys = [k.value for k in node.args[0].keys]
    names = [n.args[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "bench_config"]
    return [f"res8_train_step_{n}" for n in names], keys


def test_bench_train_prints_the_root_scripts_lines_on_the_cpu(capsys):
    """The root script's three metrics with its keys, at its CPU sizes
    (batch 8 and 3 steps, batch 1024 for the last line): finite positive
    rates and finite losses."""
    names, keys = _root_bench_train()
    assert names == ["res8_train_step_f32", "res8_train_step_bf16", "res8_train_step_bf16_b1024"]
    assert keys == ["metric", "value", "unit", "examples_per_sec", "final_loss"]
    records = bench_train.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == records
    assert [r["metric"] for r in records] == names
    for rec, batch in zip(records, (8, 8, 1024)):
        assert list(rec) == keys and rec["unit"] == f"steps_per_sec_batch{batch}"
        assert math.isfinite(rec["value"]) and rec["value"] > 0 and rec["examples_per_sec"] > 0
        assert math.isfinite(rec["final_loss"]) and rec["final_loss"] > 0


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_new_tools_refuse_to_run_without_a_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TOOLS[name].main([])
