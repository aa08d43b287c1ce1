"""The port's live engines for the zoo's other families against the JAX
package's: ``OnlineEngine`` and ``IncrementalOnlineEngine``
(howl_tpu_torch/inference/online.py against howl_tpu/inference/online.py)
on the same weights and audio, hop by hop, with and without ``carry_hops``
for the three recurrent families (lstm, seq-lstm, gru).

4 streams of 1.5 s (the decision gate's ``family_audio``: two loud tones and
two quiet buzzes), 40 mels, 0.4 s windows (33 frames) every 62.5 ms, 24
hops. The weights are seeded numpy weights (``compat.numpy_variables``) at
``tests/test_torch_models.py``'s narrow widths, loaded by the JAX engines
as they are and by the port's through ``compat.variables_to_state_dict``.
The first kernel gain of ``GAINS`` and seed whose float32 per-hop
posteriors (an engine of the family, with and without ``carry_hops``)
admit a word and threshold under which each fires on some streams and not
on others,
every decision 0.01 from flipping
(``validate_tpu_decisions.margin_word_threshold`` without halves), is
taken.

Both sides run float32 with the exact frontend: the JAX engines' jnp chain
at HIGHEST, the port's ``OnlineEngine`` its frontend kernel's plain
version at "f32" (las: the plain stacked chain, as the JAX step), the
incremental engines their plain chains. Tolerances: every hop's labels and
fire flags equal; the newest posterior of the smoothing ring within 1e-4.
"""

import functools

import numpy as np
import pytest
import torch

from howl_tpu.inference import EngineConfig as JaxEngineConfig
from howl_tpu.inference.online import IncrementalOnlineEngine as JaxIncrementalOnlineEngine
from howl_tpu.inference.online import OnlineEngine as JaxOnlineEngine
from howl_tpu.models import create_model as jax_create_model
from howl_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from howl_tpu_torch.compat import numpy_variables, variables_to_state_dict
from howl_tpu_torch.inference import EngineConfig
from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
from howl_tpu_torch.models import create_model, model_spec
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.tools.validate_tpu_decisions import family_audio, margin_word_threshold
from tests.test_torch_models import FAMILIES, FAMILY_KW, PORT_KW

torch.set_num_threads(1)

SR = 16000
ZMUV = (-6.0, 4.0)
STREAMS, SAMPLES = 4, 24000
BASE = dict(inference_sequence=(0, 1, 2), max_window_size_ms=400.0, eval_stride_size_ms=62.5, negative_label=3,
            num_labels=4, sample_rate=SR)
ENGINES = {"full-window": (JaxOnlineEngine, OnlineEngine), "incremental": (JaxIncrementalOnlineEngine,
                                                                           IncrementalOnlineEngine)}
RECURRENT = ("lstm", "seq-lstm", "gru")
MARGIN = 0.01
GAINS = (1.0, 1.2, 1.4, 2.0)  # kernel standard deviations in units of flax's lecun-normal


def _variants(name):
    """(engine kind, carry_hops) pairs the family serves: las has no incremental engine."""
    kinds = ["full-window"] + ([] if model_spec(name).uses_deltas else ["incremental"])
    return [(k, c) for k in kinds for c in ((False, True) if name in RECURRENT else (False,))]


CASES = [(name, kind, carry) for name in FAMILIES for kind, carry in _variants(name)]


def _jax_engine(name, kind, variables, cfg_kw, carry=False):
    return ENGINES[kind][0](jax_create_model(name, num_labels=4, **FAMILY_KW[name]), variables,
                            JaxEngineConfig(**cfg_kw), JaxFrontendConfig(n_mels=40), *ZMUV, num_streams=STREAMS,
                            carry_hops=carry)


def _port_engine(name, kind, variables, cfg_kw, carry=False, **kw):
    model = create_model(name, num_labels=4, **FAMILY_KW[name], **PORT_KW.get(name, {}))
    return ENGINES[kind][1](model, variables_to_state_dict(name, variables), EngineConfig(**cfg_kw),
                            FrontendConfig(n_mels=40), *ZMUV, num_streams=STREAMS, carry_hops=carry, device="cpu",
                            **kw)


def _run(engine, audio):
    """Drive a live engine hop by hop, as the decision gate does:
    ``OnlineEngine`` gets the window ending at each hop (shorter at the
    start), the incremental engine each hop's samples. Returns per hop
    (labels, fire flags, newest posteriors), each (hops, streams[, L])."""
    hop = int(round(engine.stride_ms / 1000 * SR))
    out = []
    for end in range(hop, audio.shape[1] + 1, hop):
        if hasattr(engine, "push"):
            engine.push(audio[:, end - hop : end])
        else:
            engine.ingest(audio[:, max(0, end - engine.window_samples) : end])
        ring = engine.state.pred_ring[:, -1]
        out.append((np.asarray(engine.last_labels), np.asarray(engine.last_fired),
                    (ring.float().numpy() if torch.is_tensor(ring) else np.asarray(ring))))
    return tuple(np.stack(x) for x in zip(*out))


def _splits(probs, pick) -> bool:
    """Whether the picked word and threshold fire on some streams of a
    variant's (hops, streams, L) posteriors and not on others."""
    top = np.where(probs.argmax(-1) == pick["word"], probs.max(-1), 0.0).max(0)
    return 0 < int((top >= pick["threshold"]).sum()) < probs.shape[1]


@functools.lru_cache(maxsize=None)
def _setup(name: str, kind: str):
    """(variables, audio, cfg_kw) of a family's engine kind: the word and
    threshold picked from the float32 per-hop posteriors with and without
    ``carry_hops``, so that each fires on some streams and not on others.
    The port's posteriors pick (they are JAX's within 1e-4, a hundredth of
    the margin, which the test checks), so each JAX engine is built once."""
    audio = family_audio(STREAMS, SAMPLES, 5)
    carries = (False, True) if name in RECURRENT else (False,)
    for gain, seed in ((g, s) for g in GAINS for s in range(3)):
        variables = numpy_variables(name, 4, np.random.default_rng(seed), kernel_gain=gain, **FAMILY_KW[name],
                                    **PORT_KW.get(name, {}))
        probs = [_run(_port_engine(name, kind, variables, BASE, carry), audio)[2] for carry in carries]
        try:
            pick = margin_word_threshold(np.concatenate(probs), MARGIN, halves=False)
        except ValueError:
            continue
        if all(_splits(p, pick) for p in probs):
            break
    else:
        raise AssertionError(f"{name} {kind}: no weights of GAINS give a split with and without carry_hops")
    word = pick["word"]
    cfg_kw = dict(BASE, inference_sequence=(word,), negative_label=(word + 1) % 4, inference_threshold=pick["threshold"])
    return variables, audio, cfg_kw


@pytest.mark.parametrize("name,kind,carry", CASES, ids=[f"{n}-{k}{'-carry' if c else ''}" for n, k, c in CASES])
def test_live_engine_matches_its_jax_twin(name, kind, carry):
    variables, audio, cfg_kw = _setup(name, kind)
    jl, jf, jp = _run(_jax_engine(name, kind, variables, cfg_kw, carry), audio)
    port = _port_engine(name, kind, variables, cfg_kw, carry)
    tl, tf, tp = _run(port, audio)
    assert tl.shape == (SAMPLES // 1000, STREAMS) and tl.dtype == np.int32 and tf.dtype == bool
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tf, jf)
    detected = tf.any(0)
    assert detected.any() and not detected.all(), f"need some streams to fire and some not: {detected}"
    assert (port.carry is not None) == carry  # threaded only with carry_hops


@pytest.mark.parametrize("name", RECURRENT)
def test_carry_hops_threads_the_state_and_reset_clears_it(name):
    """With ``carry_hops`` the first hop scores as without it and the later
    ones differ; ``reset`` clears the carry, so the run repeats bit for bit."""
    variables = numpy_variables(name, 4, np.random.default_rng(1), **FAMILY_KW[name])
    audio = family_audio(STREAMS, 8000, 6)
    stateless = _run(_port_engine(name, "incremental", variables, BASE), audio)[2]
    eng = _port_engine(name, "incremental", variables, BASE, carry=True)
    carried = _run(eng, audio)[2]
    np.testing.assert_array_equal(carried[0], stateless[0])
    assert np.abs(carried[1:] - stateless[1:]).max() > 0
    eng.reset()
    assert eng.carry is None
    np.testing.assert_array_equal(_run(eng, audio)[2], carried)


def test_the_refusals_are_jaxs():
    """las on the incremental engine and ``carry_hops`` on a model that is
    not recurrent raise, on both sides, with the same messages."""
    las = numpy_variables("las", 4, np.random.default_rng(0), **FAMILY_KW["las"])
    cnn = numpy_variables("small-cnn", 4, np.random.default_rng(0), **FAMILY_KW["small-cnn"],
                          **PORT_KW["small-cnn"])
    for build in (_jax_engine, _port_engine):
        with pytest.raises(ValueError, match="delta-channel models"):
            build("las", "incremental", las, BASE)
        for kind in ENGINES:
            with pytest.raises(ValueError, match="recurrent models only; 'small-cnn' is not recurrent"):
                build("small-cnn", kind, cnn, BASE, True)


def test_bf16_engines_serve_every_family():
    """A bf16 ``OnlineEngine`` casts the weights and scores in bf16 (K1's
    plain version at the "bf16" grade; las's stacked chain in float32): its
    posteriors are float32 and near the float32 engine's."""
    audio = family_audio(STREAMS, 8000, 7)
    for name in FAMILIES:
        variables = numpy_variables(name, 4, np.random.default_rng(2), **FAMILY_KW[name], **PORT_KW.get(name, {}))
        f32 = _run(_port_engine(name, "full-window", variables, BASE), audio)[2]
        eng = _port_engine(name, "full-window", variables, BASE, compute_dtype=torch.bfloat16)
        b16 = _run(eng, audio)[2]
        assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters()), name
        assert b16.dtype == np.float32 and np.isfinite(b16).all()
        np.testing.assert_allclose(b16, f32, atol=5e-2, err_msg=name)


@pytest.mark.parametrize("kind", list(ENGINES))
def test_a_converted_res8_serves_live_as_jax_does(kind):
    """``CONVERT_STATIC``'s res8 (``ConvertedStaticModel`` around it, a
    sequential spec that keeps ``supports_trunk``) on both live engines: no
    stem kernel taps (``ModelSpec.uses_trunk``), its last frame's logits
    scored each hop, as JAX's engines score it."""
    from dataclasses import replace

    from howl_tpu.models.base import ConvertedStaticModel as JaxConvertedStaticModel
    from howl_tpu.models.base import model_spec as jax_model_spec
    from howl_tpu_torch.bench import res8_numpy_variables
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.models import ConvertedStaticModel

    variables = res8_numpy_variables(np.random.default_rng(3), 4, maps=8)
    audio = family_audio(STREAMS, 16000, 8)
    cfg_kw = dict(BASE, max_window_size_ms=600.0)  # 49 frames: the converted model's window is 40
    jax_eng = ENGINES[kind][0](JaxConvertedStaticModel(jax_create_model("res8", num_labels=4, num_maps=8)),
                               {k: {"inner": v} for k, v in variables.items()}, JaxEngineConfig(**cfg_kw),
                               JaxFrontendConfig(n_mels=40), *ZMUV, num_streams=STREAMS,
                               spec=replace(jax_model_spec("res8"), is_sequential=True))
    state = {f"inner.{k}": v for k, v in res8_variables_to_state_dict(variables).items()}
    port = ENGINES[kind][1](ConvertedStaticModel(create_model("res8", num_labels=4, num_maps=8)), state,
                            EngineConfig(**cfg_kw), FrontendConfig(n_mels=40), *ZMUV,
                            spec=replace(model_spec("res8"), is_sequential=True), num_streams=STREAMS, device="cpu")
    assert port._stem_taps is None
    jl, jf, jp = _run(jax_eng, audio)
    tl, tf, tp = _run(port, audio)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tf, jf)
