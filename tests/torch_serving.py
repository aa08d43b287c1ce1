"""Workspaces and audio for the serving-surface tests of the port
(tests/test_torch_hub.py, tests/test_torch_client.py).

One family's seeded weights (``compat.numpy_variables`` at the registered
widths, as both hubs build the model) are written three ways, with the same
settings and ZMUV stats: a JAX workspace (``howl_tpu``'s ``Workspace``: flax
msgpack), a port workspace (``model-best.pt``, the weights through
``compat.variables_to_state_dict``) and a reference (castorini/howl) one
(an underscore-keyed ``settings.json`` with the reference's ``device``,
``zmuv.pt.bin``, ``model-best.pt.bin`` in the reference's names, each LSTM
bias split between ``bias_ih`` and ``bias_hh`` as a trained torch LSTM
holds it).

The audio is two streams of ``tests/fixtures.py``'s tone corpus, as two
clients hear them: the positives' WAVs one after another, and the
negatives'. The word and threshold of the settings are picked from the
port's float32 posteriors on those streams, fed at the client's cadence,
for every engine kind the family serves, so that every decision sits 0.01
from flipping (``validate_tpu_decisions.margin_word_threshold``, the
negative label excluded) and each kind fires on one stream and not on the
other: an equality of decisions is then no coin toss.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tests.fixtures import make_wakeword_corpus

SR = 16000
VOCAB = ["hey", "fire", "fox"]
ZMUV = {"mean": -6.0, "mean2": 52.0, "total": 1000.0}  # mean -6, std 4
MARGIN = 0.01
SEEDS = ((0, 1.0), (1, 1.0), (0, 2.0), (1, 3.0), (2, 3.0), (2, 4.0), (3, 4.0))  # (seed, kernel gain), tried in turn
KINDS = {"res8": ("online", "incremental", "trunk"), "lstm": ("online", "incremental"), "las": ("online",)}
HUB_FLAGS = {"online": {}, "incremental": {"incremental": True}, "trunk": {"streaming_trunk": True}}


def settings_dict(word: int = 0, threshold: float = 0.0) -> dict:
    return {
        "audio": {"sample_rate": SR, "use_mono": True},
        "audio_transform": {"num_fft": 512, "num_mels": 40, "sample_rate": SR, "hop_length": 200,
                            "use_meyda_spectrogram": False},
        "inference_engine": {"inference_weights": None, "inference_sequence": [word], "inference_window_ms": 2000.0,
                             "smoothing_window_ms": 50.0, "tolerance_window_ms": 500.0,
                             "inference_threshold": threshold},
        "training": {"seed": 0, "vocab": VOCAB, "max_window_size_seconds": 0.5, "eval_window_size_seconds": 0.5,
                     "eval_stride_size_seconds": 0.0625, "convert_static": False, "objective": "frame",
                     "token_type": "word"},
    }


def write_port_workspace(path: Path, name: str, variables: dict, settings: dict) -> Path:
    from howl_tpu_torch.compat import variables_to_state_dict
    from howl_tpu_torch.ops.zmuv import ZmuvTransform
    from howl_tpu_torch.settings import HowlSettings
    from howl_tpu_torch.workspace import Workspace

    s = HowlSettings()
    s.load_dict(settings)
    ws = Workspace(path, delete_existing=False)
    ws.save_settings(s)
    ws.save_zmuv(ZmuvTransform(ZMUV["mean"], ZMUV["mean2"], ZMUV["total"]))
    ws.save_model(variables_to_state_dict(name, variables), best=True)
    (path / "cmd-args.json").write_text(json.dumps({"model": name}))
    return path


def write_jax_workspace(path: Path, name: str, variables: dict, settings: dict) -> Path:
    from howl_tpu.ops.zmuv import ZmuvTransform
    from howl_tpu.settings import HowlSettings
    from howl_tpu.workspace import Workspace

    s = HowlSettings()
    s.load_dict(settings)
    ws = Workspace(path, delete_existing=False)
    ws.save_settings(s)
    ws.save_zmuv(ZmuvTransform(ZMUV["mean"], ZMUV["mean2"], ZMUV["total"]))
    ws.save_model(variables, best=True)
    (path / "cmd-args.json").write_text(json.dumps({"model": name}))
    return path


def reference_state_dict(name: str, variables: dict, rng: np.random.Generator) -> dict:
    """The weights in the reference's names, each LSTM bias split at random
    between the input and hidden sides (their sum is the flax bias)."""
    from howl_tpu_torch.compat import variables_to_state_dict

    sd = dict(variables_to_state_dict(name, variables))
    for key in [k for k in sd if "bias_hh_l0" in k and name != "gru"]:
        ih = key.replace("bias_hh", "bias_ih")
        part = torch.from_numpy(rng.normal(0.0, 0.1, tuple(sd[key].shape)).astype(np.float32))
        sd[ih], sd[key] = sd[ih] + part, sd[key] - part
    return sd


def write_reference_workspace(path: Path, name: str, variables: dict, settings: dict) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    data = {f"_{section}": dict(values) for section, values in settings.items()}
    data["_training"]["device"] = "cuda:0"  # the reference's torch device string, which neither hub takes
    (path / "settings.json").write_text(json.dumps(data))
    torch.save({k: torch.tensor([v]) for k, v in ZMUV.items()}, path / "zmuv.pt.bin")
    torch.save(reference_state_dict(name, variables, np.random.default_rng(7)), path / "model-best.pt.bin")
    (path / "cmd-args.json").write_text(json.dumps({"model": name, "workspace": str(path)}))
    return path


def tone_streams(root: Path):
    """(positive WAVs, negative WAVs, (2, samples) audio: the positives one
    after another, then the negatives)."""
    from howl_tpu_torch.utils.audio_utils import read_wav

    corpus = make_wakeword_corpus(root, n_positive=3, n_negative=3)
    pos = sorted((corpus / "audio").glob("pos_*.wav"))
    neg = sorted((corpus / "audio").glob("neg_*.wav"))
    audio = np.stack([np.concatenate([read_wav(p)[0][0] for p in wavs]) for wavs in (pos, neg)]).astype(np.float32)
    return pos, neg, audio


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x, dtype=np.float32)


def feed_like_client(engine, audio: np.ndarray):
    """Drive a live engine, JAX's or the port's, over ``audio`` as
    ``HowlClient`` drives it: an engine with ``push`` gets each hop's
    samples (a hop-blocked one ``hop_block`` hops a call), the
    ``OnlineEngine`` the window ending at each hop once the first window is
    whole. Returns per hop ((hops, N, L) newest posteriors, (hops, N) fire
    flags): ``last_probs`` of a trunk engine, the smoothing ring's newest
    entry otherwise."""
    hop = int(round(engine.stride_ms / 1000 * SR))
    block = getattr(engine, "hop_block", 1) if hasattr(engine, "push") else 1
    probs, fired = [], []
    if hasattr(engine, "push"):
        for end in range(block * hop, audio.shape[1] + 1, block * hop):
            engine.push(audio[:, end - block * hop : end])
            if block > 1:
                probs += list(_host(engine.last_probs).transpose(1, 0, 2))
                fired += list(np.asarray(engine.last_fired).T)
            else:
                trunk = getattr(engine, "last_probs", None) is not None
                probs.append(_host(engine.last_probs if trunk else engine.state.pred_ring[:, -1]))
                fired.append(np.asarray(engine.last_fired))
    else:
        for end in range(engine.window_samples, audio.shape[1] + 1, hop):
            engine.ingest(audio[:, end - engine.window_samples : end])
            probs.append(_host(engine.state.pred_ring[:, -1]))
            fired.append(np.asarray(engine.last_fired))
    return np.stack(probs), np.stack(fired)


def _splits(probs: np.ndarray, pick: dict) -> bool:
    """Whether the pick fires on one of the two streams and not on the other."""
    top = np.where(probs.argmax(-1) == pick["word"], probs.max(-1), 0.0).max(0)
    return int((top >= pick["threshold"]).sum()) == 1


def family_setup(root: Path, name: str) -> dict:
    """The family's weights, workspaces and audio: {"variables", "pick",
    "audio", "pos", "neg", "port", "jax", "reference"}. The first (seed,
    gain) of ``SEEDS`` whose posteriors admit a pick is taken."""
    from howl_tpu_torch import hub
    from howl_tpu_torch.compat import numpy_variables
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.tools.validate_tpu_decisions import margin_word_threshold

    pos, neg, audio = tone_streams(root / "corpus")
    for seed, gain in SEEDS:
        variables = numpy_variables(name, len(VOCAB) + 1, np.random.default_rng(seed), kernel_gain=gain)
        ws = write_port_workspace(root / "port", name, variables, settings_dict())
        probs = []
        for kind in KINDS[name]:
            engine, _ = hub.load_workspace_engine(ws, num_streams=2, device="cpu", **HUB_FLAGS[kind])
            probs.append(feed_like_client(engine, audio)[0])
        SETTINGS.reset()
        try:
            pick = margin_word_threshold(np.concatenate(probs), MARGIN, halves=False)
        except ValueError:
            continue
        if pick["word"] >= len(VOCAB) or not all(_splits(p, pick) for p in probs):  # the last label is no word
            continue
        settings = settings_dict(pick["word"], pick["threshold"])
        write_port_workspace(root / "port", name, variables, settings)
        return {"variables": variables, "pick": pick, "audio": audio, "pos": pos, "neg": neg, "port": root / "port",
                "jax": write_jax_workspace(root / "jax", name, variables, settings),
                "reference": write_reference_workspace(root / "reference", name, variables, settings)}
    raise ValueError(f"no seed of {SEEDS} gives {name} a word and threshold with a margin of {MARGIN}")
