"""Weight bridge between the JAX package and the port, both ways, for every
model of the zoo.

``res8_variables_to_state_dict`` is the inverse of ``howl_tpu/compat.py``'s
``res8_torch_state_to_variables`` (the same mapping as
``howl_tpu/training/run/export_honkling.py``'s ``res8_variables_to_torch_dict``):
flax HWIO conv kernels (H = time, W = freq) become torch OIHW, flax (in, out)
dense kernels become torch (out, in), and BatchNorm ``batch_stats`` become
``running_mean`` / ``running_var``. ``res8_state_dict_to_variables`` maps a
port state dict back, as numpy in the JAX layout, so a res8 the port trained
can be compared with the JAX package and loaded by it.

The other families go through :func:`variables_to_state_dict` and
:func:`state_dict_to_variables`, each driven by the family's entry in
``LAYOUTS``: a list of (kind, JAX path, port prefix) rows.

  * small-cnn, seq-cnn and mobilenet keep the JAX tree's names; their convs
    run with time as H, so an HWIO kernel becomes OIHW, a dense (in, out)
    kernel becomes (out, in), and an affine BatchNorm's ``scale`` and
    ``bias`` and its ``batch_stats`` become ``weight``, ``bias``,
    ``running_mean`` and ``running_var``;
  * lstm, seq-lstm, gru and las carry the reference howl modules' names,
    which ``howl_tpu/compat.py`` reads: their convs run on (frequency,
    time), so HWIO (kT, kF, I, O) becomes (O, I, kF, kT); an LSTM cell's
    per-gate kernels stack in torch's [i, f, g, o] order with the flax bias
    in ``bias_hh`` and zeros in ``bias_ih``; a GRU cell's in [r, z, n], with
    the r and z biases on the input side and the candidate's two biases
    kept apart; las's LSTM inputs permuted from flax's frequency-major
    flattening to the reference's channel-major one. Going back, torch's
    two LSTM biases sum into flax's one, and a GRU's r and z biases too.

:func:`numpy_variables` makes seeded weights in the JAX layout for any
family, for the tools and the smoke run.

Reference (castorini/howl) workspaces: ``model{-best}.pt.bin`` (torch state
dicts), ``zmuv.pt.bin`` (the ZMUV buffers) and an underscore-keyed
``settings.json``. Since the port's models carry the reference's parameter
names and layouts (res8's, and the rows above for lstm, seq-lstm, gru and
las, las's channel-major LSTM inputs included), a reference state dict loads
into the port's model as it is: :func:`load_reference_workspace` reads one
without writing anything (the hub serves it so), and
:func:`import_reference_workspace` writes it out as a port workspace. The
families are the JAX package's ``SUPPORTED_IMPORT_FAMILIES``.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def res8_variables_to_state_dict(variables) -> "OrderedDict[str, torch.Tensor]":
    """res8 variables ``{"params": ..., "batch_stats": ...}`` as numpy (or
    anything ``np.asarray`` reads) -> a state dict that
    ``Res8.load_state_dict(..., strict=True)`` accepts."""
    params = variables["params"]
    stats = variables["batch_stats"]

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    out = OrderedDict()
    for i in range(7):
        out[f"conv{i}.weight"] = t(np.asarray(params[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1))
    for i in range(1, 7):
        out[f"bn{i}.running_mean"] = t(stats[f"bn{i}"]["mean"])
        out[f"bn{i}.running_var"] = t(stats[f"bn{i}"]["var"])
        out[f"bn{i}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    out["output.weight"] = t(np.asarray(params["output"]["kernel"]).T)
    out["output.bias"] = t(params["output"]["bias"])
    return out


def res8_state_dict_to_variables(state_dict) -> dict:
    """A res8 state dict (``Res8.state_dict()``) -> variables
    ``{"params": ..., "batch_stats": ...}`` as float32 numpy in the JAX
    package's layout; the inverse of :func:`res8_variables_to_state_dict`."""

    def n(name):
        return state_dict[name].detach().to(device="cpu", dtype=torch.float32).numpy()

    params = {f"conv{i}": {"kernel": n(f"conv{i}.weight").transpose(2, 3, 1, 0)} for i in range(7)}
    params["output"] = {"kernel": n("output.weight").T, "bias": n("output.bias")}
    stats = {f"bn{i}": {"mean": n(f"bn{i}.running_mean"), "var": n(f"bn{i}.running_var")} for i in range(1, 7)}
    return {"params": params, "batch_stats": stats}


# ---- the other families ----

_OHWI_TIME_H = (3, 2, 0, 1)  # HWIO (kT, kF, I, O) -> OIHW with time as H; (2, 3, 1, 0) back
_FT = (3, 2, 1, 0)  # HWIO (kT, kF, I, O) <-> (O, I, kF, kT) on (frequency, time) inputs; its own inverse
_LSTM_GATES, _GRU_GATES = "ifgo", "rzn"


def _mobilenet_layout(variables_or_model) -> list:
    """mobilenet's rows; the blocks and their convs are counted from the tree."""
    rows = [("conv", ("downsample",), "downsample"), ("bn", ("downsample_bn",), "downsample_bn"),
            ("conv", ("stem",), "stem"), ("bn", ("stem_bn",), "stem_bn")]
    for k, j in variables_or_model:
        rows += [("conv", (f"InvertedResidual_{k}", f"Conv_{j}"), f"blocks.{k}.convs.{j}"),
                 ("bn", (f"InvertedResidual_{k}", f"BatchNorm_{j}"), f"blocks.{k}.bns.{j}")]
    return rows + [("conv", ("head_conv",), "head_conv"), ("bn", ("head_bn",), "head_bn"),
                   ("dense", ("classifier",), "classifier")]


_CNN = [("conv", ("conv0",), "conv0"), ("bn", ("bn1",), "bn1"), ("conv", ("conv1",), "conv1"),
        ("bn", ("bn2",), "bn2"), ("dense", ("fc1",), "fc1"), ("dense", ("fc2",), "fc2")]
_LSTM = [("lstm", ("OptimizedLSTMCell_0",), "lstm"), ("dense", ("fc1",), "dnn.0"), ("dense", ("fc2",), "dnn.2")]
LAYOUTS = {
    "small-cnn": _CNN,
    "seq-cnn": _CNN,
    "lstm": _LSTM,
    "seq-lstm": _LSTM,
    "gru": [("conv_ft", ("conv1",), "conv_encoder.0"), ("bn", ("bn1",), "conv_encoder.1"),
            ("conv_ft", ("conv2",), "conv_encoder.4"), ("bn", ("bn2",), "conv_encoder.6"),
            ("gru", ("GRUCell_0",), "lstm_encoder"), ("dense", ("fc1",), "dnn.0"), ("dense", ("fc2",), "dnn.3")],
    # conv1 and conv2 sit twice in the reference's LAS encoder, also as conv_encoder.0 and .4
    "las": [("conv_ft", ("encoder", "conv1"), "encoder.conv1"), ("conv_ft", ("encoder", "conv1"), "encoder.conv_encoder.0"),
            ("bn", ("encoder", "bn1"), "encoder.conv_encoder.1"),
            ("conv_ft", ("encoder", "conv2"), "encoder.conv2"), ("conv_ft", ("encoder", "conv2"), "encoder.conv_encoder.4"),
            ("bn", ("encoder", "bn2"), "encoder.conv_encoder.5"),
            ("lstm", ("encoder", "OptimizedLSTMCell_0"), "encoder.lstm_encoder"),
            ("lstm_reverse", ("encoder", "OptimizedLSTMCell_1"), "encoder.lstm_encoder"),
            ("vec", ("attn", "context_vec"), "attn.context_vec"),
            ("dense", ("attn", "v_proj"), "attn.v_proj"), ("dense", ("attn", "k_proj"), "attn.k_proj"),
            ("dense", ("fc1",), "fc.0"), ("dense", ("fc2",), "fc.3")],
}


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _layout(name: str, blocks) -> list:
    if name == "mobilenet":
        return _mobilenet_layout(blocks)
    try:
        return LAYOUTS[name]
    except KeyError as e:
        raise ValueError(f"no weight layout for model {name!r}; families: {sorted([*LAYOUTS, 'mobilenet', 'res8'])}") from e


def _las_input_perm(w_ih: np.ndarray, n_ch: int) -> np.ndarray:
    """flax input index (f * C + c) -> the reference's (c * F' + f)."""
    i_total = w_ih.shape[1]
    return np.arange(i_total).reshape(n_ch, i_total // n_ch).T.reshape(-1)


def variables_to_state_dict(name: str, variables) -> "OrderedDict[str, torch.Tensor]":
    """A family's JAX variables ``{"params": ..., "batch_stats": ...}`` as
    numpy (or anything ``np.asarray`` reads) -> a state dict that the port's
    model of that name loads with ``strict=True``."""
    if name == "res8":
        return res8_variables_to_state_dict(variables)
    params, stats = variables["params"], variables.get("batch_stats", {})

    def a(x):
        return np.asarray(x, dtype=np.float32)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    blocks = sorted((int(k.split("_")[1]), int(c.split("_")[1])) for k, v in params.items()
                    if k.startswith("InvertedResidual_") for c in v if c.startswith("Conv_"))
    out = OrderedDict()
    n_ch = None
    for kind, path, prefix in _layout(name, blocks):
        p = _get(params, path)
        if kind in ("conv", "conv_ft"):
            out[f"{prefix}.weight"] = t(a(p["kernel"]).transpose(_OHWI_TIME_H if kind == "conv" else _FT))
            n_ch = a(p["kernel"]).shape[-1]
            if "bias" in p:
                out[f"{prefix}.bias"] = t(p["bias"])
        elif kind == "bn":
            s = _get(stats, path)
            out[f"{prefix}.weight"], out[f"{prefix}.bias"] = t(p["scale"]), t(p["bias"])
            out[f"{prefix}.running_mean"], out[f"{prefix}.running_var"] = t(s["mean"]), t(s["var"])
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif kind == "dense":
            out[f"{prefix}.weight"], out[f"{prefix}.bias"] = t(a(p["kernel"]).T), t(p["bias"])
        elif kind == "vec":
            out[prefix] = t(p)
        elif kind in ("lstm", "lstm_reverse"):
            suffix = "_reverse" if kind == "lstm_reverse" else ""
            w_ih = np.concatenate([a(p[f"i{g}"]["kernel"]).T for g in _LSTM_GATES])
            if name == "las":
                w_ih[:, _las_input_perm(w_ih, n_ch)] = w_ih.copy()
            out[f"{prefix}.weight_ih_l0{suffix}"] = t(w_ih)
            out[f"{prefix}.weight_hh_l0{suffix}"] = t(np.concatenate([a(p[f"h{g}"]["kernel"]).T for g in _LSTM_GATES]))
            bias = np.concatenate([a(p[f"h{g}"]["bias"]) for g in _LSTM_GATES])
            out[f"{prefix}.bias_ih_l0{suffix}"], out[f"{prefix}.bias_hh_l0{suffix}"] = t(np.zeros_like(bias)), t(bias)
        elif kind == "gru":
            out[f"{prefix}.weight_ih_l0"] = t(np.concatenate([a(p[f"i{g}"]["kernel"]).T for g in _GRU_GATES]))
            out[f"{prefix}.weight_hh_l0"] = t(np.concatenate([a(p[f"h{g}"]["kernel"]).T for g in _GRU_GATES]))
            out[f"{prefix}.bias_ih_l0"] = t(np.concatenate([a(p[f"i{g}"]["bias"]) for g in _GRU_GATES]))
            hn = a(p["hn"]["bias"])
            out[f"{prefix}.bias_hh_l0"] = t(np.concatenate([np.zeros_like(hn), np.zeros_like(hn), hn]))
    return out


def state_dict_to_variables(name: str, state_dict) -> dict:
    """A port state dict of model ``name`` -> variables ``{"params": ...,
    "batch_stats": ...}`` as float32 numpy in the JAX package's layout; the
    inverse of :func:`variables_to_state_dict`."""
    if name == "res8":
        return res8_state_dict_to_variables(state_dict)

    def n(key):
        return state_dict[key].detach().to(device="cpu", dtype=torch.float32).numpy()

    blocks = sorted({(int(k.split(".")[1]), int(k.split(".")[3])) for k in state_dict
                     if k.startswith("blocks.") and ".convs." in k})
    params, stats = {}, {}
    n_ch = None
    for kind, path, prefix in _layout(name, blocks):
        if kind in ("conv", "conv_ft"):
            w = n(f"{prefix}.weight")
            leaf = {"kernel": w.transpose((2, 3, 1, 0) if kind == "conv" else _FT)}
            n_ch = w.shape[0]
            if f"{prefix}.bias" in state_dict:
                leaf["bias"] = n(f"{prefix}.bias")
            _put(params, path, leaf)
        elif kind == "bn":
            _put(params, path, {"scale": n(f"{prefix}.weight"), "bias": n(f"{prefix}.bias")})
            _put(stats, path, {"mean": n(f"{prefix}.running_mean"), "var": n(f"{prefix}.running_var")})
        elif kind == "dense":
            _put(params, path, {"kernel": n(f"{prefix}.weight").T, "bias": n(f"{prefix}.bias")})
        elif kind == "vec":
            _put(params, path, n(prefix))
        elif kind in ("lstm", "lstm_reverse"):
            suffix = "_reverse" if kind == "lstm_reverse" else ""
            w_ih = n(f"{prefix}.weight_ih_l0{suffix}")
            if name == "las":
                w_ih = w_ih[:, _las_input_perm(w_ih, n_ch)]
            w_hh = n(f"{prefix}.weight_hh_l0{suffix}")
            bias = n(f"{prefix}.bias_ih_l0{suffix}") + n(f"{prefix}.bias_hh_l0{suffix}")
            cell = {}
            for g, wi, wh, b in zip(_LSTM_GATES, np.split(w_ih, 4), np.split(w_hh, 4), np.split(bias, 4)):
                cell[f"i{g}"], cell[f"h{g}"] = {"kernel": wi.T}, {"kernel": wh.T, "bias": b}
            _put(params, path, cell)
        elif kind == "gru":
            wi = dict(zip(_GRU_GATES, np.split(n(f"{prefix}.weight_ih_l0"), 3)))
            wh = dict(zip(_GRU_GATES, np.split(n(f"{prefix}.weight_hh_l0"), 3)))
            bi = dict(zip(_GRU_GATES, np.split(n(f"{prefix}.bias_ih_l0"), 3)))
            bh = dict(zip(_GRU_GATES, np.split(n(f"{prefix}.bias_hh_l0"), 3)))
            _put(params, path, {
                "ir": {"kernel": wi["r"].T, "bias": bi["r"] + bh["r"]},
                "iz": {"kernel": wi["z"].T, "bias": bi["z"] + bh["z"]},
                "in": {"kernel": wi["n"].T, "bias": bi["n"]},
                "hr": {"kernel": wh["r"].T}, "hz": {"kernel": wh["z"].T}, "hn": {"kernel": wh["n"].T, "bias": bh["n"]},
            })
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def numpy_variables(name: str, num_labels: int, rng: np.random.Generator, kernel_gain: float = 1.0,
                    **model_kwargs) -> dict:
    """Seeded variables of model ``name`` in the JAX package's layout:
    normal kernels of variance ``kernel_gain`` ** 2 / fan_in (1: flax's
    lecun-normal; sqrt(2) keeps a ReLU net's activations at their scale
    through depth), small biases, BatchNorm scales near 1 and running stats
    near (0, 1), las's context vector uniform in +-0.25, as flax initializes
    it. The tree is the port model's, carried across."""
    from howl_tpu_torch.models import create_model

    template = state_dict_to_variables(name, create_model(name, num_labels=num_labels, **model_kwargs).state_dict())

    def fill(key, leaf):
        if isinstance(leaf, dict):
            return {k: fill(k, leaf[k]) for k in sorted(leaf)}
        return draw(key, leaf.shape).astype(np.float32)

    def draw(key, shape):
        if key == "kernel":
            return rng.standard_normal(shape) * kernel_gain / np.sqrt(np.prod(shape[:-1]))
        if key == "scale":
            return 1.0 + rng.normal(0.0, 0.1, shape)
        if key == "mean":
            return rng.normal(0.0, 0.1, shape)
        if key == "var":
            return rng.uniform(0.5, 1.5, shape)
        if key == "context_vec":
            return rng.uniform(-0.25, 0.25, shape)
        return rng.normal(0.0, 0.05, shape)  # biases

    return {k: fill(k, template[k]) for k in sorted(template)}



# ---- reference (castorini/howl) workspaces ----

SUPPORTED_IMPORT_FAMILIES = ("res8", "lstm", "seq-lstm", "gru", "las")


def reference_settings_to_dict(ref_data: dict) -> dict:
    """A reference ``settings.json`` (sections ``_audio``, ``_training``, ...)
    -> the layout ``HowlSettings.load_dict`` reads. The field names are
    shared; ``load_dict`` drops the reference-only ones, and ``device`` is
    dropped here: the reference's is a torch device string of the machine
    that trained, the port's comes from the caller."""
    return {key.lstrip("_"): {k: v for k, v in value.items() if k != "device"}
            for key, value in ref_data.items() if isinstance(value, dict)}


def is_reference_workspace(path) -> bool:
    """True where ``path`` holds a reference workspace: its torch checkpoints,
    or an underscore-keyed ``settings.json``."""
    p = Path(path)
    if (p / "model-best.pt.bin").exists() or (p / "model.pt.bin").exists():
        return True
    settings = p / "settings.json"
    if settings.exists():
        try:
            data = json.loads(settings.read_text())
        except ValueError:
            return False
        return isinstance(data, dict) and bool(data) and all(k.startswith("_") for k in data)
    return False


def _torch_load(path: Path) -> dict:
    return torch.load(str(path), map_location="cpu", weights_only=True)


def reference_model_name(src_path, model_name: Optional[str] = None) -> str:
    """``model_name``, else the ``model`` entry of the workspace's
    ``cmd-args.json``; a family outside ``SUPPORTED_IMPORT_FAMILIES`` raises."""
    src = Path(src_path)
    if model_name is None:
        args_path = src / "cmd-args.json"
        if args_path.exists():
            model_name = json.loads(args_path.read_text()).get("model")
        if model_name is None:
            raise ValueError("model_name not given and the source cmd-args.json is missing or has no 'model' entry; "
                             "pass the architecture explicitly (e.g. 'res8')")
    if model_name not in SUPPORTED_IMPORT_FAMILIES:
        raise NotImplementedError(f"reference checkpoints are read for {SUPPORTED_IMPORT_FAMILIES}; got "
                                  f"{model_name!r}. Retrain the others with howl_tpu_torch.training.run.train.")
    return model_name


def load_reference_workspace(src_path, model_name: Optional[str] = None, settings=None):
    """Read a reference workspace and write nothing: (model_name, settings,
    {best: state dict}, zmuv or None). ``settings`` (a ``HowlSettings``, the
    global one for the hub) takes the snapshot; a fresh one by default.
    ``{True: ...}`` is always there: a workspace with only ``model.pt.bin``
    serves it as its best."""
    from howl_tpu_torch.ops.zmuv import ZmuvTransform
    from howl_tpu_torch.settings import HowlSettings

    src = Path(src_path)
    if not (src / "settings.json").exists():
        raise FileNotFoundError(f"{src} has no settings.json: not a reference workspace")
    model_name = reference_model_name(src, model_name)
    settings = settings if settings is not None else HowlSettings()
    settings.load_dict(reference_settings_to_dict(json.loads((src / "settings.json").read_text())))

    zmuv = None
    if (src / "zmuv.pt.bin").exists():
        z = {k: float(torch.as_tensor(v).reshape(-1)[0]) for k, v in _torch_load(src / "zmuv.pt.bin").items()}
        try:
            # a file without its stats fails here, not as garbage-normalized features later
            zmuv = ZmuvTransform(z["mean"], z["mean2"], z["total"])
        except KeyError as e:
            raise ValueError(f"{src / 'zmuv.pt.bin'} lacks the reference ZmuvTransform buffers (total, mean, mean2); "
                             f"found {sorted(z)}") from e

    state_dicts = {}
    for fname, best in (("model-best.pt.bin", True), ("model.pt.bin", False)):
        if (src / fname).exists():
            state_dicts[best] = {k: v.float() if v.is_floating_point() else v for k, v in _torch_load(src / fname).items()}
    if not state_dicts:
        raise FileNotFoundError(f"{src} has neither model-best.pt.bin nor model.pt.bin")
    if True not in state_dicts:
        state_dicts[True] = state_dicts[False]
    return model_name, settings, state_dicts, zmuv


def import_reference_workspace(src_path, dst_path, model_name: Optional[str] = None):
    """Write a reference workspace out as a port workspace (``settings.json``,
    ``cmd-args.json``, ``zmuv.json``, ``model{-best}.pt``); returns the
    ``Workspace``, which ``hub.load_workspace_engine(dst_path)`` serves."""
    from howl_tpu_torch.workspace import Workspace

    model_name, settings, state_dicts, zmuv = load_reference_workspace(src_path, model_name)
    workspace = Workspace(Path(dst_path), delete_existing=False)
    workspace.save_settings(settings)
    (workspace.path / "cmd-args.json").write_text(json.dumps({"model": model_name}))
    if zmuv is not None:
        workspace.save_zmuv(zmuv)
    for best, state_dict in state_dicts.items():
        workspace.save_model(state_dict, best=best)
    return workspace
