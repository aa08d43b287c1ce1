"""Pretrained-model hub (counterpart of ``howl_tpu/hub.py``; ref
hubconf.py:27-136).

Builds a live or offline engine from a workspace directory: the settings
snapshot, the ``InferenceContext``, the ZMUV stats, the model and its
weights. A workspace is the port's (``model{-best}.pt``, ``zmuv.json``,
``settings.json``, ``cmd-args.json``, as the training entry point writes
it) or a reference (castorini/howl) one (``model{-best}.pt.bin``,
``zmuv.pt.bin``, an underscore-keyed ``settings.json``), whose state dict
loads into the port's model as it is (``compat.py``); nothing is written.
Published names resolve against a local howl-models-style checkout named by
``$HOWL_MODELS_PATH`` (or ``models_path``); nothing is downloaded.

Every flag is checked before a file of the workspace is read, and every
check that needs the model (``auto``'s choice, ``carry_hops`` on a
recurrent model, the trunk engine on res8, ``hop_block`` against the
trunk's schedule, the capacity guardrail) before its weights or ZMUV stats
are read: only ``settings.json`` and ``cmd-args.json`` come first (the JAX
hub checks ``carry_hops`` with ``streaming_trunk`` after loading the
model, ROADMAP F4). The engines default to the card (``device="cuda"``) and
raise without one unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import replace
from pathlib import Path
from typing import Optional, Tuple

from howl_tpu_torch import compat
from howl_tpu_torch.context import InferenceContext
from howl_tpu_torch.inference.capacity import CapacityError, CapacityWarning, check_capacity, recommend
from howl_tpu_torch.inference.config import EngineConfig
from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine, trunk_schedule
from howl_tpu_torch.models import ConvertedStaticModel, create_model, model_spec
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.utils.platform import resolve_device
from howl_tpu_torch.workspace import Workspace

# published model name -> (architecture, workspace path inside howl-models)
PRETRAINED_MODELS = {
    "hey_fire_fox": ("res8", "howl/hey-fire-fox"),
}


def _workspace_header(path: Path, model_name: Optional[str]) -> Tuple[str, bool]:
    """(model name, whether the workspace is a reference one), with the
    workspace's settings loaded into ``SETTINGS``. Reads ``settings.json``
    and ``cmd-args.json`` only."""
    reference = compat.is_reference_workspace(path)
    settings_path = path / "settings.json"
    if not settings_path.exists():
        raise FileNotFoundError(f"{path} has no settings.json: not a workspace")
    data = json.loads(settings_path.read_text())
    SETTINGS.load_dict(compat.reference_settings_to_dict(data) if reference else data)
    if reference:
        return compat.reference_model_name(path, model_name), True
    if model_name is None:
        args_path = path / "cmd-args.json"
        if args_path.exists():
            model_name = json.loads(args_path.read_text()).get("model")
        if model_name is None:
            raise ValueError("model_name not given and cmd-args.json missing from workspace")
    return model_name, False


def _serving_model(model_name: str):
    """(model without weights, spec, cfg, frontend, ctx) from ``SETTINGS``;
    a workspace trained with ``convert_static`` gets the same per-frame
    wrapper its weights were saved from."""
    tr = SETTINGS.training
    ctx = InferenceContext(vocab=tr.vocab, token_type=tr.token_type, use_blank=tr.objective != "frame")
    model = create_model(model_name, num_labels=ctx.num_labels)
    spec = model_spec(model_name)
    if tr.convert_static:
        model = ConvertedStaticModel(model, frame_window_size=40, frame_stride_size=10)
        spec = replace(spec, is_sequential=True)
    return model, spec, EngineConfig.from_settings(ctx), FrontendConfig.from_settings(), ctx


def _load_weights(path: Path, reference: bool, model_name: str, best: bool):
    """(ZMUV stats, state dict): the files with the weights, read last."""
    if reference:
        _, _, state_dicts, zmuv = compat.load_reference_workspace(path, model_name)
        if not best and not (path / "model.pt.bin").exists():
            raise FileNotFoundError(f"{path} has no non-best model.pt.bin")
        state_dict = state_dicts[best]
    else:
        workspace = Workspace(path, delete_existing=False)
        zmuv = workspace.load_zmuv()
    if zmuv is None:
        raise FileNotFoundError(f"zmuv stats missing from workspace {path}")
    if not reference:
        state_dict = workspace.load_model(best=best)
    return zmuv, state_dict


def _load_workspace_stack(workspace_path, model_name: Optional[str], best: bool):
    """Workspace dir (the port's or a reference one) -> (model, spec,
    state dict, cfg, frontend, zmuv, ctx): what both entry points need
    before they pick an engine class."""
    path = Path(workspace_path)
    model_name, reference = _workspace_header(path, model_name)
    model, spec, cfg, frontend, ctx = _serving_model(model_name)
    zmuv, state_dict = _load_weights(path, reference, model_name, best)
    return model, spec, state_dict, cfg, frontend, zmuv, ctx


def load_workspace_engine(
    workspace_path,
    model_name: Optional[str] = None,
    best: bool = True,
    num_streams: int = 1,
    incremental: bool = False,
    streaming_trunk: bool = False,
    hop_block: int = 1,
    auto: bool = False,
    strict_capacity: bool = False,
    carry_hops: bool = False,
    device="cuda",
):
    """Workspace dir -> (live engine, InferenceContext) (ref hubconf.py:33-84).

    The default is an ``OnlineEngine``, which scores each hop's whole
    window; ``incremental=True`` returns an ``IncrementalOnlineEngine``,
    which featurizes only each hop's new audio; ``streaming_trunk=True``
    (res8) a ``FusedStreamingOnlineEngine``, which keeps per-layer trunk
    caches and decides ``schedule.lag`` hops late, scoring as the offline
    fused-trunk engine. ``hop_block > 1`` (streaming_trunk only, a multiple
    of the schedule's period) scores that many hops a step, the bulk mode.
    ``carry_hops=True`` (recurrent models on the window engines) threads the
    model's state from hop to hop.

    ``auto=True`` takes no engine flag and picks the lowest-decision-latency
    engine that sustains ``num_streams`` on one card
    (``inference/capacity.py``'s measured profiles), raising
    ``CapacityError`` when none does. Every explicit configuration is
    checked against the same profiles: one predicted to miss the cadence
    warns (``CapacityWarning``), or raises with ``strict_capacity=True``.

    The engine scores in float32 at the frontend grade "auto" picks ("f32"),
    as the JAX hub's, on ``device``."""
    # the flags alone, before any file of the workspace is read
    if auto and (incremental or streaming_trunk or hop_block != 1):
        raise ValueError("auto=True selects the engine; don't also pass engine flags")
    if streaming_trunk and incremental:
        raise ValueError("streaming_trunk and incremental select different engines; pass exactly one")
    if hop_block != 1 and not streaming_trunk:
        raise ValueError("hop_block requires streaming_trunk=True")
    if carry_hops and streaming_trunk:
        raise ValueError("carry_hops applies to recurrent models on the window-scoring engines; "
                         "the streaming-trunk engine serves the res8 family only")
    resolve_device(device)

    # the checks that need the model: settings.json and cmd-args.json read, no weights yet
    path = Path(workspace_path)
    model_name, reference = _workspace_header(path, model_name)
    model, spec, cfg, frontend, ctx = _serving_model(model_name)
    if auto:
        kwargs = recommend(num_streams, supports_trunk=spec.uses_trunk)
        incremental = bool(kwargs.get("incremental", False))
        streaming_trunk = bool(kwargs.get("streaming_trunk", False))
        hop_block = int(kwargs.get("hop_block", 1))
        if carry_hops and streaming_trunk:
            raise ValueError(f"auto=True picked the streaming-trunk engine for {num_streams} streams, which "
                             "carries no RNN state; carry_hops needs a window-scoring engine")
    if carry_hops and not spec.is_recurrent:
        raise ValueError(f"carry_hops threads RNN state across hops and applies to recurrent models only; "
                         f"{model_name!r} is not recurrent")
    if streaming_trunk:
        if not spec.uses_trunk:
            raise ValueError(f"the streaming-trunk engine serves a window classifier with a trunk (res8); "
                             f"got {model_name!r}")
        if hop_block != 1:
            trunk_schedule(cfg, frontend, model.pooling[0]).blocked(hop_block)
    if incremental and spec.uses_deltas:
        raise ValueError(f"IncrementalOnlineEngine keeps a plain log-mel ring and cannot serve delta-channel "
                         f"models ({model_name!r}); use the default OnlineEngine")
    kind = "streaming_trunk" if streaming_trunk else ("incremental" if incremental else "online")
    report = check_capacity(kind, num_streams, hop_block)
    if not report.ok:
        if strict_capacity:
            raise CapacityError(report.message)
        warnings.warn(report.message, CapacityWarning, stacklevel=2)

    zmuv, state_dict = _load_weights(path, reference, model_name, best)
    extra = {}
    if streaming_trunk:
        engine_cls, extra["hop_block"] = FusedStreamingOnlineEngine, hop_block
    else:
        engine_cls, extra["carry_hops"] = (IncrementalOnlineEngine if incremental else OnlineEngine), carry_hops
    engine = engine_cls(model, state_dict, cfg, frontend, zmuv.mean, zmuv.std, spec=spec, num_streams=num_streams,
                        device=device, **extra)
    return engine, ctx


def load_workspace_streaming_engine(workspace_path, model_name: Optional[str] = None, best: bool = True,
                                    device="cuda", **engine_kwargs):
    """Workspace dir -> (offline ``StreamingEngine``, InferenceContext): the
    same workspaces as :func:`load_workspace_engine`, scored a batch of
    whole clips at a time (ref howl/model/inference.py:203-248).
    ``engine_kwargs`` go to ``StreamingEngine``: ``compute_dtype``
    (``torch.bfloat16`` scores in bf16), ``frontend_precision`` (the
    frontend's grade: "auto", "f32", "bf16x3", "bf16x2", "bf16"; K1 takes
    its tensor-core or FMA kernel by ``ops.frontend_cuda.frontend_route``),
    ``fused_trunk`` (res8's fused-trunk scorer, or False for the per-window
    one), ``carry_windows``, ``use_int8_trunk`` with
    ``int8_calibration_audio`` and ``int8_route`` ("fused" or "layer")::

        engine, ctx = hub.load_workspace_streaming_engine(
            "workspaces/hey-ff", compute_dtype=torch.bfloat16, frontend_precision="bf16")
        out = engine.infer_batch(clips)  # (B, samples) -> out["detected"], (B,)

    Offline scoring has no cadence to miss, so no capacity check applies."""
    from howl_tpu_torch.inference.engine import StreamingEngine

    resolve_device(device)
    model, spec, state_dict, cfg, frontend, zmuv, ctx = _load_workspace_stack(workspace_path, model_name, best)
    engine = StreamingEngine(model, state_dict, cfg, frontend, zmuv.mean, zmuv.std, spec=spec, device=device,
                             **engine_kwargs)
    return engine, ctx


def load_pretrained(name: str, models_path=None, **kwargs):
    """Resolve a published model name against a howl-models checkout:
    ``models_path`` or ``$HOWL_MODELS_PATH``; ``kwargs`` go to
    :func:`load_workspace_engine`."""
    if name not in PRETRAINED_MODELS:
        raise ValueError(f"unknown pretrained model {name!r}; available: {sorted(PRETRAINED_MODELS)}")
    models_path = models_path or os.environ.get("HOWL_MODELS_PATH")
    if not models_path:
        raise ValueError("set HOWL_MODELS_PATH (or pass models_path) to a howl-models checkout "
                         "containing the published workspaces")
    model_name, workspace_rel = PRETRAINED_MODELS[name]
    return load_workspace_engine(Path(models_path) / workspace_rel, model_name, **kwargs)


def hey_fire_fox(**kwargs):
    """The pretrained 'hey firefox' model (ref hubconf.py:27)."""
    return load_pretrained("hey_fire_fox", **kwargs)
