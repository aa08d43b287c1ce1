"""Live serving: N streams scored one hop at a time (counterpart of
``howl_tpu/inference/online.py``).

The batched engines of ``engine.py`` score whole clips; a live client feeds
one 62.5 ms hop at a time. Each engine here keeps its state on the device
between calls and runs one step a hop: featurize, the model, a float32
softmax, inference weights, and ``detect_step`` (the scan form of the
smoothing and the sequence FSM, ``detect.py``).

``OnlineEngine`` re-featurizes the whole window every hop: its (N, 8,000)
windows go through the frontend kernel K1 ("fm" layout) into (N, 1, F, T)
features, for every model but las, which reads delta channels and is
featurized, as the JAX step does, by the plain stacked chain
(``ops/frontend.py``, ``stacked=True``, exact float32). Then the model:
``Res8.forward`` (the stem kernel K2 on (N, 41, 40) mels, the residual convs
by cuDNN), or any other family of the zoo. ``IncrementalOnlineEngine``
featurizes only the newest samples (tail + hop, ``center=False``, the plain
log-mel chain of ``ops/frontend.py``, where the JAX package runs its XLA
chain) into a ring of mel frames and scores the ring's window the same way
(K2 included for res8); it keeps no delta channels, so it refuses las, as in
JAX. A float32 engine runs each step with TF32 off whatever the caller's
global ``allow_tf32`` flags (``ops/tf32.py``); a bf16 engine leaves them as
set.

The step's tail is the JAX engines' ``_score_and_detect``: a recurrent model
is called with its carry and returns the new one, a sequential model's (T,
N, L) output is scored by its last frame's logits. ``carry_hops``
(recurrent models only: lstm, seq-lstm, gru) threads that carry from hop to
hop, so each window is scored from the previous hop's final state; by
default every hop starts from zeros, as the offline engine scores windows
and as the reference serves live. ``reset`` clears it. Every engine runs on
the card unless the caller passes ``device="cpu"``; a CUDA device that does
not exist raises.

``shard_streams(mesh)`` (``parallel.mesh.make_mesh``) splits the streams
over the mesh's devices in this one process, with no collectives: each
device holds a shard, an engine of ``num_streams / k`` streams with its own
replica of the weights and its slice of every per-stream state (the
detection rings, the recurrent carry, the incremental engine's mel ring and
audio tail, the trunk engine's caches and rings). ``push`` and ``ingest``
keep their whole-(N, hop) signature: every shard is stepped before any
result is read back, so launches on different cards overlap, and the
decisions come back as (N,) arrays in stream order. Reading a per-stream
attribute of a sharded engine (``state``, ``mel_ring``, ``last_probs``,
...) gathers the shards' on the first device; ``reset`` and assigning
``variables`` reach every shard.

Timestamps are float32 on the device; once the clock passes 2^22 ms (~70
min) the engines move it and every ring timestamp back by 2^21 ms, so the
spacing of float32 stays 0.25 ms or finer; the -1e30 empty-slot sentinel
absorbs the subtraction.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from howl_tpu_torch.inference.config import (
    EngineConfig,
    cast_compute_dtype,
    hop_geometry,
    ring_steps,
    serving_dft_precision,
)
from howl_tpu_torch.inference.detect import DetectState, apply_inference_weights, detect_step, init_state
from howl_tpu_torch.models.base import ModelSpec, model_spec, serve_in_weight_dtype
from howl_tpu_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
from howl_tpu_torch.ops.frontend_cuda import frontend_grade, log_mel_spectrogram_cuda, log_mel_spectrogram_plain
from howl_tpu_torch.ops.tf32 import exact_float32, exact_if_float32

_REBASE_AT = float(2**22)  # ms
_REBASE_DELTA = float(2**21)  # ms


def _rebase_times(state: DetectState, delta: float) -> DetectState:
    return state._replace(pred_times=state.pred_times - delta, label_times=state.label_times - delta)


def _take_streams(x, lo: int, hi: int, device, axis: int = 0):
    """Streams [lo, hi) of a per-stream state (a tensor, a tuple or
    NamedTuple or dict of them, or None) on ``device``."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.narrow(axis, lo, hi - lo).to(device).contiguous()
    if isinstance(x, dict):
        return {k: _take_streams(v, lo, hi, device, axis) for k, v in x.items()}
    parts = [_take_streams(v, lo, hi, device, axis) for v in x]
    return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)


def _gather_streams(parts: list, device, axis: int = 0):
    """The shards' per-stream states joined in stream order on ``device``."""
    first = parts[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        return torch.cat([p.to(device) for p in parts], dim=axis)
    if isinstance(first, dict):
        return {k: _gather_streams([p[k] for p in parts], device, axis) for k in first}
    joined = [_gather_streams(list(group), device, axis) for group in zip(*parts)]
    return type(first)(*joined) if hasattr(first, "_fields") else type(first)(joined)


def chain_log_mels(audio: torch.Tensor, frontend: FrontendConfig, precision) -> torch.Tensor:
    """Log-mels (B, F, T) of the plain chain a hop runs at a frontend grade:
    the chain's own float32 and "bf16" grades, and K1's plain version for
    the grades the chain lacks ("bf16x3", "bf16x2")."""
    grade = frontend_grade(precision)
    if grade in ("f32", "bf16"):
        return log_mel_spectrogram(audio, frontend, precision=None if grade == "f32" else grade)
    return log_mel_spectrogram_plain(audio, frontend, precision=grade, layout="fm")


class _HopEngine:
    """What the online engines share: the device, the weights (res8's stem
    kernel taps re-derived whenever ``variables`` is assigned), the hop
    geometry, the step's tail from the model to decisions, and the split of
    the streams over a mesh (``shard_streams``).

    A subclass names its per-stream state in ``_STREAM_STATE`` (stream axis
    0; the recurrent carry's is 1) and its clocks in ``_CLOCKS``, and
    implements ``_advance`` (one step of its own streams on its device,
    returning the step's labels and fire flags on the device)."""

    _STREAM_STATE = ("state", "carry")
    _STREAM_AXIS = {"carry": 1}  # PyTorch's recurrent carry is (layers, N, H)
    _CLOCKS = ("curr_time",)

    def __init__(self, model, variables, cfg: EngineConfig, frontend: FrontendConfig, zmuv_mean: float,
                 zmuv_std: float, spec: Optional[ModelSpec], num_streams: int, compute_dtype, dft_precision,
                 device, carry_hops: bool = False):
        self.spec = spec or model_spec(getattr(model, "registered_name", "res8"))
        if carry_hops and not self.spec.is_recurrent:
            raise ValueError(
                f"carry_hops threads RNN state across hops and applies to recurrent models only; "
                f"{self.spec.name!r} is not recurrent"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        self.carry_hops = bool(carry_hops)
        self.compute_dtype = compute_dtype
        self.cfg = cfg
        self.frontend = frontend
        self.zmuv_mean = float(zmuv_mean)
        self.zmuv_std = float(zmuv_std)
        # dft_precision follows the JAX live engines' chain, where None (and, with TF32 off, HIGH) is the exact
        # float32 grade: the same grade here, for the frontend kernel too
        if dft_precision is None or (isinstance(dft_precision, str) and dft_precision.lower() == "high"):
            dft_precision = "f32"
        self._dft_precision = serving_dft_precision(compute_dtype, dft_precision)
        self.num_streams = int(num_streams)
        self.window_frames, self.stride_frames, self.stride_ms = hop_geometry(cfg, frontend)
        self.hop_samples = self.stride_frames * frontend.hop_length
        self._s_steps, self._w_steps = ring_steps(cfg, self.stride_ms)
        self.model = copy.deepcopy(model).to(device=self.device, dtype=compute_dtype or torch.float32).eval()
        self.model.requires_grad_(False)
        serve_in_weight_dtype(self.model)  # the weights' dtype, compute_dtype, governs scoring
        for rnn in (m for m in self.model.modules() if isinstance(m, torch.nn.RNNBase)):
            rnn.flatten_parameters()  # one weight buffer for cuDNN, which would compact them at every call
        self.variables = variables

    @property
    def variables(self):
        return self._variables

    @variables.setter
    def variables(self, value):
        """Load a new state dict, rounded to the compute dtype, and for res8
        re-derive the stem kernel's taps from it; on a sharded engine, into
        every shard's replica as well."""
        self._variables = cast_compute_dtype(value, self.compute_dtype)
        self.model.load_state_dict(self._variables, strict=True)
        self._stem_taps = self.model.stem_taps(self.frontend.n_mels) if self.spec.uses_trunk else None
        for shard in self.__dict__.get("_shards") or ():
            shard.variables = value

    # ---- streams split over a mesh ----

    @property
    def shards(self) -> list:
        """The engine's shards after ``shard_streams`` (empty before)."""
        return list(self.__dict__.get("_shards") or ())

    def shard_streams(self, mesh):
        """Split the streams over ``mesh``'s devices (``parallel.mesh.Mesh``;
        a device may repeat): shard i holds streams [i * N / k, (i + 1) * N /
        k) on device i with its own replica of the weights. Returns the
        engine."""
        if self.shards:
            raise ValueError("the streams are already sharded")
        devices = mesh.device_list()
        n = len(devices)
        if self.num_streams % n:
            raise ValueError(
                f"num_streams={self.num_streams} must be divisible by the mesh's {n} devices "
                f"(mesh {dict(mesh.shape)})"
            )
        per = self.num_streams // n
        shards = []
        for i, dev in enumerate(devices):
            shard = copy.copy(self)
            shard.device = torch.device(dev)
            shard.num_streams = per
            shard.model = copy.deepcopy(self.model).to(shard.device)
            shard.variables = self._variables  # the replica's weights, and its stem taps on its device
            for name in self._STREAM_STATE:
                lo = i * per
                setattr(shard, name, _take_streams(getattr(self, name), lo, lo + per, shard.device,
                                                   self._STREAM_AXIS.get(name, 0)))
            shards.append(shard)
        for name in self._STREAM_STATE + self._CLOCKS:
            self.__dict__.pop(name, None)
        self._shards = shards
        return self

    def __getattr__(self, name):
        shards = self.__dict__.get("_shards")
        if shards and name in self._CLOCKS:
            return getattr(shards[0], name)
        if shards and name in self._STREAM_STATE:
            return _gather_streams([getattr(s, name) for s in shards], shards[0].device,
                                   self._STREAM_AXIS.get(name, 0))
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def _reset_shards(self, *per_stream) -> bool:
        """On a sharded engine, reset every shard (each ``per_stream``
        argument with N rows split by stream) and the host results; False
        on an engine that is not sharded."""
        shards = self.shards
        if not shards:
            return False
        per = self.num_streams // len(shards)
        for i, shard in enumerate(shards):
            shard.reset(*(a[i * per : (i + 1) * per] if getattr(a, "ndim", np.ndim(a)) > 1 else a
                          for a in per_stream))
        self.last_labels = None
        self.last_fired = None
        return True

    def _hop(self, audio: torch.Tensor) -> bool:
        """One step of every stream on (N, samples) audio: each shard (or
        the engine itself) advances, then the results come to the host."""
        shards = self.shards
        if not shards:
            return self._fetch(*self._advance(audio.to(self.device)))
        outs = [s._advance(part.to(s.device)) for s, part in zip(shards, audio.split(self.num_streams // len(shards)))]
        host = torch.cat([torch.stack([lab.to(torch.int32), fired.to(torch.int32)]).cpu() for lab, fired in outs],
                         dim=1).numpy()
        self.last_labels, self.last_fired = host[0], host[1].astype(bool)
        return bool(self.last_fired.any())

    def _new_state(self) -> DetectState:
        return init_state(self.num_streams, self.cfg.num_labels, self._s_steps, self._w_steps, self.device)

    def _as_audio(self, audio) -> torch.Tensor:
        """(samples,) or (N, samples) audio -> float32 (N, samples), on the
        device unless the engine is sharded (each shard moves its part)."""
        audio = torch.as_tensor(audio, dtype=torch.float32)
        if not self.shards:
            audio = audio.to(self.device)
        return audio[None] if audio.ndim == 1 else audio

    def _maybe_rebase(self) -> None:
        if self.curr_time >= _REBASE_AT:
            self.state = _rebase_times(self.state, _REBASE_DELTA)
            self.curr_time -= _REBASE_DELTA

    def _decide(self, logits: torch.Tensor, state: DetectState, t_now, valid):
        """Logits (..., L) -> their float32 softmax (see ``_decide_probs``)."""
        return self._decide_probs(torch.softmax(logits.float(), -1), state, t_now, valid)

    def _decide_probs(self, probs: torch.Tensor, state: DetectState, t_now, valid):
        """Posteriors (N, L) -> (state, label, fired_now, weighted
        posteriors): the inference weights, one ``detect_step``."""
        probs = apply_inference_weights(probs, self.cfg)
        state, label, fired_now = detect_step(state, probs, t_now, valid, self.cfg, check_offset_ms=self.stride_ms)
        return state, label, fired_now, probs

    def _score_and_detect(self, feats: torch.Tensor, state: DetectState, t_now, carry=None):
        """(N, C, F, T) features in the compute dtype -> the model ->
        ``_decide``; every stream produced a frame. A recurrent model is
        called with ``carry`` and returns its new one; a sequential model's
        (T, N, L) output is scored by its last frame's logits. Returns
        (state, label, fired_now, probs, new carry)."""
        if self._stem_taps is not None:
            out = self.model(feats, self._stem_taps)
        elif self.spec.is_recurrent:
            out, carry = self.model(feats, carry=carry, return_carry=True)
        else:
            out = self.model(feats)
        if out.ndim == 3:  # a sequential model: the last frame's logits
            out = out[-1]
        return (*self._decide(out, state, t_now, True), carry)

    def _keep_carry(self, carry) -> None:
        """Thread a recurrent model's state to the next hop when
        ``carry_hops`` is set; otherwise every hop starts from zeros."""
        if self.carry_hops:
            self.carry = carry

    def _fetch(self, label: torch.Tensor, fired: torch.Tensor) -> bool:
        """The step's labels and fire flags to the host in one copy, as
        ``last_labels`` and ``last_fired``; True if any stream fired."""
        host = torch.stack([label.to(torch.int32), fired.to(torch.int32)]).cpu().numpy()
        self.last_labels, self.last_fired = host[0], host[1].astype(bool)
        return bool(self.last_fired.any())


class OnlineEngine(_HopEngine):
    """N parallel streams, each scored on its whole current window every hop."""

    def __init__(
        self,
        model,
        variables,
        cfg: EngineConfig,
        frontend: FrontendConfig,
        zmuv_mean: float = 0.0,
        zmuv_std: float = 1.0,
        spec: Optional[ModelSpec] = None,
        num_streams: int = 1,
        compute_dtype=None,
        dft_precision="auto",
        carry_hops: bool = False,
        device="cuda",
    ):
        """``model`` gives the architecture (any model of the zoo; ``spec``
        defaults to its registry entry); the engine keeps its own copy on
        ``device`` and loads ``variables``, its state dict.
        ``compute_dtype=torch.bfloat16`` scores in bf16 (the frontend at the
        "bf16" grade unless ``dft_precision`` names another); the
        posteriors and the decisions stay float32. ``carry_hops`` (recurrent
        models only) threads the model's state from hop to hop."""
        super().__init__(model, variables, cfg, frontend, zmuv_mean, zmuv_std, spec, num_streams, compute_dtype,
                         dft_precision, device, carry_hops)
        self.window_samples = int(cfg.max_window_size_ms / 1000 * cfg.sample_rate)
        self.reset()

    def reset(self):
        """Clear the histories."""
        if self._reset_shards():
            return
        self.state = self._new_state()
        self.carry = None
        self.curr_time = 0.0
        self.last_labels = None
        self.last_fired = None

    def _features(self, audio: torch.Tensor) -> torch.Tensor:
        """(N, window_samples) -> (N, C, F, T) ZMUV'd features in the compute
        dtype: the frontend kernel K1's log-mels on a card, C = 1; for a
        model that reads deltas (las) the plain stacked chain in exact
        float32, C = 3."""
        if self.spec.uses_deltas:
            with exact_float32():
                feats = log_mel_spectrogram(audio, self.frontend, stacked=True)
            return ((feats - self.zmuv_mean) / self.zmuv_std).to(self.compute_dtype or torch.float32)
        return log_mel_spectrogram_cuda(
            audio, self.frontend, self.zmuv_mean, self.zmuv_std, precision=self._dft_precision,
            out_dtype=self.compute_dtype or torch.float32, layout="fm",
        )[:, None]

    @torch.no_grad()
    @exact_if_float32
    def _step(self, audio: torch.Tensor, state: DetectState, t_now, carry=None):
        """One hop on (N, window_samples) device audio: (state, label,
        fired_now, probs, new carry)."""
        return self._score_and_detect(self._features(audio), state, t_now, carry)

    def ingest(self, window_audio) -> bool:
        """Feed the current window of every stream; True if the wakeword
        fired now. ``window_audio``: (window_samples,) or (num_streams,
        window_samples) float32 in [-1, 1]; shorter windows are zero-padded
        on the left, as a filling ring buffer presents its content."""
        audio = self._as_audio(window_audio)
        if audio.shape[0] != self.num_streams:
            raise ValueError(
                f"ingest expects {self.num_streams} stream(s), got {audio.shape[0]} "
                "(a mismatched count would silently broadcast into every stream's state)"
            )
        if audio.shape[-1] < self.window_samples:
            audio = torch.nn.functional.pad(audio, (self.window_samples - audio.shape[-1], 0))
        return self._hop(audio[:, -self.window_samples :].contiguous())

    def _advance(self, audio: torch.Tensor):
        self._maybe_rebase()
        self.state, label, fired_now, _, carry = self._step(audio, self.state, self.curr_time, self.carry)
        self._keep_carry(carry)
        self.curr_time += self.stride_ms
        return label, fired_now

    def infer(self, window_audio) -> bool:
        """Reference-API-shaped alias for ``ingest``."""
        return self.ingest(window_audio)


class IncrementalOnlineEngine(_HopEngine):
    """N streams that featurize only each hop's new audio.

    The engine keeps a ring of log-mel frames per stream, computes the
    ``stride_frames`` new frames from the hop's samples and a short audio
    tail, and scores the ring's window. The tail length puts the stream's
    frames on the centered-frame grid of the batched engines' clip-level
    features (``tail = n_fft/2 (mod hop)``, ``n_fft - hop <= tail <
    n_fft``): once the startup frames roll out of the ring, the ring equals
    ``log_mel_spectrogram(stream, center=True)``'s frames. The newest scored
    frame ends ``tail + hop - n_fft`` samples behind the stream head (144
    samples at the defaults).
    """

    _STREAM_STATE = _HopEngine._STREAM_STATE + ("mel_ring", "tail")

    def __init__(
        self,
        model,
        variables,
        cfg: EngineConfig,
        frontend: FrontendConfig,
        zmuv_mean: float = 0.0,
        zmuv_std: float = 1.0,
        spec: Optional[ModelSpec] = None,
        num_streams: int = 1,
        compute_dtype=None,
        dft_precision="auto",
        carry_hops: bool = False,
        device="cuda",
    ):
        super().__init__(model, variables, cfg, frontend, zmuv_mean, zmuv_std, spec, num_streams, compute_dtype,
                         dft_precision, device, carry_hops)
        if self.spec.uses_deltas:
            raise ValueError(
                "IncrementalOnlineEngine keeps a plain log-mel ring and cannot serve "
                "delta-channel models (las); use OnlineEngine for those"
            )
        hop, n_fft = frontend.hop_length, frontend.n_fft
        # the smallest tail in [n_fft - hop, n_fft) with tail = n_fft // 2 (mod hop)
        base = n_fft - hop
        self.tail_samples = base + ((n_fft // 2 - base) % hop)
        self._frontend_nc = dataclasses.replace(frontend, center=False)
        self.reset()

    def reset(self):
        """Featurized silence in the ring (the ZMUV'd log of the offset, what
        a zeroed audio ring would featurize to), a zero tail, empty histories."""
        if self._reset_shards():
            return
        n, f, w = self.num_streams, self.frontend.n_mels, self.window_frames
        silence = (float(np.log(self.frontend.log_offset)) - self.zmuv_mean) / self.zmuv_std
        self.mel_ring = torch.full((n, f, w), silence, dtype=torch.float32, device=self.device)
        self.tail = torch.zeros((n, self.tail_samples), dtype=torch.float32, device=self.device)
        self.state = self._new_state()
        self.carry = None
        self.curr_time = 0.0
        self.last_labels = None
        self.last_fired = None

    @torch.no_grad()
    @exact_if_float32
    def _step(self, new_audio: torch.Tensor, tail: torch.Tensor, ring: torch.Tensor, state: DetectState, t_now,
              carry=None):
        """One hop on (N, hop_samples) device audio: (tail, ring, state,
        label, fired_now, new carry)."""
        buf = torch.cat([tail, new_audio], dim=-1)
        mels = chain_log_mels(buf, self._frontend_nc, self._dft_precision)
        mels = (mels - self.zmuv_mean) / self.zmuv_std  # (N, F, stride_frames)
        ring = torch.cat([ring[..., self.stride_frames :], mels], dim=-1)  # oldest -> newest
        feats = ring[:, None].to(self.compute_dtype or torch.float32)
        state, label, fired_now, _, carry = self._score_and_detect(feats, state, t_now, carry)
        return buf[:, -self.tail_samples :], ring, state, label, fired_now, carry

    def push(self, new_audio) -> bool:
        """Feed every stream's newest ``hop_samples`` samples; True if the
        wakeword fired this step. ``new_audio``: (hop_samples,) or
        (num_streams, hop_samples) float32."""
        audio = self._as_audio(new_audio)
        if tuple(audio.shape) != (self.num_streams, self.hop_samples):
            raise ValueError(f"push expects {(self.num_streams, self.hop_samples)}, got {tuple(audio.shape)}")
        return self._hop(audio)

    def _advance(self, audio: torch.Tensor):
        self._maybe_rebase()
        self.tail, self.mel_ring, self.state, label, fired_now, carry = self._step(
            audio, self.tail, self.mel_ring, self.state, self.curr_time, self.carry
        )
        self._keep_carry(carry)
        self.curr_time += self.stride_ms
        return label, fired_now
