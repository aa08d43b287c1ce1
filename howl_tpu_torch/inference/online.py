"""Live serving: N streams scored one hop at a time (counterpart of
``howl_tpu/inference/online.py``).

The batched engines of ``engine.py`` score whole clips; a live client feeds
one 62.5 ms hop at a time. Each engine here keeps its state on the device
between calls and runs one step a hop: featurize, res8, a float32 softmax,
inference weights, and ``detect_step`` (the scan form of the smoothing and
the sequence FSM, ``detect.py``).

``OnlineEngine`` re-featurizes the whole window every hop: its (N, 8,000)
windows go through the frontend kernel K1 ("fm" layout), then
``Res8.forward`` (the stem kernel K2 on (N, 41, 40) mels, the residual convs
by cuDNN). ``IncrementalOnlineEngine`` featurizes only the newest samples
(tail + hop, ``center=False``, the plain log-mel chain of
``ops/frontend.py``, where the JAX package runs its XLA chain) into a ring of
mel frames and scores the ring's window the same way (K2 included).

Only res8 is ported; other models, ``carry_hops`` (recurrent models) and
``shard_streams`` (a mesh of cards) raise and cite their ROADMAP items. Every
engine runs on the card unless the caller passes ``device="cpu"``; a CUDA
device that does not exist raises.

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
from howl_tpu_torch.inference.engine import _not_ported
from howl_tpu_torch.models.base import ModelSpec, model_spec
from howl_tpu_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
from howl_tpu_torch.ops.frontend_cuda import frontend_grade, log_mel_spectrogram_cuda

_REBASE_AT = float(2**22)  # ms
_REBASE_DELTA = float(2**21)  # ms


def _rebase_times(state: DetectState, delta: float) -> DetectState:
    return state._replace(pred_times=state.pred_times - delta, label_times=state.label_times - delta)


def chain_precision(precision):
    """A frontend precision as the plain log-mel chain takes it: None for
    the float32 grade, else the name of the grade."""
    return None if frontend_grade(precision) == "f32" else precision


class _HopEngine:
    """What the online engines share: the device, the weights (the stem
    kernel's taps re-derived whenever ``variables`` is assigned), the hop
    geometry, and the step's tail from logits to decisions."""

    def __init__(self, model, variables, cfg: EngineConfig, frontend: FrontendConfig, zmuv_mean: float,
                 zmuv_std: float, spec: Optional[ModelSpec], num_streams: int, compute_dtype, dft_precision,
                 device, carry_hops: bool = False):
        self.spec = spec or model_spec(getattr(model, "registered_name", "res8"))
        if not self.spec.supports_trunk:
            raise _not_ported(f"online serving of model {self.spec.name!r}", "item 8 (the non-res8 scorers)")
        if carry_hops and not self.spec.is_recurrent:
            raise ValueError(
                f"carry_hops threads RNN state across hops and applies to recurrent models only; "
                f"{self.spec.name!r} is not recurrent (the recurrent models are ROADMAP Queue 1, item 8)"
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
        self.model.dtype = None  # the weights' dtype, compute_dtype, governs scoring
        self.variables = variables

    @property
    def variables(self):
        return self._variables

    @variables.setter
    def variables(self, value):
        """Load a new res8 state dict, rounded to the compute dtype, and
        re-derive the stem kernel's taps from it."""
        self._variables = cast_compute_dtype(value, self.compute_dtype)
        self.model.load_state_dict(self._variables, strict=True)
        self._stem_taps = self.model.stem_taps(self.frontend.n_mels)

    def shard_streams(self, mesh):
        raise _not_ported("shard_streams (the streams split over a mesh of cards)", "item 12")

    def _new_state(self) -> DetectState:
        return init_state(self.num_streams, self.cfg.num_labels, self._s_steps, self._w_steps, self.device)

    def _as_audio(self, audio) -> torch.Tensor:
        """(samples,) or (N, samples) audio -> float32 (N, samples) on the device."""
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
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

    def _score_and_detect(self, feats: torch.Tensor, state: DetectState, t_now):
        """(N, 1, F, T) features in the compute dtype -> res8 -> ``_decide``;
        every stream produced a frame."""
        return self._decide(self.model(feats, self._stem_taps), state, t_now, True)

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
        """``model`` gives the architecture (a ``Res8``); the engine keeps its
        own copy on ``device`` and loads ``variables``, a res8 state dict.
        ``compute_dtype=torch.bfloat16`` scores in bf16 (the frontend at the
        "bf16" grade unless ``dft_precision`` names another); the
        posteriors and the decisions stay float32."""
        super().__init__(model, variables, cfg, frontend, zmuv_mean, zmuv_std, spec, num_streams, compute_dtype,
                         dft_precision, device, carry_hops)
        self.window_samples = int(cfg.max_window_size_ms / 1000 * cfg.sample_rate)
        self.reset()

    def reset(self):
        """Clear the histories."""
        self.state = self._new_state()
        self.carry = None
        self.curr_time = 0.0
        self.last_labels = None
        self.last_fired = None

    def _features(self, audio: torch.Tensor) -> torch.Tensor:
        """(N, window_samples) -> (N, F, T) ZMUV'd log-mels in the compute
        dtype: the frontend kernel K1 on a card."""
        return log_mel_spectrogram_cuda(
            audio, self.frontend, self.zmuv_mean, self.zmuv_std, precision=self._dft_precision,
            out_dtype=self.compute_dtype or torch.float32, layout="fm",
        )

    @torch.no_grad()
    def _step(self, audio: torch.Tensor, state: DetectState, t_now):
        """One hop on (N, window_samples) device audio: (state, label,
        fired_now, probs)."""
        return self._score_and_detect(self._features(audio)[:, None], state, t_now)

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
        audio = audio[:, -self.window_samples :].contiguous()
        self._maybe_rebase()
        self.state, label, fired_now, _ = self._step(audio, self.state, self.curr_time)
        self.curr_time += self.stride_ms
        return self._fetch(label, fired_now)

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
        hop, n_fft = frontend.hop_length, frontend.n_fft
        # the smallest tail in [n_fft - hop, n_fft) with tail = n_fft // 2 (mod hop)
        base = n_fft - hop
        self.tail_samples = base + ((n_fft // 2 - base) % hop)
        self._frontend_nc = dataclasses.replace(frontend, center=False)
        self.reset()

    def reset(self):
        """Featurized silence in the ring (the ZMUV'd log of the offset, what
        a zeroed audio ring would featurize to), a zero tail, empty histories."""
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
    def _step(self, new_audio: torch.Tensor, tail: torch.Tensor, ring: torch.Tensor, state: DetectState, t_now):
        """One hop on (N, hop_samples) device audio: (tail, ring, state,
        label, fired_now)."""
        buf = torch.cat([tail, new_audio], dim=-1)
        mels = log_mel_spectrogram(buf, self._frontend_nc, precision=chain_precision(self._dft_precision))
        mels = (mels - self.zmuv_mean) / self.zmuv_std  # (N, F, stride_frames)
        ring = torch.cat([ring[..., self.stride_frames :], mels], dim=-1)  # oldest -> newest
        feats = ring[:, None].to(self.compute_dtype or torch.float32)
        state, label, fired_now, _ = self._score_and_detect(feats, state, t_now)
        return buf[:, -self.tail_samples :], ring, state, label, fired_now

    def push(self, new_audio) -> bool:
        """Feed every stream's newest ``hop_samples`` samples; True if the
        wakeword fired this step. ``new_audio``: (hop_samples,) or
        (num_streams, hop_samples) float32."""
        audio = self._as_audio(new_audio)
        if tuple(audio.shape) != (self.num_streams, self.hop_samples):
            raise ValueError(f"push expects {(self.num_streams, self.hop_samples)}, got {tuple(audio.shape)}")
        self._maybe_rebase()
        self.tail, self.mel_ring, self.state, label, fired_now = self._step(
            audio, self.tail, self.mel_ring, self.state, self.curr_time
        )
        self.curr_time += self.stride_ms
        return self._fetch(label, fired_now)
