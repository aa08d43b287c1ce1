"""Batched offline wake-word scoring (counterpart of
``howl_tpu/inference/engine.py``'s ``StreamingEngine``, fused-trunk res8).

A batch of clips is scored in five stages, each over the whole batch:

  1. audio -> ZMUV'd time-major log-mels: ``ops/frontend_cuda.py`` (kernel);
  2. res8 stem, conv0 + ReLU + AvgPool(3, 4): ``ops/stem_cuda.py`` (kernel);
  3. the six residual convs with affine-less BatchNorm (``F.conv2d``);
  4. the frequency mean of the trunk output, then cumsum window pooling over
     time into the dense head and softmax, in float32;
  5. smoothing and the sequence FSM (``inference/detect.py``).

The trunk runs once over each whole clip and every sliding window's logits
come from window means of its output, as in the JAX package. On a CUDA
device stages 1 and 2 always launch the hand-written kernels; on the CPU the
same functions run their plain PyTorch versions.

Deviations from the reference that the JAX package documents hold here too:
windows are cut from clip-level mel frames, and the window stride is
quantized to whole hops.
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
    serving_dft_precision,
)
from howl_tpu_torch.inference.detect import (
    _ring_geometry,
    _smooth_and_detect_parallel,
    apply_inference_weights,
    smooth_and_detect,
)
from howl_tpu_torch.models.base import ModelSpec, model_spec
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP Queue 1, {item})")


class StreamingEngine:
    """Sliding-window scoring + smoothing + FSM over batches of clips."""

    def __init__(
        self,
        model: torch.nn.Module,
        variables,
        cfg: EngineConfig,
        frontend: FrontendConfig,
        zmuv_mean: float = 0.0,
        zmuv_std: float = 1.0,
        spec: Optional[ModelSpec] = None,
        compute_dtype: Optional[torch.dtype] = None,
        fused_trunk: Optional[bool] = None,
        frontend_precision="bf16",
        carry_windows: bool = False,
        use_int8_trunk: bool = False,
        device="cpu",
    ):
        """``model`` gives the architecture (a ``Res8``); the engine keeps its
        own copy on ``device`` and loads ``variables``, a res8 state dict
        (``compat.res8_variables_to_state_dict`` makes one from JAX
        variables), into it.

        ``compute_dtype=torch.bfloat16`` rounds every float32 weight to bf16
        and scores in bf16; the head, the posteriors and the decision logic
        stay float32. The frontend runs at ``frontend_precision`` ("bf16" by
        default, the JAX engine's ``pallas_precision``; "auto" picks float32
        for float32 serving and "bf16" for bf16) and writes its mels in the
        compute dtype.

        ``device`` is where the engine runs; a CUDA device that does not
        exist raises, it never falls back to the CPU.
        """
        self.spec = spec or model_spec(getattr(model, "registered_name", "res8"))
        if not self.spec.supports_trunk:
            raise _not_ported(f"scoring model {self.spec.name!r}", "item 8 (non-trunk scorers)")
        if fused_trunk is not None and not fused_trunk:
            raise _not_ported("fused_trunk=False (the per-window mega-batch scorer)", "item 8")
        if carry_windows:
            raise _not_ported("carry_windows (recurrent window carry)", "item 8")
        if use_int8_trunk:
            raise _not_ported("use_int8_trunk (the int8 residual stack)", "item 10")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        self.compute_dtype = compute_dtype
        self.cfg = cfg
        self.frontend = frontend
        self.zmuv_mean = float(zmuv_mean)
        self.zmuv_std = float(zmuv_std)
        self.frontend_precision = serving_dft_precision(compute_dtype, frontend_precision)
        self.window_frames, self.stride_frames, self.stride_ms = hop_geometry(cfg, frontend)
        # a window is valid only with all window_samples real samples, as the
        # reference strides with drop_incomplete=True
        self.window_samples = int(cfg.max_window_size_ms / 1000 * cfg.sample_rate)
        self.model = copy.deepcopy(model).to(device=self.device, dtype=compute_dtype or torch.float32).eval()
        self.variables = variables
        self._geom_cache: dict = {}

    # ---- weights: the stem taps follow variables reassignment ----

    @property
    def variables(self):
        return self._variables

    @variables.setter
    def variables(self, value):
        """Load a new state dict, rounded to the compute dtype, and re-derive
        the stem kernel's taps from it, so a new checkpoint never serves with
        stale taps. Eager PyTorch bakes nothing else."""
        self._variables = cast_compute_dtype(value, self.compute_dtype)
        self.model.load_state_dict(self._variables, strict=True)
        self._stem_taps = self.model.stem_taps(self.frontend.n_mels)

    # ---- scoring ----

    def _pooled_stem(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, samples) audio -> (B, T', F', maps) pooled stem activations:
        the frontend in time-major layout straight into the stem."""
        mel_tm = log_mel_spectrogram_cuda(
            audio, self.frontend, self.zmuv_mean, self.zmuv_std,
            precision=self.frontend_precision, out_dtype=self.compute_dtype or torch.float32,
            layout="tm",
        )
        return res8_stem_cuda(mel_tm, self._stem_taps, self.model.pooling)

    @torch.no_grad()
    def _score(self, audio: torch.Tensor, n_windows: int) -> torch.Tensor:
        """(B, samples) -> (B, n_windows, L) posteriors."""
        pool_t = self.model.pooling[0]
        span = max(self.window_frames // pool_t, 1)
        trunk = self.model.residual_features(self._pooled_stem(audio))
        # float32 before the cumsum: bf16 running sums over long clips would
        # leak precision into every window mean
        tf = trunk.float().mean(dim=2)  # (B, T', maps)
        tp = tf.shape[1]
        eff = min(span, tp)
        csum = torch.cat([torch.zeros_like(tf[:, :1]), torch.cumsum(tf, dim=1)], dim=1)
        starts = np.clip(
            np.round(np.arange(n_windows) * self.stride_frames / pool_t).astype(np.int32), 0, tp - eff
        )
        starts = torch.from_numpy(starts.astype(np.int64)).to(tf.device)
        wmean = (csum[:, starts + eff] - csum[:, starts]) / eff  # (B, n_windows, maps)
        return torch.softmax(self.model.head(wmean), dim=-1)

    def n_windows(self, num_samples: int) -> int:
        total_frames = self.frontend.num_frames(num_samples)
        return max((total_frames - self.window_frames) // self.stride_frames + 1, 1)

    def _as_audio(self, audio) -> torch.Tensor:
        return torch.as_tensor(audio, dtype=torch.float32).to(self.device).contiguous()

    def _as_lengths(self, lengths, batch: int, num_samples: int) -> torch.Tensor:
        if lengths is None:
            return torch.full((batch,), num_samples, dtype=torch.long, device=self.device)
        return torch.as_tensor(lengths).to(device=self.device, dtype=torch.long)

    def _pad_short_clips(self, audio: torch.Tensor, lengths):
        """Right-pad clips shorter than one window with silence. The returned
        true lengths keep the full-window validity rule: a clip shorter than
        one window yields no scored windows and can never fire."""
        num = audio.shape[-1]
        min_samples = (self.window_frames - 1) * self.frontend.hop_length
        if num >= min_samples:
            return audio, lengths
        if lengths is None:
            lengths = torch.full((audio.shape[0],), num, dtype=torch.long, device=audio.device)
        return torch.nn.functional.pad(audio, (0, min_samples - num)), lengths

    def _step_geometry(self, batch: int, num_samples: int) -> dict:
        """Host-side step timing + ring geometry for one clip shape (cached)."""
        key = (batch, num_samples)
        geom = self._geom_cache.get(key)
        if geom is not None:
            return geom
        n_win = self.n_windows(num_samples)
        times = np.arange(n_win) * self.stride_ms
        _, s_steps, w_steps, stride, check_offset = _ring_geometry(times, self.cfg, True)
        geom = {
            "n_win": n_win,
            "times": times.astype(np.float32),
            "stride": stride,
            "check_offset": check_offset,
            "s_steps": s_steps,
            "w_steps": w_steps,
        }
        self._geom_cache[key] = geom
        return geom

    def _valid_mask(self, lengths: torch.Tensor, t_steps: int) -> torch.Tensor:
        """(B, T) validity: window i is valid only when it is full."""
        win_start = torch.arange(t_steps, device=lengths.device)[None, :] * (
            self.stride_frames * self.frontend.hop_length
        )
        return (lengths[:, None] - win_start) >= self.window_samples

    def _score_weight_mask(self, audio, lengths, n_windows):
        """Posteriors with inference weights applied, and the validity mask."""
        probs = apply_inference_weights(self._score(audio, n_windows), self.cfg)
        return probs, self._valid_mask(lengths, probs.shape[1])

    # ---- public API ----

    def score_batch(self, audio, lengths=None) -> dict:
        """Model scoring only: posteriors + step timing + validity."""
        audio, lengths = self._pad_short_clips(self._as_audio(audio), lengths)
        batch, num_samples = audio.shape
        probs = apply_inference_weights(self._score(audio, self.n_windows(num_samples)), self.cfg)
        t_steps = probs.shape[1]
        if lengths is None:
            valid = torch.ones((batch, t_steps), dtype=torch.bool, device=self.device)
        else:
            valid = self._valid_mask(self._as_lengths(lengths, batch, num_samples), t_steps)
        return {
            "probs": probs,
            "times_ms": np.arange(t_steps) * self.stride_ms,
            "valid": valid,
            "check_offset_is_stride": True,
        }

    def detect_from_scores(self, scores: dict, threshold: Optional[float] = None) -> dict:
        """Smoothing + FSM over cached posteriors, optionally at an overridden
        detection threshold (for sweeps)."""
        cfg = self.cfg
        if threshold is not None:
            cfg = dataclasses.replace(cfg, inference_threshold=float(threshold))
        result = smooth_and_detect(
            scores["probs"], scores["times_ms"], scores["valid"], cfg, scores["check_offset_is_stride"]
        )
        result["times_ms"] = scores["times_ms"]
        result["probs"] = scores["probs"]
        return result

    def infer_batch(self, audio, lengths=None, threshold: Optional[float] = None) -> dict:
        """Score B clips; returns detected (B,), first fire step, per-step
        labels and fire mask, and the posteriors.

        audio: (B, samples) float32 at cfg.sample_rate. lengths: optional true
        sample counts; windows past them are masked out of the decisions.
        """
        audio, lengths = self._pad_short_clips(self._as_audio(audio), lengths)
        batch, num_samples = audio.shape
        geom = self._step_geometry(batch, num_samples)
        lengths = self._as_lengths(lengths, batch, num_samples)
        thr = self.cfg.inference_threshold if threshold is None else float(threshold)
        probs, valid = self._score_weight_mask(audio, lengths, geom["n_win"])
        static_cfg = dataclasses.replace(self.cfg, inference_threshold=0.0)
        out = _smooth_and_detect_parallel(
            probs, valid, thr, static_cfg,
            geom["s_steps"], geom["w_steps"], geom["stride"], geom["check_offset"],
        )
        out["probs"] = probs
        out["times_ms"] = geom["times"]
        return out

    def infer(self, audio) -> bool:
        """Single-clip convenience: True when the clip fires."""
        out = self.infer_batch(self._as_audio(audio)[None, :])
        return bool(out["detected"][0])

    def infer_sweep_batch(self, audio, lengths=None, thresholds=()):
        raise _not_ported("infer_sweep_batch (threshold sweeps)", "item 4")

    def detect_sweep_from_scores(self, scores: dict, thresholds):
        raise _not_ported("detect_sweep_from_scores (threshold sweeps)", "item 4")


class WholeClipEngine(StreamingEngine):
    """The whole-clip engine of sequential models; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("WholeClipEngine (sequential models)", "item 4")
