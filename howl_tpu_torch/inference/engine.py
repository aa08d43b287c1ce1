"""Batched offline wake-word scoring (counterpart of
``howl_tpu/inference/engine.py``'s ``StreamingEngine`` and
``WholeClipEngine``), for every model of the zoo.

A batch of res8 clips is scored in five stages, each over the whole batch,
by the fused-trunk scorer (res8's default):

  1. audio -> ZMUV'd time-major log-mels: ``ops/frontend_cuda.py`` (kernel:
     on the tensor cores wherever ``frontend_route`` finds the geometry
     served, the serving geometry for every grade, the float32 engine's
     exact grade as six bf16 passes; float32 FMA elsewhere);
  2. res8 stem, conv0 + ReLU + AvgPool(3, 4): ``ops/stem_cuda.py`` (kernel);
  3. the six residual convs with affine-less BatchNorm (``F.conv2d``), or
     with ``use_int8_trunk`` the int8 residual trunk (``ops/int8_trunk.py``:
     on a card one launch of the fused s8 x s8 -> s32 trunk kernel at the
     serving geometry, else six of the layer kernel);
  4. the frequency mean of the trunk output, then cumsum window pooling over
     time into the dense head and softmax, in float32;
  5. smoothing and the sequence FSM (``inference/detect.py``).

The trunk runs once over each whole clip and every sliding window's logits
come from window means of its output, as in the JAX package.

The other scorers featurize the whole batch once into (B, C, F, T): the
frontend kernel writes feature-major mels (B, 1, F, T) for every model but
las, which reads delta and accel channels and featurizes, as the JAX engine
does, through the plain stacked chain (``ops/frontend.py``,
``stacked=True``, float32 products with TF32 off). Then:

  * the per-window mega-batch, for static models, for recurrent ones by
    default and for res8 with ``fused_trunk=False``: every 41-frame window is
    gathered at the window stride and the (B * n_windows, C, F, 41) windows
    go through the model as one batch (res8's stem on its kernel), in
    chunks of ``WINDOW_CHUNK`` windows for the models without a trunk, each
    window scored alone from a zero recurrent state;
  * ``carry_windows`` (recurrent models only, as in the JAX engine): the
    recurrent state threaded across a clip's windows in time order, one
    window of every clip a call;
  * sequential models (seq-lstm, seq-cnn): per-frame logits over the whole
    clip in one pass, each frame a step of the detector, whose
    ``blank_label`` frames are skipped (``WholeClipEngine``).

The logits go into a float32 softmax, and stage 5 is shared.

On a CUDA device the frontend, the stem and the int8 trunk always launch the
hand-written kernels; on the CPU the same functions run their plain PyTorch
versions. Convolutions, recurrences and dense layers are PyTorch's, as XLA
lowers them in the JAX package.

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
    _smooth_and_detect_sweep,
    apply_inference_weights,
    smooth_and_detect,
    smooth_and_detect_sweep,
)
from howl_tpu_torch.models.base import ModelSpec, model_spec
from howl_tpu_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
from howl_tpu_torch.ops.int8_trunk import ROUTES as INT8_ROUTES
from howl_tpu_torch.ops.int8_trunk import calibrate_act_scales, quantize_residual_trunk, residual_features_int8
from howl_tpu_torch.ops.stem_cuda import fold_stem_weights, res8_stem_cuda
from howl_tpu_torch.ops.tf32 import exact_float32, exact_if_float32

# windows a model without a trunk scores a call in the per-window mega-batch (MobileNet's widest activation is
# 96 x 11 x 20 values a window: 0.7 GB a chunk in bf16)
WINDOW_CHUNK = 16384


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
        frontend_precision="auto",
        carry_windows: bool = False,
        use_int8_trunk: bool = False,
        int8_calibration_audio=None,
        int8_route: Optional[str] = None,
        device="cuda",
    ):
        """``model`` gives the architecture, any model of the zoo; the engine
        keeps its own copy on ``device`` and loads ``variables``, the
        model's state dict (``compat.variables_to_state_dict`` makes one from
        JAX variables), into it. ``spec`` defaults to the registry's entry
        for the model's registered name.

        ``compute_dtype=torch.bfloat16`` rounds every float32 weight to bf16
        and scores in bf16; the head, the posteriors and the decision logic
        stay float32. A float32 engine scores with TF32 off, whatever the
        caller's global ``allow_tf32`` flags (``ops/tf32.py``). The frontend
        runs at ``frontend_precision``: "auto" (the default, as the JAX
        engine's ``dft_precision``) serves the exact "f32" grade for float32
        scoring and the 1-pass "bf16" grade for bf16; any grade
        ``ops.frontend_cuda.frontend_grade`` knows can be named. It writes its
        mels in the compute dtype.

        ``fused_trunk`` (None: the fused-trunk scorer for a model with a
        trunk, res8, and the model's own scorer for the others; False: the
        per-window mega-batch scorer) picks the scorer; see the module's
        docstring. ``carry_windows`` threads a recurrent model's state
        across each clip's windows; the engine reads it for recurrent models
        only, as the JAX engine does.

        ``use_int8_trunk`` (fused-trunk scorer only) runs the six residual
        convolutions in s8 x s8 -> s32 (``ops/int8_trunk.py``) with static
        per-layer activation scales calibrated from
        ``int8_calibration_audio``, a (B, samples) float32 array of
        representative audio, which it requires. Calibration and weight
        quantization read the float32 weights as given, not their
        compute-dtype copy: the calibration stem (the frontend at the exact
        "f32" grade, the stem in float32) and the float32 residual reference
        run with TF32 off, so a bf16 engine quantizes the same weights as a
        float32 one. Assigning ``variables`` quantizes again. Validate
        decisions per deployment (``howl_tpu_torch.tools.validate_tpu_decisions``).
        ``int8_route`` names the int8 trunk's kernel on a card ("fused": the
        six layers in one launch; "layer": six launches); None takes
        ``ops.int8_trunk.int8_trunk_route``'s, the fused kernel at the
        serving geometry.

        ``device`` is where the engine runs: the card unless the caller
        passes ``"cpu"``. A CUDA device that does not exist raises; the
        engine never falls back to the CPU.
        """
        self.spec = spec or model_spec(getattr(model, "registered_name", "res8"))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        self.compute_dtype = compute_dtype
        self.fused_trunk = self.spec.supports_trunk if fused_trunk is None else bool(fused_trunk)
        if self.fused_trunk and not self.spec.supports_trunk:
            raise ValueError(f"fused_trunk needs a model with a trunk (res8); {self.spec.name!r} has none")
        self.carry_windows = bool(carry_windows)
        if use_int8_trunk and not self.fused_trunk:
            # never silently serve something other than what was asked for
            raise ValueError(
                "use_int8_trunk applies to the fused-trunk scorer only (trunk-capable model + fused_trunk enabled); "
                f"got fused_trunk={self.fused_trunk}, model={self.spec.name!r} "
                f"(supports_trunk={self.spec.supports_trunk})"
            )
        if int8_route not in (None, *INT8_ROUTES):
            raise ValueError(f"int8_route must be one of {INT8_ROUTES} or None, got {int8_route!r}")
        if use_int8_trunk and int8_calibration_audio is None:
            raise ValueError(
                "use_int8_trunk requires int8_calibration_audio: a (B, samples) f32 array of representative audio "
                "for static activation-scale calibration (ops/int8_trunk.py)"
            )
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
        self.model.dtype = None  # the weights' dtype, compute_dtype, governs scoring
        for rnn in (m for m in self.model.modules() if isinstance(m, torch.nn.RNNBase)):
            rnn.flatten_parameters()  # one weight buffer for cuDNN, which would compact them at every call
        self._int8_params = None
        self._int8_cal = None
        self.int8_route = int8_route
        if use_int8_trunk:
            self._int8_cal = torch.as_tensor(int8_calibration_audio, dtype=torch.float32).to(self.device)
        self.variables = variables
        self._geom_cache: dict = {}

    # ---- weights: the stem taps and the int8 trunk follow variables reassignment ----

    @property
    def variables(self):
        return self._variables

    @variables.setter
    def variables(self, value):
        """Load a new state dict, rounded to the compute dtype, and re-derive
        the stem kernel's taps and, with the int8 trunk, its quantized
        weights and activation scales from it, so a new checkpoint never
        serves with stale ones (ROADMAP F2). Eager PyTorch bakes nothing
        else."""
        self._variables = cast_compute_dtype(value, self.compute_dtype)
        self.model.load_state_dict(self._variables, strict=True)
        if self.spec.supports_trunk:
            self._stem_taps = self.model.stem_taps(self.frontend.n_mels)
        if self._int8_cal is not None:
            self._requantize_int8(value)

    @torch.no_grad()
    def _requantize_int8(self, masters) -> None:
        """Calibrate the int8 trunk's activation scales on the calibration
        audio and quantize its weights, both from the float32 weights
        ``masters`` (ROADMAP F3): the frontend at the exact grade, the stem in
        float32 and the float32 residual reference (TF32 off)."""
        masters = {k: torch.as_tensor(v).to(self.device) for k, v in masters.items()}
        conv0 = masters["conv0.weight"].to(torch.float32).permute(2, 3, 1, 0)  # HWIO
        taps = fold_stem_weights(conv0, self.frontend.n_mels, self.model.pooling[1])
        mel = log_mel_spectrogram_cuda(self._int8_cal, self.frontend, self.zmuv_mean, self.zmuv_std,
                                       precision="f32", out_dtype=torch.float32, layout="tm")
        act = calibrate_act_scales(res8_stem_cuda(mel, taps, self.model.pooling), masters)
        self._int8_params = quantize_residual_trunk(masters, act, self.device)

    # ---- scoring ----

    def _features(self, audio: torch.Tensor, layout: str) -> torch.Tensor:
        """(B, samples) audio -> ZMUV'd log-mels in the compute dtype:
        (B, T, F) for ``layout="tm"``, (B, F, T) for ``"fm"``."""
        return log_mel_spectrogram_cuda(
            audio, self.frontend, self.zmuv_mean, self.zmuv_std,
            precision=self.frontend_precision, out_dtype=self.compute_dtype or torch.float32, layout=layout,
        )

    def _pooled_stem(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, samples) audio -> (B, T', F', maps) pooled stem activations:
        the frontend in time-major layout straight into the stem."""
        return res8_stem_cuda(self._features(audio, "tm"), self._stem_taps, self.model.pooling)

    def _window_posteriors(self, trunk: torch.Tensor, n_windows: int) -> torch.Tensor:
        """(B, T', F', maps) clip-level trunk output -> (B, n_windows, L)
        posteriors: the frequency mean, window means by cumsum over pooled
        frames, the head and a float32 softmax."""
        pool_t = self.model.pooling[0]
        span = max(self.window_frames // pool_t, 1)
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

    def _featurize(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, samples) audio -> (B, C, F, T) ZMUV'd features in the compute
        dtype: the stacked chain's three channels, exact float32, for a model
        that reads deltas, else the frontend kernel's mels."""
        if not self.spec.uses_deltas:
            return self._features(audio, "fm")[:, None]
        with exact_float32():
            feats = log_mel_spectrogram(audio, self.frontend, stacked=True)
        return ((feats - self.zmuv_mean) / self.zmuv_std).to(self.compute_dtype or torch.float32)

    def _score_windows(self, feats: torch.Tensor, n_windows: int) -> torch.Tensor:
        """(B, C, F, T) features -> (B, n_windows, L) posteriors of every
        window: one mega-batch, or with ``carry_windows`` a recurrent state
        carried across the windows."""
        b, c, f, _ = feats.shape
        wf = self.window_frames
        starts = torch.arange(n_windows, device=feats.device) * self.stride_frames
        idx = starts[:, None] + torch.arange(wf, device=feats.device)[None, :]  # (n_windows, wf)
        windows = feats[:, :, :, idx].permute(0, 3, 1, 2, 4)  # (B, n_windows, C, F, wf)
        if self.spec.is_recurrent and self.carry_windows:
            carry, logits = None, []
            for k in range(n_windows):  # in time order, every clip at once
                out, carry = self.model(windows[:, k], carry=carry, return_carry=True)
                logits.append(out)
            return torch.softmax(torch.stack(logits, dim=1).float(), dim=-1)
        flat = windows.reshape(b * n_windows, c, f, wf)
        chunk = flat.shape[0] if self.spec.supports_trunk else WINDOW_CHUNK
        logits = torch.cat([self.model(flat[i : i + chunk]) for i in range(0, flat.shape[0], chunk)])
        return torch.softmax(logits.float(), dim=-1).reshape(b, n_windows, -1)

    @torch.no_grad()
    @exact_if_float32
    def _score(self, audio: torch.Tensor, n_windows: int) -> torch.Tensor:
        """(B, samples) -> (B, T, L) posteriors: T windows, or a sequential
        model's output frames."""
        if not self.fused_trunk:
            feats = self._featurize(audio)
            if self.spec.is_sequential:
                return torch.softmax(self.model(feats).float(), dim=-1).transpose(0, 1)  # (B, T', L)
            return self._score_windows(feats, n_windows)
        s0 = self._pooled_stem(audio)
        if self._int8_params is not None:
            trunk = residual_features_int8(s0, self._int8_params, self.compute_dtype, self.int8_route)
        else:
            trunk = self.model.residual_features(s0)
        return self._window_posteriors(trunk, n_windows)

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
        one window yields no scored windows and can never fire. Sequential
        models score frames and take clips as they are."""
        if self.spec.is_sequential:
            return audio, lengths
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
        times, check_offset_is_stride = self._step_times(num_samples)
        _, s_steps, w_steps, stride, check_offset = _ring_geometry(times, self.cfg, check_offset_is_stride)
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

    def _step_times(self, num_samples: int) -> tuple:
        """(step timestamps in ms, whether the FSM checks one stride ahead).
        Windows step at the quantized stride. A sequential model's T' frames
        split the clip's whole milliseconds evenly, the first at one step, as
        the reference's whole-clip engine times them."""
        if not self.spec.is_sequential:
            return np.arange(self.n_windows(num_samples)) * self.stride_ms, True
        t_steps = int(self.model.compute_length(self.frontend.num_frames(num_samples)))
        clip_ms = float(int(num_samples / self.cfg.sample_rate * 1000))
        return np.arange(1, t_steps + 1) * (clip_ms / t_steps), False

    def _valid_mask(self, lengths: torch.Tensor, t_steps: int) -> torch.Tensor:
        """(B, T) validity: window i is valid only when it is full; a
        sequential model's frame only below its true length mapped through
        the model's time downsampling."""
        if self.spec.is_sequential:
            frame_len = self.model.compute_length(lengths // self.frontend.hop_length + 1)
            frame_len = torch.as_tensor(frame_len, device=lengths.device).clamp(1, t_steps)
            return torch.arange(t_steps, device=lengths.device)[None, :] < frame_len[:, None]
        win_start = torch.arange(t_steps, device=lengths.device)[None, :] * (
            self.stride_frames * self.frontend.hop_length
        )
        return (lengths[:, None] - win_start) >= self.window_samples

    def _decide(self, probs: torch.Tensor, lengths: torch.Tensor, geom: dict, threshold=None) -> dict:
        """Stage 5 of ``infer_batch`` on the scorer's (B, T, L) posteriors:
        inference weights, the validity mask, smoothing and the FSM."""
        probs = apply_inference_weights(probs, self.cfg)
        valid = self._valid_mask(lengths, probs.shape[1])
        thr = self.cfg.inference_threshold if threshold is None else float(threshold)
        out = _smooth_and_detect_parallel(
            probs, valid, thr, self._static_cfg(),
            geom["s_steps"], geom["w_steps"], geom["stride"], geom["check_offset"],
        )
        out["probs"] = probs
        out["times_ms"] = geom["times"]
        return out

    def _static_cfg(self) -> EngineConfig:
        """The configuration with the threshold taken out: it is passed on its own."""
        return dataclasses.replace(self.cfg, inference_threshold=0.0)

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
        times, check_offset_is_stride = self._step_times(num_samples)
        return {"probs": probs, "times_ms": times, "valid": valid, "check_offset_is_stride": check_offset_is_stride}

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
        return self._decide(self._score(audio, geom["n_win"]), lengths, geom, threshold)

    def infer(self, audio) -> bool:
        """Single-clip convenience: True when the clip fires."""
        out = self.infer_batch(self._as_audio(audio)[None, :])
        return bool(out["detected"][0])

    def detect_sweep_from_scores(self, scores: dict, thresholds) -> dict:
        """Smoothing + FSM over cached posteriors at every threshold at once;
        the outputs carry a leading (K,) thresholds axis."""
        return smooth_and_detect_sweep(
            scores["probs"], scores["times_ms"], scores["valid"], thresholds, self.cfg,
            scores["check_offset_is_stride"],
        )

    def infer_sweep_batch(self, audio, lengths=None, thresholds=()) -> np.ndarray:
        """Score B clips once and decide at K thresholds; returns detected
        (K, B) as a host array."""
        audio, lengths = self._pad_short_clips(self._as_audio(audio), lengths)
        batch, num_samples = audio.shape
        geom = self._step_geometry(batch, num_samples)
        lengths = self._as_lengths(lengths, batch, num_samples)
        probs = apply_inference_weights(self._score(audio, geom["n_win"]), self.cfg)
        out = _smooth_and_detect_sweep(
            probs, self._valid_mask(lengths, probs.shape[1]), thresholds, self._static_cfg(),
            geom["s_steps"], geom["w_steps"], geom["stride"], geom["check_offset"],
        )
        return out["detected"].cpu().numpy()


class WholeClipEngine(StreamingEngine):
    """The whole-clip engine: a sequential model consumes each whole clip and
    emits per-frame posteriors, each frame a detector step; frames whose
    argmax is ``cfg.blank_label`` are skipped (``inference/detect.py``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if not self.spec.is_sequential:
            raise ValueError("WholeClipEngine requires a sequential model (seq-lstm / seq-cnn)")
