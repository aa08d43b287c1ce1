"""Two-point-slope attribution of the offline serving step, on the card
(counterpart of ``tools/ablate_serving_slope.py``).

    python -m howl_tpu_torch.tools.ablate_serving_slope [--device cuda] [--batch 512] [--clip-seconds 8] [--iters 16]

Each leg runs as a chain of calls whose input is bumped in place by the
last output (times 1e-30), timed by CUDA events at ``iters`` and 4 x
``iters`` calls; a leg's time is the median over three repeats of the
two-point slope ``(t_long - t_short) / (3 iters)`` (``_study.slope_ms``),
which cancels whatever a chain costs once. The legs, on the bf16 serving
engine of the bench (res8, 4 labels, random weights from the seed, seeded
noise):

  * the full fused step, ``infer_batch``: the frontend kernel (K1, "bf16")
    + the stem kernel (K2) + cuDNN's residual convs + window head + softmax
    + smoothing and the FSM: what the bench's headline chains;
  * the same step with the frontend as the torch GEMM chain (float32
    products, ``ops/frontend.log_mel_spectrogram``), composed here from the
    engine's stages (the JAX tool's "xla frontend" leg);
  * the same step with the int8 residual trunk (``use_int8_trunk``: one
    launch of ``csrc/int8_trunk_fused.cu`` in place of cuDNN's convs and
    BN), calibrated on the step's own audio, as the JAX tool's engine is;
  * the frontend alone: K1 at "bf16" (time-major, bf16 out), and the torch
    GEMM chain;
  * the trunk alone, ``Res8.trunk_features`` and the global mean on
    precomputed feature-major features;
  * the post-frontend remainder in its in-step form: the stem kernel, the
    residual convs, the window head and the softmax on precomputed
    time-major mels;
  * the head alone: the frequency mean, cumsum window pooling, the dense
    layer and the softmax on a precomputed trunk output.

It runs on the card: with ``--device cuda`` (the default) and no CUDA
device it raises. ``--device cpu`` runs the plain versions at 4 clips of
2 s, 2 iterations, on the host clock.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from howl_tpu_torch.tools._study import CPU_SIZE, REPEATS, bumped_chain, pick_device, slope_ms, study_parser

INT8_LEG = "full fused step (frontend kernel + stem kernel + int8)"
BF16_LEG = "full fused step (frontend kernel + stem kernel)"


def _setup(batch: int, clip_seconds: float, seed: int, dev: torch.device):
    """(the bench's bf16 fused engine, the same with the int8 trunk calibrated
    on the audio, the audio): seeded weights and noise, as the bench's."""
    from howl_tpu_torch.bench import SAMPLE_RATE, headline_engine, res8_numpy_variables
    from howl_tpu_torch.compat import res8_variables_to_state_dict

    rng = np.random.default_rng(seed)
    state = res8_variables_to_state_dict(res8_numpy_variables(rng, 4))
    clip_samples = int(clip_seconds * SAMPLE_RATE)
    audio = torch.from_numpy((rng.standard_normal((batch, clip_samples)) * 0.1).astype(np.float32)).to(dev)
    engine = headline_engine(dev, state, "bf16")
    engine_int8 = headline_engine(dev, state, "int8", audio)
    return engine, engine_int8, audio


def trunk_ab(batch: int, clip_seconds: float, iters: int, seed: int, dev: torch.device, turns: int = 2) -> dict:
    """The full fused step with the bf16 trunk against the same step with the
    int8 trunk on each of its routes, in turns (bf16, int8, int8_layer,
    int8_layer, int8, bf16, ... ``turns`` times each): {"bf16": [ms per
    turn], "int8": [...], "int8_layer": [...]}, each a two-point slope;
    "int8" is the engine's own route (the fused kernel at the serving
    geometry), "int8_layer" the layer kernel's six launches."""
    engine, engine_int8, audio = _setup(batch, clip_seconds, seed, dev)
    engine_layer = copy.copy(engine_int8)
    engine_layer.int8_route = "layer"
    makers = {who: bumped_chain(lambda a, e=e: e.infer_batch(a)["detected"], audio)
              for who, e in (("bf16", engine), ("int8", engine_int8), ("int8_layer", engine_layer))}
    out = {who: [] for who in makers}
    with torch.no_grad():
        for i in range(turns):
            for who in (list(makers) if i % 2 == 0 else list(makers)[::-1]):
                out[who].append(slope_ms(makers[who], iters, 4 * iters, 1, dev)[0])
    return out


def run(batch: int, clip_seconds: float, iters: int, seed: int, dev: torch.device) -> dict:
    """{leg name: ms per iteration}."""
    from howl_tpu_torch.ops.frontend import log_mel_spectrogram
    from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
    from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda

    engine, engine_int8, audio = _setup(batch, clip_seconds, seed, dev)
    clip_samples = audio.shape[1]
    model, frontend, dtype = engine.model, engine.frontend, engine.compute_dtype
    geom = engine._step_geometry(batch, clip_samples)
    lengths = engine._as_lengths(None, batch, clip_samples)
    n_win = geom["n_win"]

    def torch_frontend_step(a):
        mels = log_mel_spectrogram(a, frontend)  # (B, F, T) float32
        feats = ((mels - engine.zmuv_mean) / engine.zmuv_std).to(dtype)[:, None]
        probs = engine._window_posteriors(model.trunk_features(feats), n_win)
        return engine._decide(probs, lengths, geom)["detected"]

    def remainder(mel_tm):
        trunk = model.residual_features(res8_stem_cuda(mel_tm, engine._stem_taps, model.pooling))
        return engine._window_posteriors(trunk, n_win)

    results = {}

    def timed(name, fn, x):
        ms, _ = slope_ms(bumped_chain(fn, x), iters, 4 * iters, REPEATS, dev)
        results[name] = ms
        print(f"{name:60s}: {ms:8.3f} ms/iter  ({batch * clip_seconds / (ms / 1e3):,.0f}x realtime)", flush=True)

    with torch.no_grad():
        feats = engine._features(audio, "fm")[:, None]  # (B, 1, F, T)
        mel_tm = engine._features(audio, "tm")
        trunk = model.trunk_features(feats)
        timed(BF16_LEG, lambda a: engine.infer_batch(a)["detected"], audio)
        timed("full fused step (torch frontend + stem kernel)", torch_frontend_step, audio)
        timed(INT8_LEG, lambda a: engine_int8.infer_batch(a)["detected"], audio)
        timed("frontend: kernel K1 bf16 (time-major, bf16 out)",
              lambda a: log_mel_spectrogram_cuda(a, frontend, engine.zmuv_mean, engine.zmuv_std, precision="bf16",
                                                 out_dtype=dtype, layout="tm"), audio)
        timed("frontend: torch gemm chain (float32)", lambda a: log_mel_spectrogram(a, frontend), audio)
        timed("trunk alone (on precomputed features)", lambda f: model.trunk_features(f).float().mean(dim=(1, 2)), feats)
        timed("post-frontend remainder (stem kernel + trunk + pool + head)", remainder, mel_tm)
        timed("head: frequency mean, cumsum window pooling + dense", lambda t: engine._window_posteriors(t, n_win),
              trunk)
    return results


def main(argv=None) -> dict:
    args = study_parser(__doc__).parse_args(argv)
    dev = pick_device(args.device)
    if dev.type == "cpu":
        args.batch, args.clip_seconds, args.iters = CPU_SIZE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(args.batch, args.clip_seconds, args.iters, args.seed, dev)


if __name__ == "__main__":
    main()
