"""int8 residual trunk for res8 serving: post-training static quantization of
the six residual convolutions (counterpart of ``howl_tpu/ops/int8_trunk.py``),
with two hand-written kernels and their plain PyTorch version: the fused
trunk ``csrc/int8_trunk_fused.cu`` (six layers a launch, ``wgmma`` on s8)
and the layer kernel ``csrc/int8_trunk.cu`` (one layer a launch,
``mma.sync`` on s8).

The scheme is the JAX package's:

* weights: per-output-channel symmetric int8, scale = max |w| / 127 over the
  (3, 3, C_in) fan-in of each output channel, quantized with the same numpy
  formula, so ``w_i8`` and ``w_scale`` equal the JAX package's bit for bit;
* activations: per-layer symmetric int8 with static scales calibrated from
  representative audio (max |layer input| x margin / 127);
* arithmetic: the conv sums in s32; ReLU on the s32 sum (it commutes with the
  positive dequant scale), the cast to the compute dtype, x dq with dq =
  cdt(w_scale * s_a); the residual adds on the pre-BatchNorm sums and the
  affine-less BatchNorm, folded to one scale and shift per channel, in the
  compute dtype, mirroring ``Res8.residual_features``.

Layout is the JAX package's: activations (B, T', F', C) channels-last, the
quantized weights HWIO (3, 3, C_in, C_out) int8 (H = time, W = frequency);
the port's res8 state dict holds conv weights OIHW, transposed here.

``residual_features_int8`` takes its plain version for a tensor on the CPU.
On a CUDA device it follows :func:`int8_trunk_route`: "fused" launches
``int8_trunk_fused_cuda`` once (the six layers in one persistent kernel),
"layer" launches ``int8_conv_layer_cuda`` six times. The plain version runs
``F.conv2d`` in float32 on the integer-valued s8 tensors (cuDNN off, see
``int8_conv_sums_plain``) and casts the sums to int32: exact, since |acc| <= 127 * 127 * 405 = 6,532,245 < 2^24 makes every
product and partial sum an exact float32 integer in any summation order
(PyTorch has no int8 convolution on either device). Its rounding points are
the JAX package's: the quantize ``clip(round(float32(x) * float32(1 / s_a)),
-127, 127)`` rounds half to even as ``jnp.round`` does, and each later
operation rounds to the compute dtype on its own.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from howl_tpu_torch.ops import _build
from howl_tpu_torch.ops.tf32 import exact_float32

_BN_EPS = 1e-5  # res8's BatchNorm eps
N_LAYERS = 6
# the kernel's geometry (csrc/int8_trunk.cu)
C_PAD = 48  # a position's channels in shared memory, and the output channels of the GEMM
K_STEPS = 14  # 9 taps x 48 channels = 432 of K in k32 steps, the last half zero
W_IMAGE_BYTES = K_STEPS * (C_PAD // 8) * 32 * 8  # 21,504
BLOCK_POSITIONS = 256  # positions a block: tt = 256 // F frames
# the fused kernel's geometry (csrc/int8_trunk_fused.cu)
FUSED_TILE_FRAMES = {torch.bfloat16: 43, torch.float32: 24}  # frames a block item keeps: 5 and 9 tiles of 213
FUSED_HALO = 6  # frames each side of a tile's input: the six layers' reach
FUSED_CORES = 27  # k16 cores of a layer's K: core n = 3 tap + column, the column's 16 channels at the tap
FUSED_K_STEPS = (FUSED_CORES + 1) // 2  # 14 k32 steps of two cores, the last one alone
FUSED_STEP_BYTES = 2 * 6 * 128  # a step's B: two k cores of six n cores, 8 n x 16 k bytes each
FUSED_W_IMAGE_BYTES = FUSED_K_STEPS * FUSED_STEP_BYTES  # 21,504
FUSED_GUARD = 1  # s8 rows below a tile's row 0
MAX_SHARED_BYTES = 232448  # 227 KB a block


class Int8TrunkParams(NamedTuple):
    """Quantized residual-stack parameters, on one device."""

    w_i8: Tuple[torch.Tensor, ...]  # 6 x (3, 3, C, C) int8, HWIO
    w_scale: Tuple[torch.Tensor, ...]  # 6 x (C,) float32 per output channel
    bn_scale: Tuple[torch.Tensor, ...]  # 6 x (C,) float32, 1 / sqrt(var + eps)
    bn_shift: Tuple[torch.Tensor, ...]  # 6 x (C,) float32, -mean * scale
    act_scale: Tuple[float, ...]  # 6 static per-layer input scales


def _numpy(t) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def _residual_layers(state_dict) -> Tuple[list, list, list]:
    """conv1..conv6 as float32 numpy HWIO kernels and bn1..bn6 folded to a
    scale 1 / sqrt(var + eps) and a shift -mean * scale, from a res8 state
    dict (float32 numpy arithmetic, as the JAX package's)."""
    kernels, scales, shifts = [], [], []
    for i in range(1, N_LAYERS + 1):
        k = _numpy(state_dict[f"conv{i}.weight"]).transpose(2, 3, 1, 0)  # OIHW -> HWIO
        mean = _numpy(state_dict[f"bn{i}.running_mean"])
        var = _numpy(state_dict[f"bn{i}.running_var"])
        s = 1.0 / np.sqrt(var + _BN_EPS)
        kernels.append(np.ascontiguousarray(k))
        scales.append(s)
        shifts.append(-mean * s)
    return kernels, scales, shifts


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def float_residual_reference(y: torch.Tensor, state_dict, capture: bool = False):
    """float32 replica of ``Res8.residual_features`` built from the state dict
    (conv, ReLU, residual adds on the pre-BN sums, folded BN): the
    calibration oracle. (B, T', F', C) in, the same out; with
    ``capture=True`` also each layer's conv input, the tensor the int8 path
    quantizes. Runs with TF32 off."""
    kernels, scales, shifts = _residual_layers(state_dict)
    dev = y.device
    x = old_x = y.to(torch.float32)
    inputs = []
    with exact_float32():
        for i in range(N_LAYERS):
            if capture:
                inputs.append(x)
            w = torch.from_numpy(kernels[i]).to(dev).permute(3, 2, 0, 1)  # OIHW
            yv = _nhwc(F.relu(F.conv2d(_nchw(x), w, padding=1)))
            if (i + 1) % 2 == 0:
                x = yv + old_x
                old_x = x
            else:
                x = yv
            x = x * torch.from_numpy(scales[i]).to(dev) + torch.from_numpy(shifts[i]).to(dev)
    return (x, inputs) if capture else x


def calibrate_act_scales(pooled_stem: torch.Tensor, state_dict, margin: float = 1.1) -> Tuple[float, ...]:
    """Static per-layer activation scales from a calibration batch:
    max |layer input| x margin / 127 for each layer, ``pooled_stem`` the
    (B, T', F', C) stem output of representative audio. Values past the
    calibrated range saturate (symmetric clip)."""
    _, inputs = float_residual_reference(pooled_stem, state_dict, capture=True)
    return tuple(max(float(x.abs().max()), 1e-6) * float(margin) / 127.0 for x in inputs)


def quantize_residual_trunk(state_dict, act_scales: Sequence[float], device=None) -> Int8TrunkParams:
    """Per-output-channel symmetric int8 weights and the folded BN affines,
    on ``device`` (default: the state dict's)."""
    if len(act_scales) != N_LAYERS:
        raise ValueError(f"need {N_LAYERS} activation scales, got {len(act_scales)}")
    device = torch.device(device) if device is not None else state_dict["conv1.weight"].device
    kernels, scales, shifts = _residual_layers(state_dict)
    w_i8, w_scale = [], []
    for k in kernels:
        s = np.abs(k).max(axis=(0, 1, 2)) / 127.0  # (C_out,)
        s = np.maximum(s, 1e-12)
        q = np.clip(np.round(k / s[None, None, None, :]), -127, 127).astype(np.int8)
        w_i8.append(torch.from_numpy(q).to(device))
        w_scale.append(torch.from_numpy(s.astype(np.float32)).to(device))

    def dev(arrays):
        return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)

    return Int8TrunkParams(w_i8=tuple(w_i8), w_scale=tuple(w_scale), bn_scale=dev(scales), bn_shift=dev(shifts),
                           act_scale=tuple(float(s) for s in act_scales))


def _inv_scale(s_a: float) -> float:
    """float32(1 / s_a), the quantize's multiplier as the JAX package forms it."""
    return float(np.float32(1.0 / s_a))


def quantize_activations(x: torch.Tensor, s_a: float) -> torch.Tensor:
    """clip(round_half_even(float32(x) * float32(1 / s_a)), -127, 127) as int8."""
    return torch.clamp(torch.round(x.to(torch.float32) * _inv_scale(s_a)), -127, 127).to(torch.int8)


def int8_conv_sums_plain(xq: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """The 3x3 SAME conv of s8 activations (B, T, F, C) with s8 HWIO weights,
    as exact int32 sums (B, T, F, C_out): ``F.conv2d`` in float32 on the
    integer values, every product and partial sum an exact float32 integer.
    cuDNN is off for the call: its heuristics may pick a transform algorithm
    (Winograd, FFT), whose float32 rounding is not exact at these
    magnitudes; PyTorch's own direct and im2col + GEMM convolutions sum the
    products as they are."""
    w = w_i8.to(torch.float32).permute(3, 2, 0, 1)  # OIHW
    with exact_float32(), torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        acc = F.conv2d(_nchw(xq.to(torch.float32)), w, padding=1)
    return _nhwc(acc).to(torch.int32)


def int8_conv_layer_plain(x: torch.Tensor, w_i8: torch.Tensor, s_a: float, w_scale: torch.Tensor,
                          bn_scale: Optional[torch.Tensor] = None, bn_shift: Optional[torch.Tensor] = None,
                          residual: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of one kernel launch, in x's dtype: (out,
    pre), pre the sum before BatchNorm (the residual included), out after it
    (pre itself without ``bn_scale``)."""
    cdt = x.dtype
    acc = int8_conv_sums_plain(quantize_activations(x, s_a), w_i8)
    # ReLU on the s32 sum, the cast, the dequant by dq = cdt(w_scale * float32(s_a)), rounded once
    dq = (w_scale * torch.tensor(s_a, dtype=torch.float32, device=w_scale.device)).to(cdt)
    pre = acc.clamp(min=0).to(cdt) * dq
    if residual is not None:
        pre = pre + residual
    out = pre if bn_scale is None else pre * bn_scale.to(cdt) + bn_shift.to(cdt)
    return out, pre


def pack_w_image(w_i8: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, C) s8 HWIO weights -> the kernel's 21,504-byte image, in the
    order its B fragments are read.

    B is the (432 + 16, 48) matrix with B[(3 kh + kw) * 48 + c_in, c_out] =
    w[kh, kw, c_in, c_out] (zero past C and past K = 432). For k32 step s,
    n8 tile nt and lane (g, t) = (lane // 4, lane % 4), the lane's 8 bytes at
    ``((s * 6 + nt) * 32 + lane) * 8`` are B[32 s + 16 j + 4 t + i, 8 nt + g]
    for j = 0, 1 (the fragment's two registers) and i = 0..3 (its bytes).
    """
    if w_i8.ndim != 4 or tuple(w_i8.shape[:2]) != (3, 3) or w_i8.dtype != torch.int8:
        raise ValueError(f"expected (3, 3, C, C) int8 weights, got {tuple(w_i8.shape)} {w_i8.dtype}")
    c_in, c_out = w_i8.shape[2:]
    if c_in > C_PAD or c_out > C_PAD:
        raise ValueError(f"the kernel serves at most {C_PAD} channels, got {c_in} -> {c_out}")
    b = torch.zeros((K_STEPS * 32, C_PAD), dtype=torch.int8, device=w_i8.device)
    b[: 9 * C_PAD].view(9, C_PAD, C_PAD)[:, :c_in, :c_out] = w_i8.reshape(9, c_in, c_out)
    v = b.view(K_STEPS, 2, 4, 4, C_PAD // 8, 8)  # s, j, t, i, nt, g
    return v.permute(0, 4, 5, 2, 1, 3).contiguous().view(torch.uint8).reshape(-1)


def fused_step_cores(step: int) -> Tuple[int, Optional[int]]:
    """The two k16 cores (n = 3 tap + column: input channels 16 column ..
    16 column + 15 at tap (kh, kw) = divmod(tap, 3)) of the fused kernel's
    k32 step ``step``, in K order: cores 2 step and 2 step + 1, the later
    first where the pair crosses from one tap's column 2 to the next tap's
    column 0 (so that the second core's rows lie above the first's in shared
    memory); the last step's second core is None (B's zero rows)."""
    n = 2 * step
    if n + 1 >= FUSED_CORES:
        return n, None
    return (n + 1, n) if n % 3 == 2 else (n, n + 1)


def pack_w_image_wgmma(w_i8: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, C) s8 HWIO weights -> the fused kernel's 21,504-byte image
    of one layer, in the order its K-major B descriptors read it.

    k32 step s holds the weights of its two cores (:func:`fused_step_cores`)
    in its k 0-15 and 16-31, zeros for the last step's missing second core.
    Within a step, k-core kc (16 k) and n-core nc (8 output channels) are 128
    bytes at ``1536 s + 768 kc + 128 nc``, byte ``16 (n % 8) + k % 16`` of it
    the weight of input channel 16 column + k % 16 of core kc's tap and
    output channel 8 nc + n % 8, zero past C.
    """
    if w_i8.ndim != 4 or tuple(w_i8.shape[:2]) != (3, 3) or w_i8.dtype != torch.int8:
        raise ValueError(f"expected (3, 3, C, C) int8 weights, got {tuple(w_i8.shape)} {w_i8.dtype}")
    c_in, c_out = w_i8.shape[2:]
    if c_in > C_PAD or c_out > C_PAD:
        raise ValueError(f"the kernel serves at most {C_PAD} channels, got {c_in} -> {c_out}")
    taps = torch.zeros((9, C_PAD, C_PAD), dtype=torch.int8, device=w_i8.device)
    taps[:, :c_in, :c_out] = w_i8.reshape(9, c_in, c_out)
    cores = taps.view(FUSED_CORES, 16, C_PAD)  # core 3 tap + column: 16 input channels
    b = torch.zeros((FUSED_K_STEPS, 32, C_PAD), dtype=torch.int8, device=w_i8.device)  # (step, k, n)
    for step in range(FUSED_K_STEPS):
        first, second = fused_step_cores(step)
        b[step, :16] = cores[first]
        if second is not None:
            b[step, 16:] = cores[second]
    v = b.view(FUSED_K_STEPS, 2, 16, C_PAD // 8, 8)  # s, kc, k, nc, n
    return v.permute(0, 1, 3, 4, 2).contiguous().view(torch.uint8).reshape(-1)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fused_layer_rows(layer: int, n_f: int, tt: int) -> Tuple[int, int]:
    """(first, count): the s8 rows layer ``layer`` (1..6) of the fused kernel
    computes, relative to the tile's row 0 (frame a - 6; F + 2 rows a
    frame): frames [a - 6 + layer, a + tt + 6 - layer)."""
    s = n_f + 2
    return s * layer, s * (tt + 2 * FUSED_HALO - 2 * layer)


def fused_shared_bytes(dtype, n_f: int, c: int) -> Optional[int]:
    """The fused kernel's shared memory for F bins of C channels in
    ``dtype``, or None where it does not fit a block (the layout of
    ``csrc/int8_trunk_fused.cu``: two weight slots, two s8 buffers of three
    16-byte chunk columns (channels 0-15, 16-31, 32-47), y's staging run, the residual over layer 2's
    frames, the per-layer tables and two mbarriers; layer 6's output staged
    over the first weight slot and s8 buffer)."""
    if dtype not in FUSED_TILE_FRAMES or not 1 <= c <= C_PAD or n_f < 1:
        return None
    tt, size, s = FUSED_TILE_FRAMES[dtype], torch.empty((), dtype=dtype).element_size(), n_f + 2
    end = max(first + 64 * ((count + 63) // 64) + s + 1
              for first, count in (fused_layer_rows(layer, n_f, tt) for layer in range(1, N_LAYERS + 1)))
    buf = 3 * _round_up(FUSED_GUARD + end, 8) * 16
    staging = _round_up((tt + 2 * FUSED_HALO) * n_f * c * size + 32, 128)
    residual = _round_up(6 * (tt + 2 * FUSED_HALO - 4) * n_f * 8 * size, 128)
    total = 2 * FUSED_W_IMAGE_BYTES + 2 * buf + staging + residual + N_LAYERS * 3 * C_PAD * 4 + 16
    out_staged = tt * n_f * c * size + 16
    return total if total <= MAX_SHARED_BYTES and out_staged <= FUSED_W_IMAGE_BYTES + buf else None


def int8_trunk_route(dtype, n_f: int, c: int) -> str:
    """The int8 trunk's kernel for activations of ``dtype`` with F bins and C
    channels: "fused" (``csrc/int8_trunk_fused.cu``) where its block holds
    them (bf16 and float32 up to C = 48; F up to 10 in bf16, the serving
    geometry), else "layer" (``csrc/int8_trunk.cu``, six launches)."""
    return "fused" if fused_shared_bytes(dtype, n_f, c) is not None else "layer"


def block_frames(n_f: int) -> int:
    """Frames a block of the kernel owns: 256 positions of F bins."""
    return max(BLOCK_POSITIONS // n_f, 1)


def _check_layer(x, w_i8, w_scale, bn_scale, bn_shift, residual) -> None:
    if x.ndim != 4:
        raise ValueError(f"expected (B, T, F, C) activations, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    if tuple(w_i8.shape) != (3, 3, c, c) or w_i8.dtype != torch.int8:
        raise ValueError(f"expected (3, 3, {c}, {c}) int8 weights, got {tuple(w_i8.shape)} {w_i8.dtype}")
    if (bn_scale is None) != (bn_shift is None):
        raise ValueError("bn_scale and bn_shift go together")
    for name, t in (("w_scale", w_scale), ("bn_scale", bn_scale), ("bn_shift", bn_shift)):
        if t is not None and (tuple(t.shape) != (c,) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be ({c},) float32, got {tuple(t.shape)} {t.dtype}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype} does not match x {tuple(x.shape)} {x.dtype}")
    for t in (w_i8, w_scale, bn_scale, bn_shift, residual):
        if t is not None and t.device != x.device:
            raise ValueError(f"an operand lies on {t.device}, the activations on {x.device}")


def int8_conv_layer_cuda(x: torch.Tensor, w_i8: torch.Tensor, s_a: float, w_scale: torch.Tensor,
                         bn_scale: Optional[torch.Tensor] = None, bn_shift: Optional[torch.Tensor] = None,
                         residual: Optional[torch.Tensor] = None,
                         keep_pre: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One int8 residual layer on (B, T, F, C) activations in bf16 or float32:
    (out, pre) as :func:`int8_conv_layer_plain` gives them, pre None unless
    ``keep_pre``. Without ``bn_scale``/``bn_shift`` the epilogue is the conv,
    ReLU and dequant (and the residual add, if given) alone.

    On a CPU tensor this is :func:`int8_conv_layer_plain`. On a CUDA tensor
    it launches ``howl_int8_conv_forward`` (``csrc/int8_trunk.cu``) or raises;
    ``launches`` counts its launches. The kernel has no backward.
    """
    _build.refuse_grad("int8_conv_layer_cuda", x)
    if x.device.type == "cpu":
        out, pre = int8_conv_layer_plain(x, w_i8, s_a, w_scale, bn_scale, bn_shift, residual)
        return out, (pre if keep_pre else None)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv_layer_cuda takes CPU or CUDA tensors, got {x.device}")
    _check_layer(x, w_i8, w_scale, bn_scale, bn_shift, residual)
    if not all(t is None or t.is_contiguous() for t in (x, w_i8, w_scale, bn_scale, bn_shift, residual)):
        raise ValueError("the int8 layer's operands must be contiguous")
    if x.data_ptr() % 16 or (residual is not None and residual.data_ptr() % 16):
        raise ValueError("the int8 layer kernel moves its runs as 16-byte vectors: x and residual must be 16-byte aligned")
    b, t, n_f, c = x.shape
    tt = block_frames(n_f)
    if tt * n_f > BLOCK_POSITIONS:
        raise ValueError(f"{n_f} frequency bins: the int8 layer kernel serves at most {BLOCK_POSITIONS}")
    out = torch.empty_like(x)
    pre = torch.empty_like(x) if keep_pre else None
    img = _build.packed_operand(pack_w_image, w_i8)

    def ptr(tensor):
        return None if tensor is None else tensor.data_ptr()

    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.kernel_library()
    with torch.cuda.device(x.device):
        status = lib.howl_int8_conv_forward(
            x.data_ptr(), img.data_ptr(), w_scale.data_ptr(), ptr(bn_scale), ptr(bn_shift), ptr(residual),
            out.data_ptr(), ptr(pre), b, t, n_f, c, tt, _inv_scale(s_a), float(s_a), int(x.dtype == torch.bfloat16),
            stream,
        )
    _build.check_launch(status, "int8 residual layer")
    int8_conv_layer_cuda.launches += 1
    return out, pre


int8_conv_layer_cuda.launches = 0


def _layers(y: torch.Tensor, p: Int8TrunkParams, compute_dtype, layer):
    """The six layers through ``layer`` (the kernel's wrapper or the plain
    version): residual adds on the pre-BN sums of layers 2, 4 and 6."""
    cdt = compute_dtype or torch.float32
    x = old_x = y.to(cdt).contiguous()
    for i in range(N_LAYERS):
        residual = old_x if (i + 1) % 2 == 0 else None
        x, pre = layer(x, p.w_i8[i], p.act_scale[i], p.w_scale[i], p.bn_scale[i], p.bn_shift[i], residual,
                       keep_pre=(i + 1) in (2, 4))
        if pre is not None:
            old_x = pre
    return x


def residual_features_int8_plain(y: torch.Tensor, p: Int8TrunkParams, compute_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`residual_features_int8`, on any device."""

    def layer(x, w, s_a, ws, bs, bb, residual, keep_pre):
        out, pre = int8_conv_layer_plain(x, w, s_a, ws, bs, bb, residual)
        return out, (pre if keep_pre else None)

    return _layers(y, p, compute_dtype, layer)


def int8_trunk_fused_cuda(y: torch.Tensor, p: Int8TrunkParams, compute_dtype=None) -> torch.Tensor:
    """The six int8 residual layers in one launch: (B, T', F', C) pooled stem
    activations -> the trunk output in ``compute_dtype`` (float32 for None),
    equal to :func:`residual_features_int8_plain` bit for bit.

    On a CPU tensor this is :func:`residual_features_int8_plain`. On a CUDA
    tensor it launches ``howl_int8_trunk_fused_forward``
    (``csrc/int8_trunk_fused.cu``) or raises; ``launches`` counts its
    launches. The kernel has no backward.
    """
    _build.refuse_grad("int8_trunk_fused_cuda", y)
    if y.device.type == "cpu":
        return residual_features_int8_plain(y, p, compute_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"int8_trunk_fused_cuda takes CPU or CUDA tensors, got {y.device}")
    cdt = compute_dtype or torch.float32
    x = y.to(cdt).contiguous()
    for i in range(N_LAYERS):
        _check_layer(x, p.w_i8[i], p.w_scale[i], p.bn_scale[i], p.bn_shift[i], None)
    vectors = (*p.w_i8, *p.w_scale, *p.bn_scale, *p.bn_shift)
    if not all(t.is_contiguous() for t in vectors):
        raise ValueError("the fused int8 trunk's weights and vectors must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("the fused int8 trunk reads y as 16-byte vectors: y must be 16-byte aligned")
    b, t, n_f, c = x.shape
    if fused_shared_bytes(cdt, n_f, c) is None:
        raise ValueError(f"the fused int8 trunk does not serve {n_f} frequency bins of {c} channels in {cdt}: "
                         f"its block would not fit in shared memory (int8_trunk_route gives 'layer')")
    out = torch.empty_like(x)
    imgs = [_build.packed_operand(pack_w_image_wgmma, w) for w in p.w_i8]

    def ptrs(tensors):
        return (ctypes.c_void_p * N_LAYERS)(*(tensor.data_ptr() for tensor in tensors))

    def floats(values):
        return (ctypes.c_float * N_LAYERS)(*values)

    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.kernel_library()
    with torch.cuda.device(x.device):
        status = lib.howl_int8_trunk_fused_forward(
            x.data_ptr(), ptrs(imgs), ptrs(p.w_scale), ptrs(p.bn_scale), ptrs(p.bn_shift), floats(p.act_scale),
            floats(_inv_scale(s) for s in p.act_scale), out.data_ptr(), b, t, n_f, c, int(cdt == torch.bfloat16),
            stream,
        )
    _build.check_launch(status, "fused int8 trunk")
    int8_trunk_fused_cuda.launches += 1
    return out


int8_trunk_fused_cuda.launches = 0

ROUTES = ("fused", "layer")


def residual_features_int8(y: torch.Tensor, p: Int8TrunkParams, compute_dtype=None,
                           route: Optional[str] = None) -> torch.Tensor:
    """(B, T', F', C) pooled stem activations -> the trunk output in
    ``compute_dtype`` (float32 for None), every conv in s8 x s8 -> s32. On a
    CUDA tensor ``route`` picks the kernel ("fused": one launch of
    :func:`int8_trunk_fused_cuda`; "layer": six of
    :func:`int8_conv_layer_cuda`), by default :func:`int8_trunk_route`'s;
    on a CPU tensor either wrapper takes the plain version."""
    if route is None:
        route = int8_trunk_route(compute_dtype or torch.float32, y.shape[2], y.shape[3])
    if route == "fused":
        return int8_trunk_fused_cuda(y, p, compute_dtype)
    if route == "layer":
        return _layers(y, p, compute_dtype, int8_conv_layer_cuda)
    raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
