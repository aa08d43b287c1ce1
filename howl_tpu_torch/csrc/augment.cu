// Noise-bank gather + mix for Hopper (sm_90a).
//
// Replaces the TPU kernel howl_tpu/ops/augment_pallas.py, mix_noise_bank_pallas
// (Pallas kernel _mix_kernel, bank view from flatten_bank). For audio (B, n),
// the wrap-extended noise bank ext (N, W) (every circular window of the raw
// bank is one contiguous slice of it) and one row, window start and mix
// weight alpha per example, it computes
//
//     out[b, i] = audio[b, i]                                  if alpha[b] == 0
//     out[b, i] = audio[b, i] * (1 - alpha[b])
//                 + ext[row[b], off[b] + i] * alpha[b]         otherwise
//
// with row clamped to [0, N - 1] and off to [0, W - n], as
// jax.lax.dynamic_slice clamps its starts. Each product, difference and sum is
// rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn): nvcc would otherwise
// contract a * b + c into one FMA, and the result would no longer equal the
// plain PyTorch version (separate ops) bit for bit.
//
// What bounds it on this card: memory. Per sample it does three flops and
// moves 12 bytes (audio and noise in, the mix out): 98 MB per call at the
// train step's (1024, 8000) batch.
//
// What the design does about it: one block takes one example and a tile of
// kTile samples. The noise window is read straight from the extended bank at
// any start, since Hopper has no tile-alignment rule, and is never written to
// device memory; the TPU kernel's tile-aligned flat bank, its quantum-aligned
// DMA blocks and its padding of the batch to 8 examples are gone. A row whose
// alpha is 0 (augmentation not applied) is copied and never reads the bank.
// Loads and stores are float4 where the three row pointers are 16-byte
// aligned, scalar otherwise (a ragged n leaves every other row unaligned).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 4 * 4;  // samples per block: 4 float4 per thread

__device__ __forceinline__ float mix(float a, float z, float al, float one_minus_al) {
  return __fadd_rn(__fmul_rn(a, one_minus_al), __fmul_rn(z, al));
}

__device__ __forceinline__ long long clamp_index(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ audio, const float* __restrict__ bank,
           const long long* __restrict__ rows, const long long* __restrict__ offs,
           const float* __restrict__ alpha, float* __restrict__ out, int n, int n_rows,
           int w_cols) {
  const int b = blockIdx.y;
  const int start = blockIdx.x * kTile;
  const int len = min(kTile, n - start);
  const size_t base = static_cast<size_t>(b) * n + start;
  const float* a = audio + base;
  float* o = out + base;
  const float al = alpha[b];

  if (al == 0.f) {
    if (aligned16(a) && aligned16(o)) {
      const int n_vec = len / 4;
      for (int i = threadIdx.x; i < n_vec; i += kThreads)
        reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(a)[i];
      for (int i = n_vec * 4 + threadIdx.x; i < len; i += kThreads) o[i] = a[i];
    } else {
      for (int i = threadIdx.x; i < len; i += kThreads) o[i] = a[i];
    }
    return;
  }

  const long long row = clamp_index(rows[b], 0, n_rows - 1);
  const long long off = clamp_index(offs[b], 0, w_cols - n);
  const float* z = bank + row * w_cols + off + start;
  const float one_minus_al = __fsub_rn(1.f, al);
  if (aligned16(a) && aligned16(z) && aligned16(o)) {
    const int n_vec = len / 4;
    for (int i = threadIdx.x; i < n_vec; i += kThreads) {
      const float4 av = reinterpret_cast<const float4*>(a)[i];
      const float4 zv = reinterpret_cast<const float4*>(z)[i];
      float4 r;
      r.x = mix(av.x, zv.x, al, one_minus_al);
      r.y = mix(av.y, zv.y, al, one_minus_al);
      r.z = mix(av.z, zv.z, al, one_minus_al);
      r.w = mix(av.w, zv.w, al, one_minus_al);
      reinterpret_cast<float4*>(o)[i] = r;
    }
    for (int i = n_vec * 4 + threadIdx.x; i < len; i += kThreads)
      o[i] = mix(a[i], z[i], al, one_minus_al);
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) o[i] = mix(a[i], z[i], al, one_minus_al);
  }
}

}  // namespace

// audio (B, n) float32; bank (n_rows, w_cols) float32, the wrap-extended bank,
// w_cols >= n; rows and offs (B,) int64; alpha (B,) float32; out (B, n)
// float32. All contiguous. Returns cudaGetLastError() after the launch.
extern "C" int howl_mix_noise_bank_forward(const void* audio, const void* bank, const void* rows,
                                           const void* offs, const void* alpha, void* out, int B,
                                           int n, int n_rows, int w_cols, void* stream) {
  if (B == 0 || n == 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, B);
  mix_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(bank),
      static_cast<const long long*>(rows), static_cast<const long long*>(offs),
      static_cast<const float*>(alpha), static_cast<float*>(out), n, n_rows, w_cols);
  return static_cast<int>(cudaGetLastError());
}
