// Stream-only leg of the frontend cost study for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_pallas_micro.py, run_stream (Pallas
// kernel stream_kernel): every (FB, 512) float32 block of the frames tensor
// x (total, 512) is staged on chip and out = x[:, :128] + s is written,
// (total, 128) float32. It is the product kernel's data movement
// (micro_gemm.cu) without the product, and shares its staging code
// (micro_common.cuh).
//
// What bounds it on this card: device memory. Each call stages total * 2 KB
// and writes total * 512 bytes; there is no arithmetic to speak of.
// The function alone needs a quarter of those reads, so the study's leg is
// bound by what it stages, above the bound of x[:, :128] + s itself.
//
// What the design does about it: a block stages 16 whole rows (32 KB) with
// one cp.async of 16 bytes per thread and round, waits, and writes the first
// 128 columns plus s from shared memory as float4. All 512 columns go
// through cp.async, which the compiler cannot eliminate although three
// quarters of the staged bytes are never read again. One round per block
// and 32 KB of shared memory let seven blocks share an SM, so about 220 KB
// of loads are in flight per SM while other blocks store. The add is one
// float32 add (__fadd_rn), bitwise what the plain version computes.
//
// The second entry, howl_hbm_stream_repro_forward, replaces
// tools/bench_hbm_sweep.py, make_stream_repro: the same function at any
// block height bn and in float32 or bf16, as the device-memory bandwidth
// sweep runs it. There one CTA owns a block of bn rows, as in the sweep's
// other legs, and walks it through a three-stage ring of 32 KB
// (hbm_common.cuh, walk_block): all 512 columns of every row go through
// cp.async, and the first 128 of each landed row plus s are stored, 16 bytes
// a thread, while the next two stages are in flight. In bf16, s is rounded to
// bf16 first and the float32 sum to nearest even.

#include "hbm_common.cuh"
#include "micro_common.cuh"

namespace {

constexpr int kRows = kStageFloats / kNfft;  // 16 rows per block

__global__ void __launch_bounds__(kThreads)
micro_stream_kernel(const float* __restrict__ x, float* __restrict__ out, int total, float s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);
  const int r0 = blockIdx.x * kRows;
  const float* src = x + static_cast<size_t>(r0) * kNfft;
  stage_f32(stage, src, src, kStageFloats, static_cast<long long>(total - r0) * kNfft);
  for (int i = threadIdx.x; i < kRows * (kOutCols / 4); i += kThreads) {
    const int row = i / (kOutCols / 4);
    const int c = (i % (kOutCols / 4)) * 4;
    if (r0 + row >= total) continue;
    float4 v = *reinterpret_cast<const float4*>(stage + row * kNfft + c);
    v.x = __fadd_rn(v.x, s);
    v.y = __fadd_rn(v.y, s);
    v.z = __fadd_rn(v.z, s);
    v.w = __fadd_rn(v.w, s);
    *reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + row) * kOutCols + c) = v;
  }
}

}  // namespace

// x (total, 512) float32, 16-byte aligned; out (total, 128) float32. Both
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int howl_micro_stream_forward(const void* x, void* out, int total, float s, void* stream) {
  if (total == 0) return 0;
  if (total < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (static_cast<unsigned>(total) + kRows - 1) / kRows;
  micro_stream_kernel<<<blocks, kThreads, kStageFloats * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), total, s);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <bool kBf16>
__global__ void __launch_bounds__(hbm::kThreads)
hbm_stream_repro_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out, int bn, float s) {
  extern __shared__ __align__(128) unsigned char ring[];
  constexpr int kRowBytes = hbm::kCols * (kBf16 ? 2 : 4);
  constexpr int kOutRowBytes = hbm::kCornerCols * (kBf16 ? 2 : 4);
  constexpr int kChunksPerRow = kOutRowBytes / 16;
  const long long block_bytes = static_cast<long long>(bn) * kRowBytes;
  unsigned char* dst = out + static_cast<long long>(blockIdx.x) * bn * kOutRowBytes;
  if (kBf16) s = hbm::bf16_round(s);
  hbm::walk_block(ring, x + blockIdx.x * block_bytes, block_bytes,
                  [&](const unsigned char* stage, long long base, int m) {
                    // a stage holds whole rows: its size and the ring's stage size are multiples of a row
                    unsigned char* to = dst + base / kRowBytes * kOutRowBytes;
                    for (int c = threadIdx.x; c < m / kRowBytes * kChunksPerRow; c += hbm::kThreads) {
                      const int row = c / kChunksPerRow;
                      const int q = (c % kChunksPerRow) * 16;
                      const uint4 v = *reinterpret_cast<const uint4*>(stage + row * kRowBytes + q);
                      *reinterpret_cast<uint4*>(to + row * kOutRowBytes + q) = hbm::add16<kBf16>(v, s);
                    }
                  });
}

}  // namespace

// x (rows, 512) float32 or bf16 (is_bf16), 16-byte aligned, rows a multiple
// of bn and bn at least 8; out (rows, 128) in x's dtype. Both contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int howl_hbm_stream_repro_forward(const void* x, void* out, int rows, int bn, int is_bf16, float s,
                                             void* stream) {
  const unsigned char* src = static_cast<const unsigned char*>(x);
  unsigned char* dst = static_cast<unsigned char*>(out);
  return is_bf16 ? hbm::launch_block_walk(hbm_stream_repro_kernel<true>, rows, bn, stream, src, dst, bn, s)
                 : hbm::launch_block_walk(hbm_stream_repro_kernel<false>, rows, bn, stream, src, dst, bn, s);
}
