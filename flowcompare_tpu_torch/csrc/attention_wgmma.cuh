// What the TMA + wgmma cross attention kernels share (cross_attention.cu,
// cross_attention_bwd.cu): one-head attention with head dimension 64, so
// every operand tile is a 64 x 64 bf16 box of a (rows, 64) matrix, 8 KB of
// 128-byte rows, loaded by TMA with the 128-byte swizzle. wgmma reads such a
// tile K-major (as K in q k^T: keys are N, the 64 dims are K) or MN-major
// (as V in P V: keys are K, dims are N) through the descriptor alone, so one
// tile in shared memory serves both products.
//
// A consumer warpgroup holds an m64n64 f32 accumulator as 32 registers a
// thread: thread t (of 128) holds rows r0 = 16 (t / 32) + (t % 32) / 4 and
// r0 + 8, columns 8 j + 2 (t % 4) and +1, j = 0..7, as acc[4 j + b] (b: bit
// 0 the column's +1, bit 1 the row's +8). The same layout, rounded to bf16
// in pairs, is wgmma's A-from-registers fragment (pack_a), so the scores
// never leave the registers between exp and the next product.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int ATT_D = 64;                 // head dimension
constexpr int ATT_TILE = 64;              // rows (keys or queries) per tile
constexpr int ATT_TILE_BYTES = 64 * 64 * 2;
constexpr float LOG2E = 1.4426950408889634f;

// exp(s - m) as 2^((s - m) log2(e)) on the SFU (ex2.approx, subnormal
// results flushed to 0); m = +inf gives 0. s - m is formed first, as the
// plain version does: folding log2(e) into one FMA, s log2(e) - m log2(e),
// would round m log2(e) at m's magnitude and cost 1e-4 of e where |m| is
// in the thousands.
__device__ __forceinline__ float exp_sub(float s, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((s - m) * LOG2E));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The bf16 A fragment (16 registers, 4 a k-step) of an m64n64 accumulator.
__device__ __forceinline__ void pack_a(const float (&acc)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// s (64 x 64, f32) = A @ B^T for two 64 x 64 tiles both read K-major (A's
// rows and B's rows are the output's rows and columns; the 64 dims are K).
__device__ __forceinline__ void tile_abt(float (&s)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64<0, 0>(s, smem_desc(a + kk * 32, 16, 1024), smem_desc(b + kk * 32, 16, 1024),
                       kk > 0);
}

// o (64 x 64, f32) += P @ B for P (64 x 64) in A registers and B a 64 x 64
// tile read MN-major (its rows are K, its 64 dims the output's columns).
__device__ __forceinline__ void tile_pb(float (&o)[32], const uint32_t (&p)[16],
                                        const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_m64n64_rs<1>(o, a, smem_desc(b + kk * 2048, 8192, 1024));
  }
}

// The first of this thread's two accumulator rows and columns 2 (t % 4)
// within the warpgroup's 64 x 64 tile.
__device__ __forceinline__ int frag_row(int t) { return 16 * (t / 32) + (t % 32) / 4; }
__device__ __forceinline__ int frag_col(int t) { return 2 * (t % 4); }

// The parity wait of stage `it % stages` for the it-th use of a ring.
__device__ __forceinline__ uint32_t ring_parity(int it, int stages) { return (it / stages) & 1; }

// Every warp of a consumer warpgroup hands a stage back (the ring's empty
// barriers count 4 arrivals a warpgroup) once its products are done.
__device__ __forceinline__ void release_stage(uint64_t* empty) {
  if (threadIdx.x % 32 == 0) mbar_arrive(empty);
}

}  // namespace
