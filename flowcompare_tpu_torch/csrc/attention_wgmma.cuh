// What the TMA + wgmma attention kernels share (cross_attention.cu,
// cross_attention_bwd.cu, attention_core.cu): one-head attention with head
// dimension D in {32, 64, 128} (`AttWidth`). An operand tile is 64 rows of a
// (rows, D) bf16 matrix held as 64 x 64 boxes of 128-byte rows, each 8 KB,
// loaded by TMA with the 128-byte swizzle: one box at D = 64, two side by
// side at D = 128 (columns 0-63, then 64-127), and one at D = 32 whose
// columns 32-63 TMA zero-fills (the tensor map is 32 columns wide, the box
// 64), so the 64-byte rows of D = 32 need no second swizzle mode or
// descriptor layout. wgmma reads a box K-major (as K in q k^T: keys are N,
// the dims are K) or MN-major (as V in P V: keys are K, dims are N) through
// the descriptor alone, so one tile in shared memory serves both products.
// q k^T takes D / 16 k-steps (the zero columns of D = 32 are never read);
// P V runs one m64n64 product a box, so at D = 32 its 32 zero columns are
// computed and never stored.
//
// A consumer warpgroup holds an m64n64 f32 accumulator as 32 registers a
// thread: thread t (of 128) holds rows r0 = 16 (t / 32) + (t % 32) / 4 and
// r0 + 8, columns 8 j + 2 (t % 4) and +1, j = 0..7, as acc[4 j + b] (b: bit
// 0 the column's +1, bit 1 the row's +8). The same layout, rounded to bf16
// in pairs, is wgmma's A-from-registers fragment (pack_a), so the scores
// never leave the registers between exp and the next product. An output
// of D columns is one such accumulator a box, acc[x] for columns 64 x on.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int ATT_TILE = 64;              // rows (keys or queries) per tile
constexpr int ATT_BOX = 64;               // columns of a box: one 128-byte swizzle row
constexpr int ATT_BOX_BYTES = ATT_TILE * ATT_BOX * 2;
constexpr float LOG2E = 1.4426950408889634f;

// The head widths the kernels take, and the tile of each.
template <int D>
struct AttWidth {
  static_assert(D == 32 || D == 64 || D == 128, "the attention kernels take D = 32, 64, 128");
  static constexpr int BOXES = D > ATT_BOX ? D / ATT_BOX : 1;   // boxes a tile
  static constexpr int TILE_BYTES = BOXES * ATT_BOX_BYTES;
  static constexpr int BOX_COLS = D < ATT_BOX ? D : ATT_BOX;    // stored columns of a box
};

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

// s (64 x 64, f32) = A @ B^T for two 64 x D tiles both read K-major (A's
// rows and B's rows are the output's rows and columns; the D dims are K):
// D / 16 k-steps, four to a box.
template <int D>
__device__ __forceinline__ void tile_abt(float (&s)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * ATT_BOX_BYTES + (kk % 4) * 32;
    wgmma_m64n64<0, 0>(s, smem_desc(a + off, 16, 1024), smem_desc(b + off, 16, 1024), kk > 0);
  }
}

// o (64 x 64, f32) += P @ B for P (64 x 64) in A registers and B a 64 x 64
// box read MN-major (its rows are K, its 64 dims the output's columns).
__device__ __forceinline__ void tile_pb(float (&o)[32], const uint32_t (&p)[16],
                                        const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_m64n64_rs<1>(o, a, smem_desc(b + kk * 2048, 8192, 1024));
  }
}

// One TMA load of a 64-row tile of a (rows, D) matrix at row `row` of
// `item`: its boxes side by side, completing on `bar`.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int item) {
#pragma unroll
  for (int x = 0; x < AttWidth<D>::BOXES; ++x)
    tma_load_3d(dst + x * ATT_BOX_BYTES, map, bar, x * ATT_BOX, row, item);
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

// The 3-D tensor map of a (items*rows, D) bf16 operand (row stride ld) read
// in 64 x 64 boxes: columns past D (at D = 32) are zero-filled, as are rows
// past an item's last.
template <int D>
inline cudaError_t att_tensor_map(CUtensorMap* map, const void* ptr, int items, int rows,
                                  int ld) {
  return bf16_tensor_map_3d(map, ptr, items, rows, D, ld, ATT_BOX, ATT_TILE);
}
