// What the TMA + wgmma attention kernels share (cross_attention.cu,
// cross_attention_bwd.cu, attention_core.cu and their *_wide.cu twins):
// one-head attention of any head width 1 <= D <= ATT_MAX_D = 512. A width
// runs on the smallest tile width DT in {32, 64, 128, 256, 512} that holds
// it (`att_tile`; `AttWidth<DT>`). An operand tile is 64 rows of a (rows,
// D) bf16 matrix held as 64 x 64 boxes of 128-byte rows, each 8 KB, loaded
// by TMA with the 128-byte swizzle: DT / 64 boxes side by side (one at DT
// = 32). The tensor map is D columns wide and TMA zero-fills the box past
// D, so the tile's columns past D are zeros and no second swizzle mode or
// descriptor layout is needed. TMA reads operands with a 16-byte-aligned
// base and rows of whole 16 bytes: the chains lay kv out as [k | 0 | v]
// with v at D rounded up to a multiple of 8 (flow_layer_cuda.kv_layout),
// so v is one at every D. wgmma reads a box K-major (as K in q k^T: keys are N, the dims
// are K) or MN-major (as V in P V: keys are K, dims are N) through the
// descriptor alone, so one tile in shared memory serves both products.
// q k^T takes DT / 16 k-steps (zero columns add exact zeros); P V runs one
// m64n64 product a box, and only the output's D columns are stored.
//
// Up to DT = 128 a block holds the whole tile of each operand and every
// output box (cross_attention.cu, cross_attention_bwd.cu,
// attention_core.cu). Past it (the *_wide.cu kernels) a block keeps its
// own tiles resident, streams the other side's one box at a time through
// a ring, sums the scores from partials of two boxes, and owns a group of the
// output's boxes: the blocks of one query (or key) tile recompute the
// scores, one group of output columns each, so the accumulators stay
// within the registers of two blocks to an SM. Past ATT_MAX_D the cluster
// tier (attention_cluster.cuh) builds on these parts.
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
constexpr int ATT_MAX_D = 512;            // the widest head the kernels take

// The tile widths DT, and the tile of each.
template <int DT>
struct AttWidth {
  static_assert(DT == 32 || DT == 64 || DT == 128 || DT == 256 || DT == 512,
                "the attention tiles are 32, 64, 128, 256 or 512 columns wide");
  static constexpr int BOXES = DT > ATT_BOX ? DT / ATT_BOX : 1;   // boxes a tile
  static constexpr int TILE_BYTES = BOXES * ATT_BOX_BYTES;
  static constexpr int BOX_COLS = DT < ATT_BOX ? DT : ATT_BOX;    // columns of a box in use
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

// Merges a (maximum, sum of exp(s - maximum)) pair into another; a pair
// with no key yet has maximum -inf and sum 0 (B10's online row sums).
__device__ __forceinline__ void merge_max_sum(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = l * exp_sub(m, mn) + l2 * exp_sub(m2, mn);
  m = mn;
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

// s (64 x 64, f32) += A @ B^T over one 64-column box of two tiles both
// read K-major (four k-steps); `first` overwrites s instead.
__device__ __forceinline__ void box_abt(float (&s)[32], const uint8_t* a, const uint8_t* b,
                                        bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64<0, 0>(s, smem_desc(a + kk * 32, 16, 1024), smem_desc(b + kk * 32, 16, 1024),
                       !first || kk > 0);
}

// One TMA load of a 64-row tile of a (rows, D) matrix at row `row` of
// `item`: its boxes side by side, completing on `bar`.
template <int DT>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int item) {
#pragma unroll
  for (int x = 0; x < AttWidth<DT>::BOXES; ++x)
    tma_load_3d(dst + x * ATT_BOX_BYTES, map, bar, x * ATT_BOX, row, item);
}

// Stores columns c and c + 1 of a row, those below n: as one pair where
// both are in and `pairs` (the row's pair alignment at column c, c even),
// else one at a time.
__device__ __forceinline__ void store2(bf16* p, int c, int n, float x, float y, bool pairs) {
  if (pairs && c + 1 < n) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
  } else {
    if (c < n) p[0] = f2bf(x);
    if (c + 1 < n) p[1] = f2bf(y);
  }
}
__device__ __forceinline__ void store2(float* p, int c, int n, float x, float y, bool pairs) {
  if (pairs && c + 1 < n) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    if (c < n) p[0] = x;
    if (c + 1 < n) p[1] = y;
  }
}

// Whether rows of `p` (row stride ld) can be written in pairs from even
// columns: a base aligned to a pair and an even stride.
template <typename T>
__device__ __forceinline__ bool pair_aligned(const T* p, int ld) {
  return (reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T))) == 0 && (ld & 1) == 0;
}

// The first of this thread's two accumulator rows and columns 2 (t % 4)
// within the warpgroup's 64 x 64 tile.
__device__ __forceinline__ int frag_row(int t) { return 16 * (t / 32) + (t % 32) / 4; }
__device__ __forceinline__ int frag_col(int t) { return 2 * (t % 4); }

// Stores this thread's part of a 64 x 64 f32 accumulator (its columns
// below ncols, of the first COLS) as f32 into `out` and bf16 into `out_b`
// at rows row0 + [0, 64) (rows >= nrows skipped) and column col0 of
// row-major matrices: in pairs where col0 leaves them aligned, else one
// element at a time (dv at an odd D).
template <int COLS>
__device__ __forceinline__ void store_tile(const float (&acc)[32], int t, int row0, int nrows,
                                           size_t row_base, float* out, int ldo, bf16* out_b,
                                           int ldob, int col0, int ncols) {
  const int fc = frag_col(t);
  const bool pairs = pair_aligned(out + col0, ldo) && pair_aligned(out_b + col0, ldob);
  const bool whole = pairs && ncols >= COLS;   // every store a pair
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + frag_row(t) + 8 * half;
    if (row >= nrows) continue;
    const size_t r = row_base + row;
    float* o = out + r * ldo + col0 + fc;
    bf16* ob = out_b + r * ldob + col0 + fc;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      const float x = acc[4 * j + 2 * half], y = acc[4 * j + 2 * half + 1];
      if (whole) {
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(x, y);
        *reinterpret_cast<uint32_t*>(ob + 8 * j) = pack_bf16(x, y);
      } else {
        store2(o + 8 * j, fc + 8 * j, ncols, x, y, pairs);
        store2(ob + 8 * j, fc + 8 * j, ncols, x, y, pairs);
      }
    }
  }
}

// The parity wait of stage `it % stages` for the it-th use of a ring.
__device__ __forceinline__ uint32_t ring_parity(int it, int stages) { return (it / stages) & 1; }

// Every warp of a consumer warpgroup hands a stage back (the ring's empty
// barriers count 4 arrivals a warpgroup) once its products are done.
__device__ __forceinline__ void release_stage(uint64_t* empty) {
  if (threadIdx.x % 32 == 0) mbar_arrive(empty);
}

// The wide forward kernels' producer thread (cross_attention_wide.cu,
// attention_core_wide.cu): the block's q tile (nb boxes) once on q_full,
// then the ring's schedule of 8 KB boxes: pass 1 each key tile's nb K
// boxes; pass 2 each key tile's K boxes, then the block's nob V boxes from
// box b0.
template <int STAGES>
__device__ __forceinline__ void wide_forward_loads(const CUtensorMap* tq, const CUtensorMap* tk,
                                                   const CUtensorMap* tv, uint8_t* qs,
                                                   uint8_t* ring, uint64_t* full,
                                                   uint64_t* empty, uint64_t* q_full, int nb,
                                                   int b0, int nob, int n_tiles, int q0,
                                                   int item) {
  prefetch_tensor_map(tq);
  prefetch_tensor_map(tk);
  prefetch_tensor_map(tv);
  mbar_expect_tx(q_full, nb * ATT_BOX_BYTES);
  for (int b = 0; b < nb; ++b)
    tma_load_3d(qs + b * ATT_BOX_BYTES, tq, q_full, b * ATT_BOX, q0, item);
  int it = 0;
  auto load = [&](const CUtensorMap* map, int col, int row) {
    const int s = it % STAGES;
    mbar_wait(&empty[s], ring_parity(it, STAGES) ^ 1);
    mbar_expect_tx(&full[s], ATT_BOX_BYTES);
    tma_load_3d(ring + s * ATT_BOX_BYTES, map, &full[s], col, row, item);
    ++it;
  };
  for (int j = 0; j < n_tiles; ++j)
    for (int b = 0; b < nb; ++b) load(tk, b * ATT_BOX, j * ATT_TILE);
  for (int j = 0; j < n_tiles; ++j) {
    for (int b = 0; b < nb; ++b) load(tk, b * ATT_BOX, j * ATT_TILE);
    for (int x = 0; x < nob; ++x) load(tv, (b0 + x) * ATT_BOX, j * ATT_TILE);
  }
}

// The boxes a fresh accumulator takes before the wide forward kernels add
// it to the scores in f32: the scores' error in one wgmma accumulator grew
// about linearly in D on the H100 (the row maximum's, 3.4e-7 relative at D
// = 64, 1.65e-6 at 512), so past D = 128, the most one accumulator takes in
// the one-block kernels, the forward's m, den and outputs sum the scores
// from partials of two boxes (half that error at 384 and 512).
constexpr int ATT_PART_BOXES = 2;

// s = A B^T over nb boxes: A's box b resident at a + b * 8 KB, B's boxes
// the ring's next nb stages (from use `it`, which this advances), in
// partials of ATT_PART_BOXES boxes (`part` is scratch); each stage goes
// back to the producer once its products are done.
template <int STAGES>
__device__ __forceinline__ void ring_abt(float (&s)[32], float (&part)[32], const uint8_t* a,
                                         const uint8_t* ring, uint64_t* full, uint64_t* empty,
                                         int& it, int nb) {
  for (int b0 = 0; b0 < nb; b0 += ATT_PART_BOXES) {
    const int n = min(ATT_PART_BOXES, nb - b0);
    for (int i = 0; i < n; ++i) mbar_wait(&full[(it + i) % STAGES], ring_parity(it + i, STAGES));
    wgmma_fence();
    for (int i = 0; i < n; ++i) {
      const uint8_t* ai = a + (b0 + i) * ATT_BOX_BYTES;
      const uint8_t* bi = ring + ((it + i) % STAGES) * ATT_BOX_BYTES;
      if (b0 == 0)
        box_abt(s, ai, bi, i == 0);
      else
        box_abt(part, ai, bi, i == 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(part);
    for (int i = 0; i < n; ++i) release_stage(&empty[(it + i) % STAGES]);
    if (b0 > 0)
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] += part[j];
    it += n;
  }
}

}  // namespace

// The kernels past 128 columns (the *_wide.cu files), called by the entry
// points of cross_attention.cu, cross_attention_bwd.cu and
// attention_core.cu with the same arguments at tiles of 256 and 512.
int cross_attention_wide(const void* q, int ldq, const void* k, const void* v, int ldkv,
                         void* out, int ldo, void* m_out, void* den_out, int n_items, int nq,
                         int nkv, int d, cudaStream_t stream);
int attention_bwd_wide(const void* q, int ldq, const void* k, const void* v, int ldkv,
                       const void* du, int lddu, const void* ddn, const void* mrow, void* dq,
                       int lddq, void* dq_b, int lddqb, void* dkv, int lddkv, void* dkv_b,
                       int lddkvb, int n_items, int nq, int nkv, int d, cudaStream_t stream);
int attention_core_wide(const void* q, int ldq, const void* k, int ldk, const void* v, int ldv,
                        void* out, int ldo, int n_items, int nq, int nkv, float scale, int d,
                        cudaStream_t stream);

// The tile width a head width d runs on: the smallest of 32, 64, 128, 256
// and 512 that holds it (0 past ATT_MAX_D).
inline int att_tile(int d) {
  if (d < 1 || d > ATT_MAX_D) return 0;
  int dt = 32;
  while (dt < d) dt *= 2;
  return dt;
}

// The 3-D tensor map of a (items*rows, d) bf16 operand (row stride ld) read
// in 64 x 64 boxes: columns past d are zero-filled, as are rows past an
// item's last.
inline cudaError_t att_tensor_map(CUtensorMap* map, const void* ptr, int items, int rows, int d,
                                  int ld) {
  return bf16_tensor_map_3d(map, ptr, items, rows, d, ld, ATT_BOX, ATT_TILE);
}
