// cross_attention_bwd at head widths 128 < D <= 512 (tiles of 256 and 512
// columns, one template instance each), called by fc_attention_bwd
// (cross_attention_bwd.cu) with its arguments and its contract: from the
// forward's row maximum m, du = da / den and ddn, per item
//
//   dv = bf16(e)^T du        dS = bf16(e * (du v^T + ddn))
//   dq = dS k                dk = dS^T q
//
// in f32 and bf16, with no atomics (deterministic).
//
// Why another kernel: cross_attention_bwd.cu's blocks hold their own two
// tiles and stages of the other side's two (48 KB a stage at D = 512),
// and their outputs in registers.
//
// Design (TMA + wgmma on sm_90a, the parts of attention_wgmma.cuh), one
// launch of two kinds of block as in cross_attention_bwd.cu:
//  * a dq block takes 64 query rows and a group of DQ_OUT_BOXES = 2 boxes
//    of dq (128 columns): it keeps its Q and dU tiles, streams each key
//    tile's K and V boxes through a ring of 8 KB stages, accumulating S = Q
//    K^T and dP = dU V^T box by box (`score_boxes`), forms dS = bf16(e (dP
//    + ddn)) in wgmma's A registers, and
//    adds dS K for its group's K boxes, which the producer streams again
//    after the scores' boxes (from L2);
//  * a dkv block takes 64 keys and one box of dk and of dv: it keeps its K
//    and V tiles, streams each query tile's Q and dU boxes, accumulates S^T
//    = K Q^T and dP^T = V dU^T, and adds bf16(e^T) dU and dS^T Q for its
//    box's dU and Q boxes, streamed again after the scores'. The query
//    tile's m and ddn are staged by the producer warp in a double buffer
//    with barriers of their own;
//  * every block of a tile recomputes the scores over all D columns in the
//    same order, so the blocks of a tile share e bit for bit;
//  * at the 256-column tile two blocks share an SM (own tiles 64 KB, 5
//    stages); at the 512-column tile the own tiles are 128 KB and one block
//    takes an SM (8 stages).
// Ragged tiles, masks, zero-filled columns past D and stores as in
// cross_attention_bwd.cu.
#include "attention_wgmma.cuh"

namespace {

constexpr int WIDE_THREADS = 128 + 32;
constexpr int DQ_OUT_BOXES = 2;   // boxes of dq a dq block

template <int DT>
struct BwdWide {
  static constexpr int KB = DT / ATT_BOX;   // boxes of an own tile
  static constexpr int STAGES = DT == 512 ? 8 : 5;
  static constexpr int MIN_BLOCKS = DT == 512 ? 1 : 2;
  static constexpr int SMEM = (2 * KB + STAGES) * ATT_BOX_BYTES + 1024;
  // each block's shared memory, its static barriers and m / ddn buffers,
  // and the 1 KB the card keeps a block
  static_assert(MIN_BLOCKS * (SMEM + 3072) <= 233472, "the blocks do not fit an SM");
};

// The two score products over nb boxes: s = A1 B1^T and p = A2 B2^T, A1's
// and A2's box b resident at a1 / a2 + b * 8 KB, B1's and B2's boxes
// interleaved in the ring (B1's box b at use it + 2 b, B2's at it + 2 b +
// 1), both summed in one accumulator each with one box's two groups of
// products in flight: a box's stages go back to the producer once the next
// box's products are issued and its own have completed. The forward sums
// its scores from partials of two boxes (`ring_abt`), which wait for each
// pair; here the two products' groups stay in flight instead, and e differs
// from the forward's by the scores' f32 rounding (about 1e-6 of s).
template <int STAGES>
__device__ __forceinline__ void score_boxes(float (&s)[32], float (&p)[32], const uint8_t* a1,
                                            const uint8_t* a2, const uint8_t* ring,
                                            uint64_t* full, uint64_t* empty, int& it, int nb) {
  constexpr int BB = ATT_BOX_BYTES;
  wgmma_fence();
  for (int b = 0; b < nb; ++b) {
    const int s1 = it % STAGES, s2 = (it + 1) % STAGES;
    mbar_wait(&full[s1], ring_parity(it, STAGES));
    box_abt(s, a1 + b * BB, ring + s1 * BB, b == 0);
    wgmma_commit();
    mbar_wait(&full[s2], ring_parity(it + 1, STAGES));
    box_abt(p, a2 + b * BB, ring + s2 * BB, b == 0);
    wgmma_commit();
    if (b > 0) {
      wgmma_wait<2>();
      release_stage(&empty[(it - 2) % STAGES]);
      release_stage(&empty[(it - 1) % STAGES]);
    }
    it += 2;
  }
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(p);
  release_stage(&empty[(it - 2) % STAGES]);
  release_stage(&empty[(it - 1) % STAGES]);
}

template <int DT>
__device__ __forceinline__ void bwd_wide_dq_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                                  const CUtensorMap& tv, const CUtensorMap& tdu,
                                                  int d,
                                                  const float* __restrict__ ddn,
                                                  const float* __restrict__ mrow,
                                                  float* __restrict__ dq, int lddq,
                                                  bf16* __restrict__ dq_b, int lddqb, int nq,
                                                  int nkv, int block) {
  using B = BwdWide<DT>;
  constexpr int STAGES = B::STAGES, BB = ATT_BOX_BYTES, OB = DQ_OUT_BOXES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], own_full;
  uint8_t* const own = align1024(smem_raw);   // Q boxes, then dU boxes from box KB
  uint8_t* const ring = own + 2 * B::KB * BB;
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int groups = (nb + OB - 1) / OB;
  const int item = blockIdx.y, q0 = (block / groups) * ATT_TILE;
  const int b0 = (block % groups) * OB;
  const int nob = min(OB, nb - b0);
  const int n_tiles = (nkv + ATT_TILE - 1) / ATT_TILE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(&own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer: Q and dU once, then per key tile its K and V boxes in
    // turn, then the group's K boxes again
    if (threadIdx.x == 128) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      prefetch_tensor_map(&tdu);
      mbar_expect_tx(&own_full, 2 * nb * BB);
      for (int b = 0; b < nb; ++b) {
        tma_load_3d(own + b * BB, &tq, &own_full, b * ATT_BOX, q0, item);
        tma_load_3d(own + (B::KB + b) * BB, &tdu, &own_full, b * ATT_BOX, q0, item);
      }
      int it = 0;
      auto load = [&](const CUtensorMap* map, int col, int row) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ring_parity(it, STAGES) ^ 1);
        mbar_expect_tx(&full[s], BB);
        tma_load_3d(ring + s * BB, map, &full[s], col, row, item);
        ++it;
      };
      for (int j = 0; j < n_tiles; ++j) {
        for (int b = 0; b < nb; ++b) {
          load(&tk, b * ATT_BOX, j * ATT_TILE);
          load(&tv, b * ATT_BOX, j * ATT_TILE);
        }
        for (int x = 0; x < nob; ++x) load(&tk, (b0 + x) * ATT_BOX, j * ATT_TILE);
      }
    }
    return;
  }

  // the consumer warpgroup: query rows q0 + [0, 64)
  const int t = threadIdx.x;
  const int fc = frag_col(t);
  float mr[2], dd[2];   // m and ddn of rows r0 and r0 + 8 (+inf and 0 past nq)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + frag_row(t) + 8 * half;
    const size_t r = (size_t)item * nq + row;
    mr[half] = row < nq ? mrow[r] : INFINITY;
    dd[half] = row < nq ? ddn[r] : 0.f;
  }
  float s[32], dp[32], acc[OB][32];
#pragma unroll
  for (int x = 0; x < OB; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  mbar_wait(&own_full, 0);
  int it = 0;
  for (int j = 0; j < n_tiles; ++j) {
    // S = Q K^T and dP = dU V^T, box by box
    score_boxes<STAGES>(s, dp, own, own + B::KB * BB, ring, full, empty, it, nb);
    const int c0 = j * ATT_TILE + fc;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const bool ok = c0 + 8 * jj + b < nkv;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * jj + 2 * half + b;
          const float e = ok ? exp_sub(s[i], mr[half]) : 0.f;
          s[i] = e * (dp[i] + dd[half]);      // dS, rounded to bf16 by pack_a
        }
      }
    }
    uint32_t p[16];
    pack_a(s, p);
    // dq += dS K over the group's K boxes (read MN-major)
#pragma unroll
    for (int x = 0; x < OB; ++x)
      if (x < nob) mbar_wait(&full[(it + x) % STAGES], ring_parity(it + x, STAGES));
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < OB; ++x)
      if (x < nob) tile_pb(acc[x], p, ring + ((it + x) % STAGES) * BB);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < OB; ++x) fence_acc(acc[x]);
#pragma unroll
    for (int x = 0; x < OB; ++x)
      if (x < nob) release_stage(&empty[(it + x) % STAGES]);
    it += nob;
  }
#pragma unroll
  for (int x = 0; x < OB; ++x)
    if (x < nob)
      store_tile<ATT_BOX>(acc[x], t, q0, nq, (size_t)item * nq, dq, lddq, dq_b, lddqb,
                          (b0 + x) * ATT_BOX, d - (b0 + x) * ATT_BOX);
}

template <int DT>
__device__ __forceinline__ void bwd_wide_dkv_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                                   const CUtensorMap& tv, const CUtensorMap& tdu,
                                                   int d,
                                                   const float* __restrict__ ddn,
                                                   const float* __restrict__ mrow,
                                                   float* __restrict__ dkv, int lddkv,
                                                   bf16* __restrict__ dkv_b, int lddkvb, int nq,
                                                   int nkv, int block) {
  using B = BwdWide<DT>;
  constexpr int STAGES = B::STAGES, BB = ATT_BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], own_full, ml_full[2], ml_empty[2];
  // each query tile's m (+inf past nq) and ddn (0 past nq), double-buffered
  __shared__ __align__(16) float ml_s[2][ATT_TILE], dd_s[2][ATT_TILE];
  uint8_t* const own = align1024(smem_raw);   // K boxes, then V boxes from box KB
  uint8_t* const ring = own + 2 * B::KB * BB;
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int box = block % nb;   // this block's box of dk and dv
  const int item = blockIdx.y, k0 = (block / nb) * ATT_TILE;
  const int n_tiles = (nq + ATT_TILE - 1) / ATT_TILE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(&own_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&ml_full[s], 32);   // the producer warp's lanes
      mbar_init(&ml_empty[s], 4);   // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer warp: every lane stages m and ddn; lane 0 loads K and V
    // once, then per query tile its Q and dU boxes in turn, then the box's
    // dU and Q boxes again
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      prefetch_tensor_map(&tdu);
      mbar_expect_tx(&own_full, 2 * nb * BB);
      for (int b = 0; b < nb; ++b) {
        tma_load_3d(own + b * BB, &tk, &own_full, b * ATT_BOX, k0, item);
        tma_load_3d(own + (B::KB + b) * BB, &tv, &own_full, b * ATT_BOX, k0, item);
      }
    }
    int it = 0;
    auto load = [&](const CUtensorMap* map, int col, int row) {
      const int s = it % STAGES;
      mbar_wait(&empty[s], ring_parity(it, STAGES) ^ 1);
      mbar_expect_tx(&full[s], BB);
      tma_load_3d(ring + s * BB, map, &full[s], col, row, item);
      ++it;
    };
    for (int i = 0; i < n_tiles; ++i) {
      const int slot = i % 2, i0 = i * ATT_TILE;
      mbar_wait(&ml_empty[slot], ring_parity(i, 2) ^ 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = lane + 32 * h, qi = i0 + idx;
        const size_t r = (size_t)item * nq + qi;
        ml_s[slot][idx] = qi < nq ? mrow[r] : INFINITY;
        dd_s[slot][idx] = qi < nq ? ddn[r] : 0.f;
      }
      mbar_arrive(&ml_full[slot]);
      if (lane == 0) {
        for (int b = 0; b < nb; ++b) {
          load(&tq, b * ATT_BOX, i0);
          load(&tdu, b * ATT_BOX, i0);
        }
        load(&tdu, box * ATT_BOX, i0);
        load(&tq, box * ATT_BOX, i0);
      }
    }
    return;
  }

  // the consumer warpgroup: keys k0 + [0, 64)
  const int t = threadIdx.x;
  const int fc = frag_col(t);
  float s[32], dp[32], dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&own_full, 0);
  int it = 0;
  for (int i = 0; i < n_tiles; ++i) {
    // S^T = K Q^T and dP^T = V dU^T, box by box
    score_boxes<STAGES>(s, dp, own, own + B::KB * BB, ring, full, empty, it, nb);
    const int slot = i % 2;
    mbar_wait(&ml_full[slot], ring_parity(i, 2));
    const int c0 = i * ATT_TILE + fc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 mlc = *reinterpret_cast<const float2*>(&ml_s[slot][8 * j + fc]);
      const float2 ddc = *reinterpret_cast<const float2*>(&dd_s[slot][8 * j + fc]);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const bool ok = c0 + 8 * j + b < nq;
        const float m_c = b ? mlc.y : mlc.x, d_c = b ? ddc.y : ddc.x;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = 4 * j + 2 * half + b;
          const float e = ok ? exp_sub(s[k], m_c) : 0.f;
          s[k] = e;                     // e^T, rounded to bf16 by pack_a
          dp[k] = e * (dp[k] + d_c);    // dS^T, likewise
        }
      }
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&ml_empty[slot]);
    uint32_t pe[16], pd[16];
    pack_a(s, pe);
    pack_a(dp, pd);
    const int su = it % STAGES, sq = (it + 1) % STAGES;
    mbar_wait(&full[su], ring_parity(it, STAGES));
    mbar_wait(&full[sq], ring_parity(it + 1, STAGES));
    wgmma_fence();
    tile_pb(dv, pe, ring + su * BB);   // dv += bf16(e^T) dU (dU read MN-major)
    tile_pb(dk, pd, ring + sq * BB);   // dk += dS^T Q (Q read MN-major)
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    release_stage(&empty[su]);
    release_stage(&empty[sq]);
    it += 2;
  }
  const size_t base = (size_t)item * nkv;
  store_tile<ATT_BOX>(dk, t, k0, nkv, base, dkv, lddkv, dkv_b, lddkvb, box * ATT_BOX,
                      d - box * ATT_BOX);
  store_tile<ATT_BOX>(dv, t, k0, nkv, base, dkv, lddkv, dkv_b, lddkvb, d + box * ATT_BOX,
                      d - box * ATT_BOX);
}

// One launch for both kinds of block: blocks [0, dq_blocks) of each item
// take (query tile, group of dq boxes), the rest (key tile, box of dk/dv).
template <int DT>
__global__ void __launch_bounds__(WIDE_THREADS, BwdWide<DT>::MIN_BLOCKS)
    attn_bwd_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdu, int d,
                         const float* __restrict__ ddn, const float* __restrict__ mrow,
                         float* __restrict__ dq, int lddq, bf16* __restrict__ dq_b, int lddqb,
                         float* __restrict__ dkv, int lddkv, bf16* __restrict__ dkv_b,
                         int lddkvb, int nq, int nkv, int dq_blocks) {
  if ((int)blockIdx.x < dq_blocks)
    bwd_wide_dq_block<DT>(tq, tk, tv, tdu, d, ddn, mrow, dq, lddq, dq_b, lddqb, nq, nkv,
                          blockIdx.x);
  else
    bwd_wide_dkv_block<DT>(tq, tk, tv, tdu, d, ddn, mrow, dkv, lddkv, dkv_b, lddkvb, nq,
                           nkv, blockIdx.x - dq_blocks);
}

template <int DT>
int launch_bwd_wide(const void* q, int ldq, const void* k, const void* v, int ldkv,
                    const void* du, int lddu, const void* ddn, const void* mrow, void* dq,
                    int lddq, void* dq_b, int lddqb, void* dkv, int lddkv, void* dkv_b,
                    int lddkvb, int n_items, int nq, int nkv, int d, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdu;
  cudaError_t err = att_tensor_map(&tq, q, n_items, nq, d, ldq);
  if (err == cudaSuccess) err = att_tensor_map(&tk, k, n_items, nkv, d, ldkv);
  if (err == cudaSuccess) err = att_tensor_map(&tv, v, n_items, nkv, d, ldkv);
  if (err == cudaSuccess) err = att_tensor_map(&tdu, du, n_items, nq, d, lddu);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set = false;   // the shared-memory opt-in, once a tile
  if (!smem_set) {
    err = cudaFuncSetAttribute(attn_bwd_wide_kernel<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BwdWide<DT>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int dq_blocks = ((nq + ATT_TILE - 1) / ATT_TILE) * ((nb + DQ_OUT_BOXES - 1) / DQ_OUT_BOXES);
  const dim3 grid(dq_blocks + nb * ((nkv + ATT_TILE - 1) / ATT_TILE), n_items);
  attn_bwd_wide_kernel<DT><<<grid, WIDE_THREADS, BwdWide<DT>::SMEM, stream>>>(
      tq, tk, tv, tdu, d, (const float*)ddn, (const float*)mrow, (float*)dq, lddq,
      (bf16*)dq_b, lddqb, (float*)dkv, lddkv, (bf16*)dkv_b, lddkvb, nq, nkv, dq_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

int attention_bwd_wide(const void* q, int ldq, const void* k, const void* v, int ldkv,
                       const void* du, int lddu, const void* ddn, const void* mrow, void* dq,
                       int lddq, void* dq_b, int lddqb, void* dkv, int lddkv, void* dkv_b,
                       int lddkvb, int n_items, int nq, int nkv, int d, cudaStream_t stream) {
#define FC_BWD_WIDE(DT)                                                                    \
  launch_bwd_wide<DT>(q, ldq, k, v, ldkv, du, lddu, ddn, mrow, dq, lddq, dq_b, lddqb, dkv, \
                      lddkv, dkv_b, lddkvb, n_items, nq, nkv, d, stream)
  switch (att_tile(d)) {
    case 256: return FC_BWD_WIDE(256);
    case 512: return FC_BWD_WIDE(512);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FC_BWD_WIDE
}
