// cross_attention_bwd at head widths up to 1,024 on thread-block clusters
// (the tier past 512; attention_cluster.cuh), with fc_attention_bwd's
// arguments and contract: from the forward's row maximum m, du = da / den
// and ddn, per item
//
//   dv = bf16(e)^T du        dS = bf16(e * (du v^T + ddn))
//   dq = dS k                dk = dS^T q
//
// in f32 and bf16, with no atomics (deterministic). The attention's
// transpose in B5 (flowcompare_tpu/ops/flow_layer_vjp_pallas.py:206), past
// the widths cross_attention_bwd.cu and cross_attention_bwd_wide.cu take.
//
// What bounds it on the H100: five D-deep products a score (S and dP in
// each kind of cluster, dq, dk, dv), 10 D operations a score, at the
// tensor cores' rate.
//
// Design: one launch of two kinds of cluster, G = ceil(D / 128) blocks
// each, block g owning columns [128 g, 128 g + 128):
//  * a dq cluster takes 64 query rows: block g keeps its Q and dU boxes,
//    streams each key tile's V and then K boxes of its columns, forms the
//    partials S_g = Q_g K_g^T and dP_g = dU_g V_g^T in fresh accumulators,
//    hands the V stages back and sums both partials across the cluster
//    (one exchange of the two 64 x 64 tiles); then dS = bf16(e (dP + ddn))
//    in wgmma's A registers and dq_g += dS K_g from the K stages it kept;
//  * a dkv cluster takes 64 keys: block g keeps its K and V boxes, streams
//    each query tile's Q and dU boxes of its columns, sums S^T = K Q^T and
//    dP^T = V dU^T across the cluster the same way, and adds bf16(e^T) dU_g
//    and dS^T Q_g into its dk and dv boxes. The query tile's m and ddn are
//    staged in shared memory by the block's first 64 threads, double-
//    buffered by the tile's parity (the exchange's barriers order them);
//  * the scores' partials are 128 columns in a fresh accumulator summed in
//    column order, as in the forward cluster: the wide backward sums all
//    of D in one accumulator, so at D = 512 the two differ by the scores'
//    f32 rounding (about 1e-6 of s), as the wide backward and the forward
//    already did;
//  * two blocks to an SM: own slices 32 KB, the exchange 32 KB, a ring of
//    BWD_STAGES 8 KB stages.
// Ragged tiles, masks, zero-filled columns past D and stores as in
// cross_attention_bwd_wide.cu.
#include "attention_cluster.cuh"

namespace {

constexpr int BWD_STAGES = 5;
// own slices (4 boxes), the ring, the exchange of two score tiles (32 KB)
constexpr int BWD_SMEM = (2 * CL_BOXES + BWD_STAGES + 4) * ATT_BOX_BYTES + 1024;
static_assert(2 * (BWD_SMEM + 3072) <= 233472, "two blocks do not fit an SM");

// The dq clusters' schedule: per key tile the block's V boxes, then its K
// boxes (V handed back after the scores, K after dq's product).
struct DqLoads {
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  int g0, nob, n_tiles, item;
  __device__ __forceinline__ bool has(int u) const { return u < 2 * n_tiles * nob; }
  __device__ __forceinline__ void load(int u, uint8_t* dst, uint64_t* bar) const {
    const int j = u / (2 * nob), r = u % (2 * nob);
    tma_load_3d(dst, r < nob ? tv : tk, bar, (g0 + r % nob) * ATT_BOX, j * ATT_TILE, item);
  }
};

// The dkv clusters' schedule: per query tile the block's Q boxes, then its
// dU boxes.
struct DkvLoads {
  const CUtensorMap* tq;
  const CUtensorMap* tdu;
  int g0, nob, n_tiles, item;
  __device__ __forceinline__ bool has(int u) const { return u < 2 * n_tiles * nob; }
  __device__ __forceinline__ void load(int u, uint8_t* dst, uint64_t* bar) const {
    const int i = u / (2 * nob), r = u % (2 * nob);
    tma_load_3d(dst, r < nob ? tq : tdu, bar, (g0 + r % nob) * ATT_BOX, i * ATT_TILE, item);
  }
};

// The two partials s = A1 B1^T and p = A2 B2^T over the block's nob boxes:
// A1's and A2's box x resident at a1 / a2 + x * 8 KB, B1's boxes the ring's
// uses first1 + x, B2's first2 + x; each into a fresh accumulator.
__device__ __forceinline__ void two_partials(float (&s)[32], float (&p)[32], const uint8_t* a1,
                                             const uint8_t* a2,
                                             const ClusterRing<BWD_STAGES>& ring, int first1,
                                             int first2, int nob) {
#pragma unroll
  for (int x = 0; x < CL_BOXES; ++x)
    if (x < nob) {
      ring.wait(first1 + x);
      ring.wait(first2 + x);
    }
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < CL_BOXES; ++x)
    if (x < nob) box_abt(s, a1 + x * ATT_BOX_BYTES, ring.stage(first1 + x), x == 0);
#pragma unroll
  for (int x = 0; x < CL_BOXES; ++x)
    if (x < nob) box_abt(p, a2 + x * ATT_BOX_BYTES, ring.stage(first2 + x), x == 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(p);
}

// Both score tiles of this block summed across the cluster (`xbuf` holds
// two tiles).
__device__ __forceinline__ void exchange_two(float* xbuf, float (&s)[32], float (&p)[32], int g,
                                             int blocks) {
  put_frag(xbuf, s);
  put_frag(xbuf + CL_TILE_FLOATS, p);
  cluster_sum(xbuf, g, blocks, 2 * CL_TILE_FLOATS / 4);
  get_frag(xbuf, s);
  get_frag(xbuf + CL_TILE_FLOATS, p);
}

__device__ __forceinline__ void bwd_cluster_dq(const CUtensorMap& tq, const CUtensorMap& tk,
                                               const CUtensorMap& tv, const CUtensorMap& tdu,
                                               int d, const float* __restrict__ ddn,
                                               const float* __restrict__ mrow,
                                               float* __restrict__ dq, int lddq,
                                               bf16* __restrict__ dq_b, int lddqb, int nq,
                                               int nkv, int tile) {
  constexpr int BB = ATT_BOX_BYTES, OB = CL_BOXES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[BWD_STAGES], empty[BWD_STAGES], own_full;
  uint8_t* const own = align1024(smem_raw);   // Q boxes, then dU boxes from box OB
  uint8_t* const ring_base = own + 2 * OB * BB;
  float* const xbuf = reinterpret_cast<float*>(ring_base + BWD_STAGES * BB);
  const int g = cluster_rank(), blocks = cluster_blocks();
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int g0 = g * OB, nob = min(OB, nb - g0);
  const int item = blockIdx.y, q0 = tile * ATT_TILE;
  const int n_tiles = (nkv + ATT_TILE - 1) / ATT_TILE;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(&own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const DqLoads loads{&tk, &tv, g0, nob, n_tiles, item};
  ClusterRing<BWD_STAGES> ring{ring_base, full, empty};
  if (t == 0) {
    prefetch_tensor_map(&tq);
    prefetch_tensor_map(&tk);
    prefetch_tensor_map(&tv);
    prefetch_tensor_map(&tdu);
    mbar_expect_tx(&own_full, 2 * nob * BB);
    for (int x = 0; x < nob; ++x) {
      tma_load_3d(own + x * BB, &tq, &own_full, (g0 + x) * ATT_BOX, q0, item);
      tma_load_3d(own + (OB + x) * BB, &tdu, &own_full, (g0 + x) * ATT_BOX, q0, item);
    }
    ring.fill(loads);
  }
  __syncwarp();

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
  for (int j = 0; j < n_tiles; ++j) {
    // S_g = Q_g K_g^T (K: the uses after V's) and dP_g = dU_g V_g^T, then
    // the V stages go back and both are summed over the cluster
    two_partials(s, dp, own, own + OB * BB, ring, nob, 0, nob);
    ring.advance(nob, loads);
    exchange_two(xbuf, s, dp, g, blocks);
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
    // dq_g += dS K_g over the block's K boxes (read MN-major), still staged
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < OB; ++x)
      if (x < nob) tile_pb(acc[x], p, ring.stage(x));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < OB; ++x) fence_acc(acc[x]);
    ring.advance(nob, loads);
  }
#pragma unroll
  for (int x = 0; x < OB; ++x)
    if (x < nob)
      store_tile<ATT_BOX>(acc[x], t, q0, nq, (size_t)item * nq, dq, lddq, dq_b, lddqb,
                          (g0 + x) * ATT_BOX, d - (g0 + x) * ATT_BOX);
  cluster_sync();   // no block leaves while a neighbour may read its buffer
}

__device__ __forceinline__ void bwd_cluster_dkv(const CUtensorMap& tq, const CUtensorMap& tk,
                                                const CUtensorMap& tv, const CUtensorMap& tdu,
                                                int d, const float* __restrict__ ddn,
                                                const float* __restrict__ mrow,
                                                float* __restrict__ dkv, int lddkv,
                                                bf16* __restrict__ dkv_b, int lddkvb, int nq,
                                                int nkv, int tile) {
  constexpr int BB = ATT_BOX_BYTES, OB = CL_BOXES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[BWD_STAGES], empty[BWD_STAGES], own_full;
  // each query tile's m (+inf past nq) and ddn (0 past nq), by the tile's parity
  __shared__ __align__(16) float ml_s[2][ATT_TILE], dd_s[2][ATT_TILE];
  uint8_t* const own = align1024(smem_raw);   // K boxes, then V boxes from box OB
  uint8_t* const ring_base = own + 2 * OB * BB;
  float* const xbuf = reinterpret_cast<float*>(ring_base + BWD_STAGES * BB);
  const int g = cluster_rank(), blocks = cluster_blocks();
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int g0 = g * OB, nob = min(OB, nb - g0);
  const int item = blockIdx.y, k0 = tile * ATT_TILE;
  const int n_tiles = (nq + ATT_TILE - 1) / ATT_TILE;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(&own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const DkvLoads loads{&tq, &tdu, g0, nob, n_tiles, item};
  ClusterRing<BWD_STAGES> ring{ring_base, full, empty};
  if (t == 0) {
    prefetch_tensor_map(&tq);
    prefetch_tensor_map(&tk);
    prefetch_tensor_map(&tv);
    prefetch_tensor_map(&tdu);
    mbar_expect_tx(&own_full, 2 * nob * BB);
    for (int x = 0; x < nob; ++x) {
      tma_load_3d(own + x * BB, &tk, &own_full, (g0 + x) * ATT_BOX, k0, item);
      tma_load_3d(own + (OB + x) * BB, &tv, &own_full, (g0 + x) * ATT_BOX, k0, item);
    }
    ring.fill(loads);
  }
  __syncwarp();

  const int fc = frag_col(t);
  float s[32], dp[32], dk[OB][32], dv[OB][32];
#pragma unroll
  for (int x = 0; x < OB; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[x][i] = dv[x][i] = 0.f;
  mbar_wait(&own_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i & 1, i0 = i * ATT_TILE;
    if (t < ATT_TILE) {   // read after the exchange's barriers
      const int qi = i0 + t;
      const size_t r = (size_t)item * nq + qi;
      ml_s[slot][t] = qi < nq ? mrow[r] : INFINITY;
      dd_s[slot][t] = qi < nq ? ddn[r] : 0.f;
    }
    // S^T = K_g Q_g^T and dP^T = V_g dU_g^T, summed over the cluster
    two_partials(s, dp, own, own + OB * BB, ring, 0, nob, nob);
    exchange_two(xbuf, s, dp, g, blocks);
    const int c0 = i0 + fc;
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
    uint32_t pe[16], pd[16];
    pack_a(s, pe);
    pack_a(dp, pd);
    // dv_g += bf16(e^T) dU_g and dk_g += dS^T Q_g (dU and Q read MN-major)
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < OB; ++x)
      if (x < nob) {
        tile_pb(dv[x], pe, ring.stage(nob + x));
        tile_pb(dk[x], pd, ring.stage(x));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < OB; ++x) {
      fence_acc(dv[x]);
      fence_acc(dk[x]);
    }
    ring.advance(2 * nob, loads);
  }
  const size_t base = (size_t)item * nkv;
#pragma unroll
  for (int x = 0; x < OB; ++x)
    if (x < nob) {
      const int col = (g0 + x) * ATT_BOX;
      store_tile<ATT_BOX>(dk[x], t, k0, nkv, base, dkv, lddkv, dkv_b, lddkvb, col, d - col);
      store_tile<ATT_BOX>(dv[x], t, k0, nkv, base, dkv, lddkv, dkv_b, lddkvb, d + col, d - col);
    }
  cluster_sync();   // no block leaves while a neighbour may read its buffer
}

// One launch for both kinds of cluster: the first dq_blocks blocks of each
// item's row are the dq clusters (one a query tile), the rest the dkv
// clusters (one a key tile); every cluster lies within one kind.
__global__ void __launch_bounds__(CL_THREADS, 2)
    attn_bwd_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdu, int d,
                            const float* __restrict__ ddn, const float* __restrict__ mrow,
                            float* __restrict__ dq, int lddq, bf16* __restrict__ dq_b, int lddqb,
                            float* __restrict__ dkv, int lddkv, bf16* __restrict__ dkv_b,
                            int lddkvb, int nq, int nkv, int dq_blocks) {
  const int blocks = cluster_blocks();
  if ((int)blockIdx.x < dq_blocks)
    bwd_cluster_dq(tq, tk, tv, tdu, d, ddn, mrow, dq, lddq, dq_b, lddqb, nq, nkv,
                   blockIdx.x / blocks);
  else
    bwd_cluster_dkv(tq, tk, tv, tdu, d, ddn, mrow, dkv, lddkv, dkv_b, lddkvb, nq, nkv,
                    (blockIdx.x - dq_blocks) / blocks);
}

}  // namespace

// The cluster tier: q, k, v and du TMA-readable (row strides a multiple of
// 8; other operands return cudaErrorMisalignedAddress); the outputs written
// in pairs where their alignment allows it, else an element at a time. Any
// head width 1 <= d <= ATT_CLUSTER_MAX_D (1,024); others return
// cudaErrorInvalidValue.
FC_API int fc_attention_bwd_cluster(const void* q, int ldq, const void* k, const void* v,
                                    int ldkv, const void* du, int lddu, const void* ddn,
                                    const void* mrow, void* dq, int lddq, void* dq_b, int lddqb,
                                    void* dkv, int lddkv, void* dkv_b, int lddkvb, int n_items,
                                    int nq, int nkv, int d, void* stream) {
  if (n_items < 1 || nq < 1 || nkv < 1 || d < 1 || d > ATT_CLUSTER_MAX_D)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdu;
  cudaError_t err = att_tensor_map(&tq, q, n_items, nq, d, ldq);
  if (err == cudaSuccess) err = att_tensor_map(&tk, k, n_items, nkv, d, ldkv);
  if (err == cudaSuccess) err = att_tensor_map(&tv, v, n_items, nkv, d, ldkv);
  if (err == cudaSuccess) err = att_tensor_map(&tdu, du, n_items, nq, d, lddu);
  if (err != cudaSuccess) return (int)err;
  static bool checked[CL_MAX_BLOCKS + 1] = {};
  const int blocks = cluster_size(d);
  const int dq_blocks = ((nq + ATT_TILE - 1) / ATT_TILE) * blocks;
  const dim3 grid(dq_blocks + ((nkv + ATT_TILE - 1) / ATT_TILE) * blocks, n_items);
  return launch_cluster(attn_bwd_cluster_kernel, checked, grid, blocks, BWD_SMEM,
                        (cudaStream_t)stream, tq, tk, tv, tdu, d, (const float*)ddn,
                        (const float*)mrow, (float*)dq, lddq, (bf16*)dq_b, lddqb, (float*)dkv,
                        lddkv, (bf16*)dkv_b, lddkvb, nq, nkv, dq_blocks);
}
