// attention_core (B10) at head widths 128 < D <= 512 (tiles of 256 and
// 512 columns, one template instance each), called by fc_attention_core
// (attention_core.cu) with its arguments and its contract: softmax(q k^T *
// scale) v with p = e / sum(e) in f32, split into three bf16 terms for the
// tensor cores, the output cast once to bf16.
//
// The layout is cross_attention_wide.cu's: a block takes 64 query rows of
// one item and a group of CORE_OUT_BOXES = 2 of the output's 64-column
// boxes, keeps its q tile and streams the K boxes and its own V boxes
// through a ring of 8 KB stages, two blocks to an SM; s = Q K^T is summed
// from partials of two boxes (`ring_abt`). Pass 1
// keeps the exact row maximum and the online f32 sum of exp(s * scale -
// maximum) as attention_core.cu does; pass 2 forms p in f32, splits it in
// three bf16 terms and adds each of the block's V boxes' P_lo V + P_mid V +
// P_hi V (a fresh accumulator) to the output in f32. Every block of a query
// tile computes the scores in the same order, so its p is the same, bit for
// bit.
#include "attention_wgmma.cuh"

namespace {

constexpr int CORE_THREADS = 128 + 32;
constexpr int CORE_OUT_BOXES = 2;   // output boxes a block

template <int DT>
struct CoreWide {
  static constexpr int KB = DT / ATT_BOX;   // boxes of a q tile
  static constexpr int STAGES = DT == 512 ? 5 : 8;
  static constexpr int SMEM = (KB + STAGES) * ATT_BOX_BYTES + 1024;
  static_assert(2 * (SMEM + 2048) <= 233472, "two blocks do not fit an SM");
};

template <int DT>
__global__ void __launch_bounds__(CORE_THREADS, 2)
    attention_core_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               bf16* __restrict__ out, int ldo, int nq, int nkv, float scale,
                               int d) {
  using F = CoreWide<DT>;
  constexpr int STAGES = F::STAGES, BB = ATT_BOX_BYTES, OB = CORE_OUT_BOXES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], q_full;
  uint8_t* const qs = align1024(smem_raw);
  uint8_t* const ring = qs + F::KB * BB;
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int groups = (nb + OB - 1) / OB;
  const int item = blockIdx.y, q0 = (blockIdx.x / groups) * ATT_TILE;
  const int b0 = (blockIdx.x % groups) * OB;
  const int nob = min(OB, nb - b0);
  const int n_tiles = (nkv + ATT_TILE - 1) / ATT_TILE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(&q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128)
      wide_forward_loads<STAGES>(&tq, &tk, &tv, qs, ring, full, empty, &q_full, nb, b0, nob,
                                 n_tiles, q0, item);
    return;
  }

  const int t = threadIdx.x;
  const int fc = frag_col(t);
  int it = 0;
  float s[32];
  float part[32];   // a partial of the scores (ring_abt)
  auto scores = [&]() { ring_abt<STAGES>(s, part, qs, ring, full, empty, it, nb); };
  mbar_wait(&q_full, 0);

  // pass 1: the exact row maximum of s * scale and the f32 sum of
  // exp(s * scale - maximum) over the keys < nkv, per thread, then per row
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    scores();
    const int c0 = j * ATT_TILE + fc;
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& v = s[4 * jj + 2 * h + b];
          v *= scale;
          if (c0 + 8 * jj + b < nkv) tm[h] = fmaxf(tm[h], v);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(mx[h], tm[h]);
      if (mn == -INFINITY) continue;
      float add = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          if (c0 + 8 * jj + b < nkv) add += exp_sub(s[4 * jj + 2 * h + b], mn);
      l[h] = l[h] * exp_sub(mx[h], mn) + add;
      mx[h] = mn;
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[h], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[h], o);
      merge_max_sum(mx[h], l[h], m2, l2);
    }
  const float rl[2] = {1.f / l[0], 1.f / l[1]};

  // pass 2: p in f32 split into three bf16 terms; each of the block's V
  // boxes: P_lo V + P_mid V + P_hi V into a fresh accumulator, added to the
  // output in f32
  float acc[OB][32], tile[32];
#pragma unroll
  for (int x = 0; x < OB; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    scores();
    const int c0 = j * ATT_TILE + fc;
    uint32_t p_hi[16], p_mid[16], p_lo[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int h = i & 1, col = c0 + 8 * (i >> 1);
      const float p0 = col < nkv ? exp_sub(s[2 * i] * scale, mx[h]) * rl[h] : 0.f;
      const float p1 = col + 1 < nkv ? exp_sub(s[2 * i + 1] * scale, mx[h]) * rl[h] : 0.f;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      const float r0 = p0 - hf.x, r1 = p1 - hf.y;   // exact in f32
      const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
      const float2 mf = __bfloat1622float2(mid);
      p_hi[i] = *reinterpret_cast<const uint32_t*>(&hi);
      p_mid[i] = *reinterpret_cast<const uint32_t*>(&mid);
      p_lo[i] = pack_bf16(r0 - mf.x, r1 - mf.y);
    }
#pragma unroll
    for (int x = 0; x < OB; ++x) {
      if (x >= nob) continue;
      const int st = it % STAGES;
      const uint8_t* vs = ring + st * BB;
      mbar_wait(&full[st], ring_parity(it, STAGES));
#pragma unroll
      for (int i = 0; i < 32; ++i) tile[i] = 0.f;
      wgmma_fence();
      tile_pb(tile, p_lo, vs);
      tile_pb(tile, p_mid, vs);
      tile_pb(tile, p_hi, vs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(tile);
      release_stage(&empty[st]);
      ++it;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[x][i] += tile[i];
    }
  }

  // epilogue: bf16(O) of the block's columns < d
  const bool pairs = pair_aligned(out, ldo);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + frag_row(t) + 8 * h;
    if (row >= nq) continue;
    bf16* orow = out + ((size_t)item * nq + row) * ldo;
#pragma unroll
    for (int x = 0; x < OB; ++x) {
      if (x >= nob) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = (b0 + x) * ATT_BOX + fc + 8 * jj;
        store2(orow + c, c, d, acc[x][4 * jj + 2 * h], acc[x][4 * jj + 2 * h + 1], pairs);
      }
    }
  }
}

template <int DT>
int launch_core_wide(const void* q, int ldq, const void* k, int ldk, const void* v, int ldv,
                     void* out, int ldo, int n_items, int nq, int nkv, float scale, int d,
                     cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = att_tensor_map(&tq, q, n_items, nq, d, ldq);
  if (err == cudaSuccess) err = att_tensor_map(&tk, k, n_items, nkv, d, ldk);
  if (err == cudaSuccess) err = att_tensor_map(&tv, v, n_items, nkv, d, ldv);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set = false;   // the shared-memory opt-in, once a tile
  if (!smem_set) {
    err = cudaFuncSetAttribute(attention_core_wide_kernel<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, CoreWide<DT>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int groups = (nb + CORE_OUT_BOXES - 1) / CORE_OUT_BOXES;
  const dim3 grid(((nq + ATT_TILE - 1) / ATT_TILE) * groups, n_items);
  attention_core_wide_kernel<DT><<<grid, CORE_THREADS, CoreWide<DT>::SMEM, stream>>>(
      tq, tk, tv, (bf16*)out, ldo, nq, nkv, scale, d);
  return (int)cudaGetLastError();
}

}  // namespace

int attention_core_wide(const void* q, int ldq, const void* k, int ldk, const void* v, int ldv,
                        void* out, int ldo, int n_items, int nq, int nkv, float scale, int d,
                        cudaStream_t stream) {
  switch (att_tile(d)) {
    case 256:
      return launch_core_wide<256>(q, ldq, k, ldk, v, ldv, out, ldo, n_items, nq, nkv, scale, d,
                                   stream);
    case 512:
      return launch_core_wide<512>(q, ldq, k, ldk, v, ldv, out, ldo, n_items, nq, nkv, scale, d,
                                   stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
