// cross_attention at head widths 128 < D <= 512 (tiles of 256 and 512
// columns, one template instance each), called by fc_cross_attention
// (cross_attention.cu) with its arguments and its contract: per item, the
// exact row maximum m of s = q k^T in f32, e = exp(s - m), out = bf16((bf16(e)
// v) / sum(e)), and m and den = sum(e) when asked.
//
// Why another kernel: at D = 128 a block already holds q, two stages of a
// K and a V tile (80 KB) and two 64 x 64 f32 output accumulators (64
// registers a thread). At D = 512 one tile is 64 KB and the output alone
// would take 256 registers a thread.
//
// Design (TMA + wgmma on sm_90a, the parts of attention_wgmma.cuh):
//  * a block takes 64 query rows of one item and a group of WIDE_OUT_BOXES
//    = 2 of the output's 64-column boxes (128 columns, 64 registers a
//    thread): the ceil(D / 128) blocks of a query tile each run both passes
//    over all D columns of the scores and P V over their own columns of V.
//    The scores are recomputed once a group (the price of the registers);
//    every block computes them in the same order, so every block has the
//    same m and e, bit for bit;
//  * the block keeps its q tile (ceil(D / 64) boxes, up to 64 KB) and
//    streams the K boxes and its own V boxes through a ring of 8 KB stages
//    (FwdWide::STAGES), so two blocks share an SM at both tiles;
//  * s = Q K^T is summed in f32 from partials of two boxes (eight k-steps),
//    each a fresh wgmma accumulator (`ring_abt`): one accumulator over all
//    of D's k-steps drifted from the plain version's scores about linearly
//    in D; a pair's stages go back to the producer once its products are
//    done;
//  * pass 1 takes the masked row maximum, pass 2 forms e on the SFU, its f32
//    row sums and bf16(e) in wgmma's A registers, then O += P V for the
//    block's V boxes (read MN-major); m and den are written by the first
//    group's blocks only.
// Ragged keys and queries, zero-filled columns past D and an odd D's last
// column stored alone: as in cross_attention.cu.
#include "attention_wgmma.cuh"

namespace {

constexpr int WIDE_THREADS = 128 + 32;
constexpr int WIDE_OUT_BOXES = 2;   // output boxes a block

template <int DT>
struct FwdWide {
  static constexpr int KB = DT / ATT_BOX;   // boxes of a q tile
  static constexpr int STAGES = DT == 512 ? 5 : 8;
  static constexpr int SMEM = (KB + STAGES) * ATT_BOX_BYTES + 1024;
  // two blocks an SM: each block's shared memory and the 1 KB the card
  // keeps a block, with room for the static barriers
  static_assert(2 * (SMEM + 2048) <= 233472, "two blocks do not fit an SM");
};

template <int DT>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
    cross_attention_wide_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                bf16* __restrict__ out, int ldo, float* __restrict__ m_out,
                                float* __restrict__ den_out, int nq, int nkv, int d) {
  using F = FwdWide<DT>;
  constexpr int STAGES = F::STAGES, BB = ATT_BOX_BYTES, OB = WIDE_OUT_BOXES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], q_full;
  uint8_t* const qs = align1024(smem_raw);
  uint8_t* const ring = qs + F::KB * BB;
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;   // boxes of the d columns
  const int groups = (nb + OB - 1) / OB;
  const int item = blockIdx.y, q0 = (blockIdx.x / groups) * ATT_TILE;
  const int b0 = (blockIdx.x % groups) * OB;    // this block's first output box
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

  // the consumer warpgroup: query rows q0 + [0, 64)
  const int t = threadIdx.x;
  const int fc = frag_col(t);
  int it = 0;   // the ring's next stage use
  float s[32];
  // s = Q K^T over the next key tile's nb boxes in the ring
  float part[32];   // a partial of the scores (ring_abt)
  auto scores = [&]() { ring_abt<STAGES>(s, part, qs, ring, full, empty, it, nb); };
  mbar_wait(&q_full, 0);

  // pass 1: the exact row maximum over the keys < nkv
  float mx0 = -INFINITY, mx1 = -INFINITY;   // rows r0 and r0 + 8
  for (int j = 0; j < n_tiles; ++j) {
    scores();
    const int c0 = j * ATT_TILE + fc;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (c0 + 8 * jj + b < nkv) {
          mx0 = fmaxf(mx0, s[4 * jj + b]);
          mx1 = fmaxf(mx1, s[4 * jj + 2 + b]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }

  // pass 2: e = exp(s - m), its f32 row sums, and O += bf16(e) V for the
  // block's boxes of V
  float acc[OB][32];
#pragma unroll
  for (int x = 0; x < OB; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    scores();
    const int c0 = j * ATT_TILE + fc;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const bool ok = c0 + 8 * jj + b < nkv;
        const float e0 = ok ? exp_sub(s[4 * jj + b], mx0) : 0.f;
        const float e1 = ok ? exp_sub(s[4 * jj + 2 + b], mx1) : 0.f;
        s[4 * jj + b] = e0;
        s[4 * jj + 2 + b] = e1;
        l0 += e0;
        l1 += e1;
      }
    }
    uint32_t p[16];
    pack_a(s, p);
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
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  // epilogue: bf16(O / sum) of the block's columns < d; m and den from the
  // first group
  const bool pairs = pair_aligned(out, ldo);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + frag_row(t) + 8 * half;
    if (row >= nq) continue;
    const float l = half ? l1 : l0;
    const size_t r = (size_t)item * nq + row;
    bf16* orow = out + r * ldo;
#pragma unroll
    for (int x = 0; x < OB; ++x) {
      if (x >= nob) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = (b0 + x) * ATT_BOX + fc + 8 * jj;
        store2(orow + c, c, d, acc[x][4 * jj + 2 * half] / l, acc[x][4 * jj + 2 * half + 1] / l,
               pairs);
      }
    }
    if (m_out != nullptr && fc == 0 && b0 == 0) {
      m_out[r] = half ? mx1 : mx0;
      den_out[r] = l;
    }
  }
}

template <int DT>
int launch_wide(const void* q, int ldq, const void* k, const void* v, int ldkv, void* out,
                int ldo, void* m_out, void* den_out, int n_items, int nq, int nkv, int d,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = att_tensor_map(&tq, q, n_items, nq, d, ldq);
  if (err == cudaSuccess) err = att_tensor_map(&tk, k, n_items, nkv, d, ldkv);
  if (err == cudaSuccess) err = att_tensor_map(&tv, v, n_items, nkv, d, ldkv);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set = false;   // the shared-memory opt-in, once a tile
  if (!smem_set) {
    err = cudaFuncSetAttribute(cross_attention_wide_kernel<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, FwdWide<DT>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int groups = (nb + WIDE_OUT_BOXES - 1) / WIDE_OUT_BOXES;
  const dim3 grid(((nq + ATT_TILE - 1) / ATT_TILE) * groups, n_items);
  cross_attention_wide_kernel<DT><<<grid, WIDE_THREADS, FwdWide<DT>::SMEM, stream>>>(
      tq, tk, tv, (bf16*)out, ldo, (float*)m_out, (float*)den_out, nq, nkv, d);
  return (int)cudaGetLastError();
}

}  // namespace

int cross_attention_wide(const void* q, int ldq, const void* k, const void* v, int ldkv,
                         void* out, int ldo, void* m_out, void* den_out, int n_items, int nq,
                         int nkv, int d, cudaStream_t stream) {
  switch (att_tile(d)) {
    case 256:
      return launch_wide<256>(q, ldq, k, v, ldkv, out, ldo, m_out, den_out, n_items, nq, nkv, d,
                              stream);
    case 512:
      return launch_wide<512>(q, ldq, k, v, ldkv, out, ldo, m_out, den_out, n_items, nq, nkv, d,
                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
