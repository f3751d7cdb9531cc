// cross_attention at head widths up to 1,024 on thread-block clusters (the
// tier past 512; attention_cluster.cuh), with fc_cross_attention's
// arguments and contract: per item, the exact row maximum m of s = q k^T in
// f32, e = exp(s - m), out = bf16((bf16(e) v) / sum(e)), and m and den =
// sum(e) when asked. The attention step of B1, B2 and B7 and of B5's
// recompute (flowcompare_tpu/ops/flow_layer_pallas.py:800), past the widths
// cross_attention.cu and cross_attention_wide.cu take.
//
// What bounds it on the H100: the three D-deep products (q k^T twice, P v),
// 6 D operations a score, at the tensor cores' rate; at D = 768 the main
// path's 20 x 1024 x 1250 call is 0.0795 ms of them.
//
// Design: a cluster of G = ceil(D / 128) blocks takes 64 query rows of one
// item; block g keeps its 128 columns of q (16 KB) and streams its columns
// of each key tile's K boxes (pass 1), then its K and V boxes (pass 2),
// through a ring of FWD_STAGES 8 KB stages, two blocks to an SM. Each pass
// sums the key tiles' scores across the cluster (`cluster_sum`), FWD_ROUND
// tiles an exchange (its two cluster barriers, not the products or the
// bytes, set an exchange's time), so each block holds the full scores, bit
// for bit the same in every block: pass 1
// takes the masked row maximum, pass 2 forms e on the SFU, its f32 row sums
// and bf16(e) in wgmma's A registers, and O_g += P V_g for the block's own
// V boxes. Block g stores its columns of the output; block 0 writes m and
// den. The arithmetic after the scores is cross_attention_wide.cu's, line
// for line, and the scores are its partials summed in its order, so at D =
// 512 this kernel writes what the wide kernel writes.
#include "attention_cluster.cuh"

namespace {

constexpr int FWD_STAGES = 7;
constexpr int FWD_ROUND = 2;   // key tiles whose scores one exchange sums
// the q slice, the ring and the exchange of FWD_ROUND tiles (16 KB each),
// aligned to 1 KB
constexpr int FWD_SMEM =
    (CL_BOXES + FWD_STAGES + 2 * FWD_ROUND) * ATT_BOX_BYTES + 1024;
static_assert(2 * (FWD_SMEM + 2048) <= 233472, "two blocks do not fit an SM");

__global__ void __launch_bounds__(CL_THREADS, 2)
    cross_attention_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   bf16* __restrict__ out, int ldo, float* __restrict__ m_out,
                                   float* __restrict__ den_out, int nq, int nkv, int d) {
  constexpr int BB = ATT_BOX_BYTES, OB = CL_BOXES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[FWD_STAGES], empty[FWD_STAGES], q_full;
  uint8_t* const qs = align1024(smem_raw);
  uint8_t* const ring_base = qs + OB * BB;
  float* const xbuf = reinterpret_cast<float*>(ring_base + FWD_STAGES * BB);
  const int g = cluster_rank(), blocks = cluster_blocks();
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int g0 = g * OB, nob = min(OB, nb - g0);   // this block's boxes of D
  const int item = blockIdx.y, q0 = (blockIdx.x / blocks) * ATT_TILE;
  const int n_tiles = (nkv + ATT_TILE - 1) / ATT_TILE;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(&q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const ForwardLoads loads{&tk, &tv, g0, nob, n_tiles, item, FWD_ROUND};
  ClusterRing<FWD_STAGES> ring{ring_base, full, empty};
  if (t == 0) {
    prefetch_tensor_map(&tq);
    prefetch_tensor_map(&tk);
    prefetch_tensor_map(&tv);
    mbar_expect_tx(&q_full, nob * BB);
    for (int x = 0; x < nob; ++x)
      tma_load_3d(qs + x * BB, &tq, &q_full, (g0 + x) * ATT_BOX, q0, item);
    ring.fill(loads);
  }
  __syncwarp();

  const int fc = frag_col(t);
  float sr[FWD_ROUND][32];
  // the next nt key tiles' scores: the block's partials, summed over the
  // cluster in one exchange
  auto scores = [&](int nt) {
#pragma unroll
    for (int r = 0; r < FWD_ROUND; ++r)
      if (r < nt) partial_abt<FWD_STAGES>(sr[r], qs, ring, r * nob, nob);
    ring.advance(nt * nob, loads);
#pragma unroll
    for (int r = 0; r < FWD_ROUND; ++r)
      if (r < nt) put_frag(xbuf + r * CL_TILE_FLOATS, sr[r]);
    cluster_sum(xbuf, g, blocks, nt * CL_TILE_FLOATS / 4);
#pragma unroll
    for (int r = 0; r < FWD_ROUND; ++r)
      if (r < nt) get_frag(xbuf + r * CL_TILE_FLOATS, sr[r]);
  };
  mbar_wait(&q_full, 0);

  // pass 1: the exact row maximum over the keys < nkv
  float mx0 = -INFINITY, mx1 = -INFINITY;   // rows r0 and r0 + 8
  for (int j0 = 0; j0 < n_tiles; j0 += FWD_ROUND) {
    const int nt = min(FWD_ROUND, n_tiles - j0);
    scores(nt);
#pragma unroll
    for (int r = 0; r < FWD_ROUND; ++r) {
      if (r >= nt) continue;
      const float(&s)[32] = sr[r];
      const int c0 = (j0 + r) * ATT_TILE + fc;
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
  for (int j0 = 0; j0 < n_tiles; j0 += FWD_ROUND) {
    const int nt = min(FWD_ROUND, n_tiles - j0);
    scores(nt);
    // tile by tile, in key order: its e, then O += P V over its V boxes
    // (the ring's uses r * nob + x)
#pragma unroll
    for (int r = 0; r < FWD_ROUND; ++r) {
      if (r >= nt) continue;
      float(&s)[32] = sr[r];
      const int c0 = (j0 + r) * ATT_TILE + fc;
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
        if (x < nob) ring.wait(r * nob + x);
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < OB; ++x)
        if (x < nob) tile_pb(acc[x], p, ring.stage(r * nob + x));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < OB; ++x) fence_acc(acc[x]);
    }
    ring.advance(nt * nob, loads);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  // epilogue: bf16(O / sum) of the block's columns < d; m and den from block 0
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
        const int c = (g0 + x) * ATT_BOX + fc + 8 * jj;
        store2(orow + c, c, d, acc[x][4 * jj + 2 * half] / l, acc[x][4 * jj + 2 * half + 1] / l,
               pairs);
      }
    }
    if (m_out != nullptr && fc == 0 && g == 0) {
      m_out[r] = half ? mx1 : mx0;
      den_out[r] = l;
    }
  }
  cluster_sync();   // no block leaves while a neighbour may read its buffer
}

}  // namespace

// The cluster tier: q, k and v TMA-readable (row strides a multiple of 8;
// other operands return cudaErrorMisalignedAddress); out written in pairs
// where its alignment allows it, else an element at a time. Any head width
// 1 <= d <= ATT_CLUSTER_MAX_D (1,024; the wrapper sends it d past 512, or
// any d when asked to); others return cudaErrorInvalidValue.
FC_API int fc_cross_attention_cluster(const void* q, int ldq, const void* k, const void* v,
                                      int ldkv, void* out, int ldo, void* m_out, void* den_out,
                                      int n_items, int nq, int nkv, int d, void* stream) {
  if (n_items < 1 || nq < 1 || nkv < 1 || d < 1 || d > ATT_CLUSTER_MAX_D)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = att_tensor_map(&tq, q, n_items, nq, d, ldq);
  if (err == cudaSuccess) err = att_tensor_map(&tk, k, n_items, nkv, d, ldkv);
  if (err == cudaSuccess) err = att_tensor_map(&tv, v, n_items, nkv, d, ldkv);
  if (err != cudaSuccess) return (int)err;
  static bool checked[CL_MAX_BLOCKS + 1] = {};
  const int blocks = cluster_size(d);
  const dim3 grid(((nq + ATT_TILE - 1) / ATT_TILE) * blocks, n_items);
  return launch_cluster(cross_attention_cluster_kernel, checked, grid, blocks, FWD_SMEM,
                        (cudaStream_t)stream, tq, tk, tv, (bf16*)out, ldo, (float*)m_out,
                        (float*)den_out, nq, nkv, d);
}
