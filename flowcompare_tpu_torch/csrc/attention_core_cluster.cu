// attention_core (B10) at head widths up to 1,024 on thread-block clusters
// (the tier past 512; attention_cluster.cuh), with fc_attention_core's
// arguments and contract: softmax(q k^T * scale) v with p = e / sum(e) in
// f32, split into three bf16 terms for the tensor cores, the output cast
// once to bf16. Replaces flowcompare_tpu/ops/attention_pallas.py::
// fused_attention_core (:69) past the widths attention_core.cu and
// attention_core_wide.cu take.
//
// What bounds it on the H100: q k^T and two bf16 P V products (the least
// that keeps p past bf16 on the tensor cores) at the tensor cores' rate.
//
// Design: cross_attention_cluster.cu's cluster (G = ceil(D / 128) blocks a
// 64-row query tile, block g owning 128 columns, the scores of each key
// tile summed across the cluster in the wide kernels' order) with
// attention_core_wide.cu's arithmetic after the scores, line for line:
// pass 1 keeps the exact row maximum of s * scale and the online f32 sum
// of exp(s * scale - maximum); pass 2 forms p in f32, splits it in three
// bf16 terms and adds each of the block's V boxes' P_lo V + P_mid V + P_hi V
// (a fresh accumulator) to the output in f32. At D = 512 it writes what the
// wide kernel writes.
#include "attention_cluster.cuh"

namespace {

constexpr int CORE_STAGES = 8;
constexpr int CORE_SMEM = (CL_BOXES + CORE_STAGES + 2) * ATT_BOX_BYTES + 1024;
static_assert(2 * (CORE_SMEM + 2048) <= 233472, "two blocks do not fit an SM");

__global__ void __launch_bounds__(CL_THREADS, 2)
    attention_core_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  bf16* __restrict__ out, int ldo, int nq, int nkv, float scale,
                                  int d) {
  constexpr int BB = ATT_BOX_BYTES, OB = CL_BOXES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[CORE_STAGES], empty[CORE_STAGES], q_full;
  uint8_t* const qs = align1024(smem_raw);
  uint8_t* const ring_base = qs + OB * BB;
  float* const xbuf = reinterpret_cast<float*>(ring_base + CORE_STAGES * BB);
  const int g = cluster_rank(), blocks = cluster_blocks();
  const int nb = (d + ATT_BOX - 1) / ATT_BOX;
  const int g0 = g * OB, nob = min(OB, nb - g0);
  const int item = blockIdx.y, q0 = (blockIdx.x / blocks) * ATT_TILE;
  const int n_tiles = (nkv + ATT_TILE - 1) / ATT_TILE;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < CORE_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(&q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const ForwardLoads loads{&tk, &tv, g0, nob, n_tiles, item, 1};
  ClusterRing<CORE_STAGES> ring{ring_base, full, empty};
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
  float s[32];
  auto scores = [&]() {
    partial_abt<CORE_STAGES>(s, qs, ring, 0, nob);
    ring.advance(nob, loads);
    put_frag(xbuf, s);
    cluster_sum(xbuf, g, blocks, CL_TILE_FLOATS / 4);
    get_frag(xbuf, s);
  };
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
      const uint8_t* vs = ring.stage(0);
      ring.wait(0);
#pragma unroll
      for (int i = 0; i < 32; ++i) tile[i] = 0.f;
      wgmma_fence();
      tile_pb(tile, p_lo, vs);
      tile_pb(tile, p_mid, vs);
      tile_pb(tile, p_hi, vs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(tile);
      ring.advance(1, loads);
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
        const int c = (g0 + x) * ATT_BOX + fc + 8 * jj;
        store2(orow + c, c, d, acc[x][4 * jj + 2 * h], acc[x][4 * jj + 2 * h + 1], pairs);
      }
    }
  }
  cluster_sync();   // no block leaves while a neighbour may read its buffer
}

}  // namespace

// The cluster tier: q, k and v TMA-readable (row strides a multiple of 8;
// other operands return cudaErrorMisalignedAddress); out written in pairs
// where its alignment allows it, else an element at a time. Any head width
// 1 <= d <= ATT_CLUSTER_MAX_D (1,024); others return cudaErrorInvalidValue.
FC_API int fc_attention_core_cluster(const void* q, int ldq, const void* k, int ldk,
                                     const void* v, int ldv, void* out, int ldo, int n_items,
                                     int nq, int nkv, float scale, int d, void* stream) {
  if (n_items < 1 || nq < 1 || nkv < 1 || d < 1 || d > ATT_CLUSTER_MAX_D)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = att_tensor_map(&tq, q, n_items, nq, d, ldq);
  if (err == cudaSuccess) err = att_tensor_map(&tk, k, n_items, nkv, d, ldk);
  if (err == cudaSuccess) err = att_tensor_map(&tv, v, n_items, nkv, d, ldv);
  if (err != cudaSuccess) return (int)err;
  static bool checked[CL_MAX_BLOCKS + 1] = {};
  const int blocks = cluster_size(d);
  const dim3 grid(((nq + ATT_TILE - 1) / ATT_TILE) * blocks, n_items);
  return launch_cluster(attention_core_cluster_kernel, checked, grid, blocks, CORE_SMEM,
                        (cudaStream_t)stream, tq, tk, tv, (bf16*)out, ldo, nq, nkv, scale, d);
}
