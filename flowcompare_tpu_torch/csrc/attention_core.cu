// attention_core: softmax(q k^T * scale) v with head dimension 1 <= D <=
// 512 (fc_attention_core's `d`, on the smallest tile of 32, 64, 128, 256 or
// 512 columns that holds it, one template instance a tile, the two widest
// in attention_core_wide.cu; a width past 512 returns
// cudaErrorInvalidValue) and the probabilities
// kept at f32 precision through the PV product, the port of
// the Pallas kernel fused_attention_core (ops/attention_pallas.py, body
// _kernel).
//
//   q (items*nq, D), k and v (items*nkv, D) bf16 -> out (items*nq, D) bf16
//
// It computes what the Pallas kernel computes, in its order: s = q k^T with
// f32 accumulation, times the temperature in f32 (an argument here, not
// folded into q as in cross_attention.cu); the exact row maximum m
// subtracted and exp taken; p = e / sum(e) normalised in f32 BEFORE the
// product; out = p @ v with f32 sums, cast once to bf16. That is the
// difference from B1's cross_attention, which rounds e to bf16 for the PV
// product and divides after, and from flash attention, which rounds p to
// bf16.
//
// Design (attention_core_wgmma_kernel, TMA + wgmma on sm_90a, built from
// cross_attention.cu's parts in attention_wgmma.cuh):
//  * a block takes 64 query rows of one item (one consumer warpgroup) and
//    one producer warp that streams the K tiles (pass 1) and the K and V
//    tiles (pass 2), 64 keys x D dims as 64 x 64 boxes (attention_wgmma.cuh),
//    through a ring of 2 stages from 3-D tensor maps (D, rows, items), so
//    no box reads the next item's keys;
//  * S = Q K^T is D / 16 wgmma m64n64k16 into 32 f32 registers a thread,
//    both passes; the scores never leave the registers;
//  * pass 1 keeps, per thread and row, a running maximum and the f32 sum of
//    exp(s - max) rescaled when the maximum grows; the four threads of a
//    row then merge theirs. The maximum is exact; the sum differs from the
//    plain version's by f32 rounding only;
//  * pass 2 forms p = exp(s - m) / sum in f32 and splits it in three bf16
//    terms, p_hi = bf16(p), p_mid = bf16(p - p_hi), p_lo = bf16(p - p_hi -
//    p_mid) (each difference exact in f32): together about 24 bits of p,
//    f32's own. All three go straight into wgmma's A-register layout, and
//    each tile's P_lo V + P_mid V + P_hi V runs on the tensor cores, a box
//    of V at a time, into a fresh f32 accumulator (one, reused by the two
//    boxes at D = 128, so the three terms, the output's two accumulators
//    and a tile's stay within two blocks' registers) that is then added to
//    the output's in f32:
//    summed over all keys in one tensor-core accumulator, or with two
//    terms (about 16 bits), several times as many outputs came out more
//    than half a bf16 ulp off the f32 plain version as with the earlier
//    kernel's f32 FMAs on the H100; rounding p to bf16 alone, as flash
//    attention does, puts far more there (chip_smoke.py's B10 phase reads
//    the shares and holds the kernel's to B10_SHARE_LIMIT);
//  * masked keys (>= nkv; nkv = 1250 is 19 tiles and 34 keys) are left out
//    of the maximum and the sum and get p = 0; TMA zero-fills the rows
//    past an item's keys and queries (and the columns past D, whose P V
//    results are never stored); rows >= nq are never stored.
//
// What bounds it on the H100: operations. One q k^T and the three bf16 PV
// products, 4 x 2 x D a score, over the bf16 peak (with the PV product as
// f32 FMAs on the CUDA cores, as the earlier kernel ran it, the bound was
// 0.0522 ms at (20, 1024) x 1250 keys). The second q k^T of pass 2 and
// one SFU exponential a score per pass are the kernel's own cost on top.
#include "attention_wgmma.cuh"

namespace {

// A block of the wgmma route: one consumer warpgroup of 64 query rows and a
// producer warp; the q tile, then a ring of CORE_STAGES stages of a K and a
// V tile (pass 1 uses only the K slot). Two blocks to an SM leave each
// thread room for the scores, a tile's accumulator and the output's, and
// the three terms of p.
constexpr int CORE_STAGES = 2;
constexpr int CORE_THREADS = 128 + 32;
constexpr int CORE_MIN_BLOCKS = 2;

template <int D>
struct Core {
  static constexpr int SMEM = (1 + 2 * CORE_STAGES) * AttWidth<D>::TILE_BYTES + 1024;
  static_assert(CORE_MIN_BLOCKS * SMEM <= 232448, "the rings exceed the SM's shared memory");
};

template <int D>
__global__ void __launch_bounds__(CORE_THREADS, CORE_MIN_BLOCKS)
    attention_core_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                bf16* __restrict__ out, int ldo, int nq, int nkv, float scale,
                                int d) {
  using W = AttWidth<D>;
  constexpr int STAGES = CORE_STAGES, TB = W::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], q_full;
  uint8_t* const qs = align1024(smem_raw);
  uint8_t* const ring = qs + TB;   // stage s: K, then V
  const int item = blockIdx.y, q0 = blockIdx.x * ATT_TILE;
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
    // the producer warp: one thread keeps the ring's loads in flight
    if (threadIdx.x == 128) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      mbar_expect_tx(&q_full, TB);
      tma_load_tile<D>(qs, &tq, &q_full, q0, item);
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = it % STAGES;
        const bool pass2 = it >= n_tiles;
        const int j0 = (pass2 ? it - n_tiles : it) * ATT_TILE;
        mbar_wait(&empty[s], ring_parity(it, STAGES) ^ 1);
        uint8_t* ks = ring + 2 * s * TB;
        mbar_expect_tx(&full[s], (pass2 ? 2 : 1) * TB);
        tma_load_tile<D>(ks, &tk, &full[s], j0, item);
        if (pass2) tma_load_tile<D>(ks + TB, &tv, &full[s], j0, item);
      }
    }
    return;
  }

  // the consumer warpgroup: query rows q0 + [0, 64); this thread's rows
  // frag_row(t) (h = 0) and +8 (h = 1)
  const int t = threadIdx.x;
  const int fc = frag_col(t);
  float s[32];
  mbar_wait(&q_full, 0);

  // pass 1: the exact row maximum of s * scale and the f32 sum of
  // exp(s * scale - maximum) over the keys < nkv, per thread, then per row
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], ring_parity(it, STAGES));
    wgmma_fence();
    tile_abt<D>(s, qs, ring + 2 * st * TB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    release_stage(&empty[st]);
    const int c0 = it * ATT_TILE + fc;
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
      if (mn == -INFINITY) continue;   // none of this thread's keys yet
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

  // pass 2: p = exp(s * scale - m) / sum in f32, split p = p_hi + p_mid +
  // p_lo (all bf16); each tile's P_lo V + P_mid V + P_hi V on the tensor
  // cores into a fresh accumulator, a box of V at a time, added to the f32
  // output in order
  float acc[W::BOXES][32], tile[32];
#pragma unroll
  for (int x = 0; x < W::BOXES; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int it = n_tiles + j, st = it % STAGES;
    const uint8_t* ks = ring + 2 * st * TB;
    mbar_wait(&full[st], ring_parity(it, STAGES));
    wgmma_fence();
    tile_abt<D>(s, qs, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    const int c0 = j * ATT_TILE + fc;
    uint32_t p_hi[16], p_mid[16], p_lo[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // s[2 i], s[2 i + 1] = acc[4 j + 2 h + {0, 1}]: row + 8 h, columns
      // 8 j + {0, 1} from c0, for i = 2 j + h
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
    for (int x = 0; x < W::BOXES; ++x) {
      const uint8_t* vs = ks + TB + x * ATT_BOX_BYTES;
#pragma unroll
      for (int i = 0; i < 32; ++i) tile[i] = 0.f;
      wgmma_fence();
      tile_pb(tile, p_lo, vs);
      tile_pb(tile, p_mid, vs);
      tile_pb(tile, p_hi, vs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(tile);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[x][i] += tile[i];
    }
    release_stage(&empty[st]);
  }

  // epilogue: bf16(O) in pairs, rows < nq and columns < d only (every
  // store a pair at the tile's own width, as cross_attention.cu's)
  const bool pairs = pair_aligned(out, ldo), whole = pairs && d == D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + frag_row(t) + 8 * h;
    if (row >= nq) continue;
    bf16* orow = out + ((size_t)item * nq + row) * ldo + fc;
    if (whole) {
#pragma unroll
      for (int x = 0; x < W::BOXES; ++x)
#pragma unroll
        for (int jj = 0; jj < W::BOX_COLS / 8; ++jj)
          *reinterpret_cast<uint32_t*>(orow + x * ATT_BOX + 8 * jj) =
              pack_bf16(acc[x][4 * jj + 2 * h], acc[x][4 * jj + 2 * h + 1]);
    } else {
#pragma unroll
      for (int x = 0; x < W::BOXES; ++x)
#pragma unroll
        for (int jj = 0; jj < W::BOX_COLS / 8; ++jj)
          store2(orow + x * ATT_BOX + 8 * jj, fc + x * ATT_BOX + 8 * jj, d,
                 acc[x][4 * jj + 2 * h], acc[x][4 * jj + 2 * h + 1], pairs);
    }
  }
}

template <int D>
int launch_core(const void* q, int ldq, const void* k, int ldk, const void* v, int ldv, void* out,
                int ldo, int n_items, int nq, int nkv, float scale, int d, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = att_tensor_map(&tq, q, n_items, nq, d, ldq);
  if (err == cudaSuccess) err = att_tensor_map(&tk, k, n_items, nkv, d, ldk);
  if (err == cudaSuccess) err = att_tensor_map(&tv, v, n_items, nkv, d, ldv);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set = false;   // the shared-memory opt-in, once a width
  if (!smem_set) {
    err = cudaFuncSetAttribute(attention_core_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Core<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((nq + ATT_TILE - 1) / ATT_TILE, n_items);
  attention_core_wgmma_kernel<D><<<grid, CORE_THREADS, Core<D>::SMEM, stream>>>(
      tq, tk, tv, (bf16*)out, ldo, nq, nkv, scale, d);
  return (int)cudaGetLastError();
}

}  // namespace

// The wgmma route: q, k and v TMA-readable (row strides a multiple of 8;
// other operands return cudaErrorMisalignedAddress: there is no other
// route); out is written in pairs where its alignment allows it, else an
// element at a time. A head width d outside [1, 512] returns
// cudaErrorInvalidValue.
FC_API int fc_attention_core(const void* q, int ldq, const void* k, int ldk, const void* v,
                             int ldv, void* out, int ldo, int n_items, int nq, int nkv,
                             float scale, int d, void* stream) {
  if (n_items < 1 || nq < 1 || nkv < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FC_CORE(DT) \
  launch_core<DT>(q, ldq, k, ldk, v, ldv, out, ldo, n_items, nq, nkv, scale, d, st)
  switch (att_tile(d)) {
    case 32: return FC_CORE(32);
    case 64: return FC_CORE(64);
    case 128: return FC_CORE(128);
    case 256:
    case 512:
      return attention_core_wide(q, ldq, k, ldk, v, ldv, out, ldo, n_items, nq, nkv, scale, d,
                                 st);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FC_CORE
}
