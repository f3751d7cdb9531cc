// cross_attention: one-head softmax(q k^T) v with head dimension 1 <= D
// <= 512 (the entry points' `d`; a width runs on the smallest tile of 32,
// 64, 128, 256 or 512 columns that holds it, one template instance a tile,
// the two widest in cross_attention_wide.cu; a width past 512 returns
// cudaErrorInvalidValue), the attention step of the Pallas kernels fused_flow_layers_t (B1,
// _attention_cond_t, flowcompare_tpu/ops/flow_layer_pallas.py:800),
// fused_augmenter (B2, _attention_cond, :239) and
// fused_flow_layers_inverse_t (B7), and of B5's per-layer recompute. The
// 1/sqrt(d) temperature is already folded into q (fold_stacks).
//
//   q (items*nq, D) bf16, k and v (items*nkv, D) bf16 -> out (items*nq, D) bf16
//
// It ports folded_scan_core's max-subtracted softmax, not the TPU kernel's
// clamp-at-80 with an epsilon on the denominator: each row's exact maximum m
// is subtracted in f32, e = exp(s - m) is rounded to bf16 for the PV
// product, and the f32 sum of the unrounded e divides after PV. A first
// pass over the keys finds m (one q k^T product, no exponentials); the
// second recomputes q k^T, forms e, sums it and accumulates P V. An online
// softmax would save that product but round P against a running maximum,
// and the backward (cross_attention_bwd.cu) rebuilds P from the m written
// here, so it must be the forward's own. With m_out and den_out set it also
// writes each row's f32 m and den = sum(e).
//
// What bounds it on the H100: at the presets' 20-50 items x 1024 queries x
// 1250 keys, the three D-deep products (q k^T twice, P v) are 3 x 2 x D
// operations a score against a few bytes of q, k and v a key row:
// operations bound it, and the exponential (one SFU ex2 a score, about the
// tensor cores' rate for 256 operations) is a co-limiter at D = 64 and the
// limit at D = 32.
//
// Design (cross_attention_wgmma_kernel, TMA + wgmma on sm_90a):
//  * a block takes 64 query rows of one item (one consumer warpgroup) plus
//    one producer warp, four blocks to an SM. 128-row blocks (two consumer
//    warpgroups sharing each K and V tile, half the L2 traffic) were slower
//    at every main-path shape on the H100, 20-50 items x 1024 x 1250 and
//    1 x 4000 x 1250, as was issuing the next tile's q k^T ahead of this
//    tile's exponentials inside one warpgroup (FlashAttention-3's overlap):
//    four blocks to an SM already interleave one warpgroup's exponentials
//    with another's products; skipping the index mask on full tiles did not
//    pay either;
//  * the producer loads the block's q rows once, then streams the K tiles
//    (pass 1) and the K and V tiles (pass 2), 64 keys x D dims as 64 x 64
//    boxes (attention_wgmma.cuh), through a ring of 2 stages with full /
//    empty mbarriers (four blocks to an SM at D <= 64, two at D = 128,
//    whose 16 KB tiles would not fit four);
//  * S = Q K^T is D / 16 wgmma m64n64k16 (Q and K both K-major in shared
//    memory) into 32 f32 registers a thread; pass 1 takes the row maximum
//    over the fragment, then over the 4 threads that share a row (shuffles);
//    pass 2 forms e = 2^((s - m) log2(e)) with the SFU's ex2, adds it to the
//    f32 row sums, rounds it to bf16 straight into wgmma's A-register
//    layout, and runs O += P V, one m64n64 product a box of V (read
//    MN-major) with A from registers; the scores never touch shared memory;
//  * the epilogue writes bf16(O / sum) as bf16 pairs, and m / den.
// Where trouble lies, and what the design does about it:
//  * ragged keys across items: nkv = 1250 is 19 tiles and 34 keys, and the
//    operands are (items*rows, D) matrices, so a 2-D box at the last tile
//    would read the next item's keys. The tensor maps are 3-D (D, rows,
//    items): TMA clips each box at its item's last row and zero-fills the
//    rest. A zero key still scores s = 0, which is wrong for the maximum
//    when every real score is negative, so scores of keys >= nkv are also
//    masked by index (left out of the maximum, e = 0);
//  * ragged stores: the output is a column slice of the packed coupling
//    rows (row stride `ldo`); rows >= nq of an item and columns past D are
//    never written (the P V product's zero columns past D stay in
//    registers; an odd D's last column is stored alone);
//  * alignment: TMA needs rows of whole 16 bytes; a base off 16-byte
//    alignment (v = kv[:, D:] at D not a multiple of 8) is read through a
//    map from the aligned address below it (att_tensor_map). The wrapper
//    sends rows of other strides to the WMMA kernel below
//    (cross_attention_wmma_kernel, fc_cross_attention_wmma, D <= 128),
//    counted apart. An out whose rows cannot take bf16 pairs is written an
//    element at a time;
//  * a ring fault traps (mbar_wait) instead of hanging the card.
#include <mma.h>

#include "attention_wgmma.cuh"

using namespace nvcuda;

namespace {

constexpr int QB = 64;    // query rows per block
constexpr int KT = 64;    // keys per tile
constexpr int LDP = KT + 8;   // 72 bf16 per row of P

// The WMMA route's shared memory at tile width D (32, 64 or 128; a head
// width below it runs with its columns zero-filled): q, k and v tiles of
// (D + 8)-element rows, then a warp's f32 scores (and, at the end, its
// output rows) of max(64, D) + 4 columns, which P (bf16) reuses.
template <int D>
struct WmmaFwd {
  static constexpr int LDT = D + 8;
  static constexpr int LDS_F = (D > KT ? D : KT) + 4;
  static constexpr int SMEM = (QB + 2 * KT) * LDT * 2 + 4 * 16 * LDS_F * 4 + 1024;
};

// The WMMA route, for operands TMA cannot read: a block of 4 warps takes 64
// query rows (16 a warp); key/value tiles of 64 rows go through shared
// memory with synchronous loads (columns d..D-1 zero-filled); both products
// are WMMA 16x16x16, and each score tile is stored to shared memory and
// read back per lane.
template <int D>
__global__ void __launch_bounds__(128) cross_attention_wmma_kernel(
    const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldkv, bf16* __restrict__ out, int ldo, float* __restrict__ m_out,
    float* __restrict__ den_out, int nq, int nkv, int d) {
  constexpr int LDT = WmmaFwd<D>::LDT, LDS_F = WmmaFwd<D>::LDS_F;
  extern __shared__ uint8_t smem_raw[];
  bf16* const Qs = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* const Ks = Qs + QB * LDT;
  bf16* const Vs = Ks + KT * LDT;
  float* const Ss = reinterpret_cast<float*>(Vs + KT * LDT);  // per-warp scores; reused as bf16 P

  const int item = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qi = q + (size_t)item * nq * ldq;
  const bf16* ki = k + (size_t)item * nkv * ldkv;
  const bf16* vi = v + (size_t)item * nkv * ldkv;
  const bool q_vec = ((reinterpret_cast<uintptr_t>(q) & 15u) == 0) && (ldq % 8 == 0);
  const bool kv_vec = ((reinterpret_cast<uintptr_t>(k) & 15u) == 0) &&
                      ((reinterpret_cast<uintptr_t>(v) & 15u) == 0) && (ldkv % 8 == 0);

  load_tile_bf16<QB, D>(Qs, LDT, qi, ldq, q0, 0, nq, d, q_vec);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], Qs + warp * 16 * LDT + kk * 16, LDT);

  float* S = Ss + warp * 16 * LDS_F;
  bf16* P = reinterpret_cast<bf16*>(S);  // 16 x LDP bf16 fits in 16 x LDS_F f32
  const int r = lane >> 1;               // this lane's row within the warp's 16
  const int c0 = (lane & 1) * 32;        // and its 32 columns of each tile

  // scores of the warp's 16 rows against the current key tile -> S (f32)
  auto scores = [&]() {
#pragma unroll
    for (int jb = 0; jb < KT / 16; ++jb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, Ks + jb * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(acc, fq[kk], fk, acc);
      }
      wmma::store_matrix_sync(S + jb * 16, acc, LDS_F, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // pass 1: exact row maximum over all keys
  float m = -INFINITY;
  for (int j0 = 0; j0 < nkv; j0 += KT) {
    load_tile_bf16<KT, D>(Ks, LDT, ki, ldkv, j0, 0, nkv, d, kv_vec);
    __syncthreads();
    scores();
    for (int c = 0; c < 32; ++c)
      if (j0 + c0 + c < nkv) m = fmaxf(m, S[r * LDS_F + c0 + c]);
    __syncthreads();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // pass 2: e = exp(s - m), its f32 row sum, and P V with P = bf16(e)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[D / 16];
#pragma unroll
  for (int db = 0; db < D / 16; ++db) wmma::fill_fragment(o[db], 0.0f);
  float sum = 0.f;
  for (int j0 = 0; j0 < nkv; j0 += KT) {
    load_tile_bf16<KT, D>(Ks, LDT, ki, ldkv, j0, 0, nkv, d, kv_vec);
    load_tile_bf16<KT, D>(Vs, LDT, vi, ldkv, j0, 0, nkv, d, kv_vec);
    __syncthreads();
    scores();
    float e[32];
#pragma unroll
    for (int c = 0; c < 32; ++c)
      e[c] = (j0 + c0 + c < nkv) ? expf(S[r * LDS_F + c0 + c] - m) : 0.f;
    __syncwarp();  // every lane has read its scores before P overwrites them
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      sum += e[c];
      P[r * LDP + c0 + c] = f2bf(e[c]);
    }
    __syncwarp();
#pragma unroll
    for (int kb = 0; kb < KT / 16; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, P + kb * 16, LDP);
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, Vs + kb * 16 * LDT + db * 16, LDT);
        wmma::mma_sync(o[db], fp, fv, o[db]);
      }
    }
    __syncthreads();
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);

#pragma unroll
  for (int db = 0; db < D / 16; ++db)
    wmma::store_matrix_sync(S + db * 16, o[db], LDS_F, wmma::mem_row_major);
  __syncwarp();
  const int row = q0 + warp * 16 + r;
  const int oc0 = (lane & 1) * (D / 2);  // this lane's half of the D output columns
  if (row < nq) {
    bf16* orow = out + ((size_t)item * nq + row) * ldo;
    for (int c = 0; c < D / 2; ++c)
      if (oc0 + c < d) orow[oc0 + c] = f2bf(S[r * LDS_F + oc0 + c] / sum);
    if (m_out != nullptr && (lane & 1) == 0) {
      m_out[(size_t)item * nq + row] = m;
      den_out[(size_t)item * nq + row] = sum;
    }
  }
}

template <int D>
int launch_wmma(const void* q, int ldq, const void* k, const void* v, int ldkv, void* out,
                int ldo, void* m_out, void* den_out, int n_items, int nq, int nkv, int d,
                cudaStream_t stream) {
  static bool smem_set = false;   // the shared-memory opt-in, once a width
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_attention_wmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WmmaFwd<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((nq + QB - 1) / QB, n_items);
  cross_attention_wmma_kernel<D><<<grid, 128, WmmaFwd<D>::SMEM, stream>>>(
      (const bf16*)q, ldq, (const bf16*)k, (const bf16*)v, ldkv, (bf16*)out, ldo, (float*)m_out,
      (float*)den_out, nq, nkv, d);
  return (int)cudaGetLastError();
}

}  // namespace

FC_API int fc_cross_attention_wmma(const void* q, int ldq, const void* k, const void* v,
                                   int ldkv, void* out, int ldo, void* m_out, void* den_out,
                                   int n_items, int nq, int nkv, int d, void* stream) {
  if (n_items < 1 || nq < 1 || nkv < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FC_FWD_WMMA(DT) \
  launch_wmma<DT>(q, ldq, k, v, ldkv, out, ldo, m_out, den_out, n_items, nq, nkv, d, st)
  switch (att_tile(d)) {
    case 32: return FC_FWD_WMMA(32);
    case 64: return FC_FWD_WMMA(64);
    case 128: return FC_FWD_WMMA(128);
    default: return (int)cudaErrorInvalidValue;   // past 128: the wgmma route only
  }
#undef FC_FWD_WMMA
}

namespace {

// A block of the wgmma route: one consumer warpgroup of 64 query rows and
// a producer warp; the q tile, then a ring of FWD_STAGES stages of a K and
// a V tile (pass 1 uses only the K slot). Two stages let four blocks share
// an SM at D = 64 (92 registers a thread): on the H100 that was as fast as
// three blocks with four stages, or faster, at every main-path shape. At
// D = 128 the tiles are twice as large and two blocks share an SM.
constexpr int FWD_STAGES = 2;
constexpr int FWD_THREADS = 128 + 32;

template <int D>
struct Fwd {
  static constexpr int MIN_BLOCKS = D > 64 ? 2 : 4;
  static constexpr int SMEM = (1 + 2 * FWD_STAGES) * AttWidth<D>::TILE_BYTES + 1024;
  static_assert(MIN_BLOCKS * SMEM <= 232448, "the rings exceed the SM's shared memory");
};

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, Fwd<D>::MIN_BLOCKS)
    cross_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 bf16* __restrict__ out, int ldo, float* __restrict__ m_out,
                                 float* __restrict__ den_out, int nq, int nkv, int d) {
  using W = AttWidth<D>;
  constexpr int STAGES = FWD_STAGES, TB = W::TILE_BYTES;
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

  // the consumer warpgroup: query rows q0 + [0, 64)
  const int t = threadIdx.x;
  const int fc = frag_col(t);
  const uint8_t* qw = qs;
  float s[32];
  mbar_wait(&q_full, 0);

  // pass 1: the exact row maximum over the keys < nkv
  float mx0 = -INFINITY, mx1 = -INFINITY;   // rows r0 and r0 + 8
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], ring_parity(it, STAGES));
    wgmma_fence();
    tile_abt<D>(s, qw, ring + 2 * st * TB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    release_stage(&empty[st]);
    const int c0 = it * ATT_TILE + fc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (c0 + 8 * j + b < nkv) {
          mx0 = fmaxf(mx0, s[4 * j + b]);
          mx1 = fmaxf(mx1, s[4 * j + 2 + b]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }

  // pass 2: e = exp(s - m), its f32 row sums, and O += bf16(e) V, a box at
  // a time
  float acc[W::BOXES][32];
#pragma unroll
  for (int x = 0; x < W::BOXES; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int it = n_tiles + j, st = it % STAGES;
    const uint8_t* ks = ring + 2 * st * TB;
    mbar_wait(&full[st], ring_parity(it, STAGES));
    wgmma_fence();
    tile_abt<D>(s, qw, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
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
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < W::BOXES; ++x) tile_pb(acc[x], p, ks + TB + x * ATT_BOX_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < W::BOXES; ++x) fence_acc(acc[x]);
    release_stage(&empty[st]);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  // epilogue: bf16(O / sum) in pairs, rows < nq and columns < d only; m
  // and den. At the tile's own width with rows that take pairs, every
  // store is a pair (the other widths' guards cost the sample's short
  // launch 3-6% at D = 64 and 128 on the H100)
  const bool pairs = pair_aligned(out, ldo), whole = pairs && d == D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + frag_row(t) + 8 * half;
    if (row >= nq) continue;
    const float l = half ? l1 : l0;
    const size_t r = (size_t)blockIdx.y * nq + row;
    bf16* orow = out + r * ldo + fc;
    if (whole) {
#pragma unroll
      for (int x = 0; x < W::BOXES; ++x)
#pragma unroll
        for (int jj = 0; jj < W::BOX_COLS / 8; ++jj)
          *reinterpret_cast<uint32_t*>(orow + x * ATT_BOX + 8 * jj) =
              pack_bf16(acc[x][4 * jj + 2 * half] / l, acc[x][4 * jj + 2 * half + 1] / l);
    } else {
#pragma unroll
      for (int x = 0; x < W::BOXES; ++x)
#pragma unroll
        for (int jj = 0; jj < W::BOX_COLS / 8; ++jj)
          store2(orow + x * ATT_BOX + 8 * jj, fc + x * ATT_BOX + 8 * jj, d,
                 acc[x][4 * jj + 2 * half] / l, acc[x][4 * jj + 2 * half + 1] / l, pairs);
    }
    if (m_out != nullptr && fc == 0) {
      m_out[r] = half ? mx1 : mx0;
      den_out[r] = l;
    }
  }
}

template <int D>
int launch_wgmma(const void* q, int ldq, const void* k, const void* v, int ldkv, void* out,
                 int ldo, void* m_out, void* den_out, int n_items, int nq, int nkv, int d,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = att_tensor_map(&tq, q, n_items, nq, d, ldq);
  if (err == cudaSuccess) err = att_tensor_map(&tk, k, n_items, nkv, d, ldkv);
  if (err == cudaSuccess) err = att_tensor_map(&tv, v, n_items, nkv, d, ldkv);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set = false;   // the shared-memory opt-in, once a width
  if (!smem_set) {
    err = cudaFuncSetAttribute(cross_attention_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((nq + ATT_TILE - 1) / ATT_TILE, n_items);
  cross_attention_wgmma_kernel<D><<<grid, FWD_THREADS, Fwd<D>::SMEM, stream>>>(
      tq, tk, tv, (bf16*)out, ldo, (float*)m_out, (float*)den_out, nq, nkv, d);
  return (int)cudaGetLastError();
}

}  // namespace

// The wgmma route: q, k and v TMA-readable (row strides a multiple of 8;
// other operands return cudaErrorMisalignedAddress); out is written in
// pairs where its alignment allows it, else an element at a time. A head
// width d outside [1, 512] returns cudaErrorInvalidValue.
FC_API int fc_cross_attention(const void* q, int ldq, const void* k, const void* v, int ldkv,
                              void* out, int ldo, void* m_out, void* den_out, int n_items, int nq,
                              int nkv, int d, void* stream) {
  if (n_items < 1 || nq < 1 || nkv < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FC_FWD_WGMMA(DT) \
  launch_wgmma<DT>(q, ldq, k, v, ldkv, out, ldo, m_out, den_out, n_items, nq, nkv, d, st)
  switch (att_tile(d)) {
    case 32: return FC_FWD_WGMMA(32);
    case 64: return FC_FWD_WGMMA(64);
    case 128: return FC_FWD_WGMMA(128);
    case 256:
    case 512:
      return cross_attention_wide(q, ldq, k, v, ldkv, out, ldo, m_out, den_out, n_items, nq, nkv,
                                  d, st);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FC_FWD_WGMMA
}
