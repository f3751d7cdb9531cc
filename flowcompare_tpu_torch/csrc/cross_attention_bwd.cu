// cross_attention_bwd: the backward of cross_attention (one head of width
// 1 <= D <= 512, the entry points' `d`, on the smallest tile of 32, 64,
// 128, 256 or 512 columns that holds it, one template instance a tile, the
// two widest in cross_attention_bwd_wide.cu; a width past 512 returns
// cudaErrorInvalidValue) inside
// flow_layers_bwd (B5), the port of the attention part of the Pallas
// backward kernel's per-layer jax.vjp (flowcompare_tpu/ops/
// flow_layer_vjp_pallas.py, _bwd_kernel_impl over _layer_fwd_math).
//
// Forward (per item): s = q k^T, e = exp(s - m) with m the row maximum,
// a = (bf16(e) v) / den with den = sum(e). Given da, and with
// du = da / den and ddn = -sum(da * a) / den per row (attn_bwd_prep in
// flow_rows_bwd.cu):
//
//   dv = bf16(e)^T du        dS = bf16(e * (du v^T + ddn))
//   dq = dS k                dk = dS^T q
//
// each written in f32 and in bf16. P is rebuilt from q, k and the forward's
// saved row maximum (the forward's own, so e is the forward's e), and
// nothing of size nq x nkv is stored. Two kinds of block, no atomics, so
// the result is deterministic: a dq block walks the keys for 64 query rows;
// a dkv block walks the queries for 64 keys and writes [dk | dv] in kv's
// (rows, 2 D) layout.
//
// What bounds it on the H100: five D-deep products a score (q k^T, du v^T,
// dS k in a dq block; k q^T, v du^T, e^T du, dS^T q in a dkv block:
// seven issued, five necessary) and two exponentials a score against a few
// bytes a row: operations, with the SFU's ex2 as co-limiter.
//
// Design (TMA + wgmma on sm_90a, as cross_attention.cu): a block has one
// consumer warpgroup of 64 rows and a producer warp, two blocks to an SM.
// The producer loads the block's own tiles once (q and du, or k and v) and
// streams the other side's tiles (k and v, or q and du: 64 rows x D dims
// each, as 64 x 64 boxes, attention_wgmma.cuh) through a ring with full /
// empty mbarriers, of 4 stages at D <= 64 and 2 at D = 128 (whose 16 KB
// tiles would not leave two blocks room for 4). The warpgroup
// keeps S, dP and dS in registers: both score products are wgmma
// m64n64k16 from shared memory, e = 2^((s - m) log2(e)) on the SFU, and e
// or dS is rounded to bf16 straight into wgmma's A-register layout for the
// products that follow (with B read MN-major from the same tile that was
// read K-major before).
//  * a dq block (attn_bwd_dq_block, per query tile, over key tiles):
//    S = Q K^T, dP = dU V^T, dS = bf16(e (dP + ddn_row)), dq += dS K;
//  * a dkv block (attn_bwd_dkv_block, per key tile, over query tiles):
//    S^T = K Q^T, dP^T = V dU^T, e^T = exp(S^T - m_col), dv += bf16(e^T) dU,
//    dS^T = bf16(e^T (dP^T + ddn_col)), dk += dS^T Q; each query tile's m
//    and ddn are staged in the stage's shared memory by the producer warp.
//    At D = 128 each key tile has two dkv blocks, one a 64-column half of
//    dk and dv: each recomputes S^T and dP^T over all 128 dims, so a block
//    holds dk and dv as at D = 64 (a block holding both halves would need
//    about 230 registers a thread, past the 204 of two blocks to an SM);
//  * both kinds of block run in one launch (attn_bwd_wgmma_kernel): at two
//    blocks to an SM the two grids alone (320 and 400 blocks at 20 x 1024 x
//    1250) each end in a nearly empty second wave; sharing the waves made
//    the backward faster at every main-path shape on the H100.
// Where trouble lies, and what the design does about it:
//  * ragged tiles across items (nkv = 1250 = 19 x 64 + 34, nq = 4000 =
//    62 x 64 + 32): 3-D tensor maps (D, rows, items) clip every box at its
//    item's last row and zero-fill the rest, so no tile reads the next
//    item; keys >= nkv (dq blocks) and queries >= nq (dkv blocks) are also
//    masked by index (e = 0), and the m and ddn of queries >= nq are never
//    read (m = +inf and ddn = 0 are staged instead);
//  * registers: at D = 64 a dkv block holds dk and dv (2 x 32 f32 a
//    thread) beside S^T and dP^T (64 more) and two bf16 fragments (32):
//    159 registers a thread and no spills in the compiler's report (-Xptxas -v, kept beside
//    the library), so two blocks share an SM. Issuing the next tile's score
//    products ahead of this tile's exponentials (FlashAttention-3's overlap
//    inside a warpgroup) needs two more fragments there and spilled; in a
//    dq block it did not spill but was no faster on the H100; 128-row
//    blocks (two warpgroups sharing each streamed tile) were slower too, and
//    so was skipping the index mask on full tiles;
//  * the outputs are never written past their D columns (dq) or 2 D
//    columns (dkv): the products' zero columns past D stay in registers,
//    and pairs that an odd D leaves unaligned (dv from column D) are
//    stored one element at a time;
//  * alignment: operands whose rows are not whole 16 bytes take the WMMA
//    kernels below (fc_attention_bwd_wmma, D <= 128), counted apart by the
//    wrapper; a base off 16-byte alignment is read at a column offset
//    (att_tensor_map), and outputs whose rows cannot take pairs are
//    written an element at a time;
//  * a ring fault traps (mbar_wait) instead of hanging the card.
#include <mma.h>

#include "attention_wgmma.cuh"

using namespace nvcuda;

namespace {

constexpr int QB = 64;         // query rows per tile
constexpr int KT = 64;         // keys per tile
constexpr int LDP = KT + 8;    // 72 bf16 per row of a warp's P (e or dS)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The WMMA route's shared memory at tile width D (32, 64 or 128; a head
// width d below it runs with its columns zero-filled): two 64-row tiles of
// (D + 8)-element rows, a warp's f32 tile of max(64, D) + 4 columns (16
// rows; scores, and the output rows at the end; the tile staging at the
// start), a warp's bf16 P, and (dkv) the query tile's m and ddn.
template <int D>
struct WmmaBwd {
  static constexpr int LDT = D + 8;
  static constexpr int LDS_F = (D > KT ? D : KT) + 4;
  static constexpr int SMEM = 2 * 64 * LDT * 2 + 4 * 16 * LDS_F * 4 + 4 * 16 * LDP * 2 +
                              2 * QB * 4 + 1024;
  static_assert(64 * LDT * 2 <= 4 * 16 * LDS_F * 4, "the staging tile exceeds the f32 tiles");
};

// The WMMA route, for operands TMA cannot read: 128-thread blocks of 64
// rows, synchronous tile loads, WMMA 16x16x16 products with every score
// tile stored to shared memory and read back per lane.
__device__ __forceinline__ bool vec_ok(const void* p, int ld) {
  return ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) && (ld % 8 == 0);
}

// out (16 x 64, f32, ld LDS_F) = a (16 x D as D / 16 fragments) @ tile^T,
// tile (64 rows x D, bf16, ld LDT) read column-major.
template <int D>
__device__ __forceinline__ void rows_by_tile_t(const FragA* a, const bf16* tile, float* out) {
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, tile + jb * 16 * WmmaBwd<D>::LDT + kk * 16, WmmaBwd<D>::LDT);
      wmma::mma_sync(acc, a[kk], fb, acc);
    }
    wmma::store_matrix_sync(out + jb * 16, acc, WmmaBwd<D>::LDS_F, wmma::mem_row_major);
  }
  __syncwarp();
}

// acc (16 x D as D / 16 fragments) += p (16 x 64, bf16, ld LDP) @ tile
// (64 x D, ld LDT)
template <int D>
__device__ __forceinline__ void accumulate_p_tile(FragC* acc, const bf16* p, const bf16* tile) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    FragA fp;
    wmma::load_matrix_sync(fp, p + kb * 16, LDP);
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, tile + kb * 16 * WmmaBwd<D>::LDT + db * 16, WmmaBwd<D>::LDT);
      wmma::mma_sync(acc[db], fp, fb, acc[db]);
    }
  }
}

// Load this warp's 16 rows of a 64 x D bf16 tile (staged through `stage`)
// into D / 16 A fragments.
template <int D>
__device__ __forceinline__ void load_rows(FragA* frag, bf16* stage, const bf16* g, int ld,
                                          int row0, int nrows, int d, bool vec) {
  constexpr int LDT = WmmaBwd<D>::LDT;
  load_tile_bf16<64, D>(stage, LDT, g, ld, row0, 0, nrows, d, vec);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(frag[kk], stage + warp * 16 * LDT + kk * 16, LDT);
  __syncthreads();
}

// Write the first d columns of a warp's 16 x D accumulator (through its f32
// tile S) to row `orow` of out (f32) and out_b (bf16) at column col0, each
// lane half a row; orow == (size_t)-1 skips.
template <int D>
__device__ __forceinline__ void store_rows(const FragC* acc, float* S, size_t orow, float* out,
                                           int ldo, bf16* out_b, int ldob, int col0, int d,
                                           int lane) {
  constexpr int LDS_F = WmmaBwd<D>::LDS_F;
#pragma unroll
  for (int db = 0; db < D / 16; ++db)
    wmma::store_matrix_sync(S + db * 16, acc[db], LDS_F, wmma::mem_row_major);
  __syncwarp();
  if (orow != (size_t)-1) {
    const int r = lane >> 1, c0 = (lane & 1) * (D / 2);
    for (int c = 0; c < D / 2 && c0 + c < d; ++c) {
      const float val = S[r * LDS_F + c0 + c];
      out[orow * ldo + col0 + c0 + c] = val;
      out_b[orow * ldob + col0 + c0 + c] = f2bf(val);
    }
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(128) attn_bwd_dq_wmma_kernel(
    const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldkv, const bf16* __restrict__ du, int lddu, const float* __restrict__ ddn,
    const float* __restrict__ mrow, float* __restrict__ dq, int lddq, bf16* __restrict__ dq_b,
    int lddqb, int nq, int nkv, int d) {
  constexpr int LDT = WmmaBwd<D>::LDT, LDS_F = WmmaBwd<D>::LDS_F;
  extern __shared__ uint8_t smem_raw[];
  bf16* const Ks = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* const Vs = Ks + KT * LDT;
  // per-warp f32 tiles, which stage the q and du tiles at the start
  float* const Ss = reinterpret_cast<float*>(Vs + KT * LDT);
  bf16* const Ps = reinterpret_cast<bf16*>(Ss + 4 * 16 * LDS_F);  // per-warp bf16 dS

  const int item = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* ki = k + (size_t)item * nkv * ldkv;
  const bf16* vi = v + (size_t)item * nkv * ldkv;
  const bool kv_vec = vec_ok(k, ldkv) && vec_ok(v, ldkv);

  bf16* stage = reinterpret_cast<bf16*>(Ss);  // 64 x LDT bf16 fits in the f32 tiles
  FragA fq[D / 16], fdu[D / 16];
  load_rows<D>(fq, stage, q + (size_t)item * nq * ldq, ldq, q0, nq, d, vec_ok(q, ldq));
  load_rows<D>(fdu, stage, du + (size_t)item * nq * lddu, lddu, q0, nq, d, vec_ok(du, lddu));

  float* S = Ss + warp * 16 * LDS_F;
  bf16* P = Ps + warp * 16 * LDP;
  const int r = lane >> 1;         // this lane's row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its 32 columns of each tile
  const int row = q0 + warp * 16 + r;
  const float mr = row < nq ? mrow[(size_t)item * nq + row] : 0.f;
  const float dr = row < nq ? ddn[(size_t)item * nq + row] : 0.f;

  FragC o[D / 16];
#pragma unroll
  for (int db = 0; db < D / 16; ++db) wmma::fill_fragment(o[db], 0.0f);
  for (int j0 = 0; j0 < nkv; j0 += KT) {
    load_tile_bf16<KT, D>(Ks, LDT, ki, ldkv, j0, 0, nkv, d, kv_vec);
    load_tile_bf16<KT, D>(Vs, LDT, vi, ldkv, j0, 0, nkv, d, kv_vec);
    __syncthreads();
    rows_by_tile_t<D>(fq, Ks, S);  // s = q k^T
    float e[32];
#pragma unroll
    for (int c = 0; c < 32; ++c)
      e[c] = (j0 + c0 + c < nkv) ? expf(S[r * LDS_F + c0 + c] - mr) : 0.f;
    __syncwarp();
    rows_by_tile_t<D>(fdu, Vs, S);  // du v^T
#pragma unroll
    for (int c = 0; c < 32; ++c) P[r * LDP + c0 + c] = f2bf(e[c] * (S[r * LDS_F + c0 + c] + dr));
    __syncwarp();
    accumulate_p_tile<D>(o, P, Ks);  // dq += dS k
    __syncthreads();
  }
  store_rows<D>(o, S, row < nq ? (size_t)item * nq + row : (size_t)-1, dq, lddq, dq_b, lddqb, 0,
                d, lane);
}

template <int D>
__global__ void __launch_bounds__(128) attn_bwd_dkv_wmma_kernel(
    const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldkv, const bf16* __restrict__ du, int lddu, const float* __restrict__ ddn,
    const float* __restrict__ mrow, float* __restrict__ dkv, int lddkv,
    bf16* __restrict__ dkv_b, int lddkvb, int nq, int nkv, int d) {
  constexpr int LDT = WmmaBwd<D>::LDT, LDS_F = WmmaBwd<D>::LDS_F;
  extern __shared__ uint8_t smem_raw[];
  bf16* const Qs = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* const DUs = Qs + QB * LDT;
  // per-warp f32 tiles, which stage the k and v tiles at the start
  float* const Ss = reinterpret_cast<float*>(DUs + QB * LDT);
  bf16* const Ps = reinterpret_cast<bf16*>(Ss + 4 * 16 * LDS_F);  // per-warp bf16 e, then dS
  float* const ms = reinterpret_cast<float*>(Ps + 4 * 16 * LDP);
  float* const dns = ms + QB;

  const int item = blockIdx.y;
  const int k0 = blockIdx.x * KT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qi = q + (size_t)item * nq * ldq;
  const bf16* dui = du + (size_t)item * nq * lddu;
  const bool q_vec = vec_ok(q, ldq), du_vec = vec_ok(du, lddu);

  bf16* stage = reinterpret_cast<bf16*>(Ss);
  const bool kv_vec = vec_ok(k, ldkv) && vec_ok(v, ldkv);
  FragA fk[D / 16], fv[D / 16];
  load_rows<D>(fk, stage, k + (size_t)item * nkv * ldkv, ldkv, k0, nkv, d, kv_vec);
  load_rows<D>(fv, stage, v + (size_t)item * nkv * ldkv, ldkv, k0, nkv, d, kv_vec);

  float* S = Ss + warp * 16 * LDS_F;
  bf16* P = Ps + warp * 16 * LDP;
  const int r = lane >> 1;         // this lane's key row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its 32 query columns of each tile

  FragC dk[D / 16], dv[D / 16];
#pragma unroll
  for (int db = 0; db < D / 16; ++db) {
    wmma::fill_fragment(dk[db], 0.0f);
    wmma::fill_fragment(dv[db], 0.0f);
  }
  for (int i0 = 0; i0 < nq; i0 += QB) {
    load_tile_bf16<QB, D>(Qs, LDT, qi, ldq, i0, 0, nq, d, q_vec);
    load_tile_bf16<QB, D>(DUs, LDT, dui, lddu, i0, 0, nq, d, du_vec);
    if (tid < QB) {
      const bool ok = i0 + tid < nq;
      ms[tid] = ok ? mrow[(size_t)item * nq + i0 + tid] : 0.f;
      dns[tid] = ok ? ddn[(size_t)item * nq + i0 + tid] : 0.f;
    }
    __syncthreads();
    rows_by_tile_t<D>(fk, Qs, S);  // s^T = k q^T
    float e[32];
#pragma unroll
    for (int c = 0; c < 32; ++c)
      e[c] = (i0 + c0 + c < nq) ? expf(S[r * LDS_F + c0 + c] - ms[c0 + c]) : 0.f;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) P[r * LDP + c0 + c] = f2bf(e[c]);
    __syncwarp();
    accumulate_p_tile<D>(dv, P, DUs);  // dv += bf16(e)^T du
    rows_by_tile_t<D>(fv, DUs, S);     // (du v^T)^T = v du^T
#pragma unroll
    for (int c = 0; c < 32; ++c)
      P[r * LDP + c0 + c] = f2bf(e[c] * (S[r * LDS_F + c0 + c] + dns[c0 + c]));
    __syncwarp();
    accumulate_p_tile<D>(dk, P, Qs);  // dk += dS^T q
    __syncthreads();
  }
  const int key = k0 + warp * 16 + r;
  const size_t orow = key < nkv ? (size_t)item * nkv + key : (size_t)-1;
  store_rows<D>(dk, S, orow, dkv, lddkv, dkv_b, lddkvb, 0, d, lane);
  store_rows<D>(dv, S, orow, dkv, lddkv, dkv_b, lddkvb, d, d, lane);
}

template <int D>
int launch_bwd_wmma(const void* q, int ldq, const void* k, const void* v, int ldkv,
                    const void* du, int lddu, const void* ddn, const void* mrow, void* dq,
                    int lddq, void* dq_b, int lddqb, void* dkv, int lddkv, void* dkv_b,
                    int lddkvb, int n_items, int nq, int nkv, int d, cudaStream_t stream) {
  static bool smem_set = false;   // the shared-memory opt-ins, once a width
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_wmma_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           WmmaBwd<D>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dkv_wmma_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, WmmaBwd<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 gq((nq + QB - 1) / QB, n_items);
  attn_bwd_dq_wmma_kernel<D><<<gq, 128, WmmaBwd<D>::SMEM, stream>>>(
      (const bf16*)q, ldq, (const bf16*)k, (const bf16*)v, ldkv, (const bf16*)du, lddu,
      (const float*)ddn, (const float*)mrow, (float*)dq, lddq, (bf16*)dq_b, lddqb, nq, nkv, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 gk((nkv + KT - 1) / KT, n_items);
  attn_bwd_dkv_wmma_kernel<D><<<gk, 128, WmmaBwd<D>::SMEM, stream>>>(
      (const bf16*)q, ldq, (const bf16*)k, (const bf16*)v, ldkv, (const bf16*)du, lddu,
      (const float*)ddn, (const float*)mrow, (float*)dkv, lddkv, (bf16*)dkv_b, lddkvb, nq, nkv,
      d);
  return (int)cudaGetLastError();
}

}  // namespace

FC_API int fc_attention_bwd_wmma(const void* q, int ldq, const void* k, const void* v,
                                 int ldkv, const void* du, int lddu, const void* ddn,
                                 const void* mrow, void* dq, int lddq, void* dq_b, int lddqb,
                                 void* dkv, int lddkv, void* dkv_b, int lddkvb, int n_items,
                                 int nq, int nkv, int d, void* stream) {
  if (n_items < 1 || nq < 1 || nkv < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FC_BWD_WMMA(D)                                                                      \
  launch_bwd_wmma<D>(q, ldq, k, v, ldkv, du, lddu, ddn, mrow, dq, lddq, dq_b, lddqb, dkv,   \
                     lddkv, dkv_b, lddkvb, n_items, nq, nkv, d, st)
  switch (att_tile(d)) {
    case 32: return FC_BWD_WMMA(32);
    case 64: return FC_BWD_WMMA(64);
    case 128: return FC_BWD_WMMA(128);
    default: return (int)cudaErrorInvalidValue;   // past 128: the wgmma route only
  }
#undef FC_BWD_WMMA
}

namespace {

// A block of the wgmma route: one consumer warpgroup of 64 rows (queries
// for dq, keys for dkv) and a producer warp; the block's own two tiles, then
// a ring of stages of the other side's two tiles. About 160 registers a
// thread at D = 64: two blocks to an SM. A dkv block accumulates `BOXES_OUT`
// 64-column boxes of dk and dv: all of them at D <= 64, one at D = 128
// (two blocks a key tile, `DKV_SPLIT`).
constexpr int BWD_THREADS = 128 + 32;
constexpr int BWD_MIN_BLOCKS = 2;

template <int D>
struct Bwd {
  static constexpr int STAGES = D > 64 ? 2 : 4;
  static constexpr int DKV_SPLIT = AttWidth<D>::BOXES;   // dkv blocks a key tile
  static constexpr int SMEM = (2 + 2 * STAGES) * AttWidth<D>::TILE_BYTES + 1024;
  static_assert(BWD_MIN_BLOCKS * SMEM <= 232448, "the rings exceed the SM's shared memory");
};

template <int D>
__device__ __forceinline__ void attn_bwd_dq_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                                  const CUtensorMap& tv, const CUtensorMap& tdu,
                                                  int d,
                                                  const float* __restrict__ ddn,
                                                  const float* __restrict__ mrow,
                                                  float* __restrict__ dq, int lddq,
                                                  bf16* __restrict__ dq_b, int lddqb, int nq,
                                                  int nkv, int q_block) {
  using W = AttWidth<D>;
  constexpr int STAGES = Bwd<D>::STAGES, TB = W::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], own_full;
  uint8_t* const own = align1024(smem_raw);   // the Q tile, then the dU tile
  uint8_t* const ring = own + 2 * TB;   // stage s: K, then V
  const int item = blockIdx.y, q0 = q_block * ATT_TILE;
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
    if (threadIdx.x == 128) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      prefetch_tensor_map(&tdu);
      mbar_expect_tx(&own_full, 2 * TB);
      tma_load_tile<D>(own, &tq, &own_full, q0, item);
      tma_load_tile<D>(own + TB, &tdu, &own_full, q0, item);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ring_parity(it, STAGES) ^ 1);
        uint8_t* ks = ring + 2 * s * TB;
        mbar_expect_tx(&full[s], 2 * TB);
        tma_load_tile<D>(ks, &tk, &full[s], it * ATT_TILE, item);
        tma_load_tile<D>(ks + TB, &tv, &full[s], it * ATT_TILE, item);
      }
    }
    return;
  }

  // the consumer warpgroup: query rows q0 + [0, 64)
  const int t = threadIdx.x;
  const int fc = frag_col(t);
  const uint8_t* qw = own;
  const uint8_t* duw = own + TB;
  float mr[2], dd[2];   // m and ddn of rows r0 and r0 + 8 (+inf and 0 past nq)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + frag_row(t) + 8 * half;
    const size_t r = (size_t)item * nq + row;
    mr[half] = row < nq ? mrow[r] : INFINITY;
    dd[half] = row < nq ? ddn[r] : 0.f;
  }
  float s[32], dp[32], acc[W::BOXES][32];
#pragma unroll
  for (int x = 0; x < W::BOXES; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  mbar_wait(&own_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const uint8_t* ks = ring + 2 * st * TB;
    mbar_wait(&full[st], ring_parity(it, STAGES));
    wgmma_fence();
    tile_abt<D>(s, qw, ks);          // S = Q K^T
    tile_abt<D>(dp, duw, ks + TB);   // dP = dU V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    const int c0 = it * ATT_TILE + fc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const bool ok = c0 + 8 * j + b < nkv;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half + b;
          const float e = ok ? exp_sub(s[i], mr[half]) : 0.f;
          s[i] = e * (dp[i] + dd[half]);      // dS, rounded to bf16 by pack_a
        }
      }
    }
    uint32_t p[16];
    pack_a(s, p);
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < W::BOXES; ++x)
      tile_pb(acc[x], p, ks + x * ATT_BOX_BYTES);   // dq += dS K (K read MN-major)
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < W::BOXES; ++x) fence_acc(acc[x]);
    release_stage(&empty[st]);
  }
#pragma unroll
  for (int x = 0; x < W::BOXES; ++x)
    store_tile<W::BOX_COLS>(acc[x], t, q0, nq, (size_t)item * nq, dq, lddq, dq_b, lddqb,
                            x * ATT_BOX, d - x * ATT_BOX);
}

template <int D>
__device__ __forceinline__ void attn_bwd_dkv_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                                   const CUtensorMap& tv, const CUtensorMap& tdu,
                                                   int d,
                                                   const float* __restrict__ ddn,
                                                   const float* __restrict__ mrow,
                                                   float* __restrict__ dkv, int lddkv,
                                                   bf16* __restrict__ dkv_b, int lddkvb, int nq,
                                                   int nkv, int dkv_block) {
  using W = AttWidth<D>;
  constexpr int STAGES = Bwd<D>::STAGES, TB = W::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], own_full;
  // each stage's queries: m (+inf past nq) and ddn (0 past nq)
  __shared__ __align__(16) float ml_s[STAGES][ATT_TILE], dd_s[STAGES][ATT_TILE];
  uint8_t* const own = align1024(smem_raw);   // the K tile, then the V tile
  uint8_t* const ring = own + 2 * TB;   // stage s: Q, then dU
  // this block's key tile, and the box of dk and dv it accumulates
  const int box = dkv_block % Bwd<D>::DKV_SPLIT;
  const int item = blockIdx.y, k0 = (dkv_block / Bwd<D>::DKV_SPLIT) * ATT_TILE;
  const int n_tiles = (nq + ATT_TILE - 1) / ATT_TILE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);   // the producer warp's 32 lanes (lane 0 with the bytes)
      mbar_init(&empty[s], 4);
    }
    mbar_init(&own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer warp: lane 0 issues the loads, every lane stages m and ddn
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      prefetch_tensor_map(&tdu);
      mbar_expect_tx(&own_full, 2 * TB);
      tma_load_tile<D>(own, &tk, &own_full, k0, item);
      tma_load_tile<D>(own + TB, &tv, &own_full, k0, item);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES, i0 = it * ATT_TILE;
      mbar_wait(&empty[s], ring_parity(it, STAGES) ^ 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = lane + 32 * h, qi = i0 + idx;
        const size_t r = (size_t)item * nq + qi;
        ml_s[s][idx] = qi < nq ? mrow[r] : INFINITY;
        dd_s[s][idx] = qi < nq ? ddn[r] : 0.f;
      }
      if (lane == 0) {
        uint8_t* qs = ring + 2 * s * TB;
        mbar_expect_tx(&full[s], 2 * TB);
        tma_load_tile<D>(qs, &tq, &full[s], i0, item);
        tma_load_tile<D>(qs + TB, &tdu, &full[s], i0, item);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // the consumer warpgroup: keys k0 + [0, 64)
  const int t = threadIdx.x;
  const int fc = frag_col(t);
  const uint8_t* kw = own;
  const uint8_t* vw = own + TB;
  float s[32], dp[32], dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&own_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const uint8_t* qs = ring + 2 * st * TB;
    const uint8_t* dus = qs + TB;
    mbar_wait(&full[st], ring_parity(it, STAGES));
    wgmma_fence();
    tile_abt<D>(s, kw, qs);     // S^T = K Q^T
    tile_abt<D>(dp, vw, dus);   // dP^T = V dU^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    const int c0 = it * ATT_TILE + fc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 mlc = *reinterpret_cast<const float2*>(&ml_s[st][8 * j + fc]);
      const float2 ddc = *reinterpret_cast<const float2*>(&dd_s[st][8 * j + fc]);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const bool ok = c0 + 8 * j + b < nq;
        const float m_c = b ? mlc.y : mlc.x, d_c = b ? ddc.y : ddc.x;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half + b;
          const float e = ok ? exp_sub(s[i], m_c) : 0.f;
          s[i] = e;                     // e^T, rounded to bf16 by pack_a
          dp[i] = e * (dp[i] + d_c);    // dS^T, likewise
        }
      }
    }
    uint32_t pe[16], pd[16];
    pack_a(s, pe);
    pack_a(dp, pd);
    wgmma_fence();
    tile_pb(dv, pe, dus + box * ATT_BOX_BYTES);   // dv += bf16(e^T) dU (dU read MN-major)
    tile_pb(dk, pd, qs + box * ATT_BOX_BYTES);    // dk += dS^T Q (Q read MN-major)
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    release_stage(&empty[st]);
  }
  const size_t base = (size_t)item * nkv;
  store_tile<W::BOX_COLS>(dk, t, k0, nkv, base, dkv, lddkv, dkv_b, lddkvb, box * ATT_BOX,
                          d - box * ATT_BOX);
  store_tile<W::BOX_COLS>(dv, t, k0, nkv, base, dkv, lddkv, dkv_b, lddkvb, d + box * ATT_BOX,
                          d - box * ATT_BOX);
}

// One launch for both kernels' blocks: blocks [0, dq_blocks) of each item
// take query tiles (dq), the rest key tiles ([dk | dv], DKV_SPLIT blocks a
// tile), so the two grids share the card's waves.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
    attn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdu, int d,
                          const float* __restrict__ ddn, const float* __restrict__ mrow,
                          float* __restrict__ dq, int lddq, bf16* __restrict__ dq_b, int lddqb,
                          float* __restrict__ dkv, int lddkv, bf16* __restrict__ dkv_b,
                          int lddkvb, int nq, int nkv, int dq_blocks) {
  if ((int)blockIdx.x < dq_blocks)
    attn_bwd_dq_block<D>(tq, tk, tv, tdu, d, ddn, mrow, dq, lddq, dq_b, lddqb, nq, nkv,
                         blockIdx.x);
  else
    attn_bwd_dkv_block<D>(tq, tk, tv, tdu, d, ddn, mrow, dkv, lddkv, dkv_b, lddkvb, nq,
                          nkv, blockIdx.x - dq_blocks);
}

template <int D>
int launch_bwd_wgmma(const void* q, int ldq, const void* k, const void* v, int ldkv,
                     const void* du, int lddu, const void* ddn, const void* mrow, void* dq,
                     int lddq, void* dq_b, int lddqb, void* dkv, int lddkv, void* dkv_b,
                     int lddkvb, int n_items, int nq, int nkv, int d, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdu;
  cudaError_t err = att_tensor_map(&tq, q, n_items, nq, d, ldq);
  if (err == cudaSuccess) err = att_tensor_map(&tk, k, n_items, nkv, d, ldkv);
  if (err == cudaSuccess) err = att_tensor_map(&tv, v, n_items, nkv, d, ldkv);
  if (err == cudaSuccess) err = att_tensor_map(&tdu, du, n_items, nq, d, lddu);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set = false;   // the shared-memory opt-in, once a width
  if (!smem_set) {
    err = cudaFuncSetAttribute(attn_bwd_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int dq_blocks = (nq + ATT_TILE - 1) / ATT_TILE;
  const dim3 grid(dq_blocks + Bwd<D>::DKV_SPLIT * ((nkv + ATT_TILE - 1) / ATT_TILE), n_items);
  attn_bwd_wgmma_kernel<D><<<grid, BWD_THREADS, Bwd<D>::SMEM, stream>>>(
      tq, tk, tv, tdu, d, (const float*)ddn, (const float*)mrow, (float*)dq, lddq, (bf16*)dq_b,
      lddqb, (float*)dkv, lddkv, (bf16*)dkv_b, lddkvb, nq, nkv, dq_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// The wgmma route: q, k, v and du TMA-readable (row strides a multiple of
// 8; other operands return cudaErrorMisalignedAddress); the outputs are
// written in pairs where their alignment allows it, else an element at a
// time. A head width d outside [1, 512] returns cudaErrorInvalidValue.
FC_API int fc_attention_bwd(const void* q, int ldq, const void* k, const void* v, int ldkv,
                            const void* du, int lddu, const void* ddn, const void* mrow, void* dq,
                            int lddq, void* dq_b, int lddqb, void* dkv, int lddkv, void* dkv_b,
                            int lddkvb, int n_items, int nq, int nkv, int d, void* stream) {
  if (n_items < 1 || nq < 1 || nkv < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FC_BWD_WGMMA(D)                                                                     \
  launch_bwd_wgmma<D>(q, ldq, k, v, ldkv, du, lddu, ddn, mrow, dq, lddq, dq_b, lddqb, dkv,  \
                      lddkv, dkv_b, lddkvb, n_items, nq, nkv, d, st)
  switch (att_tile(d)) {
    case 32: return FC_BWD_WGMMA(32);
    case 64: return FC_BWD_WGMMA(64);
    case 128: return FC_BWD_WGMMA(128);
    case 256:
    case 512:
      return attention_bwd_wide(q, ldq, k, v, ldkv, du, lddu, ddn, mrow, dq, lddq, dq_b, lddqb,
                                dkv, lddkv, dkv_b, lddkvb, n_items, nq, nkv, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FC_BWD_WGMMA
}
