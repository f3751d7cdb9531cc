// cross_attention_bwd: the backward of cross_attention (one head, d = 64)
// inside flow_layers_bwd (B5), the port of the attention part of the Pallas
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
// (rows, 128) layout.
//
// What bounds it on the H100: five 64-deep products a score (q k^T, du v^T,
// dS k in a dq block; k q^T, v du^T, e^T du, dS^T q in a dkv block:
// seven issued, five necessary) and two exponentials a score against a few
// bytes a row: operations, with the SFU's ex2 as co-limiter.
//
// Design (TMA + wgmma on sm_90a, as cross_attention.cu): a block has one
// consumer warpgroup of 64 rows and a producer warp, two blocks to an SM.
// The producer loads the block's own tiles once (q and du, or k and v) and
// streams the other side's tiles (k and v, or q and du: 64 rows x 64 dims
// each) through a 4-stage ring with full / empty mbarriers. The warpgroup
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
//    and ddn are staged in the stage's shared memory by the producer warp;
//  * both kinds of block run in one launch (attn_bwd_wgmma_kernel): at two
//    blocks to an SM the two grids alone (320 and 400 blocks at 20 x 1024 x
//    1250) each end in a nearly empty second wave; sharing the waves made
//    the backward faster at every main-path shape on the H100.
// Where trouble lies, and what the design does about it:
//  * ragged tiles across items (nkv = 1250 = 19 x 64 + 34, nq = 4000 =
//    62 x 64 + 32): 3-D tensor maps (64, rows, items) clip every box at its
//    item's last row and zero-fill the rest, so no tile reads the next
//    item; keys >= nkv (dq blocks) and queries >= nq (dkv blocks) are also
//    masked by index (e = 0), and the m and ddn of queries >= nq are never
//    read (m = +inf and ddn = 0 are staged instead);
//  * registers: a dkv block holds dk and dv (2 x 32 f32 a thread) beside
//    S^T and dP^T (64 more) and two bf16 fragments (32): 159 registers a
//    thread and no spills in the compiler's report (-Xptxas -v, kept beside
//    the library), so two blocks share an SM. Issuing the next tile's score
//    products ahead of this tile's exponentials (FlashAttention-3's overlap
//    inside a warpgroup) needs two more fragments there and spilled; in a
//    dq block it did not spill but was no faster on the H100; 128-row
//    blocks (two warpgroups sharing each streamed tile) were slower too, and
//    so was skipping the index mask on full tiles;
//  * alignment: operands TMA cannot read take the WMMA kernels below
//    (fc_attention_bwd_wmma), counted apart by the wrapper;
//  * a ring fault traps (mbar_wait) instead of hanging the card.
#include <mma.h>

#include "attention_wgmma.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 64;          // head dimension
constexpr int QB = 64;         // query rows per tile
constexpr int KT = 64;         // keys per tile
constexpr int LDT = D + 8;     // 72 bf16 per smem row
constexpr int LDS_F = KT + 4;  // 68 f32 per score row

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The WMMA route, for operands TMA cannot read: 128-thread blocks of 64
// rows, synchronous tile loads, WMMA 16x16x16 products with every score
// tile stored to shared memory and read back per lane.
__device__ __forceinline__ bool vec_ok(const void* p, int ld) {
  return ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) && (ld % 8 == 0);
}

// out (16 x 64, f32, ld LDS_F) = a (16 x 64 as 4 fragments) @ tile^T, tile
// (64 rows x 64, bf16, ld LDT) read column-major.
__device__ __forceinline__ void rows_by_tile_t(const FragA* a, const bf16* tile, float* out) {
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, tile + jb * 16 * LDT + kk * 16, LDT);
      wmma::mma_sync(acc, a[kk], fb, acc);
    }
    wmma::store_matrix_sync(out + jb * 16, acc, LDS_F, wmma::mem_row_major);
  }
  __syncwarp();
}

// acc (16 x 64 as 4 fragments) += p (16 x 64, bf16, ld LDT) @ tile (64 x 64, ld LDT)
__device__ __forceinline__ void accumulate_p_tile(FragC* acc, const bf16* p, const bf16* tile) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    FragA fp;
    wmma::load_matrix_sync(fp, p + kb * 16, LDT);
#pragma unroll
    for (int db = 0; db < 4; ++db) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, tile + kb * 16 * LDT + db * 16, LDT);
      wmma::mma_sync(acc[db], fp, fb, acc[db]);
    }
  }
}

// Load this warp's 16 rows of a 64 x 64 bf16 tile (staged through `stage`)
// into four A fragments.
__device__ __forceinline__ void load_rows(FragA* frag, bf16* stage, const bf16* g, int ld,
                                          int row0, int nrows, bool vec) {
  load_tile_bf16<64, D>(stage, LDT, g, ld, row0, 0, nrows, D, vec);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(frag[kk], stage + warp * 16 * LDT + kk * 16, LDT);
  __syncthreads();
}

// Write a warp's 16 x 64 accumulator (through its f32 tile S) to row `orow`
// of out (f32) and out_b (bf16) at column col0; orow == (size_t)-1 skips.
__device__ __forceinline__ void store_rows(const FragC* acc, float* S, size_t orow, float* out,
                                           int ldo, bf16* out_b, int ldob, int col0, int r,
                                           int c0) {
#pragma unroll
  for (int db = 0; db < 4; ++db)
    wmma::store_matrix_sync(S + db * 16, acc[db], LDS_F, wmma::mem_row_major);
  __syncwarp();
  if (orow != (size_t)-1) {
    for (int c = 0; c < 32; ++c) {
      const float val = S[r * LDS_F + c0 + c];
      out[orow * ldo + col0 + c0 + c] = val;
      out_b[orow * ldob + col0 + c0 + c] = f2bf(val);
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(128) attn_bwd_dq_wmma_kernel(
    const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldkv, const bf16* __restrict__ du, int lddu, const float* __restrict__ ddn,
    const float* __restrict__ mrow, float* __restrict__ dq, int lddq, bf16* __restrict__ dq_b,
    int lddqb, int nq, int nkv) {
  __shared__ __align__(32) bf16 Ks[KT * LDT];
  __shared__ __align__(32) bf16 Vs[KT * LDT];
  __shared__ __align__(32) float Ss[4][16 * LDS_F];  // per-warp f32 tile; staging at start
  __shared__ __align__(32) bf16 Ps[4][16 * LDT];     // per-warp bf16 dS

  const int item = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* ki = k + (size_t)item * nkv * ldkv;
  const bf16* vi = v + (size_t)item * nkv * ldkv;
  const bool kv_vec = vec_ok(k, ldkv) && vec_ok(v, ldkv);

  bf16* stage = reinterpret_cast<bf16*>(&Ss[0][0]);  // 64 x LDT bf16 fits in Ss
  FragA fq[4], fdu[4];
  load_rows(fq, stage, q + (size_t)item * nq * ldq, ldq, q0, nq, vec_ok(q, ldq));
  load_rows(fdu, stage, du + (size_t)item * nq * lddu, lddu, q0, nq, vec_ok(du, lddu));

  float* S = Ss[warp];
  bf16* P = Ps[warp];
  const int r = lane >> 1;         // this lane's row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its 32 columns of each tile
  const int row = q0 + warp * 16 + r;
  const float mr = row < nq ? mrow[(size_t)item * nq + row] : 0.f;
  const float dr = row < nq ? ddn[(size_t)item * nq + row] : 0.f;

  FragC o[4];
#pragma unroll
  for (int db = 0; db < 4; ++db) wmma::fill_fragment(o[db], 0.0f);
  for (int j0 = 0; j0 < nkv; j0 += KT) {
    load_tile_bf16<KT, D>(Ks, LDT, ki, ldkv, j0, 0, nkv, D, kv_vec);
    load_tile_bf16<KT, D>(Vs, LDT, vi, ldkv, j0, 0, nkv, D, kv_vec);
    __syncthreads();
    rows_by_tile_t(fq, Ks, S);  // s = q k^T
    float e[32];
#pragma unroll
    for (int c = 0; c < 32; ++c)
      e[c] = (j0 + c0 + c < nkv) ? expf(S[r * LDS_F + c0 + c] - mr) : 0.f;
    __syncwarp();
    rows_by_tile_t(fdu, Vs, S);  // du v^T
#pragma unroll
    for (int c = 0; c < 32; ++c) P[r * LDT + c0 + c] = f2bf(e[c] * (S[r * LDS_F + c0 + c] + dr));
    __syncwarp();
    accumulate_p_tile(o, P, Ks);  // dq += dS k
    __syncthreads();
  }
  store_rows(o, S, row < nq ? (size_t)item * nq + row : (size_t)-1, dq, lddq, dq_b, lddqb, 0, r,
             c0);
}

__global__ void __launch_bounds__(128) attn_bwd_dkv_wmma_kernel(
    const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldkv, const bf16* __restrict__ du, int lddu, const float* __restrict__ ddn,
    const float* __restrict__ mrow, float* __restrict__ dkv, int lddkv,
    bf16* __restrict__ dkv_b, int lddkvb, int nq, int nkv) {
  __shared__ __align__(32) bf16 Qs[QB * LDT];
  __shared__ __align__(32) bf16 DUs[QB * LDT];
  __shared__ __align__(32) float Ss[4][16 * LDS_F];  // per-warp f32 tile; staging at start
  __shared__ __align__(32) bf16 Ps[4][16 * LDT];     // per-warp bf16 e, then dS
  __shared__ float ms[QB], dns[QB];

  const int item = blockIdx.y;
  const int k0 = blockIdx.x * KT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qi = q + (size_t)item * nq * ldq;
  const bf16* dui = du + (size_t)item * nq * lddu;
  const bool q_vec = vec_ok(q, ldq), du_vec = vec_ok(du, lddu);

  bf16* stage = reinterpret_cast<bf16*>(&Ss[0][0]);
  const bool kv_vec = vec_ok(k, ldkv) && vec_ok(v, ldkv);
  FragA fk[4], fv[4];
  load_rows(fk, stage, k + (size_t)item * nkv * ldkv, ldkv, k0, nkv, kv_vec);
  load_rows(fv, stage, v + (size_t)item * nkv * ldkv, ldkv, k0, nkv, kv_vec);

  float* S = Ss[warp];
  bf16* P = Ps[warp];
  const int r = lane >> 1;         // this lane's key row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its 32 query columns of each tile

  FragC dk[4], dv[4];
#pragma unroll
  for (int db = 0; db < 4; ++db) {
    wmma::fill_fragment(dk[db], 0.0f);
    wmma::fill_fragment(dv[db], 0.0f);
  }
  for (int i0 = 0; i0 < nq; i0 += QB) {
    load_tile_bf16<QB, D>(Qs, LDT, qi, ldq, i0, 0, nq, D, q_vec);
    load_tile_bf16<QB, D>(DUs, LDT, dui, lddu, i0, 0, nq, D, du_vec);
    if (tid < QB) {
      const bool ok = i0 + tid < nq;
      ms[tid] = ok ? mrow[(size_t)item * nq + i0 + tid] : 0.f;
      dns[tid] = ok ? ddn[(size_t)item * nq + i0 + tid] : 0.f;
    }
    __syncthreads();
    rows_by_tile_t(fk, Qs, S);  // s^T = k q^T
    float e[32];
#pragma unroll
    for (int c = 0; c < 32; ++c)
      e[c] = (i0 + c0 + c < nq) ? expf(S[r * LDS_F + c0 + c] - ms[c0 + c]) : 0.f;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) P[r * LDT + c0 + c] = f2bf(e[c]);
    __syncwarp();
    accumulate_p_tile(dv, P, DUs);  // dv += bf16(e)^T du
    rows_by_tile_t(fv, DUs, S);     // (du v^T)^T = v du^T
#pragma unroll
    for (int c = 0; c < 32; ++c)
      P[r * LDT + c0 + c] = f2bf(e[c] * (S[r * LDS_F + c0 + c] + dns[c0 + c]));
    __syncwarp();
    accumulate_p_tile(dk, P, Qs);  // dk += dS^T q
    __syncthreads();
  }
  const int key = k0 + warp * 16 + r;
  store_rows(dk, S, key < nkv ? (size_t)item * nkv + key : (size_t)-1, dkv, lddkv, dkv_b, lddkvb,
             0, r, c0);
  store_rows(dv, S, key < nkv ? (size_t)item * nkv + key : (size_t)-1, dkv, lddkv, dkv_b, lddkvb,
             D, r, c0);
}

}  // namespace

FC_API int fc_attention_bwd_wmma(const void* q, int ldq, const void* k, const void* v,
                                 int ldkv, const void* du, int lddu, const void* ddn,
                                 const void* mrow, void* dq, int lddq, void* dq_b, int lddqb,
                                 void* dkv, int lddkv, void* dkv_b, int lddkvb, int n_items,
                                 int nq, int nkv, void* stream) {
  dim3 gq((nq + QB - 1) / QB, n_items);
  attn_bwd_dq_wmma_kernel<<<gq, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, ldq, (const bf16*)k, (const bf16*)v, ldkv, (const bf16*)du, lddu,
      (const float*)ddn, (const float*)mrow, (float*)dq, lddq, (bf16*)dq_b, lddqb, nq, nkv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 gk((nkv + KT - 1) / KT, n_items);
  attn_bwd_dkv_wmma_kernel<<<gk, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, ldq, (const bf16*)k, (const bf16*)v, ldkv, (const bf16*)du, lddu,
      (const float*)ddn, (const float*)mrow, (float*)dkv, lddkv, (bf16*)dkv_b, lddkvb, nq, nkv);
  return (int)cudaGetLastError();
}

namespace {

// A block of the wgmma route: one consumer warpgroup of 64 rows (queries
// for dq, keys for dkv) and a producer warp; the block's own two tiles, then
// a ring of BWD_STAGES stages of the other side's two tiles. About 160
// registers a thread: two blocks to an SM.
constexpr int BWD_STAGES = 4;
constexpr int BWD_THREADS = 128 + 32;
constexpr int BWD_MIN_BLOCKS = 2;
constexpr int BWD_SMEM_BYTES = (2 + 2 * BWD_STAGES) * ATT_TILE_BYTES + 1024;
static_assert(BWD_MIN_BLOCKS * BWD_SMEM_BYTES <= 232448,
              "the rings exceed the SM's shared memory");

// Stores this thread's part of a 64 x 64 f32 accumulator as f32 pairs into
// `out` and bf16 pairs into `out_b` at rows row0 + [0, 64) (rows >= nrows
// skipped) and column col0 of row-major matrices.
__device__ __forceinline__ void store_tile(const float (&acc)[32], int t, int row0, int nrows,
                                           size_t row_base, float* out, int ldo, bf16* out_b,
                                           int ldob, int col0) {
  const int fc = frag_col(t);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + frag_row(t) + 8 * half;
    if (row >= nrows) continue;
    const size_t r = row_base + row;
    float* o = out + r * ldo + col0 + fc;
    bf16* ob = out_b + r * ldob + col0 + fc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = acc[4 * j + 2 * half], y = acc[4 * j + 2 * half + 1];
      *reinterpret_cast<float2*>(o + 8 * j) = make_float2(x, y);
      *reinterpret_cast<uint32_t*>(ob + 8 * j) = pack_bf16(x, y);
    }
  }
}

__device__ __forceinline__ void attn_bwd_dq_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                                  const CUtensorMap& tv, const CUtensorMap& tdu,
                                                  const float* __restrict__ ddn,
                                                  const float* __restrict__ mrow,
                                                  float* __restrict__ dq, int lddq,
                                                  bf16* __restrict__ dq_b, int lddqb, int nq,
                                                  int nkv, int q_block) {
  constexpr int STAGES = BWD_STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], own_full;
  uint8_t* const own = align1024(smem_raw);   // the Q tile, then the dU tile
  uint8_t* const ring = own + 2 * ATT_TILE_BYTES;   // stage s: K, then V
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
      mbar_expect_tx(&own_full, 2 * ATT_TILE_BYTES);
      tma_load_3d(own, &tq, &own_full, 0, q0, item);
      tma_load_3d(own + ATT_TILE_BYTES, &tdu, &own_full, 0, q0, item);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ring_parity(it, STAGES) ^ 1);
        uint8_t* ks = ring + 2 * s * ATT_TILE_BYTES;
        mbar_expect_tx(&full[s], 2 * ATT_TILE_BYTES);
        tma_load_3d(ks, &tk, &full[s], 0, it * ATT_TILE, item);
        tma_load_3d(ks + ATT_TILE_BYTES, &tv, &full[s], 0, it * ATT_TILE, item);
      }
    }
    return;
  }

  // the consumer warpgroup: query rows q0 + [0, 64)
  const int t = threadIdx.x;
  const int fc = frag_col(t);
  const uint8_t* qw = own;
  const uint8_t* duw = own + ATT_TILE_BYTES;
  float mr[2], dd[2];   // m and ddn of rows r0 and r0 + 8 (+inf and 0 past nq)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + frag_row(t) + 8 * half;
    const size_t r = (size_t)item * nq + row;
    mr[half] = row < nq ? mrow[r] : INFINITY;
    dd[half] = row < nq ? ddn[r] : 0.f;
  }
  float s[32], dp[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mbar_wait(&own_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const uint8_t* ks = ring + 2 * st * ATT_TILE_BYTES;
    mbar_wait(&full[st], ring_parity(it, STAGES));
    wgmma_fence();
    tile_abt(s, qw, ks);                    // S = Q K^T
    tile_abt(dp, duw, ks + ATT_TILE_BYTES);  // dP = dU V^T
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
    tile_pb(acc, p, ks);                    // dq += dS K (K read MN-major)
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    release_stage(&empty[st]);
  }
  store_tile(acc, t, q0, nq, (size_t)item * nq, dq, lddq, dq_b, lddqb, 0);
}

__device__ __forceinline__ void attn_bwd_dkv_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                                   const CUtensorMap& tv, const CUtensorMap& tdu,
                                                   const float* __restrict__ ddn,
                                                   const float* __restrict__ mrow,
                                                   float* __restrict__ dkv, int lddkv,
                                                   bf16* __restrict__ dkv_b, int lddkvb, int nq,
                                                   int nkv, int k_block) {
  constexpr int STAGES = BWD_STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], own_full;
  // each stage's queries: m (+inf past nq) and ddn (0 past nq)
  __shared__ __align__(16) float ml_s[STAGES][ATT_TILE], dd_s[STAGES][ATT_TILE];
  uint8_t* const own = align1024(smem_raw);   // the K tile, then the V tile
  uint8_t* const ring = own + 2 * ATT_TILE_BYTES;   // stage s: Q, then dU
  const int item = blockIdx.y, k0 = k_block * ATT_TILE;
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
      mbar_expect_tx(&own_full, 2 * ATT_TILE_BYTES);
      tma_load_3d(own, &tk, &own_full, 0, k0, item);
      tma_load_3d(own + ATT_TILE_BYTES, &tv, &own_full, 0, k0, item);
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
        uint8_t* qs = ring + 2 * s * ATT_TILE_BYTES;
        mbar_expect_tx(&full[s], 2 * ATT_TILE_BYTES);
        tma_load_3d(qs, &tq, &full[s], 0, i0, item);
        tma_load_3d(qs + ATT_TILE_BYTES, &tdu, &full[s], 0, i0, item);
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
  const uint8_t* vw = own + ATT_TILE_BYTES;
  float s[32], dp[32], dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&own_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const uint8_t* qs = ring + 2 * st * ATT_TILE_BYTES;
    const uint8_t* dus = qs + ATT_TILE_BYTES;
    mbar_wait(&full[st], ring_parity(it, STAGES));
    wgmma_fence();
    tile_abt(s, kw, qs);     // S^T = K Q^T
    tile_abt(dp, vw, dus);   // dP^T = V dU^T
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
    tile_pb(dv, pe, dus);   // dv += bf16(e^T) dU (dU read MN-major)
    tile_pb(dk, pd, qs);    // dk += dS^T Q (Q read MN-major)
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    release_stage(&empty[st]);
  }
  const size_t base = (size_t)item * nkv;
  store_tile(dk, t, k0, nkv, base, dkv, lddkv, dkv_b, lddkvb, 0);
  store_tile(dv, t, k0, nkv, base, dkv, lddkv, dkv_b, lddkvb, ATT_D);
}

// One launch for both kernels' blocks: blocks [0, dq_blocks) of each item
// take query tiles (dq), the rest key tiles ([dk | dv]), so the two grids
// share the card's waves.
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
    attn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdu,
                          const float* __restrict__ ddn, const float* __restrict__ mrow,
                          float* __restrict__ dq, int lddq, bf16* __restrict__ dq_b, int lddqb,
                          float* __restrict__ dkv, int lddkv, bf16* __restrict__ dkv_b,
                          int lddkvb, int nq, int nkv, int dq_blocks) {
  if ((int)blockIdx.x < dq_blocks)
    attn_bwd_dq_block(tq, tk, tv, tdu, ddn, mrow, dq, lddq, dq_b, lddqb, nq, nkv, blockIdx.x);
  else
    attn_bwd_dkv_block(tq, tk, tv, tdu, ddn, mrow, dkv, lddkv, dkv_b, lddkvb, nq, nkv,
                       blockIdx.x - dq_blocks);
}

bool pairs_ok(const void* p, int ld, int elt) {
  return (reinterpret_cast<uintptr_t>(p) % (2 * elt)) == 0 && ld % 2 == 0;
}

}  // namespace

// The wgmma route: q, k, v and du TMA-readable (16-byte bases, row strides
// a multiple of 8), the outputs written in pairs (bases aligned to a pair,
// even row strides). Misaligned operands return cudaErrorMisalignedAddress.
FC_API int fc_attention_bwd(const void* q, int ldq, const void* k, const void* v, int ldkv,
                            const void* du, int lddu, const void* ddn, const void* mrow, void* dq,
                            int lddq, void* dq_b, int lddqb, void* dkv, int lddkv, void* dkv_b,
                            int lddkvb, int n_items, int nq, int nkv, void* stream) {
  if (n_items < 1 || nq < 1 || nkv < 1) return (int)cudaErrorInvalidValue;
  if (!pairs_ok(dq, lddq, 4) || !pairs_ok(dq_b, lddqb, 2) || !pairs_ok(dkv, lddkv, 4) ||
      !pairs_ok(dkv_b, lddkvb, 2))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tdu;
  cudaError_t err = bf16_tensor_map_3d(&tq, q, n_items, nq, ATT_D, ldq, ATT_D, ATT_TILE);
  if (err == cudaSuccess)
    err = bf16_tensor_map_3d(&tk, k, n_items, nkv, ATT_D, ldkv, ATT_D, ATT_TILE);
  if (err == cudaSuccess)
    err = bf16_tensor_map_3d(&tv, v, n_items, nkv, ATT_D, ldkv, ATT_D, ATT_TILE);
  if (err == cudaSuccess)
    err = bf16_tensor_map_3d(&tdu, du, n_items, nq, ATT_D, lddu, ATT_D, ATT_TILE);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set = false;   // the shared-memory opt-in, once
  if (!smem_set) {
    err = cudaFuncSetAttribute(attn_bwd_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int dq_blocks = (nq + ATT_TILE - 1) / ATT_TILE;
  const dim3 grid(dq_blocks + (nkv + ATT_TILE - 1) / ATT_TILE, n_items);
  attn_bwd_wgmma_kernel<<<grid, BWD_THREADS, BWD_SMEM_BYTES, (cudaStream_t)stream>>>(
      tq, tk, tv, tdu, (const float*)ddn, (const float*)mrow, (float*)dq, lddq, (bf16*)dq_b,
      lddqb, (float*)dkv, lddkv, (bf16*)dkv_b, lddkvb, nq, nkv, dq_blocks);
  return (int)cudaGetLastError();
}
