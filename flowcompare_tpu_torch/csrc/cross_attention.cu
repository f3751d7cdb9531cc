// cross_attention: one-head softmax(q k^T) v with head dimension 64, the
// attention step of the Pallas kernels fused_flow_layers_t (_attention_cond_t)
// and fused_augmenter (_attention_cond). The 1/sqrt(d) temperature is
// already folded into q (fold_stacks).
//
//   q (items*nq, 64) bf16, k and v (items*nkv, 64) bf16 -> out (items*nq, 64) bf16
//
// It ports folded_scan_core's max-subtracted softmax, not the TPU kernel's
// clamp-at-80 with an epsilon on the denominator: each row's maximum is
// subtracted in f32, e = exp(s - max) is rounded to bf16 for the PV product,
// and the f32 sum of the unrounded e divides after PV. A first pass over the
// keys finds the exact row maximum; the second recomputes q k^T, forms e,
// sums it and accumulates P V. Two passes cost one more q k^T than an online
// softmax but keep every rounding where the plain version has it.
//
// Design: a block of 4 warps takes 64 query rows of one item (16 per warp);
// key/value tiles of 64 rows go through shared memory; both products are
// WMMA 16x16x16 bf16 with f32 accumulators. Bound on the H100 by the exp
// and the per-tile shared-memory round trips of the scores (nkv = 1250 keys
// per row); a later version keeps scores in registers (wgmma) and pipelines
// the tile loads.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 64;     // head dimension
constexpr int QB = 64;    // query rows per block
constexpr int KT = 64;    // keys per tile
constexpr int LDT = D + 8;    // 72 bf16 per smem row
constexpr int LDS_F = KT + 4; // 68 f32 per score row

__global__ void __launch_bounds__(128) cross_attention_kernel(
    const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldkv, bf16* __restrict__ out, int ldo, int nq, int nkv) {
  __shared__ __align__(32) bf16 Qs[QB * LDT];
  __shared__ __align__(32) bf16 Ks[KT * LDT];
  __shared__ __align__(32) bf16 Vs[KT * LDT];
  __shared__ __align__(32) float Ss[4][16 * LDS_F];  // per-warp scores; reused as bf16 P

  const int item = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qi = q + (size_t)item * nq * ldq;
  const bf16* ki = k + (size_t)item * nkv * ldkv;
  const bf16* vi = v + (size_t)item * nkv * ldkv;
  const bool q_vec = ((reinterpret_cast<uintptr_t>(q) & 15u) == 0) && (ldq % 8 == 0);
  const bool kv_vec = ((reinterpret_cast<uintptr_t>(k) & 15u) == 0) &&
                      ((reinterpret_cast<uintptr_t>(v) & 15u) == 0) && (ldkv % 8 == 0);

  load_tile_bf16<QB, D>(Qs, LDT, qi, ldq, q0, 0, nq, D, q_vec);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], Qs + warp * 16 * LDT + kk * 16, LDT);

  float* S = Ss[warp];
  bf16* P = reinterpret_cast<bf16*>(S);  // 16 x LDT bf16 fits in 16 x LDS_F f32
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
    load_tile_bf16<KT, D>(Ks, LDT, ki, ldkv, j0, 0, nkv, D, kv_vec);
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
    load_tile_bf16<KT, D>(Ks, LDT, ki, ldkv, j0, 0, nkv, D, kv_vec);
    load_tile_bf16<KT, D>(Vs, LDT, vi, ldkv, j0, 0, nkv, D, kv_vec);
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
      P[r * LDT + c0 + c] = f2bf(e[c]);
    }
    __syncwarp();
#pragma unroll
    for (int kb = 0; kb < KT / 16; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, P + kb * 16, LDT);
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
  if (row < nq) {
    bf16* orow = out + ((size_t)item * nq + row) * ldo;
    for (int c = 0; c < 32; ++c) orow[c0 + c] = f2bf(S[r * LDS_F + c0 + c] / sum);
  }
}

}  // namespace

FC_API int fc_cross_attention(const void* q, int ldq, const void* k, const void* v, int ldkv,
                              void* out, int ldo, int n_items, int nq, int nkv, void* stream) {
  dim3 grid((nq + QB - 1) / QB, n_items);
  cross_attention_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, ldq, (const bf16*)k, (const bf16*)v, ldkv, (bf16*)out, ldo, nq, nkv);
  return (int)cudaGetLastError();
}
