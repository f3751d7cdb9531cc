// The WMMA route of the port's GEMM: C = epilogue(A @ op(B)) and
// C = A^T @ B, bf16 operands, float32 accumulation.
//
// The port's products go to the TMA + wgmma kernels of gemm_wgmma.cu and
// gemm_tn_wgmma.cu when both operands can be read by TMA (a 16-byte-aligned
// base and a row stride that is a multiple of 16 bytes); `_build.gemm` and
// `_build.gemm_tn` choose from that alone, and count each route. These
// kernels take what TMA cannot: a matrix with a row of 6 bf16 (B4's first
// EdgeConv stage reads the 6-wide cloud, ops/dgcnn_cuda.py) or any other
// unaligned view. The B1, B2, B5 and B7 chains pad their buffers and weight
// copies so that none of their products comes here.
//
// Design: a 64x64 output tile per block of 4 warps, each warp 32x32 as 2x2
// WMMA 16x16x16 bf16 fragments, K in steps of 32 through shared memory. A
// transposed operand is staged as it lies in memory and read through a
// column-major fragment, so no transposed copy is made. Tiles are loaded
// with 16-byte loads where the rows are aligned and zero-filled at ragged
// edges, so M, N and K need no padding. The epilogue stages the f32 tile in
// shared memory and applies gemm_common.cuh's element-wise epilogue.
//
// A^T @ B (weight gradients, K = B*N rows, few output tiles) splits K over
// blocks: each split writes its f32 partial tile to a workspace and a second
// pass sums the splits in order, so the result is deterministic.
//
// What bounds it on the H100: at the main path's shapes, tensor-core issue
// through mma.sync and the un-pipelined tile loads (one buffer, loaded
// through registers); it ran the 512-wide products at 6-7% of the bf16 peak.
#include <mma.h>

#include <type_traits>

#include "gemm_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA_S = BK + 8;   // 40 bf16: A tile [m][k]; 80-byte rows keep 16-byte and WMMA alignment
constexpr int LDAT_S = BM + 8;  // 72 bf16: A^T tile [k][m]
constexpr int LDB_S = BN + 8;   // 72 bf16: B tile [k][n]
constexpr int LDBT_S = BK + 8;  // 40 bf16: B^T tile [n][k]
constexpr int LDC_S = BN + 4;   // 68 f32
constexpr int A_SMEM = (BM * LDA_S > BK * LDAT_S) ? BM * LDA_S : BK * LDAT_S;
constexpr int B_SMEM = (BK * LDB_S > BN * LDBT_S) ? BK * LDB_S : BN * LDBT_S;

// C tile = A[m0:, k_begin:k_end] @ B[k_begin:k_end, n0:] with A given as A^T
// (K x M) when TA and B given as B^T (N x K) when TB. Leaves the f32 tile in Cs.
template <bool TA, bool TB>
__device__ __forceinline__ void mainloop(const bf16* __restrict__ A, int lda,
                                         const bf16* __restrict__ B, int ldb, int M, int N,
                                         int k_begin, int k_end, bool a_vec, bool b_vec,
                                         bf16* As, bf16* Bs, float* Cs) {
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  using LayA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LayB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // the tile loader's bound on k is k_end, so a split never reads its neighbour's rows
    if constexpr (TA)
      load_tile_bf16<BK, BM>(As, LDAT_S, A, lda, k0, m0, k_end, M, a_vec);
    else
      load_tile_bf16<BM, BK>(As, LDA_S, A, lda, m0, k0, M, k_end, a_vec);
    if constexpr (TB)
      load_tile_bf16<BN, BK>(Bs, LDBT_S, B, ldb, n0, k0, N, k_end, b_vec);
    else
      load_tile_bf16<BK, BN>(Bs, LDB_S, B, ldb, k0, n0, k_end, N, b_vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (TA)
          wmma::load_matrix_sync(fa[i], As + kk * LDAT_S + wm + 16 * i, LDAT_S);
        else
          wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA_S + kk, LDA_S);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (TB)
          wmma::load_matrix_sync(fb[j], Bs + (wn + 16 * j) * LDBT_S + kk, LDBT_S);
        else
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB_S + wn + 16 * j, LDB_S);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC_S + wn + 16 * j, acc[i][j], LDC_S,
                              wmma::mem_row_major);
  __syncthreads();
}

template <bool TB>
__global__ void __launch_bounds__(128) gemm_bf16_wmma_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb, void* C, int ldc,
    int M, int N, int K, Epilogue ep, bool a_vec, bool b_vec) {
  __shared__ __align__(32) bf16 As[A_SMEM];
  __shared__ __align__(32) bf16 Bs[B_SMEM];
  __shared__ __align__(32) float Cs[BM * LDC_S];
  mainloop<false, TB>(A, lda, B, ldb, M, N, 0, K, a_vec, b_vec, As, Bs, Cs);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
    const int r = e / BN, c = e % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) epilogue_store(Cs[r * LDC_S + c], gr, gc, ep, C, ldc);
  }
}

// One split of C = A^T @ B: rows [z * k_chunk, (z + 1) * k_chunk) of both,
// written as f32 into out (ldo) + z * split_stride.
__global__ void __launch_bounds__(128) gemm_tn_wmma_kernel(const bf16* __restrict__ A, int lda,
                                                           const bf16* __restrict__ B, int ldb,
                                                           float* out, int ldo, size_t split_stride,
                                                           int M, int N, int K, int k_chunk,
                                                           bool a_vec, bool b_vec) {
  __shared__ __align__(32) bf16 As[A_SMEM];
  __shared__ __align__(32) bf16 Bs[B_SMEM];
  __shared__ __align__(32) float Cs[BM * LDC_S];
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  mainloop<true, false>(A, lda, B, ldb, M, N, k_begin, k_end, a_vec, b_vec, As, Bs, Cs);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float* o = out + blockIdx.z * split_stride;
  for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
    const int r = e / BN, c = e % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) o[(size_t)gr * ldo + gc] = Cs[r * LDC_S + c];
  }
}

}  // namespace

FC_API int fc_gemm_bf16_wmma(const void* A, int lda, const void* B, int ldb, void* C, int ldc,
                             int M, int N, int K, const void* bias, const void* res, int ldr,
                             const void* aff_a, const void* aff_b, void* aux, int ldaux,
                             void* out2, int ld2, int split, int flags, int trans_b,
                             void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const Epilogue ep{(const float*)bias, res,          ldr,        (const float*)aff_a,
                    (const float*)aff_b, (float*)aux, ldaux,      (bf16*)out2,
                    ld2,                 flags,       split};
  if (trans_b)
    gemm_bf16_wmma_kernel<true><<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const bf16*)A, lda, (const bf16*)B, ldb, C, ldc, M, N, K, ep, aligned16(A, lda),
        aligned16(B, ldb));
  else
    gemm_bf16_wmma_kernel<false><<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const bf16*)A, lda, (const bf16*)B, ldb, C, ldc, M, N, K, ep, aligned16(A, lda),
        aligned16(B, ldb));
  return (int)cudaGetLastError();
}

// C (M x N, f32) = A^T @ B with A (K x M) and B (K x N) bf16. With splits > 1,
// ws holds splits * M * N floats.
FC_API int fc_gemm_tn_wmma(const void* A, int lda, const void* B, int ldb, void* C, int ldc,
                           int M, int N, int K, int splits, void* ws, void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const int k_chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const bool av = aligned16(A, lda), bv = aligned16(B, ldb);
  if (splits == 1) {
    gemm_tn_wmma_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const bf16*)A, lda, (const bf16*)B, ldb, (float*)C, ldc, 0, M, N, K, k_chunk, av, bv);
    return (int)cudaGetLastError();
  }
  gemm_tn_wmma_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)A, lda, (const bf16*)B, ldb, (float*)ws, N, (size_t)M * N, M, N, K, k_chunk,
      av, bv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_split_sum((const float*)ws, splits, (float*)C, ldc, M, N,
                               (cudaStream_t)stream);
}

FC_API const char* fc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
