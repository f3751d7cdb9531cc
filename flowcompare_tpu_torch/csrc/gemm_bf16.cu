// gemm_bf16: C = epilogue(A @ B), bf16 operands, float32 accumulation.
//
// Every matrix product inside the port's ports of the Pallas kernels
// fused_flow_layers_t, fused_augmenter and fused_dgcnn_encoder runs here:
// the MLP layers, the LayerNorm-folded q projection, ctx @ wkv, the
// coupling input, the ActNorm-folded LinearLU, the EdgeConv u/c products,
// conv5 and the encoder head.
//
// Design: a 64x64 output tile per block of 4 warps, each warp 32x32 as 2x2
// WMMA 16x16x16 bf16 fragments, K in steps of 32 through shared memory.
// Tiles are loaded with 16-byte loads where the rows are aligned and
// zero-filled at ragged edges, so M, N and K need no padding (K = 6, 150,
// 215 and N = 300 occur on the main path). The epilogue stages the f32 tile
// in shared memory and applies, in this order: + bias, + residual,
// the per-channel affine with leaky-0.2 (BatchNorm folded), erf-GELU; then
// stores bf16 or f32.
//
// What bounds it on the H100: the layer products are large (M = B*1024 rows,
// K and N 150..588), so tensor-core issue and the un-pipelined tile loads
// bound it; wgmma, TMA and a multi-stage ring are the later speed-ups.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

enum : int {
  EPI_BIAS = 1,
  EPI_RESIDUAL = 2,
  EPI_GELU = 4,
  EPI_AFFINE_LEAKY = 8,
  EPI_OUT_F32 = 16,
};

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA_S = BK + 8;  // 40 bf16: 80-byte rows keep 16-byte and WMMA alignment
constexpr int LDB_S = BN + 8;  // 72 bf16
constexpr int LDC_S = BN + 4;  // 68 f32

__global__ void __launch_bounds__(128) gemm_bf16_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb, void* C, int ldc,
    int M, int N, int K, const float* __restrict__ bias, const bf16* __restrict__ res, int ldr,
    const float* __restrict__ aff_a, const float* __restrict__ aff_b, int flags, bool a_vec,
    bool b_vec) {
  __shared__ __align__(32) bf16 As[BM * LDA_S];
  __shared__ __align__(32) bf16 Bs[BK * LDB_S];
  __shared__ __align__(32) float Cs[BM * LDC_S];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile_bf16<BM, BK>(As, LDA_S, A, lda, m0, k0, M, K, a_vec);
    load_tile_bf16<BK, BN>(Bs, LDB_S, B, ldb, k0, n0, K, N, b_vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * LDB_S + wn + 16 * j, LDB_S);
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

  for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
    const int r = e / BN, c = e % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    float v = Cs[r * LDC_S + c];
    if (flags & EPI_BIAS) v += bias[gc];
    if (flags & EPI_RESIDUAL) v = bf2f(res[(size_t)gr * ldr + gc]) + v;
    if (flags & EPI_AFFINE_LEAKY) v = leaky02(v * aff_a[gc] + aff_b[gc]);
    if (flags & EPI_GELU) v = gelu_erf(v);
    if (flags & EPI_OUT_F32)
      reinterpret_cast<float*>(C)[(size_t)gr * ldc + gc] = v;
    else
      reinterpret_cast<bf16*>(C)[(size_t)gr * ldc + gc] = f2bf(v);
  }
}

}  // namespace

FC_API int fc_gemm_bf16(const void* A, int lda, const void* B, int ldb, void* C, int ldc, int M,
                        int N, int K, const void* bias, const void* res, int ldr, const void* aff_a,
                        const void* aff_b, int flags, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)A, lda, (const bf16*)B, ldb, C, ldc, M, N, K, (const float*)bias,
      (const bf16*)res, ldr, (const float*)aff_a, (const float*)aff_b, flags, aligned16(A, lda),
      aligned16(B, ldb));
  return (int)cudaGetLastError();
}

FC_API const char* fc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
