// gemm_bf16 on the TMA + wgmma route: C = epilogue(A @ B), or A @ B^T
// with trans_b, bf16 operands, float32 sums; the mainloop and what bounds
// it are in gemm_wgmma.cuh.
//
// The epilogue keeps gemm_bf16's contract (gemm_common.cuh): + bias,
// + residual (bf16 or f32), + the current f32 output (accumulate), the
// leaky-0.2 affine, store of the pre-GELU value, erf-GELU, x GELU'(aux),
// then the bf16 or f32 store and the optional bf16 copy, or the split
// store (C's columns below `split`, out2's from it); applied from the
// f32 sums staged in shared memory, 8 neighbouring columns per thread with
// 16- and 32-byte accesses where every matrix it touches allows them
// (`vec`), one column at a time otherwise.
//
// Output tiles: BM = 128 (two consumer warpgroups) or 64 for small M, BN =
// 64 or 128, chosen per shape by `_build.gemm_tile`.
#include "gemm_wgmma.cuh"

namespace {

__device__ __forceinline__ void ld8(const float* __restrict__ p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z,
  v[7] = hi.w;
}

__device__ __forceinline__ void st8(float* __restrict__ p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void ld8(const bf16* __restrict__ p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void st8(bf16* __restrict__ p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// gemm_common.cuh's epilogue for the 8 sums s[0..8) of row r from column c:
// 16- and 32-byte loads and stores when `vec` (every matrix it touches has
// 16-byte rows, see rows16) and all 8 columns lie inside N; element by
// element otherwise.
__device__ __forceinline__ void epilogue_chunk(const float* s, int r, int c, int N, bool vec,
                                               const Epilogue& ep, void* C, int ldc) {
  const int flags = ep.flags;
  if (!vec || c + 8 > N || ((flags & EPI_SPLIT) && c < ep.split && c + 8 > ep.split)) {
    for (int i = 0; i < 8 && c + i < N; ++i) epilogue_store(s[i], r, c + i, ep, C, ldc);
    return;
  }
  float v[8], u[8], w[8];
  ld8(s, v);
  if (flags & EPI_BIAS) {
    ld8(ep.bias + c, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += u[i];
  }
  if (flags & EPI_RESIDUAL) {
    const size_t o = (size_t)r * ep.ldr + c;
    if (flags & EPI_RES_F32)
      ld8(reinterpret_cast<const float*>(ep.res) + o, u);
    else
      ld8(reinterpret_cast<const bf16*>(ep.res) + o, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = u[i] + v[i];
  }
  const size_t oc = (size_t)r * ldc + c;
  if (flags & EPI_ACCUM) {
    ld8(reinterpret_cast<const float*>(C) + oc, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += u[i];
  }
  if (flags & EPI_AFFINE_LEAKY) {
    ld8(ep.aff_a + c, u);
    ld8(ep.aff_b + c, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = leaky02(v[i] * u[i] + w[i]);
  }
  float* aux = ep.aux + (size_t)r * ep.ldaux + c;
  if (flags & EPI_PRE_OUT) st8(aux, v);
  if (flags & EPI_GELU) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = gelu_erf(v[i]);
  }
  if (flags & EPI_GELU_GRAD) {
    ld8(aux, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= gelu_erf_grad(u[i]);
  }
  if ((flags & EPI_SPLIT) && c >= ep.split)
    st8(ep.out2 + (size_t)r * ep.ld2 + c - ep.split, v);
  else if (flags & EPI_OUT_F32)
    st8(reinterpret_cast<float*>(C) + oc, v);
  else
    st8(reinterpret_cast<bf16*>(C) + oc, v);
  if (flags & EPI_OUT2_BF16) st8(ep.out2 + (size_t)r * ep.ld2 + c, v);
}

// 3 stages, two blocks per SM (gemm_wgmma.cuh).
template <int BM, int BN>
using BlockTile = Tile<BM, BN, 3, 2>;

// B_K: B is stored (N, K) and the product is A @ B^T (trans_b).
template <int BM, int BN, bool B_K>
__global__ void __launch_bounds__(BlockTile<BM, BN>::THREADS, BlockTile<BM, BN>::MIN_BLOCKS)
    gemm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb, void* C, int ldc, int M, int N,
                           int K, Epilogue ep, int vec) {
  const auto epi = [=](const float* s, int r, int c) {
    epilogue_chunk(s, r, c, N, vec, ep, C, ldc);
  };
  gemm_block<BlockTile<BM, BN>, false, B_K>(&ta, &tb, M, N, blockIdx.y * BM, blockIdx.x * BN, 0,
                                            (K + BK - 1) / BK, epi);
}

template <int BM, int BN, bool B_K>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, void* C, int ldc, int M, int N,
                   int K, const Epilogue& ep, int vec, cudaStream_t stream) {
  using T = BlockTile<BM, BN>;
  static bool smem_set = false;   // the shared-memory opt-in, once per instantiation
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(gemm_bf16_wgmma_kernel<BM, BN, B_K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_wgmma_kernel<BM, BN, B_K>
      <<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(ta, tb, C, ldc, M, N, K, ep, vec);
  return cudaGetLastError();
}

template <int BM, bool B_K>
cudaError_t launch_bn(int bn, const CUtensorMap& ta, const CUtensorMap& tb, void* C, int ldc,
                      int M, int N, int K, const Epilogue& ep, int vec, cudaStream_t stream) {
  switch (bn) {
    case 64: return launch<BM, 64, B_K>(ta, tb, C, ldc, M, N, K, ep, vec, stream);
    case 128: return launch<BM, 128, B_K>(ta, tb, C, ldc, M, N, K, ep, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C (M x N, ldc) = epilogue(A (M x K) @ B), B (K x N) or with trans_b B^T
// for B (N x K); output tile bm x bn (bm 64 or 128, bn 64 or 128). With
// EPI_SPLIT, C holds columns [0, split) and out2 (bf16) the rest.
// Both operands must be TMA-readable (16-byte base, row stride a multiple
// of 8 bf16), else it returns cudaErrorMisalignedAddress.
FC_API int fc_gemm_bf16(const void* A, int lda, const void* B, int ldb, void* C, int ldc, int M,
                        int N, int K, const void* bias, const void* res, int ldr, const void* aff_a,
                        const void* aff_b, void* aux, int ldaux, void* out2, int ld2, int split,
                        int flags, int trans_b, int bm, int bn, void* stream) {
  CUtensorMap ta, tb;
  cudaError_t err = bf16_tensor_map(&ta, A, M, K, lda, BK, bm);
  if (err == cudaSuccess)
    err = trans_b ? bf16_tensor_map(&tb, B, N, K, ldb, BK, bn)
                  : bf16_tensor_map(&tb, B, K, N, ldb, 64, BK);
  if (err != cudaSuccess) return (int)err;
  const Epilogue ep{(const float*)bias, res,          ldr,        (const float*)aff_a,
                    (const float*)aff_b, (float*)aux, ldaux,      (bf16*)out2,
                    ld2,                 flags,       split};
  const int vec = rows16(C, ldc, (flags & EPI_OUT_F32) ? 4 : 2) &&
                  (!(flags & EPI_SPLIT) || split % 8 == 0) &&
                  rows16(res, ldr, (flags & EPI_RES_F32) ? 4 : 2) && rows16(aux, ldaux, 4) &&
                  rows16(out2, ld2, 2) && rows16(bias, 0, 4) && rows16(aff_a, 0, 4) &&
                  rows16(aff_b, 0, 4);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 128)
    return (int)(trans_b ? launch_bn<128, true>(bn, ta, tb, C, ldc, M, N, K, ep, vec, s)
                         : launch_bn<128, false>(bn, ta, tb, C, ldc, M, N, K, ep, vec, s));
  if (bm == 64)
    return (int)(trans_b ? launch_bn<64, true>(bn, ta, tb, C, ldc, M, N, K, ep, vec, s)
                         : launch_bn<64, false>(bn, ta, tb, C, ldc, M, N, K, ep, vec, s));
  return (int)cudaErrorInvalidValue;
}
