// What the port's two GEMM routes share: the epilogue's flags and
// arguments, its element-wise math, and the ordered sum of gemm_tn's
// split-K partials. gemm_wgmma.cu / gemm_tn_wgmma.cu (TMA + wgmma) and
// gemm_bf16.cu (WMMA) apply exactly this math, so the two routes differ
// only in the order of the f32 sums over K.
#pragma once

#include "common.cuh"

enum : int {
  EPI_BIAS = 1,
  EPI_RESIDUAL = 2,
  EPI_GELU = 4,
  EPI_AFFINE_LEAKY = 8,
  EPI_OUT_F32 = 16,
  EPI_RES_F32 = 32,     // the residual is f32
  EPI_ACCUM = 64,       // add the f32 output's current value
  EPI_PRE_OUT = 128,    // store the pre-GELU value (f32) into aux
  EPI_GELU_GRAD = 256,  // multiply by GELU'(aux)
  EPI_OUT2_BF16 = 512,  // also store bf16(v) into out2
  EPI_SPLIT = 1024,     // columns from `split` on go to out2 (bf16) instead of C
};

struct Epilogue {
  const float* bias;
  const void* res;
  int ldr;
  const float* aff_a;
  const float* aff_b;
  float* aux;
  int ldaux;
  bf16* out2;
  int ld2;
  int flags;
  int split;   // EPI_SPLIT: the first column stored into out2 (at column c - split)
};

// The epilogue of one output element (row r, column c) whose product is v,
// in this order: + bias, + residual (bf16 or f32), + the current f32 output
// (accumulate), the per-channel affine with leaky-0.2 (BatchNorm folded),
// [store the pre-activation into aux], erf-GELU, x GELU'(aux); then the
// store (bf16 or f32) and the optional bf16 copy into out2, or with
// EPI_SPLIT the bf16 store into out2 of the columns from `split` on.
__device__ __forceinline__ void epilogue_store(float v, int r, int c, const Epilogue& ep, void* C,
                                               int ldc) {
  const int flags = ep.flags;
  if (flags & EPI_BIAS) v += ep.bias[c];
  if (flags & EPI_RESIDUAL) {
    const size_t o = (size_t)r * ep.ldr + c;
    v = ((flags & EPI_RES_F32) ? reinterpret_cast<const float*>(ep.res)[o]
                               : bf2f(reinterpret_cast<const bf16*>(ep.res)[o])) + v;
  }
  if (flags & EPI_ACCUM) v += reinterpret_cast<const float*>(C)[(size_t)r * ldc + c];
  if (flags & EPI_AFFINE_LEAKY) v = leaky02(v * ep.aff_a[c] + ep.aff_b[c]);
  if (flags & EPI_PRE_OUT) ep.aux[(size_t)r * ep.ldaux + c] = v;
  if (flags & EPI_GELU) v = gelu_erf(v);
  if (flags & EPI_GELU_GRAD) v *= gelu_erf_grad(ep.aux[(size_t)r * ep.ldaux + c]);
  if ((flags & EPI_SPLIT) && c >= ep.split) {
    ep.out2[(size_t)r * ep.ld2 + c - ep.split] = f2bf(v);
    return;
  }
  if (flags & EPI_OUT_F32)
    reinterpret_cast<float*>(C)[(size_t)r * ldc + c] = v;
  else
    reinterpret_cast<bf16*>(C)[(size_t)r * ldc + c] = f2bf(v);
  if (flags & EPI_OUT2_BF16) ep.out2[(size_t)r * ep.ld2 + c] = f2bf(v);
}

namespace {

// C (ldc) = the sum over the splits of ws (M x N each, row-major), in split
// order, so gemm_tn's result does not depend on which split ends first.
__global__ void split_sum_kernel(const float* __restrict__ ws, int splits, float* __restrict__ C,
                                 int ldc, int M, int N) {
  const size_t total = (size_t)M * N, stride = total;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += ws[z * stride + e];
    C[(e / N) * ldc + e % N] = acc;
  }
}

inline cudaError_t launch_split_sum(const float* ws, int splits, float* C, int ldc, int M, int N,
                                    cudaStream_t stream) {
  int blocks = (int)(((size_t)M * N + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  split_sum_kernel<<<blocks, 256, 0, stream>>>(ws, splits, C, ldc, M, N);
  return cudaGetLastError();
}

}  // namespace
