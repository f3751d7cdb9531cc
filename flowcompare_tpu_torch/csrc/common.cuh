// Shared helpers of the port's Hopper kernels (built for sm_90a).
//
// Every entry point has a plain C interface: device pointers and the CUDA
// stream arrive as void*, sizes as int, and the function returns
// cudaGetLastError() right after its launch so the Python wrapper can raise
// on a launch the CUDA runtime refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FC_API extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// Exact erf GELU, torch.nn.GELU's default form.
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ float leaky02(float x) { return x >= 0.f ? x : 0.2f * x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copy a ROWS x COLS bf16 tile (COLS a multiple of 8) from a row-major
// matrix with leading dimension `ld` into shared memory with leading
// dimension `lds`, zero-filling outside [nrows) x [ncols). Uses 16-byte
// loads where the source row is aligned for them.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile_bf16(bf16* smem, int lds, const bf16* g, int ld,
                                               int row0, int col0, int nrows, int ncols,
                                               bool vec_ok) {
  constexpr int VPR = COLS / 8;
  for (int v = threadIdx.x; v < ROWS * VPR; v += blockDim.x) {
    const int r = v / VPR, c = (v % VPR) * 8;
    const int gr = row0 + r, gc = col0 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows && gc < ncols) {
      const bf16* p = g + (size_t)gr * ld + gc;
      if (vec_ok && gc + 8 <= ncols) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        unsigned short tmp[8];
        const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
        for (int e = 0; e < 8; ++e) tmp[e] = (gc + e < ncols) ? ps[e] : (unsigned short)0;
        val.x = tmp[0] | ((unsigned)tmp[1] << 16);
        val.y = tmp[2] | ((unsigned)tmp[3] << 16);
        val.z = tmp[4] | ((unsigned)tmp[5] << 16);
        val.w = tmp[6] | ((unsigned)tmp[7] << 16);
      }
    }
    *reinterpret_cast<uint4*>(smem + r * lds + c) = val;
  }
}

__host__ __forceinline__ bool aligned16(const void* p, int ld) {
  return ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) && (ld % 8 == 0);
}
