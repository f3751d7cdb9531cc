// gemm_tn on the TMA + wgmma route: C (M x N, f32) = A^T @ B for A (K x M)
// and B (K x N) bf16, the weight gradients of B5 (K = B*N rows, 20,480 and
// 25,600 at the presets' training batches; M, N <= 592), so few output
// tiles and a deep K.
//
// Both operands are read MN-major (A as stored, M contiguous; B, N
// contiguous), so no transposed copy is made (gemm_wgmma.cuh). K is split
// over blocks: each split of k_chunk rows (a multiple of 64, so a split's
// TMA boxes never reach its neighbour's rows) writes its f32 partial tile to
// the workspace, and a second pass sums the splits in split order, so the
// result is deterministic. `_build.gemm_tn_plan` picks the split count for
// about one wave of 128 x BN blocks on the 132 SMs, each split at least 512
// rows deep.
//
// What bounds it: the bytes of A and B read once (42 MB for the 512 x 512
// gradient over 20,480 rows, 12.5 us) against 10.7 GFLOP (10.9 us), plus
// the partials (splits x M x N f32 written and read once).
#include "gemm_wgmma.cuh"

namespace {

// 4 stages for the deep K, one block per SM (gemm_wgmma.cuh).
template <int BN>
using TnTile = Tile<128, BN, 4, 1>;

// One split of C = A^T @ B: rows [z * k_chunk, (z + 1) * k_chunk) of both,
// written as f32 into out (ldo) + z * split_stride.
template <int BN>
__global__ void __launch_bounds__(TnTile<BN>::THREADS, TnTile<BN>::MIN_BLOCKS)
    gemm_tn_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb, float* out, int ldo,
                         size_t split_stride, int M, int N, int K, int k_chunk, int vec) {
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  float* o = out + blockIdx.z * split_stride;
  const auto store = [=](const float* s, int r, int c) {
    float* p = o + (size_t)r * ldo + c;
    if (vec && c + 8 <= N) {
      *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(s);
      *reinterpret_cast<float4*>(p + 4) = *reinterpret_cast<const float4*>(s + 4);
    } else {
      for (int i = 0; i < 8 && c + i < N; ++i) p[i] = s[i];
    }
  };
  gemm_block<TnTile<BN>, true, false>(&ta, &tb, M, N, blockIdx.y * 128, blockIdx.x * BN, k_begin,
                                      (k_end - k_begin + BK - 1) / BK,
                                      store);
}

template <int BN>
cudaError_t launch_tn(const CUtensorMap& ta, const CUtensorMap& tb, float* out, int ldo,
                      size_t split_stride, int M, int N, int K, int splits, int k_chunk, int vec,
                      cudaStream_t stream) {
  using T = TnTile<BN>;
  static bool smem_set = false;   // the shared-memory opt-in, once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tn_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + 127) / 128, splits);
  gemm_tn_wgmma_kernel<BN><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      ta, tb, out, ldo, split_stride, M, N, K, k_chunk, vec);
  return cudaGetLastError();
}

}  // namespace

// C (M x N, ldc, f32) = A^T @ B with A (K x M) and B (K x N) bf16, output
// tiles of 128 x bn (bn 64 or 128), K in `splits` chunks of k_chunk rows
// (a multiple of 64). With splits > 1, ws holds splits * M * N floats.
FC_API int fc_gemm_tn(const void* A, int lda, const void* B, int ldb, void* C, int ldc, int M,
                      int N, int K, int bn, int splits, int k_chunk, void* ws, void* stream) {
  if (splits < 1 || k_chunk < BK || k_chunk % BK != 0 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err = bf16_tensor_map(&ta, A, K, M, lda, 64, BK);
  if (err == cudaSuccess) err = bf16_tensor_map(&tb, B, K, N, ldb, 64, BK);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  float* out = splits == 1 ? (float*)C : (float*)ws;
  const int ldo = splits == 1 ? ldc : N;
  const size_t split_stride = splits == 1 ? 0 : (size_t)M * N;
  const int vec = rows16(out, ldo, 4);
  if (bn == 64)
    err = launch_tn<64>(ta, tb, out, ldo, split_stride, M, N, K, splits, k_chunk, vec, s);
  else if (bn == 128)
    err = launch_tn<128>(ta, tb, out, ldo, split_stride, M, N, K, splits, k_chunk, vec, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_split_sum((const float*)ws, splits, (float*)C, ldc, M, N, s);
}
