// fps: batch farthest-point sampling, the port of the Pallas kernel
// fps_pallas (flowcompare_tpu/ops/fps_pallas.py:99, body :46-95) and of the
// reference's pointops furthestsampling.
//
// m greedy picks per item, the first being index 0: each pick updates every
// point's running minimum of its f32 squared distance to the picks so far,
// d = ((dx*dx + dy*dy) + dz*dz), written with the _rn intrinsics so that nvcc
// does not contract it into FMAs (the plain version and the JAX package
// round after every operation), and the next pick is the first index of the
// largest minimum (jnp.argmax / torch.argmax).
//
// Design: one block of 512 threads per item, as the reference's
// sampling_cuda_kernel.cu. The cloud and the running minima live in shared
// memory (16 bytes a point: 20 KB at N = 1250); thread t owns points
// t, t + 512, ... and scans them in index order, so a strict > keeps its
// first maximum. The block argmax carries (value, index) pairs through warp
// shuffles and one pass over the warps' winners; on equal values the smaller
// index wins, and threads without a point carry (-inf, INT_MAX), which no
// point can lose to.
//
// What bounds it on the H100: the m sequential picks, each a sweep over N
// points in shared memory and two block barriers; a single item runs on one
// SM, so the batch (50 clouds in eval) fills 50 of the 132 SMs.
#include <climits>

#include "common.cuh"

namespace {

constexpr int FPS_THREADS = 512;
constexpr int FPS_WARPS = FPS_THREADS / 32;

__device__ __forceinline__ void take_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    take_better(v, i, v2, i2);
  }
}

__global__ void __launch_bounds__(FPS_THREADS) fps_kernel(const float* __restrict__ xyz, int n,
                                                          int m, long long* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  float* mind = pz + n;
  __shared__ float win_v[FPS_WARPS];
  __shared__ int win_i[FPS_WARPS];
  __shared__ int pick;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* x = xyz + (size_t)blockIdx.x * n * 3;
  long long* o = out + (size_t)blockIdx.x * m;
  for (int j = tid; j < n; j += FPS_THREADS) {
    px[j] = x[3 * j];
    py[j] = x[3 * j + 1];
    pz[j] = x[3 * j + 2];
    mind[j] = INFINITY;
  }
  __syncthreads();

  int far = 0;
  for (int i = 0; i < m; ++i) {
    if (tid == 0) o[i] = far;
    if (i == m - 1) break;
    const float cx = px[far], cy = py[far], cz = pz[far];
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < n; j += FPS_THREADS) {
      const float dx = __fsub_rn(px[j], cx);
      const float dy = __fsub_rn(py[j], cy);
      const float dz = __fsub_rn(pz[j], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float md = fminf(mind[j], d);
      mind[j] = md;
      if (md > bv) {
        bv = md;
        bi = j;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      win_v[warp] = bv;
      win_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < FPS_WARPS ? win_v[lane] : -INFINITY;
      bi = lane < FPS_WARPS ? win_i[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) pick = bi;
    }
    __syncthreads();
    far = pick;
  }
}

}  // namespace

FC_API int fc_fps_smem(int n) { return (int)(sizeof(float) * 4 * (size_t)n); }

FC_API int fc_fps(const void* xyz, int n_items, int n, int m, void* out, void* stream) {
  if (n < 1 || m < 1 || n_items < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * 4 * (size_t)n;
  cudaError_t err =
      cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<n_items, FPS_THREADS, bytes, (cudaStream_t)stream>>>((const float*)xyz, n, m,
                                                                     (long long*)out);
  return (int)cudaGetLastError();
}
