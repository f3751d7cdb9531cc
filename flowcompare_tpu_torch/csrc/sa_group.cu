// sa_group: PAConv set-abstraction grouping, the port of the Pallas kernel
// sa_group_fused (flowcompare_tpu/ops/sa_group_pallas.py:126, body :54-122)
// and of the reference's knnquery_heap + grouping pair.
//
// For each item and each FPS centre c (a point of the item, index idx):
//   1. d_j = max(|c|^2 - 2 c.x_j + |x_j|^2, 0) in f32 over the item's n
//      points (the expansion of pairwise_sqdist, clamped as the Pallas
//      kernel's _knn_select_ranks clamps);
//   2. slot 0 is the centre itself, through idx and not through its
//      distance; slots 1..k-1 are the k - 1 nearest other points, exact, the
//      ties at the k-th distance taken in index order, written in ascending
//      index order (select_row_pinned of knn_select.cuh);
//   3. when k > n the slots past n hold point 0;
//   4. out[b, m, s] = [x_p - c (f32, then rounded to nearest even in the
//      output dtype) | feats_p], p the point of slot s.
// A centre index outside [0, n) gives a row of NaN (no out-of-range access).
//
// Design: a block of 8 warps owns 8 centres of one item, one warp each. The
// item's points (x, y, z, |x|^2) go to shared memory once per block, each
// warp writes its centre's distance row to shared memory, keeping each lane's
// two nearest others as the selection's pool, selects, then
// gathers: for each slot one warp-wide pass over the 3 + C output columns,
// neighbouring lanes on neighbouring columns of the feature row (a real row
// gather, not the TPU's one-hot product). Features and output are bf16 or
// f32 (templated); coordinates are always f32.
//
// What bounds it on the H100: the output bytes (B M k (3 + C) elements) and
// the selection's sweeps over each distance row in shared memory (knn_select.cuh:
// one sweep a row after a threshold from the lanes' two nearest, the radix
// select where ties crowd the threshold); the distances are 3-deep dot
// products, negligible.
#include "knn_select.cuh"

namespace {

constexpr int SG_CENTRES = 8;  // centres per block, one warp each
constexpr int SG_THREADS = SG_CENTRES * 32;

inline size_t sa_group_smem(int n) {
  return sizeof(float) * ((size_t)4 * n + (size_t)SG_CENTRES * n) +
         sizeof(unsigned) * SG_CENTRES * 2 * knn::CAP + sizeof(int) * SG_CENTRES * knn::MAX_K;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(SG_THREADS) sa_group_kernel(
    const float* __restrict__ new_xyz, const long long* __restrict__ idx,
    const float* __restrict__ xyz, const T* __restrict__ feats, int c, T* __restrict__ out,
    int n, int mc, int k) {
  extern __shared__ __align__(16) float smem[];
  float4* pts = reinterpret_cast<float4*>(smem);
  unsigned* dist = reinterpret_cast<unsigned*>(smem + 4 * (size_t)n);
  unsigned* scratch = dist + (size_t)SG_CENTRES * n;  // 16-byte aligned: n * 48 bytes before
  int* lists = reinterpret_cast<int*>(scratch + SG_CENTRES * 2 * knn::CAP);

  const int item = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xi = xyz + (size_t)item * n * 3;
  for (int j = threadIdx.x; j < n; j += SG_THREADS) {
    const float x = xi[3 * j], y = xi[3 * j + 1], z = xi[3 * j + 2];
    pts[j] = make_float4(x, y, z, fmaf(z, z, fmaf(y, y, x * x)));
  }
  __syncthreads();
  const int ci = blockIdx.x * SG_CENTRES + warp;
  if (ci >= mc) return;  // no block barrier below

  const size_t crow = (size_t)item * mc + ci;
  const float cx = new_xyz[3 * crow], cy = new_xyz[3 * crow + 1], cz = new_xyz[3 * crow + 2];
  const float cn = fmaf(cz, cz, fmaf(cy, cy, cx * cx));
  const long long self_ll = idx[crow];
  const int w = 3 + c;
  T* orow = out + crow * (size_t)k * w;
  if (self_ll < 0 || self_ll >= n) {  // not a point of the item: NaN rows, no access
    for (int e = lane; e < k * w; e += 32) orow[e] = from_f32<T>(__int_as_float(0x7fc00000));
    return;
  }
  const int self = (int)self_ll;
  unsigned* dr = dist + (size_t)warp * n;
  unsigned p0 = knn::FULL, p1 = knn::FULL;  // this lane's two nearest others: the pool
  for (int j = lane; j < n; j += 32) {
    const float4 p = pts[j];
    const float cross = fmaf(cz, p.z, fmaf(cy, p.y, cx * p.x));
    const float d = (cn - 2.f * cross) + p.w;
    const unsigned bits = __float_as_uint(d > 0.f ? d : 0.f);  // +0, never -0
    dr[j] = bits;
    if (j != self) knn::keep2(p0, p1, bits);
  }
  __syncwarp();
  int* list = lists + warp * knn::MAX_K;
  const int taken = knn::select_row_pinned(dr, n, k, self, p0, p1,
                                           scratch + warp * 2 * knn::CAP, list);

  const T* fi = feats + (size_t)item * n * c;
  for (int s = 0; s < k; ++s) {
    const int p = s == 0 ? self : (s <= taken ? list[s - 1] : 0);
    const float4 q = pts[p];
    T* o = orow + (size_t)s * w;
    for (int col = lane; col < w; col += 32) {
      T v;
      if (col < 3) {
        const float pv = col == 0 ? q.x : (col == 1 ? q.y : q.z);
        const float cv = col == 0 ? cx : (col == 1 ? cy : cz);
        v = from_f32<T>(__fsub_rn(pv, cv));
      } else {
        v = fi[(size_t)p * c + (col - 3)];
      }
      o[col] = v;
    }
  }
}

template <typename T>
int launch(const void* new_xyz, const void* idx, const void* xyz, const void* feats, int c,
           void* out, int n_items, int n, int mc, int k, cudaStream_t stream) {
  const size_t bytes = sa_group_smem(n);
  cudaError_t err = cudaFuncSetAttribute(sa_group_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((mc + SG_CENTRES - 1) / SG_CENTRES, n_items);
  sa_group_kernel<T><<<grid, SG_THREADS, bytes, stream>>>(
      (const float*)new_xyz, (const long long*)idx, (const float*)xyz, (const T*)feats, c,
      (T*)out, n, mc, k);
  return (int)cudaGetLastError();
}

}  // namespace

FC_API int fc_sa_group_smem(int n) { return (int)sa_group_smem(n); }

FC_API int fc_sa_group(const void* new_xyz, const void* idx, const void* xyz, const void* feats,
                       int c, void* out, int n_items, int n, int mc, int k, int bf16_feats,
                       void* stream) {
  if (n < 1 || mc < 1 || k < 1 || k > knn::MAX_K || c < 0) return (int)cudaErrorInvalidValue;
  if (bf16_feats)
    return launch<bf16>(new_xyz, idx, xyz, feats, c, out, n_items, n, mc, k,
                        (cudaStream_t)stream);
  return launch<float>(new_xyz, idx, xyz, feats, c, out, n_items, n, mc, k,
                       (cudaStream_t)stream);
}
