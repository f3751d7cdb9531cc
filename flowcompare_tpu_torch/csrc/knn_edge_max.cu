// knn_edge_max: the exact-kNN neighbourhood max of EdgeConv, the port of the
// Pallas kernel edge_neighbor_max (edgeconv_pallas.py: selection
// _knn_select_ranks, extraction _knn_extract_max) and the core of
// fused_dgcnn_encoder.
//
// The selection is knn_select.cuh's (shared with knn_edge_reduce, the
// training twin): distances on the tensor cores, a radix select. Then
// mx_i = max over the selected j of u'_j. With the optional epilogue the
// kernel writes the EdgeConv stage output y = leaky((sign * mx + c) * a + b)
// directly (BatchNorm folded into a, b; fold_dgcnn).
//
// Design: a block of 8 warps owns 16 query rows of one item and keeps their
// distance rows in shared memory; each warp selects for two rows and gathers
// the k selected u' rows from L2, 16 bytes a lane: L lanes cover a row in
// chunks of 8 channels and 32 / L neighbours go at once (cout = 64: four),
// their maxima merged by shuffles. No one-hot matmul and no pad rows: the GPU
// gathers, and bounds are checked.
//
// Any 1 <= k <= min(n, 256): past k = 64 every row takes the radix select.
//
// Clouds whose 16 distance rows do not fit shared memory (past 3,200 points
// at 128 features) take knn_edge_max_chunked_kernel: the same selection
// walking the row in chunks (knn::select_chunked, one pass with a falling
// threshold), the same gather.
//
// What bounds it on the H100: the u' gathers from L2 (k rows of cout bf16 a
// query row, about 2 GB over the four widths of a B=20 eval item) and the
// candidates' B fragments (re-read from L2 by each 16-row block); the
// distance products are a few microseconds of tensor-core time an item and
// the selection 2-5 sweeps a row over shared memory (the radix select's past
// k = 64). Both grow as n^2 with the cloud: at 4,096 points the candidates'
// reads (n / 16 blocks, each reading the item's n rows) lead.
#include "knn_select.cuh"

namespace {

constexpr int MAX_COUT = 256;

__device__ __forceinline__ void load8(const bf16* p, int valid, bool vec, float v[8]) {
  if (vec && valid == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = knn::lo_f(w[e]);
      v[2 * e + 1] = knn::hi_f(w[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < valid ? bf2f(p[e]) : 0.f;
  }
}

__device__ __forceinline__ void load8f(const float* p, int valid, bool vec, float v[8]) {
  if (vec && valid == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < valid ? p[e] : 0.f;
  }
}

// The maximum of u over row gr's k selected neighbours (list), or the stage
// output with the epilogue (cin != nullptr), into out. One warp.
__device__ __forceinline__ void max_row(const bf16* __restrict__ u, int ldu, int cout,
                                        bf16* __restrict__ out, int ldo,
                                        const float* __restrict__ cin, int ldc,
                                        const float* __restrict__ sign,
                                        const float* __restrict__ aff_a,
                                        const float* __restrict__ aff_b, int n, int k, bool vec,
                                        int item, int gr, const int* list) {
  const knn::Lanes ln = knn::gather_lanes(cout);
  const int valid = min(8, cout - ln.ch);
  const bf16* ui = u + (size_t)item * n * ldu + ln.ch;
  float mx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) mx[e] = -INFINITY;
  if (valid > 0) {
#pragma unroll 4
    for (int j = ln.grp; j < k; j += ln.P) {
      float v[8];
      load8(ui + (size_t)list[j] * ldu, valid, vec, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], v[e]);
    }
  }
  for (int o = ln.L; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], __shfl_xor_sync(knn::FULL, mx[e], o));
  }
  if (ln.grp == 0 && valid > 0) {
    const size_t orow = (size_t)item * n + gr;
    if (cin != nullptr) {
      float cv[8], sg[8], aa[8], bb[8];
      load8f(cin + orow * ldc + ln.ch, valid, vec, cv);
      load8f(sign + ln.ch, valid, vec, sg);
      load8f(aff_a + ln.ch, valid, vec, aa);
      load8f(aff_b + ln.ch, valid, vec, bb);
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[e] = leaky02((sg[e] * mx[e] + cv[e]) * aa[e] + bb[e]);
    }
    bf16* o = out + orow * ldo + ln.ch;
    if (vec && valid == 8) {
      uint4 w;
      w.x = knn::pack2(mx[0], mx[1]);
      w.y = knn::pack2(mx[2], mx[3]);
      w.z = knn::pack2(mx[4], mx[5]);
      w.w = knn::pack2(mx[6], mx[7]);
      *reinterpret_cast<uint4*>(o) = w;
    } else {
      for (int e = 0; e < valid; ++e) o[e] = f2bf(mx[e]);
    }
  }
}

// Whole distance rows in shared memory (clouds up to 3,200 points at 128
// features).
template <int KS>
__global__ void __launch_bounds__(knn::THREADS, 2) knn_edge_max_kernel(
    const bf16* __restrict__ x, int ldx, int cq, const bf16* __restrict__ u, int ldu,
    int cout, bf16* __restrict__ out, int ldo, const float* __restrict__ cin, int ldc,
    const float* __restrict__ sign, const float* __restrict__ aff_a,
    const float* __restrict__ aff_b, int n, int k, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const knn::Smem s = knn::carve(smem, n, cq);
  const int item = blockIdx.y;
  const int row0 = blockIdx.x * knn::QR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  knn::distances<KS>(x + (size_t)item * n * ldx, ldx, cq, n, row0, s);

  unsigned* scratch = s.scratch + warp * 2 * knn::CAP;
  int* list = knn::list_at(s.sel + warp * knn::POOL, scratch, k);
  for (int rr = 0; rr < knn::QR / knn::WARPS; ++rr) {
    const int r = warp * (knn::QR / knn::WARPS) + rr;
    const int gr = row0 + r;
    if (gr >= n) break;
    const unsigned* dr = reinterpret_cast<const unsigned*>(s.dist + r * s.ldd);
    knn::select_row(dr, n, k, s.pool[r * knn::POOL + lane],
                    s.pool[r * knn::POOL + 32 + lane], scratch, list);
    max_row(u, ldu, cout, out, ldo, cin, ldc, sign, aff_a, aff_b, n, k, vec, item, gr, list);
    __syncwarp();
  }
}

// Larger clouds: the row walked in chunks (knn::select_chunked).
template <int KS>
__global__ void __launch_bounds__(knn::THREADS, 2) knn_edge_max_chunked_kernel(
    const bf16* __restrict__ x, int ldx, int cq, const bf16* __restrict__ u, int ldu,
    int cout, bf16* __restrict__ out, int ldo, const float* __restrict__ cin, int ldc,
    const float* __restrict__ sign, const float* __restrict__ aff_a,
    const float* __restrict__ aff_b, int n, int k, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const knn::Smem s = knn::carve(smem, knn::CHUNK, cq, knn::RPW);
  const int item = blockIdx.y;
  knn::select_chunked<KS>(
      x + (size_t)item * n * ldx, ldx, cq, n, k, blockIdx.x * knn::QR, s,
      [&](int, int gr, const int* list) {
        max_row(u, ldu, cout, out, ldo, cin, ldc, sign, aff_a, aff_b, n, k, vec, item, gr, list);
      });
}

template <class Kernel>
int launch_max(Kernel kernel, const void* x, int ldx, int cq, const void* u, int ldu, int cout,
               void* out, int ldo, const void* cin, int ldc, const void* sign, const void* aff_a,
               const void* aff_b, int n_items, int n, int k, bool vec, cudaStream_t stream) {
  const size_t bytes = knn::smem_bytes(n, cq);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + knn::QR - 1) / knn::QR, n_items);
  kernel<<<grid, knn::THREADS, bytes, stream>>>(
      (const bf16*)x, ldx, cq, (const bf16*)u, ldu, cout, (bf16*)out, ldo, (const float*)cin,
      ldc, (const float*)sign, (const float*)aff_a, (const float*)aff_b, n, k, vec);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_ks(const void* x, int ldx, int cq, const void* u, int ldu, int cout, void* out,
              int ldo, const void* cin, int ldc, const void* sign, const void* aff_a,
              const void* aff_b, int n_items, int n, int k, bool vec, cudaStream_t st) {
  if (knn::whole_rows(n, cq))
    return launch_max(knn_edge_max_kernel<KS>, x, ldx, cq, u, ldu, cout, out, ldo, cin, ldc,
                      sign, aff_a, aff_b, n_items, n, k, vec, st);
  return launch_max(knn_edge_max_chunked_kernel<KS>, x, ldx, cq, u, ldu, cout, out, ldo, cin,
                    ldc, sign, aff_a, aff_b, n_items, n, k, vec, st);
}

}  // namespace

FC_API int fc_knn_edge_max_smem(int n, int cq) { return (int)knn::smem_bytes(n, cq); }

FC_API int fc_knn_edge_max(const void* x, int ldx, int cq, const void* u, int ldu, int cout,
                           void* out, int ldo, const void* cin, int ldc, const void* sign,
                           const void* aff_a, const void* aff_b, int n_items, int n, int k,
                           void* stream) {
  if (k < 1 || k > knn::MAX_K || k > n || cout > MAX_COUT || !knn::pairs_ok(x, ldx, cq))
    return (int)cudaErrorInvalidValue;
  // 16-byte chunks wherever every row of every operand starts on 16 bytes
  const bool vec = cout % 8 == 0 && aligned16(u, ldu) && aligned16(out, ldo) &&
                   (cin == nullptr || (ldc % 4 == 0 && knn::base16(cin) && knn::base16(sign) &&
                                       knn::base16(aff_a) && knn::base16(aff_b)));
  const cudaStream_t st = (cudaStream_t)stream;
  switch (knn::ks_of(cq)) {
    case 1:
      return launch_ks<1>(x, ldx, cq, u, ldu, cout, out, ldo, cin, ldc, sign, aff_a, aff_b,
                          n_items, n, k, vec, st);
    case 2:
      return launch_ks<2>(x, ldx, cq, u, ldu, cout, out, ldo, cin, ldc, sign, aff_a, aff_b,
                          n_items, n, k, vec, st);
    case 4:
      return launch_ks<4>(x, ldx, cq, u, ldu, cout, out, ldo, cin, ldc, sign, aff_a, aff_b,
                          n_items, n, k, vec, st);
    default:
      return launch_ks<8>(x, ldx, cq, u, ldu, cout, out, ldo, cin, ldc, sign, aff_a, aff_b,
                          n_items, n, k, vec, st);
  }
}
