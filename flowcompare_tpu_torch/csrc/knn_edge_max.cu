// knn_edge_max: the exact-kNN neighbourhood max of EdgeConv, the port of the
// Pallas kernel edge_neighbor_max (edgeconv_pallas.py: selection
// _knn_select_ranks, extraction _knn_extract_max) and the core of
// fused_dgcnn_encoder.
//
// For each row i of an item: d_ij = max(|x_i|^2 - 2 x_i.x_j + |x_j|^2, 0) in
// f32 from bf16 features (the expansion _knn_select_ranks uses), the exact
// k-th smallest d by a binary search over the f32 bit pattern (non-negative
// floats order like their bits), every j strictly below it plus the ties at
// it in index order until k are taken (lax.top_k's order), and
// mx_i = max over the selected j of u'_j. With the optional epilogue the
// kernel writes the EdgeConv stage output y = leaky((sign * mx + c) * a + b)
// directly (BatchNorm folded into a, b; fold_dgcnn).
//
// Design: a block of 8 warps owns 16 query rows of one item and keeps their
// full distance rows (16 x N f32) in shared memory; candidate rows stream
// through shared memory in tiles of 32, transposed so neighbouring threads
// read neighbouring candidates. Each warp then selects for two rows: the
// 31-step count-and-halve search over the row in shared memory, one ballot
// pass to admit strict and tied rows in index order, and a gather of the k
// selected u' rows from global memory (one warp-wide coalesced row read each).
// No one-hot matmul and no pad rows: the GPU gathers, and bounds are checked.
//
// What bounds it on the H100: the distance FMAs (N^2 * Cq per item, on CUDA
// cores) and the search sweeps over shared memory; tensor-core distance tiles
// and a radix select are the later speed-ups.
#include "common.cuh"

namespace {

constexpr int QR = 16;       // query rows per block
constexpr int TJ = 32;       // candidates per tile
constexpr int THREADS = 256; // 8 warps
constexpr int MAX_K = 64;
constexpr int MAX_COUT = 256;
constexpr int CPL = MAX_COUT / 32;  // channels per lane

__global__ void __launch_bounds__(THREADS) knn_edge_max_kernel(
    const bf16* __restrict__ x, int ldx, int cq, const bf16* __restrict__ u, int ldu, int cout,
    bf16* __restrict__ out, int ldo, const float* __restrict__ cin, int ldc,
    const float* __restrict__ sign, const float* __restrict__ aff_a,
    const float* __restrict__ aff_b, int n, int k) {
  extern __shared__ __align__(16) float smem[];
  float* dist = smem;                       // QR * n
  float* qs = dist + QR * n;                // QR * cq
  float* xs = qs + QR * cq;                 // cq * TJ (transposed tile)
  float* nb = xs + cq * TJ;                 // QR
  int* sel = reinterpret_cast<int*>(nb + QR);  // 8 warps * MAX_K

  const int item = blockIdx.y;
  const int row0 = blockIdx.x * QR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* xi = x + (size_t)item * n * ldx;

  for (int e = tid; e < QR * cq; e += THREADS) {
    const int r = e / cq, c = e % cq;
    const int gr = row0 + r;
    qs[e] = gr < n ? bf2f(xi[(size_t)gr * ldx + c]) : 0.f;
  }
  __syncthreads();
  if (tid < QR) {
    float s = 0.f;
    for (int c = 0; c < cq; ++c) s = fmaf(qs[tid * cq + c], qs[tid * cq + c], s);
    nb[tid] = s;
  }

  // distances: thread -> one candidate of the tile, QR / 8 = 2 query rows
  const int jj = tid % TJ, rg = tid / TJ;
  for (int j0 = 0; j0 < n; j0 += TJ) {
    __syncthreads();
    for (int e = tid; e < TJ * cq; e += THREADS) {
      const int j = e / cq, c = e % cq;
      const int gj = j0 + j;
      xs[c * TJ + j] = gj < n ? bf2f(xi[(size_t)gj * ldx + c]) : 0.f;
    }
    __syncthreads();
    float a0 = 0.f, a1 = 0.f, nf = 0.f;
    const float* q0 = qs + (rg * 2) * cq;
    const float* q1 = q0 + cq;
    for (int c = 0; c < cq; ++c) {
      const float xv = xs[c * TJ + jj];
      nf = fmaf(xv, xv, nf);
      a0 = fmaf(q0[c], xv, a0);
      a1 = fmaf(q1[c], xv, a1);
    }
    const int gj = j0 + jj;
    if (gj < n) {
      // clamp to +0 (never -0, whose bits would sort last)
      const float d0 = (nb[rg * 2] - 2.f * a0) + nf;
      const float d1 = (nb[rg * 2 + 1] - 2.f * a1) + nf;
      dist[(rg * 2) * n + gj] = d0 > 0.f ? d0 : 0.f;
      dist[(rg * 2 + 1) * n + gj] = d1 > 0.f ? d1 : 0.f;
    }
  }
  __syncthreads();

  int* list = sel + warp * MAX_K;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int rr = 0; rr < QR / 8; ++rr) {
    const int r = warp * (QR / 8) + rr;
    const int gr = row0 + r;
    if (gr >= n) break;
    const unsigned* dr = reinterpret_cast<const unsigned*>(dist + r * n);

    // smallest t with #{d <= t} >= k: the k-th smallest distance
    unsigned lo = 0u, hi = 0x7F800000u;
    while (lo < hi) {
      const unsigned mid = (lo + hi) >> 1;
      int cnt = 0;
      for (int j = lane; j < n; j += 32) cnt += dr[j] <= mid;
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (cnt >= k) hi = mid; else lo = mid + 1u;
    }
    const unsigned th = hi;
    int strict = 0;
    for (int j = lane; j < n; j += 32) strict += dr[j] < th;
    const int m = k - __reduce_add_sync(0xffffffffu, strict);

    // admit strict rows, and ties in index order until k
    int nsel = 0, nties = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const unsigned dv = j < n ? dr[j] : 0xFFFFFFFFu;
      const bool tie = dv == th;
      const unsigned tb = __ballot_sync(0xffffffffu, tie);
      const bool take = dv < th || (tie && nties + __popc(tb & lt_mask) + 1 <= m);
      const unsigned sb = __ballot_sync(0xffffffffu, take);
      if (take) list[nsel + __popc(sb & lt_mask)] = j;
      nsel += __popc(sb);
      nties += __popc(tb);
    }
    __syncwarp();

    float mx[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) mx[t] = -INFINITY;
    for (int s = 0; s < k; ++s) {
      const bf16* ur = u + ((size_t)item * n + list[s]) * ldu;
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        if (c < cout) mx[t] = fmaxf(mx[t], bf2f(ur[c]));
      }
    }
    const size_t orow = (size_t)item * n + gr;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c >= cout) continue;
      float vv = mx[t];
      if (cin != nullptr) {
        const float z = sign[c] * vv + cin[orow * ldc + c];
        vv = leaky02(z * aff_a[c] + aff_b[c]);
      }
      out[orow * ldo + c] = f2bf(vv);
    }
    __syncwarp();
  }
}

size_t smem_bytes(int n, int cq) {
  return sizeof(float) * ((size_t)QR * n + (size_t)QR * cq + (size_t)cq * TJ + QR) +
         sizeof(int) * 8 * MAX_K;
}

}  // namespace

FC_API int fc_knn_edge_max_smem(int n, int cq) { return (int)smem_bytes(n, cq); }

FC_API int fc_knn_edge_max(const void* x, int ldx, int cq, const void* u, int ldu, int cout,
                           void* out, int ldo, const void* cin, int ldc, const void* sign,
                           const void* aff_a, const void* aff_b, int n_items, int n, int k,
                           void* stream) {
  if (k < 1 || k > MAX_K || k > n || cout > MAX_COUT) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, cq);
  cudaError_t err = cudaFuncSetAttribute(knn_edge_max_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + QR - 1) / QR, n_items);
  knn_edge_max_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const bf16*)x, ldx, cq, (const bf16*)u, ldu, cout, (bf16*)out, ldo, (const float*)cin, ldc,
      (const float*)sign, (const float*)aff_a, (const float*)aff_b, n, k);
  return (int)cudaGetLastError();
}
