// Exact kNN selection shared by knn_edge_max (B3/B4, eval) and
// knn_edge_reduce (B6, training), so the two select the same neighbours;
// sa_group (B9) runs select_row on its own f32 xyz distance rows through
// select_row_pinned.
//
// For each query row i of an item: d_ij = max(|x_i|^2 - 2 x_i.x_j + |x_j|^2, 0)
// in f32 from bf16 features (the expansion of the Pallas kernels'
// _knn_select_ranks), the exact k-th smallest d by a binary search over the
// f32 bit pattern (non-negative floats order like their bits), every j
// strictly below it plus the ties at it in index order until k are taken
// (lax.top_k's order). The selected indices come out ascending.
//
// Layout: a block of 8 warps owns QR = 16 query rows of one item and keeps
// their full distance rows (16 x n f32) in shared memory; candidate rows
// stream through shared memory in tiles of 32, transposed so neighbouring
// threads read neighbouring candidates. Each warp then selects for two rows.
#pragma once

#include "common.cuh"

namespace {
namespace knn {

constexpr int QR = 16;        // query rows per block
constexpr int TJ = 32;        // candidates per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_K = 64;

// Shared memory of distances(): dist (QR x n), qs (QR x cq), xs (cq x TJ),
// nb (QR), then the per-warp selection lists (8 x MAX_K ints).
inline size_t smem_bytes(int n, int cq) {
  return sizeof(float) * ((size_t)QR * n + (size_t)QR * cq + (size_t)cq * TJ + QR) +
         sizeof(int) * 8 * MAX_K;
}

struct Smem {
  float* dist;
  float* qs;
  float* xs;
  float* nb;
  int* sel;
};

__device__ __forceinline__ Smem carve(float* smem, int n, int cq) {
  Smem s;
  s.dist = smem;
  s.qs = s.dist + QR * n;
  s.xs = s.qs + QR * cq;
  s.nb = s.xs + cq * TJ;
  s.sel = reinterpret_cast<int*>(s.nb + QR);
  return s;
}

// Distance rows of query rows row0..row0+QR-1 of item xi (n rows, ld ldx)
// into s.dist; ends with __syncthreads().
__device__ __forceinline__ void distances(const bf16* __restrict__ xi, int ldx, int cq, int n,
                                          int row0, const Smem& s) {
  const int tid = threadIdx.x;
  for (int e = tid; e < QR * cq; e += THREADS) {
    const int r = e / cq, c = e % cq;
    const int gr = row0 + r;
    s.qs[e] = gr < n ? bf2f(xi[(size_t)gr * ldx + c]) : 0.f;
  }
  __syncthreads();
  if (tid < QR) {
    float acc = 0.f;
    for (int c = 0; c < cq; ++c) acc = fmaf(s.qs[tid * cq + c], s.qs[tid * cq + c], acc);
    s.nb[tid] = acc;
  }
  // thread -> one candidate of the tile, QR / 8 = 2 query rows
  const int jj = tid % TJ, rg = tid / TJ;
  for (int j0 = 0; j0 < n; j0 += TJ) {
    __syncthreads();
    for (int e = tid; e < TJ * cq; e += THREADS) {
      const int j = e / cq, c = e % cq;
      const int gj = j0 + j;
      s.xs[c * TJ + j] = gj < n ? bf2f(xi[(size_t)gj * ldx + c]) : 0.f;
    }
    __syncthreads();
    float a0 = 0.f, a1 = 0.f, nf = 0.f;
    const float* q0 = s.qs + (rg * 2) * cq;
    const float* q1 = q0 + cq;
    for (int c = 0; c < cq; ++c) {
      const float xv = s.xs[c * TJ + jj];
      nf = fmaf(xv, xv, nf);
      a0 = fmaf(q0[c], xv, a0);
      a1 = fmaf(q1[c], xv, a1);
    }
    const int gj = j0 + jj;
    if (gj < n) {
      // clamp to +0 (never -0, whose bits would sort last)
      const float d0 = (s.nb[rg * 2] - 2.f * a0) + nf;
      const float d1 = (s.nb[rg * 2 + 1] - 2.f * a1) + nf;
      s.dist[(rg * 2) * n + gj] = d0 > 0.f ? d0 : 0.f;
      s.dist[(rg * 2 + 1) * n + gj] = d1 > 0.f ? d1 : 0.f;
    }
  }
  __syncthreads();
}

// One warp: the exact k nearest of distance row dr (n entries) into
// list[0..k), ascending. Ends with __syncwarp().
__device__ __forceinline__ void select_row(const unsigned* dr, int n, int k, int* list) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
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
}

// select_row for a query that is itself point `self` of the row (an FPS
// centre; sa_group, B9): the self entry gets all-ones bits, above every
// distance, so the k - 1 nearest OTHER points are taken, ascending, into
// list[0..). Returns how many were taken, min(k, n) - 1: the caller puts the
// centre in slot 0 (through its index, whatever its rounded distance) and
// pads slots past n. Entries of dr are non-negative f32 bit patterns.
__device__ __forceinline__ int select_row_pinned(unsigned* dr, int n, int k, int self,
                                                 int* list) {
  if ((threadIdx.x & 31) == 0) dr[self] = 0xFFFFFFFFu;
  __syncwarp();
  const int kr = min(k, n) - 1;
  select_row(dr, n, kr, list);
  return kr;
}

}  // namespace knn
}  // namespace
