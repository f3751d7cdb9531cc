// knn_edge_reduce: the training EdgeConv reduction (B6), the port of the
// Pallas kernels of edge_knn_reduce (edgeconv_vjp_pallas.py: forward
// _fwd_kernel, backward _bwd_kernel).
//
// Forward, per row i of an item, over i's exact kNN set in x (knn_select.cuh,
// the same selection as knn_edge_max: tensor-core distances, radix select):
// mx, mn, s1 = sum u_j, s2 = sum u_j^2 (f32, from bf16 u), the selected
// indices in ascending order (the Pallas kernel's selection-rank order) and,
// per channel, the first-occurrence slot of the max and of the min in that
// order (torch.max's tie rule), one byte each: so k <= 256 (slots 0-255,
// every byte value a slot). The k rows of u are gathered from L2 as
// knn_edge_max gathers them (knn::gather_lanes: neighbour slots g, g + P, ...
// in lane group g), the groups merged by shuffles (the max / min keep the
// lower slot on ties). The TPU
// kernel's (B, N, N) rank matrix and one-hot MXU gather are not kept.
//
// Backward, du_j = sum over rows i that selected j of
//   ds1_i + 2 u_j ds2_i + dmx_i [argmax slot of i is j] + dmn_i [argmin slot of i is j].
// Deterministic, with no atomics on the sums, and spread over the card. The
// reverse lists are a counting sort of the selected entries by j, in
// scratch linear in the rows (2 n + 1 + 2 n k ints an item) and with no
// shared memory that grows with n, so any cloud and batch take them:
// 1. knn_rev_count: a block a tile of REV_TILE rows counts its entries'
//    j in shared memory, a window of REV_WINDOW j at a time (the window
//    walks the cloud), each entry keeping its place among the tile's
//    entries of its j; then one atomicAdd a (tile, j) on j's count reserves
//    the tile's places in j's list (integer counts only), and each entry's
//    place in its list is the tile's base plus its own;
// 2. knn_rev_scan: per item, the counts' exclusive scan over j, walked in
//    chunks of 4,096 by one block with a running carry: off[j] .. off[j + 1]
//    is the list of j;
// 3. knn_rev_place: each entry (i << sh | slot) at off[j] plus its place,
//    no atomics: the lists hold their entries in the atomics' order (sh,
//    the slot's bits: 6 up to k = 64, 8 past it; so n < 2^(31 - sh));
// 4. knn_rev_rank: a thread a list position counts the entries of its list
//    below its own (entries are distinct: a row selects j once) and writes
//    it there, so each list is in increasing i whatever the atomics' order
//    (L loads a thread for a list of L: about k on a spread cloud, spread
//    over the list's threads on a hub; n for the k lists of an all-duplicate
//    cloud);
// 5. knn_edge_reduce_bwd: a warp takes one j and one slab of 64 channels and
//    walks j's list, 16 bytes a lane (16 lanes an entry, the two half-warps
//    entries p and p + 1, added at the end). dmx and dmn are read only where
//    a lane's 4 channels hold the entry's argmax or argmin slot (one entry in
//    k on average), so the rows re-read per entry are ds1 and ds2 (8 bytes a
//    channel) and the two slot bytes, not all four cotangent rows; the slabs
//    of one j go to neighbouring warps, so the blocks in flight cover one or
//    two items and read from L2.
// The lists hold the same entries in the same order as any build that keeps
// each list in increasing i, so du is bit-equal to the earlier tiled build.
// The lists (a random cloud's neighbours share no order) give a tile nothing
// to share: the gathers of ds1 and ds2 from L2 bound the backward.
//
// Clouds past whole distance rows in shared memory take the forward's
// chunked kernel (knn::select_chunked, as knn_edge_max does). A launch takes
// up to 65,535 items (the grid's y); the wrapper walks larger batches, and
// batches whose scratch passes 2^28 ints, in groups of items.
//
// What bounds it on the H100: the forward is knn_edge_max's (the u gathers
// from L2) plus its five outputs; the backward the L2 gathers above
// (about 10 bytes a channel per selected entry).
#include <climits>

#include "knn_select.cuh"

namespace {

constexpr int MAX_COUT = 256;
constexpr int SLAB = 64;      // channels one backward warp sums

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

struct FwdArgs {
  const bf16* x;
  int ldx, cq;
  const bf16* u;
  int ldu, cout;
  float *mx, *mn, *s1, *s2;
  unsigned char *amax, *amin;
  int* idx;
  int n, k;
  bool vec;
};

// Row gr's selected indices (list, ascending) and mx, mn, s1, s2 of u over
// them with the first max / min slots. One warp.
__device__ __forceinline__ void reduce_row(const FwdArgs& a, int item, int gr, const int* list) {
  const int lane = threadIdx.x & 31;
  const int k = a.k;
  const knn::Lanes ln = knn::gather_lanes(a.cout);
  const int valid = min(8, a.cout - ln.ch);
  const bf16* ui = a.u + (size_t)item * a.n * a.ldu + ln.ch;
  const size_t orow = (size_t)item * a.n + gr;
  for (int j = lane; j < k; j += 32) a.idx[orow * k + j] = list[j];

  float mx[8], mn[8], a1[8], a2[8];
  int tmx[8], tmn[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mx[e] = -INFINITY;
    mn[e] = INFINITY;
    a1[e] = 0.f;
    a2[e] = 0.f;
    tmx[e] = 0;
    tmn[e] = 0;
  }
  if (valid > 0) {
#pragma unroll 2
    for (int j = ln.grp; j < k; j += ln.P) {
      const bf16* ur = ui + (size_t)list[j] * a.ldu;
      float v[8];
      if (a.vec) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(ur);
        const unsigned w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[2 * e] = knn::lo_f(w[e]);
          v[2 * e + 1] = knn::hi_f(w[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = e < valid ? bf2f(ur[e]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (v[e] > mx[e]) { mx[e] = v[e]; tmx[e] = j; }  // strict: the first slot stays
        if (v[e] < mn[e]) { mn[e] = v[e]; tmn[e] = j; }
        a1[e] += v[e];
        a2[e] += v[e] * v[e];
      }
    }
  }
  for (int o = ln.L; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float omx = __shfl_xor_sync(knn::FULL, mx[e], o);
      const float omn = __shfl_xor_sync(knn::FULL, mn[e], o);
      const int otx = __shfl_xor_sync(knn::FULL, tmx[e], o);
      const int otn = __shfl_xor_sync(knn::FULL, tmn[e], o);
      if (omx > mx[e] || (omx == mx[e] && otx < tmx[e])) { mx[e] = omx; tmx[e] = otx; }
      if (omn < mn[e] || (omn == mn[e] && otn < tmn[e])) { mn[e] = omn; tmn[e] = otn; }
      a1[e] += __shfl_xor_sync(knn::FULL, a1[e], o);
      a2[e] += __shfl_xor_sync(knn::FULL, a2[e], o);
    }
  }
  if (ln.grp == 0 && valid > 0) {
    const size_t o = orow * a.cout + ln.ch;
    if (a.vec) {
      store8(a.mx + o, mx);
      store8(a.mn + o, mn);
      store8(a.s1 + o, a1);
      store8(a.s2 + o, a2);
      uint2 px, pn;
      px.x = tmx[0] | tmx[1] << 8 | tmx[2] << 16 | tmx[3] << 24;
      px.y = tmx[4] | tmx[5] << 8 | tmx[6] << 16 | tmx[7] << 24;
      pn.x = tmn[0] | tmn[1] << 8 | tmn[2] << 16 | tmn[3] << 24;
      pn.y = tmn[4] | tmn[5] << 8 | tmn[6] << 16 | tmn[7] << 24;
      *reinterpret_cast<uint2*>(a.amax + o) = px;
      *reinterpret_cast<uint2*>(a.amin + o) = pn;
    } else {
      for (int e = 0; e < valid; ++e) {
        a.mx[o + e] = mx[e];
        a.mn[o + e] = mn[e];
        a.s1[o + e] = a1[e];
        a.s2[o + e] = a2[e];
        a.amax[o + e] = (unsigned char)tmx[e];
        a.amin[o + e] = (unsigned char)tmn[e];
      }
    }
  }
}

#define FWD_PARAMS                                                                           \
  const bf16 *__restrict__ x, int ldx, int cq, const bf16 *__restrict__ u, int ldu, int cout, \
      float *__restrict__ mx_out, float *__restrict__ mn_out, float *__restrict__ s1_out,     \
      float *__restrict__ s2_out, unsigned char *__restrict__ amax_out,                       \
      unsigned char *__restrict__ amin_out, int *__restrict__ idx_out, int n, int k, bool vec
#define FWD_ARGS \
  {x, ldx, cq, u, ldu, cout, mx_out, mn_out, s1_out, s2_out, amax_out, amin_out, idx_out, n, k, vec}

// Whole distance rows in shared memory (clouds up to 3,200 points at 128
// features).
template <int KS>
__global__ void __launch_bounds__(knn::THREADS, 2) knn_edge_reduce_fwd_kernel(FWD_PARAMS) {
  extern __shared__ __align__(16) float smem[];
  const FwdArgs a FWD_ARGS;
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
    reduce_row(a, item, gr, list);
    __syncwarp();
  }
}

// Larger clouds: the row walked in chunks (knn::select_chunked).
template <int KS>
__global__ void __launch_bounds__(knn::THREADS, 2)
    knn_edge_reduce_fwd_chunked_kernel(FWD_PARAMS) {
  extern __shared__ __align__(16) float smem[];
  const FwdArgs a FWD_ARGS;
  const knn::Smem s = knn::carve(smem, knn::CHUNK, cq, knn::RPW);
  const int item = blockIdx.y;
  knn::select_chunked<KS>(
      x + (size_t)item * n * ldx, ldx, cq, n, k, blockIdx.x * knn::QR, s,
      [&](int, int gr, const int* list) { reduce_row(a, item, gr, list); });
}

constexpr int REV_TILE = 128;     // rows a count block takes
constexpr int REV_WINDOW = 8192;  // j a count block counts at once (32 KB of shared memory)

// Per tile of REV_TILE rows: pos[e] = the place of entry e among the item's
// entries of its j (the tile's base in j's list, reserved by one atomicAdd
// a (tile, j), plus its place among the tile's), cnt[j] the item's count.
__global__ void __launch_bounds__(256) knn_rev_count_kernel(const int* __restrict__ idx, int n,
                                                            int k, int* __restrict__ cnt,
                                                            int* __restrict__ pos) {
  __shared__ int local[REV_WINDOW];
  const int item = blockIdx.y, tid = threadIdx.x;
  const int i0 = blockIdx.x * REV_TILE, entries = min(REV_TILE, n - i0) * k;
  const int* ii = idx + ((size_t)item * n + i0) * k;
  int* pi = pos + ((size_t)item * n + i0) * k;
  int* ci = cnt + (size_t)item * n;
  for (int w0 = 0; w0 < n; w0 += REV_WINDOW) {
    const int wn = min(REV_WINDOW, n - w0);
    for (int j = tid; j < wn; j += blockDim.x) local[j] = 0;
    __syncthreads();
    for (int e = tid; e < entries; e += blockDim.x) {
      const int j = ii[e] - w0;
      if (j >= 0 && j < wn) pi[e] = atomicAdd(&local[j], 1);
    }
    __syncthreads();
    for (int j = tid; j < wn; j += blockDim.x) {
      const int c = local[j];
      if (c != 0) local[j] = atomicAdd(&ci[w0 + j], c);  // integer counts only
    }
    __syncthreads();
    for (int e = tid; e < entries; e += blockDim.x) {
      const int j = ii[e] - w0;
      if (j >= 0 && j < wn) pi[e] += local[j];
    }
    __syncthreads();  // local is cleared by the next window
  }
}

// Per item, one block: off[j] = sum of cnt[j'] over j' < j (off[n] the
// total), walked in chunks of REV_SCAN_CHUNK with a running carry.
constexpr int REV_SCAN_THREADS = 1024;
constexpr int REV_SCAN_CHUNK = 4 * REV_SCAN_THREADS;

__global__ void __launch_bounds__(REV_SCAN_THREADS) knn_rev_scan_kernel(
    const int* __restrict__ cnt, int n, int* __restrict__ off) {
  __shared__ int wsum[32];
  __shared__ int chunk_total;
  const int item = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* c = cnt + (size_t)item * n;
  int* o = off + (size_t)item * (n + 1);
  int carry = 0;
  for (int base = 0; base < n; base += REV_SCAN_CHUNK) {
    const int j0 = base + 4 * tid;
    int v[4], sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = j0 + q < n ? c[j0 + q] : 0;
      sum += v[q];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(knn::FULL, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = wsum[lane];
      int wi = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(knn::FULL, wi, d);
        if (lane >= d) wi += t;
      }
      wsum[lane] = wi - w;  // exclusive
      if (lane == 31) chunk_total = wi;
    }
    __syncthreads();
    int run = carry + wsum[warp] + incl - sum;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j0 + q < n) o[j0 + q] = run;
      run += v[q];
    }
    carry += chunk_total;
    __syncthreads();  // wsum and chunk_total are rewritten by the next chunk
  }
  if (tid == 0) o[n] = carry;
}

// pool[off[j] + pos[e]] = i << sh | slot for every selected entry e = i k +
// slot: each list holds its entries, in the atomics' order.
__global__ void __launch_bounds__(256) knn_rev_place_kernel(const int* __restrict__ idx,
                                                            const int* __restrict__ pos,
                                                            const int* __restrict__ off, int n,
                                                            int k, int sh,
                                                            int* __restrict__ pool) {
  const int item = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * k) return;
  const size_t at = (size_t)item * n * k + e;
  const int i = e / k;
  pool[(size_t)item * n * k + off[(size_t)item * (n + 1) + idx[at]] + pos[at]] =
      (i << sh) | (e - i * k);
}

// A thread a list position p: the entry there goes to off[j] + the number
// of its list's entries below it, so rev holds each list in increasing i
// (i << sh | slot orders as i does: a row selects j once). The threads of a
// warp mostly share a list, so its loads are broadcasts.
__global__ void __launch_bounds__(256) knn_rev_rank_kernel(const int* __restrict__ idx,
                                                           const int* __restrict__ off,
                                                           const int* __restrict__ pool, int n,
                                                           int k, int sh,
                                                           int* __restrict__ rev) {
  const int item = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n * k) return;
  const int* lists = pool + (size_t)item * n * k;
  const int e = lists[p];
  const int j = idx[((size_t)item * n + (e >> sh)) * k + (e & ((1 << sh) - 1))];
  const int* oi = off + (size_t)item * (n + 1);
  const int p0 = oi[j], p1 = oi[j + 1];
  int rank = 0;
  for (int q = p0; q < p1; ++q) rank += lists[q] < e;
  rev[(size_t)item * n * k + p0 + rank] = e;
}

__device__ __forceinline__ void load4(const float* p, int valid, bool vec, float v[4]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < valid ? p[e] : 0.f;
  }
}

__device__ __forceinline__ unsigned load4b(const unsigned char* p, int valid, bool vec) {
  if (vec) return *reinterpret_cast<const unsigned*>(p);
  // past cout 0xff: no slot below 255; at k = 256 slot 255 matches it, but
  // the sums of channels past cout are never stored
  unsigned w = 0xffffffffu;
  for (int e = 0; e < valid; ++e) w = (w & ~(0xffu << (8 * e))) | ((unsigned)p[e] << (8 * e));
  return w;
}

// 0xff in each byte of w that equals slot, 0 in the others.
__device__ __forceinline__ unsigned slot_hits(unsigned w, int slot) {
  return __vcmpeq4(w, (unsigned)slot * 0x01010101u);
}

// A warp sums du for one j and one slab of SLAB channels: 16 lanes of 4
// channels each take one list entry, the two half-warps entries p and p + 1
// (group g the entries g, g + 2, ...), added at the end (one xor-16 shuffle).
// Consecutive warps take the slabs of one j, so blocks in flight cover one or
// two items' rows and the gathers stay in L2. SH: the entries' slot bits.
template <int SH>
__global__ void __launch_bounds__(256) knn_edge_reduce_bwd_kernel(
    const bf16* __restrict__ u, int ldu, int cout, const float* __restrict__ dmx,
    const float* __restrict__ dmn, const float* __restrict__ ds1, const float* __restrict__ ds2,
    const unsigned char* __restrict__ amax, const unsigned char* __restrict__ amin,
    const int* __restrict__ off, const int* __restrict__ rev, float* __restrict__ du, int n,
    int k, int slabs, bool vec) {
  const int item = blockIdx.y, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int j = unit / slabs;
  if (j >= n) return;
  const int half = lane >> 4;
  const int ch = (unit % slabs) * SLAB + 4 * (lane & 15);
  const int valid = min(4, cout - ch);
  const size_t jrow = (size_t)item * n + j;
  float uj[4], acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uj[e] = e < valid ? bf2f(u[jrow * ldu + ch + e]) : 0.f;
    acc[e] = 0.f;
  }
  const int* oi = off + (size_t)item * (n + 1);
  const int* ri = rev + (size_t)item * n * k;
  const int p1 = oi[j + 1];
  if (valid > 0) {
#pragma unroll 2
    for (int p = oi[j] + half; p < p1; p += 2) {
      const int e = ri[p];
      const int slot = e & ((1 << SH) - 1);
      const size_t o = ((size_t)item * n + (e >> SH)) * cout + ch;
      float a[4], b[4];
      load4(ds1 + o, valid, vec, a);
      load4(ds2 + o, valid, vec, b);
      const unsigned hx = slot_hits(load4b(amax + o, valid, vec), slot);
      const unsigned hn = slot_hits(load4b(amin + o, valid, vec), slot);
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q] = a[q] + 2.f * uj[q] * b[q];
      if (hx != 0u) {
        float m[4];
        load4(dmx + o, valid, vec, m);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((hx >> (8 * q)) & 1u) g[q] += m[q];
      }
      if (hn != 0u) {
        float m[4];
        load4(dmn + o, valid, vec, m);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((hn >> (8 * q)) & 1u) g[q] += m[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += g[q];
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += __shfl_xor_sync(knn::FULL, acc[q], 16);
  if (half != 0 || valid <= 0) return;
  float* d = du + jrow * cout + ch;
  if (vec) {
    *reinterpret_cast<float4*>(d) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    for (int q = 0; q < valid; ++q) d[q] = acc[q];
  }
}

template <class Kernel>
int launch_fwd(Kernel kernel, const FwdArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t bytes = knn::smem_bytes(a.n, a.cq);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, knn::THREADS, bytes, stream>>>(a.x, a.ldx, a.cq, a.u, a.ldu, a.cout, a.mx, a.mn,
                                                 a.s1, a.s2, a.amax, a.amin, a.idx, a.n, a.k,
                                                 a.vec);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_fwd_ks(const FwdArgs& a, dim3 grid, cudaStream_t st) {
  if (knn::whole_rows(a.n, a.cq)) return launch_fwd(knn_edge_reduce_fwd_kernel<KS>, a, grid, st);
  return launch_fwd(knn_edge_reduce_fwd_chunked_kernel<KS>, a, grid, st);
}

}  // namespace

// Ints of scratch knn_edge_reduce_bwd needs an item: the counts, the list
// offsets, the entries' places (then the ordered lists) and the unordered
// lists; -1 past 2^31 - 1.
FC_API int fc_knn_edge_reduce_bwd_scratch(int n, int k) {
  const long long ints = 2LL * n + 1 + 2LL * n * k;
  return ints > 0x7fffffffLL ? -1 : (int)ints;
}

FC_API int fc_knn_edge_reduce_fwd(const void* x, int ldx, int cq, const void* u, int ldu, int cout,
                                  void* mx, void* mn, void* s1, void* s2, void* amax, void* amin,
                                  void* idx, int n_items, int n, int k, void* stream) {
  if (k < 1 || k > knn::MAX_K || k > n || cout > MAX_COUT || !knn::pairs_ok(x, ldx, cq))
    return (int)cudaErrorInvalidValue;
  // outputs are contiguous (rows, cout): 16-byte chunks when cout % 8 == 0
  const bool vec = cout % 8 == 0 && aligned16(u, ldu) && knn::base16(mx) && knn::base16(mn) &&
                   knn::base16(s1) && knn::base16(s2) &&
                   (reinterpret_cast<uintptr_t>(amax) & 7u) == 0 &&
                   (reinterpret_cast<uintptr_t>(amin) & 7u) == 0;
  const FwdArgs a{(const bf16*)x, ldx, cq, (const bf16*)u, ldu, cout,
                  (float*)mx, (float*)mn, (float*)s1, (float*)s2, (unsigned char*)amax,
                  (unsigned char*)amin, (int*)idx, n, k, vec};
  const dim3 grid((n + knn::QR - 1) / knn::QR, n_items);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (knn::ks_of(cq)) {
    case 1: return launch_fwd_ks<1>(a, grid, st);
    case 2: return launch_fwd_ks<2>(a, grid, st);
    case 4: return launch_fwd_ks<4>(a, grid, st);
    default: return launch_fwd_ks<8>(a, grid, st);
  }
}

FC_API int fc_knn_edge_reduce_bwd(const void* u, int ldu, int cout, const void* dmx,
                                  const void* dmn, const void* ds1, const void* ds2,
                                  const void* amax, const void* amin, const void* idx,
                                  void* scratch, void* du, int n_items, int n, int k,
                                  void* stream) {
  // entries i << sh | slot and an item's n k entries are int32
  const int sh = k > knn::POOL ? 8 : 6;
  if (k < 1 || k > knn::MAX_K || k > n || cout > MAX_COUT || n_items < 1 || n_items > 65535 ||
      n >= (1 << (31 - sh)) || (long long)n * k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // scratch: the counts, the list offsets, each entry's place in its list
  // (then the ordered lists, rev) and the lists in the atomics' order
  int* cnt = (int*)scratch;
  int* off = cnt + (size_t)n_items * n;
  int* pos = off + (size_t)n_items * (n + 1);
  int* pool = pos + (size_t)n_items * n * k;
  int* rev = pos;
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)n_items * n, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 egrid((unsigned)(((long long)n * k + 255) / 256), n_items);
  knn_rev_count_kernel<<<dim3((n + REV_TILE - 1) / REV_TILE, n_items), 256, 0, st>>>(
      (const int*)idx, n, k, cnt, pos);
  knn_rev_scan_kernel<<<n_items, REV_SCAN_THREADS, 0, st>>>(cnt, n, off);
  knn_rev_place_kernel<<<egrid, 256, 0, st>>>((const int*)idx, pos, off, n, k, sh, pool);
  knn_rev_rank_kernel<<<egrid, 256, 0, st>>>((const int*)idx, off, pool, n, k, sh, rev);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // every row is contiguous (rows, cout): 16-byte chunks when cout % 4 == 0
  const bool vec = cout % 4 == 0 && knn::base16(dmx) && knn::base16(dmn) &&
                   knn::base16(ds1) && knn::base16(ds2) && knn::base16(du) &&
                   (reinterpret_cast<uintptr_t>(amax) & 3u) == 0 &&
                   (reinterpret_cast<uintptr_t>(amin) & 3u) == 0;
  const int slabs = (cout + SLAB - 1) / SLAB;
  dim3 grid((n * slabs + 7) / 8, n_items);
  auto bwd = sh == 6 ? knn_edge_reduce_bwd_kernel<6> : knn_edge_reduce_bwd_kernel<8>;
  bwd<<<grid, 256, 0, st>>>(
      (const bf16*)u, ldu, cout, (const float*)dmx, (const float*)dmn, (const float*)ds1,
      (const float*)ds2, (const unsigned char*)amax, (const unsigned char*)amin, off, rev,
      (float*)du, n, k, slabs, vec);
  return (int)cudaGetLastError();
}
