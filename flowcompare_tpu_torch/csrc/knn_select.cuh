// Exact kNN selection shared by knn_edge_max (B3/B4, eval) and
// knn_edge_reduce (B6, training), so the two select the same neighbours;
// sa_group (B9) runs select_row on its own f32 xyz distance rows through
// select_row_pinned, or select_row_of on distances it recomputes.
//
// For each query row i of an item: d_ij = max(|x_i|^2 - 2 x_i.x_j + |x_j|^2, +0)
// in f32 from bf16 features (the expansion of the Pallas kernels'
// _knn_select_ranks), the exact k-th smallest d, every j strictly below it
// plus the ties at it in index order until k (lax.top_k's order). The
// selected indices come out ascending. Self is not excluded.
//
// Design for the H100:
// - Distances on the tensor cores. A block of 8 warps owns QR = 16 query rows
//   of one item (one m16 tile) and writes their full distance rows into shared
//   memory: each warp takes candidate tiles of 8 (n8) and runs mma.sync
//   m16n8k16 bf16 -> f32 over ceil(cq / 16) k-steps, zero-padded (cq = 6 pads
//   to 16, which changes no product). The query tile's A fragments come from
//   shared memory, the candidates' B fragments straight from global memory
//   (an item's rows stay in L2), KS k-steps of 2-4 tiles loaded at once so
//   that a warp waits on L2 once per group of tiles, not once per k-step.
//   bf16 x bf16 products are exact in f32; only the order of the f32
//   accumulation differs from an expansion on the CUDA cores. The squared
//   norms are f32 fmaf sums of the same fragments (per lane, then over the
//   lane quad), the query rows' from the staged A tile in the same order, so
//   |x_i|^2 is one number whether i is the query or the candidate.
//   Rows in shared memory, not a tile recomputed on each pass: 16 rows of
//   n = 1,250 take 82 KB (two blocks an SM) and the selection reads a row
//   once more; recomputing would re-read the candidates from L2, and the
//   loads, not the products, are what a tile costs.
// - Selection, one warp a row, exact. While the distances are written, each
//   of 32 sources (a warp and a lane quad: a fixed eighth of the columns of
//   every eighth tile) keeps its two smallest entries of the row: a pool of
//   64 entries of the row. The pool's k-th smallest, t (a bitonic sort
//   across the warp), is at least the row's k-th smallest, since k entries of
//   the row lie at or below it. One sweep gathers the entries d <= t (on
//   spread distances a few more than k: t sits near the row's 4-5% quantile
//   at k = 40 of 1,250) and their rank by (d, index) among themselves picks
//   the k: the smallest, ties in index order. Where ties around t bring more
//   than CAP candidates (duplicated points, integer features), the row falls
//   back to a radix select over the f32 bit pattern (non-negative floats
//   order like their bits): 256-bin histograms of digits of 8, 8, 8 and 7
//   bits from bit 30 down, equal digits of a warp grouped by
//   __match_any_sync before their shared atomic, a warp scan for the bin of
//   the k-th value, an early stop when that bin holds exactly the entries
//   still needed, then the admit pass. Sweeps of a row: 1 (2-5 more on the
//   fallback) against the 33 of the binary search this replaced (31
//   halvings of [0, 0x7F800000], a strict count, the admit pass).
// - Clouds whose 16 distance rows do not fit a block's shared memory (n >
//   3,200 at 128 features) walk the row in chunks of CHUNK columns
//   (select_chunked): the chunk's 16 distance rows go to shared memory, and a
//   warp keeps the candidates of both its rows (2 CAP entries each) across
//   the chunks, in index order, in one pass with a falling threshold: after
//   each chunk the pool so far gives t, which bounds the row's k-th smallest
//   too; a warp drops its candidates above the new t and sweeps the chunk
//   under it. Each distance is computed once. (Two passes, a pool pass then
//   a recomputing sweep under its t, were slower at every measured shape:
//   PERF.md.) The radix fallback recomputes the chunks for each digit pass
//   and for the admit pass, the whole block in step. A recomputed distance
//   is bit-identical to the first (the same mma.sync k-steps, the same fmaf
//   norms), so the walk selects the whole-row path's set.
// - k past the pool (64 < k <= MAX_K = 256): the pool's k-th smallest no
//   longer bounds the row's, so every row takes the radix select from the
//   start (the chunked walk its recomputing passes, with no pool pass before
//   them). Its list of k then lies in the upper half of the warp's 2 CAP
//   words of scratch, which the radix select (its histogram the lower BINS
//   words) leaves free, so no launch's shared memory depends on k.
#pragma once

#include "common.cuh"

namespace {
namespace knn {

constexpr int QR = 16;        // query rows per block: one m16 tile
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 256;     // the largest k (B6 keeps a selection slot in a byte)
constexpr int POOL = 64;      // pool values of a row: two per source; the pool's largest k
constexpr int BINS = 256;     // histogram bins of the radix select
constexpr int CAP = 256;      // candidates a warp holds (indices, then bit patterns)
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 1024;   // columns of a chunk of the chunked walk
constexpr int RPW = QR / WARPS;  // rows a warp selects for
constexpr int SMEM_OPTIN = 227 * 1024;  // dynamic shared memory a block may opt into

__host__ __device__ inline int ksteps(int cq) { return (cq + 15) / 16; }
// shared row strides: distance rows padded to 8 mod 32 words so the
// fragments' stores spread over the banks; query rows of 16 ksteps bf16 + 8
__host__ __device__ inline int dist_ld(int n) { return (n + 31) / 32 * 32 + 8; }
__host__ __device__ inline int q_ld(int cq) { return 16 * ksteps(cq) + 8; }

static_assert(2 * CAP - BINS >= MAX_K, "a list past the pool fits beside a histogram");

// Shared memory of a select block: dist (QR x dist_ld f32), pool (QR x
// POOL), qs (QR x q_ld bf16), per warp 2 CAP words of scratch (the
// candidates, or the radix select's histogram) and a selection list of POOL
// (a list past the pool lies in the scratch: list_at).
inline size_t whole_smem_bytes(int n, int cq) {
  return sizeof(float) * (size_t)QR * dist_ld(n) + sizeof(unsigned) * QR * POOL +
         sizeof(bf16) * (size_t)QR * q_ld(cq) + sizeof(unsigned) * WARPS * 2 * CAP +
         sizeof(int) * WARPS * POOL;
}

// Whether the whole distance rows fit: else the block walks the row in chunks.
inline bool whole_rows(int n, int cq) { return whole_smem_bytes(n, cq) <= (size_t)SMEM_OPTIN; }

// The chunked walk's: dist (QR x dist_ld(CHUNK)), pool, qs, per warp RPW rows
// of 2 CAP words (candidates, or a radix histogram) and RPW lists.
inline size_t chunked_smem_bytes(int cq) {
  return sizeof(float) * (size_t)QR * dist_ld(CHUNK) + sizeof(unsigned) * QR * POOL +
         sizeof(bf16) * (size_t)QR * q_ld(cq) + sizeof(unsigned) * WARPS * RPW * 2 * CAP +
         sizeof(int) * WARPS * RPW * POOL;
}

inline size_t smem_bytes(int n, int cq) {
  return whole_rows(n, cq) ? whole_smem_bytes(n, cq) : chunked_smem_bytes(cq);
}

// The selection list of a row whose 2 CAP words of scratch are `scratch`:
// its own POOL entries `own` up to k = POOL; past it (the radix select
// alone, its histogram the lower BINS words) the scratch's upper half.
__device__ __forceinline__ int* list_at(int* own, unsigned* scratch, int k) {
  return k > POOL ? reinterpret_cast<int*>(scratch + BINS) : own;
}

struct Smem {
  float* dist;
  unsigned* pool;
  unsigned* qs;       // bf16 pairs
  unsigned* scratch;  // 2 CAP a warp
  int* sel;
  int ldd, ldq2;  // in f32 / in bf16 pairs
};

// cols: the distance rows' columns (n, or CHUNK); rows: the rows a warp keeps
// candidates for at once (1, or RPW in the chunked walk).
__device__ __forceinline__ Smem carve(float* smem, int cols, int cq, int rows = 1) {
  Smem s;
  s.ldd = dist_ld(cols);
  s.ldq2 = q_ld(cq) / 2;
  s.dist = smem;
  s.pool = reinterpret_cast<unsigned*>(s.dist + QR * s.ldd);
  s.qs = s.pool + QR * POOL;
  s.scratch = s.qs + QR * s.ldq2;
  s.sel = reinterpret_cast<int*>(s.scratch + WARPS * rows * 2 * CAP);
  return s;
}

// The KS of the distance loop for cq features (k-steps loaded at once).
__host__ inline int ks_of(int cq) {
  const int ks = ksteps(cq);
  return ks <= 1 ? 1 : ks <= 2 ? 2 : ks <= 4 ? 4 : 8;
}

// The gathers' lanes: L lanes read one row in chunks of 8 channels (cout <=
// 256), P = 32 / L rows at once; this lane's group and first channel.
struct Lanes {
  int L, P, grp, ch;
};

__device__ __forceinline__ Lanes gather_lanes(int cout) {
  const int chunks = (cout + 7) / 8;
  int L = 1;
  while (L < chunks) L <<= 1;
  const int lane = threadIdx.x & 31;
  return {L, 32 / L, lane / L, (lane % L) * 8};
}

// m1 <= m2: the two smallest values seen, v the next one.
__device__ __forceinline__ void keep2(unsigned& m1, unsigned& m2, unsigned v) {
  m2 = min(m2, max(m1, v));
  m1 = min(m1, v);
}

// Whether the kernels can read a bf16 matrix in aligned pairs (the wrappers
// pad one that cannot).
__host__ __forceinline__ bool pairs_ok(const void* x, int ldx, int cq) {
  return (reinterpret_cast<uintptr_t>(x) & 3u) == 0 && ldx % 2 == 0 && cq % 2 == 0;
}

__host__ __forceinline__ bool base16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// row[c], row[c + 1] (c even; zero at and past cq, which is even): an mma
// register, low half first.
__device__ __forceinline__ unsigned load_pair(const bf16* row, int c, int cq) {
  return c < cq ? *reinterpret_cast<const unsigned*>(row + c) : 0u;
}

__device__ __forceinline__ float lo_f(unsigned p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f(unsigned p) { return __uint_as_float(p & 0xffff0000u); }

// f32 sum of the squares of a B fragment's four bf16 values, into nrm.
__device__ __forceinline__ void add_squares(unsigned b0, unsigned b1, float& nrm) {
  nrm = fmaf(lo_f(b0), lo_f(b0), nrm);
  nrm = fmaf(hi_f(b0), hi_f(b0), nrm);
  nrm = fmaf(lo_f(b1), lo_f(b1), nrm);
  nrm = fmaf(hi_f(b1), hi_f(b1), nrm);
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

__device__ __forceinline__ void mma_bf16(float c[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage the query rows row0..row0+QR-1 of item xi (n rows, ld ldx, read in
// aligned pairs; zero past n) into s.qs. Ends with __syncthreads().
__device__ __forceinline__ void stage_queries(const bf16* __restrict__ xi, int ldx, int cq,
                                              int n, int row0, const Smem& s) {
  const int nks = ksteps(cq);
  for (int e = threadIdx.x; e < QR * 8 * nks; e += THREADS) {
    const int r = e / (8 * nks), cp = e % (8 * nks);
    const bf16* row = xi + (size_t)(row0 + r) * ldx;
    s.qs[r * s.ldq2 + cp] = row0 + r < n ? load_pair(row, 2 * cp, cq) : 0u;
  }
  __syncthreads();
}

// A lane's view of the staged query tile: its A fragments' rows g and g + 8
// and their norms, summed as the candidates' are in tiles().
struct Queries {
  const unsigned *qa0, *qa1;
  float qn0, qn1;
};

__device__ __forceinline__ Queries queries(int cq, const Smem& s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  Queries a;
  a.qa0 = s.qs + g * s.ldq2 + q;
  a.qa1 = a.qa0 + 8 * s.ldq2;
  float qn0 = 0.f, qn1 = 0.f;
  for (int ks = 0; ks < ksteps(cq); ++ks) {
    add_squares(a.qa0[8 * ks], a.qa0[8 * ks + 4], qn0);
    add_squares(a.qa1[8 * ks], a.qa1[8 * ks + 4], qn1);
  }
  a.qn0 = quad_sum(qn0);
  a.qn1 = quad_sum(qn1);
  return a;
}

// Each row's two smallest of a source (warp w, lane quad q: the columns 2q,
// 2q+1 of the tiles w, w + 8, ...), rows g and g + 8 of the lane.
struct Pool2 {
  unsigned m00 = FULL, m01 = FULL, m10 = FULL, m11 = FULL;
};

// The distances of the staged query rows to the columns [c0, c1) of item xi
// (c0 a multiple of 8; n rows in all): with STORE into s.dist at column j -
// c0 (entries past c1 are written but never read), with POOL into the
// lane's two smallest (columns below n). KS k-steps of TILES candidate
// tiles are loaded at once, so a warp has their L2 reads in flight together.
template <int KS, bool STORE, bool POOL>
__device__ __forceinline__ void tiles(const bf16* __restrict__ xi, int ldx, int cq, int n,
                                      int c0, int c1, const Smem& s, const Queries& a,
                                      Pool2& m) {
  constexpr int TILES = KS >= 8 ? 2 : 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nks = ksteps(cq);
  for (int base = c0 + 8 * warp; base < c1; base += 8 * WARPS * TILES) {
    const bf16* row[TILES];
    float acc[TILES][4], nrm[TILES];
#pragma unroll
    for (int u = 0; u < TILES; ++u) {
      const int j = base + 8 * WARPS * u + g;
      row[u] = j < c1 ? xi + (size_t)j * ldx : nullptr;
      acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
      nrm[u] = 0.f;
    }
    for (int kc = 0; kc < nks; kc += KS) {
      unsigned b[TILES][KS][2];
#pragma unroll
      for (int u = 0; u < TILES; ++u)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int c = 16 * (kc + ks) + 2 * q;
          b[u][ks][0] = row[u] ? load_pair(row[u], c, cq) : 0u;
          b[u][ks][1] = row[u] ? load_pair(row[u], c + 8, cq) : 0u;
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (kc + ks < nks) {
          const int o = 8 * (kc + ks);
          const unsigned a0 = a.qa0[o], a1 = a.qa1[o], a2 = a.qa0[o + 4], a3 = a.qa1[o + 4];
#pragma unroll
          for (int u = 0; u < TILES; ++u) {
            add_squares(b[u][ks][0], b[u][ks][1], nrm[u]);
            mma_bf16(acc[u], a0, a1, a2, a3, b[u][ks][0], b[u][ks][1]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TILES; ++u) {
      const int j0 = base + 8 * WARPS * u;
      if (j0 >= c1) break;
      const float nu = quad_sum(nrm[u]);  // the norm of candidate j0 + g
      const float na = __shfl_sync(FULL, nu, 8 * q), nb = __shfl_sync(FULL, nu, 8 * q + 4);
      // clamp to +0 (never -0, whose bits would sort last)
      float2 d0 = make_float2((a.qn0 - 2.f * acc[u][0]) + na, (a.qn0 - 2.f * acc[u][1]) + nb);
      float2 d1 = make_float2((a.qn1 - 2.f * acc[u][2]) + na, (a.qn1 - 2.f * acc[u][3]) + nb);
      d0.x = d0.x > 0.f ? d0.x : 0.f;
      d0.y = d0.y > 0.f ? d0.y : 0.f;
      d1.x = d1.x > 0.f ? d1.x : 0.f;
      d1.y = d1.y > 0.f ? d1.y : 0.f;
      if (STORE) {
        *reinterpret_cast<float2*>(s.dist + g * s.ldd + j0 - c0 + 2 * q) = d0;
        *reinterpret_cast<float2*>(s.dist + (g + 8) * s.ldd + j0 - c0 + 2 * q) = d1;
      }
      if (POOL) {
        if (j0 + 2 * q < n) {
          keep2(m.m00, m.m01, __float_as_uint(d0.x));
          keep2(m.m10, m.m11, __float_as_uint(d1.x));
        }
        if (j0 + 2 * q + 1 < n) {
          keep2(m.m00, m.m01, __float_as_uint(d0.y));
          keep2(m.m10, m.m11, __float_as_uint(d1.y));
        }
      }
    }
  }
}

__device__ __forceinline__ void write_pool(const Pool2& m, const Smem& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int src = 2 * (4 * warp + q);
  s.pool[g * POOL + src] = m.m00;
  s.pool[g * POOL + src + 1] = m.m01;
  s.pool[(g + 8) * POOL + src] = m.m10;
  s.pool[(g + 8) * POOL + src + 1] = m.m11;
}

// Distance rows of query rows row0..row0+QR-1 of item xi (n rows, ld ldx,
// read in aligned pairs) into s.dist (entries past n are written but never
// read), and each row's pool: per source its two smallest bit patterns into
// s.pool. Ends with __syncthreads().
template <int KS>
__device__ __forceinline__ void distances(const bf16* __restrict__ xi, int ldx, int cq, int n,
                                          int row0, const Smem& s) {
  stage_queries(xi, ldx, cq, n, row0, s);
  const Queries a = queries(cq, s);
  Pool2 m;
  tiles<KS, true, true>(xi, ldx, cq, n, 0, n, s, a, m);
  write_pool(m, s);
  __syncthreads();
}

// The k-th smallest (k <= POOL) of the warp's 64 values v0 (element lane) and
// v1 (element lane + 32): a bitonic sort across the warp.
__device__ __forceinline__ unsigned kth_of_pool(unsigned v0, unsigned v1, int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // element lane against lane + 32, ascending
        const unsigned lo = min(v0, v1);
        v1 = max(v0, v1);
        v0 = lo;
      } else {
        const bool lower = (lane & stride) == 0;
        const unsigned o0 = __shfl_xor_sync(FULL, v0, stride);
        const unsigned o1 = __shfl_xor_sync(FULL, v1, stride);
        // ascending where (element & size) == 0; element lane + 32 has bit 5 set
        const bool up0 = (lane & size) == 0, up1 = ((lane + 32) & size) == 0;
        v0 = (up0 == lower) ? min(v0, o0) : max(v0, o0);
        v1 = (up1 == lower) ? min(v1, o1) : max(v1, o1);
      }
    }
  }
  return __shfl_sync(FULL, k <= 32 ? v0 : v1, (k - 1) & 31);
}

// The radix select's state, one warp a row (warp-uniform): the digits found
// so far (prefix), the bits below them (shift), the rank of the k-th value
// among the entries matching prefix (need), the histogram passes made.
struct Radix {
  unsigned prefix = 0u, need = 0u;
  int shift = 31, pass = 0;
};

__device__ __forceinline__ int radix_width(const Radix& r) { return r.pass < 3 ? 8 : 7; }

// Zero this warp's BINS counters. Ends with __syncwarp().
__device__ __forceinline__ void radix_clear(unsigned* hist) {
  for (int b = threadIdx.x & 31; b < BINS; b += 32) hist[b] = 0u;
  __syncwarp();
}

// Count the next digit of the entries get(j), j in [j0, j1), whose higher
// digits match the prefix, into hist. Entries with bit 31 set are never
// counted.
template <class Get>
__device__ __forceinline__ void radix_count(const Radix& r, Get get, int j0, int j1,
                                            unsigned* hist) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int width = radix_width(r), nshift = r.shift - width;
  for (int jb = j0; jb < j1; jb += 32) {
    const int j = jb + lane;
    const unsigned v = j < j1 ? get(j) : FULL;
    const bool match = (v >> r.shift) == r.prefix;
    if (__ballot_sync(FULL, match) == 0u) continue;
    const unsigned digit = (v >> nshift) & ((1u << width) - 1u);
    const unsigned peers = __match_any_sync(FULL, match ? digit : BINS + lane);
    if (match && (peers & lt_mask) == 0u) atomicAdd(&hist[digit], (unsigned)__popc(peers));
  }
}

// After a pass's counts (and a __syncwarp): the bin of the k-th value,
// added to the prefix. Returns whether the search is done (the whole bin is
// taken, or the last digit). Ends with __syncwarp().
__device__ __forceinline__ bool radix_pick(Radix& r, const unsigned* hist) {
  const int lane = threadIdx.x & 31;
  const int width = radix_width(r);
  // lane l holds bins 8l .. 8l+7
  const uint4 h0 = reinterpret_cast<const uint4*>(hist)[2 * lane];
  const uint4 h1 = reinterpret_cast<const uint4*>(hist)[2 * lane + 1];
  const unsigned c[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  unsigned sum = 0u;
#pragma unroll
  for (int b = 0; b < 8; ++b) sum += c[b];
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned excl = incl - sum;
  const unsigned owner = __ballot_sync(FULL, excl < r.need && r.need <= incl);
  unsigned digit = 0u, below = excl, cnt = 0u;
  if ((owner >> lane) & 1u) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (cnt == 0u && below + c[b] >= r.need) {
        digit = 8 * lane + b;
        cnt = c[b];
      } else if (cnt == 0u) {
        below += c[b];
      }
    }
  }
  const int src = __ffs(owner) - 1;
  digit = __shfl_sync(FULL, digit, src);
  below = __shfl_sync(FULL, below, src);
  cnt = __shfl_sync(FULL, cnt, src);
  r.prefix = (r.prefix << width) | digit;
  r.shift -= width;
  r.need -= below;
  ++r.pass;
  __syncwarp();
  return cnt == r.need || r.pass == 4;
}

// The admit pass over get(j), j in [j0, j1), in index order: the keys below
// the prefix, and ties at it until need; nsel and nties run on across calls.
template <class Get>
__device__ __forceinline__ void radix_admit(const Radix& r, Get get, int j0, int j1, int k,
                                            int& nsel, unsigned& nties, int* list) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int jb = j0; jb < j1 && nsel < k; jb += 32) {
    const int j = jb + lane;
    const unsigned key = j < j1 ? get(j) >> r.shift : FULL;
    const bool tie = key == r.prefix;
    const unsigned tb = __ballot_sync(FULL, tie);
    const bool take = key < r.prefix || (tie && nties + __popc(tb & lt_mask) < r.need);
    const unsigned sb = __ballot_sync(FULL, take);
    if (take) list[nsel + __popc(sb & lt_mask)] = j;
    nsel += __popc(sb);
    nties += __popc(tb);
  }
}

// Radix select, one warp: the exact k (>= 1) smallest of a row of n bit
// patterns get(j), their indices into list[0..k), ascending: 256-bin
// histograms of digits of 8, 8, 8 and 7 bits from bit 30 down, equal digits
// of a warp grouped by __match_any_sync before their shared atomic, a warp
// scan for the bin of the k-th value, an early stop when that bin holds
// exactly the entries still needed, then the admit pass. Entries with bit 31
// set are never counted or taken. hist: this warp's BINS counters. Returns
// the sweeps over the row. Ends with __syncwarp().
template <class Get>
__device__ __forceinline__ int radix_select(Get get, int n, int k, unsigned* hist, int* list) {
  Radix r;
  r.need = k;
  do {
    radix_clear(hist);
    radix_count(r, get, 0, n, hist);
    __syncwarp();
  } while (!radix_pick(r, hist));
  int nsel = 0;
  unsigned nties = 0u;
  radix_admit(r, get, 0, n, k, nsel, nties, list);
  __syncwarp();
  return r.pass + 1;
}

// Gather the entries get(j) <= t, j in [j0, j1), bit 31 clear, in index
// order into cand (index) and cval (value) at cnt, which runs on across
// calls (past CAP it counts on, storing nothing).
template <class Get>
__device__ __forceinline__ void sweep(Get get, int j0, int j1, unsigned t, int& cnt,
                                      unsigned* cand, unsigned* cval) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int jb = j0; jb < j1; jb += 32) {
    const int j = jb + lane;
    const unsigned v = j < j1 ? get(j) : FULL;
    const bool c = v <= t && (v >> 31) == 0u;
    const unsigned cb = __ballot_sync(FULL, c);
    const int pos = cnt + __popc(cb & lt_mask);
    if (c && pos < CAP) {
      cand[pos] = j;
      cval[pos] = v;
    }
    cnt += __popc(cb);
  }
}

// The k of cnt (<= CAP) candidates with the smallest (value, position):
// their indices into list, in candidate (index) order. Ends with __syncwarp().
__device__ __forceinline__ void rank_candidates(int cnt, int k, const unsigned* cand,
                                                const unsigned* cval, int* list) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  int nsel = 0;
  for (int c0 = 0; c0 < cnt; c0 += 32) {
    const int c = c0 + lane;
    const unsigned v = c < cnt ? cval[c] : FULL;
    int rank = 0;
    for (int c2 = 0; c2 < cnt; ++c2) {
      const unsigned w = cval[c2];
      rank += (w < v) | ((w == v) & (c2 < c));
    }
    const bool take = c < cnt && rank < k;
    const unsigned sb = __ballot_sync(FULL, take);
    if (take) list[nsel + __popc(sb & lt_mask)] = (int)cand[c];
    nsel += __popc(sb);
  }
  __syncwarp();
}

// One warp: the exact k (1 <= k <= MAX_K) smallest of a row of n bit
// patterns get(j), their indices into list[0..k), ascending. Past the pool
// (k > POOL) the radix select alone, from the start. Else t, the k-th smallest of
// the 64 pool values p0 (lane) and p1 (lane + 32), which are entries of the
// row, bounds the k-th smallest of the row from above; one sweep gathers the
// candidates d <= t (a few more than k on spread distances) into scratch,
// and each candidate's rank by (d, index) among them decides: rank < k is
// taken. More than CAP candidates (ties around t) fall back to the radix
// select. Entries with bit 31 set are never taken. scratch: this warp's 2
// CAP words. Returns the sweeps over the row. Ends with __syncwarp().
template <class Get>
__device__ __forceinline__ int select_row_of(Get get, int n, int k, unsigned p0, unsigned p1,
                                             unsigned* scratch, int* list) {
  if (k > POOL) return radix_select(get, n, k, scratch, list);
  const unsigned t = kth_of_pool(p0, p1, k);
  int cnt = 0;
  sweep(get, 0, n, t, cnt, scratch, scratch + CAP);
  __syncwarp();
  if (cnt > CAP) return 1 + radix_select(get, n, k, scratch, list);
  rank_candidates(cnt, k, scratch, scratch + CAP, list);
  return 1;
}

// select_row_of over a row held in shared memory.
__device__ __forceinline__ int select_row(const unsigned* dr, int n, int k, unsigned p0,
                                          unsigned p1, unsigned* scratch, int* list) {
  return select_row_of([dr](int j) { return dr[j]; }, n, k, p0, p1, scratch, list);
}

// select_row for a query that is itself point `self` of the row (an FPS
// centre; sa_group, B9): the self entry gets all-ones bits, which the
// selection never takes, so the k - 1 nearest OTHER points are taken,
// ascending, into list[0..); p0, p1 must be entries other than self.
// Returns how many were taken, min(k, n) - 1: the caller puts the centre in
// slot 0 (through its index, whatever its rounded distance) and pads slots
// past n. Entries of dr are non-negative f32 bit patterns.
__device__ __forceinline__ int select_row_pinned(unsigned* dr, int n, int k, int self,
                                                 unsigned p0, unsigned p1, unsigned* scratch,
                                                 int* list) {
  if ((threadIdx.x & 31) == 0) dr[self] = FULL;
  __syncwarp();
  const int kr = min(k, n) - 1;
  if (kr > 0) select_row(dr, n, kr, p0, p1, scratch, list);
  return kr;
}

// Keep the candidates of value <= t, in order. Ends with __syncwarp().
__device__ __forceinline__ void drop_above(unsigned t, int& cnt, unsigned* cand, unsigned* cval) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  int kept = 0;
  for (int c0 = 0; c0 < cnt; c0 += 32) {
    const int c = c0 + lane;
    const unsigned v = c < cnt ? cval[c] : FULL, j = c < cnt ? cand[c] : 0u;
    const bool keep = c < cnt && v <= t;
    const unsigned kb = __ballot_sync(FULL, keep);
    __syncwarp();  // every lane has read before any writes (writes land at or below reads)
    if (keep) {
      cand[kept + __popc(kb & lt_mask)] = j;
      cval[kept + __popc(kb & lt_mask)] = v;
    }
    kept += __popc(kb);
  }
  cnt = kept;
  __syncwarp();
}

// The chunked walk: the exact selection of the block's QR query rows
// row0.. of item xi over its n points, CHUNK columns at a time (the rows of a
// chunk in s.dist; s carved with rows = RPW), then emit(r, gr, list) for
// each live row r (point gr = row0 + r) of the calling warp (one pass with a
// falling threshold, header; for k > POOL no such pass: every row takes the
// radix select over the chunks). Every thread of the block must call it.
template <int KS, class Emit>
__device__ __forceinline__ void select_chunked(const bf16* __restrict__ xi, int ldx, int cq,
                                               int n, int k, int row0, const Smem& s,
                                               Emit emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_queries(xi, ldx, cq, n, row0, s);
  const Queries a = queries(cq, s);
  Pool2 m;
  int cnt[RPW];
  bool fall[RPW];
  unsigned* cand[RPW];
  int* list[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    cand[i] = s.scratch + (warp * RPW + i) * 2 * CAP;
    list[i] = list_at(s.sel + (warp * RPW + i) * POOL, cand[i], k);
    cnt[i] = 0;
    fall[i] = k > POOL && row0 + warp * RPW + i < n;  // past the pool: the radix select
  }
  const int r0 = warp * RPW;
  auto row_of = [&](int i, int c0) {
    const unsigned* dr = reinterpret_cast<const unsigned*>(s.dist + (r0 + i) * s.ldd);
    return [dr, c0](int j) { return dr[j - c0]; };
  };
  for (int c0 = 0; c0 < (k > POOL ? 0 : n); c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, n);
    tiles<KS, true, true>(xi, ldx, cq, n, c0, c1, s, a, m);
    write_pool(m, s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (row0 + r0 + i >= n || fall[i]) continue;
      // the pool of the chunks so far: t falls
      const unsigned t =
          kth_of_pool(s.pool[(r0 + i) * POOL + lane], s.pool[(r0 + i) * POOL + 32 + lane], k);
      drop_above(t, cnt[i], cand[i], cand[i] + CAP);
      sweep(row_of(i, c0), c0, c1, t, cnt[i], cand[i], cand[i] + CAP);
      fall[i] = cnt[i] > CAP;
      __syncwarp();
    }
    __syncthreads();
  }
  bool mine = false;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (row0 + r0 + i >= n) continue;
    if (!fall[i]) rank_candidates(cnt[i], k, cand[i], cand[i] + CAP, list[i]);
    mine |= fall[i];
  }
  if (__syncthreads_or(mine)) {
    // crowded ties, or k past the pool: the radix select, each digit pass
    // and the admit pass a walk over the chunks, recomputed; a row's
    // histogram is its candidates' words
    Radix rs[RPW];
    bool active[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      rs[i].need = k;
      active[i] = fall[i];
    }
    auto any_active = [&] {
      bool any = false;
#pragma unroll
      for (int i = 0; i < RPW; ++i) any |= active[i];
      return any;
    };
    while (__syncthreads_or(any_active())) {
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (active[i]) radix_clear(cand[i]);
      for (int c0 = 0; c0 < n; c0 += CHUNK) {
        const int c1 = min(c0 + CHUNK, n);
        tiles<KS, true, false>(xi, ldx, cq, n, c0, c1, s, a, m);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          if (active[i]) radix_count(rs[i], row_of(i, c0), c0, c1, cand[i]);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (active[i]) active[i] = !radix_pick(rs[i], cand[i]);
    }
    int nsel[RPW];
    unsigned nties[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) nsel[i] = 0, nties[i] = 0u;
    for (int c0 = 0; c0 < n; c0 += CHUNK) {
      const int c1 = min(c0 + CHUNK, n);
      tiles<KS, true, false>(xi, ldx, cq, n, c0, c1, s, a, m);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (fall[i]) radix_admit(rs[i], row_of(i, c0), c0, c1, k, nsel[i], nties[i], list[i]);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (row0 + r0 + i >= n) break;
    emit(r0 + i, row0 + r0 + i, list[i]);
  }
}

}  // namespace knn
}  // namespace
