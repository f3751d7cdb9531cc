// sa_group: PAConv set-abstraction grouping as two kernels, the port of the
// Pallas kernel sa_group_fused (flowcompare_tpu/ops/sa_group_pallas.py:126,
// body :54-122) and of the reference's knnquery_heap + grouping pair.
//
// For each item and each FPS centre c (a point of the item, index idx):
//   1. d_j = max(|c|^2 - 2 c.x_j + |x_j|^2, 0) in f32 over the item's n
//      points (the expansion of pairwise_sqdist, clamped as the Pallas
//      kernel's _knn_select_ranks clamps);
//   2. slot 0 is the centre itself, through idx and not through its
//      distance; slots 1..k-1 are the k - 1 nearest other points, exact, the
//      ties at the k-th distance taken in index order, written in ascending
//      index order (select_row_pinned of knn_select.cuh);
//   3. when k > n the slots past n hold point 0 (k <= 256: past the pool's
//      64 the selection is the radix select alone);
//   4. out[b, m, s] = [x_p - c (f32, then rounded to nearest even in the
//      output dtype) | feats_p], p the point of slot s.
// A centre index outside [0, n) gives a row of NaN (no out-of-range access).
//
// sa_select (steps 1-3): one launch selects for up to four levels, since a
// centre's neighbours depend only on its level's xyz, which farthest-point
// sampling gives for every level at once. The grid holds each level's blocks
// in turn, level 0 first; a block of 8 warps owns 8 rpw consecutive centres
// of one item of one level (rpw rows a warp, chosen by the host so that a
// large level reuses each load of its cloud for more rows and a small one
// spreads over the card). The item's points (x, y, z, |x|^2) go to shared
// memory once per block; a warp writes a centre's distance row to shared
// memory, keeping each lane's two nearest others as the selection's pool,
// selects, and writes the k slot indices (int32; slot 0 -1 for a centre
// outside [0, n)). A launch whose largest cloud does not fit that way (past
// 4,458 points) keeps no rows: a warp reads its item's points from global
// memory (L1 and L2 hold them) and recomputes a centre's distances, bit for
// bit, for each sweep: one for the pool, one for the candidates under its
// threshold (and the radix fallback's), so a cloud of any size fits.
//
// sa_gather (step 4): one launch a level, when the level's features exist.
// A warp owns a group of up to 32 consecutive slots of a centre (fewer for
// wide rows: a group's rows fit 2,048 elements, in multiples of 8 rows): it
// assembles the group's rows in a shared tile laid out as the output (the
// xyz diffs a lane per (slot, coordinate); the features a lane per 16-byte
// chunk of a feature row, read as one vector where the row allows it, else a
// lane per element), then writes the tile's contiguous span with 16-byte
// stores, the head and tail that are not 16-byte aligned element by element
// (the tile sits at the destination's alignment mod 16). Features and output
// are bf16 or f32 (templated); coordinates are always f32.
//
// What bounds it on the H100: the output bytes (B M k (3 + C) elements), and
// at these sizes the latency of dependent loads (slot index, then the point's
// row), which the gather's many independent warps hide; the selection's
// sweeps over each distance row in shared memory (one sweep a row after a
// threshold from the lanes' two nearest, the radix select where ties crowd
// it); the distances are 3-deep dot products, negligible.
#include "knn_select.cuh"

namespace {

constexpr int SEL_WARPS = 8;
constexpr int SEL_THREADS = SEL_WARPS * 32;
constexpr int SEL_LEVELS = 4;
constexpr int GA_WARPS = 4;
constexpr int GA_THREADS = GA_WARPS * 32;
constexpr int GA_TILE = 2048;  // elements of a gather group's rows, at least 8 rows

struct SelLevel {
  const float* new_xyz;    // (items, mc, 3)
  const long long* idx;    // (items, mc)
  const float* xyz;        // (items, n, 3)
  int* sel;                // (items, mc, k)
  int n, mc, rpw, blocks;  // blocks: of one item
  int block0;              // the level's first block in the grid
};

struct SelArgs {
  SelLevel lv[SEL_LEVELS];
  int levels, k;
  bool rows;  // the cloud and the distance rows in shared memory (select_rows_fit)
};

// The card's SMs, asked once: they set the selection's rows a warp and the
// gather's grid.
int card_sms() {
  static const int sms = [] {
    int dev = 0, count = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return sms;
}

// Rows a warp selects at a level of mc centres over `items` items: more
// where the level fills the card several times over (each block then loads
// its item's cloud once for more rows).
int select_rows(int items, int mc, int sms) {
  const long long blocks = (long long)items * ((mc + SEL_WARPS - 1) / SEL_WARPS);
  return blocks >= 8LL * sms ? 4 : blocks >= 4LL * sms ? 2 : 1;
}

// The warps' candidates and lists (of knn::POOL: a list past the pool lies
// in the candidates' words, knn::list_at); with rows, the points as float4
// and a distance row a warp before them.
inline size_t select_smem_of(int n, bool rows) {
  const size_t row_bytes = rows ? sizeof(float) * ((size_t)4 * n + (size_t)SEL_WARPS * n) : 0;
  return row_bytes + sizeof(unsigned) * SEL_WARPS * 2 * knn::CAP +
         sizeof(int) * SEL_WARPS * knn::POOL;
}

// Whether clouds of n points fit shared memory with their distance rows (n
// <= 4,458); larger clouds are read from global memory (L1 and L2) and
// their distances recomputed for each sweep.
inline bool select_rows_fit(int n) { return select_smem_of(n, true) <= (size_t)knn::SMEM_OPTIN; }

inline size_t select_smem(int n) { return select_smem_of(n, select_rows_fit(n)); }

// The distance bit pattern of point j of xi (n x 3 f32) to the centre (cx,
// cy, cz) of squared norm cn, clamped to +0: the expansion of the rows'
// path (the norm fmaf(z, z, fmaf(y, y, x x)), the cross term fmaf(cz, z,
// fmaf(cy, y, cx x))), bit for bit.
__device__ __forceinline__ unsigned centre_bits(const float* __restrict__ xi, int j, float cx,
                                                float cy, float cz, float cn) {
  const float x = __ldg(xi + 3 * j), y = __ldg(xi + 3 * j + 1), z = __ldg(xi + 3 * j + 2);
  const float w = fmaf(z, z, fmaf(y, y, x * x));
  const float cross = fmaf(cz, z, fmaf(cy, y, cx * x));
  const float d = (cn - 2.f * cross) + w;
  return __float_as_uint(d > 0.f ? d : 0.f);  // +0, never -0
}

// One centre's slot list with the cloud read from global memory: the pool
// (each lane's two nearest others, lane = j mod 32, as the rows' path keeps
// it) from a first sweep of the recomputed distances (none past the pool's
// k), then knn::select_row_of over the same distances recomputed (the radix
// select recomputes them for each pass too). One warp.
__device__ __forceinline__ void select_centre(const SelLevel& L, int item, int ci, int k,
                                              const float* __restrict__ xi, unsigned* scratch,
                                              int* list) {
  const int lane = threadIdx.x & 31, n = L.n;
  const size_t crow = (size_t)item * L.mc + ci;
  int* sel = L.sel + crow * k;
  const float cx = L.new_xyz[3 * crow], cy = L.new_xyz[3 * crow + 1],
              cz = L.new_xyz[3 * crow + 2];
  const float cn = fmaf(cz, cz, fmaf(cy, cy, cx * cx));
  const long long self_ll = L.idx[crow];
  if (self_ll < 0 || self_ll >= n) {  // not a point of the item: the gather writes NaN
    if (lane == 0) sel[0] = -1;
    return;
  }
  const int self = (int)self_ll;
  // the centre's own entry all ones: never in the pool, never taken
  auto get = [=](int j) { return j == self ? knn::FULL : centre_bits(xi, j, cx, cy, cz, cn); };
  const int taken = min(k, n) - 1;
  unsigned p0 = knn::FULL, p1 = knn::FULL;
  if (taken <= knn::POOL) {
#pragma unroll 4
    for (int j = lane; j < n; j += 32) knn::keep2(p0, p1, get(j));
  }
  if (taken > 0) knn::select_row_of(get, n, taken, p0, p1, scratch, list);
  for (int s = lane; s < k; s += 32) sel[s] = s == 0 ? self : (s <= taken ? list[s - 1] : 0);
  __syncwarp();  // the list serves the warp's next centre
}

__global__ void __launch_bounds__(SEL_THREADS) sa_select_kernel(SelArgs a) {
  SelLevel L = a.lv[0];
#pragma unroll
  for (int q = 1; q < SEL_LEVELS; ++q)
    if (q < a.levels && (int)blockIdx.x >= a.lv[q].block0) L = a.lv[q];
  const int b = blockIdx.x - L.block0;
  const int item = b / L.blocks, blk = b % L.blocks;
  const int n = L.n, k = a.k;

  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xi = L.xyz + (size_t)item * n * 3;
  if (!a.rows) {
    unsigned* scratch = reinterpret_cast<unsigned*>(smem) + warp * 2 * knn::CAP;
    int* own = reinterpret_cast<int*>(reinterpret_cast<unsigned*>(smem) +
                                      SEL_WARPS * 2 * knn::CAP) + warp * knn::POOL;
    int* list = knn::list_at(own, scratch, min(k, L.n) - 1);
    for (int r = 0; r < L.rpw; ++r) {
      const int ci = (blk * L.rpw + r) * SEL_WARPS + warp;
      if (ci >= L.mc) break;
      select_centre(L, item, ci, k, xi, scratch, list);
    }
    return;
  }
  float4* pts = reinterpret_cast<float4*>(smem);
  unsigned* dist = reinterpret_cast<unsigned*>(smem + 4 * (size_t)n);
  unsigned* scratch = dist + (size_t)SEL_WARPS * n;  // 16-byte aligned: n * 48 bytes before
  int* lists = reinterpret_cast<int*>(scratch + SEL_WARPS * 2 * knn::CAP);

  for (int j = threadIdx.x; j < n; j += SEL_THREADS) {
    const float x = xi[3 * j], y = xi[3 * j + 1], z = xi[3 * j + 2];
    pts[j] = make_float4(x, y, z, fmaf(z, z, fmaf(y, y, x * x)));
  }
  __syncthreads();  // no block barrier below

  unsigned* dr = dist + (size_t)warp * n;
  int* list = knn::list_at(lists + warp * knn::POOL, scratch + warp * 2 * knn::CAP,
                           min(k, n) - 1);
  for (int r = 0; r < L.rpw; ++r) {
    const int ci = (blk * L.rpw + r) * SEL_WARPS + warp;
    if (ci >= L.mc) break;
    const size_t crow = (size_t)item * L.mc + ci;
    int* sel = L.sel + crow * k;
    const float cx = L.new_xyz[3 * crow], cy = L.new_xyz[3 * crow + 1],
                cz = L.new_xyz[3 * crow + 2];
    const float cn = fmaf(cz, cz, fmaf(cy, cy, cx * cx));
    const long long self_ll = L.idx[crow];
    if (self_ll < 0 || self_ll >= n) {  // not a point of the item: the gather writes NaN
      if (lane == 0) sel[0] = -1;
      continue;
    }
    const int self = (int)self_ll;
    unsigned p0 = knn::FULL, p1 = knn::FULL;  // this lane's two nearest others: the pool
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      const float4 p = pts[j];
      const float cross = fmaf(cz, p.z, fmaf(cy, p.y, cx * p.x));
      const float d = (cn - 2.f * cross) + p.w;
      const unsigned bits = __float_as_uint(d > 0.f ? d : 0.f);  // +0, never -0
      dr[j] = bits;
      if (j != self) knn::keep2(p0, p1, bits);
    }
    __syncwarp();
    // the distance rows are written
    const int taken = knn::select_row_pinned(dr, n, k, self, p0, p1,
                                             scratch + warp * 2 * knn::CAP, list);
    // the selection is made
    for (int s = lane; s < k; s += 32) sel[s] = s == 0 ? self : (s <= taken ? list[s - 1] : 0);
    __syncwarp();  // the row and the list serve the warp's next centre
  }
}

// Element i (a constant after unrolling) of a 16-byte chunk of T.
template <typename T>
__device__ __forceinline__ T chunk_elem(const uint4& v, int i);
template <>
__device__ __forceinline__ float chunk_elem<float>(const uint4& v, int i) {
  return __uint_as_float(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}
template <>
__device__ __forceinline__ bf16 chunk_elem<bf16>(const uint4& v, int i) {
  const int q = i >> 1;
  const unsigned w = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  return __ushort_as_bfloat16((unsigned short)((i & 1) ? w >> 16 : w & 0xffffu));
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

// Rows of a gather group for output rows of w elements (k = 32: one group of
// 32 rows up to w = 64, 24 + 8 at w = 67, groups of 8 past w = 256; a larger
// k takes more groups of the same rows).
inline int group_rows(int w, int k) {
  const int g = (GA_TILE / w) & ~7;
  return min(k, min(32, max(8, g)));
}

inline size_t tile_bytes(int rows, int w, int esize) {
  return ((size_t)rows * w * esize + 16 + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(GA_THREADS) sa_gather_kernel(
    const int* __restrict__ sel, const float* __restrict__ new_xyz,
    const float* __restrict__ xyz, const T* __restrict__ feats, int c, T* __restrict__ out,
    int n, int mc, int k, int rows_per_group, int groups, long long units, int tile, bool vec) {
  constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char gsmem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = 3 + c;
  unsigned char* tile_raw = gsmem + (size_t)warp * tile;
  int* prow = reinterpret_cast<int*>(gsmem + (size_t)GA_WARPS * tile) + warp * 32;

  for (long long u = (long long)blockIdx.x * GA_WARPS + warp; u < units;
       u += (long long)gridDim.x * GA_WARPS) {
    const long long crow = u / groups;
    const int g0 = (int)(u % groups) * rows_per_group;
    const int rows = min(rows_per_group, k - g0);
    const long long item = crow / mc;
    const int* srow = sel + crow * k;
    T* dst = out + (crow * k + g0) * w;
    const int count = rows * w;
    const int pad = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
    T* t = reinterpret_cast<T*>(tile_raw + pad);  // at the destination's alignment mod 16
    if (srow[0] < 0) {
      for (int e = lane; e < count; e += 32) t[e] = from_f32<T>(__int_as_float(0x7fc00000));
    } else {
      if (lane < rows) prow[lane] = srow[g0 + lane];
      __syncwarp();
      const float* cen = new_xyz + 3 * crow;
      const float* xi = xyz + item * n * 3;
      for (int e = lane; e < rows * 3; e += 32) {
        const int r = e / 3, q = e - 3 * r;
        t[r * w + q] = from_f32<T>(__fsub_rn(xi[3 * prow[r] + q], cen[q]));
      }
      const T* fi = feats + item * n * c;
      if (vec) {  // c a multiple of VE and feats 16-byte aligned
        const int chunks = c / VE;
        for (int e = lane; e < rows * chunks; e += 32) {
          const int r = e / chunks, q = e - chunks * r;
          const uint4 v = *reinterpret_cast<const uint4*>(fi + (size_t)prow[r] * c + q * VE);
          T* o = t + r * w + 3 + q * VE;
#pragma unroll
          for (int i = 0; i < VE; ++i) o[i] = chunk_elem<T>(v, i);
        }
      } else {
        for (int e = lane; e < rows * c; e += 32) {
          const int r = e / c, q = e - c * r;
          t[r * w + 3 + q] = fi[(size_t)prow[r] * c + q];
        }
      }
    }
    __syncwarp();
    // the span: element stores up to dst's first 16-byte boundary, 16-byte
    // stores, element stores for the tail
    const int head = min(count, ((16 - pad) & 15) / (int)sizeof(T));
    const int body = (count - head) / VE;
    if (lane < head) dst[lane] = t[lane];
    const uint4* tv = reinterpret_cast<const uint4*>(t + head);
    uint4* dv = reinterpret_cast<uint4*>(dst + head);
    for (int q = lane; q < body; q += 32) dv[q] = tv[q];
    for (int e = head + body * VE + lane; e < count; e += 32) dst[e] = t[e];
    __syncwarp();  // the tile and prow serve the warp's next group
  }
}

template <typename T>
int launch_gather(const void* sel, const void* new_xyz, const void* xyz, const void* feats, int c,
                  void* out, int items, int n, int mc, int k, cudaStream_t stream) {
  const int w = 3 + c;
  const int rows = group_rows(w, k);
  const int groups = (k + rows - 1) / rows;
  const int tile = (int)tile_bytes(rows, w, sizeof(T));
  const size_t smem = (size_t)GA_WARPS * (tile + 32 * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(sa_gather_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)items * mc * groups;
  const bool vec = c % (16 / (int)sizeof(T)) == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  const long long blocks = min((units + GA_WARPS - 1) / GA_WARPS, 32LL * card_sms());
  sa_gather_kernel<T><<<(unsigned)blocks, GA_THREADS, smem, stream>>>(
      (const int*)sel, (const float*)new_xyz, (const float*)xyz, (const T*)feats, c, (T*)out, n,
      mc, k, rows, groups, units, tile, vec);
  return (int)cudaGetLastError();
}

}  // namespace

FC_API int fc_sa_select_smem(int n) { return (int)select_smem(n); }

// Up to four levels in one launch: level l's centres new_xyz_l (items, mc_l,
// 3) f32 with their indices idx_l (items, mc_l) int64 into xyz_l (items, n_l,
// 3) f32 -> sel_l (items, mc_l, k) int32.
FC_API int fc_sa_select(int levels, int items, int k, const void* const* new_xyz,
                        const void* const* idx, const void* const* xyz, void* const* sel,
                        const int* n, const int* mc, void* stream) {
  if (levels < 1 || levels > SEL_LEVELS || items < 1 || k < 1 || k > knn::MAX_K)
    return (int)cudaErrorInvalidValue;
  SelArgs a = {};
  a.levels = levels;
  a.k = k;
  int blocks = 0, nmax = 1;
  const int sms = card_sms();
  for (int l = 0; l < levels; ++l) {
    if (n[l] < 1 || mc[l] < 1) return (int)cudaErrorInvalidValue;
    SelLevel& L = a.lv[l];
    L.new_xyz = (const float*)new_xyz[l];
    L.idx = (const long long*)idx[l];
    L.xyz = (const float*)xyz[l];
    L.sel = (int*)sel[l];
    L.n = n[l];
    L.mc = mc[l];
    L.rpw = select_rows(items, mc[l], sms);
    L.blocks = (mc[l] + SEL_WARPS * L.rpw - 1) / (SEL_WARPS * L.rpw);
    L.block0 = blocks;
    blocks += items * L.blocks;
    nmax = max(nmax, n[l]);
  }
  a.rows = select_rows_fit(nmax);
  const size_t smem = select_smem(nmax);
  cudaError_t err = cudaFuncSetAttribute(sa_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_select_kernel<<<blocks, SEL_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Shared memory of a gather of rows of 3 + c elements of esize bytes.
FC_API int fc_sa_gather_smem(int c, int k, int esize) {
  const int w = 3 + c;
  return (int)((size_t)GA_WARPS * (tile_bytes(group_rows(w, k), w, esize) + 32 * sizeof(int)));
}

// sel (items, mc, k) int32 from fc_sa_select -> out (items, mc, k, 3 + c)
// in the features' dtype (bf16 or f32).
FC_API int fc_sa_gather(const void* sel, const void* new_xyz, const void* xyz, const void* feats,
                        int c, void* out, int items, int n, int mc, int k, int bf16_feats,
                        void* stream) {
  if (n < 1 || mc < 1 || k < 1 || k > knn::MAX_K || c < 0 || items < 1)
    return (int)cudaErrorInvalidValue;
  if (bf16_feats)
    return launch_gather<bf16>(sel, new_xyz, xyz, feats, c, out, items, n, mc, k,
                               (cudaStream_t)stream);
  return launch_gather<float>(sel, new_xyz, xyz, feats, c, out, items, n, mc, k,
                              (cudaStream_t)stream);
}
