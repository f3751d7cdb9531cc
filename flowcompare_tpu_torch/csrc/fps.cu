// fps: batch farthest-point sampling over up to four chained levels in one
// launch, the port of the Pallas kernel fps_pallas
// (flowcompare_tpu/ops/fps_pallas.py:99, body :46-95) as PAConv's four
// set-abstraction levels call it (encoders/paconv.py::_sa_level), and of the
// reference's pointops furthestsampling.
//
// Per level, m greedy picks per item, the first being index 0: each pick
// lowers every point's running minimum of its f32 squared distance to the
// picks so far, d = ((dx*dx + dy*dy) + dz*dz), written with the _rn
// intrinsics so that nvcc does not contract it into FMAs (the plain version
// and the JAX package round after every operation), and the next pick is the
// first index of the largest minimum (jnp.argmax / torch.argmax). Level l + 1
// samples the points level l picked, in pick order; every level's indices
// (int64) and coordinates (f32) are written.
//
// Design: one block of T = FPS_THREADS threads owns one item through all its
// levels (128: the fastest of 128, 256 and 512 on the H100, PERF.md). The
// level's cloud lives in shared memory (x, y, z arrays) for the broadcast of
// each pick's coordinates and as the next level's input; each thread keeps
// its points and their running minima in registers (points t, t + T, ...:
// exactly ceil(n / T) of them, the level's count chosen among compiled ones; past
// 2,048 points a block the rest stay in shared memory), so a pick's sweep
// reads no memory. Per pick:
//   - each thread's first maximum over its points (strict >, index order);
//   - the warp's argmax in two redux.sync: __reduce_max_sync over the minima's
//     f32 bits (non-negative floats order like their bits), then
//     __reduce_min_sync over the indices of the lanes that hold the maximum:
//     the first-index tie-break stays exact;
//   - each warp's winner as one 64-bit key (value bits, then the complement
//     of the index) into a slot of a double buffer chosen by the pick's
//     parity, one block barrier, and every thread takes the largest key
//     itself: one barrier a pick. A warp may run a pick ahead into the other
//     buffer, never two: the next write to a buffer comes after the next
//     barrier, which every reader of that buffer has passed.
// Bounded on the H100 by the dependent chain of sum(m) - levels
// picks, each a sweep, the reductions and the barrier, not by bytes or
// operations.
//
// Clouds whose level clouds and minima pass shared memory (12,662 points
// over PAConv's four levels) take fps_levels_big_kernel, still one launch
// and one block a cloud: FPS_BIG_THREADS = 512 threads hold up to 8,192
// points and their minima in registers (16 a thread), the next points as
// (x, y, z, min) in shared memory (up to 14,336: 16,384-point clouds stay on
// chip) and the rest in a global scratch the wrapper allocates (L2-resident:
// 16 bytes a point). Thread g still holds points g, g + T, ... in scan
// order, so its first maximum and the reductions are the small kernel's.
// The level clouds stay in device memory (level 0 the input, level l + 1
// the coordinates level l wrote, visible to the block after its barrier),
// and each warp's winner writes its point's coordinates beside its key, so
// a pick reads no cloud: the next centre comes from the winning slot.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int FPS_MAX_LEVELS = 4;
constexpr int FPS_THREADS = 128;
constexpr int FPS_NW = FPS_THREADS / 32;
constexpr int FPS_POINTS = 2048;  // points a block holds in registers at most
constexpr unsigned FULL = 0xffffffffu;
constexpr int FPS_SMEM_OPTIN = 227 * 1024;  // dynamic shared memory a block may opt into

struct FpsLevels {
  const float* xyz;  // (items, n, 3)
  int n, levels;
  int m[FPS_MAX_LEVELS];
  long long* idx[FPS_MAX_LEVELS];  // (items, m)
  float* out[FPS_MAX_LEVELS];      // (items, m, 3)
  int size[2];                     // points of the two level buffers
};

__device__ __forceinline__ float sqdist(float px, float py, float pz, float cx, float cy,
                                        float cz) {
  const float dx = __fsub_rn(px, cx), dy = __fsub_rn(py, cy), dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// This thread's first maximum bv at index bi (bi == INT_MAX: no point) to the
// warp's (bits, index) winner, known to every lane.
__device__ __forceinline__ void warp_argmax(float bv, int bi, unsigned& bits, unsigned& index) {
  const unsigned vb = bi == INT_MAX ? 0u : __float_as_uint(bv);
  bits = __reduce_max_sync(FULL, vb);
  index = __reduce_min_sync(FULL, vb == bits ? (unsigned)bi : FULL);
}

// The block's argmax from each warp's winner: one 64-bit key a warp into
// the slots of this pick's parity, one barrier, and the largest of the
// FPS_NW keys, read by every thread.
__device__ __forceinline__ int block_argmax(unsigned bits, unsigned index,
                                            unsigned long long* slots, int& parity) {
  constexpr int NW = FPS_NW;
  unsigned long long* sl = slots + parity * NW;
  if ((threadIdx.x & 31) == 0)
    sl[threadIdx.x >> 5] = ((unsigned long long)bits << 32) | (FULL - index);
  __syncthreads();
  unsigned long long k[NW];
#pragma unroll
  for (int w = 0; w < NW; w += 2) {
    const ulonglong2 k2 = *reinterpret_cast<const ulonglong2*>(sl + w);
    k[w] = k2.x;
    k[w + 1] = k2.y;
  }
#pragma unroll
  for (int step = 1; step < NW; step <<= 1)  // a tree: log2(NW) dependent maxima
#pragma unroll
    for (int w = 0; w + step < NW; w += 2 * step) k[w] = max(k[w], k[w + step]);
  parity ^= 1;
  return (int)(FULL - (unsigned)k[0]);
}

// One level sampled by the block, PER points a thread in registers (the
// rest in shared memory): the cloud in cur (x, y, z arrays of stride s), its
// n points, m picks. Thread 0 writes the outputs and the next level's cloud.
template <int PER>
__device__ __forceinline__ void fps_level(const float* cur, int s, int n, int m,
                                          long long* oidx, float* oxyz, float* nxt, int sn,
                                          float* spill, unsigned long long* slots,
                                          int& parity) {
  constexpr int NT = FPS_THREADS;
  const int g = threadIdx.x;
  const float* cx_ = cur;
  const float* cy_ = cur + s;
  const float* cz_ = cur + 2 * s;
  // a slot past n holds a minimum of -inf, which never wins: the sweep below
  // runs without a branch
  float px[PER], py[PER], pz[PER], md[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int j = g + NT * r;
    const bool v = j < n;
    px[r] = v ? cx_[j] : 0.f;
    py[r] = v ? cy_[j] : 0.f;
    pz[r] = v ? cz_[j] : 0.f;
    md[r] = v ? INFINITY : -INFINITY;
  }
  for (int j = g + NT * PER; j < n; j += NT) spill[j - NT * PER] = INFINITY;
  int far = 0;
  for (int i = 0; i < m; ++i) {
    const float cx = cx_[far], cy = cy_[far], cz = cz_[far];
    if (g == 0) {
      oidx[i] = far;
      oxyz[3 * i] = cx;
      oxyz[3 * i + 1] = cy;
      oxyz[3 * i + 2] = cz;
      if (nxt != nullptr) {
        nxt[i] = cx;
        nxt[sn + i] = cy;
        nxt[2 * sn + i] = cz;
      }
    }
    if (i == m - 1) break;
    float bv = -1.f;
    int bi = INT_MAX;
#pragma unroll
    for (int r = 0; r < PER; ++r) md[r] = fminf(md[r], sqdist(px[r], py[r], pz[r], cx, cy, cz));
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      if (md[r] > bv) {
        bv = md[r];
        bi = g + NT * r;
      }
    }
    for (int j = g + NT * PER; j < n; j += NT) {
      float* mj = spill + (j - NT * PER);
      const float v = fminf(*mj, sqdist(cx_[j], cy_[j], cz_[j], cx, cy, cz));
      *mj = v;
      if (v > bv) {
        bv = v;
        bi = j;
      }
    }
    unsigned bits, index;
    warp_argmax(bv, bi, bits, index);
    far = block_argmax(bits, index, slots, parity);
  }
}

// fps_level with the first of P, REST... that holds ceil(n / FPS_THREADS)
// points a thread (the last takes the rest in shared memory).
template <int P, int... REST>
__device__ __forceinline__ void fps_level_per(int per, const float* cur, int s, int n, int m,
                                              long long* oidx, float* oxyz, float* nxt, int sn,
                                              float* spill, unsigned long long* slots,
                                              int& parity) {
  if constexpr (sizeof...(REST) == 0) {
    static_assert(P * FPS_THREADS >= FPS_POINTS, "the last count holds FPS_POINTS a block");
    fps_level<P>(cur, s, n, m, oidx, oxyz, nxt, sn, spill, slots, parity);
  } else {
    if (per <= P)
      fps_level<P>(cur, s, n, m, oidx, oxyz, nxt, sn, spill, slots, parity);
    else
      fps_level_per<REST...>(per, cur, s, n, m, oidx, oxyz, nxt, sn, spill, slots, parity);
  }
}

__global__ void __launch_bounds__(FPS_THREADS) fps_levels_kernel(FpsLevels a) {
  constexpr int T = FPS_THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(smem);
  float* const buf0 = reinterpret_cast<float*>(slots + 2 * FPS_NW);
  float* const buf1 = buf0 + 3 * a.size[0];
  float* const spill = buf1 + 3 * a.size[1];

  const int item = blockIdx.x;
  const float* x = a.xyz + (size_t)item * a.n * 3;
  for (int e = threadIdx.x; e < 3 * a.n; e += T) buf0[(e % 3) * a.size[0] + e / 3] = x[e];
  __syncthreads();

  int parity = 0, n = a.n;
  for (int l = 0; l < a.levels; ++l) {
    const float* cur = (l & 1) ? buf1 : buf0;
    float* nxt = l + 1 == a.levels ? nullptr : ((l & 1) ? buf0 : buf1);
    const int m = a.m[l], s = a.size[l & 1], sn = a.size[(l + 1) & 1];
    long long* oidx = a.idx[l] + (size_t)item * m;
    float* oxyz = a.out[l] + (size_t)item * m * 3;
    const int per = (n + T - 1) / T;
    fps_level_per<1, 2, 3, 4, 5, 6, 8, 10, 12, 16>(per, cur, s, n, m, oidx, oxyz, nxt, sn, spill,
                                                   slots, parity);
    __syncthreads();
    n = m;
  }
}

constexpr int FPS_BIG_THREADS = 512;
constexpr int FPS_BIG_NW = FPS_BIG_THREADS / 32;
constexpr int FPS_BIG_PER = 16;  // points a thread holds in registers at most
constexpr int FPS_BIG_SLOTS = 2 * FPS_BIG_NW * (sizeof(unsigned long long) + sizeof(float4));
// (x, y, z, min) points in shared memory at most, a whole number of rounds of
// the block's threads
constexpr int FPS_BIG_TIER =
    ((FPS_SMEM_OPTIN - FPS_BIG_SLOTS) / (int)sizeof(float4)) / FPS_BIG_THREADS * FPS_BIG_THREADS;

// Point j of a tier (shared or global memory): fold the pick's distance into
// its minimum and keep the thread's first maximum.
__device__ __forceinline__ void tier_point(float4* t, int j, float cx, float cy, float cz,
                                           float& bv, int& bi, float& bx, float& by,
                                           float& bz) {
  float4 p = *t;
  p.w = fminf(p.w, sqdist(p.x, p.y, p.z, cx, cy, cz));
  t->w = p.w;
  if (p.w > bv) {
    bv = p.w;
    bi = j;
    bx = p.x;
    by = p.y;
    bz = p.z;
  }
}

// One level of a large cloud: src (n, 3) in device memory, PER points a
// thread in registers, then up to FPS_BIG_TIER in the shared tier and the
// rest in the global one (gtier). Thread 0 writes the outputs, which are the
// next level's src. The pick's centre comes back in (cx, cy, cz).
template <int PER>
__device__ __forceinline__ void fps_big_level(const float* src, int n, int m, long long* oidx,
                                              float* oxyz, float4* stier, float4* gtier,
                                              unsigned long long* keys, float4* wxyz,
                                              int& parity) {
  constexpr int NT = FPS_BIG_THREADS, NW = FPS_BIG_NW;
  const int g = threadIdx.x, lane = g & 31, warp = g >> 5;
  const int reg = NT * PER, shared_end = min(n, reg + FPS_BIG_TIER);
  float px[PER], py[PER], pz[PER], md[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int j = g + NT * r;
    const bool v = j < n;
    px[r] = v ? src[3 * j] : 0.f;
    py[r] = v ? src[3 * j + 1] : 0.f;
    pz[r] = v ? src[3 * j + 2] : 0.f;
    md[r] = v ? INFINITY : -INFINITY;
  }
  // the tiers: thread g's points reg + g + NT s, only ever touched by thread g
  for (int j = reg + g; j < n; j += NT) {
    const float4 p = make_float4(src[3 * j], src[3 * j + 1], src[3 * j + 2], INFINITY);
    if (j < shared_end) stier[j - reg] = p;
    else gtier[j - shared_end] = p;
  }
  float cx = src[0], cy = src[1], cz = src[2];
  int far = 0;
  for (int i = 0; i < m; ++i) {
    if (g == 0) {
      oidx[i] = far;
      oxyz[3 * i] = cx;
      oxyz[3 * i + 1] = cy;
      oxyz[3 * i + 2] = cz;
    }
    if (i == m - 1) break;
    float bv = -1.f, bx = 0.f, by = 0.f, bz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int r = 0; r < PER; ++r) md[r] = fminf(md[r], sqdist(px[r], py[r], pz[r], cx, cy, cz));
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      if (md[r] > bv) {
        bv = md[r];
        bi = g + NT * r;
        bx = px[r];
        by = py[r];
        bz = pz[r];
      }
    }
    for (int j = reg + g; j < shared_end; j += NT)
      tier_point(stier + (j - reg), j, cx, cy, cz, bv, bi, bx, by, bz);
    for (int j = shared_end + g; j < n; j += NT)
      tier_point(gtier + (j - shared_end), j, cx, cy, cz, bv, bi, bx, by, bz);
    unsigned bits, index;
    warp_argmax(bv, bi, bits, index);
    // the warp's winner: its key and its point's coordinates
    unsigned long long* kl = keys + parity * NW;
    float4* wl = wxyz + parity * NW;
    const unsigned who = __ballot_sync(FULL, bi == (int)index);
    if (lane == __ffs(who) - 1) {
      kl[warp] = ((unsigned long long)bits << 32) | (FULL - index);
      wl[warp] = make_float4(bx, by, bz, 0.f);
    }
    __syncthreads();
    unsigned long long k[NW];
#pragma unroll
    for (int w = 0; w < NW; w += 2) {
      const ulonglong2 k2 = *reinterpret_cast<const ulonglong2*>(kl + w);
      k[w] = k2.x;
      k[w + 1] = k2.y;
    }
#pragma unroll
    for (int step = 1; step < NW; step <<= 1)
#pragma unroll
      for (int w = 0; w + step < NW; w += 2 * step) k[w] = max(k[w], k[w + step]);
    far = (int)(FULL - (unsigned)k[0]);
    const float4 c = wl[(far & (NT - 1)) >> 5];  // thread far % NT holds point far
    cx = c.x;
    cy = c.y;
    cz = c.z;
    parity ^= 1;
  }
}

template <int P, int... REST>
__device__ __forceinline__ void fps_big_level_per(int per, const float* src, int n, int m,
                                                  long long* oidx, float* oxyz, float4* stier,
                                                  float4* gtier, unsigned long long* keys,
                                                  float4* wxyz, int& parity) {
  if constexpr (sizeof...(REST) == 0) {
    fps_big_level<P>(src, n, m, oidx, oxyz, stier, gtier, keys, wxyz, parity);
  } else {
    if (per <= P)
      fps_big_level<P>(src, n, m, oidx, oxyz, stier, gtier, keys, wxyz, parity);
    else
      fps_big_level_per<REST...>(per, src, n, m, oidx, oxyz, stier, gtier, keys, wxyz, parity);
  }
}

// One block a cloud of any size; gtier holds `spill` points a cloud.
__global__ void __launch_bounds__(FPS_BIG_THREADS, 1)
    fps_levels_big_kernel(FpsLevels a, float4* gtier, long long spill) {
  constexpr int T = FPS_BIG_THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float4* wxyz = reinterpret_cast<float4*>(keys + 2 * FPS_BIG_NW);
  float4* stier = wxyz + 2 * FPS_BIG_NW;
  const int item = blockIdx.x;
  float4* gt = gtier + (size_t)item * spill;
  const float* src = a.xyz + (size_t)item * a.n * 3;
  int parity = 0, n = a.n;
  for (int l = 0; l < a.levels; ++l) {
    const int m = a.m[l];
    long long* oidx = a.idx[l] + (size_t)item * m;
    float* oxyz = a.out[l] + (size_t)item * m * 3;
    const int per = (n + T - 1) / T;
    fps_big_level_per<1, 2, 4, 8, FPS_BIG_PER>(per, src, n, m, oidx, oxyz, stier, gt, keys,
                                               wxyz, parity);
    __syncthreads();  // the level's outputs, the next level's cloud, are written
    src = oxyz;
    n = m;
  }
}

// B8's dependent-chain floor: rounds of one pick's reductions without its
// sweep (the warp argmax in two redux.sync, the slot write, the barrier and
// the keys' read, as fps_level runs them), each round's pick feeding the
// next; timed over many rounds it gives the latency of one round.
__global__ void __launch_bounds__(FPS_THREADS) fps_round_probe_kernel(int rounds, int* out) {
  __shared__ __align__(16) unsigned long long slots[2 * FPS_NW];
  int parity = 0, far = threadIdx.x;
  for (int i = 0; i < rounds; ++i) {
    const float v = __uint_as_float(((unsigned)(far + threadIdx.x) * 2654435761u) >> 9);
    unsigned bits, index;
    warp_argmax(v, (int)threadIdx.x, bits, index);
    far = block_argmax(bits, index, slots, parity);
  }
  if (threadIdx.x == 0) *out = far;
}

// The level buffers' sizes and the spilled minima of a launch: shared
// memory in bytes, or -1 for arguments it does not take.
size_t plan(FpsLevels& a) {
  int n = a.n, spill = 0;
  a.size[0] = a.size[1] = 1;
  for (int l = 0; l < a.levels; ++l) {
    if (n < 1 || a.m[l] < 1) return (size_t)-1;
    a.size[l & 1] = max(a.size[l & 1], n);
    spill = max(spill, n - FPS_POINTS);
    n = a.m[l];
  }
  return sizeof(unsigned long long) * 2 * FPS_NW +
         sizeof(float) * (3 * (size_t)(a.size[0] + a.size[1]) + spill);
}

// The large clouds' kernel: its shared memory in bytes and its global tier's
// points a cloud (the most any level spills past registers and the shared
// tier).
size_t plan_big(const FpsLevels& a, long long& spill) {
  constexpr long long REG = (long long)FPS_BIG_THREADS * FPS_BIG_PER;
  long long tier = 0;
  int n = a.n;
  spill = 0;
  for (int l = 0; l < a.levels; ++l) {
    tier = std::max(tier, std::min<long long>(std::max(0LL, n - REG), FPS_BIG_TIER));
    spill = std::max(spill, n - REG - FPS_BIG_TIER);
    n = a.m[l];
  }
  return FPS_BIG_SLOTS + sizeof(float4) * (size_t)tier;
}

FpsLevels make_args(const void* xyz, int n, int levels, const int* ms, void* const* idx,
                    void* const* out) {
  FpsLevels a = {};
  a.xyz = (const float*)xyz;
  a.n = n;
  a.levels = levels;
  for (int l = 0; l < levels; ++l) {
    a.m[l] = ms[l];
    a.idx[l] = (long long*)idx[l];
    a.out[l] = (float*)out[l];
  }
  return a;
}

}  // namespace

// Shared memory of a launch in bytes (-1: arguments it does not take):
// the small kernel's where it fits, else the large clouds' kernel's.
FC_API int fc_fps_levels_smem(int n, int levels, int m0, int m1, int m2, int m3) {
  if (levels < 1 || levels > FPS_MAX_LEVELS) return -1;
  const int ms[4] = {m0, m1, m2, m3};
  void* none[4] = {nullptr, nullptr, nullptr, nullptr};
  FpsLevels a = make_args(nullptr, n, levels, ms, none, none);
  const size_t smem = plan(a);
  if (smem == (size_t)-1) return -1;
  if (smem <= (size_t)FPS_SMEM_OPTIN) return (int)smem;
  long long spill;
  return (int)plan_big(a, spill);
}

// Points of global scratch (x, y, z, min: 16 bytes each) a cloud: 0 where
// the small kernel runs, else the large clouds' kernel's global tier (-1:
// arguments it does not take).
FC_API int fc_fps_levels_spill(int n, int levels, int m0, int m1, int m2, int m3) {
  if (levels < 1 || levels > FPS_MAX_LEVELS) return -1;
  const int ms[4] = {m0, m1, m2, m3};
  void* none[4] = {nullptr, nullptr, nullptr, nullptr};
  FpsLevels a = make_args(nullptr, n, levels, ms, none, none);
  const size_t smem = plan(a);
  if (smem == (size_t)-1) return -1;
  if (smem <= (size_t)FPS_SMEM_OPTIN) return 0;
  long long spill;
  plan_big(a, spill);
  return (int)std::max(0LL, spill);
}

// Threads a block of the kernel a launch runs (-1: arguments it does not take).
FC_API int fc_fps_levels_threads(int n, int levels, int m0, int m1, int m2, int m3) {
  if (levels < 1 || levels > FPS_MAX_LEVELS) return -1;
  const int ms[4] = {m0, m1, m2, m3};
  void* none[4] = {nullptr, nullptr, nullptr, nullptr};
  FpsLevels a = make_args(nullptr, n, levels, ms, none, none);
  const size_t smem = plan(a);
  if (smem == (size_t)-1) return -1;
  return smem <= (size_t)FPS_SMEM_OPTIN ? FPS_THREADS : FPS_BIG_THREADS;
}

// xyz (items, n, 3) f32 -> per level l < levels: idx_l (items, m_l) int64
// and out_l (items, m_l, 3) f32, level l + 1 sampling out_l; scratch holds
// fc_fps_levels_spill points of 16 bytes a cloud (unused, and may be null,
// where that is 0).
FC_API int fc_fps_levels(const void* xyz, int items, int n, int levels, int m0, int m1, int m2,
                         int m3, void* idx0, void* idx1, void* idx2, void* idx3, void* out0,
                         void* out1, void* out2, void* out3, void* scratch, void* stream) {
  if (items < 1 || levels < 1 || levels > FPS_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const int ms[4] = {m0, m1, m2, m3};
  void* idx[4] = {idx0, idx1, idx2, idx3};
  void* out[4] = {out0, out1, out2, out3};
  FpsLevels a = make_args(xyz, n, levels, ms, idx, out);
  size_t smem = plan(a);
  if (smem == (size_t)-1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem <= (size_t)FPS_SMEM_OPTIN) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_levels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fps_levels_kernel<<<items, FPS_THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  long long spill;
  smem = plan_big(a, spill);
  if (spill > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fps_levels_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_levels_big_kernel<<<items, FPS_BIG_THREADS, smem, st>>>(a, (float4*)scratch,
                                                              std::max(0LL, spill));
  return (int)cudaGetLastError();
}

// One block running `rounds` rounds of fps_round_probe_kernel.
FC_API int fc_fps_round_probe(int rounds, void* out, void* stream) {
  fps_round_probe_kernel<<<1, FPS_THREADS, 0, (cudaStream_t)stream>>>(rounds, (int*)out);
  return (int)cudaGetLastError();
}
