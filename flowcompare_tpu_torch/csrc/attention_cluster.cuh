// What the cluster tier of the attention kernels shares
// (cross_attention_cluster.cu, cross_attention_bwd_cluster.cu,
// attention_core_cluster.cu): one-head attention at head widths up to
// ATT_CLUSTER_MAX_D = 1,024, where one block can no longer hold a 64-row
// tile of every operand (64 KB of q alone at D = 512; 128 KB of a
// backward block's own two tiles) and recomputing the scores for every
// group of output columns (the *_wide.cu kernels, past D = 128) costs the
// backward 27x its bound at D = 512.
//
// The columns of D are split over the blocks of a thread-block cluster:
//  * one cluster takes one 64-row tile (queries, or keys in the backward's
//    dkv clusters) with G = ceil(D / 128) <= 8 blocks, a portable cluster;
//    block g owns columns [128 g, 128 g + 128) of every operand (boxes 2 g
//    and 2 g + 1 of attention_wgmma.cuh's 64 x 64 boxes; the last block's
//    columns past D are TMA's zero fill, and where D / 64 rounds up odd
//    it owns one box). It keeps its own slice resident and streams the
//    other side's boxes of its columns through a ring of 8 KB stages;
//  * each score tile is summed across the cluster: every block forms its
//    partial S_g over its own columns in a fresh wgmma accumulator and
//    stores it in its exchange buffer, in fragment order (element i of
//    thread t at i * 128 + t). After a cluster barrier, block g sums chunk
//    g of every block's partial over distributed shared memory (mapa /
//    ld.shared::cluster) in the fixed order g' = 0 .. G-1 and writes the sum
//    back into chunk g of every block's buffer (a reduce-scatter, then an
//    all-gather: each block reads and writes 16 KB a tile where reading
//    every partial whole would read G x 16 KB). Chunk g of any buffer is
//    touched by block g alone between the two barriers, so the sum lands
//    in place. After a second barrier every block holds the same scores,
//    bit for bit, and reads them back from its own buffer;
//  * the partials are the wide kernels' own: 128 columns in a fresh
//    accumulator, summed in f32 in column order. So at D = 512 the cluster
//    forward and B10 give the wide kernels' outputs bit for bit
//    (ring_abt: s = P0, s += P1, ...);
//  * a block is one consumer warpgroup of 128 threads and no producer warp:
//    every thread takes part in the cluster barriers. Thread 0 issues the
//    TMA loads, refilling a stage as soon as the four warps hand it back
//    (`ClusterRing`);
//  * the last remote access of a kernel is followed by a cluster barrier
//    (`cluster_sync` at its end), so no block's shared memory goes away
//    while a neighbour may still read it.
//
// Launch: cudaLaunchKernelEx with a cluster dimension of G along x; the
// first launch of each kernel at each G checks cudaOccupancyMaxActiveClusters
// > 0 and returns cudaErrorInvalidConfiguration otherwise (the wrapper
// raises: no other kernel stands in).
#pragma once

#include <utility>

#include "attention_wgmma.cuh"

namespace {

constexpr int ATT_CLUSTER_MAX_D = 1024;   // the widest head the cluster tier takes
constexpr int CL_THREADS = 128;           // one consumer warpgroup a block
constexpr int CL_BOXES = 2;               // 64-column boxes of D a block owns
constexpr int CL_MAX_BLOCKS = ATT_CLUSTER_MAX_D / (CL_BOXES * ATT_BOX);   // 8: portable
constexpr int CL_TILE_FLOATS = ATT_TILE * ATT_TILE;   // one 64 x 64 f32 score tile

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}

// Every thread of every block of the cluster: this thread's earlier
// shared-memory writes (local and remote) become visible to every thread
// that passes the barrier after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// The address of the same shared-memory offset in block `rank`'s shared
// memory, in the cluster's window.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// This thread's 64 x 64 accumulator into / out of an exchange tile, in
// fragment order: conflict-free, and the same index in every block.
__device__ __forceinline__ void put_frag(float* buf, const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) buf[i * CL_THREADS + threadIdx.x] = s[i];
}
__device__ __forceinline__ void get_frag(const float* buf, float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = buf[i * CL_THREADS + threadIdx.x];
}

// Sums the first n4 float4s of every block's exchange buffer `buf` (each
// block's partials, already stored) into every block's buffer, in the
// order of the blocks' ranks: the reduce-scatter and all-gather above,
// between two cluster barriers.
__device__ __forceinline__ void cluster_sum(float* buf, int rank, int blocks, int n4) {
  cluster_sync();   // every partial stored
  const int chunk = (n4 + blocks - 1) / blocks;
  const int lo = rank * chunk, hi = min(n4, lo + chunk);
  const uint32_t base = smem_u32(buf);
  for (int i = lo + (int)threadIdx.x; i < hi; i += CL_THREADS) {
    const uint32_t off = base + i * 16;
    // every block's partial in flight at once, then summed in rank order
    float4 p[CL_MAX_BLOCKS];
#pragma unroll
    for (int h = 0; h < CL_MAX_BLOCKS; ++h)
      if (h < blocks) p[h] = ld_cluster(cluster_addr(off, h));
    float4 acc = p[0];
#pragma unroll
    for (int h = 1; h < CL_MAX_BLOCKS; ++h)
      if (h < blocks) {
        acc.x += p[h].x;
        acc.y += p[h].y;
        acc.z += p[h].z;
        acc.w += p[h].w;
      }
#pragma unroll
    for (int h = 0; h < CL_MAX_BLOCKS; ++h)
      if (h < blocks) st_cluster(cluster_addr(off, h), acc);
  }
  cluster_sync();   // every sum in place
}

// A ring of STAGES 8 KB stages filled by thread 0 in the order of a
// schedule: `Loads` gives `has(u)` (whether use u exists) and loads use u's
// box into a stage (`load(u, dst, bar)`). Uses are consumed and handed back
// in order; a stage is refilled with use u + STAGES once its four warps
// have handed use u back.
template <int STAGES>
struct ClusterRing {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int it = 0;   // the next use to consume

  __device__ __forceinline__ const uint8_t* stage(int i) const {
    return base + ((it + i) % STAGES) * ATT_BOX_BYTES;
  }
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(&full[(it + i) % STAGES], ring_parity(it + i, STAGES));
  }
  template <class Loads>
  __device__ __forceinline__ void issue(int u, const Loads& loads) const {
    if (!loads.has(u)) return;
    const int s = u % STAGES;
    mbar_wait(&empty[s], ring_parity(u, STAGES) ^ 1);
    mbar_expect_tx(&full[s], ATT_BOX_BYTES);
    loads.load(u, base + s * ATT_BOX_BYTES, &full[s]);
  }
  // the first STAGES uses (thread 0)
  template <class Loads>
  __device__ __forceinline__ void fill(const Loads& loads) const {
    for (int u = 0; u < STAGES; ++u) issue(u, loads);
  }
  // hands the next n uses back (every thread, after its products on them
  // completed) and refills their stages
  template <class Loads>
  __device__ __forceinline__ void advance(int n, const Loads& loads) {
    for (int i = 0; i < n; ++i) release_stage(&empty[(it + i) % STAGES]);
    if (threadIdx.x == 0)
      for (int i = 0; i < n; ++i) issue(it + i + STAGES, loads);
    __syncwarp();
    it += n;
  }
};

// The forward kernels' schedule (cross_attention_cluster.cu,
// attention_core_cluster.cu) for a block owning boxes g0 .. g0 + nob - 1:
// pass 1 each key tile's K boxes; pass 2 in rounds of `round` key tiles
// (the last one shorter), each round's K boxes tile by tile, then its V
// boxes tile by tile.
struct ForwardLoads {
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  int g0, nob, n_tiles, item, round;
  __device__ __forceinline__ bool has(int u) const { return u < 3 * n_tiles * nob; }
  __device__ __forceinline__ void load(int u, uint8_t* dst, uint64_t* bar) const {
    const int p1 = n_tiles * nob;
    if (u < p1) {
      tma_load_3d(dst, tk, bar, (g0 + u % nob) * ATT_BOX, (u / nob) * ATT_TILE, item);
      return;
    }
    u -= p1;
    const int per = 2 * round * nob;   // the uses of a whole round
    const int t0 = (u / per) * round, nt = min(round, n_tiles - t0);
    int w = u % per;
    const bool v = w >= nt * nob;
    if (v) w -= nt * nob;
    tma_load_3d(dst, v ? tv : tk, bar, (g0 + w % nob) * ATT_BOX, (t0 + w / nob) * ATT_TILE,
                item);
  }
};

// The block's partial of the scores, s = A B^T over its nob boxes (A's box x
// resident at a + x * 8 KB, B's the ring's next nob stages), in one fresh
// accumulator; the stages stay the caller's.
template <int STAGES>
__device__ __forceinline__ void partial_abt(float (&s)[32], const uint8_t* a,
                                            const ClusterRing<STAGES>& ring, int first, int nob) {
#pragma unroll
  for (int x = 0; x < CL_BOXES; ++x)
    if (x < nob) ring.wait(first + x);
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < CL_BOXES; ++x)
    if (x < nob) box_abt(s, a + x * ATT_BOX_BYTES, ring.stage(first + x), x == 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
}

}  // namespace

// The cluster-dimension launch of `kernel` on a grid whose x is a multiple
// of `blocks`, with `smem` bytes of dynamic shared memory: the opt-in and
// the occupancy check once for each kernel and cluster size (`checked`,
// indexed by the size), then cudaLaunchKernelEx; returns its error.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), bool (&checked)[CL_MAX_BLOCKS + 1], dim3 grid,
                   int blocks, int smem, cudaStream_t stream, Args&&... args) {
  if (blocks < 1 || blocks > CL_MAX_BLOCKS || grid.x % blocks) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!checked[blocks]) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    checked[blocks] = true;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The blocks of a cluster at head width d: one a 128 columns.
inline int cluster_size(int d) { return (d + CL_BOXES * ATT_BOX - 1) / (CL_BOXES * ATT_BOX); }
