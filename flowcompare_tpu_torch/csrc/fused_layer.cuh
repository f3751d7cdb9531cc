// What the fused layer kernels share: the forward and record kernels of
// fused_layer.cu (B1, B7, B5's recompute) and the backward kernels of
// fused_layer_bwd.cu (B5). A block owns BM = 64 rows; four consumer
// warpgroups each own up to 128 output columns of a product's pass (PASS_W
// = 512 columns; a product wider than that runs in passes); a producer warp
// streams every pass's weights, WB K-rows x the pass's output columns a
// stage, through a ring of STAGES stages; activations are bf16 in wgmma's
// 128-byte-swizzled K-major layout (atoms of 64 columns x 64 rows), in
// shared memory (two buffers, products up to PASS_W wide) or, in the wide
// kernels (any width up to MAXW), the product's input alone in shared
// memory, S_COLS columns of it at a time (a deeper product's K in two
// halves, S refilled between them), and the tile's two activation buffers
// in device scratch (SCRATCH_TILE_BYTES a tile), each output copied back
// into S by one bulk copy.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int BM = 64;            // rows a block
constexpr int WB = 32;            // K rows a weight stage
constexpr int CWG = 4;            // consumer warpgroups
constexpr int CONSUMERS = CWG * 128;
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int STAGES = 3;
constexpr int PASS_W = 512;       // output columns a pass; the one-pass kernels' widest product
constexpr int PASS_CHUNKS = PASS_W / 64;
constexpr int MAXW = 2048;        // widest product (K and N) of the wide kernels
constexpr int ROW_W = 1024;       // widest row-wise epilogue (the LayerNorm's row, the latent)
constexpr int S_COLS = 1024;      // K columns of a product's input S holds
constexpr int MAX_PRODUCTS = 10;
constexpr int BOX_BYTES = 64 * WB * 2;    // 64 output columns x 32 K rows
constexpr int ATOM_BYTES = BM * 128;      // 64 rows x 64 bf16, 128-byte swizzle
constexpr int ACT_BYTES = BM * PASS_W * 2;
constexpr int S_BYTES = BM * S_COLS * 2;        // the wide kernels' input buffer, 2 ACT_BYTES
constexpr int WIDE_ACT_BYTES = BM * MAXW * 2;   // a wide activation buffer in the scratch
constexpr int STAGE_BYTES = WB * PASS_W * 2;
constexpr int RED_BYTES = CWG * BM * 4;   // one f32 per row and warpgroup
constexpr int SMEM_BYTES = 2 * ACT_BYTES + STAGES * STAGE_BYTES + RED_BYTES + 1024;
// a tile's scratch: the two activation buffers, then the stash (a row-wise
// epilogue's f32 passes before its last, each thread's own elements, while
// the row's statistics are summed) and the backward's column-sum partials
constexpr int STASH_BYTES = (ROW_W / PASS_W - 1) * BM * PASS_W * 4;
constexpr int CSUM_BYTES = CWG * 512 * 4;
constexpr long long STASH_OFFSET = 2LL * WIDE_ACT_BYTES;
constexpr long long SCRATCH_TILE_BYTES = STASH_OFFSET + STASH_BYTES + CSUM_BYTES;
static_assert(S_BYTES == 2 * ACT_BYTES, "the wide input buffer takes both buffers' place");
static_assert(ROW_W <= S_COLS && S_COLS % WB == 0 && 2 * S_COLS == MAXW,
              "a row-wise epilogue's output fits S, and a product's K two halves of it");

// The kernels' instances: the one-pass kernel (every product's K and N at
// most PASS_W), the wide one (past it; every K at most S_COLS and every
// row-wise epilogue in one pass) and the wider one (a K
// past S_COLS or a row-wise epilogue past one pass), whose paths cost
// registers the wide one's launches at 1,024 columns would pay for too.
enum Tier { ONE_PASS = 0, WIDE_TIER = 1, WIDER_TIER = 2 };

// Pass j of a product with n output columns: its chunks of 64 columns
// [PASS_CHUNKS j, PASS_CHUNKS j + nch), cpw of them a warpgroup, and where
// its values start in a tile's block of the accumulator-order records
// (frag_ptr's k; every pass before it is whole, 2 chunks a warpgroup).
struct PassSpan {
  int nch, cpw, k0;
};

__device__ __forceinline__ int pass_count(int n) { return (n + PASS_W - 1) / PASS_W; }

__device__ __forceinline__ PassSpan pass_span(int n, int j) {
  const int nch = min(PASS_CHUNKS, (n + 63) / 64 - PASS_CHUNKS * j);
  return {nch, (nch + CWG - 1) / CWG, 8 * (PASS_CHUNKS / CWG) * j};
}

// Whether a product of a plan (fused_layer.cu's Plan, fused_layer_bwd.cu's
// BwdPlan) is wider than one pass: the wide kernel's launch.
template <class PlanT>
bool plan_is_wide(const PlanT& plan) {
  for (int p = 0; p < plan.n_products; ++p)
    if (plan.prod[p].k > PASS_W || plan.prod[p].n > PASS_W) return true;
  return false;
}

// The chunks a warpgroup owns over all passes of an n-column output: the
// size, in units of 64 KB, of a tile's block of accumulator-order records.
__host__ __device__ __forceinline__ int frag_cpw(int n) {
  const int nch = (n + 63) / 64, whole = nch / PASS_CHUNKS, rest = nch % PASS_CHUNKS;
  return whole * (PASS_CHUNKS / CWG) + (rest + CWG - 1) / CWG;
}

__device__ __forceinline__ uint8_t* act_at(uint8_t* base, int row, int col) {
  const int cc = col & 63;
  return base + (col >> 6) * ATOM_BYTES + row * 128 + ((((cc >> 3) ^ (row & 7))) << 4) +
         (cc & 7) * 2;
}

__device__ __forceinline__ void st_pair(uint8_t* base, int row, int col, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(act_at(base, row, col)) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float2 ld_pair(uint8_t* base, int row, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(act_at(base, row, col)));
}

__device__ __forceinline__ float sigmoid_scale(float s, float eps) {
  const float sig = 1.f / (1.f + expf(-s));
  return (2.f * sig - 1.f) * (1.f - eps) + 1.f;
}

// f(row, col, h, v0, v1) for each pair of this thread's sums plus the bias:
// rows fr + 8 h of the tile, columns col and col + 1 (col even) of its `cnt`
// chunks of 64 from chunk c0 (wgmma's m64nN fragment layout). Each chunk's
// 16 bias values are loaded before any of its pairs is used, so their
// latencies overlap; columns at or past n, and every column without a bias,
// add 0.
template <class F>
__device__ __forceinline__ void for_pairs(const float (&acc)[64], int cnt, int c0,
                                          const float* __restrict__ bias, int n, F f) {
  const int t = threadIdx.x % 128;
  const int fr = (t / 32) * 16 + (t % 32) / 4, fc = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < cnt) {
      float2 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (c0 + i) * 64 + 8 * j + fc;
        b[j].x = bias != nullptr && col < n ? __ldg(bias + col) : 0.f;
        b[j].y = bias != nullptr && col + 1 < n ? __ldg(bias + col + 1) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(fr + 8 * h, (c0 + i) * 64 + 8 * j + fc, h, acc[i * 32 + 4 * j + 2 * h] + b[j].x,
            acc[i * 32 + 4 * j + 2 * h + 1] + b[j].y);
      }
    }
  }
}

// acc (this warpgroup's cnt chunks from chunk c0) = bias + acc in place,
// then, with R, R's bf16 pair + acc (the residual scheme's add, in the
// order for_pairs' callers take it); bias loaded 16 values at a time.
__device__ __forceinline__ void add_bias_res(float (&acc)[64], int cnt, int c0,
                                             const float* __restrict__ bias, int n, uint8_t* R) {
  const int t = threadIdx.x % 128;
  const int fr = (t / 32) * 16 + (t % 32) / 4, fc = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < cnt) {
      float2 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (c0 + i) * 64 + 8 * j + fc;
        b[j].x = col < n ? __ldg(bias + col) : 0.f;
        b[j].y = col + 1 < n ? __ldg(bias + col + 1) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& v0 = acc[i * 32 + 4 * j + 2 * h];
          float& v1 = acc[i * 32 + 4 * j + 2 * h + 1];
          v0 += b[j].x;
          v1 += b[j].y;
          if (R != nullptr) {
            const float2 rv = ld_pair(R, fr + 8 * h, (c0 + i) * 64 + 8 * j + fc);
            v0 = rv.x + v0;
            v1 = rv.y + v1;
          }
        }
    }
  }
}

// B5's f32 rows in the accumulator's order ("fragment" layout): float4 k of
// a consumer thread's sums (acc[4 k .. 4 k + 3]) in tile b at float4 index
// (b * 8 cpw + k) * CONSUMERS + thread, so a warp's 16-byte accesses are
// contiguous and a tile's values are one contiguous block of cpw x 64 KB;
// cpw is frag_cpw(n), and pass j's float4s start at its k0 (pass_span).
// The recompute writes a product's values so and the backward reads them
// back from the same thread, whose columns are the same in both (the same
// output width gives the same passes and chunks per warpgroup).
__device__ __forceinline__ float4* frag_ptr(const float* base, int cpw, int k) {
  return const_cast<float4*>(reinterpret_cast<const float4*>(base)) +
         ((size_t)blockIdx.x * 8 * cpw + k) * CONSUMERS + threadIdx.x % CONSUMERS;
}

// A hidden product's epilogue in B5's recompute, acc holding its f32
// pre-activations: GELU'(acc), the factor the backward multiplies its
// gradient by, in the accumulator's order (frag_ptr, from the pass's k0),
// and GELU(acc) in bf16 into the activation buffer O, from one erff an
// element.
__device__ __forceinline__ void gelu_record(const float (&acc)[64], int cnt, int c0, float* base,
                                            int cpw, int k0, uint8_t* O) {
  const int t = threadIdx.x % 128;
  const int fr = (t / 32) * 16 + (t % 32) / 4, fc = 2 * (t % 4);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < 8 * cnt) {
      float2 g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q] = gelu_erf_and_grad(acc[4 * k + q]);
      *frag_ptr(base, cpw, k0 + k) = make_float4(g[0].y, g[1].y, g[2].y, g[3].y);
      const int col = (c0 + k / 8) * 64 + 8 * (k % 8) + fc;
      st_pair(O, fr, col, g[0].x, g[1].x);
      st_pair(O, fr + 8, col, g[2].x, g[3].x);
    }
  }
}

// A row-wise epilogue's pass j before its last, kept in the tile's stash
// (the wider kernels) until the row's statistics are known: this consumer
// thread's cnt chunks of acc, as float4s of its own, and back.
__device__ __forceinline__ void stash_pass(float4* stash, int j, const float (&acc)[64],
                                           int cnt) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < 8 * cnt)
      stash[(j * 16 + k) * CONSUMERS + threadIdx.x] =
          make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
}

__device__ __forceinline__ void unstash_pass(const float4* stash, int j, float (&acc)[64],
                                             int cnt) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < 8 * cnt) {
      const float4 v = stash[(j * 16 + k) * CONSUMERS + threadIdx.x];
      acc[4 * k] = v.x;
      acc[4 * k + 1] = v.y;
      acc[4 * k + 2] = v.z;
      acc[4 * k + 3] = v.w;
    }
}

// Orders this thread's generic-proxy writes to global memory before later
// asynchronous-proxy reads of it (the bulk copies below, issued by the
// producer after the ring's barriers have passed these writes on).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// One contiguous block of global memory (16-byte aligned, a multiple of 16
// bytes) into shared memory by the bulk copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// S (the wide kernels' input buffer) = K columns [S_COLS h, S_COLS h +
// S_COLS) of a k-column activation buffer in the tile's scratch, one bulk
// copy completing on bar (its caller waits there); every thread's stores to
// the buffer are fenced (fence_proxy_async_global) and past a barrier.
__device__ __forceinline__ void copy_to_s(uint8_t* S, const uint8_t* buf, int k, int h,
                                          uint64_t* bar) {
  const uint32_t bytes = (uint32_t)((min(S_COLS, k - S_COLS * h) + 63) / 64 * ATOM_BYTES);
  mbar_expect_tx(bar, bytes);
  bulk_copy(S, buf + (size_t)h * S_BYTES, bytes, bar);
}

// A tile's fragment block into L2 (the producer's, one product ahead).
__device__ __forceinline__ void prefetch_frag(const float* base, int cpw) {
  if (base == nullptr) return;
  const float4* block = frag_ptr(base, cpw, 0) - threadIdx.x % CONSUMERS;
  const char* start = reinterpret_cast<const char*>(block);
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(start), "r"(cpw * 65536)
               : "memory");
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A ring stage is handed back by every consumer warp (its empty barrier
// counts EMPTY_ARRIVALS), not once a warpgroup: a warpgroup with no columns
// in a product (cnt 0) issues no wgmma that would keep its four warps in
// step, and a warp left two fills behind its leader would read a stage's
// parity as the phase before (a hang once the producer is done).
constexpr int EMPTY_ARRIVALS = CONSUMERS / 32;

__device__ __forceinline__ void release(uint64_t* bar) {
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}


// The producer's side of one pass of a product: its weights' output chunks
// [c_first, c_first + nch), WB K-rows a stage, from the 3-D tensor map (n,
// k, layers) at `layer`, through the ring; `it` counts the ring's fills.
__device__ __forceinline__ void produce_weights(const CUtensorMap* map, int k, int c_first,
                                                int nch, int layer, uint8_t* ring,
                                                uint64_t* full, uint64_t* empty, int& it) {
  prefetch_tensor_map(map);
  const int kt = (k + WB - 1) / WB;
  for (int t = 0; t < kt; ++t, ++it) {
    const int s = it % STAGES;
    mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    uint8_t* stage = ring + s * STAGE_BYTES;
    mbar_expect_tx(&full[s], nch * BOX_BYTES);
    for (int c = 0; c < nch; ++c)
      tma_load_3d(stage + c * BOX_BYTES, map, &full[s], 64 * (c_first + c), WB * t, layer);
  }
}

// A consumer warpgroup's side of one pass: acc (its cnt chunks of 64
// output columns from the pass's chunk c0, m64n64 / m64n128 layout) = A (64
// x k bf16, swizzled) @ the pass's weights, stage by stage as they arrive;
// each stage is handed back once this warpgroup's products on it are done.
// With add, acc += instead: the next K rows of a pass, after the stages
// before them (the second half of a K deeper than S_COLS).
__device__ __forceinline__ void consume_weights(float (&acc)[64], const uint8_t* A, int k,
                                                int c0, int cnt, uint8_t* ring, uint64_t* full,
                                                uint64_t* empty, int& it, bool add = false) {
  if (!add) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  }
  fence_acc(acc);
  const int kt = (k + WB - 1) / WB;
  for (int kk = 0; kk < kt; ++kk, ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (cnt > 0) {
      const uint8_t* stage = ring + s * STAGE_BYTES + c0 * BOX_BYTES;
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = kk * WB + h * 16;
        const uint64_t da = smem_desc(A + (col >> 6) * ATOM_BYTES + (col & 63) * 2, 16, 1024);
        const uint64_t db = smem_desc(stage + h * 2048, BOX_BYTES, 1024);
        if (cnt == 2)
          wgmma_m64n128<0, 1>(acc, da, db);
        else
          wgmma_m64n64<0, 1>(*reinterpret_cast<float(*)[32]>(&acc[0]), da, db);
      }
      wgmma_commit();
    }
    if (kk > 0) {
      wgmma_wait<1>();
      release(&empty[(it - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(&empty[(it - 1) % STAGES]);
}

}  // namespace
