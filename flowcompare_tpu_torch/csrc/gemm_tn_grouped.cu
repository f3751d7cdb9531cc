// The weight and bias gradients of one layer of B5 (flow_layers_bwd, the
// port of flowcompare_tpu/ops/flow_layer_vjp_pallas.py:598, whose kernel
// accumulates them on chip across row blocks) in two launches:
//
//   gemm_tn_grouped  every weight gradient A^T @ B of the layer (A (K x M)
//                    and B (K x N) bf16, K = the B*N rows or the context
//                    rows) from a table of problems, one launch: each
//                    problem's 128 x 128 output tiles times a fixed number
//                    of K splits, each split's f32 partial written to the
//                    problem's workspace;
//   grad_reduce      every sum of partials in a fixed order, one launch
//                    (a weight's few splits a thread an element, a bias's
//                    hundreds of tile sums 8 runs a column then the runs):
//                    the weight gradients' K splits, and the bias
//                    gradients' per-tile column sums that the fused
//                    backward kernels wrote (fused_layer_bwd.cu), into the
//                    layer's slice of each gradient stack.
//
// Nothing is summed with atomics, so two calls give the same bits.
//
// What bounds it on the H100: the bytes of A and B read once against the
// layer's 2 x rows x sum(M x N) operations (about 0.14 ms of tensor-core time
// at dulcet-universe's 20,480 rows), plus the partials written and read
// once. The per-product chain took one gemm_tn and one colsum launch (two
// kernels each) per weight and bias, 35-40 launches a layer.
//
// Design: gemm_tn_wgmma.cu's blocks (gemm_wgmma.cuh's mainloop, both
// operands read MN-major, 4 stages, one block an SM), where the block's
// index picks the problem, the split and the tile from the table; a
// problem's tiles run row tile by row tile, so A comes from L2 after the
// first. The split count is one for the whole table, chosen by the host
// for about two waves of blocks on the 132 SMs.
#include <cstring>

#include "gemm_wgmma.cuh"

namespace {

constexpr int MAX_TN = 16;      // weight gradients a launch
constexpr int MAX_SUMS = 32;    // sums a launch (weights and biases)
using GroupTile = Tile<128, 128, 4, 1>;

struct TnProblem {
  CUtensorMap ta, tb;   // A (K x M) and B (K x N), boxes 64 x BK
  float* ws;            // splits partials of M x N, row-major
  int M, N, K, k_chunk, tiles_n, tiles_mn, block0, vec;
};

struct TnGroup {
  TnProblem p[MAX_TN];
  int n;
};

__global__ void __launch_bounds__(GroupTile::THREADS, GroupTile::MIN_BLOCKS)
    gemm_tn_grouped_kernel(const __grid_constant__ TnGroup g) {
  int q = 0;
  while (q + 1 < g.n && (int)blockIdx.x >= g.p[q + 1].block0) ++q;
  const TnProblem& pr = g.p[q];
  const int b = blockIdx.x - pr.block0;
  const int z = b / pr.tiles_mn, mn = b % pr.tiles_mn;
  const int m0 = (mn / pr.tiles_n) * 128, n0 = (mn % pr.tiles_n) * 128;
  const int k_begin = z * pr.k_chunk, k_end = min(pr.K, k_begin + pr.k_chunk);
  float* o = pr.ws + (size_t)z * pr.M * pr.N;
  const int N = pr.N, vec = pr.vec;
  const auto store = [=](const float* s, int r, int c) {
    float* p = o + (size_t)r * N + c;
    if (vec && c + 8 <= N) {
      *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(s);
      *reinterpret_cast<float4*>(p + 4) = *reinterpret_cast<const float4*>(s + 4);
    } else {
      for (int i = 0; i < 8 && c + i < N; ++i) p[i] = s[i];
    }
  };
  gemm_block<GroupTile, true, false>(&pr.ta, &pr.tb, pr.M, N, m0, n0, k_begin,
                                     (k_end - k_begin + BK - 1) / BK, store);
}

struct SumProblem {
  const float* src;   // count partials of rows x cols, row-major, one after another
  float* out;         // + layer * out_stride: rows x cols, row stride ld_out
  long long out_stride;
  int count, rows, cols, ld_out, block0;
};

struct SumGroup {
  SumProblem p[MAX_SUMS];
  int n, layer;
};

// A few partials (a weight gradient's K splits): a thread an element, the
// partials in order. Many (a bias's tile sums): 32 elements a block, the
// partials in 8 interleaved runs of 8 (k = run, run + 8, ...) each summed in
// order, then the 8 runs in order. Either way the order is fixed.
constexpr int FEW_PARTIALS = 8;

__global__ void __launch_bounds__(256) grad_reduce_kernel(const __grid_constant__ SumGroup g) {
  __shared__ float runs[8][33];
  int q = 0;
  while (q + 1 < g.n && (int)blockIdx.x >= g.p[q + 1].block0) ++q;
  const SumProblem& p = g.p[q];
  const int b = blockIdx.x - p.block0;
  const int elems = p.rows * p.cols;
  const size_t plane = (size_t)elems;
  float* out = p.out + g.layer * p.out_stride;
  if (p.count <= FEW_PARTIALS) {
    const int i = b * 256 + threadIdx.x;
    if (i >= elems) return;
    float acc = 0.f;
    for (int k = 0; k < p.count; ++k) acc += p.src[k * plane + i];
    out[(size_t)(i / p.cols) * p.ld_out + i % p.cols] = acc;
    return;
  }
  const int lane = threadIdx.x % 32, run = threadIdx.x / 32, i = b * 32 + lane;
  float acc = 0.f;
  if (i < elems)
    for (int k = run; k < p.count; k += 8) acc += p.src[k * plane + i];
  runs[run][lane] = acc;
  __syncthreads();
  if (run == 0 && i < elems) {
    float total = 0.f;
    for (int r = 0; r < 8; ++r) total += runs[r][lane];
    out[(size_t)(i / p.cols) * p.ld_out + i % p.cols] = total;
  }
}

}  // namespace

// Problem i: out_i (m[i] x n[i]) = A_i^T @ B_i with A_i (k[i] x m[i], row
// stride lda[i]) and B_i (k[i] x n[i], ldb[i]) bf16, TMA-readable, K in
// splits[i] chunks of k_chunk[i] rows (a multiple of 64); split z's f32
// partial goes to ws[i] + z * m[i] * n[i] (16-byte aligned).
FC_API int fc_gemm_tn_grouped(int n_problems, const uint64_t* a, const int* lda,
                              const uint64_t* b, const int* ldb, const int* m, const int* n,
                              const int* k, const int* splits, const int* k_chunk,
                              const uint64_t* ws, void* stream) {
  if (n_problems < 1 || n_problems > MAX_TN) return (int)cudaErrorInvalidValue;
  TnGroup g;
  memset(&g, 0, sizeof(g));
  g.n = n_problems;
  int blocks = 0;
  for (int i = 0; i < n_problems; ++i) {
    if (splits[i] < 1 || k_chunk[i] < BK || k_chunk[i] % BK != 0 ||
        (long long)splits[i] * k_chunk[i] < k[i] || ws[i] == 0 || ws[i] % 16 != 0)
      return (int)cudaErrorInvalidValue;
    TnProblem& p = g.p[i];
    cudaError_t err = bf16_tensor_map(&p.ta, reinterpret_cast<const void*>(a[i]), k[i], m[i],
                                      lda[i], 64, BK);
    if (err == cudaSuccess)
      err = bf16_tensor_map(&p.tb, reinterpret_cast<const void*>(b[i]), k[i], n[i], ldb[i], 64,
                            BK);
    if (err != cudaSuccess) return (int)err;
    p.ws = reinterpret_cast<float*>(ws[i]);
    p.M = m[i];
    p.N = n[i];
    p.K = k[i];
    p.k_chunk = k_chunk[i];
    p.tiles_n = (n[i] + 127) / 128;
    p.tiles_mn = p.tiles_n * ((m[i] + 127) / 128);
    p.block0 = blocks;
    p.vec = n[i] % 4 == 0;
    blocks += p.tiles_mn * splits[i];
  }
  static bool smem_set = false;   // the shared-memory opt-in, once
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(gemm_tn_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GroupTile::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  gemm_tn_grouped_kernel<<<blocks, GroupTile::THREADS, GroupTile::SMEM_BYTES,
                           (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// Sum i: out[i] + layer * out_stride[i] (rows[i] x cols[i], row stride
// ld_out[i]) = the sum, in order, of count[i] partials of rows[i] x cols[i]
// stored one after another from src[i].
FC_API int fc_grad_reduce(int n_sums, const uint64_t* src, const int* count, const int* rows,
                          const int* cols, const uint64_t* out, const int* ld_out,
                          const long long* out_stride, int layer, void* stream) {
  if (n_sums < 1 || n_sums > MAX_SUMS) return (int)cudaErrorInvalidValue;
  SumGroup g;
  memset(&g, 0, sizeof(g));
  g.n = n_sums;
  g.layer = layer;
  int blocks = 0;
  for (int i = 0; i < n_sums; ++i) {
    const long long elems = (long long)rows[i] * cols[i];
    if (count[i] < 1 || rows[i] < 1 || cols[i] < 1 || ld_out[i] < cols[i] || elems > (1 << 28))
      return (int)cudaErrorInvalidValue;
    g.p[i] = {reinterpret_cast<const float*>(src[i]), reinterpret_cast<float*>(out[i]),
              out_stride[i], count[i], rows[i], cols[i], ld_out[i], blocks};
    blocks += (int)((elems + (count[i] <= FEW_PARTIALS ? 255 : 31)) /
                    (count[i] <= FEW_PARTIALS ? 256 : 32));
  }
  grad_reduce_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
