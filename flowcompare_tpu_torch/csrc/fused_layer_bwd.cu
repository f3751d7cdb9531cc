// The backward of one coupling layer in two TMA + wgmma kernels that keep a
// row tile on chip: B5's port of the Pallas kernel flow_layers_bwd (body
// _bwd_kernel_impl, flowcompare_tpu/ops/flow_layer_vjp_pallas.py:598), which
// walks a layer's transpose on a block of rows in VMEM.
//
//   coupling_bwd     the carry's gradient g -> bf16 (also written, for the
//                    LinearLU's weight gradient) -> dy = g @ lu_w_f -> the
//                    sigmoid-scale affine's transpose (coupling_epilogue_bwd's
//                    arithmetic, flow_rows_bwd.cu) at the layer's bf16 save,
//                    writing y and the next carry gradient [dy1 | dy2 *
//                    scale] -> the coupling MLP in reverse, each product dh =
//                    dp @ W^T with the residual's gradient and GELU'(f32
//                    pre-activation) in its epilogue -> the packed input's
//                    gradient: x1's added to the carry gradient, extra's and
//                    the cond columns' (the attention's da, or the global
//                    conditioner's row-wise dctx) written or added
//   conditioner_bwd  dq -> dqn = dq @ wq_f^T -> the LayerNorm's transpose
//                    (row_norm_bwd's arithmetic) from the normalised f32 row
//                    and 1 / std the recompute recorded -> the pre-MLP in
//                    reverse -> x1's gradient added to the carry gradient
//
// Each writes, per product, the bf16 output gradient dp that the weight
// gradients read and the per-tile column sums of the f32 dp that the bias
// gradients are summed from (`fc_grad_reduce`, gemm_tn_grouped.cu), so no
// bias needs a column-sum launch. What they re-linearise at was written by
// the recompute (fused_layer.cu's record mode) from the f32 values there:
// GELU' at each hidden pre-activation and the LayerNorm's normalised row in
// the accumulator's order (fused_layer.cuh's frag_ptr), so the thread that
// needs an element wrote it and a tile's values are one contiguous block;
// [s | t] row-major. The producer brings a hidden product's GELU' (and
// residual gradient) blocks into the weight ring after its weights, by
// bulk copies, so its epilogue reads them from shared memory: read from
// device memory in the epilogue, each thread's loads waited one after
// another behind its stores and took most of the epilogue's time.
//
// What bounds it on the H100: operations, as the forward: the transposed
// products of the layer (1.76 MFLOP a row for dulcet-universe's coupling,
// 0.49 for its conditioner) against some 6 KB a row of f32 pre-activations
// read; a per-product chain moved every 512-wide gradient through device
// memory in f32 and bf16.
//
// Design: fused_layer.cu's block (fused_layer.cuh): 64 rows, four consumer
// warpgroups of up to 128 output columns, a producer warp streaming each
// product's weights transposed (host-made W^T stacks, read as the forward
// reads W) through a 3-stage ring, two 64 KB bf16 activation buffers: a
// product reads one and its epilogue writes the other. Where this differs:
//  * the residual's gradient is kept in f32 in device memory, in the
//    accumulator's order (each thread writes the elements it later reads,
//    through the ring), so the sums are the per-product chain's: no bf16
//    residual;
//  * column sums: over a warp's 16 rows by shuffles, then over the four
//    warps in order through the product's A buffer (free once every
//    warpgroup's products on it are done), one row of partials a tile; the
//    coupling head's, where the affine's transpose runs as a row-major pass
//    over dy2 staged in shared memory, one row a band of rows;
//  * row sums (the LayerNorm's four statistics) through the 1 KB exchange,
//    the warpgroups in order, as the forward;
//  * every element of a row past M is set to 0 before anything reads it.
// Past 512 columns the wide kernels (up to 2,048) take fused_layer.cu's
// layout: the product's input in shared memory, the tile's two bf16
// buffers in device scratch, each product's output columns in passes of
// 512, a pass's GELU' and residual blocks streamed after its weights (the
// records' pass-by-pass order, fused_layer.cuh's pass_span), and the next
// product's input brought back by one bulk copy. As fused_layer.cu's, they
// come in two tiers: the wide one (every K up to 1,024, the head one pass)
// and the wider one, where a K past 1,024 comes in two halves (S refilled
// between them each pass) and the head's output (the latent, or the
// LayerNorm's row) takes two passes: the coupling head stages dy2 over the
// passes and runs the affine's transpose after the last; the LayerNorm's
// transpose sums its two row statistics over the passes and keeps the
// first pass's dqn in the tile's stash until they are known; the column
// sums' partials go to the scratch, since act[a] must keep the input's
// halves.
// Rounding points are the per-product chain's: g and each dp in bf16 as
// product operands, everything else in f32.
#include <cstring>

#include "fused_layer_bwd_kernel.cuh"

namespace {

// The one-pass kernel where every product's K and N are at most PASS_W,
// the wide or (a K past S_COLS, or the head's output past one pass) the
// wider kernel, whose scratch io must hold, otherwise.
template <int KIND>
cudaError_t launch_bwd(const BwdPlan& plan, const BwdRows& io, cudaStream_t stream) {
  if (!plan_is_wide(plan)) return launch_bwd_kind<KIND, ONE_PASS>(plan, io, stream);
  if (io.scratch == nullptr) return cudaErrorInvalidValue;
  bool wider = plan.prod[0].n > PASS_W;
  for (int p = 0; p < plan.n_products; ++p) wider = wider || plan.prod[p].k > S_COLS;
  return wider ? launch_bwd_wider(KIND, plan, io, stream)
               : launch_bwd_kind<KIND, WIDE_TIER>(plan, io, stream);
}

}  // namespace

// One layer's coupling backward (kind 0) or conditioner backward (1) over M
// rows, one block of 64 rows a tile. Product p of n_products (the head, the
// MLP's products in reverse, the tail over the input) streams weight stack
// w[p] ((w_layers[p], k[p], n[p]) bf16, row stride w_ld[p]: the transposed
// weights; the coupling head's is lu_w_f itself) at `layer`. Per product:
// pre[p] the f32 values its epilogue reads (the coupling head's row-major,
// row stride ld_pre[p] even; the others in frag_ptr's order), res_in[p] /
// res_out[p] the f32 residual gradient read and written (frag_ptr's
// order), d_out[p] / ld_d[p] the bf16 dp out and colsum[p] its (tiles,
// cs_n[p]) column sums; 0 where none. The head reads src (M x src_cols
// f32). Everything else as in BwdRows. Products take K and N up to MAXW
// (2,048; past PASS_W the wide kernel, given `scratch` of fc_fused_scratch_bytes(M)
// bytes, fused_layer.cu), the head's K (src_cols) and output (the latent,
// or the LayerNorm's row) up to ROW_W.
FC_API int fc_fused_layer_bwd(int kind, int n_products, const uint64_t* w, const int* w_ld,
                              const int* w_layers, const int* k, const int* n,
                              const uint64_t* pre, const int* ld_pre, const uint64_t* res_in,
                              const uint64_t* res_out, const uint64_t* d_out,
                              const int* ld_d, const uint64_t* colsum, const int* cs_n, int layer,
                              int M, const void* src, int ld_src, int src_cols, void* src_b,
                              int ld_src_b, void* src_colsum, void* g_next, int ld_g,
                              const void* x, int ld_x, const void* dldj, void* y, int ld_y,
                              void* dextra, int ld_extra, void* dcond, int ld_cond,
                              int accumulate_cond, int split, int half, int xe, int xc, int cond,
                              const void* ln_rstd, float eps, void* scratch, void* stream) {
  if (kind < 0 || kind > 1 || n_products < 3 || n_products > MAX_PRODUCTS || M < 1 ||
      src_cols < 1 || src_cols > ROW_W || k[0] != src_cols || n[0] > ROW_W)
    return (int)cudaErrorInvalidValue;
  BwdPlan plan;
  memset(&plan, 0, sizeof(plan));
  plan.n_products = n_products;
  plan.layer = layer;
  cudaError_t err = cudaSuccess;
  for (int p = 0; p < n_products && err == cudaSuccess; ++p) {
    if (k[p] < 1 || k[p] > MAXW || n[p] < 1 || n[p] > MAXW) return (int)cudaErrorInvalidValue;
    if ((p > 0 && k[p] != n[p - 1] && !(p == 1 && kind == COUPLING_BWD)) ||
        (p < n_products - 1 && (colsum[p] == 0 || d_out[p] == 0 || (p > 0 && pre[p] == 0))))
      return (int)cudaErrorInvalidValue;
    err = bf16_tensor_map_3d(&plan.w[p], reinterpret_cast<const void*>(w[p]), w_layers[p], k[p],
                             n[p], w_ld[p], 64, WB);
    plan.prod[p] = {k[p],
                    n[p],
                    reinterpret_cast<const float*>(pre[p]),
                    reinterpret_cast<const float*>(res_in[p]),
                    reinterpret_cast<float*>(res_out[p]),
                    reinterpret_cast<bf16*>(d_out[p]),
                    reinterpret_cast<float*>(colsum[p]),
                    ld_pre[p],
                    ld_d[p],
                    cs_n[p]};
  }
  if (err != cudaSuccess) return (int)err;
  if (pre[0] == 0 || (kind == CONDITIONER_BWD && ln_rstd == nullptr) ||
      (kind == COUPLING_BWD && (half < 1 || half > ROW_W / 2 || k[1] != 2 * half ||
                                n[0] != split + half)))
    return (int)cudaErrorInvalidValue;
  const BwdRows io{(const float*)src, (bf16*)src_b, (float*)src_colsum, (float*)g_next,
                   (const bf16*)x, (const float*)dldj, (bf16*)y, (float*)dextra, (float*)dcond,
                   (const float*)ln_rstd,
                   ld_src, ld_src_b, ld_g, ld_x, ld_y, ld_extra, ld_cond, accumulate_cond, M,
                   src_cols, split, half, xe, xc, cond, eps, (uint8_t*)scratch};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(kind == COUPLING_BWD ? launch_bwd<COUPLING_BWD>(plan, io, s)
                                    : launch_bwd<CONDITIONER_BWD>(plan, io, s));
}
