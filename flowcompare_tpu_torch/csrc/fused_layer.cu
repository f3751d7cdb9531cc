// One coupling layer of the flow in two TMA + wgmma kernels that keep a row
// tile on chip: the layer-stack port of the Pallas kernels
// fused_flow_layers_t (B1, body _kernel_t, flowcompare_tpu/ops/
// flow_layer_pallas.py:851-921) and fused_flow_layers_inverse_t (B7, body
// _kernel_inverse_t), which hold a block of rows in VMEM through a whole
// layer.
//
//   conditioner      packed rows' x1 columns -> pre-MLP (GELU, a residual
//                    every second hidden product) -> LayerNorm with f32
//                    statistics over the row -> bf16 -> q = qn @ wq_f + bq_f
//                    in bf16, ready for cross_attention
//   coupling_layer   packed rows [x1 | extra | pad | cond] -> coupling MLP
//                    -> [s | t] in f32 -> the sigmoid-scale affine
//                    (coupling_epilogue_kernel's arithmetic, flow_rows.cu)
//                    -> y in bf16 -> y @ lu_w_f^T + lu_b into the f32 carry;
//                    also the next layer's x1 columns of the packed rows and,
//                    for training, its bf16 save row
//   coupling_inverse the same MLP, then x2 = (y2 - t) / scale
//                    (inverse_coupling_epilogue_kernel's arithmetic); below
//                    the top layer of the walk it runs the next layer's LU
//                    inverse on the tile, bf16(x) @ Minv^T + shift, writing
//                    the f32 y and its x1 columns; at layer 0 it writes x.
//
// Two more kinds run a whole MLP of the eval path on the same mainloop:
//
//   dgcnn_tail       B4's tail (the Pallas fused_dgcnn_encoder, flowcompare_tpu/
//                    ops/dgcnn_pallas.py:336): the 512-wide concat of the
//                    four EdgeConv stages, read once -> conv5 with its
//                    folded eval BatchNorm, leaky(v * a5 + b5) -> the
//                    residual head (GELU after each product but the last, a
//                    residual every second hidden product) -> the bf16
//                    embedding; with one product (head=False) it stops after
//                    conv5 and writes the 512-wide trunk
//   augment_net      B2's ConditionalNormal net (the Pallas fused_augmenter,
//                    flow_layer_pallas.py:1504) over the packed rows
//                    [x | extra | pad | attn]: 72 -> 512 -> 512 -> 512, then
//                    the last product, its (mean_i, log_std_i) columns
//                    interleaved, in column passes of at most 256 pairs
//                    (two at 588 > PASS_W columns, four at 2,036), one
//                    product a pass; each pass's epilogue runs on the registers
//                    against the pass's eps columns staged in shared memory:
//                    z2 = mean + eps exp(log_std) and this row's share of
//                    ldj = sum(log 2pi / 2 + log_std + eps^2 / 2), summed
//                    over every pass and the four warpgroups through the
//                    exchange; z = [x | z2] and ldj in f32
//
// Both read their input rows once and keep every activation of their MLP
// in shared memory (the per-product chains they replace wrote about 0.8 GB
// of the head's bf16 rows at 40 clouds, and B2's f32 [mean | log_std]).
// They carry the coupling kernels' limit (below): every 64-row tile streams
// all of its MLP's weights from L2 (4 MB a tile for the tail's eight
// 512-wide products, 3.2 GB at 50,000 rows), so on device they run slower
// than the per-product wgmma GEMMs, whose 128 x 128 tiles reuse each
// weight tile; what they save is the host's launches and the HBM round
// trips (PERF.md).
//
// B5's recompute (flow_layers_bwd, the port of flow_layer_vjp_pallas.py's
// _bwd_kernel_impl, which re-runs each layer from its bf16 save) runs the
// conditioner and a fourth kind, coupling_record (the coupling MLP alone), in
// record mode: each hidden product also writes GELU' at its f32
// pre-activation (fused_layer.cuh's frag_ptr order, the order the backward
// kernels read it in) and its bf16 activation (for the weight gradients),
// the LayerNorm its f32 normalised row and 1 / std, the coupling MLP its
// f32 [s | t]; the x1 columns come from the layer's save.
//
// What bounds it on the H100: at dulcet-universe's widths a coupling layer is
// about 1.76 MFLOP a row and the conditioner 0.49, against some 2 KB a row
// of bf16 and f32 rows in and out: operations bound both (73 us and 21 us a
// layer at 40,960 rows). Run as a chain of one launch per product, every 256-
// and 512-wide activation went to device memory and back (about 22 KB a row
// a layer), which made bytes the bound; here they stay in shared memory.
//
// Design:
//  * a block owns BM = 64 rows and runs every product of its layer on them:
//    four consumer warpgroups, each owning up to 128 output columns (the
//    f32 sums of m64n64 / m64n128 wgmma in registers, at most 64 a thread),
//    and one producer warp;
//  * activations live in two 64 KB shared buffers as bf16 in wgmma's 128-
//    byte-swizzled K-major layout (atoms of 64 columns x 64 rows): a product
//    reads one and its epilogue writes the other, or adds the residual in
//    place over the buffer that holds it, so three live activations of the
//    residual scheme need two buffers;
//  * the producer streams every product's weights, 32 K-rows x all output
//    columns a stage (32 KB at 512 columns), through a ring of 3 stages with
//    full / empty mbarriers, from 3-D tensor maps (N, K, layer) that clip
//    each layer's K;
//  * [s | t] comes out of the last MLP product with its columns interleaved
//    (the host permutes the weight: column 2i is s_i, 2i + 1 is t_i), so
//    each thread holds both halves of its pairs and the affine runs on the
//    registers; y's x1 half is a TMA copy of the packed rows' bf16 x1;
//  * ragged row counts: TMA zero-fills rows past M and no row past M is
//    stored; the padded columns of each operand are zero (TMA fill, or
//    written as zero), so no garbage meets a zero-filled weight row.
//
// What limits it on the H100 (chip_smoke.py's fused-layer phase): each
// 64-row tile streams all of its layer's weights into its SM, and the
// epilogues (GELU over 64 x 512 values a product, the affine, the
// LinearLU's stores) run while the ring is full, so a layer takes about
// six times its bound. Thread-block clusters of 2 and 4 that multicast each
// weight stage cut the L2 reads, not the bytes each SM takes in, and were
// slower; splitting each product's columns between two warpgroup pairs with
// a ring each, so one pair's epilogue overlaps the other's products, was
// slower too (small rings cannot cover an epilogue). A consumer never waits
// on a ring slot two fills ahead of the producer (the parity would alias),
// which one shared ring walked in order guarantees.
//
// Products wider than 512 columns (the wide kernels, WIDE = true; every
// width up to MAXW = 2,048): two 64 x 1,024 bf16 activations (128 KB each)
// and the ring do not fit the 227 KB a block may hold. Of the two layouts
// that fit, this one keeps one block a tile: the product's input, S, takes
// the two buffers' 128 KB of shared memory (S_COLS = 1,024 columns of it);
// the tile's two activation buffers move to device scratch (indexed by tile
// over the launch, SCRATCH_TILE_BYTES = 648 KB a tile with the stash below:
// 415 MB at 40,960 rows; whether a running tile's lines stay in the 50 MB L2
// is not measured); a product's output columns run in passes of PASS_W =
// 512 (each pass its own weight fills, the epilogue writing bf16 pairs to
// the scratch, the residual read from it), and once every pass is done one
// bulk copy brings the next product's input back into S. The other layout,
// a cluster of two blocks each owning half of every product's columns,
// would have to move the peer's half of each input through distributed
// shared memory into wgmma's operands and split the LayerNorm's and the
// affine's row sums across blocks; this one keeps every row reduction,
// [s | t]'s pairs and the accumulator-order records in one block, the
// one-pass kernels' code and rounding unchanged (the one-pass kernels, WIDE
// = false, still run every product up to 512 wide, bit for bit as before).
//
// The wide kernels come in two tiers (fused_layer.cuh's Tier): WIDE_TIER
// (fused_layer_wide.cu) runs every plan whose K fit S and whose row-wise
// epilogues take one pass, its code as it was before the wider tier; WIDER_TIER
// (fused_layer_wider.cu) runs the rest, with the paths below. The wider
// paths' state (a pass's sums over the passes, the halves' bookkeeping)
// costs registers: the kernels hold 96 a thread, and built into one
// instance they doubled its spills and cost the 1,024-wide launches 12-25%.
//
// A K past S_COLS (hidden products 2,048 wide) takes its input in two
// halves: each pass sums its first 1,024 K rows from S, S is refilled with
// the input's other half from the scratch (one 128 KB bulk copy, after a
// barrier), and the pass adds the rest on in the same accumulators, so a
// pass's sums run over K in order, as one walk would. The weights stream
// through the ring as before; a 2,048 x 2,048 product of a tile reads 8 MB
// of weights and now also 8 x 128 KB of its input (the first half is
// copied back each pass after the first), the cost of keeping one block a
// tile. Streaming the input's K slices through the ring beside the weights
// would put 4 KB of it in every stage, whose 128-byte swizzle would need
// 64-column boxes (two stages) or another descriptor mode; a cluster pair
// sharing the input through distributed shared memory has the cost above.
//
// Row-wise epilogues past one pass (up to ROW_W = 1,024 columns: the
// LayerNorm's row, [s | t] and the latent): the LayerNorm sums each
// thread's two rows over the passes (a thread owns the same rows in every
// pass), keeps a pass before the last in the tile's stash (f32, 128 KB,
// each thread its own elements) and normalises every pass once the row's
// statistics are known; [s | t]'s passes hold whole pairs, so the affine
// runs pass by pass with x2 / y2 read from the f32 rows where they lie (S
// still holds the input), y written to the scratch with its x1 columns and
// the ldj's log-scales summed on over the passes; the LinearLU (or LU
// inverse) writes each pass's f32 columns from its registers, as the
// one-pass tail's staged 4-column stores would (the staging takes S and the
// ring, busy until the last pass); B2's output layer is one product a pass
// of at most 256 pairs. One-pass epilogues keep their staging, bit for bit.
//
// Rounding points are the per-product chain's: bf16 between products, the
// f32 add of the bf16 residual, [s | t] and the LayerNorm statistics in f32,
// q in bf16, y rounded to bf16 before LinearLU, the carry and ldj in f32.
#include <cstring>

#include "fused_layer_kernel.cuh"

namespace {

// Whether a wide plan needs the wider tier: a K past S_COLS (the input in
// halves), or a row-wise epilogue past one pass (the LayerNorm's row, [s |
// t] or the LinearLU's latent: the products from the last MLP one on).
bool plan_is_wider(const Plan& plan, int kind) {
  for (int p = 0; p < plan.n_products; ++p)
    if (plan.prod[p].k > S_COLS) return true;
  if (kind != CONDITIONER && kind != COUPLING && kind != COUPLING_INVERSE) return false;
  for (int p = plan.n_mlp - 1; p < plan.n_products; ++p)
    if (plan.prod[p].n > PASS_W) return true;
  return false;
}

// The one-pass kernel where every product's K and N are at most PASS_W,
// the wide or the wider kernel (whose scratch io must hold) otherwise.
template <int KIND>
cudaError_t launch(const Plan& plan, const Rows& io, cudaStream_t stream) {
  if (!plan_is_wide(plan)) return launch_kind<KIND, ONE_PASS>(plan, io, stream);
  if (io.scratch == nullptr) return cudaErrorInvalidValue;
  return plan_is_wider(plan, KIND) ? launch_wider(KIND, plan, io, stream)
                                   : launch_wide(KIND, plan, io, stream);
}

// The plan's products: product p's weight map (n, k, L) and its bias, at
// `layer` (the tail's at `tail_layer`); record rows where given.
cudaError_t fill_plan(Plan& plan, int n_products, int n_mlp, const uint64_t* w, const int* w_ld,
                      const int* w_layers, const int* k, const int* n, const uint64_t* bias,
                      int layer, int tail_layer, const uint64_t* rec_pre, const int* ld_pre,
                      const uint64_t* rec_h, const int* ld_h) {
  memset(&plan, 0, sizeof(plan));
  plan.n_products = n_products;
  plan.n_mlp = n_mlp;
  for (int p = 0; p < n_products; ++p) {
    if (k[p] < 1 || k[p] > MAXW || n[p] < 1 || n[p] > MAXW) return cudaErrorInvalidValue;
    const cudaError_t err = bf16_tensor_map_3d(&plan.w[p], reinterpret_cast<const void*>(w[p]),
                                               w_layers[p], k[p], n[p], w_ld[p], 64, WB);
    if (err != cudaSuccess) return err;
    plan.prod[p] = {reinterpret_cast<const float*>(bias[p]), k[p], n[p],
                    p < n_mlp ? layer : tail_layer,
                    rec_pre == nullptr ? nullptr : reinterpret_cast<float*>(rec_pre[p]),
                    rec_h == nullptr ? nullptr : reinterpret_cast<bf16*>(rec_h[p]),
                    rec_pre == nullptr ? 0 : ld_pre[p], rec_h == nullptr ? 0 : ld_h[p], nullptr};
  }
  // the first product reads the packed rows whole from S
  return k[0] <= S_COLS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// The device scratch the wide kernels take for M rows (SCRATCH_TILE_BYTES
// a 64-row tile: two 64 x 2,048 bf16 activations, the stash of a row-wise
// epilogue and the backward's column-sum partials): the `scratch` of every
// entry point below when a product is wider than PASS_W (512) columns,
// ignored otherwise.
FC_API long long fc_fused_scratch_bytes(int M) {
  return M < 1 ? 0 : (long long)((M + BM - 1) / BM) * SCRATCH_TILE_BYTES;
}

// One layer of the conditioner (kind 0), the coupling forward (1), the
// coupling inverse (2) or B5's coupling recompute (3: the MLP alone) over M
// rows, one block of 64 rows a tile. Product p (of n_products; the first
// n_mlp are the MLP, one more is the tail: q, the LinearLU or the next
// layer's LU inverse; kind 3 has none) reads weight stack w[p]
// ((w_layers[p], k[p], n[p]) bf16, row stride w_ld[p], layer stride k[p] *
// w_ld[p]) at `layer` (the tail at `tail_layer`) and adds bias[p] ((layers,
// n[p]) f32). The first product reads the packed rows' first in_cols
// columns. Every operand must be TMA-readable (16-byte base, row stride a
// multiple of 8 bf16). B5's recompute passes, per product, f32 record rows
// rec_pre[p] and bf16 rec_h[p] (0 where none; [s | t]'s row stride even,
// rec_h's rows 16-byte aligned) and x1_src, the layer's save, whose x1 columns are read in
// place of xin's and written into xin, and for the conditioner ln_rstd
// (M f32): hidden products record GELU' at their f32 pre-activations in
// frag_ptr's order, the LayerNorm the normalised f32 row likewise and each
// row's 1 / std; other calls pass nulls. Products take K and N up to MAXW
// (2,048; past PASS_W the wide kernel, given `scratch` of
// fc_fused_scratch_bytes(M) bytes), the first (the packed rows, in_cols) K
// up to S_COLS (1,024); the last MLP product (the LayerNorm's row, [s |
// t]), the tail and the latent split + half take at most ROW_W (1,024).
FC_API int fc_fused_layer(int kind, int n_products, int n_mlp,
                          const uint64_t* w, const int* w_ld, const int* w_layers, const int* k,
                          const int* n, const uint64_t* bias, int layer, int tail_layer,
                          const void* xin, int ldxin, int in_cols, int split, int half, int M,
                          void* x, int ldx, void* y, int ldy, void* ldj, const void* lu_ldj,
                          void* save, int ldsave, void* q, int ldq, float eps,
                          const uint64_t* rec_pre, const int* ld_pre, const uint64_t* rec_h,
                          const int* ld_h, const void* x1_src, int ld_x1src, void* ln_rstd,
                          void* scratch, void* stream) {
  if (kind < 0 || kind > 3 || n_products < 2 || n_products > MAX_PRODUCTS || n_mlp < 2 ||
      n_mlp > n_products ||
      n_products - n_mlp > 1 || M < 1 || in_cols > S_COLS || split + half > ROW_W ||
      k[0] != in_cols || n[n_mlp - 1] > ROW_W ||
      (n_products > n_mlp && (k[n_mlp] > ROW_W || n[n_mlp] > ROW_W)))
    return (int)cudaErrorInvalidValue;
  if (kind != COUPLING_INVERSE && n_products != n_mlp + (kind == COUPLING_RECORD ? 0 : 1))
    return (int)cudaErrorInvalidValue;
  if (kind == CONDITIONER && rec_pre != nullptr && rec_pre[n_mlp - 1] != 0 && ln_rstd == nullptr)
    return (int)cudaErrorInvalidValue;   // the LayerNorm's record needs its 1 / std rows
  Plan plan;
  cudaError_t err = fill_plan(plan, n_products, n_mlp, w, w_ld, w_layers, k, n, bias, layer,
                              tail_layer, rec_pre, ld_pre, rec_h, ld_h);
  if (err == cudaSuccess) err = bf16_tensor_map(&plan.in, xin, M, in_cols, ldxin, 64, BM);
  if (err == cudaSuccess && kind != CONDITIONER)
    err = bf16_tensor_map(&plan.x1, xin, M, split, ldxin, 64, BM);
  if (err != cudaSuccess) return (int)err;
  Rows io{(float*)x,  (float*)y, (float*)ldj, (const float*)lu_ldj, (bf16*)xin,
          (bf16*)save, (bf16*)q, (const bf16*)x1_src, (float*)ln_rstd, ldx, ldy, ldxin,
          ldsave, ldq,
          ld_x1src, M, split, half, eps};
  io.scratch = (uint8_t*)scratch;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case CONDITIONER: return (int)launch<CONDITIONER>(plan, io, s);
    case COUPLING: return (int)launch<COUPLING>(plan, io, s);
    case COUPLING_RECORD: return (int)launch<COUPLING_RECORD>(plan, io, s);
    default: return (int)launch<COUPLING_INVERSE>(plan, io, s);
  }
}

// B4's tail (kind 4) over M rows of the stage concat xin (bf16, TMA-readable,
// the first product's k columns): product 0 is conv5 (epilogue leaky(v *
// scale + bias)), the others the head (GELU after each but the last, a
// residual every second hidden product); the last product's bf16 output
// into out (16-byte rows and base, its width a multiple of 8). Weight
// stacks and scratch as fc_fused_layer's, at layer 0; every product up to
// MAXW, conv5's K up to S_COLS.
FC_API int fc_dgcnn_tail(int n_products, const uint64_t* w, const int* w_ld, const int* w_layers,
                         const int* k, const int* n, const uint64_t* bias, const void* scale,
                         const void* xin, int ldxin, int M, void* out, int ldout, void* scratch,
                         void* stream) {
  if (n_products < 1 || n_products > MAX_PRODUCTS || M < 1 || n[n_products - 1] % 8 ||
      ldout % 8 || reinterpret_cast<uintptr_t>(out) % 16 || scale == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int p = 1; p < n_products; ++p)
    if (k[p] != n[p - 1]) return (int)cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = fill_plan(plan, n_products, n_products, w, w_ld, w_layers, k, n, bias, 0, 0,
                              nullptr, nullptr, nullptr, nullptr);
  if (err == cudaSuccess) err = bf16_tensor_map(&plan.in, xin, M, k[0], ldxin, 64, BM);
  if (err != cudaSuccess) return (int)err;
  plan.prod[0].scale = reinterpret_cast<const float*>(scale);
  Rows io;
  memset(&io, 0, sizeof(io));
  io.M = M;
  io.out = (bf16*)out;
  io.ldout = ldout;
  io.scratch = (uint8_t*)scratch;
  return (int)launch<DGCNN_TAIL>(plan, io, (cudaStream_t)stream);
}

// B2's net (kind 5) over M packed rows xin (bf16, TMA-readable, the first
// product's k columns): GELU after every product before the last n_out, a
// residual every second hidden one; the last n_out products are the output
// layer's column passes, (mean_i, log_std_i) interleaved, n[p] / 2 pairs
// each and aug in all, each reading the last hidden output. z (M, in_dim +
// aug, f32) = [x | mean + eps * exp(log_std)] and ldj (M) = sum(log 2pi / 2
// + log_std + eps^2 / 2), from x (M, in_dim) and eps (M, aug) f32. Weight
// stacks and scratch as fc_fused_layer's, at layer 0; the net's products up
// to MAXW (the first's K up to S_COLS), each output pass up to PASS_W.
FC_API int fc_augment_net(int n_products, int n_out, const uint64_t* w, const int* w_ld,
                          const int* w_layers, const int* k, const int* n, const uint64_t* bias,
                          const void* xin, int ldxin, int M, int in_dim, const void* x, int ldx,
                          const void* eps, int ldeps, int aug, void* z, int ldz, void* ldj,
                          void* scratch, void* stream) {
  if (n_out < 1 || n_products - n_out < 2 || n_products > MAX_PRODUCTS || M < 1 || in_dim < 1)
    return (int)cudaErrorInvalidValue;
  int pairs = 0;
  for (int p = n_products - n_out; p < n_products; ++p) {
    if (n[p] % 2 || n[p] > PASS_W || k[p] != n[n_products - n_out - 1])
      return (int)cudaErrorInvalidValue;
    pairs += n[p] / 2;
  }
  if (pairs != aug) return (int)cudaErrorInvalidValue;
  for (int p = 1; p < n_products - n_out; ++p)
    if (k[p] != n[p - 1]) return (int)cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = fill_plan(plan, n_products, n_products, w, w_ld, w_layers, k, n, bias, 0, 0,
                              nullptr, nullptr, nullptr, nullptr);
  if (err == cudaSuccess) err = bf16_tensor_map(&plan.in, xin, M, k[0], ldxin, 64, BM);
  if (err != cudaSuccess) return (int)err;
  Rows io;
  memset(&io, 0, sizeof(io));
  io.x = (float*)x;
  io.ldx = ldx;
  io.ldj = (float*)ldj;
  io.M = M;
  io.split = in_dim;
  io.noise = (const float*)eps;
  io.ldnoise = ldeps;
  io.z = (float*)z;
  io.ldz = ldz;
  io.scratch = (uint8_t*)scratch;
  plan.n_out = n_out;
  return (int)launch<AUGMENT>(plan, io, (cudaStream_t)stream);
}
