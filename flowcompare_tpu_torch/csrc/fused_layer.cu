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
//                    interleaved, in two column passes of at most 256 pairs
//                    (588 > MAXW); each pass's epilogue runs on the registers
//                    against the pass's eps columns staged in shared memory:
//                    z2 = mean + eps exp(log_std) and this row's share of
//                    ldj = sum(log 2pi / 2 + log_std + eps^2 / 2), summed
//                    over both passes and the four warpgroups through the
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
// Rounding points are the per-product chain's: bf16 between products, the
// f32 add of the bf16 residual, [s | t] and the LayerNorm statistics in f32,
// q in bf16, y rounded to bf16 before LinearLU, the carry and ldj in f32.
#include <cstring>

#include "fused_layer.cuh"

namespace {

enum Kind {
  CONDITIONER = 0,
  COUPLING = 1,
  COUPLING_INVERSE = 2,
  COUPLING_RECORD = 3,
  DGCNN_TAIL = 4,
  AUGMENT = 5
};

struct Product {
  const float* bias;   // (L, n) f32
  int k, n, layer;
  // B5's recompute (null otherwise): the f32 value each epilogue forms (a
  // GELU's pre-activation, the LayerNorm's input, [s | t]) and its bf16
  // result (the activation, the normalised row), (M, n) row-major
  float* pre;
  bf16* h;
  int ld_pre, ld_h;
  const float* scale;  // dgcnn_tail's conv5: the folded BatchNorm's a5, (L, n) f32
};

struct Plan {
  CUtensorMap w[MAX_PRODUCTS];   // product p's weight stack, (n, k, L), boxes 64 x WB x 1
  CUtensorMap in;                // the packed rows' first in_cols columns, boxes 64 x BM
  CUtensorMap x1;                // their x1 columns (y's first half)
  Product prod[MAX_PRODUCTS];
  int n_products, n_mlp;
};

struct Rows {
  float* x;            // forward: the f32 carry, in and out; inverse: x at layer 0
  float* y;            // inverse: this layer's f32 y, in; the next layer's, out
  float* ldj;          // forward
  const float* lu_ldj; // forward: this layer's folded LinearLU log-det (one float)
  bf16* xin;           // the packed rows (the x1 columns are written)
  bf16* save;          // forward with saves: the next layer's bf16 entry carry
  bf16* q;             // conditioner
  const bf16* x1_src;  // B5's recompute: the layer's bf16 save, whose x1 columns replace xin's
  float* ln_rstd;      // B5's conditioner recompute: each row's LayerNorm 1 / std
  int ldx, ldy, ldxin, ldsave, ldq, ld_x1src;
  int M, split, half;
  float eps;
  bf16* out;           // dgcnn_tail: the embedding or the trunk (bf16)
  const float* noise;  // augment_net: eps, (M, aug) f32
  float* z;            // augment_net: z = [x | z2], (M, split + aug) f32 (ldj into ldj)
  int ldout, ldnoise, ldz;
};

// B5's recompute: [s | t]'s f32 values at row gr, columns col and col + 1
// (col even), into the last product's record rows (row-major: the
// backward's head reads them at other threads' columns).
__device__ __forceinline__ void record_pair(const Product& pr, int gr, int M, int col, float v0,
                                            float v1) {
  if (gr >= M || col >= pr.n) return;
  float* p = pr.pre + (size_t)gr * pr.ld_pre + col;
  if (col + 1 < pr.n)
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  else
    p[0] = v0;
}

// B5's recompute: a product's bf16 results, as its epilogue left them in the
// activation buffer O, into its bf16 record rows, 16 bytes a thread.
__device__ __forceinline__ void record_rows(const Product& pr, const uint8_t* O, int m0, int M) {
  const int chunks = (pr.n + 7) / 8;
  for (int e = threadIdx.x; e < BM * chunks; e += CONSUMERS) {
    const int row = e / chunks, c = 8 * (e % chunks), gr = m0 + row;
    if (gr < M)
      *reinterpret_cast<uint4*>(pr.h + (size_t)gr * pr.ld_h + c) =
          *reinterpret_cast<const uint4*>(act_at(const_cast<uint8_t*>(O), row, c));
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
    fused_layer_kernel(const __grid_constant__ Plan plan, const Rows io) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], abar, ybar;
  uint8_t* smem = align1024(smem_raw);
  uint8_t* act[2] = {smem, smem + ACT_BYTES};
  uint8_t* ring = smem + 2 * ACT_BYTES;
  float* red = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  const int m0 = blockIdx.x * BM;
  // warp-uniform for the compiler (a shuffle from lane 0), so it keeps the
  // per-warpgroup branches around wgmma from serialising the products
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], EMPTY_ARRIVALS);
    }
    mbar_init(&abar, 1);
    mbar_init(&ybar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CWG) {
    // the producer: the block's input rows once, then every product's weights
    if (threadIdx.x == CONSUMERS) {
      if (KIND == COUPLING || KIND == COUPLING_INVERSE) {
        // the tile's f32 rows the last epilogue reads (x forward, y inverse)
        // into L2 now, so that epilogue finds them there
        const float* src = (KIND == COUPLING ? io.x : io.y);
        const int ld = KIND == COUPLING ? io.ldx : io.ldy;
        const char* start = reinterpret_cast<const char*>(src + (size_t)m0 * ld);
        const uint32_t bytes = (uint32_t)(min(BM, io.M - m0) * ld * 4);
        if (reinterpret_cast<uintptr_t>(start) % 16 == 0 && bytes % 16 == 0)
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(start), "r"(bytes)
                       : "memory");
      }
      const int in_atoms = (plan.prod[0].k + 63) / 64;
      mbar_expect_tx(&abar, in_atoms * ATOM_BYTES);
      for (int a = 0; a < in_atoms; ++a)
        tma_load(act[1] + a * ATOM_BYTES, &plan.in, &abar, 64 * a, m0);
      int it = 0;
      for (int p = 0; p < plan.n_products; ++p)
        produce_weights(&plan.w[p], plan.prod[p].k, plan.prod[p].n, plan.prod[p].layer, ring,
                        full, empty, it);
    }
    __syncwarp();
  } else {
    const int tid = threadIdx.x;
    const int t = tid % 128;
    const int M = io.M, split = io.split, half = io.half, lat = split + half;
    int it = 0;
    int a = 1, r = 0, ybuf = 0;
    float lsum_aug[2] = {0.f, 0.f};   // augment_net: this thread's rows' ldj terms
    int pofs = 0;                     // augment_net: the pairs of the passes before
    // the last MLP product's output goes to a bf16 y tile (all but layer 0 of
    // the inverse walk, which writes x)
    const bool to_y = KIND == COUPLING || plan.n_products > plan.n_mlp;
    mbar_wait(&abar, 0);
    if (io.x1_src != nullptr) {
      // B5's recompute: the x1 columns come from the layer's bf16 save (whose
      // rows TMA cannot read), over what TMA loaded, and go into the packed
      // rows for the weight gradients
      for (int e = tid; e < BM * split; e += CONSUMERS) {
        const int row = e / split, c = e % split, gr = m0 + row;
        const bf16 v = gr < M ? io.x1_src[(size_t)gr * io.ld_x1src + c] : f2bf(0.f);
        *reinterpret_cast<bf16*>(act_at(act[1], row, c)) = v;
        if (gr < M) io.xin[(size_t)gr * io.ldxin + c] = v;
      }
      fence_proxy_async();
      named_barrier(1, CONSUMERS);
    }
    for (int p = 0; p < plan.n_products; ++p) {
      const Product& pr = plan.prod[p];
      const int n = pr.n;
      const float* bias = pr.bias + (size_t)pr.layer * n;
      const bool tail = p == plan.n_mlp;
      const bool last = p == plan.n_mlp - 1;
      uint8_t* A = act[tail ? ybuf : a];
      if (last) {
        ybuf = 1 - a;
        if (KIND != CONDITIONER && to_y && tid == 0) {
          // y's x1 half: the packed rows' bf16 x1 columns, zero past split
          const int atoms = (split + 63) / 64;
          mbar_expect_tx(&ybar, atoms * ATOM_BYTES);
          for (int c = 0; c < atoms; ++c)
            tma_load(act[ybuf] + c * ATOM_BYTES, &plan.x1, &ybar, 64 * c, m0);
        }
      }
      // augment_net's output passes: the pass's eps columns, f32, into the
      // buffer the input does not use (free since the last product's barrier)
      const bool aug_out = KIND == AUGMENT && p >= plan.n_mlp - 2;
      const int P = n / 2;
      float* E = reinterpret_cast<float*>(act[1 - a]);
      if (aug_out) {
        for (int e = tid; e < BM * P; e += CONSUMERS) {
          const int gr = m0 + e / P;
          E[e] = gr < M ? io.noise[(size_t)gr * io.ldnoise + pofs + e % P] : 0.f;
        }
        named_barrier(1, CONSUMERS);
      }
      const int nch = (n + 63) / 64, cpw = (nch + CWG - 1) / CWG, c0 = wg * cpw;
      const int cnt = min(max(nch - c0, 0), cpw);
      float acc[64];
      consume_weights(acc, A, pr.k, c0, cnt, ring, full, empty, it);

      if (KIND == DGCNN_TAIL && (p == 0 || p == plan.n_products - 1)) {
        // conv5 with its folded BatchNorm, leaky(v * a5 + b5) rounded as the
        // plain version rounds it, or the head's last product, v + b: bf16
        // into the free buffer, stored from there after the barrier
        uint8_t* O = act[1 - a];
        const float* sc = pr.scale + (size_t)pr.layer * n;
        for_pairs(acc, cnt, c0, p == 0 ? nullptr : bias, n,
                  [&](int row, int col, int, float v0, float v1) {
                    if (p == 0) {
                      const float s0 = col < n ? __ldg(sc + col) : 0.f;
                      const float s1 = col + 1 < n ? __ldg(sc + col + 1) : 0.f;
                      const float b0 = col < n ? __ldg(bias + col) : 0.f;
                      const float b1 = col + 1 < n ? __ldg(bias + col + 1) : 0.f;
                      v0 = leaky02(__fadd_rn(__fmul_rn(v0, s0), b0));
                      v1 = leaky02(__fadd_rn(__fmul_rn(v1, s1), b1));
                    }
                    st_pair(O, row, col, v0, v1);
                  });
        a = 1 - a;
      } else if (aug_out) {
        // (mean_i, log_std_i) pairs against the staged eps: z2 over eps in
        // place, and this thread's share of ldj
        for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int h, float v0, float v1) {
          if (col >= n || m0 + row >= M) return;
          float* ev = E + row * P + (col >> 1);
          const float e = *ev;
          *ev = v0 + e * expf(v1);
          lsum_aug[h] += (0.91893853320467274178f + v1) + 0.5f * e * e;
        });
      } else if (!last && !tail) {
        // first and hidden products: GELU, a residual every second hidden
        // one (the tail's MLP starts after conv5)
        const int k_hidden = p - 1 - (KIND == DGCNN_TAIL ? 1 : 0);
        const bool add_res = k_hidden >= 0 && (k_hidden & 1);
        int out;
        if (add_res) {
          out = r;
        } else {
          if (k_hidden >= 0) r = a;
          out = 1 - a;
        }
        uint8_t* O = act[out];
        uint8_t* R = act[r];
        if (pr.pre != nullptr) {
          // B5's recompute: GELU' at the f32 pre-activations, in the
          // accumulator's order
          add_bias_res(acc, cnt, c0, bias, n, add_res ? R : nullptr);
          gelu_record(acc, cnt, c0, pr.pre, cpw, O);
        } else {
          for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int, float v0, float v1) {
            if (add_res) {
              const float2 rv = ld_pair(R, row, col);
              v0 = rv.x + v0;
              v1 = rv.y + v1;
            }
            st_pair(O, row, col, gelu_erf(v0), gelu_erf(v1));
          });
        }
        a = out;
      } else if (KIND == CONDITIONER && last) {
        // LayerNorm of the f32 row (plain statistics; scale and bias are in wq_f)
        if (pr.pre != nullptr) {
          add_bias_res(acc, cnt, c0, bias, n, nullptr);
          bias = nullptr;
        }
        float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
        for_pairs(acc, cnt, c0, bias, n, [&](int, int, int h, float v0, float v1) {
          s1[h] += v0 + v1;
          s2[h] += v0 * v0 + v1 * v1;
        });
        const int fr = (t / 32) * 16 + (t % 32) / 4;
        // the row sums over the four warpgroups' columns, one quantity at a
        // time through the 1 KB exchange
        const auto row_total = [&](float (&v)[2]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h] = quad_sum(v[h]);
            if (t % 4 == 0) red[wg * BM + fr + 8 * h] = v[h];
          }
          named_barrier(1, CONSUMERS);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float total = 0.f;
            for (int w = 0; w < CWG; ++w) total += red[w * BM + fr + 8 * h];
            v[h] = total;
          }
          named_barrier(1, CONSUMERS);
        };
        row_total(s1);
        row_total(s2);
        float mean[2], inv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mean[h] = s1[h] / n;
          inv[h] = rsqrtf(s2[h] / n - mean[h] * mean[h] + 1e-5f);
        }
        if (pr.pre != nullptr) {
          // B5's recompute: the normalised row in f32 (xhat, in the
          // accumulator's order) and each row's 1 / std
#pragma unroll
          for (int k = 0; k < 16; ++k)
            if (k < 8 * cnt)
              *frag_ptr(pr.pre, cpw, k) = make_float4(
                  (acc[4 * k] - mean[0]) * inv[0], (acc[4 * k + 1] - mean[0]) * inv[0],
                  (acc[4 * k + 2] - mean[1]) * inv[1], (acc[4 * k + 3] - mean[1]) * inv[1]);
          if (wg == 0 && t % 4 == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (m0 + fr + 8 * h < M) io.ln_rstd[m0 + fr + 8 * h] = inv[h];
          }
        }
        uint8_t* O = act[ybuf];
        for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int h, float v0, float v1) {
          st_pair(O, row, col, col < n ? (v0 - mean[h]) * inv[h] : 0.f,
                  col + 1 < n ? (v1 - mean[h]) * inv[h] : 0.f);
        });
      } else if (KIND == CONDITIONER) {
        // q = qn @ wq_f + bq_f, in bf16
        for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int, float v0, float v1) {
          const int gr = m0 + row;
          if (gr >= M) return;
          bf16* qr = io.q + (size_t)gr * io.ldq;
          if (col < n) qr[col] = f2bf(v0);
          if (col + 1 < n) qr[col + 1] = f2bf(v1);
        });
      } else if (KIND == COUPLING_RECORD) {
        // B5's recompute: [s | t] (interleaved) in f32, nothing after it
        for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int, float v0, float v1) {
          record_pair(pr, m0 + row, M, col, v0, v1);
        });
      } else if (last) {
        // [s | t] interleaved: the affine (forward) or its inverse on the registers
        // the tile's x2 (forward) or y2 (inverse), f32, staged in the A
        // buffer once every warpgroup's products are done, read coalesced
        named_barrier(1, CONSUMERS);
        float* X2 = reinterpret_cast<float*>(act[a]);
        {
          const float* src = (KIND == COUPLING ? io.x : io.y) + split;
          const int lds = KIND == COUPLING ? io.ldx : io.ldy;
          // four loads in flight a thread before their stores
          for (int e0 = tid; e0 < BM * half; e0 += 4 * CONSUMERS) {
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int e = e0 + k * CONSUMERS, gr = m0 + e / half;
              v[k] = e < BM * half && gr < M ? src[(size_t)gr * lds + e % half] : 0.f;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (e0 + k * CONSUMERS < BM * half) X2[e0 + k * CONSUMERS] = v[k];
          }
        }
        named_barrier(1, CONSUMERS);
        if (to_y) mbar_wait(&ybar, 0);
        uint8_t* Y = act[ybuf];
        float lsum[2] = {0.f, 0.f};
        for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int h, float v0, float v1) {
          const int i = col >> 1;
          if (i >= half) return;
          const float sc = sigmoid_scale(v0, io.eps);
          const int gr = m0 + row;
          float out = 0.f;
          if (KIND == COUPLING) {
            if (gr < M) {
              out = X2[row * half + i] * sc + v1;
              lsum[h] += logf(sc);
            }
          } else if (gr < M) {
            out = __fdiv_rn(X2[row * half + i] - v1, sc);
            if (!to_y) io.x[(size_t)gr * io.ldx + split + i] = out;
          }
          if (to_y) *reinterpret_cast<bf16*>(act_at(Y, row, split + i)) = f2bf(out);
        });
        if (to_y) {
          // zero y's pad columns up to the LinearLU's last K stage
          const int pad = (lat + WB - 1) / WB * WB - lat;
          for (int e = tid; e < BM * pad; e += CONSUMERS)
            *reinterpret_cast<bf16*>(act_at(Y, e / pad, lat + e % pad)) = f2bf(0.f);
        }
        if (KIND == COUPLING) {
          const int fr = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = quad_sum(lsum[h]);
            if (t % 4 == 0) red[wg * BM + fr + 8 * h] = v;
          }
          named_barrier(1, CONSUMERS);
          if (tid < BM && m0 + tid < M) {
            float v = 0.f;
            for (int w = 0; w < CWG; ++w) v += red[w * BM + tid];
            io.ldj[m0 + tid] = (io.ldj[m0 + tid] + v) + io.lu_ldj[0];
          }
        } else if (!to_y) {
          // layer 0 of the walk: x1 = y1 in f32
          for (int e = tid; e < BM * split; e += CONSUMERS) {
            const int gr = m0 + e / split, c = e % split;
            if (gr < M) io.x[(size_t)gr * io.ldx + c] = io.y[(size_t)gr * io.ldy + c];
          }
        }
      } else {
        // the LinearLU (forward) or the next layer's LU inverse: the f32 tile
        // staged over the activation buffers and the ring (every product is
        // done and nothing is loaded after this one), then written row by
        // row, 4 columns a thread: the f32 rows, the packed rows' bf16 x1
        // columns and the save row
        named_barrier(1, CONSUMERS);
        const int ldt = (lat + 7) / 8 * 8 + 8;
        float* T = reinterpret_cast<float*>(smem);
        for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int, float v0, float v1) {
          if (col < lat) *reinterpret_cast<float2*>(T + row * ldt + col) = make_float2(v0, v1);
        });
        named_barrier(1, CONSUMERS);
        float* dst = KIND == COUPLING ? io.x : io.y;
        const int ldd = KIND == COUPLING ? io.ldx : io.ldy;
        bf16* save = KIND == COUPLING ? io.save : nullptr;
        const bool vec = ldd % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                         io.ldxin % 4 == 0 && reinterpret_cast<uintptr_t>(io.xin) % 8 == 0 &&
                         (save == nullptr ||
                          (io.ldsave % 4 == 0 && reinterpret_cast<uintptr_t>(save) % 8 == 0));
        const int q4 = (lat + 3) / 4;
        for (int e = tid; e < BM * q4; e += CONSUMERS) {
          const int row = e / q4, c = 4 * (e % q4), gr = m0 + row;
          if (gr >= M) continue;
          const float* tv = T + row * ldt + c;
          float* dr = dst + (size_t)gr * ldd + c;
          bf16* xr = io.xin + (size_t)gr * io.ldxin + c;
          bf16* sr = save == nullptr ? nullptr : save + (size_t)gr * io.ldsave + c;
          if (vec && c + 4 <= lat) {
            const float4 v = *reinterpret_cast<const float4*>(tv);
            *reinterpret_cast<float4*>(dr) = v;
            uint2 packed;
            *reinterpret_cast<__nv_bfloat162*>(&packed.x) = __floats2bfloat162_rn(v.x, v.y);
            *reinterpret_cast<__nv_bfloat162*>(&packed.y) = __floats2bfloat162_rn(v.z, v.w);
            if (c + 4 <= split) {
              *reinterpret_cast<uint2*>(xr) = packed;
            } else {
              for (int k = 0; k < 4 && c + k < split; ++k) xr[k] = f2bf(tv[k]);
            }
            if (sr != nullptr) *reinterpret_cast<uint2*>(sr) = packed;
          } else {
            for (int k = 0; k < 4 && c + k < lat; ++k) {
              dr[k] = tv[k];
              if (c + k < split) xr[k] = f2bf(tv[k]);
              if (sr != nullptr) sr[k] = f2bf(tv[k]);
            }
          }
        }
      }
      fence_proxy_async();
      named_barrier(1, CONSUMERS);
      // B5's recompute: the activation (or the normalised row) the epilogue
      // wrote, now complete in shared memory
      if (pr.h != nullptr && !tail) record_rows(pr, act[last ? ybuf : a], m0, M);
      if (KIND == DGCNN_TAIL && p == plan.n_products - 1) {
        // the tile's output rows, 16 bytes a thread
        const int chunks = n / 8;
        for (int e = tid; e < BM * chunks; e += CONSUMERS) {
          const int row = e / chunks, c = 8 * (e % chunks), gr = m0 + row;
          if (gr < M)
            *reinterpret_cast<uint4*>(io.out + (size_t)gr * io.ldout + c) =
                *reinterpret_cast<const uint4*>(act_at(act[a], row, c));
        }
      }
      if (aug_out) {
        // the pass's z2 columns, then (after the last pass) ldj and z's x columns
        for (int e = tid; e < BM * P; e += CONSUMERS) {
          const int gr = m0 + e / P;
          if (gr < M) io.z[(size_t)gr * io.ldz + split + pofs + e % P] = E[e];
        }
        pofs += P;
        named_barrier(1, CONSUMERS);
        if (p == plan.n_products - 1) {
          const int fr = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = quad_sum(lsum_aug[h]);
            if (t % 4 == 0) red[wg * BM + fr + 8 * h] = v;
          }
          named_barrier(1, CONSUMERS);
          if (tid < BM && m0 + tid < M) {
            float v = 0.f;
            for (int w = 0; w < CWG; ++w) v += red[w * BM + tid];
            io.ldj[m0 + tid] = v;
          }
          for (int e = tid; e < BM * split; e += CONSUMERS) {
            const int gr = m0 + e / split, c = e % split;
            if (gr < M) io.z[(size_t)gr * io.ldz + c] = io.x[(size_t)gr * io.ldx + c];
          }
        }
      }
    }
  }
}

template <int KIND>
cudaError_t launch(const Plan& plan, const Rows& io, cudaStream_t stream) {
  static bool smem_set = false;   // the shared-memory opt-in, once per kernel
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_layer_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  fused_layer_kernel<KIND><<<(io.M + BM - 1) / BM, THREADS, SMEM_BYTES, stream>>>(plan, io);
  return cudaGetLastError();
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
  return cudaSuccess;
}

}  // namespace

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
// row's 1 / std; other calls pass nulls.
FC_API int fc_fused_layer(int kind, int n_products, int n_mlp,
                          const uint64_t* w, const int* w_ld, const int* w_layers, const int* k,
                          const int* n, const uint64_t* bias, int layer, int tail_layer,
                          const void* xin, int ldxin, int in_cols, int split, int half, int M,
                          void* x, int ldx, void* y, int ldy, void* ldj, const void* lu_ldj,
                          void* save, int ldsave, void* q, int ldq, float eps,
                          const uint64_t* rec_pre, const int* ld_pre, const uint64_t* rec_h,
                          const int* ld_h, const void* x1_src, int ld_x1src, void* ln_rstd,
                          void* stream) {
  if (kind < 0 || kind > 3 || n_products < 2 || n_products > MAX_PRODUCTS || n_mlp < 2 ||
      n_mlp > n_products ||
      n_products - n_mlp > 1 || M < 1 || in_cols > MAXW || split + half > MAXW ||
      k[0] != in_cols)
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
  const Rows io{(float*)x,  (float*)y, (float*)ldj, (const float*)lu_ldj, (bf16*)xin,
                (bf16*)save, (bf16*)q, (const bf16*)x1_src, (float*)ln_rstd, ldx, ldy, ldxin,
                ldsave, ldq,
                ld_x1src, M, split, half, eps};
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
// stacks as fc_fused_layer's, at layer 0.
FC_API int fc_dgcnn_tail(int n_products, const uint64_t* w, const int* w_ld, const int* w_layers,
                         const int* k, const int* n, const uint64_t* bias, const void* scale,
                         const void* xin, int ldxin, int M, void* out, int ldout, void* stream) {
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
  return (int)launch<DGCNN_TAIL>(plan, io, (cudaStream_t)stream);
}

// B2's net (kind 5) over M packed rows xin (bf16, TMA-readable, the first
// product's k columns): GELU after every product before the last two, a
// residual every second hidden one; the last two products are the output
// layer's column passes, (mean_i, log_std_i) interleaved, n[p] / 2 pairs
// each and aug in all. z (M, in_dim + aug, f32) = [x | mean + eps *
// exp(log_std)] and ldj (M) = sum(log 2pi / 2 + log_std + eps^2 / 2), from x
// (M, in_dim) and eps (M, aug) f32. Weight stacks as fc_fused_layer's, at
// layer 0.
FC_API int fc_augment_net(int n_products, const uint64_t* w, const int* w_ld,
                          const int* w_layers, const int* k, const int* n, const uint64_t* bias,
                          const void* xin, int ldxin, int M, int in_dim, const void* x, int ldx,
                          const void* eps, int ldeps, int aug, void* z, int ldz, void* ldj,
                          void* stream) {
  if (n_products < 3 || n_products > MAX_PRODUCTS || M < 1 || in_dim < 1 ||
      n[n_products - 1] % 2 || n[n_products - 2] % 2 ||
      n[n_products - 1] / 2 + n[n_products - 2] / 2 != aug || k[n_products - 1] != k[n_products - 2])
    return (int)cudaErrorInvalidValue;
  for (int p = 1; p < n_products - 1; ++p)
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
  return (int)launch<AUGMENT>(plan, io, (cudaStream_t)stream);
}
