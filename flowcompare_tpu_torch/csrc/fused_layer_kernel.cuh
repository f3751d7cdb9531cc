// The forward and record kernels of fused_layer.cu (see its header for what
// they compute and how), shared by the three translation units that
// instantiate them, which nvcc compiles in parallel: fused_layer.cu the
// one-pass kernels (tier ONE_PASS), fused_layer_wide.cu the wide ones
// (WIDE_TIER: products past PASS_W, K up to S_COLS, row-wise epilogues in
// one pass) and fused_layer_wider.cu the wider ones (WIDER_TIER: a K past
// S_COLS in halves, row-wise epilogues over passes). The plan and row
// tables are in a named namespace so that the units pass the same types to
// `fused_layer::launch_wide`.
#pragma once

#include "fused_layer.cuh"

namespace fused_layer {

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
  int n_out;                     // augment_net: the output layer's column passes, the last products
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
  uint8_t* scratch;    // the wide kernels' activation buffers, SCRATCH_TILE_BYTES a tile
};

// The wide kernel of `kind` (fused_layer_wide.cu) and the wider one
// (fused_layer_wider.cu).
cudaError_t launch_wide(int kind, const Plan& plan, const Rows& io, cudaStream_t stream);
cudaError_t launch_wider(int kind, const Plan& plan, const Rows& io, cudaStream_t stream);

}  // namespace fused_layer

namespace {

using namespace fused_layer;

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

template <int KIND, int TIER>
__global__ void __launch_bounds__(THREADS, 1)
    fused_layer_kernel(const __grid_constant__ Plan plan, const Rows io) {
  // the wider tier's paths are compiled into its own instances alone: each
  // costs the wide kernel's registers (96 a thread, with spills)
  constexpr bool WIDE = TIER >= WIDE_TIER, WIDER = TIER == WIDER_TIER;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], abar, ybar, sbar;
  uint8_t* smem = align1024(smem_raw);
  // the one-pass kernels' two activation buffers in shared memory; the wide
  // kernels' in the tile's device scratch, and their input buffer S (a
  // product's A operand) in shared memory in the two buffers' place
  uint8_t* const S = smem;
  uint8_t* act[2] = {smem, smem + ACT_BYTES};
  if (WIDE) {
    act[0] = io.scratch + (size_t)blockIdx.x * SCRATCH_TILE_BYTES;
    act[1] = act[0] + WIDE_ACT_BYTES;
  }
  // the wide kernels' stash of a row-wise epilogue's earlier passes
  float4* const stash = WIDER ? reinterpret_cast<float4*>(act[0] + STASH_OFFSET) : nullptr;
  uint8_t* const in_buf = WIDE ? S : act[1];
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
    mbar_init(&sbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CWG) {
    // the producer: the block's input rows once, then every pass's weights
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
        tma_load(in_buf + a * ATOM_BYTES, &plan.in, &abar, 64 * a, m0);
      int it = 0;
      for (int p = 0; p < plan.n_products; ++p) {
        const Product& pr = plan.prod[p];
        const int passes = WIDE ? pass_count(pr.n) : 1;
        for (int j = 0; j < passes; ++j)
          produce_weights(&plan.w[p], pr.k, PASS_CHUNKS * j,
                          WIDE ? pass_span(pr.n, j).nch : (pr.n + 63) / 64, pr.layer, ring, full,
                          empty, it);
      }
    }
    __syncwarp();
  } else {
    const int tid = threadIdx.x;
    const int t = tid % 128;
    const int M = io.M, split = io.split, half = io.half, lat = split + half;
    int it = 0;
    int a = 1, r = 0, ybuf = 0;
    int s_holds = -1;                 // wide: the buffer whose copy S holds (-1: the input)
    int s_half = 0;                   // wider: which S_COLS columns of it
    uint32_t s_phase = 0;             // wide: the parity of S's next bulk copy
    float lsum_aug[2] = {0.f, 0.f};   // augment_net: this thread's rows' ldj terms
    int pofs = 0;                     // augment_net: the pairs of the passes before
    // wider: this thread's two rows' sums over the passes of a row-wise
    // epilogue, the affine's log-scales and the LayerNorm's sum and sum of
    // squares
    float lsum_w[2] = {0.f, 0.f}, ln_s1[2] = {0.f, 0.f}, ln_s2[2] = {0.f, 0.f};
    // wider: S := half h of buffer b (every consumer calls it, past a
    // barrier after S's last reader)
    const auto hold = [&](int b, int h, int k) {
      if (b == s_holds && h == s_half) return;
      if (tid == 0) copy_to_s(S, act[b], k, h, &sbar);
      mbar_wait(&sbar, s_phase);
      s_phase ^= 1;
      s_holds = b;
      s_half = h;
    };
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
        *reinterpret_cast<bf16*>(act_at(in_buf, row, c)) = v;
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
      uint8_t* A = WIDE ? S : act[tail ? ybuf : a];
      if (last) {
        ybuf = 1 - a;
        if (!WIDE && KIND != CONDITIONER && to_y && tid == 0) {
          // y's x1 half: the packed rows' bf16 x1 columns, zero past split
          const int atoms = (split + 63) / 64;
          mbar_expect_tx(&ybar, atoms * ATOM_BYTES);
          for (int c = 0; c < atoms; ++c)
            tma_load(act[ybuf] + c * ATOM_BYTES, &plan.x1, &ybar, 64 * c, m0);
        }
      }
      // augment_net's output passes: the pass's eps columns, f32, into the
      // buffer the input does not use (free since the last product's barrier)
      const bool aug_out = KIND == AUGMENT && p >= plan.n_products - plan.n_out;
      const int P = n / 2;
      float* E = reinterpret_cast<float*>(act[1 - a]);
      if (aug_out) {
        for (int e = tid; e < BM * P; e += CONSUMERS) {
          const int gr = m0 + e / P;
          E[e] = gr < M ? io.noise[(size_t)gr * io.ldnoise + pofs + e % P] : 0.f;
        }
        named_barrier(1, CONSUMERS);
      }
      // the buffer a bf16 epilogue writes: conv5's and the tail's last
      // product the free one; the first and hidden products GELU, a residual
      // every second hidden one (the tail's MLP starts after conv5)
      const bool dgcnn_end = KIND == DGCNN_TAIL && (p == 0 || p == plan.n_products - 1);
      const bool hidden = !dgcnn_end && !aug_out && !last && !tail;
      const int k_hidden = p - 1 - (KIND == DGCNN_TAIL ? 1 : 0);
      const bool add_res = hidden && k_hidden >= 0 && (k_hidden & 1);
      int o_buf = a;
      if (dgcnn_end) {
        o_buf = 1 - a;
      } else if (hidden) {
        if (add_res) {
          o_buf = r;
        } else {
          if (k_hidden >= 0) r = a;
          o_buf = 1 - a;
        }
      }
      uint8_t* O = act[o_buf];
      uint8_t* R = act[r];
      // a product wider than PASS_W (the wide kernels' elementwise epilogues:
      // conv5, GELU, the head's last product, q, [s | t]'s record) in passes
      const int passes = WIDE ? pass_count(n) : 1;
      const int cpw_all = frag_cpw(n);
      for (int j = 0; j < passes; ++j) {
        const PassSpan ps = WIDE ? pass_span(n, j) : PassSpan{(n + 63) / 64, cpw_all, 0};
        const int nch = ps.nch, cpw = ps.cpw, cl = wg * cpw;
        const int cnt = min(max(nch - cl, 0), cpw), c0 = PASS_CHUNKS * j + cl;
        float acc[64];
        if (WIDER && pr.k > S_COLS) {
          // a K deeper than S: the input's first S_COLS columns, then S
          // refilled with the rest, each pass (such an input is act[a]: the
          // first product's and a tail's K are at most S_COLS)
          named_barrier(1, CONSUMERS);
          hold(a, 0, pr.k);
          consume_weights(acc, S, S_COLS, cl, cnt, ring, full, empty, it);
          named_barrier(1, CONSUMERS);
          hold(a, 1, pr.k);
          consume_weights(acc, S, pr.k - S_COLS, cl, cnt, ring, full, empty, it, true);
        } else {
          consume_weights(acc, A, pr.k, cl, cnt, ring, full, empty, it);
        }

        if (dgcnn_end) {
          // conv5 with its folded BatchNorm, leaky(v * a5 + b5) rounded as the
          // plain version rounds it, or the head's last product, v + b: bf16
          // into the free buffer, stored from there after the barrier
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
        } else if (hidden) {
          if (pr.pre != nullptr) {
            // B5's recompute: GELU' at the f32 pre-activations, in the
            // accumulator's order
            add_bias_res(acc, cnt, c0, bias, n, add_res ? R : nullptr);
            gelu_record(acc, cnt, c0, pr.pre, cpw_all, ps.k0, O);
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
        } else if (KIND == CONDITIONER && last && !WIDER) {
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
          uint8_t* Y = act[ybuf];
          for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int h, float v0, float v1) {
            st_pair(Y, row, col, col < n ? (v0 - mean[h]) * inv[h] : 0.f,
                    col + 1 < n ? (v1 - mean[h]) * inv[h] : 0.f);
          });
        } else if (KIND == CONDITIONER && last) {
          // LayerNorm of the f32 row (plain statistics; scale and bias are in
          // wq_f). A row wider than a pass: each thread's sums over its two
          // rows run on over the passes, and a pass before the last waits in
          // the stash (this thread's own elements) until they are known
          add_bias_res(acc, cnt, c0, bias, n, nullptr);
          for_pairs(acc, cnt, c0, nullptr, n, [&](int, int, int h, float v0, float v1) {
            ln_s1[h] += v0 + v1;
            ln_s2[h] += v0 * v0 + v1 * v1;
          });
          if (j + 1 < passes) {
            stash_pass(stash, j, acc, cnt);
            continue;
          }
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
          row_total(ln_s1);
          row_total(ln_s2);
          float mean[2], inv[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mean[h] = ln_s1[h] / n;
            inv[h] = rsqrtf(ln_s2[h] / n - mean[h] * mean[h] + 1e-5f);
          }
          if (pr.pre != nullptr && wg == 0 && t % 4 == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (m0 + fr + 8 * h < M) io.ln_rstd[m0 + fr + 8 * h] = inv[h];
          }
          // a pass's normalised row: bf16 into Y and, for B5's recompute, in
          // f32 (xhat) in the accumulator's order
          uint8_t* Y = act[ybuf];
          const auto normalise = [&](int cnt_j, int c0_j, int k0_j) {
            if (pr.pre != nullptr) {
#pragma unroll
              for (int k = 0; k < 16; ++k)
                if (k < 8 * cnt_j)
                  *frag_ptr(pr.pre, cpw_all, k0_j + k) = make_float4(
                      (acc[4 * k] - mean[0]) * inv[0], (acc[4 * k + 1] - mean[0]) * inv[0],
                      (acc[4 * k + 2] - mean[1]) * inv[1], (acc[4 * k + 3] - mean[1]) * inv[1]);
            }
            for_pairs(acc, cnt_j, c0_j, nullptr, n, [&](int row, int col, int h, float v0, float v1) {
              st_pair(Y, row, col, col < n ? (v0 - mean[h]) * inv[h] : 0.f,
                      col + 1 < n ? (v1 - mean[h]) * inv[h] : 0.f);
            });
          };
          normalise(cnt, c0, ps.k0);
          for (int jj = 0; jj < j; ++jj) {
            const PassSpan pj = pass_span(n, jj);
            const int cnt_j = min(max(pj.nch - wg * pj.cpw, 0), pj.cpw);
            unstash_pass(stash, jj, acc, cnt_j);
            normalise(cnt_j, PASS_CHUNKS * jj + wg * pj.cpw, pj.k0);
          }
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
        } else if (last && !WIDER) {
          // [s | t] interleaved: the affine (forward) or its inverse on the
          // registers. The tile's x2 (forward) or y2 (inverse), f32, staged
          // once every warpgroup's products are done, read coalesced: over
          // the A buffer, or in the wide kernels over S's second half, whose
          // first half takes y (S is free now), its x1 columns loaded here
          named_barrier(1, CONSUMERS);
          if (WIDE && to_y && tid == 0) {
            const int atoms = (split + 63) / 64;
            mbar_expect_tx(&ybar, atoms * ATOM_BYTES);
            for (int c = 0; c < atoms; ++c)
              tma_load(S + c * ATOM_BYTES, &plan.x1, &ybar, 64 * c, m0);
          }
          float* X2 = reinterpret_cast<float*>(WIDE ? S + ACT_BYTES : act[a]);
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
          uint8_t* Y = WIDE ? S : act[ybuf];
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
        } else if (last) {
          // [s | t] interleaved: the affine (forward) or its inverse on the
          // registers, each pass holding whole pairs. One pass: the tile's
          // x2 (forward) or y2 (inverse), f32, staged once every warpgroup's
          // products are done, read coalesced: over the A buffer, or in the
          // wide kernels over S's second half, whose first half takes y (S is
          // free now), its x1 columns loaded here. More passes (the wide
          // kernels, a latent past PASS_W): S holds the input until the last
          // pass, so x2 / y2 is read from the f32 rows where it lies and y
          // goes to the scratch (act[ybuf]), its x1 columns copied there
          const bool staged = passes == 1;
          float* X2 = reinterpret_cast<float*>(S + ACT_BYTES);
          const float* src = (KIND == COUPLING ? io.x : io.y) + split;
          const int lds = KIND == COUPLING ? io.ldx : io.ldy;
          if (staged) {
            named_barrier(1, CONSUMERS);
            if (to_y && tid == 0) {
              const int atoms = (split + 63) / 64;
              mbar_expect_tx(&ybar, atoms * ATOM_BYTES);
              for (int c = 0; c < atoms; ++c)
                tma_load(S + c * ATOM_BYTES, &plan.x1, &ybar, 64 * c, m0);
            }
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
            named_barrier(1, CONSUMERS);
            if (to_y) mbar_wait(&ybar, 0);
          }
          uint8_t* Y = staged ? S : act[ybuf];
          if (!staged && j == 0 && to_y) {
            for (int e = tid; e < BM * split; e += CONSUMERS) {
              const int row = e / split, c = e % split, gr = m0 + row;
              *reinterpret_cast<bf16*>(act_at(Y, row, c)) =
                  gr < M ? io.xin[(size_t)gr * io.ldxin + c] : f2bf(0.f);
            }
          }
          for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int h, float v0, float v1) {
            const int i = col >> 1;
            if (i >= half) return;
            const float sc = sigmoid_scale(v0, io.eps);
            const int gr = m0 + row;
            float out = 0.f;
            if (gr < M) {
              const float x2 = staged ? X2[row * half + i] : src[(size_t)gr * lds + i];
              if (KIND == COUPLING) {
                out = x2 * sc + v1;
                lsum_w[h] += logf(sc);
              } else {
                out = __fdiv_rn(x2 - v1, sc);
                if (!to_y) io.x[(size_t)gr * io.ldx + split + i] = out;
              }
            }
            if (to_y) *reinterpret_cast<bf16*>(act_at(Y, row, split + i)) = f2bf(out);
          });
          if (to_y && (staged || j == 0)) {
            // zero y's pad columns up to the LinearLU's last K stage
            const int pad = (lat + WB - 1) / WB * WB - lat;
            for (int e = tid; e < BM * pad; e += CONSUMERS)
              *reinterpret_cast<bf16*>(act_at(Y, e / pad, lat + e % pad)) = f2bf(0.f);
          }
          if (j + 1 < passes) continue;
          if (KIND == COUPLING) {
            const int fr = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = quad_sum(lsum_w[h]);
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
          if (WIDER && passes > 1) {
            // a latent past one pass: the LinearLU (forward) or the next
            // layer's LU inverse a pass at a time from the registers (the
            // ring is still filling and S holds y until the last pass) into
            // the f32 rows, the packed rows' bf16 x1 columns and the save row
            float* dst = KIND == COUPLING ? io.x : io.y;
            const int ldd = KIND == COUPLING ? io.ldx : io.ldy;
            bf16* save = KIND == COUPLING ? io.save : nullptr;
            for_pairs(acc, cnt, c0, bias, n, [&](int row, int col, int, float v0, float v1) {
              const int gr = m0 + row;
              if (gr >= M || col >= lat) return;
              const float v[2] = {v0, v1};
              for (int k = 0; k < 2 && col + k < lat; ++k) {
                dst[(size_t)gr * ldd + col + k] = v[k];
                if (col + k < split) io.xin[(size_t)gr * io.ldxin + col + k] = f2bf(v[k]);
                if (save != nullptr) save[(size_t)gr * io.ldsave + col + k] = f2bf(v[k]);
              }
            });
            continue;
          }
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
      }
      a = o_buf;
      fence_proxy_async();
      // the wide kernels' activation stores, before a bulk copy reads them
      if (WIDE) fence_proxy_async_global();
      named_barrier(1, CONSUMERS);
      if (WIDE && !WIDER && p + 1 < plan.n_products) {
        // the next product's input into S (a copy of it stays in the
        // scratch for a later residual), unless S holds it already or the
        // affine wrote y there
        const int next = p + 1 == plan.n_mlp ? ybuf : a;
        const bool y_in_s = (KIND == COUPLING || KIND == COUPLING_INVERSE) && last;
        if (!y_in_s && next != s_holds) {
          if (tid == 0) {
            const uint32_t bytes = (uint32_t)((plan.prod[p + 1].k + 63) / 64 * ATOM_BYTES);
            mbar_expect_tx(&sbar, bytes);
            bulk_copy(S, act[next], bytes, &sbar);
          }
          mbar_wait(&sbar, s_phase);
          s_phase ^= 1;
          s_holds = next;
        }
      }
      if (WIDER && p + 1 < plan.n_products) {
        // the next product's input (its first S_COLS columns) into S (a
        // copy of it stays in the scratch for a later residual or half),
        // unless S holds it already or the one-pass affine wrote y there
        const int next = p + 1 == plan.n_mlp ? ybuf : a;
        const bool y_in_s =
            (KIND == COUPLING || KIND == COUPLING_INVERSE) && last && passes == 1;
        if (!y_in_s) hold(next, 0, plan.prod[p + 1].k);
      }
      // B5's recompute: the activation (or the normalised row) the epilogue
      // wrote, now complete
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

template <int KIND, int TIER>
cudaError_t launch_kind(const Plan& plan, const Rows& io, cudaStream_t stream) {
  static bool smem_set = false;   // the shared-memory opt-in, once per kernel
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_layer_kernel<KIND, TIER>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  fused_layer_kernel<KIND, TIER>
      <<<(io.M + BM - 1) / BM, THREADS, SMEM_BYTES, stream>>>(plan, io);
  return cudaGetLastError();
}

}  // namespace
