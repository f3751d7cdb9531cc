// The backward kernels of fused_layer_bwd.cu (see its header for what they
// compute and how), shared by the two translation units that instantiate
// them, which nvcc compiles in parallel: fused_layer_bwd.cu the one-pass
// and wide tiers, fused_layer_bwd_wider.cu the wider one
// (fused_layer.cuh's Tier). The plan and row tables are in a named
// namespace so that both units pass the same types to
// `fused_layer_bwd::launch_bwd_wider`.
#pragma once

#include "fused_layer.cuh"

namespace fused_layer_bwd {

enum BwdKind { COUPLING_BWD = 0, CONDITIONER_BWD = 1 };

struct BwdProduct {
  int k, n;             // the product's depth (rows of W^T) and output columns
  const float* pre;     // f32 the epilogue reads at its elements: GELU' at
                        // the pre-activations (hidden) or the normalised row
                        // (conditioner head) in the accumulator's order
                        // (frag_ptr), or [s | t] interleaved, row-major
                        // (coupling head)
  const float* res_in;  // f32 residual gradient added before GELU', frag_ptr order (or null)
  float* res_out;       // f32 copy of this product's dp for a later residual, likewise (or null)
  bf16* d_out;          // bf16 copy of dp for the weight gradients (null: the tail)
  float* colsum;        // per-tile column sums of the f32 dp, (tiles, cs_n); the coupling
                        // head's (tiles x groups, cs_n), groups = CONSUMERS / half (null: the tail)
  int ld_pre, ld_d, cs_n;
};

struct BwdPlan {
  CUtensorMap w[MAX_PRODUCTS];   // product p's W^T stack (n, k, L), boxes 64 x WB x 1
  BwdProduct prod[MAX_PRODUCTS];
  int n_products, layer;
};

struct BwdRows {
  const float* src;    // the head's input: g (coupling) or dq (conditioner), f32
  bf16* src_b;         // coupling: bf16(g) out
  float* src_colsum;   // per-tile column sums of src, (tiles, src_cols)
  float* g_next;       // the next carry gradient (coupling writes it, both add to x1's)
  const bf16* x;       // coupling: the layer's bf16 save
  const float* dldj;   // coupling
  bf16* y;             // coupling: y = bf16([x1 | x2 * scale + t]) out
  float* dextra;       // coupling: extra's gradient, added to (or null)
  float* dcond;        // coupling: the cond columns' gradient (written, or added to)
  const float* ln_rstd;  // conditioner: each row's LayerNorm 1 / std
  int ld_src, ld_src_b, ld_g, ld_x, ld_y, ld_extra, ld_cond;
  int accumulate_cond, M, src_cols, split, half, xe, xc, cond;
  float eps;
  uint8_t* scratch;      // the wide kernel's activation buffers, SCRATCH_TILE_BYTES a tile
};

// The wider kernel of `kind` (fused_layer_bwd_wider.cu).
cudaError_t launch_bwd_wider(int kind, const BwdPlan& plan, const BwdRows& io,
                             cudaStream_t stream);

}  // namespace fused_layer_bwd

namespace {

using namespace fused_layer_bwd;

// f(row, col, h, v0, v1) with v0, v1 references to this thread's sums at
// rows fr + 8 h and columns col, col + 1 of its cnt chunks from chunk c0.
template <class F>
__device__ __forceinline__ void for_acc_pairs(float (&acc)[64], int cnt, int c0, F f) {
  const int t = threadIdx.x % 128;
  const int fr = (t / 32) * 16 + (t % 32) / 4, fc = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (i < cnt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(fr + 8 * h, (c0 + i) * 64 + 8 * j + fc, h, acc[i * 32 + 4 * j + 2 * h],
            acc[i * 32 + 4 * j + 2 * h + 1]);
}

// out[map(col)] = the sum over the tile's 64 rows of v at column col, for
// this warpgroup's columns where map(col) >= 0: the two rows a thread
// holds, then the warp's 8 row groups by shuffles, then the 4 warps in
// order through `scratch` (512 floats of this warpgroup's).
template <class Map>
__device__ __forceinline__ void col_sums(const float (&v)[64], int cnt, int c0, float* scratch,
                                         float* out, Map map) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, fc = 2 * (t % 4);
  const int bar = 2 + threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (i < cnt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float s = v[i * 32 + 4 * j + b] + v[i * 32 + 4 * j + 2 + b];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (lane < 4) scratch[warp * 128 + i * 64 + 8 * j + fc + b] = s;
        }
  named_barrier(bar, 128);
  for (int lc = t; lc < cnt * 64; lc += 128) {
    const int oc = map(c0 * 64 + lc);
    if (oc >= 0)
      out[oc] = ((scratch[lc] + scratch[128 + lc]) + scratch[256 + lc]) + scratch[384 + lc];
  }
  named_barrier(bar, 128);
}

// v[h] = the sum over the row's columns of every warpgroup (each thread
// gives its partial; the 4 threads of a row, then the warpgroups in order).
__device__ __forceinline__ void row_totals(float (&v)[2], float* red) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int fr = (t / 32) * 16 + (t % 32) / 4;
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
}

__device__ __forceinline__ void prefetch_rows(const void* base, int ld, int elt, int m0, int M) {
  if (base == nullptr) return;
  const char* start = reinterpret_cast<const char*>(base) + (size_t)m0 * ld * elt;
  const uint32_t bytes = (uint32_t)(min(BM, M - m0) * ld * elt);
  if (reinterpret_cast<uintptr_t>(start) % 16 == 0 && bytes % 16 == 0)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(start), "r"(bytes)
                 : "memory");
}

template <int KIND, int TIER>
__global__ void __launch_bounds__(THREADS, 1)
    fused_layer_bwd_kernel(const __grid_constant__ BwdPlan plan, const BwdRows io) {
  // as fused_layer.cu's tiers: the wider paths in their own instances
  constexpr bool WIDE = TIER >= WIDE_TIER, WIDER = TIER == WIDER_TIER;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], sbar;
  uint8_t* smem = align1024(smem_raw);
  // as fused_layer.cu: the one-pass kernel's two buffers in shared memory;
  // the wide kernel's in the tile's scratch, its input buffer S in their place
  uint8_t* const S = smem;
  uint8_t* act[2] = {smem, smem + ACT_BYTES};
  if (WIDE) {
    act[0] = io.scratch + (size_t)blockIdx.x * SCRATCH_TILE_BYTES;
    act[1] = act[0] + WIDE_ACT_BYTES;
  }
  float4* const stash = WIDER ? reinterpret_cast<float4*>(act[0] + STASH_OFFSET) : nullptr;
  float* const csum = WIDER ? reinterpret_cast<float*>(act[0] + STASH_OFFSET + STASH_BYTES)
                            : nullptr;
  uint8_t* ring = smem + 2 * ACT_BYTES;
  float* red = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  const int m0 = blockIdx.x * BM, M = io.M;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], EMPTY_ARRIVALS);
    }
    mbar_init(&sbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CWG) {
    // the producer: each pass's weights and, after a hidden product's pass's
    // weights, the tile's blocks of the pass's recorded GELU' (and residual
    // gradient) in ring-stage chunks of 4 float4 a consumer thread, which
    // its epilogue reads from shared memory; the head's f32 rows into L2
    if (threadIdx.x == CONSUMERS) {
      const BwdProduct& p0 = plan.prod[0];
      if (KIND == COUPLING_BWD) {
        prefetch_rows(p0.pre, p0.ld_pre, 4, m0, M);
        prefetch_rows(io.x, io.ld_x, 2, m0, M);
      } else {
        prefetch_frag(p0.pre, frag_cpw(p0.n));
      }
      int it = 0;
      for (int p = 0; p < plan.n_products; ++p) {
        const BwdProduct& pr = plan.prod[p];
        const int passes = WIDE ? pass_count(pr.n) : 1;
        for (int j = 0; j < passes; ++j) {
          const PassSpan ps = WIDE ? pass_span(pr.n, j) : PassSpan{(pr.n + 63) / 64,
                                                                   frag_cpw(pr.n), 0};
          produce_weights(&plan.w[p], pr.k, PASS_CHUNKS * j, ps.nch, plan.layer, ring, full,
                          empty, it);
          if (p == 0 || p == plan.n_products - 1) continue;
          const size_t block =
              ((size_t)blockIdx.x * frag_cpw(pr.n) * 8 + ps.k0) * CONSUMERS * sizeof(float4);
          for (int c = 0; c < 2 * ps.cpw; ++c) {
            for (int r = 0; r < (pr.res_in != nullptr ? 2 : 1); ++r) {
              const float* src = r ? pr.res_in : pr.pre;
              const int s = it % STAGES;
              mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
              mbar_expect_tx(&full[s], STAGE_BYTES);
              bulk_copy(ring + s * STAGE_BYTES,
                        reinterpret_cast<const char*>(src) + block + (size_t)c * STAGE_BYTES,
                        STAGE_BYTES, &full[s]);
              ++it;
            }
          }
        }
      }
    }
    __syncwarp();
    return;
  }

  const int tid = threadIdx.x;
  const int split = io.split, half = io.half;
  // the head's input tile: src (f32) -> bf16 in act[0] (the wide kernel's
  // S), zero to the next 64 columns and past M; its per-tile column sums;
  // coupling: bf16(g) out
  {
    uint8_t* const in_buf = WIDE ? S : act[0];
    const int cols = io.src_cols, padded = (cols + 63) / 64 * 64;
    for (int c = tid; c < padded; c += CONSUMERS) {
      float sum = 0.f;
#pragma unroll 8
      for (int row = 0; row < BM; ++row) {
        const int gr = m0 + row;
        const bool in = c < cols && gr < M;
        const float v = in ? io.src[(size_t)gr * io.ld_src + c] : 0.f;
        sum += v;
        const bf16 b = f2bf(v);
        *reinterpret_cast<bf16*>(act_at(in_buf, row, c)) = b;
      }
      if (c < cols) io.src_colsum[(size_t)blockIdx.x * cols + c] = sum;
    }
    fence_proxy_async();
    named_barrier(1, CONSUMERS);
    if (KIND == COUPLING_BWD) {
      // bf16(g) for the LinearLU's weight gradient, 16 bytes a thread
      const int chunks = (cols + 7) / 8;
      for (int e = tid; e < BM * chunks; e += CONSUMERS) {
        const int row = e / chunks, c = 8 * (e % chunks), gr = m0 + row;
        if (gr < M)
          *reinterpret_cast<uint4*>(io.src_b + (size_t)gr * io.ld_src_b + c) =
              *reinterpret_cast<const uint4*>(act_at(in_buf, row, c));
      }
    }
  }

  int it = 0, a = 0;
  uint32_t s_phase = 0;
  int s_half = 0;   // wider: which S_COLS columns of act[a]'s input S holds
  // wider: the LayerNorm's transpose, this thread's two rows' sums of g and
  // g xhat over the passes
  float gs_w[2] = {0.f, 0.f}, gxs_w[2] = {0.f, 0.f};
  for (int p = 0; p < plan.n_products; ++p) {
    const BwdProduct& pr = plan.prod[p];
    const int n = pr.n;
    const bool head = p == 0, tail = p == plan.n_products - 1;
    // a product wider than PASS_W (the wide kernel's hidden products and
    // the tail) in passes
    const int passes = WIDE ? pass_count(n) : 1;
    const int cpw_all = frag_cpw(n);
    uint8_t* O = act[1 - a];
    float* cs = pr.colsum == nullptr ? nullptr : pr.colsum + (size_t)blockIdx.x * pr.cs_n;
    for (int j = 0; j < passes; ++j) {
      const PassSpan ps = WIDE ? pass_span(n, j) : PassSpan{(n + 63) / 64, cpw_all, 0};
      const int nch = ps.nch, cpw = ps.cpw, cl = wg * cpw;
      const int cnt = min(max(nch - cl, 0), cpw), c0 = PASS_CHUNKS * j + cl;
      float acc[64];
      if (WIDER && pr.k > S_COLS) {
        // a K deeper than S (never the head's): the input's first S_COLS
        // columns from act[a], then S refilled with the rest, each pass
        const auto hold = [&](int h) {
          if (h == s_half) return;
          named_barrier(1, CONSUMERS);
          if (tid == 0) copy_to_s(S, act[a], pr.k, h, &sbar);
          mbar_wait(&sbar, s_phase);
          s_phase ^= 1;
          s_half = h;
        };
        hold(0);
        consume_weights(acc, S, S_COLS, cl, cnt, ring, full, empty, it);
        hold(1);
        consume_weights(acc, S, pr.k - S_COLS, cl, cnt, ring, full, empty, it, true);
      } else {
        consume_weights(acc, WIDE ? S : act[a], pr.k, cl, cnt, ring, full, empty, it);
      }
      // every warpgroup is done with this pass's products: act[a] (the
      // one-pass kernel's input buffer, the wide kernel's scratch copy of S)
      // is the column sums' scratch now; the wider kernel's must keep the
      // input's halves, and its partials take their own
      named_barrier(1, CONSUMERS);
      float* scratch = (WIDER ? csum : reinterpret_cast<float*>(act[a])) + wg * 512;

      if (tail) {
        // the input's gradient: x1's added to the carry gradient; coupling:
        // extra's added, the cond columns' written or added. Each group of
        // four elements loads what it adds to before any of its stores.
        const int t = tid % 128, fr = (t / 32) * 16 + (t % 32) / 4, fc = 2 * (t % 4);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (k >= 8 * cnt) continue;
          const int col = (c0 + k / 8) * 64 + 8 * (k % 8) + fc;
          float* dst[4];
          float old[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int gr = m0 + fr + 8 * (q >> 1), c = col + (q & 1);
            dst[q] = nullptr;
            if (gr < M) {
              if (c < split)
                dst[q] = io.g_next + (size_t)gr * io.ld_g + c;
              else if (KIND == COUPLING_BWD && c < io.xe && io.dextra != nullptr)
                dst[q] = io.dextra + (size_t)gr * io.ld_extra + c - split;
              else if (KIND == COUPLING_BWD && c >= io.xc && c < io.xc + io.cond)
                dst[q] = io.dcond + (size_t)gr * io.ld_cond + c - io.xc;
            }
            // everything adds but the attention's da, which is written
            const bool add =
                dst[q] != nullptr && !(KIND == COUPLING_BWD && c >= io.xc && !io.accumulate_cond);
            old[q] = add ? *dst[q] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (dst[q] != nullptr) *dst[q] = old[q] + acc[4 * k + q];
        }
      } else if (head && KIND == COUPLING_BWD) {
        // dy -> the affine's transpose at the save. dy1 goes straight into the
        // carry gradient; dy2 is staged in f32, row-major, over this product's
        // A buffer (free now; half <= 256 columns fit its 64 KB, the wide
        // kernel's scratch buffer half <= 512 over both passes), then, after
        // the last pass, a row-major pass, `groups` threads a column and a
        // band of rows each, reads [s | t] and x2 coalesced, writes y and dy2
        // * scale coalesced, d[s | t] in plain order into O (ds_i at column
        // i, dt_i = dy2_i at half + i), and each band's column sums of ds and
        // dt (the head's colsum rows: `groups` a tile, in band order).
        float* dy2s = reinterpret_cast<float*>(act[a]);
        for_acc_pairs(acc, cnt, c0, [&](int row, int col, int, float& v0, float& v1) {
          const int gr = m0 + row;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int c = col + b;
            const float v = b ? v1 : v0;
            if (c < split) {
              if (gr < M) io.g_next[(size_t)gr * io.ld_g + c] = v;
            } else if (c < n) {
              dy2s[row * half + c - split] = v;
            }
          }
        });
        if (WIDER && j + 1 < passes) continue;
        named_barrier(1, CONSUMERS);
        for (int e = tid; e < BM * split; e += CONSUMERS) {
          const int gr = m0 + e / split, c = e % split;
          if (gr < M) io.y[(size_t)gr * io.ld_y + c] = io.x[(size_t)gr * io.ld_x + c];
        }
        const int groups = CONSUMERS / half, band = (BM + groups - 1) / groups;
        if (tid < groups * half) {
          const int i = tid % half, grp = tid / half;
          const int r0 = grp * band, r1 = min(BM, r0 + band);
          const float keep = 1.f - io.eps;
          float sum_ds = 0.f, sum_dt = 0.f;
          for (int row = r0; row < r1; row += 2) {
            // both rows' inputs first, so their latencies overlap
            float2 st[2];
            float x2[2], dl[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int gr = m0 + row + u;
              const bool ok = row + u < r1 && gr < M;
              st[u] = ok ? *reinterpret_cast<const float2*>(pr.pre + (size_t)gr * pr.ld_pre + 2 * i)
                         : make_float2(0.f, 0.f);
              x2[u] = ok ? bf2f(io.x[(size_t)gr * io.ld_x + split + i]) : 0.f;
              dl[u] = ok ? io.dldj[gr] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (row + u >= r1) break;
              const int gr = m0 + row + u;
              float ds = 0.f, dt = 0.f;
              if (gr < M) {
                dt = dy2s[(row + u) * half + i];
                const float sig = 1.f / (1.f + expf(-st[u].x));
                const float sc = (2.f * sig - 1.f) * keep + 1.f;
                io.y[(size_t)gr * io.ld_y + split + i] = f2bf(x2[u] * sc + st[u].y);
                io.g_next[(size_t)gr * io.ld_g + split + i] = dt * sc;
                ds = (dt * x2[u] + dl[u] / sc) * keep * 2.f * sig * (1.f - sig);
              }
              *reinterpret_cast<bf16*>(act_at(O, row + u, i)) = f2bf(ds);
              *reinterpret_cast<bf16*>(act_at(O, row + u, half + i)) = f2bf(dt);
              sum_ds += ds;
              sum_dt += dt;
            }
          }
          float* out = pr.colsum + ((size_t)blockIdx.x * groups + grp) * pr.cs_n;
          out[i] = sum_ds;
          out[half + i] = sum_dt;
        }
        // O's columns past 2 half, up to the next product's last stage, are zero
        const int w2 = 2 * half, pad = (w2 + 63) / 64 * 64 - w2;
        for (int e = tid; e < BM * pad; e += CONSUMERS)
          *reinterpret_cast<bf16*>(act_at(O, e / pad, w2 + e % pad)) = f2bf(0.f);
      } else if (head && !WIDER) {
        // dqn -> the LayerNorm's transpose from the recorded normalised row
        // xhat (the accumulator's order) and 1 / std (rstd):
        // rstd * (g - mean(g) - xhat * mean(g * xhat))
        const int t = tid % 128, fr = (t / 32) * 16 + (t % 32) / 4, fc = 2 * (t % 4);
        float rstd[2], gs[2] = {0.f, 0.f}, gxs[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) rstd[h] = m0 + fr + 8 * h < M ? io.ln_rstd[m0 + fr + 8 * h] : 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (k < 8 * cnt) {
            const float4 x4 = *frag_ptr(pr.pre, cpw, k);
            const float x[4] = {x4.x, x4.y, x4.z, x4.w};
            const int col = (c0 + k / 8) * 64 + 8 * (k % 8) + fc;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float& v = acc[4 * k + q];
              if (m0 + fr + 8 * (q >> 1) < M && col + (q & 1) < n) {
                gs[q >> 1] += v;
                gxs[q >> 1] += v * x[q];
              } else {
                v = 0.f;
              }
            }
          }
        }
        row_totals(gs, red);
        row_totals(gxs, red);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (k < 8 * cnt) {
            const float4 x4 = *frag_ptr(pr.pre, cpw, k);
            const float x[4] = {x4.x, x4.y, x4.z, x4.w};
            const int col = (c0 + k / 8) * 64 + 8 * (k % 8) + fc;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int h = q >> 1;
              float& v = acc[4 * k + q];
              if (m0 + fr + 8 * h < M && col + (q & 1) < n)
                v = rstd[h] * (v - gs[h] / n - x[q] * (gxs[h] / n));
            }
            st_pair(O, fr, col, acc[4 * k], acc[4 * k + 1]);
            st_pair(O, fr + 8, col, acc[4 * k + 2], acc[4 * k + 3]);
          }
        }
        col_sums(acc, cnt, c0, scratch, cs, [&](int c) { return c < n ? c : -1; });
      } else if (head) {
        // dqn -> the LayerNorm's transpose from the recorded normalised row
        // xhat (the accumulator's order) and 1 / std (rstd):
        // rstd * (g - mean(g) - xhat * mean(g * xhat)). A row wider than a
        // pass: the sums run on over the passes, and a pass before the last
        // waits in the stash (this thread's own elements) until they are known
        const int t = tid % 128, fr = (t / 32) * 16 + (t % 32) / 4, fc = 2 * (t % 4);
        float rstd[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) rstd[h] = m0 + fr + 8 * h < M ? io.ln_rstd[m0 + fr + 8 * h] : 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (k < 8 * cnt) {
            const float4 x4 = *frag_ptr(pr.pre, cpw_all, ps.k0 + k);
            const float x[4] = {x4.x, x4.y, x4.z, x4.w};
            const int col = (c0 + k / 8) * 64 + 8 * (k % 8) + fc;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float& v = acc[4 * k + q];
              if (m0 + fr + 8 * (q >> 1) < M && col + (q & 1) < n) {
                gs_w[q >> 1] += v;
                gxs_w[q >> 1] += v * x[q];
              } else {
                v = 0.f;
              }
            }
          }
        }
        if (j + 1 < passes) {
          stash_pass(stash, j, acc, cnt);
          continue;
        }
        row_totals(gs_w, red);
        row_totals(gxs_w, red);
        // a pass's dp from its dqn in acc: bf16 into O, its column sums
        const auto finish = [&](int cnt_j, int c0_j, int k0_j) {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            if (k < 8 * cnt_j) {
              const float4 x4 = *frag_ptr(pr.pre, cpw_all, k0_j + k);
              const float x[4] = {x4.x, x4.y, x4.z, x4.w};
              const int col = (c0_j + k / 8) * 64 + 8 * (k % 8) + fc;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int h = q >> 1;
                float& v = acc[4 * k + q];
                if (m0 + fr + 8 * h < M && col + (q & 1) < n)
                  v = rstd[h] * (v - gs_w[h] / n - x[q] * (gxs_w[h] / n));
              }
              st_pair(O, fr, col, acc[4 * k], acc[4 * k + 1]);
              st_pair(O, fr + 8, col, acc[4 * k + 2], acc[4 * k + 3]);
            }
          }
          col_sums(acc, cnt_j, c0_j, scratch, cs, [&](int c) { return c < n ? c : -1; });
        };
        finish(cnt, c0, ps.k0);
        for (int jj = 0; jj < j; ++jj) {
          const PassSpan pj = pass_span(n, jj);
          const int cnt_j = min(max(pj.nch - wg * pj.cpw, 0), pj.cpw);
          unstash_pass(stash, jj, acc, cnt_j);
          finish(cnt_j, PASS_CHUNKS * jj + wg * pj.cpw, pj.k0);
        }
      } else {
        // a hidden product: dp = (dh + the residual's gradient) * GELU', both
        // recorded in the accumulator's order and brought into the ring by the
        // producer: chunk c holds float4 4 c .. 4 c + 3 of every consumer
        // thread (thread t's float4 4 c + u at u * CONSUMERS + t)
        const int t = tid % 128, fr = (t / 32) * 16 + (t % 32) / 4, fc = 2 * (t % 4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= 2 * cpw) continue;
          const int sx = it % STAGES;
          mbar_wait(&full[sx], (it / STAGES) & 1);
          ++it;
          int sr = -1;
          if (pr.res_in != nullptr) {
            sr = it % STAGES;
            mbar_wait(&full[sr], (it / STAGES) & 1);
            ++it;
          }
          const float4* xs = reinterpret_cast<const float4*>(ring + sx * STAGE_BYTES) + tid;
          const float4* rs = reinterpret_cast<const float4*>(ring + max(sr, 0) * STAGE_BYTES) + tid;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = 4 * c + u;
            if (k >= 8 * cnt) continue;
            const float4 x4 = xs[u * CONSUMERS];
            const float4 r4 = sr >= 0 ? rs[u * CONSUMERS] : make_float4(0.f, 0.f, 0.f, 0.f);
            const float x[4] = {x4.x, x4.y, x4.z, x4.w}, r[4] = {r4.x, r4.y, r4.z, r4.w};
            const int col = (c0 + k / 8) * 64 + 8 * (k % 8) + fc;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float& v = acc[4 * k + q];
              v = m0 + fr + 8 * (q >> 1) < M && col + (q & 1) < n ? (r[q] + v) * x[q] : 0.f;
            }
            if (pr.res_out != nullptr)
              *frag_ptr(pr.res_out, cpw_all, ps.k0 + k) =
                  make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
            st_pair(O, fr, col, acc[4 * k], acc[4 * k + 1]);
            st_pair(O, fr + 8, col, acc[4 * k + 2], acc[4 * k + 3]);
          }
          release(&empty[sx]);
          if (sr >= 0) release(&empty[sr]);
        }
        // the residual gradient written here comes back through a bulk copy
        if (pr.res_out != nullptr) fence_proxy_async_global();
        col_sums(acc, cnt, c0, scratch, cs, [&](int c) { return c < n ? c : -1; });
      }
    }
    fence_proxy_async();
    // the wide kernel's stores of O, before the bulk copy reads them
    if (WIDE) fence_proxy_async_global();
    named_barrier(1, CONSUMERS);
    if (WIDE && !tail) {
      // the next product's input, O (its first S_COLS columns), into S
      if (tid == 0) {
        if (WIDER) {
          copy_to_s(S, O, plan.prod[p + 1].k, 0, &sbar);
        } else {
          const uint32_t bytes = (uint32_t)((plan.prod[p + 1].k + 63) / 64 * ATOM_BYTES);
          mbar_expect_tx(&sbar, bytes);
          bulk_copy(S, O, bytes, &sbar);
        }
      }
    }
    if (pr.d_out != nullptr) {
      // dp in bf16 for the weight gradients, 16 bytes a thread from O
      const int chunks = (n + 7) / 8;
      for (int e = tid; e < BM * chunks; e += CONSUMERS) {
        const int row = e / chunks, c = 8 * (e % chunks), gr = m0 + row;
        if (gr < M)
          *reinterpret_cast<uint4*>(pr.d_out + (size_t)gr * pr.ld_d + c) =
              *reinterpret_cast<const uint4*>(act_at(O, row, c));
      }
    }
    if (WIDE && !tail) {
      mbar_wait(&sbar, s_phase);
      s_phase ^= 1;
      s_half = 0;
    }
    a = 1 - a;
  }
}

template <int KIND, int TIER>
cudaError_t launch_bwd_kind(const BwdPlan& plan, const BwdRows& io, cudaStream_t stream) {
  static bool smem_set = false;   // the shared-memory opt-in, once per kernel
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(fused_layer_bwd_kernel<KIND, TIER>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  fused_layer_bwd_kernel<KIND, TIER>
      <<<(io.M + BM - 1) / BM, THREADS, SMEM_BYTES, stream>>>(plan, io);
  return cudaGetLastError();
}

}  // namespace
