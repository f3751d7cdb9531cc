// Row-wise passes of the flow-layer and augmenter chains:
//
//   cast_rows          f32 -> bf16 copy of a column block (x1 and the extra
//                      context into the packed coupling-input rows)
//   row_norm           plain-statistics LayerNorm, (q - mean) *
//                      rsqrt(E[q^2] - mean^2 + eps) -> bf16; its scale and
//                      bias are folded into wq_f (fold_stacks)
//   coupling_epilogue  the sigmoid-scale affine of fused_flow_layers_t's
//                      _kernel_t: y = [x1 | x2 * scale(s) + t] in bf16 for the
//                      LinearLU product, ldj += sum(log scale) + lu_ldj_f[l]
//   augment_epilogue   the tail of fused_augmenter's _augment_kernel:
//                      z = [x | mean + eps * exp(log_std)],
//                      ldj = sum(0.5 log 2pi + log_std + 0.5 eps^2)
//
// One warp per row for the three reductions. All of these move a few bytes
// per multiply of the neighbouring products, so memory bandwidth bounds
// them; the design keeps each to one read and one write of its rows.
#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // 8 warps, one row each

__global__ void cast_rows_kernel(const float* __restrict__ src, int lds, bf16* __restrict__ dst,
                                 int ldd, int R, int C) {
  const size_t total = (size_t)R * C;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / C), c = (int)(e % C);
    dst[(size_t)r * ldd + c] = f2bf(src[(size_t)r * lds + c]);
  }
}

__global__ void row_norm_kernel(const float* __restrict__ x, int ldx, bf16* __restrict__ y, int ldy,
                                int R, int C, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float* xr = x + (size_t)row * ldx;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = xr[c];
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / C;
  const float var = s2 / C - mean * mean;
  const float inv = rsqrtf(var + eps);
  for (int c = lane; c < C; c += 32) y[(size_t)row * ldy + c] = f2bf((xr[c] - mean) * inv);
}

__global__ void coupling_epilogue_kernel(const float* __restrict__ st, int ldst,
                                         const float* __restrict__ x, int ldx,
                                         float* __restrict__ ldj, bf16* __restrict__ y, int ldy,
                                         int R, int split, int half, float eps_affine,
                                         const float* __restrict__ lu_ldj) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float* sr = st + (size_t)row * ldst;
  const float* xr = x + (size_t)row * ldx;
  bf16* yr = y + (size_t)row * ldy;
  for (int c = lane; c < split; c += 32) yr[c] = f2bf(xr[c]);
  float acc = 0.f;
  for (int c = lane; c < half; c += 32) {
    const float sig = 1.f / (1.f + expf(-sr[c]));
    const float sc = (2.f * sig - 1.f) * (1.f - eps_affine) + 1.f;
    yr[split + c] = f2bf(xr[split + c] * sc + sr[half + c]);
    acc += logf(sc);
  }
  acc = warp_sum(acc);
  if (lane == 0) ldj[row] = (ldj[row] + acc) + lu_ldj[0];
}

__global__ void augment_epilogue_kernel(const float* __restrict__ st, int ldst,
                                        const float* __restrict__ x, int ldx, int in_dim,
                                        const float* __restrict__ eps, int ldeps, int aug,
                                        float* __restrict__ z, int ldz, float* __restrict__ ldj,
                                        int R) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float* sr = st + (size_t)row * ldst;
  const float* er = eps + (size_t)row * ldeps;
  float* zr = z + (size_t)row * ldz;
  for (int c = lane; c < in_dim; c += 32) zr[c] = x[(size_t)row * ldx + c];
  const float half_log_2pi = 0.91893853320467274178f;
  float acc = 0.f;
  for (int c = lane; c < aug; c += 32) {
    const float mean = sr[c], log_std = sr[aug + c], e = er[c];
    zr[in_dim + c] = mean + e * expf(log_std);
    acc += (half_log_2pi + log_std) + 0.5f * e * e;
  }
  acc = warp_sum(acc);
  if (lane == 0) ldj[row] = acc;
}

inline int row_blocks(int R) { return (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK; }

}  // namespace

FC_API int fc_cast_rows(const void* src, int lds, void* dst, int ldd, int R, int C, void* stream) {
  const size_t total = (size_t)R * C;
  int blocks = (int)((total + 255) / 256);
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  cast_rows_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)src, lds, (bf16*)dst,
                                                             ldd, R, C);
  return (int)cudaGetLastError();
}

FC_API int fc_row_norm(const void* x, int ldx, void* y, int ldy, int R, int C, float eps,
                       void* stream) {
  row_norm_kernel<<<row_blocks(R), 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)x, ldx, (bf16*)y, ldy, R, C, eps);
  return (int)cudaGetLastError();
}

FC_API int fc_coupling_epilogue(const void* st, int ldst, const void* x, int ldx, void* ldj,
                                void* y, int ldy, int R, int split, int half, float eps_affine,
                                const void* lu_ldj, void* stream) {
  coupling_epilogue_kernel<<<row_blocks(R), 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)st, ldst, (const float*)x, ldx, (float*)ldj, (bf16*)y, ldy, R, split, half,
      eps_affine, (const float*)lu_ldj);
  return (int)cudaGetLastError();
}

FC_API int fc_augment_epilogue(const void* st, int ldst, const void* x, int ldx, int in_dim,
                               const void* eps, int ldeps, int aug, void* z, int ldz, void* ldj,
                               int R, void* stream) {
  augment_epilogue_kernel<<<row_blocks(R), 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)st, ldst, (const float*)x, ldx, in_dim, (const float*)eps, ldeps, aug,
      (float*)z, ldz, (float*)ldj, R);
  return (int)cudaGetLastError();
}
