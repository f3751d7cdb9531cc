// The TMA + wgmma mainloop of the port's GEMM on Hopper (sm_90a), shared by
// gemm_wgmma.cu (C = epilogue(A @ B) and A @ B^T) and gemm_tn_wgmma.cu
// (C = A^T @ B, split over K).
//
// It serves every product of the ports of the Pallas kernels
// fused_flow_layers_t (B1), fused_augmenter (B2), flow_layers_bwd (B5) and
// fused_flow_layers_inverse_t (B7), and the aligned ones of
// fused_dgcnn_encoder (B4): rows M = B*N points (20,480-51,200 at the
// presets' batches, 4,000 in a sample), K and N 6..592.
//
// What bounds it on the H100: the 512 x 512 coupling product over 40,960
// rows is 21.5 GFLOP against 84 MB that must move (A read once, C written
// once), about 256 FLOP per byte, just under the card's ridge of about
// 295: so bytes bound it (25 us) with the tensor cores close behind. The
// design therefore keeps HBM streaming and the tensor cores fed at once:
//  * one producer warp issues TMA loads of the A and B tiles (64 of K a
//    stage, 128-byte swizzle) into a ring of 3 or 4 stages, each with a
//    `full` and an `empty` mbarrier (3 stages for gemm_bf16, so that two
//    blocks share an SM and one's epilogue overlaps the other's products;
//    4 for gemm_tn's deep K at one block per SM); TMA zero-fills the ragged edges, so M,
//    N and K need no padding (K = 6, 150, 216, 276; N = 300, 588 occur);
//  * one or two consumer warpgroups, 64 output rows each, run
//    wgmma.mma_async m64nBNk16 (BN 64 or 128) on the stages that have arrived, keep one
//    group of products in flight, and release a stage once its products are
//    done; the f32 sums stay in registers;
//  * the epilogue stages the f32 sums in the ring's shared memory, then
//    each thread takes 8 consecutive columns of a row, so every global load
//    and store of the epilogue is 16 or 32 bytes wide and a warp's are
//    contiguous;
//  * blocks run row tile by row tile (the N tiles of one row tile side by
//    side), so A's tile comes from L2 for all but the first of them.
// One mainloop takes the three layouts, since wgmma reads a 16-bit operand
// from shared memory either K-major or MN-major: A @ B (B stored (K, N):
// B MN-major), A @ B^T (B stored (N, K): K-major), A^T @ B (A stored
// (K, M): A MN-major).
//
// TMA needs a 16-byte-aligned base and a row stride that is a multiple of 16
// bytes; `_build.gemm` sends other operands to the WMMA route
// (gemm_bf16.cu), and the chains pad their buffers so that none does.
#pragma once

#include "gemm_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BK = 64;      // bf16 of K per stage: one 128-byte swizzled row

// A block's shape: BM x BN outputs, a ring of STAGES stages, and at least
// MIN_BLOCKS blocks resident on an SM (so one block's epilogue overlaps
// another's products where the ring leaves room for two).
template <int BM, int BN, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int ROWS = BM, COLS = BN;
  static constexpr int CONSUMERS = BM / 64;   // warpgroups of 64 output rows
  static constexpr int THREADS = CONSUMERS * 128 + 32;   // + the producer warp
  static constexpr int STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + the 1024-byte alignment
  // the staged f32 tile of a consumer warpgroup: 64 rows of BN + 8 floats (the
  // pad keeps the fragment's 8-byte stores free of bank conflicts)
  static constexpr int STAGED_LD = BN + 8;
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static_assert(MIN_BLOCKS * SMEM_BYTES <= 232448, "the rings exceed the SM's shared memory");
  static_assert(CONSUMERS * 64 * STAGED_LD * 4 <= STAGES * STAGE_BYTES,
                "the staged tile does not fit in the ring");
};

// One block's output tile C[m0:m0+BM, n0:n0+BN] over k_tiles stages of K
// from k_begin. A_MN: A is stored (K, M); B_K: B is stored (N, K);
// otherwise A (M, K) and B (K, N). The f32 sums are staged in shared memory
// (the ring's, free once every product is done), then `epi(v, r, c)` gets
// each chunk of 8 consecutive sums v[0..8) of row r from column c, for every
// r < M and c < N (c a multiple of 8; columns at or past N are to be
// skipped), 8 consecutive columns per thread so that its global loads and
// stores are 16 or 32 bytes wide and a warp's are contiguous.
template <class T, bool A_MN, bool B_K, class Epi>
__device__ __forceinline__ void gemm_block(const CUtensorMap* ta, const CUtensorMap* tb, int M,
                                           int N, int m0, int n0, int k_begin, int k_tiles,
                                           Epi epi) {
  constexpr int BM = T::ROWS, BN = T::COLS;
  constexpr int STAGES = T::STAGES, LDS = T::STAGED_LD;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES];
  uint8_t* smem = align1024(smem_raw);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == T::CONSUMERS) {
    // the producer warp: one thread keeps up to STAGES stages of loads in flight
    if (threadIdx.x == T::CONSUMERS * 128) {
      prefetch_tensor_map(ta);
      prefetch_tensor_map(tb);
      for (int it = 0; it < k_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* sa = smem + s * T::STAGE_BYTES;
        uint8_t* sb = sa + T::A_BYTES;
        const int k0 = k_begin + it * BK;
        mbar_expect_tx(&full[s], T::STAGE_BYTES);
        if constexpr (A_MN) {
#pragma unroll
          for (int j = 0; j < BM / 64; ++j) tma_load(sa + j * 8192, ta, &full[s], m0 + 64 * j, k0);
        } else {
          tma_load(sa, ta, &full[s], k0, m0);
        }
        if constexpr (B_K) {
          tma_load(sb, tb, &full[s], k0, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) tma_load(sb + j * 8192, tb, &full[s], n0 + 64 * j, k0);
        }
      }
    }
  } else {
    // a consumer warpgroup: output rows [m0 + 64 wg, m0 + 64 wg + 64)
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int it = 0; it < k_tiles; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      // this warpgroup's 64 rows of A: 64 rows of 128 bytes (K-major) or
      // the 64-wide M atom (MN-major), 8 KB either way
      const uint8_t* sa = smem + s * T::STAGE_BYTES + wg * 8192;
      const uint8_t* sb = smem + s * T::STAGE_BYTES + T::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 of K: 32 bytes along a K-major row, or two 8-row groups MN-major
        const uint64_t da = A_MN ? smem_desc(sa + kk * 2048, 8192, 1024)
                                 : smem_desc(sa + kk * 32, 16, 1024);
        const uint64_t db = B_K ? smem_desc(sb + kk * 32, 16, 1024)
                                : smem_desc(sb + kk * 2048, 8192, 1024);
        wgmma_bn<BN, A_MN ? 1 : 0, B_K ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
      if (it > 0) {
        // the previous stage's products are done: hand its buffers back
        wgmma_wait<1>();
        if (threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // every consumer's products are done, so the ring is free: stage the
    // sums there. Fragment layout of m64nN: thread t of the warpgroup holds
    // rows 16 (t / 32) + (t % 32) / 4 and +8, columns 8 j + 2 (t % 4) and +1.
    named_barrier(1, T::CONSUMERS * 128);
    float* tile = reinterpret_cast<float*>(smem) + wg * 64 * LDS;
    const int t = threadIdx.x % 128;
    const int fr = (t / 32) * 16 + (t % 32) / 4, fc = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(tile + fr * LDS + fc + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(tile + (fr + 8) * LDS + fc + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_barrier(2 + wg, 128);
    constexpr int CHUNKS = BN / 8;
    for (int idx = t; idx < 64 * CHUNKS; idx += 128) {
      const int row = idx / CHUNKS, ch = idx % CHUNKS;
      const int r = m0 + wg * 64 + row, c = n0 + 8 * ch;
      if (r < M && c < N) epi(tile + row * LDS + 8 * ch, r, c);
    }
  }
}

}  // namespace
