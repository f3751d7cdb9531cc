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

#include <cuda.h>  // CUtensorMap; the driver's encoder is fetched through the runtime

#include "gemm_common.cuh"

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A phase that
// never completes (a fault in the ring) traps after about 2^34 cycles, so it
// surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 1024) start = clock64();
    if (n > 1024 && (n & 1023) == 0 && clock64() - start > (1LL << 34)) __trap();
  }
}

// One 2-D TMA load of a box at (c0 innermost, c1) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1.
// K-major: rows of 64 K-values, 8-row groups 1024 bytes apart (LBO unused).
// MN-major: 8 K-rows of 64 MN-values a group (SBO 1024 between groups of
// K), atoms of 64 MN-values LBO bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32 registers) += A (64 x 16) @ B (16 x N), both from shared
// memory through descriptors; TA / TB = 1 reads that operand MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64)
    wgmma_m64n64<TA, TB>(d, da, db);
  else
    wgmma_m64n128<TA, TB>(d, da, db);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

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
                                           int N, int k_begin, int k_tiles, Epi epi) {
  constexpr int BM = T::ROWS, BN = T::COLS;
  constexpr int STAGES = T::STAGES, LDS = T::STAGED_LD;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
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
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(ta)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tb)) : "memory");
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

// The 2-D tensor map of a row-major bf16 matrix (rows x cols, row stride ld
// elements) read in boxes of box_cols x box_rows with the 128-byte swizzle,
// zero-filled outside the matrix. cuTensorMapEncodeTiled comes from the
// driver through the runtime, so the library links no libcuda.
inline cudaError_t bf16_tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                                   int box_cols, int box_rows) {
  using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (rows < 1 || cols < 1 || ld < cols) return cudaErrorInvalidValue;
  if (!aligned16(ptr, ld)) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether every row of a matrix can be read and written 8 elements (16
// bytes of bf16, 32 of f32) at a time from any column that is a multiple of
// 8: a 16-byte-aligned base and rows of whole 16 bytes (a missing operand
// qualifies; a vector has no row stride).
inline bool rows16(const void* p, int ld, int elt) {
  return p == nullptr || ((reinterpret_cast<uintptr_t>(p) % 16) == 0 && (ld * elt) % 16 == 0);
}
