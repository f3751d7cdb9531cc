// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels:
// the GEMM mainloop (gemm_wgmma.cuh) and the cross attention forward and
// backward (cross_attention.cu, cross_attention_bwd.cu).
//
//  * mbarriers (init, expect_tx, arrive, a parity wait that traps after
//    about 2^34 cycles so that a ring fault is a launch error, not a hung
//    card);
//  * TMA tile loads from 2-D and 3-D tensor maps, and the host encoders of
//    those maps for bf16 matrices with the 128-byte swizzle
//    (cuTensorMapEncodeTiled is fetched through the runtime, so nothing
//    links libcuda);
//  * wgmma's shared-memory descriptors, its fence / commit / wait, and the
//    m64n64k16 / m64n128k16 bf16 products with A from shared memory (SS)
//    or, for m64n64k16, from registers (RS);
//  * the proxy fence between shared-memory stores and wgmma's reads
//    (fused_layer.cu).
#pragma once

#include <cuda.h>  // CUtensorMap; its encoder is fetched through the runtime

#include "common.cuh"

namespace {

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

// One 3-D TMA load of a box at (c0 innermost, c1, c2), completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// asynchronous-proxy reads of it (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Shared memory from `raw` rounded up to the 1024-byte alignment the
// 128-byte swizzle needs.
__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
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

// D (64 x N, f32 registers) = A (64 x 16) @ B (16 x N) + (scale_d ? D : 0),
// both operands from shared memory through descriptors; TA / TB = 1 reads
// that operand MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d = 1) {
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, f32 registers) += A (64 x 16, bf16 in registers) @ B (16 x 64
// from shared memory); TB = 1 reads B MN-major. `a` holds the thread's four
// pairs of A in mma's fragment layout: for warp w of the warpgroup and lane
// l, rows 16 w + l / 4 (a[0], a[2]) and +8 (a[1], a[3]), columns 2 (l % 4)
// and +1 (a[0], a[1]) and those +8 (a[2], a[3]). Columns 16 kk .. 16 kk + 15
// of an m64n64 accumulator d map onto it as a[0] = (d[8 kk], d[8 kk + 1]),
// a[1] = (d[8 kk + 2], d[8 kk + 3]), a[2] = (d[8 kk + 4], d[8 kk + 5]),
// a[3] = (d[8 kk + 6], d[8 kk + 7]).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
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

}  // namespace

using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                          const cuuint32_t*, CUtensorMapInterleave,
                                          CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once through the runtime's entry-point query.
inline cudaError_t tensor_map_encoder(TensorMapEncodeTiled* out) {
  static TensorMapEncodeTiled encode = nullptr;
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
    encode = reinterpret_cast<TensorMapEncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// The 2-D tensor map of a row-major bf16 matrix (rows x cols, row stride ld
// elements) read in boxes of box_cols x box_rows with the 128-byte swizzle,
// zero-filled outside the matrix.
inline cudaError_t bf16_tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                                   int box_cols, int box_rows) {
  TensorMapEncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
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

// The 3-D tensor map of `items` row-major bf16 matrices of rows x cols each,
// stored one after another (row stride ld elements, item stride rows * ld),
// read in boxes of box_cols x box_rows x 1 with the 128-byte swizzle. A box
// that runs past an item's last row is zero-filled there: it never reads
// the next item's rows.
inline cudaError_t bf16_tensor_map_3d(CUtensorMap* map, const void* ptr, int items, int rows,
                                      int cols, int ld, int box_cols, int box_rows) {
  TensorMapEncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  if (items < 1 || rows < 1 || cols < 1 || ld < cols) return cudaErrorInvalidValue;
  if (!aligned16(ptr, ld)) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)items};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(bf16),
                                 (cuuint64_t)rows * ld * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
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
