// Hopper GEMM mainloop pieces (sm_90a): TMA tensor maps and loads, mbarriers,
// wgmma descriptors and the m64n128k16 bf16 product with f32 accumulators.
// gemm_wgrad (fused_block_bwd.cu) is built from them; they take no part of
// its arithmetic, so gemm_dgrad and gemm_bias_act can move onto them as they
// are.
//
// Shared-memory operand tiles are "MN-major, 128-byte swizzle" atoms: 64
// bf16 of the M (or N) index contiguous in a 128-byte row, one row per index
// of the reduction (K) dimension, the eight 16-byte chunks of row r XOR-ed
// by r % 8, 8 rows = 1024 bytes, every atom 1024-byte aligned. A TMA load
// with CU_TENSOR_MAP_SWIZZLE_128B of a box {64, rows} from a row-major
// [rows][64+] bf16 matrix writes exactly this layout, and it is wgmma's
// canonical MN-major SW128 layout: a descriptor's stride byte offset (SBO)
// steps 8 K rows (1024 bytes), its leading byte offset (LBO) steps from one
// 64-wide atom to the next along M or N, and a K step of 16 rows advances the
// start address by 2048 bytes.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

constexpr int GC_ATOM_ROW_BYTES = 128;  // one K row of an atom: 64 bf16

__device__ __forceinline__ uint32_t gc_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(gc_smem(bar)), "r"(count));
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(gc_smem(bar)) : "memory");
}

// arrives and adds `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(gc_smem(bar)), "r"(bytes) : "memory");
}

// waits until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(gc_smem(bar)), "r"(phase) : "memory");
}

// ---- TMA -------------------------------------------------------------------

// box of a 2-D tensor map at (c0 = innermost element, c1 = row) into shared
// memory; completion adds the box's bytes to `bar`'s transaction count (the
// whole box, out-of-bounds elements zero-filled)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(gc_smem(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(gc_smem(bar)), "r"(c0),
        "r"(c1)
      : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma reading a tile that threads wrote)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) over `count` threads, a multiple of 32
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// descriptor of an MN-major SW128 operand whose first atom starts at `addr`
// (1024-byte aligned, or advanced from such by whole 16-row K steps)
__device__ __forceinline__ uint64_t wgmma_desc_mn_sw128(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((8 * GC_ATOM_ROW_BYTES) >> 4) << 32;  // SBO: 8 K rows
  d |= (uint64_t)1 << 62;                                // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], bf16 operands from shared memory,
// both MN-major (transposed flags 1), f32 accumulators in the m64nNk16 layout:
// thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+8) and,
// for each 8-column tile j, columns 8 j + 2 (t % 4) (+1): d[4 j + {0,1}] the
// first row, d[4 j + {2,3}] the second.
__device__ __forceinline__ void wgmma_m64n128k16_mn(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---- host: tensor maps -----------------------------------------------------

// cuTensorMapEncodeTiled from the driver through the runtime (no link
// against libcuda); null if the driver has none
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  static bool asked = false;
  if (!asked) {
    asked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// tensor map of a row-major [rows][cols] matrix (row pitch `cols` elements),
// read in boxes of {box_cols, box_rows}; out-of-bounds elements read as 0.
// Returns a CUDA error code (0 on success).
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                     const void* base, long long rows, long long cols, int box_cols,
                     int box_rows, CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t elem_strides[2] = {1, 1};
  CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
