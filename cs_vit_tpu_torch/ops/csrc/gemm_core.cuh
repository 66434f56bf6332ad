// Hopper GEMM mainloop pieces (sm_90a): TMA tensor maps and loads, mbarriers,
// wgmma descriptors and the m64nNk16 bf16 products (N = 64, 128) with f32
// accumulators, A from shared memory or from registers. The three bf16
// GEMMs of the block kernels are built from them: gemm_wgrad and gemm_dgrad
// (fused_block_bwd.cu), gemm_bias_act (fused_block.cu); none of their
// arithmetic is here.
//
// Shared-memory operand tiles come in two 128-byte-swizzle layouts, both
// written as they are by a TMA load with CU_TENSOR_MAP_SWIZZLE_128B of a
// box {64, rows} from a row-major bf16 matrix (each box row 128 bytes, its
// eight 16-byte chunks XOR-ed by row % 8, 8 rows = 1024 bytes, every atom
// 1024-byte aligned):
//  * MN-major: 64 bf16 of the M (or N) index contiguous in a row, one row
//    per index of the reduction (K) dimension. The descriptor's stride byte
//    offset (SBO) steps 8 K rows (1024 bytes), its leading byte offset (LBO)
//    steps from one 64-wide atom to the next along M or N, and a K step of
//    16 rows advances the start address by 2048 bytes.
//  * K-major: 64 bf16 of the reduction index contiguous in a row, one row
//    per index of M (or N). SBO steps 8 rows, LBO is unused, and a K step of
//    16 advances the start address by 32 bytes inside the rows.

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

// descriptor of a K-major SW128 operand: rows of the M (or N) index, each
// 128 bytes = 64 bf16 of the reduction index with its eight 16-byte chunks
// XOR-ed by row % 8, as a TMA box {64, rows} with CU_TENSOR_MAP_SWIZZLE_128B
// writes them. SBO steps 8 rows (1024 bytes); the leading offset is unused
// (a 16-deep K step lies inside one 128-byte row). `addr` is the tile's
// first row (1024-byte aligned) plus 32 bytes per 16-deep K step.
__device__ __forceinline__ uint64_t wgmma_desc_k_sw128(uint32_t addr) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;                                // LBO: unused
  d |= (uint64_t)((8 * GC_ATOM_ROW_BYTES) >> 4) << 32;  // SBO: 8 rows
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

// keeps a register a wgmma reads (an A fragment) or writes (an accumulator)
// live and unmoved up to this point: after wgmma_wait, the compiler may not
// have reused or read it while the product was in flight
__device__ __forceinline__ void wgmma_keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void wgmma_keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d[64 x N] += A[64 x 16] . B[16 x N] in bf16, f32 accumulators in the
// m64nNk16 layout: thread t of the warpgroup holds rows 16 (t / 32) +
// (t % 32) / 4 (+8) and, for each 8-column tile j, columns 8 j + 2 (t % 4)
// (+1): d[4 j + {0,1}] the first row, d[4 j + {2,3}] the second.
// "_ss": A and B by descriptor; TA and TB are the transpose flags (0: the
// operand is K-major, 1: MN-major). "_rs": A from registers, four words of
// bf16 pairs per thread: warp w of the warpgroup holds rows 16 w + g and
// 16 w + g + 8 (g = lane / 4), columns 2 (lane % 4) (+1) and 8 more (+1):
// a[0] (row g, col c), a[1] (row g + 8, col c), a[2] (row g, col c + 8),
// a[3] (row g + 8, col c + 8), the lower column in the low half.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// the m64nBNk16 products above by tile width BN (64 or 128)
template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 64 || BN == 128, "wgmma_ss: BN is 64 or 128");
  if constexpr (BN == 128) wgmma_m64n128k16_ss<TA, TB>(d, da, db);
  else wgmma_m64n64k16_ss<TA, TB>(d, da, db);
}
template <int BN, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(BN == 64 || BN == 128, "wgmma_rs: BN is 64 or 128");
  if constexpr (BN == 128) wgmma_m64n128k16_rs<TB>(d, a, db);
  else wgmma_m64n64k16_rs<TB>(d, a, db);
}

// ---- the ring and the epilogue's staging tile --------------------------------

// The kernels' dynamic shared memory: `stages` full and `stages` empty
// mbarriers (at most GC_MAX_STAGES each) first, then, from the first
// 1024-byte boundary (the swizzle atoms' alignment), the ring of operand
// stages, which the epilogue reuses for its f32 accumulator tile once the
// last products are done.
constexpr int GC_MAX_STAGES = 8;
constexpr size_t GC_BARRIER_BYTES = 2 * GC_MAX_STAGES * sizeof(uint64_t);
// the dynamic shared memory a block of the H100 may opt in to (227 KB)
constexpr size_t GC_SMEM_CAP = 232448;

__device__ __forceinline__ unsigned char* gc_ring(unsigned char* raw) {
  unsigned char* p = raw + GC_BARRIER_BYTES;
  return p + ((1024 - (gc_smem(p) & 1023)) & 1023);
}

// bytes of dynamic shared memory for a ring of `stages` stages of
// `stage_bytes` and an epilogue tile of `tile_bytes`
inline size_t gc_smem_bytes(int stages, int stage_bytes, int tile_bytes) {
  const size_t ring = (size_t)stages * stage_bytes;
  return GC_BARRIER_BYTES + 1024 + (ring > (size_t)tile_bytes ? ring : (size_t)tile_bytes);
}

// row pitch, in floats, of a warpgroup's [64][BN] f32 accumulator tile in
// shared memory: 8 more than BN, so that the float2 writes of a warp's 8
// rows take the two wavefronts a 256-byte store needs and no more
template <int BN>
__host__ __device__ constexpr int acc_pitch() { return BN + 8; }

// writes the warpgroup's m64nBN accumulators (layout above; t = the thread's
// index in the warpgroup) into the tile
template <int BN>
__device__ __forceinline__ void stage_acc(float* tile, const float (&acc)[BN / 2], int t) {
  constexpr int P = acc_pitch<BN>();
  const int lane = t & 31;
  float* row = tile + (16 * (t >> 5) + (lane >> 2)) * P + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(row + 8 * P + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
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

// makes the current device's primary context current on the calling
// thread, which cuTensorMapEncodeTiled needs: a host thread that has made no
// runtime call yet (autograd's backward thread, for one) has none until the
// runtime binds it, and cudaSetDevice does. Once per thread.
inline int bind_thread_context() {
  static thread_local bool bound = false;
  if (bound) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  bound = true;
  return 0;
}

// tensor map of a row-major [rows][cols] matrix (row pitch `cols` elements),
// read in boxes of {box_cols, box_rows}; out-of-bounds elements read as 0.
// Returns a CUDA error code (0 on success).
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                     const void* base, long long rows, long long cols, int box_cols,
                     int box_rows, CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const int e = bind_thread_context();
  if (e) return e;
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
