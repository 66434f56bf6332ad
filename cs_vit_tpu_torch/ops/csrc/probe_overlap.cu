// Tensor-core / SFU overlap probe for Hopper (sm_90a): the kernel behind
// cs_vit_tpu_torch/ops/probe_overlap.py:probe_overlap.
//
// Replaces the TPU kernel of tools/probe_overlap.py:bench (body make_kernel),
// which asks whether the TPU's matrix unit and its vector unit overlap. It
// computes, for mode "mma", "exp" or "both":
//   acc = a; 8 times: acc = bf16(acc . w)        (f32 sums)        "mma", "both"
//   vec = x; 32 times: vec = exp(vec * 0.25 - 1)                   "exp", "both"
// and repeats the whole work `repeats` times (the TPU grid of 64 recomputes
// the same outputs), writing acc (a itself in "exp" mode) and vec (x itself
// in "mma" mode). Here the products run on the tensor cores (WMMA bf16
// 16x16x16, mma.sync underneath) and the exponentials on the SFU (__expf:
// ex2.approx), never on SIMT FMAs: both are the point of the probe.
//
// Layout. The product chain is row-local, so block (i, r) owns rows
// [64 i, 64 i + 64) of acc in shared memory (bf16) through all 8 products of
// repeat r, and slice i of vec. 16 warps: 4 row tiles of 16 x 4 column groups
// of 128, eight 16x16 f32 accumulators each. w streams through shared memory
// 16 k-rows at a time (two-stage cp.async ring) and each product's result,
// rounded to bf16, replaces the block's rows of acc. vec is independent of
// acc element by element, so its passes ride along the products' k-steps in
// the same instruction stream, with no dependence on them: each thread keeps
// 8 elements of the block's vec slice in registers for 8 k-steps and gives
// each 4 passes per k-step (8 independent chains, so the SFU is fed), then
// stores them after their 32 passes and loads the next 8: 32 groups over the
// 256 k-steps of the 8 products. Every element gets its 32 passes in order
// (the TPU kernel's 4 per product, regrouped: the same values) and is
// written once, so the blocks of other repeats never read a partial value.
//
// What bounds it: in "mma" the 8 * 2 * 512^3 FLOPs per repeat at the bf16
// tensor-core rate, but every block streams all of w (512 KB) from L2 per
// product, which likely holds it below that rate; in "exp" the 32 exp2 per
// element at the SFU's 16 per clock per SM. "both" at the larger of the two
// says the units overlap; at their sum, that they do not.
//
// Plain C interface for ctypes. The entry point returns cudaGetLastError()
// right after its launch; it launches on the caller's stream, allocates
// nothing and does not synchronise.

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int PO_N = 512;                 // acc is [M, 512], w is [512, 512]
constexpr int PO_ROWS = 64;               // acc rows per block: 4 WMMA row tiles
constexpr int PO_THREADS = 512;           // 16 warps: 4 row tiles x 4 column groups of 128
constexpr int PO_KT = 16;                 // k-rows of w staged per step
constexpr int PO_KSTEPS = PO_N / PO_KT;   // 32 per product
constexpr int PO_REPS = 8;                // products in the chain
constexpr int PO_STEPS = PO_REPS * PO_KSTEPS;  // 256 k-steps per block
constexpr int PO_GROUP = 8;               // vec elements in flight per thread
constexpr int PO_GROUP_STEPS = 8;         // k-steps a group stays in registers
constexpr int PO_PASSES_PER_STEP = 4;     // 8 x 4 = 32 exp passes per element
constexpr size_t PO_VEC_PER_BLOCK = (size_t)PO_STEPS / PO_GROUP_STEPS * PO_GROUP * PO_THREADS;
constexpr int PO_LD = PO_N + 8;           // padded bf16 row: 1040 B, keeps WMMA pointers 32 B aligned

constexpr size_t po_smem_bytes() {
  return (size_t)PO_ROWS * PO_LD * 2 + 2 * (size_t)PO_KT * PO_LD * 2
         + (size_t)(PO_THREADS / 32) * 256 * 4;
}

__global__ void __launch_bounds__(PO_THREADS)
probe_overlap_kernel(const bf16* a, const bf16* w, const float* x, bf16* acc_out,
                     float* vec_out, int do_mma, int do_exp) {
  namespace nw = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char po_smem[];
  bf16* As = reinterpret_cast<bf16*>(po_smem);                       // [ROWS][LD] acc rows
  bf16* Ws = As + PO_ROWS * PO_LD;                                   // [2][KT][LD] w rows
  float* Cs = reinterpret_cast<float*>(Ws + 2 * PO_KT * PO_LD);      // [warps][16*16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.x * PO_ROWS;
  // this block's vec slice: PO_STEPS / PO_GROUP_STEPS groups of
  // PO_GROUP x PO_THREADS elements
  const size_t v0 = (size_t)blockIdx.x * PO_VEC_PER_BLOCK;
  float vals[PO_GROUP];

  auto stage_w = [&](int buf, int k0) {
    for (int c = tid; c < PO_KT * PO_N / 8; c += PO_THREADS) {
      const int r = c / (PO_N / 8), col = (c % (PO_N / 8)) * 8;
      cp_async16(&Ws[(buf * PO_KT + r) * PO_LD + col], w + (size_t)(k0 + r) * PO_N + col, true);
    }
    cp_async_commit();
  };

  if (do_mma) {
    for (int c = tid; c < PO_ROWS * PO_N / 8; c += PO_THREADS) {
      const int r = c / (PO_N / 8), col = (c % (PO_N / 8)) * 8;
      cp_async16(&As[r * PO_LD + col], a + (size_t)(r0 + r) * PO_N + col, true);
    }
    cp_async_commit();
  }

  nw::fragment<nw::accumulator, 16, 16, 16, float> acc[8];
  for (int rep = 0; rep < PO_REPS; ++rep) {
    if (do_mma) {
#pragma unroll
      for (int j = 0; j < 8; ++j) nw::fill_fragment(acc[j], 0.0f);
      stage_w(0, 0);
    }
    for (int kt = 0; kt < PO_KSTEPS; ++kt) {
      if (do_mma) {
        const int buf = kt & 1;
        if (kt + 1 < PO_KSTEPS) {
          stage_w(buf ^ 1, (kt + 1) * PO_KT);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        nw::fragment<nw::matrix_a, 16, 16, 16, bf16, nw::row_major> af;
        nw::load_matrix_sync(af, &As[wm * 16 * PO_LD + kt * PO_KT], PO_LD);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          nw::fragment<nw::matrix_b, 16, 16, 16, bf16, nw::row_major> bfr;
          nw::load_matrix_sync(bfr, &Ws[buf * PO_KT * PO_LD + wn * 128 + j * 16], PO_LD);
          nw::mma_sync(acc[j], af, bfr, acc[j]);
        }
      }
      if (do_exp) {
        const int step = rep * PO_KSTEPS + kt;
        const size_t base = v0 + (size_t)(step / PO_GROUP_STEPS) * PO_GROUP * PO_THREADS + tid;
        if (step % PO_GROUP_STEPS == 0) {
#pragma unroll
          for (int j = 0; j < PO_GROUP; ++j) vals[j] = x[base + (size_t)j * PO_THREADS];
        }
#pragma unroll
        for (int p = 0; p < PO_PASSES_PER_STEP; ++p)
#pragma unroll
          for (int j = 0; j < PO_GROUP; ++j) vals[j] = __expf(vals[j] * 0.25f - 1.0f);
        if (step % PO_GROUP_STEPS == PO_GROUP_STEPS - 1) {
#pragma unroll
          for (int j = 0; j < PO_GROUP; ++j) vec_out[base + (size_t)j * PO_THREADS] = vals[j];
        }
      }
      if (do_mma) __syncthreads();
    }
    if (do_mma) {
      // every warp has read its last tile of acc: the product, rounded to
      // bf16, replaces it
      float* cs = Cs + warp * 256;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        nw::store_matrix_sync(cs, acc[j], 16, nw::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          As[(wm * 16 + (e >> 4)) * PO_LD + wn * 128 + j * 16 + (e & 15)] =
              __float2bfloat16(cs[e]);
        __syncwarp();
      }
      __syncthreads();
    }
  }

  for (int c = tid; c < PO_ROWS * PO_N / 8; c += PO_THREADS) {
    const int r = c / (PO_N / 8), col = (c % (PO_N / 8)) * 8;
    const size_t g = (size_t)(r0 + r) * PO_N + col;
    *reinterpret_cast<uint4*>(acc_out + g) =
        do_mma ? *reinterpret_cast<const uint4*>(&As[r * PO_LD + col])
               : *reinterpret_cast<const uint4*>(a + g);
  }
  if (!do_exp) {
    for (size_t e = tid; e < PO_VEC_PER_BLOCK; e += PO_THREADS) vec_out[v0 + e] = x[v0 + e];
  }
}

}  // namespace

// a [M,512] and w [512,512] bf16, acc_out [M,512] bf16, x and vec_out
// [M/64 * PO_VEC_PER_BLOCK] = [M * 2048] f32; M a multiple of 64
extern "C" int probe_overlap(const void* a, const void* w, const void* x, void* acc_out,
                             void* vec_out, int M, int do_mma, int do_exp, int repeats,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = po_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(probe_overlap_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(M / PO_ROWS, repeats);
  probe_overlap_kernel<<<grid, PO_THREADS, smem, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), static_cast<const float*>(x),
      static_cast<bf16*>(acc_out), static_cast<float*>(vec_out), do_mma, do_exp);
  return (int)cudaGetLastError();
}
