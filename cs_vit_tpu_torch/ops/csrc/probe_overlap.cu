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
// in "mma" mode). The products run on the tensor cores as asynchronous
// wgmma, the exponentials on the SFU (ex2.approx): the question is
// whether the SFU's work hides under wgmma that is in flight.
//
// Layout (ops/probe_overlap.py:probe_plan holds the same numbers). The
// product chain is row-local, so block (i, r) owns rows [64 i, 64 i + 64) of
// acc through all 8 products of repeat r, and slice i of vec. acc lives in
// shared memory in bf16, as the K-major 128-byte-swizzled tile that wgmma's
// A descriptor reads (8 atoms of 64 rows x 64 of K; a TMA load writes a's
// rows so). Two consumer warpgroups each own 256 columns of the product as
// two m64n128 f32 accumulators (128 registers a thread: a 64 x 512 f32
// accumulator would take 256, over the 255 a thread may hold). One thread
// of a producer warpgroup keeps a ring of w k-tiles (32 rows of K x all 512
// columns, as 8 MN-major swizzled atoms) in flight by TMA, with full/empty
// mbarriers: no block barrier in the k-loop. The producer warpgroup hands
// its registers to the consumers (setmaxnreg: 40 against 232 a thread; a
// block of 384 threads starts at 168, too few for the accumulators and
// the exp chains together). After each product both warpgroups wait
// for their last wgmma, meet at a named barrier (both have read the old
// rows), round their accumulators to bf16 over the block's rows of acc,
// fence the writes for the async proxy and meet again before the next
// product's first wgmma reads them.
//
// What bounds it. "mma": the products' 8 * 2 * 512^3 FLOPs a repeat at the
// bf16 tensor-core rate, and the reads of w: every block streams all of w
// (512 KiB) from L2 per product, 2 GiB a call at the probe's shapes, which
// holds it near half the tensor-core rate on an H100 (0.28 ms against 0.14).
// Clusters of two with each w tile multicast to both blocks would halve
// those reads, but a version that did so ran the products at 0.78 ms on an
// H100 (PERF.md, section 6), so the blocks run alone.
// "exp": 32 exp2 per element of x at the SFU's 16 per clock per SM; each
// takes three instructions (FFMA, FMUL, MUFU.EX2; exp_pass below), so that
// two warps a scheduler keep the SFU near its rate.
//
// The exp stream sits inside the consumer warpgroups, between a wgmma's
// commit and its wait, as an attention kernel's softmax would: each thread
// keeps PO_CHAINS independent chains (elements of the block's vec slice; 8
// warps an SM, so many chains a warp keep the SFU fed) and gives them
// PO_PASSES passes per k-tile, for PO_GROUP_TILES k-tiles, then stores them
// once, after their 32 passes in order, and takes the next group (loaded a
// group ahead).
// Blocks of other repeats read only x, never a partial value. "exp" runs
// the same warps on the same schedule with no products; "mma" the products
// alone. "both" at the larger of the two says the units overlap; at their
// sum, that they do not.
//
// Plain C interface for ctypes. The entry point returns cudaGetLastError()
// right after its launch; it launches on the caller's stream, allocates
// nothing and does not synchronise.

#include "common.cuh"
#include "gemm_core.cuh"

namespace {

constexpr int PO_N = 512;                        // acc is [M, 512], w is [512, 512]
constexpr int PO_ROWS = 64;                      // acc rows per block: one wgmma row tile
constexpr int PO_CONSUMERS = 256;                // two warpgroups, 256 columns each
constexpr int PO_CONSUMER_WARPS = PO_CONSUMERS / 32;
constexpr int PO_THREADS = PO_CONSUMERS + 128;   // and one producer warpgroup
constexpr int PO_PRODUCER_REGS = 40, PO_CONSUMER_REGS = 232;  // setmaxnreg, per thread
constexpr int PO_BK = 32;                        // k-rows of w a ring stage holds
constexpr int PO_KTILES = PO_N / PO_BK;          // stages a product
constexpr int PO_PRODUCTS = 8;                   // products in the chain
constexpr int PO_ITERS = PO_PRODUCTS * PO_KTILES;  // k-tiles a block walks
constexpr int PO_STAGES = 5;                     // ring depth: as many as fit
constexpr int PO_ATOMS = PO_N / 64;              // 64-column atoms of w and K-atoms of acc
constexpr int PO_A_ATOM_BYTES = PO_ROWS * GC_ATOM_ROW_BYTES;  // 64 rows x 64 of K
constexpr int PO_ACC_BYTES = PO_ATOMS * PO_A_ATOM_BYTES;      // 64 KiB
constexpr int PO_W_ATOM_BYTES = PO_BK * GC_ATOM_ROW_BYTES;    // 32 of K x 64 columns
constexpr int PO_STAGE_BYTES = PO_ATOMS * PO_W_ATOM_BYTES;    // 32 KiB
constexpr int PO_CHAINS = 16;                    // vec elements in flight per thread
constexpr int PO_EXP_PASSES = 32;
constexpr int PO_VEC_PER_BLOCK = PO_ROWS * 2048;  // the block's slice of x
constexpr int PO_GROUP_ELEMS = PO_CHAINS * PO_CONSUMERS;
constexpr int PO_GROUPS = PO_VEC_PER_BLOCK / PO_GROUP_ELEMS;  // stored once each
constexpr int PO_GROUP_TILES = PO_ITERS / PO_GROUPS;          // k-tiles a group stays
constexpr int PO_PASSES = PO_EXP_PASSES / PO_GROUP_TILES;     // passes per k-tile
constexpr size_t PO_SMEM = GC_BARRIER_BYTES + 1024 + PO_ACC_BYTES
                           + (size_t)PO_STAGES * PO_STAGE_BYTES;
static_assert(PO_SMEM <= GC_SMEM_CAP, "probe_overlap: shared memory over the cap");
static_assert(2 * PO_STAGES + 1 <= 2 * GC_MAX_STAGES, "probe_overlap: barriers over their room");
static_assert(128 * PO_PRODUCER_REGS + PO_CONSUMERS * PO_CONSUMER_REGS <= 65536,
              "probe_overlap: registers over the SM's");
static_assert(PO_GROUPS * PO_GROUP_TILES == PO_ITERS && PO_PASSES * PO_GROUP_TILES == PO_EXP_PASSES,
              "probe_overlap: every element gets its 32 passes inside the k-loop");

// ---- the two streams ------------------------------------------------------

// __expf(x) is ex2.approx of x * log2(e) (this constant); without -ftz it
// wraps the ex2 in a fix-up for arguments below -126, three more
// instructions an exp. The flush-to-zero ex2 gives the same bits for every
// argument whose exp is a normal float (here they lie in [-4, 1]).
constexpr float PO_LOG2E = 1.44269502162933349609375f;

__device__ __forceinline__ float ex2_ftz(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
  return r;
}

// one pass of the probe's exp(v * 0.25 - 1)
__device__ __forceinline__ float exp_pass(float v) {
  return ex2_ftz((v * 0.25f - 1.0f) * PO_LOG2E);
}

// this warpgroup's registers a thread (every thread of the warpgroup)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void exp_passes(float (&v)[PO_CHAINS]) {
#pragma unroll
  for (int p = 0; p < PO_PASSES; ++p)
#pragma unroll
    for (int j = 0; j < PO_CHAINS; ++j) v[j] = exp_pass(v[j]);
#pragma unroll
  for (int j = 0; j < PO_CHAINS; ++j) wgmma_keep(v[j]);  // computed before the wait
}

// the warpgroup's m64n128 accumulator for acc columns [128 c, 128 c + 128),
// rounded to bf16, into acc's swizzled K-major tile (column n of the product
// is K index n of the next one: atom n / 64, 16-byte chunk (n % 64) / 8 XOR
// row % 8)
__device__ __forceinline__ void store_acc_bf16(unsigned char* acc_s, const float (&acc)[64],
                                               int c, int warp_in_wg, int lane) {
  const int row = 16 * warp_in_wg + (lane >> 2);
  unsigned char* base = acc_s + row * GC_ATOM_ROW_BYTES + 4 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    unsigned char* p = base + (2 * c + (j >> 3)) * PO_A_ATOM_BYTES + (((j & 7) ^ (row & 7)) << 4);
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(p + 8 * GC_ATOM_ROW_BYTES) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <bool MMA, bool EXP>
__global__ void __launch_bounds__(PO_THREADS, 1)
probe_overlap_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ a,
                     const float* __restrict__ x, bf16* __restrict__ acc_out,
                     float* __restrict__ vec_out) {
  extern __shared__ unsigned char po_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(po_raw);
  uint64_t* empty = full + PO_STAGES;
  uint64_t* abar = empty + PO_STAGES;
  unsigned char* acc_s = gc_ring(po_raw);  // 1024-byte aligned, as the swizzle atoms need
  unsigned char* ring = acc_s + PO_ACC_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * PO_ROWS;

  if constexpr (MMA) {
    if (tid == 0) {
      for (int s = 0; s < PO_STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], PO_CONSUMER_WARPS);  // one arrival per consumer warp
      }
      mbar_init(abar, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  if (warp >= PO_CONSUMER_WARPS) {  // producer warpgroup: one thread issues every load
    regs_dec<PO_PRODUCER_REGS>();
    if (MMA && tid == PO_CONSUMERS) {
      mbar_arrive_expect_tx(abar, PO_ACC_BYTES);
#pragma unroll
      for (int q = 0; q < PO_ATOMS; ++q)
        tma_load_2d(acc_s + q * PO_A_ATOM_BYTES, &tm_a, abar, 64 * q, r0);
      for (int it = 0, s = 0, ph = 0; it < PO_ITERS; ++it) {
        if (it >= PO_STAGES) mbar_wait(&empty[s], ph ^ 1);  // every consumer warp freed it
        unsigned char* st = ring + s * PO_STAGE_BYTES;
        const int k = (it % PO_KTILES) * PO_BK;
        mbar_arrive_expect_tx(&full[s], PO_STAGE_BYTES);
#pragma unroll
        for (int q = 0; q < PO_ATOMS; ++q)
          tma_load_2d(st + q * PO_W_ATOM_BYTES, &tm_w, &full[s], 64 * q, k);
        if (++s == PO_STAGES) s = 0, ph ^= 1;
      }
    }
  } else {
    regs_inc<PO_CONSUMER_REGS>();
    const int wg = tid >> 7, warp_in_wg = warp & 3;
    const uint32_t acc_addr = gc_smem(acc_s);
    const uint32_t w_addr = gc_smem(ring) + 4 * wg * PO_W_ATOM_BYTES;  // this warpgroup's columns
    const size_t v0 = (size_t)blockIdx.x * PO_VEC_PER_BLOCK + tid;
    float cur[PO_CHAINS], nxt[PO_CHAINS];
    if constexpr (EXP) {
#pragma unroll
      for (int j = 0; j < PO_CHAINS; ++j) cur[j] = x[v0 + (size_t)j * PO_CONSUMERS];
    }
    // hands stage `s` back to the producer
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(&empty[s]);
      __syncwarp();
    };
    if constexpr (MMA) mbar_wait(abar, 0);

    float acc0[64], acc1[64];
    for (int p = 0, s = 0, ph = 0, prev = 0; p < PO_PRODUCTS; ++p) {
      if constexpr (MMA) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.0f;
      }
      for (int kt = 0; kt < PO_KTILES; ++kt) {
        const int it = p * PO_KTILES + kt;
        if constexpr (MMA) {
          mbar_wait(&full[s], ph);
          const uint32_t st = w_addr + s * PO_STAGE_BYTES;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < PO_BK / 16; ++kk) {
            const int k = kt * PO_BK + kk * 16;
            const uint64_t da =
                wgmma_desc_k_sw128(acc_addr + (k / 64) * PO_A_ATOM_BYTES + (k % 64) / 16 * 32);
            const uint32_t b = st + kk * 16 * GC_ATOM_ROW_BYTES;
            wgmma_m64n128k16_ss<0, 1>(acc0, da, wgmma_desc_mn_sw128(b, PO_W_ATOM_BYTES));
            wgmma_m64n128k16_ss<0, 1>(
                acc1, da, wgmma_desc_mn_sw128(b + 2 * PO_W_ATOM_BYTES, PO_W_ATOM_BYTES));
          }
          wgmma_commit();
        }
        if constexpr (EXP) {  // between the commit and the wait: the units may overlap
          const int g = it / PO_GROUP_TILES, phase = it % PO_GROUP_TILES;
          if (phase == 0 && g + 1 < PO_GROUPS) {
#pragma unroll
            for (int j = 0; j < PO_CHAINS; ++j)
              nxt[j] = x[v0 + (size_t)(g + 1) * PO_GROUP_ELEMS + (size_t)j * PO_CONSUMERS];
          }
          exp_passes(cur);
          if (phase == PO_GROUP_TILES - 1) {
#pragma unroll
            for (int j = 0; j < PO_CHAINS; ++j) {
              vec_out[v0 + (size_t)g * PO_GROUP_ELEMS + (size_t)j * PO_CONSUMERS] = cur[j];
              cur[j] = nxt[j];
            }
          }
        }
        if constexpr (MMA) {
          wgmma_wait<1>();  // the previous k-tile's products are done: hand it back
          if (kt > 0) release(prev);
          prev = s;
          if (++s == PO_STAGES) s = 0, ph ^= 1;
        }
      }
      if constexpr (MMA) {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          wgmma_keep(acc0[i]);
          wgmma_keep(acc1[i]);
        }
        release(prev);
        named_barrier(1, PO_CONSUMERS);  // both warpgroups have read the old rows
        store_acc_bf16(acc_s, acc0, 2 * wg, warp_in_wg, lane);
        store_acc_bf16(acc_s, acc1, 2 * wg + 1, warp_in_wg, lane);
        fence_proxy_async();             // the next product's wgmma reads them
        named_barrier(1, PO_CONSUMERS);
      }
    }

    // acc rows out (from the swizzled tile, or a itself), and vec (x itself)
    for (int c = tid; c < PO_ROWS * PO_N / 8; c += PO_CONSUMERS) {
      const int row = c / (PO_N / 8), cc = c % (PO_N / 8);
      const size_t g = (size_t)(r0 + row) * PO_N + cc * 8;
      uint4 v;
      if constexpr (MMA)
        v = *reinterpret_cast<const uint4*>(acc_s + (cc >> 3) * PO_A_ATOM_BYTES +
                                            row * GC_ATOM_ROW_BYTES + (((cc & 7) ^ (row & 7)) << 4));
      else
        v = *reinterpret_cast<const uint4*>(a + g);
      *reinterpret_cast<uint4*>(acc_out + g) = v;
    }
    if constexpr (!EXP) {
      const size_t b0 = (size_t)blockIdx.x * PO_VEC_PER_BLOCK / 4;
      for (int e = tid; e < PO_VEC_PER_BLOCK / 4; e += PO_CONSUMERS)
        reinterpret_cast<float4*>(vec_out)[b0 + e] = reinterpret_cast<const float4*>(x)[b0 + e];
    }
  }
}

template <bool MMA, bool EXP>
int launch_probe(const CUtensorMap& ta, const CUtensorMap& tw, const bf16* a, const float* x,
                 bf16* acc, float* vec, int M, int repeats, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(probe_overlap_kernel<MMA, EXP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PO_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(M / PO_ROWS, repeats);
  probe_overlap_kernel<MMA, EXP><<<grid, PO_THREADS, PO_SMEM, st>>>(ta, tw, a, x, acc, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// a [M,512] and w [512,512] bf16, acc_out [M,512] bf16, x and vec_out
// [M * 2048] f32; M a multiple of 64
extern "C" int probe_overlap(const void* a, const void* w, const void* x, void* acc_out,
                             void* vec_out, int M, int do_mma, int do_exp, int repeats,
                             void* stream) {
  if (M <= 0 || M % PO_ROWS || repeats <= 0 || repeats > 65535 ||
      !(do_mma || do_exp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tw;
  int e = encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, M, PO_N, 64, PO_ROWS,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  e = encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, PO_N, PO_N, 64, PO_BK,
                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  const bf16* pa = static_cast<const bf16*>(a);
  const float* px = static_cast<const float*>(x);
  bf16* pacc = static_cast<bf16*>(acc_out);
  float* pvec = static_cast<float*>(vec_out);
  if (!do_exp) return launch_probe<true, false>(ta, tw, pa, px, pacc, pvec, M, repeats, st);
  if (!do_mma) return launch_probe<false, true>(ta, tw, pa, px, pacc, pvec, M, repeats, st);
  return launch_probe<true, true>(ta, tw, pa, px, pacc, pvec, M, repeats, st);
}
