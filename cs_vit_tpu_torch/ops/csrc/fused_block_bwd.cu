// SwinV2 block backward for Hopper (sm_90a): the four kernels behind
// cs_vit_tpu_torch/ops/fused_block.py:FusedSwinBlock.backward.
//
// Replaces the TPU kernel cs_vit_tpu/ops/fused_block.py:973 (_pallas_backward,
// kernel body _bwd_kernel), which recomputes a slab of the forward in VMEM and
// backpropagates it in place, carrying the weight grads across its sequential
// grid in f32 output blocks. On Hopper blocks run in parallel in no order, so
// every sum across token rows or windows is written as f32 partials and summed
// in a fixed order: by a second, deterministic pass (sum_splits) inside the
// same entry point, or, in ln_residual_bwd, by the kernel's last blocks. As
// in the forward, only the attention kernel knows windows and the cyclic shift;
// the GEMMs and LayerNorms run over the B*H*W token rows in original order.
// One block backward = 4 gemm_wgrad + 4 gemm_dgrad + 2 ln_residual_bwd +
// 1 swin_window_attn_bwd:
//   m2b  = LNbwd(m2; g, dp1)                ln_residual_bwd   (+ dln2 scale/bias)
//   dW2  = gelu(m1)^T m2b, db2 = sum m2b    gemm_wgrad
//   m1b  = (m2b W2^T) * gelu'(m1)           gemm_dgrad  (GELU epilogue)
//   dW1  = h1^T m1b, db1                    gemm_wgrad
//   h1b  = g + m1b W1^T                     gemm_dgrad  (residual epilogue)
//   pb   = LNbwd(proj; h1b, dp0)            ln_residual_bwd   (+ dln1 scale/bias)
//   dWp  = o^T pb, dbp                      gemm_wgrad
//   ab   = pb Wproj^T                       gemm_dgrad  (dt out)
//   dqkv = attention backward(ab)           swin_window_attn_bwd (+ d rel_bias, d scale)
//   dWqkv = x^T dqkv, dbqkv                 gemm_wgrad
//   dx   = h1b + dqkv Wqkv^T                gemm_dgrad  (residual epilogue, dt out)
// Rounding points are _bwd_kernel's: every gradient that feeds a product is
// rounded to the compute dtype on its way into the product (the kernels read
// f32 gradients and round them as they load them), bias and LN grads sum the
// f32 values, the attention-output grad ab and p and ds are rounded to the
// compute dtype, gelu'(m1) reads m1 rounded to the compute dtype.
//
// What bounds each kernel on the H100, and what the design does about it:
//  * gemm_dgrad: bytes (the f32 dY, 4 bytes an element, and the output
//    dominate; C <= 1024 gives the products little reuse). bf16: wgmma
//    (gemm_core.cuh) on output tiles of 128 x 128, 128 x 64 or 64 x 64, W read
//    as stored ([in,out]: K-major for this product, no transpose pass) and
//    the f32 dY by TMA into an mbarrier ring, dY rounded to bf16 in
//    registers into the A fragments, the epilogue through shared memory in
//    contiguous chunks. f32: the SIMT kernel below.
//  * gemm_wgrad: bytes. The product reduces over all M token rows; the f32
//    gradient dY (4 bytes an element, read once for every 128 output rows)
//    dominates what it moves. bf16: wgmma (gemm_core.cuh), X by TMA into a
//    4-stage ring of 128-byte-swizzled MN-major tiles, dY through registers
//    converted into the bf16 B tile with its column sums (the bias grad)
//    taken on the way; split-K over row ranges only where the output tiles
//    leave most SMs idle (stage 0: 1-4 tiles), f32 partials summed in a
//    fixed order. f32 operands run on SIMT FMA (the tensor cores would round
//    them to TF32), 64x64 tiles, the bias column sums by the blocks of the
//    first output-row tile.
//  * ln_residual_bwd: bytes (z f32 and g in, dz f32 out: 10-12 bytes an
//    element against 12 FLOPs). Rows in registers (ln_core.cuh): half a warp
//    (C = 128), a warp (C = 256, 512) or four warps (C = 1024) a row, 8
//    columns a lane a chunk, z and g read once each as 16-byte pieces and dz
//    written once, f32 statistics recomputed from z (E[z^2]-E[z]^2 clamped
//    at 0); built for each Swin-B width (no masks) and once masked for any C
//    a multiple of 8 up to 1024. The lane-to-column map is fixed, so each
//    lane carries its dgamma/dbeta partials in registers across its rows,
//    the next pass's row loaded before this one's arithmetic. The block sums
//    them once in shared memory, each cluster of 8 blocks through
//    distributed shared memory (one [2C] row per cluster written), and the
//    last block of each cluster rank to finish sums its eighth of the
//    columns over the clusters, its threads sharing the clusters so that
//    many loads are in flight: one launch, the tail split over 8 SMs. The
//    grid (fused_block.py:_ln_plan) is two blocks an SM where there are rows
//    enough (stage 3 at b8: 264 four-warp blocks; stages 0 and 1: 31-124
//    rows a block): more blocks mean more clusters to place and to sum
//    over, which costs more than their loads in flight gain.
//  * swin_window_attn_bwd: latency of its dependent products, not the tensor
//    cores' rate (81 GFLOP a Swin-B b8 step, 0.08 ms at the bf16 peak) nor
//    bytes. bf16: mma.sync on the pieces of window_attn_core.cuh, one block
//    per (head, window position, image group) owning whole windows, so dk and
//    dv never leave the block as partials; d rel_bias summed over a block's
//    images in its own slab, so the scratch follows the resident blocks, not
//    the batch; two barriers per 128 query rows. f32 (the check path):
//    SIMT, one block per (head, window), the L x L scores of a 32-row query
//    tile in shared memory, dk and dv accumulated there across the tiles,
//    d rel_bias and d logit_scale as per-window f32 partials.
// Every cross-block sum runs in a fixed order: the step is bit-reproducible.
//
// Plain C interface for ctypes. Every entry point returns cudaGetLastError()
// right after its last launch; it launches on the caller's stream, allocates
// nothing (partials live in caller-provided scratch) and does not synchronise.

#include <cooperative_groups.h>
#include <limits.h>

#include "common.cuh"
#include "gemm_core.cuh"
#include "ln_core.cuh"
#include "window_attn_core.cuh"

namespace {

__device__ __forceinline__ float gelu_grad(float x) {
  // d/dx of exact-erf GELU: Phi(x) + x * phi(x)
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f)) +
         x * expf(-0.5f * x * x) * 0.3989422804014327f;
}

// out[i] = sum_s part[s * n + i], s in [0, splits): a fixed summation order
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int splits, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
    out[i] = s;
  }
}

int launch_sum_splits(const float* part, float* out, int splits, size_t n, cudaStream_t st) {
  const int threads = 256;
  size_t blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<(unsigned)blocks, threads, 0, st>>>(part, out, splits, n);
  return (int)cudaGetLastError();
}

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_ADD = 2 };

// ---------------------------------------------------------------------------
// gemm_dgrad, bf16: out[M,K] = epi(round(dY[M,N]) . W[K,N]^T) on wgmma
// (gemm_core.cuh). Replaces the input-grad products of
// cs_vit_tpu/ops/fused_block.py:_bwd_kernel (:394).
// Output tile BM x BN (128 x 128, 128 x 64 or 64 x 64 in rows m and columns
// k; one consumer warpgroup per 64 rows; fused_block.py:_gemm_plan), depth =
// n, 64 a stage. Both operands are K-major (n contiguous). Thread 0 keeps a
// ring of up to 8 stages (sized to let two blocks share an SM: two stages
// of 48 or 40 KB for the 128-row tiles; fewer where N is shorter) full by
// TMA, refilling each stage as soon as the block has handed it back: W
// [K,N] as stored, which is this product's B operand (a box {64 of n, BN
// rows of k}, bf16), and the f32 dY rows (two boxes {32 of n, BM rows}),
// both 128-byte swizzled; out-of-bounds rows and columns arrive as 0. (A
// producer warp of its own would make the block 9 warps: three of
// them on one of the SM's four register files, which caps a thread at 168
// registers, and two such blocks at 96.) dY is rounded to bf16 where
// it is read, as the plain version rounds it: each consumer thread reads
// the f32 values of its own A fragments (two rows, four column pairs per
// 16-deep step) from the stage, packs them to bf16 pairs, and the products
// take A from registers (wgmma ... {a0..a3}, descB), so the bf16 A never
// goes back to shared memory and needs no proxy fence (loaded from device
// memory a stage ahead into registers instead, they would leave each stage
// waiting one memory latency). A stage goes back to thread 0 when its
// products are done: a block keeps no product in flight past its stage
// (with one group in flight, a thread packing the next stage's fragments
// would define a wgmma's input registers while it runs, and ptxas then
// serialises every product), and the SM's other block fills the gaps. (A
// ring of three or more stages, one block an SM, and a bf16 copy of dY in
// shared memory for wgmma to read with one group in flight both measured
// slower on the step's shapes: cs_vit_tpu_torch/tools/gemm_sweep.py.) The
// epilogue stages the f32
// accumulators in shared memory (the ring, free by then) and walks the tile
// in rows of 4-column chunks, so that a warp's loads of aux and stores of
// the output are contiguous and a thread issues all its aux loads before
// its first store (rather than 8 rows of 8 or 16 bytes a warp instruction
// in the accumulators' own pairs, one load before each store): times
// gelu'(m1) with m1 read in bf16 (the exact erf), or plus aux read in bf16
// or f32, one rounding to the output dtype.
// The grid walks the column tiles of one band of BM dY rows before the next
// band, so the blocks that read the same f32 dY rows run together and all
// but the first read them from L2: dY comes from device memory about once,
// though each band is read ceil(K / BN) times.
// What bounds it on the H100: bytes (4 M N + 2 N K + 4 or 2 M K, plus the
// aux, against 2 M N K FLOPs): 0.77 ms a b8 step, summed per call as
// chip_smoke.py counts it.
// ---------------------------------------------------------------------------

template <int BM, int BN>
struct DgradGemm {
  // no producer warp: with one, a block of 9 warps may give a thread no
  // more than 168 registers (three warps on one of the SM's four register
  // files), and two such blocks no more than 96
  static constexpr int WG = BM / 64, THREADS = 128 * WG, BK = 64;
  static constexpr int W_BYTES = BN * GC_ATOM_ROW_BYTES;      // BN rows x 64 of n, bf16
  static constexpr int DY_HALF_BYTES = BM * GC_ATOM_ROW_BYTES;  // BM rows x 32 of n, f32
  static constexpr int STAGE_BYTES = W_BYTES + 2 * DY_HALF_BYTES;
  static constexpr int TILE_BYTES = BM * acc_pitch<BN>() * 4;
};

// this thread's A fragments for one 64-deep stage, rounded to bf16 pairs
// from the stage's f32 dY tile: two 128-byte-swizzled halves of 32 columns
// (TMA boxes {32, BM}), row `row` (+8 if q & 1), columns 16 kk + c (+8 if
// q & 2) and the next. Rows and columns past M or N arrived as 0.
__device__ __forceinline__ void dy_frags(uint32_t (&af)[4][4], const unsigned char* dy_tile,
                                         int half_bytes, int row, int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row + 8 * (q & 1), col = 16 * kk + c + 4 * (q & 2);
      const int cw = col & 31;
      const float2 v = *reinterpret_cast<const float2*>(
          dy_tile + (col >> 5) * half_bytes + r * GC_ATOM_ROW_BYTES
          + ((((cw >> 2) ^ (r & 7))) << 4) + (cw & 3) * 4);
      af[kk][q] = pack_bf16(v.x, v.y);
    }
}

template <int BM, int BN>
__global__ void __launch_bounds__(DgradGemm<BM, BN>::THREADS, 1)
dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_dy, const void* __restrict__ aux,
                   void* __restrict__ out, int M, int N, int K, int stages, int epi, int aux_f32,
                   int out_f32) {
  using S_ = DgradGemm<BM, BN>;
  constexpr int BK = S_::BK, STAGE_BYTES = S_::STAGE_BYTES, CONSUMERS = S_::THREADS;
  extern __shared__ unsigned char dg_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(dg_raw);
  uint64_t* empty = full + GC_MAX_STAGES;
  unsigned char* ring = gc_ring(dg_raw);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int iters = (N + BK - 1) / BK;
  // thread 0 issues every load: the first `stages` here, each later one
  // into the stage the block has just handed back
  auto load = [&](int it, int s) {
    unsigned char* st = ring + s * STAGE_BYTES;
    const int n = it * BK;
    mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
    tma_load_2d(st, &tm_w, &full[s], n, k0);
    tma_load_2d(st + S_::W_BYTES, &tm_dy, &full[s], n, m0);
    tma_load_2d(st + S_::W_BYTES + S_::DY_HALF_BYTES, &tm_dy, &full[s], n + 32, m0);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
    for (int it = 0; it < stages && it < iters; ++it) load(it, it);
  }
  __syncthreads();

  const int lane = tid & 31, wg = tid >> 7;
  const int row = 16 * (tid >> 5) + (lane >> 2);  // this thread's first A row in the tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  uint32_t af[4][4];  // this stage's A fragments, bf16 pairs
  for (int it = 0, s = 0, ph = 0; it < iters; ++it) {
    mbar_wait(&full[s], ph);
    const unsigned char* st = ring + s * STAGE_BYTES;
    dy_frags(af, st + S_::W_BYTES, S_::DY_HALF_BYTES, row, 2 * (lane & 3));
    const uint32_t w_addr = gc_smem(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<BN, 0>(acc, af[kk], wgmma_desc_k_sw128(w_addr + kk * 32));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) wgmma_keep(af[kk][q]);
    mbar_arrive(&empty[s]);
    if (tid == 0 && it + stages < iters) {  // refill the stage once all are done with it
      mbar_wait(&empty[s], ph);
      load(it + stages, s);
    }
    __syncwarp();  // warp 0 whole again before the next wgmma
    if (++s == stages) s = 0, ph ^= 1;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) wgmma_keep(acc[i]);

  // epilogue: the accumulators through shared memory (the ring is free once
  // every warpgroup's last products are done), then out in rows of 4-column
  // chunks, each warp's loads of aux and stores contiguous; a thread loads
  // all of its aux chunks before it computes any output
  constexpr int CH = BN / 4, RSTEP = CONSUMERS / CH, ROWS = BM / RSTEP, P = acc_pitch<BN>();
  float* tile = reinterpret_cast<float*>(ring);
  named_barrier(1, CONSUMERS);
  stage_acc<BN>(tile + wg * 64 * P, acc, tid & 127);
  named_barrier(1, CONSUMERS);
  const int cq = tid % CH, rq = tid / CH, c = k0 + 4 * cq;
  if (c >= K) return;  // K is a multiple of 8: a chunk is in or out whole
  constexpr int BATCH = ROWS < 8 ? ROWS : 8;  // rows whose aux is loaded at once
#pragma unroll
  for (int i0 = 0; i0 < ROWS; i0 += BATCH) {
    float4 x[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int r = m0 + rq + RSTEP * (i0 + i);
      const size_t o = (size_t)r * K + c;
      x[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (epi != EPI_NONE && r < M)
        x[i] = aux_f32 ? load4(static_cast<const float*>(aux) + o)
                       : load4(static_cast<const bf16*>(aux) + o);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int rt = rq + RSTEP * (i0 + i), r = m0 + rt;
      if (r >= M) break;
      float4 v = *reinterpret_cast<const float4*>(tile + rt * P + 4 * cq);
      if (epi == EPI_GELU) {
        v.x *= gelu_grad(x[i].x);
        v.y *= gelu_grad(x[i].y);
        v.z *= gelu_grad(x[i].z);
        v.w *= gelu_grad(x[i].w);
      } else if (epi == EPI_ADD) {
        v.x += x[i].x;
        v.y += x[i].y;
        v.z += x[i].z;
        v.w += x[i].w;
      }
      const size_t o = (size_t)r * K + c;
      if (out_f32) store4(static_cast<float*>(out) + o, v);
      else store4(static_cast<bf16*>(out) + o, v);
    }
  }
}

template <int BM, int BN>
int launch_dgrad_bf16(const float* dY, const bf16* W, const void* aux, void* out, int M, int N,
                      int K, int stages, int epi, int aux_f32, int out_f32, cudaStream_t st) {
  using S_ = DgradGemm<BM, BN>;
  CUtensorMap tw, tdy;
  int e = encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, W, K, N, 64, BN,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  e = encode_2d(&tdy, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dY, M, N, 32, BM,
                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  static int resident[WC_MAX_DEVICES];
  const int blocks = device_blocks(resident, dgrad_wgmma_kernel<BM, BN>, S_::THREADS,
                                   GC_SMEM_CAP);
  if (blocks < 0) return -blocks;
  const size_t smem = gc_smem_bytes(stages, S_::STAGE_BYTES, S_::TILE_BYTES);
  if (smem > GC_SMEM_CAP) return (int)cudaErrorInvalidValue;
  dim3 grid((K + BN - 1) / BN, (M + BM - 1) / BM);
  dgrad_wgmma_kernel<BM, BN><<<grid, S_::THREADS, smem, st>>>(tw, tdy, aux, out, M, N, K, stages,
                                                              epi, aux_f32, out_f32);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gemm_wgrad, bf16: part[s][K][N] = X[rows of split s, K]^T . round(dY[rows, N])
// and part[s][K*N + n] = sum_rows dY[., n] (f32), on wgmma (gemm_core.cuh).
// Replaces the weight- and bias-grad products of
// cs_vit_tpu/ops/fused_block.py:_bwd_kernel (:394), which the TPU grid sums
// across its sequential steps in f32 output blocks.
// Output tile 128 (k) x 128 (n), depth = token rows m, 64 rows a stage, a
// ring of 4 stages. Warpgroup 0 is the producer: one thread keeps the ring full of X by
// TMA (128-byte-swizzled 64-column atoms, which are wgmma's MN-major A operand
// as they land). The two consumer warpgroups read the f32 dY tile from device
// memory into registers one stage ahead (each thread four columns of a few
// rows) and convert it into the stage's bf16 B operand in the same swizzled
// MN-major layout, taking the f32 column sums on the way (the bias grad costs
// no pass of its own); then they fence the generic writes to the async
// proxy, meet at a named barrier and run 4 wgmma m64n128k16 each (warpgroup
// w the output rows 64 w .. 64 w + 63). A stage goes back to the
// producer once both warpgroups' products on it have completed (one wgmma
// group in flight, so the next stage's conversion overlaps the products).
// What bounds it on the H100: bytes. Every block reads its dY columns in f32
// once per 128 output rows, so dY is read K / 128 times: over a Swin-B b8
// step the operands move 7.2 GB, 2.2 ms at the card's 3.35 TB/s, which is
// what chip_smoke.py reads for the kernel queued. (Two variants read no
// faster: the f32 dY tile staged in shared memory by TMA, and 256-row
// output tiles, whose fewer tiles need more split partials.) Epilogue:
// f32 pairs straight from the accumulators, the column sums across the 8
// consumer warps in a fixed order. Split-K (rows_per_split a multiple of 64,
// so that a split's stages never reach the next split's rows) only where the
// output tiles leave most of the SMs idle; the partials are summed by
// sum_splits.
// ---------------------------------------------------------------------------

struct WgradShape {
  static constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, THREADS = 384;
  static constexpr int ATOM_BYTES = BK * GC_ATOM_ROW_BYTES;  // BK rows x 128 B
  static constexpr int X_BYTES = 2 * ATOM_BYTES;             // X: BK rows x 128 cols bf16
  static constexpr int B_BYTES = 2 * ATOM_BYTES;             // dY as bf16: BK x 128, two atoms
  static constexpr int STAGE_BYTES = X_BYTES + B_BYTES;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + 8 * BN * 4
                                 + 2 * STAGES * sizeof(uint64_t);
};

// the f32 dY rows cw + 8 i (i < BK / 8) of the stage at token row m0, columns
// j0 + col .. + 3 (zero past the split's end re or past N)
__device__ __forceinline__ void load_dy_rows(float4 (&dy)[WgradShape::BK / 8],
                                             const float* __restrict__ dY, int m0, int re, int N,
                                             int j0, int col, int cw, bool col_in) {
#pragma unroll
  for (int i = 0; i < WgradShape::BK / 8; ++i) {
    const int m = m0 + cw + 8 * i;
    dy[i] = (col_in && m < re)
                ? __ldg(reinterpret_cast<const float4*>(dY + (size_t)m * N + j0 + col))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(WgradShape::THREADS, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const float* __restrict__ dY,
                   float* __restrict__ part, int M, int N, int K, int rows_per_split) {
  using S_ = WgradShape;
  constexpr int BM = S_::BM, BN = S_::BN, BK = S_::BK, STAGES = S_::STAGES;
  constexpr int ATOM_BYTES = S_::ATOM_BYTES, X_BYTES = S_::X_BYTES, STAGE_BYTES = S_::STAGE_BYTES;
  extern __shared__ unsigned char wg_raw[];
  // stages 1024-byte aligned (the swizzle atoms' alignment)
  unsigned char* smem = wg_raw + ((1024 - (gc_smem(wg_raw) & 1023)) & 1023);
  float* csum_s = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);  // [8][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(csum_s + 8 * BN);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BN, i0 = blockIdx.y * BM, split = blockIdx.z;
  const int rb = split * rows_per_split;
  const int re = min(M, rb + rows_per_split);
  const int iters = re > rb ? (re - rb + BK - 1) / BK : 0;
  float* out = part + (size_t)split * ((size_t)K * N + N);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    if (tid == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * STAGE_BYTES;
        const int m = rb + it * BK;
        mbar_arrive_expect_tx(&full[s], X_BYTES);
        tma_load_2d(st, &tm_x, &full[s], i0, m);
        tma_load_2d(st + ATOM_BYTES, &tm_x, &full[s], i0 + 64, m);
      }
    }
    return;
  }

  const int ct = tid - 128, wg = ct >> 7, cw = ct >> 5, lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float cs0 = 0.0f, cs1 = 0.0f, cs2 = 0.0f, cs3 = 0.0f;  // columns 4 lane .. 4 lane + 3
  const int col = 4 * lane, atom = col >> 6, ac = col & 63;
  const bool col_in = j0 + col < N;  // N is a multiple of 8: four columns in or out together
  float4 dy[BK / 8];                 // rows cw + 8 i of the next stage
  if (iters > 0) load_dy_rows(dy, dY, rb, re, N, j0, col, cw, col_in);

  for (int it = 0; it < iters; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    unsigned char* st = smem + s * STAGE_BYTES;
    unsigned char* bs = st + X_BYTES;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int r = cw + 8 * i;
      const float4 v = dy[i];
      cs0 += v.x;
      cs1 += v.y;
      cs2 += v.z;
      cs3 += v.w;
      uint2 packed;
      packed.x = pack_bf16(v.x, v.y);
      packed.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(bs + atom * ATOM_BYTES + r * GC_ATOM_ROW_BYTES
                                + ((((ac >> 3) ^ (r & 7))) << 4) + (ac & 7) * 2) = packed;
    }
    if (it + 1 < iters) load_dy_rows(dy, dY, rb + (it + 1) * BK, re, N, j0, col, cw, col_in);
    fence_proxy_async();
    named_barrier(1, 256);  // both warpgroups' halves of the bf16 tile
    wgmma_fence();
    const uint32_t xa = gc_smem(st + wg * ATOM_BYTES), ba = gc_smem(bs);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16_ss<1, 1>(
          acc, wgmma_desc_mn_sw128(xa + kk * 16 * GC_ATOM_ROW_BYTES, ATOM_BYTES),
          wgmma_desc_mn_sw128(ba + kk * 16 * GC_ATOM_ROW_BYTES, ATOM_BYTES));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: hand it back
    if (it > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();

  const int wr = (ct & 127) >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int gj = j0 + j * 8 + 2 * t;
    if (gj >= N) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gi = i0 + wg * 64 + wr * 16 + g + 8 * hh;
      if (gi < K)
        *reinterpret_cast<float2*>(out + (size_t)gi * N + gj) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
  if (blockIdx.y == 0) {
    *reinterpret_cast<float4*>(csum_s + cw * BN + col) = make_float4(cs0, cs1, cs2, cs3);
    named_barrier(1, 256);
    if (ct < BN && j0 + ct < N) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += csum_s[w * BN + ct];
      out[(size_t)K * N + j0 + ct] = sum;
    }
  }
}

int launch_wgrad_bf16(const bf16* X, const float* dY, float* part, int M, int N, int K,
                      int splits, int rows_per_split, cudaStream_t st) {
  using S_ = WgradShape;
  if (rows_per_split % S_::BK != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tx;
  const int e = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, X, M, K, 64, S_::BK,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  static int resident[WC_MAX_DEVICES];
  const int blocks = device_blocks(resident, wgrad_wgmma_kernel, S_::THREADS, S_::SMEM);
  if (blocks < 0) return -blocks;
  dim3 grid((N + S_::BN - 1) / S_::BN, (K + S_::BM - 1) / S_::BM, splits);
  wgrad_wgmma_kernel<<<grid, S_::THREADS, S_::SMEM, st>>>(tx, dY, part, M, N, K, rows_per_split);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 GEMMs on SIMT FMA: out(i, j) = sum_r A(i, r) B(r, j) with strided
// operands A(i, r) = A[i*sai + r*sar], B(r, j) = B[r*sbr + j*sbj]; 64x64 tile,
// depth 16, 256 threads of 4x4 outputs. Serves dgrad (with its epilogues) and
// wgrad (split-K over r, with the bias column sums of B).
// ---------------------------------------------------------------------------

constexpr int FB = 64, FK = 16;

template <int EPI, typename AuxT>
__global__ void __launch_bounds__(256)
gemm_f32_strided_kernel(const float* __restrict__ A, const float* __restrict__ B,
                        const AuxT* __restrict__ aux, float* __restrict__ part,
                        int I, int J, int R, long long sai, long long sar, long long sbr,
                        long long sbj, int rows_per_split, int bias_sums) {
  __shared__ float As[FK][FB + 1];
  __shared__ float Bs[FK][FB + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * FB, j0 = blockIdx.x * FB, s = blockIdx.z;
  const int rb = s * rows_per_split;
  const int re = min(R, rb + rows_per_split);
  float* out = part + (size_t)s * ((size_t)I * J + (bias_sums ? J : 0));
  float acc[4][4] = {};
  for (int r0 = rb; r0 < re; r0 += FK) {
    for (int e = tid; e < FB * FK; e += 256) {
      // walk the contiguous index fastest
      int i, r;
      if (sar == 1) { i = e / FK; r = e % FK; } else { r = e / FB; i = e % FB; }
      const int gi = i0 + i, gr = r0 + r;
      As[r][i] = (gi < I && gr < re) ? A[gi * sai + gr * sar] : 0.0f;
      int j, r2;
      if (sbj == 1) { r2 = e / FB; j = e % FB; } else { j = e / FK; r2 = e % FK; }
      const int gj = j0 + j, gr2 = r0 + r2;
      Bs[r2][j] = (gj < J && gr2 < re) ? B[gr2 * sbr + gj * sbj] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gi = i0 + ty + 16 * i, gj = j0 + tx + 16 * j;
      if (gi < I && gj < J) {
        const size_t o = (size_t)gi * J + gj;
        float v = acc[i][j];
        if (EPI == EPI_GELU) v *= gelu_grad(to_f(aux[o]));
        if (EPI == EPI_ADD) v += to_f(aux[o]);
        out[o] = v;
      }
    }
  if (bias_sums && blockIdx.y == 0) {
    for (int j = tid; j < FB; j += 256) {
      const int gj = j0 + j;
      if (gj >= J) continue;
      float sum = 0.0f;
      for (int r = rb; r < re; ++r) sum += B[r * sbr + gj * sbj];
      out[(size_t)I * J + gj] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// ln_residual_bwd: for y = res + dp[b, col] * (LN(z) * gamma + beta), per row
//   zh = (z - mean) r, gz = g dp, zb = gz gamma,
//   dz = (zb - mean(zb) - zh mean(zb zh)) r,
// and per column dgamma = sum gz zh, dbeta = sum gz over every row. Replaces
// the LayerNorm VJPs of cs_vit_tpu/ops/fused_block.py:_bwd_kernel (:394).
// Rows in registers (ln_core.cuh): each row's z and g read once, the next
// pass's row loaded before this one's arithmetic, dz written once, gamma
// read once into registers. Each lane carries its columns' dgamma/dbeta
// partials in registers across its rows; then, in a fixed order: the
// block's row groups summed in shared memory; the 8 blocks of a
// cluster summed through distributed shared memory, block rank q taking
// columns [q, q + 1) * 2C / 8 of all 8 and writing them to `part` (one [2C]
// row per cluster); the last block of each rank to finish (a counter per
// rank, which that block sets back to 0) sums its columns over the clusters
// into `out`, spreading the clusters over its threads so that many loads
// are in flight. Blocks past the last row take part with zero partials.
// ---------------------------------------------------------------------------

// floats in flight per thread in the last blocks' sum over the clusters
constexpr int LN_TAIL_FLOATS = 64;

// V adjacent floats (V = 4: 16-byte aligned): from shared or distributed
// shared memory, from L2 (written by other blocks of this launch), and stored
template <int V> __device__ __forceinline__ void ldv(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int V> __device__ __forceinline__ void ldv_cg(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldcg(p);
  }
}
template <int V> __device__ __forceinline__ void stv(float* p, const float (&v)[V]) {
  if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}

// atomic add with acquire and release at GPU scope: the writes ordered before
// it (the block's, by a barrier) are visible to whoever reads the count after
__device__ __forceinline__ unsigned atomic_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// columns [rank, rank + 1) * slice of this cluster's partials: the 8 ranks'
// block sums (lsm[0, 2C) of each) added in rank order, V columns a load
template <int V>
__device__ __forceinline__ void ln_cluster_slice(cooperative_groups::cluster_group cluster,
                                                 float* lsm, float* row, int rank, int slice) {
  for (int c = threadIdx.x * V; c < slice; c += blockDim.x * V) {
    float s[V], v[LN_CLUSTER][V];
#pragma unroll
    for (int q = 0; q < LN_CLUSTER; ++q) ldv<V>(cluster.map_shared_rank(lsm, q) + rank * slice + c, v[q]);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s[e] = v[0][e];
#pragma unroll
      for (int q = 1; q < LN_CLUSTER; ++q) s[e] += v[q][e];
    }
    stv<V>(row + rank * slice + c, s);
  }
}

// out[rank * slice, (rank + 1) * slice) = the clusters' rows of `part` summed
// in a fixed order: `ways` threads share each V-column, thread j taking
// clusters j, j + ways, ... in order (LN_TAIL_FLOATS / V loads in flight),
// their sums added in order of j through `red` (ways * slice floats)
template <int V>
__device__ __forceinline__ void ln_clusters_sum(const float* part, float* out, float* red,
                                                int rank, int slice, int clusters, int C2) {
  constexpr int LOADS = LN_TAIL_FLOATS / V;
  const int cols = slice / V;
  const bool wide = (int)blockDim.x >= cols;
  const int ways = wide ? blockDim.x / cols : 1, way = wide ? threadIdx.x / cols : 0;
  if (way < ways) {
    for (int c = (wide ? threadIdx.x % cols : threadIdx.x) * V; c < slice;
         c += (wide ? cols : blockDim.x) * V) {
      const float* src = part + (size_t)rank * slice + c;
      float s[V] = {};
      for (int k0 = way; k0 < clusters; k0 += LOADS * ways) {
        float v[LOADS][V];
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const int k = k0 + j * ways;
          if (k < clusters) {
            ldv_cg<V>(src + (size_t)k * C2, v[j]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[j][e] = 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < LOADS; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e) s[e] += v[j][e];
      }
      stv<V>(red + way * slice + c, s);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < slice; c += blockDim.x) {
    float s = red[c];
    for (int j = 1; j < ways; ++j) s += red[j * slice + c];
    out[rank * slice + c] = s;
  }
}

template <typename GT, typename DT, int TPR, int VPT, int CX>
__global__ void __cluster_dims__(LN_CLUSTER, 1, 1) __launch_bounds__(LN_THREADS)
ln_residual_bwd_kernel(const float* __restrict__ z, const GT* __restrict__ g,
                       const DT* __restrict__ gamma, const float* __restrict__ dp, int dp_col,
                       int rows_per_image, float* __restrict__ dz, float* __restrict__ part,
                       unsigned* __restrict__ counters, float* __restrict__ out, int M,
                       int C_arg, float eps) {
  // [groups][2C]: dgamma | dbeta of each group, then LN_THREADS floats for
  // the last block's sum over the clusters
  extern __shared__ __align__(16) float lsm[];
  __shared__ bool last;
  const int C = CX ? CX : C_arg;
  const int groups = blockDim.x / TPR, group = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  int r0, r1;
  ln_block_rows(M, r0, r1);
  float pg[VPT][8], pb[VPT][8], gm[VPT][8];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    zero8(pg[i]);
    zero8(pb[i]);
    const int col = ln_col<TPR>(lane, i);
    if (ln_in_row<CX>(col, C)) load8(gamma + col, gm[i]); else zero8(gm[i]);
  }
  // one row's z and g (zeros past the block's rows or the row's columns)
  auto load_row = [&](int row, float (&zr)[VPT][8], float (&gr)[VPT][8]) {
    const bool valid = row < r1;
    const size_t off = (size_t)(valid ? row : 0) * C;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = ln_col<TPR>(lane, i);
      if (valid && ln_in_row<CX>(col, C)) {
        load8(z + off + col, zr[i]);
        load8(g + off + col, gr[i]);
      } else {
        zero8(zr[i]);
        zero8(gr[i]);
      }
    }
  };
  // the row's dz, its dgamma/dbeta terms added to the lane's partials
  auto row_grad = [&](int row, float (&zh)[VPT][8], float (&gz)[VPT][8]) {
    const bool valid = row < r1;
    const size_t off = (size_t)(valid ? row : 0) * C;
    float mean, r;
    ln_stats<TPR, VPT>(zh, C, eps, mean, r);
    const float d = (dp && valid) ? dp[(row / rows_per_image) * 2 + dp_col] : 1.0f;
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        zh[i][e] = (zh[i][e] - mean) * r;
        const float gze = gz[i][e] * d;
        pg[i][e] += gze * zh[i][e];
        pb[i][e] += gze;
        gz[i][e] = gze * gm[i][e];  // zb from here on
        a += gz[i][e];
        b += gz[i][e] * zh[i][e];
      }
    }
    group_sum2<TPR>(a, b);
    a /= C;
    b /= C;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = ln_col<TPR>(lane, i);
      if (!valid || !ln_in_row<CX>(col, C)) continue;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = (gz[i][e] - a - zh[i][e] * b) * r;
      store8(dz + off + col, o);
    }
  };
  // two rows a group in flight: a pass's loads are issued before the
  // arithmetic of the pass before it
  float zA[VPT][8], gA[VPT][8], zB[VPT][8], gB[VPT][8];
  if (r0 < r1) load_row(r0 + group, zA, gA);
  for (int base = r0; base < r1; base += 2 * groups) {
    const bool second = base + groups < r1;
    if (second) load_row(base + groups + group, zB, gB);
    row_grad(base + group, zA, gA);
    if (second) {
      if (base + 2 * groups < r1) load_row(base + 2 * groups + group, zA, gA);
      row_grad(base + groups + group, zB, gB);
    }
  }
  // the block's sum over its row groups, in group order, into group 0's row
  const int C2 = 2 * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = ln_col<TPR>(lane, i);
    if (!ln_in_row<CX>(col, C)) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      lsm[(size_t)group * C2 + col + e] = pg[i][e];
      lsm[(size_t)group * C2 + C + col + e] = pb[i][e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C2; c += blockDim.x) {
    float s = lsm[c];
    for (int q = 1; q < groups; ++q) s += lsm[(size_t)q * C2 + c];
    lsm[c] = s;
  }
  // the cluster's sum over its blocks, in rank order: rank q its slice
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank(), slice = C2 / LN_CLUSTER;
  const int clusters = gridDim.x / LN_CLUSTER, cl = blockIdx.x / LN_CLUSTER;
  const bool vec = slice % 4 == 0;  // C a multiple of 16: 16-byte loads
  if (vec) ln_cluster_slice<4>(cluster, lsm, part + (size_t)cl * C2, rank, slice);
  else ln_cluster_slice<1>(cluster, lsm, part + (size_t)cl * C2, rank, slice);
  // done reading the ranks' shared memory; no rank leaves before all are
  // (ln_cluster_wait below), but the counting goes on meanwhile
  ln_cluster_arrive();
  __syncthreads();  // the block's partials, before thread 0's release
  if (threadIdx.x == 0) last = atomic_add_acq_rel(&counters[rank], 1u) == (unsigned)(clusters - 1);
  __syncthreads();
  if (last) {
    // the last block of this rank: its slice summed over the clusters
    float* red = lsm + (size_t)groups * C2;
    if (vec) ln_clusters_sum<4>(part, out, red, rank, slice, clusters, C2);
    else ln_clusters_sum<1>(part, out, red, rank, slice, clusters, C2);
    if (threadIdx.x == 0) counters[rank] = 0;
  }
  ln_cluster_wait();
}

// ---------------------------------------------------------------------------
// swin_window_attn_bwd, f32 (the check path; the f32 operands would round to
// TF32 on the tensor cores): one CUDA block per (head, window of an image); hd = 32
// (one lane per channel), L = ws*ws in {16, 64, 256}, query tiles of
// min(32, L) rows. Tokens are gathered and scattered at their shifted,
// partitioned positions by index, as in the forward kernel.
// ---------------------------------------------------------------------------

constexpr int AB_THREADS = 256, AB_HD = 32, AB_WARPS = AB_THREADS / 32;

template <int L>
struct AttnBwdShape {
  static constexpr int QT = L < 32 ? L : 32;
  static constexpr int LDK = AB_HD + 1;     // odd stride: no bank conflicts across keys
  static constexpr int TPK = AB_THREADS / L;  // threads per key
  static constexpr int DN = AB_HD / TPK;      // channels per thread in the dk/dv sums
  static constexpr int NRG = AB_THREADS / L;  // row groups in the score passes
  static constexpr size_t smem_floats =
      4 * (size_t)L * LDK + 3 * (size_t)QT * AB_HD + (size_t)QT * L + QT + AB_WARPS;
};

template <typename T, int L>
__global__ void __launch_bounds__(AB_THREADS)
window_attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                       const T* __restrict__ rel_bias, const T* __restrict__ mask,
                       const float* __restrict__ scale, float* __restrict__ dqkv,
                       float* __restrict__ part, int H, int W, int C, int heads, int ws,
                       int shift) {
  using S_ = AttnBwdShape<L>;
  constexpr int QT = S_::QT, LDK = S_::LDK, TPK = S_::TPK, DN = S_::DN, NRG = S_::NRG;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;             // [L][LDK] k-hat rounded to the compute dtype
  float* Vs = Ks + L * LDK;     // [L][LDK] v
  float* dKs = Vs + L * LDK;    // [L][LDK] sum over queries of ds^T q-hat
  float* dVs = dKs + L * LDK;   // [L][LDK] sum over queries of p^T do
  float* Qs = dVs + L * LDK;    // [QT][HD] q-hat rounded
  float* Qf = Qs + QT * AB_HD;  // [QT][HD] q-hat (f32)
  float* Os = Qf + QT * AB_HD;  // [QT][HD] do
  float* S = Os + QT * AB_HD;   // [QT][L] scores -> p -> ds (rounded)
  float* Dv = S + QT * L;       // [QT] rowsum(dp * p) = do . o
  float* red = Dv + QT;         // [AB_WARPS]

  const int nWc = W / ws, nW = (H / ws) * nWc;
  const int h = blockIdx.x, widx = blockIdx.y;
  const int b = widx / nW, w = widx % nW;
  const int wr = w / nWc, wc = w % nWc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t C3 = 3 * (size_t)C;
  const float lam = scale[h];
  const T* bias_h = rel_bias + (size_t)h * L * L;
  const T* mask_w = mask ? mask + (size_t)w * L * L : nullptr;
  float* drb = part + (size_t)widx * ((size_t)heads * L * L + heads) + (size_t)h * L * L;

  auto token = [&](int l) -> size_t {
    const int i = l / ws, j = l % ws;
    const int r = (wr * ws + i + shift) % H;
    const int c = (wc * ws + j + shift) % W;
    return ((size_t)b * H + r) * W + c;
  };

  for (int l = warp; l < L; l += AB_WARPS) {
    const size_t base = token(l) * C3 + (size_t)h * AB_HD + lane;
    const float k = to_f(qkv[base + C]);
    const float rk = rsqrtf(warp_sum(k * k) + 1e-24f);
    Ks[l * LDK + lane] = round_to<T>(k * rk);
    Vs[l * LDK + lane] = to_f(qkv[base + 2 * (size_t)C]);
    dKs[l * LDK + lane] = 0.0f;
    dVs[l * LDK + lane] = 0.0f;
  }
  float dlam = 0.0f;  // this lane's share of sum (ds k-hat) . q-hat

  const int jcol = tid % L, rg = tid / L;  // score passes: one key column per thread
  const int d0 = (tid / L) * DN;           // dk/dv sums: key jcol, channels d0..d0+DN

  for (int q0 = 0; q0 < L; q0 += QT) {
    __syncthreads();
    for (int i = warp; i < QT; i += AB_WARPS) {
      const size_t tq = token(q0 + i);
      const float q = to_f(qkv[tq * C3 + (size_t)h * AB_HD + lane]);
      const float rq = rsqrtf(warp_sum(q * q) + 1e-24f);
      Qf[i * AB_HD + lane] = q * rq;
      Qs[i * AB_HD + lane] = round_to<T>(q * rq);
      Os[i * AB_HD + lane] = to_f(dout[tq * C + (size_t)h * AB_HD + lane]);
    }
    __syncthreads();

    // scores, as the forward kernel computes them
    {
      float kr[AB_HD];
#pragma unroll
      for (int d = 0; d < AB_HD; ++d) kr[d] = Ks[jcol * LDK + d];
      for (int i = rg; i < QT; i += NRG) {
        const float4* qrow = reinterpret_cast<const float4*>(Qs + i * AB_HD);
        float dot = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < AB_HD / 4; ++d4) {
          const float4 qv = qrow[d4];
          dot = fmaf(qv.x, kr[4 * d4 + 0], dot);
          dot = fmaf(qv.y, kr[4 * d4 + 1], dot);
          dot = fmaf(qv.z, kr[4 * d4 + 2], dot);
          dot = fmaf(qv.w, kr[4 * d4 + 3], dot);
        }
        const size_t idx = (size_t)(q0 + i) * L + jcol;
        float s = dot * lam + to_f(bias_h[idx]);
        if (mask_w) s += to_f(mask_w[idx]);
        S[i * L + jcol] = s;
      }
    }
    __syncthreads();

    // softmax (row max), one warp per row; p rounded to the compute dtype
    for (int i = warp; i < QT; i += AB_WARPS) {
      float* row = S + i * L;
      float m = -INFINITY;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float sum = 0.0f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < L; j += 32) row[j] = round_to<T>(row[j] / sum);
    }
    __syncthreads();

    // D_i = do_i . o_i with o_i = sum_j p_ij v_j; warp per row, lane = channel
    for (int i = warp; i < QT; i += AB_WARPS) {
      float o = 0.0f;
      for (int j = 0; j < L; ++j) o = fmaf(S[i * L + j], Vs[j * LDK + lane], o);
      const float dsum = warp_sum(o * Os[i * AB_HD + lane]);
      if (lane == 0) Dv[i] = dsum;
    }
    // dv_j += sum_i p_ij do_i
    {
      float acc[DN];
#pragma unroll
      for (int d = 0; d < DN; ++d) acc[d] = 0.0f;
      for (int i = 0; i < QT; ++i) {
        const float p = S[i * L + jcol];
#pragma unroll
        for (int d = 0; d < DN; ++d) acc[d] = fmaf(p, Os[i * AB_HD + d0 + d], acc[d]);
      }
#pragma unroll
      for (int d = 0; d < DN; ++d) dVs[jcol * LDK + d0 + d] += acc[d];
    }
    __syncthreads();

    // ds_ij = p_ij (do_i . v_j - D_i): f32 into the rel_bias partial, rounded
    // to the compute dtype for the dq/dk products
    {
      float vr[AB_HD];
#pragma unroll
      for (int d = 0; d < AB_HD; ++d) vr[d] = Vs[jcol * LDK + d];
      for (int i = rg; i < QT; i += NRG) {
        const float4* orow = reinterpret_cast<const float4*>(Os + i * AB_HD);
        float dpv = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < AB_HD / 4; ++d4) {
          const float4 ov = orow[d4];
          dpv = fmaf(ov.x, vr[4 * d4 + 0], dpv);
          dpv = fmaf(ov.y, vr[4 * d4 + 1], dpv);
          dpv = fmaf(ov.z, vr[4 * d4 + 2], dpv);
          dpv = fmaf(ov.w, vr[4 * d4 + 3], dpv);
        }
        const float ds = S[i * L + jcol] * (dpv - Dv[i]);
        drb[(size_t)(q0 + i) * L + jcol] = ds;
        S[i * L + jcol] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dq: qhb = ds k-hat (warp per row); normalisation backward with eps 1e-24
    for (int i = warp; i < QT; i += AB_WARPS) {
      float qhb = 0.0f;
      for (int j = 0; j < L; ++j) qhb = fmaf(S[i * L + j], Ks[j * LDK + lane], qhb);
      dlam = fmaf(qhb, Qf[i * AB_HD + lane], dlam);
      const size_t tq = token(q0 + i) * C3 + (size_t)h * AB_HD + lane;
      const float q = to_f(qkv[tq]);
      const float rq = rsqrtf(warp_sum(q * q) + 1e-24f);
      const float qnb = lam * qhb;
      const float dot = warp_sum(qnb * q);
      dqkv[tq] = rq * (qnb - q * rq * rq * dot);
    }
    // dk-hat_j += sum_i ds_ij q-hat_i
    {
      float acc[DN];
#pragma unroll
      for (int d = 0; d < DN; ++d) acc[d] = 0.0f;
      for (int i = 0; i < QT; ++i) {
        const float dsv = S[i * L + jcol];
#pragma unroll
        for (int d = 0; d < DN; ++d) acc[d] = fmaf(dsv, Qs[i * AB_HD + d0 + d], acc[d]);
      }
#pragma unroll
      for (int d = 0; d < DN; ++d) dKs[jcol * LDK + d0 + d] += acc[d];
    }
  }
  __syncthreads();

  for (int l = warp; l < L; l += AB_WARPS) {
    const size_t base = token(l) * C3 + (size_t)h * AB_HD + lane;
    const float k = to_f(qkv[base + C]);
    const float rk = rsqrtf(warp_sum(k * k) + 1e-24f);
    const float knb = lam * dKs[l * LDK + lane];
    const float dot = warp_sum(knb * k);
    dqkv[base + C] = rk * (knb - k * rk * rk * dot);
    dqkv[base + 2 * (size_t)C] = dVs[l * LDK + lane];
  }
  const float wl = warp_sum(dlam);
  if (lane == 0) red[warp] = wl;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.0f;
    for (int i = 0; i < AB_WARPS; ++i) sum += red[i];
    part[(size_t)widx * ((size_t)heads * L * L + heads) + (size_t)heads * L * L + h] = sum;
  }
}

// dynamic shared memory of `kernel` raised to at least `smem` on the current
// device, asking the driver only when a launch needs more than the last one
// (`cache`: a function-local static of each launcher's instantiation)
template <class Kernel>
int raise_smem_limit(int (&cache)[WC_MAX_DEVICES], Kernel kernel, size_t smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= WC_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cache[dev] >= (int)smem) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cache[dev] = (int)smem;
  return 0;
}

// f32 (the check path): SIMT, one block per (head, window of an image), the
// per-window partials summed by sum_splits
template <int L>
int launch_attn_bwd_f32(const void* qkv, const void* dout, const void* rel_bias, const void* mask,
                        const void* scale, void* dqkv, void* part, void* out, int B, int H, int W,
                        int C, int heads, int ws, int shift, cudaStream_t st) {
  const size_t smem = AttnBwdShape<L>::smem_floats * sizeof(float);
  static int limit[WC_MAX_DEVICES];
  const int e = raise_smem_limit(limit, window_attn_bwd_kernel<float, L>, smem);
  if (e != 0) return e;
  const int nWin = B * (H / ws) * (W / ws);
  dim3 grid(heads, nWin);
  window_attn_bwd_kernel<float, L><<<grid, AB_THREADS, smem, st>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout),
      static_cast<const float*>(rel_bias), static_cast<const float*>(mask),
      static_cast<const float*>(scale), static_cast<float*>(dqkv), static_cast<float*>(part), H,
      W, C, heads, ws, shift);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return (int)le;
  return launch_sum_splits(static_cast<const float*>(part), static_cast<float*>(out), nWin,
                           (size_t)heads * L * L + heads, st);
}

// ---------------------------------------------------------------------------
// swin_window_attn_bwd, bf16: tensor cores (mma.sync m16n8k16 over the
// pieces of window_attn_core.cuh). One block per (head, window position,
// group of images); it walks its images one by one and owns, for each, the
// whole window: all L query rows and all L keys, so dk and dv are summed
// over the window's queries inside the block and never leave it as partials.
// NWARP warps (8 at L=256, 4 at L=64, 1 at L=16), 16 query rows each; the
// window's query rows are taken in HALVES passes of 16 NWARP rows. Per pass:
//  1. query phase (warp per 16 query rows): s = round(q^) . round(k^)^T,
//     scaled, plus the bias (and shift-mask) rows, which the warp stages by
//     cp.async into its own rows of the p and round(ds) tiles (they hold
//     them until the softmax is done); softmax, p rounded to bf16 and stored
//     to shared memory: at L <= 64 the forward core's full row in registers,
//     at L = 256 three sweeps over 128-key blocks (max, sum, p), which leave
//     the registers the rest of the kernel needs. p is read back from shared
//     memory as the A operand: o = p . v in f32 and D = do . o (the plain
//     version's rowsum(dp * p), rounded where it rounds it); then per 16
//     keys dp = do . v^T, ds = p (dp - D) in f32 (added to the block's d
//     rel_bias slab), round(ds) stored to shared memory and, as the A
//     operand (C layout = A layout), dq^ += round(ds) . k^. dq^ is whole in
//     the warp's registers: the q-normalisation backward runs there (quad
//     sums) and dq is written.
//  2. key phase (warp per KW = L / NWARP keys): over the pass's query tiles,
//     p^T and round(ds)^T by ldmatrix.trans of the stored tiles are the A
//     operands of dv += p^T . do and dk^ += round(ds)^T . q^; dv and dk^
//     stay in registers over both passes, then the k-normalisation backward
//     and dk, dv written.
// Two barriers per pass and two per image, none inside either phase's loop.
// Replaces the attention half of cs_vit_tpu/ops/fused_block.py:_bwd_kernel
// (:394). What bounds it on the H100: the latency of its dependent products
// and barriers at 8 warps an SM (one 199 KB block), not the tensor cores'
// rate (81 GFLOP a Swin-B b8 step: 0.08 ms at the bf16 peak) nor bytes.
// d rel_bias: the block's [L, L] f32 slab in the caller's scratch, slot
// (window position, image group) of [nW * groups][heads * L * L + heads];
// written by the block's first image and added to, element by element by the
// same thread, by the next ones; summed over the slots by sum_splits. The
// scratch depends on the number of groups, which the caller sizes to the
// resident blocks, not on B. d logit_scale: each block's sum of
// (ds k^) . q^ (q^ in f32) over its images, in a fixed order. No atomics.
// ---------------------------------------------------------------------------

template <int L>
struct AttnBwdTc {
  static constexpr int NWARP = L == 256 ? 8 : (L == 64 ? 4 : 1);
  static constexpr int THREADS = 32 * NWARP;
  static constexpr int KW = L / NWARP;   // keys per warp in the key phase
  static constexpr int KT = KW / 16;     // 16-key tiles per warp
  static constexpr int HR = 16 * NWARP;  // query rows per pass
  static constexpr int HALVES = L / HR;  // passes per image
  static constexpr int PLD = L + 8;      // p / ds rows: an ldmatrix phase's 8 rows in distinct banks
  static constexpr int WS = L == 256 ? 16 : (L == 64 ? 8 : 4);
  static constexpr int CHUNKS = L * 4 / THREADS;  // 16-byte chunks of a [L][32] tile per thread
  static constexpr size_t smem_bytes =
      4 * (size_t)L * WC_HD * sizeof(bf16)   // k^, v, q^, do
      + 2 * (size_t)HR * PLD * sizeof(bf16)  // p and round(ds) of a pass
      + NWARP * sizeof(float)                // the warps' d logit_scale sums
      + L * sizeof(int);                     // the window's token indices
};

// The softmax of a warp's 16 rows in three sweeps over 128-key blocks (row
// max, row sum, then p rounded to bf16 and stored to `prow`: rows g and
// g + 8 of 16, row stride ld), with 64 score registers a thread where the
// full row takes 128. Each sweep recomputes the same scores by the same
// instructions as window_scores / window_softmax, and the sums run over the
// keys in the same order, so p is bit-identical to the full-row variant's.
template <int L, class Bias>
__device__ __forceinline__ void softmax_to_smem(const uint32_t (&qa)[2][4], const bf16* Ks,
                                                float lam, const Bias& bias, bf16* prow,
                                                int ld) {
  constexpr int HK = 128;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float m0 = -INFINITY, m1 = -INFINITY, sum0 = 0.0f, sum1 = 0.0f;
  float n0 = 0.0f, n1 = 0.0f, inv0 = 0.0f, inv1 = 0.0f;
#pragma unroll 1
  for (int sweep = 0; sweep < 3; ++sweep) {
#pragma unroll 1
    for (int hk = 0; hk < L / HK; ++hk) {
      float sc[HK / 8][4];
      window_scores<HK>(sc, qa, Ks + hk * HK * WC_HD);
#pragma unroll
      for (int j = 0; j < HK / 8; ++j) {
        const int c = hk * HK + j * 8 + 2 * t;
        const float2 r0 = bias(g, c), r1 = bias(g + 8, c);
        const float s0 = sc[j][0] * lam + r0.x, s1 = sc[j][1] * lam + r0.y;
        const float s2 = sc[j][2] * lam + r1.x, s3 = sc[j][3] * lam + r1.y;
        if (sweep == 0) {
          m0 = fmaxf(m0, fmaxf(s0, s1));
          m1 = fmaxf(m1, fmaxf(s2, s3));
          continue;
        }
        const float e0 = ex2(fmaf(s0, WC_LOG2E, n0)), e1 = ex2(fmaf(s1, WC_LOG2E, n0));
        const float e2 = ex2(fmaf(s2, WC_LOG2E, n1)), e3 = ex2(fmaf(s3, WC_LOG2E, n1));
        if (sweep == 1) {
          sum0 += e0 + e1;
          sum1 += e2 + e3;
        } else {
          *reinterpret_cast<uint32_t*>(prow + g * ld + c) = pack_bf16(e0 * inv0, e1 * inv0);
          *reinterpret_cast<uint32_t*>(prow + (g + 8) * ld + c) = pack_bf16(e2 * inv1, e3 * inv1);
        }
      }
    }
    if (sweep == 0) {
      n0 = -quad_max(m0) * WC_LOG2E;
      n1 = -quad_max(m1) * WC_LOG2E;
    } else if (sweep == 1) {
      inv0 = 1.0f / quad_sum(sum0);
      inv1 = 1.0f / quad_sum(sum1);
    }
  }
}

// token (row * W + column) of window token l of the shifted window (wr, wc):
// ((wr WS + l / WS + shift) mod H, (wc WS + l % WS + shift) mod W)
template <int WS>
__device__ __forceinline__ int window_token(int l, int wr, int wc, int shift, int H, int W) {
  return ((wr * WS + l / WS + shift) % H) * W + (wc * WS + l % WS + shift) % W;
}

template <int L, bool MASKED>
__global__ void __launch_bounds__(AttnBwdTc<L>::THREADS, 1)
window_attn_bwd_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                          const bf16* __restrict__ rel_bias, const bf16* __restrict__ mask,
                          const float* __restrict__ scale, float* __restrict__ dqkv,
                          float* __restrict__ part, int B, int H, int W, int C, int heads,
                          int shift, int per_group) {
  using S_ = AttnBwdTc<L>;
  constexpr int NWARP = S_::NWARP, THREADS = S_::THREADS, KW = S_::KW, KT = S_::KT;
  constexpr int HR = S_::HR, HALVES = S_::HALVES, PLD = S_::PLD, WS = S_::WS;
  constexpr int CHUNKS = S_::CHUNKS;
  extern __shared__ __align__(16) unsigned char ab_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(ab_smem);  // [L][32] swizzled: k, then k^
  bf16* Vs = Ks + L * WC_HD;                    // v
  bf16* Qs = Vs + L * WC_HD;                    // q, then q^
  bf16* Os = Qs + L * WC_HD;                    // do
  bf16* P = Os + L * WC_HD;                     // [HR][PLD] p of the pass
  bf16* DS = P + HR * PLD;                      // [HR][PLD] round(ds) of the pass
  float* red = reinterpret_cast<float*>(DS + HR * PLD);  // [NWARP]
  int* Tok = reinterpret_cast<int*>(red + NWARP);        // [L]

  const int nWc = W / WS;
  const int h = blockIdx.x, w = blockIdx.y;
  const int b0 = blockIdx.z * per_group, b1 = min(B, b0 + per_group);
  const int wr = w / nWc, wc = w % nWc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float lam = scale[h];
  float* slot = part + ((size_t)w * gridDim.z + blockIdx.z) * ((size_t)heads * L * L + heads);
  float* drb = slot + (size_t)h * L * L;
  const size_t C3 = 3 * (size_t)C;
  const size_t img_qkv = (size_t)H * W * C3, img_do = (size_t)H * W * C;

  // the window's token indices (row * W + column within the image), once:
  // index arithmetic held in registers would not fit beside the L=256 scores
  for (int l = tid; l < L; l += THREADS) Tok[l] = window_token<WS>(l, wr, wc, shift, H, W);
  __syncthreads();
  float dlam = 0.0f;  // this thread's share of sum (ds k^) . q^
  const int kb = warp * KW;  // the key phase's keys of this warp

  for (int b = b0; b < b1; ++b) {
    {
      int off3[CHUNKS], off1[CHUNKS];  // this thread's chunks of the q/k/v and do tiles
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int c = tid + i * THREADS, tok = Tok[c >> 2];
        off3[i] = tok * 3 * C + h * WC_HD + (c & 3) * 8;
        off1[i] = tok * C + h * WC_HD + (c & 3) * 8;
      }
      const bf16* qkv_b = qkv + b * img_qkv;
      gather_rows<THREADS>(Qs, qkv_b, off3);
      gather_rows<THREADS>(Ks, qkv_b + C, off3);
      gather_rows<THREADS>(Vs, qkv_b + 2 * C, off3);
      gather_rows<THREADS>(Os, dout + b * img_do, off1);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // k^ and q^: x * rsqrt(sum x^2 + 1e-24), rounded to bf16, in place (L * 4
    // is a multiple of THREADS, so every lane of a quad takes each step)
    for (int c = tid; c < L * 4; c += THREADS) {
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        bf16* chunk = (which ? Qs : Ks) + swz(c >> 2, c & 3);
        float f[8];
        const float r = rsqrtf(chunk_row_sumsq(chunk, f) + 1e-24f);
        uint4 packed;
        packed.x = pack_bf16(f[0] * r, f[1] * r);
        packed.y = pack_bf16(f[2] * r, f[3] * r);
        packed.z = pack_bf16(f[4] * r, f[5] * r);
        packed.w = pack_bf16(f[6] * r, f[7] * r);
        *reinterpret_cast<uint4*>(chunk) = packed;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int half = 0; half < HALVES; ++half) {
      // 1. query phase: this warp's rows q0 .. q0 + 15 (r0 .. r0 + 15 of the pass)
      {
        const int r0 = warp * 16, q0 = half * HR + r0;
        // the rows' bias (and mask) staged into this warp's rows of the
        // round(ds) (and p) tiles, which hold them until the softmax is done
        bf16* my_ds = DS + r0 * PLD;
        bf16* my_p = P + r0 * PLD;
        stage_rows(my_ds, PLD, rel_bias + ((size_t)h * L + q0) * L, L, 16, L, lane, 32);
        if (MASKED) stage_rows(my_p, PLD, mask + ((size_t)w * L + q0) * L, L, 16, L, lane, 32);
        cp_async_commit();
        // q of this lane's rows, for the q-normalisation backward at the end:
        // into L1 now, read then (no registers held across the softmax)
        const size_t qrow0 = b * img_qkv + (size_t)Tok[q0 + g] * C3
                             + (size_t)h * WC_HD + 2 * t;
        const size_t qrow1 = b * img_qkv + (size_t)Tok[q0 + g + 8] * C3
                             + (size_t)h * WC_HD + 2 * t;
        asm volatile("prefetch.global.L1 [%0];" ::"l"(qkv + qrow0));
        asm volatile("prefetch.global.L1 [%0];" ::"l"(qkv + qrow1));
        uint32_t qa[2][4];
        load_q_frags(qa, Qs + q0 * WC_HD);
        // p to shared memory (into the mask rows' place, each element after
        // the thread that reads it has read it); from here on p is read back
        // from there as the A fragments of the p . v and ds products
        const SmemBias<bf16, MASKED> bias_at{my_ds, my_p, PLD};
        if constexpr (L == 256) {
          cp_async_wait<0>();
          __syncwarp();
          softmax_to_smem<L>(qa, Ks, lam, bias_at, my_p, PLD);
        } else {
          uint32_t pa[L / 16][4];
          float s[L / 8][4];
          window_scores<L>(s, qa, Ks);
          cp_async_wait<0>();
          __syncwarp();
          window_softmax<L, false>(s, lam, lam, nullptr, bias_at, pa);
          bf16* p0 = my_p + g * PLD + 2 * t;
#pragma unroll
          for (int kk = 0; kk < L / 16; ++kk) {
            *reinterpret_cast<uint32_t*>(p0 + 16 * kk) = pa[kk][0];
            *reinterpret_cast<uint32_t*>(p0 + 8 * PLD + 16 * kk) = pa[kk][1];
            *reinterpret_cast<uint32_t*>(p0 + 16 * kk + 8) = pa[kk][2];
            *reinterpret_cast<uint32_t*>(p0 + 8 * PLD + 16 * kk + 8) = pa[kk][3];
          }
        }
        __syncwarp();  // p, and every lane is done with the staged rows
        float o[4][4];
        const bf16* pfr = my_p + ((lane & 7) + ((lane >> 3) & 1) * 8) * PLD + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk) {
          uint32_t pk[4];
          ldsm_x4(pk, pfr + 16 * kk);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t vb[4];
            ldsm_x4_trans(vb, Vs + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                       np * 2 + (lane >> 4)));
            mma_bf16(o[2 * np], pk, vb[0], vb[1]);
            mma_bf16(o[2 * np + 1], pk, vb[2], vb[3]);
          }
        }
        float D0 = 0.0f, D1 = 0.0f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float2 x0 = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(Os + swz(q0 + g, n) + 2 * t));
          const float2 x1 = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(Os + swz(q0 + g + 8, n) + 2 * t));
          D0 += o[n][0] * x0.x + o[n][1] * x0.y;
          D1 += o[n][2] * x1.x + o[n][3] * x1.y;
        }
        D0 = quad_sum(D0);
        D1 = quad_sum(D1);
        uint32_t da[2][4];  // do of the rows: A fragments [q x hd]
        load_q_frags(da, Os + q0 * WC_HD);
        float dq[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
        float* drow0 = drb + (size_t)(q0 + g) * L + 2 * t;
        float* drow1 = drow0 + 8 * L;
#pragma unroll 2
        for (int kk = 0; kk < L / 16; ++kk) {
          uint32_t pk[4];  // p of the 16 keys: A fragments
          ldsm_x4(pk, pfr + 16 * kk);
          float ds[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t vb[4];  // v rows 16 kk + 8 j as the B operand [hd x key]
            ldsm_x4(vb, Vs + swz(kk * 16 + j * 8 + (lane & 7), lane >> 3));
            float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(dp, da[0], vb[0], vb[1]);
            mma_bf16(dp, da[1], vb[2], vb[3]);
            const float2 p0 = unpack_bf16(pk[2 * j]), p1 = unpack_bf16(pk[2 * j + 1]);
            ds[j][0] = p0.x * (dp[0] - D0);
            ds[j][1] = p0.y * (dp[1] - D0);
            ds[j][2] = p1.x * (dp[2] - D1);
            ds[j][3] = p1.y * (dp[3] - D1);
            // d rel_bias[q][key], q = q0 + g (+8), key = 16 kk + 8 j + 2 t (+1)
            float2* d0 = reinterpret_cast<float2*>(drow0 + 16 * kk + 8 * j);
            float2* d1 = reinterpret_cast<float2*>(drow1 + 16 * kk + 8 * j);
            if (b == b0) {
              *d0 = make_float2(ds[j][0], ds[j][1]);
              *d1 = make_float2(ds[j][2], ds[j][3]);
            } else {
              const float2 e0 = *d0, e1 = *d1;
              *d0 = make_float2(e0.x + ds[j][0], e0.y + ds[j][1]);
              *d1 = make_float2(e1.x + ds[j][2], e1.y + ds[j][3]);
            }
          }
          uint32_t dsa[4];  // round(ds) [q x 16 keys]: A fragments
          dsa[0] = pack_bf16(ds[0][0], ds[0][1]);
          dsa[1] = pack_bf16(ds[0][2], ds[0][3]);
          dsa[2] = pack_bf16(ds[1][0], ds[1][1]);
          dsa[3] = pack_bf16(ds[1][2], ds[1][3]);
          bf16* s0 = my_ds + g * PLD + 2 * t + 16 * kk;
          *reinterpret_cast<uint32_t*>(s0) = dsa[0];
          *reinterpret_cast<uint32_t*>(s0 + 8 * PLD) = dsa[1];
          *reinterpret_cast<uint32_t*>(s0 + 8) = dsa[2];
          *reinterpret_cast<uint32_t*>(s0 + 8 * PLD + 8) = dsa[3];
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t kbf[4];  // k^ rows 16 kk .. as the B operand [key x hd]
            ldsm_x4_trans(kbf, Ks + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                        np * 2 + (lane >> 4)));
            mma_bf16(dq[2 * np], dsa, kbf[0], kbf[1]);
            mma_bf16(dq[2 * np + 1], dsa, kbf[2], kbf[3]);
          }
        }
        // q-normalisation backward (eps 1e-24): rows g and g + 8, this lane's
        // head dims 8 n + 2 t, + 1; row sums over the quad
        float ss0 = 0.0f, ss1 = 0.0f;
        float2 qv[2][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          qv[0][n] = unpack_bf16(*reinterpret_cast<const uint32_t*>(qkv + qrow0 + n * 8));
          qv[1][n] = unpack_bf16(*reinterpret_cast<const uint32_t*>(qkv + qrow1 + n * 8));
          ss0 += qv[0][n].x * qv[0][n].x + qv[0][n].y * qv[0][n].y;
          ss1 += qv[1][n].x * qv[1][n].x + qv[1][n].y * qv[1][n].y;
        }
        const float rq[2] = {rsqrtf(quad_sum(ss0) + 1e-24f), rsqrtf(quad_sum(ss1) + 1e-24f)};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float dot = 0.0f;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float a0 = dq[n][2 * hh], a1 = dq[n][2 * hh + 1];
            dlam = fmaf(a0, qv[hh][n].x * rq[hh], dlam);
            dlam = fmaf(a1, qv[hh][n].y * rq[hh], dlam);
            dot += lam * a0 * qv[hh][n].x + lam * a1 * qv[hh][n].y;
          }
          dot = quad_sum(dot);
          float* out = dqkv + (hh ? qrow1 : qrow0);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float n0 = lam * dq[n][2 * hh], n1 = lam * dq[n][2 * hh + 1];
            const float r = rq[hh];
            *reinterpret_cast<float2*>(out + n * 8) =
                make_float2(r * (n0 - qv[hh][n].x * r * r * dot),
                            r * (n1 - qv[hh][n].y * r * r * dot));
          }
        }
      }
      __syncthreads();  // the pass's p and round(ds)

      // 2. key phase: this warp's keys kb .. kb + KW - 1 against the pass's
      // rows. dv and dk^ of the earlier passes wait in this warp's own dk and
      // dv slots of dqkv (f32), so no accumulator is live across a query phase.
      {
        float dv[KT][4][4], dk[KT][4][4];
#pragma unroll
        for (int mt = 0; mt < KT; ++mt)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) dv[mt][n][i] = dk[mt][n][i] = 0.0f;
        size_t kbase[KT][2];  // dqkv offset of this lane's key rows g, g + 8 (head dims 2 t ..)
#pragma unroll
        for (int mt = 0; mt < KT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            kbase[mt][hh] = b * img_qkv + (size_t)Tok[kb + 16 * mt + g + 8 * hh] * C3
                            + (size_t)h * WC_HD + 2 * t;
        if (half > 0) {  // the earlier passes' sums into L1 while the products run
#pragma unroll
          for (int mt = 0; mt < KT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              asm volatile("prefetch.global.L1 [%0];" ::"l"(dqkv + kbase[mt][hh] + C));
              asm volatile("prefetch.global.L1 [%0];" ::"l"(dqkv + kbase[mt][hh] + 2 * C));
            }
        }
#pragma unroll 2
        for (int qt = 0; qt < NWARP; ++qt) {
          const int r0 = qt * 16, q0 = half * HR + r0;
          const int tr = q0 + (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix.trans row of [q][hd]
          uint32_t pt[KT][4], dst[KT][4];  // p^T and round(ds)^T [16 keys x 16 q]: A fragments
#pragma unroll
          for (int mt = 0; mt < KT; ++mt) {
            const int pr = r0 + (lane & 7) + ((lane >> 4) & 1) * 8;
            const int pk = kb + 16 * mt + ((lane >> 3) & 1) * 8;
            ldsm_x4_trans(pt[mt], P + pr * PLD + pk);
            ldsm_x4_trans(dst[mt], DS + pr * PLD + pk);
          }
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t ot[4], qtr[4];  // do and q^ rows as B operands [q x hd]
            ldsm_x4_trans(ot, Os + swz(tr, np * 2 + (lane >> 4)));
            ldsm_x4_trans(qtr, Qs + swz(tr, np * 2 + (lane >> 4)));
#pragma unroll
            for (int mt = 0; mt < KT; ++mt) {
              mma_bf16(dv[mt][2 * np], pt[mt], ot[0], ot[1]);
              mma_bf16(dv[mt][2 * np + 1], pt[mt], ot[2], ot[3]);
              mma_bf16(dk[mt][2 * np], dst[mt], qtr[0], qtr[1]);
              mma_bf16(dk[mt][2 * np + 1], dst[mt], qtr[2], qtr[3]);
            }
          }
        }
        if (half > 0) {
#pragma unroll
          for (int mt = 0; mt < KT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int n = 0; n < 4; ++n) {
                const float2 pk = *reinterpret_cast<const float2*>(dqkv + kbase[mt][hh] + C + n * 8);
                const float2 pv = *reinterpret_cast<const float2*>(dqkv + kbase[mt][hh] + 2 * C + n * 8);
                dk[mt][n][2 * hh] += pk.x;
                dk[mt][n][2 * hh + 1] += pk.y;
                dv[mt][n][2 * hh] += pv.x;
                dv[mt][n][2 * hh + 1] += pv.y;
              }
        }
#pragma unroll
        for (int mt = 0; mt < KT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float* base = dqkv + kbase[mt][hh];
            if (half + 1 < HALVES) {  // park the sums for the next pass
#pragma unroll
              for (int n = 0; n < 4; ++n) {
                *reinterpret_cast<float2*>(base + C + n * 8) =
                    make_float2(dk[mt][n][2 * hh], dk[mt][n][2 * hh + 1]);
                *reinterpret_cast<float2*>(base + 2 * C + n * 8) =
                    make_float2(dv[mt][n][2 * hh], dv[mt][n][2 * hh + 1]);
              }
              continue;
            }
            // dk (k-normalisation backward, eps 1e-24) and dv of this key row
            float2 kv[4];
            float ss = 0.0f, dot = 0.0f;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              kv[n] = unpack_bf16(*reinterpret_cast<const uint32_t*>(qkv + kbase[mt][hh] + C + n * 8));
              ss += kv[n].x * kv[n].x + kv[n].y * kv[n].y;
              dot += lam * (dk[mt][n][2 * hh] * kv[n].x + dk[mt][n][2 * hh + 1] * kv[n].y);
            }
            const float rk = rsqrtf(quad_sum(ss) + 1e-24f);
            dot = quad_sum(dot);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const float k0 = lam * dk[mt][n][2 * hh], k1 = lam * dk[mt][n][2 * hh + 1];
              *reinterpret_cast<float2*>(base + C + n * 8) =
                  make_float2(rk * (k0 - kv[n].x * rk * rk * dot),
                              rk * (k1 - kv[n].y * rk * rk * dot));
              *reinterpret_cast<float2*>(base + 2 * C + n * 8) =
                  make_float2(dv[mt][n][2 * hh], dv[mt][n][2 * hh + 1]);
            }
          }
      }
      __syncthreads();  // every warp is done with the pass's tiles
    }
  }

  // d logit_scale: the block's sum, warps in order
  const float wl = warp_sum(dlam);
  if (lane == 0) red[warp] = wl;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.0f;
    for (int i = 0; i < NWARP; ++i) sum += red[i];
    slot[(size_t)heads * L * L + h] = sum;
  }
}

template <int L, bool MASKED>
int attn_bwd_tc_resident(int (&blocks)) {
  static int resident[WC_MAX_DEVICES];
  blocks = device_blocks(resident, window_attn_bwd_tc_kernel<L, MASKED>, AttnBwdTc<L>::THREADS,
                         AttnBwdTc<L>::smem_bytes);
  return blocks < 0 ? -blocks : 0;
}

template <int L, bool MASKED>
int launch_attn_bwd_tc(const void* qkv, const void* dout, const void* rel_bias, const void* mask,
                       const void* scale, void* dqkv, void* part, void* out, int B, int H, int W,
                       int C, int heads, int ws, int shift, int per_group, cudaStream_t st) {
  if ((long long)H * W * 3 * C > INT_MAX || per_group < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int e = attn_bwd_tc_resident<L, MASKED>(blocks);
  if (e != 0) return e;
  const int nW = (H / ws) * (W / ws), groups = (B + per_group - 1) / per_group;
  dim3 grid(heads, nW, groups);
  window_attn_bwd_tc_kernel<L, MASKED><<<grid, AttnBwdTc<L>::THREADS, AttnBwdTc<L>::smem_bytes,
                                         st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(rel_bias), static_cast<const bf16*>(mask),
      static_cast<const float*>(scale), static_cast<float*>(dqkv), static_cast<float*>(part), B,
      H, W, C, heads, shift, per_group);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return (int)le;
  return launch_sum_splits(static_cast<const float*>(part), static_cast<float*>(out), nW * groups,
                           (size_t)heads * L * L + heads, st);
}

#define ATTN_BWD_ARGS qkv, dout, rel_bias, mask, scale, dqkv, part, out, B, H, W, C, heads, ws, shift

template <int L>
int launch_attn_bwd_bf16(const void* qkv, const void* dout, const void* rel_bias,
                         const void* mask, const void* scale, void* dqkv, void* part, void* out,
                         int B, int H, int W, int C, int heads, int ws, int shift, int per_group,
                         cudaStream_t st) {
  if (mask) return launch_attn_bwd_tc<L, true>(ATTN_BWD_ARGS, per_group, st);
  return launch_attn_bwd_tc<L, false>(ATTN_BWD_ARGS, per_group, st);
}

}  // namespace

// dt_code: 0 = float32, 1 = bfloat16. epi: 0 none, 1 GELU' (aux = m1 in the
// compute dtype), 2 add (aux in aux_f32 ? f32 : compute dtype). out_f32 picks
// f32 or compute-dtype output. bm x bn: the bf16 kernel's output tile,
// 128 x 128, 128 x 64 or 64 x 64, and stages its ring of 64-deep stages, 1 to
// 8 (fused_block.py:_gemm_plan); the f32 body ignores them.
extern "C" int gemm_dgrad(const void* dY, const void* W, const void* aux, void* out, int M,
                          int N, int K, int dt_code, int epi, int aux_f32, int out_f32, int bm,
                          int bn, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dy = static_cast<const float*>(dY);
  if (epi < EPI_NONE || epi > EPI_ADD) return (int)cudaErrorInvalidValue;
  if (dt_code == 1) {
    if (stages < 1 || stages > GC_MAX_STAGES) return (int)cudaErrorInvalidValue;
    const bf16* w = static_cast<const bf16*>(W);
#define DGRAD(BM, BN) \
  launch_dgrad_bf16<BM, BN>(dy, w, aux, out, M, N, K, stages, epi, aux_f32, out_f32, st)
    switch (bm * 1000 + bn) {
      case 128128: return DGRAD(128, 128);
      case 128064: return DGRAD(128, 64);
      case 64064: return DGRAD(64, 64);
    }
#undef DGRAD
    return (int)cudaErrorInvalidValue;
  }
  // f32: the output is f32 and so is aux
  dim3 grid((K + FB - 1) / FB, (M + FB - 1) / FB, 1);
  const float* w = static_cast<const float*>(W);
  const float* ax = static_cast<const float*>(aux);
  float* o = static_cast<float*>(out);
#define DGRAD32(EPI)                                                                      \
  gemm_f32_strided_kernel<EPI, float><<<grid, 256, 0, st>>>(dy, w, ax, o, M, K, N, N, 1, 1, \
                                                            N, N, 0)
  if (epi == EPI_GELU) DGRAD32(EPI_GELU);
  else if (epi == EPI_ADD) DGRAD32(EPI_ADD);
  else DGRAD32(EPI_NONE);
#undef DGRAD32
  return (int)cudaGetLastError();
}

// out = [dW (K*N) | db (N)] f32; part holds `splits` such slabs (part may be
// out when splits == 1). X [M,K] in the compute dtype, dY [M,N] f32.
extern "C" int gemm_wgrad(const void* X, const void* dY, void* part, void* out, int M, int N,
                          int K, int splits, int rows_per_split, int dt_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dy = static_cast<const float*>(dY);
  float* p = static_cast<float*>(part);
  if (dt_code == 1) {
    const int e = launch_wgrad_bf16(static_cast<const bf16*>(X), dy, p, M, N, K, splits,
                                    rows_per_split, st);
    if (e != 0) return e;
  } else {
    dim3 grid((N + FB - 1) / FB, (K + FB - 1) / FB, splits);
    gemm_f32_strided_kernel<EPI_NONE, float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(X), dy, nullptr, p, K, N, M, 1, K, N, 1, rows_per_split, 1);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_sum_splits(p, static_cast<float*>(out), splits, (size_t)K * N + N, st);
}

namespace {

// (TPR, VPT, groups, blocks) as fused_block.py:_ln_plan gives them, blocks a
// multiple of LN_CLUSTER; part [blocks / LN_CLUSTER][2C] f32
// scratch; counters [LN_CLUSTER], zero, left zero; out [2][C] = (dgamma,
// dbeta). A plan the kernel was not built for is refused.
template <typename GT, typename DT>
int launch_ln_residual_bwd(const float* z, const GT* g, const DT* gamma, const float* dp,
                           int dp_col, int rows_per_image, float* dz, float* part,
                           unsigned* counters, float* out, int M, int C, float eps, int tpr,
                           int vpt, int groups, int blocks, cudaStream_t st) {
  if (C % 8 != 0 || tpr * groups > LN_THREADS || (tpr * groups) % 32 != 0 ||
      (tpr > 32 && groups != 1) || blocks % LN_CLUSTER != 0 || 8 * tpr * vpt < C ||
      8 * tpr * (vpt - 1) >= C)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)groups * 2 * C + 4 * LN_THREADS) * sizeof(float);
#define LNB(TPR, VPT, CX)                                                                   \
  do {                                                                                      \
    static int limit[WC_MAX_DEVICES];                                                       \
    const int e = raise_smem_limit(limit, ln_residual_bwd_kernel<GT, DT, TPR, VPT, CX>, smem); \
    if (e != 0) return e;                                                                   \
    ln_residual_bwd_kernel<GT, DT, TPR, VPT, CX><<<blocks, tpr * groups, smem, st>>>(       \
        z, g, gamma, dp, dp_col, rows_per_image, dz, part, counters, out, M, C, eps);      \
  } while (0)
  if (tpr == 16 && vpt == 1) {
    if (C == 128) LNB(16, 1, 128); else LNB(16, 1, 0);
  } else if (tpr == 32 && vpt == 1) {
    if (C == 256) LNB(32, 1, 256); else LNB(32, 1, 0);
  } else if (tpr == 32 && vpt == 2) {
    if (C == 512) LNB(32, 2, 512); else LNB(32, 2, 0);
  } else if (tpr == 128 && vpt == 1) {
    if (C == 1024) LNB(128, 1, 1024); else LNB(128, 1, 0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LNB
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ln_residual_bwd(const void* z, const void* g, const void* gamma, const void* dp,
                               int dp_col, int rows_per_image, void* dz, void* part,
                               void* counters, void* out, int M, int C, float eps, int tpr,
                               int vpt, int groups, int blocks, int dt_code, int g_f32,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  const float* d = static_cast<const float*>(dp);
  float* dzf = static_cast<float*>(dz);
  float* pf = static_cast<float*>(part);
  unsigned* cnt = static_cast<unsigned*>(counters);
  float* of = static_cast<float*>(out);
  if (dt_code == 1) {
    const bf16* gm = static_cast<const bf16*>(gamma);
    if (g_f32)
      return launch_ln_residual_bwd(zf, static_cast<const float*>(g), gm, d, dp_col,
                                    rows_per_image, dzf, pf, cnt, of, M, C, eps, tpr, vpt,
                                    groups, blocks, st);
    return launch_ln_residual_bwd(zf, static_cast<const bf16*>(g), gm, d, dp_col,
                                  rows_per_image, dzf, pf, cnt, of, M, C, eps, tpr, vpt, groups,
                                  blocks, st);
  }
  return launch_ln_residual_bwd(zf, static_cast<const float*>(g),
                                static_cast<const float*>(gamma), d, dp_col, rows_per_image,
                                dzf, pf, cnt, of, M, C, eps, tpr, vpt, groups, blocks, st);
}

// dqkv [B,H,W,3C] f32 (every element written); out [heads*L*L + heads] =
// (d rel_bias, d logit_scale) f32. part: scratch of [B*nW][heads*L*L + heads]
// f32 (f32) or [nW*groups][heads*L*L + heads] (bf16, groups = ceil(B /
// per_group)); see swin_window_attn_bwd_blocks.
extern "C" int swin_window_attn_bwd(const void* qkv, const void* dout, const void* rel_bias,
                                    const void* mask, const void* scale, void* dqkv, void* part,
                                    void* out, int B, int H, int W, int C, int heads, int ws,
                                    int shift, int per_group, int dt_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt_code == 1) {
    switch (ws) {
      case 16: return launch_attn_bwd_bf16<256>(ATTN_BWD_ARGS, per_group, st);
      case 8: return launch_attn_bwd_bf16<64>(ATTN_BWD_ARGS, per_group, st);
      case 4: return launch_attn_bwd_bf16<16>(ATTN_BWD_ARGS, per_group, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (ws) {
    case 16: return launch_attn_bwd_f32<256>(ATTN_BWD_ARGS, st);
    case 8: return launch_attn_bwd_f32<64>(ATTN_BWD_ARGS, st);
    case 4: return launch_attn_bwd_f32<16>(ATTN_BWD_ARGS, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks of the bf16 attention backward at window size ws (with
// or without the shift mask) on the current device, or a negated CUDA
// error: the caller sizes the image groups, and so the scratch, to it.
extern "C" int swin_window_attn_bwd_blocks(int ws, int masked) {
  int blocks = 0, e = (int)cudaErrorInvalidValue;
  switch (ws * 2 + (masked ? 1 : 0)) {
    case 32: e = attn_bwd_tc_resident<256, false>(blocks); break;
    case 33: e = attn_bwd_tc_resident<256, true>(blocks); break;
    case 16: e = attn_bwd_tc_resident<64, false>(blocks); break;
    case 17: e = attn_bwd_tc_resident<64, true>(blocks); break;
    case 8: e = attn_bwd_tc_resident<16, false>(blocks); break;
    case 9: e = attn_bwd_tc_resident<16, true>(blocks); break;
  }
  return e != 0 ? -e : blocks;
}
