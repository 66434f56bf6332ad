// SwinV2 block forward for Hopper (sm_90a): the three kernels behind
// cs_vit_tpu_torch/ops/fused_block.py:fused_swin_block.
//
// Replaces the TPU kernel cs_vit_tpu/ops/fused_block.py:_pallas_forward
// (kernel body _block_kernel/_block_body), which computes a whole block in
// one Pallas call with every weight resident in up to 100 MB of VMEM. A
// Hopper block has 227 KB of shared memory, so the block is split where the
// data allows: every op but attention works on one token at a time (the
// GEMMs, both LayerNorms, the residuals), so only the attention kernel knows
// about windows and the cyclic shift. The GEMMs run over the B*H*W token rows
// in their original order; no roll or window-partition pass touches device
// memory. One block forward = 7 launches:
//   qkv = x Wqkv + b             gemm_bias_act  (dt out)
//   o   = window attention(qkv)  swin_window_attn_fwd (dt out, shift by index)
//   p   = o Wproj + b            gemm_bias_act  (f32 out)
//   h1  = x + dp0 * LN(p)        ln_residual    (f32 and dt out)
//   m   = gelu(h1 W1 + b1)       gemm_bias_act  (dt out)
//   m2  = m W2 + b2              gemm_bias_act  (f32 out)
//   y   = h1 + dp1 * LN(m2)      ln_residual    (dt out)
// Numerics follow _block_reference: f32 accumulation, LN statistics as
// E[x^2]-E[x]^2 clamped at 0, exact-erf GELU (erff), q/k L2-normalised in
// f32 with eps 1e-24 and rounded to the compute dtype before the score
// product, softmax in f32 and p rounded to the compute dtype before p.v.
//
// What bounds each kernel on the H100, and what the design does about it:
//  * gemm_bias_act: bytes at most Swin-B shapes (24*C^2 of the 24*C^2 +
//    4*L*C FLOPs per token are GEMMs, but C <= 1024 gives them little reuse).
//    bf16: wgmma (gemm_core.cuh) on output tiles of 128 x 128, 128 x 64 or
//    64 x 64, A and W by TMA into an mbarrier ring kept full by a producer
//    warp; bias and GELU applied in the epilogue straight from the accumulators,
//    so no extra pass reads the product. f32 (the check path): SIMT FMA.
//  * swin_window_attn_fwd: bytes at the bf16 tensor-core peak (at L=256,
//    4*L*hd = 32768 FLOPs per query and head against 4*hd*2 = 256 bytes of
//    q, k, v and o: 128 FLOP/byte, under the H100's ~295). bf16 (the timed
//    path): the tensor-core core of window_attn_core.cuh (mma.sync m16n8k16,
//    one warp per 16 query rows with its whole [16, L] score block in
//    registers: the full-row variant, no two-pass; 203 registers unshifted,
//    195 with the shift mask at L=256, no spill, per ptxas -v for sm_90a; 2
//    blocks of 4 warps per SM), 4 warps = 64 query rows per block at L=256
//    and L=64, one warp at L=16. q^ and k^ are rounded to
//    bf16 as the plain version rounds them, so they are exact mma operands:
//    one product per score tile. Each block takes one (query tile, head,
//    window) and walks a group of images: its rel_bias and shift-mask rows
//    (bf16) are staged once in shared memory for all of them; each image's
//    q, k and v are gathered as 4 x 16-byte cp.async per token (its 64 bytes
//    of a head in its 3C row), the next image's while this one computes; k^
//    is normalised in shared memory, q^ in registers. The cyclic shift and
//    the window partition are index arithmetic on the gather and the
//    scatter. f32 (the check path, dt_code 0; nothing times it):
//    SIMT f32 math, one block per (query tile of 32, head, image*window),
//    the L x L scores in shared memory.
//  * ln_residual: bytes. One warp per token row, one read of each input and
//    one write of each output. A null dp means keep-scales of 1 (inference).
//
// Plain C interface for ctypes. Every entry point returns cudaGetLastError()
// right after its launch; it launches on the caller's stream, allocates
// nothing and does not synchronise.

#include <limits.h>

#include "common.cuh"
#include "gemm_core.cuh"
#include "window_attn_core.cuh"

namespace {

// ---------------------------------------------------------------------------
// gemm_bias_act, bf16: out[M,N] = act(A[M,K] . W[K,N] + bias[N]) on wgmma
// (gemm_core.cuh). Replaces the four products of the TPU kernel's
// _block_kernel (cs_vit_tpu/ops/fused_block.py:_pallas_forward, :738), which
// hold every weight in VMEM.
// Output tile BM x BN (128 x 128, 128 x 64 or 64 x 64; fused_block.py:
// _gemm_plan picks the largest whose tiles fill half of the SMs), one
// consumer warpgroup per 64 rows, depth 64 a stage, a ring of up to 8
// stages sized to let two blocks share an SM (fewer where K is shorter).
// One producer warp (the block's last) keeps the ring full by TMA: the A rows as a K-major 128-byte-
// swizzled tile (box {64 of K, BM rows}), the W rows as BN / 64 MN-major
// swizzled atoms (boxes {64 of N, 64 rows of K}); both land as wgmma's
// operands are read, and out-of-bounds rows and columns read as 0, so
// ragged M, N and K need no masks in the mainloop. Each consumer warpgroup
// runs 4 wgmma m64nBNk16 a stage with one group in flight and hands a
// stage back once the products that read it are done. The epilogue stages
// the f32 accumulators in shared memory (the ring, free by then) and
// writes the tile in rows of 4-column chunks, a warp's stores contiguous
// (rather than 8 rows of 8 or 4 bytes a warp instruction in the
// accumulators' own pairs): bias in f32, the optional exact-erf GELU, one
// rounding to the output dtype.
// The grid walks the column tiles of one band of BM rows before the next
// band, so the blocks that share an A band run together and re-read it
// from L2.
// What bounds it on the H100: bytes at most Swin-B shapes (2 M K + 2 K N +
// 2 or 4 M N bytes against 2 M N K FLOPs; operations only for the qkv and
// MLP-1 products of stages 2-3): 0.42 ms a b8 forward, summed per call as
// chip_smoke.py counts it. So the design keeps the A and W tiles in flight
// by TMA, reads A from device memory once per band (then from L2), and
// writes the output once, in whole sectors. At those shapes the operands'
// re-reads from L2 (each column of tiles reads all of A, each row all of W)
// set the pace, more than the tensor cores do: a larger tile reads less.
// ---------------------------------------------------------------------------

template <int BM, int BN>
struct FwdGemm {
  static constexpr int WG = BM / 64, CONSUMERS = 128 * WG, THREADS = CONSUMERS + 32, BK = 64;
  static constexpr int A_BYTES = BM * GC_ATOM_ROW_BYTES;       // BM rows x 64 of K
  static constexpr int W_ATOM_BYTES = BK * GC_ATOM_ROW_BYTES;  // 64 of K x 64 of N
  static constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * W_ATOM_BYTES;
  static constexpr int TILE_BYTES = BM * acc_pitch<BN>() * 4;
};

template <int BM, int BN>
__global__ void __launch_bounds__(FwdGemm<BM, BN>::THREADS, 1)
gemm_bias_act_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                           const __grid_constant__ CUtensorMap tm_w,
                           const bf16* __restrict__ bias, void* __restrict__ out, int M, int N,
                           int K, int stages, int act, int out_f32) {
  using S_ = FwdGemm<BM, BN>;
  constexpr int BK = S_::BK, STAGE_BYTES = S_::STAGE_BYTES, CONSUMERS = S_::CONSUMERS;
  extern __shared__ unsigned char gb_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(gb_raw);
  uint64_t* empty = full + GC_MAX_STAGES;
  unsigned char* ring = gc_ring(gb_raw);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int iters = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warp: one thread issues every load
    if (tid == CONSUMERS) {
      for (int it = 0, s = 0, ph = 0; it < iters; ++it) {
        if (it >= stages) mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        const int k = it * BK;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(st, &tm_a, &full[s], k, m0);
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          tma_load_2d(st + S_::A_BYTES + a * S_::W_ATOM_BYTES, &tm_w, &full[s], n0 + 64 * a, k);
        if (++s == stages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  const int wg = tid >> 7;  // this warpgroup's 64 rows of the tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int it = 0, s = 0, ph = 0, prev = 0; it < iters; ++it) {
    mbar_wait(&full[s], ph);
    const uint32_t st = gc_smem(ring + s * STAGE_BYTES);
    const uint32_t a_addr = st + wg * 64 * GC_ATOM_ROW_BYTES, w_addr = st + S_::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<BN, 0, 1>(acc, wgmma_desc_k_sw128(a_addr + kk * 32),
                         wgmma_desc_mn_sw128(w_addr + kk * 16 * GC_ATOM_ROW_BYTES,
                                             S_::W_ATOM_BYTES));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: hand it back
    if (it > 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == stages) s = 0, ph ^= 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) wgmma_keep(acc[i]);

  // epilogue: the accumulators through shared memory (the ring is free once
  // every warpgroup's last products are done), then out in rows of 4-column
  // chunks, each warp's stores contiguous; a thread keeps one chunk column,
  // so it reads its 4 bias values once
  constexpr int CH = BN / 4, RSTEP = CONSUMERS / CH, P = acc_pitch<BN>();
  float* tile = reinterpret_cast<float*>(ring);
  named_barrier(1, CONSUMERS);
  stage_acc<BN>(tile + wg * 64 * P, acc, tid & 127);
  named_barrier(1, CONSUMERS);
  const int cq = tid % CH, c = n0 + 4 * cq;
  if (c >= N) return;  // N is a multiple of 8: a chunk is in or out whole
  const float4 b = load4(bias + c);
#pragma unroll
  for (int i = 0; i < BM / RSTEP; ++i) {
    const int rt = tid / CH + RSTEP * i, r = m0 + rt;
    if (r >= M) break;
    float4 v = *reinterpret_cast<const float4*>(tile + rt * P + 4 * cq);
    v.x += b.x;
    v.y += b.y;
    v.z += b.z;
    v.w += b.w;
    if (act) {
      v.x = gelu_erf(v.x);
      v.y = gelu_erf(v.y);
      v.z = gelu_erf(v.z);
      v.w = gelu_erf(v.w);
    }
    const size_t o = (size_t)r * N + c;
    if (out_f32) store4(static_cast<float*>(out) + o, v);
    else store4(static_cast<bf16*>(out) + o, v);
  }
}

template <int BM, int BN>
int launch_gemm_bias_act_bf16(const bf16* A, const bf16* W, const bf16* bias, void* out, int M,
                              int N, int K, int stages, int act, int out_f32, cudaStream_t st) {
  using S_ = FwdGemm<BM, BN>;
  CUtensorMap ta, tw;
  int e = encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, A, M, K, 64, BM,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  e = encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, W, K, N, 64, S_::BK,
                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  static int resident[WC_MAX_DEVICES];
  const int blocks = device_blocks(resident, gemm_bias_act_wgmma_kernel<BM, BN>, S_::THREADS,
                                   GC_SMEM_CAP);
  if (blocks < 0) return -blocks;
  // a stage goes back to the producer one stage late (one group of products
  // stays in flight): a longer reduction needs two stages or more
  if (stages < 2 && K > S_::BK) return (int)cudaErrorInvalidValue;
  const size_t smem = gc_smem_bytes(stages, S_::STAGE_BYTES, S_::TILE_BYTES);
  if (smem > GC_SMEM_CAP) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bias_act_wgmma_kernel<BM, BN><<<grid, S_::THREADS, smem, st>>>(ta, tw, bias, out, M, N,
                                                                      K, stages, act, out_f32);
  return (int)cudaGetLastError();
}

// f32 operands: SIMT FMA (the tensor cores would round to TF32), 64x64 tile,
// 4x4 outputs per thread.
constexpr int FB = 64, FK = 16;

template <int ACT>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K) {
  __shared__ float As[FK][FB + 1];
  __shared__ float Bs[FK][FB + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FB, n0 = blockIdx.x * FB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int e = tid; e < FB * FK; e += 256) {
      const int r = e / FK, k = e % FK;
      const int gm = m0 + r, gk = k0 + k;
      As[k][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
      const int kr = e / FB, c = e % FB;
      const int gk2 = k0 + kr, gn = n0 + c;
      Bs[kr][c] = (gk2 < K && gn < N) ? W[(size_t)gk2 * N + gn] : 0.0f;
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
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        float v = acc[i][j] + bias[gn];
        if (ACT == 1) v = gelu_erf(v);
        out[(size_t)gm * N + gn] = v;
      }
    }
}

// ---------------------------------------------------------------------------
// ln_residual: y = res + dp[b, col] * (LN(z) * gamma + beta), one warp per row
// ---------------------------------------------------------------------------

template <typename ResT, typename DT>
__global__ void __launch_bounds__(256)
ln_residual_kernel(const float* __restrict__ z, const ResT* __restrict__ res,
                   const DT* __restrict__ gamma, const DT* __restrict__ beta,
                   const float* __restrict__ dp, int dp_col, int rows_per_image,
                   float* __restrict__ out_f32, DT* __restrict__ out_dt,
                   int M, int C, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* zr = z + (size_t)row * C;
  float s = 0.0f, ss = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = zr[c];
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / C;
  const float var = fmaxf(ss / C - mean * mean, 0.0f);
  const float r = rsqrtf(var + eps);
  const float d = dp ? dp[(row / rows_per_image) * 2 + dp_col] : 1.0f;
  const size_t base = (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float ln = (zr[c] - mean) * r * to_f(gamma[c]) + to_f(beta[c]);
    const float y = to_f(res[base + c]) + d * ln;
    if (out_f32) out_f32[base + c] = y;
    if (out_dt) out_dt[base + c] = from_f<DT>(y);
  }
}

// ---------------------------------------------------------------------------
// swin_window_attn_fwd: cosine window attention with the cyclic shift folded
// into the gather/scatter indices. hd = 32 (one lane per channel), L = ws*ws
// dividing 256, query tiles of min(32, L) rows.
// ---------------------------------------------------------------------------

constexpr int AT_THREADS = 256, AT_HD = 32, AT_QT = 32, AT_NWARPS = AT_THREADS / 32;

__host__ __device__ constexpr size_t attn_smem_floats(int L, int QT) {
  return (size_t)L * (AT_HD + 1) + (size_t)L * AT_HD + (size_t)QT * AT_HD + (size_t)QT * L;
}

template <typename T>
__global__ void __launch_bounds__(AT_THREADS)
window_attn_kernel(const T* __restrict__ qkv, const T* __restrict__ rel_bias,
                   const T* __restrict__ mask, const float* __restrict__ scale,
                   T* __restrict__ out, int H, int W, int C, int ws, int shift) {
  extern __shared__ __align__(16) float smem[];
  const int L = ws * ws;
  const int QT = L < AT_QT ? L : AT_QT;
  float* Ks = smem;                   // [L][AT_HD+1] normalised k (odd stride: no bank conflicts)
  float* Vs = Ks + L * (AT_HD + 1);   // [L][AT_HD]
  float* Qs = Vs + L * AT_HD;         // [QT][AT_HD] normalised q
  float* S = Qs + QT * AT_HD;         // [QT][L] scores, then p

  const int nWc = W / ws, nW = (H / ws) * nWc;
  const int h = blockIdx.y;
  const int b = blockIdx.z / nW, w = blockIdx.z % nW;
  const int wr = w / nWc, wc = w % nWc;
  const int q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t C3 = 3 * (size_t)C;

  // window token l of shifted window (wr, wc) is original token
  // ((wr*ws + i + shift) mod H, (wc*ws + j + shift) mod W)
  auto token = [&](int l) -> size_t {
    const int i = l / ws, j = l % ws;
    const int r = (wr * ws + i + shift) % H;
    const int c = (wc * ws + j + shift) % W;
    return ((size_t)b * H + r) * W + c;
  };

  for (int l = warp; l < L; l += AT_NWARPS) {
    const size_t base = token(l) * C3 + (size_t)h * AT_HD + lane;
    const float k = to_f(qkv[base + C]);
    const float v = to_f(qkv[base + 2 * (size_t)C]);
    const float rk = rsqrtf(warp_sum(k * k) + 1e-24f);
    Ks[l * (AT_HD + 1) + lane] = round_to<T>(k * rk);
    Vs[l * AT_HD + lane] = v;
  }
  for (int i = warp; i < QT; i += AT_NWARPS) {
    const float q = to_f(qkv[token(q0 + i) * C3 + (size_t)h * AT_HD + lane]);
    const float rq = rsqrtf(warp_sum(q * q) + 1e-24f);
    Qs[i * AT_HD + lane] = round_to<T>(q * rq);
  }
  __syncthreads();

  // scores: each thread owns key column j (k_j in registers) and a stride of rows
  {
    const float sc = scale[h];
    const T* bias_h = rel_bias + (size_t)h * L * L;
    const T* mask_w = mask ? mask + (size_t)w * L * L : nullptr;
    const int nrg = AT_THREADS / L;
    const int j = tid % L, rg = tid / L;
    float kr[AT_HD];
#pragma unroll
    for (int d = 0; d < AT_HD; ++d) kr[d] = Ks[j * (AT_HD + 1) + d];
    for (int i = rg; i < QT; i += nrg) {
      const float4* qrow = reinterpret_cast<const float4*>(Qs + i * AT_HD);
      float dot = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < AT_HD / 4; ++d4) {
        const float4 qv = qrow[d4];
        dot = fmaf(qv.x, kr[4 * d4 + 0], dot);
        dot = fmaf(qv.y, kr[4 * d4 + 1], dot);
        dot = fmaf(qv.z, kr[4 * d4 + 2], dot);
        dot = fmaf(qv.w, kr[4 * d4 + 3], dot);
      }
      const size_t idx = (size_t)(q0 + i) * L + j;
      float s = dot * sc + to_f(bias_h[idx]);
      if (mask_w) s += to_f(mask_w[idx]);
      S[i * L + j] = s;
    }
  }
  __syncthreads();

  // softmax (row max), one warp per row; p rounded to the compute dtype
  for (int i = warp; i < QT; i += AT_NWARPS) {
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

  // o = p . v: warp owns rows warp, warp+8, warp+16, warp+24; lane = channel
  float acc[AT_QT / AT_NWARPS] = {};
  for (int j = 0; j < L; j += 4) {
    const float v0 = Vs[(j + 0) * AT_HD + lane];
    const float v1 = Vs[(j + 1) * AT_HD + lane];
    const float v2 = Vs[(j + 2) * AT_HD + lane];
    const float v3 = Vs[(j + 3) * AT_HD + lane];
#pragma unroll
    for (int r = 0; r < AT_QT / AT_NWARPS; ++r) {
      const int i = warp + AT_NWARPS * r;
      if (i < QT) {
        const float4 p = *reinterpret_cast<const float4*>(S + i * L + j);
        acc[r] = fmaf(p.x, v0, fmaf(p.y, v1, fmaf(p.z, v2, fmaf(p.w, v3, acc[r]))));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < AT_QT / AT_NWARPS; ++r) {
    const int i = warp + AT_NWARPS * r;
    if (i < QT) out[token(q0 + i) * C + (size_t)h * AT_HD + lane] = from_f<T>(acc[r]);
  }
}

template <typename T>
int launch_attn(const void* qkv, const void* rel_bias, const void* mask, const void* scale,
                void* out, int B, int H, int W, int C, int heads, int ws, int shift,
                cudaStream_t st) {
  const int L = ws * ws;
  const int QT = L < AT_QT ? L : AT_QT;
  const size_t smem = attn_smem_floats(L, QT) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(window_attn_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(L / QT, heads, B * (H / ws) * (W / ws));
  window_attn_kernel<T><<<grid, AT_THREADS, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(rel_bias),
      static_cast<const T*>(mask), static_cast<const float*>(scale), static_cast<T*>(out),
      H, W, C, ws, shift);
  return (int)cudaGetLastError();
}

// bf16: tensor cores (window_attn_core.cuh). Grid (query tile of 64 or 16
// rows, head, window + nW * image group): a block walks the images of its
// group for one (query tile, head, window). Shared memory: q of the block's
// rows, k and v of the window (swizzled bf16), the block's rel_bias rows and,
// with a shift, its mask rows (padded bf16).
template <int L>
__host__ __device__ constexpr size_t attn_tc_smem_bytes(bool masked) {
  return ((size_t)(WC_ROWS * wc_warps<L>() + 2 * L) * WC_HD
          + (masked ? 2 : 1) * (size_t)WC_ROWS * wc_warps<L>() * (L + WC_BIAS_PAD))
         * sizeof(bf16);
}

template <int L, bool MASKED>
__global__ void __launch_bounds__(32 * wc_warps<L>())
window_attn_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ rel_bias,
                      const bf16* __restrict__ mask, const float* __restrict__ scale,
                      bf16* __restrict__ out, int B, int H, int W, int C, int shift,
                      int per_group) {
  constexpr int WS = L == 256 ? 16 : (L == 64 ? 8 : 4);
  constexpr int NWARP = wc_warps<L>(), THREADS = 32 * NWARP, QROWS = WC_ROWS * NWARP;
  constexpr int BLD = L + WC_BIAS_PAD;
  extern __shared__ __align__(16) unsigned char wc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(wc_smem);
  bf16* Ks = Qs + QROWS * WC_HD;
  bf16* Vs = Ks + L * WC_HD;
  bf16* Rb = Vs + L * WC_HD;   // [QROWS][BLD] rel_bias rows
  bf16* Mk = Rb + QROWS * BLD;  // [QROWS][BLD] mask rows (MASKED)

  const int nWc = W / WS, nW = (H / WS) * nWc;
  const int h = blockIdx.y;
  const int w = blockIdx.z % nW;
  const int b0 = (blockIdx.z / nW) * per_group, b1 = min(B, b0 + per_group);
  const int wr = w / nWc, wc = w % nWc;
  const int q0 = blockIdx.x * QROWS;
  const int tid = threadIdx.x, warp = tid >> 5;

  // Window token l of shifted window (wr, wc) is token
  // ((wr*WS + i + shift) mod H, (wc*WS + j + shift) mod W) of its image.
  // Each thread copies the same chunks of every image: their offsets in an
  // image's [H, W, 3C] qkv, and those of its two output rows in [H, W, C],
  // are computed once.
  constexpr int KV_PER = L * 4 / THREADS, Q_PER = QROWS * 4 / THREADS;
  int kv_off[KV_PER], q_off[Q_PER];
#pragma unroll
  for (int i = 0; i < KV_PER; ++i) {
    const int c = tid + i * THREADS, l = c >> 2;
    const int tok = ((wr * WS + l / WS + shift) % H) * W + (wc * WS + l % WS + shift) % W;
    kv_off[i] = tok * 3 * C + h * WC_HD + (c & 3) * 8;
  }
#pragma unroll
  for (int i = 0; i < Q_PER; ++i) {
    const int c = tid + i * THREADS, l = q0 + (c >> 2);
    const int tok = ((wr * WS + l / WS + shift) % H) * W + (wc * WS + l % WS + shift) % W;
    q_off[i] = tok * 3 * C + h * WC_HD + (c & 3) * 8;
  }
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  int o_off[2];  // this lane's output rows: r0 + g and r0 + g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int l = q0 + warp * WC_ROWS + g + 8 * i;
    const int tok = ((wr * WS + l / WS + shift) % H) * W + (wc * WS + l % WS + shift) % W;
    o_off[i] = tok * C + h * WC_HD;
  }
  const size_t img_qkv = (size_t)H * W * 3 * C, img_out = (size_t)H * W * C;

  // cp.async groups: q and k of an image, the bias rows (once), v of an
  // image. A head's 32 values of q, k or v are 64 contiguous bytes of the
  // token's 3C row: 4 chunks of 16 bytes. Every thread commits every group
  // (empty past the last image), so the wait counts below hold.
  gather_rows<THREADS>(Qs, qkv + b0 * img_qkv, q_off);
  gather_rows<THREADS>(Ks, qkv + b0 * img_qkv + C, kv_off);
  cp_async_commit();
  stage_rows(Rb, BLD, rel_bias + ((size_t)h * L + q0) * L, L, QROWS, L, tid, THREADS);
  if (MASKED) stage_rows(Mk, BLD, mask + ((size_t)w * L + q0) * L, L, QROWS, L, tid, THREADS);
  cp_async_commit();
  gather_rows<THREADS>(Vs, qkv + b0 * img_qkv + 2 * C, kv_off);
  cp_async_commit();

  const SmemBias<bf16, MASKED> bias_at{Rb + warp * WC_ROWS * BLD, Mk + warp * WC_ROWS * BLD, BLD};
  const float sc = scale[h];
  for (int b = b0; b < b1; ++b) {
    // pending: (bias, v) of the first image, else v of this one
    if (b == b0) cp_async_wait<2>();
    else cp_async_wait<1>();
    __syncthreads();  // q and k of this image
    // k^ = k * rsqrt(sum k^2 + 1e-24), rounded to bf16, in place. L * 4 is a
    // multiple of THREADS, so every lane of a quad takes each step.
    for (int c = tid; c < L * 4; c += THREADS) {
      bf16* chunk = Ks + swz(c >> 2, c & 3);
      float f[8];
      const float r = rsqrtf(chunk_row_sumsq(chunk, f) + 1e-24f);
      uint4 packed;
      packed.x = pack_bf16(f[0] * r, f[1] * r);
      packed.y = pack_bf16(f[2] * r, f[3] * r);
      packed.z = pack_bf16(f[4] * r, f[5] * r);
      packed.w = pack_bf16(f[6] * r, f[7] * r);
      *reinterpret_cast<uint4*>(chunk) = packed;
    }
    // q^ likewise, in this warp's A fragments
    uint32_t qa[2][4];
    load_q_frags(qa, Qs + warp * WC_ROWS * WC_HD);
    const float2 qss = q_row_sumsq(qa);
    const float rq0 = rsqrtf(qss.x + 1e-24f), rq1 = rsqrtf(qss.y + 1e-24f);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack_bf16(qa[kk][i]);
        const float r = (i & 1) ? rq1 : rq0;
        qa[kk][i] = pack_bf16(f.x * r, f.y * r);
      }
    __syncthreads();  // k^
    float s[L / 8][4];
    window_scores<L>(s, qa, Ks);
    if (b == b0) {
      cp_async_wait<1>();  // pending: v
      __syncthreads();     // the bias rows
    }
    uint32_t pa[L / 16][4];
    window_softmax<L, false>(s, sc, sc, nullptr, bias_at, pa);
    // the next image's q and k, fetched once the f32 scores are gone (fewer
    // live registers than right after the product)
    __syncthreads();  // every warp is done with q and k
    if (b + 1 < b1) {
      gather_rows<THREADS>(Qs, qkv + (b + 1) * img_qkv, q_off);
      gather_rows<THREADS>(Ks, qkv + (b + 1) * img_qkv + C, kv_off);
    }
    cp_async_commit();
    cp_async_wait<1>();  // pending: next q and k
    __syncthreads();     // v of this image
    float o[4][4];
    window_pv<L>(pa, Vs, o);

    bf16* o0 = out + b * img_out + o_off[0];
    bf16* o1 = out + b * img_out + o_off[1];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(o0 + c) = pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(o1 + c) = pack_bf16(o[n][2], o[n][3]);
    }
    __syncthreads();  // every warp is done with v
    if (b + 1 < b1) gather_rows<THREADS>(Vs, qkv + (b + 1) * img_qkv + 2 * C, kv_off);
    cp_async_commit();
  }
}

template <int L, bool MASKED>
int launch_attn_tc(const void* qkv, const void* rel_bias, const void* mask, const void* scale,
                   void* out, int B, int H, int W, int C, int heads, int ws, int shift,
                   cudaStream_t st) {
  constexpr int THREADS = 32 * wc_warps<L>(), TILES = L / (WC_ROWS * wc_warps<L>());
  constexpr size_t smem = attn_tc_smem_bytes<L>(MASKED);
  if ((long long)H * W * 3 * C > INT_MAX) return (int)cudaErrorInvalidValue;  // int offsets
  auto kernel = window_attn_tc_kernel<L, MASKED>;
  static int resident[WC_MAX_DEVICES];
  const int blocks = device_blocks(resident, kernel, THREADS, smem);
  if (blocks < 0) return -blocks;
  const int nW = (H / ws) * (W / ws);
  const int per_group = images_per_group(blocks, TILES * heads * nW, B);
  dim3 grid(TILES, heads, nW * ((B + per_group - 1) / per_group));
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel_bias),
      static_cast<const bf16*>(mask), static_cast<const float*>(scale), static_cast<bf16*>(out),
      B, H, W, C, shift, per_group);
  return (int)cudaGetLastError();
}

template <int L>
int launch_attn_tc(const void* qkv, const void* rel_bias, const void* mask, const void* scale,
                   void* out, int B, int H, int W, int C, int heads, int ws, int shift,
                   cudaStream_t st) {
  if (mask)
    return launch_attn_tc<L, true>(qkv, rel_bias, mask, scale, out, B, H, W, C, heads, ws,
                                   shift, st);
  return launch_attn_tc<L, false>(qkv, rel_bias, mask, scale, out, B, H, W, C, heads, ws, shift,
                                  st);
}

int launch_attn_bf16(const void* qkv, const void* rel_bias, const void* mask, const void* scale,
                     void* out, int B, int H, int W, int C, int heads, int ws, int shift,
                     cudaStream_t st) {
  switch (ws) {
    case 16: return launch_attn_tc<256>(qkv, rel_bias, mask, scale, out, B, H, W, C, heads, ws, shift, st);
    case 8: return launch_attn_tc<64>(qkv, rel_bias, mask, scale, out, B, H, W, C, heads, ws, shift, st);
    case 4: return launch_attn_tc<16>(qkv, rel_bias, mask, scale, out, B, H, W, C, heads, ws, shift, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dt_code: 0 = float32, 1 = bfloat16
// bm x bn: the bf16 kernel's output tile, 128 x 128, 128 x 64 or 64 x 64,
// and stages its ring of 64-deep stages, 1 to 8 (fused_block.py:_gemm_plan);
// the f32 body ignores them.
extern "C" int gemm_bias_act(const void* A, const void* W, const void* bias, void* out,
                             int M, int N, int K, int dt_code, int out_f32, int act, int bm,
                             int bn, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt_code == 1) {
    if (stages < 1 || stages > GC_MAX_STAGES) return (int)cudaErrorInvalidValue;
    const bf16* a = static_cast<const bf16*>(A);
    const bf16* w = static_cast<const bf16*>(W);
    const bf16* b = static_cast<const bf16*>(bias);
#define GBA(BM, BN) \
  launch_gemm_bias_act_bf16<BM, BN>(a, w, b, out, M, N, K, stages, act, out_f32, st)
    switch (bm * 1000 + bn) {
      case 128128: return GBA(128, 128);
      case 128064: return GBA(128, 64);
      case 64064: return GBA(64, 64);
    }
#undef GBA
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((N + FB - 1) / FB, (M + FB - 1) / FB);
  const float* a = static_cast<const float*>(A);
  const float* w = static_cast<const float*>(W);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (act) gemm_f32_kernel<1><<<grid, 256, 0, st>>>(a, w, b, o, M, N, K);
  else gemm_f32_kernel<0><<<grid, 256, 0, st>>>(a, w, b, o, M, N, K);
  return (int)cudaGetLastError();
}

extern "C" int ln_residual(const void* z, const void* res, const void* gamma, const void* beta,
                           const void* dp, int dp_col, int rows_per_image, void* out_f32,
                           void* out_dt, int M, int C, float eps, int dt_code, int res_f32,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_block = 256 / 32;
  const int grid = (M + rows_per_block - 1) / rows_per_block;
  const float* zf = static_cast<const float*>(z);
  const float* d = static_cast<const float*>(dp);
  float* of = static_cast<float*>(out_f32);
  if (dt_code == 1) {
    const bf16* g = static_cast<const bf16*>(gamma);
    const bf16* bt = static_cast<const bf16*>(beta);
    bf16* od = static_cast<bf16*>(out_dt);
    if (res_f32)
      ln_residual_kernel<float, bf16><<<grid, 256, 0, st>>>(
          zf, static_cast<const float*>(res), g, bt, d, dp_col, rows_per_image, of, od, M, C, eps);
    else
      ln_residual_kernel<bf16, bf16><<<grid, 256, 0, st>>>(
          zf, static_cast<const bf16*>(res), g, bt, d, dp_col, rows_per_image, of, od, M, C, eps);
  } else {
    ln_residual_kernel<float, float><<<grid, 256, 0, st>>>(
        zf, static_cast<const float*>(res), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), d, dp_col, rows_per_image, of,
        static_cast<float*>(out_dt), M, C, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" int swin_window_attn_fwd(const void* qkv, const void* rel_bias, const void* mask,
                                    const void* scale, void* out, int B, int H, int W, int C,
                                    int heads, int ws, int shift, int dt_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt_code == 1)
    return launch_attn_bf16(qkv, rel_bias, mask, scale, out, B, H, W, C, heads, ws, shift, st);
  return launch_attn<float>(qkv, rel_bias, mask, scale, out, B, H, W, C, heads, ws, shift, st);
}
