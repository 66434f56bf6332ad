// SwinV2 block backward for Hopper (sm_90a): the four kernels behind
// cs_vit_tpu_torch/ops/fused_block.py:FusedSwinBlock.backward.
//
// Replaces the TPU kernel cs_vit_tpu/ops/fused_block.py:973 (_pallas_backward,
// kernel body _bwd_kernel), which recomputes a slab of the forward in VMEM and
// backpropagates it in place, carrying the weight grads across its sequential
// grid in f32 output blocks. On Hopper blocks run in parallel in no order, so
// every sum across token rows or windows is written as f32 partials and summed
// by a second, deterministic pass (sum_splits) inside the same entry point. As
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
// f32 gradients and round them while staging tiles), bias and LN grads sum the
// f32 values, the attention-output grad ab and p and ds are rounded to the
// compute dtype, gelu'(m1) reads m1 rounded to the compute dtype.
//
// What bounds each kernel on the H100, and what the design does about it:
//  * gemm_dgrad / gemm_wgrad: operations (the 8*C^2 + 16*C^2 FLOPs per token of
//    the block's four GEMMs, twice). bf16 tiles of 64x128x32 on the tensor
//    cores (WMMA), weights/activations staged by cp.async, f32 gradients
//    converted to bf16 as they are staged; two shared-memory buffers. dgrad
//    reads W in its forward [in,out] layout as a column-major operand, so no
//    transpose pass runs. wgrad reduces over all M token rows: split-K over row
//    ranges fills the SMs (stage 0 has only 6 output tiles), f32 partials are
//    summed in a fixed order; the bias grad is the column sum of the f32
//    gradient, taken by the blocks of the first output-row tile. f32 operands
//    run on SIMT FMA (the tensor cores would round them to TF32).
//  * ln_residual_bwd: bytes. One warp per token row, f32 statistics recomputed
//    from the f32 pre-norm input (E[z^2]-E[z]^2 clamped at 0); per-column
//    dgamma/dbeta partials in per-warp shared memory, summed per block, then
//    over blocks.
//  * swin_window_attn_bwd: operations at the bf16 tensor-core peak, but SIMT f32
//    math (no tensor cores yet) holds it at the FMA rate. One CUDA block per
//    (head, window): the L x L scores of a 32-row query tile stay in shared
//    memory, p is recomputed exactly as the forward kernel computes it, dk and
//    dv accumulate in shared memory across the query tiles. rowsum(dp*p) is
//    taken as do . o (o recomputed from p and v). d rel_bias and d logit_scale
//    are per-window f32 partials, summed over the B*nW windows afterwards.
//
// Plain C interface for ctypes. Every entry point returns cudaGetLastError()
// right after its last launch; it launches on the caller's stream, allocates
// nothing (partials live in caller-provided scratch) and does not synchronise.

#include <mma.h>

#include "common.cuh"

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

// ---------------------------------------------------------------------------
// bf16 GEMMs on the tensor cores: 64x128 output tile, depth 32, 4 warps of
// 32x64, two shared-memory stages.
// ---------------------------------------------------------------------------

constexpr int TM = 64, TN = 128, TK = 32, G_THREADS = 128;
enum { EPI_NONE = 0, EPI_GELU = 1, EPI_ADD = 2 };

// dgrad: out[M,K] = epi(round(dY[M,N]) . W[K,N]^T). Output tile rows m, cols
// k; depth n. A = dY (f32, staged as bf16), B = W read as column-major [n][k].
template <int EPI, typename AuxT, typename OutT>
__global__ void __launch_bounds__(G_THREADS)
dgrad_bf16_kernel(const float* __restrict__ dY, const bf16* __restrict__ W,
                  const AuxT* __restrict__ aux, OutT* __restrict__ out, int M, int N, int K) {
  namespace nw = nvcuda::wmma;
  constexpr int LD = TK + 8;  // 40 bf16 = 80 B rows: WMMA pointers stay 32 B aligned
  __shared__ __align__(128) bf16 As[2][TM * LD];  // [m][n]
  __shared__ __align__(128) bf16 Bs[2][TN * LD];  // [k][n]: column-major B
  __shared__ __align__(128) float Cs[G_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * TM, k0 = blockIdx.x * TN;
  const int wr = warp >> 1, wc = warp & 1;

  float4 areg[TM * TK / 4 / G_THREADS];  // 4 float4 per thread
  auto load_a = [&](int n0) {
#pragma unroll
    for (int t = 0; t < TM * TK / 4 / G_THREADS; ++t) {
      const int c = tid + t * G_THREADS;
      const int r = c >> 3, nc = (c & 7) * 4;
      const int gm = m0 + r, gn = n0 + nc;
      areg[t] = (gm < M && gn < N)
                    ? *reinterpret_cast<const float4*>(dY + (size_t)gm * N + gn)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int t = 0; t < TM * TK / 4 / G_THREADS; ++t) {
      const int c = tid + t * G_THREADS;
      const int r = c >> 3, nc = (c & 7) * 4;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&As[buf][r * LD + nc]);
      p[0] = __floats2bfloat162_rn(areg[t].x, areg[t].y);
      p[1] = __floats2bfloat162_rn(areg[t].z, areg[t].w);
    }
  };
  auto load_b = [&](int buf, int n0) {
    for (int c = tid; c < TN * TK / 8; c += G_THREADS) {
      const int r = c >> 2, nc = (c & 3) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(&Bs[buf][r * LD + nc], ok ? W + (size_t)gk * N + gn : W, ok);
    }
    cp_async_commit();
  };

  nw::fragment<nw::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) nw::fill_fragment(acc[i][j], 0.0f);

  const int nt = (N + TK - 1) / TK;
  load_b(0, 0);
  load_a(0);
  store_a(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < nt;
    if (more) {
      load_b(buf ^ 1, (t + 1) * TK);
      load_a((t + 1) * TK);
    }
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      nw::fragment<nw::matrix_a, 16, 16, 16, bf16, nw::row_major> af[2];
      nw::fragment<nw::matrix_b, 16, 16, 16, bf16, nw::col_major> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nw::load_matrix_sync(af[i], &As[buf][(wr * 32 + i * 16) * LD + kk], LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        nw::load_matrix_sync(bfr[j], &Bs[buf][(wc * 64 + j * 16) * LD + kk], LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) nw::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    if (more) {
      store_a(buf ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nw::store_matrix_sync(cs, acc[i][j], 16, nw::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wr * 32 + i * 16 + (e >> 4);
        const int gk = k0 + wc * 64 + j * 16 + (e & 15);
        if (gm < M && gk < K) {
          const size_t o = (size_t)gm * K + gk;
          float v = cs[e];
          if (EPI == EPI_GELU) v *= gelu_grad(to_f(aux[o]));
          if (EPI == EPI_ADD) v += to_f(aux[o]);
          out[o] = from_f<OutT>(v);
        }
      }
      __syncwarp();
    }
}

// wgrad: part[s][K][N] = X[rows of split s, K]^T . round(dY[rows, N]); and,
// from the blocks of output-row tile 0, part[s][K*N + n] = sum_rows dY[., n]
// (f32). Output tile rows i (= k), cols j (= n); depth = token rows m.
__global__ void __launch_bounds__(G_THREADS)
wgrad_bf16_kernel(const bf16* __restrict__ X, const float* __restrict__ dY,
                  float* __restrict__ part, int M, int N, int K, int rows_per_split) {
  namespace nw = nvcuda::wmma;
  constexpr int A_LD = TM + 8;  // As[m][k]: column-major A, 144 B rows
  constexpr int B_LD = TN + 8;  // Bs[m][n]: row-major B, 272 B rows
  __shared__ __align__(128) bf16 As[2][TK * A_LD];
  __shared__ __align__(128) bf16 Bs[2][TK * B_LD];
  __shared__ __align__(128) float Cs[G_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN, s = blockIdx.z;
  const int rb = s * rows_per_split;
  const int re = min(M, rb + rows_per_split);
  const int wr = warp >> 1, wc = warp & 1;
  float* out = part + (size_t)s * ((size_t)K * N + N);

  auto load_a = [&](int buf, int m0) {
    for (int c = tid; c < TK * TM / 8; c += G_THREADS) {
      const int r = c >> 3, ic = (c & 7) * 8;
      const int gm = m0 + r, gi = i0 + ic;
      const bool ok = gm < re && gi < K;
      cp_async16(&As[buf][r * A_LD + ic], ok ? X + (size_t)gm * K + gi : X, ok);
    }
    cp_async_commit();
  };
  float4 breg[TK * TN / 4 / G_THREADS];  // 8 float4 per thread
  auto load_b = [&](int m0) {
#pragma unroll
    for (int t = 0; t < TK * TN / 4 / G_THREADS; ++t) {
      const int c = tid + t * G_THREADS;
      const int r = c >> 5, jc = (c & 31) * 4;
      const int gm = m0 + r, gj = j0 + jc;
      breg[t] = (gm < re && gj < N)
                    ? *reinterpret_cast<const float4*>(dY + (size_t)gm * N + gj)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_b = [&](int buf) {
#pragma unroll
    for (int t = 0; t < TK * TN / 4 / G_THREADS; ++t) {
      const int c = tid + t * G_THREADS;
      const int r = c >> 5, jc = (c & 31) * 4;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&Bs[buf][r * B_LD + jc]);
      p[0] = __floats2bfloat162_rn(breg[t].x, breg[t].y);
      p[1] = __floats2bfloat162_rn(breg[t].z, breg[t].w);
    }
  };

  nw::fragment<nw::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) nw::fill_fragment(acc[i][j], 0.0f);

  const int nt = (re - rb + TK - 1) / TK;
  if (nt > 0) {
    load_a(0, rb);
    load_b(rb);
    store_b(0);
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < nt;
    if (more) {
      load_a(buf ^ 1, rb + (t + 1) * TK);
      load_b(rb + (t + 1) * TK);
    }
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      nw::fragment<nw::matrix_a, 16, 16, 16, bf16, nw::col_major> af[2];
      nw::fragment<nw::matrix_b, 16, 16, 16, bf16, nw::row_major> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nw::load_matrix_sync(af[i], &As[buf][kk * A_LD + wr * 32 + i * 16], A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        nw::load_matrix_sync(bfr[j], &Bs[buf][kk * B_LD + wc * 64 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) nw::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    if (more) {
      store_b(buf ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nw::store_matrix_sync(cs, acc[i][j], 16, nw::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gi = i0 + wr * 32 + i * 16 + (e >> 4);
        const int gj = j0 + wc * 64 + j * 16 + (e & 15);
        if (gi < K && gj < N) out[(size_t)gi * N + gj] = cs[e];
      }
      __syncwarp();
    }

  if (blockIdx.y == 0) {
    for (int j = tid; j < TN; j += G_THREADS) {
      const int gj = j0 + j;
      if (gj >= N) continue;
      float sum = 0.0f;
      for (int m = rb; m < re; ++m) sum += dY[(size_t)m * N + gj];
      out[(size_t)K * N + gj] = sum;
    }
  }
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
// and per column dgamma = sum gz zh, dbeta = sum gz. One warp per row.
// ---------------------------------------------------------------------------

constexpr int LN_THREADS = 256, LN_WARPS = LN_THREADS / 32;

template <typename GT, typename DT>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const float* __restrict__ z, const GT* __restrict__ g, const DT* __restrict__ gamma,
              const float* __restrict__ dp, int dp_col, int rows_per_image,
              float* __restrict__ dz, float* __restrict__ part, int M, int C, float eps,
              int rows_per_block) {
  extern __shared__ float lsm[];  // [LN_WARPS][2][C] per-warp column sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = lsm + (size_t)warp * 2 * C;
  for (int c = lane; c < 2 * C; c += 32) mine[c] = 0.0f;
  const int r_end = min(M, (blockIdx.x + 1) * rows_per_block);
  for (int row = blockIdx.x * rows_per_block + warp; row < r_end; row += LN_WARPS) {
    const float* zr = z + (size_t)row * C;
    const GT* gr = g + (size_t)row * C;
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
    float a = 0.0f, b = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float zh = (zr[c] - mean) * r;
      const float gz = to_f(gr[c]) * d;
      const float zb = gz * to_f(gamma[c]);
      a += zb;
      b += zb * zh;
      mine[c] += gz * zh;
      mine[C + c] += gz;
    }
    a = warp_sum(a) / C;
    b = warp_sum(b) / C;
    float* dzr = dz + (size_t)row * C;
    for (int c = lane; c < C; c += 32) {
      const float zh = (zr[c] - mean) * r;
      const float zb = to_f(gr[c]) * d * to_f(gamma[c]);
      dzr[c] = (zb - a - zh * b) * r;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += LN_THREADS) {
    float sum = 0.0f;
    for (int w = 0; w < LN_WARPS; ++w) sum += lsm[(size_t)w * 2 * C + c];
    part[(size_t)blockIdx.x * 2 * C + c] = sum;
  }
}

// ---------------------------------------------------------------------------
// swin_window_attn_bwd: one CUDA block per (head, window of an image); hd = 32
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

template <typename T, int L>
int launch_attn_bwd(const void* qkv, const void* dout, const void* rel_bias, const void* mask,
                    const void* scale, void* dqkv, void* part, void* out, int B, int H, int W,
                    int C, int heads, int ws, int shift, cudaStream_t st) {
  const size_t smem = AttnBwdShape<L>::smem_floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(window_attn_bwd_kernel<T, L>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nWin = B * (H / ws) * (W / ws);
  dim3 grid(heads, nWin);
  window_attn_bwd_kernel<T, L><<<grid, AB_THREADS, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<const T*>(rel_bias),
      static_cast<const T*>(mask), static_cast<const float*>(scale), static_cast<float*>(dqkv),
      static_cast<float*>(part), H, W, C, heads, ws, shift);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum_splits(static_cast<const float*>(part), static_cast<float*>(out), nWin,
                           (size_t)heads * L * L + heads, st);
}

template <typename T>
int attn_bwd_dispatch(const void* qkv, const void* dout, const void* rel_bias, const void* mask,
                      const void* scale, void* dqkv, void* part, void* out, int B, int H, int W,
                      int C, int heads, int ws, int shift, cudaStream_t st) {
  switch (ws * ws) {
    case 16:
      return launch_attn_bwd<T, 16>(qkv, dout, rel_bias, mask, scale, dqkv, part, out, B, H, W,
                                    C, heads, ws, shift, st);
    case 64:
      return launch_attn_bwd<T, 64>(qkv, dout, rel_bias, mask, scale, dqkv, part, out, B, H, W,
                                    C, heads, ws, shift, st);
    case 256:
      return launch_attn_bwd<T, 256>(qkv, dout, rel_bias, mask, scale, dqkv, part, out, B, H, W,
                                     C, heads, ws, shift, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dt_code: 0 = float32, 1 = bfloat16. epi: 0 none, 1 GELU' (aux = m1 in the
// compute dtype), 2 add (aux in aux_f32 ? f32 : compute dtype). out_f32 picks
// f32 or compute-dtype output.
extern "C" int gemm_dgrad(const void* dY, const void* W, const void* aux, void* out, int M,
                          int N, int K, int dt_code, int epi, int aux_f32, int out_f32,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dy = static_cast<const float*>(dY);
  if (dt_code == 1) {
    dim3 grid((K + TN - 1) / TN, (M + TM - 1) / TM);
    const bf16* w = static_cast<const bf16*>(W);
#define DGRAD(EPI, AUXT, OUTT)                                                            \
  dgrad_bf16_kernel<EPI, AUXT, OUTT><<<grid, G_THREADS, 0, st>>>(                         \
      dy, w, static_cast<const AUXT*>(aux), static_cast<OUTT*>(out), M, N, K)
    if (epi == EPI_GELU) {
      if (out_f32) DGRAD(EPI_GELU, bf16, float); else DGRAD(EPI_GELU, bf16, bf16);
    } else if (epi == EPI_ADD) {
      if (aux_f32) {
        if (out_f32) DGRAD(EPI_ADD, float, float); else DGRAD(EPI_ADD, float, bf16);
      } else {
        if (out_f32) DGRAD(EPI_ADD, bf16, float); else DGRAD(EPI_ADD, bf16, bf16);
      }
    } else {
      if (out_f32) DGRAD(EPI_NONE, float, float); else DGRAD(EPI_NONE, float, bf16);
    }
#undef DGRAD
  } else {
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
  }
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
    dim3 grid((N + TN - 1) / TN, (K + TM - 1) / TM, splits);
    wgrad_bf16_kernel<<<grid, G_THREADS, 0, st>>>(static_cast<const bf16*>(X), dy, p, M, N, K,
                                                  rows_per_split);
  } else {
    dim3 grid((N + FB - 1) / FB, (K + FB - 1) / FB, splits);
    gemm_f32_strided_kernel<EPI_NONE, float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(X), dy, nullptr, p, K, N, M, 1, K, N, 1, rows_per_split, 1);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_sum_splits(p, static_cast<float*>(out), splits, (size_t)K * N + N, st);
}

// dz [M,C] f32; part [blocks][2][C] scratch; out [2][C] = (dgamma, dbeta).
extern "C" int ln_residual_bwd(const void* z, const void* g, const void* gamma, const void* dp,
                               int dp_col, int rows_per_image, void* dz, void* part, void* out,
                               int M, int C, float eps, int blocks, int rows_per_block,
                               int dt_code, int g_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)LN_WARPS * 2 * C * sizeof(float);
  const float* zf = static_cast<const float*>(z);
  const float* d = static_cast<const float*>(dp);
  float* dzf = static_cast<float*>(dz);
  float* pf = static_cast<float*>(part);
#define LNB(GT, DT)                                                                         \
  do {                                                                                      \
    cudaError_t e = cudaFuncSetAttribute(ln_bwd_kernel<GT, DT>,                             \
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,       \
                                         (int)smem);                                        \
    if (e != cudaSuccess) return (int)e;                                                    \
    ln_bwd_kernel<GT, DT><<<blocks, LN_THREADS, smem, st>>>(                                \
        zf, static_cast<const GT*>(g), static_cast<const DT*>(gamma), d, dp_col,            \
        rows_per_image, dzf, pf, M, C, eps, rows_per_block);                                \
  } while (0)
  if (dt_code == 1) {
    if (g_f32) LNB(float, bf16); else LNB(bf16, bf16);
  } else {
    LNB(float, float);
  }
#undef LNB
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum_splits(pf, static_cast<float*>(out), blocks, 2 * (size_t)C, st);
}

// dqkv [B,H,W,3C] f32 (every element written); part [B*nW][heads*L*L + heads]
// scratch; out [heads*L*L + heads] = (d rel_bias, d logit_scale) f32.
extern "C" int swin_window_attn_bwd(const void* qkv, const void* dout, const void* rel_bias,
                                    const void* mask, const void* scale, void* dqkv, void* part,
                                    void* out, int B, int H, int W, int C, int heads, int ws,
                                    int shift, int dt_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt_code == 1)
    return attn_bwd_dispatch<bf16>(qkv, dout, rel_bias, mask, scale, dqkv, part, out, B, H, W,
                                   C, heads, ws, shift, st);
  return attn_bwd_dispatch<float>(qkv, dout, rel_bias, mask, scale, dqkv, part, out, B, H, W, C,
                                  heads, ws, shift, st);
}
