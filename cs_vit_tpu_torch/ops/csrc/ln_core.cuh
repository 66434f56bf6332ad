// Rows in registers: the pieces shared by the two LayerNorm-residual kernels,
// ln_residual (fused_block.cu) and ln_residual_bwd (fused_block_bwd.cu).
//
// A block of at most LN_THREADS threads is cut into row groups of TPR
// adjacent lanes: 16 or 32 (half a warp or a warp: a row sum is a few
// shuffles), or 128 (four warps, the whole block on one row at a time: a row
// sum is shuffles, then the four warps' sums through shared memory between
// two barriers). Thread `lane` of a group owns the 8-column chunks lane,
// lane + TPR, ..., lane + (VPT - 1) TPR of every row the group takes: the same
// columns for every row, so per-column sums stay in its registers, and a
// group's loads of one chunk index cover TPR adjacent 16-byte (bf16) or
// 32-byte (f32) pieces of the row. Block b of a grid of G takes rows
// [b M / G, (b + 1) M / G), its groups one row each per pass, every group
// making the same number of passes (a group past the block's last row
// computes on zeros and stores nothing), so that no lane leaves a shuffle. CX is C where the kernel is
// built for one width (the Swin-B widths 128, 256, 512, 1024, with
// TPR * VPT * 8 == C: no masks), 0 for any C that is a multiple of 8 (the
// chunks at or past C idle). fused_block.py:_ln_plan picks TPR, VPT, the
// groups per block and the grid.

#pragma once

#include "common.cuh"

namespace {

constexpr int LN_THREADS = 256, LN_CLUSTER = 8;

// 8 adjacent elements (the first at a multiple of 8, the base 16-byte
// aligned) widened to f32: one 16-byte load of bf16, two of f32
template <typename T> __device__ __forceinline__ void load8(const T* p, float (&v)[8]);
template <> __device__ __forceinline__ void load8<float>(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <> __device__ __forceinline__ void load8<bf16>(const bf16* p, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// 8 f32 values, each rounded once to T, stored as one such chunk
template <typename T> __device__ __forceinline__ void store8(T* p, const float (&v)[8]);
template <> __device__ __forceinline__ void store8<float>(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <> __device__ __forceinline__ void store8<bf16>(bf16* p, const float (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void zero8(float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.0f;
}

// sums of x and of y over the TPR lanes of a row group: TPR adjacent lanes
// of one warp (every lane of the warp takes part), or, for TPR > 32, the
// whole block (every thread takes part), the warps' sums added in warp order
template <int TPR> __device__ __forceinline__ void group_sum2(float& x, float& y) {
#pragma unroll
  for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
    y += __shfl_xor_sync(0xffffffffu, y, o);
  }
  if constexpr (TPR > 32) {
    constexpr int W = TPR / 32;
    __shared__ float red[2][W];
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // the last row's sums are read
    if ((threadIdx.x & 31) == 0) {
      red[0][warp] = x;
      red[1][warp] = y;
    }
    __syncthreads();
    x = red[0][0];
    y = red[1][0];
#pragma unroll
    for (int w = 1; w < W; ++w) {
      x += red[0][w];
      y += red[1][w];
    }
  }
}

// the rows [r0, r1) of this block: the grid's blocks share the M rows as
// evenly as whole rows allow
__device__ __forceinline__ void ln_block_rows(int M, int& r0, int& r1) {
  r0 = (int)((long long)blockIdx.x * M / gridDim.x);
  r1 = (int)((long long)(blockIdx.x + 1) * M / gridDim.x);
}

// the two halves of a cluster barrier (every thread of every block of the
// cluster): arrive (its earlier writes and reads done) and wait for all
__device__ __forceinline__ void ln_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void ln_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// first column of chunk i of `lane`, and whether it lies in the row
template <int TPR> __device__ __forceinline__ int ln_col(int lane, int i) {
  return 8 * (lane + TPR * i);
}
template <int CX> __device__ __forceinline__ bool ln_in_row(int col, int C) {
  return CX != 0 || col < C;
}

// the row's mean and 1/sqrt(var + eps) from the values v of the lane's
// chunks, var as E[z^2] - E[z]^2 clamped at 0 (the kernels' statistics)
template <int TPR, int VPT>
__device__ __forceinline__ void ln_stats(float (&v)[VPT][8], int C, float eps,
                                         float& mean, float& rstd) {
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += v[i][e];
      ss += v[i][e] * v[i][e];
    }
  group_sum2<TPR>(s, ss);
  mean = s / C;
  rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.0f) + eps);
}

}  // namespace
