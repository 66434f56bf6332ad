// Attention-only SwinV2 cosine window attention for Hopper (sm_90a): the
// kernel behind cs_vit_tpu_torch/ops/window_attention.py:fused_window_attention.
//
// Replaces the TPU kernel cs_vit_tpu/ops/window_attention.py:fused_window_attention
// (the Pallas kernel body `kernel`, grid (window, head chunk, image)), which
// computes, per window instance b_ and head h,
//   out = softmax(q^ k^T * scale[h] + bias[b_ % nW, h]) v
// with q^ = q * rsqrt(sum q^2 + 1e-24) and k^ likewise, both in f32 and NOT
// rounded (unlike the whole-block kernel of fused_block.cu, which rounds them
// to the compute dtype), the softmax by the row max in f32, p rounded to v's
// dtype before p.v, f32 accumulation and the output in q's dtype. The bias is
// the CPB bias plus the shift mask, combined outside: [nW or 1, H, L, L], read
// in its own dtype (f32 when the f32 shift mask was added, else the CPB
// bias's dtype) and widened in registers.
//
// What bounds it on the H100, and what the design does about it: bytes at
// the tensor-core peak (at L=256 and hd=32, 4*L*hd FLOPs per query row
// against the 4*hd values of q, k, v and out it moves: 128 FLOP/byte in bf16,
// under the card's ~295), but run on SIMT f32 math (no tensor cores yet) it
// is held by the FMA rate. The L x L scores never leave shared memory. One
// CUDA block per (query tile of 32 rows, head, window instance); k^ (f32) and
// v stay in shared memory for the whole window beside the score tile: about
// 101 KB at L=256. The layout and loops are those of window_attn_kernel in
// fused_block.cu; the TPU kernel's bias residency across images has no
// counterpart (blocks run in no order); the bias slab of a block is read
// once, coalesced, from L2.
//
// Plain C interface for ctypes. The entry point returns cudaGetLastError()
// right after its launch; it launches on the caller's stream, allocates
// nothing and does not synchronise.

#include "common.cuh"

namespace {

constexpr int WA_THREADS = 256, WA_HD = 32, WA_QT = 32, WA_NWARPS = WA_THREADS / 32;

__host__ __device__ constexpr size_t wa_smem_floats(int L, int QT) {
  return (size_t)L * (WA_HD + 1) + (size_t)L * WA_HD + (size_t)QT * WA_HD + (size_t)QT * L;
}

// hd = 32 (one lane per channel); L = 16, 64 or 256; query tiles of min(32, L) rows.
template <typename T, typename BT>
__global__ void __launch_bounds__(WA_THREADS)
fused_window_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const BT* __restrict__ bias,
                         const float* __restrict__ scale, T* __restrict__ out,
                         int H, int L, int nW) {
  extern __shared__ __align__(16) float smem[];
  const int QT = L < WA_QT ? L : WA_QT;
  float* Ks = smem;                   // [L][WA_HD+1] k^ in f32 (odd stride: no bank conflicts)
  float* Vs = Ks + L * (WA_HD + 1);   // [L][WA_HD]
  float* Qs = Vs + L * WA_HD;         // [QT][WA_HD] q^ in f32
  float* S = Qs + QT * WA_HD;         // [QT][L] scores, then p

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int bw = blockIdx.z;          // window instance b_ = image * nW + window
  const int w = nW == 1 ? 0 : bw % nW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head = ((size_t)bw * H + h) * L * WA_HD;

  for (int l = warp; l < L; l += WA_NWARPS) {
    const size_t idx = head + (size_t)l * WA_HD + lane;
    const float kv = to_f(k[idx]);
    const float rk = rsqrtf(warp_sum(kv * kv) + 1e-24f);
    Ks[l * (WA_HD + 1) + lane] = kv * rk;
    Vs[l * WA_HD + lane] = to_f(v[idx]);
  }
  for (int i = warp; i < QT; i += WA_NWARPS) {
    const float qv = to_f(q[head + (size_t)(q0 + i) * WA_HD + lane]);
    const float rq = rsqrtf(warp_sum(qv * qv) + 1e-24f);
    Qs[i * WA_HD + lane] = qv * rq;
  }
  __syncthreads();

  // scores: each thread owns key column j (k^_j in registers) and a stride of rows
  {
    const float sc = scale[h];
    const BT* bias_wh = bias + ((size_t)w * H + h) * L * L;
    const int nrg = WA_THREADS / L;
    const int j = tid % L, rg = tid / L;
    float kr[WA_HD];
#pragma unroll
    for (int d = 0; d < WA_HD; ++d) kr[d] = Ks[j * (WA_HD + 1) + d];
    for (int i = rg; i < QT; i += nrg) {
      const float4* qrow = reinterpret_cast<const float4*>(Qs + i * WA_HD);
      float dot = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < WA_HD / 4; ++d4) {
        const float4 qv = qrow[d4];
        dot = fmaf(qv.x, kr[4 * d4 + 0], dot);
        dot = fmaf(qv.y, kr[4 * d4 + 1], dot);
        dot = fmaf(qv.z, kr[4 * d4 + 2], dot);
        dot = fmaf(qv.w, kr[4 * d4 + 3], dot);
      }
      S[i * L + j] = dot * sc + to_f(bias_wh[(size_t)(q0 + i) * L + j]);
    }
  }
  __syncthreads();

  // softmax (row max), one warp per row; p rounded to v's dtype
  for (int i = warp; i < QT; i += WA_NWARPS) {
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

  // out = p . v: warp owns rows warp, warp+8, warp+16, warp+24; lane = channel
  float acc[WA_QT / WA_NWARPS] = {};
  for (int j = 0; j < L; j += 4) {
    const float v0 = Vs[(j + 0) * WA_HD + lane];
    const float v1 = Vs[(j + 1) * WA_HD + lane];
    const float v2 = Vs[(j + 2) * WA_HD + lane];
    const float v3 = Vs[(j + 3) * WA_HD + lane];
#pragma unroll
    for (int r = 0; r < WA_QT / WA_NWARPS; ++r) {
      const int i = warp + WA_NWARPS * r;
      if (i < QT) {
        const float4 p = *reinterpret_cast<const float4*>(S + i * L + j);
        acc[r] = fmaf(p.x, v0, fmaf(p.y, v1, fmaf(p.z, v2, fmaf(p.w, v3, acc[r]))));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < WA_QT / WA_NWARPS; ++r) {
    const int i = warp + WA_NWARPS * r;
    if (i < QT) out[head + (size_t)(q0 + i) * WA_HD + lane] = from_f<T>(acc[r]);
  }
}

template <typename T, typename BT>
int launch_fused_window_attn(const void* q, const void* k, const void* v, const void* bias,
                             const void* scale, void* out, int B_, int H, int L, int nW,
                             cudaStream_t st) {
  const int QT = L < WA_QT ? L : WA_QT;
  const size_t smem = wa_smem_floats(L, QT) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fused_window_attn_kernel<T, BT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(L / QT, H, B_);
  fused_window_attn_kernel<T, BT><<<grid, WA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const BT*>(bias), static_cast<const float*>(scale), static_cast<T*>(out),
      H, L, nW);
  return (int)cudaGetLastError();
}

}  // namespace

// dt_code (q, k, v, out): 0 = float32, 1 = bfloat16; bias_f32: the bias is
// float32 (else bfloat16)
extern "C" int fused_window_attn(const void* q, const void* k, const void* v, const void* bias,
                                 const void* scale, void* out, int B_, int H, int L, int nW,
                                 int dt_code, int bias_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt_code == 1) {
    if (bias_f32)
      return launch_fused_window_attn<bf16, float>(q, k, v, bias, scale, out, B_, H, L, nW, st);
    return launch_fused_window_attn<bf16, bf16>(q, k, v, bias, scale, out, B_, H, L, nW, st);
  }
  if (bias_f32)
    return launch_fused_window_attn<float, float>(q, k, v, bias, scale, out, B_, H, L, nW, st);
  return launch_fused_window_attn<float, bf16>(q, k, v, bias, scale, out, B_, H, L, nW, st);
}
