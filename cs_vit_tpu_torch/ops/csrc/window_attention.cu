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
// What bounds it on the H100: bytes. At L=256 and hd=32 it does 4*L*hd FLOPs
// per query row against the 4*hd values of q, k, v and out it moves: 128
// FLOP/byte in bf16, under the card's ~295 at the tensor-core peak.
//
// bf16 (the timed path): the tensor-core core of window_attn_core.cuh, one
// warp per 16 query rows with its whole [16, L] score block in registers
// (the full-row variant, no two-pass: 190 registers with a bf16 bias, 195
// with an f32 one at L=256, no spill, per ptxas -v for sm_90a; 2 blocks of
// 4 warps per SM), 4 warps = 64 rows per block at L=256 and L=64, one warp
// at L=16, each block walking a group of the images that share its bias
// rows. q^ and k^ stay unrounded: the normalisation is a per-row and a
// per-key scalar, so s = (q . k) * (rsqrt_q * scale) * rsqrt_k, with q and
// k, bf16 as given, as exact mma operands and the dot product summed in f32. That is q^.k^ to f32 rounding, at one mma per score
// tile (a bf16 hi + lo split of q^ and k^ would take three, and carry a
// 2^-17 relative error per product). k and v of the window are staged once
// per image by cp.async as bf16, the keys' rsqrt beside them in f32. The
// block's bias rows are staged once in shared memory and serve every image
// of its group, as the TPU grid (window, head chunk, image) keeps the bias
// block in VMEM while it walks the images.
//
// f32 (the check path, dt_code 0; nothing times it): SIMT f32 math, one block
// per (query tile of 32 rows, head, window instance) with k^ (f32), v and the
// score tile in shared memory (about 101 KB at L=256).
//
// Plain C interface for ctypes. The entry point returns cudaGetLastError()
// right after its launch; it launches on the caller's stream, allocates
// nothing and does not synchronise.

#include "common.cuh"
#include "window_attn_core.cuh"

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

// ---------------------------------------------------------------------------
// bf16: tensor cores. Grid (query tile, image group, window * H + head): a
// block walks the images of its group for one (query tile, window, head).
// Shared memory: q of the block's rows, k and v of the window (swizzled
// bf16), the keys' rsqrt (f32) and the block's bias rows (padded, in the
// bias's dtype).
// ---------------------------------------------------------------------------

template <int L, typename BT>
__host__ __device__ constexpr size_t wa_tc_smem_bytes() {
  return (size_t)(WC_ROWS * wc_warps<L>() + 2 * L) * WC_HD * sizeof(bf16) + L * sizeof(float)
         + (size_t)WC_ROWS * wc_warps<L>() * (L + WC_BIAS_PAD) * sizeof(BT);
}

template <int L, typename BT>
__global__ void __launch_bounds__(32 * wc_warps<L>())
fused_window_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const BT* __restrict__ bias,
                            const float* __restrict__ scale, bf16* __restrict__ out,
                            int H, int nW, int n_img, int per_group) {
  constexpr int NWARP = wc_warps<L>(), THREADS = 32 * NWARP, QROWS = WC_ROWS * NWARP;
  constexpr int BLD = L + WC_BIAS_PAD;
  extern __shared__ __align__(16) unsigned char wc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(wc_smem);
  bf16* Ks = Qs + QROWS * WC_HD;
  bf16* Vs = Ks + L * WC_HD;
  float* Rk = reinterpret_cast<float*>(Vs + L * WC_HD);  // rsqrt(sum k^2 + 1e-24) per key
  BT* Bs = reinterpret_cast<BT*>(Rk + L);                // [QROWS][BLD] bias rows

  const int q0 = blockIdx.x * QROWS;
  const int img0 = blockIdx.y * per_group;
  const int img1 = min(n_img, img0 + per_group);
  const int w = blockIdx.z / H, h = blockIdx.z % H;
  const int tid = threadIdx.x, warp = tid >> 5;
  // q, k, v, out of window instance (image, w) and head h start at
  // img * img_ld + head
  const size_t head = ((size_t)w * H + h) * L * WC_HD, img_ld = (size_t)nW * H * L * WC_HD;

  // cp.async groups: q and k of an image, the bias rows (once), v of an
  // image. Every thread commits every group (empty past the last image), so
  // the wait counts below hold.
  fetch_rows<THREADS>(Qs, q + img0 * img_ld + head + (size_t)q0 * WC_HD, QROWS, WC_HD);
  fetch_rows<THREADS>(Ks, k + img0 * img_ld + head, L, WC_HD);
  cp_async_commit();
  stage_rows(Bs, BLD, bias + (((size_t)(nW == 1 ? 0 : w) * H + h) * L + q0) * L, L, QROWS, L,
             tid, THREADS);
  cp_async_commit();
  fetch_rows<THREADS>(Vs, v + img0 * img_ld + head, L, WC_HD);
  cp_async_commit();

  const float sc = scale[h];
  const SmemBias<BT> bias_at{Bs + warp * WC_ROWS * BLD, nullptr, BLD};
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  for (int img = img0; img < img1; ++img) {
    // pending: (bias, v) of the first image, else v of this one
    if (img == img0) cp_async_wait<2>();
    else cp_async_wait<1>();
    __syncthreads();  // q and k of this image
    // L * 4 is a multiple of THREADS, so every lane of a quad takes each step
    for (int c = tid; c < L * 4; c += THREADS) {
      float f[8];
      const float ss = chunk_row_sumsq(Ks + swz(c >> 2, c & 3), f);
      if ((c & 3) == 0) Rk[c >> 2] = rsqrtf(ss + 1e-24f);
    }
    uint32_t qa[2][4];
    load_q_frags(qa, Qs + warp * WC_ROWS * WC_HD);
    const float2 qss = q_row_sumsq(qa);
    float s[L / 8][4];
    window_scores<L>(s, qa, Ks);
    __syncthreads();  // every warp is done with q and k; Rk is written
    if (img + 1 < img1) {
      fetch_rows<THREADS>(Qs, q + (img + 1) * img_ld + head + (size_t)q0 * WC_HD, QROWS, WC_HD);
      fetch_rows<THREADS>(Ks, k + (img + 1) * img_ld + head, L, WC_HD);
    }
    cp_async_commit();
    if (img == img0) {
      cp_async_wait<2>();  // pending: v, next q and k
      __syncthreads();     // the bias rows
    }
    uint32_t pa[L / 16][4];
    window_softmax<L, true>(s, rsqrtf(qss.x + 1e-24f) * sc, rsqrtf(qss.y + 1e-24f) * sc, Rk,
                            bias_at, pa);
    cp_async_wait<1>();  // pending: next q and k
    __syncthreads();     // v of this image
    float o[4][4];
    window_pv<L>(pa, Vs, o);

    bf16* orow = out + img * img_ld + head + (size_t)(q0 + warp * WC_ROWS) * WC_HD;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(orow + g * WC_HD + c) = pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(orow + (g + 8) * WC_HD + c) = pack_bf16(o[n][2], o[n][3]);
    }
    __syncthreads();  // every warp is done with v and Rk
    if (img + 1 < img1) fetch_rows<THREADS>(Vs, v + (img + 1) * img_ld + head, L, WC_HD);
    cp_async_commit();
  }
}

template <int L, typename BT>
int launch_fused_window_attn_tc(const void* q, const void* k, const void* v, const void* bias,
                                const void* scale, void* out, int B_, int H, int nW,
                                cudaStream_t st) {
  constexpr int THREADS = 32 * wc_warps<L>(), TILES = L / (WC_ROWS * wc_warps<L>());
  constexpr size_t smem = wa_tc_smem_bytes<L, BT>();
  auto kernel = fused_window_attn_tc_kernel<L, BT>;
  static int resident[WC_MAX_DEVICES];
  const int blocks = device_blocks(resident, kernel, THREADS, smem);
  if (blocks < 0) return -blocks;
  const int n_img = B_ / nW;
  const int per_group = images_per_group(blocks, TILES * nW * H, n_img);
  dim3 grid(TILES, (n_img + per_group - 1) / per_group, nW * H);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const BT*>(bias), static_cast<const float*>(scale), static_cast<bf16*>(out),
      H, nW, n_img, per_group);
  return (int)cudaGetLastError();
}

template <typename BT>
int launch_fused_window_attn_bf16(const void* q, const void* k, const void* v, const void* bias,
                                  const void* scale, void* out, int B_, int H, int L, int nW,
                                  cudaStream_t st) {
  switch (L) {
    case 256: return launch_fused_window_attn_tc<256, BT>(q, k, v, bias, scale, out, B_, H, nW, st);
    case 64: return launch_fused_window_attn_tc<64, BT>(q, k, v, bias, scale, out, B_, H, nW, st);
    case 16: return launch_fused_window_attn_tc<16, BT>(q, k, v, bias, scale, out, B_, H, nW, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
      return launch_fused_window_attn_bf16<float>(q, k, v, bias, scale, out, B_, H, L, nW, st);
    return launch_fused_window_attn_bf16<bf16>(q, k, v, bias, scale, out, B_, H, L, nW, st);
  }
  if (bias_f32)
    return launch_fused_window_attn<float, float>(q, k, v, bias, scale, out, B_, H, L, nW, st);
  return launch_fused_window_attn<float, bf16>(q, k, v, bias, scale, out, B_, H, L, nW, st);
}
