// Tensor-core core of the two SwinV2 window-attention forward kernels, bf16:
// swin_window_attn_fwd (fused_block.cu) and fused_window_attn
// (window_attention.cu).
//
// One warp computes the attention of 16 query rows against the whole window
// of L keys (L = 16, 64 or 256), head dim 32:
//   * q.k^T through mma.sync m16n8k16 (bf16 in, f32 accumulators), the
//     whole [16, L] score block kept in registers in the m16n8 accumulator
//     layout (L/8 tiles of 4 f32 per thread: 128 at L=256). k comes from
//     shared memory by ldmatrix (row-major [key][hd] is the "col" B operand);
//   * the scores scaled per row (and per key column where the caller asks),
//     the bias added in the same layout from the block's bias rows, which
//     the caller stages in shared memory by cp.async (rows of L + 8
//     elements: the 8 rows a quad-strided read touches fall in distinct
//     banks);
//   * the row max and the row sum over the quad of lanes that holds a row
//     (__shfl_xor_sync 1, 2), e = ex2.approx(s log2e - m log2e) (one fma;
//     the argument within 2^-23 |m log2e| of (s - m) log2e and ex2.approx
//     within 2 ulp, so e within 1e-5 relative of exp(s - m) at |m| <= 116),
//     p = e * (1 / sum) (within one f32 ulp of e / sum), rounded to bf16 and
//     packed straight into the A fragments of the p.v mma: the C layout of
//     m16n8 is the A layout of m16n8k16, so p never touches shared memory;
//   * v from shared memory by ldmatrix.trans; the output [16, 32] in f32
//     accumulators (4 tiles of 4 per thread), rounded once by the caller.
// No online softmax: a row fits in registers at L <= 256 (the full-row
// variant; no two-pass), and the plain versions' rounding points (p rounded
// to bf16 before p.v, the output once) stay where they are. The three steps
// are separate functions so that the caller can wait for the bias and for v
// (later cp.async groups) between them.
//
// Both kernels give each block one (query tile, head, window) and a group of
// the images that share its bias rows (images_per_group): the bias rows are
// staged once and stay in shared memory while the block walks the images,
// as the TPU grid keeps the bias block in VMEM; the next image's q and k
// are fetched while the block works on the current image's p.v (and, in
// fused_window_attn, its softmax), and its v while it works on the next
// image's scores.
//
// q, k and v tiles are [rows][32] bf16 in shared memory with their four
// 16-byte chunks XOR-swizzled per row pair (swz), so the eight rows an
// ldmatrix phase reads fall in distinct banks without padding.

#pragma once

#include "common.cuh"

namespace {

constexpr int WC_HD = 32;          // head dim
constexpr int WC_ROWS = 16;        // query rows per warp
constexpr int WC_BIAS_PAD = 8;     // bias rows in shared memory: L + 8 elements
constexpr float WC_LOG2E = 1.4426950408889634f;

// warps per block: 4 (64 query rows) at L >= 64, one at L = 16
template <int L> __host__ __device__ constexpr int wc_warps() { return L >= 64 ? 4 : 1; }

// element offset of 16-byte chunk `chunk` (0..3) of row `row` in a [rows][32]
// bf16 tile: the chunks of a row are XOR-swizzled by (row / 2) % 4, so the
// eight rows an ldmatrix phase reads fall in distinct banks
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * WC_HD + ((chunk ^ ((row >> 1) & 3)) << 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the two bf16 of a word, low half first, widened to f32 (exact)
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// 2^x by the SFU: ex2.approx.ftz.f32, the instruction behind exp2f (2 ulp in
// the CUDA programming guide's table). A result below 2^-126 flushes to 0:
// a weight under 2^-126 of the row's largest, which moves no output by as
// much as one f32 ulp of the output.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// two adjacent values of a bias row in shared memory, widened to f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}

// A fragments of 16 rows x 32 head dims from a swizzled tile whose first row
// is a multiple of 8: qa[kk] covers head dims [16 kk, 16 kk + 16).
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[2][4], const bf16* Qs) {
  const int lane = threadIdx.x & 31;
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(qa[0], Qs + swz(r, lane >> 4));
  ldsm_x4(qa[1], Qs + swz(r, 2 + (lane >> 4)));
}

// sums of squares of this lane's two query rows (lane/4 and lane/4 + 8) over
// all 32 head dims: each lane of the quad holds 8 of a row's values
__device__ __forceinline__ float2 q_row_sumsq(const uint32_t (&qa)[2][4]) {
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(qa[kk][i]);
      if (i & 1) s1 += f.x * f.x + f.y * f.y;
      else s0 += f.x * f.x + f.y * f.y;
    }
  return make_float2(quad_sum(s0), quad_sum(s1));
}

// the 8 bf16 values of one 16-byte chunk and the sum of their squares over the
// quad of lanes that holds one 32-wide row (lanes 4i..4i+3, one chunk each)
__device__ __forceinline__ float chunk_row_sumsq(const bf16* chunk, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(chunk);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = unpack_bf16(w[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
    ss += v.x * v.x + v.y * v.y;
  }
  return quad_sum(ss);
}

// The attention of one warp's 16 query rows against the window's L keys, in
// three steps so that the caller can wait for the bias and for v between
// them (they arrive by cp.async while the previous step runs).
//
// 1. window_scores: s = q . k^T, with qa the A fragments of the rows' q (bf16,
//    as given to the product) and Ks the window's k, [L][32] bf16 swizzled.
template <int L>
__device__ __forceinline__ void window_scores(float (&s)[L / 8][4], const uint32_t (&qa)[2][4],
                                              const bf16* Ks) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < L / 8; ++j) {
    uint32_t kb[4];
    ldsm_x4(kb, Ks + swz(j * 8 + (lane & 7), lane >> 3));
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    mma_bf16(s[j], qa[0], kb[0], kb[1]);
    mma_bf16(s[j], qa[1], kb[2], kb[3]);
  }
}

// 2. window_softmax: s = s * mul_row (* col_mul[key] where COL_MUL) +
//    bias(r, c), where bias(r, c) is the float2 of keys c, c + 1 of the
//    warp's row r; e = exp(s - row max) and p = e * (1 / row sum) for this
//    lane's two rows (lane/4 and lane/4 + 8), rounded to bf16 and packed
//    into the A fragments of the p.v product (keys [16 kk, 16 kk + 16) are
//    score tiles 2 kk and 2 kk + 1), so the f32 scores die here.
template <int L, bool COL_MUL, class Bias>
__device__ __forceinline__ void window_softmax(float (&s)[L / 8][4], float mul0, float mul1,
                                               const float* col_mul, const Bias& bias,
                                               uint32_t (&p)[L / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < L / 8; ++j) {
    const int c = j * 8 + 2 * t;
    float a0 = mul0, a1 = mul0, b0 = mul1, b1 = mul1;
    if (COL_MUL) {
      const float2 cm = *reinterpret_cast<const float2*>(col_mul + c);
      a0 *= cm.x;
      a1 *= cm.y;
      b0 *= cm.x;
      b1 *= cm.y;
    }
    const float2 r0 = bias(g, c), r1 = bias(g + 8, c);
    s[j][0] = s[j][0] * a0 + r0.x;
    s[j][1] = s[j][1] * a1 + r0.y;
    s[j][2] = s[j][2] * b0 + r1.x;
    s[j][3] = s[j][3] * b1 + r1.y;
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  // exp(s - m) = exp2(s log2e - m log2e), one fma per score
  const float n0 = -quad_max(m0) * WC_LOG2E, n1 = -quad_max(m1) * WC_LOG2E;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < L / 8; ++j) {
    s[j][0] = ex2(fmaf(s[j][0], WC_LOG2E, n0));
    s[j][1] = ex2(fmaf(s[j][1], WC_LOG2E, n0));
    s[j][2] = ex2(fmaf(s[j][2], WC_LOG2E, n1));
    s[j][3] = ex2(fmaf(s[j][3], WC_LOG2E, n1));
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
  const float inv0 = 1.0f / quad_sum(sum0), inv1 = 1.0f / quad_sum(sum1);
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk) {
    p[kk][0] = pack_bf16(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0);
    p[kk][1] = pack_bf16(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1);
    p[kk][2] = pack_bf16(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0);
    p[kk][3] = pack_bf16(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1);
  }
}

// 3. window_pv: o = p . v, with Vs the window's v, [L][32] bf16 swizzled; o
//    is [4 head-dim tiles of 8][4] f32 in the C layout.
template <int L>
__device__ __forceinline__ void window_pv(const uint32_t (&p)[L / 16][4], const bf16* Vs,
                                          float (&o)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, Vs + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 np * 2 + (lane >> 4)));
      mma_bf16(o[2 * np], p[kk], vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], p[kk], vb[2], vb[3]);
    }
  }
}

// bias(r, c) of window_softmax: keys c, c + 1 of row r of the warp's bias
// rows in shared memory (row stride ld), and with TWO the same of a second
// set of rows added (the shift mask beside the relative-position bias)
template <typename T, bool TWO = false>
struct SmemBias {
  const T* rows;
  const T* rows2;
  int ld;
  __device__ __forceinline__ float2 operator()(int r, int c) const {
    float2 v = load2(rows + r * ld + c);
    if (TWO) {
      const float2 m = load2(rows2 + r * ld + c);
      v.x += m.x;
      v.y += m.y;
    }
    return v;
  }
};

// cp.async of the 4 chunks of 16 bytes of `rows` rows of 32 bf16, `src_ld`
// apart in device memory, into a swizzled [rows][32] tile
template <int THREADS>
__device__ __forceinline__ void fetch_rows(bf16* dst, const bf16* src, int rows, int src_ld) {
  for (int c = threadIdx.x; c < rows * 4; c += THREADS)
    cp_async16(dst + swz(c >> 2, c & 3), src + (size_t)(c >> 2) * src_ld + (c & 3) * 8, true);
}

// the same for gathered rows: chunk threadIdx.x + i * THREADS of the tile
// comes from src + off[i]
template <int THREADS, int N>
__device__ __forceinline__ void gather_rows(bf16* dst, const bf16* src, const int (&off)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = threadIdx.x + i * THREADS;
    cp_async16(dst + swz(c >> 2, c & 3), src + off[i], true);
  }
}

constexpr int WC_MAX_DEVICES = 64;

// How many blocks of `kernel` the current device holds at once (blocks per
// SM at `threads` and `smem` times the SMs), after setting the kernel's
// dynamic shared memory to `smem`; a negated CUDA error on failure. The
// driver is asked once per device: `cache` is a function-local static of
// each launcher's instantiation, so a launch makes no driver query.
template <class Kernel>
int device_blocks(int (&cache)[WC_MAX_DEVICES], Kernel kernel, int threads, size_t smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev >= WC_MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (cache[dev] > 0) return cache[dev];
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return -(int)e;
  cache[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  return cache[dev];
}

// How many groups of images a launch splits its images into: enough blocks
// (`base` per group) to fill the device's `blocks` resident blocks, and as
// few groups as that allows, so that each block keeps its bias rows in
// shared memory for as many images as it can. Returns the images per group.
inline int images_per_group(int blocks, int base, int n_img) {
  int groups = blocks / base;
  groups = groups < 1 ? 1 : (groups > n_img ? n_img : groups);
  return (n_img + groups - 1) / groups;
}

// cp.async of `rows` rows of `cols` elements of T (cols * sizeof(T) a
// multiple of 16) from rows `src_stride` apart into rows `dst_stride` apart
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dst_stride, const T* src,
                                           size_t src_stride, int rows, int cols,
                                           int tid, int nthreads) {
  constexpr int PER = 16 / sizeof(T);
  const int chunks = cols / PER;
  for (int c = tid; c < rows * chunks; c += nthreads) {
    const int r = c / chunks, k = (c % chunks) * PER;
    cp_async16(dst + r * dst_stride + k, src + r * src_stride + k, true);
  }
}

}  // namespace
