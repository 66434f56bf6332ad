// Multi-tensor kernels of the train step's update for Hopper (sm_90a): the
// kernels behind cs_vit_tpu_torch/ops/multi_tensor.py (squares, clip_, adamw_).
//
// Replaces no TPU kernel. JAX's train step (cs_vit_tpu/train/step.py) runs
// optax's global-norm clip and AdamW inside its jitted graph, where XLA fuses
// them over every leaf. The port's eager step issued them leaf by leaf: three
// launches a leaf for the sum of squares, three for the clip's scaling, and
// torch.optim.AdamW's foreach launches, about 4,600 a step at the poser
// step's 651 trained leaves, with a host sync on the clip's branch between
// them. Here each pass is one launch over a table of every leaf:
//   squares  the sums of g^2 over the replicated and over the sharded leaves
//            (tensor parallelism: the table holds the replicated ones first)
//            and sqrt of the whole. Each block writes its partial sums in
//            f64; a second launch of one block adds them in a fixed order, so
//            the result is the same bits on every run (no atomics).
//   clip     optax's select, g = norm < max ? g : g / norm * max, in place,
//            the norm read from device memory: no host branch, no sync. A
//            NaN norm takes the scaling side, as the host's branch did; a
//            norm under the limit ends every block before it reads a byte.
//   adamw    torch.optim.AdamW's arithmetic in its order, f32:
//            p *= 1 - lr wd; m = lerp(m, g, 1 - b1); v = b2 v + (1 - b2) g^2;
//            p += -lr / bc1 * (m / (sqrt(v) / sqrt(bc2) + eps)),
//            lr, the betas, eps, wd and the bias corrections as scalars.
// The sum and the clip take each grad's elements in memory order, so any
// dense layout will do. AdamW pairs g with p, m and v element by element: a
// grad stored transposed (the weight grads the block kernels' backward
// gives, a [C, R] buffer seen as [R, C]) goes by 32 x 32 tiles through shared
// memory, so that its reads stay coalesced.
//
// What bounds them: bytes. At the poser step's 193.0 M trained elements the
// sum reads g (0.77 GB), the clip reads and writes it (1.54 GB), AdamW reads
// p, g, m, v and writes p, m, v (5.40 GB): 2.3 ms at 3.35 TB/s. Design for
// that: the table travels by value as the kernel's parameter (up to 32 KB of
// them since CUDA 12.1; __grid_constant__, so no thread copies it), so no
// copy to the card precedes a launch and a fresh gradient's pointer costs
// nothing. Each leaf is cut into chunks of MT_CHUNK elements; a grid of as
// many blocks as the card keeps resident walks the chunks of all leaves
// (block b takes chunks b, b + grid, ...), finding a chunk's leaf by a binary
// search of the table's prefix of chunk counts. A leaf whose arrays all lie
// on 16 bytes moves float4s; any other leaf, and a leaf's last ragged
// elements, one float at a time. A table longer than one launch's parameters
// hold goes over several launches; the sum's partials then add up across
// them in launch order.
//
// Plain C interface for ctypes. Each entry point returns the first cudaError
// of its launches; it launches on the caller's stream, allocates nothing and
// does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MT_THREADS = 256;
constexpr int MT_WARPS = MT_THREADS / 32;
constexpr int MT_BLOCKS_PER_SM = 8;    // 2048 threads an SM: the card's most
constexpr long long MT_CHUNK = 16384;  // elements of a leaf a block takes at once
#if CUDART_VERSION >= 12010
constexpr int MT_PARAM_BYTES = 32000;  // a launch's parameters: 32,764 bytes at most
#else
constexpr int MT_PARAM_BYTES = 4000;   // 4,096 before CUDA 12.1
#endif

constexpr int MT_TILE = 32;            // a transposed grad's tiles: 32 x 32
constexpr int MT_TILES = MT_CHUNK / (MT_TILE * MT_TILE);  // tiles a chunk

// A launch's slice of the table: DEPTH arrays a leaf (the leaf's element
// count in n), leaf i's chunks [first[i], first[i + 1]). rows[i] > 0: AdamW's
// leaf i is [rows, n / rows] row-major and its grad (column 1) is stored
// transposed, [n / rows, rows] row-major; its chunks are runs of MT_TILES
// tiles.
template <int DEPTH>
struct Table {
  static constexpr int CAP = (MT_PARAM_BYTES - 64) / (DEPTH * 8 + 8 + 4 + 4);
  float* ptr[DEPTH][CAP];
  long long n[CAP];
  int rows[CAP];
  int first[CAP + 1];
  int count;
};

struct AdamwScalars {
  float decay;     // 1 - lr wd
  float w1;        // 1 - b1, lerp's weight
  float b2;
  float omb2;      // 1 - b2
  float bc2_sqrt;  // sqrt(1 - b2^t)
  float eps;
  float neg_step;  // -lr / (1 - b1^t)
};

// The leaf of chunk c: the last whose first chunk is at or before c.
template <int DEPTH>
__device__ __forceinline__ int leaf_of(const Table<DEPTH>& t, int c) {
  int i = 0, hi = t.count - 1;
  while (i < hi) {
    const int mid = (i + hi + 1) >> 1;
    if (t.first[mid] <= c) i = mid; else hi = mid - 1;
  }
  return i;
}

// Calls vec(j) for each float4 at element j of leaf i in its chunk c, one a
// thread in turn, and one(j) for each element left.
template <int DEPTH, class Vec, class One>
__device__ __forceinline__ void walk(const Table<DEPTH>& t, int i, int c, Vec vec, One one) {
  const long long lo = (long long)(c - t.first[i]) * MT_CHUNK;
  const long long end = min(lo + MT_CHUNK, t.n[i]);
  uintptr_t bits = 0;
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) bits |= reinterpret_cast<uintptr_t>(t.ptr[d][i]);
  long long rest = lo;  // lo is a multiple of 4: a 16-byte leaf stays on 16 bytes
  if ((bits & 15) == 0) {
    rest = lo + ((end - lo) & ~3LL);
    for (long long j = lo + 4 * threadIdx.x; j < rest; j += 4 * MT_THREADS) vec(j);
  }
  for (long long j = rest + threadIdx.x; j < end; j += MT_THREADS) one(j);
}

__device__ __forceinline__ double block_sum(double v, double* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // smem may still be read from a previous call
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < MT_WARPS; ++w) s += smem[w];  // fixed order
  return s;
}

__global__ void __launch_bounds__(MT_THREADS)
squares_kernel(const __grid_constant__ Table<1> t, int replicated, double* partials,
               int accumulate) {
  __shared__ double smem[MT_WARPS];
  double rep = 0.0, shard = 0.0;
  const int chunks = t.first[t.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    double s = 0.0;
    const int i = leaf_of(t, c);
    const float* g = t.ptr[0][i];
    walk(
        t, i, c,
        [&](long long j) {
          const float4 x = *reinterpret_cast<const float4*>(g + j);
          s = fma((double)x.x, (double)x.x, s);
          s = fma((double)x.y, (double)x.y, s);
          s = fma((double)x.z, (double)x.z, s);
          s = fma((double)x.w, (double)x.w, s);
        },
        [&](long long j) { s = fma((double)g[j], (double)g[j], s); });
    if (i < replicated) rep += s; else shard += s;
  }
  rep = block_sum(rep, smem);
  shard = block_sum(shard, smem);
  if (threadIdx.x == 0) {
    double* r = partials + blockIdx.x;
    double* h = partials + gridDim.x + blockIdx.x;
    *r = (accumulate ? *r : 0.0) + rep;
    *h = (accumulate ? *h : 0.0) + shard;
  }
}

__global__ void __launch_bounds__(MT_THREADS)
squares_finish_kernel(const double* partials, int blocks, float* out) {
  __shared__ double smem[MT_WARPS];
  double rep = 0.0, shard = 0.0;
  for (int k = threadIdx.x; k < blocks; k += MT_THREADS) {
    rep += partials[k];
    shard += partials[blocks + k];
  }
  rep = block_sum(rep, smem);
  shard = block_sum(shard, smem);
  if (threadIdx.x == 0) {
    out[0] = (float)rep;
    out[1] = (float)shard;
    out[2] = (float)sqrt(rep + shard);
  }
}

__device__ __forceinline__ float clipped(float g, float norm, float max_norm) {
  return g / norm * max_norm;
}

__global__ void __launch_bounds__(MT_THREADS)
clip_kernel(const __grid_constant__ Table<1> t, const float* norm_p, float max_norm) {
  const float norm = *norm_p;
  if (norm < max_norm) return;  // the grads stay as they are
  const int chunks = t.first[t.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int i = leaf_of(t, c);
    float* g = t.ptr[0][i];
    walk(
        t, i, c,
        [&](long long j) {
          float4 x = *reinterpret_cast<float4*>(g + j);
          x.x = clipped(x.x, norm, max_norm);
          x.y = clipped(x.y, norm, max_norm);
          x.z = clipped(x.z, norm, max_norm);
          x.w = clipped(x.w, norm, max_norm);
          *reinterpret_cast<float4*>(g + j) = x;
        },
        [&](long long j) { g[j] = clipped(g[j], norm, max_norm); });
  }
}

// one element of AdamW, in torch.optim.AdamW's order (its foreach path:
// _foreach_mul_, _foreach_lerp_, _foreach_mul_ and _foreach_addcmul_,
// _foreach_sqrt, _foreach_div_, _foreach_add_, _foreach_addcdiv_)
__device__ __forceinline__ void adamw_one(float& p, float g, float& m, float& v,
                                          AdamwScalars s) {
  p = p * s.decay;
  m = s.w1 < 0.5f ? m + s.w1 * (g - m) : g - (g - m) * (1.0f - s.w1);  // torch's lerp
  v = v * s.b2;
  v = v + s.omb2 * (g * g);
  const float denom = sqrtf(v) / s.bc2_sqrt + s.eps;
  p = p + s.neg_step * (m / denom);
}

__global__ void __launch_bounds__(MT_THREADS)
adamw_kernel(const __grid_constant__ Table<4> t, const AdamwScalars s) {
  __shared__ float tile[MT_TILE][MT_TILE + 1];  // a transposed grad's tile
  const int chunks = t.first[t.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int i = leaf_of(t, c);
    float* p = t.ptr[0][i];
    const float* g = t.ptr[1][i];
    float* m = t.ptr[2][i];
    float* v = t.ptr[3][i];
    if (t.rows[i] == 0) {
      walk(
          t, i, c,
          [&](long long j) {
            float4 p4 = *reinterpret_cast<float4*>(p + j);
            const float4 g4 = *reinterpret_cast<const float4*>(g + j);
            float4 m4 = *reinterpret_cast<float4*>(m + j);
            float4 v4 = *reinterpret_cast<float4*>(v + j);
            adamw_one(p4.x, g4.x, m4.x, v4.x, s);
            adamw_one(p4.y, g4.y, m4.y, v4.y, s);
            adamw_one(p4.z, g4.z, m4.z, v4.z, s);
            adamw_one(p4.w, g4.w, m4.w, v4.w, s);
            *reinterpret_cast<float4*>(p + j) = p4;
            *reinterpret_cast<float4*>(m + j) = m4;
            *reinterpret_cast<float4*>(v + j) = v4;
          },
          [&](long long j) { adamw_one(p[j], g[j], m[j], v[j], s); });
      continue;
    }
    // A grad stored transposed (the weight grad of a product with the
    // weight's transpose): p is [R, C], g's storage [C, R]. A tile of g is
    // read along its rows into shared memory, then read across them beside
    // p's tile, so every access to device memory is coalesced.
    const int R = t.rows[i];
    const int C = (int)(t.n[i] / R);
    const int tiles_c = (C + MT_TILE - 1) / MT_TILE;
    const int tiles = (R + MT_TILE - 1) / MT_TILE * tiles_c;
    const int x = threadIdx.x % MT_TILE, y = threadIdx.x / MT_TILE;
    for (int k = (c - t.first[i]) * MT_TILES; k < tiles && k < (c - t.first[i] + 1) * MT_TILES;
         ++k) {
      const int r0 = k / tiles_c * MT_TILE, c0 = k % tiles_c * MT_TILE;
      __syncthreads();  // the previous tile's reads are done
      for (int q = y; q < MT_TILE; q += MT_THREADS / MT_TILE)
        if (c0 + q < C && r0 + x < R) tile[q][x] = g[(long long)(c0 + q) * R + r0 + x];
      __syncthreads();
      for (int q = y; q < MT_TILE; q += MT_THREADS / MT_TILE) {
        if (r0 + q < R && c0 + x < C) {
          const long long j = (long long)(r0 + q) * C + c0 + x;
          adamw_one(p[j], tile[x][q], m[j], v[j], s);
        }
      }
    }
  }
}

// Fills `t` with the non-empty leaves of [from, n) that fit, columns `cols`;
// returns the index past the last leaf looked at. `replicated` (if given)
// gets how many of the slice's entries come from leaves under `n_rep`.
template <int DEPTH>
int fill(Table<DEPTH>& t, void* const* const* cols, const long long* sizes, int from, int n,
         const int* rows = nullptr, int n_rep = 0, int* replicated = nullptr) {
  t.count = 0;
  int chunks = 0, rep = 0, i = from;
  for (; i < n && t.count < Table<DEPTH>::CAP; ++i) {
    if (sizes[i] == 0) continue;
    for (int d = 0; d < DEPTH; ++d) t.ptr[d][t.count] = static_cast<float*>(cols[d][i]);
    const int r = rows ? rows[i] : 0;
    t.n[t.count] = sizes[i];
    t.rows[t.count] = r;
    t.first[t.count] = chunks;
    if (r) {
      const long long tiles = (r + MT_TILE - 1) / MT_TILE *
                              ((sizes[i] / r + MT_TILE - 1) / MT_TILE);
      chunks += (int)((tiles + MT_TILES - 1) / MT_TILES);
    } else {
      chunks += (int)((sizes[i] + MT_CHUNK - 1) / MT_CHUNK);
    }
    rep += i < n_rep;
    ++t.count;
  }
  t.first[t.count] = chunks;
  if (replicated) *replicated = rep;
  return i;
}

int resident_blocks() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * MT_BLOCKS_PER_SM;
}

int grid_for(int chunks) {
  const int resident = resident_blocks();
  return chunks < resident ? chunks : resident;
}

}  // namespace

extern "C" {

// The first launch's blocks (its partial sums): `partials` of mt_squares
// holds twice as many doubles.
int mt_squares_blocks(void) { return resident_blocks(); }

// out[0] = sum of g^2 over leaves [0, n_rep) of the table, out[1] over
// [n_rep, n), out[2] = sqrt(out[0] + out[1]); f32 leaves g[i] of sizes[i]
// elements; `partials`: 2 * mt_squares_blocks() doubles of scratch.
int mt_squares(int n, void* const* g, const long long* sizes, int n_rep, double* partials,
               float* out, cudaStream_t stream) {
  Table<1> t;
  const int blocks = resident_blocks();
  void* const* cols[1] = {g};
  int from = 0, launch = 0;
  do {
    int rep = 0;
    from = fill(t, cols, sizes, from, n, nullptr, n_rep, &rep);
    squares_kernel<<<blocks, MT_THREADS, 0, stream>>>(t, rep, partials, launch > 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++launch;
  } while (from < n);
  squares_finish_kernel<<<1, MT_THREADS, 0, stream>>>(partials, blocks, out);
  return cudaGetLastError();
}

// g[i] = norm < max_norm ? g[i] : g[i] / norm * max_norm, in place; `norm`
// one f32 on the card.
int mt_clip(int n, void* const* g, const long long* sizes, const float* norm, float max_norm,
            cudaStream_t stream) {
  Table<1> t;
  void* const* cols[1] = {g};
  for (int from = 0; from < n;) {
    from = fill(t, cols, sizes, from, n);
    const int chunks = t.first[t.count];
    if (chunks == 0) continue;
    clip_kernel<<<grid_for(chunks), MT_THREADS, 0, stream>>>(t, norm, max_norm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One AdamW update of leaves p[i] with grads g[i] and moments m[i], v[i]
// (f32, sizes[i] elements each), at the scalars given; rows[i] > 0: p[i] is
// [rows[i], sizes[i] / rows[i]] and g[i] its transpose's storage.
int mt_adamw(int n, void* const* p, void* const* g, void* const* m, void* const* v,
             const long long* sizes, const int* rows, float decay, float w1, float b2,
             float omb2, float bc2_sqrt, float eps, float neg_step, cudaStream_t stream) {
  Table<4> t;
  void* const* cols[4] = {p, g, m, v};
  const AdamwScalars s{decay, w1, b2, omb2, bc2_sqrt, eps, neg_step};
  for (int from = 0; from < n;) {
    from = fill(t, cols, sizes, from, n, rows);
    const int chunks = t.first[t.count];
    if (chunks == 0) continue;
    adamw_kernel<<<grid_for(chunks), MT_THREADS, 0, stream>>>(t, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
