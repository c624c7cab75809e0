// The serving engine's sampling core, written for Hopper (sm_90a), with a
// plain C launcher bound from Python with ctypes
// (paddle_tpu_torch/ops/sampling.py):
//
//   smp::sample_kernel  computes what paddle_tpu/serving/sampling.py
//                       sample_tokens computes, row by row. The JAX package
//                       runs it as XLA ops (it has no Pallas body); on the
//                       card it is one kernel so that a captured decode step
//                       stays one launch for it whatever its rows ask for: a
//                       graph cannot branch on device data the way the JAX
//                       step's lax.cond skips the sampled branch.
//
// Per row r of logits [R, V] (float32; the wrapper casts bf16/f16 first):
//   x = allowed[r] ? logits[r] : -inf   (allowed may be null: all True)
//   greedy = argmax(x), the first index on ties (NaN counts as largest)
//   temperature[r] <= 0: the token is greedy; the row stops there.
//   Otherwise, as the JAX function:
//   1. s = x / max(temperature, 1e-6)            (IEEE division)
//   2. lo0, hi0 = min, max of the finite s
//   3. top-k (k_eff = clip(top_k, 0, V) > 0): 64 bisections
//      mid = 0.5f * (lo + hi), ok = count(s >= mid) >= k_eff; s < lo -> -inf
//   4. probs = exp(s - max) / sum                (accurate expf)
//   5. top-p (0 < top_p < 1): 64 bisections over [lo0, hi0] with
//      ok = sum(probs where s > mid) >= top_p; keep s >= hi
//   6. cum = inclusive prefix sum of the kept probs in vocabulary order
//   7. u = max(uniform(fold_in(PRNGKey(seed), position)), 1e-12), threefry
//      bit-equal to jax.random (see positional_uniform)
//   8. token = min(count(cum < u * cum[V-1]), V - 1)
//   A row with no finite entry gives token 0, as the JAX function does (its
//   cum is NaN or 0, and nothing is below the draw).
//
// The counts of steps 3 and 8 are integers, so the top-k threshold is exact
// in any order. The softmax denominator, the top-p mass and the prefix sum
// are float32 sums taken in another order than XLA's and the plain version's;
// a token can differ only where a draw lands within a few ulps of a boundary
// of cum. The prefix sum is kept non-decreasing: each thread scans a
// contiguous chunk from its offset, and a max-scan over the chunks repairs
// an offset that rounding left an ulp below the previous chunk's end (a dip
// there would move the count past zero-probability entries). Each launch
// takes the same order, so two launches give the same bits.
//
// Design: one block of 1024 threads per row. The row's s lives in dynamic
// shared memory (V floats: 201,216 bytes at V = 50304, under the 227 KB a
// block may hold); the probabilities, which steps 5 and 6 need beside s,
// go to a float32 workspace [R, V] that the wrapper allocates (L2-resident).
// Every reduction is a warp butterfly plus one pass over the 32 warp
// results. A greedy row costs one pass over its logits and mask; a sampled
// row up to 2 x 64 serial block reductions.
//
// Bound on an H100 SXM: the logits and the mask are read once (2.0 MB at
// 8 x 50304), 0.0006 ms at 3.35 TB/s; a sampled row's bisections are about
// 130 passes over V on the CUDA cores. With one block per row the kernel
// uses R of the 132 SMs and runs its reductions one after another: known
// costs, left for a redesign (a row split across a cluster, or a radix
// select in place of the bisections).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace smp {

constexpr int kThreads = 1024;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;  // == kWarp: one pass over warps
constexpr int kSteps = 64;                // bisection steps, as the JAX code
constexpr int kLoads = 8;                 // loads in flight in the first pass
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kWarps == kWarp, "block reductions read one value per lane");

// ------------------------------------------------------------ threefry

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, as jax/_src/prng.py threefry_2x32: counters
// (x0, x1) are hashed in place under key (k1, k2).
__device__ void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x0,
                             uint32_t& x1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[g & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
}

// max(jax.random.uniform(fold_in(PRNGKey(seed), position)), 1e-12f):
// PRNGKey of an int32 seed is (0, uint32(seed)); fold_in hashes the counters
// (0, uint32(position)) under it; a scalar draw hashes the counters (0, 0)
// under the folded key and xors the two words (threefry_partitionable); the
// top 23 bits become the mantissa of a float in [1, 2), minus 1.
__device__ float positional_uniform(int seed, int position) {
  uint32_t a = 0u, b = static_cast<uint32_t>(position);
  threefry2x32(0u, static_cast<uint32_t>(seed), a, b);
  uint32_t c = 0u, d = 0u;
  threefry2x32(a, b, c, d);
  const float f = __uint_as_float(((c ^ d) >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(f, 1e-12f);
}

// ------------------------------------------------------ block reductions

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Every thread gets the block's reduction of v. The leading barrier frees
// `sh` from the previous reduction's readers.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* sh, Op op) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  v = warp_reduce(v, op);
  __syncthreads();
  if (lane == 0) sh[w] = v;
  __syncthreads();
  return warp_reduce(sh[lane], op);
}

// (a, ia) comes before (b, ib) in jnp.argmax's order: larger, NaN largest,
// the smaller index among equals.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (na || a == b) return ia < ib;
  return a > b;
}

__device__ int block_argmax(float v, int i, float* shv, int* shi) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (before(ov, oi, v, i)) v = ov, i = oi;
  }
  __syncthreads();
  if (lane == 0) shv[w] = v, shi[w] = i;
  __syncthreads();
  v = shv[lane];
  i = shi[lane];
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (before(ov, oi, v, i)) v = ov, i = oi;
  }
  return i;
}

// Exclusive prefix over the threads in thread order: the sum (Sum, from 0)
// or the maximum (Max, from `identity`) of the values of the threads before.
template <typename Op>
__device__ float block_exclusive(float v, float identity, float* sh, Op op) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  float x = v;  // inclusive within the warp
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = op(x, y);
  }
  float excl = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) excl = identity;
  __syncthreads();
  if (lane == kWarp - 1) sh[w] = x;
  __syncthreads();
  float t = sh[lane];  // inclusive over the warps' totals
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float y = __shfl_up_sync(kFull, t, o);
    if (lane >= o) t = op(t, y);
  }
  const float before_warp = __shfl_sync(kFull, t, (w + kWarp - 1) % kWarp);
  return w == 0 ? excl : op(before_warp, excl);
}

// ------------------------------------------------------------- the kernel

__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ logits,
              const uint8_t* __restrict__ allowed,
              const float* __restrict__ temperature,
              const int* __restrict__ top_k, const float* __restrict__ top_p,
              const int* __restrict__ seeds,
              const int* __restrict__ positions, long long* __restrict__ out,
              float* __restrict__ u_out, float* __restrict__ work, int V) {
  extern __shared__ float s[];  // V floats: the row, then its scaled values
  __shared__ float shf[kWarps];
  __shared__ int shi[kWarps];
  const int r = blockIdx.x, t = threadIdx.x;
  const float* x = logits + static_cast<long long>(r) * V;
  const uint8_t* ok = allowed ? allowed + static_cast<long long>(r) * V
                              : nullptr;
  float* probs = work + static_cast<long long>(r) * V;

  // the masked row and its argmax; kLoads independent loads in flight per
  // thread (a greedy row is this pass alone, bound by load latency), the
  // thread's indices still visited in increasing order
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int base = t; base < V; base += kLoads * kThreads) {
    float v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = base + j * kThreads;
      v[j] = -INFINITY;
      if (i < V) {
        const float xv = x[i];
        v[j] = (ok && !ok[i]) ? -INFINITY : xv;
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = base + j * kThreads;
      if (i < V) {
        s[i] = v[j];
        if (before(v[j], i, bv, bi)) bv = v[j], bi = i;
      }
    }
  }
  const int greedy = block_argmax(bv, bi, shf, shi);
  const float temp = temperature[r];
  const float u = positional_uniform(seeds[r], positions[r]);
  if (t == 0 && u_out) u_out[r] = u;
  if (!(temp > 0.0f)) {
    if (t == 0) out[r] = greedy;
    return;  // the whole block: temp is the row's
  }

  // 1-2. scaled row and its finite range
  const float tdiv = fmaxf(temp, 1e-6f);
  float lo = INFINITY, hi = -INFINITY;
  for (int i = t; i < V; i += kThreads) {
    const float v = __fdiv_rn(s[i], tdiv);
    s[i] = v;
    if (isfinite(v)) lo = fminf(lo, v), hi = fmaxf(hi, v);
  }
  lo = block_reduce(lo, shf, Min());
  hi = block_reduce(hi, shf, Max());
  if (hi == -INFINITY) {  // no finite entry
    if (t == 0) out[r] = 0;
    return;
  }

  // 3. top-k: the k-th largest value by bisection on an integer count
  const int k_eff = min(max(top_k[r], 0), V);
  if (k_eff > 0) {
    float a = lo, b = hi;
    for (int step = 0; step < kSteps; ++step) {
      const float mid = 0.5f * (a + b);
      int n = 0;
      for (int i = t; i < V; i += kThreads) n += s[i] >= mid;
      if (block_reduce(n, shi, Sum()) >= k_eff) {
        a = mid;
      } else {
        b = mid;
      }
    }
    for (int i = t; i < V; i += kThreads)
      if (s[i] < a) s[i] = -INFINITY;
    __syncthreads();
  }

  // 4. softmax (the maximum is hi: top-k keeps the largest value)
  float den = 0.0f;
  for (int i = t; i < V; i += kThreads) {
    const float e = expf(s[i] - hi);
    probs[i] = e;
    den += e;
  }
  den = block_reduce(den, shf, Sum());
  for (int i = t; i < V; i += kThreads) probs[i] = __fdiv_rn(probs[i], den);

  // 5. top-p: the smallest kept value by bisection on the mass above it
  const float p = top_p[r];
  float p_thresh = -INFINITY;
  if (p > 0.0f && p < 1.0f) {
    float a = lo, b = hi;
    for (int step = 0; step < kSteps; ++step) {
      const float mid = 0.5f * (a + b);
      float mass = 0.0f;
      for (int i = t; i < V; i += kThreads)
        if (s[i] > mid) mass += probs[i];
      if (block_reduce(mass, shf, Sum()) >= p) {
        a = mid;
      } else {
        b = mid;
      }
    }
    p_thresh = b;
  }

  // 6. cum over contiguous chunks, one per thread, kept non-decreasing
  __syncthreads();  // the chunks read other threads' s and probs
  const int chunk = (V + kThreads - 1) / kThreads;
  const int i0 = min(t * chunk, V), i1 = min(i0 + chunk, V);
  float total = 0.0f;
  for (int i = i0; i < i1; ++i)
    if (s[i] >= p_thresh) total += probs[i];
  float run = block_exclusive(total, 0.0f, shf, Sum());
  for (int i = i0; i < i1; ++i) {
    if (s[i] >= p_thresh) run += probs[i];
    s[i] = run;  // this thread's own chunk: no other thread reads it
  }
  const float last = i1 > i0 ? run : -INFINITY;
  const float floor_ = block_exclusive(last, -INFINITY, shf, Max());
  for (int i = i0; i < i1; ++i) s[i] = fmaxf(s[i], floor_);
  const float cum_end = block_reduce(last, shf, Max());  // == cum[V-1]

  // 7-8. the inverse-CDF draw
  const float draw = u * cum_end;
  int n = 0;
  for (int i = i0; i < i1; ++i) n += s[i] < draw;
  n = block_reduce(n, shi, Sum());
  if (t == 0) out[r] = min(n, V - 1);
}

}  // namespace smp

// Launch the sampling kernel over R rows of V logits on `stream`; returns
// cudaGetLastError(). `allowed` and `u` may be null; `work` holds R x V
// floats. The wrapper checks shapes, types and V against the shared memory
// a block may take.
extern "C" int sample_tokens_launch(const void* logits, const void* allowed,
                                    const void* temperature,
                                    const void* top_k, const void* top_p,
                                    const void* seeds, const void* positions,
                                    void* tokens, void* u, void* work, int R,
                                    int V, void* stream) {
  if (R == 0) return 0;
  const size_t smem = static_cast<size_t>(V) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      smp::sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  smp::sample_kernel<<<R, smp::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const uint8_t*>(allowed),
      static_cast<const float*>(temperature), static_cast<const int*>(top_k),
      static_cast<const float*>(top_p), static_cast<const int*>(seeds),
      static_cast<const int*>(positions), static_cast<long long*>(tokens),
      static_cast<float*>(u), static_cast<float*>(work), V);
  return cudaGetLastError();
}
