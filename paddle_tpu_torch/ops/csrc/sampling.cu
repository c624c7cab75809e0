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
// Per row r of logits [R, V] (float32, bfloat16 or float16, converted to
// float32 on load: exact, so the values are those of .float()):
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
//   A row with no finite entry, or with a NaN or +inf, gives token 0, as the
//   JAX function does (its cum is NaN or 0, and nothing is below the draw).
//
// The bisections are not run over the row. Each predicate is monotone in
// mid, so it is a comparison with one threshold of the row:
//   top-k: count(s >= mid) >= k  <=>  mid <= K, K the k-th largest s (NaN
//          ranked below everything: it satisfies no >=);
//   top-p: mass{s > mid} >= p    <=>  mid < Vc, Vc the largest s with
//          mass{s >= Vc} >= p (-inf where the row's mass is below p).
// The kernel finds K and Vc exactly by radix select and then replays the 64
// steps on scalars, so its bracket is the JAX bracket step for step. A radix
// select alone is not the JAX function: where 64 halvings of [lo0, hi0] do
// not narrow to one float (values near 0 beside logits of +-10) the
// bisection keeps a set other than {s >= K}; the replay keeps that set.
//
// The counts of the top-k select and of step 8 are integers, and the top-p
// masses are summed as 64-bit fixed point (2^-52 units, integer atomics), so
// all of them are exact in any order. The softmax denominator and the prefix
// sum are float32 sums in a fixed order of their own (not XLA's or the plain
// version's): a token can differ only where a draw lands within a few ulps
// of a boundary of cum. The prefix sum is kept non-decreasing: each thread
// scans a contiguous chunk from its offset, and a max-scan over the chunks
// and over the cluster's ranks repairs an offset that rounding left an ulp
// below the previous chunk's end (a dip there would move the count past
// zero-probability entries). Every launch takes the same order, and the
// kernel's form (resident or not) depends on V and the card only, so two
// launches give the same bits and a row gives the same token alone ([1, V], a prefill) and in
// a batch (the decode step).
//
// Design: each row is split across a thread block cluster of C = kCluster =
// 8 CTAs, the largest portable cluster (grid C x R, cluster (C, 1, 1),
// launched with cudaLaunchKernelEx); CTA `rank` owns the contiguous slice
// [rank * slice, (rank + 1) * slice) of the row, slice = ceil(V / C) rounded
// up to 8, so vocabulary order survives for the scan. Cross-CTA reductions
// go through distributed shared memory: a small partial is pushed into a
// slot of every rank, a histogram or a candidate list is pulled from every
// rank, each after one cluster barrier, combined in rank order (or as
// integers), double-buffered so that no rank waits for readers. Resident
// form: each CTA keeps its slice of s and of the probabilities in shared
// memory (2 x slice floats: 50 KB at V = 50304; rows of up to about 196K
// logits on an H100). Where that does not fit, every pass reads its slice
// again from the logits (the row stays in L2). Each threshold select is one
// cluster pass over 256 buckets of equal width on [lo0, hi0] (monotone in
// s, so the shared-memory atomics rarely collide), then the crossing
// bucket's entries (a few at top-k 50) gathered into every CTA and sorted
// there, in a warp's registers up to 32 of them; a radix select over the
// keys, 8 bits a cluster pass, where the bucket holds more than 1024. The
// top-k gather also carries each rank's softmax denominator above the
// bucket. The prefix sum needs one exchange of the ranks' scan ends, and
// the rank whose span holds the draw writes the token. A greedy row costs
// one pass over its slice and one barrier; a sampled row at top-k 50 /
// top-p 0.95 six.
//
// Bound on an H100 SXM: the function reads the logits and the mask once and
// writes a token and a draw per row: at 8 x 50304, float32 logits 2.01 MB,
// 0.0006 ms at 3.35 TB/s; bf16 1.21 MB, 0.00036 ms; its float32 operations
// (about 25 per element) take less. The design reads each element from
// device memory once (the resident form) and spreads a row over C SMs; what
// remains is latency: the launch, the cluster barriers and the short
// passes between them (PERF.md has the measured breakdown), far above the
// bytes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace smp {

constexpr int kThreads = 512;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kSteps = 64;        // bisection steps, as the JAX code
constexpr int kBins = 256;        // radix digits of 8 bits
constexpr int kCluster = 8;       // CTAs a row is split across (portable)
constexpr int kVec = 8;           // elements per vector load; slice unit
constexpr int kGather = 1024;     // candidates a select gathers, at most
constexpr int kPerThread = kGather / kThreads > 0 ? kGather / kThreads : 1;
constexpr float kMassUnit = 4503599627370496.0f;  // 2^52: fixed-point mass
constexpr unsigned kFull = 0xFFFFFFFFu;
typedef unsigned long long u64;

static_assert(kWarps <= kWarp, "block reductions read one value per lane");
static_assert(kCluster <= kWarp, "cluster gathers read one rank per lane");
static_assert(kBins <= kThreads, "a thread per digit");
static_assert(kPerThread * kThreads >= kGather, "the candidates' scan");

// ------------------------------------------------------------ threefry

using rng::threefry2x32;  // threefry.cuh, shared with dropout.cu

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

// ------------------------------------------------------ loads and keys

// x / d and e / d, IEEE-rounded, for d > 0 finite: an infinite x or a zero e
// gives its own bits without the division's slow path (a masked row is
// almost all -inf, and its probabilities almost all 0).
__device__ __forceinline__ float scale_div(float x, float d) {
  return isinf(x) ? x : __fdiv_rn(x, d);
}
__device__ __forceinline__ float prob_div(float e, float d) {
  return e == 0.0f ? 0.0f : __fdiv_rn(e, d);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// Eight consecutive logits from a 16-byte-aligned address.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const T* h = reinterpret_cast<const T*>(&a);
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = to_f32(h[e]);
}

// Order-preserving 32-bit key of a float: larger float, larger key; -0 and
// +0 one key (they compare equal); NaN key 0, below -inf (NaN satisfies no
// >=, so it ranks last).
__device__ __forceinline__ uint32_t key_of(float v) {
  if (isnan(v)) return 0u;
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float value_of(uint32_t k) {
  if (k == 0u) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// ------------------------------------------------------ block reductions

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
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
__device__ T block_reduce(T v, T identity, T* sh, Op op) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  v = warp_reduce(v, op);
  __syncthreads();
  if (lane == 0) sh[w] = v;
  __syncthreads();
  return warp_reduce(lane < kWarps ? sh[lane] : identity, op);
}

// (a, ia) comes before (b, ib) in jnp.argmax's order: larger, NaN largest,
// the smaller index among equals.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (na || a == b) return ia < ib;
  return a > b;
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (before(ov, oi, v, i)) v = ov, i = oi;
  }
}

// The exclusive prefix over the threads in thread order of v (Sum from 0,
// or Max from -inf) and, in `total`, the block's reduction.
template <typename Op>
__device__ float block_exclusive(float v, float identity, float* sh, Op op,
                                 float& total) {
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
  float t = lane < kWarps ? sh[lane] : identity;  // over the warps' totals
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float y = __shfl_up_sync(kFull, t, o);
    if (lane >= o) t = op(t, y);
  }
  total = __shfl_sync(kFull, t, kWarps - 1);
  const float before_warp = __shfl_sync(kFull, t, (w + kWarp - 1) % kWarp);
  return w == 0 ? excl : op(before_warp, excl);
}

// ------------------------------------------------------------- cluster

// Every thread of every CTA of the cluster arrives; the arrive releases this
// thread's writes (shared memory of any rank), the wait acquires the others'.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// A CTA's partial of a small reduction: pushed into slot `rank` of every
// rank's `parts` before a barrier, read locally after it.
struct Part {
  float v;        // value of the argmax, or a float partial
  int i;          // index of the argmax
  float lo, hi;   // range of the finite s
  int bad;        // a NaN or +inf in s
};

struct Pick {
  int found;
  uint32_t digit;  // a bin, or a key
  u64 above;       // weight of the bins above the picked one
  unsigned count;  // entries in the picked bin
};

// Shared memory of the threshold selects.
struct Select {
  u64 hist[2][kBins];        // a cluster pass's weights per bin, pulled
  unsigned count[2][kBins];  // and its entries per bin
  u64 wscan[kWarps];
  uint32_t ckey[kGather];    // this rank's candidates, pulled by every rank
  u64 cwt[kGather];
  uint32_t gkey[kGather];    // the cluster's candidates
  u64 gwt[kGather];
  int ncand;
  Pick pick;
};

template <typename T, bool kResident>
struct Row {
  const T* x;           // this CTA's slice of the logits
  const uint8_t* ok;    // its slice of the mask, or null
  float tdiv, kth, hi, den;
  float* s;             // resident: the slice's s, then its probs' cum
  float* p;             // resident: the slice's probabilities

  __device__ __forceinline__ float logit(int j) const {
    const float v = to_f32(x[j]);
    return (ok && !ok[j]) ? -INFINITY : v;
  }
  // s after the top-k mask (kth is -inf before it)
  __device__ __forceinline__ float scaled(int j) const {
    if (kResident) return s[j];
    const float v = scale_div(logit(j), tdiv);
    return v < kth ? -INFINITY : v;
  }
  __device__ __forceinline__ float prob(int j, float sv) const {
    if (kResident) return p[j];
    return prob_div(expf(sv - hi), den);
  }
};

// The inclusive prefix of v over the threads in thread order (integers:
// exact). The leading barrier is the caller's.
__device__ u64 block_inclusive(u64 v, u64* wscan) {
  const int t = threadIdx.x, lane = t % kWarp, w = t / kWarp;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const u64 y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == kWarp - 1) wscan[w] = v;
  __syncthreads();
  for (int u = 0; u < w; ++u) v += wscan[u];
  return v;
}

// Thread t holds the weight h and the entries n of bin 255 - t (0 beyond
// the bins): the bin where the weight from the top first reaches want.
// Returns false where the weight never reaches it (the same in every rank).
// The caller has passed a barrier since the last pick was read.
__device__ bool pick_bin(Select& sel, u64 h, unsigned n, u64 want) {
  const int t = threadIdx.x;
  if (t == 0) sel.pick.found = 0;
  const u64 incl = block_inclusive(h, sel.wscan);
  const u64 above = incl - h;
  if (t < kBins && h != 0 && above < want && want <= incl)
    sel.pick = Pick{1, static_cast<uint32_t>(kBins - 1 - t), above, n};
  __syncthreads();
  return sel.pick.found;
}

// 256 buckets of equal width on [lo, hi], monotone in s (-inf in bucket 0).
struct Buckets {
  float lo, scale;
  __device__ Buckets(float lo_, float hi_)
      : lo(lo_), scale(hi_ > lo_ ? 256.0f / (hi_ - lo_) : 0.0f) {}
  __device__ __forceinline__ uint32_t operator()(float sv) const {
    const float x = (sv - lo) * scale;
    return x >= 255.0f ? 255u : (x > 0.0f ? static_cast<uint32_t>(x) : 0u);
  }
};

// One pass over the cluster's row: every entry of this rank's slice adds
// its weight to its bin (`elem(j, bin, weight)`; weight 0 adds nothing;
// kCounts: every weight is 1, and only the entries are counted); after a
// cluster barrier each thread of a bin sums it over the ranks (integers:
// any order) and pick_bin picks. The two buffers alternate: a rank zeroes
// the next pass's after this pass's barrier, when every rank has read it.
template <bool kCounts, typename F>
__device__ bool cluster_pass(Select& sel, int& pass, int n, u64 want,
                             F elem) {
  cg::cluster_group cl = cg::this_cluster();
  const int t = threadIdx.x;
  u64* hw = sel.hist[pass & 1];
  unsigned* hn = sel.count[pass & 1];
  for (int j = t; j < n; j += kThreads) {
    uint32_t bin;
    u64 wt;
    elem(j, bin, wt);
    if (wt) {
      if (!kCounts) atomicAdd(hw + bin, wt);
      atomicAdd(hn + bin, 1u);
    }
  }
  cluster_sync();
  ++pass;
  if (t < kBins) sel.hist[pass & 1][t] = 0, sel.count[pass & 1][t] = 0;
  if (t == 0) sel.ncand = 0;
  u64 h = 0;
  unsigned cnt = 0;
  if (t < kBins) {  // the ranks' bins loaded all at once
    u64 bw[kCluster];
    unsigned bn[kCluster];
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      bw[c] = !kCounts ? cl.map_shared_rank(hw, c)[kBins - 1 - t] : 0;
      bn[c] = cl.map_shared_rank(hn, c)[kBins - 1 - t];
    }
#pragma unroll
    for (int c = 0; c < kCluster; ++c) h += bw[c], cnt += bn[c];
  }
  return pick_bin(sel, kCounts ? cnt : h, cnt, want);
}

// What a select found.
struct Found {
  bool found;       // the row's weight reaches want
  uint32_t key;     // where it does
  int gathered;     // candidates sorted into sel.gkey (0: the radix select)
  uint32_t bucket;  // the crossing bucket
  const Part* xs;   // the gather's parts: each rank's `side` partial in v
};

// The key where the weight of the row's entries from the top first reaches
// want (`elem(j, s, weight)` over this rank's slice; NaN absent): one
// cluster pass over the buckets (spread, so the atomics rarely collide),
// then the crossing bucket's entries, at most kGather over the cluster,
// gathered into every rank and sorted there by key: up to 32 in each warp's
// registers, more in shared memory. `side(bucket)` is a block-wide partial
// that rides the gather's barrier. Where the bucket holds more, a radix
// select over the keys, 8 bits a cluster pass. Every rank finds the same.
template <bool kCounts, typename F, typename G>
__device__ Found select_key(Select& sel, Part (&parts)[2][kCluster],
                            int& pass, int& xpass, int rank, int n,
                            const Buckets& bucket, u64 want, F elem, G side) {
  cg::cluster_group cl = cg::this_cluster();
  const int t = threadIdx.x, lane = t % kWarp;
  Found res{false, 0u, 0, 0u, nullptr};
  if (!cluster_pass<kCounts>(sel, pass, n, want,
                             [&](int j, uint32_t& bin, u64& wt) {
                               float sv;
                               elem(j, sv, wt);
                               bin = bucket(sv);
                             }))
    return res;
  res.found = true;
  const uint32_t b0 = sel.pick.digit;
  const unsigned total = sel.pick.count;
  res.bucket = b0;
  if (total <= static_cast<unsigned>(kGather)) {
    const u64 rest = want - sel.pick.above;
    for (int j = t; j < n; j += kThreads) {
      float sv;
      u64 wt;
      elem(j, sv, wt);
      if (wt && bucket(sv) == b0) {
        const int i = atomicAdd(&sel.ncand, 1);
        sel.ckey[i] = key_of(sv);
        sel.cwt[i] = wt;
      }
    }
    __syncthreads();
    const float partial = side(b0);
    Part* xs = parts[xpass++ & 1];
    if (t < kCluster) {
      Part* q = cl.map_shared_rank(xs + rank, t);
      q->i = sel.ncand;
      q->v = partial;
    }
    cluster_sync();
    res.gathered = static_cast<int>(total);
    res.xs = xs;
    if (total <= static_cast<unsigned>(kWarp)) {
      // every warp: lane l takes candidate l in rank order, then a bitonic
      // sort in registers, descending by key (padding, key 0, last)
      uint32_t k = 0u;
      u64 w = 0;
      for (int c = 0, start = 0; c < kCluster; start += xs[c].i, ++c) {
        if (lane >= start && lane < start + xs[c].i) {
          k = cl.map_shared_rank(sel.ckey, c)[lane - start];
          w = cl.map_shared_rank(sel.cwt, c)[lane - start];
        }
      }
#pragma unroll
      for (int size = 2; size <= kWarp; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const uint32_t ok = __shfl_xor_sync(kFull, k, stride);
          const u64 ow = __shfl_xor_sync(kFull, w, stride);
          const bool first = (lane & stride) == 0, desc = (lane & size) == 0;
          if (first == desc ? ok > k : ok < k) k = ok, w = ow;
        }
      }
      u64 incl = w;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const u64 y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned at =
          __ballot_sync(kFull, w != 0 && incl >= rest && incl - w < rest);
      res.key = __shfl_sync(kFull, k, __ffs(at) - 1);
      if (t < kWarp) sel.gkey[lane] = k, sel.gwt[lane] = w;
      return res;
    }
    int off = 0;
    for (int c = 0; c < kCluster; ++c) {  // rank order
      const int m = xs[c].i;
      const uint32_t* rk = cl.map_shared_rank(sel.ckey, c);
      const u64* rw = cl.map_shared_rank(sel.cwt, c);
      for (int i = t; i < m; i += kThreads) {
        sel.gkey[off + i] = rk[i];
        sel.gwt[off + i] = rw[i];
      }
      off += m;
    }
    int P = 2 * kPerThread;
    while (P < off) P <<= 1;
    for (int i = off + t; i < P; i += kThreads) sel.gkey[i] = 0, sel.gwt[i] = 0;
    __syncthreads();
    // bitonic sort, descending by key (padding, key 0, sorts last)
    for (int size = 2; size <= P; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int q = t; q < P / 2; q += kThreads) {
          const int i = 2 * q - (q & (stride - 1)), j = i + stride;
          const uint32_t a = sel.gkey[i], b = sel.gkey[j];
          if (((i & size) == 0) ? a < b : a > b) {
            sel.gkey[i] = b, sel.gkey[j] = a;
            const u64 wa = sel.gwt[i];
            sel.gwt[i] = sel.gwt[j], sel.gwt[j] = wa;
          }
        }
        __syncthreads();
      }
    }
    // the first entry where the weight from the top reaches rest
    if (t == 0) sel.pick.found = 0;
    const int i0 = t * kPerThread;
    u64 mine = 0;
    for (int e = 0; e < kPerThread; ++e) mine += i0 + e < P ? sel.gwt[i0 + e] : 0;
    u64 run = block_inclusive(mine, sel.wscan) - mine;
    for (int e = 0; e < kPerThread && i0 + e < P; ++e) {
      const u64 w = sel.gwt[i0 + e];
      if (w && run < rest && rest <= run + w)
        sel.pick = Pick{1, sel.gkey[i0 + e], 0, 0};
      run += w;
    }
    __syncthreads();
    res.key = sel.pick.digit;
    return res;
  }
  uint32_t prefix = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    const uint32_t hmask = shift >= 24 ? 0u : (kFull << (shift + 8));
    cluster_pass<kCounts>(sel, pass, n, want,
                          [&](int j, uint32_t& bin, u64& wt) {
                            float sv;
                            elem(j, sv, wt);
                            const uint32_t k = key_of(sv);
                            bin = (k >> shift) & 0xFFu;
                            if ((k & hmask) != prefix) wt = 0;
                          });
    prefix |= sel.pick.digit << shift;
    want -= sel.pick.above;
  }
  res.key = prefix;
  return res;
}

// ------------------------------------------------------------- the kernel

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const T* __restrict__ logits,
              const uint8_t* __restrict__ allowed,
              const float* __restrict__ temperature,
              const int* __restrict__ top_k, const float* __restrict__ top_p,
              const int* __restrict__ seeds,
              const int* __restrict__ positions, long long* __restrict__ out,
              float* __restrict__ u_out, int V, int slice, int vec) {
  extern __shared__ float dyn[];  // resident: s[slice], p[slice]
  __shared__ Part parts[2][kCluster];
  __shared__ Select sel;
  __shared__ float shf[kWarps];
  __shared__ int shi[kWarps];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int r = blockIdx.y, t = threadIdx.x, lane = t % kWarp;
  const int i0 = min(rank * slice, V);
  const int n = min(slice, V - i0);
  // every rank has started before any rank touches another's shared memory
  cluster_arrive_relaxed();
  if (t < kBins) {  // both cluster-pass buffers, before the first pass
    sel.hist[0][t] = sel.hist[1][t] = 0;
    sel.count[0][t] = sel.count[1][t] = 0;
  }

  Row<T, kResident> row;
  row.x = logits + static_cast<long long>(r) * V + i0;
  row.ok = allowed ? allowed + static_cast<long long>(r) * V + i0 : nullptr;
  row.s = dyn;
  row.p = dyn + slice;
  row.kth = -INFINITY;
  const float temp = temperature[r];
  const bool sampled = temp > 0.0f;
  row.tdiv = fmaxf(temp, 1e-6f);
  // every thread draws u now, off the path of the barriers
  const float u = sampled || rank == 0 ? positional_uniform(seeds[r],
                                                            positions[r])
                                       : 0.0f;
  if (rank == 0 && t == 0 && u_out) u_out[r] = u;

  // the masked slice, its argmax and (sampled) its s and finite range
  float bv = -INFINITY, lo = INFINITY, hi = -INFINITY;
  int bi = INT_MAX, bad = 0;
  auto visit = [&](int j, float xv) {
    if (before(xv, i0 + j, bv, bi)) bv = xv, bi = i0 + j;
    if (sampled) {
      const float v = scale_div(xv, row.tdiv);
      if (kResident) row.s[j] = v;
      if (isfinite(v)) {
        lo = fminf(lo, v), hi = fmaxf(hi, v);
      } else if (!(v < 0.0f)) {
        bad = 1;  // NaN or +inf
      }
    }
  };
  if (vec) {  // 16-byte loads, two in flight per thread
    for (int j = t * kVec; j < n; j += 2 * kThreads * kVec) {
      const int j2 = j + kThreads * kVec;
      float a[kVec], b[kVec];
      uint2 ma = make_uint2(~0u, ~0u), mb = ma;
      load8(row.x + j, a);
      if (row.ok) ma = __ldg(reinterpret_cast<const uint2*>(row.ok + j));
      if (j2 < n) {
        load8(row.x + j2, b);
        if (row.ok) mb = __ldg(reinterpret_cast<const uint2*>(row.ok + j2));
      }
      const uint8_t* ka = reinterpret_cast<const uint8_t*>(&ma);
      const uint8_t* kb = reinterpret_cast<const uint8_t*>(&mb);
#pragma unroll
      for (int e = 0; e < kVec; ++e) visit(j + e, ka[e] ? a[e] : -INFINITY);
      if (j2 < n) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) visit(j2 + e, kb[e] ? b[e] : -INFINITY);
      }
    }
  } else {
    for (int j = t; j < n; j += kThreads) visit(j, row.logit(j));
  }
  // the CTA's partial: argmax, range, bad
  {
    const int w = t / kWarp;
    warp_argmax(bv, bi);
    lo = warp_reduce(lo, [](float a, float b) { return fminf(a, b); });
    hi = warp_reduce(hi, Max());
    bad = __any_sync(kFull, bad);
    __shared__ Part wpart[kWarps];
    if (lane == 0) wpart[w] = Part{bv, bi, lo, hi, bad};
    __syncthreads();
    if (t < kWarp) {
      Part q = lane < kWarps ? wpart[lane]
                             : Part{-INFINITY, INT_MAX, INFINITY, -INFINITY, 0};
      warp_argmax(q.v, q.i);
      q.lo = warp_reduce(q.lo, [](float a, float b) { return fminf(a, b); });
      q.hi = warp_reduce(q.hi, Max());
      q.bad = __any_sync(kFull, q.bad);
      cluster_wait();  // the start barrier: every rank is running
      // greedy: rank 0 alone reads the parts
      if (lane < (sampled ? kCluster : 1)) *cl.map_shared_rank(&parts[0][rank], lane) = q;
    } else {
      cluster_wait();
    }
  }
  cluster_sync();
  Part q = lane < kCluster ? parts[0][lane]
                    : Part{-INFINITY, INT_MAX, INFINITY, -INFINITY, 0};
  if (!sampled) {
    if (rank == 0 && t < kWarp) {
      warp_argmax(q.v, q.i);
      if (t == 0) out[r] = q.i;
    }
    return;  // no rank reads another after the barrier
  }
  // the whole cluster has the row's range: every warp combines the same
  // parts in the same order
  q.lo = warp_reduce(q.lo, [](float a, float b) { return fminf(a, b); });
  q.hi = warp_reduce(q.hi, Max());
  q.bad = __any_sync(kFull, q.bad);
  if (q.bad || q.hi == -INFINITY) {  // NaN, +inf, or no finite entry
    if (rank == 0 && t == 0) out[r] = 0;
    return;
  }
  lo = q.lo;
  hi = q.hi;
  row.hi = hi;
  int pass = 0, xpass = 1;  // cluster passes; small exchanges (parts[xpass & 1])

  // 3. top-k: K exactly, then the JAX bracket replayed on scalars
  const Buckets bucket(lo, hi);
  const int k_eff = min(max(top_k[r], 0), V);
  Found fk{false, 0u, 0, 0u, nullptr};
  float a = -INFINITY;
  if (k_eff > 0) {
    // the gather also carries each rank's denominator over the buckets
    // above the crossing one, which the cut keeps whole
    fk = select_key<true>(
        sel, parts, pass, xpass, rank, n, bucket, static_cast<u64>(k_eff),
        [&](int j, float& sv, u64& wt) {
          sv = row.scaled(j);
          wt = 1;
        },
        [&](uint32_t b0) {
          float d = 0.0f;
          for (int j = t; j < n; j += kThreads) {
            const float sv = row.scaled(j);
            if (bucket(sv) > b0) d += expf(sv - hi);
          }
          return block_reduce(d, 0.0f, shf, Sum());
        });
    const float K = value_of(fk.key);
    float b = hi;
    a = lo;
    for (int step = 0; step < kSteps; ++step) {
      const float mid = 0.5f * (a + b);
      if (mid <= K) {
        a = mid;
      } else {
        b = mid;
      }
    }
    if (kResident) {
      for (int j = t; j < n; j += kThreads)
        if (row.s[j] < a) row.s[j] = -INFINITY;
    } else {
      row.kth = a;
    }
  }

  // 4. softmax (the maximum is hi: top-k keeps the largest value); the
  // denominator in a fixed order over threads, then ranks. Where the cut
  // lies in the gathered bucket, the ranks' partials above it plus the
  // kept candidates (in key order), which every rank holds: no exchange.
  float den = 0.0f;
  for (int j = t; j < n; j += kThreads) {
    const float e = expf(row.scaled(j) - hi);
    if (kResident) row.p[j] = e;
    den += e;
  }
  if (fk.gathered && bucket(a) == fk.bucket) {
    __syncthreads();  // the sorted candidates
    float e = 0.0f;
    if (fk.gathered <= kWarp) {
      const float v = value_of(sel.gkey[lane]);
      e = lane < fk.gathered && v >= a ? expf(v - hi) : 0.0f;
      e = warp_reduce(e, Sum());
    } else {
      for (int i = t * kPerThread; i < (t + 1) * kPerThread; ++i) {
        const float v = value_of(sel.gkey[i]);
        if (i < fk.gathered && v >= a) e += expf(v - hi);
      }
      e = block_reduce(e, 0.0f, shf, Sum());
    }
    den = warp_reduce(lane < kCluster ? fk.xs[lane].v : 0.0f, Sum()) + e;
  } else {
    den = block_reduce(den, 0.0f, shf, Sum());
    Part* xs = parts[xpass++ & 1];
    if (t < kCluster) cl.map_shared_rank(xs + rank, t)->v = den;
    cluster_sync();
    den = warp_reduce(lane < kCluster ? xs[lane].v : 0.0f, Sum());
  }
  row.den = den;
  if (kResident)
    for (int j = t; j < n; j += kThreads) row.p[j] = prob_div(row.p[j], den);

  // 5. top-p: Vc exactly by a mass-weighted select, then the JAX bracket
  const float p = top_p[r];
  float pth = -INFINITY;
  if (p > 0.0f && p < 1.0f) {
    const u64 p_mass = __float2ull_rn(p * kMassUnit);
    const Found fp = select_key<false>(
        sel, parts, pass, xpass, rank, n, bucket, p_mass > 0 ? p_mass : 1,
        [&](int j, float& sv, u64& wt) {
          sv = row.scaled(j);
          wt = __float2ull_rn(row.prob(j, sv) * kMassUnit);
        },
        [](uint32_t) { return 0.0f; });
    const float vc = fp.found ? value_of(fp.key) : -INFINITY;
    float a = lo, b = hi;
    for (int step = 0; step < kSteps; ++step) {
      const float mid = 0.5f * (a + b);
      if (mid < vc) {
        a = mid;
      } else {
        b = mid;
      }
    }
    pth = b;
  }

  // 6. cum: each rank scans its slice from 0 over contiguous chunks, one
  // per thread (an odd stride: no bank conflicts), kept non-decreasing by a
  // max-scan over the chunks; one exchange of the ranks' scan ends, from
  // which every rank derives every rank's offset and end with the same
  // float ops; cum = max(offset + local cum, the ends of the ranks before)
  __syncthreads();  // the chunks read other threads' s and probs
  int chunk = (n + kThreads - 1) / kThreads;
  chunk += !(chunk & 1);
  const int j0 = min(t * chunk, n), j1 = min(j0 + chunk, n);
  float tot = 0.0f;
  for (int j = j0; j < j1; ++j) {
    const float sv = row.scaled(j);
    if (sv >= pth) tot += row.prob(j, sv);
  }
  float unused;
  const float excl = block_exclusive(tot, 0.0f, shf, Sum(), unused);
  float run = excl;
  for (int j = j0; j < j1; ++j) {
    const float sv = row.scaled(j);
    if (sv >= pth) run += row.prob(j, sv);
    if (kResident) row.s[j] = run;  // this thread's own chunk
  }
  float local_end;  // -inf for an empty slice
  const float floor_t = block_exclusive(j1 > j0 ? run : -INFINITY, -INFINITY,
                                        shf, Max(), local_end);
  Part* xs = parts[xpass++ & 1];
  if (t < kCluster) cl.map_shared_rank(xs + rank, t)->v = local_end;
  cluster_sync();  // the last barrier: no rank reads another after it
  // lane c: rank c's offset (an inclusive scan over the ranks before, in
  // rank order), end and floor (the largest end before it)
  const float lend = lane < kCluster ? xs[lane].v : -INFINITY;
  float x = lend == -INFINITY ? 0.0f : lend;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  x = __shfl_up_sync(kFull, x, 1);
  const float offset = lane == 0 ? 0.0f : x;
  const float end = lend == -INFINITY ? -INFINITY : offset + lend;
  float f = end;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float y = __shfl_up_sync(kFull, f, o);
    if (lane >= o) f = fmaxf(f, y);
  }
  const float cum_end = __shfl_sync(kFull, f, kWarp - 1);  // == cum[V-1]
  f = __shfl_up_sync(kFull, f, 1);
  const float floor_l = lane == 0 ? -INFINITY : f;

  // 7-8. the inverse-CDF draw: cum is non-decreasing, so every entry of the
  // ranks before the first rank whose end reaches the draw lies below it,
  // and none after; that rank counts its own and writes the token
  const float draw = u * cum_end;
  const unsigned reach = __ballot_sync(kFull, lane < kCluster && end >= draw);
  if (rank != (reach ? __ffs(reach) - 1 : kCluster - 1)) return;
  const float offset_c = __shfl_sync(kFull, offset, rank);
  const float floor_c = __shfl_sync(kFull, floor_l, rank);
  int cnt = 0;
  if (kResident) {
    for (int j = j0; j < j1; ++j)
      cnt += fmaxf(offset_c + fmaxf(row.s[j], floor_t), floor_c) < draw;
  } else {
    run = excl;
    for (int j = j0; j < j1; ++j) {
      const float sv = row.scaled(j);
      if (sv >= pth) run += row.prob(j, sv);
      cnt += fmaxf(offset_c + fmaxf(run, floor_t), floor_c) < draw;
    }
  }
  cnt = block_reduce(cnt, 0, shi, Sum());
  if (t == 0) out[r] = min(i0 + cnt, V - 1);
}

// Elements of one rank's slice: ceil(V / kCluster), rounded up to kVec.
inline int slice_len(int V) {
  const int per = (V + kCluster - 1) / kCluster;
  return (per + kVec - 1) / kVec * kVec;
}

typedef void (*Kernel)(const void*, const uint8_t*, const float*, const int*,
                       const float*, const int*, const int*, long long*,
                       float*, int, int, int);

template <typename T, bool kResident>
Kernel instance() {
  return reinterpret_cast<Kernel>(&sample_kernel<T, kResident>);
}

// dtype 0 float32, 1 bfloat16, 2 float16 (as paged_attention.py's codes)
inline Kernel pick_kernel(int dtype, bool resident) {
  switch (dtype) {
    case 0: return resident ? instance<float, true>() : instance<float, false>();
    case 1:
      return resident ? instance<__nv_bfloat16, true>()
                      : instance<__nv_bfloat16, false>();
    case 2: return resident ? instance<__half, true>() : instance<__half, false>();
    default: return nullptr;
  }
}

inline size_t resident_bytes(int V) {
  return static_cast<size_t>(2) * slice_len(V) * sizeof(float);
}

// The launch of R rows, clusters of kCluster CTAs, `smem` dynamic bytes.
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(int R, size_t smem, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCluster, R, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

inline cudaError_t allow_smem(Kernel k, size_t smem) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace smp

// The form of the kernel for rows of V logits of `dtype` on the current
// device: *resident 1 where each CTA of the cluster keeps its slice of s and
// of the probabilities in shared memory (the slice fits, and
// cudaOccupancyMaxActiveClusters finds room for such a cluster), else 0: the
// CTAs read their slice again at every pass. It depends on V and the card
// only, never on the number of rows, so a row gives the same bits in any
// batch. Returns a CUDA error code.
extern "C" int sample_tokens_plan(int dtype, int V, int* resident) {
  const smp::Kernel k = smp::pick_kernel(dtype, true);
  if (!k || V <= 0) return cudaErrorInvalidValue;
  *resident = 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(k));
  if (err != cudaSuccess) return err;
  const size_t smem = smp::resident_bytes(V);
  if (smem + fa.sharedSizeBytes > static_cast<size_t>(optin)) return cudaSuccess;
  err = smp::allow_smem(k, smem);
  if (err != cudaSuccess) return err;
  int active = 0;
  const smp::Launch launch(1, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(
      &active, reinterpret_cast<const void*>(k), &launch.cfg);
  if (err != cudaSuccess) return err;
  *resident = active > 0;
  return cudaSuccess;
}

// Launch the sampling kernel over R rows of V logits of `dtype` on `stream`
// in the form sample_tokens_plan chose (`resident`): one cluster launch,
// capturable in a CUDA graph; returns cudaGetLastError(). `allowed` and `u`
// may be null. The wrapper checks shapes, types and devices.
extern "C" int sample_tokens_launch(int dtype, const void* logits,
                                    const void* allowed,
                                    const void* temperature,
                                    const void* top_k, const void* top_p,
                                    const void* seeds, const void* positions,
                                    void* tokens, void* u, int R, int V,
                                    int resident, void* stream) {
  if (R == 0) return 0;
  const smp::Kernel k = smp::pick_kernel(dtype, resident != 0);
  if (!k || V <= 0 || R > 65535) return cudaErrorInvalidValue;
  const size_t smem = resident ? smp::resident_bytes(V) : 0;
  cudaError_t err = smp::allow_smem(k, smem);
  if (err != cudaSuccess) return err;
  const size_t esz = dtype == 0 ? 4 : 2;
  const int vec = V % smp::kVec == 0 &&
                  reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                  (static_cast<size_t>(V) * esz) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(allowed) % 8 == 0;
  const smp::Launch launch(R, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(
      &launch.cfg, k, logits, static_cast<const uint8_t*>(allowed),
      static_cast<const float*>(temperature), static_cast<const int*>(top_k),
      static_cast<const float*>(top_p), static_cast<const int*>(seeds),
      static_cast<const int*>(positions), static_cast<long long*>(tokens),
      static_cast<float*>(u), V, smp::slice_len(V), vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
