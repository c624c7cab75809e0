// Paged attention over the serving engine's KV arena, written for Hopper
// (sm_90a). Two kernels, each with a plain C launcher bound from Python with
// ctypes (paddle_tpu_torch/ops/paged_attention.py):
//
//   dec::decode_kernel    replaces paddle_tpu/ops/paged_attention.py
//                         _decode_kernel: one new query per slot against that
//                         slot's paged K/V, read through its block table,
//                         each slot's walk split over several blocks.
//   paged_prefill_kernel  replaces paddle_tpu/ops/paged_attention.py
//                         _prefill_kernel: one slot's causal queries at global
//                         positions prefix_len + i, read through its table.
//                         bf16 queries at head_dim <= 128 run its tensor-core
//                         form, pf::prefill_kernel; f32, float16 and head_dim
//                         256 the CUDA-core form.
//
// Query dtypes T: float, __nv_bfloat16, __half; head dims 32, 64, 128, 256.
//
// Both are templated on the pool payload type P. P = T (the query's dtype)
// is the full-precision arena. P = int8_t is the int8 arena, the Pallas
// bodies' `quantized` variant (the int8 kernels, launched through the
// paged_*_attention_int8_launch entry points): float32 scale pools
// [num_blocks, bs] hold one scale per token row, and each loaded element is
// then round_to<T>(float(q) * scale) -- dequantize_kv's float32
// multiply and one cast to T -- before any other use. Everything after the
// load is the same code for both payloads.
//
// Layouts (the JAX package's, kept at the public functions):
//   q, out          [rows, H, D]            (decode: rows = slots)
//   k, v pools      [num_blocks, bs, H, D]  block 0 is the scratch sink
//   Each row's [H, D] is dense; rows may be strided (q_stride, kv_stride in
//   elements), so the qkv split's views are read in place, uncopied.
//   block tables    int32 [S, MB] / [MB]; positions int32 [S]; prefix_len an
//                   int32 device scalar. All are runtime data read by the
//                   kernel: a launch never synchronises or allocates, so it can
//                   be captured in a CUDA graph.
//
// Numerics mirror the Pallas bodies: scores q.k in fp32 times 1/sqrt(D), an
// online softmax in fp32 with running max, denominator and accumulator, the
// probabilities rounded to the value dtype before P.V (the Pallas
// `p.astype(v.dtype)`), a zero-denominator guard, and one cast of the result.
//
// Bound on an H100 SXM: both kernels read each needed K/V row once, so decode
// is bound by bytes (K/V rows up to each slot's position over 3.35 TB/s, at
// about 1 FLOP per byte; see dec:: below). Prefill at the engine's buckets
// (a 512-token prompt: 0.27 GFLOP over 8 MB) is bound by neither rate but by
// latency: the time to
// bring each 64-key tile through the table into shared memory and the chain
// of products and softmax over it. Its tensor-core form keeps loads in flight
// behind the math (a ring of cp.async gathers), does both products on the
// tensor cores, reads Q once per block, and masks only the tiles that cross
// the diagonal or the last real key (see pf:: below). Both kernels skip whole
// blocks past the position: a stale table entry pointing at scratch block 0
// is never read.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas NEG_INF: finite, so exp() of
                                   // a masked score against a real max is 0
constexpr int kWarp = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// p rounded to the value dtype, as the Pallas body does before P.V
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Physical token row of logical key t through a block table: the index
// into a scale pool, and (times kv_stride) into a K/V pool.
__device__ __forceinline__ long long token_row(const int* table, int t,
                                               int bs) {
  const long long blk = table[t / bs];
  return blk * bs + t % bs;
}

// Offset of logical key t of head h through a block table; kv_stride is
// the pool's token-row stride in elements.
__device__ __forceinline__ long long key_row(const int* table, int t, int bs,
                                            long long kv_stride, int h,
                                            int D) {
  return token_row(table, t, bs) * kv_stride + static_cast<long long>(h) * D;
}

// N consecutive int8 elements at p (N-byte aligned) in one load, each
// dequantized with its row's scale s and rounded to T.
template <typename T, int N>
__device__ __forceinline__ void load_deq(const int8_t* p, float s,
                                         float* o) {
  if constexpr (N == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    o[0] = round_to<T>(static_cast<float>(c.x) * s);
    o[1] = round_to<T>(static_cast<float>(c.y) * s);
    o[2] = round_to<T>(static_cast<float>(c.z) * s);
    o[3] = round_to<T>(static_cast<float>(c.w) * s);
  } else if constexpr (N == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    o[0] = round_to<T>(static_cast<float>(c.x) * s);
    o[1] = round_to<T>(static_cast<float>(c.y) * s);
  } else {
    static_assert(N == 1, "one, two or four int8 per load");
    o[0] = round_to<T>(static_cast<float>(p[0]) * s);
  }
}

// ------------------------------------------------------------------ decode
//
// Bound by bytes: every K/V row up to each slot's position is read once, at
// about one FLOP per byte, so the kernel's work is to keep enough loads in
// flight on all 132 SMs. Its design:
//
//   - Each (slot, head)'s key walk is cut into splits, one thread block
//     each: grid (splits, H, S). Every (slot, head) gets `splits`
//     contiguous, block-aligned shares of its positions[s] + 1 keys, so
//     the host needs no length: positions stay device data. The caller
//     picks `splits` (the wrapper: about 4 blocks on each SM in one wave,
//     4 at 8 slots x 16 heads on 132 SMs) and sizes the workspace by it.
//   - Lanes own contiguous dims and read 16 bytes a load. LR lanes cover a
//     key row (16 at D = 128 in bf16 or fp16, so one warp-wide load reads
//     two rows; 8 for an int8 row), and each such lane group walks its own
//     keys with its own online softmax state. An int8 row is dequantized
//     in registers as round_to<T>(float(q) * scale), its row's scale read
//     with the row.
//   - Loads run ahead of the products: two steps of K/V rows are in flight
//     in two register buffers, and the table entries of the step after
//     them are read while the first of the two is used.
//   - The partials merge deterministically, with no floating-point atomics:
//     lane groups by shuffles, warps through shared memory in warp order,
//     splits through a workspace [S, H, splits, D + 2] f32 (acc, m, l) and
//     a ticket counter per (slot, head), both owned by the wrapper. The
//     split that takes the last ticket merges every split's partial in
//     split order, writes the output and sets the counter back to 0 for
//     the next launch. The output is the same bits on every launch, and
//     one launch does it all: the launch stays capturable in a CUDA graph.
//   - exp is the fast __expf for 16-bit queries (p is rounded to T before
//     P.V anyway) and the accurate expf for f32, which the parity runs hold
//     to 1e-5.

namespace dec {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kGroup = 2;       // keys a lane group loads per step
constexpr int kMaxMerge = 64;   // splits one merge takes

// E elements per 16-byte load, LR lanes per key row, NC loads per lane per
// row, KW rows per warp-wide load, N dims per lane
template <typename P, int D>
struct Lanes {
  static constexpr int E = 16 / sizeof(P);
  static constexpr int LR = D / E < kWarp ? D / E : kWarp;
  static constexpr int NC = D / (E * LR);
  static constexpr int KW = kWarp / LR;
  static constexpr int N = E * NC;
  static_assert(D % E == 0 && LR * KW == kWarp, "rows of whole loads");
};

// keys per split of a walk of n keys through blocks of bs, in a grid of
// `splits` splits per (slot, head): block-aligned shares
__device__ __forceinline__ int split_len(int n, int bs, int splits) {
  const int per = ((n + bs - 1) / bs + splits - 1) / splits;
  return (per > 1 ? per : 1) * bs;
}

template <typename T>
__device__ __forceinline__ float exp_of(float x) {
  if constexpr (std::is_same<T, float>::value) return expf(x);
  else return __expf(x);
}

// the E elements of one 16-byte load of a full-precision row, as float
__device__ __forceinline__ void unpack(const uint4& w, float* o, float) {
  o[0] = __uint_as_float(w.x);
  o[1] = __uint_as_float(w.y);
  o[2] = __uint_as_float(w.z);
  o[3] = __uint_as_float(w.w);
}
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& w, float* o) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    } else {
      const float2 f =
          __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}
// 16 int8 of w, each times s rounded to T. 0x4B0000uu is the float 2^23 +
// uu, so (b ^ 0x80) placed there minus 2^23 + 128 is float(b), exactly.
template <typename T>
__device__ __forceinline__ void unpack_i8(const uint4& w, float* o, float s) {
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                         w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    o[i] = round_to<T>((__uint_as_float(__byte_perm(u[i / 4], 0x4B000000u,
                                                    0x7540 | (i % 4))) -
                        8388736.f) * s);
}

template <typename T, typename P>
__device__ __forceinline__ void unpack_row(const uint4& w, float* o, float s) {
  if constexpr (std::is_same<P, int8_t>::value) unpack_i8<T>(w, o, s);
  else if constexpr (std::is_same<P, float>::value) unpack(w, o, s);
  else unpack16<P>(w, o);
}

// Merges the n partials [n][D + 2] (acc, m, l) of one (slot, head), in
// split order, into its output row. They were written by other blocks of
// this launch, so they are read past L1; each split's weight
// exp(m_i - max m) is computed once, into shared memory.
template <typename T, int D>
__device__ __forceinline__ void merge(const float* part, int n, T* o) {
  __shared__ float w[kMaxMerge];
  __shared__ float den;
  if (threadIdx.x < kWarp) {
    const int lane = threadIdx.x;
    float m[kMaxMerge / kWarp];
    float mall = kNegInf;
#pragma unroll
    for (int k = 0; k < kMaxMerge / kWarp; ++k) {
      const int i = lane + k * kWarp;
      m[k] = i < n ? __ldcg(part + i * (D + 2) + D) : kNegInf;
      mall = fmaxf(mall, m[k]);
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      mall = fmaxf(mall, __shfl_xor_sync(0xffffffffu, mall, o));
#pragma unroll
    for (int k = 0; k < kMaxMerge / kWarp; ++k)
      if (lane + k * kWarp < n) w[lane + k * kWarp] = exp_of<T>(m[k] - mall);
    __syncwarp();
    if (lane == 0) {  // the denominator, in split order
      float sum = 0.f;
      for (int i = 0; i < n; ++i)
        sum += __ldcg(part + i * (D + 2) + D + 1) * w[i];
      den = sum == 0.f ? 1.f : sum;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += __ldcg(part + i * (D + 2) + d) * w[i];
    o[d] = from_f32<T>(acc / den);
  }
}

// splits with keys of a slot of n keys: a slot with no key still runs
// split 0, whose zero denominator gives a zero row
__device__ __forceinline__ int live_splits(int n, int bs, int splits) {
  const int len = split_len(n, bs, splits);
  return n > 0 ? (n + len - 1) / len : 1;
}

template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                  const P* __restrict__ vp, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ positions, T* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ tickets, int H,
                  int bs, int MB, long long q_stride, long long kv_stride,
                  float scale) {
  using L = Lanes<P, D>;
  constexpr int N = L::N, E = L::E, NC = L::NC;
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  constexpr int kStep = kWarps * kGroup * L::KW;  // keys per block step
  const int split = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int lr = lane % L::LR, grp = lane / L::LR;
  const int n = min(positions[s], MB * bs - 1) + 1;  // keys of slot s
  const int live = live_splits(n, bs, gridDim.x);
  if (split >= live) return;
  const int len = split_len(n, bs, gridDim.x);
  const int t0 = split * len;
  const int t_end = min(t0 + len, n) - 1;  // this split's last key
  const int steps = t_end >= t0 ? (t_end - t0) / kStep + 1 : 0;
  const int* table = block_tables + static_cast<long long>(s) * MB;
  const long long head = static_cast<long long>(h) * D;

  // this lane's element i is dim (i / E * LR + lr) * E + i % E
  const auto dim = [&](int i) { return (i / E * L::LR + lr) * E + i % E; };
  float qf[N], acc[N];
  const T* qrow = q + s * q_stride + head;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    qf[i] = to_f32(qrow[dim(i)]);
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  struct Buf {
    uint4 k[kGroup][NC], v[kGroup][NC];
    float ks[kGroup], vs[kGroup];
    int row[kGroup];  // token row, -1 past the split's last key
  };
  // the token rows of step i's keys, from the table
  const auto rows = [&](int (&r)[kGroup], int i) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int t = t0 + ((i * kWarps + warp) * kGroup + j) * L::KW + grp;
      r[j] = t <= t_end ? __ldg(table + t / bs) * bs + t % bs : -1;
    }
  };
  const auto load = [&](Buf& b, const int (&r)[kGroup]) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      b.row[j] = r[j];
      const bool real = r[j] >= 0;
      const long long off = real ? r[j] * kv_stride + head : 0;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = (c * L::LR + lr) * E;
        b.k[j][c] = real ? __ldg(reinterpret_cast<const uint4*>(kp + off + d))
                         : make_uint4(0, 0, 0, 0);
        b.v[j][c] = real ? __ldg(reinterpret_cast<const uint4*>(vp + off + d))
                         : make_uint4(0, 0, 0, 0);
      }
      if constexpr (kInt8) {
        b.ks[j] = real ? __ldg(k_scale + r[j]) : 0.f;
        b.vs[j] = real ? __ldg(v_scale + r[j]) : 0.f;
      } else {
        b.ks[j] = b.vs[j] = 1.f;
      }
    }
  };
  const auto compute = [&](const Buf& b) {
    float sc[kGroup];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float kf[E];
        unpack_row<T, P>(b.k[j][c], kf, b.ks[j]);
#pragma unroll
        for (int e = 0; e < E; ++e) part += qf[c * E + e] * kf[e];
      }
#pragma unroll
      for (int o = L::LR / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      sc[j] = b.row[j] >= 0 ? part * scale : kNegInf;
      mx = fmaxf(mx, sc[j]);
    }
    const float corr = exp_of<T>(m - mx);
    l *= corr;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float p = b.row[j] >= 0 ? exp_of<T>(sc[j] - mx) : 0.f;
      l += p;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vf[E];
        unpack_row<T, P>(b.v[j][c], vf, b.vs[j]);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[c * E + e] += pr * vf[e];
      }
    }
    m = mx;
  };

  // two steps of K/V in flight, and the table entries of the next
  Buf A, B;
  int ra[kGroup], rb[kGroup];
  rows(ra, 0);
  rows(rb, 1);
  load(A, ra);
  load(B, rb);
  for (int i = 0; i < steps; i += 2) {
    rows(ra, i + 2);
    compute(A);
    if (i + 1 >= steps) break;
    load(A, ra);  // step i + 2
    rows(rb, i + 3);
    compute(B);
    load(B, rb);  // step i + 3
  }

  // the lane groups of a warp (lanes lane ^ LR, ^ 2 LR, ...)
#pragma unroll
  for (int o = L::LR; o < kWarp; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mall = fmaxf(m, mo);
    const float c = exp_of<T>(m - mall), co = exp_of<T>(mo - mall);
    l = l * c + lo * co;
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc[i] = acc[i] * c + __shfl_xor_sync(0xffffffffu, acc[i], o) * co;
    m = mall;
  }
  // the warps, in warp order
  __shared__ float sm_acc[kWarps][D];
  __shared__ float sm_ml[kWarps][2];
  __shared__ int merges;
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) sm_acc[warp][dim(i)] = acc[i];
  }
  if (lane == 0) {
    sm_ml[warp][0] = m;
    sm_ml[warp][1] = l;
  }
  __syncthreads();
  float mb = kNegInf, lb = 0.f, cw[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm_ml[w][0]);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    cw[w] = exp_of<T>(sm_ml[w][0] - mb);
    lb += sm_ml[w][1] * cw[w];
  }
  const long long sh = static_cast<long long>(s) * H + h;
  if (live == 1) {  // one split: the block's is the output
    const float den = lb == 0.f ? 1.f : lb;
    for (int d = tid; d < D; d += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += sm_acc[w][d] * cw[w];
      out[sh * D + d] = from_f32<T>(o / den);
    }
    return;
  }
  float* parts = ws + sh * gridDim.x * (D + 2);
  float* part = parts + split * (D + 2);
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sm_acc[w][d] * cw[w];
    part[d] = o;
  }
  if (tid == 0) {
    part[D] = mb;
    part[D + 1] = lb;
  }
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) merges = atomicAdd(tickets + sh, 1) == live - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();
  merge<T, D>(parts, live, out + sh * D);
  if (tid == 0) tickets[sh] = 0;  // ready for the next launch
}

}  // namespace dec

// ----------------------------------------------------------------- prefill
//
// The CUDA-core form, for f32 queries (whose products must stay f32: the
// parity runs hold them to 1e-5), for float16, and for bf16 at head_dim
// 256, past the tensor-core form's registers. One thread block per (query
// tile, head). A tile is kTileQ query rows; each
// of its warps owns kRowsPerWarp rows and keeps their online softmax state
// in registers. The block walks the slot's keys kTileK at a time: it stages
// the tile's K and V rows in shared memory as fp32 (read once from device
// memory, then shared by every row of the tile), and stops at the key of the
// tile's last real row. Query and output rows are read and written in place
// in the [sq, H, D] layout, so no head-major copy is made. An int8 tile is
// staged four elements (one word) per thread and load, dequantized with its
// row's scale on the way into shared memory.

constexpr int kPrefillWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kTileQ = kPrefillWarps * kRowsPerWarp;
constexpr int kTileK = 16;

template <typename T, typename P, int D>
__global__ void __launch_bounds__(kPrefillWarps * kWarp)
    paged_prefill_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                         const P* __restrict__ vp,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ bt_row,
                         const int* __restrict__ prefix_len,
                         T* __restrict__ out, int sq, int H, int bs, int MB,
                         long long q_stride, long long kv_stride,
                         float scale) {
  constexpr int E = D / kWarp;
  __shared__ float ks[kTileK][D];
  __shared__ float vs[kTileK][D];
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int prefix = *prefix_len;
  // keys past the tile's last real row are masked for every row: never read
  const int q_last = min(q0 + kTileQ, sq) - 1;
  const int k_last = min(prefix + q_last, MB * bs - 1);

  float qr[kRowsPerWarp][E], acc[kRowsPerWarp][E];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int grow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    grow[r] = qi < sq ? prefix + qi : -1;  // -1: a row past sq (no output)
    m[r] = kNegInf;
    l[r] = 0.f;
    const T* qrow = q + qi * q_stride + static_cast<long long>(h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[r][e] = qi < sq ? to_f32(qrow[lane + kWarp * e]) : 0.f;
      acc[r][e] = 0.f;
    }
  }

  for (int t0 = 0; t0 <= k_last; t0 += kTileK) {
    __syncthreads();  // the previous key tile is consumed
    if constexpr (std::is_same<P, int8_t>::value) {
      constexpr int W = D / 4;  // words per row
      for (int i = threadIdx.x; i < kTileK * W; i += blockDim.x) {
        const int kk = i / W;
        const int d = (i % W) * 4;
        const int t = t0 + kk;
        float kv[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
        if (t <= k_last) {
          const long long trow = token_row(bt_row, t, bs);
          const long long row = trow * kv_stride
              + static_cast<long long>(h) * D + d;
          load_deq<T, 4>(kp + row, k_scale[trow], kv);
          load_deq<T, 4>(vp + row, v_scale[trow], vv);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ks[kk][d + j] = kv[j];
          vs[kk][d + j] = vv[j];
        }
      }
    } else {
      for (int i = threadIdx.x; i < kTileK * D; i += blockDim.x) {
        const int kk = i / D;
        const int d = i % D;
        const int t = t0 + kk;
        float kv = 0.f, vv = 0.f;
        if (t <= k_last) {
          const long long row = key_row(bt_row, t, bs, kv_stride, h, D);
          kv = to_f32(kp[row + d]);
          vv = to_f32(vp[row + d]);
        }
        ks[kk][d] = kv;
        vs[kk][d] = vv;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      // warp-uniform: every key of this tile lies past the row (or the row
      // is past sq) -- the Pallas body's fully masked step changes nothing
      if (t0 > grow[r]) continue;
      float sc[kTileK];
      float mx = m[r];
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qr[r][e] * ks[kk][lane + kWarp * e];
        sc[kk] = (t0 + kk <= grow[r]) ? warp_sum(part) * scale : kNegInf;
        mx = fmaxf(mx, sc[kk]);
      }
      const float corr = expf(m[r] - mx);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        const float p = expf(sc[kk] - mx);
        l[r] += p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] += pr * vs[kk][lane + kWarp * e];
      }
      m[r] = mx;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* orow = out + (static_cast<long long>(qi) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e)
      orow[lane + kWarp * e] = from_f32<T>(acc[r][e] / denom);
  }
}

// ------------------------------------------------ prefill on the tensor cores
//
// bf16 queries at head_dim 32, 64 and 128, over bf16 or int8 pools. One
// thread block per (query tile, head); a tile is BQ = 64 query rows, or 32
// where sq <= 256 (a chunk of 256 makes 8 x H blocks at 64 rows: 128 SMs
// would idle at H = 16). Blocks of later tiles walk more keys, so they are
// scheduled first.
//
//   - The walk goes over 64-key tiles up to the key of the block's last
//     real row (k_last), kGroups tiles per step: each of the block's two
//     warp groups (BQ / 16 warps of 16 rows each) takes every other tile
//     with its own online softmax, so the chain of dependent products per
//     warp is half the walk, and the two states merge through shared
//     memory at the end.
//   - Q's rows are staged once and each warp keeps its 16 rows' A fragments
//     in registers for the whole walk.
//   - Each step's tiles are gathered through the block table with
//     cp.async, 16 bytes a thread, into a ring of stages: while the warps
//     run step i, the next steps' gathers are in flight. A thread pair owns
//     a key: one table read per key per step; keys past k_last are never
//     read (their rows are zero-filled), so a stale table entry is never
//     followed.
//   - S = Q K^T and O += P V run as mma.sync m16n8k16 (tensor_core.cuh): p
//     goes from the accumulator into the A fragment rounded to bf16.
//   - The causal and last-key masks are evaluated only on the tiles that
//     cross the diagonal of the warp's first row or k_last.
//   - An int8 tile is staged raw with each key's two float32 scales; each
//     thread then dequantizes the pieces it copied itself (no extra
//     barrier) into a bf16 tile as round_to<bf16>(float(q) * scale), which
//     the products read: dequantize_kv's contract, with the int8 -> float
//     conversion done by a byte permute and one add instead of the
//     quarter-rate I2F.
//   - exp is the fast __expf (ex2.approx, a few ulp of f32): p is rounded
//     to bf16 before P V anyway, and it took a sixth of the kernel's time.

namespace pf {

constexpr int kBK = 64;     // keys per tile
constexpr int kGroups = 2;  // tiles per step: one per warp group (the
                            // merge below takes two)

using tc::bf16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory, in bytes: Q [BQ][D + 8] bf16, then NS stages of kGroups
// tiles, each tile its K then V rows (bf16 rows of D + 8, or raw int8 rows
// of D) and, for int8, the scales [thread parity][K, V][kBK] f32; for int8
// two buffers of kGroups dequantized tiles, K then V [kBK][D + 8] bf16.
// After the walk the stages hold the merge: [BQ][D] f32 o, [BQ][2] f32 m, l.
// Two stages: a third timed the same at the path's shapes on an H100.
template <typename P, int D, int BQ>
struct Smem {
  static constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  static constexpr int NS = 2;  // steps in the ring
  static constexpr int DP = D + 8;
  static constexpr size_t q = sizeof(bf16) * BQ * DP;
  static constexpr size_t row = kInt8 ? D : sizeof(bf16) * DP;
  static constexpr size_t scales = kInt8 ? 4 * kBK * sizeof(float) : 0;
  static constexpr size_t tile = 2 * kBK * row + scales;
  static constexpr size_t stage = kGroups * tile;
  static constexpr size_t deq_tile = 2 * sizeof(bf16) * kBK * DP;
  static constexpr size_t deq = kInt8 ? 2 * kGroups * deq_tile : 0;
  static constexpr size_t total = q + NS * stage + deq;
  static_assert(NS * stage >= sizeof(float) * BQ * (D + 2),
                "the merge fits in the ring");
};

// 4 int8 of w (byte 0 first), each times s, rounded to bf16, as two bf16
// pairs. 0x4B0000uu is the float 2^23 + uu, so (b ^ 0x80) placed there
// minus 2^23 + 128 is float(b), exactly.
__device__ __forceinline__ uint2 deq4(uint32_t w, float s) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k)) -
            8388736.f) * s;
  return make_uint2(tc::pack(f[0], f[1]), tc::pack(f[2], f[3]));
}

template <typename P, int D, int BQ>
__global__ void __launch_bounds__(kGroups * BQ / 16 * 32)
    prefill_kernel(const bf16* __restrict__ q, const P* __restrict__ kp,
                   const P* __restrict__ vp, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ bt_row,
                   const int* __restrict__ prefix_len, bf16* __restrict__ out,
                   int sq, int H, int bs, int MB, long long q_stride,
                   long long kv_stride, float scale) {
  using L = Smem<P, D, BQ>;
  constexpr int NS = L::NS;
  constexpr int kWarps = BQ / 16;  // per group
  constexpr int kThreads = kGroups * kWarps * 32;
  constexpr int DP = D + 8;
  constexpr int E = 16 / sizeof(P);  // elements per 16-byte copy
  constexpr int CR = D / E;          // copies per key row
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  char* ring = smem + L::q;
  bf16* deq = reinterpret_cast<bf16*>(ring + NS * L::stage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / kWarps, wr = warp % kWarps;
  const int t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int prefix = *prefix_len;
  // keys past the tile's last real row are masked for every row: never read
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_last = min(prefix + q_last, MB * bs - 1);
  const int n_tiles = k_last / kBK + 1;
  const int n_steps = (n_tiles + kGroups - 1) / kGroups;

  for (int i = tid; i < BQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool real = q0 + r < sq;
    cp_async16(Qs + r * DP + c * 8,
               real ? q + (q0 + r) * q_stride + h * D + c * 8 : q, real);
  }
  // Thread pair tid / 2 owns keys tid / 2 + n * kThreads / 2 (n < KPT) of
  // each step's kGroups * kBK. rows() reads their token rows from the
  // table (-1 past k_last) one step before gather() needs them, so the
  // table's latency hides behind a step of products.
  constexpr int KPT = kGroups * kBK / (kThreads / 2);
  long long trows[KPT];
  const auto rows = [&](int i) {
#pragma unroll
    for (int n = 0; n < KPT; ++n) {
      const int key = i * kGroups * kBK + (tid >> 1) + n * (kThreads / 2);
      trows[n] = key <= k_last
                     ? static_cast<long long>(bt_row[key / bs]) * bs + key % bs
                     : -1;
    }
  };
  // step i's gathers into its stage: each thread every other 16 bytes of
  // its keys' K and V rows (and, for int8, both scales into its own slot)
  const auto gather = [&](int i) {
    char* st = ring + (i % NS) * L::stage;
#pragma unroll
    for (int n = 0; n < KPT; ++n) {
      const int kk = (tid >> 1) + n * (kThreads / 2);
      char* tl = st + (kk / kBK) * L::tile;
      const int r = kk % kBK;
      const bool real = trows[n] >= 0;
      const long long trow = real ? trows[n] : 0;
      const long long off = trow * kv_stride + static_cast<long long>(h) * D;
#pragma unroll
      for (int c = tid & 1; c < CR; c += 2) {
        cp_async16(tl + r * L::row + c * 16, kp + off + c * E, real);
        cp_async16(tl + (kBK + r) * L::row + c * 16, vp + off + c * E, real);
      }
      if constexpr (L::kInt8) {
        float* sc = reinterpret_cast<float*>(tl + 2 * kBK * L::row) +
                    (tid & 1) * 2 * kBK;
        cp_async4(sc + r, k_scale + trow, real);
        cp_async4(sc + kBK + r, v_scale + trow, real);
      }
    }
  };
  // the pieces this thread copied of step i, dequantized into buffer i % 2
  const auto dequantize = [&](int i) {
    const char* st = ring + (i % NS) * L::stage;
#pragma unroll
    for (int n = 0; n < KPT; ++n) {
      const int kk = (tid >> 1) + n * (kThreads / 2);
      const char* tl = st + (kk / kBK) * L::tile;
      const int r = kk % kBK;
      const float* sc = reinterpret_cast<const float*>(tl + 2 * kBK * L::row) +
                        (tid & 1) * 2 * kBK;
      bf16* dt = deq + ((i & 1) * kGroups + kk / kBK) * (2 * kBK * DP);
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const float s = sc[kv * kBK + r];
#pragma unroll
        for (int c = tid & 1; c < CR; c += 2) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              tl + (kv * kBK + r) * L::row + c * 16);
          uint2* dst =
              reinterpret_cast<uint2*>(dt + (kv * kBK + r) * DP + c * 16);
          dst[0] = deq4(w.x, s);
          dst[1] = deq4(w.y, s);
          dst[2] = deq4(w.z, s);
          dst[3] = deq4(w.w, s);
        }
      }
    }
  };
  rows(0);
  gather(0);
  cp_commit();  // group 0: Q and step 0
#pragma unroll
  for (int i = 1; i < NS - 1; ++i) {
    rows(i);
    if (i < n_steps) gather(i);
    cp_commit();
  }
  rows(NS - 1);

  // this warp's rows r_lo .. r_hi; fragment rows row0 and row0 + 8
  const int r_lo = q0 + wr * 16;
  const int r_hi = min(r_lo + 15, q_last);
  const int row0 = r_lo + (lane >> 2);
  const int reach = min(prefix + r_hi, k_last);    // its farthest key
  const int plain = min(prefix + r_lo, k_last);    // keys no row masks
  const int lim[2] = {min(prefix + row0, k_last),
                      min(prefix + row0 + 8, k_last)};
  uint32_t qa[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_steps; ++i) {
    cp_wait<NS - 2>();  // this thread's copies of step i have landed
    if constexpr (L::kInt8) dequantize(i);
    __syncthreads();  // everyone's have, and step i - 1 is consumed
    if (i + NS - 1 < n_steps) gather(i + NS - 1);
    cp_commit();
    rows(i + NS);
    if (i == 0) tc::load_a<D>(qa, Qs, wr * 16, lane);
    const int k0 = (i * kGroups + grp) * kBK;
    // warp-uniform: every key of this tile lies past each row of the warp
    // (or the warp has no real row) -- the Pallas body's fully masked step
    if (r_lo > q_last || k0 > reach) continue;
    const bf16 *Kt, *Vt;
    if constexpr (L::kInt8) {
      Kt = deq + ((i & 1) * kGroups + grp) * (2 * kBK * DP);
      Vt = Kt + kBK * DP;
    } else {
      Kt = reinterpret_cast<const bf16*>(ring + (i % NS) * L::stage +
                                         grp * L::tile);
      Vt = Kt + kBK * DP;
    }
    float s[8][4];
    tc::dot_tile_a<D, 8>(s, qa, Kt, 0, lane);
    float mx[2] = {m[0], m[1]};
    const bool edge = k0 + kBK - 1 > plain;  // crosses the diagonal or k_last
    if (edge) {
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + jn * 8 + 2 * t + (e & 1);
          s[jn][e] = col <= lim[e >> 1] ? s[jn][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[jn][e]);
        }
    } else {
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[jn][e] *= scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[jn][e]);
        }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = tc::quad_max(mx[r]);
      corr[r] = __expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score's p is 0, also in a row of the second group that
        // has no key yet (whose max is still kNegInf)
        const float p = !edge || s[jn][e] > 0.5f * kNegInf
                            ? __expf(s[jn][e] - mx[e >> 1])
                            : 0.f;
        sum[e >> 1] += p;
        s[jn][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * corr[r] + tc::quad_sum(sum[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }
    tc::acc_tile<D, 8>(o, s, Vt, 0, lane);  // P rounded to bf16, then P . V
  }

  cp_wait<0>();  // no copy outlives the walk
  __syncthreads();  // the ring is free: it holds the merge

  // the second group hands its (m, l, o) to the first, row by row
  float* mo = reinterpret_cast<float*>(ring);  // [BQ][D]
  float* ml = mo + BQ * D;                     // [BQ][2]
  const int lr = wr * 16 + (lane >> 2);        // local rows lr, lr + 8
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(mo + (lr + 8 * r) * D + dn * 8 + 2 * t) =
            make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
      if (t == 0) {
        ml[(lr + 8 * r) * 2] = m[r];
        ml[(lr + 8 * r) * 2 + 1] = l[r];
      }
    }
  }
  __syncthreads();
  if (grp == 1) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = ml[(lr + 8 * r) * 2], l1 = ml[(lr + 8 * r) * 2 + 1];
    const float mall = fmaxf(m[r], m1);
    const float c0 = __expf(m[r] - mall), c1 = __expf(m1 - mall);
    const float lsum = l[r] * c0 + l1 * c1;
    inv[r] = 1.f / (lsum == 0.f ? 1.f : lsum);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const float2 o1 =
          *reinterpret_cast<const float2*>(mo + (lr + 8 * r) * D + dn * 8 + 2 * t);
      o[dn][2 * r] = o[dn][2 * r] * c0 + o1.x * c1;
      o[dn][2 * r + 1] = o[dn][2 * r + 1] * c0 + o1.y * c1;
    }
  }
  tc::store<D>(out + static_cast<long long>(h) * D,
               static_cast<long long>(H) * D, row0, sq, t, o, inv);
}

template <typename P, int D, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* bt,
                   const void* prefix, void* out, int sq, int H, int bs,
                   int MB, long long q_stride, long long kv_stride, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<P, D, BQ>::total;
  const auto kernel = prefill_kernel<P, D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, H);
  kernel<<<grid, kGroups * BQ / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(prefix), static_cast<bf16*>(out), sq, H, bs, MB,
      q_stride, kv_stride, scale);
  return cudaGetLastError();
}

}  // namespace pf

// --------------------------------------------------------------- launchers

// P = T: full-precision pools, no scales; P = int8_t: int8 pools with
// their float32 scale pools ks, vs.
template <typename T, typename P, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, const void* bt,
                          const void* pos, void* out, void* ws, void* tickets,
                          int splits, int S, int H, int bs, int MB,
                          long long q_stride, long long kv_stride, float scale,
                          cudaStream_t stream) {
  if (splits < 1 || splits > dec::kMaxMerge) return cudaErrorInvalidValue;
  dec::decode_kernel<T, P, D><<<dim3(splits, H, S), dec::kThreads, 0,
                                stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), H, bs, MB,
      q_stride, kv_stride, scale);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* bt,
                           const void* prefix, void* out, int sq, int H,
                           int bs, int MB, long long q_stride,
                           long long kv_stride, float scale,
                           cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D <= 128) {
    // bf16 runs on the tensor cores, in 32-row tiles up to a chunk of 256
    const auto run = sq <= 256 ? pf::launch<P, D, 32> : pf::launch<P, D, 64>;
    return run(q, k, v, ks, vs, bt, prefix, out, sq, H, bs, MB, q_stride,
               kv_stride, scale, stream);
  } else {
    const dim3 grid((sq + kTileQ - 1) / kTileQ, H);
    paged_prefill_kernel<T, P, D><<<grid, kPrefillWarps * kWarp, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const P*>(k),
        static_cast<const P*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(bt),
        static_cast<const int*>(prefix), static_cast<T*>(out), sq, H, bs, MB,
        q_stride, kv_stride, scale);
    return cudaGetLastError();
  }
}

// the full-precision and int8 instances (PAGED_DISPATCH names one of these)
template <typename T, int D, typename... A>
cudaError_t decode_fp(A... a) { return launch_decode<T, T, D>(a...); }
template <typename T, int D, typename... A>
cudaError_t decode_i8(A... a) { return launch_decode<T, int8_t, D>(a...); }
template <typename T, int D, typename... A>
cudaError_t prefill_fp(A... a) { return launch_prefill<T, T, D>(a...); }
template <typename T, int D, typename... A>
cudaError_t prefill_i8(A... a) { return launch_prefill<T, int8_t, D>(a...); }

#define PAGED_HEAD_DIMS(LAUNCH, T, ...)                                      \
  do {                                                                       \
    if (D == 32) return LAUNCH<T, 32>(__VA_ARGS__);                          \
    if (D == 64) return LAUNCH<T, 64>(__VA_ARGS__);                          \
    if (D == 128) return LAUNCH<T, 128>(__VA_ARGS__);                        \
    if (D == 256) return LAUNCH<T, 256>(__VA_ARGS__);                        \
  } while (0)

#define PAGED_DISPATCH(LAUNCH, ...)                                          \
  do {                                                                       \
    if (dtype == 0) PAGED_HEAD_DIMS(LAUNCH, float, __VA_ARGS__);             \
    if (dtype == 1) PAGED_HEAD_DIMS(LAUNCH, __nv_bfloat16, __VA_ARGS__);     \
    if (dtype == 2) PAGED_HEAD_DIMS(LAUNCH, __half, __VA_ARGS__);            \
    return cudaErrorInvalidValue;                                            \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, out and
// full-precision pools). D must be 32, 64, 128 or 256. Every pointer is a
// CUDA device pointer; stream is a cudaStream_t. q_stride and kv_stride are
// the row strides, in elements, of q and of the pools' token rows; out is
// dense. The _int8 launchers take int8 pools and their dense float32
// [num_blocks, bs] scale pools k_scale, v_scale. The decode launchers read
// the pools 16 bytes a load (their start and row stride 16-byte aligned),
// cut each slot's walk into `splits` (1 to 64) splits per (slot, head), one
// thread block each, and take their workspace: ws, S * H * splits * (D + 2)
// floats, and tickets, S * H int32 zeros, which each launch leaves zero;
// launches that share them must run in order (one stream). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention_launch(int dtype, const void* q,
                                             const void* k, const void* v,
                                             const void* block_tables,
                                             const void* positions, void* out,
                                             void* ws, void* tickets,
                                             int splits, int S, int H, int D,
                                             int bs, int MB,
                                             long long q_stride,
                                             long long kv_stride, float scale,
                                             void* stream) {
  if (S == 0) return 0;
  PAGED_DISPATCH(decode_fp, q, k, v, nullptr, nullptr, block_tables,
                 positions, out, ws, tickets, splits, S, H, bs, MB, q_stride,
                 kv_stride, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_decode_attention_int8_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* positions, void* out, void* ws, void* tickets, int splits,
    int S, int H, int D, int bs, int MB, long long q_stride,
    long long kv_stride, float scale, void* stream) {
  if (S == 0) return 0;
  PAGED_DISPATCH(decode_i8, q, k, v, k_scale, v_scale, block_tables,
                 positions, out, ws, tickets, splits, S, H, bs, MB, q_stride,
                 kv_stride, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_prefill_attention_launch(int dtype, const void* q,
                                              const void* k, const void* v,
                                              const void* bt_row,
                                              const void* prefix_len,
                                              void* out, int sq, int H, int D,
                                              int bs, int MB,
                                              long long q_stride,
                                              long long kv_stride, float scale,
                                              void* stream) {
  if (sq == 0) return 0;
  PAGED_DISPATCH(prefill_fp, q, k, v, nullptr, nullptr, bt_row, prefix_len,
                 out, sq, H, bs, MB, q_stride, kv_stride, scale,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int paged_prefill_attention_int8_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* bt_row,
    const void* prefix_len, void* out, int sq, int H, int D, int bs, int MB,
    long long q_stride, long long kv_stride, float scale, void* stream) {
  if (sq == 0) return 0;
  PAGED_DISPATCH(prefill_i8, q, k, v, k_scale, v_scale, bt_row, prefix_len,
                 out, sq, H, bs, MB, q_stride, kv_stride, scale,
                 static_cast<cudaStream_t>(stream));
}
