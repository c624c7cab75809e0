// Paged attention over the serving engine's KV arena, written for Hopper
// (sm_90a). Two kernels, each with a plain C launcher bound from Python with
// ctypes (paddle_tpu_torch/ops/paged_attention.py):
//
//   paged_decode_kernel   replaces paddle_tpu/ops/paged_attention.py
//                         _decode_kernel: one new query per slot against that
//                         slot's paged K/V, read through its block table.
//   paged_prefill_kernel  replaces paddle_tpu/ops/paged_attention.py
//                         _prefill_kernel: one slot's causal queries at global
//                         positions prefix_len + i, read through its table.
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
// about 1 FLOP per byte) and prefill, at the engine's bucket sizes, mostly by
// bytes too. The designs below keep every byte read exactly once per block,
// skip whole blocks past the position (a stale table entry pointing at scratch
// block 0 is never read), and keep the running softmax state in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas NEG_INF: finite, so exp() of
                                   // a masked score against a real max is 0
constexpr int kWarp = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
// One thread block per (head, slot). Its warps split the slot's keys
// 0..positions[s] between them, kDecodeGroup keys at a time (the group's K
// and V rows are loaded together so several loads are in flight per warp).
// Lane l owns dims l, l+32, ... of a row, so every load of a row is one
// coalesced transaction. An int8 row of D bytes is read as one word per
// lane instead: lane l owns dims l*E .. l*E+E-1 (E = D/32, 4 bytes at D =
// 128). Each warp keeps its own online softmax state; the warps merge theirs
// through shared memory at the end.

constexpr int kDecodeWarps = 8;
constexpr int kDecodeGroup = 4;

template <typename T, typename P, int D>
__global__ void __launch_bounds__(kDecodeWarps * kWarp)
    paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                        const P* __restrict__ vp,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ positions, T* __restrict__ out,
                        int H, int bs, int MB, long long q_stride,
                        long long kv_stride, float scale) {
  constexpr int E = D / kWarp;
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int* table = block_tables + static_cast<long long>(s) * MB;
  const int last = min(positions[s], MB * bs - 1);

  // the dim of element e of this lane
  const auto dim = [lane](int e) {
    return kInt8 ? lane * E + e : lane + kWarp * e;
  };

  const T* qrow = q + s * q_stride + static_cast<long long>(h) * D;
  float qr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qr[e] = to_f32(qrow[dim(e)]);

  float m = kNegInf, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int t0 = warp * kDecodeGroup; t0 <= last;
       t0 += kDecodeWarps * kDecodeGroup) {
    float kr[kDecodeGroup][E], vr[kDecodeGroup][E];
#pragma unroll
    for (int g = 0; g < kDecodeGroup; ++g) {
      const int t = t0 + g;
      if (t <= last) {
        if constexpr (kInt8) {
          const long long trow = token_row(table, t, bs);
          const long long row = trow * kv_stride
              + static_cast<long long>(h) * D + lane * E;
          load_deq<T, E>(kp + row, k_scale[trow], kr[g]);
          load_deq<T, E>(vp + row, v_scale[trow], vr[g]);
        } else {
          const long long row = key_row(table, t, bs, kv_stride, h, D);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            kr[g][e] = to_f32(kp[row + lane + kWarp * e]);
            vr[g][e] = to_f32(vp[row + lane + kWarp * e]);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[g][e] = vr[g][e] = 0.f;
      }
    }
    float sc[kDecodeGroup];
    float mx = m;
#pragma unroll
    for (int g = 0; g < kDecodeGroup; ++g) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part += qr[e] * kr[g][e];
      sc[g] = (t0 + g <= last) ? warp_sum(part) * scale : kNegInf;
      mx = fmaxf(mx, sc[g]);
    }
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
    for (int g = 0; g < kDecodeGroup; ++g) {
      const float p = expf(sc[g] - mx);
      l += p;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += pr * vr[g][e];
    }
    m = mx;
  }

  __shared__ float sm_m[kDecodeWarps];
  __shared__ float sm_l[kDecodeWarps];
  __shared__ float sm_acc[kDecodeWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][dim(e)] = acc[e];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mall = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mall = fmaxf(mall, sm_m[w]);
    float denom = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      // a warp that owned no key holds m = kNegInf, l = 0, acc = 0
      const float c = expf(sm_m[w] - mall);
      denom += sm_l[w] * c;
      o += sm_acc[w][d] * c;
    }
    if (denom == 0.f) denom = 1.f;
    out[(static_cast<long long>(s) * H + h) * D + d] = from_f32<T>(o / denom);
  }
}

// ----------------------------------------------------------------- prefill
//
// One thread block per (query tile, head). A tile is kTileQ query rows; each
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

// --------------------------------------------------------------- launchers

// P = T: full-precision pools, no scales; P = int8_t: int8 pools with
// their float32 scale pools ks, vs.
template <typename T, typename P, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, const void* bt,
                          const void* pos, void* out, int S, int H, int bs,
                          int MB, long long q_stride, long long kv_stride,
                          float scale, cudaStream_t stream) {
  const dim3 grid(H, S);
  paged_decode_kernel<T, P, D><<<grid, kDecodeWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<T*>(out), H, bs, MB, q_stride,
      kv_stride, scale);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* bt,
                           const void* prefix, void* out, int sq, int H,
                           int bs, int MB, long long q_stride,
                           long long kv_stride, float scale,
                           cudaStream_t stream) {
  const dim3 grid((sq + kTileQ - 1) / kTileQ, H);
  paged_prefill_kernel<T, P, D><<<grid, kPrefillWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(prefix), static_cast<T*>(out), sq, H, bs, MB,
      q_stride, kv_stride, scale);
  return cudaGetLastError();
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

#define PAGED_DISPATCH(LAUNCH, ...)                                          \
  do {                                                                       \
    if (dtype == 0) {                                                        \
      if (D == 32) return LAUNCH<float, 32>(__VA_ARGS__);                    \
      if (D == 64) return LAUNCH<float, 64>(__VA_ARGS__);                    \
      if (D == 128) return LAUNCH<float, 128>(__VA_ARGS__);                  \
    } else if (dtype == 1) {                                                 \
      if (D == 32) return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);            \
      if (D == 64) return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);            \
      if (D == 128) return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);          \
    }                                                                        \
    return cudaErrorInvalidValue;                                            \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out and full-precision pools). D
// must be 32, 64 or 128. Every pointer is a CUDA device pointer; stream is a
// cudaStream_t. q_stride and kv_stride are the row strides, in elements, of
// q and of the pools' token rows; out is dense. The _int8 launchers take
// int8 pools (4-byte aligned) and their dense float32 [num_blocks, bs]
// scale pools k_scale, v_scale. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int paged_decode_attention_launch(int dtype, const void* q,
                                             const void* k, const void* v,
                                             const void* block_tables,
                                             const void* positions, void* out,
                                             int S, int H, int D, int bs,
                                             int MB, long long q_stride,
                                             long long kv_stride, float scale,
                                             void* stream) {
  if (S == 0) return 0;
  PAGED_DISPATCH(decode_fp, q, k, v, nullptr, nullptr, block_tables,
                 positions, out, S, H, bs, MB, q_stride, kv_stride, scale,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int paged_decode_attention_int8_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* positions, void* out, int S, int H, int D, int bs, int MB,
    long long q_stride, long long kv_stride, float scale, void* stream) {
  if (S == 0) return 0;
  PAGED_DISPATCH(decode_i8, q, k, v, k_scale, v_scale, block_tables,
                 positions, out, S, H, bs, MB, q_stride, kv_stride, scale,
                 static_cast<cudaStream_t>(stream));
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
