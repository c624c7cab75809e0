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

// Offset of logical key t of head h through a block table; kv_stride is
// the pool's token-row stride in elements.
__device__ __forceinline__ long long key_row(const int* table, int t, int bs,
                                            long long kv_stride, int h,
                                            int D) {
  const long long blk = table[t / bs];
  return (blk * bs + t % bs) * kv_stride + static_cast<long long>(h) * D;
}

// ------------------------------------------------------------------ decode
//
// One thread block per (head, slot). Its warps split the slot's keys
// 0..positions[s] between them, kDecodeGroup keys at a time (the group's K
// and V rows are loaded together so several loads are in flight per warp).
// Lane l owns dims l, l+32, ... of a row, so every load of a row is one
// coalesced transaction. Each warp keeps its own online softmax state; the
// warps merge theirs through shared memory at the end.

constexpr int kDecodeWarps = 8;
constexpr int kDecodeGroup = 4;

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeWarps * kWarp)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ positions, T* __restrict__ out,
                        int H, int bs, int MB, long long q_stride,
                        long long kv_stride, float scale) {
  constexpr int E = D / kWarp;
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int* table = block_tables + static_cast<long long>(s) * MB;
  const int last = min(positions[s], MB * bs - 1);

  const T* qrow = q + s * q_stride + static_cast<long long>(h) * D;
  float qr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qr[e] = to_f32(qrow[lane + kWarp * e]);

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
        const long long row = key_row(table, t, bs, kv_stride, h, D);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kr[g][e] = to_f32(kp[row + lane + kWarp * e]);
          vr[g][e] = to_f32(vp[row + lane + kWarp * e]);
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
  for (int e = 0; e < E; ++e) sm_acc[warp][lane + kWarp * e] = acc[e];
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
// in the [sq, H, D] layout, so no head-major copy is made.

constexpr int kPrefillWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kTileQ = kPrefillWarps * kRowsPerWarp;
constexpr int kTileK = 16;

template <typename T, int D>
__global__ void __launch_bounds__(kPrefillWarps * kWarp)
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                         const T* __restrict__ vp,
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

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const void* bt, const void* pos, void* out, int S,
                          int H, int bs, int MB, long long q_stride,
                          long long kv_stride, float scale,
                          cudaStream_t stream) {
  const dim3 grid(H, S);
  paged_decode_kernel<T, D><<<grid, kDecodeWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<T*>(out), H, bs, MB, q_stride,
      kv_stride, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const void* bt, const void* prefix, void* out,
                           int sq, int H, int bs, int MB, long long q_stride,
                           long long kv_stride, float scale,
                           cudaStream_t stream) {
  const dim3 grid((sq + kTileQ - 1) / kTileQ, H);
  paged_prefill_kernel<T, D><<<grid, kPrefillWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(prefix), static_cast<T*>(out), sq, H, bs, MB,
      q_stride, kv_stride, scale);
  return cudaGetLastError();
}

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

// dtype: 0 = float32, 1 = bfloat16. D must be 32, 64 or 128. Every pointer
// is a CUDA device pointer; stream is a cudaStream_t. q_stride and kv_stride
// are the row strides, in elements, of q and of the pools' token rows; out
// is dense. Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention_launch(int dtype, const void* q,
                                             const void* k, const void* v,
                                             const void* block_tables,
                                             const void* positions, void* out,
                                             int S, int H, int D, int bs,
                                             int MB, long long q_stride,
                                             long long kv_stride, float scale,
                                             void* stream) {
  if (S == 0) return 0;
  PAGED_DISPATCH(launch_decode, q, k, v, block_tables, positions, out, S, H,
                 bs, MB, q_stride, kv_stride, scale,
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
  PAGED_DISPATCH(launch_prefill, q, k, v, bt_row, prefix_len, out, sq, H, bs,
                 MB, q_stride, kv_stride, scale,
                 static_cast<cudaStream_t>(stream));
}
