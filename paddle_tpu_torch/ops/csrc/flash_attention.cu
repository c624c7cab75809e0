// Flash attention forward and backward, written for Hopper (sm_90a). Three
// kernels, each with a plain C launcher bound from Python with ctypes
// (paddle_tpu_torch/ops/flash_attention.py):
//
//   flash_fwd_kernel      replaces paddle_tpu/ops/pallas_ops.py
//                         _flash_fwd_kernel: blockwise softmax attention with
//                         an online softmax; writes o and the log-sum-exp.
//   flash_bwd_dkv_kernel  replaces pallas_ops.py _flash_bwd_dkv_kernel: dK and
//                         dV of one key tile, reduced over the query tiles.
//   flash_bwd_dq_kernel   replaces pallas_ops.py _flash_bwd_dq_kernel: dQ of
//                         one query tile, reduced over the key tiles.
//
// Layouts (the JAX package's public [batch, seq, heads, head_dim]):
//   q, k, v, o, dO, dq, dk, dv  [B, s, H, D]; the last dim is dense, the
//                               batch, row and head strides are arguments,
//                               so the qkv split's views are read in place.
//   lse, delta                  [B, H, sq] f32, dense (the TPU's 128-lane
//                               broadcast of these residuals is not kept).
//
// Numerics mirror the Pallas bodies: scores q.k in f32 times `scale`; the
// causal test `row + (sk - sq) >= col`; masked scores -1e30; the online
// softmax in f32; p rounded to v's dtype before P.V; one cast of o at the
// end. A row with no key gives o = 0 and lse = -1e30. In the backward pass
// p = exp(s - lse), forced to 0 on masked entries and on rows whose lse is
// -1e30 (else exp(-1e30 - -1e30) = 1 would poison dQ); ds = p (dP - delta)
// scale; p is rounded to dO's dtype for dV, ds to q's dtype for dK and to
// k's dtype for dQ (all one dtype T here); dQ, dK and dV accumulate in f32
// and are cast once.
//
// Tiles. The TPU grid carries its reduction across an "arbitrary" grid axis
// in VMEM scratch; Hopper runs thread blocks in no order, so each block owns
// its whole reduction: the forward one query tile over all its key tiles,
// dK/dV one key tile over all query tiles, dQ one query tile over all key
// tiles. Whole tiles above the causal diagonal are skipped.
//
// Two implementations of each kernel, picked at compile time per (dtype,
// head_dim) by the launchers at the end:
//   - bf16 at head_dim 64 and 128 (the training path) on the tensor cores,
//     all three with Hopper's TMA loads and warpgroup wgmma products,
//     namespace wg;
//   - f32 (whose products must stay f32: the parity runs hold it to 1e-5),
//     float16, and bf16 at head_dim 256: f32 FMAs on the CUDA cores. Tiles
//     live in shared memory as f32 rows padded by 4 floats (16-byte
//     aligned, and conflict-free for the float4 reads). 256 threads form a
//     16 x 16 grid: thread (tr, tc) owns score rows tr + 16 i and columns
//     tc + 16 j, and output columns tc * 4 + 64 q (one float4 each), so
//     every product reads float4s from shared memory and does 16 FMAs per
//     8 loads.
//
// Bound on an H100 SXM: at the training path's [B, 2048, 16, 128] the work
// is about 4 FLOPs per (row, key, dim) forward and 14 backward against a few
// bytes per (row, dim), so all three are bound by operations (989 TFLOP/s on
// the tensor cores). Only wgmma reaches that rate, and only if its operands
// arrive without the warps that multiply waiting for them: each kernel
// (they replace the mma.sync kernels of the first port) has one producer
// warp keep its streamed tiles in flight by TMA while two consumer
// warpgroups multiply, each at its own pace.

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas NEG_INF: finite
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kBQ = 64;            // query rows per tile

// key rows per tile: 32 at D = 256 keeps the backward tiles in shared memory
template <int D>
__host__ __device__ constexpr int block_k() {
  return D > 128 ? 32 : 64;
}

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

// x rounded to T, as the Pallas bodies' astype before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reductions over the 16 threads of one score row (lanes that differ in
// their low four bits)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ const float4& ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Operands of one launch. st[i] = (batch, row, head) strides in elements of
// q, k, v, dO, out0, out1 (forward: out0 = o; dK/dV: out0 = dk, out1 = dv;
// dQ: out0 = dq).
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out0;
  void* out1;
  float* lse;
  const float* delta;
  long long st[6][3];
  int H, sq, sk, causal;
  float scale;
};

template <typename T>
__device__ __forceinline__ T* head(const void* p, const long long* st, int b,
                                   int h) {
  return const_cast<T*>(static_cast<const T*>(p)) + b * st[0] + h * st[2];
}

// rows [r0, r0 + R) of one head into shared rows of stride D + 4, as f32;
// rows at or past n are zero
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int n) {
  constexpr int DP = D + 4;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int row = r0 + r;
    dst[r * DP + d] = row < n ? to_f32(src[row * row_stride + d]) : 0.f;
  }
}

// s[i][j] = sum_d A[tr + 16 i][d] * B[tc + 16 j][d] over shared rows of
// stride D + 4
template <int D, int RI, int CJ>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int tr, int tc, float (&s)[RI][CJ]) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = ld4(A + (tr + 16 * i) * DP + d);
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = ld4(B + (tc + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][q] += sum_n W[tr + 16 i][n] * X[n][tc * 4 + 64 q .. + 3] for n in
// [0, N): W rows of stride WP, X rows of stride D + 4
template <int D, int RI, int N, int WP>
__device__ __forceinline__ void tile_acc(const float* W, const float* X,
                                         int tr, int tc,
                                         float4 (&acc)[RI][D / 64]) {
  constexpr int DP = D + 4;
  constexpr int DQ = D / 64;
#pragma unroll 2
  for (int n = 0; n < N; n += 4) {
    float4 w[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) w[i] = ld4(W + (tr + 16 * i) * WP + n);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 x[DQ];
#pragma unroll
      for (int q = 0; q < DQ; ++q) x[q] = ld4(X + (n + u) * DP + tc * 4 + 64 * q);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float wu = part(w[i], u);
#pragma unroll
        for (int q = 0; q < DQ; ++q) fma4(acc[i][q], wu, x[q]);
      }
    }
  }
}

// rows r0 + tr + 16 i (i < RI) of acc, scaled by inv[i], into a [.., D] head
// whose rows are row_stride apart; rows at or past n are not written
template <typename T, int D, int RI>
__device__ __forceinline__ void store_rows(T* dst, long long row_stride,
                                           int r0, int n, int tr, int tc,
                                           const float4 (&acc)[RI][D / 64],
                                           const float (&inv)[RI]) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = r0 + tr + 16 * i;
    if (row >= n) continue;
    T* out = dst + row * row_stride + tc * 4;
#pragma unroll
    for (int q = 0; q < D / 64; ++q) {
      out[64 * q + 0] = from_f32<T>(acc[i][q].x * inv[i]);
      out[64 * q + 1] = from_f32<T>(acc[i][q].y * inv[i]);
      out[64 * q + 2] = from_f32<T>(acc[i][q].z * inv[i]);
      out[64 * q + 3] = from_f32<T>(acc[i][q].w * inv[i]);
    }
  }
}

// ----------------------------------------------------------------- forward
//
// One block per (query tile, batch x head). It stages its query rows once,
// then walks the key tiles up to the causal reach of its last row: S = Q K^T
// in registers, the online softmax per row (max and sum across the row's 16
// threads by shuffles), p rounded to T through shared memory, then P V into
// the f32 accumulator. Blocks of later query tiles have more key tiles under
// a causal mask, so they are scheduled first.

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         ((kBQ + 2 * block_k<D>()) * (D + 4) + kBQ * (block_k<D>() + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const Params a) {
  constexpr int BK = block_k<D>();
  constexpr int DP = D + 4, PP = BK + 4;
  constexpr int RI = kBQ / 16, CJ = BK / 16, DQ = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const T* q = head<T>(a.q, a.st[0], b, h);
  const T* k = head<T>(a.k, a.st[1], b, h);
  const T* v = head<T>(a.v, a.st[2], b, h);
  const int offset = a.sk - a.sq;
  load_rows<T, D, kBQ>(Qs, q, a.st[0][1], q0, a.sq);

  float m[RI], l[RI];
  float4 acc[RI][DQ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DQ; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // keys past the reach of the tile's last row are masked for every row
  const int k_end = a.causal ? min(a.sk, q0 + kBQ + offset) : a.sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tiles are consumed
    load_rows<T, D, BK>(Ks, k, a.st[1][1], k0, a.sk);
    load_rows<T, D, BK>(Vs, v, a.st[2][1], k0, a.sk);
    __syncthreads();
    float s[RI][CJ];
    tile_dot<D, RI, CJ>(Qs, Ks, tr, tc, s);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + tr + 16 * i;
      bool ok[CJ];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tc + 16 * j;
        ok[j] = col < a.sk && (!a.causal || col <= row + offset);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float corr = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mx) : 0.f;
        sum += p;
        Ps[(tr + 16 * i) * PP + tc + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < DQ; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
    }
    __syncthreads();  // P is in shared memory
    tile_acc<D, RI, BK, PP>(Ps, Vs, tr, tc, acc);
  }

  float inv[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  store_rows<T, D, RI>(head<T>(a.out0, a.st[4], b, h), a.st[4][1], q0, a.sq,
                       tr, tc, acc, inv);
  if (tc == 0) {
    float* lse = a.lse + static_cast<long long>(blockIdx.y) * a.sq;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + tr + 16 * i;
      if (row < a.sq) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
    }
  }
}

// ---------------------------------------------------------------- backward
//
// Both backward kernels recompute S = Q K^T and dP = dO V^T tile by tile
// from the saved lse and the f32 delta = rowsum(dO * O), as the Pallas
// bodies do (_bwd_common).

// p and ds of one score tile; rows r0 + tr + 16 i, keys k0 + tc + 16 j
template <typename T, int RI, int CJ>
__device__ __forceinline__ void probs_and_dscores(
    const Params& a, int r0, int k0, int tr, int tc, const float* Ls,
    const float* Ds, float (&s)[RI][CJ], float (&dp)[RI][CJ]) {
  const int offset = a.sk - a.sq;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = tr + 16 * i;
    const int row = r0 + r;
    const float lse = Ls[r];
    const bool live = row < a.sq && lse > kNegInf * 0.5f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = k0 + tc + 16 * j;
      const bool ok =
          live && col < a.sk && (!a.causal || col <= row + offset);
      const float p = ok ? expf(s[i][j] * a.scale - lse) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - Ds[r]) * a.scale;
    }
  }
}

template <int R>
__device__ __forceinline__ void load_residuals(float* Ls, float* Ds,
                                               const Params& a, int r0) {
  const long long base = static_cast<long long>(blockIdx.y) * a.sq;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int row = r0 + r;
    Ls[r] = row < a.sq ? a.lse[base + row] : kNegInf;
    Ds[r] = row < a.sq ? a.delta[base + row] : 0.f;
  }
}

// dK/dV: one block per (key tile, batch x head). K and V stay in shared
// memory; the block walks the query tiles that reach its keys, writes p and
// ds of each score tile transposed into shared memory, and accumulates
// dV += P^T dO and dK += dS^T Q with the key rows as its output rows.

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * block_k<D>() + 2 * kBQ) * (D + 4) +
                          2 * block_k<D>() * (kBQ + 4) + 2 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const Params a) {
  constexpr int BK = block_k<D>();
  constexpr int DP = D + 4, TP = kBQ + 4;
  constexpr int RI = kBQ / 16, CJ = BK / 16, RK = BK / 16, DQ = D / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * DP;
  float* Qs = Vs + BK * DP;
  float* Os = Qs + kBQ * DP;  // dO rows
  float* Pt = Os + kBQ * DP;  // [BK][kBQ + 4]: p transposed
  float* St = Pt + BK * TP;   // [BK][kBQ + 4]: ds transposed
  float* Ls = St + BK * TP;
  float* Ds = Ls + kBQ;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const T* q = head<T>(a.q, a.st[0], b, h);
  const T* dout = head<T>(a.dout, a.st[3], b, h);
  load_rows<T, D, BK>(Ks, head<T>(a.k, a.st[1], b, h), a.st[1][1], k0, a.sk);
  load_rows<T, D, BK>(Vs, head<T>(a.v, a.st[2], b, h), a.st[2][1], k0, a.sk);

  float4 dk[RK][DQ], dv[RK][DQ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < DQ; ++c)
      dk[i][c] = dv[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // rows before k0 - offset see none of this tile's keys
  const int i_begin =
      a.causal ? max(0, k0 - (a.sk - a.sq)) / kBQ * kBQ : 0;
  for (int i0 = i_begin; i0 < a.sq; i0 += kBQ) {
    __syncthreads();  // the previous query tile is consumed
    load_rows<T, D, kBQ>(Qs, q, a.st[0][1], i0, a.sq);
    load_rows<T, D, kBQ>(Os, dout, a.st[3][1], i0, a.sq);
    load_residuals<kBQ>(Ls, Ds, a, i0);
    __syncthreads();
    float s[RI][CJ], dp[RI][CJ];
    tile_dot<D, RI, CJ>(Qs, Ks, tr, tc, s);
    tile_dot<D, RI, CJ>(Os, Vs, tr, tc, dp);
    probs_and_dscores<T, RI, CJ>(a, i0, k0, tr, tc, Ls, Ds, s, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        Pt[(tc + 16 * j) * TP + tr + 16 * i] = round_to<T>(s[i][j]);
        St[(tc + 16 * j) * TP + tr + 16 * i] = round_to<T>(dp[i][j]);
      }
    __syncthreads();  // P^T and dS^T are in shared memory
    tile_acc<D, RK, kBQ, TP>(Pt, Os, tr, tc, dv);
    tile_acc<D, RK, kBQ, TP>(St, Qs, tr, tc, dk);
  }

  float one[RK];
#pragma unroll
  for (int i = 0; i < RK; ++i) one[i] = 1.f;
  store_rows<T, D, RK>(head<T>(a.out0, a.st[4], b, h), a.st[4][1], k0, a.sk,
                       tr, tc, dk, one);
  store_rows<T, D, RK>(head<T>(a.out1, a.st[5], b, h), a.st[5][1], k0, a.sk,
                       tr, tc, dv, one);
}

// dQ: one block per (query tile, batch x head). Q, dO and the residuals of
// its rows stay in shared memory; the block walks the key tiles up to the
// causal reach of its last row and accumulates dQ += dS K.

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * kBQ + 2 * block_k<D>()) * (D + 4) +
                          kBQ * (block_k<D>() + 4) + 2 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const Params a) {
  constexpr int BK = block_k<D>();
  constexpr int DP = D + 4, PP = BK + 4;
  constexpr int RI = kBQ / 16, CJ = BK / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + kBQ * DP;  // dO rows
  float* Ks = Os + kBQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ss = Vs + BK * DP;  // [kBQ][BK + 4]: ds
  float* Ls = Ss + kBQ * PP;
  float* Ds = Ls + kBQ;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const T* k = head<T>(a.k, a.st[1], b, h);
  const T* v = head<T>(a.v, a.st[2], b, h);
  load_rows<T, D, kBQ>(Qs, head<T>(a.q, a.st[0], b, h), a.st[0][1], q0, a.sq);
  load_rows<T, D, kBQ>(Os, head<T>(a.dout, a.st[3], b, h), a.st[3][1], q0,
                       a.sq);
  load_residuals<kBQ>(Ls, Ds, a, q0);

  float4 dq[RI][D / 64];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < D / 64; ++c) dq[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int k_end =
      a.causal ? min(a.sk, q0 + kBQ + (a.sk - a.sq)) : a.sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous key tile is consumed
    load_rows<T, D, BK>(Ks, k, a.st[1][1], k0, a.sk);
    load_rows<T, D, BK>(Vs, v, a.st[2][1], k0, a.sk);
    __syncthreads();
    float s[RI][CJ], dp[RI][CJ];
    tile_dot<D, RI, CJ>(Qs, Ks, tr, tc, s);
    tile_dot<D, RI, CJ>(Os, Vs, tr, tc, dp);
    probs_and_dscores<T, RI, CJ>(a, q0, k0, tr, tc, Ls, Ds, s, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        Ss[(tr + 16 * i) * PP + tc + 16 * j] = round_to<T>(dp[i][j]);
    __syncthreads();  // dS is in shared memory
    tile_acc<D, RI, BK, PP>(Ss, Ks, tr, tc, dq);
  }

  float one[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) one[i] = 1.f;
  store_rows<T, D, RI>(head<T>(a.out0, a.st[4], b, h), a.st[4][1], q0, a.sq,
                       tr, tc, dq, one);
}

// ------------------------------------- forward: TMA and wgmma (Hopper only)
//
// bf16 at head_dim 64 and 128. One block per (128 query rows, batch x
// head) and three warpgroups:
//   - warpgroup 0 is the producer: one thread issues TMA loads
//     (cp.async.bulk.tensor) of the block's Q tile, then of each K and V
//     tile of kBK keys into a ring of stages<D>() stages, each stage guarded
//     by a "full" mbarrier (the copies' bytes have landed) and an "empty"
//     one (both consumers are done with it). It hands its registers to the
//     consumers (setmaxnreg).
//   - warpgroups 1 and 2 are consumers, 64 query rows each. S = Q K^T is a
//     wgmma from shared memory (Q and K both K-major); P stays in registers
//     and is the A operand of O += P V, with V read MN-major (the transpose
//     bit of wgmma for bf16).
// A TMA tensor map per operand spans the [B, s, H, D] view with its strides
// (the qkv split's views are read in place); it loads boxes of 64 columns
// (128 bytes, the limit of the 128-byte swizzle wgmma reads) x kBK rows, so
// a D = 128 row comes in two boxes, stored as two column halves. Rows past s
// arrive as zeros. Key tiles past the causal reach of the block's last row
// are never loaded; a consumer skips a tile past its own rows' reach, and
// masks only a tile that crosses its diagonal or the last key.

namespace wg {

using namespace ::tc;  // tensor_core.cuh

constexpr int kBQ = 128;  // query rows per block: two consumers of 64
constexpr int kBK = 128;  // keys per tile
constexpr int kThreads = 384;

// ring depth: the shared memory of Q and the stages stays under 227 KB
template <int D>
__host__ __device__ constexpr int stages() {
  return D > 64 ? 2 : 3;
}

template <int D>
constexpr size_t fwd_smem() {
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte
  // period, the tiles, then 2 mbarriers per stage and one for Q
  return 1024 + sizeof(bf16) * (kBQ + 2 * stages<D>() * kBK) * D +
         8 * (2 * stages<D>() + 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of the 4-d map at (column, head, row, batch) into dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int h, int r,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c),
      "r"(h), "r"(r), "r"(b)
      : "memory");
}

// a wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lead,
                                         uint32_t stride) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lead >> 4) << 16 |
         static_cast<uint64_t>(stride >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of an accumulator above wg_wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (+)= A . B^T, A [64 x 16] and B [N x 16] K-major in shared memory
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 8][4], uint64_t a,
                                       uint64_t b, int accumulate);
// d += A . B, A [64 x 16] in registers (mma.sync's A fragment per warp), B
// [16 x N] MN-major in shared memory
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 8][4],
                                       const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[8][4],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[16][4], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[16][4],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params a) {
  constexpr int NS = stages<D>();
  constexpr int NH = D / 64;  // 64-column boxes per row
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  bf16* Ks = Qs + kBQ * D;     // stage s: Ks + s * kBK * D, [NH][kBK][64]
  bf16* Vs = Ks + NS * kBK * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + NS * kBK * D);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int offset = a.sk - a.sq;
  // keys past the reach of the block's last row are masked for every row
  const int k_end = a.causal ? min(a.sk, q0 + kBQ + offset) : a.sk;
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      bar_expect(qbar, sizeof(bf16) * kBQ * D);
      for (int c = 0; c < NH; ++c)
        tma_load(Qs + c * kBQ * 64, &tq, qbar, c * 64, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS;
        if (j >= NS) bar_wait(empty + s, (j / NS - 1) & 1);
        bar_expect(full + s, 2 * sizeof(bf16) * kBK * D);
        for (int c = 0; c < NH; ++c) {
          tma_load(Ks + (s * NH + c) * kBK * 64, &tk, full + s, c * 64, h,
                   j * kBK, b);
          tma_load(Vs + (s * NH + c) * kBK * 64, &tv, full + s, c * 64, h,
                   j * kBK, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int r_lo = q0 + cw * 64;  // this consumer's rows r_lo .. r_lo + 63
  const int row0 = r_lo + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  bar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS;
    const int k0 = j * kBK;
    bar_wait(full + s, (j / NS) & 1);
    // every key of the tile lies past every row of this consumer
    if (!(a.causal && k0 > r_lo + 63 + offset)) {
      const bf16* K = Ks + s * NH * kBK * 64;
      const bf16* V = Vs + s * NH * kBK * 64;
      float S[kBK / 8][4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<kBK>(S,
                    desc(Qs + ((kk / 4) * kBQ + cw * 64) * 64 + (kk % 4) * 16,
                         16, 1024),
                    desc(K + (kk / 4) * kBK * 64 + (kk % 4) * 16, 16, 1024),
                    kk > 0);
      wg_commit();
      wg_wait();
      pin(S);
      float mx[2] = {m[0], m[1]};
      if ((a.causal && k0 + kBK - 1 > r_lo + offset) || k0 + kBK > a.sk) {
#pragma unroll
        for (int jn = 0; jn < kBK / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e >> 1);
            const int col = k0 + jn * 8 + 2 * t + (e & 1);
            const bool ok = col < a.sk && (!a.causal || col <= row + offset);
            S[jn][e] = ok ? S[jn][e] * a.scale : kNegInf;
            mx[e >> 1] = fmaxf(mx[e >> 1], S[jn][e]);
          }
      } else {
#pragma unroll
        for (int jn = 0; jn < kBK / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            S[jn][e] *= a.scale;
            mx[e >> 1] = fmaxf(mx[e >> 1], S[jn][e]);
          }
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = __expf(m[r] - mx[r]);
      }
      // P rounded to bf16: the A fragments of P . V (a masked score's p is
      // 0, also in a row that has no key yet, whose max is kNegInf)
      uint32_t P[kBK / 16][4];
#pragma unroll
      for (int jn = 0; jn < kBK / 8; ++jn) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = S[jn][e] > 0.5f * kNegInf ? __expf(S[jn][e] - mx[e >> 1])
                                           : 0.f;
          sum[e >> 1] += p[e];
        }
        P[jn / 2][(jn & 1) * 2] = pack(p[0], p[1]);
        P[jn / 2][(jn & 1) * 2 + 1] = pack(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * corr[r] + quad_sum(sum[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= corr[0];
        o[dn][1] *= corr[0];
        o[dn][2] *= corr[1];
        o[dn][3] *= corr[1];
      }
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc)
        mma_rs<D>(o, P[kc], desc(V + kc * 16 * 64, kBK * 128, 1024));
      wg_commit();
      wg_wait();
      pin(o);
    }
    if (lane == 0) bar_arrive(empty + s);  // this warp is done with stage s
  }

  const float inv[2] = {1.f / (l[0] == 0.f ? 1.f : l[0]),
                        1.f / (l[1] == 0.f ? 1.f : l[1])};
  store<D>(head<bf16>(a.out0, a.st[4], b, h), a.st[4][1], row0, a.sq, t, o,
           inv);
  if (t == 0) {
    float* lse = a.lse + static_cast<long long>(blockIdx.y) * a.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.sq) lse[row] = l[r] > 0.f ? m[r] + logf(l[r]) : kNegInf;
    }
  }
}

// ----------------------------------- backward: TMA and wgmma (Hopper only)
//
// bf16 at head_dim 64 and 128, in the forward's shape: warpgroup 0 is the
// producer, whose first warp keeps TMA loads in flight through a ring of
// stages guarded by "full" and "empty" mbarriers and then hands its
// registers to the consumers (setmaxnreg); warpgroups 1 and 2 are consumers
// of 64 rows each, and every product is a wgmma. Both kernels recompute S
// and dP from the saved lse and delta, as the Pallas _bwd_common does. The
// lse of a row with no key (-1e30) or past sq is taken as +inf, so exp
// gives its p = 0 with no test in the inner loop; masks apply only on tiles
// that cross the causal diagonal or the last key. p (for dV) and ds (for dK
// and dQ) are rounded to bf16 as they become the register A fragments of
// the second products: the Pallas bodies' rounding points.
//
// Bound on an H100 SXM at the training path's [8, 2048, 16, 128] causal:
// 8 d FLOPs per kept (row, key) pair for dK/dV (S, dP, dV, dK) and 6 d for
// dQ (S, dP, dQ), against a few bytes per (row, dim): both are bound by
// operations (989 TFLOP/s). So the design keeps the tensor cores fed: a
// block's operands arrive by TMA while its other consumer multiplies, the
// products are wgmma (the only way to the full rate), and exp is __expf.

constexpr int kDkvKeys = 128;  // keys per dK/dV block: two consumers of 64
constexpr int kDkvRows = 64, kDkvStages = 3;  // query rows per tile, ring
constexpr int kDqRows = 128;  // query rows per dQ block: two consumers of 64
constexpr int kDqKeys = 128, kDqStages = 2;  // keys per tile, ring

__device__ __forceinline__ float positive_inf() {
  return __int_as_float(0x7f800000);
}

// p and ds of one consumer's 64 x N score tile s (dp: the dO V^T tile),
// rounded to bf16 into the A fragments pa and dsa of the next products.
// res(j, e) gives (lse, delta) of fragment element e of s[j]; keep(j, e)
// its mask, read only with kMask.
template <bool kMask, int N, typename Res, typename Keep>
__device__ __forceinline__ void probs(const float (&s)[N / 8][4],
                                      const float (&dp)[N / 8][4],
                                      float scale, Res res, Keep keep,
                                      uint32_t (&pa)[N / 16][4],
                                      uint32_t (&dsa)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 r = res(j, e);
      p[e] = __expf(s[j][e] * scale - r.x);
      if (kMask && !keep(j, e)) p[e] = 0.f;
      ds[e] = p[e] * (dp[j][e] - r.y) * scale;
    }
    pa[j / 2][(j & 1) * 2] = pack(p[0], p[1]);
    pa[j / 2][(j & 1) * 2 + 1] = pack(p[2], p[3]);
    dsa[j / 2][(j & 1) * 2] = pack(ds[0], ds[1]);
    dsa[j / 2][(j & 1) * 2 + 1] = pack(ds[2], ds[3]);
  }
}

template <int D>
constexpr size_t dkv_smem() {
  // alignment slack, K and V, the ring of Q and dO tiles, the lse and delta
  // of each stage, 2 mbarriers per stage and one for K and V
  return 1024 +
         sizeof(bf16) * (2 * kDkvKeys + 2 * kDkvStages * kDkvRows) * D +
         sizeof(float) * 2 * kDkvStages * kDkvRows + 8 * (2 * kDkvStages + 1);
}

// dK/dV replaces pallas_ops.py _flash_bwd_dkv_kernel: one block per (128
// keys, batch x head). The producer loads the block's K and V once, then
// streams the Q and dO tiles of the query rows that reach those keys,
// starting at the first such tile (the early key blocks, which have the
// most tiles, are scheduled first); its 32 lanes write each tile's lse and
// delta and each arrives on the stage's barrier. Each consumer owns 64
// keys: S^T = K Q^T and dP^T = V dO^T from shared memory (both K-major),
// P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q with dO and
// Q read MN-major from the same tiles. dK and dV (64 x D f32 each) stay in
// registers for the whole walk. Bound at [8, 2048, 16, 128] causal: 0.278
// ms of operations.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const Params a) {
  constexpr int NS = kDkvStages, BQ = kDkvRows, BK = kDkvKeys;
  constexpr int NH = D / 64;  // 64-column boxes per row
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  bf16* Vs = Ks + BK * D;       // K and V: [NH][BK][64]
  bf16* Qs = Vs + BK * D;       // stage s: Qs + s * BQ * D, [NH][BQ][64]
  bf16* Os = Qs + NS * BQ * D;  // dO, as Qs
  float* Ls = reinterpret_cast<float*>(Os + NS * BQ * D);  // [NS][BQ]
  float* Ds = Ls + NS * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(Ds + NS * BQ);
  uint64_t* empty = full + NS;
  uint64_t* kvbar = empty + NS;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int offset = a.sk - a.sq;
  // rows before k0 - offset see none of the block's keys
  const int i_begin = a.causal ? max(0, k0 - offset) / BQ * BQ : 0;
  const int n_tiles = a.sq > i_begin ? (a.sq - i_begin + BQ - 1) / BQ : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(full + s, 32);  // every lane of the producer warp
      bar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    bar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        bar_expect(kvbar, 2 * sizeof(bf16) * BK * D);
        for (int c = 0; c < NH; ++c) {
          tma_load(Ks + c * BK * 64, &tk, kvbar, c * 64, h, k0, b);
          tma_load(Vs + c * BK * 64, &tv, kvbar, c * 64, h, k0, b);
        }
      }
      const float* lse = a.lse + static_cast<long long>(blockIdx.y) * a.sq;
      const float* delta =
          a.delta + static_cast<long long>(blockIdx.y) * a.sq;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS, i0 = i_begin + j * BQ;
        if (j >= NS) bar_wait(empty + s, (j / NS - 1) & 1);
        for (int r = lane; r < BQ; r += 32) {
          const int row = i0 + r;
          const float l = row < a.sq ? lse[row] : kNegInf;
          Ls[s * BQ + r] = l > 0.5f * kNegInf ? l : positive_inf();
          Ds[s * BQ + r] = row < a.sq ? delta[row] : 0.f;
        }
        if (lane == 0) {
          bar_expect(full + s, 2 * sizeof(bf16) * BQ * D);
          for (int c = 0; c < NH; ++c) {
            tma_load(Qs + (s * NH + c) * BQ * 64, &tq, full + s, c * 64, h,
                     i0, b);
            tma_load(Os + (s * NH + c) * BQ * 64, &tdo, full + s, c * 64, h,
                     i0, b);
          }
        } else {
          bar_arrive(full + s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int kc0 = k0 + cw * 64;  // this consumer's keys kc0 .. kc0 + 63
  const int key0 = kc0 + warp * 16 + (lane >> 2);  // keys key0, key0 + 8
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  bar_wait(kvbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS, i0 = i_begin + j * BQ;
    bar_wait(full + s, (j / NS) & 1);
    // the tile's last row reaches this consumer's first key
    if (!(a.causal && kc0 > i0 + BQ - 1 + offset)) {
      const bf16* Q = Qs + s * NH * BQ * 64;
      const bf16* O = Os + s * NH * BQ * 64;
      float St[BQ / 8][4], dPt[BQ / 8][4];  // S^T, dP^T: keys x rows
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BQ>(St,
                   desc(Ks + ((kk / 4) * BK + cw * 64) * 64 + (kk % 4) * 16,
                        16, 1024),
                   desc(Q + (kk / 4) * BQ * 64 + (kk % 4) * 16, 16, 1024),
                   kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BQ>(dPt,
                   desc(Vs + ((kk / 4) * BK + cw * 64) * 64 + (kk % 4) * 16,
                        16, 1024),
                   desc(O + (kk / 4) * BQ * 64 + (kk % 4) * 16, 16, 1024),
                   kk > 0);
      wg_commit();
      wg_wait();
      pin(St);
      pin(dPt);
      const float* L = Ls + s * BQ;
      const float* Dl = Ds + s * BQ;
      // element e of column block jn is query row i0 + 8 jn + 2 t + e % 2
      auto res = [&](int jn, int e) {
        const int c = jn * 8 + 2 * t + (e & 1);
        return make_float2(L[c], Dl[c]);
      };
      auto keep = [&](int jn, int e) {
        const int key = key0 + 8 * (e >> 1);
        const int qrow = i0 + jn * 8 + 2 * t + (e & 1);
        return key < a.sk && (!a.causal || key <= qrow + offset);
      };
      uint32_t P[BQ / 16][4], dS[BQ / 16][4];
      if ((a.causal && kc0 + 63 > i0 + offset) || kc0 + 64 > a.sk)
        probs<true, BQ>(St, dPt, a.scale, res, keep, P, dS);
      else
        probs<false, BQ>(St, dPt, a.scale, res, keep, P, dS);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        mma_rs<D>(dv, P[kc], desc(O + kc * 16 * 64, BQ * 128, 1024));
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        mma_rs<D>(dk, dS[kc], desc(Q + kc * 16 * 64, BQ * 128, 1024));
      wg_commit();
      wg_wait();
      pin(dv);
      pin(dk);
    }
    if (lane == 0) bar_arrive(empty + s);  // this warp is done with stage s
  }

  const float one[2] = {1.f, 1.f};
  store<D>(head<bf16>(a.out0, a.st[4], b, h), a.st[4][1], key0, a.sk, t, dk,
           one);
  store<D>(head<bf16>(a.out1, a.st[5], b, h), a.st[5][1], key0, a.sk, t, dv,
           one);
}

template <int D>
constexpr size_t dq_smem() {
  // alignment slack, Q and dO, the ring of K and V tiles, 2 mbarriers per
  // stage and one for Q and dO
  return 1024 + sizeof(bf16) * (2 * kDqRows + 2 * kDqStages * kDqKeys) * D +
         8 * (2 * kDqStages + 1);
}

// dQ replaces pallas_ops.py _flash_bwd_dq_kernel: one block per (128 query
// rows, batch x head), the last query blocks (the longest causal walks)
// scheduled first. The producer loads the block's Q and dO once, then
// streams K and V tiles up to the causal reach of the block's last row;
// key tiles past it are never loaded. Each consumer owns 64 rows, whose lse
// and delta it keeps in registers: S = Q K^T and dP = dO V^T from shared
// memory, dS in registers, then dQ += dS K with K read MN-major. On an
// H100, 128-key tiles (two stages) ran 10% faster than 64-key ones (three;
// tools/flash_bwd_variants.py). Bound at [8, 2048, 16, 128] causal: 0.209
// ms of operations.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const Params a) {
  constexpr int NS = kDqStages, BQ = kDqRows, BK = kDqKeys;
  constexpr int NH = D / 64;  // 64-column boxes per row
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  bf16* Os = Qs + BQ * D;  // Q and dO: [NH][BQ][64]
  bf16* Ks = Os + BQ * D;  // stage s: Ks + s * BK * D, [NH][BK][64]
  bf16* Vs = Ks + NS * BK * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + NS * BK * D);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int offset = a.sk - a.sq;
  // keys past the reach of the block's last row are masked for every row
  const int k_end = a.causal ? min(a.sk, q0 + BQ + offset) : a.sk;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      bar_expect(qbar, 2 * sizeof(bf16) * BQ * D);
      for (int c = 0; c < NH; ++c) {
        tma_load(Qs + c * BQ * 64, &tq, qbar, c * 64, h, q0, b);
        tma_load(Os + c * BQ * 64, &tdo, qbar, c * 64, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS;
        if (j >= NS) bar_wait(empty + s, (j / NS - 1) & 1);
        bar_expect(full + s, 2 * sizeof(bf16) * BK * D);
        for (int c = 0; c < NH; ++c) {
          tma_load(Ks + (s * NH + c) * BK * 64, &tk, full + s, c * 64, h,
                   j * BK, b);
          tma_load(Vs + (s * NH + c) * BK * 64, &tv, full + s, c * 64, h,
                   j * BK, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int r_lo = q0 + cw * 64;  // this consumer's rows r_lo .. r_lo + 63
  const int row0 = r_lo + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int reach = r_lo + 63 + offset;  // the last key its rows see
  const long long base = static_cast<long long>(blockIdx.y) * a.sq;
  float lse[2], delta[2];
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l = row < a.sq ? a.lse[base + row] : kNegInf;
    lse[r] = l > 0.5f * kNegInf ? l : positive_inf();
    delta[r] = row < a.sq ? a.delta[base + row] : 0.f;
    lim[r] = row + offset;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
  bar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS;
    const int k0 = j * BK;
    bar_wait(full + s, (j / NS) & 1);
    if (!(a.causal && k0 > reach)) {
      const bf16* K = Ks + s * NH * BK * 64;
      const bf16* V = Vs + s * NH * BK * 64;
      float S[BK / 8][4], dP[BK / 8][4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BK>(S,
                   desc(Qs + ((kk / 4) * BQ + cw * 64) * 64 + (kk % 4) * 16,
                        16, 1024),
                   desc(K + (kk / 4) * BK * 64 + (kk % 4) * 16, 16, 1024),
                   kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BK>(dP,
                   desc(Os + ((kk / 4) * BQ + cw * 64) * 64 + (kk % 4) * 16,
                        16, 1024),
                   desc(V + (kk / 4) * BK * 64 + (kk % 4) * 16, 16, 1024),
                   kk > 0);
      wg_commit();
      wg_wait();
      pin(S);
      pin(dP);
      auto res = [&](int, int e) {
        return make_float2(lse[e >> 1], delta[e >> 1]);
      };
      // element e of key block jn is key k0 + 8 jn + 2 t + e % 2
      auto keep = [&](int jn, int e) {
        const int col = k0 + jn * 8 + 2 * t + (e & 1);
        return col < a.sk && (!a.causal || col <= lim[e >> 1]);
      };
      uint32_t P[BK / 16][4], dS[BK / 16][4];  // P is not used here
      if ((a.causal && k0 + BK - 1 > r_lo + offset) || k0 + BK > a.sk)
        probs<true, BK>(S, dP, a.scale, res, keep, P, dS);
      else
        probs<false, BK>(S, dP, a.scale, res, keep, P, dS);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        mma_rs<D>(dq, dS[kc], desc(K + kc * 16 * 64, BK * 128, 1024));
      wg_commit();
      wg_wait();
      pin(dq);
    }
    if (lane == 0) bar_arrive(empty + s);  // this warp is done with stage s
  }

  const float one[2] = {1.f, 1.f};
  store<D>(head<bf16>(a.out0, a.st[4], b, h), a.st[4][1], row0, a.sq, t, dq,
           one);
}

}  // namespace wg

// --------------------------------------------------------------- launchers

// sets the kernel's dynamic shared memory, launches it on stream and
// returns the launch's error
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, dim3 grid,
                   cudaStream_t stream, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// bf16 at head_dim 64 and 128 runs on the tensor cores; f32, float16 and
// head_dim 256 on the CUDA cores
template <typename T, int D>
constexpr bool on_tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value && D <= 128;
}

// cuTensorMapEncodeTiled, a libcuda entry point looked up through the
// runtime, so the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got);
#endif
    return err == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a bf16 [B, s, H, D] operand with (batch, row, head)
// element strides st: boxes of 64 columns x `rows` rows of one (head,
// batch), 128-byte swizzled, rows past s read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, const long long* st,
                int B, int s, int H, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(s > 0 ? s : 1),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
cudaError_t launch_fwd(const Params& p, int B, cudaStream_t stream) {
  if constexpr (on_tensor_cores<T, D>()) {
    CUtensorMap tq, tk, tv;
    if (!tensor_map(&tq, p.q, p.st[0], B, p.sq, p.H, D, wg::kBQ) ||
        !tensor_map(&tk, p.k, p.st[1], B, p.sk, p.H, D, wg::kBK) ||
        !tensor_map(&tv, p.v, p.st[2], B, p.sk, p.H, D, wg::kBK))
      return cudaErrorInvalidValue;
    const dim3 grid((p.sq + wg::kBQ - 1) / wg::kBQ, B * p.H);
    return launch(wg::flash_fwd_kernel<D>, wg::kThreads, wg::fwd_smem<D>(),
                  grid, stream, tq, tk, tv, p);
  } else {
    const dim3 grid((p.sq + kBQ - 1) / kBQ, B * p.H);
    return launch(flash_fwd_kernel<T, D>, kThreads, fwd_smem<D>(), grid,
                  stream, p);
  }
}

// the TMA maps of q and dO (boxes of `rows` rows) and of k and v (boxes of
// `keys` rows) of a backward launch
bool bwd_maps(CUtensorMap (&m)[4], const Params& p, int B, int D, int rows,
              int keys) {
  return tensor_map(&m[0], p.q, p.st[0], B, p.sq, p.H, D, rows) &&
         tensor_map(&m[1], p.k, p.st[1], B, p.sk, p.H, D, keys) &&
         tensor_map(&m[2], p.v, p.st[2], B, p.sk, p.H, D, keys) &&
         tensor_map(&m[3], p.dout, p.st[3], B, p.sq, p.H, D, rows);
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, int B, cudaStream_t stream) {
  if constexpr (on_tensor_cores<T, D>()) {
    CUtensorMap m[4];
    if (!bwd_maps(m, p, B, D, wg::kDkvRows, wg::kDkvKeys))
      return cudaErrorInvalidValue;
    const dim3 grid((p.sk + wg::kDkvKeys - 1) / wg::kDkvKeys, B * p.H);
    return launch(wg::flash_bwd_dkv_kernel<D>, wg::kThreads,
                  wg::dkv_smem<D>(), grid, stream, m[0], m[1], m[2], m[3], p);
  } else {
    const dim3 grid((p.sk + block_k<D>() - 1) / block_k<D>(), B * p.H);
    return launch(flash_bwd_dkv_kernel<T, D>, kThreads, dkv_smem<D>(), grid,
                  stream, p);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, int B, cudaStream_t stream) {
  if constexpr (on_tensor_cores<T, D>()) {
    CUtensorMap m[4];
    if (!bwd_maps(m, p, B, D, wg::kDqRows, wg::kDqKeys))
      return cudaErrorInvalidValue;
    const dim3 grid((p.sq + wg::kDqRows - 1) / wg::kDqRows, B * p.H);
    return launch(wg::flash_bwd_dq_kernel<D>, wg::kThreads, wg::dq_smem<D>(),
                  grid, stream, m[0], m[1], m[2], m[3], p);
  } else {
    const dim3 grid((p.sq + kBQ - 1) / kBQ, B * p.H);
    return launch(flash_bwd_dq_kernel<T, D>, kThreads, dq_smem<D>(), grid,
                  stream, p);
  }
}

#define FLASH_DISPATCH(LAUNCH)                                               \
  do {                                                                       \
    if (dtype == 0) {                                                        \
      if (D == 64) return LAUNCH<float, 64>(p, B, s);                        \
      if (D == 128) return LAUNCH<float, 128>(p, B, s);                      \
      if (D == 256) return LAUNCH<float, 256>(p, B, s);                      \
    } else if (dtype == 1) {                                                 \
      if (D == 64) return LAUNCH<__nv_bfloat16, 64>(p, B, s);                \
      if (D == 128) return LAUNCH<__nv_bfloat16, 128>(p, B, s);              \
      if (D == 256) return LAUNCH<__nv_bfloat16, 256>(p, B, s);              \
    } else if (dtype == 2) {                                                 \
      if (D == 64) return LAUNCH<__half, 64>(p, B, s);                       \
      if (D == 128) return LAUNCH<__half, 128>(p, B, s);                     \
      if (D == 256) return LAUNCH<__half, 256>(p, B, s);                     \
    }                                                                        \
    return cudaErrorInvalidValue;                                            \
  } while (0)

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, void* out0, void* out1, void* lse,
                   const void* delta, const long long* strides, int H, int sq,
                   int sk, float scale, int causal) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.out0 = out0;
  p.out1 = out1;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<const float*>(delta);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.H = H;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D must be 64, 128 or 256. Every tensor
// pointer is a CUDA device pointer and stream a cudaStream_t. strides is a
// host array of 18 element strides: (batch, row, head) of q, k, v, dO, out0,
// out1 in that order (entries of operands a launcher does not take are
// ignored). lse and delta are dense [B, H, sq] f32. Each returns the
// cudaError_t of its launch (0 on success).

extern "C" int flash_fwd_launch(int dtype, int D, const void* q,
                                const void* k, const void* v, void* o,
                                void* lse, const long long* strides, int B,
                                int H, int sq, int sk, float scale,
                                int causal, void* stream) {
  if (B == 0 || sq == 0) return 0;
  const Params p = make_params(q, k, v, nullptr, o, nullptr, lse, nullptr,
                               strides, H, sq, sk, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd);
}

extern "C" int flash_bwd_dkv_launch(int dtype, int D, const void* q,
                                    const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    const long long* strides, int B, int H,
                                    int sq, int sk, float scale, int causal,
                                    void* stream) {
  if (B == 0 || sk == 0) return 0;
  const Params p = make_params(q, k, v, dout, dk, dv, const_cast<void*>(lse),
                               delta, strides, H, sq, sk, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv);
}

extern "C" int flash_bwd_dq_launch(int dtype, int D, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq,
                                   const long long* strides, int B, int H,
                                   int sq, int sk, float scale, int causal,
                                   void* stream) {
  if (B == 0 || sq == 0) return 0;
  const Params p = make_params(q, k, v, dout, dq, nullptr,
                               const_cast<void*>(lse), delta, strides, H, sq,
                               sk, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq);
}
