// Dropout written for Hopper (sm_90a), with a plain C launcher bound from
// Python with ctypes (paddle_tpu_torch/ops/dropout.py):
//
//   drop::dropout_kernel  computes what paddle_tpu/nn/functional/common.py:32
//                         dropout and paddle_tpu/nn/functional/attention.py:26
//                         _prob_dropout compute. The JAX package runs them as
//                         XLA ops (threefry bits, a compare, a select and a
//                         scale, fused by XLA; no Pallas body); eager PyTorch
//                         would run about a hundred int64 launches per draw.
//
// For flat index i of x (n < 2^32 elements) and m the flat index of its
// element of the keep mask (m = i, or i mapped onto the mask's reduced shape
// in the axis form of dropout2d/3d, or, in a mesh's box, i mapped onto the
// whole tensor's flat index: base + sum of x's index along each dimension
// times the whole tensor's stride there, base being the box's offsets
// times those strides; the whole tensor has fewer than 2^32 elements):
//   (w0, w1) = threefry2x32(key, (0, m)), bits = w0 ^ w1
//                                (jax_threefry_partitionable's random_bits)
//   u    = bitcast<float>((bits >> 9) | 0x3F800000) - 1   (uniform, float32)
//   keep = u < keep_p            (keep_p = float32(1 - p): bernoulli "low")
//   y    = keep ? T(float(x) * scale) : 0      (upscale_in_train)
//   y    = keep ? x : 0                        (downscale_in_infer, training)
//   y    = keep ? affine(x) : fill             (alpha_dropout)
// The product is one IEEE float32 multiply rounded once to T. `scale` is the
// float32 value the JAX package's XLA program multiplies by: XLA rewrites
// x / (1 - p) as x times the reciprocal of the divisor (float32: 1 / f32(1 -
// p); bfloat16: the float32 reciprocal of bf16(1 - p); float16: the float16
// reciprocal of f16(1 - p)), computed on the host by the wrapper. The key is
// a device tensor of two uint32 words held in int64, read by the kernel
// (nothing is read on the host, so a captured graph may hold the launch).
// The backward of dropout is this kernel on the upstream gradient with the
// same key: nothing but the key is kept between them.
//
// The alpha form computes paddle_tpu/nn/functional/common.py:70
// alpha_dropout, a * where(keep, x, alpha_p) + b with a, b and alpha_p weakly
// typed Python floats, under the same keep mask. Its bits follow what XLA's
// CPU program gives, found by test (tests/test_torch_dropout.py): a kept
// element is fma(a, x, b) rounded once for float32 and float16 (a float16
// product is exact in float32, so the fma equals a multiply then an add),
// and the product rounded to bfloat16 before the add for bfloat16; a, b are
// the Python floats rounded to T. A dropped element is `fill`, the constant
// XLA folds: T(T(a * alpha_p) + b) from the rounded a, alpha_p and b,
// computed on the host. Its gradient, a * keep * g, is the upscale form on g
// with scale a rounded to T.
//
// Bound on an H100 SXM: threefry is about 75 32-bit integer operations a
// mask element (two adds, then 20 rounds of add, rotate and xor, five key
// injections of two adds, and the xor, shift and or of the draw); x is read
// once and y written once. At [8, 16, 2048, 2048] bf16 that is 40 G integer
// operations against 2.1 GB: 1.2 ms at the 33.5 T 32-bit operations/s the
// SMs can issue (128 lanes an SM a clock: half the 67 TFLOP/s float32 rate,
// which counts an FMA as 2) against 0.64 ms at 3.35 TB/s, so instruction
// issue bounds it, not the bytes. (The 64 dedicated INT32 lanes an SM would
// allow half that rate; nvcc puts the adds on the float32 lanes as IMAD.)
//
// Design: a grid-stride loop over 16-byte packs of x (4 float32 or 8 16-bit
// elements a thread an iteration), each element hashing its own counter, and
// a scalar loop over the ragged tail. The form is a template mode, so each
// instance carries only its own arithmetic after the shared draw. x and y must be 16-byte aligned (the
// wrapper copies a misaligned x; the launcher refuses one). No shared memory:
// each element's bits depend on its index alone.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace drop {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kMaxDims = 8;

// x's shape and, per dimension, the mask's stride (0 where the mask
// broadcasts; the whole tensor's stride in a box), and the counter of x's
// first element (0 but in a box): the axis and box forms' index map,
// passed by value
struct Bcast {
  int ndim;
  long long shape[kMaxDims];
  long long mstride[kMaxDims];
  long long base;
};

template <typename T>
struct Conv;
template <>
struct Conv<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <>
struct Conv<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Conv<__half> {
  static __device__ __forceinline__ float load(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half store(float v) {
    return __float2half_rn(v);
  }
};

template <typename T, int V>
struct alignas(16) Pack {
  T v[V];
};

__device__ __forceinline__ bool keep_of(uint32_t k1, uint32_t k2, uint32_t m,
                                        float keep_p) {
  uint32_t x0 = 0u, x1 = m;
  rng::threefry2x32(k1, k2, x0, x1);
  const float u = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
  return u < keep_p;
}

template <bool kBcast>
__device__ __forceinline__ uint32_t mask_index(long long i, const Bcast& b) {
  if (!kBcast) return static_cast<uint32_t>(i);
  long long m = b.base;
  for (int d = b.ndim - 1; d >= 0; --d) {
    m += (i % b.shape[d]) * b.mstride[d];
    i /= b.shape[d];
  }
  return static_cast<uint32_t>(m);
}

// the forms, a template mode of the kernel
constexpr int kDownscale = 0;  // keep ? x : 0
constexpr int kUpscale = 1;    // keep ? T(x * scale) : 0
constexpr int kAlpha = 2;      // keep ? affine(x) : fill

// the alpha form's kept element: fma(a, x, b) rounded once, except in
// bfloat16, where XLA rounds the product before the add
template <typename T>
__device__ __forceinline__ float affine(float v, float a, float b) {
  return __fmaf_rn(a, v, b);
}
template <>
__device__ __forceinline__ float affine<__nv_bfloat16>(float v, float a,
                                                       float b) {
  const float prod = __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, v)));
  return __fadd_rn(prod, b);
}

template <typename T, int kMode>
__device__ __forceinline__ T drop_one(T v, bool keep, float scale,
                                      float shift, float fill) {
  if (kMode == kAlpha) {
    return Conv<T>::store(keep ? affine<T>(Conv<T>::load(v), scale, shift)
                               : fill);
  }
  if (!keep) return Conv<T>::store(0.0f);
  return kMode == kUpscale ? Conv<T>::store(__fmul_rn(Conv<T>::load(v), scale))
                           : v;
}

// V elements a pack (16 bytes); x and y 16-byte aligned
template <typename T, int V, bool kBcast, int kMode>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const long long* __restrict__ key, long long n,
                   float keep_p, float scale, float shift, float fill,
                   Bcast b) {
  const uint32_t k1 = static_cast<uint32_t>(key[0]);
  const uint32_t k2 = static_cast<uint32_t>(key[1]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long packs = n / V;
  for (long long g = tid; g < packs; g += stride) {
    Pack<T, V> in = reinterpret_cast<const Pack<T, V>*>(x)[g];
    Pack<T, V> out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool keep =
          keep_of(k1, k2, mask_index<kBcast>(g * V + j, b), keep_p);
      out.v[j] = drop_one<T, kMode>(in.v[j], keep, scale, shift, fill);
    }
    reinterpret_cast<Pack<T, V>*>(y)[g] = out;
  }
  for (long long i = packs * V + tid; i < n; i += stride) {
    const bool keep = keep_of(k1, k2, mask_index<kBcast>(i, b), keep_p);
    y[i] = drop_one<T, kMode>(x[i], keep, scale, shift, fill);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename T, bool kBcast, int kMode>
void launch(const void* x, void* y, const long long* key, long long n,
            float keep_p, float scale, float shift, float fill,
            const Bcast& b, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  long long blocks = ((n + V - 1) / V + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  dropout_kernel<T, V, kBcast, kMode>
      <<<static_cast<int>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), key, n, keep_p, scale,
          shift, fill, b);
}

// the axis form (kBcast) exists for the zero-filled forms only
template <typename T>
int dispatch(const void* x, void* y, const long long* key, long long n,
             float keep_p, float scale, float shift, float fill, int mode,
             const Bcast& b, cudaStream_t stream) {
  const bool bc = b.ndim > 0;
  if (mode == kAlpha) {
    if (bc) return cudaErrorInvalidValue;
    launch<T, false, kAlpha>(x, y, key, n, keep_p, scale, shift, fill, b,
                             stream);
  } else if (mode == kUpscale) {
    if (bc) {
      launch<T, true, kUpscale>(x, y, key, n, keep_p, scale, shift, fill, b,
                                stream);
    } else {
      launch<T, false, kUpscale>(x, y, key, n, keep_p, scale, shift, fill, b,
                                 stream);
    }
  } else if (mode == kDownscale) {
    if (bc) {
      launch<T, true, kDownscale>(x, y, key, n, keep_p, scale, shift, fill, b,
                                  stream);
    } else {
      launch<T, false, kDownscale>(x, y, key, n, keep_p, scale, shift, fill,
                                   b, stream);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace drop

// dtype: 0 float32, 1 bfloat16, 2 float16. x and y contiguous, n elements,
// both 16-byte aligned (else cudaErrorMisalignedAddress, and no launch);
// key a device int64 [2]. mode: 0 downscale_in_infer (keep ? x : 0), 1
// upscale_in_train (keep ? x * scale : 0), 2 alpha (keep ? affine(x; a =
// scale, b = shift) : fill). ndim > 0 selects the axis or box form (modes 0
// and 1): shape[ndim] is x's shape and mstride[ndim] the mask's strides over
// it (0: broadcast), base the counter of x's first element (0 in the axis
// form). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dropout_launch(int dtype, const void* x, void* y,
                              const void* key, long long n, float keep_p,
                              float scale, float shift, float fill, int mode,
                              int ndim, const long long* shape,
                              const long long* mstride, long long base,
                              void* stream) {
  using namespace drop;
  if (n <= 0) return 0;
  if (ndim < 0 || ndim > kMaxDims) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  Bcast b{};
  b.ndim = ndim;
  b.base = base;
  for (int d = 0; d < ndim; ++d) {
    b.shape[d] = shape[d];
    b.mstride[d] = mstride[d];
  }
  const long long* k = static_cast<const long long*>(key);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0:
      rc = dispatch<float>(x, y, k, n, keep_p, scale, shift, fill, mode, b, s);
      break;
    case 1:
      rc = dispatch<__nv_bfloat16>(x, y, k, n, keep_p, scale, shift, fill,
                                   mode, b, s);
      break;
    case 2:
      rc = dispatch<__half>(x, y, k, n, keep_p, scale, shift, fill, mode, b,
                            s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
