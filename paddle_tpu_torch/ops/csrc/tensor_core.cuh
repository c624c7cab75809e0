// Warp-level tensor-core helpers shared by paged_attention.cu and
// flash_attention.cu: mma.sync m16n8k16 (bf16 in, f32 accumulate), the
// ldmatrix reads that feed it from shared memory, and the fragment
// bookkeeping of a 16-row attention tile.
//
// Shared tiles are bf16 rows of stride D + 8 elements (16 bytes of padding),
// so an ldmatrix read of 8 rows hits 8 different bank groups. Fragment
// element e of an m16n8 accumulator s[j] of a warp is row g + 8 (e / 2),
// column 8 j + 2 t + e % 2 (g = lane / 4, t = lane % 4). A score tile's
// accumulator fragments are exactly the A-operand fragments of the next
// product, so p (or ds) goes from registers, rounded to bf16, straight into
// the second mma: the Pallas bodies' rounding point, at no cost.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// two f32 rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// quad reductions: the 4 lanes that hold one fragment row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The A fragments of rows X[xr .. xr + 16) over all D columns, for a warp
// that multiplies the same rows by many tiles.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       const bf16* X, int xr, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm(a[kk], X + (xr + (lane & 15)) * (D + 8) + kk * 16 + (lane >> 4) * 8);
}

// s[j] = A . Y[yr+8j .. yr+8j+8)^T over D (j < NJ), A the fragments of
// load_a: a warp's 16 x 8NJ score tile.
template <int D, int NJ>
__device__ __forceinline__ void dot_tile_a(float (&s)[NJ][4],
                                           const uint32_t (&a)[D / 16][4],
                                           const bf16* Y, int yr, int lane) {
  constexpr int DP = D + 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b[4];
      ldsm(b, Y + (yr + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * DP +
                  kk * 16 + ((lane >> 3) & 1) * 8);
      mma(s[j], a[kk], b[0], b[1]);
      mma(s[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc += W . Y[yr .. yr + 8NJ) with W (16 x 8NJ) the fragments of a score
// tile, rounded to bf16: the A operand comes from registers, Y (rows along
// the reduction, D columns) through transposing ldmatrix reads
template <int D, int NJ>
__device__ __forceinline__ void acc_tile(float (&acc)[D / 8][4],
                                         const float (&w)[NJ][4],
                                         const bf16* Y, int yr, int lane) {
  constexpr int DP = D + 8;
#pragma unroll
  for (int kc = 0; kc < NJ / 2; ++kc) {
    const uint32_t a[4] = {pack(w[2 * kc][0], w[2 * kc][1]),
                           pack(w[2 * kc][2], w[2 * kc][3]),
                           pack(w[2 * kc + 1][0], w[2 * kc + 1][1]),
                           pack(w[2 * kc + 1][2], w[2 * kc + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      ldsm_t(b, Y + (yr + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DP +
                    dn * 8 + (lane >> 4) * 8);
      mma(acc[dn], a, b[0], b[1]);
      mma(acc[dn + 1], a, b[2], b[3]);
    }
  }
}

// rows r (fragment rows g and g + 8 at r0) of acc into a [.., D] head,
// scaled by inv[]; rows at or past n are not written
template <int D>
__device__ __forceinline__ void store(bf16* dst, long long row_stride, int r0,
                                      int n, int t, const float (&acc)[D / 8][4],
                                      const float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
    bf16* out = dst + row * row_stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(out + dn * 8) =
          pack(acc[dn][2 * r] * inv[r], acc[dn][2 * r + 1] * inv[r]);
  }
}

}  // namespace tc
