// What the flash attention forward (flash_attention.cu) and the fused
// backward (flash_attention_bwd.cu) share: the [B, H, S, D] strides of the
// three layouts, the per-row q/k preparation (LN, RoPE, q scale) and the
// RoPE adjoint and bf16 store of an mma fragment tile.
#pragma once

#include "mma_utils.cuh"

namespace bya {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f;
constexpr float LSE_EMPTY = 2.3819763e38f;  // 0.7 * FLT_MAX: a row with no kv
constexpr unsigned FULL = 0xffffffffu;

// Element strides of a [B, H, S, D] view (D contiguous).
struct Layout {
  long long sb, sh, ss;
  __host__ __device__ __forceinline__ long long off(int b, int h) const { return b * sb + h * sh; }
};

inline Layout make_layout(int S, int H, int D, int bshd) {
  if (bshd) return Layout{(long long)S * H * D, (long long)D, (long long)H * D};
  return Layout{(long long)H * S * D, (long long)S * D, (long long)D};
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One warp prepares one D-wide head row; lane holds elements E*lane..+E-1.
// The rotate-half partner of element i < D/2 is i + D/2, held by lane ^ 16.
// LN (if w) -> bf16, RoPE (if rot) -> bf16, then * scale -> bf16.
template <int E>
__device__ __forceinline__ void prep_row(const bf16* x, bf16* out, const float* w,
                                         const float* b, bool rot, const float (&c)[E],
                                         const float (&sn)[E], float scale, float eps, int lane) {
  constexpr int D = 32 * E;
  float v[E];
#pragma unroll
  for (int e = 0; e < E / 2; ++e) {
    const __nv_bfloat162 p = reinterpret_cast<const __nv_bfloat162*>(x)[e];
    v[2 * e] = __low2float(p);
    v[2 * e + 1] = __high2float(p);
  }
  if (w != nullptr) {
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) sum += v[e];
    const float mean = warp_sum(sum) * (1.0f / D);
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[e] -= mean;
      sq += v[e] * v[e];
    }
    const float r = rsqrtf(warp_sum(sq) * (1.0f / D) + eps);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = bf16_round(v[e] * r * w[E * lane + e] + b[E * lane + e]);
  }
  if (rot) {
    const float sign = lane < 16 ? -1.0f : 1.0f;
    float p[E];
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = __shfl_xor_sync(FULL, v[e], 16);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = bf16_round(v[e] * c[e] + sign * p[e] * sn[e]);
  }
#pragma unroll
  for (int e = 0; e < E / 2; ++e)
    reinterpret_cast<__nv_bfloat162*>(out)[e] =
        __floats2bfloat162_rn(v[2 * e] * scale, v[2 * e + 1] * scale);
}

// The RoPE factors of this lane's E elements of row s (identity outside
// [rope_start, rope_start + rope_rows) or without tables); true if rotated.
template <int E>
__device__ __forceinline__ bool rope_factors(float (&c)[E], float (&sn)[E], const float* cos_t,
                                             const float* sin_t, int s, int rope_start,
                                             int rope_rows, int lane) {
  constexpr int D = 32 * E;
  const bool rot = cos_t != nullptr && s >= rope_start && s < rope_start + rope_rows;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    c[e] = 1.f;
    sn[e] = 0.f;
  }
  if (rot) {
    const long long t = (long long)(s - rope_start) * D + E * lane;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      c[e] = cos_t[t + e];
      sn[e] = sin_t[t + e];
    }
  }
  return rot;
}

// LN (if lnqw) and RoPE (if cos_t) of q and k row (b, s, h) into qo/ko, same
// layout; q also scaled by q_scale.  Called by one whole warp.
template <int D>
__device__ __forceinline__ void prep_qk_row(const bf16* q, const bf16* k, bf16* qo, bf16* ko,
                                            const float* lnqw, const float* lnqb,
                                            const float* lnkw, const float* lnkb,
                                            const float* cos_t, const float* sin_t,
                                            int rope_start, int rope_rows, int b, int s, int h,
                                            Layout L, float q_scale, float eps, int lane) {
  constexpr int E = D / 32;
  const long long off = L.off(b, h) + s * L.ss + E * lane;
  float c[E], sn[E];
  const bool rot = rope_factors<E>(c, sn, cos_t, sin_t, s, rope_start, rope_rows, lane);
  prep_row<E>(q + off, qo + off, lnqw, lnqb, rot, c, sn, q_scale, eps, lane);
  prep_row<E>(k + off, ko + off, lnkw, lnkb, rot, c, sn, 1.0f, eps, lane);
}

// g <- the JAX kernels' `_rope_tile(g, cos, -sin)` on the rows of a warp's
// [16, D] fp32 fragment tile (rows row0, row0 + 8 of this lane) that lie in
// [rope_start, rope_start + rope_rows).  Column c < D/2 pairs with c + D/2:
// fragment nd with nd + D/16 of the same lane.
template <int D>
__device__ __forceinline__ void rope_adjoint(float (&g)[D / 8][4], int row0, int lane,
                                             const float* cos_t, const float* sin_t,
                                             int rope_start, int rope_rows) {
  constexpr int HALF = D / 16;
  if (cos_t == nullptr) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row0 + half * 8;
    if (s < rope_start || s >= rope_start + rope_rows) continue;
    const float* cr = cos_t + (long long)(s - rope_start) * D;
    const float* sr = sin_t + (long long)(s - rope_start) * D;
#pragma unroll
    for (int nd = 0; nd < HALF; ++nd)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = half * 2 + c;
        const int col = nd * 8 + (lane & 3) * 2 + c;
        const float g1 = g[nd][e], g2 = g[nd + HALF][e];
        g[nd][e] = g1 * cr[col] + g2 * sr[col];
        g[nd + HALF][e] = g2 * cr[col + D / 2] - g1 * sr[col + D / 2];
      }
  }
}

// Store a warp's [16, D] fp32 fragment tile (rows row0, row0 + 8 of this
// lane) as bf16 rows `ld` apart; rows >= S are not stored.
template <int D>
__device__ __forceinline__ void store_tile(bf16* base, long long ld, const float (&a)[D / 8][4],
                                           int row0, int S, int lane) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + (lane & 3) * 2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(base + row0 * ld + col) = pack_bf16(a[nd][0], a[nd][1]);
    if (row0 + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (row0 + 8) * ld + col) = pack_bf16(a[nd][2], a[nd][3]);
  }
}

}  // namespace bya
