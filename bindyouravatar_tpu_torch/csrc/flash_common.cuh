// What the flash attention forward (flash_attention.cu) and the fused
// backward (flash_attention_bwd.cu) share: the [B, H, S, D] strides of the
// three layouts, the per-row q/k preparation (LN, RoPE, q scale) at D = 32,
// 64 and 128 and at any D with D % 8 == 0, and the RoPE adjoint and the
// stores of an mma fragment tile.
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

// A lane's E consecutive bf16 elements of a head row as fp32, and back
// (E = 1 at D = 32: one element a lane; else bf16 pairs).
template <int E>
__device__ __forceinline__ void load_row(float (&v)[E], const bf16* x) {
  if constexpr (E == 1) {
    v[0] = __bfloat162float(x[0]);
  } else {
#pragma unroll
    for (int e = 0; e < E / 2; ++e) {
      const __nv_bfloat162 p = reinterpret_cast<const __nv_bfloat162*>(x)[e];
      v[2 * e] = __low2float(p);
      v[2 * e + 1] = __high2float(p);
    }
  }
}

template <int E>
__device__ __forceinline__ void store_row(bf16* out, const float (&v)[E]) {
  if constexpr (E == 1) {
    out[0] = __float2bfloat16(v[0]);
  } else {
#pragma unroll
    for (int e = 0; e < E / 2; ++e)
      reinterpret_cast<__nv_bfloat162*>(out)[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  }
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
  load_row<E>(v, x);
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
  for (int e = 0; e < E; ++e) v[e] *= scale;
  store_row<E>(out, v);
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

// ------------------------------------------------ any head width (D % 8 == 0)
// The forms above hold E = D / 32 consecutive elements a lane and find the
// rotate-half partner at lane ^ 16, which exists only for D = 32, 64 and
// 128.  Below, for any D with D % 8 == 0 and D <= 32 * NE_ANY: lane holds
// elements lane + 32 e (e < NE_ANY, those < D), and reads the partner of
// element c (c + D/2 or c - D/2 of the true D) from the row itself, putting
// it through the same LN (warp-uniform mean and rstd, so the same value
// the partner's lane computes).
constexpr int NE_ANY = 8;

__device__ __forceinline__ int rope_partner(int c, int D) { return c < D / 2 ? c + D / 2 : c - D / 2; }

// prep_row for a D-wide row at x (LN if w, RoPE with row tables cr/sr if
// cr, then * scale); the statistics divide by D over D columns.
__device__ __forceinline__ void prep_row_any(const bf16* x, bf16* out, const float* w,
                                             const float* b, const float* cr, const float* sr,
                                             int D, float scale, float eps, int lane) {
  float v[NE_ANY], mean = 0.f, r = 1.f;
#pragma unroll
  for (int e = 0; e < NE_ANY; ++e) {
    const int c = lane + 32 * e;
    v[e] = c < D ? __bfloat162float(x[c]) : 0.f;
  }
  if (w != nullptr) {
    const float inv_d = 1.0f / D;
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < NE_ANY; ++e) sum += v[e];
    mean = warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < NE_ANY; ++e)
      if (lane + 32 * e < D) sq += (v[e] - mean) * (v[e] - mean);
    r = rsqrtf(warp_sum(sq) * inv_d + eps);
#pragma unroll
    for (int e = 0; e < NE_ANY; ++e) {
      const int c = lane + 32 * e;
      if (c < D) v[e] = bf16_round((v[e] - mean) * r * w[c] + b[c]);
    }
  }
  if (cr != nullptr) {
#pragma unroll
    for (int e = 0; e < NE_ANY; ++e) {
      const int c = lane + 32 * e;
      if (c >= D) continue;
      const int pc = rope_partner(c, D);
      float p = __bfloat162float(x[pc]);
      if (w != nullptr) p = bf16_round((p - mean) * r * w[pc] + b[pc]);
      v[e] = bf16_round(v[e] * cr[c] + (c < D / 2 ? -p : p) * sr[c]);
    }
  }
#pragma unroll
  for (int e = 0; e < NE_ANY; ++e) {
    const int c = lane + 32 * e;
    if (c < D) out[c] = __float2bfloat16(v[e] * scale);
  }
}

// prep_qk_row for any D: LN (if lnqw) and RoPE (if cos_t) of q and k row
// (b, s, h) into qo/ko; q also scaled by q_scale.  Called by one warp.
__device__ __forceinline__ void prep_qk_row_any(const bf16* q, const bf16* k, bf16* qo, bf16* ko,
                                                const float* lnqw, const float* lnqb,
                                                const float* lnkw, const float* lnkb,
                                                const float* cos_t, const float* sin_t,
                                                int rope_start, int rope_rows, int b, int s,
                                                int h, Layout L, float q_scale, float eps,
                                                int lane, int D) {
  const long long off = L.off(b, h) + s * L.ss;
  const bool rot = cos_t != nullptr && s >= rope_start && s < rope_start + rope_rows;
  const long long t = (long long)(s - rope_start) * D;
  const float* cr = rot ? cos_t + t : nullptr;
  const float* sr = rot ? sin_t + t : nullptr;
  prep_row_any(q + off, qo + off, lnqw, lnqb, cr, sr, D, q_scale, eps, lane);
  prep_row_any(k + off, ko + off, lnkw, lnkb, cr, sr, D, 1.0f, eps, lane);
}

// Store columns col0 + 0 .. 8N-1 of a warp's [16, 8N] fp32 fragment tile
// (rows row0, row0 + 8 of this lane) that lie below the head's D (D % 8 ==
// 0: a fragment is wholly in or out) as T (bf16 or fp32) rows `ld` apart;
// rows >= S are not stored.
template <typename T, int N>
__device__ __forceinline__ void store_tile_any(T* base, long long ld, const float (&a)[N][4],
                                               int row0, int S, int lane, int col0, int D) {
#pragma unroll
  for (int nd = 0; nd < N; ++nd) {
    if (col0 + nd * 8 >= D) break;
    const int col = col0 + nd * 8 + (lane & 3) * 2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + 8 * hf;
      if (r >= S) continue;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(base + r * ld + col) = pack_bf16(a[nd][2 * hf], a[nd][2 * hf + 1]);
      else
        *reinterpret_cast<float2*>(base + r * ld + col) = make_float2(a[nd][2 * hf], a[nd][2 * hf + 1]);
    }
  }
}

// g <- the JAX kernels' `_rope_tile(g, cos, -sin)` on the rows of a warp's
// [16, D] fp32 fragment tile (rows row0, row0 + 8 of this lane) that lie in
// [rope_start, rope_start + rope_rows).  Column c < D/2 pairs with c + D/2:
// fragment nd with nd + D/16 of the same lane.  The tile may be held in a
// wider accumulator (N >= D/8 fragments: D = 32 in a 64-column one).
template <int D, int N>
__device__ __forceinline__ void rope_adjoint(float (&g)[N][4], int row0, int lane,
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

// Store the first D columns of a warp's [16, 8N] fp32 fragment tile (rows
// row0, row0 + 8 of this lane) as bf16 rows `ld` apart; rows >= S are not
// stored.
template <int D, int N>
__device__ __forceinline__ void store_tile(bf16* base, long long ld, const float (&a)[N][4],
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
