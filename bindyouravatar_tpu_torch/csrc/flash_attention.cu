// Flash attention: kernels B1 and B7 over the flat [B, S, H*64] layout, and
// B11, B12, B13 over [B, H, S, D] ("bhsd") or [B, S, H, D] ("bshd") for head
// dims 64 and 128.  One source: a pre-pass body, a forward body and a
// backward pair templated on the head dim and on the flat kernels' math,
// each instantiated under its own kernel name.
//
// B1 replaces the TPU kernel `_fwd_flat_t_kernel`
// (bindyouravatar_tpu/ops/flash_attention.py), reached through
// `flash_attention(layout="flat", v_transposed=True)` from the DiT's joint
// self-attention at inference.  Same math: per head, LN(eps, fp32 stats,
// fp32 affine) -> bf16, rotate-half RoPE on rows [rope_start, rope_start +
// rope_rows) -> bf16, q scaled by scale*log2(e) in fp32 -> bf16, then
// non-causal softmax(q k^T) v over kv rows < kv_len.
//
// B7 (forward) replaces `_fwd_flat_kernel` with `save_residuals` (reached
// through the `_flash_flat` custom vjp from the DiT's training attention,
// QK-LN applied outside, and the router's STAB spatial attention): the same
// kernels with no LN, writing the per-row log-sum-exp (natural log, fp32,
// [B, H, S]).  B7 (backward) replaces `_bwd_flat_kernel`: dq, dk, dv from
// q, k, v, dO, the LSE and delta = rowsum(o * dO) (computed outside, as
// the JAX package computes it in XLA), P recomputed from the LSE,
// dS = P (dP - delta) rounded to bf16 before the dq/dk products, and the
// RoPE adjoint (cos, -sin) on dq and dk over the RoPE rows only.
//
// B11 replaces `_fwd_kernel`, reached through `flash_attention(layout=
// "bhsd" | "bshd")`: the differentiable `_flash` custom vjp (saving the
// LSE) and the inference form with the QK LayerNorm fused.  Same math as
// B1 up to the scale: the TPU body's tricks (scale and log2 e folded into a
// rounded q, a ones column for the row sum, the eye-matmul LSE store) are
// not copied, the scale multiplies the fp32 scores.  B12 replaces
// `_dkv_kernel` and B13 `_dq_kernel` (the two-kernel backward of
// `_bwd_impl`): P = exp(q k^T * scale - LSE) with the masked kv columns
// exactly 0, delta = rowsum(o * dO) computed inside each kernel from o and
// dO, dS = P (dO V^T - delta) * scale rounded to bf16 before the dK and dQ
// products, dV = P^T dO with P rounded to bf16, and the RoPE adjoint on the
// fp32 accumulators before the store.  The JAX package routes its own
// bhsd/bshd backward through the combined kernel (B7's body) unless
// `COMBINED_BWD` is off or D % 8 != 0: a TPU VMEM and layout choice.  On
// the GPU, B7's backward is itself one dK/dV kernel per kv tile and one dQ
// kernel per q tile, and B12/B13 are that pair for the strided layouts.
//
// What bounds them on the H100: the matmuls.  Forward 4*S^2*D FLOP per head
// (~3.9e12 per layer at B=1, S=17,776, 48 heads of 64) against ~0.1-0.4 GB
// of q/k/v/o traffic; the backward's two kernels recompute the scores and
// dP, 8 (dK, dV) + 6 (dQ) S^2*D FLOP per head.  Compute bound, so the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) carry every
// product.
//
// Design:
//  * The kernels take the batch, head and row strides of a [B, H, S, D]
//    view (`Layout`), so flat (bshd at D = 64), bhsd and bshd come from one
//    body; rows are 16-byte vector loads (D % 8 == 0).
//  * The TPU kernels prepare K once at grid step iq == 0 into scratch that
//    later grid steps reuse; GPU blocks run in no order, so a pre-pass
//    (`prep_qk`) applies LN + RoPE (+ B1/B7's q scale) to q and k once, into
//    bf16 scratch of the input's layout, and the attention kernels read the
//    prepared tensors.  Without LN, RoPE or a q scale (B11/B12/B13 with no
//    options) the kernels read q and k directly.  The backward runs the
//    same pre-pass once, shared by its two kernels, so it recomputes exactly
//    the scores the forward saw.
//  * The softmax keeps an fp32 online running max per row (the TPU kernel's
//    static max is valid only behind the fused LN); masked scores are a
//    large finite negative, so no row ever computes inf - inf.  A row with
//    no kv gets the LSE +big, so the backward's P is 0 there.
//  * Forward: one block = 4 warps = 64 query rows of one (batch, head); kv
//    tiles of 64 rows stream through a cp.async double buffer; a warp keeps
//    its q fragments in registers.  Rows past S (q) and kv_len (k, v) are
//    zero-filled on load and masked; q rows >= S are never stored.
//  * Backward, no atomics, deterministic sums: one block per 64-row kv tile
//    sweeps the q tiles for dK and dV (Q, dO and the rows' LSE and delta
//    through a double buffer), one block per 64-row q tile sweeps the kv
//    tiles for dQ.  The block's own rows (K, V or Q, dO) stay in shared
//    memory and are read into fragments one k-step pair at a time, so at
//    D = 128 a warp's registers hold the two [16, 128] fp32 accumulators
//    (dK, dV) and the score tiles without the operands.
//  * Shared memory: the forward's 46 KB at D = 64 is static in B1/B7's
//    kernel; the backward's (56 KB at D = 64, 105 KB at D = 128) and B11's
//    are dynamic, and the launchers raise each kernel's limit.
#include "mma_utils.cuh"

namespace {

using bya::bf16;

constexpr int BM = 64;  // query rows per block (16 per warp)
constexpr int BN = 64;  // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f;
constexpr float LSE_EMPTY = 2.3819763e38f;  // 0.7 * FLT_MAX: a row with no kv
constexpr unsigned FULL = 0xffffffffu;

// Element strides of a [B, H, S, D] view (D contiguous).
struct Layout {
  long long sb, sh, ss;
  __device__ __forceinline__ long long off(int b, int h) const { return b * sb + h * sh; }
};

Layout make_layout(int S, int H, int D, int bshd) {
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

template <int D>
__device__ __forceinline__ void zero(float (&a)[D / 8][4]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// ---------------------------------------------------------------- pre-pass

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

// LN (if lnqw) and RoPE (if cos_t) of q and k into qo/ko, same layout; q
// also scaled by q_scale.  One warp per (b, s, h) row.
template <int D>
__device__ __forceinline__ void prep_qk(const bf16* q, const bf16* k, bf16* qo, bf16* ko,
                                        const float* lnqw, const float* lnqb, const float* lnkw,
                                        const float* lnkb, const float* cos_t, const float* sin_t,
                                        int rope_start, int rope_rows, int B, int S, int H,
                                        Layout L, float q_scale, float eps) {
  constexpr int E = D / 32;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * S * H) return;
  const int h = (int)(warp % H);
  const long long bs = warp / H;
  const int s = (int)(bs % S), b = (int)(bs / S);
  const long long off = L.off(b, h) + s * L.ss + E * lane;
  const bool rot = cos_t != nullptr && s >= rope_start && s < rope_start + rope_rows;
  float c[E], sn[E];
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
  prep_row<E>(q + off, qo + off, lnqw, lnqb, rot, c, sn, q_scale, eps, lane);
  prep_row<E>(k + off, ko + off, lnkw, lnkb, rot, c, sn, 1.0f, eps, lane);
}

#define PREP_PARAMS                                                                        \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, bf16 *__restrict__ qo,           \
      bf16 *__restrict__ ko, const float *__restrict__ lnqw, const float *__restrict__ lnqb, \
      const float *__restrict__ lnkw, const float *__restrict__ lnkb,                      \
      const float *__restrict__ cos_t, const float *__restrict__ sin_t, int rope_start,    \
      int rope_rows, int B, int S, int H, Layout L, float q_scale, float eps
#define PREP_ARGS                                                                      \
  q, k, qo, ko, lnqw, lnqb, lnkw, lnkb, cos_t, sin_t, rope_start, rope_rows, B, S, H, L, \
      q_scale, eps

// B1 / B7's pre-pass (flat, D = 64, q scaled by scale * log2 e)
__global__ void __launch_bounds__(256) prep_qk_kernel(PREP_PARAMS) { prep_qk<64>(PREP_ARGS); }

// B11's (LN and RoPE) and B12/B13's (RoPE) pre-pass
template <int D>
__global__ void __launch_bounds__(256) layout_prep_kernel(PREP_PARAMS) { prep_qk<D>(PREP_ARGS); }

// ---------------------------------------------------------------- forward

// SCALE: multiply the fp32 scores by scale_log2 (B11); B1/B7 fold the scale
// and log2 e into the prepared q.  Scores are in log2 units, p = exp2(s - m).
// `lse` (null for B1): the per-row natural log-sum-exp, fp32 [B, H, S].
// smem: 5 [64, D + 8] bf16 tiles (q; k and v double-buffered).
template <int D, bool SCALE>
__device__ __forceinline__ void fwd_body(bf16* smem, const bf16* __restrict__ q,
                                         const bf16* __restrict__ k, const bf16* __restrict__ v,
                                         bf16* __restrict__ o, float* __restrict__ lse, Layout L,
                                         int S, int H, int kv_len, float scale_log2) {
  constexpr int LDS = D + 8, KS = D / 16, ND = D / 8;
  bf16* sQ = smem;
  bf16* sK = sQ + BM * LDS;      // two slots
  bf16* sV = sK + 2 * BN * LDS;  // two slots

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const long long base = L.off(b, h), ld = L.ss;

  bya::load_rows<BM, D, NTHREADS>(sQ, LDS, q + base, ld, q0, S, tid);
  bya::load_rows<BN, D, NTHREADS>(sK, LDS, k + base, ld, 0, kv_len, tid);
  bya::load_rows<BN, D, NTHREADS>(sV, LDS, v + base, ld, 0, kv_len, tid);
  bya::cp_async_commit();

  const int n_tiles = (kv_len + BN - 1) / BN;
  float acc[ND][4];
  zero<D>(acc);
  float m_i[2] = {MASKED, MASKED};
  float l_i[2] = {0.f, 0.f};
  uint32_t qf[KS][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      bya::load_rows<BN, D, NTHREADS>(sK + (buf ^ 1) * BN * LDS, LDS, k + base, ld,
                                      (j + 1) * BN, kv_len, tid);
      bya::load_rows<BN, D, NTHREADS>(sV + (buf ^ 1) * BN * LDS, LDS, v + base, ld,
                                      (j + 1) * BN, kv_len, tid);
      bya::cp_async_commit();
      bya::cp_async_wait<1>();
    } else {
      bya::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) bya::load_a_frags<KS, LDS>(qf, sQ + warp * 16 * LDS, lane);

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    bya::qk_scores<8, KS, LDS>(s, qf, sK + buf * BN * LDS, lane);

    if (SCALE) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale_log2;
    }
    const int kv0 = j * BN;
    if (kv0 + BN > kv_len) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + nt * 8 + (lane & 3) * 2 + (e & 1) >= kv_len) s[nt][e] = MASKED;
    }

    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    }
    const float alpha0 = exp2f(m_i[0] - mx[0]), alpha1 = exp2f(m_i[1] - mx[1]);
    m_i[0] = mx[0];
    m_i[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx[0]);
      s[nt][1] = exp2f(s[nt][1] - mx[0]);
      s[nt][2] = exp2f(s[nt][2] - mx[1]);
      s[nt][3] = exp2f(s[nt][3] - mx[1]);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l_i[0] = l_i[0] * alpha0 + rs0;
    l_i[1] = l_i[1] * alpha1 + rs1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha0;
      acc[nd][1] *= alpha0;
      acc[nd][2] *= alpha1;
      acc[nd][3] *= alpha1;
    }
    bya::pv_accumulate<8, ND, LDS>(acc, s, sV + buf * BN * LDS, lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(FULL, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(FULL, l_i[r], 2);
  }
  const float inv0 = l_i[0] > 0.f ? 1.f / l_i[0] : 0.f;
  const float inv1 = l_i[1] > 0.f ? 1.f / l_i[1] : 0.f;
  const int row0 = q0 + warp * 16 + (lane >> 2);
  if (lse != nullptr && (lane & 3) == 0) {
    float* lb = lse + ((long long)b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < S)
        lb[row0 + 8 * r] =
            l_i[r] > 0.f ? m_i[r] * (1.0f / LOG2E) + logf(l_i[r]) : LSE_EMPTY;
  }
  bf16* ob = o + base;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + (lane & 3) * 2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * ld + col) =
          bya::pack_bf16(acc[nd][0] * inv0, acc[nd][1] * inv0);
    if (row0 + 8 < S)
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * ld + col) =
          bya::pack_bf16(acc[nd][2] * inv1, acc[nd][3] * inv1);
  }
}

constexpr int FWD_SMEM64 = 5 * BM * (64 + 8) * (int)sizeof(bf16);  // 46,080 B

// B1 and B7's forward: q prepared and pre-scaled, flat [B, S, H*64]
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 Layout L, int S, int H, int kv_len) {
  __shared__ __align__(128) bf16 smem[FWD_SMEM64 / sizeof(bf16)];
  fwd_body<64, false>(smem, q, k, v, o, lse, L, S, H, kv_len, 1.f);
}

// B11
template <int D>
__global__ void __launch_bounds__(NTHREADS)
mha_fwd_layout_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      Layout L, int S, int H, int kv_len, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  fwd_body<D, true>(reinterpret_cast<bf16*>(smem_raw), q, k, v, o, lse, L, S, H, kv_len,
                    scale_log2);
}

// ---------------------------------------------------------------- backward

// s[nt] += A (a warp's 16 rows of a [*, LDS] shared tile, k = 0..D-1) *
// B^T (rows nt*8.. of another [*, LDS] tile), the A fragments read from
// shared memory one k-step pair at a time (KS even).
template <int NT, int KS, int LDS>
__device__ __forceinline__ void scores_smem(float (&s)[NT][4], const bf16* a_rows,
                                            const bf16* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; kk += 2) {
    uint32_t a0[4], a1[4];
    const bf16* pa = a_rows + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8;
    bya::ldmatrix_x4(a0[0], a0[1], a0[2], a0[3], pa);
    bya::ldmatrix_x4(a1[0], a1[1], a1[2], a1[3], pa + 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1, b2, b3;
      const bf16* pb = b_tile + (nt * 8 + (lane & 7)) * LDS + kk * 16 + (lane >> 3) * 8;
      bya::ldmatrix_x4(b0, b1, b2, b3, pb);
      bya::mma_bf16(s[nt], a0, b0, b1);
      bya::mma_bf16(s[nt], a1, b2, b3);
    }
  }
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
      *reinterpret_cast<uint32_t*>(base + row0 * ld + col) = bya::pack_bf16(a[nd][0], a[nd][1]);
    if (row0 + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (row0 + 8) * ld + col) =
          bya::pack_bf16(a[nd][2], a[nd][3]);
  }
}

// delta[r] = sum_d o[r0 + r, d] * dO[r0 + r, d] (fp32) for the BM rows of a
// tile: o from global memory (rows `ld` apart), dO from its shared tile;
// two threads per row.  Rows >= S get 0.
template <int D>
__device__ __forceinline__ void row_delta(float* sdl, const bf16* ob, long long ld,
                                          const bf16* sdo, int r0, int S, int tid) {
  constexpr int LDS = D + 8, HALF = D / 2;
  const int r = tid >> 1, part = tid & 1;
  float acc = 0.f;
  if (r0 + r < S) {
    const bf16* orow = ob + (long long)(r0 + r) * ld + part * HALF;
    const bf16* grow = sdo + r * LDS + part * HALF;
#pragma unroll
    for (int c = 0; c < HALF; c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc += __low2float(o2[i]) * __low2float(g2[i]) + __high2float(o2[i]) * __high2float(g2[i]);
    }
  }
  acc += __shfl_xor_sync(FULL, acc, 1);
  if (part == 0) sdl[r] = acc;
}

// The two backward modes.  FLAT (B7): q prepared with the scale * log2 e
// folded in, so P = exp2(q_s k^T - lse2), dS = P (dP - delta) and the
// scale comes back on the fp32 accumulators (dk / log2 e, dq * scale); delta
// given, [B, H, S].  Otherwise (B12, B13): P = exp2(q k^T * scale * log2 e
// - lse2), dS = P (dP - delta) * scale, delta computed from o and dO.
// Both round P and dS to bf16 where they enter a product.
#define BWD_PARAMS                                                                           \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,        \
      const bf16 *__restrict__ o, const bf16 *__restrict__ dout, const float *__restrict__ lse, \
      const float *__restrict__ delta, bf16 *__restrict__ g0, bf16 *__restrict__ g1,         \
      const float *__restrict__ cos_t, const float *__restrict__ sin_t, int rope_start,      \
      int rope_rows, Layout L, int S, int H, int kv_len, float scale
#define BWD_ARGS \
  q, k, v, o, dout, lse, delta, g0, g1, cos_t, sin_t, rope_start, rope_rows, L, S, H, kv_len, scale

template <int D>
constexpr int bwd_smem() {
  return 6 * BM * (D + 8) * (int)sizeof(bf16) + 4 * BM * (int)sizeof(float);
}

// dK (g0), dV (g1) of one 64-row kv tile of one (batch, head): sweeps every
// q tile.  q, k are the prepared rows.  Warp w owns kv rows kv0 + 16w.. and
// accumulates, in fp32, dV += P^T dO and dK += dS^T q.
template <int D, bool FLAT>
__device__ __forceinline__ void dkv_body(bf16* smem, BWD_PARAMS) {
  constexpr int LDS = D + 8, KS = D / 16, ND = D / 8;
  bf16* sK = smem;
  bf16* sV = sK + BN * LDS;
  bf16* sQ = sV + BN * LDS;       // two slots
  bf16* sG = sQ + 2 * BM * LDS;   // dO, two slots
  float* sL = reinterpret_cast<float*>(sG + 2 * BM * LDS);  // LSE * log2 e, two slots
  float* sDl = sL + 2 * BM;                                 // delta, two slots

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv0 = blockIdx.x * BN;
  const long long base = L.off(b, h), ld = L.ss;
  const long long bh = ((long long)b * H + h) * S;
  const float scale_log2 = scale * LOG2E;
  const int n_q = kv0 < kv_len ? (S + BM - 1) / BM : 0;  // tiles past kv_len: dK = dV = 0

  auto stage = [&](int j, int slot) {
    bya::load_rows<BM, D, NTHREADS>(sQ + slot * BM * LDS, LDS, q + base, ld, j * BM, S, tid);
    bya::load_rows<BM, D, NTHREADS>(sG + slot * BM * LDS, LDS, dout + base, ld, j * BM, S, tid);
    for (int i = tid; i < BM; i += NTHREADS) {
      const int r = j * BM + i;
      sL[slot * BM + i] = r < S ? lse[bh + r] * LOG2E : 0.f;
      if (FLAT) sDl[slot * BM + i] = r < S ? delta[bh + r] : 0.f;
    }
  };
  bya::load_rows<BN, D, NTHREADS>(sK, LDS, k + base, ld, kv0, S, tid);
  bya::load_rows<BN, D, NTHREADS>(sV, LDS, v + base, ld, kv0, S, tid);
  if (n_q > 0) stage(0, 0);
  bya::cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  const int row0 = kv0 + warp * 16 + (lane >> 2);
  const bool kv_ok[2] = {row0 < kv_len, row0 + 8 < kv_len};

  for (int j = 0; j < n_q; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_q) {
      stage(j + 1, buf ^ 1);
      bya::cp_async_commit();
      bya::cp_async_wait<1>();
    } else {
      bya::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = sQ + buf * BM * LDS;
    const bf16* gt = sG + buf * BM * LDS;
    const float* lt = sL + buf * BM;
    const float* dt = sDl + buf * BM;
    if (!FLAT) {
      row_delta<D>(sDl + buf * BM, o + base, ld, gt, j * BM, S, tid);
      __syncthreads();
    }
    const int q0 = j * BM;

    float pt[8][4];  // P^T: this warp's 16 kv rows x the tile's 64 q columns
#pragma unroll
    for (int i = 0; i < 8; ++i) pt[i][0] = pt[i][1] = pt[i][2] = pt[i][3] = 0.f;
    scores_smem<8, KS, LDS>(pt, sK + warp * 16 * LDS, qt, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
        const float x = FLAT ? pt[nt][e] : pt[nt][e] * scale_log2;
        pt[nt][e] = (kv_ok[e >> 1] && q0 + c < S) ? exp2f(x - lt[c]) : 0.f;
      }
    bya::pv_accumulate<8, ND, LDS>(dv_acc, pt, gt, lane);

    float ds[8][4];  // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) (* scale)
#pragma unroll
    for (int i = 0; i < 8; ++i) ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0.f;
    scores_smem<8, KS, LDS>(ds, sV + warp * 16 * LDS, gt, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
        const float x = pt[nt][e] * (ds[nt][e] - dt[c]);
        ds[nt][e] = FLAT ? x : x * scale;
      }
    bya::pv_accumulate<8, ND, LDS>(dk_acc, ds, qt, lane);
    __syncthreads();
  }

  if (FLAT) {  // unwind the q-scale fold: dk = dS^T (q * scale * log2 e) / log2 e
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][e] *= 1.0f / LOG2E;
  }
  rope_adjoint<D>(dk_acc, row0, lane, cos_t, sin_t, rope_start, rope_rows);
  store_tile<D>(g0 + base, ld, dk_acc, row0, S, lane);
  store_tile<D>(g1 + base, ld, dv_acc, row0, S, lane);
}

// dQ (g0) of one 64-row q tile of one (batch, head): sweeps every kv tile.
// Warp w owns q rows q0 + 16w.. and accumulates dQ += dS K in fp32.
template <int D, bool FLAT>
__device__ __forceinline__ void dq_body(bf16* smem, BWD_PARAMS) {
  constexpr int LDS = D + 8, KS = D / 16, ND = D / 8;
  bf16* sQ = smem;
  bf16* sG = sQ + BM * LDS;      // dO
  bf16* sK = sG + BM * LDS;      // two slots
  bf16* sV = sK + 2 * BN * LDS;  // two slots
  float* sDl = reinterpret_cast<float*>(sV + 2 * BN * LDS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const long long base = L.off(b, h), ld = L.ss;
  const long long bh = ((long long)b * H + h) * S;
  const float scale_log2 = scale * LOG2E;

  bya::load_rows<BM, D, NTHREADS>(sQ, LDS, q + base, ld, q0, S, tid);
  bya::load_rows<BM, D, NTHREADS>(sG, LDS, dout + base, ld, q0, S, tid);
  bya::load_rows<BN, D, NTHREADS>(sK, LDS, k + base, ld, 0, kv_len, tid);
  bya::load_rows<BN, D, NTHREADS>(sV, LDS, v + base, ld, 0, kv_len, tid);
  bya::cp_async_commit();
  bya::cp_async_wait<0>();
  __syncthreads();
  if (!FLAT) {
    row_delta<D>(sDl, o + base, ld, sG, q0, S, tid);
    __syncthreads();
  }

  const int r_loc = warp * 16 + (lane >> 2);
  const int row0 = q0 + r_loc;
  const float lse2[2] = {row0 < S ? lse[bh + row0] * LOG2E : 0.f,
                         row0 + 8 < S ? lse[bh + row0 + 8] * LOG2E : 0.f};
  float dl[2];
  if (FLAT) {
    dl[0] = row0 < S ? delta[bh + row0] : 0.f;
    dl[1] = row0 + 8 < S ? delta[bh + row0 + 8] : 0.f;
  } else {
    dl[0] = sDl[r_loc];
    dl[1] = sDl[r_loc + 8];
  }

  float acc[ND][4];
  zero<D>(acc);
  const int n_tiles = (kv_len + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      bya::load_rows<BN, D, NTHREADS>(sK + (buf ^ 1) * BN * LDS, LDS, k + base, ld,
                                      (j + 1) * BN, kv_len, tid);
      bya::load_rows<BN, D, NTHREADS>(sV + (buf ^ 1) * BN * LDS, LDS, v + base, ld,
                                      (j + 1) * BN, kv_len, tid);
      bya::cp_async_commit();
      bya::cp_async_wait<1>();
    } else {
      bya::cp_async_wait<0>();
    }
    __syncthreads();
    const int kv0 = j * BN;
    const bf16* kt = sK + buf * BN * LDS;

    float p[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
    scores_smem<8, KS, LDS>(p, sQ + warp * 16 * LDS, kt, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kv0 + nt * 8 + (lane & 3) * 2 + (e & 1);
        const float x = FLAT ? p[nt][e] : p[nt][e] * scale_log2;
        p[nt][e] = c < kv_len ? exp2f(x - lse2[e >> 1]) : 0.f;
      }
    float ds[8][4];  // dP = dO V^T, then dS = P (dP - delta) (* scale)
#pragma unroll
    for (int i = 0; i < 8; ++i) ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0.f;
    scores_smem<8, KS, LDS>(ds, sG + warp * 16 * LDS, sV + buf * BN * LDS, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = p[nt][e] * (ds[nt][e] - dl[e >> 1]);
        ds[nt][e] = FLAT ? x : x * scale;
      }
    bya::pv_accumulate<8, ND, LDS>(acc, ds, kt, lane);
    __syncthreads();
  }

  if (FLAT) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= scale;
  }
  rope_adjoint<D>(acc, row0, lane, cos_t, sin_t, rope_start, rope_rows);
  store_tile<D>(g0 + base, ld, acc, row0, S, lane);
}

// B7's backward pair
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(BWD_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  dkv_body<64, true>(reinterpret_cast<bf16*>(smem_raw), BWD_ARGS);
}

__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(BWD_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  dq_body<64, true>(reinterpret_cast<bf16*>(smem_raw), BWD_ARGS);
}

// B12 and B13
template <int D>
__global__ void __launch_bounds__(NTHREADS) mha_bwd_dkv_layout_kernel(BWD_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  dkv_body<D, false>(reinterpret_cast<bf16*>(smem_raw), BWD_ARGS);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) mha_bwd_dq_layout_kernel(BWD_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  dq_body<D, false>(reinterpret_cast<bf16*>(smem_raw), BWD_ARGS);
}

// ---------------------------------------------------------------- launchers

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename K>
cudaError_t launch_prep(K kernel, const void* q, const void* k, void* q_prep, void* k_prep,
                        const float* ln_q_w, const float* ln_q_b, const float* ln_k_w,
                        const float* ln_k_b, const float* cos_t, const float* sin_t,
                        int rope_start, int rope_rows, int B, int S, int H, Layout L,
                        float q_scale, float ln_eps, cudaStream_t st) {
  const long long threads = (long long)B * S * H * 32;
  const int block = 256;
  kernel<<<(unsigned)((threads + block - 1) / block), block, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(q_prep),
      static_cast<bf16*>(k_prep), ln_q_w, ln_q_b, ln_k_w, ln_k_b, cos_t, sin_t, rope_start,
      rope_rows, B, S, H, L, q_scale, ln_eps);
  return cudaGetLastError();
}

// One backward kernel over the prepared q, k: `dkv` picks dK/dV (g0, g1)
// or dQ (g0).
template <typename K>
cudaError_t launch_bwd(K kernel, int smem, bool dkv, const void* q, const void* k,
                       const void* v, const void* o, const void* dout, const float* lse,
                       const float* delta, void* g0, void* g1, const float* cos_t,
                       const float* sin_t, int rope_start, int rope_rows, Layout L, int B, int S,
                       int H, int kv_len, float scale, cudaStream_t st) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + (dkv ? BN : BM) - 1) / (dkv ? BN : BM), H, B);
  kernel<<<grid, NTHREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(g0), static_cast<bf16*>(g1), cos_t, sin_t, rope_start, rope_rows, L, S,
      H, kv_len, scale);
  return cudaGetLastError();
}

template <int D>
int run_layout_fwd(const void* q, const void* k, const void* v, void* o, void* q_prep,
                   void* k_prep, const float* ln_q_w, const float* ln_q_b, const float* ln_k_w,
                   const float* ln_k_b, const float* cos_t, const float* sin_t, int rope_start,
                   int rope_rows, int B, int S, int H, int bshd, int kv_len, float scale,
                   float ln_eps, float* lse, cudaStream_t st) {
  const Layout L = make_layout(S, H, D, bshd);
  cudaError_t err;
  if (q_prep != nullptr) {
    err = launch_prep(layout_prep_kernel<D>, q, k, q_prep, k_prep, ln_q_w, ln_q_b, ln_k_w,
                      ln_k_b, cos_t, sin_t, rope_start, rope_rows, B, S, H, L, 1.0f, ln_eps, st);
    if (err != cudaSuccess) return (int)err;
    q = q_prep;
    k = k_prep;
  }
  const int smem = 5 * BM * (D + 8) * (int)sizeof(bf16);
  err = allow_smem(mha_fwd_layout_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, H, B);
  mha_fwd_layout_kernel<D><<<grid, NTHREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, L, S, H, kv_len, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int run_layout_bwd(bool dkv, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* g0, void* g1, const float* cos_t,
                   const float* sin_t, int rope_start, int rope_rows, int B, int S, int H,
                   int bshd, int kv_len, float scale, cudaStream_t st) {
  const Layout L = make_layout(S, H, D, bshd);
  return (int)(dkv ? launch_bwd(mha_bwd_dkv_layout_kernel<D>, bwd_smem<D>(), true, q, k, v, o,
                                dout, lse, nullptr, g0, g1, cos_t, sin_t, rope_start, rope_rows,
                                L, B, S, H, kv_len, scale, st)
                   : launch_bwd(mha_bwd_dq_layout_kernel<D>, bwd_smem<D>(), false, q, k, v, o,
                                dout, lse, nullptr, g0, nullptr, cos_t, sin_t, rope_start,
                                rope_rows, L, B, S, H, kv_len, scale, st));
}

}  // namespace

// B1 / B7 forward.  q, k, v, o, q_prep, k_prep: [B, S, H*64] bf16,
// contiguous.  ln_*: [64] fp32 or all null (no QK LayerNorm).  cos_t/sin_t:
// [rope_rows, 64] fp32 or null (no RoPE).  lse: [B, H, S] fp32 or null.
// Returns the cudaError_t of the launches.
extern "C" int bya_flash_attention_flat(const void* q, const void* k, const void* v, void* o,
                                        void* q_prep, void* k_prep, const float* ln_q_w,
                                        const float* ln_q_b, const float* ln_k_w,
                                        const float* ln_k_b, const float* cos_t,
                                        const float* sin_t, int rope_start, int rope_rows,
                                        int B, int S, int H, int kv_len, float scale,
                                        float ln_eps, float* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L = make_layout(S, H, 64, 1);
  cudaError_t err = launch_prep(prep_qk_kernel, q, k, q_prep, k_prep, ln_q_w, ln_q_b, ln_k_w,
                                ln_k_b, cos_t, sin_t, rope_start, rope_rows, B, S, H, L,
                                scale * LOG2E, ln_eps, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, 0, st>>>(static_cast<const bf16*>(q_prep),
                                              static_cast<const bf16*>(k_prep),
                                              static_cast<const bf16*>(v),
                                              static_cast<bf16*>(o), lse, L, S, H, kv_len);
  return (int)cudaGetLastError();
}

// B7 backward.  q, k, v, dout, dq, dk, dv, q_prep, k_prep: [B, S, H*64]
// bf16, contiguous; lse (natural log) and delta = rowsum(o * dout): [B, H, S]
// fp32; cos_t/sin_t as for the forward.  Returns the cudaError_t of the
// launches.
extern "C" int bya_flash_attention_flat_bwd(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* delta, void* dq, void* dk, void* dv,
                                            void* q_prep, void* k_prep, const float* cos_t,
                                            const float* sin_t, int rope_start, int rope_rows,
                                            int B, int S, int H, int kv_len, float scale,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L = make_layout(S, H, 64, 1);
  cudaError_t err = launch_prep(prep_qk_kernel, q, k, q_prep, k_prep, nullptr, nullptr, nullptr,
                                nullptr, cos_t, sin_t, rope_start, rope_rows, B, S, H, L,
                                scale * LOG2E, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_bwd(flash_bwd_dkdv_kernel, bwd_smem<64>(), true, q_prep, k_prep, v, nullptr, dout,
                   lse, delta, dk, dv, cos_t, sin_t, rope_start, rope_rows, L, B, S, H, kv_len,
                   scale, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_bwd(flash_bwd_dq_kernel, bwd_smem<64>(), false, q_prep, k_prep, v, nullptr,
                         dout, lse, delta, dq, nullptr, cos_t, sin_t, rope_start, rope_rows, L,
                         B, S, H, kv_len, scale, st);
}

// B11.  q, k, v, o: [B, H, S, D] (bshd = 0) or [B, S, H, D] (bshd = 1) bf16,
// contiguous, D = 64 or 128.  q_prep/k_prep: scratch of q's shape, or null
// when there is neither LN nor RoPE.  ln_*: [D] fp32 or all null.
// cos_t/sin_t: [rope_rows, D] fp32 or null.  lse: [B, H, S] fp32 or null.
// Returns the cudaError_t of the launches.
extern "C" int bya_flash_layout_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* q_prep, void* k_prep, const float* ln_q_w,
                                    const float* ln_q_b, const float* ln_k_w,
                                    const float* ln_k_b, const float* cos_t, const float* sin_t,
                                    int rope_start, int rope_rows, int B, int S, int H, int D,
                                    int bshd, int kv_len, float scale, float ln_eps, float* lse,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return run_layout_fwd<64>(q, k, v, o, q_prep, k_prep, ln_q_w, ln_q_b, ln_k_w, ln_k_b, cos_t,
                              sin_t, rope_start, rope_rows, B, S, H, bshd, kv_len, scale, ln_eps,
                              lse, st);
  if (D == 128)
    return run_layout_fwd<128>(q, k, v, o, q_prep, k_prep, ln_q_w, ln_q_b, ln_k_w, ln_k_b, cos_t,
                               sin_t, rope_start, rope_rows, B, S, H, bshd, kv_len, scale, ln_eps,
                               lse, st);
  return (int)cudaErrorInvalidValue;
}

// The RoPE pre-pass that B12 and B13 share: q, k -> q_rot, k_rot (same
// layout as B11's tensors), rows [rope_start, rope_start + rope_rows).
extern "C" int bya_flash_layout_rope(const void* q, const void* k, void* q_rot, void* k_rot,
                                     const float* cos_t, const float* sin_t, int rope_start,
                                     int rope_rows, int B, int S, int H, int D, int bshd,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(S, H, D, bshd);
  return (int)(D == 64 ? launch_prep(layout_prep_kernel<64>, q, k, q_rot, k_rot, nullptr, nullptr,
                                     nullptr, nullptr, cos_t, sin_t, rope_start, rope_rows, B, S,
                                     H, L, 1.0f, 0.f, st)
                       : launch_prep(layout_prep_kernel<128>, q, k, q_rot, k_rot, nullptr,
                                     nullptr, nullptr, nullptr, cos_t, sin_t, rope_start,
                                     rope_rows, B, S, H, L, 1.0f, 0.f, st));
}

// B12 (dkv = 1: g0 = dk, g1 = dv) and B13 (dkv = 0: g0 = dq).  q and k are
// the rotated rows (`bya_flash_layout_rope`; q and k themselves without
// RoPE); v, o, dout and the gradients in the layout of B11; lse: [B, H, S]
// fp32 (natural log); cos_t/sin_t (or null) for the RoPE adjoint.
extern "C" int bya_flash_layout_bwd(int dkv, const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, const float* lse, void* g0,
                                    void* g1, const float* cos_t, const float* sin_t,
                                    int rope_start, int rope_rows, int B, int S, int H, int D,
                                    int bshd, int kv_len, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return run_layout_bwd<64>(dkv != 0, q, k, v, o, dout, lse, g0, g1, cos_t, sin_t, rope_start,
                              rope_rows, B, S, H, bshd, kv_len, scale, st);
  if (D == 128)
    return run_layout_bwd<128>(dkv != 0, q, k, v, o, dout, lse, g0, g1, cos_t, sin_t, rope_start,
                               rope_rows, B, S, H, bshd, kv_len, scale, st);
  return (int)cudaErrorInvalidValue;
}
