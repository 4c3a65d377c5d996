// Flash attention forward: kernels B1 and B7's forward over the flat
// [B, S, H*64] layout, and B11 over [B, H, S, D] ("bhsd") or [B, S, H, D]
// ("bshd") for head dims 64 and 128.  One source: a pre-pass body and a
// forward body templated on the head dim and on the scale mode, each
// instantiated under its own kernel name.  The backward of B7 and of B11
// (B12 + B13) is one fused kernel in flash_attention_bwd.cu.
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
// [B, H, S]).
//
// B11 replaces `_fwd_kernel`, reached through `flash_attention(layout=
// "bhsd" | "bshd")`: the differentiable `_flash` custom vjp (saving the
// LSE) and the inference form with the QK LayerNorm fused.  Same math as
// B1 up to the scale: the TPU body's tricks (scale and log2 e folded into a
// rounded q, a ones column for the row sum, the eye-matmul LSE store) are
// not copied, the scale multiplies the fp32 scores.
//
// What bounds them on the H100: the matmuls, 4*S^2*D FLOP per head (~3.9e12
// per layer at B=1, S=17,776, 48 heads of 64) against ~0.1-0.4 GB of
// q/k/v/o traffic.  Compute bound, so the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate) carry every product.
//
// Design:
//  * The kernels take the batch, head and row strides of a [B, H, S, D]
//    view (`Layout`), so flat (bshd at D = 64), bhsd and bshd come from one
//    body; rows are 16-byte vector loads (D % 8 == 0).
//  * The TPU kernels prepare K once at grid step iq == 0 into scratch that
//    later grid steps reuse; GPU blocks run in no order, so a pre-pass
//    (`prep_qk`) applies LN + RoPE (+ B1/B7's q scale) to q and k once, into
//    bf16 scratch of the input's layout, and the attention kernels read the
//    prepared tensors.  Without LN, RoPE or a q scale (B11 with no options)
//    the kernel reads q and k directly.
//  * The softmax keeps an fp32 online running max per row (the TPU kernel's
//    static max is valid only behind the fused LN); masked scores are a
//    large finite negative, so no row ever computes inf - inf.  A row with
//    no kv gets the LSE +big, so the backward's P is 0 there.
//  * One block = 4 warps = 64 query rows of one (batch, head); kv tiles of
//    64 rows stream through a cp.async double buffer; a warp keeps its q
//    fragments in registers.  Rows past S (q) and kv_len (k, v) are
//    zero-filled on load and masked; q rows >= S are never stored.
//  * Shared memory: 46 KB at D = 64, static in B1/B7's kernel; B11's is
//    dynamic, and its launcher raises the kernel's limit.
#include "flash_common.cuh"

namespace {

using bya::bf16;
using bya::Layout;
using bya::LOG2E;
using bya::LSE_EMPTY;
using bya::MASKED;
using bya::FULL;
using bya::make_layout;

constexpr int BM = 64;  // query rows per block (16 per warp)
constexpr int BN = 64;  // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <int D>
__device__ __forceinline__ void zero(float (&a)[D / 8][4]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// ---------------------------------------------------------------- pre-pass

// LN (if lnqw) and RoPE (if cos_t) of q and k into qo/ko, same layout; q
// also scaled by q_scale.  One warp per (b, s, h) row.
template <int D>
__device__ __forceinline__ void prep_qk(const bf16* q, const bf16* k, bf16* qo, bf16* ko,
                                        const float* lnqw, const float* lnqb, const float* lnkw,
                                        const float* lnkb, const float* cos_t, const float* sin_t,
                                        int rope_start, int rope_rows, int B, int S, int H,
                                        Layout L, float q_scale, float eps) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * S * H) return;
  const int h = (int)(warp % H);
  const long long bs = warp / H;
  const int s = (int)(bs % S), b = (int)(bs / S);
  bya::prep_qk_row<D>(q, k, qo, ko, lnqw, lnqb, lnkw, lnkb, cos_t, sin_t, rope_start,
                      rope_rows, b, s, h, L, q_scale, eps, lane);
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

// B11's (LN and RoPE) pre-pass
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
