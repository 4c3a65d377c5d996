// B1: flat flash-attention forward with fused per-head QK LayerNorm and
// rotate-half RoPE, for head dim 64.
//
// Replaces the TPU kernel `_fwd_flat_t_kernel`
// (bindyouravatar_tpu/ops/flash_attention.py), reached through
// `flash_attention(layout="flat", v_transposed=True)` from the DiT's joint
// self-attention at inference.  Same math: per head, LN(eps, fp32 stats,
// fp32 affine) -> bf16, rotate-half RoPE on rows [rope_start, rope_start +
// rope_rows) -> bf16, q scaled by scale*log2(e) in fp32 -> bf16, then
// non-causal softmax(q k^T) v over kv rows < kv_len.
//
// What bounds it on the H100: the two matmuls, 4*S^2*D FLOP per head
// (~7.8e12 per layer at B=2, S=17,776, 48 heads), against ~0.2 GB of q/k/v
// traffic: compute bound, so the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate) carry both matmuls.
//
// Design:
//  * The TPU kernel prepares K once at grid step iq == 0 into scratch that
//    later grid steps reuse; GPU blocks run in no order, so a pre-pass
//    kernel (`prep_qk_kernel`) applies LN + RoPE (+ the q scale) to q and k
//    once, into bf16 scratch, and the attention kernel reads the prepared
//    tensors.  Nothing carries over between blocks.
//  * The softmax keeps an fp32 online running max per row (the TPU kernel's
//    static max is valid only behind the fused LN); masked scores are a
//    large finite negative, so no row ever computes inf - inf.
//  * One block = 4 warps = 64 query rows of one (batch, head); kv tiles of
//    64 rows stream through a cp.async double buffer.  Rows past S (q) and
//    past kv_len (k, v) are zero-filled on load; scores of kv rows >= kv_len
//    are masked; q rows >= S are never stored.
//  * q, k, v and the output keep the flat [B, S, H*64] layout: no transposed
//    V, no padded sequence.
#include "mma_utils.cuh"

namespace {

using bya::bf16;

constexpr int D = 64;
constexpr int BM = 64;  // query rows per block (16 per warp)
constexpr int BN = 64;  // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One warp prepares one 64-wide head row; lane holds elements 2*lane, +1.
// The rotate-half partner of element i < 32 is i + 32, held by lane ^ 16.
__device__ __forceinline__ void prep_row(const bf16* x, bf16* out, const float* w,
                                         const float* b, bool rot, float c0, float c1,
                                         float s0, float s1, float scale, float eps,
                                         int lane) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(x);
  float x0 = __low2float(v), x1 = __high2float(v);
  if (w != nullptr) {
    const float mean = warp_sum(x0 + x1) * (1.0f / D);
    const float d0 = x0 - mean, d1 = x1 - mean;
    const float r = rsqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.0f / D) + eps);
    x0 = bf16_round(d0 * r * w[2 * lane] + b[2 * lane]);
    x1 = bf16_round(d1 * r * w[2 * lane + 1] + b[2 * lane + 1]);
  }
  if (rot) {
    const float p0 = __shfl_xor_sync(FULL, x0, 16);
    const float p1 = __shfl_xor_sync(FULL, x1, 16);
    const float sign = lane < 16 ? -1.0f : 1.0f;
    x0 = bf16_round(x0 * c0 + sign * p0 * s0);
    x1 = bf16_round(x1 * c1 + sign * p1 * s1);
  }
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x0 * scale, x1 * scale);
}

__global__ void __launch_bounds__(256)
prep_qk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, bf16* __restrict__ qo,
               bf16* __restrict__ ko, const float* __restrict__ lnqw,
               const float* __restrict__ lnqb, const float* __restrict__ lnkw,
               const float* __restrict__ lnkb, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, int rope_start, int rope_rows,
               long long n_rows, int S, int H, float q_scale, float eps) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_rows * H) return;
  const long long row = warp / H;
  const int h = (int)(warp % H);
  const int s = (int)(row % S);
  const long long off = row * (long long)(H * D) + h * D + 2 * lane;
  const bool rot = cos_t != nullptr && s >= rope_start && s < rope_start + rope_rows;
  float c0 = 1.f, c1 = 1.f, s0 = 0.f, s1 = 0.f;
  if (rot) {
    const long long t = (long long)(s - rope_start) * D + 2 * lane;
    c0 = cos_t[t];
    c1 = cos_t[t + 1];
    s0 = sin_t[t];
    s1 = sin_t[t + 1];
  }
  prep_row(q + off, qo + off, lnqw, lnqb, rot, c0, c1, s0, s1, q_scale, eps, lane);
  prep_row(k + off, ko + off, lnkw, lnkb, rot, c0, c1, s0, s1, 1.0f, eps, lane);
}

// q is pre-scaled by scale*log2(e): scores are in log2 units, p = exp2(s - m).
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int kv_len) {
  __shared__ __align__(128) bf16 sQ[BM * LDS];
  __shared__ __align__(128) bf16 sK[2][BN * LDS];
  __shared__ __align__(128) bf16 sV[2][BN * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const long long ld = (long long)H * D;
  const long long boff = (long long)b * S * ld + (long long)h * D;
  const bf16* qb = q + boff;
  const bf16* kb = k + boff;
  const bf16* vb = v + boff;

  bya::load_rows64<BM, NTHREADS>(sQ, LDS, qb, ld, q0, S, tid);
  bya::load_rows64<BN, NTHREADS>(sK[0], LDS, kb, ld, 0, kv_len, tid);
  bya::load_rows64<BN, NTHREADS>(sV[0], LDS, vb, ld, 0, kv_len, tid);
  bya::cp_async_commit();

  const int n_tiles = (kv_len + BN - 1) / BN;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_i[2] = {MASKED, MASKED};
  float l_i[2] = {0.f, 0.f};
  uint32_t qf[4][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      bya::load_rows64<BN, NTHREADS>(sK[buf ^ 1], LDS, kb, ld, (j + 1) * BN, kv_len, tid);
      bya::load_rows64<BN, NTHREADS>(sV[buf ^ 1], LDS, vb, ld, (j + 1) * BN, kv_len, tid);
      bya::cp_async_commit();
      bya::cp_async_wait<1>();
    } else {
      bya::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) bya::load_a_frags64<LDS>(qf, sQ + warp * 16 * LDS, lane);

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    bya::qk_scores64<8, LDS>(s, qf, sK[buf], lane);

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
    for (int nd = 0; nd < 8; ++nd) {
      acc[nd][0] *= alpha0;
      acc[nd][1] *= alpha0;
      acc[nd][2] *= alpha1;
      acc[nd][3] *= alpha1;
    }
    bya::pv_accumulate64<8, LDS>(acc, s, sV[buf], lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(FULL, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(FULL, l_i[r], 2);
  }
  const float inv0 = 1.f / l_i[0], inv1 = 1.f / l_i[1];
  const int row0 = q0 + warp * 16 + (lane >> 2);
  bf16* ob = o + boff;
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) {
    const int col = nd * 8 + (lane & 3) * 2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * ld + col) =
          bya::pack_bf16(acc[nd][0] * inv0, acc[nd][1] * inv0);
    if (row0 + 8 < S)
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * ld + col) =
          bya::pack_bf16(acc[nd][2] * inv1, acc[nd][3] * inv1);
  }
}

}  // namespace

// q, k, v, o, q_prep, k_prep: [B, S, H*64] bf16, contiguous.  ln_*: [64]
// fp32 or all null (no QK LayerNorm).  cos_t/sin_t: [rope_rows, 64] fp32 or
// null (no RoPE).  Returns the cudaError_t of the launches.
extern "C" int bya_flash_attention_flat(const void* q, const void* k, const void* v, void* o,
                                        void* q_prep, void* k_prep, const float* ln_q_w,
                                        const float* ln_q_b, const float* ln_k_w,
                                        const float* ln_k_b, const float* cos_t,
                                        const float* sin_t, int rope_start, int rope_rows,
                                        int B, int S, int H, int kv_len, float scale,
                                        float ln_eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)B * S;
  const long long threads = n_rows * H * 32;
  const int block = 256;
  const unsigned grid_prep = (unsigned)((threads + block - 1) / block);
  prep_qk_kernel<<<grid_prep, block, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(q_prep),
      static_cast<bf16*>(k_prep), ln_q_w, ln_q_b, ln_k_w, ln_k_b, cos_t, sin_t, rope_start,
      rope_rows, n_rows, S, H, scale * LOG2E, ln_eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, 0, st>>>(static_cast<const bf16*>(q_prep),
                                              static_cast<const bf16*>(k_prep),
                                              static_cast<const bf16*>(v),
                                              static_cast<bf16*>(o), S, H, kv_len);
  return (int)cudaGetLastError();
}
