// B5 (and B5', and B8 its backward): multi-head self-attention over a tiny sequence, per row of a
// huge batch, channel-packed:
//   q, k, v, o: [M, S, H*64]; head h = channels [64h, 64h + 64)
//   o[m, a, h] = sum_b softmax_b(q[m, a, h] . k[m, b, h] * scale) v[m, b, h]
//
// Replaces two TPU kernels of bindyouravatar_tpu/ops/packed_attention.py
// that compute this one function:
//   * B5, `_slice_kernel` (per-head lane slices, S >= 8), reached through
//     `tiny_seq_attention` from the router's temporal STAB attention
//     (S = T = 13 latent frames, M = B*I*H*W = 5,400 rows at the 5B path);
//   * B5', `_kernel` (the packed-head fold with a block-diagonal head mask,
//     S < 8), reached through `packed_head_attention` from the same call at
//     fewer than 8 latent frames.  Its [M, S*H, 64] operand is the same
//     memory as [M, S, H*64], so one kernel, instantiated per S, serves both.
// Same math and roundings: fp32 scores, fp32 softmax normalised before p is
// rounded to bf16, fp32 P.V, bf16 store.
//
// What bounds it on the H100: memory.  Per (row, head) it reads 3 * S * 128 B
// and writes S * 128 B against 4 * S^2 * 64 FLOP: at S = 13, 6.5 FLOP/B.  At
// [5400, 13, 8*64] a call moves ~288 MB: ~0.086 ms at 3.35 TB/s.  The [S, S]
// scores are too small for the tensor cores to matter.
//
// B8, `tiny_seq_attention`'s backward at S >= 8, replaces `_slice_bwd_kernel`
// (reached through `_tiny_bwd_pallas` from the custom vjp `_tiny_bwd`): the
// softmax vjp per (row, head) in fp32, scores recomputed,
//   dv_b = sum_a p_ab g_a,  dp_ab = g_a . v_b,
//   ds_ab = p_ab (dp_ab - sum_b' p_ab' dp_ab') * scale,
//   dq_a = sum_b ds_ab k_b,  dk_b = sum_a ds_ab q_a,
// written flat [M, S, H*64] in the input dtype.  Memory bound as the
// forward: 4 tensors read, 3 written (~504 MB at [5400, 13, 512]) against
// ~10 S^2 * 64 FLOP per (row, head).
//
// Design: one warp per (m, head); lane l owns channels 2l, 2l+1 of the
// head, so each of the S rows of q, k, v is one coalesced 128-byte load per
// warp.  k and v stay in registers (4*S floats a lane); for each query row
// the S scores are partial dots reduced across the warp with xor shuffles,
// the softmax runs redundantly in every lane, and the lane writes its two
// output channels.  Warps of one block take consecutive (m, head) items, so
// rows of different m never share a score, and warps past M*H return
// before loading anything (the ragged last block).  The backward keeps k and
// v (and the dk, dv sums) in registers, streams the query rows a with their
// output gradients g_a, and reduces each score and each dp_ab across the
// warp with shuffles; S is a template parameter (8..16) as in the forward.
#include "mma_utils.cuh"

namespace {

using bya::bf16;

constexpr int DH = 64;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_S = 16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int S>
__global__ void __launch_bounds__(NTHREADS)
tiny_seq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, long long n_items, int H,
                float scale_log2) {
  const long long item = ((long long)blockIdx.x * NTHREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= n_items) return;
  const long long m = item / H;
  const int h = (int)(item % H);
  const long long ld = (long long)H * DH;
  const long long base = m * S * ld + (long long)h * DH + 2 * lane;

  float kx[S], ky[S], vx[S], vy[S];
#pragma unroll
  for (int b = 0; b < S; ++b) {
    const __nv_bfloat162 kb = *reinterpret_cast<const __nv_bfloat162*>(k + base + b * ld);
    const __nv_bfloat162 vb = *reinterpret_cast<const __nv_bfloat162*>(v + base + b * ld);
    kx[b] = __low2float(kb);
    ky[b] = __high2float(kb);
    vx[b] = __low2float(vb);
    vy[b] = __high2float(vb);
  }

#pragma unroll 1
  for (int a = 0; a < S; ++a) {
    const __nv_bfloat162 qa = *reinterpret_cast<const __nv_bfloat162*>(q + base + a * ld);
    const float qx = __low2float(qa), qy = __high2float(qa);
    float sc[S];
    float mx = -1e30f;
#pragma unroll
    for (int b = 0; b < S; ++b) {
      sc[b] = warp_sum(qx * kx[b] + qy * ky[b]) * scale_log2;
      mx = fmaxf(mx, sc[b]);
    }
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < S; ++b) {
      sc[b] = exp2f(sc[b] - mx);
      sum += sc[b];
    }
    const float inv = 1.f / sum;
    float ox = 0.f, oy = 0.f;
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const float p = bf16_round(sc[b] * inv);
      ox += p * vx[b];
      oy += p * vy[b];
    }
    *reinterpret_cast<uint32_t*>(o + base + a * ld) = bya::pack_bf16(ox, oy);
  }
}

template <int S>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int M, int H,
                   float scale, cudaStream_t st) {
  const long long n_items = (long long)M * H;
  const unsigned blocks = (unsigned)((n_items + NWARPS - 1) / NWARPS);
  tiny_seq_kernel<S><<<blocks, NTHREADS, 0, st>>>(q, k, v, o, n_items, H, scale * LOG2E);
  return cudaGetLastError();
}

template <int S>
__global__ void __launch_bounds__(NTHREADS)
tiny_seq_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    long long n_items, int H, float scale) {
  const long long item = ((long long)blockIdx.x * NTHREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= n_items) return;
  const long long m = item / H;
  const int h = (int)(item % H);
  const long long ld = (long long)H * DH;
  const long long base = m * S * ld + (long long)h * DH + 2 * lane;

  float kx[S], ky[S], vx[S], vy[S], dkx[S], dky[S], dvx[S], dvy[S];
#pragma unroll
  for (int b = 0; b < S; ++b) {
    const __nv_bfloat162 kb = *reinterpret_cast<const __nv_bfloat162*>(k + base + b * ld);
    const __nv_bfloat162 vb = *reinterpret_cast<const __nv_bfloat162*>(v + base + b * ld);
    kx[b] = __low2float(kb);
    ky[b] = __high2float(kb);
    vx[b] = __low2float(vb);
    vy[b] = __high2float(vb);
    dkx[b] = dky[b] = dvx[b] = dvy[b] = 0.f;
  }

#pragma unroll 1
  for (int a = 0; a < S; ++a) {
    const __nv_bfloat162 qa = *reinterpret_cast<const __nv_bfloat162*>(q + base + a * ld);
    const __nv_bfloat162 ga = *reinterpret_cast<const __nv_bfloat162*>(g + base + a * ld);
    const float qx = __low2float(qa), qy = __high2float(qa);
    const float gx = __low2float(ga), gy = __high2float(ga);
    float p[S], dp[S];
    float mx = -1e30f;
#pragma unroll
    for (int b = 0; b < S; ++b) {
      p[b] = warp_sum(qx * kx[b] + qy * ky[b]) * scale;
      mx = fmaxf(mx, p[b]);
    }
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < S; ++b) {
      p[b] = expf(p[b] - mx);
      sum += p[b];
    }
    const float inv = 1.f / sum;
    float rowdot = 0.f;
#pragma unroll
    for (int b = 0; b < S; ++b) {
      p[b] *= inv;
      dp[b] = warp_sum(gx * vx[b] + gy * vy[b]);
      rowdot += p[b] * dp[b];
    }
    float dqx = 0.f, dqy = 0.f;
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const float ds = p[b] * (dp[b] - rowdot) * scale;
      dqx += ds * kx[b];
      dqy += ds * ky[b];
      dkx[b] += ds * qx;
      dky[b] += ds * qy;
      dvx[b] += p[b] * gx;
      dvy[b] += p[b] * gy;
    }
    *reinterpret_cast<uint32_t*>(dq + base + a * ld) = bya::pack_bf16(dqx, dqy);
  }
#pragma unroll
  for (int b = 0; b < S; ++b) {
    *reinterpret_cast<uint32_t*>(dk + base + b * ld) = bya::pack_bf16(dkx[b], dky[b]);
    *reinterpret_cast<uint32_t*>(dv + base + b * ld) = bya::pack_bf16(dvx[b], dvy[b]);
  }
}

template <int S>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq,
                       bf16* dk, bf16* dv, int M, int H, float scale, cudaStream_t st) {
  const long long n_items = (long long)M * H;
  const unsigned blocks = (unsigned)((n_items + NWARPS - 1) / NWARPS);
  tiny_seq_bwd_kernel<S><<<blocks, NTHREADS, 0, st>>>(q, k, v, g, dq, dk, dv, n_items, H,
                                                      scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [M, S, H*64] bf16, contiguous; 1 <= S <= 16.  Returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for a shape it does
// not take.
extern "C" int bya_tiny_seq_attention(const void* q, const void* k, const void* v, void* o,
                                      int M, int S, int H, int D, float scale, void* stream) {
  if (D != DH || S < 1 || S > MAX_S || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
#define BYA_TINY_CASE(n) \
  case n:                \
    return (int)launch<n>(qp, kp, vp, op, M, H, scale, st);
    BYA_TINY_CASE(1) BYA_TINY_CASE(2) BYA_TINY_CASE(3) BYA_TINY_CASE(4)
    BYA_TINY_CASE(5) BYA_TINY_CASE(6) BYA_TINY_CASE(7) BYA_TINY_CASE(8)
    BYA_TINY_CASE(9) BYA_TINY_CASE(10) BYA_TINY_CASE(11) BYA_TINY_CASE(12)
    BYA_TINY_CASE(13) BYA_TINY_CASE(14) BYA_TINY_CASE(15) BYA_TINY_CASE(16)
#undef BYA_TINY_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// B8: q, k, v, g (the output gradient), dq, dk, dv: [M, S, H*64] bf16,
// contiguous; 8 <= S <= 16.  Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int bya_tiny_seq_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* g, void* dq, void* dk, void* dv, int M,
                                          int S, int H, int D, float scale, void* stream) {
  if (D != DH || S < 8 || S > MAX_S || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
#define BYA_TINY_BWD_CASE(n) \
  case n:                    \
    return (int)launch_bwd<n>(qp, kp, vp, gp, dqp, dkp, dvp, M, H, scale, st);
    BYA_TINY_BWD_CASE(8) BYA_TINY_BWD_CASE(9) BYA_TINY_BWD_CASE(10) BYA_TINY_BWD_CASE(11)
    BYA_TINY_BWD_CASE(12) BYA_TINY_BWD_CASE(13) BYA_TINY_BWD_CASE(14) BYA_TINY_BWD_CASE(15)
    BYA_TINY_BWD_CASE(16)
#undef BYA_TINY_BWD_CASE
  }
  return (int)cudaErrorInvalidValue;
}
