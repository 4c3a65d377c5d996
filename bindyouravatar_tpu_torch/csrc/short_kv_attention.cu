// Long-query / short-KV cross-attention: kernels B3 and B2.
//
// B3, with the fused identity combine, for head dim 64:
//   out[g, q, h] = sum_i w[g, q, i] * softmax_k(q . k_i^T * scale) . v_i
// with one softmax per identity i.
//
// Replaces the TPU kernel `_kernel_flat`
// (bindyouravatar_tpu/ops/short_kv_attention.py), reached through
// `short_kv_attention_combined_flat` from the audio cross-attention
// (models/audio.py).  Same math and roundings: fp32 scores, fp32 softmax
// normalised before p is rounded to bf16, fp32 P.V, fp32 weighted sum,
// bf16 store.
//
// What bounds it on the H100: memory.  Per (query row, head) it reads 128 B
// of q and writes 128 B of output against 16 KFLOP (I=2, K=32), ~125
// FLOP/B; the tensor cores (mma.sync m16n8k16) keep the arithmetic far
// below the time of the q/out traffic (~0.43 GB per call at the slice).
//
// B3 design: one block = 4 warps for one (g, head) and 256 query rows.  The
// block stages every identity's K and V for its head in shared memory once
// (I*K*64*2 bf16, 16 KB at I=2, K=32) and streams 64-row query tiles past
// them; each warp owns 16 query rows, so scores, softmax and the combine
// stay in registers.  Query rows past Sq are zero-filled and never stored.
#include "mma_utils.cuh"

namespace {

using bya::bf16;

constexpr int D = 64;
constexpr int BM = 64;             // query rows per tile (16 per warp)
constexpr int ROWS_PER_BLOCK = 256;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;
constexpr int KT = 32;             // tokens per identity (the audio context)
constexpr int MAX_ID = 4;          // identities: I*KT*2 rows of K/V in smem
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(NTHREADS)
short_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ w, bf16* __restrict__ o,
                int Sq, int I, int H, float scale) {
  constexpr int NT = KT / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * LDS;
  bf16* sV = sK + I * KT * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, g = blockIdx.z;
  const long long ld = (long long)H * D;
  const bf16* qb = q + (long long)g * Sq * ld + (long long)h * D;
  bf16* ob = o + (long long)g * Sq * ld + (long long)h * D;

  for (int i = 0; i < I; ++i) {
    const long long kv_off = (((long long)g * I + i) * H + h) * KT * D;
    bya::load_rows64<KT, NTHREADS>(sK + i * KT * LDS, LDS, k + kv_off, D, 0, KT, tid);
    bya::load_rows64<KT, NTHREADS>(sV + i * KT * LDS, LDS, v + kv_off, D, 0, KT, tid);
  }

  const int row_end = min(Sq, (int)(blockIdx.x + 1) * ROWS_PER_BLOCK);
  for (int q0 = blockIdx.x * ROWS_PER_BLOCK; q0 < row_end; q0 += BM) {
    bya::load_rows64<BM, NTHREADS>(sQ, LDS, qb, ld, q0, Sq, tid);
    bya::cp_async_commit();
    bya::cp_async_wait<0>();
    __syncthreads();

    uint32_t qf[4][4];
    bya::load_a_frags64<LDS>(qf, sQ + warp * 16 * LDS, lane);
    const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;

    float acc[8][4];
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

    for (int i = 0; i < I; ++i) {
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      bya::qk_scores64<NT, LDS>(s, qf, sK + i * KT * LDS, lane);

      float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = __expf(s[nt][0] - mx0);
        s[nt][1] = __expf(s[nt][1] - mx0);
        s[nt][2] = __expf(s[nt][2] - mx1);
        s[nt][3] = __expf(s[nt][3] - mx1);
        sum0 += s[nt][0] + s[nt][1];
        sum1 += s[nt][2] + s[nt][3];
      }
      sum0 += __shfl_xor_sync(FULL, sum0, 1);
      sum0 += __shfl_xor_sync(FULL, sum0, 2);
      sum1 += __shfl_xor_sync(FULL, sum1, 1);
      sum1 += __shfl_xor_sync(FULL, sum1, 2);
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] *= inv0;
        s[nt][1] *= inv0;
        s[nt][2] *= inv1;
        s[nt][3] *= inv1;
      }

      float oi[8][4];
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) oi[nd][0] = oi[nd][1] = oi[nd][2] = oi[nd][3] = 0.f;
      bya::pv_accumulate64<NT, LDS>(oi, s, sV + i * KT * LDS, lane);

      const long long wrow = (long long)g * Sq;
      const float w0 = r0 < Sq ? __bfloat162float(w[(wrow + r0) * I + i]) : 0.f;
      const float w1 = r1 < Sq ? __bfloat162float(w[(wrow + r1) * I + i]) : 0.f;
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        acc[nd][0] += w0 * oi[nd][0];
        acc[nd][1] += w0 * oi[nd][1];
        acc[nd][2] += w1 * oi[nd][2];
        acc[nd][3] += w1 * oi[nd][3];
      }
    }

#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const int col = nd * 8 + (lane & 3) * 2;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * ld + col) = bya::pack_bf16(acc[nd][0], acc[nd][1]);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * ld + col) = bya::pack_bf16(acc[nd][2], acc[nd][3]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- B2
// Per-identity cross-attention without a combine, for head dim 128:
//   o[b, i, q, h] = softmax_k(q . k_i^T * scale) . v_i
// with one softmax per identity i and one output row per identity.
//
// Replaces the TPU kernel `_kernel` (bindyouravatar_tpu/ops/
// short_kv_attention.py, `combine=False`), reached through
// `short_kv_attention` from the perceiver face injection
// (models/router.py:PerceiverCrossAttention).  Same math and roundings as
// the TPU kernel: fp32 scores in log2 units (q.k * scale * log2 e), fp32
// exp2 softmax normalised before p is rounded to bf16, fp32 P.V, bf16
// store.  Unlike the TPU kernel, q is read in the to_q projection's flat
// [B, Sq, H*128] layout and each identity's output is written flat
// [B, I, Sq, H*128], the layout the routing combine reads: no head-major
// transposes.
//
// What bounds it on the H100: memory.  Per (query row, head) it reads 256 B
// of q and writes I * 256 B against I * 32 KFLOP (K = 32): ~85 FLOP/B at
// I = 2, far below the ~295 FLOP/B ridge.  At the 5B path (B = 2, Sq =
// 17,550, 16 heads, I = 2) a call moves ~144 MB of q and ~288 MB of output:
// ~0.13 ms at 3.35 TB/s.
//
// Design: as B3, one block = 4 warps for one (b, head) and 256 query rows;
// every identity's K and V for the head (I * 32 rows of 128, 32 KB at I = 2)
// sit in shared memory and 64-row query tiles stream past them.  A warp
// keeps its 16 rows' q fragments (k = 0..127) in registers and, identity by
// identity, computes the [16, 32] scores, the softmax and the [16, 128]
// output in registers, then stores that identity's rows.  Shared memory is
// ~51 KB at I = 2, so the launcher raises the dynamic limit.  Query rows
// past Sq are zero-filled on load and never stored.
constexpr int D2 = 128;
constexpr int LDS2 = D2 + 8;
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(NTHREADS)
short_kv_attend_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int I, int H,
                       float scale_log2) {
  constexpr int NT = KT / 8;   // 8-key score fragments per identity
  constexpr int KS = D2 / 16;  // 16-wide k steps of q . k
  constexpr int ND = D2 / 8;   // 8-wide output fragments
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * LDS2;
  bf16* sV = sK + I * KT * LDS2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long ld = (long long)H * D2;
  const bf16* qb = q + (long long)b * Sq * ld + (long long)h * D2;

  for (int i = 0; i < I; ++i) {
    const long long kv_off = (((long long)b * I + i) * H + h) * KT * D2;
    bya::load_rows<KT, D2, NTHREADS>(sK + i * KT * LDS2, LDS2, k + kv_off, D2, 0, KT, tid);
    bya::load_rows<KT, D2, NTHREADS>(sV + i * KT * LDS2, LDS2, v + kv_off, D2, 0, KT, tid);
  }

  const int row_end = min(Sq, (int)(blockIdx.x + 1) * ROWS_PER_BLOCK);
  for (int q0 = blockIdx.x * ROWS_PER_BLOCK; q0 < row_end; q0 += BM) {
    bya::load_rows<BM, D2, NTHREADS>(sQ, LDS2, qb, ld, q0, Sq, tid);
    bya::cp_async_commit();
    bya::cp_async_wait<0>();
    __syncthreads();

    uint32_t qf[KS][4];
    bya::load_a_frags<KS, LDS2>(qf, sQ + warp * 16 * LDS2, lane);
    const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;

    for (int i = 0; i < I; ++i) {
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      bya::qk_scores<NT, KS, LDS2>(s, qf, sK + i * KT * LDS2, lane);

      float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale_log2;
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - mx0);
        s[nt][1] = exp2f(s[nt][1] - mx0);
        s[nt][2] = exp2f(s[nt][2] - mx1);
        s[nt][3] = exp2f(s[nt][3] - mx1);
        sum0 += s[nt][0] + s[nt][1];
        sum1 += s[nt][2] + s[nt][3];
      }
      sum0 += __shfl_xor_sync(FULL, sum0, 1);
      sum0 += __shfl_xor_sync(FULL, sum0, 2);
      sum1 += __shfl_xor_sync(FULL, sum1, 1);
      sum1 += __shfl_xor_sync(FULL, sum1, 2);
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] *= inv0;
        s[nt][1] *= inv0;
        s[nt][2] *= inv1;
        s[nt][3] *= inv1;
      }

      float oi[ND][4];
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) oi[nd][0] = oi[nd][1] = oi[nd][2] = oi[nd][3] = 0.f;
      bya::pv_accumulate<NT, ND, LDS2>(oi, s, sV + i * KT * LDS2, lane);

      bf16* ob = o + ((long long)b * I + i) * Sq * ld + (long long)h * D2;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int col = nd * 8 + (lane & 3) * 2;
        if (r0 < Sq)
          *reinterpret_cast<uint32_t*>(ob + r0 * ld + col) = bya::pack_bf16(oi[nd][0], oi[nd][1]);
        if (r1 < Sq)
          *reinterpret_cast<uint32_t*>(ob + r1 * ld + col) = bya::pack_bf16(oi[nd][2], oi[nd][3]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// q: [B, Sq, H*128]; k, v: [B, I, H, 32, 128]; o: [B, I, Sq, H*128]; all bf16
// and contiguous; 1 <= I <= 4.  Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for a K or I it does not take.
extern "C" int bya_short_kv_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int I, int H, int K, float scale,
                                      void* stream) {
  if (K != KT || I < 1 || I > MAX_ID) return (int)cudaErrorInvalidValue;
  const int smem = (BM + 2 * I * KT) * LDS2 * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(short_kv_attend_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, H, B);
  short_kv_attend_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, I, H, scale * LOG2E);
  return (int)cudaGetLastError();
}

// q, o: [G, Sq, H*64]; k, v: [G, I, H, 32, 64]; w: [G, Sq, I]; all bf16 and
// contiguous; 1 <= I <= 4 (shared memory stays under the 48 KB static
// limit).  Returns the cudaError_t of the launch, or cudaErrorInvalidValue
// for a K or I it does not take.
extern "C" int bya_short_kv_attention_combined_flat(const void* q, const void* k,
                                                    const void* v, const void* w, void* o,
                                                    int G, int Sq, int I, int H, int K,
                                                    float scale, void* stream) {
  if (K != KT || I < 1 || I > MAX_ID) return (int)cudaErrorInvalidValue;
  const int smem = (BM + 2 * I * KT) * LDS * (int)sizeof(bf16);
  dim3 grid((Sq + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, H, G);
  short_kv_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(w), static_cast<bf16*>(o), Sq, I, H, scale);
  return (int)cudaGetLastError();
}
