// Long-query / short-KV cross-attention: kernels B2, B3, B14, B2c and B2h,
// one body templated on the head dim, the mode and the layout:
//
//   per identity:  o[g, i, ., h] = softmax_k(q . k_i^T * scale) . v_i
//   combined:      o[g, ., h]    = sum_i w[g, ., i] * softmax_k(q . k_i^T * scale) . v_i
//
// with one softmax per identity i over its K = 32 tokens.  q-major q is
// [G, Sq, H, D], the flat [G, Sq, H*D] projection layout; head-major q is
// [G, H, Sq, D].  k, v: [G, I, H, 32, D]; w: [G, Sq, I].
//
//   B3  (combined, q-major, D = 64) replaces the TPU kernel `_kernel_flat`
//       (bindyouravatar_tpu/ops/short_kv_attention.py), reached through
//       `short_kv_attention_combined_flat` from the audio cross-attention.
//   B2  (per identity, q-major, D = 128) replaces `_kernel` with
//       `combine=False`, reached through `short_kv_attention_flat` from the
//       perceiver face injection: q read in the to_q projection's flat
//       layout and each identity's output written [B, I, Sq, H*128], the
//       layout the routing combine reads, with no head-major transposes.
//   B14 (q-major, both modes, D = 64 or 128) replaces `_kernel_qmajor`
//       (`short_kv_attention_qmajor`, `short_kv_attention_combined_qmajor`).
//   B2c (combined, head-major) replaces `_kernel` with `combine=True`
//       (`short_kv_attention_combined`), and B2h (per identity, head-major)
//       runs `_kernel(combine=False)` in JAX's own layout
//       (`short_kv_attention`: [G, H, Sq, D] -> [G, I, H, Sq, D]).
// Each has its own kernel name (B2 and B3 keep theirs, B14/B2c/B2h are the
// instantiations of `skv_layout_kernel`), so device time groups by body.
//
// Same math and roundings as the TPU bodies: fp32 scores in log2 units
// (q.k * scale * log2 e), one fp32 exp2 softmax per identity normalised
// before p is rounded to bf16, fp32 P.V, the combine an fp32 weighted sum,
// one bf16 store.
//
// What bounds them on the H100: memory.  Per (query row, head) they read 2D
// bytes of q and write 2D (combined) or 2ID bytes (per identity) against
// 4IKD FLOP: at I = 2, K = 32, 64 FLOP/B combined and ~85 FLOP/B per
// identity, far below the ~295 FLOP/B ridge.  At the 5B path B2 moves
// ~144 MB of q and ~288 MB of output per call (~0.13 ms at 3.35 TB/s).
//
// Design: one block = 4 warps for one (g, head) and 256 query rows.  The
// block stages every identity's K and V for its head in shared memory once
// (I * 32 rows of D: 16 KB at I = 2, D = 64; 32 KB at D = 128) and streams
// 64-row query tiles past them.  A warp keeps its 16 rows' q fragments in
// registers and computes each identity's [16, 32] scores, softmax and
// [16, D] output in registers, then stores it (per identity) or adds it,
// weighted, to an fp32 accumulator (combined).  Query rows past Sq are
// zero-filled on load and never stored.  Shared memory is dynamic (~51 KB
// at I = 2, D = 128), so the launcher raises each kernel's limit.
#include "mma_utils.cuh"

namespace {

using bya::bf16;

constexpr int BM = 64;  // query rows per tile (16 per warp)
constexpr int ROWS_PER_BLOCK = 256;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KT = 32;  // tokens per identity
constexpr int MAX_ID = 4;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int D, bool COMBINE, bool QMAJOR>
__device__ __forceinline__ void skv_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, const bf16* __restrict__ w,
                                         bf16* __restrict__ o, int Sq, int I, int H,
                                         float scale_log2) {
  constexpr int LDS = D + 8, KS = D / 16, ND = D / 8, NT = KT / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * LDS;
  bf16* sV = sK + I * KT * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, g = blockIdx.z;
  // q (and the combined output): rows H * D apart (q-major) or D apart
  const long long ld = QMAJOR ? (long long)H * D : (long long)D;
  const bf16* qb =
      q + (QMAJOR ? ((long long)g * Sq * H + h) * D : ((long long)g * H + h) * Sq * D);

  for (int i = 0; i < I; ++i) {
    const long long kv_off = (((long long)g * I + i) * H + h) * KT * D;
    bya::load_rows<KT, D, NTHREADS>(sK + i * KT * LDS, LDS, k + kv_off, D, 0, KT, tid);
    bya::load_rows<KT, D, NTHREADS>(sV + i * KT * LDS, LDS, v + kv_off, D, 0, KT, tid);
  }

  const int row_end = min(Sq, (int)(blockIdx.x + 1) * ROWS_PER_BLOCK);
  for (int q0 = blockIdx.x * ROWS_PER_BLOCK; q0 < row_end; q0 += BM) {
    bya::load_rows<BM, D, NTHREADS>(sQ, LDS, qb, ld, q0, Sq, tid);
    bya::cp_async_commit();
    bya::cp_async_wait<0>();
    __syncthreads();

    uint32_t qf[KS][4];
    bya::load_a_frags<KS, LDS>(qf, sQ + warp * 16 * LDS, lane);
    const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;

    float acc[COMBINE ? ND : 1][4];  // the weighted sum (combined only)
    if constexpr (COMBINE) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
    }

    for (int i = 0; i < I; ++i) {
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      bya::qk_scores<NT, KS, LDS>(s, qf, sK + i * KT * LDS, lane);

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
      bya::pv_accumulate<NT, ND, LDS>(oi, s, sV + i * KT * LDS, lane);

      if constexpr (COMBINE) {
        const long long wrow = (long long)g * Sq;
        const float w0 = r0 < Sq ? __bfloat162float(w[(wrow + r0) * I + i]) : 0.f;
        const float w1 = r1 < Sq ? __bfloat162float(w[(wrow + r1) * I + i]) : 0.f;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[nd][0] += w0 * oi[nd][0];
          acc[nd][1] += w0 * oi[nd][1];
          acc[nd][2] += w1 * oi[nd][2];
          acc[nd][3] += w1 * oi[nd][3];
        }
      } else {
        // q-major [G, I, Sq, H, D], head-major [G, I, H, Sq, D]
        bf16* ob = o + (QMAJOR ? (((long long)g * I + i) * Sq * H + h) * D
                               : (((long long)g * I + i) * H + h) * Sq * D);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const int col = nd * 8 + (lane & 3) * 2;
          if (r0 < Sq)
            *reinterpret_cast<uint32_t*>(ob + r0 * ld + col) = bya::pack_bf16(oi[nd][0], oi[nd][1]);
          if (r1 < Sq)
            *reinterpret_cast<uint32_t*>(ob + r1 * ld + col) = bya::pack_bf16(oi[nd][2], oi[nd][3]);
        }
      }
    }

    if constexpr (COMBINE) {
      bf16* ob = o + (qb - q);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int col = nd * 8 + (lane & 3) * 2;
        if (r0 < Sq)
          *reinterpret_cast<uint32_t*>(ob + r0 * ld + col) = bya::pack_bf16(acc[nd][0], acc[nd][1]);
        if (r1 < Sq)
          *reinterpret_cast<uint32_t*>(ob + r1 * ld + col) = bya::pack_bf16(acc[nd][2], acc[nd][3]);
      }
    }
    __syncthreads();
  }
}

#define SKV_PARAMS                                                                     \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,  \
      const bf16 *__restrict__ w, bf16 *__restrict__ o, int Sq, int I, int H, float scale_log2
#define SKV_ARGS q, k, v, w, o, Sq, I, H, scale_log2

// B3
__global__ void __launch_bounds__(NTHREADS) short_kv_kernel(SKV_PARAMS) {
  skv_body<64, true, true>(SKV_ARGS);
}

// B2
__global__ void __launch_bounds__(NTHREADS) short_kv_attend_kernel(SKV_PARAMS) {
  skv_body<128, false, true>(SKV_ARGS);
}

// B14 (QMAJOR), B2c (COMBINE, head-major), B2h (head-major per identity)
template <int D, bool COMBINE, bool QMAJOR>
__global__ void __launch_bounds__(NTHREADS) skv_layout_kernel(SKV_PARAMS) {
  skv_body<D, COMBINE, QMAJOR>(SKV_ARGS);
}

template <typename K>
int launch(K kernel, int D, const void* q, const void* k, const void* v, const void* w, void* o,
           int G, int Sq, int I, int H, int K_tokens, float scale, void* stream) {
  if (K_tokens != KT || I < 1 || I > MAX_ID) return (int)cudaErrorInvalidValue;
  const int smem = (BM + 2 * I * KT) * (D + 8) * (int)sizeof(bf16);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, H, G);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(w), static_cast<bf16*>(o), Sq, I, H, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_layout(const void* q, const void* k, const void* v, const void* w, void* o, int G,
                  int Sq, int I, int H, int K, int qmajor, float scale, void* stream) {
  if (qmajor)
    return w != nullptr
               ? launch(skv_layout_kernel<D, true, true>, D, q, k, v, w, o, G, Sq, I, H, K, scale,
                        stream)
               : launch(skv_layout_kernel<D, false, true>, D, q, k, v, w, o, G, Sq, I, H, K,
                        scale, stream);
  return w != nullptr
             ? launch(skv_layout_kernel<D, true, false>, D, q, k, v, w, o, G, Sq, I, H, K, scale,
                      stream)
             : launch(skv_layout_kernel<D, false, false>, D, q, k, v, w, o, G, Sq, I, H, K, scale,
                      stream);
}

}  // namespace

// B2.  q: [B, Sq, H*128]; k, v: [B, I, H, 32, 128]; o: [B, I, Sq, H*128]; all
// bf16 and contiguous; 1 <= I <= 4.  Returns the cudaError_t of the launch,
// or cudaErrorInvalidValue for a K or I it does not take.
extern "C" int bya_short_kv_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int I, int H, int K, float scale,
                                      void* stream) {
  return launch(short_kv_attend_kernel, 128, q, k, v, nullptr, o, B, Sq, I, H, K, scale, stream);
}

// B3.  q, o: [G, Sq, H*64]; k, v: [G, I, H, 32, 64]; w: [G, Sq, I]; all bf16
// and contiguous; 1 <= I <= 4.
extern "C" int bya_short_kv_attention_combined_flat(const void* q, const void* k,
                                                    const void* v, const void* w, void* o,
                                                    int G, int Sq, int I, int H, int K,
                                                    float scale, void* stream) {
  return launch(short_kv_kernel, 64, q, k, v, w, o, G, Sq, I, H, K, scale, stream);
}

// B14, B2c, B2h.  q: [G, Sq, H, D] (qmajor = 1) or [G, H, Sq, D]; k, v:
// [G, I, H, 32, D]; w: [G, Sq, I] or null (per identity); o: q's layout
// (combined) or [G, I, Sq, H, D] / [G, I, H, Sq, D] (per identity); all bf16
// and contiguous; D = 64 or 128, 1 <= I <= 4.
extern "C" int bya_short_kv_layout(const void* q, const void* k, const void* v, const void* w,
                                   void* o, int G, int Sq, int I, int H, int K, int D,
                                   int qmajor, float scale, void* stream) {
  if (D == 64) return launch_layout<64>(q, k, v, w, o, G, Sq, I, H, K, qmajor, scale, stream);
  if (D == 128) return launch_layout<128>(q, k, v, w, o, G, Sq, I, H, K, qmajor, scale, stream);
  return (int)cudaErrorInvalidValue;
}
