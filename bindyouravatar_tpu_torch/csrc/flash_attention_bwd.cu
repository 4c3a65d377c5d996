// Flash attention backward for Hopper: one fused kernel computes dq, dk and
// dv of B7 (the flat [B, S, H*64] training attention) and of B12 + B13 (the
// [B, H, S, D] "bhsd" / [B, S, H, D] "bshd" layouts, D = 64 or 128).
//
// It replaces three TPU kernels of bindyouravatar_tpu/ops/flash_attention.py:
// `_bwd_flat_kernel` (B7's backward, the `_flash_flat` custom vjp) and the
// two-kernel backward of `_bwd_impl`, `_dkv_kernel` (B12) and `_dq_kernel`
// (B13).  Same math as those and as the plain versions
// (`flash_attention_flat_bwd_plain`, `_bwd_plain`): P from the saved LSE,
// exactly 0 on kv columns >= kv_len; P rounded to bf16 before dV = P^T dO;
// dS = P (dP - delta), times `scale` before its bf16 rounding (B12/B13) or
// not (B7, whose q arrives pre-scaled by scale * log2 e and whose dk / log2 e
// and dq * scale unfold it); the RoPE adjoint (cos, -sin) on dq and dk over
// the RoPE rows; kv tiles wholly past kv_len store dk = dv = 0.
//
// What bounds it on the H100: the five products per (kv tile, q tile),
// S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, dQ = dS K, that is
// 10 S^2 D FLOP per head (9.8 ms at B = 1, S = 17,776, 48 heads of 64 on
// 989 TFLOP/s bf16) against well under 1 GB of bf16 traffic.  The earlier
// two-kernel design recomputed S and dP for dq (14 S^2 D) on mma.sync; here
// every product is one `wgmma` stream and the scores are computed once.
//
// Design:
//  * Three launches: a pre-pass (one warp per row: the q/k RoPE and B7's
//    q scale into scratch, lse2 = LSE * log2 e with +big on the pad rows
//    >= S, delta = rowsum(o * dO) for B12/B13 or B7's given delta, and the
//    zeroing of the dq accumulator), the fused kernel, and a post-pass (one
//    warp per row: dq from its fp32 accumulator, times scale for B7, RoPE
//    adjoint, bf16 store in the layout).
//  * One CTA per 128-row kv tile of one (batch, head), 384 threads: warp
//    group 0 is the producer (one thread issues every TMA load; setmaxnreg
//    drops the group to 24 registers), warp groups 1 and 2 each own 64 kv
//    rows (setmaxnreg 240).  ptxas allots 168 registers a thread: at D = 64
//    the consumers' dK and dV accumulators (2 x 32 fp32), the S^T and dP^T
//    tiles (2 x 32) and the P^T and dS^T fragments held while their wgmma
//    runs (2 x 16) fit with a few bytes of spill; at D = 128 (2 x 64
//    accumulators) they spill about 1 KB.  128 kv rows at D = 128 all the
//    same: a 64-row tile would leave one consumer warp group per SM, and
//    the D = 128 path serves no shipped model.
//  * TMA and mbarriers: K and V of the tile are loaded once and stay in
//    shared memory; the q tiles (64 rows of Q and dO, and the rows' lse2 and
//    delta by 1-D bulk copies) stream through a ring of 3 stages at D = 64,
//    2 at D = 128 (shared memory: 133,688 and 182,312 bytes).  One 4-D tensor map
//    [B, H, S, D] with the layout's strides serves flat, bhsd and bshd;
//    rows past S are zero-filled by the TMA unit.  Tiles are 64-column
//    panels of 128-byte rows in the 128-byte swizzle that wgmma reads.
//  * wgmma m64n64k16 for every product.  S^T and dP^T read both operands
//    from shared memory (K-major).  The S^T accumulator's register layout
//    is the A-fragment layout, so P^T and dS^T feed dV and dK from
//    registers (RS, dO and Q read transposed).  The scores stay transposed,
//    as in the TPU's combined kernel, so each q column's lse2 and delta
//    broadcast down a register column.  dS^T also goes to shared memory as
//    bf16, and dQ = dS K reads the group's own rows of it and of K through
//    transposed descriptors, so the two consumers never wait on each other.
//    P = exp2(...) runs on the special-function unit (`ex2.approx`); the
//    library exp2f's accurate path cost a quarter of the kernel's time.
//  * dq by fp32 reduction: for each q tile each consumer computes its 64 kv
//    rows' dq contribution (one 64-column panel at a time), stages it in
//    shared memory and adds it to a [B*H, S_pad / 64, D / 64, 64, 64] fp32
//    workspace with one bulk reduce-add (`cp.reduce.async.bulk .add.f32`):
//    S/64 adds of 64 x D fp32 per row of the head, ~60 GB per 48-head call
//    at S = 17,776, through L2.  Summing over the whole 128-row tile first
//    halves that traffic but couples the consumers at every q tile, which
//    measured slower.  The order in which the contributions are summed
//    varies from run to run (dq is not bitwise reproducible); dk and dv
//    have one owning CTA each and are.  Within a 64-column row the
//    workspace's 16-byte chunks are XOR-swizzled by the row index, so the
//    staging writes hit distinct banks.
#include <cuda.h>

#include "flash_common.cuh"

namespace {

using bya::bf16;
using bya::Layout;
using bya::LOG2E;
using bya::make_layout;
using bya::smem_addr;

constexpr int BQ = 64;    // q rows per streamed tile
constexpr int BN = 128;   // kv rows per CTA: two consumer warp groups of 64
constexpr int NTHREADS = 384;
constexpr float PAD_LSE2 = 1e30f;  // lse2 of the pad rows >= S: P = 0 there

template <int D>
struct BwdSmem {
  static constexpr int NP = D / 64;               // 64-column panels
  static constexpr int NST = D == 64 ? 3 : 2;     // q-tile ring stages
  static constexpr int KV_TILE = BN * D * 2;      // bytes of K (or V)
  static constexpr int Q_TILE = BQ * D * 2;       // bytes of one Q (or dO) tile
  static constexpr int DS_TILE = BN * BQ * 2;     // dS^T, bf16
  static constexpr int STG = BQ * 64 * 4;         // one consumer's dq staging, fp32
  static constexpr int K_OFF = 0, V_OFF = KV_TILE, Q_OFF = 2 * KV_TILE;
  static constexpr int DO_OFF = Q_OFF + NST * Q_TILE, DS_OFF = DO_OFF + NST * Q_TILE;
  static constexpr int STG_OFF = DS_OFF + DS_TILE, ROW_OFF = STG_OFF + 2 * STG;
  static constexpr int BAR_OFF = ROW_OFF + NST * 2 * BQ * 4;
  static constexpr int BYTES = BAR_OFF + (2 * NST + 1) * 8 + 1024;  // + base alignment
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A wait
// that never ends (a lost arrival) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 22)) __trap();
  }
}

// TMA: the box at (c0, c1, c2, c3) (innermost first) of a 4-D tensor map.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy shared-memory writes -> visible to wgmma and bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptors, 128-byte swizzle, for tiles of 128-byte
// rows whose 8-row groups are 1024 bytes apart.  K-major (the operand's K
// runs along the row): SBO = 1024, LBO unused; the K step moves the start
// address 32 bytes within the swizzle atom.  MN-major (K runs down the
// rows; the operand is exactly one 64-element atom wide): the 8-row K
// groups are 1024 bytes apart, given as both SBO and LBO.
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], fp32 accumulators (the m16n8
// C-fragment layout per warp: d[4i..4i+1] row g, cols 8i + 2t..; d[4i+2..3]
// row g + 8), bf16 operands from shared memory.  TA / TB: the operand is
// MN-major (read transposed).  accumulate = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// The same with A from registers (the m16n8k16 A-fragment layout per warp).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// --------------------------------------------------------------- pre-pass

// Offset of row (bh, s) of the dq accumulator [B*H, NQ, D/64, 64, 64]:
// panel p's 64 floats of that row follow at + p * 4096.
__device__ __forceinline__ long long acc_row(long long bh, int s, int nq, int np) {
  return (((bh * nq + s / BQ) * np) * BQ + s % BQ) * 64;
}

// Index within a 64-float accumulator row r of column c: 16-byte chunks
// XOR-swizzled by r % 8.
__device__ __forceinline__ int acc_col(int r, int c) { return (((c >> 2) ^ (r & 7)) << 2) | (c & 3); }

// One warp per row (b, s, h), s < S_pad = NQ * 64: RoPE (and B7's q scale)
// of q and k into qo/ko when qo is given; lse2 and delta; the row of the
// dq accumulator zeroed.  FLAT: delta_in given [B, H, S]; else delta =
// rowsum(o * dO), fp32.
template <int D, bool FLAT>
__device__ __forceinline__ void pre_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         bf16* __restrict__ qo, bf16* __restrict__ ko,
                                         const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta_in,
                                         float* __restrict__ lse2, float* __restrict__ delta,
                                         float* __restrict__ dq_acc, const float* cos_t,
                                         const float* sin_t, int rope_start, int rope_rows, int B,
                                         int S, int H, int NQ, Layout L, float q_scale) {
  constexpr int E = D / 32, NP = D / 64;
  const int s_pad = NQ * BQ;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * s_pad * H) return;
  const int h = (int)(warp % H);
  const long long bs = warp / H;
  const int s = (int)(bs % s_pad), b = (int)(bs / s_pad);
  const long long bh = (long long)b * H + h;
  float dl = 0.f;
  if (s < S) {
    if (qo != nullptr)
      bya::prep_qk_row<D>(q, k, qo, ko, nullptr, nullptr, nullptr, nullptr, cos_t, sin_t,
                          rope_start, rope_rows, b, s, h, L, q_scale, 0.f, lane);
    if (FLAT) {
      dl = delta_in[bh * S + s];
    } else {
      const long long off = L.off(b, h) + s * L.ss + E * lane;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < E / 2; ++e) {
        const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(o + off)[e];
        const __nv_bfloat162 g = reinterpret_cast<const __nv_bfloat162*>(dout + off)[e];
        acc += __low2float(a) * __low2float(g) + __high2float(a) * __high2float(g);
      }
      dl = bya::warp_sum(acc);
    }
  }
  if (lane == 0) {
    lse2[bh * s_pad + s] = s < S ? lse[bh * S + s] * LOG2E : PAD_LSE2;
    delta[bh * s_pad + s] = dl;
  }
  float* row = dq_acc + acc_row(bh, s, NQ, NP);
#pragma unroll
  for (int p = 0; p < NP; ++p)
    reinterpret_cast<float2*>(row + p * BQ * 64)[lane] = make_float2(0.f, 0.f);
}

// -------------------------------------------------------------- post-pass

// One warp per row (b, s, h), s < S: dq = the accumulator row (times scale
// for B7), RoPE adjoint on the RoPE rows, bf16 into the layout.
template <int D, bool FLAT>
__device__ __forceinline__ void post_body(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                                          const float* cos_t, const float* sin_t, int rope_start,
                                          int rope_rows, int B, int S, int H, int NQ, Layout L,
                                          float scale) {
  constexpr int E = D / 32, NP = D / 64;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * S * H) return;
  const int h = (int)(warp % H);
  const long long bs = warp / H;
  const int s = (int)(bs % S), b = (int)(bs / S);
  const int c0 = E * lane, r = s % BQ;
  const float* row = dq_acc + acc_row((long long)b * H + h, s, NQ, NP) + (c0 / 64) * BQ * 64;
  const int i = acc_col(r, c0 % 64);
  float v[E];
  if constexpr (E == 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + i);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(row + i);
    v[0] = x.x, v[1] = x.y;
  }
  float c[E], sn[E];
  const bool rot = bya::rope_factors<E>(c, sn, cos_t, sin_t, s, rope_start, rope_rows, lane);
  const float sign = lane < 16 ? 1.0f : -1.0f;  // the adjoint: sin negated
  float p[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (FLAT) v[e] *= scale;
    p[e] = __shfl_xor_sync(bya::FULL, v[e], 16);
  }
  if (rot) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = v[e] * c[e] + sign * p[e] * sn[e];
  }
  bf16* out = dq + L.off(b, h) + s * L.ss + c0;
#pragma unroll
  for (int e = 0; e < E / 2; ++e)
    reinterpret_cast<__nv_bfloat162*>(out)[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
}

// 2^x on the special-function unit (about 2 ulp; P is rounded to bf16)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -------------------------------------------------------- the fused kernel

#define BWD_PARAMS                                                                            \
  const CUtensorMap *tq, const CUtensorMap *tk, const CUtensorMap *tv, const CUtensorMap *tdo, \
      const float *__restrict__ lse2, const float *__restrict__ delta,                       \
      float *__restrict__ dq_acc, bf16 *__restrict__ dk_out, bf16 *__restrict__ dv_out,      \
      const float *cos_t, const float *sin_t, int rope_start, int rope_rows, Layout L, int S,  \
      int H, int NQ, int kv_len, float scale
#define BWD_ARGS                                                                            \
  &tq, &tk, &tv, &tdo, lse2, delta, dq_acc, dk_out, dv_out, cos_t, sin_t, rope_start, rope_rows, \
      L, S, H, NQ, kv_len, scale

// dK, dV of one 128-row kv tile of one (batch, head) and its dq
// contributions.  q, k are the prepared rows (B7: RoPE and the q scale;
// B12/B13: RoPE, or q and k themselves).  FLAT (B7): P = exp2(q_s k^T -
// lse2), dS = P (dP - delta); else P = exp2(q k^T * scale * log2 e -
// lse2), dS = P (dP - delta) * scale.
template <int D, bool FLAT>
__device__ __forceinline__ void bwd_body(unsigned char* smem_raw, BWD_PARAMS) {
  using SM = BwdSmem<D>;
  constexpr int NP = SM::NP, NST = SM::NST;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(smem + SM::K_OFF);    // [NP][BN][64], swizzled
  bf16* sV = reinterpret_cast<bf16*>(smem + SM::V_OFF);
  bf16* sQ = reinterpret_cast<bf16*>(smem + SM::Q_OFF);    // [NST][NP][BQ][64]
  bf16* sDO = reinterpret_cast<bf16*>(smem + SM::DO_OFF);
  bf16* sDS = reinterpret_cast<bf16*>(smem + SM::DS_OFF);  // [BN][BQ]: dS^T
  float* sStg = reinterpret_cast<float*>(smem + SM::STG_OFF);  // [2 groups][BQ][64]
  float* sRow = reinterpret_cast<float*>(smem + SM::ROW_OFF);  // [NST][lse2, delta][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* kv_full = empty + NST;

  const int h = blockIdx.y, b = blockIdx.z, kv0 = blockIdx.x * BN;
  const long long bh = (long long)b * H + h;
  const int n_q = kv0 < kv_len ? NQ : 0;  // tiles wholly past kv_len: dK = dV = 0
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warp group: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && n_q > 0) {
      mbar_expect_tx(kv_full, 2 * SM::KV_TILE);
      for (int p = 0; p < NP; ++p) {
        tma_load_4d(sK + p * BN * 64, tk, 64 * p, kv0, h, b, kv_full);
        tma_load_4d(sV + p * BN * 64, tv, 64 * p, kv0, h, b, kv_full);
      }
      const float* l2 = lse2 + bh * NQ * BQ;
      const float* dl = delta + bh * NQ * BQ;
      for (int j = 0; j < n_q; ++j) {
        const int st = j % NST, f = j / NST;
        if (f > 0) mbar_wait(&empty[st], (f - 1) & 1);
        mbar_expect_tx(&full[st], 2 * SM::Q_TILE + 2 * BQ * 4);
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(sQ + (st * NP + p) * BQ * 64, tq, 64 * p, j * BQ, h, b, &full[st]);
          tma_load_4d(sDO + (st * NP + p) * BQ * 64, tdo, 64 * p, j * BQ, h, b, &full[st]);
        }
        bulk_load(sRow + st * 2 * BQ, l2 + j * BQ, BQ * 4, &full[st]);
        bulk_load(sRow + st * 2 * BQ + BQ, dl + j * BQ, BQ * 4, &full[st]);
      }
    }
  } else {  // consumer warp groups 1 and 2: kv rows 64 w .. 64 w + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = tid / 128 - 1, tw = tid % 128, lane = tid & 31;
    const int r_loc = (tw >> 5) * 16 + (lane >> 2);  // this lane's rows r_loc, r_loc + 8
    const int kv_row = kv0 + 64 * w + r_loc;
    const bool ok[2] = {kv_row < kv_len, kv_row + 8 < kv_len};
    const float scale_log2 = scale * LOG2E;
    const bf16* kw = sK + w * 64 * 64;
    const bf16* vw = sV + w * 64 * 64;
    float dk[D / 8][4], dv[D / 8][4], sT[8][4], dpT[8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[i][e] = dpT[i][e] = 0.f;
    if (n_q > 0) mbar_wait(kv_full, 0);

    for (int j = 0; j < n_q; ++j) {
      const int st = j % NST;
      mbar_wait(&full[st], (j / NST) & 1);
      const bf16* qt = sQ + st * NP * BQ * 64;
      const bf16* gt = sDO + st * NP * BQ * 64;
      const float* lt = sRow + st * 2 * BQ;
      const float* dt = lt + BQ;

      // S^T = K Q^T and dP^T = V dO^T, both operands K-major in shared memory
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(&sT[0][0], desc_kmajor(kw + (kk / 4) * BN * 64 + (kk % 4) * 16),
                       desc_kmajor(qt + (kk / 4) * BQ * 64 + (kk % 4) * 16), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(&dpT[0][0], desc_kmajor(vw + (kk / 4) * BN * 64 + (kk % 4) * 16),
                       desc_kmajor(gt + (kk / 4) * BQ * 64 + (kk % 4) * 16), kk > 0);
      wg_commit();
      wg_wait<1>();
      fence_regs<32>(&sT[0][0]);

      // P^T from the saved LSE; masked kv rows exactly 0.  dV += P^T dO.
      uint32_t pa[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i * 8 + (lane & 3) * 2 + (e & 1);
          const float x = FLAT ? sT[i][e] : sT[i][e] * scale_log2;
          sT[i][e] = ok[e >> 1] ? fast_exp2(x - lt[c]) : 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = bya::pack_bf16(sT[2 * kk][0], sT[2 * kk][1]);
        pa[kk][1] = bya::pack_bf16(sT[2 * kk][2], sT[2 * kk][3]);
        pa[kk][2] = bya::pack_bf16(sT[2 * kk + 1][0], sT[2 * kk + 1][1]);
        pa[kk][3] = bya::pack_bf16(sT[2 * kk + 1][2], sT[2 * kk + 1][3]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs<1>(&dv[p * 8][0], pa[kk], desc_mnmajor(gt + p * BQ * 64 + kk * 16 * 64));
      wg_commit();
      wg_wait<1>();
      fence_regs<32>(&dpT[0][0]);

      // dS^T = P^T (dP^T - delta) (* scale), to registers (dK += dS^T Q)
      // and, swizzled, to shared memory for dQ
      uint32_t da[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i * 8 + (lane & 3) * 2 + (e & 1);
          const float x = sT[i][e] * (dpT[i][e] - dt[c]);
          dpT[i][e] = FLAT ? x : x * scale;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        da[kk][0] = bya::pack_bf16(dpT[2 * kk][0], dpT[2 * kk][1]);
        da[kk][1] = bya::pack_bf16(dpT[2 * kk][2], dpT[2 * kk][3]);
        da[kk][2] = bya::pack_bf16(dpT[2 * kk + 1][0], dpT[2 * kk + 1][1]);
        da[kk][3] = bya::pack_bf16(dpT[2 * kk + 1][2], dpT[2 * kk + 1][3]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 64 * w + r_loc + 8 * hf;
          *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(sDS) + r * 128 +
                                       ((i ^ (r & 7)) << 4) + (lane & 3) * 4) =
              hf ? da[i / 2][(i & 1) * 2 + 1] : da[i / 2][(i & 1) * 2];
        }
      fence_async_shared();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs<1>(&dk[p * 8][0], da[kk], desc_mnmajor(qt + p * BQ * 64 + kk * 16 * 64));
      wg_commit();

      // this group's share of dQ = dS K (its 64 kv rows), one 64-column
      // panel at a time, added to the fp32 workspace
      named_sync(2 + w, 128);  // this group's rows of dS^T written
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float dq[8][4];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(&dq[0][0], desc_mnmajor(sDS + (64 * w + kk * 16) * 64),
                         desc_mnmajor(sK + p * BN * 64 + (64 * w + kk * 16) * 64), kk > 0);
        wg_commit();
        wg_wait<0>();
        fence_regs<32>(&dq[0][0]);
        float* stg = sStg + w * BQ * 64;
        if (tw == 0) bulk_wait_read();  // the previous reduce has read the staging
        named_sync(2 + w, 128);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r_loc + 8 * hf, c = i * 8 + (lane & 3) * 2;
            *reinterpret_cast<float2*>(stg + r * 64 + acc_col(r, c)) =
                make_float2(dq[i][2 * hf], dq[i][2 * hf + 1]);
          }
        fence_async_shared();
        named_sync(2 + w, 128);
        if (tw == 0)
          bulk_reduce_add(dq_acc + acc_row(bh, j * BQ, NQ, NP) + p * BQ * 64, stg, SM::STG);
      }
      wg_wait<0>();
      fence_regs<D / 2>(&dk[0][0]);
      fence_regs<D / 2>(&dv[0][0]);
      mbar_arrive(&empty[st]);
    }
    if (tw == 0) bulk_wait_all();

    if (FLAT) {  // unwind the q-scale fold: dk = dS^T (q * scale * log2 e) / log2 e
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[i][e] *= 1.0f / LOG2E;
    }
    bya::rope_adjoint<D>(dk, kv_row, lane, cos_t, sin_t, rope_start, rope_rows);
    bya::store_tile<D>(dk_out + L.off(b, h), L.ss, dk, kv_row, S, lane);
    bya::store_tile<D>(dv_out + L.off(b, h), L.ss, dv, kv_row, S, lane);
  }
}

#define PRE_PARAMS                                                                           \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, bf16 *__restrict__ qo,             \
      bf16 *__restrict__ ko, const bf16 *__restrict__ o, const bf16 *__restrict__ dout,       \
      const float *__restrict__ lse, const float *__restrict__ delta_in,                     \
      float *__restrict__ lse2, float *__restrict__ delta, float *__restrict__ dq_acc,       \
      const float *cos_t, const float *sin_t, int rope_start, int rope_rows, int B, int S,   \
      int H, int NQ, Layout L, float q_scale
#define PRE_ARGS                                                                        \
  q, k, qo, ko, o, dout, lse, delta_in, lse2, delta, dq_acc, cos_t, sin_t, rope_start, \
      rope_rows, B, S, H, NQ, L, q_scale
#define POST_PARAMS                                                                          \
  const float *__restrict__ dq_acc, bf16 *__restrict__ dq, const float *cos_t,                \
      const float *sin_t, int rope_start, int rope_rows, int B, int S, int H, int NQ, Layout L, \
      float scale
#define POST_ARGS dq_acc, dq, cos_t, sin_t, rope_start, rope_rows, B, S, H, NQ, L, scale
#define MAIN_PARAMS                                                                          \
  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,           \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,      \
      const float *__restrict__ lse2, const float *__restrict__ delta,                      \
      float *__restrict__ dq_acc, bf16 *__restrict__ dk_out, bf16 *__restrict__ dv_out,     \
      const float *cos_t, const float *sin_t, int rope_start, int rope_rows, Layout L, int S, \
      int H, int NQ, int kv_len, float scale

// B7's backward: flat [B, S, H*64], q scale folded into the prepared q
__global__ void __launch_bounds__(256) flash_bwd_pre_kernel(PRE_PARAMS) {
  pre_body<64, true>(PRE_ARGS);
}
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_kernel(MAIN_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  bwd_body<64, true>(smem_raw, BWD_ARGS);
}
__global__ void __launch_bounds__(256) flash_bwd_post_kernel(POST_PARAMS) {
  post_body<64, true>(POST_ARGS);
}

// B12 + B13: bhsd / bshd, D = 64 or 128, scale on the scores
template <int D>
__global__ void __launch_bounds__(256) mha_bwd_pre_kernel(PRE_PARAMS) {
  pre_body<D, false>(PRE_ARGS);
}
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) mha_bwd_kernel(MAIN_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  bwd_body<D, false>(smem_raw, BWD_ARGS);
}
template <int D>
__global__ void __launch_bounds__(256) mha_bwd_post_kernel(POST_PARAMS) {
  post_body<D, false>(POST_ARGS);
}

// ---------------------------------------------------------------- host

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// The driver's tensor-map encoder, reached through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A [B, H, S, D] bf16 tensor map over `ptr` with the strides of L: boxes of
// 64 columns x `rows` rows in the 128-byte swizzle; rows past S read as 0.
bool make_map(CUtensorMap* map, const void* ptr, Layout L, int B, int H, int S, int D,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)L.ss * 2, (cuuint64_t)L.sh * 2,
                                 (cuuint64_t)L.sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool FLAT, typename PreK, typename MainK, typename PostK>
int run_bwd(PreK pre, MainK fused, PostK post, const void* q, const void* k, const void* v,
            const void* o, const void* dout, const float* lse, const float* delta_in, void* dq,
            void* dk, void* dv, void* q_prep, void* k_prep, float* dq_acc, float* lse2,
            float* delta, const float* cos_t, const float* sin_t, int rope_start, int rope_rows,
            int B, int S, int H, int bshd, int kv_len, float scale, cudaStream_t st) {
  const Layout L = make_layout(S, H, D, bshd);
  const int NQ = (S + BQ - 1) / BQ;
  const int block = 256;
  const long long pre_threads = (long long)B * NQ * BQ * H * 32;
  pre<<<(unsigned)((pre_threads + block - 1) / block), block, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(q_prep),
      static_cast<bf16*>(k_prep), static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      delta_in, lse2, delta, dq_acc, cos_t, sin_t, rope_start, rope_rows, B, S, H, NQ, L,
      FLAT ? scale * LOG2E : 1.0f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const void* qa = q_prep != nullptr ? q_prep : q;
  const void* ka = k_prep != nullptr ? k_prep : k;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, qa, L, B, H, S, D, BQ) || !make_map(&tk, ka, L, B, H, S, D, BN) ||
      !make_map(&tv, v, L, B, H, S, D, BN) || !make_map(&tdo, dout, L, B, H, S, D, BQ))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = BwdSmem<D>::BYTES;
  err = cudaFuncSetAttribute(fused, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BN - 1) / BN, H, B);
  fused<<<grid, NTHREADS, smem, st>>>(tq, tk, tv, tdo, lse2, delta, dq_acc,
                                      static_cast<bf16*>(dk), static_cast<bf16*>(dv), cos_t,
                                      sin_t, rope_start, rope_rows, L, S, H, NQ, kv_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long post_threads = (long long)B * S * H * 32;
  post<<<(unsigned)((post_threads + block - 1) / block), block, 0, st>>>(
      dq_acc, static_cast<bf16*>(dq), cos_t, sin_t, rope_start, rope_rows, B, S, H, NQ, L, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The fused flash backward: dq, dk, dv (bf16, in the layout of q) from q,
// k, v, dO and the forward's LSE (natural log, fp32 [B, H, S]).
//  flat = 1 (B7): [B, S, H*64] contiguous (D = 64, bshd = 1); delta_in =
//    rowsum(o * dO), fp32 [B, H, S]; o unused; q_prep/k_prep required.
//  flat = 0 (B12 + B13): [B, H, S, D] (bshd = 0) or [B, S, H, D] (bshd =
//    1), D = 64 or 128; o given, delta_in unused; q_prep/k_prep scratch of
//    q's shape when there is RoPE, else null.
// Workspaces (the caller's, uninitialised): dq_acc [B*H*S_pad*D] fp32,
// lse2 and delta [B*H*S_pad] fp32, S_pad = S rounded up to 64.  cos_t/sin_t:
// [rope_rows, D] fp32 or null.  Returns the cudaError_t of the launches.
extern "C" int bya_flash_bwd(int flat, const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             const float* delta_in, void* dq, void* dk, void* dv, void* q_prep,
                             void* k_prep, float* dq_acc, float* lse2, float* delta,
                             const float* cos_t, const float* sin_t, int rope_start,
                             int rope_rows, int B, int S, int H, int D, int bshd, int kv_len,
                             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flat) {
    if (D != 64 || !bshd || q_prep == nullptr || k_prep == nullptr)
      return (int)cudaErrorInvalidValue;
    return run_bwd<64, true>(flash_bwd_pre_kernel, flash_bwd_kernel, flash_bwd_post_kernel, q, k,
                             v, o, dout, lse, delta_in, dq, dk, dv, q_prep, k_prep, dq_acc, lse2,
                             delta, cos_t, sin_t, rope_start, rope_rows, B, S, H, bshd, kv_len,
                             scale, st);
  }
  if (D == 64)
    return run_bwd<64, false>(mha_bwd_pre_kernel<64>, mha_bwd_kernel<64>, mha_bwd_post_kernel<64>,
                              q, k, v, o, dout, lse, delta_in, dq, dk, dv, q_prep, k_prep, dq_acc,
                              lse2, delta, cos_t, sin_t, rope_start, rope_rows, B, S, H, bshd,
                              kv_len, scale, st);
  if (D == 128)
    return run_bwd<128, false>(mha_bwd_pre_kernel<128>, mha_bwd_kernel<128>,
                               mha_bwd_post_kernel<128>, q, k, v, o, dout, lse, delta_in, dq, dk,
                               dv, q_prep, k_prep, dq_acc, lse2, delta, cos_t, sin_t, rope_start,
                               rope_rows, B, S, H, bshd, kv_len, scale, st);
  return (int)cudaErrorInvalidValue;
}
