// Flash attention backward for Hopper: one fused kernel computes dq, dk and
// dv of B7 (the flat [B, S, H*D] training attention) and of B12 + B13 (the
// [B, H, S, D] "bhsd" / [B, S, H, D] "bshd" layouts), at every head dim D
// with D % 8 == 0 and 8 <= D <= 256, on the forward's three bodies: a head
// runs on the narrowest of 64, 128 and 256 columns that holds it.  The
// tensor maps' innermost extent is the true D, so the TMA boxes read the
// columns past D as zeros (never the next head's columns in bshd or flat):
// dk, dv and dq there are 0, the dq accumulator keeps the body's columns a
// row and the stores keep the first D.
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
// every product is one `wgmma` stream and the scores are computed once
// (twice at DC = 256, below).
//
// Design:
//  * Three launches: a pre-pass (one warp per row: the q/k RoPE and B7's
//    q scale into scratch, lse2 = LSE * log2 e with +big on the pad rows
//    >= S, delta = rowsum(o * dO) over D for B12/B13 or B7's given delta,
//    and the zeroing of the dq accumulator), the fused kernel, and a
//    post-pass (one warp per row: dq from its fp32 accumulator, times scale
//    for B7, RoPE adjoint, bf16 store in the layout).
//  * One CTA per 128-row kv tile of one (batch, head), 384 threads: warp
//    group 0 is the producer (one thread issues every TMA load; setmaxnreg
//    drops the group to 24 registers), warp groups 1 and 2 each own 64 kv
//    rows (setmaxnreg 240).  ptxas allots 168 registers a thread: at D = 64
//    the consumers' dK and dV accumulators (2 x 32 fp32), the S^T and dP^T
//    tiles (2 x 32) and the P^T and dS^T fragments held while their wgmma
//    runs (2 x 16) fit with a few bytes of spill; at DC = 128 (2 x 64
//    accumulators) they spill about 1 KB.  128 kv rows at DC = 128 all the
//    same: a 64-row tile would leave one consumer warp group per SM.
//  * DC = 256: dK and dV of 256 fp32 columns a row (2 x 128 registers)
//    fit no register file, so two CTAs share a kv tile, each owning 128 of
//    the columns of dK, dV and dQ (grid y = 2 H) and each computing S^T and
//    dP^T whole (256 deep): those two products run twice, 1.4 times the
//    FLOP of one pass.  K, V, Q and dO stay 256 wide in shared memory, so
//    the kv tile is 64 rows with one consumer warp group (256 threads, no
//    setmaxnreg: ptxas may give each thread up to 255 registers): K 32 KB +
//    V 32 KB + two q-tile stages of Q and dO 128 KB + dS^T, staging and rows
//    25 KB, 223,272 bytes.
//  * TMA and mbarriers: K and V of the tile are loaded once and stay in
//    shared memory; the q tiles (64 rows of Q and dO, and the rows' lse2 and
//    delta by 1-D bulk copies) stream through a ring of 3 stages at DC = 64,
//    2 at DC = 128 and 256 (shared memory: 133,688, 182,312 and 223,272
//    bytes).  One 4-D tensor map [B, H, S, D] with the layout's strides
//    serves flat, bhsd and bshd; rows past S are zero-filled by the TMA
//    unit.  Tiles are 64-column panels of 128-byte rows in the 128-byte
//    swizzle that wgmma reads.
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
//    shared memory and adds it to a [B*H, S_pad / 64, DC / 64, 64, 64] fp32
//    workspace with one bulk reduce-add (`cp.reduce.async.bulk .add.f32`):
//    S/64 adds of 64 x D fp32 per row of the head, ~60 GB per 48-head call
//    at S = 17,776, through L2.  Summing over the whole 128-row tile first
//    halves that traffic but couples the consumers at every q tile, which
//    measured slower.  The order in which the contributions are summed
//    varies from run to run (dq is not bitwise reproducible); dk and dv
//    have one owning CTA each and are.  Within a 64-column row the
//    workspace's 16-byte chunks are XOR-swizzled by the row index, so the
//    staging writes hit distinct banks.
//  * dK's RoPE adjoint pairs column c with c + D/2.  At D = 32, 64 and 128
//    that is fragment nd with nd + D/16 of the same lane, done in registers
//    before the store (D a template argument).  At any other D (and at DC =
//    256, where the pair lies in the other CTA's half) the kernel stores dK
//    unrotated in fp32 to a workspace of dk's shape, and the post-pass
//    rotates it with dq; without RoPE dK is stored as bf16 directly.
#include "hopper.cuh"

namespace {

using namespace bya;

constexpr int BQ = 64;    // q rows per streamed tile
constexpr float PAD_LSE2 = 1e30f;  // lse2 of the pad rows >= S: P = 0 there

template <int DC>
struct BwdSmem {
  static constexpr int NC = DC == 256 ? 1 : 2;      // consumer warp groups
  static constexpr int BN = 64 * NC;                // kv rows per CTA
  static constexpr int NTHREADS = 128 * (NC + 1);
  static constexpr int HALVES = DC == 256 ? 2 : 1;  // CTAs sharing a kv tile
  static constexpr int DV = DC / HALVES;            // dK / dV / dQ columns of one CTA
  static constexpr int NP = DC / 64;                // 64-column panels
  static constexpr int NST = DC == 64 ? 3 : 2;      // q-tile ring stages
  static constexpr int KV_TILE = BN * DC * 2;       // bytes of K (or V)
  static constexpr int Q_TILE = BQ * DC * 2;        // bytes of one Q (or dO) tile
  static constexpr int DS_TILE = BN * BQ * 2;       // dS^T, bf16
  static constexpr int STG = BQ * 64 * 4;           // one consumer's dq staging, fp32
  static constexpr int K_OFF = 0, V_OFF = KV_TILE, Q_OFF = 2 * KV_TILE;
  static constexpr int DO_OFF = Q_OFF + NST * Q_TILE, DS_OFF = DO_OFF + NST * Q_TILE;
  static constexpr int STG_OFF = DS_OFF + DS_TILE, ROW_OFF = STG_OFF + NC * STG;
  static constexpr int BAR_OFF = ROW_OFF + NST * 2 * BQ * 4;
  static constexpr int BYTES = BAR_OFF + (2 * NST + 1) * 8 + 1024;  // + base alignment
};

// --------------------------------------------------------------- pre-pass

// Offset of row (bh, s) of the dq accumulator [B*H, NQ, NP, 64, 64]:
// panel p's 64 floats of that row follow at + p * 4096.
__device__ __forceinline__ long long acc_row(long long bh, int s, int nq, int np) {
  return (((bh * nq + s / BQ) * np) * BQ + s % BQ) * 64;
}

// Index within a 64-float accumulator row r of column c: 16-byte chunks
// XOR-swizzled by r % 8.
__device__ __forceinline__ int acc_col(int r, int c) { return (((c >> 2) ^ (r & 7)) << 2) | (c & 3); }

// One warp per row (b, s, h), s < S_pad = NQ * 64: RoPE (and B7's q scale)
// of q and k into qo/ko when qo is given; lse2 and delta; the row of the
// dq accumulator (DC columns) zeroed.  FLAT: delta_in given [B, H, S]; else
// delta = rowsum(o * dO), fp32.  D = 32, 64 or 128, or 0: any width Dr.
template <int D, int DC, bool FLAT>
__device__ __forceinline__ void pre_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         bf16* __restrict__ qo, bf16* __restrict__ ko,
                                         const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta_in,
                                         float* __restrict__ lse2, float* __restrict__ delta,
                                         float* __restrict__ dq_acc, const float* cos_t,
                                         const float* sin_t, int rope_start, int rope_rows, int B,
                                         int S, int H, int NQ, Layout L, float q_scale, int Dr) {
  constexpr int NP = DC / 64;
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
    if (qo != nullptr) {
      if constexpr (D == 0)
        bya::prep_qk_row_any(q, k, qo, ko, nullptr, nullptr, nullptr, nullptr, cos_t, sin_t,
                             rope_start, rope_rows, b, s, h, L, q_scale, 0.f, lane, Dr);
      else
        bya::prep_qk_row<D>(q, k, qo, ko, nullptr, nullptr, nullptr, nullptr, cos_t, sin_t,
                            rope_start, rope_rows, b, s, h, L, q_scale, 0.f, lane);
    }
    if (FLAT) {
      dl = delta_in[bh * S + s];
    } else {
      const long long off = L.off(b, h) + s * L.ss;
      float acc = 0.f;
      if constexpr (D == 0 || D == 32) {  // D = 32: one element a lane
        for (int c = lane; c < (D == 0 ? Dr : D); c += 32)
          acc += __bfloat162float(o[off + c]) * __bfloat162float(dout[off + c]);
      } else {
        constexpr int E = D / 32;
#pragma unroll
        for (int e = 0; e < E / 2; ++e) {
          const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(o + off + E * lane)[e];
          const __nv_bfloat162 g =
              reinterpret_cast<const __nv_bfloat162*>(dout + off + E * lane)[e];
          acc += __low2float(a) * __low2float(g) + __high2float(a) * __high2float(g);
        }
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

// One warp per row (b, s, h), s < S: dq = the accumulator row's first D
// columns (times scale for B7), RoPE adjoint on the RoPE rows, bf16 into
// the layout.  D = 0 (any width Dr): a lane takes every 32nd column and
// reads the partner column from the row; with dk_acc (the fused kernel's
// unrotated fp32 dK, in dk's layout) it also rotates and stores dK.
template <int D, int DC, bool FLAT>
__device__ __forceinline__ void post_body(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                                          const float* __restrict__ dk_acc,
                                          bf16* __restrict__ dk, const float* cos_t,
                                          const float* sin_t, int rope_start, int rope_rows, int B,
                                          int S, int H, int NQ, Layout L, float scale, int Dr) {
  constexpr int NP = DC / 64;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * S * H) return;
  const int h = (int)(warp % H);
  const long long bs = warp / H;
  const int s = (int)(bs % S), b = (int)(bs / S);
  const int r = s % BQ;
  const float* row = dq_acc + acc_row((long long)b * H + h, s, NQ, NP);
  const long long out = L.off(b, h) + s * L.ss;
  if constexpr (D == 0) {
    const bool rot = cos_t != nullptr && s >= rope_start && s < rope_start + rope_rows;
    const float* cr = rot ? cos_t + (long long)(s - rope_start) * Dr : nullptr;
    const float* sr = rot ? sin_t + (long long)(s - rope_start) * Dr : nullptr;
    const float qs = FLAT ? scale : 1.0f;
    auto acc = [&](int c) { return row[(c / 64) * BQ * 64 + acc_col(r, c % 64)] * qs; };
    // the adjoint: sin negated, so + partner * sin below D/2 and - above
    for (int c = lane; c < Dr; c += 32) {
      float v = acc(c);
      if (rot) {
        const float p = acc(rope_partner(c, Dr));
        v = v * cr[c] + (c < Dr / 2 ? p : -p) * sr[c];
      }
      dq[out + c] = __float2bfloat16(v);
    }
    if (dk_acc != nullptr) {
      const float* g = dk_acc + out;
      for (int c = lane; c < Dr; c += 32) {
        float v = g[c];
        if (rot) {
          const float p = g[rope_partner(c, Dr)];
          v = v * cr[c] + (c < Dr / 2 ? p : -p) * sr[c];
        }
        dk[out + c] = __float2bfloat16(v);
      }
    }
  } else {
    constexpr int E = D / 32;
    const int c0 = E * lane;
    const float* rp = row + (c0 / 64) * BQ * 64;
    const int i = acc_col(r, c0 % 64);
    float v[E];
    if constexpr (E == 4) {
      const float4 x = *reinterpret_cast<const float4*>(rp + i);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else if constexpr (E == 2) {
      const float2 x = *reinterpret_cast<const float2*>(rp + i);
      v[0] = x.x, v[1] = x.y;
    } else {
      v[0] = rp[i];
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
    bya::store_row<E>(dq + out + c0, v);
  }
}


// -------------------------------------------------------- the fused kernel

#define BWD_PARAMS                                                                            \
  const CUtensorMap *tq, const CUtensorMap *tk, const CUtensorMap *tv, const CUtensorMap *tdo, \
      const float *__restrict__ lse2, const float *__restrict__ delta,                       \
      float *__restrict__ dq_acc, bf16 *__restrict__ dk_out, bf16 *__restrict__ dv_out,      \
      float *__restrict__ dk_acc, const float *cos_t, const float *sin_t, int rope_start,    \
      int rope_rows, Layout L, int S, int H, int NQ, int kv_len, float scale, int Dr
#define BWD_ARGS                                                                            \
  &tq, &tk, &tv, &tdo, lse2, delta, dq_acc, dk_out, dv_out, dk_acc, cos_t, sin_t, rope_start, \
      rope_rows, L, S, H, NQ, kv_len, scale, Dr

// dK, dV of one kv tile of one (batch, head) and its dq contributions, on
// the DC-column body (this CTA's DV columns of them: all unless DC = 256,
// where blockIdx.y = 2 h + half).  q, k are the prepared rows (B7: RoPE and
// the q scale; B12/B13: RoPE, or q and k themselves).  FLAT (B7): P =
// exp2(q_s k^T - lse2), dS = P (dP - delta); else P = exp2(q k^T * scale *
// log2 e - lse2), dS = P (dP - delta) * scale.  Heads of D < DC columns read
// as zeros past D (the TMA boxes fill them), so the products are exact and
// the stores keep the first D.  D = 32, 64 or 128: dK's RoPE adjoint in
// registers; D = 0 (any width Dr): dK to dk_acc (fp32, unrotated) when
// given, the post-pass rotates it.
template <int D, int DC, bool FLAT>
__device__ __forceinline__ void bwd_body(unsigned char* smem_raw, BWD_PARAMS) {
  using SM = BwdSmem<DC>;
  constexpr int NP = SM::NP, NST = SM::NST, NC = SM::NC, BN = SM::BN, DV = SM::DV;
  constexpr int NPV = DV / 64;
  static_assert(D == 0 || (D <= DC && SM::HALVES == 1), "a templated head dim has one body");
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(smem + SM::K_OFF);    // [NP][BN][64], swizzled
  bf16* sV = reinterpret_cast<bf16*>(smem + SM::V_OFF);
  bf16* sQ = reinterpret_cast<bf16*>(smem + SM::Q_OFF);    // [NST][NP][BQ][64]
  bf16* sDO = reinterpret_cast<bf16*>(smem + SM::DO_OFF);
  bf16* sDS = reinterpret_cast<bf16*>(smem + SM::DS_OFF);  // [BN][BQ]: dS^T
  float* sStg = reinterpret_cast<float*>(smem + SM::STG_OFF);  // [NC groups][BQ][64]
  float* sRow = reinterpret_cast<float*>(smem + SM::ROW_OFF);  // [NST][lse2, delta][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* kv_full = empty + NST;

  const int h = blockIdx.y / SM::HALVES, half = blockIdx.y % SM::HALVES;
  const int b = blockIdx.z, kv0 = blockIdx.x * BN, p0 = half * NPV;  // p0: first owned panel
  const long long bh = (long long)b * H + h;
  const int n_q = kv0 < kv_len ? NQ : 0;  // tiles wholly past kv_len: dK = dV = 0
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NC);
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {  // producer warp group: one thread issues the loads
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
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
  } else {  // consumer warp groups: kv rows 64 w .. 64 w + 63
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = tid / 128 - 1, tw = tid % 128, lane = tid & 31;
    const int r_loc = (tw >> 5) * 16 + (lane >> 2);  // this lane's rows r_loc, r_loc + 8
    const int kv_row = kv0 + 64 * w + r_loc;
    const bool ok[2] = {kv_row < kv_len, kv_row + 8 < kv_len};
    const float scale_log2 = scale * LOG2E;
    const bf16* kw = sK + w * 64 * 64;
    const bf16* vw = sV + w * 64 * 64;
    float dk[DV / 8][4], dv[DV / 8][4], sT[8][4], dpT[8][4];
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
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
      for (int kk = 0; kk < DC / 16; ++kk)
        wgmma_ss<0, 0>(&sT[0][0], desc_kmajor(kw + (kk / 4) * BN * 64 + (kk % 4) * 16),
                       desc_kmajor(qt + (kk / 4) * BQ * 64 + (kk % 4) * 16), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DC / 16; ++kk)
        wgmma_ss<0, 0>(&dpT[0][0], desc_kmajor(vw + (kk / 4) * BN * 64 + (kk % 4) * 16),
                       desc_kmajor(gt + (kk / 4) * BQ * 64 + (kk % 4) * 16), kk > 0);
      wg_commit();
      wg_wait<1>();
      fence_regs<32>(&sT[0][0]);

      // P^T from the saved LSE; masked kv rows exactly 0.  dV += P^T dO
      // over this CTA's panels of dO.
      uint32_t pa[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i * 8 + (lane & 3) * 2 + (e & 1);
          const float x = FLAT ? sT[i][e] : sT[i][e] * scale_log2;
          sT[i][e] = ok[e >> 1] ? fast_exp2(x - lt[c]) : 0.f;
        }
      acc_to_a_frags<4>(pa, sT);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NPV; ++p)
          wgmma_rs<1>(&dv[p * 8][0], pa[kk],
                      desc_mnmajor(gt + (p0 + p) * BQ * 64 + kk * 16 * 64));
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
      acc_to_a_frags<4>(da, dpT);
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
        for (int p = 0; p < NPV; ++p)
          wgmma_rs<1>(&dk[p * 8][0], da[kk],
                      desc_mnmajor(qt + (p0 + p) * BQ * 64 + kk * 16 * 64));
      wg_commit();

      // this group's share of dQ = dS K (its 64 kv rows) over this CTA's
      // panels, one 64-column panel at a time, added to the fp32 workspace
      named_sync(2 + w, 128);  // this group's rows of dS^T written
#pragma unroll
      for (int pp = 0; pp < NPV; ++pp) {
        const int p = p0 + pp;
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
      fence_regs<DV / 2>(&dk[0][0]);
      fence_regs<DV / 2>(&dv[0][0]);
      mbar_arrive(&empty[st]);
    }
    if (tw == 0) bulk_wait_all();

    if (FLAT) {  // unwind the q-scale fold: dk = dS^T (q * scale * log2 e) / log2 e
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[i][e] *= 1.0f / LOG2E;
    }
    if constexpr (D == 0) {
      const int col0 = p0 * 64;
      if (dk_acc != nullptr)
        bya::store_tile_any(dk_acc + L.off(b, h), L.ss, dk, kv_row, S, lane, col0, Dr);
      else
        bya::store_tile_any(dk_out + L.off(b, h), L.ss, dk, kv_row, S, lane, col0, Dr);
      bya::store_tile_any(dv_out + L.off(b, h), L.ss, dv, kv_row, S, lane, col0, Dr);
    } else {
      bya::rope_adjoint<D>(dk, kv_row, lane, cos_t, sin_t, rope_start, rope_rows);
      bya::store_tile<D>(dk_out + L.off(b, h), L.ss, dk, kv_row, S, lane);
      bya::store_tile<D>(dv_out + L.off(b, h), L.ss, dv, kv_row, S, lane);
    }
  }
}

#define PRE_PARAMS                                                                           \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, bf16 *__restrict__ qo,             \
      bf16 *__restrict__ ko, const bf16 *__restrict__ o, const bf16 *__restrict__ dout,       \
      const float *__restrict__ lse, const float *__restrict__ delta_in,                     \
      float *__restrict__ lse2, float *__restrict__ delta, float *__restrict__ dq_acc,       \
      const float *cos_t, const float *sin_t, int rope_start, int rope_rows, int B, int S,   \
      int H, int NQ, Layout L, float q_scale, int Dr
#define PRE_ARGS                                                                        \
  q, k, qo, ko, o, dout, lse, delta_in, lse2, delta, dq_acc, cos_t, sin_t, rope_start, \
      rope_rows, B, S, H, NQ, L, q_scale, Dr
#define POST_PARAMS                                                                          \
  const float *__restrict__ dq_acc, bf16 *__restrict__ dq, const float *__restrict__ dk_acc, \
      bf16 *__restrict__ dk, const float *cos_t, const float *sin_t, int rope_start,          \
      int rope_rows, int B, int S, int H, int NQ, Layout L, float scale, int Dr
#define POST_ARGS \
  dq_acc, dq, dk_acc, dk, cos_t, sin_t, rope_start, rope_rows, B, S, H, NQ, L, scale, Dr
#define MAIN_PARAMS                                                                          \
  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,           \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,      \
      const float *__restrict__ lse2, const float *__restrict__ delta,                      \
      float *__restrict__ dq_acc, bf16 *__restrict__ dk_out, bf16 *__restrict__ dv_out,     \
      float *__restrict__ dk_acc, const float *cos_t, const float *sin_t, int rope_start,   \
      int rope_rows, Layout L, int S, int H, int NQ, int kv_len, float scale, int Dr

// The three launches at head dim D (32, 64, 128, or 0: any width) on the
// DC-column body; FLAT: B7 (q scale folded into the prepared q, delta
// given), else B12 + B13
template <int D, int DC, bool FLAT>
__global__ void __launch_bounds__(256) bwd_pre_kernel(PRE_PARAMS) {
  pre_body<D, DC, FLAT>(PRE_ARGS);
}
template <int D, int DC, bool FLAT>
__global__ void __launch_bounds__(BwdSmem<DC>::NTHREADS, 1) bwd_kernel(MAIN_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  bwd_body<D, DC, FLAT>(smem_raw, BWD_ARGS);
}
template <int D, int DC, bool FLAT>
__global__ void __launch_bounds__(256) bwd_post_kernel(POST_PARAMS) {
  post_body<D, DC, FLAT>(POST_ARGS);
}

// ---------------------------------------------------------------- host

template <int D, int DC, bool FLAT>
int run_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
            const float* lse, const float* delta_in, void* dq, void* dk, void* dv, void* q_prep,
            void* k_prep, float* dq_acc, float* dk_acc, float* lse2, float* delta,
            const float* cos_t, const float* sin_t, int rope_start, int rope_rows, int B, int S,
            int H, int Dr, int bshd, int kv_len, float scale, cudaStream_t st) {
  using SM = BwdSmem<DC>;
  const Layout L = make_layout(S, H, Dr, bshd);
  const int NQ = (S + BQ - 1) / BQ;
  const int block = 256;
  const long long pre_threads = (long long)B * NQ * BQ * H * 32;
  bwd_pre_kernel<D, DC, FLAT><<<(unsigned)((pre_threads + block - 1) / block), block, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(q_prep),
      static_cast<bf16*>(k_prep), static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      delta_in, lse2, delta, dq_acc, cos_t, sin_t, rope_start, rope_rows, B, S, H, NQ, L,
      FLAT ? scale * LOG2E : 1.0f, Dr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const void* qa = q_prep != nullptr ? q_prep : q;
  const void* ka = k_prep != nullptr ? k_prep : k;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, qa, L, B, H, S, Dr, BQ) || !make_map(&tk, ka, L, B, H, S, Dr, SM::BN) ||
      !make_map(&tv, v, L, B, H, S, Dr, SM::BN) || !make_map(&tdo, dout, L, B, H, S, Dr, BQ))
    return (int)cudaErrorInvalidValue;
  auto fused = bwd_kernel<D, DC, FLAT>;
  err = cudaFuncSetAttribute(fused, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + SM::BN - 1) / SM::BN, H * SM::HALVES, B);
  fused<<<grid, SM::NTHREADS, SM::BYTES, st>>>(
      tq, tk, tv, tdo, lse2, delta, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      dk_acc, cos_t, sin_t, rope_start, rope_rows, L, S, H, NQ, kv_len, scale, Dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long post_threads = (long long)B * S * H * 32;
  bwd_post_kernel<D, DC, FLAT><<<(unsigned)((post_threads + block - 1) / block), block, 0, st>>>(
      dq_acc, static_cast<bf16*>(dq), dk_acc, static_cast<bf16*>(dk), cos_t, sin_t, rope_start,
      rope_rows, B, S, H, NQ, L, scale, Dr);
  return (int)cudaGetLastError();
}

template <bool FLAT>
int dispatch_bwd(int D, const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, const float* delta_in, void* dq, void* dk,
                 void* dv, void* q_prep, void* k_prep, float* dq_acc, float* dk_acc, float* lse2,
                 float* delta, const float* cos_t, const float* sin_t, int rope_start,
                 int rope_rows, int B, int S, int H, int bshd, int kv_len, float scale,
                 cudaStream_t st) {
#define BWD_CALL_ARGS                                                                       \
  q, k, v, o, dout, lse, delta_in, dq, dk, dv, q_prep, k_prep, dq_acc, dk_acc, lse2, delta, \
      cos_t, sin_t, rope_start, rope_rows, B, S, H, D, bshd, kv_len, scale, st
  if (D == 32) return run_bwd<32, 64, FLAT>(BWD_CALL_ARGS);
  if (D == 64) return run_bwd<64, 64, FLAT>(BWD_CALL_ARGS);
  if (D == 128) return run_bwd<128, 128, FLAT>(BWD_CALL_ARGS);
  const int dc = body_of(D);  // the head's body (D checked)
  if (dc == 64) return run_bwd<0, 64, FLAT>(BWD_CALL_ARGS);
  if (dc == 128) return run_bwd<0, 128, FLAT>(BWD_CALL_ARGS);
  return run_bwd<0, 256, FLAT>(BWD_CALL_ARGS);
#undef BWD_CALL_ARGS
}

}  // namespace

// The fused flash backward: dq, dk, dv (bf16, in the layout of q) from q,
// k, v, dO and the forward's LSE (natural log, fp32 [B, H, S]); D % 8 == 0,
// 8 <= D <= 256.
//  flat = 1 (B7): [B, S, H*D] contiguous (bshd = 1); delta_in = rowsum(o *
//    dO), fp32 [B, H, S]; o unused; q_prep/k_prep required.
//  flat = 0 (B12 + B13): [B, H, S, D] (bshd = 0) or [B, S, H, D] (bshd =
//    1); o given, delta_in unused; q_prep/k_prep scratch of q's shape when
//    there is RoPE, else null.
// Workspaces (the caller's, uninitialised): dq_acc [B*H*S_pad*DC] fp32 (DC
// = 64, 128 or 256: the narrowest that holds D), lse2 and delta
// [B*H*S_pad] fp32, S_pad = S rounded up to 64; dk_acc, fp32 of dk's shape,
// required when there is RoPE and D is not 32, 64 or 128, else null.
// cos_t/sin_t: [rope_rows, D] fp32 or null.  Returns the cudaError_t of the
// launches.
extern "C" int bya_flash_bwd(int flat, const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             const float* delta_in, void* dq, void* dk, void* dv, void* q_prep,
                             void* k_prep, float* dq_acc, float* dk_acc, float* lse2,
                             float* delta, const float* cos_t, const float* sin_t,
                             int rope_start, int rope_rows, int B, int S, int H, int D, int bshd,
                             int kv_len, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > 256 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  const bool generic = D != 32 && D != 64 && D != 128;
  if (generic && cos_t != nullptr && dk_acc == nullptr) return (int)cudaErrorInvalidValue;
  if (!generic) dk_acc = nullptr;
  if (flat) {
    if (!bshd || q_prep == nullptr || k_prep == nullptr) return (int)cudaErrorInvalidValue;
    return dispatch_bwd<true>(D, q, k, v, o, dout, lse, delta_in, dq, dk, dv, q_prep, k_prep,
                              dq_acc, dk_acc, lse2, delta, cos_t, sin_t, rope_start, rope_rows,
                              B, S, H, bshd, kv_len, scale, st);
  }
  return dispatch_bwd<false>(D, q, k, v, o, dout, lse, delta_in, dq, dk, dv, q_prep, k_prep,
                             dq_acc, dk_acc, lse2, delta, cos_t, sin_t, rope_start, rope_rows, B,
                             S, H, bshd, kv_len, scale, st);
}
