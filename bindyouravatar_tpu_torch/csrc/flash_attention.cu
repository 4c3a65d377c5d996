// Flash attention forward for Hopper: one wgmma + TMA body computes B1 and
// B7's forward over the flat [B, S, H*D] layout and B11 over [B, H, S, D]
// ("bhsd") or [B, S, H, D] ("bshd"), at every head dim D with D % 8 == 0
// and 8 <= D <= 256 (the flat wrappers take those where JAX's flat kernels
// pack their heads).  The backward of B7 and of B11 (B12 + B13) is one
// fused kernel in flash_attention_bwd.cu; both sources take their Hopper
// building blocks from hopper.cuh.
//
// B1 replaces the TPU kernel `_fwd_flat_t_kernel`
// (bindyouravatar_tpu/ops/flash_attention.py), reached through
// `flash_attention(layout="flat")` from the DiT's joint self-attention at
// inference (QK-LN and RoPE fused) and from the router's STAB spatial
// attention (bare).  Same math: per head, LN(eps, fp32 stats, fp32 affine)
// -> bf16, rotate-half RoPE on rows [rope_start, rope_start + rope_rows) ->
// bf16, then non-causal softmax(q k^T * scale) v over kv rows < kv_len.
//
// B7's forward replaces `_fwd_flat_kernel` with `save_residuals` (the
// `_flash_flat` custom vjp: the DiT's training attention, QK-LN applied
// outside, and the STAB spatial attention): the same with no LN, writing the
// per-row log-sum-exp (natural log, fp32, [B, H, S]) that the backward reads.
//
// B11 replaces `_fwd_kernel`, reached through `flash_attention(layout=
// "bhsd" | "bshd")`: the differentiable `_flash` custom vjp (saving the
// LSE) and the inference form with the QK LayerNorm fused.
//
// What bounds it on the H100: the two products per (q tile, kv tile),
// S = Q K^T and O += P V, 4 S^2 D FLOP per head (3.9 ms at B = 1, S = 17,776,
// 48 heads of 64 on 989 TFLOP/s bf16) against 0.1-0.4 GB of q/k/v/o
// traffic; and at D = 64 the softmax's one 2^x per score, which the
// special-function unit issues at about the rate the tensor cores finish
// the score's 256 FLOP, so the two have to overlap.
//
// Design:
//  * A pre-pass (`prep_qk`, one warp per row) applies LN and RoPE to q and k
//    where a call has either, into bf16 scratch of the input's layout; B1
//    and B7 fold scale * log2 e into the prepared q there and round it to
//    bf16, as the JAX kernels do.  A call with neither (B11 bare, the bare
//    STAB attention of B1 and B7) skips it: the kernel reads q and k and
//    multiplies the fp32 scores by scale * log2 e in the exponent's FFMA.
//    At D = 32, 64 and 128 a lane holds D / 32 consecutive elements and
//    finds its rotate-half partner at lane ^ 16; at any other D a lane holds
//    every 32nd element and reads its partner (i +- D/2 of the true D) from
//    the row (`prep_row_any`, flash_common.cuh).
//  * One CTA per 128-row q tile of one (batch, head).  DC = 64 and 128: 384
//    threads: warp group 0 is the producer (one thread issues every TMA
//    load; setmaxnreg drops the group to 24 registers), warp groups 1 and 2
//    each own 64 q rows (setmaxnreg 240).  The q tile is loaded once; K and
//    V tiles of 128 rows stream through a ring of 4 stages at DC = 64, 2 at
//    DC = 128 (shared memory 148,584 and 164,920 bytes), K and V on
//    barriers of their own so S can start before V lands.  One 4-D tensor
//    map [B, H, S, D] with the layout's strides serves flat, bhsd and bshd;
//    the TMA unit zero-fills rows past S.  Tiles are 64-column panels of
//    128-byte rows in the 128-byte swizzle.
//  * Three bodies, DC = 64, 128 and 256 columns wide: a head of D columns
//    runs on the narrowest body with DC >= D.  Every tensor map's innermost
//    extent is the head's true D, so the boxes' columns past D read as zeros
//    (outside the tensor, never the next head's columns in bshd or flat),
//    the products over them add nothing, and the output store leaves them
//    out.  TMA needs 16-byte row strides, so D % 8 == 0.  A narrow head pays
//    the body's full product width per score: D = 16 on the 64-column body
//    multiplies four times its useful columns.
//  * DC = 256 (`fwd_body256`): 256 threads, two consumer warp groups of 64
//    q rows and no producer warps, so ptxas may give a thread 255 registers
//    (a ninth warp shares a sub-partition's registers three ways: 168, as
//    at 384 threads, where setmaxnreg does not raise what ptxas compiled
//    for).  Consumer threads issue the loads.  Each group holds
//    all 256 of O's columns (128 fp32 registers) beside S over a 64-key
//    block (32) and P's bf16 fragments (16), so S = Q K^T is made once per
//    (q tile, key block): the earlier body split O's columns between two
//    CTAs that each made the whole S, 1.5 times the forward's products.  Q
//    64 KB, three stages of a 64-key block's K and two of its V (32 KB
//    each) take 230,468 bytes; a K stage is freed once S is made, a V stage
//    once P V is, each reloaded by the second group to free it (the third
//    K stage measured faster than two: the block loads, not the products,
//    had held the body; PERF.md section 6).  The
//    groups run the DC = 64 body's software pipeline (S_j issued with
//    P_{j-1} V_{j-1}, S_j's softmax under that product) and take turns to
//    issue; a warp skips O's rescale where no row's max grew.  One CTA a q
//    tile: one writer of the LSE.
//  * S = Q K^T is wgmma m64n128k16 (m64n64k16 at DC = 256) with both
//    operands K-major in shared memory.  Its accumulator is already the A-fragment layout, so P goes
//    from registers to O += P V (wgmma m64n64k16 per 64-column panel of V,
//    V read through a transposed, MN-major descriptor).
//  * Softmax: an fp32 online running max per row (the TPU kernel's static
//    max is valid only behind the fused LN; the bare STAB calls come here
//    too), scores in log2 units, P and the rescale factor on `ex2.approx`.
//    Columns >= kv_len are masked (a large finite negative) only on the
//    tile that reaches past it (a branch, skipped on the other tiles); a
//    row's max and sum run over four partial values each (chains of eight
//    dependent instructions, not 32: the scaled calls' exponent FFMA waits
//    on the max, and this took B11 bare from 16.9 to 15.6-15.8 ms), and
//    the sum stays per thread until the end.
//  * What bounds it in practice at D = 64: per 128 x 128 tile pair of the
//    two groups the tensor cores need ~1,024 cycles and the special-
//    function unit ~1,056 (16 results a cycle per SM), so the kernel is
//    near its limit only if the two overlap perfectly; it takes about
//    twice its 4 S^2 D bound (B1 fused, B11 bare, B7's forward).
//  * Overlap at DC = 64, the two kept together because together they
//    measured faster (`bench_flash_fwd.py` on an H100 80GB HBM3 at 700 W,
//    kernel times, before the partial sums): each consumer issues tile
//    j's S product together with tile j-1's P V and runs S_j's softmax
//    while they execute (alone this was slower than the plain order, 19.2
//    against 17.0-17.9 ms for B11 bare); and the two consumers take turns
//    to issue their products (named barriers), so one group's softmax runs
//    under the other's products (with both: 16.9-17.0 ms for B11 bare,
//    15.4-15.5 for B1 fused against 18.4).  At DC = 128 the
//    pipeline's S, P and O need more than the 168 registers ptxas allots
//    (it serialised the products and spilled 192 bytes: 13.4 ms against
//    6.7), so each tile runs in order.  ptxas: 168 registers, no spill,
//    for every 384-thread instance; setmaxnreg does not raise the 168 it
//    compiles for.
//  * Epilogue: O normalised in registers, written as bf16 into the group's
//    own rows of the q tile in shared memory and stored by TMA in the
//    caller's layout (rows >= S and columns >= D are not written); the LSE
//    when asked.
#include "hopper.cuh"

namespace {

using namespace bya;

constexpr int BM = 128;  // q rows per CTA: two consumer warp groups of 64
constexpr int BN = 128;  // kv rows per streamed tile
constexpr int NTHREADS = 384;

// DC = 64 and 128
template <int DC>
struct FwdSmem {
  static constexpr int NP = DC / 64;              // 64-column panels of Q, K, V and O
  static constexpr int NST = DC == 64 ? 4 : 2;    // kv ring stages
  static constexpr int Q_TILE = BM * DC * 2;      // bytes of the q tile
  static constexpr int K_TILE = BN * DC * 2;      // bytes of one K tile
  static constexpr int V_TILE = BN * DC * 2;      // bytes of one V tile
  static constexpr int Q_OFF = 0, K_OFF = Q_TILE, V_OFF = K_OFF + NST * K_TILE;
  static constexpr int BAR_OFF = V_OFF + NST * V_TILE;
  static constexpr int BYTES = BAR_OFF + (3 * NST + 1) * 8 + 1024;  // + base alignment
};

// DC = 256: 64-key blocks, three K stages and two V stages
struct Fwd256Smem {
  static constexpr int NP = 4;                    // 64-column panels of Q, K, V and O
  static constexpr int BN = 64;                   // keys a block
  static constexpr int NSK = 3, NSV = 2;         // K and V ring stages
  static constexpr int NTHREADS = 256;            // two consumer groups
  static constexpr int Q_TILE = BM * 256 * 2;     // bytes of the q tile
  static constexpr int KV_TILE = BN * 256 * 2;    // bytes of one block's K (or V)
  static constexpr int Q_OFF = 0, K_OFF = Q_TILE, V_OFF = K_OFF + NSK * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + NSV * KV_TILE;
  // barriers, then a release count a stage
  static constexpr int BYTES = BAR_OFF + (1 + NSK + NSV) * 8 + (NSK + NSV) * 4 + 1024;
};

// threads and shared memory of a CTA on the DC-column body
template <int DC>
struct FwdThreads {
  static constexpr int value = DC == 256 ? Fwd256Smem::NTHREADS : NTHREADS;
};
template <int DC>
constexpr int fwd_smem_bytes() {
  if constexpr (DC == 256)
    return Fwd256Smem::BYTES;
  else
    return FwdSmem<DC>::BYTES;
}

// ---------------------------------------------------------------- pre-pass

// LN (if lnqw) and RoPE (if cos_t) of q and k into qo/ko, same layout; q
// also scaled by q_scale.  One warp per (b, s, h) row.  D = 32, 64 or 128:
// D / 32 consecutive elements a lane; D = 0: any width Dr (D % 8 == 0).
template <int D>
__device__ __forceinline__ void prep_qk(const bf16* q, const bf16* k, bf16* qo, bf16* ko,
                                        const float* lnqw, const float* lnqb, const float* lnkw,
                                        const float* lnkb, const float* cos_t, const float* sin_t,
                                        int rope_start, int rope_rows, int B, int S, int H,
                                        Layout L, float q_scale, float eps, int Dr) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * S * H) return;
  const int h = (int)(warp % H);
  const long long bs = warp / H;
  const int s = (int)(bs % S), b = (int)(bs / S);
  if constexpr (D == 0)
    prep_qk_row_any(q, k, qo, ko, lnqw, lnqb, lnkw, lnkb, cos_t, sin_t, rope_start, rope_rows, b,
                    s, h, L, q_scale, eps, lane, Dr);
  else
    prep_qk_row<D>(q, k, qo, ko, lnqw, lnqb, lnkw, lnkb, cos_t, sin_t, rope_start, rope_rows, b,
                   s, h, L, q_scale, eps, lane);
}

#define PREP_PARAMS                                                                        \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, bf16 *__restrict__ qo,           \
      bf16 *__restrict__ ko, const float *__restrict__ lnqw, const float *__restrict__ lnqb, \
      const float *__restrict__ lnkw, const float *__restrict__ lnkb,                      \
      const float *__restrict__ cos_t, const float *__restrict__ sin_t, int rope_start,    \
      int rope_rows, int B, int S, int H, Layout L, float q_scale, float eps, int Dr
#define PREP_ARGS                                                                      \
  q, k, qo, ko, lnqw, lnqb, lnkw, lnkb, cos_t, sin_t, rope_start, rope_rows, B, S, H, L, \
      q_scale, eps, Dr

// The pre-pass of B1 / B7 (flat, q scaled by scale * log2 e) and of B11
// (LN and RoPE), D = 32, 64 or 128, or 0 (any width Dr)
template <int D>
__global__ void __launch_bounds__(256) prep_qk_kernel(PREP_PARAMS) { prep_qk<D>(PREP_ARGS); }

// ---------------------------------------------------------------- forward

// The online softmax of one 64 x 8 NB score tile (NB = 16: a 128-key tile,
// 8: a 64-key block) in log2 units: columns >= kv_len masked (only on a
// tile that reaches past it), the running row max m and this lane's share
// of the row sum l updated, alpha the factor that rescales what O holds,
// and s overwritten by P = 2^(s * sl - m * sl).
template <int NB>
__device__ __forceinline__ void softmax_tile(float (&s)[NB][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int kv0, int kv_len, float sl,
                                             int lane) {
  if (kv0 + 8 * NB > kv_len) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kv0 + 8 * i + 2 * (lane & 3) + (e & 1) >= kv_len) s[i][e] = MASKED;
  }
  // row max and row sum over four partial values per row, so that no chain
  // of dependent instructions is longer than eight
  float mx[2][4], rs[2][4], mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[r][c] = fmaxf(s[c][2 * r], s[c][2 * r + 1]);
      rs[r][c] = 0.f;
    }
#pragma unroll
  for (int i = 4; i < NB; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][i % 4] = fmaxf(mx[r][i % 4], fmaxf(s[i][2 * r], s[i][2 * r + 1]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], fmaxf(mx[r][3], m[r])));
    x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
    x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
    alpha[r] = fast_exp2((m[r] - x) * sl);
    m[r] = x;
    mb[r] = x * sl;
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[i][e] = fast_exp2(fmaf(s[i][e], sl, -mb[e >> 1]));
      rs[e >> 1][i % 4] += s[i][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
}

// O (and the LSE, if `lse`) of one 128-row q tile of one (batch, head) on
// the DC-column body, DC = 64 or 128.  SCALE: the scores are multiplied by
// scale_log2 in the exponent (q, k as given); else q arrives scaled by
// scale * log2 e.  Scores are in log2 units: P = 2^(s * sl - m * sl), m the
// running row max of s.
template <int DC, bool SCALE>
__device__ __forceinline__ void fwd_body(unsigned char* smem_raw, const CUtensorMap* tq,
                                         const CUtensorMap* tk, const CUtensorMap* tv,
                                         const CUtensorMap* to, float* __restrict__ lse, int S,
                                         int H, int kv_len, float scale_log2) {
  static_assert(DC == 64 || DC == 128, "DC = 256 runs fwd_body256");
  using SM = FwdSmem<DC>;
  constexpr int NP = SM::NP, NST = SM::NST;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem + SM::Q_OFF);  // [NP][BM][64], swizzled
  bf16* sK = reinterpret_cast<bf16*>(smem + SM::K_OFF);  // [NST][NP][BN][64]
  bf16* sV = reinterpret_cast<bf16*>(smem + SM::V_OFF);  // [NST][NP][BN][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + SM::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NST;
  uint64_t* empty = v_full + NST;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BM;
  const int n_kv = (kv_len + BN - 1) / BN;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {  // producer warp group: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, SM::Q_TILE);
      for (int p = 0; p < NP; ++p) tma_load_4d(sQ + p * BM * 64, tq, 64 * p, q0, h, b, q_full);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % NST, f = j / NST;
        if (f > 0) mbar_wait(&empty[st], (f - 1) & 1);
        mbar_expect_tx(&k_full[st], SM::K_TILE);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sK + (st * NP + p) * BN * 64, tk, 64 * p, j * BN, h, b, &k_full[st]);
        mbar_expect_tx(&v_full[st], SM::V_TILE);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sV + (st * NP + p) * BN * 64, tv, 64 * p, j * BN, h, b, &v_full[st]);
      }
    }
    return;
  }

  // consumer warp groups 1 and 2: q rows 64 w .. 64 w + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int w = tid / 128 - 1, tw = tid % 128, lane = tid & 31;
  const int r_loc = (tw >> 5) * 16 + (lane >> 2);  // this lane's rows r_loc, r_loc + 8
  const float sl = SCALE ? scale_log2 : 1.0f;
  const bf16* qw = sQ + w * 64 * 64;
  float o[DC / 8][4], s[16][4], m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;

  // S = Q K^T of kv tile j, both operands K-major in shared memory
  auto issue_s = [&](int j) {
    const bf16* kt = sK + (j % NST) * NP * BN * 64;
    mbar_wait(&k_full[j % NST], (j / NST) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk)
      wgmma_ss_n128(&s[0][0], desc_kmajor(qw + (kk / 4) * BM * 64 + (kk % 4) * 16),
                    desc_kmajor(kt + (kk / 4) * BN * 64 + (kk % 4) * 16), kk > 0);
    wg_commit();
  };
  // O += P V of kv tile j, P from registers, V read transposed, one
  // 64-column panel at a time
  auto issue_pv = [&](int j) {
    const bf16* vt = sV + (j % NST) * NP * BN * 64;
    mbar_wait(&v_full[j % NST], (j / NST) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs<1>(&o[p * 8][0], pa[kk], desc_mnmajor(vt + p * BN * 64 + kk * 16 * 64));
    wg_commit();
  };

  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < DC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e >> 1];
  };

  mbar_wait(q_full, 0);
  if constexpr (DC == 64) {
    // Software pipeline: tile j's S product is issued with tile j-1's P V,
    // and S_j's softmax runs while the tensor cores finish P_{j-1} V_{j-1};
    // O is rescaled once that product has completed.  The two consumer
    // groups take turns to issue (named barriers 3 and 4, group 0 first),
    // so one group's softmax runs under the other's products.
    const int turn = 3 + w, other = 4 - w;
    if (w == 1) named_arrive(3, 256);
    named_sync(turn, 256);
    issue_s(0);
    named_arrive(other, 256);
    wg_wait<0>();
    fence_regs<64>(&s[0][0]);
    softmax_tile<16>(s, m, l, alpha, 0, kv_len, sl, lane);
    acc_to_a_frags<8>(pa, s);
    for (int j = 1; j < n_kv; ++j) {
      named_sync(turn, 256);
      issue_s(j);
      issue_pv(j - 1);
      named_arrive(other, 256);
      wg_wait<1>();
      fence_regs<64>(&s[0][0]);
      softmax_tile<16>(s, m, l, alpha, j * BN, kv_len, sl, lane);
      wg_wait<0>();
      fence_regs<DC / 2>(&o[0][0]);
      mbar_arrive(&empty[(j - 1) % NST]);
      rescale_o();
      acc_to_a_frags<8>(pa, s);
    }
    named_sync(turn, 256);
    issue_pv(n_kv - 1);
    if (w == 0) named_arrive(other, 256);  // every sync has its arrival
  } else {
    // DC = 128: S, P and O do not fit beside each other in 168
    // registers (ptxas serialises the products and spills), so each tile
    // runs in order
    for (int j = 0; j < n_kv; ++j) {
      issue_s(j);
      wg_wait<0>();
      fence_regs<64>(&s[0][0]);
      softmax_tile<16>(s, m, l, alpha, j * BN, kv_len, sl, lane);
      rescale_o();
      acc_to_a_frags<8>(pa, s);
      if (j + 1 < n_kv) {
        issue_pv(j);
        wg_wait<0>();
        fence_regs<DC / 2>(&o[0][0]);
        mbar_arrive(&empty[j % NST]);
      }
    }
    issue_pv(n_kv - 1);
  }
  wg_wait<0>();
  fence_regs<DC / 2>(&o[0][0]);
  mbar_arrive(&empty[(n_kv - 1) % NST]);

  // epilogue: the row sums across the quad, the LSE, O / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
  const int row0 = q0 + 64 * w + r_loc;
  if (lse != nullptr && (lane & 3) == 0) {
    float* lb = lse + ((long long)b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < S)
        lb[row0 + 8 * r] = l[r] > 0.f ? m[r] * sl * (1.0f / LOG2E) + logf(l[r]) : LSE_EMPTY;
  }
  // O as bf16 into this group's rows of the q tile (every S product that
  // read them has completed), swizzled as TMA reads it, then one TMA store
  // per panel (columns past the head's D fall outside the tensor map)
  unsigned char* ob = reinterpret_cast<unsigned char*>(sQ);
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 64 * w + r_loc + 8 * hf, c = i % 8;
      *reinterpret_cast<uint32_t*>(ob + (i / 8) * BM * 128 + r * 128 + ((c ^ (r & 7)) << 4) +
                                   (lane & 3) * 4) =
          pack_bf16(o[i][2 * hf] * inv[hf], o[i][2 * hf + 1] * inv[hf]);
    }
  fence_async_shared();
  named_sync(1 + w, 128);
  if (tw == 0 && q0 + 64 * w < S) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_store_4d(to, sQ + p * BM * 64 + w * 64 * 64, 64 * p, q0 + 64 * w, h, b);
    bulk_wait_read();
  }
}

// O (and the LSE, if `lse`) of one 128-row q tile of one (batch, head) on
// the 256-column body (heads of 136..256 columns): two consumer groups of
// 64 q rows, each holding all of O's columns.  Thread 0 issues the q tile's
// and the first blocks' loads; a stage's next block is issued by the group
// that frees it second (a count a stage), so neither waits on the other to
// issue.  SCALE and the scores' units as in fwd_body.
template <bool SCALE>
__device__ __forceinline__ void fwd_body256(unsigned char* smem_raw, const CUtensorMap* tq,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const CUtensorMap* to, float* __restrict__ lse,
                                            int S, int H, int kv_len, float scale_log2) {
  using SM = Fwd256Smem;
  constexpr int NP = SM::NP, NSK = SM::NSK, NSV = SM::NSV, KB = SM::BN;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem + SM::Q_OFF);  // [NP][BM][64], swizzled
  bf16* sK = reinterpret_cast<bf16*>(smem + SM::K_OFF);  // [NSK][NP][KB][64]
  bf16* sV = reinterpret_cast<bf16*>(smem + SM::V_OFF);  // [NSV][NP][KB][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + SM::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NSK;
  int* k_freed = reinterpret_cast<int*>(v_full + NSV);  // groups that freed each stage, so far
  int* v_freed = k_freed + NSK;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BM;
  const int n_kv = (kv_len + KB - 1) / KB;
  const int tid = threadIdx.x;
  // block j's K into stage j % NSK, its V into j % NSV
  auto load_k = [&](int j) {
    const int st = j % NSK;
    mbar_expect_tx(&k_full[st], SM::KV_TILE);
    for (int p = 0; p < NP; ++p)
      tma_load_4d(sK + (st * NP + p) * KB * 64, tk, 64 * p, j * KB, h, b, &k_full[st]);
  };
  auto load_v = [&](int j) {
    const int st = j % NSV;
    mbar_expect_tx(&v_full[st], SM::KV_TILE);
    for (int p = 0; p < NP; ++p)
      tma_load_4d(sV + (st * NP + p) * KB * 64, tv, 64 * p, j * KB, h, b, &v_full[st]);
  };
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSK; ++s) {
      mbar_init(&k_full[s], 1);
      k_freed[s] = 0;
    }
    for (int s = 0; s < NSV; ++s) {
      mbar_init(&v_full[s], 1);
      v_freed[s] = 0;
    }
    mbar_init_fence();
    mbar_expect_tx(q_full, SM::Q_TILE);
    for (int p = 0; p < NP; ++p) tma_load_4d(sQ + p * BM * 64, tq, 64 * p, q0, h, b, q_full);
    for (int j = 0; j < NSK && j < n_kv; ++j) load_k(j);
    for (int j = 0; j < NSV && j < n_kv; ++j) load_v(j);
  }
  __syncthreads();

  // consumer group w: q rows 64 w .. 64 w + 63 of the tile
  const int w = tid / 128, tw = tid % 128, lane = tid & 31;
  // block j's K (V) stage is free in this group (its products have
  // completed): the second group to free it loads block j + NSK (NSV) there
  auto release_k = [&](int j) {
    if (tw != 0 || j + NSK >= n_kv) return;
    __threadfence_block();
    if (atomicAdd(&k_freed[j % NSK], 1) & 1) load_k(j + NSK);
  };
  auto release_v = [&](int j) {
    if (tw != 0 || j + NSV >= n_kv) return;
    __threadfence_block();
    if (atomicAdd(&v_freed[j % NSV], 1) & 1) load_v(j + NSV);
  };
  const int r_loc = (tw >> 5) * 16 + (lane >> 2);  // this lane's rows r_loc, r_loc + 8
  const float sl = SCALE ? scale_log2 : 1.0f;
  const bf16* qw = sQ + w * 64 * 64;
  float o[32][4], s[8][4], m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  // S = Q K^T of key block j, both operands K-major in shared memory
  auto issue_s = [&](int j) {
    const bf16* kt = sK + (j % NSK) * NP * KB * 64;
    mbar_wait(&k_full[j % NSK], (j / NSK) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss<0, 0>(&s[0][0], desc_kmajor(qw + (kk / 4) * BM * 64 + (kk % 4) * 16),
                     desc_kmajor(kt + (kk / 4) * KB * 64 + (kk % 4) * 16), kk > 0);
    wg_commit();
  };
  // O += P V of key block j, P from registers, V read transposed, one
  // 64-column panel at a time
  auto issue_pv = [&](int j) {
    const bf16* vt = sV + (j % NSV) * NP * KB * 64;
    mbar_wait(&v_full[j % NSV], (j / NSV) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs<1>(&o[p * 8][0], pa[kk], desc_mnmajor(vt + p * KB * 64 + kk * 16 * 64));
    wg_commit();
  };

  // block j's S is issued with block j-1's P V, and its softmax runs while
  // that product finishes; O is rescaled once it has (not where no row of
  // the warp's max grew: alpha = 2^0 = 1).  The two groups take turns to
  // issue (named barriers 3 and 4, group 0 first), so one group's softmax
  // runs under the other's products.
  const int turn = 3 + w, other = 4 - w;
  mbar_wait(q_full, 0);
  if (w == 1) named_arrive(3, 256);
  named_sync(turn, 256);
  issue_s(0);
  named_arrive(other, 256);
  wg_wait<0>();
  fence_regs<32>(&s[0][0]);
  release_k(0);
  softmax_tile<8>(s, m, l, alpha, 0, kv_len, sl, lane);
  acc_to_a_frags<4>(pa, s);
  for (int j = 1; j < n_kv; ++j) {
    named_sync(turn, 256);
    issue_s(j);
    issue_pv(j - 1);
    named_arrive(other, 256);
    wg_wait<1>();
    fence_regs<32>(&s[0][0]);
    release_k(j);
    softmax_tile<8>(s, m, l, alpha, j * KB, kv_len, sl, lane);
    wg_wait<0>();
    fence_regs<128>(&o[0][0]);
    release_v(j - 1);
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e >> 1];
    }
    acc_to_a_frags<4>(pa, s);
  }
  named_sync(turn, 256);
  issue_pv(n_kv - 1);
  if (w == 0) named_arrive(other, 256);  // every sync has its arrival
  wg_wait<0>();
  fence_regs<128>(&o[0][0]);

  // epilogue: the row sums across the quad, the LSE, O / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
  const int row0 = q0 + 64 * w + r_loc;
  if (lse != nullptr && (lane & 3) == 0) {
    float* lb = lse + ((long long)b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < S)
        lb[row0 + 8 * r] = l[r] > 0.f ? m[r] * sl * (1.0f / LOG2E) + logf(l[r]) : LSE_EMPTY;
  }
  // O as bf16 into this group's rows of the q tile (every S product that
  // read them has completed), swizzled as TMA reads it, then one TMA store
  // per panel (columns past the head's D fall outside the tensor map)
  unsigned char* ob = reinterpret_cast<unsigned char*>(sQ);
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 64 * w + r_loc + 8 * hf, c = i % 8;
      *reinterpret_cast<uint32_t*>(ob + (i / 8) * BM * 128 + r * 128 + ((c ^ (r & 7)) << 4) +
                                   (lane & 3) * 4) =
          pack_bf16(o[i][2 * hf] * inv[hf], o[i][2 * hf + 1] * inv[hf]);
    }
  fence_async_shared();
  named_sync(1 + w, 128);
  if (tw == 0 && q0 + 64 * w < S) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_store_4d(to, sQ + p * BM * 64 + w * 64 * 64, 64 * p, q0 + 64 * w, h, b);
    bulk_wait_read();
  }
}

#define FWD_PARAMS                                                                         \
  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,          \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,      \
      float *__restrict__ lse, int S, int H, int kv_len, float scale_log2

// B1 and B7's forward, flat [B, S, H*D] on the DC-column body: SCALE =
// false behind the pre-pass (q prepared and pre-scaled), true for the bare
// calls
template <int DC, bool SCALE>
__global__ void __launch_bounds__(FwdThreads<DC>::value, 1) flash_fwd_kernel(FWD_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (DC == 256)
    fwd_body256<SCALE>(smem_raw, &tq, &tk, &tv, &to, lse, S, H, kv_len, scale_log2);
  else
    fwd_body<DC, SCALE>(smem_raw, &tq, &tk, &tv, &to, lse, S, H, kv_len, scale_log2);
}

// B11: bhsd / bshd on the DC-column body, the scale on the scores
template <int DC>
__global__ void __launch_bounds__(FwdThreads<DC>::value, 1) mha_fwd_layout_kernel(FWD_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (DC == 256)
    fwd_body256<true>(smem_raw, &tq, &tk, &tv, &to, lse, S, H, kv_len, scale_log2);
  else
    fwd_body<DC, true>(smem_raw, &tq, &tk, &tv, &to, lse, S, H, kv_len, scale_log2);
}

// ---------------------------------------------------------------- launchers

// The pre-pass at head dim D: the lane-contiguous form at 32, 64 and 128,
// the any-width form otherwise.
cudaError_t launch_prep(const void* q, const void* k, void* q_prep, void* k_prep,
                        const float* ln_q_w, const float* ln_q_b, const float* ln_k_w,
                        const float* ln_k_b, const float* cos_t, const float* sin_t,
                        int rope_start, int rope_rows, int B, int S, int H, int D, Layout L,
                        float q_scale, float ln_eps, cudaStream_t st) {
  const long long threads = (long long)B * S * H * 32;
  const int block = 256;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  auto kernel = D == 32 ? prep_qk_kernel<32> : D == 64 ? prep_qk_kernel<64>
              : D == 128 ? prep_qk_kernel<128> : prep_qk_kernel<0>;
  kernel<<<grid, block, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(q_prep),
      static_cast<bf16*>(k_prep), ln_q_w, ln_q_b, ln_k_w, ln_k_b, cos_t, sin_t, rope_start,
      rope_rows, B, S, H, L, q_scale, ln_eps, D);
  return cudaGetLastError();
}

// The forward on the DC-column body for D-wide heads (D <= DC: the maps'
// boxes read the columns past D as zeros and the store leaves them out).
template <int DC, typename K>
int launch_fwd(K kernel, const void* q, const void* k, const void* v, void* o, float* lse,
               Layout L, int B, int S, int H, int D, int kv_len, float scale_log2,
               cudaStream_t st) {
  constexpr int kv_rows = DC == 256 ? Fwd256Smem::BN : BN;  // rows of a K / V box
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, L, B, H, S, D, BM) || !make_map(&tk, k, L, B, H, S, D, kv_rows) ||
      !make_map(&tv, v, L, B, H, S, D, kv_rows) || !make_map(&to, o, L, B, H, S, D, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = fwd_smem_bytes<DC>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, H, B);
  kernel<<<grid, FwdThreads<DC>::value, smem, st>>>(tq, tk, tv, to, lse, S, H, kv_len, scale_log2);
  return (int)cudaGetLastError();
}

#define RUN_PARAMS                                                                             \
  const void *q, const void *k, const void *v, void *o, void *q_prep, void *k_prep,           \
      const float *ln_q_w, const float *ln_q_b, const float *ln_k_w, const float *ln_k_b,    \
      const float *cos_t, const float *sin_t, int rope_start, int rope_rows, int B, int S,    \
      int H, int D, int kv_len, float scale, float ln_eps, float *lse, cudaStream_t st
#define RUN_ARGS                                                                            \
  q, k, v, o, q_prep, k_prep, ln_q_w, ln_q_b, ln_k_w, ln_k_b, cos_t, sin_t, rope_start,     \
      rope_rows, B, S, H, D, kv_len, scale, ln_eps, lse, st

// B11 at head dim D on the DC-column body
template <int DC>
int run_layout_fwd(int bshd, RUN_PARAMS) {
  const Layout L = make_layout(S, H, D, bshd);
  if (q_prep != nullptr) {
    const cudaError_t err =
        launch_prep(q, k, q_prep, k_prep, ln_q_w, ln_q_b, ln_k_w, ln_k_b, cos_t, sin_t,
                    rope_start, rope_rows, B, S, H, D, L, 1.0f, ln_eps, st);
    if (err != cudaSuccess) return (int)err;
    q = q_prep;
    k = k_prep;
  }
  return launch_fwd<DC>(mha_fwd_layout_kernel<DC>, q, k, v, o, lse, L, B, S, H, D, kv_len,
                        scale * LOG2E, st);
}

// B1 / B7's forward at head dim D on the DC-column body
template <int DC>
int run_flat_fwd(RUN_PARAMS) {
  const Layout L = make_layout(S, H, D, 1);
  if (ln_q_w == nullptr && cos_t == nullptr)
    return launch_fwd<DC>(flash_fwd_kernel<DC, true>, q, k, v, o, lse, L, B, S, H, D, kv_len,
                          scale * LOG2E, st);
  if (q_prep == nullptr || k_prep == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      launch_prep(q, k, q_prep, k_prep, ln_q_w, ln_q_b, ln_k_w, ln_k_b, cos_t, sin_t, rope_start,
                  rope_rows, B, S, H, D, L, scale * LOG2E, ln_eps, st);
  if (err != cudaSuccess) return (int)err;
  return launch_fwd<DC>(flash_fwd_kernel<DC, false>, q_prep, k_prep, v, o, lse, L, B, S, H, D,
                        kv_len, 1.0f, st);
}

bool head_dim_ok(int D) { return D >= 8 && D <= 256 && D % 8 == 0; }

}  // namespace

// B1 / B7 forward.  q, k, v, o: [B, S, H*D] bf16, contiguous, D % 8 == 0,
// 8 <= D <= 256.  ln_*: [D] fp32 or all null (no QK LayerNorm).
// cos_t/sin_t: [rope_rows, D] fp32 or null (no RoPE).  q_prep, k_prep:
// scratch of q's shape, required when there is LN or RoPE, else unused (may
// be null).  lse: [B, H, S] fp32 or null.  Returns the cudaError_t of the
// launches.
extern "C" int bya_flash_attention_flat(const void* q, const void* k, const void* v, void* o,
                                        void* q_prep, void* k_prep, const float* ln_q_w,
                                        const float* ln_q_b, const float* ln_k_w,
                                        const float* ln_k_b, const float* cos_t,
                                        const float* sin_t, int rope_start, int rope_rows,
                                        int B, int S, int H, int D, int kv_len, float scale,
                                        float ln_eps, float* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  const int dc = body_of(D);  // the head's body (D checked)
  if (dc == 64) return run_flat_fwd<64>(RUN_ARGS);
  if (dc == 128) return run_flat_fwd<128>(RUN_ARGS);
  return run_flat_fwd<256>(RUN_ARGS);
}

// B11.  q, k, v, o: [B, H, S, D] (bshd = 0) or [B, S, H, D] (bshd = 1) bf16,
// contiguous, D % 8 == 0, 8 <= D <= 256.  q_prep/k_prep: scratch of q's
// shape, or null when there is neither LN nor RoPE.  ln_*: [D] fp32 or all
// null.  cos_t/sin_t: [rope_rows, D] fp32 or null.  lse: [B, H, S] fp32 or
// null.  Returns the cudaError_t of the launches.
extern "C" int bya_flash_layout_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* q_prep, void* k_prep, const float* ln_q_w,
                                    const float* ln_q_b, const float* ln_k_w,
                                    const float* ln_k_b, const float* cos_t, const float* sin_t,
                                    int rope_start, int rope_rows, int B, int S, int H, int D,
                                    int bshd, int kv_len, float scale, float ln_eps, float* lse,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  const int dc = body_of(D);  // the head's body (D checked)
  if (dc == 64) return run_layout_fwd<64>(bshd, RUN_ARGS);
  if (dc == 128) return run_layout_fwd<128>(bshd, RUN_ARGS);
  return run_layout_fwd<256>(bshd, RUN_ARGS);
}
