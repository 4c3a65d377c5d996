// Long-query / short-KV cross-attention: kernels B2, B3, B14, B2c and B2h,
// one body templated on its width (64, 128 or 256 columns), the mode and
// the key block:
//
//   per identity:  o[g, i, ., h] = softmax_k(q . k_i^T * scale) . v_i
//   combined:      o[g, ., h]    = sum_i w[g, ., i] * softmax_k(q . k_i^T * scale) . v_i
//
// with one softmax per identity i over its K tokens.  q-major q is
// [G, Sq, H, D], the flat [G, Sq, H*D] projection layout; head-major q is
// [G, H, Sq, D].  k, v: [G, I, H, K, D]; w: [G, Sq, I].
//
//   B3  (combined, q-major) replaces the TPU kernel `_kernel_flat`
//       (bindyouravatar_tpu/ops/short_kv_attention.py), reached through
//       `short_kv_attention_combined_flat` from the audio cross-attention
//       (the DiT's own head split: 48 x 64 at the 5B, 24 x 128, 96 x 32,
//       192 x 16 or 12 x 256 at other splits; K = `context_tokens`).  Its
//       own instances (`short_kv_kernel<D, KB>`) at every body, so device
//       time groups by kernel name; at D = 128 it is the same function as
//       B14's combined q-major instance, compiled again under B3's name.
//   B2  (per identity, q-major) replaces `_kernel` with `combine=False`,
//       reached through `short_kv_attention_flat` from the perceiver face
//       injection (K = `lfe_num_tokens`): q read in the to_q projection's
//       flat layout and each identity's output written [B, I, Sq, H*D], the
//       layout the routing combine reads, with no head-major transposes.
//   B14 (q-major, both modes) replaces `_kernel_qmajor`
//       (`short_kv_attention_qmajor`, `short_kv_attention_combined_qmajor`).
//   B2c (combined, head-major) replaces `_kernel` with `combine=True`
//       (`short_kv_attention_combined`), and B2h (per identity, head-major)
//       runs `_kernel(combine=False)` in JAX's own layout
//       (`short_kv_attention`: [G, H, Sq, D] -> [G, I, H, Sq, D]).
// Each has its own kernel name (B2 and B3 keep theirs, B14/B2c/B2h are the
// instantiations of `skv_layout_kernel`), so device time groups by body.
// The layout lives in the tensor maps only: the body reads and writes
// (column, row, head, batch) boxes, whatever the strides.
//
// Head widths: every D % 8 == 0 up to 256 (JAX's `_call_kernel_flat` takes
// every D whose head pairs fill 128 lanes; its other bodies any D).  A head
// runs on the narrowest body that holds it (`short_kv_body` in the Python
// wrapper is the rule): D <= 64 on the 64-column body, <= 128 on the 128
// one, <= 256 on the 256 one.  Every tensor map's innermost extent is the
// true D, so the boxes' columns past D read as zeros (never the next
// head's), the products over them add nothing, and the output stores clip
// them: no padded copy is made.  A narrow head pays the body's product
// width (D = 16 on the 64 body multiplies four times its useful columns)
// and its per-tile costs, not its bytes.  (Skipping the products past D on
// a run-time D put a branch between each ldmatrix and its mma and made
// B2 and B3 1.7x slower at D = 64 and 128.)  TMA needs 16-byte row
// strides, so D % 8 == 0.
//
// Tokens and identities: any K >= 1 and I >= 1, on a key block `KB` (a
// template parameter; one instantiation per body, mode and key block):
//  * KB = SHIPPED, the shipped configuration (K = 32, I <= 4: `skv_body`):
//    the score fragments hold an identity's 32 keys, the routing weights sit
//    in registers, and a batch's K and V of every identity stay in shared
//    memory.
//  * KB = 16, 32 or 64, every other K and I (`skv_general`), the narrowest
//    that holds K (`key_block`): a batch's keys of every identity laid out
//    as 64-column key blocks (64 / KB identities a block, or past 64 keys
//    one identity's chunk of 64), and each 64-row q tile's scores made a
//    key block at a time by one wgmma product on a consumer warp group,
//    then the softmax of each identity over its own columns; the columns
//    past K are masked (the tensor maps' K extent is the true K, so TMA
//    fills the rows past it with zeros, which would score 0, not -inf).
//    Past 64 keys the softmax goes in two passes: the row maxima and sums
//    over the chunks, then each chunk's P normalised in fp32 and rounded,
//    as the TPU body rounds it.  A batch's K and V stay in shared memory
//    when its blocks fit (two buffers when two fit); else the blocks
//    stream through each group's ring, once a tile.
//  * Combined attention on the 16-key block keeps PR 21's warp body
//    (`skv_warps`: four warps of 16 rows, `mma.sync`, identities one after
//    another): at (K, I) = (16, 2) it measured 0.185 ms against the general
//    body's 0.256 (B3 at [26, 1350, 3072]; H100 80GB HBM3 at 700 W).
// The only bound left on I is the combined mode's weight slices, which
// share a block's shared memory with the rest: a few hundred identities.
//
// Same math and roundings as the TPU bodies: fp32 scores in log2 units
// (q.k * scale * log2 e), one exp2 softmax per identity normalised in fp32
// before p is rounded to bf16, fp32 P.V, the combine an fp32 weighted sum,
// one bf16 store.
//
// What bounds them on the H100: memory.  Per (query row, head) they read 2D
// bytes of q and write 2D (combined) or 2ID bytes (per identity) against
// 4IKD FLOP: at I = 2, K = 32, 64 FLOP/B combined and ~85 FLOP/B per
// identity, far below the ~295 FLOP/B ridge.  At the 5B path B2 moves
// ~144 MB of q and ~288 MB of output per call (~0.13 ms at 3.35 TB/s).
//
// Design: a persistent kernel that keeps the q stream and the output
// stream in flight and never waits on either.
//  * Work: a block keeps one head.  The grid is m blocks per head (as many
//    as fit on the card at once); a head's G x ceil(Sq / 64) q tiles of 64
//    rows are cut into m equal contiguous shares, and share s of every
//    head goes to blocks s H .. s H + H - 1, which start together and so
//    read and write the heads of the same rows side by side (in the
//    q-major layout those are neighbours in memory; B3 0.250 ms with each
//    block's share taken from one list of all heads' tiles, 0.212 so).  A
//    block loads its head's K and V (I x 2 x K x D) once per batch g, by
//    TMA (two K/V buffers at D = 64, so the next batch's load overlaps the
//    last tiles of this one; one at D = 128 and 256).
//  * One producer warp keeps a ring of q tiles in flight by TMA with
//    mbarriers (3 at D = 64, 4 at D = 128, 2 at D = 256; rows past Sq are
//    zero-filled by the copy).  In combined mode the tile's [64, I] slice
//    of w comes with it: the producer's 32 lanes load it while the tile's
//    copy is in flight and store it into the ring slot before the producer
//    next waits (a wait first could deadlock: with one K/V buffer the
//    consumers free it only after the tile that needs this slice).  A TMA
//    box must start on a 16-byte boundary, and the slice starts at
//    (g Sq + q0) I elements, which at Sq = 1,350 is not one for odd g.
//    Loaded by each consumer thread for its own rows instead, the weights'
//    latency stood in the way of every tile (B3 0.212 ms, 0.178 with
//    constant weights; times here are kernel records on an H100 80GB HBM3
//    at 700 W).
//  * Four consumer warps take 16 rows each.  A warp copies its q fragments
//    into registers and frees the ring slot at once, then per identity
//    computes the [16, 32] scores (mma.sync: at 64-85 FLOP/B the tensor
//    cores are idle either way) and the softmax with ex2.approx into P as
//    bf16 A fragments, and P . V_i one 64-column panel at a time, each
//    panel stored as it is made (per identity) or added with the weight to
//    the row's fp32 sum (combined).  The combined 256 body makes every
//    identity's P first (8 registers an identity), then each panel summed
//    over the identities: a thread holds one panel's sum, not the row's
//    128 floats, which beside the q fragments' 64 would not fit.  A wgmma form of this body (one warp
//    group a block, the scores of two identities per m64n64k16 product)
//    was slower at D = 64 (B3 0.292 against 0.238 ms): the block's only
//    consumers then wait on each product in turn, where four independent
//    warps overlap one another's latencies.
//  * The output leaves through shared memory: each warp writes a [16, 64]
//    bf16 panel into its own staging buffers (two, in the 128-byte swizzle)
//    and one lane stores it by TMA (rows >= Sq and columns >= D are
//    clipped), so a panel's store overlaps the next panel's math; a buffer
//    is rewritten only after the store that read it has left shared
//    memory.  No barrier spans warps except the ring's and the K/V
//    buffers' mbarriers.
//  * The general body (`skv_general`) redesigns the consumers for wgmma:
//    three consumer warp groups at D = 64 (two at 128, one at 256), each
//    taking every third (second) q tile of the block's share with a
//    producer warp of its own (its q stages, its w slices, its ring of
//    streamed key blocks); a block's share is cut from every head's tiles
//    in (head, batch, tile) order, one block an SM.  Per tile and key
//    block: S = Q K^T as one [64, 64] product (Q and K in shared memory),
//    each identity's softmax over its columns, P in registers as the A
//    operand of each identity's P V (V read transposed), a 64-column panel
//    at a time: stored as it is made (per identity), or added with the
//    identity's weight to the tile's fp32 sum (combined: the TPU body's
//    order; folding w into P before the bf16 rounding, one product for
//    every identity, measured past phase 2's tolerance).  The producer
//    issues a tile's q copy and its w slice (a bulk copy from the 16-byte
//    boundary before it, on the stage's barrier) before it waits on any
//    K/V buffer (a streamed block of this tile can only be freed by the
//    group that holds this tile); every group walks every tile of the
//    share and frees each resident buffer once, so a group with no tile in
//    a batch still counts on that batch's barrier; each warp stores its
//    own 16 rows of a panel, as in the shipped body.
// Shared memory is dynamic (`SkvSmem`); the launcher raises each kernel's
// limit to the configuration's bytes.  At D = 256 and I = 4 (the shipped
// body) a block takes 2 q stages of 32 KB, the staging buffers (16 KB), the
// barriers and w ring (~1 KB), then one K/V buffer of 4 identities x 2 x 32
// x 256 bf16 (128 KB): 216,064 bytes of the 232,448 a block may have; a
// third q stage would take 248,832.
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace bya;

constexpr int BM = 64;   // q rows per tile (16 per consumer warp)
constexpr int KT = 32;   // the shipped body's key block: K = 32 tokens an identity
constexpr int MAX_ID = 4;  // and at most 4 identities (its weights' registers)
constexpr int KC = 64;   // the general body's widest key block: keys an identity in registers
constexpr int SHIPPED = 0;  // the key-block template value of the shipped body
constexpr int NCW = 4;   // consumer warps
constexpr int NTHREADS = (NCW + 1) * 32;
constexpr int NSB = 2;   // staging buffers per consumer warp
constexpr int PANEL_ROWS = 16;
constexpr int OUT_PANEL = PANEL_ROWS * 128;  // bytes of one [16, 64] bf16 panel
constexpr int KV_PANEL = KT * 128;           // bytes of one identity's [32, 64] K or V panel

// Shared memory of one block, from a 1024-aligned base: the q ring, the
// consumers' staging buffers, the barriers (at most 16: 2 NST + 2 K/V
// buffers' worth) and the ring of routing-weight slices (combined), then
// the K/V buffers.  The shipped body: at I = 2, 74 KB at D = 64
// (three blocks an SM), 114 KB at D = 128 (one; four q stages in one
// block measured faster than three in each of two) and 150 KB at D = 256.
template <int D>
struct SkvSmem {
  static constexpr int NP = D / 64;                        // 64-column panels
  static constexpr int NST = D == 64 ? 3 : D == 128 ? 4 : 2;  // q ring stages
  static constexpr int KVB = D == 64 ? 2 : 1;              // K/V buffers
  static constexpr int Q_TILE = BM * D * 2;     // bytes of a q tile
  static constexpr int Q_OFF = 0;
  static constexpr int OUT_OFF = Q_OFF + NST * Q_TILE;
  static constexpr int BAR_OFF = OUT_OFF + NCW * NSB * OUT_PANEL;
  static constexpr int W_OFF = BAR_OFF + 128;   // [NST][BM][I] bf16, combined only
  // the K/V buffers start at the next 1024 bytes past the w ring
  __host__ __device__ static constexpr int kv_off(int I, bool combine) {
    return (W_OFF + (combine ? NST * BM * I * 2 : 0) + 1023) / 1024 * 1024;
  }
  // one K/V buffer: K as [I][NP][32][64], then V the same
  __host__ __device__ static constexpr int kv_buffer(int I) { return 2 * I * NP * KV_PANEL; }
  // + 1024 for the base alignment
  static constexpr int bytes(int I, bool combine) {
    return kv_off(I, combine) + KVB * kv_buffer(I) + 1024;
  }
};
static_assert(SkvSmem<64>::bytes(MAX_ID, true) <= 232448, "the 64 body past a block's smem");
static_assert(SkvSmem<128>::bytes(MAX_ID, true) <= 232448, "the 128 body past a block's smem");
static_assert(SkvSmem<256>::bytes(MAX_ID, true) <= 232448, "the 256 body past a block's smem");

// The (batch, first row) of position j of a head's tile list (j = g tiles
// + q0 / BM), advanced without divisions.
struct TileCursor {
  int q0, g;
  __device__ __forceinline__ void seek(long long j, int tiles) {
    g = (int)(j / tiles);
    q0 = (int)(j - (long long)g * tiles) * BM;
  }
  __device__ __forceinline__ void next(int Sq) {
    q0 += BM;
    if (q0 >= Sq) {
      q0 = 0;
      ++g;
    }
  }
};

// Wait until all but the newest N bulk groups of this thread have read
// their shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read_but() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// c = a * b (m16n8k16, bf16 x bf16 -> fp32) from a zero accumulator, which
// costs no instructions to clear
__device__ __forceinline__ void mma_bf16_first(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled
// panel of 128-byte rows.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// P = softmax(Q K^T * scale) of one identity over its 32 keys (ks: its K
// as NP [32, 64] swizzled panels), normalised in fp32 and then rounded: the
// bf16 A fragments of keys 0..15 and 16..31 of this warp's 16 rows.  In
// log2 units, 2^(s sl - max(s) sl), the scale folded into one FMA.
template <int KS>
__device__ __forceinline__ void skv_probs(const uint32_t (&qf)[KS][4], const unsigned char* ks,
                                          float scale_log2, int lane, uint32_t (&pa)[2][4]) {
  // S = Q K^T: [16, 32] as 4 column blocks of 8 keys
  float s[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int r = nt * 8 + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      const int cc = kk * 2 + (lane >> 3);
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3, ks + (cc >> 3) * KV_PANEL + swz(r, cc & 7));
      if (kk == 0)
        mma_bf16_first(s[nt], qf[0], b0, b1);
      else
        mma_bf16(s[nt], qf[kk], b0, b1);
      mma_bf16(s[nt], qf[kk + 1], b2, b3);
    }
  }
  // the softmax over the 32 keys of each row (4 lanes hold a row)
  float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
  const float m0 = mx0 * scale_log2, m1 = mx1 * scale_log2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    s[nt][0] = fast_exp2(fmaf(s[nt][0], scale_log2, -m0));
    s[nt][1] = fast_exp2(fmaf(s[nt][1], scale_log2, -m0));
    s[nt][2] = fast_exp2(fmaf(s[nt][2], scale_log2, -m1));
    s[nt][3] = fast_exp2(fmaf(s[nt][3], scale_log2, -m1));
    sum0 += s[nt][0] + s[nt][1];
    sum1 += s[nt][2] + s[nt][3];
  }
  sum0 += __shfl_xor_sync(FULL, sum0, 1);
  sum0 += __shfl_xor_sync(FULL, sum0, 2);
  sum1 += __shfl_xor_sync(FULL, sum1, 1);
  sum1 += __shfl_xor_sync(FULL, sum1, 2);
  const float inv0 = __fdividef(1.f, sum0), inv1 = __fdividef(1.f, sum1);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0);
    pa[kk][1] = pack_bf16(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1);
  }
}

// One 64-column panel of O = P V as fp32 fragments (vs: that panel of V,
// [32, 64] swizzled; pa: skv_probs' P).
__device__ __forceinline__ void skv_pv(const uint32_t (&pa)[2][4], const unsigned char* vs,
                                       int lane, float (&o)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int r = kk * 16 + (lane & 15), c = j + (lane >> 4);
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, vs + swz(r, c));
      if (kk == 0) {
        mma_bf16_first(o[j], pa[0], b0, b1);
        mma_bf16_first(o[j + 1], pa[0], b2, b3);
      } else {
        mma_bf16(o[j], pa[1], b0, b1);
        mma_bf16(o[j + 1], pa[1], b2, b3);
      }
    }
  }
}

// ------------------------------------ the warp body (combined, key block 16)

// S = Q K^T of one chunk of an identity's keys, raw (unscaled) fp32 as
// [16, KB] fragments (column block nt: keys 8 nt ..).  `ks`: the chunk's K,
// NP panels `pstride` bytes apart of KR >= kc swizzled rows.  The 16-key
// blocks past the chunk's kc keys are skipped and every column past kc is
// MASKED (the tensor map's rows past K read as zeros, which would score 0).
template <int KS, int KB>
__device__ __forceinline__ void skv_scores(const uint32_t (&qf)[KS][4], const unsigned char* ks,
                                           int pstride, int kc, int lane, float (&s)[KB / 8][4]) {
  const int nkb = (kc + 15) >> 4;
#pragma unroll
  for (int kb = 0; kb < KB / 16; ++kb) {
    if (kb < nkb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kb + half, r = nt * 8 + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          const int cc = kk * 2 + (lane >> 3);
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(b0, b1, b2, b3, ks + (cc >> 3) * pstride + swz(r, cc & 7));
          if (kk == 0)
            mma_bf16_first(s[nt], qf[0], b0, b1);
          else
            mma_bf16(s[nt], qf[kk], b0, b1);
          mma_bf16(s[nt], qf[kk + 1], b2, b3);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * kb + half, col = nt * 8 + 2 * (lane & 3);
      if (col >= kc) s[nt][0] = s[nt][2] = MASKED;
      if (col + 1 >= kc) s[nt][1] = s[nt][3] = MASKED;
    }
  }
}

// The raw row maxima of rows rl and rl + 8 (4 lanes hold a row).
template <int KB>
__device__ __forceinline__ void skv_row_max(const float (&s)[KB / 8][4], float& mx0, float& mx1) {
  mx0 = mx1 = MASKED;
#pragma unroll
  for (int nt = 0; nt < KB / 8; ++nt) {
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
}

// s <- 2^(s sl - m) in place over the chunk's kc keys (0 past them); this
// lane's share of each row's sum is added to sum0 / sum1.
template <int KB>
__device__ __forceinline__ void skv_exp(float (&s)[KB / 8][4], int kc, float scale_log2, float m0,
                                        float m1, float& sum0, float& sum1) {
  const int nkb = (kc + 15) >> 4;
#pragma unroll
  for (int nt = 0; nt < KB / 8; ++nt) {
    if (nt / 2 < nkb) {
      s[nt][0] = fast_exp2(fmaf(s[nt][0], scale_log2, -m0));
      s[nt][1] = fast_exp2(fmaf(s[nt][1], scale_log2, -m0));
      s[nt][2] = fast_exp2(fmaf(s[nt][2], scale_log2, -m1));
      s[nt][3] = fast_exp2(fmaf(s[nt][3], scale_log2, -m1));
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    } else {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// P = s * inv rounded to bf16 A fragments (16-key block kb: column blocks
// 2 kb, 2 kb + 1).
template <int KB>
__device__ __forceinline__ void skv_to_a(const float (&s)[KB / 8][4], float inv0, float inv1,
                                         uint32_t (&pa)[KB / 16][4]) {
#pragma unroll
  for (int kb = 0; kb < KB / 16; ++kb) {
    pa[kb][0] = pack_bf16(s[2 * kb][0] * inv0, s[2 * kb][1] * inv0);
    pa[kb][1] = pack_bf16(s[2 * kb][2] * inv1, s[2 * kb][3] * inv1);
    pa[kb][2] = pack_bf16(s[2 * kb + 1][0] * inv0, s[2 * kb + 1][1] * inv0);
    pa[kb][3] = pack_bf16(s[2 * kb + 1][2] * inv1, s[2 * kb + 1][3] * inv1);
  }
}

// o += P V over one 64-column panel of the chunk's V (vs: [KR, 64]
// swizzled), the 16-key blocks past kc skipped.
template <int KB>
__device__ __forceinline__ void skv_pv_add(const uint32_t (&pa)[KB / 16][4],
                                           const unsigned char* vs, int kc, int lane,
                                           float (&o)[8][4]) {
  const int nkb = (kc + 15) >> 4;
#pragma unroll
  for (int kb = 0; kb < KB / 16; ++kb) {
    if (kb < nkb) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int r = kb * 16 + (lane & 15), c = j + (lane >> 4);
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vs + swz(r, c));
        mma_bf16(o[j], pa[kb], b0, b1);
        mma_bf16(o[j + 1], pa[kb], b2, b3);
      }
    }
  }
}

// The general body's layout of the K/V buffers, set by the host per launch.
struct WarpGeo {
  int C;         // chunks of at most KB keys an identity: ceil(K / KB), 1 unless KB = KC
  int KR;        // shared-memory rows a chunk takes: K rounded up to 16 (C == 1), else KB
  int RI;        // rows an identity takes in a buffer: C KR (resident), KR (streamed)
  int resident;  // 1: a batch's K and V of every identity in one buffer; 0: chunks stream
  int NKV;       // K/V buffers (<= 4: the barriers' room)
  int kv_off;    // byte offset of the first buffer (1024-aligned)
  int buf;       // bytes of one buffer
};

// The warp body: combined attention on the 16-key block (any I; K <= 16),
// where it measured faster than `skv_general` (B3 at (K, I) = (16, 2)).
// The pipeline of `skv_body`, four consumer warps of 16 rows; the K/V
// buffers hold either every identity's keys of a batch (geo.resident) or
// one identity's each, streamed in the order the consumers read them: per
// output panel, per identity.
template <int D, bool COMBINE, int KB>
__device__ __forceinline__ void skv_warps(unsigned char* smem_raw, const CUtensorMap* tq,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const CUtensorMap* to, const bf16* __restrict__ w,
                                            int Sq, int I, int H, int tiles, long long total,
                                            float scale_log2, int K, const WarpGeo& geo) {
  using SM = SkvSmem<D>;
  constexpr int NP = SM::NP, NST = SM::NST, KS = D / 16;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem + SM::Q_OFF;                     // [NST][NP][BM][64], swizzled
  unsigned char* sOut = smem + SM::OUT_OFF;                 // [NCW][NSB][16][64], swizzled
  unsigned char* sKV = smem + geo.kv_off;                   // [NKV] K/V buffers
  bf16* sW = reinterpret_cast<bf16*>(smem + SM::W_OFF);     // [NST][BM][I]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* kv_full = empty + NST;
  uint64_t* kv_empty = kv_full + geo.NKV;
  const int NKV = geo.NKV, C = KB == KC ? geo.C : 1, KR = geo.KR, buf_bytes = geo.buf;
  const bool resident = geo.resident != 0;
  // a buffer: per identity its K as NP panels of RI rows, then its V so
  const int pstride = geo.RI * 128, vstride = NP * pstride, id_bytes = 2 * vstride;
  const int passes = C == 1 ? 1 : 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = (int)(blockIdx.x % H), m = (int)(gridDim.x / H), share = (int)(blockIdx.x / H);
  const long long t_begin = total * share / m, t_end = total * (share + 1) / m;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], COMBINE ? 2 : 1);  // the q copy, and the w slice
      mbar_init(&empty[s], NCW);
    }
    for (int b = 0; b < NKV; ++b) {
      mbar_init(&kv_full[b], 1);
      mbar_init(&kv_empty[b], NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == NCW) {  // producer
    TileCursor c;
    c.seek(t_begin, tiles);
    long long n_kv = 0;
    // the next K/V buffer, once the consumers have freed it: `bytes` on
    // its way
    auto next_buffer = [&](int bytes) {
      const int b = (int)(n_kv % NKV);
      if (n_kv >= NKV) mbar_wait(&kv_empty[b], (int)((n_kv / NKV - 1) & 1));
      mbar_expect_tx(&kv_full[b], bytes);
      ++n_kv;
      return b;
    };
    // chunk ch of identity i (rows 64 ch .., KR of them) into `dst`
    auto load_chunk = [&](unsigned char* dst, int i, int ch, uint64_t* bar) {
      for (int p = 0; p < NP; ++p) {
        tma_load_4d(dst + p * pstride, tk, 64 * p, KB * ch, h, c.g * I + i, bar);
        tma_load_4d(dst + vstride + p * pstride, tv, 64 * p, KB * ch, h, c.g * I + i, bar);
      }
    };
    int n = 0;
    for (long long t = t_begin; t < t_end; ++t, ++n, c.next(Sq)) {
      const int st = n % NST;
      if (n >= NST) mbar_wait(&empty[st], (n / NST - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[st], SM::Q_TILE);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sQ + st * SM::Q_TILE + p * BM * 128, tq, 64 * p, c.q0, h, c.g, &full[st]);
      }
      if constexpr (COMBINE) {
        // the tile's [64, I] slice of w (zeros past Sq), in before any K/V
        // wait: a streamed chunk of this tile is freed only by consumers
        // that hold this tile
        unsigned short* dst = reinterpret_cast<unsigned short*>(sW + st * BM * I);
        const unsigned short* src = reinterpret_cast<const unsigned short*>(w) +
                                    ((long long)c.g * Sq + c.q0) * I;
        const int valid = min(BM, Sq - c.q0) * I;
        for (int e = lane; e < BM * I; e += 32) dst[e] = e < valid ? src[e] : 0;
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[st]);
      }
      if (lane == 0) {
        if (resident) {
          if (t == t_begin || c.q0 == 0) {  // a new batch: every identity's K and V
            const int b = next_buffer(I * id_bytes);
            for (int i = 0; i < I; ++i)
              for (int ch = 0; ch < C; ++ch)
                load_chunk(sKV + b * buf_bytes + i * id_bytes + ch * KR * 128, i, ch, &kv_full[b]);
          }
        } else {
          for (int p = 0; p < NP; ++p)
            for (int i = 0; i < I; ++i)
              for (int pass = 0; pass < passes; ++pass)
                for (int ch = 0; ch < C; ++ch) {
                  const int b = next_buffer(id_bytes);
                  load_chunk(sKV + b * buf_bytes, i, ch, &kv_full[b]);
                }
        }
      }
      __syncwarp();
    }
    return;
  }

  // consumer warp `warp`: rows 16 warp .. 16 warp + 15 of each tile; this
  // lane's fragment rows are rl and rl + 8
  const int rl = warp * 16 + (lane >> 2);
  TileCursor cur, nxt;
  nxt.seek(t_begin, tiles);
  long long n_kv = 0;
  const unsigned char* batch_kv = sKV;  // resident: this batch's buffer
  int n = 0, sb = 0;
  for (long long t = t_begin; t < t_end; ++t, ++n) {
    cur = nxt;
    nxt.next(Sq);
    const int q0 = cur.q0, g = cur.g;
    if (resident && (t == t_begin || q0 == 0)) {  // a new batch: free the last one's
      if (n_kv > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&kv_empty[(n_kv - 1) % NKV]);
      }
      mbar_wait(&kv_full[n_kv % NKV], (int)((n_kv / NKV) & 1));
      batch_kv = sKV + (n_kv % NKV) * buf_bytes;
      ++n_kv;
    }
    const int st = n % NST;
    mbar_wait(&full[st], (n / NST) & 1);
    uint32_t qf[KS][4];
    {
      const unsigned char* qt = sQ + st * SM::Q_TILE;
      const int r = warp * 16 + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int cc = kk * 2 + (lane >> 4);
        ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                    qt + (cc >> 3) * BM * 128 + swz(r, cc & 7));
      }
    }
    if constexpr (!COMBINE) {  // per identity the slot is free: q lives in registers
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    const bf16* ws = sW + st * BM * I;
    const int row0 = q0 + warp * 16;
    const bool live = row0 < Sq;  // a ragged last tile may leave this warp no row

    // chunk ch of identity i: its K (its V at + vstride), from the batch's
    // buffer or the next streamed one, which `done` frees
    auto take = [&](int i, int ch) -> const unsigned char* {
      if (resident) return batch_kv + i * id_bytes + ch * KR * 128;
      const int b = (int)(n_kv % NKV);
      mbar_wait(&kv_full[b], (int)((n_kv / NKV) & 1));
      return sKV + b * buf_bytes;
    };
    auto done = [&]() {
      if (resident) return;
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[n_kv % NKV]);
      ++n_kv;
    };
    auto store_panel = [&](const float* a, int p, int b_out) {
      if (lane == 0) bulk_wait_read_but<NSB - 1>();
      __syncwarp();
      unsigned char* buf = sOut + (warp * NSB + sb) * OUT_PANEL;
      const int r = lane >> 2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(buf + swz(r, j) + (lane & 3) * 4) =
            pack_bf16(a[4 * j], a[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(buf + swz(r + 8, j) + (lane & 3) * 4) =
            pack_bf16(a[4 * j + 2], a[4 * j + 3]);
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) tma_store_4d(to, buf, 64 * p, row0, h, b_out);
      sb = (sb + 1) % NSB;
    };

    // per output panel, per identity: its chunks' scores, once for the row
    // maxima and sums (C > 1: pass 1), then for P and P V (one chunk: both
    // from the same scores); one copy of the math for every case
    const int steps = C == 1 ? 1 : 2 * C;
    for (int p = 0; p < NP; ++p) {
      float acc[8][4];  // combined: the panel's weighted sum, set by identity 0
      for (int i = 0; i < I; ++i) {
        float o[8][4] = {};
        float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f, inv0 = 0.f, inv1 = 0.f;
        for (int step = 0; step < steps; ++step) {
          const bool stats = C == 1 || step < C;  // this step's scores set m and l
          const int ch = step < C ? step : step - C;
          const unsigned char* ks = take(i, ch);
          if (live) {
            const int kc = min(KB, K - KB * ch);
            float s[KB / 8][4];
            skv_scores<KS, KB>(qf, ks, pstride, kc, lane, s);
            float e0 = 0.f, e1 = 0.f;  // this chunk's share of the sums
            if (stats) {
              float mx0, mx1;
              skv_row_max<KB>(s, mx0, mx1);
              const float n0 = fmaxf(m0, mx0 * scale_log2), n1 = fmaxf(m1, mx1 * scale_log2);
              l0 *= fast_exp2(m0 - n0);
              l1 *= fast_exp2(m1 - n1);
              m0 = n0;
              m1 = n1;
            }
            skv_exp<KB>(s, kc, scale_log2, m0, m1, e0, e1);
            if (stats) {
              l0 += e0;
              l1 += e1;
              if (step == (C == 1 ? 0 : C - 1)) {  // the sums are whole
                inv0 = __fdividef(1.f, quad_sum(l0));
                inv1 = __fdividef(1.f, quad_sum(l1));
              }
            }
            if (C == 1 || step >= C) {
              uint32_t pa[KB / 16][4];
              skv_to_a<KB>(s, inv0, inv1, pa);
              skv_pv_add<KB>(pa, ks + vstride + p * pstride, kc, lane, o);
            }
          }
          done();
        }
        if (!live) continue;
        if constexpr (COMBINE) {
          const float w0 = __bfloat162float(ws[rl * I + i]);
          const float w1 = __bfloat162float(ws[(rl + 8) * I + i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[j][0] = (i == 0 ? 0.f : acc[j][0]) + w0 * o[j][0];
            acc[j][1] = (i == 0 ? 0.f : acc[j][1]) + w0 * o[j][1];
            acc[j][2] = (i == 0 ? 0.f : acc[j][2]) + w1 * o[j][2];
            acc[j][3] = (i == 0 ? 0.f : acc[j][3]) + w1 * o[j][3];
          }
        } else {
          store_panel(&o[0][0], p, g * I + i);
        }
      }
      if constexpr (COMBINE) {
        if (live) store_panel(&acc[0][0], p, g);
      }
    }
    if constexpr (COMBINE) {  // the w slice has been read: the slot is free
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }
  if (lane == 0) bulk_wait_all();  // the stores have left before the block ends
}

// ------------------------------------ the general body (key block KB = 16, 32, 64)

constexpr int GEN_PANEL = BM * 128;           // bytes of a [64, 64] bf16 panel
constexpr int GEN_MAX_ST = 4, GEN_MAX_KV = 4;  // q stages a group; K/V buffers or ring slots
constexpr int GEN_BARS = 2 * (GEN_MAX_ST + GEN_MAX_KV);  // a group's barriers

template <int D>
struct Gen {
  static constexpr int NP = D / 64;
  // consumer warp groups a block, each with a producer warp: three at D =
  // 64 (the 136 registers of 480 threads hold them), two at 128, one at
  // 256, whose q tiles (32 KB) and key blocks (64 KB) leave a block's
  // shared memory room for one group's stages
  static constexpr int NWG = D == 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int THREADS = NWG * 160;
  static constexpr int Q_TILE = NP * GEN_PANEL;     // bytes of a q stage
  static constexpr int BLOCK = 2 * NP * GEN_PANEL;  // a 64-key block: K's panels, then V's
};

// A stage's routing-weight slice of the general body: the tile's [64, I]
// elements from the 16-byte boundary at or before its first (a bulk copy
// starts and ends on one), so up to 14 more.
__host__ __device__ constexpr int w_slot(int I) { return BM * I + 16; }

// The general body's plan for one launch, set by the host (`general_geo`).
struct SkvGeo {
  int C;         // 64-key chunks of an identity: ceil(K / 64) on the 64-key block, else 1
  int NB;        // 64-column key blocks of a batch: ceil(I / (64 / KB)), or I C
  int resident;  // 1: a batch's key blocks stay in a buffer; 0: they stream per q tile
  int NKV;       // resident buffers, or each group's ring slots
  int NST;       // q stages of each group
  int out_off;   // byte offsets: the staging panels (NSB a consumer warp),
  int w_off;     // the routing weights' ring (combined: W_SLOT(I) elements a stage),
  int kv_off;    // the K/V buffers or rings (1024-aligned)
  WarpGeo warp;  // the warp body's plan (combined, KB = 16)
};

template <int D, bool COMBINE>
__device__ __forceinline__ void skv_body(unsigned char* smem_raw, const CUtensorMap* tq,
                                         const CUtensorMap* tk, const CUtensorMap* tv,
                                         const CUtensorMap* to, const bf16* __restrict__ w,
                                         int Sq, int I, int H, int tiles, long long total,
                                         float scale_log2) {
  using SM = SkvSmem<D>;
  constexpr int NP = SM::NP, NST = SM::NST, KVB = SM::KVB, KS = D / 16;  // KS: k steps of 16
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem + SM::Q_OFF;                     // [NST][NP][BM][64], swizzled
  unsigned char* sOut = smem + SM::OUT_OFF;                 // [NCW][NSB][16][64], swizzled
  unsigned char* sKV = smem + SM::kv_off(I, COMBINE);       // [KVB] K/V buffers
  bf16* sW = reinterpret_cast<bf16*>(smem + SM::W_OFF);     // [NST][BM][I]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* kv_full = empty + NST;
  uint64_t* kv_empty = kv_full + KVB;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this block's head and its share of that head's G * tiles tiles (the
  // grid is a multiple of H: the blocks of one share run the heads of the
  // same rows side by side)
  const int h = (int)(blockIdx.x % H), m = (int)(gridDim.x / H), share = (int)(blockIdx.x / H);
  const long long t_begin = total * share / m, t_end = total * (share + 1) / m;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], COMBINE ? 2 : 1);  // the q copy, and the w slice
      mbar_init(&empty[s], NCW);
    }
    for (int b = 0; b < KVB; ++b) {
      mbar_init(&kv_full[b], 1);
      mbar_init(&kv_empty[b], NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == NCW) {  // producer: one lane issues the copies; in combined
                      // mode the warp also copies each tile's w slice
    // w[g, q0 .. q0 + 63, :] (zeros past Sq): element lane + 32 k of the
    // slice, loaded while the tile's copy is in flight and stored into the
    // ring at the top of the next iteration
    unsigned short wr[2 * MAX_ID] = {};
    auto load_w = [&](const TileCursor& c) {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(w) +
                                  ((long long)c.g * Sq + c.q0) * I;
#pragma unroll
      for (int k = 0; k < 2 * MAX_ID; ++k) {
        const int e = lane + 32 * k;
        wr[k] = k < 2 * I && c.q0 + e / I < Sq ? src[e] : 0;
      }
    };
    auto store_w = [&](int st) {
      unsigned short* dst = reinterpret_cast<unsigned short*>(sW + st * BM * I);
#pragma unroll
      for (int k = 0; k < 2 * MAX_ID; ++k)
        if (k < 2 * I) dst[lane + 32 * k] = wr[k];
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[st]);
    };
    TileCursor c;
    c.seek(t_begin, tiles);
    int n_kv = 0, n = 0;
    for (long long t = t_begin; t < t_end; ++t, ++n, c.next(Sq)) {
      // the last tile's w slice goes in before any wait: the consumers free
      // a K/V buffer only once they have finished that tile, which needs it
      if (COMBINE && n > 0) store_w((n - 1) % NST);
      if (lane == 0 && (t == t_begin || c.q0 == 0)) {  // a new batch: this head's K, V
        const int b = n_kv % KVB;
        if (n_kv >= KVB) mbar_wait(&kv_empty[b], (n_kv / KVB - 1) & 1);
        mbar_expect_tx(&kv_full[b], SM::kv_buffer(I));
        unsigned char* kb = sKV + b * SM::kv_buffer(I);
        for (int i = 0; i < I; ++i)
          for (int p = 0; p < NP; ++p) {
            tma_load_4d(kb + (i * NP + p) * KV_PANEL, tk, 64 * p, 0, h, c.g * I + i,
                        &kv_full[b]);
            tma_load_4d(kb + ((I + i) * NP + p) * KV_PANEL, tv, 64 * p, 0, h, c.g * I + i,
                        &kv_full[b]);
          }
        ++n_kv;
      }
      const int st = n % NST;
      if (n >= NST) mbar_wait(&empty[st], (n / NST - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[st], SM::Q_TILE);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sQ + st * SM::Q_TILE + p * BM * 128, tq, 64 * p, c.q0, h, c.g, &full[st]);
      }
      if constexpr (COMBINE) load_w(c);  // stored into the ring next iteration
    }
    if (COMBINE && n > 0) store_w((n - 1) % NST);
    return;
  }

  // consumer warp `warp`: rows 16 warp .. 16 warp + 15 of each tile; this
  // lane's fragment rows are rl and rl + 8
  const int rl = warp * 16 + (lane >> 2);
  TileCursor cur, nxt;
  nxt.seek(t_begin, tiles);
  int n_kv = 0, n = 0, sb = 0;
  for (long long t = t_begin; t < t_end; ++t, ++n) {
    cur = nxt;
    nxt.next(Sq);
    const int q0 = cur.q0, g = cur.g;
    if (t == t_begin || q0 == 0) {  // a new batch: free the last one's K/V buffer
      if (n_kv > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&kv_empty[(n_kv - 1) % KVB]);
      }
      mbar_wait(&kv_full[n_kv % KVB], (n_kv / KVB) & 1);
      ++n_kv;
    }
    const unsigned char* kb = sKV + ((n_kv - 1) % KVB) * SM::kv_buffer(I);
    const int st = n % NST;
    mbar_wait(&full[st], (n / NST) & 1);

    // q fragments (A of m16n8k16, k = 16 kk ..) of this warp's 16 rows
    uint32_t qf[KS][4];
    {
      const unsigned char* qt = sQ + st * SM::Q_TILE;
      const int r = warp * 16 + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int cc = kk * 2 + (lane >> 4);
        ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                    qt + (cc >> 3) * BM * 128 + swz(r, cc & 7));
      }
    }
    // combined: the routing weights of rows rl, rl + 8 (registers: read by
    // a select on the identity or an unrolled loop, never by a runtime index)
    float wv[MAX_ID][2] = {};
    if constexpr (COMBINE) {
      const bf16* ws = sW + st * BM * I;
#pragma unroll
      for (int i = 0; i < MAX_ID; ++i)
        if (i < I) {
          wv[i][0] = __bfloat162float(ws[rl * I + i]);
          wv[i][1] = __bfloat162float(ws[(rl + 8) * I + i]);
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the slot is free: q and w live in registers
    const int row0 = q0 + warp * 16;
    if (row0 >= Sq) continue;                // a ragged last tile: no row of this warp

    // one [16, 64] panel of output from fp32 fragments a (8 column blocks
    // of 4), through the warp's next staging buffer
    auto store_panel = [&](const float* a, int p, int b_out) {
      if (lane == 0) bulk_wait_read_but<NSB - 1>();
      __syncwarp();
      unsigned char* buf = sOut + (warp * NSB + sb) * OUT_PANEL;
      const int r = lane >> 2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(buf + swz(r, j) + (lane & 3) * 4) =
            pack_bf16(a[4 * j], a[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(buf + swz(r + 8, j) + (lane & 3) * 4) =
            pack_bf16(a[4 * j + 2], a[4 * j + 3]);
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) tma_store_4d(to, buf, 64 * p, row0, h, b_out);
      sb = (sb + 1) % NSB;
    };

    if constexpr (COMBINE && D == 256) {
      // every identity's P first (8 registers an identity), then the output
      // one 64-column panel at a time, the identities summed with the
      // weights in fp32: a thread holds one panel's sum, not the row's 128
      // floats (which would not fit beside the q fragments' 64).  The
      // other bodies keep the identity-outer loop below: this order spilled
      // on the 64 body (44 bytes at its 128 registers).
      uint32_t pa[MAX_ID][2][4];
#pragma unroll
      for (int i = 0; i < MAX_ID; ++i)
        if (i < I) skv_probs<KS>(qf, kb + i * NP * KV_PANEL, scale_log2, lane, pa[i]);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < MAX_ID; ++i) {
          if (i >= I) continue;
          float o[8][4];
          skv_pv(pa[i], kb + ((I + i) * NP + p) * KV_PANEL, lane, o);
          const float w0 = wv[i][0], w1 = wv[i][1];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[j][0] = (i == 0 ? 0.f : acc[j][0]) + w0 * o[j][0];
            acc[j][1] = (i == 0 ? 0.f : acc[j][1]) + w0 * o[j][1];
            acc[j][2] = (i == 0 ? 0.f : acc[j][2]) + w1 * o[j][2];
            acc[j][3] = (i == 0 ? 0.f : acc[j][3]) + w1 * o[j][3];
          }
        }
        store_panel(&acc[0][0], p, g);
      }
    } else {
      // per identity: its P, then its output panels, each stored as it is
      // made (per identity) or added with its weight to the row's fp32 sum
      // (combined: D / 2 floats a thread)
      float acc[COMBINE ? D / 8 : 1][4];  // the weighted sum, set by identity 0
      for (int i = 0; i < I; ++i) {
        uint32_t pa[2][4];
        skv_probs<KS>(qf, kb + i * NP * KV_PANEL, scale_log2, lane, pa);
        float w0 = 0.f, w1 = 0.f;
        if constexpr (COMBINE) {
          w0 = wv[0][0];
          w1 = wv[0][1];
#pragma unroll
          for (int c = 1; c < MAX_ID; ++c)
            if (i == c) {
              w0 = wv[c][0];
              w1 = wv[c][1];
            }
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          float o[8][4];
          skv_pv(pa, kb + ((I + i) * NP + p) * KV_PANEL, lane, o);
          if constexpr (COMBINE) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float* a = acc[p * 8 + j];
              if (i == 0) {
                a[0] = w0 * o[j][0];
                a[1] = w0 * o[j][1];
                a[2] = w1 * o[j][2];
                a[3] = w1 * o[j][3];
              } else {
                a[0] += w0 * o[j][0];
                a[1] += w0 * o[j][1];
                a[2] += w1 * o[j][2];
                a[3] += w1 * o[j][3];
              }
            }
          } else {
            store_panel(&o[0][0], p, g * I + i);
          }
        }
      }
      if constexpr (COMBINE) {
#pragma unroll
        for (int p = 0; p < NP; ++p) store_panel(&acc[p * 8][0], p, g);
      }
    }
  }
  if (lane == 0) bulk_wait_all();  // the stores have left before the block ends
}

// Any K and I: K <= KB, or any K in chunks of 64 when KB = KC.  A batch's
// keys, every identity's, are laid out as 64-column key blocks (`Gen::
// BLOCK`): 64 / KB identities a block at KB rows each, or one 64-key chunk
// of one identity.  Each consumer warp group takes a 64-row q tile and
// makes its [64, 64] scores a key block at a time with one wgmma product
// (Q and K in shared memory), then the softmax of each identity over its
// columns, normalised in fp32; P, rounded to bf16, stays in registers as
// the A operand of each identity's P V (V read transposed through its
// descriptor), one 64-column panel at a time: stored as it is made (per
// identity) or added with the identity's weight to the tile's fp32 sum
// (combined).  Past 64 keys an identity's chunks go twice: its row maxima
// and sums, then P.
template <int D, bool COMBINE, int KB>
__device__ __forceinline__ void skv_general(unsigned char* smem_raw, const CUtensorMap* tq,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const CUtensorMap* to, const bf16* __restrict__ w,
                                            int Sq, int I, int H, int tiles, long long total,
                                            float scale_log2, int K, const SkvGeo& geo) {
  using GN = Gen<D>;
  constexpr int NP = GN::NP, NWG = GN::NWG, BLOCK = GN::BLOCK;
  constexpr int IPB = KB == KC ? 1 : 64 / KB;  // identities a key block
  constexpr int NCB = KB / 8;                  // 8-column score blocks an identity
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31;
  // warps 0 .. 4 NWG - 1: the consumer groups (group tid / 128); then one
  // producer warp a group
  const bool producer = tid >= 128 * NWG;
  const int grp = producer ? (tid - 128 * NWG) >> 5 : tid >> 7;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = bars + grp * GEN_BARS;  // the group's q stages
  uint64_t* empty = full + GEN_MAX_ST;
  uint64_t* ring_full = empty + GEN_MAX_ST;  // its streamed key blocks
  uint64_t* ring_empty = ring_full + GEN_MAX_KV;
  uint64_t* kv_full = bars + NWG * GEN_BARS;  // the resident buffers, shared
  uint64_t* kv_empty = kv_full + GEN_MAX_KV;
  const int NST = geo.NST, NKV = geo.NKV, NB = geo.NB, C = KB == KC ? geo.C : 1;
  const bool resident = geo.resident != 0;
  const int buf_bytes = NB * BLOCK;  // a resident buffer
  unsigned char* sQ = smem + 1024 + grp * NST * GN::Q_TILE;
  // each consumer warp's staging panels, NSB of [16, 64]
  unsigned char* sOut = smem + geo.out_off + (grp * 4 + ((tid >> 5) & 3)) * NSB * OUT_PANEL;
  bf16* sW = reinterpret_cast<bf16*>(smem + geo.w_off) + grp * NST * w_slot(I);
  unsigned char* sKV = smem + geo.kv_off;
  unsigned char* ring = sKV + grp * NKV * BLOCK;
  // the block's share of every head's tiles, in (head, batch, tile) order
  const long long all = total * H;
  const long long j_begin = all * blockIdx.x / gridDim.x;
  const long long j_end = all * (blockIdx.x + 1) / gridDim.x;
  if (tid == 0) {
    for (int g = 0; g < NWG; ++g) {
      uint64_t* b = bars + g * GEN_BARS;
      for (int s = 0; s < GEN_MAX_ST; ++s) {
        mbar_init(&b[s], COMBINE ? 2 : 1);  // the q copy, and the w slice
        mbar_init(&b[GEN_MAX_ST + s], 4);   // the group's warps
      }
      for (int s = 0; s < GEN_MAX_KV; ++s) {
        mbar_init(&b[2 * GEN_MAX_ST + s], 1);
        mbar_init(&b[2 * GEN_MAX_ST + GEN_MAX_KV + s], 4);
      }
    }
    for (int s = 0; s < GEN_MAX_KV; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 4 * NWG);  // every consumer warp
    }
    mbar_init_fence();
  }
  // zeros where no identity is loaded (the last block's slots past I), so
  // that P V multiplies their p = 0 by finite values
  {
    const int bytes = resident ? NKV * buf_bytes : NWG * NKV * BLOCK;
    for (int i = tid * 16; i < bytes; i += GN::THREADS * 16)
      *reinterpret_cast<uint4*>(sKV + i) = make_uint4(0u, 0u, 0u, 0u);
    fence_async_shared();
  }
  __syncthreads();

  // position j of the share: head h, batch g, first row q0
  auto decode = [&](long long j, int& h, int& g, int& q0) {
    h = (int)(j / total);
    const long long r = j - (long long)h * total;
    g = (int)(r / tiles);
    q0 = (int)(r - (long long)g * tiles) * BM;
  };
  // the streamed key blocks of a tile, in the order the consumers take them
  const int seq = C == 1 ? NB : 2 * I * C;
  auto block_of = [&](int e) { return C == 1 ? e : (e / (2 * C)) * C + e % C; };

  if (producer) {  // lane 0 issues the copies; in combined mode the warp copies w
    // key block b of batch g, head h, into dst: its identities' K and V
    // (KB rows each), or identity b / C's chunk b % C
    auto load_block = [&](unsigned char* dst, int b, int h, int g, uint64_t* bar) {
      if (C == 1) {
        for (int s = 0; s < IPB && b * IPB + s < I; ++s)
          for (int p = 0; p < NP; ++p) {
            tma_load_4d(dst + p * GEN_PANEL + s * KB * 128, tk, 64 * p, 0, h,
                        g * I + b * IPB + s, bar);
            tma_load_4d(dst + (NP + p) * GEN_PANEL + s * KB * 128, tv, 64 * p, 0, h,
                        g * I + b * IPB + s, bar);
          }
      } else {
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(dst + p * GEN_PANEL, tk, 64 * p, KC * (b % C), h, g * I + b / C, bar);
          tma_load_4d(dst + (NP + p) * GEN_PANEL, tv, 64 * p, KC * (b % C), h, g * I + b / C,
                      bar);
        }
      }
    };
    auto block_bytes = [&](int b) {
      return (C == 1 ? min(IPB, I - b * IPB) : 1) * 2 * NP * KB * 128;
    };
    long long kv_n = 0, ring_n = 0, prev = -1;
    int n = 0;  // the group's tiles so far
    for (long long j = j_begin, i = 0; j < j_end; ++j, ++i) {
      int h, g, q0;
      decode(j, h, g, q0);
      const long long key = j / tiles;  // (head, batch)
      if (resident && grp == 0 && key != prev) {  // a new batch: every identity's K and V
        if (lane == 0) {
          const int b = (int)(kv_n % NKV);
          if (kv_n >= NKV) mbar_wait(&kv_empty[b], (int)((kv_n / NKV - 1) & 1));
          mbar_expect_tx(&kv_full[b], I * C * 2 * NP * KB * 128);
          for (int blk = 0; blk < NB; ++blk)
            load_block(sKV + b * buf_bytes + blk * BLOCK, blk, h, g, &kv_full[b]);
        }
        ++kv_n;
      }
      prev = key;
      if ((int)(i % NWG) != grp) continue;
      const int st = n % NST;
      if (n >= NST) mbar_wait(&empty[st], (n / NST - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[st], GN::Q_TILE);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sQ + st * GN::Q_TILE + p * GEN_PANEL, tq, 64 * p, q0, h, g, &full[st]);
      }
      if constexpr (COMBINE) {
        // the tile's [64, I] slice of w (its rows < Sq), in before any K/V
        // wait: a streamed block of this tile is freed only by the group
        // that holds this tile.  Its start, (g Sq + q0) I elements, is not
        // 16-byte aligned at odd g and Sq = 1,350, so the bulk copy takes it
        // from the boundary before (the consumers read it at that offset)
        // to the one after its end, on the stage's barrier; where that end
        // would pass the tensor's (its last tile), the warp copies it.
        // (Copied by the warp's loads every tile, its latency held each
        // tile back.)
        bf16* dst = sW + st * w_slot(I);
        const long long e0 = ((long long)g * Sq + q0) * I, a0 = e0 & ~7LL;
        const long long e1 = e0 + (long long)min(BM, Sq - q0) * I, a1 = (e1 + 7) & ~7LL;
        if (a1 <= total / tiles * Sq * I) {
          if (lane == 0) {
            mbar_expect_tx(&full[st], (uint32_t)((a1 - a0) * 2));
            bulk_load(dst, w + a0, (uint32_t)((a1 - a0) * 2), &full[st]);
          }
        } else {
          for (long long e = a0 + lane; e < e1; e += 32) dst[e - a0] = w[e];
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[st]);
        }
      }
      if (!resident && lane == 0)
        for (int e = 0; e < seq; ++e, ++ring_n) {
          const int s = (int)(ring_n % NKV), b = block_of(e);
          if (ring_n >= NKV) mbar_wait(&ring_empty[s], (int)((ring_n / NKV - 1) & 1));
          mbar_expect_tx(&ring_full[s], block_bytes(b));
          load_block(ring + s * BLOCK, b, h, g, &ring_full[s]);
        }
      __syncwarp();
      ++n;
    }
    return;
  }

  // consumer group grp: warp wq of the group holds tile rows 16 wq + lane / 4
  // and + 8 (the wgmma accumulator layout)
  const int tw = tid & 127, wq = tw >> 5, t4 = lane & 3;
  const int rows[2] = {16 * wq + (lane >> 2), 16 * wq + (lane >> 2) + 8};
  long long kv_n = 0, ring_n = 0, prev = -1;
  const unsigned char* batch_kv = sKV;  // resident: this batch's buffer
  int n = 0, sb = 0;
  for (long long j = j_begin, i = 0; j < j_end; ++j, ++i) {
    int h, g, q0;
    decode(j, h, g, q0);
    const long long key = j / tiles;
    if (resident && key != prev) {  // a new batch: free the last one's buffer
      if (kv_n > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&kv_empty[(kv_n - 1) % NKV]);
      }
      mbar_wait(&kv_full[kv_n % NKV], (int)((kv_n / NKV) & 1));
      batch_kv = sKV + (kv_n % NKV) * buf_bytes;
      ++kv_n;
    }
    prev = key;
    if ((int)(i % NWG) != grp) continue;  // the other group's tile
    const int st = n % NST;
    mbar_wait(&full[st], (n / NST) & 1);
    const unsigned char* qs = sQ + st * GN::Q_TILE;
    const bf16* ws = sW + st * w_slot(I) + (((long long)g * Sq + q0) * I & 7);

    // key block b (streamed: the tile's next block), and its release
    auto take = [&](int b) -> const unsigned char* {
      if (resident) return batch_kv + b * BLOCK;
      mbar_wait(&ring_full[ring_n % NKV], (int)((ring_n / NKV) & 1));
      return ring + (ring_n % NKV) * BLOCK;
    };
    auto done = [&]() {
      if (resident) return;
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring_empty[ring_n % NKV]);
      ++ring_n;
    };
    // S = Q K^T of a key block: raw fp32 scores, column c of the block in
    // s[c / 8][..]
    // (the descriptors made once and moved by constant offsets: their low
    // 14 bits are the tile's shared-memory address / 16, every address
    // below 2^18)
    const uint64_t dq = desc_kmajor(qs);
    auto scores = [&](float (&s)[8][4], const unsigned char* kb) {
      const uint64_t dk = desc_kmajor(kb);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ofs = ((kk / 4) * GEN_PANEL + (kk % 4) * 32) / 16;
        wgmma_ss<0, 0>(&s[0][0], dq + ofs, dk + ofs, kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(&s[0][0]);
    };
    // o: combined, the tile's weighted sum; per identity past 64 keys, the
    // identity's output over its chunks
    float o[NP * 8][4];
    auto zero_o = [&]() {
#pragma unroll
      for (int c = 0; c < NP * 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
    };
    // op = P V over k steps [k0, k1) of the block's 64 keys, V's panel p
    auto pv_panel = [&](float (&op)[8][4], const uint32_t (&pa)[4][4], const unsigned char* kb,
                        int k0, int k1, int p) {
#pragma unroll
      for (int c = 0; c < 8; ++c) op[c][0] = op[c][1] = op[c][2] = op[c][3] = 0.f;
      const uint64_t dv = desc_mnmajor(kb + (NP + p) * GEN_PANEL);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk >= k0 && kk < k1) wgmma_rs<1>(&op[0][0], pa[kk], dv + kk * (16 * 128 / 16));
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(&op[0][0]);
    };
    // the warp's 16 rows of a [64, 64] output panel from fp32 accumulators
    // a (8 column blocks of 4), through the warp's next staging panel,
    // stored by TMA (rows >= Sq and columns >= D clipped); no barrier
    // spans warps, as in the shipped body
    auto store_panel = [&](const float* a, int p, int b_out) {
      if (lane == 0) bulk_wait_read_but<NSB - 1>();
      __syncwarp();  // the staging panel's last store has read it
      unsigned char* sp = sOut + sb * OUT_PANEL;
      const int r = lane >> 2;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<uint32_t*>(sp + swz(r, c) + t4 * 4) = pack_bf16(a[4 * c], a[4 * c + 1]);
        *reinterpret_cast<uint32_t*>(sp + swz(r + 8, c) + t4 * 4) =
            pack_bf16(a[4 * c + 2], a[4 * c + 3]);
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) tma_store_4d(to, sp, 64 * p, q0 + 16 * wq, h, b_out);
      sb = (sb + 1) % NSB;
    };
    // identity i's routing weight of this thread's rows (1 per identity)
    auto weight = [&](int i, int r) {
      return COMBINE ? __bfloat162float(ws[rows[r] * I + i]) : 1.f;
    };
    auto quad_max = [](float v) {
      v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
      return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
    };
    auto quad_add = [](float v) {
      v += __shfl_xor_sync(FULL, v, 1);
      return v + __shfl_xor_sync(FULL, v, 2);
    };

    // identity id's P V over k steps [k0, k1), a panel at a time: stored
    // (per identity), or added with its weight to o in fp32 (combined)
    auto attend = [&](const uint32_t (&pa)[4][4], const unsigned char* kb, int k0, int k1,
                      int id) {
      float w2[2] = {1.f, 1.f};
      if constexpr (COMBINE) w2[0] = weight(id, 0), w2[1] = weight(id, 1);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float op[8][4];
        pv_panel(op, pa, kb, k0, k1, p);
        if constexpr (COMBINE) {
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[p * 8 + c][e] += w2[e >> 1] * op[c][e];
        } else {
          store_panel(&op[0][0], p, g * I + id);
        }
      }
    };
    if (COMBINE) zero_o();
    if (C == 1) {
      // every identity's K within one block: the softmax of each identity
      // over its columns, normalised in fp32 (a slot past I: p = 0)
      auto softmax_block = [&](float (&s)[8][4], int b, auto masked) {
#pragma unroll
        for (int sl = 0; sl < IPB; ++sl) {
          const int id = b * IPB + sl;
          if (id >= I) {
#pragma unroll
            for (int c = 0; c < NCB; ++c)
              s[sl * NCB + c][0] = s[sl * NCB + c][1] = s[sl * NCB + c][2] =
                  s[sl * NCB + c][3] = 0.f;
            continue;
          }
          float mx[2] = {MASKED, MASKED}, sum[2] = {0.f, 0.f};
#pragma unroll
          for (int c = 0; c < NCB; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& x = s[sl * NCB + c][e];
              if constexpr (decltype(masked)::value)
                if (8 * c + 2 * t4 + (e & 1) >= K) x = MASKED;  // past the identity's K keys
              mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]) * scale_log2;
#pragma unroll
          for (int c = 0; c < NCB; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& x = s[sl * NCB + c][e];
              x = fast_exp2(fmaf(x, scale_log2, -mx[e >> 1]));
              sum[e >> 1] += x;
            }
          const float f[2] = {__fdividef(1.f, quad_add(sum[0])), __fdividef(1.f, quad_add(sum[1]))};
#pragma unroll
          for (int c = 0; c < NCB; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[sl * NCB + c][e] *= f[e >> 1];
        }
      };
      for (int b = 0; b < NB; ++b) {
        const unsigned char* kb = take(b);
        float s[8][4];
        scores(s, kb);
        if (K < KB)  // a separate copy: at K = KB no column is masked
          softmax_block(s, b, std::true_type());
        else
          softmax_block(s, b, std::false_type());
        uint32_t pa[4][4];
        acc_to_a_frags<4>(pa, s);
#pragma unroll
        for (int sl = 0; sl < IPB; ++sl) {
          if (b * IPB + sl >= I) break;
          attend(pa, kb, sl * (KB / 16), (sl + 1) * (KB / 16), b * IPB + sl);
        }
        done();
      }
    } else {
      // an identity's K in C chunks of 64: its row maxima and sums over the
      // chunks, then P normalised in fp32 before it is rounded (combined: then
      // weighted)
      for (int id = 0; id < I; ++id) {
        float mx[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
        for (int c = 0; c < 2 * C; ++c) {
          const int chunk = c % C;
          const unsigned char* kb = take(id * C + chunk);
          float s[8][4];
          scores(s, kb);
          if (KC * chunk + KC > K) {
#pragma unroll
            for (int cc = 0; cc < 8; ++cc)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (KC * chunk + 8 * cc + 2 * t4 + (e & 1) >= K) s[cc][e] = MASKED;
          }
          if (c < C) {  // the statistics
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float x = mx[r];
#pragma unroll
              for (int cc = 0; cc < 8; ++cc) x = fmaxf(x, fmaxf(s[cc][2 * r], s[cc][2 * r + 1]));
              x = quad_max(x);
              float e = 0.f;
#pragma unroll
              for (int cc = 0; cc < 8; ++cc)
                e += fast_exp2(fmaf(s[cc][2 * r], scale_log2, -x * scale_log2)) +
                     fast_exp2(fmaf(s[cc][2 * r + 1], scale_log2, -x * scale_log2));
              l[r] = l[r] * fast_exp2((mx[r] - x) * scale_log2) + e;
              mx[r] = x;
            }
            if (c == C - 1) {
              if (!COMBINE) zero_o();
#pragma unroll
              for (int r = 0; r < 2; ++r) l[r] = __fdividef(1.f, quad_add(l[r]));
            }
          } else {  // P = 2^(s sl - max sl) / sum, then P V
#pragma unroll
            for (int cc = 0; cc < 8; ++cc)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[cc][e] = fast_exp2(fmaf(s[cc][e], scale_log2, -mx[e >> 1] * scale_log2)) *
                           l[e >> 1];
            uint32_t pa[4][4];
            acc_to_a_frags<4>(pa, s);
            if constexpr (COMBINE) {
              attend(pa, kb, 0, 4, id);  // each chunk's P V, weighted, into the sum
            } else {
              wg_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int p = 0; p < NP; ++p)
                  wgmma_rs<1>(&o[p * 8][0], pa[kk],
                              desc_mnmajor(kb + (NP + p) * GEN_PANEL + kk * 16 * 128));
              wg_commit();
              wg_wait<0>();
              fence_regs<NP * 32>(&o[0][0]);
            }
          }
          done();
        }
        if constexpr (!COMBINE) {
#pragma unroll
          for (int p = 0; p < NP; ++p) store_panel(&o[p * 8][0], p, g * I + id);
        }
      }
    }
    if constexpr (COMBINE) {
#pragma unroll
      for (int p = 0; p < NP; ++p) store_panel(&o[p * 8][0], p, g);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the tile's q and w slice have been read
    ++n;
  }
  if (lane == 0) bulk_wait_all();  // the stores have left before the block ends
}

#define SKV_PARAMS                                                                        \
  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,         \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,     \
      const bf16* __restrict__ w, int Sq, int I, int H, int tiles, long long total,       \
      float scale_log2, int K, const __grid_constant__ SkvGeo geo
// KB = SHIPPED: the shipped body (K = 32, I <= 4); KB = 16, 32, 64: the
// general one on that key block (combined at 16: the warp body)
#define SKV_ARGS(D, COMBINE, KB)                                                          \
  extern __shared__ unsigned char smem_raw[];                                             \
  if constexpr (KB == SHIPPED)                                                            \
    skv_body<D, COMBINE>(smem_raw, &tq, &tk, &tv, &to, w, Sq, I, H, tiles, total,         \
                         scale_log2);                                                     \
  else if constexpr (warp_body(COMBINE, KB))                                              \
    skv_warps<D, COMBINE, KB>(smem_raw, &tq, &tk, &tv, &to, w, Sq, I, H, tiles, total,    \
                              scale_log2, K, geo.warp);                                   \
  else                                                                                    \
    skv_general<D, COMBINE, KB>(smem_raw, &tq, &tk, &tv, &to, w, Sq, I, H, tiles, total,  \
                                scale_log2, K, geo)

// combined attention on the 16-key block runs the warp body
__host__ __device__ constexpr bool warp_body(bool combine, int KB) { return combine && KB == 16; }

// blocks an SM the compiler should leave registers for: the shipped body
// as shared memory allows at I = 2, the warp body three at D = 64; the
// general one's shared memory holds one block an SM
template <int D, bool COMBINE, int KB>
constexpr int min_blocks() {
  return D == 64 && (KB == SHIPPED || warp_body(COMBINE, KB)) ? 3 : 1;
}

// threads a block: the shipped and warp bodies' four consumer warps and
// producer; the general one's consumer warp groups, a producer warp each
template <int D, bool COMBINE, int KB>
constexpr int skv_threads() {
  return KB == SHIPPED || warp_body(COMBINE, KB) ? NTHREADS : Gen<D>::THREADS;
}

// B3
template <int D, int KB>
__global__ void __launch_bounds__(skv_threads<D, true, KB>(), min_blocks<D, true, KB>())
    short_kv_kernel(SKV_PARAMS) {
  SKV_ARGS(D, true, KB);
}

// B2
template <int D, int KB>
__global__ void __launch_bounds__(skv_threads<D, false, KB>(), min_blocks<D, false, KB>())
    short_kv_attend_kernel(SKV_PARAMS) {
  SKV_ARGS(D, false, KB);
}

// B14 (QMAJOR), B2c (COMBINE, head-major), B2h (head-major per identity):
// QMAJOR changes only the host's tensor maps; it keeps the shipped body's
// instances apart by name (the general ones share the QMAJOR = false
// instance)
template <int D, bool COMBINE, bool QMAJOR, int KB>
__global__ void __launch_bounds__(skv_threads<D, COMBINE, KB>(), min_blocks<D, COMBINE, KB>())
    skv_layout_kernel(SKV_PARAMS) {
  SKV_ARGS(D, COMBINE, KB);
}

// The general body's key block for K tokens: the narrowest of 16, 32 and
// 64 that holds them, 64 (in chunks) past 64.
inline int key_block(int K) { return K <= 16 ? 16 : K <= 32 ? 32 : KC; }

// The general body's shared memory for K tokens and I identities: the
// barriers' kilobyte, each group's q stages, staging panels and (combined)
// w ring, then the K/V buffers.  A batch's key blocks stay resident when a
// buffer fits beside two q stages a group (two buffers when they fit, so
// the next batch's load overlaps this one's last tiles), else they stream
// through each group's ring of blocks, once a tile; the rest goes to q
// stages (at most 4 a group).  False when not even one streamed block fits
// (the weights' slices of some hundreds of identities).
template <int D>
bool general_geo(int K, int I, bool combine, SkvGeo& geo) {
  using GN = Gen<D>;
  if (I > (1 << 16)) return false;
  const int kb = key_block(K);
  geo.C = kb == KC ? (K + KC - 1) / KC : 1;
  geo.NB = geo.C == 1 ? (I + 64 / kb - 1) / (64 / kb) : I * geo.C;
  const long long room = 232448 - 1024;  // past the base's alignment
  // the bytes of a plan of `nst` q stages and `kv` bytes of K/V buffers
  auto plan = [&](int nst, long long kv) {
    geo.NST = nst;
    geo.out_off = 1024 + GN::NWG * nst * GN::Q_TILE;
    geo.w_off = geo.out_off + GN::NWG * 4 * NSB * OUT_PANEL;
    geo.kv_off = (geo.w_off + (combine ? GN::NWG * nst * w_slot(I) * 2 : 0) + 1023) / 1024 * 1024;
    return geo.kv_off + kv;
  };
  const long long batch = (long long)geo.NB * GN::BLOCK;
  for (int nkv = 2; nkv >= 1; --nkv)
    for (int nst = GEN_MAX_ST; nst >= 2; --nst)
      if (plan(nst, nkv * batch) <= room) {
        geo.resident = 1;
        geo.NKV = nkv;
        return true;
      }
  geo.resident = 0;
  for (int nst = 2; nst >= 1; --nst)
    for (int nkv = GEN_MAX_KV; nkv >= 1; --nkv)
      if (plan(nst, (long long)GN::NWG * nkv * GN::BLOCK) <= room) {
        geo.NKV = nkv;
        return true;
      }
  return false;
}

// The warp body's K/V buffers for K tokens and I identities: every
// identity's chunks of a batch in one buffer when they fit beside the q
// ring, the staging buffers and the w ring (two such buffers when one is
// at most 16 KB, so the next batch's load overlaps this one's last tiles)
// and, on the 64 body, still leave an SM room for two blocks; else one
// chunk a buffer, as many buffers as fit, up to 4.  False when not even
// one chunk fits (the weights' slices of some hundreds of identities).
template <int D>
bool warp_geo(int K, int I, bool combine, WarpGeo& geo) {
  constexpr int NP = D / 64;
  if (I > (1 << 16)) return false;
  const int kb = key_block(K);
  geo.C = (K + kb - 1) / kb;
  geo.KR = geo.C == 1 ? (K + 15) / 16 * 16 : kb;
  geo.kv_off = SkvSmem<D>::kv_off(I, combine);
  const long long room = 232448 - 1024 - geo.kv_off;  // bytes left for the buffers
  const long long batch = 2LL * NP * geo.C * geo.KR * 128 * I;
  // two blocks of the 64 body in an SM's 233,472 bytes, 1 KB reserved each
  const bool two = D > 64 || geo.kv_off + batch + 1024 <= 233472 / 2 - 1024;
  if (batch <= room && two) {
    geo.resident = 1;
    geo.RI = geo.C * geo.KR;
    geo.buf = (int)batch;
    geo.NKV = batch <= 16384 && 2 * batch <= room ? 2 : 1;
  } else {
    geo.resident = 0;
    geo.RI = geo.KR;
    geo.buf = 2 * NP * geo.KR * 128;
    geo.NKV = room < geo.buf ? 0 : (int)(room / geo.buf < 4 ? room / geo.buf : 4);
  }
  return geo.NKV >= 1;
}

// The card's SM count, queried once.
cudaError_t sm_count(int& sms) {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  sms = n;
  return cudaSuccess;
}

// Blocks of KERNEL an SM holds at `smem` dynamic bytes: the kernel's limit
// raised to those bytes first; the query made once per kernel and byte
// count.
template <auto KERNEL>
cudaError_t blocks_per_sm(int smem, int threads, int& n) {
  static int limit = 0, used = 0, keys[32], vals[32];
  for (int j = 0; j < used; ++j)
    if (keys[j] == smem) {
      n = vals[j];
      return cudaSuccess;
    }
  if (smem > limit) {
    const cudaError_t err =
        cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    limit = smem;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, KERNEL, threads, smem);
  if (err == cudaSuccess && used < 32) {
    keys[used] = smem;
    vals[used++] = n;
  }
  return err;
}

// The grid: as many blocks as fit on the card at once, at most one per
// tile: the shipped and warp bodies' a multiple of H (m blocks a head), the
// general body's cut from every head's tiles (its one block an SM would leave a
// multiple of H short of the card: 96 of 132 SMs at 48 heads).  K = 32
// with I <= 4 runs KERNEL<SHIPPED>, every other K and I
// KERNEL<key_block(K)>.  `dh` is the tensors' head width: D, or a multiple
// of 8 below it whose missing columns the tensor maps fill with zeros.
template <template <int> class KERNEL, int D, bool COMBINE>
int launch(bool qmajor, const void* q, const void* k, const void* v, const void* w, void* o,
           int G, int Sq, int I, int H, int K, float scale, void* stream, int dh) {
  if (K < 1 || I < 1 || G < 0 || Sq < 0 || H < 1 || dh < 8 || dh > D || dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (Sq + BM - 1) / BM;
  const long long total = (long long)G * tiles;  // tiles of one head
  if (total == 0) return 0;
  const int kb = K == KT && I <= MAX_ID ? SHIPPED : key_block(K);
  SkvGeo geo{};
  int smem = SkvSmem<D>::bytes(I, COMBINE), rows = KT;
  int threads = NTHREADS;
  const bool warps = warp_body(COMBINE, kb);
  if (warps) {
    if (!warp_geo<D>(K, I, COMBINE, geo.warp)) return (int)cudaErrorInvalidConfiguration;
    smem = geo.warp.kv_off + geo.warp.NKV * geo.warp.buf + 1024;
    rows = geo.warp.KR;
  } else if (kb != SHIPPED) {
    if (!general_geo<D>(K, I, COMBINE, geo)) return (int)cudaErrorInvalidConfiguration;
    smem = geo.kv_off +
           (geo.resident ? geo.NKV * geo.NB : Gen<D>::NWG * geo.NKV) * Gen<D>::BLOCK + 1024;
    rows = kb;
    threads = Gen<D>::THREADS;
  }
  const Layout lq = make_layout(Sq, H, dh, qmajor ? 1 : 0);
  const Layout lkv = make_layout(K, H, dh, 0);
  CUtensorMap tq, tk, tv, to;
  // per identity, o is [G * I] batches of q's layout
  if (!make_map(&tq, q, lq, G, H, Sq, dh, BM) || !make_map(&tk, k, lkv, G * I, H, K, dh, rows) ||
      !make_map(&tv, v, lkv, G * I, H, K, dh, rows) ||
      !make_map(&to, o, lq, COMBINE ? G : G * I, H, Sq, dh, PANEL_ROWS))
    return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(sms);
  if (err == cudaSuccess) {
    switch (kb) {
      case SHIPPED: err = blocks_per_sm<KERNEL<SHIPPED>::fn>(smem, threads, per_sm); break;
      case 16: err = blocks_per_sm<KERNEL<16>::fn>(smem, threads, per_sm); break;
      case 32: err = blocks_per_sm<KERNEL<32>::fn>(smem, threads, per_sm); break;
      default: err = blocks_per_sm<KERNEL<KC>::fn>(smem, threads, per_sm);
    }
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  // the shipped body: blocks per head, as many as fit on the card beside
  // the other heads'
  const long long per_head = (long long)sms * per_sm / H, fit = (long long)sms * per_sm;
  const long long m = per_head < 1 ? 1 : (per_head < total ? per_head : total);
  const unsigned grid =
      (unsigned)(kb == SHIPPED || warps ? m * H : (fit < total * H ? fit : total * H));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* wb = static_cast<const bf16*>(w);
  const float sl = scale * LOG2E;
#define SKV_LAUNCH(KB)                                                                     \
  KERNEL<KB>::fn<<<grid, threads, smem, st>>>(tq, tk, tv, to, wb, Sq, I, H, tiles, total, sl, \
                                              K, geo)
  switch (kb) {
    case SHIPPED: SKV_LAUNCH(SHIPPED); break;
    case 16: SKV_LAUNCH(16); break;
    case 32: SKV_LAUNCH(32); break;
    default: SKV_LAUNCH(KC);
  }
#undef SKV_LAUNCH
  return (int)cudaGetLastError();
}

// The kernels of each entry point by key block (`KERNEL<KB>::fn`)
template <int D>
struct B3Kernels {
  template <int KB>
  struct of {
    static constexpr auto fn = short_kv_kernel<D, KB>;
  };
};
template <int D>
struct B2Kernels {
  template <int KB>
  struct of {
    static constexpr auto fn = short_kv_attend_kernel<D, KB>;
  };
};
// the general key blocks share the QMAJOR = false instance
template <int D, bool COMBINE, bool QMAJOR>
struct LayoutKernels {
  template <int KB>
  struct of {
    static constexpr auto fn = skv_layout_kernel<D, COMBINE, KB == SHIPPED && QMAJOR, KB>;
  };
};

// B3 (q-major combined) at head width dh on the D-column body
template <int D>
int launch_b3(const void* q, const void* k, const void* v, const void* w, void* o, int G,
              int Sq, int I, int H, int K, int dh, float scale, void* stream) {
  return launch<B3Kernels<D>::template of, D, true>(true, q, k, v, w, o, G, Sq, I, H, K, scale,
                                                    stream, dh);
}

// B2 (q-major per identity) at head width dh on the D-column body
template <int D>
int launch_b2(const void* q, const void* k, const void* v, void* o, int G, int Sq, int I, int H,
              int K, int dh, float scale, void* stream) {
  return launch<B2Kernels<D>::template of, D, false>(true, q, k, v, nullptr, o, G, Sq, I, H, K,
                                                     scale, stream, dh);
}

// B14, B2c, B2h (COMBINE, QMAJOR) at head width dh on the D-column body
template <int D, bool COMBINE, bool QMAJOR>
int launch_layout_mode(const void* q, const void* k, const void* v, const void* w, void* o,
                       int G, int Sq, int I, int H, int K, int dh, float scale, void* stream) {
  return launch<LayoutKernels<D, COMBINE, QMAJOR>::template of, D, COMBINE>(
      QMAJOR, q, k, v, w, o, G, Sq, I, H, K, scale, stream, dh);
}

template <int D>
int launch_layout(const void* q, const void* k, const void* v, const void* w, void* o, int G,
                  int Sq, int I, int H, int K, int dh, int qmajor, float scale, void* stream) {
  if (qmajor)
    return w != nullptr
               ? launch_layout_mode<D, true, true>(q, k, v, w, o, G, Sq, I, H, K, dh, scale, stream)
               : launch_layout_mode<D, false, true>(q, k, v, w, o, G, Sq, I, H, K, dh, scale,
                                                    stream);
  return w != nullptr
             ? launch_layout_mode<D, true, false>(q, k, v, w, o, G, Sq, I, H, K, dh, scale, stream)
             : launch_layout_mode<D, false, false>(q, k, v, w, o, G, Sq, I, H, K, dh, scale,
                                                   stream);
}

}  // namespace

// Every entry point takes bf16 tensors, contiguous and 16-byte aligned; D a
// multiple of 8 up to 256 (the narrowest body that holds it runs), any K >=
// 1 tokens an identity and I >= 1 identities.  Each returns the
// cudaError_t of the launch, cudaErrorInvalidValue for a D (or a shape) it
// does not take, or cudaErrorInvalidConfiguration when the combined mode's
// weight slices of I identities leave no room for a K/V buffer.

// B2.  q: [B, Sq, H*D]; k, v: [B, I, H, K, D]; o: [B, I, Sq, H*D].
extern "C" int bya_short_kv_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int I, int H, int K, int D, float scale,
                                      void* stream) {
  switch (bya::body_of(D)) {
    case 64: return launch_b2<64>(q, k, v, o, B, Sq, I, H, K, D, scale, stream);
    case 128: return launch_b2<128>(q, k, v, o, B, Sq, I, H, K, D, scale, stream);
    case 256: return launch_b2<256>(q, k, v, o, B, Sq, I, H, K, D, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// B3.  q, o: [G, Sq, H*D]; k, v: [G, I, H, K, D]; w: [G, Sq, I].
extern "C" int bya_short_kv_attention_combined_flat(const void* q, const void* k,
                                                    const void* v, const void* w, void* o,
                                                    int G, int Sq, int I, int H, int K, int D,
                                                    float scale, void* stream) {
  switch (bya::body_of(D)) {
    case 64: return launch_b3<64>(q, k, v, w, o, G, Sq, I, H, K, D, scale, stream);
    case 128: return launch_b3<128>(q, k, v, w, o, G, Sq, I, H, K, D, scale, stream);
    case 256: return launch_b3<256>(q, k, v, w, o, G, Sq, I, H, K, D, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// B14, B2c, B2h.  q: [G, Sq, H, D] (qmajor = 1) or [G, H, Sq, D]; k, v:
// [G, I, H, K, D]; w: [G, Sq, I] or null (per identity); o: q's layout
// (combined) or [G, I, Sq, H, D] / [G, I, H, Sq, D] (per identity).
extern "C" int bya_short_kv_layout(const void* q, const void* k, const void* v, const void* w,
                                   void* o, int G, int Sq, int I, int H, int K, int D,
                                   int qmajor, float scale, void* stream) {
  switch (bya::body_of(D)) {
    case 64: return launch_layout<64>(q, k, v, w, o, G, Sq, I, H, K, D, qmajor, scale, stream);
    case 128: return launch_layout<128>(q, k, v, w, o, G, Sq, I, H, K, D, qmajor, scale, stream);
    case 256: return launch_layout<256>(q, k, v, w, o, G, Sq, I, H, K, D, qmajor, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}
