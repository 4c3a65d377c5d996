// B5 / B5' and B8 past each long body's cap (`packed_attention.cu`: the
// one-tile and long bodies, the C entry points that dispatch here): the
// streamed bodies, in a source of their own so that nvcc builds them beside
// the rest, with C entry points of their own that the wrapper calls past a
// body's cap.
//   forward (B5, B5'): the one-pass body on the tensor cores
//     (`tiny_seq_stream_fwd_kernel`: wgmma, TMA, an online softmax, an
//     item's K and V read once into shared memory while its q tiles run).
//     What bounds it on the H100: bytes.  Per (item, head) it reads q, k
//     and v and writes o, 8 S dh bytes, against 4 S^2 dh FLOP: at S = 201,
//     100 FLOP/B, under the ~295 FLOP/B ridge, so the card's time is the
//     bytes' (2.641 ms at [5400, 400, 512]).  Its one rounding apart from
//     the long bodies': P is rounded to bf16 before it is divided by the
//     row's sum (the sum divides O in fp32 at the end).
//   backward (B8), two kernels in the long bodies' math and roundings, on
//     `mma.sync` and cp.async: a group of q and g rows, K and V streamed
//     once for each row's max, 1 / sum and delta (saved to `stats`, fp32),
//     then once a panel for dQ = dS K; then a group of k and v rows, q, g
//     and the rows' statistics streamed once a panel for dV = P^T G and
//     dK = dS^T Q.
// No unit shares a sum with another, so the bodies repeat bit for bit.
// Rows past S load as zeros and their key columns are masked (p = 0), so a
// ragged last block, chunk or group adds nothing; rows past S are never
// stored.
#include <type_traits>

#include "hopper.cuh"
#include "packed_attention.cuh"

namespace {

// ---- B8's streamed bodies, S > LONG_MAX_S: fixed shared memory at any S ----
// A block of four warps takes one unit at a time: an item's group of 64
// rows (four 16-row tiles, a tile a warp), held in shared memory, while the
// other side's rows stream through two buffers of CT-tile chunks by
// cp.async (the next chunk in flight while the block computes on the
// current one).  Each warp makes its tile's sums in the long bodies' order
// (16-row kv chunks in order, the same fragments).
template <int DP>
struct Stream {
  static constexpr int LDS = DP + 8, TILE = 16 * LDS;
  static constexpr int WARPS = 4, THREADS = 32 * WARPS;
  static constexpr int GROUP = 16 * WARPS;      // the rows of a unit
  static constexpr int CT = DP == 64 ? 4 : 2;   // the tiles of a streamed chunk
  static constexpr int CHUNK = 16 * CT;
  static constexpr int BUF = 2 * CT * TILE;     // a buffer: two tensors' chunks
  // the backward: two groups, a staging tile a warp, two buffers (+ the
  // dK / dV kernel's rows' statistics, three floats a row, two buffers)
  static constexpr int BWD_SMEM = (3 * WARPS + 2 * 2 * CT) * TILE * (int)sizeof(bf16);
  static constexpr int DKV_SMEM = BWD_SMEM + 2 * 3 * CHUNK * (int)sizeof(float);
};
static_assert(Stream<256>::DKV_SMEM <= SMEM_LIMIT && Stream<128>::DKV_SMEM <= SMEM_LIMIT &&
                  Stream<64>::DKV_SMEM <= SMEM_LIMIT,
              "a streamed body past the smem of a block");

// `n` bf16 elements of shared memory from `sm` to zero (n % 8 == 0), by a block
template <int THREADS>
__device__ __forceinline__ void zero_smem_block(bf16* sm, int n, int tid) {
  for (int i = tid * 8; i < n; i += THREADS * 8)
    *reinterpret_cast<uint4*>(sm + i) = make_uint4(0u, 0u, 0u, 0u);
}

// rows [r0, r0 + n) of an item's [S, H*dh] rows at `src` (row stride `ld`)
// into `n` rows of `dst`, the rows at or past S zero-filled, the chunks
// that hold the head (c < ch) only; by the whole block (no commit)
template <int DP>
__device__ __forceinline__ void load_stream_rows(bf16* dst, const bf16* src, long long ld,
                                                 int r0, int n, int S, int ch, int tid) {
  constexpr int CPR = DP / 8, LDS = DP + 8;
  for (int i = tid; i < n * CPR; i += Stream<DP>::THREADS) {
    const int r = i / CPR, c = i % CPR;
    if (c >= ch) continue;
    const bool ok = r0 + r < S;
    bya::cp_async16(dst + r * LDS + c * 8, src + (ok ? (long long)(r0 + r) * ld + c * 8 : 0),
                    ok ? 16 : 0);
  }
}

// chunks 0 .. n-1 through the two buffers: load(buf, c) issues chunk c's
// copies into buffer buf (no commit), body(buf, c) consumes it; the first
// chunk's group also takes any copies issued before the call
template <class Load, class Body>
__device__ __forceinline__ void stream_chunks(int n, Load load, Body body) {
  load(0, 0);
  bya::cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) load((c + 1) & 1, c + 1);
    bya::cp_async_commit();
    bya::cp_async_wait<1>();
    __syncthreads();
    body(c & 1, c);
    __syncthreads();  // every warp is done with buffer c & 1 before chunk c + 2 refills it
  }
}

// ---- B5 / B5' past each long body's cap: the one-pass forward on wgmma ----
// Two or three consumer warp groups a block (`SFwd::NWG`), each fed by a
// producer warp of its own.  A unit is one 64-row q tile of one item, a
// (row, head) pair (at DP = 256 one half of O's columns of it: the two
// halves compute the same scores, each holds 128 of O's columns); a block
// walks a contiguous share of the units in order, unit n of its share going
// to group n % NWG, so an item's units run side by side.  An item's K and V
// stay in shared memory while its units run (`SFwdGeo::resident`: loaded
// whole by TMA, every byte read from device memory once; two buffers when
// two fit, so the next item's load overlaps this one's last units); past
// what fits, each unit streams the item's 64-key blocks through its
// group's ring.  Per unit: S = Q K^T of each 64-key block (wgmma, both
// operands K-major in shared memory), the online softmax in fp32 (running
// max and sum, O rescaled as the max grows), P rounded to bf16 in registers
// as the A operand of O += P V (V read transposed through its descriptor),
// O divided by the sum in fp32 at the end, written as bf16 over the unit's
// q tile and stored by TMA.  A block's S is made while the last block's
// P V runs, and its softmax while that product finishes (the flash
// forward's order); the last block runs at the width its keys need (16,
// 32, 48 or 64 columns; 64 at DP = 256).  The tensor maps zero-fill rows
// past S; key columns past S are masked by index (a zero key scores 0, not
// -inf); rows past S are not stored.  No unit sums with another: results
// repeat bit for bit.
constexpr int SF_BM = 64;                  // q rows a unit
constexpr int SF_PANEL = 64 * 128;         // bytes of a [64, 64] bf16 panel
constexpr int SF_MAX_ST = 4, SF_MAX_KV = 4;  // q stages a group; K/V buffers or ring slots
constexpr int SF_BARS = 2 * (SF_MAX_ST + SF_MAX_KV);  // a group's barriers
// the barriers of three groups and the resident buffers' fit the first kilobyte
static_assert((3 * SF_BARS + 2 * SF_MAX_KV) * 8 <= 1024, "the forward's barriers");

template <int DP>
struct SFwd {
  static constexpr int NP = DP / 64;                // 64-column panels of q, k and v
  static constexpr int HALVES = DP == 256 ? 2 : 1;  // units a q tile
  static constexpr int NPV = NP / HALVES;           // O's panels a unit
  static constexpr int Q_TILE = NP * SF_PANEL;      // bytes of a q stage
  // keys a score block (128 with two groups measured 1.8x slower at
  // [1001, 49, 2 x 256] and 1.1x at [5400, 400, 512], H100 80GB HBM3)
  static constexpr int BN = 64;
  // consumer warp groups, each with its producer warp: three where O's 32
  // registers a thread leave room (the 136 of 480 threads), else two
  static constexpr int NWG = NPV == 1 ? 3 : 2;
  static constexpr int THREADS = NWG * 160;
  static constexpr int KS = BN / 16;  // k steps of P V
};

// The forward's shared-memory plan for one launch, set by the host.
struct SFwdGeo {
  int T;         // q tiles of an item
  int nkb;       // 64-key blocks of an item
  int rows;      // rows of a K or V panel: S rounded up to 16 (resident), 64 (streamed)
  int box;       // rows of a K / V TMA box: a divisor of `rows`, at most 256
  int resident;  // 1: an item's K and V whole in a buffer; 0: its key blocks stream per unit
  int NKV;       // resident buffers, or each group's ring slots
  int NST;       // q stages of each group
  int kv_off;    // byte offset of the K/V buffers or rings (1024-aligned)
  int buf;       // bytes of a buffer or ring slot: K's panels, then V's, then zeros
  int groups;    // consumer groups that take units (NWG, or 1 where two groups'
                 // rings of streamed blocks would not fit: the other stay idle)
};

template <int DP>
__global__ void __launch_bounds__(SFwd<DP>::THREADS, 1)
tiny_seq_stream_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, long long units, int H, int S,
                           float scale_log2, const __grid_constant__ SFwdGeo geo) {
  using G = SFwd<DP>;
  constexpr int NP = G::NP, HALVES = G::HALVES, NPV = G::NPV, NWG = G::NWG, BN = G::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (bya::smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31;
  // warps 0 .. 4 NWG - 1: the consumer groups (group tid / 128); then
  // their producers, a warp each
  const bool producer = tid >= 128 * NWG;
  const int grp = producer ? (tid - 128 * NWG) >> 5 : tid >> 7;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = bars + grp * SF_BARS;  // the group's q stages
  uint64_t* empty = full + SF_MAX_ST;
  uint64_t* ring_full = empty + SF_MAX_ST;  // its streamed key blocks
  uint64_t* ring_empty = ring_full + SF_MAX_KV;
  uint64_t* kv_full = bars + NWG * SF_BARS;  // the resident buffers, shared
  uint64_t* kv_empty = kv_full + SF_MAX_KV;
  const int NST = geo.NST, NKV = geo.NKV, nkb = geo.nkb, per_item = geo.T * HALVES;
  const int ngrp = geo.groups;
  const bool resident = geo.resident != 0;
  const int kpanel = geo.rows * 128;  // bytes of a K (or V) panel
  const int vpart = NP * kpanel;      // V's panels after K's
  unsigned char* sQ = smem + 1024 + grp * NST * G::Q_TILE;  // [groups][NST] stages
  unsigned char* sKV = smem + geo.kv_off;
  unsigned char* ring = sKV + grp * NKV * geo.buf;
  const long long u_begin = units * blockIdx.x / gridDim.x;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  if (tid == 0) {
    for (int g = 0; g < NWG; ++g) {
      uint64_t* b = bars + g * SF_BARS;
      for (int s = 0; s < SF_MAX_ST; ++s) {
        bya::mbar_init(&b[s], 1);              // the q copy
        bya::mbar_init(&b[SF_MAX_ST + s], 1);  // the O store has read the stage
      }
      for (int s = 0; s < SF_MAX_KV; ++s) {
        bya::mbar_init(&b[2 * SF_MAX_ST + s], 1);              // the block's copy
        bya::mbar_init(&b[2 * SF_MAX_ST + SF_MAX_KV + s], 4);  // the group's warps
      }
    }
    for (int s = 0; s < SF_MAX_KV; ++s) {
      bya::mbar_init(&kv_full[s], 1);
      bya::mbar_init(&kv_empty[s], 4 * NWG);  // every consumer warp
    }
    bya::mbar_init_fence();
  }
  // the rows a resident buffer holds past V's last panel, read (times p =
  // 0) by the last key block's P V: zeros, so they add nothing
  if (resident)
    for (int b = 0; b < NKV; ++b)
      for (int i = 2 * vpart + tid * 16; i < geo.buf; i += G::THREADS * 16)
        *reinterpret_cast<uint4*>(sKV + b * geo.buf + i) = make_uint4(0u, 0u, 0u, 0u);
  bya::fence_async_shared();  // the zeros, visible to wgmma
  __syncthreads();
  if (grp >= ngrp) return;  // an idle group (streamed at DP = 256: one group)

  if (producer) {  // lane 0 issues every copy of its group (producer 0 also the buffers')
    if (lane != 0) return;
    long long kv_n = 0, ring_n = 0, prev = -1;
    int n = 0;  // the group's units so far
    for (long long u = u_begin, i = 0; u < u_end; ++u, ++i) {
      const long long it = u / per_item;
      const int tile = (int)(u - it * per_item) / HALVES;
      const int m = (int)(it / H), h = (int)(it % H);
      if (resident && grp == 0 && it != prev) {  // a new item: its K and V, whole
        const int b = (int)(kv_n % NKV);
        if (kv_n >= NKV) bya::mbar_wait(&kv_empty[b], (int)((kv_n / NKV - 1) & 1));
        bya::mbar_expect_tx(&kv_full[b], 2 * vpart);
        unsigned char* dst = sKV + b * geo.buf;
        for (int p = 0; p < NP; ++p)
          for (int r = 0; r < geo.rows; r += geo.box) {
            bya::tma_load_4d(dst + p * kpanel + r * 128, &tk, 64 * p, r, h, m, &kv_full[b]);
            bya::tma_load_4d(dst + vpart + p * kpanel + r * 128, &tv, 64 * p, r, h, m,
                             &kv_full[b]);
          }
        ++kv_n;
      }
      prev = it;
      if ((int)(i % ngrp) != grp) continue;
      const int st = n % NST;
      if (n >= NST) bya::mbar_wait(&empty[st], (n / NST - 1) & 1);
      bya::mbar_expect_tx(&full[st], G::Q_TILE);
      for (int p = 0; p < NP; ++p)
        bya::tma_load_4d(sQ + st * G::Q_TILE + p * SF_PANEL, &tq, 64 * p, tile * SF_BM, h, m,
                         &full[st]);
      if (!resident)
        for (int j = 0; j < nkb; ++j, ++ring_n) {  // the unit's key blocks, in order
          const int s = (int)(ring_n % NKV);
          if (ring_n >= NKV) bya::mbar_wait(&ring_empty[s], (int)((ring_n / NKV - 1) & 1));
          bya::mbar_expect_tx(&ring_full[s], 2 * vpart);
          for (int p = 0; p < NP; ++p) {
            bya::tma_load_4d(ring + s * geo.buf + p * kpanel, &tk, 64 * p, j * BN, h, m,
                             &ring_full[s]);
            bya::tma_load_4d(ring + s * geo.buf + vpart + p * kpanel, &tv, 64 * p, j * BN, h,
                             m, &ring_full[s]);
          }
        }
      ++n;
    }
    return;
  }

  // consumer group grp: warp wq of the group holds rows 16 wq + lane / 4 and + 8
  const int tw = tid & 127, wq = tw >> 5;
  long long kv_n = 0, ring_n = 0, prev = -1;
  const unsigned char* kvb = sKV;  // resident: the item's buffer
  int n = 0;
  for (long long u = u_begin, i = 0; u < u_end; ++u, ++i) {
    const long long it = u / per_item;
    const int rem = (int)(u - it * per_item), tile = rem / HALVES, half = rem % HALVES;
    if (resident && it != prev) {  // a new item: free the last one's buffer, wait for this one's
      if (kv_n > 0) {
        __syncwarp();
        if (lane == 0) bya::mbar_arrive(&kv_empty[(kv_n - 1) % NKV]);
      }
      bya::mbar_wait(&kv_full[kv_n % NKV], (int)((kv_n / NKV) & 1));
      kvb = sKV + (kv_n % NKV) * geo.buf;
      ++kv_n;
    }
    prev = it;
    if ((int)(i % ngrp) != grp) continue;  // another group's unit
    const int st = n % NST;
    unsigned char* qs = sQ + st * G::Q_TILE;
    bya::mbar_wait(&full[st], (n / NST) & 1);

    float o[NPV * 8][4], mx[2] = {bya::MASKED, bya::MASKED}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NPV * 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
    // key block j: K's rows 64 j .. (V's at + vpart); streamed, its ring
    // slot (waited for; a second call returns at once) and its release
    auto kblock = [&](int j) -> const unsigned char* {
      if (resident) return kvb + j * BN * 128;
      const long long c = ring_n + j;
      bya::mbar_wait(&ring_full[c % NKV], (int)((c / NKV) & 1));
      return ring + (c % NKV) * geo.buf;
    };
    auto release = [&](int j) {
      if (resident) return;
      __syncwarp();
      if (lane == 0) bya::mbar_arrive(&ring_empty[(ring_n + j) % NKV]);
    };
    float s[BN / 8][4];
    uint32_t pa[G::KS][4];
    // S = Q K^T of a block (one commit group)
    auto issue_s = [&](const unsigned char* kb) {
      bya::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t da = bya::desc_kmajor(qs + (kk / 4) * SF_PANEL + (kk % 4) * 32);
        const uint64_t db = bya::desc_kmajor(kb + (kk / 4) * kpanel + (kk % 4) * 32);
        bya::wgmma_ss<0, 0>(&s[0][0], da, db, kk > 0);
      }
      bya::wg_commit();
    };
    // O += P V of a block, this unit's columns of V (one commit group)
    auto issue_pv = [&](const unsigned char* kb) {
      bya::wg_fence();
#pragma unroll
      for (int kk = 0; kk < G::KS; ++kk)
#pragma unroll
        for (int p = 0; p < NPV; ++p)
          bya::wgmma_rs<1>(&o[p * 8][0], pa[kk],
                           bya::desc_mnmajor(kb + vpart + (half * NPV + p) * kpanel +
                                             kk * 16 * 128));
      bya::wg_commit();
    };
    // the online softmax of block j's scores: key columns past S masked
    // (`masked`: the last block, when it reaches past S; a separate copy of
    // the code, so the other blocks carry no mask), the running max, this
    // thread's share of the sum, and alpha, the factor that rescales O
    float alpha[2];
    auto softmax = [&](auto& sc, int j, auto masked) {
      constexpr int NC = std::extent<std::remove_reference_t<decltype(sc)>>::value;
      if constexpr (decltype(masked)::value) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * BN + 8 * c + 2 * (lane & 3) + (e & 1) >= S) sc[c][e] = bya::MASKED;
      }
      float mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = mx[r];
#pragma unroll
        for (int c = 0; c < NC; ++c) x = fmaxf(x, fmaxf(sc[c][2 * r], sc[c][2 * r + 1]));
        x = fmaxf(x, __shfl_xor_sync(bya::FULL, x, 1));
        x = fmaxf(x, __shfl_xor_sync(bya::FULL, x, 2));
        alpha[r] = bya::fast_exp2((mx[r] - x) * scale_log2);
        mx[r] = x;
        mb[r] = x * scale_log2;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[c][e] = bya::fast_exp2(fmaf(sc[c][e], scale_log2, -mb[e >> 1]));
          rs[e >> 1] += sc[c][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    };
    // block j's S is made while block j - 1's P V runs, and its softmax
    // while that product finishes; O is rescaled once it has
    // at 256 columns (an item of one or two blocks at the lengths past its
    // cap) one masked copy of the softmax and no separate last block: the
    // copies spilled there (ptxas allots this block's ten warps 168
    // registers a thread)
    const std::true_type mask;
    const std::integral_constant<bool, DP == 256> no_mask;
    const unsigned char* kb = kblock(0);
    issue_s(kb);
    bya::wg_wait<0>();
    bya::fence_regs<BN / 2>(&s[0][0]);
    if (nkb == 1)  // the only block, masked where it reaches past S
      softmax(s, 0, mask);
    else
      softmax(s, 0, no_mask);
    bya::acc_to_a_frags<G::KS>(pa, s);
    auto step = [&](int j) {
      const unsigned char* kn = kblock(j);
      issue_s(kn);
      issue_pv(kb);
      bya::wg_wait<1>();
      bya::fence_regs<BN / 2>(&s[0][0]);
      softmax(s, j, no_mask);
      bya::wg_wait<0>();
      bya::fence_regs<NPV * 32>(&o[0][0]);
      release(j - 1);
#pragma unroll
      for (int c = 0; c < NPV * 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][e] *= alpha[e >> 1];
      bya::acc_to_a_frags<G::KS>(pa, s);
      kb = kn;
    };
    // the last block at the width its keys need (16, 32, 48 or 64 columns:
    // a ragged block pays for its keys, not for a whole block), then its
    // P V over as many 16-key steps
    auto last = [&](auto width) {
      constexpr int NT = decltype(width)::value, KT = NT / 16;
      const int j = nkb - 1;
      const unsigned char* kn = kblock(j);
      float st[NT / 8][4];
      bya::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t da = bya::desc_kmajor(qs + (kk / 4) * SF_PANEL + (kk % 4) * 32);
        const uint64_t db = bya::desc_kmajor(kn + (kk / 4) * kpanel + (kk % 4) * 32);
        if constexpr (NT == BN)
          bya::wgmma_ss<0, 0>(&st[0][0], da, db, kk > 0);
        else
          bya::wgmma_ss_narrow<NT>(&st[0][0], da, db, kk > 0);
      }
      bya::wg_commit();
      issue_pv(kb);
      bya::wg_wait<1>();
      bya::fence_regs<NT / 2>(&st[0][0]);
      softmax(st, j, mask);
      bya::wg_wait<0>();
      bya::fence_regs<NPV * 32>(&o[0][0]);
      release(j - 1);
#pragma unroll
      for (int c = 0; c < NPV * 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][e] *= alpha[e >> 1];
      uint32_t pt[KT][4];
      bya::acc_to_a_frags<KT>(pt, st);
      bya::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int p = 0; p < NPV; ++p)
          bya::wgmma_rs<1>(&o[p * 8][0], pt[kk],
                           bya::desc_mnmajor(kn + vpart + (half * NPV + p) * kpanel +
                                             kk * 16 * 128));
      bya::wg_commit();
      bya::wg_wait<0>();
      bya::fence_regs<NPV * 32>(&o[0][0]);
      release(j);
    };
    if constexpr (DP == 256) {  // every block on `step`, masked (one copy of the code)
      for (int j = 1; j < nkb; ++j) step(j);
      issue_pv(kb);
      bya::wg_wait<0>();
      bya::fence_regs<NPV * 32>(&o[0][0]);
      release(nkb - 1);
    } else {
      for (int j = 1; j < nkb - 1; ++j) step(j);
      if (nkb > 1) {
        switch ((S - (nkb - 1) * BN + 15) / 16) {
          case 1: last(std::integral_constant<int, 16>()); break;
          case 2: last(std::integral_constant<int, 32>()); break;
          case 3: last(std::integral_constant<int, 48>()); break;
          default: last(std::integral_constant<int, 64>());
        }
      } else {
        issue_pv(kb);
        bya::wg_wait<0>();
        bya::fence_regs<NPV * 32>(&o[0][0]);
        release(0);
      }
    }
    if (!resident) ring_n += nkb;
    // O / l as bf16 over the unit's q tile (its products have completed),
    // swizzled as TMA reads it, then one TMA store a panel
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(bya::FULL, l[r], 1);
      l[r] += __shfl_xor_sync(bya::FULL, l[r], 2);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int c = 0; c < NPV * 8; ++c)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * wq + (lane >> 2) + 8 * hf, cc = c % 8;
        *reinterpret_cast<uint32_t*>(qs + (c / 8) * SF_PANEL + r * 128 + ((cc ^ (r & 7)) << 4) +
                                     (lane & 3) * 4) =
            bya::pack_bf16(o[c][2 * hf] * inv[hf], o[c][2 * hf + 1] * inv[hf]);
      }
    bya::fence_async_shared();
    bya::named_sync(1 + grp, 128);
    if (tw == 0) {
      const int m = (int)(it / H), h = (int)(it % H);
#pragma unroll
      for (int p = 0; p < NPV; ++p)
        bya::tma_store_4d(&to, qs + p * SF_PANEL, (half * NPV + p) * 64, tile * SF_BM, h, m);
      bya::bulk_wait_read();
      bya::mbar_arrive(&empty[st]);  // the stage is free for the next q tile
    }
    ++n;
  }
}

// B8's streamed body, first kernel: each row's statistics, then dQ
template <int DP>
__global__ void __launch_bounds__(Stream<DP>::THREADS)
tiny_seq_stream_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ g,
                          bf16* __restrict__ dq, float* __restrict__ stats, long long n_items,
                          int H, int S, int dh, float scale) {
  using G = Stream<DP>;
  constexpr int TILE = G::TILE, CT = G::CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const qg = reinterpret_cast<bf16*>(smem_raw);  // the q group
  bf16* const gg = qg + G::WARPS * TILE;               // the g group
  bf16* const stg = gg + G::WARPS * TILE;              // a staging tile a warp
  bf16* const kv = stg + G::WARPS * TILE;              // buffer b: K at b * BUF, V after it
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ld = (long long)H * dh;
  const int ch = dh / 8;
  const float scale_log2 = scale * LOG2E;
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
  const int groups = (S + G::GROUP - 1) / G::GROUP, n_chunks = (S + G::CHUNK - 1) / G::CHUNK;
  const long long n_units = n_items * groups, plane = n_items * S;
  zero_smem_block<G::THREADS>(qg, (3 * G::WARPS + 2 * 2 * CT) * TILE, tid);
  auto col_ok = [&](int kc, int n, int e) { return kc * 16 + n * 8 + c0 + (e & 1) < S; };

  for (long long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const long long item = unit / groups;
    const int row0 = (int)(unit - item * groups) * G::GROUP;
    const long long base = (item / H) * S * ld + (item % H) * dh;
    const int qt = row0 / 16 + warp;
    const bool active = qt * 16 < S;
    __syncthreads();
    load_stream_rows<DP>(qg, q + base, ld, row0, G::GROUP, S, ch, tid);
    load_stream_rows<DP>(gg, g + base, ld, row0, G::GROUP, S, ch, tid);
    bya::cp_async_commit();
    bya::cp_async_wait<0>();
    __syncthreads();
    const ATile<DP> aq(qg + warp * TILE, lane), ag(gg + warp * TILE, lane);
    auto load_kv = [&](int buf, int c) {
      load_stream_rows<DP>(kv + buf * G::BUF, k + base, ld, c * G::CHUNK, G::CHUNK, S, ch, tid);
      load_stream_rows<DP>(kv + buf * G::BUF + CT * TILE, v + base, ld, c * G::CHUNK, G::CHUNK,
                           S, ch, tid);
    };

    // each row's max, 1 / sum and delta = sum_b p_ab dp_ab (the sum and
    // delta rescaled as the max grows)
    float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    stream_chunks(n_chunks, load_kv, [&](int buf, int c) {
      if (!active) return;
      for (int j = 0; j < CT && (c * CT + j) * 16 < S; ++j) {
        const int kc = c * CT + j;
        float s[2][4], dp[2][4];
        aq.scores(s, kv + buf * G::BUF + j * TILE, lane);
        ag.scores(dp, kv + buf * G::BUF + (CT + j) * TILE, lane);
        float cm[2] = {mx[0], mx[1]}, cs[2] = {0.f, 0.f}, cd[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col_ok(kc, n, e)) cm[e >> 1] = fmaxf(cm[e >> 1], s[n][e]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          cm[i] = fmaxf(cm[i], __shfl_xor_sync(FULL, cm[i], 1));
          cm[i] = fmaxf(cm[i], __shfl_xor_sync(FULL, cm[i], 2));
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col_ok(kc, n, e)) {
              const float p = exp2f((s[n][e] - cm[e >> 1]) * scale_log2);
              cs[e >> 1] += p;
              cd[e >> 1] += p * dp[n][e];
            }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float alpha = exp2f((mx[i] - cm[i]) * scale_log2);
          sum[i] = sum[i] * alpha + cs[i];
          dl[i] = dl[i] * alpha + cd[i];
          mx[i] = cm[i];
        }
      }
    });
    // the rows' statistics, as the long body keeps them (rows past S: p = 0)
    float iv[2], de[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
      dl[i] += __shfl_xor_sync(FULL, dl[i], 1);
      dl[i] += __shfl_xor_sync(FULL, dl[i], 2);
      const int row = qt * 16 + r0 + 8 * i;
      iv[i] = row < S ? 1.f / sum[i] : 0.f;
      de[i] = dl[i] / sum[i];
      if (active && (lane & 3) == 0 && row < S) {
        const long long at = item * S + row;
        stats[at] = mx[i];
        stats[plane + at] = iv[i];
        stats[2 * plane + at] = de[i];
      }
    }

    // dQ = dS K, a 64-column panel at a time over the chunks
    for (int pn = 0; pn < DP / 64 && pn * 64 < dh; ++pn) {
      float acc[8][4];
      zero_acc(acc);
      stream_chunks(n_chunks, load_kv, [&](int buf, int c) {
        if (!active) return;
        for (int j = 0; j < CT && (c * CT + j) * 16 < S; ++j) {
          const int kc = c * CT + j;
          const bf16* ks = kv + buf * G::BUF + j * TILE;
          float s[2][4], dp[2][4];
          aq.scores(s, ks, lane);
          ag.scores(dp, kv + buf * G::BUF + (CT + j) * TILE, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int e = 2 * i + jj;
                const float p =
                    col_ok(kc, n, e) ? exp2f((s[n][e] - mx[i]) * scale_log2) * iv[i] : 0.f;
                dp[n][e] = p * (dp[n][e] - de[i]) * scale;
              }
          const uint32_t ds_a[4] = {
              bya::pack_bf16(dp[0][0], dp[0][1]), bya::pack_bf16(dp[0][2], dp[0][3]),
              bya::pack_bf16(dp[1][0], dp[1][1]), bya::pack_bf16(dp[1][2], dp[1][3])};
          mma_a_tile_add<8, G::LDS>(acc, ds_a, ks + pn * 64, lane);
        }
      });
      if (active)
        write_tile<DP>(dq, base, ld, stg + warp * TILE + pn * 64, acc, qt, pn, S, ch, lane);
    }
  }
}

// B8's streamed body, second kernel: dK and dV of a group of kv rows from
// the first kernel's statistics
template <int DP>
__global__ void __launch_bounds__(Stream<DP>::THREADS)
tiny_seq_stream_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ g,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           const float* __restrict__ stats, long long n_items, int H, int S,
                           int dh, float scale) {
  using G = Stream<DP>;
  constexpr int TILE = G::TILE, CT = G::CT, CHUNK = G::CHUNK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const kg = reinterpret_cast<bf16*>(smem_raw);  // the k group
  bf16* const vg = kg + G::WARPS * TILE;               // the v group
  bf16* const stg = vg + G::WARPS * TILE;              // a staging tile a warp
  bf16* const qgb = stg + G::WARPS * TILE;             // buffer b: Q at b * BUF, G after it
  float* const st = reinterpret_cast<float*>(qgb + 2 * G::BUF);  // buffer b: 3 x CHUNK floats
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ld = (long long)H * dh;
  const int ch = dh / 8;
  const float scale_log2 = scale * LOG2E;
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
  const int groups = (S + G::GROUP - 1) / G::GROUP, n_chunks = (S + CHUNK - 1) / CHUNK;
  const long long n_units = n_items * groups, plane = n_items * S;
  zero_smem_block<G::THREADS>(kg, (3 * G::WARPS + 2 * 2 * CT) * TILE, tid);

  for (long long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const long long item = unit / groups;
    const int row0 = (int)(unit - item * groups) * G::GROUP;
    const long long base = (item / H) * S * ld + (item % H) * dh;
    const int kt = row0 / 16 + warp;  // this warp's kv tile
    const bool active = kt * 16 < S;
    __syncthreads();
    load_stream_rows<DP>(kg, k + base, ld, row0, G::GROUP, S, ch, tid);
    load_stream_rows<DP>(vg, v + base, ld, row0, G::GROUP, S, ch, tid);
    bya::cp_async_commit();
    bya::cp_async_wait<0>();
    __syncthreads();
    const bf16* ks = kg + warp * TILE;
    const bf16* vs = vg + warp * TILE;
    // chunk c of q, g and the rows' statistics (rows past S: all 0, so p = 0)
    auto load_qg = [&](int buf, int c) {
      load_stream_rows<DP>(qgb + buf * G::BUF, q + base, ld, c * CHUNK, CHUNK, S, ch, tid);
      load_stream_rows<DP>(qgb + buf * G::BUF + CT * TILE, g + base, ld, c * CHUNK, CHUNK, S, ch,
                           tid);
      for (int i = tid; i < 3 * CHUNK; i += G::THREADS) {
        const int p = i / CHUNK, row = c * CHUNK + i % CHUNK;
        st[buf * 3 * CHUNK + i] = row < S ? stats[p * plane + item * S + row] : 0.f;
      }
    };

    // dV = P^T G and dK = dS^T Q, a panel at a time over the q tiles
    // (P^T and dS^T transposed 8x8 block by block, as the long body)
    for (int pn = 0; pn < DP / 64 && pn * 64 < dh; ++pn) {
      float acc_k[8][4], acc_v[8][4];
      zero_acc(acc_k);
      zero_acc(acc_v);
      stream_chunks(n_chunks, load_qg, [&](int buf, int c) {
        if (!active) return;
        const float* row_max = st + buf * 3 * CHUNK;
        const float* row_inv = row_max + CHUNK;
        const float* row_delta = row_inv + CHUNK;
        for (int j = 0; j < CT && (c * CT + j) * 16 < S; ++j) {
          const bf16* qs = qgb + buf * G::BUF + j * TILE;
          const bf16* gs = qs + CT * TILE;
          const ATile<DP> aq(qs, lane), ag(gs, lane);
          float s[2][4], dp[2][4];
          aq.scores(s, ks, lane);
          ag.scores(dp, vs, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = j * 16 + r0 + 8 * i;  // in the chunk
            const float m = row_max[row], iv = row_inv[row], de = row_delta[row];
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int e = 2 * i + jj;
                const float p = kt * 16 + n * 8 + c0 + (e & 1) < S
                                    ? exp2f((s[n][e] - m) * scale_log2) * iv
                                    : 0.f;
                s[n][e] = p;
                dp[n][e] = p * (dp[n][e] - de) * scale;
              }
          }
          const uint32_t pt_a[4] = {transpose8(bya::pack_bf16(s[0][0], s[0][1])),
                                    transpose8(bya::pack_bf16(s[1][0], s[1][1])),
                                    transpose8(bya::pack_bf16(s[0][2], s[0][3])),
                                    transpose8(bya::pack_bf16(s[1][2], s[1][3]))};
          const uint32_t dst_a[4] = {transpose8(bya::pack_bf16(dp[0][0], dp[0][1])),
                                     transpose8(bya::pack_bf16(dp[1][0], dp[1][1])),
                                     transpose8(bya::pack_bf16(dp[0][2], dp[0][3])),
                                     transpose8(bya::pack_bf16(dp[1][2], dp[1][3]))};
          mma_a_tile_add<8, G::LDS>(acc_v, pt_a, gs + pn * 64, lane);
          mma_a_tile_add<8, G::LDS>(acc_k, dst_a, qs + pn * 64, lane);
        }
      });
      if (active) {
        write_tile<DP>(dk, base, ld, stg + warp * TILE + pn * 64, acc_k, kt, pn, S, ch, lane);
        write_tile<DP>(dv, base, ld, stg + warp * TILE + pn * 64, acc_v, kt, pn, S, ch, lane);
      }
    }
  }
}

// The one-pass forward: one block an SM (its shared memory), each walking
// an equal contiguous share of the M H T HALVES units.  An item's K and V
// stay resident when a buffer fits beside two q stages a group (two
// buffers when they fit), else its key blocks stream; the rest of the
// shared memory goes to q stages (at most 4 a group).
template <int DP>
cudaError_t launch_stream_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, int M, int S,
                              int H, int dh, float scale, cudaStream_t st) {
  using G = SFwd<DP>;
  SFwdGeo geo{};
  geo.T = (S + SF_BM - 1) / SF_BM;
  geo.nkb = (S + G::BN - 1) / G::BN;
  const int room = SMEM_LIMIT - 2048;  // the base's alignment and the barriers' kilobyte
  const int rows = (S + 15) / 16 * 16;
  // a resident buffer: K's and V's panels of `rows` rows, then the rows past
  // V's last panel that the last key block reads (zeros)
  const int res_buf = ((2 * G::NP * rows + G::BN * geo.nkb - rows) * 128 + 1023) / 1024 * 1024;
  const int stage = G::NWG * G::Q_TILE;  // a q stage of each group
  auto stages = [&](long long kv) {      // q stages that fit beside kv bytes (<= 4)
    const long long n = (room - kv) / stage;
    return (int)(n < 0 ? 0 : n > SF_MAX_ST ? SF_MAX_ST : n);
  };
  const int slot = 2 * G::NP * G::BN * 128;  // a streamed key block
  if (stages(2LL * res_buf) >= 2) {
    geo = {geo.T, geo.nkb, rows, 0, 1, 2, stages(2LL * res_buf), 0, res_buf, G::NWG};
  } else if (stages(res_buf) >= 2) {
    geo = {geo.T, geo.nkb, rows, 0, 1, 1, stages(res_buf), 0, res_buf, G::NWG};
  } else {  // streamed: two q stages a group, the rest ring slots (a unit holds two
            // blocks at a time); one group where the groups' rings would not fit
    int ngrp = G::NWG, nkv = (room - 2 * stage) / (ngrp * slot);
    if (nkv < 2) ngrp = 1, nkv = (room - 2 * G::Q_TILE) / slot;
    if (nkv < 2) return cudaErrorInvalidConfiguration;
    geo = {geo.T, geo.nkb, G::BN, G::BN, 0, nkv < SF_MAX_KV ? nkv : SF_MAX_KV, 2, 0, slot, ngrp};
  }
  if (geo.resident)  // the longest box of 16-row steps that divides the panel
    for (int b = 16; b <= 256 && b <= rows; b += 16)
      if (rows % b == 0) geo.box = b;
  geo.kv_off = 1024 + geo.NST * geo.groups * G::Q_TILE;
  const int smem = geo.kv_off + (geo.resident ? 1 : geo.groups) * geo.NKV * geo.buf + 1024;

  const bya::Layout L = bya::make_layout(S, H, dh, 1);  // [M, S, H, dh]
  CUtensorMap tq, tk, tv, to;
  if (!bya::make_map(&tq, q, L, M, H, S, dh, SF_BM) ||
      !bya::make_map(&tk, k, L, M, H, S, dh, geo.box) ||
      !bya::make_map(&tv, v, L, M, H, S, dh, geo.box) ||
      !bya::make_map(&to, o, L, M, H, S, dh, SF_BM))
    return cudaErrorInvalidValue;
  static int sms = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {  // once: the SM count, the kernel's limit raised to a block's whole
    int dev = 0;
    err = cudaFuncSetAttribute(tiny_seq_stream_fwd_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tiny_seq_stream_fwd_kernel<DP>,
                                                      G::THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const long long units = (long long)M * H * geo.T * G::HALVES, fit = (long long)sms * per_sm;
  tiny_seq_stream_fwd_kernel<DP><<<(unsigned)(units < fit ? units : fit), G::THREADS, smem, st>>>(
      tq, tk, tv, to, units, H, S, scale * LOG2E, geo);
  return cudaGetLastError();
}

// `stats`: 3 x M x H x S floats of scratch (each row's max, 1 / sum, delta)
template <int DP>
cudaError_t launch_stream_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                              bf16* dq, bf16* dk, bf16* dv, float* stats, int M, int S, int H,
                              int dh, float scale, cudaStream_t st) {
  using G = Stream<DP>;
  static int fit_dq = 0, fit_dkv = 0;
  cudaError_t err =
      resident_blocks(tiny_seq_stream_dq_kernel<DP>, G::THREADS, G::BWD_SMEM, &fit_dq);
  if (err == cudaSuccess)
    err = resident_blocks(tiny_seq_stream_dkv_kernel<DP>, G::THREADS, G::DKV_SMEM, &fit_dkv);
  if (err != cudaSuccess) return err;
  const long long n_items = (long long)M * H, units = n_items * ((S + G::GROUP - 1) / G::GROUP);
  tiny_seq_stream_dq_kernel<DP><<<(unsigned)(units < fit_dq ? units : fit_dq), G::THREADS,
                                  G::BWD_SMEM, st>>>(q, k, v, g, dq, stats, n_items, H, S, dh,
                                                     scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiny_seq_stream_dkv_kernel<DP><<<(unsigned)(units < fit_dkv ? units : fit_dkv), G::THREADS,
                                   G::DKV_SMEM, st>>>(q, k, v, g, dk, dv, stats, n_items, H, S,
                                                      dh, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [M, S, H*D] bf16, contiguous, 16-byte aligned; D % 8 == 0 up
// to 256 (on the narrowest body that holds it); any S >= 1 (the wrapper
// sends S past the body's LONG_MAX_S here, `kernel_body` "stream").
// Returns the cudaError_t of the launch, or cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int bya_tiny_seq_attention_stream(const void* q, const void* k, const void* v,
                                             void* o, int M, int S, int H, int D, float scale,
                                             void* stream) {
  const int body = bya::body_of(D);
  if (body == 0 || S < 1 || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 64) return (int)launch_stream_fwd<64>(qp, kp, vp, op, M, S, H, D, scale, st);
  if (body == 128) return (int)launch_stream_fwd<128>(qp, kp, vp, op, M, S, H, D, scale, st);
  return (int)launch_stream_fwd<256>(qp, kp, vp, op, M, S, H, D, scale, st);
}

// B8's streamed body: q, k, v, g (the output gradient), dq, dk, dv as the
// forward's; `stats`: 3 x M x H x S floats of device scratch (each row's
// max, 1 / sum and delta, from the first kernel to the second).  Returns
// the cudaError_t of the launches, or cudaErrorInvalidValue for a shape it
// does not take.
extern "C" int bya_tiny_seq_attention_stream_bwd(const void* q, const void* k, const void* v,
                                                 const void* g, void* dq, void* dk, void* dv,
                                                 void* stats, int M, int S, int H, int D,
                                                 float scale, void* stream) {
  const int body = bya::body_of(D);
  if (body == 0 || S < 1 || M < 1 || H < 1 || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  float* sp = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 64)
    return (int)launch_stream_bwd<64>(qp, kp, vp, gp, dqp, dkp, dvp, sp, M, S, H, D, scale, st);
  if (body == 128)
    return (int)launch_stream_bwd<128>(qp, kp, vp, gp, dqp, dkp, dvp, sp, M, S, H, D, scale, st);
  return (int)launch_stream_bwd<256>(qp, kp, vp, gp, dqp, dkp, dvp, sp, M, S, H, D, scale, st);
}
