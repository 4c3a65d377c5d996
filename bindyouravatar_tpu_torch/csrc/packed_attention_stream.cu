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
//   backward (B8), two kernels on the tensor cores (wgmma, TMA; below,
//     before `tiny_seq_stream_dq_kernel`): a q-major one (each row's max,
//     1 / sum and delta, saved to `stats` in fp32, then dQ = dS K) and a
//     kv-major one (dV = P^T G and dK = dS^T Q from those statistics), an
//     item's blocks resident in shared memory.  What bounds it on the H100:
//     bytes on paper (7 S dh bf16 values per (item, head) against 10 S^2
//     dh FLOP: at S = 201, 144 FLOP/B), but the two kernels make 18 S^2 dh
//     (at S rounded up to 64) and three 2^x a score, on 64-row tiles.
//     Its roundings are the long bodies': P and dS rounded to bf16 as the
//     products' operands, the statistics in fp32; 2^x on the special-
//     function unit (`ex2.approx`).
// No unit shares a sum with another, so the bodies repeat bit for bit.
// Rows past S load as zeros and their key columns are masked (p = 0), so a
// ragged last block, chunk or group adds nothing; rows past S are never
// stored.
#include <type_traits>

#include "hopper.cuh"
#include "packed_attention.cuh"

namespace {

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

// ---- B8 past each long body's cap: two wgmma kernels, no atomic sums ----
// (shared-memory counters only decide which group issues a load)
// The q-major kernel (`tiny_seq_stream_dq_kernel`) takes a unit of one
// item's 64 q rows: a pass over the item's 64-key blocks for each row's
// max, sum and delta = sum_b p_ab dp_ab (online, rescaled as the max grows;
// written to `stats`), then a pass that makes dS = P (dP - delta) * scale a
// key block at a time and dQ += dS K.  The kv-major kernel
// (`tiny_seq_stream_dkv_kernel`) takes a unit of 64 kv rows: per 64-row q
// block, S^T = K Q^T and dP^T = V G^T, P^T from the rows' statistics, dV
// += P^T G and dK += dS^T Q.  So S and dP are made once per (unit, block)
// in each pass: five products of the q-major kernel's two passes and four
// of the kv-major kernel's, where the mma.sync bodies before made them once
// for every 64-column panel of the head.
// Blocks of consumer warp groups only: two at 128 and 256 columns (ptxas
// may give a thread 255 registers; a producer warp beside them would
// leave a third of a sub-partition's registers, 168), three (q-major, 168
// registers) or four (kv-major, 128) at 64 columns, where a 64-row step's
// products are short and more groups hide their latency.  The item's blocks the units read
// (K and V for the q-major kernel; Q, G and the rows' statistics for the
// kv-major kernel) stay resident in shared memory, loaded whole by TMA once
// per block and item (two buffers where they fit, so the next item's load
// overlaps); past what fits they stream through a ring, a unit's blocks in
// order (twice in the q-major kernel: once a pass).  A unit's own 64 rows
// (Q and G, or K and V) come by TMA into its slot's stage; its result is
// written as bf16 over that stage and stored by TMA (rows past S and
// columns past dh fall outside the tensor maps).  Thread 0 issues the
// first loads; after that the last group to free a stage, buffer or ring
// slot (a count each) issues its next load, so no group waits on another
// to issue.
//   * The q-major kernel: each group a unit.  At dh 256 the scores run in
//     32-key halves of a block (dQ's 128 fp32 registers a thread beside S
//     and dP).
//   * The kv-major kernel: a unit on a pair of groups (dK and dV of a
//     64-row tile at 256 columns are 256 fp32 registers a thread): group
//     0 makes S^T and P^T and holds dV, group 1 makes dP^T and holds dK;
//     P^T goes from group 0 to group 1 through shared memory in fp32 (an
//     exchange of two slots, or one where two do not fit), so each product
//     is made once.
//   * Each group issues the next block's score products before the current
//     block's accumulating ones and makes the next block's P and dS while
//     those run (the flash forward's order).
// The statistics, fp32 [M H][3][T 64] (T = ceil(S / 64)): each row's max
// times scale log2 e, 1 / sum and delta; rows past S get 1 / sum = delta =
// 0, so their p is 0 in the kv-major kernel.  Key columns past S are masked
// by index (p = 0); the TMA unit zero-fills every row past S.  No unit sums
// with another: the results repeat bit for bit.
constexpr int SB_ROWS = 64;              // rows of a unit and of a block
constexpr int SB_PANEL = 64 * 128;       // bytes of a [64, 64] bf16 panel
constexpr int SB_XBUF = 128 * 32 * 4;    // an exchange slot: a group's 64 x 64 fp32 tile
constexpr int SB_STATS = 3 * SB_ROWS * 4;  // a block's statistics, bytes
// the first kilobyte: 8 stage, 4 buffer or ring and 2 x 4 exchange barriers,
// then 8 + 4 counts of the groups that freed each
static_assert((8 + 4 + 2 * 4) * 8 + (8 + 4) * 4 <= 1024, "the backward's barriers");

template <int DP, bool KVM>
struct SBwd {
  static constexpr int NP = DP / 64;                    // 64-column panels
  static constexpr int BLK = 2 * NP * SB_PANEL;         // a block or a unit's rows: two tensors
  // consumer groups: at 64 columns three (q-major, 168 registers a
  // thread) or four (kv-major: two pairs, 128), else two (255)
  static constexpr int NWG = DP == 64 ? (KVM ? 4 : 3) : 2;
  static constexpr int THREADS = 128 * NWG;
};

// The backward's shared-memory plan for one launch, set by the host.
struct SBwdGeo {
  int T;         // 64-row tiles (units, blocks) of an item
  int resident;  // 1: an item's blocks whole in a buffer; 0: streamed per unit
  int NKV;       // resident buffers (1, 2), or ring slots (2 to 4)
  int NST;       // unit stages of each slot (1, 2)
  int slots;     // units at work at once: q-major groups, kv-major group pairs
  int NX;        // exchange slots of each pair (the kv-major kernel)
  int st_off;    // byte offsets of the stages, the buffers or ring, the exchange
  int kv_off;
  int x_off;
  int buf;       // bytes of a buffer (T blocks, then the statistics) or a ring slot
};

// wgmma m64nNk16 for the scores, N = 64 or 32, both operands K-major
template <int N>
__device__ __forceinline__ void sb_score(float* d, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 64)
    bya::wgmma_ss<0, 0>(d, da, db, accumulate);
  else
    bya::wgmma_ss_narrow<N>(d, da, db, accumulate);
}

// A group's 64 x DP fp32 accumulator as bf16 over the panels at `dst`
// (128-byte rows, swizzled as TMA reads them)
template <int NC>
__device__ __forceinline__ void sb_stage_out(unsigned char* dst, const float (&acc)[NC][4],
                                             int wq, int lane) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * wq + (lane >> 2) + 8 * hf, cc = c % 8;
      *reinterpret_cast<uint32_t*>(dst + (c / 8) * SB_PANEL + r * 128 + ((cc ^ (r & 7)) << 4) +
                                   (lane & 3) * 4) =
          bya::pack_bf16(acc[c][2 * hf], acc[c][2 * hf + 1]);
    }
}

// The two kernels' common frame.  KVM = false: the q-major kernel (units:
// an item's q tiles, their Q and G rows; blocks: K and V); true: the
// kv-major kernel (units: kv tiles, their K and V rows; blocks: Q and G
// and the statistics).  Maps: ua, ub the unit's tensors, ba, bb the
// blocks', o0 (dQ; dK) and o1 (dV) the outputs'.
template <int DP, bool KVM>
__device__ __forceinline__ void stream_bwd_body(
    unsigned char* smem_raw, const CUtensorMap* ua, const CUtensorMap* ub, const CUtensorMap* ba,
    const CUtensorMap* bb, const CUtensorMap* o0, const CUtensorMap* o1,
    float* __restrict__ stats, long long units, int H, int S, float scale, const SBwdGeo& geo) {
  using G = SBwd<DP, KVM>;
  constexpr int NP = G::NP, BLK = G::BLK;
  constexpr int PASSES = KVM ? 1 : 2;  // a unit's walks over its item's blocks
  unsigned char* smem = smem_raw + ((1024 - (bya::smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int T = geo.T, NST = geo.NST, NKV = geo.NKV, slots = geo.slots, NX = geo.NX;
  const bool resident = geo.resident != 0;
  const int plane = T * SB_ROWS;  // an item's statistics: three planes of plane floats
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = bars;             // [slot][stage]: a unit's rows
  uint64_t* kv_full = bars + 8;      // [buffer or ring slot]: a block's or an item's
  uint64_t* x_full = kv_full + 4;    // [pair][exchange slot]
  uint64_t* x_empty = x_full + 4;
  // the groups that have freed each stage, buffer or ring slot, so far
  int* st_freed = reinterpret_cast<int*>(x_empty + 4);  // [slot][stage]
  int* kv_freed = st_freed + 8;                           // [buffer or ring slot]
  auto stage = [&](int sl, int st) { return smem + geo.st_off + (sl * NST + st) * BLK; };
  unsigned char* kvs = smem + geo.kv_off;  // the buffers, or the ring
  float* xbuf = reinterpret_cast<float*>(smem + geo.x_off);
  const int unit_users = KVM ? 2 : 1;      // groups that read a unit's stage
  const int groups = unit_users * slots;   // consumer groups at work
  const int block_users = resident ? groups : unit_users;  // groups that read a buffer / ring slot
  const long long u_begin = units * blockIdx.x / gridDim.x;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  const long long it0 = u_begin / T;
  const long long n_items = u_end > u_begin ? (u_end - 1) / T - it0 + 1 : 0;
  const long long n_ring = (u_end - u_begin) * PASSES * T;  // streamed: the ring's blocks
  // the loads, issued by one thread: the k-th item's blocks whole into
  // buffer k % NKV; slot sl's n-th unit's rows into its stage n % NST; the
  // ring's c-th block (unit c / (PASSES T) of the share, block c % T)
  auto load_item = [&](long long k) {
    const long long it = it0 + k;
    const int b = (int)(k % NKV), m = (int)(it / H), h = (int)(it % H);
    bya::mbar_expect_tx(&kv_full[b], T * BLK + (KVM ? 3 * plane * 4 : 0));
    unsigned char* dst = kvs + b * geo.buf;
    for (int j = 0; j < T; ++j)
      for (int p = 0; p < NP; ++p) {
        bya::tma_load_4d(dst + j * BLK + p * SB_PANEL, ba, 64 * p, j * SB_ROWS, h, m, &kv_full[b]);
        bya::tma_load_4d(dst + j * BLK + (NP + p) * SB_PANEL, bb, 64 * p, j * SB_ROWS, h, m,
                         &kv_full[b]);
      }
    if (KVM) bya::bulk_load(dst + T * BLK, stats + it * 3 * plane, 3 * plane * 4, &kv_full[b]);
  };
  auto load_unit = [&](int sl, long long n) {
    const long long u = u_begin + sl + n * slots, it = u / T;
    const int st = (int)(n % NST), tile = (int)(u - it * T), m = (int)(it / H), h = (int)(it % H);
    uint64_t* bar = &full[sl * 2 + st];
    bya::mbar_expect_tx(bar, BLK);
    for (int p = 0; p < NP; ++p) {
      bya::tma_load_4d(stage(sl, st) + p * SB_PANEL, ua, 64 * p, tile * SB_ROWS, h, m, bar);
      bya::tma_load_4d(stage(sl, st) + (NP + p) * SB_PANEL, ub, 64 * p, tile * SB_ROWS, h, m, bar);
    }
  };
  auto load_block = [&](long long c) {
    const long long u = u_begin + c / (PASSES * T), it = u / T;
    const int j = (int)(c % T), s = (int)(c % NKV), m = (int)(it / H), h = (int)(it % H);
    bya::mbar_expect_tx(&kv_full[s], BLK + (KVM ? SB_STATS : 0));
    unsigned char* dst = kvs + s * geo.buf;
    for (int p = 0; p < NP; ++p) {
      bya::tma_load_4d(dst + p * SB_PANEL, ba, 64 * p, j * SB_ROWS, h, m, &kv_full[s]);
      bya::tma_load_4d(dst + (NP + p) * SB_PANEL, bb, 64 * p, j * SB_ROWS, h, m, &kv_full[s]);
    }
    if (KVM)
      for (int q = 0; q < 3; ++q)
        bya::bulk_load(dst + BLK + q * SB_ROWS * 4, stats + it * 3 * plane + q * plane + j * SB_ROWS,
                       SB_ROWS * 4, &kv_full[s]);
  };
  // the last of `users` groups to free a resource (counted in *freed)
  // issues its next load; called by one thread of a group whose reads of it
  // have completed
  auto last_to_free = [&](int* freed, int users) {
    __threadfence_block();
    return atomicAdd(freed, 1) % users == users - 1;
  };
  if (tid == 0) {
    for (int s = 0; s < 8; ++s) {
      bya::mbar_init(&full[s], 1);
      st_freed[s] = 0;
    }
    for (int s = 0; s < 4; ++s) {
      bya::mbar_init(&kv_full[s], 1);
      bya::mbar_init(&x_full[s], 128);
      bya::mbar_init(&x_empty[s], 128);
      kv_freed[s] = 0;
    }
    bya::mbar_init_fence();
    // the first loads: the first items (or ring blocks), each slot's first units
    if (resident)
      for (long long k = 0; k < NKV && k < n_items; ++k) load_item(k);
    else
      for (long long c = 0; c < NKV && c < n_ring; ++c) load_block(c);
    for (int sl = 0; sl < slots; ++sl)
      for (long long n = 0; n < NST && u_begin + sl + n * slots < u_end; ++n) load_unit(sl, n);
  }
  __syncthreads();

  // the consumer groups: warp wq of group wg holds rows 16 wq + lane / 4 and + 8
  if (wg >= groups) return;  // an idle group (streamed: one slot)
  const int slot = KVM ? wg / 2 : wg, tw = tid & 127, wq = tw >> 5;
  const float sl2 = scale * LOG2E;  // scores to log2 units
  long long item_n = 0, ring_n = 0, prev = -1, x_n = 0;
  const unsigned char* kvb = kvs;  // resident: the item's buffer
  long long n = 0;                 // this slot's units so far
  for (long long u = u_begin, i = 0; u < u_end; ++u, ++i) {
    const long long it = u / T;
    const int tile = (int)(u - it * T);
    if (resident && it != prev) {  // a new item: free the last one's buffer, wait for this one's
      if (item_n > 0) {
        bya::named_sync(1 + wg, 128);  // every warp of the group is done with it
        const long long k = item_n - 1;
        if (tw == 0 && k + NKV < n_items && last_to_free(&kv_freed[k % NKV], block_users))
          load_item(k + NKV);
      }
      bya::mbar_wait(&kv_full[item_n % NKV], (int)((item_n / NKV) & 1));
      kvb = kvs + (item_n % NKV) * geo.buf;
      ++item_n;
    }
    prev = it;
    if ((int)(i % slots) != slot) continue;  // another slot's unit
    const int st = (int)(n % NST);
    unsigned char* us = stage(slot, st);
    bya::mbar_wait(&full[slot * 2 + st], (int)((n / NST) & 1));
    // block j of the unit's pass: resident, its place in the buffer;
    // streamed, its ring slot (waited for) and its release (the group's
    // reads of it done: its products waited for, and the statistics read
    // by every warp)
    auto block = [&](int j, int pass) -> const unsigned char* {
      if (resident) return kvb + j * BLK;
      const long long c = ring_n + pass * T + j;
      bya::mbar_wait(&kv_full[c % NKV], (int)((c / NKV) & 1));
      return kvs + (c % NKV) * geo.buf;
    };
    auto release = [&](int j, int pass) {
      if (resident) return;
      const long long c = ring_n + pass * T + j;
      if (KVM) bya::named_sync(1 + wg, 128);
      if (tw == 0 && c + NKV < n_ring && last_to_free(&kv_freed[c % NKV], block_users))
        load_block(c + NKV);
    };
    // the unit's result, written over its stage's first (`second`: second)
    // tensor and stored through `map`; then (`last`) the stage is free
    auto store = [&](const auto& acc, bool second, const CUtensorMap* map, bool last) {
      unsigned char* dst = us + (second ? NP * SB_PANEL : 0);
      sb_stage_out(dst, acc, wq, lane);
      bya::fence_async_shared();
      bya::named_sync(1 + wg, 128);
      if (tw == 0) {
        const int m = (int)(it / H), h = (int)(it % H);
        for (int p = 0; p < NP; ++p)
          bya::tma_store_4d(map, dst + p * SB_PANEL, 64 * p, tile * SB_ROWS, h, m);
        bya::bulk_wait_read();
        if (last && u_begin + slot + (n + NST) * slots < u_end &&
            last_to_free(&st_freed[slot * 2 + st], unit_users))
          load_unit(slot, n + NST);
      }
    };

    if constexpr (!KVM) {
      // ---- the q-major unit: the rows' statistics, then dQ ----
      // keys a score product: 32 at 256 columns, beside dQ's 128 registers
      constexpr int KN = DP == 256 ? 32 : 64, NSUB = SB_ROWS / KN, NB = KN / 8;
      const unsigned char* qs = us;                  // Q's panels
      const unsigned char* gs = us + NP * SB_PANEL;  // G's
      float s[NB][4], dp[NB][4];
      // S = Q K^T and dP = G V^T over keys 64 j + KN hs .. of block kb
      auto issue_sdp = [&](float (&sa)[NB][4], float (&da)[NB][4], const unsigned char* kb,
                           int hs) {
        bya::wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          sb_score<KN>(&sa[0][0], bya::desc_kmajor(qs + (kk / 4) * SB_PANEL + (kk % 4) * 32),
                       bya::desc_kmajor(kb + (kk / 4) * SB_PANEL + hs * KN * 128 + (kk % 4) * 32),
                       kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          sb_score<KN>(&da[0][0], bya::desc_kmajor(gs + (kk / 4) * SB_PANEL + (kk % 4) * 32),
                       bya::desc_kmajor(kb + (NP + kk / 4) * SB_PANEL + hs * KN * 128 +
                                        (kk % 4) * 32),
                       kk > 0);
        bya::wg_commit();
      };
      // key columns past S (the last block's, where it reaches past S)
      auto mask = [&](float (&sa)[NB][4], int k0) {
        if (k0 + KN <= S) return;
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * c + 2 * (lane & 3) + (e & 1) >= S) sa[c][e] = bya::MASKED;
      };
      // pass 1: each row's max, this thread's share of the sum and of
      // sum_b p dp, both rescaled as the max grows (a second register set
      // to fold one step in while the next one's products ran measured
      // slower at every width)
      float mx[2] = {bya::MASKED, bya::MASKED}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
      for (int j = 0; j < T; ++j) {
        const unsigned char* kb = block(j, 0);
        for (int hs = 0; hs < NSUB; ++hs) {
          issue_sdp(s, dp, kb, hs);
          bya::wg_wait<0>();
          bya::fence_regs<KN / 2>(&s[0][0]);
          bya::fence_regs<KN / 2>(&dp[0][0]);
          mask(s, j * SB_ROWS + hs * KN);
          float nm[2], mb[2], cs[2] = {0.f, 0.f}, cd[2] = {0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = mx[r];
#pragma unroll
            for (int c = 0; c < NB; ++c) x = fmaxf(x, fmaxf(s[c][2 * r], s[c][2 * r + 1]));
            x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
            nm[r] = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
            mb[r] = nm[r] * sl2;
          }
#pragma unroll
          for (int c = 0; c < NB; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = bya::fast_exp2(fmaf(s[c][e], sl2, -mb[e >> 1]));
              cs[e >> 1] += p;
              cd[e >> 1] += p * dp[c][e];
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float alpha = bya::fast_exp2((mx[r] - nm[r]) * sl2);
            l[r] = l[r] * alpha + cs[r];
            dl[r] = dl[r] * alpha + cd[r];
            mx[r] = nm[r];
          }
        }
        release(j, 0);
      }
      float mb[2], iv[2], de[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        dl[r] += __shfl_xor_sync(FULL, dl[r], 1);
        dl[r] += __shfl_xor_sync(FULL, dl[r], 2);
        const int row = tile * SB_ROWS + 16 * wq + (lane >> 2) + 8 * r;
        mb[r] = mx[r] * sl2;
        iv[r] = row < S ? 1.f / l[r] : 0.f;
        de[r] = row < S ? dl[r] / l[r] : 0.f;
        if ((lane & 3) == 0) {
          float* at = stats + it * 3 * plane + row;
          at[0] = mb[r];
          at[plane] = iv[r];
          at[2 * plane] = de[r];
        }
      }
      // pass 2: dS = P (dP - delta) * scale, rounded to bf16, dQ += dS K
      float dq[DP / 8][4];
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) dq[c][0] = dq[c][1] = dq[c][2] = dq[c][3] = 0.f;
      uint32_t fa[KN / 16][4];
      auto make_ds = [&](int k0) {
        mask(s, k0);
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = bya::fast_exp2(fmaf(s[c][e], sl2, -mb[e >> 1])) * iv[e >> 1];
            dp[c][e] = p * (dp[c][e] - de[e >> 1]) * scale;
          }
      };
      auto issue_dq = [&](const unsigned char* kb, int hs) {
        bya::wg_fence();
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p)
            bya::wgmma_rs<1>(&dq[p * 8][0], fa[kk],
                             bya::desc_mnmajor(kb + p * SB_PANEL + (hs * KN + kk * 16) * 128));
        bya::wg_commit();
      };
      // step t = (block t / NSUB, part t % NSUB): its S and dP are made while
      // step t - 1's dQ product runs
      const int n_steps = T * NSUB;
      const unsigned char* kb = block(0, 1);
      issue_sdp(s, dp, kb, 0);
      bya::wg_wait<0>();
      bya::fence_regs<KN / 2>(&s[0][0]);
      bya::fence_regs<KN / 2>(&dp[0][0]);
      make_ds(0);
      bya::acc_to_a_frags<KN / 16>(fa, dp);
      for (int t = 1; t < n_steps; ++t) {
        const int j = t / NSUB, hs = t % NSUB;
        const unsigned char* kn = hs == 0 ? block(j, 1) : kb;
        issue_sdp(s, dp, kn, hs);
        issue_dq(kb, (t - 1) % NSUB);
        bya::wg_wait<1>();
        bya::fence_regs<KN / 2>(&s[0][0]);
        bya::fence_regs<KN / 2>(&dp[0][0]);
        make_ds(j * SB_ROWS + hs * KN);
        bya::wg_wait<0>();
        bya::fence_regs<DP / 2>(&dq[0][0]);
        if (hs == 0) release(j - 1, 1);
        bya::acc_to_a_frags<KN / 16>(fa, dp);
        kb = kn;
      }
      issue_dq(kb, (n_steps - 1) % NSUB);
      bya::wg_wait<0>();
      bya::fence_regs<DP / 2>(&dq[0][0]);
      release(T - 1, 1);
      if (!resident) ring_n += 2 * T;
      store(dq, false, o0, true);
    } else {
      // ---- the kv-major unit: dV = P^T G, dK = dS^T Q over the q blocks ----
      const unsigned char* ks = us;                  // K's panels
      const unsigned char* vs = us + NP * SB_PANEL;  // V's
      // the statistics of block j: pointer and plane stride
      auto stats_of = [&](int j, const unsigned char* qb, int& stride) -> const float* {
        if (resident) {
          stride = plane;
          return reinterpret_cast<const float*>(kvb + T * BLK) + j * SB_ROWS;
        }
        stride = SB_ROWS;
        return reinterpret_cast<const float*>(qb + BLK);
      };
      // X^T = A B^T for A the unit's tensor at `a`, B block qb's at `b`
      auto issue_t = [&](float (&x)[8][4], const unsigned char* a, const unsigned char* b) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          bya::wgmma_ss<0, 0>(&x[0][0], bya::desc_kmajor(a + (kk / 4) * SB_PANEL + (kk % 4) * 32),
                              bya::desc_kmajor(b + (kk / 4) * SB_PANEL + (kk % 4) * 32), kk > 0);
      };
      // acc += F^T-fragments times block qb's tensor at `b` (read transposed)
      auto issue_acc = [&](float (&acc)[DP / 8][4], const uint32_t (&f)[4][4],
                           const unsigned char* b) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p)
            bya::wgmma_rs<1>(&acc[p * 8][0], f[kk],
                             bya::desc_mnmajor(b + p * SB_PANEL + kk * 16 * 128));
      };
      // P^T of block j from its statistics (a column pair's by one load);
      // q columns past S are 0 (the last block, where it reaches past S)
      auto make_p = [&](float (&x)[8][4], int j, const float* sm, int ss) {
        const int edge = (j + 1) * SB_ROWS > S ? S - j * SB_ROWS : SB_ROWS;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * i + 2 * (lane & 3);
          const float2 mb = *reinterpret_cast<const float2*>(sm + c);
          const float2 iv = *reinterpret_cast<const float2*>(sm + ss + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = bya::fast_exp2(fmaf(x[i][e], sl2, (e & 1) ? -mb.y : -mb.x)) *
                            ((e & 1) ? iv.y : iv.x);
            x[i][e] = c + (e & 1) < edge ? p : 0.f;
          }
        }
      };
      // dS^T = P^T (dP^T - delta) * scale, in place in d, P^T read from
      // the exchange slot xb as it goes
      auto make_ds = [&](float (&d)[8][4], const float4* xb, const float* sm, int ss) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 de = *reinterpret_cast<const float2*>(sm + 2 * ss + 8 * i + 2 * (lane & 3));
          const float4 pt = xb[i * 128 + tw];
          d[i][0] = pt.x * (d[i][0] - de.x) * scale;
          d[i][1] = pt.y * (d[i][1] - de.y) * scale;
          d[i][2] = pt.z * (d[i][2] - de.x) * scale;
          d[i][3] = pt.w * (d[i][3] - de.y) * scale;
        }
      };
      {
        // group 0 of the pair: S^T, P^T (published), dV; group 1: dP^T,
        // dS^T, dK
        const bool pg = wg % 2 == 0;
        float acc[DP / 8][4], x[8][4];
#pragma unroll
        for (int c = 0; c < DP / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
        uint32_t fr[4][4];
        // the group's score operands: K and Q, or V and G (chosen by
        // pointer: a wgmma on a divergent path is serialised)
        const unsigned char* ta = pg ? ks : vs;
        const int tb = pg ? 0 : NP * SB_PANEL;
        auto issue_sc = [&](const unsigned char* qb) {
          bya::wg_fence();
          issue_t(x, ta, qb + tb);
          bya::wg_commit();
        };
        // block j's P^T or dS^T in x, through the exchange
        auto probs = [&](int j, const unsigned char* qb) {
          int ss;
          const float* sm = stats_of(j, qb, ss);
          const int xs = (int)(x_n % NX), xi = slot * 2 + xs;
          float4* xb = reinterpret_cast<float4*>(xbuf + (slot * NX + xs) * (SB_XBUF / 4));
          if (pg) {
            make_p(x, j, sm, ss);
            if (x_n >= NX) bya::mbar_wait(&x_empty[xi], (int)((x_n / NX - 1) & 1));
#pragma unroll
            for (int i = 0; i < 8; ++i) xb[i * 128 + tw] = make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
            bya::mbar_arrive(&x_full[xi]);
          } else {
            bya::mbar_wait(&x_full[xi], (int)((x_n / NX) & 1));
            make_ds(x, xb, sm, ss);
            bya::mbar_arrive(&x_empty[xi]);
          }
          ++x_n;
        };
        // group 0's operand is G (dV = P^T G), group 1's Q (dK = dS^T Q)
        const int acc_off = pg ? NP * SB_PANEL : 0;
        const unsigned char* qb = block(0, 0);
        issue_sc(qb);
        bya::wg_wait<0>();
        bya::fence_regs<32>(&x[0][0]);
        probs(0, qb);
        bya::acc_to_a_frags<4>(fr, x);
        for (int j = 1; j <= T; ++j) {
          const unsigned char* qn = j < T ? block(j, 0) : nullptr;
          if (j < T) issue_sc(qn);
          bya::wg_fence();
          issue_acc(acc, fr, qb + acc_off);
          bya::wg_commit();
          if (j < T) {
            bya::wg_wait<1>();
            bya::fence_regs<32>(&x[0][0]);
            probs(j, qn);
          }
          bya::wg_wait<0>();
          bya::fence_regs<DP / 2>(&acc[0][0]);
          release(j - 1, 0);
          if (j < T) bya::acc_to_a_frags<4>(fr, x);
          qb = qn;
        }
        if (!resident) ring_n += T;
        // dV over K's panels (only group 0 reads K), dK over V's (group 1's)
        store(acc, !pg, pg ? o1 : o0, true);
      }
    }
    ++n;
  }
}

#define SBWD_PARAMS                                                                         \
  const __grid_constant__ CUtensorMap ua, const __grid_constant__ CUtensorMap ub,           \
      const __grid_constant__ CUtensorMap ba, const __grid_constant__ CUtensorMap bb,       \
      const __grid_constant__ CUtensorMap o0, const __grid_constant__ CUtensorMap o1,       \
      float *__restrict__ stats, long long units, int H, int S, float scale,               \
      const __grid_constant__ SBwdGeo geo

// B8's streamed body, first kernel: each row's statistics, then dQ
template <int DP>
__global__ void __launch_bounds__(SBwd<DP, false>::THREADS, 1)
tiny_seq_stream_dq_kernel(SBWD_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  stream_bwd_body<DP, false>(smem_raw, &ua, &ub, &ba, &bb, &o0, &o1, stats, units, H, S, scale,
                             geo);
}

// B8's streamed body, second kernel: dK and dV from the first kernel's
// statistics
template <int DP>
__global__ void __launch_bounds__(SBwd<DP, true>::THREADS, 1)
tiny_seq_stream_dkv_kernel(SBWD_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  stream_bwd_body<DP, true>(smem_raw, &ua, &ub, &ba, &bb, &o0, &o1, stats, units, H, S, scale,
                            geo);
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

// One of B8's two streamed kernels (KVM: the kv-major one) over the M H T
// units: one block an SM (its shared memory), each walking an equal
// contiguous share.  An item's blocks stay resident when a buffer fits (two
// buffers, then two unit stages a slot, then two exchange slots preferred in
// that order), else they stream through one slot's ring (2 to 4 blocks).
template <int DP, bool KVM>
cudaError_t launch_stream_bwd_pass(const CUtensorMap& ua, const CUtensorMap& ub,
                                   const CUtensorMap& ba, const CUtensorMap& bb,
                                   const CUtensorMap& o0, const CUtensorMap& o1, float* stats,
                                   int M, int S, int H, float scale, cudaStream_t st) {
  using G = SBwd<DP, KVM>;
  constexpr int BLK = G::BLK;
  auto kernel = KVM ? tiny_seq_stream_dkv_kernel<DP> : tiny_seq_stream_dq_kernel<DP>;
  const int T = (S + SB_ROWS - 1) / SB_ROWS;
  const long long room = SMEM_LIMIT - 2048;  // the base's alignment and the barriers' kilobyte
  auto kb1 = [](long long b) { return (b + 1023) / 1024 * 1024; };
  const long long res_buf = kb1((long long)T * BLK + (KVM ? 3LL * T * SB_ROWS * 4 : 0));
  const long long ring_buf = kb1(BLK + (KVM ? SB_STATS : 0));
  const int nx_max = KVM ? 2 : 0, nx_min = KVM ? 1 : 0;
  const int max_slots = KVM ? G::NWG / 2 : G::NWG;
  SBwdGeo geo{};
  geo.T = T;
  bool found = false;
  // resident: every slot at work, then fewer; two buffers, then one; two
  // stages, then one; two exchange slots, then one
  for (int sl = max_slots; sl >= 1 && !found; --sl)
    for (int nkv = 2; nkv >= 1 && !found; --nkv)
      for (int nst = 2; nst >= 1 && !found; --nst)
        for (int nx = nx_max; nx >= nx_min && !found; --nx)
          if ((long long)sl * (nst * BLK + nx * SB_XBUF) + nkv * res_buf <= room) {
            geo = {T, 1, nkv, nst, sl, nx, 0, 0, 0, (int)res_buf};
            found = true;
          }
  // streamed: one slot, its ring of 2 to 4 blocks
  for (int nst = 2; nst >= 1 && !found; --nst)
    for (int nx = nx_max; nx >= nx_min && !found; --nx) {
      const long long nkv = (room - (long long)nst * BLK - nx * SB_XBUF) / ring_buf;
      if (nkv >= 2) {
        geo = {T, 0, (int)(nkv < 4 ? nkv : 4), nst, 1, nx, 0, 0, 0, (int)ring_buf};
        found = true;
      }
    }
  if (!found) return cudaErrorInvalidConfiguration;
  geo.st_off = 1024;
  geo.kv_off = geo.st_off + geo.slots * geo.NST * BLK;
  geo.x_off = geo.kv_off + geo.NKV * geo.buf;
  const int smem = geo.x_off + geo.slots * geo.NX * SB_XBUF + 1024;
  static int sms = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {  // once: the SM count, the kernel's limit raised to a block's whole
    int dev = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const long long units = (long long)M * H * T, fit = (long long)sms * per_sm;
  kernel<<<(unsigned)(units < fit ? units : fit), G::THREADS, smem, st>>>(
      ua, ub, ba, bb, o0, o1, stats, units, H, S, scale, geo);
  return cudaGetLastError();
}

// `stats`: M x H x 3 x T 64 floats of scratch (T = ceil(S / 64): each row's
// max in log2 units, 1 / sum, delta), written by the first kernel
template <int DP>
cudaError_t launch_stream_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                              bf16* dq, bf16* dk, bf16* dv, float* stats, int M, int S, int H,
                              int dh, float scale, cudaStream_t st) {
  const bya::Layout L = bya::make_layout(S, H, dh, 1);  // [M, S, H, dh]
  CUtensorMap tq, tk, tv, tg, tdq, tdk, tdv;
  if (!bya::make_map(&tq, q, L, M, H, S, dh, SB_ROWS) ||
      !bya::make_map(&tk, k, L, M, H, S, dh, SB_ROWS) ||
      !bya::make_map(&tv, v, L, M, H, S, dh, SB_ROWS) ||
      !bya::make_map(&tg, g, L, M, H, S, dh, SB_ROWS) ||
      !bya::make_map(&tdq, dq, L, M, H, S, dh, SB_ROWS) ||
      !bya::make_map(&tdk, dk, L, M, H, S, dh, SB_ROWS) ||
      !bya::make_map(&tdv, dv, L, M, H, S, dh, SB_ROWS))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      launch_stream_bwd_pass<DP, false>(tq, tg, tk, tv, tdq, tdq, stats, M, S, H, scale, st);
  if (err != cudaSuccess) return err;
  return launch_stream_bwd_pass<DP, true>(tk, tv, tq, tg, tdk, tdv, stats, M, S, H, scale, st);
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
// forward's; `stats`: 3 x M x H x T 64 floats of device scratch, T =
// ceil(S / 64) (each row's max, 1 / sum and delta, from the first kernel to
// the second).  Returns
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
