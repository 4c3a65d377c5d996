// B5 (and B5', and B8 its backward): multi-head self-attention over a tiny sequence, per row of a
// huge batch, channel-packed:
//   q, k, v, o: [M, S, H*dh]; head h = channels [dh h, dh h + dh)
//   o[m, a, h] = sum_b softmax_b(q[m, a, h] . k[m, b, h] * scale) v[m, b, h]
// for every dh % 8 == 0 up to 256 (the router's STAB: 8 heads of 64 at the
// 5B, 4 of 128 or 16 of 32 at other `attn_heads`).
//
// Replaces two TPU kernels of bindyouravatar_tpu/ops/packed_attention.py
// that compute this one function:
//   * B5, `_slice_kernel` (per-head lane slices, S >= 8), reached through
//     `tiny_seq_attention` from the router's temporal STAB attention
//     (S = T = 13 latent frames, M = B*I*H*W = 5,400 rows at the 5B path);
//   * B5', `_kernel` (the packed-head fold with a block-diagonal head mask,
//     S < 8), reached through `packed_head_attention` from the same call at
//     fewer than 8 latent frames.  Its [M, S*H, dh] operand is the same
//     memory as [M, S, H*dh], so one kernel, instantiated per S, serves both.
// Same math and roundings: fp32 scores, fp32 softmax normalised before p is
// rounded to bf16, fp32 P.V, bf16 store.
//
// What bounds it on the H100: memory.  Per (row, head) it reads 3 * S * 128 B
// and writes S * 128 B against 4 * S^2 * 64 FLOP: at S = 13, 6.5 FLOP/B.  At
// [5400, 13, 8*64] a call moves ~288 MB: ~0.086 ms at 3.35 TB/s.  On the
// tensor cores an item's products take a few instructions a warp, so the
// loads and stores, not the arithmetic, set its time.
//
// B8, `tiny_seq_attention`'s backward at S >= 8, replaces `_slice_bwd_kernel`
// (reached through `_tiny_bwd_pallas` from the custom vjp `_tiny_bwd`): the
// softmax vjp per (row, head) in fp32, scores recomputed (P and dS rounded
// to bf16 as operands of the last three products: see its design below),
//   dv_b = sum_a p_ab g_a,  dp_ab = g_a . v_b,
//   ds_ab = p_ab (dp_ab - sum_b' p_ab' dp_ab') * scale,
//   dq_a = sum_b ds_ab k_b,  dk_b = sum_a ds_ab q_a,
// written flat [M, S, H*dh] in the input dtype.  Memory bound as the
// forward: 4 tensors read, 3 written (~252 MB at [2700, 13, 512], 0.075 ms
// at 3.35 TB/s) against ~10 S^2 * 64 FLOP per (row, head).
//
// Design (B5, B5'): one (m, head) item is one tile of S rows padded to 16,
// so its two products run on the tensor cores.  A persistent kernel of
// 4-warp blocks, sized by occupancy; each warp walks its tiles with the
// next tile's q, k and v in flight by cp.async into the second of two
// shared-memory buffers while it computes on the first.  Per tile, with A
// from ldmatrix (or from the fp32 score fragments) and B from ldmatrix
// (.trans for V), mma.sync m16n8k16 bf16 -> fp32:
//   S = Q K^T                           (8 products)
//   P = softmax(S * scale) in fp32 in the fragments, the key columns of
//   other items and past the tile's rows masked, row max and row sum by 2
//   xor shuffles each; P is normalised in fp32 before it is rounded to
//   bf16 as the A operand, as `_slice_kernel` rounds p / sum
//   O = P V                             (8 products)
// O is staged over the q tile and leaves as 16-byte rows.  Below S = 9 a
// tile packs 16 / S consecutive items (the block-diagonal mask of B5''s
// packed-head fold, `_kernel`), so short sequences do not pad 16 rows an
// item.  S is a template parameter (1..16).
//
// B8 is the same design with four tiles an item (q, k, v, g) and S >= 8.
//
// Past 16 rows (the router's temporal STAB at 81 and 97 frames: S = 21,
// 25 latent frames) an item no longer fits one tile.  The long bodies
// (B5, B5' and B8 at 16 < S <= LONG_MAX_S) give a warp one whole item at a
// time: q, k, v (and g) in shared memory, S rows padded to 16 * nt,
// double-buffered across items by cp.async as above; blocks of one warp,
// as many resident as shared memory allows (the smem of an item grows
// with S, so no share of a block waits on another warp).  Inside an item
// the warp loops over 16-row q tiles and 16-row kv chunks, the numerics
// of the one-tile bodies kept: fp32 scores, the row max and sum found
// first (one pass over the chunks, the sum rescaled as the max grows),
// then P = 2^(s - max) / sum normalised in fp32 before it is rounded to
// bf16.  The forward's O tile leaves over its q tile (its fragments are in
// registers).  The backward finds each row's max, 1 / sum and delta =
// sum_b p_ab dp_ab in one pass (kept in shared memory), then dQ a q tile
// at a time (dS K over the chunks), then dK and dV a kv chunk at a time
// (dS^T Q and P^T G over the q tiles), each through a 16-row staging tile:
// no sums across items or warps, so it stays bitwise repeatable.  The
// item's smem sets the cap: LONG_MAX_S = 192 at dh 64 (the backward's two
// buffers of four tensors take 225,792 bytes there; other widths below).
// Past the cap (the temporal STAB at T = 193 and more at dh 64, a 769-frame
// clip; T = 49 at dh 256) the streamed bodies run: a four-warp block takes a
// 64-row group of one item and streams the other side's rows through
// shared memory in fixed chunks, so their shared memory does not grow with
// S and JAX's any-S kernels have a counterpart at every length
// (`packed_attention_stream.cu`, which holds their design).
//
// Head widths.  Every body is templated on its width DP = 64, 128 or 256
// columns, and a head of dh columns runs on the narrowest that holds it
// (`kernel_body` in the Python wrapper is the rule), as the flash kernels
// do.  Narrower heads ride a wider body padded, not instantiated per dh:
// one instance per (body, S) keeps the build to 3 x 27 kernels where one
// per dh % 8 would take 32 x 27 (the long bodies are compiled twice a body:
// with dh = DP known, which kept them at their dh-64 times, and with a
// run-time dh narrower than DP), and the copies already work in 16-byte
// chunks, so a row's chunks past dh / 8 are simply not loaded.  Shared
// memory is zeroed once when a block starts; the loads write only a row's
// first dh / 8 chunks and every output leaves only those, so the columns
// past dh stay zero (each product over them adds 0, and every staged
// output's pad columns are exact zeros: products with the zero columns of
// V, G, K or Q).  A narrow head pays its body's product width, not its
// bytes.  The blocks' warps scale as 4 x 64 / DP, so a block's shared
// memory is about the same at every body.  The one-tile bodies hold a
// tile's whole output row (DP / 2 fp32 registers a thread: 128 at DP =
// 256); the long bodies make their outputs 64 columns at a time,
// recomputing the scores per panel (at DP = 64, one panel: unchanged;
// panels wholly past dh are skipped), and at DP = 256 B8's long body reads
// its A operands from shared memory as it goes (`ATile`), so no thread
// holds q's and g's fragments (128 registers) beside two panels' sums.  The long bodies' cap is the largest S whose backward
// item (two buffers of four [16 nt, DP + 8] tensors, a staging tile and
// three floats a row) fits the 232,448 bytes of a block: LONG_MAX_S = 192
// at DP = 64, 96 at 128, 48 at 256 (`Geo::LONG_MAX_S`), all past the 25
// latent frames of a 97-frame clip.
#include "packed_attention.cuh"

namespace {

constexpr int MAX_S = 16;         // the one-tile bodies

// The shapes of the DP-column body
template <int DP>
struct Geo {
  static constexpr int LDS = DP + 8;        // padded smem row: conflict-free ldmatrix
  static constexpr int TILE = 16 * LDS;     // one [16, DP] operand tile, bf16 elements
  static constexpr int CPR = DP / 8;        // 16-byte chunks in a row
  static constexpr int KS = DP / 16;        // k steps of 16 over a row
  static constexpr int ND = DP / 8;         // 8-column blocks of a row
  static constexpr int NPN = DP / 64;       // 64-column output panels
  static constexpr int WARPS = 4 * 64 / DP;  // a one-tile block's warps: 4, 2, 1
  static constexpr int FWD_SMEM = WARPS * 2 * 3 * TILE * (int)sizeof(bf16);  // q, k, v, x2
  static constexpr int BWD_SMEM = WARPS * 2 * 4 * TILE * (int)sizeof(bf16);  // + g
  // the long bodies, nt 16-row tiles an item: the forward's two buffers of
  // q, k, v; the backward's two of q, k, v, g, a staging tile and each
  // row's max, 1 / sum and delta
  static constexpr int long_fwd_smem(int nt) { return 2 * 3 * nt * TILE * (int)sizeof(bf16); }
  static constexpr int long_bwd_smem(int nt) {
    return (2 * 4 * nt + 1) * TILE * (int)sizeof(bf16) + 3 * nt * 16 * (int)sizeof(float);
  }
  static constexpr int LONG_NT =
      (SMEM_LIMIT - TILE * (int)sizeof(bf16)) / (8 * TILE * (int)sizeof(bf16) + 48 * 4);
  static constexpr int LONG_MAX_S = 16 * LONG_NT;
};
static_assert(Geo<64>::LONG_MAX_S == 192 && Geo<128>::LONG_MAX_S == 96 &&
                  Geo<256>::LONG_MAX_S == 48,
              "the long bodies' caps (kernel_body's MAX_S in ops/packed_attention.py)");
static_assert(Geo<64>::long_bwd_smem(Geo<64>::LONG_NT) <= SMEM_LIMIT &&
                  Geo<128>::long_bwd_smem(Geo<128>::LONG_NT) <= SMEM_LIMIT &&
                  Geo<256>::long_bwd_smem(Geo<256>::LONG_NT) <= SMEM_LIMIT,
              "B8's long body past the smem of a block");
static_assert(Geo<256>::BWD_SMEM <= SMEM_LIMIT, "B8's one-tile body past the smem of a block");

// acc[nd] = A (16 x 16) * T (16 x 8 ND)
template <int ND, int LDS>
__device__ __forceinline__ void mma_a_tile(float (&acc)[ND][4], const uint32_t (&a)[4],
                                           const bf16* tile, int lane) {
  zero_acc(acc);
  mma_a_tile_add<ND, LDS>(acc, a, tile, lane);
}

// `n` bf16 elements of shared memory from `sm` to zero (n % 8 == 0), by a warp
__device__ __forceinline__ void zero_smem(bf16* sm, int n, int lane) {
  for (int i = lane * 8; i < n; i += 32 * 8)
    *reinterpret_cast<uint4*>(sm + i) = make_uint4(0u, 0u, 0u, 0u);
}

// B5 / B5': a warp takes one tile at a time, PACK = 16 / S consecutive
// (m, head) items of S rows each ([PACK * S, dh] of q, k and v, padded to
// 16 rows and DP columns); see the design at the top.
template <int DP, int S>
__global__ void __launch_bounds__(Geo<DP>::WARPS * 32)
tiny_seq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, long long n_items, int H,
                int dh, float scale) {
  using G = Geo<DP>;
  constexpr int LDS = G::LDS, TILE = G::TILE, CPR = G::CPR, TILES = 3 * TILE;
  constexpr int PACK = 16 / S;
  constexpr int ROWS = PACK * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* sm = reinterpret_cast<bf16*>(smem_raw) + warp * 2 * TILES;  // this warp's two tiles
  const long long ld = (long long)H * dh;
  const int ch = dh / 8;  // a row's chunks that hold the head
  const long long n_tiles = (n_items + PACK - 1) / PACK;
  const long long step = (long long)gridDim.x * G::WARPS;
  const float scale_log2 = scale * LOG2E;

  // rows ROWS..15 and columns dh..DP-1 of every tile stay zero: loads and
  // the staged output write rows < ROWS, loads columns < dh only
  zero_smem(sm, 2 * TILES, lane);
  // a tile's first item and its (m, head): one division a tile
  struct First {
    long long item, m;
    int h;
  };
  auto first_of = [&](long long tile) {
    const long long item = tile * PACK, m = item / H;
    return First{item, m, (int)(item - m * H)};
  };
  // the offset in [M, S, H*dh] of chunk c of the tile's row r (row r % S of
  // its item r / S), or -1 for an item past the end
  auto chunk_offset = [&](const First& f, int r, int c) -> long long {
    const int j = r / S;
    if (f.item + j >= n_items) return -1;
    long long m = f.m;
    int h = f.h + j;
    for (; h >= H; h -= H) ++m;
    return m * S * ld + (long long)h * dh + (long long)(r - j * S) * ld + c * 8;
  };
  const bf16* const srcs[3] = {q, k, v};
  // tile `tile`'s rows of q, k and v into buffer `buf`, the rows of items
  // past the end zero-filled (an empty group past the last tile)
  auto load = [&](int buf, long long tile) {
    if (tile < n_tiles) {
      const First f = first_of(tile);
      for (int i = lane; i < ROWS * CPR; i += 32) {
        const int r = i / CPR, c = i % CPR;
        if (c >= ch) continue;
        const long long off = chunk_offset(f, r, c);
        const int dst = r * LDS + c * 8;
#pragma unroll
        for (int t = 0; t < 3; ++t)
          bya::cp_async16(sm + buf * TILES + t * TILE + dst, srcs[t] + (off < 0 ? 0 : off),
                          off < 0 ? 0 : 16);
      }
    }
    bya::cp_async_commit();
  };

  long long tile = (long long)blockIdx.x * G::WARPS + warp;
  int buf = 0;
  load(0, tile);
  for (; tile < n_tiles; tile += step, buf ^= 1) {
    load(buf ^ 1, tile + step);
    bya::cp_async_wait<1>();
    __syncwarp();
    bf16* qs = sm + buf * TILES;
    const bf16* ks = qs + TILE;
    const bf16* vs = ks + TILE;

    // S = Q K^T; fragment element (nt, e) is row r0 + 8 (e >> 1), column
    // nt * 8 + c0 + (e & 1)
    float s[2][4] = {};
    {
      uint32_t af[G::KS][4];
      bya::load_a_frags<G::KS, LDS>(af, qs, lane);
      bya::qk_scores<2, G::KS, LDS>(s, af, ks, lane);
    }

    // a key column counts for a row of the same item (block-diagonal when
    // PACK > 1); the rows past ROWS get p = 0
    const int r0 = lane >> 2, c0 = 2 * (lane & 3);
    auto keep = [&](int nt, int e) {
      const int r = r0 + 8 * (e >> 1), c = nt * 8 + c0 + (e & 1);
      return c < ROWS && (PACK == 1 || r / S == c / S);
    };
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (keep(nt, e)) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = keep(nt, e) ? exp2f((s[nt][e] - mx[e >> 1]) * scale_log2) : 0.f;
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
      inv[i] = r0 + 8 * i < ROWS ? 1.f / sum[i] : 0.f;
    }
    // P normalised in fp32, then rounded to bf16 as the A operand of O = P V
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];
    const uint32_t p_a[4] = {bya::pack_bf16(s[0][0], s[0][1]), bya::pack_bf16(s[0][2], s[0][3]),
                             bya::pack_bf16(s[1][0], s[1][1]), bya::pack_bf16(s[1][2], s[1][3])};
    float acc[G::ND][4];
    mma_a_tile<G::ND, LDS>(acc, p_a, vs, lane);
    __syncwarp();  // every lane's q fragments are read: O goes over q
    stage_rows<G::ND, LDS>(qs, acc, lane, ROWS);
    __syncwarp();
    const First f = first_of(tile);
    for (int i = lane; i < ROWS * CPR; i += 32) {
      const int r = i / CPR, c = i % CPR;
      if (c >= ch) continue;
      const long long off = chunk_offset(f, r, c);
      if (off >= 0)
        *reinterpret_cast<uint4*>(o + off) = *reinterpret_cast<const uint4*>(qs + r * LDS + c * 8);
    }
    __syncwarp();
  }
}

// B8 on the tensor cores: a warp takes one (m, head) item at a time, a
// [S, dh] tile of each of q, k, v and g padded to 16 rows and DP columns,
// in shared memory rows of LDS elements.  Per item, with A from ldmatrix
// (or from the fp32 score fragments), B from ldmatrix (.trans where the
// operand is row-major along n) and mma.sync m16n8k16 bf16 -> fp32:
//   S = Q K^T, dP = G V^T          (2 x DP / 8 products)
//   P = softmax(S * scale) in fp32 in the fragments, key columns >= S and
//   query rows >= S zeroed; delta = rowsum(P o dP); dS = P o (dP - delta) * scale
//   dV = P^T G, dQ = dS K, dK = dS^T Q   (3 x DP / 8 products; P and dS
//   rounded to bf16 as their A operand, P^T and dS^T by movmatrix)
// 40 products an item at DP = 64, where the warp-shuffle version reduced
// ~1,690 scores and dP entries across the warp.  The outputs leave through
// the item's own tiles (dV over g, dQ over k, dK over q, each once its
// operand is read) as 16-byte chunks.
template <int DP, int S>
__global__ void __launch_bounds__(Geo<DP>::WARPS * 32)
tiny_seq_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    long long n_items, int H, int dh, float scale) {
  using G = Geo<DP>;
  constexpr int LDS = G::LDS, TILE = G::TILE, CPR = G::CPR, ITEM = 4 * TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* sm = reinterpret_cast<bf16*>(smem_raw) + warp * 2 * ITEM;  // this warp's two items
  const long long ld = (long long)H * dh;
  const int ch = dh / 8;
  const long long step = (long long)gridDim.x * G::WARPS;
  const float scale_log2 = scale * LOG2E;

  // rows S..15 and columns dh..DP-1 of every tile stay zero: loads and
  // staged outputs write rows < S, loads columns < dh only
  zero_smem(sm, 2 * ITEM, lane);
  const bf16* const srcs[4] = {q, k, v, g};
  auto base_of = [&](long long it) {
    return (it / H) * S * ld + (long long)(it % H) * dh;
  };
  // item `it`'s rows of q, k, v and g into buffer `buf` (an empty group past the end)
  auto load = [&](int buf, long long it) {
    if (it < n_items) {
      const long long base = base_of(it);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        for (int i = lane; i < S * CPR; i += 32) {
          const int r = i / CPR, c = i % CPR;
          if (c < ch)
            bya::cp_async16(sm + buf * ITEM + t * TILE + r * LDS + c * 8,
                            srcs[t] + base + r * ld + c * 8, 16);
        }
    }
    bya::cp_async_commit();
  };

  long long item = (long long)blockIdx.x * G::WARPS + warp;
  int buf = 0;
  load(0, item);
  for (; item < n_items; item += step, buf ^= 1) {
    load(buf ^ 1, item + step);
    bya::cp_async_wait<1>();
    __syncwarp();
    bf16* qs = sm + buf * ITEM;
    bf16* ks = qs + TILE;
    bf16* vs = ks + TILE;
    bf16* gs = vs + TILE;

    // S = Q K^T and dP = G V^T; fragment element (nt, e) is row
    // r0 + 8 (e >> 1), column nt * 8 + c0 + (e & 1)
    float s[2][4] = {}, dp[2][4] = {};
    {
      uint32_t af[G::KS][4];
      bya::load_a_frags<G::KS, LDS>(af, qs, lane);
      bya::qk_scores<2, G::KS, LDS>(s, af, ks, lane);
      bya::load_a_frags<G::KS, LDS>(af, gs, lane);
      bya::qk_scores<2, G::KS, LDS>(dp, af, vs, lane);
    }

    const int r0 = lane >> 2, c0 = 2 * (lane & 3);
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nt * 8 + c0 + (e & 1) < S) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = nt * 8 + c0 + (e & 1) < S ? exp2f((s[nt][e] - mx[e >> 1]) * scale_log2)
                                                   : 0.f;
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
    float delta[2] = {0.f, 0.f}, inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
      inv[i] = r0 + 8 * i < S ? 1.f / sum[i] : 0.f;  // query rows >= S: p = 0
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= inv[e >> 1];
        delta[e >> 1] += s[nt][e] * dp[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(FULL, delta[i], 1);
      delta[i] += __shfl_xor_sync(FULL, delta[i], 2);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - delta[e >> 1]) * scale;

    // A operands: dS as it lies in the fragments, P^T and dS^T transposed
    // 8x8 block by block
    const uint32_t ds_a[4] = {
        bya::pack_bf16(dp[0][0], dp[0][1]), bya::pack_bf16(dp[0][2], dp[0][3]),
        bya::pack_bf16(dp[1][0], dp[1][1]), bya::pack_bf16(dp[1][2], dp[1][3])};
    const uint32_t pt_a[4] = {transpose8(bya::pack_bf16(s[0][0], s[0][1])),
                              transpose8(bya::pack_bf16(s[1][0], s[1][1])),
                              transpose8(bya::pack_bf16(s[0][2], s[0][3])),
                              transpose8(bya::pack_bf16(s[1][2], s[1][3]))};
    const uint32_t dst_a[4] = {transpose8(ds_a[0]), transpose8(ds_a[2]), transpose8(ds_a[1]),
                               transpose8(ds_a[3])};
    float acc[G::ND][4];
    mma_a_tile<G::ND, LDS>(acc, pt_a, gs, lane);  // dV = P^T G, staged over g
    __syncwarp();
    stage_rows<G::ND, LDS>(gs, acc, lane, S);
    mma_a_tile<G::ND, LDS>(acc, ds_a, ks, lane);  // dQ = dS K, over k
    __syncwarp();
    stage_rows<G::ND, LDS>(ks, acc, lane, S);
    mma_a_tile<G::ND, LDS>(acc, dst_a, qs, lane);  // dK = dS^T Q, over q
    __syncwarp();
    stage_rows<G::ND, LDS>(qs, acc, lane, S);
    __syncwarp();

    const long long base = base_of(item);
    bf16* const outs[3] = {dk, dq, dv};
    const bf16* const tiles[3] = {qs, ks, gs};
#pragma unroll
    for (int t = 0; t < 3; ++t)
      for (int i = lane; i < S * CPR; i += 32) {
        const int r = i / CPR, c = i % CPR;
        if (c < ch)
          *reinterpret_cast<uint4*>(outs[t] + base + r * ld + c * 8) =
              *reinterpret_cast<const uint4*>(tiles[t] + r * LDS + c * 8);
      }
    __syncwarp();
  }
}

// ---- the long bodies, 16 < S <= LONG_MAX_S: one warp a whole item ----
// An item's tensor takes nt = ceil(S / 16) tiles of 16 rows in shared memory.

// `count` tensors of item `it` ([M, S, H*dh], the item's rows at `base`)
// into consecutive spans of `dst` as one cp.async group
template <int DP>
__device__ __forceinline__ void load_item(bf16* dst, int span, const bf16* const* srcs,
                                          int count, long long base, long long ld, int S, int ch,
                                          int lane) {
  constexpr int LDS = DP + 8, CPR = DP / 8;
  for (int t = 0; t < count; ++t)
    for (int i = lane; i < S * CPR; i += 32) {
      const int r = i / CPR, c = i % CPR;
      if (c < ch)
        bya::cp_async16(dst + t * span + r * LDS + c * 8,
                        srcs[t] + base + (long long)r * ld + c * 8, 16);
    }
}

// DH_IS_DP: the head fills the body (dh == DP), known when compiled, so the
// chunk and panel tests fold away (the one-tile bodies did not measure the
// difference; the long ones ran 11-12% slower at dh 64 on a run-time dh)
template <int DP, bool DH_IS_DP>
__global__ void __launch_bounds__(32)
tiny_seq_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, long long n_items, int H,
                     int S, int dh, float scale) {
  using G = Geo<DP>;
  if constexpr (DH_IS_DP) dh = DP;
  constexpr int TILE = G::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x;
  const int nt = (S + 15) >> 4, span = nt * TILE;
  const long long ld = (long long)H * dh;
  const int ch = dh / 8;
  const float scale_log2 = scale * LOG2E;
  const int c0 = 2 * (lane & 3);
  zero_smem(sm, 2 * 3 * span, lane);  // rows past S, columns past dh
  const bf16* const srcs[3] = {q, k, v};
  auto base_of = [&](long long it) { return (it / H) * S * ld + (long long)(it % H) * dh; };
  auto load = [&](int buf, long long it) {
    if (it < n_items)
      load_item<DP>(sm + buf * 3 * span, span, srcs, 3, base_of(it), ld, S, ch, lane);
    bya::cp_async_commit();
  };

  long long item = blockIdx.x;
  int buf = 0;
  load(0, item);
  for (; item < n_items; item += gridDim.x, buf ^= 1) {
    load(buf ^ 1, item + gridDim.x);
    bya::cp_async_wait<1>();
    __syncwarp();
    bf16* qs = sm + buf * 3 * span;
    const bf16* ks = qs + span;
    const bf16* vs = ks + span;
    const long long base = base_of(item);
    for (int qt = 0; qt < nt; ++qt) {
      uint32_t af[G::KS][4];
      bya::load_a_frags<G::KS, G::LDS>(af, qs + qt * TILE, lane);
      // the row max and sum over every key column < S, the sum rescaled as
      // the max grows chunk by chunk
      float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f};
      for (int kc = 0; kc < nt; ++kc) {
        float s[2][4];
        scores16<DP>(s, af, ks + kc * TILE, lane);
        float cm[2] = {mx[0], mx[1]}, cs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kc * 16 + n * 8 + c0 + (e & 1) < S) cm[e >> 1] = fmaxf(cm[e >> 1], s[n][e]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          cm[i] = fmaxf(cm[i], __shfl_xor_sync(FULL, cm[i], 1));
          cm[i] = fmaxf(cm[i], __shfl_xor_sync(FULL, cm[i], 2));
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kc * 16 + n * 8 + c0 + (e & 1) < S)
              cs[e >> 1] += exp2f((s[n][e] - cm[e >> 1]) * scale_log2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sum[i] = sum[i] * exp2f((mx[i] - cm[i]) * scale_log2) + cs[i];
          mx[i] = cm[i];
        }
      }
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
        sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
        inv[i] = 1.f / sum[i];
      }
      // O = P V over the chunks, a 64-column panel at a time (the scores
      // recomputed per panel), P normalised in fp32, then rounded to bf16
      for (int pn = 0; pn < G::NPN && pn * 64 < dh; ++pn) {
        float acc[8][4];
        zero_acc(acc);
        for (int kc = 0; kc < nt; ++kc) {
          float s[2][4];
          scores16<DP>(s, af, ks + kc * TILE, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = kc * 16 + n * 8 + c0 + (e & 1) < S
                            ? exp2f((s[n][e] - mx[e >> 1]) * scale_log2) * inv[e >> 1]
                            : 0.f;
          const uint32_t p_a[4] = {
              bya::pack_bf16(s[0][0], s[0][1]), bya::pack_bf16(s[0][2], s[0][3]),
              bya::pack_bf16(s[1][0], s[1][1]), bya::pack_bf16(s[1][2], s[1][3])};
          mma_a_tile_add<8, G::LDS>(acc, p_a, vs + kc * TILE + pn * 64, lane);
        }
        // O leaves over its own q tile's panel: this tile's q is in the fragments
        write_tile<DP>(o, base, ld, qs + qt * TILE + pn * 64, acc, qt, pn, S, ch, lane);
      }
    }
  }
}

template <int DP, bool DH_IS_DP>
__global__ void __launch_bounds__(32)
tiny_seq_long_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                         long long n_items, int H, int S, int dh, float scale) {
  using G = Geo<DP>;
  if constexpr (DH_IS_DP) dh = DP;
  constexpr int TILE = G::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x;
  const int nt = (S + 15) >> 4, span = nt * TILE;
  const long long ld = (long long)H * dh;
  const int ch = dh / 8;
  const float scale_log2 = scale * LOG2E;
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
  bf16* const stg = sm + 2 * 4 * span;
  float* const row_max = reinterpret_cast<float*>(stg + TILE);
  float* const row_inv = row_max + nt * 16;
  float* const row_delta = row_inv + nt * 16;
  zero_smem(sm, 2 * 4 * span, lane);  // rows past S, columns past dh
  const bf16* const srcs[4] = {q, k, v, g};
  auto base_of = [&](long long it) { return (it / H) * S * ld + (long long)(it % H) * dh; };
  auto load = [&](int buf, long long it) {
    if (it < n_items)
      load_item<DP>(sm + buf * 4 * span, span, srcs, 4, base_of(it), ld, S, ch, lane);
    bya::cp_async_commit();
  };
  auto col_ok = [&](int kc, int n, int e) { return kc * 16 + n * 8 + c0 + (e & 1) < S; };

  long long item = blockIdx.x;
  int buf = 0;
  load(0, item);
  for (; item < n_items; item += gridDim.x, buf ^= 1) {
    load(buf ^ 1, item + gridDim.x);
    bya::cp_async_wait<1>();
    __syncwarp();
    const bf16* qs = sm + buf * 4 * span;
    const bf16* ks = qs + span;
    const bf16* vs = ks + span;
    const bf16* gs = vs + span;
    const long long base = base_of(item);

    // each row's max, 1 / sum and delta = sum_b p_ab dp_ab, one pass over
    // the chunks (the sum and delta rescaled as the max grows)
    for (int qt = 0; qt < nt; ++qt) {
      const ATile<DP> aq(qs + qt * TILE, lane), ag(gs + qt * TILE, lane);
      float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
      for (int kc = 0; kc < nt; ++kc) {
        float s[2][4], dp[2][4];
        aq.scores(s, ks + kc * TILE, lane);
        ag.scores(dp, vs + kc * TILE, lane);
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
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
        sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
        dl[i] += __shfl_xor_sync(FULL, dl[i], 1);
        dl[i] += __shfl_xor_sync(FULL, dl[i], 2);
        if ((lane & 3) == 0) {
          const int row = qt * 16 + r0 + 8 * i;
          row_max[row] = mx[i];
          row_inv[row] = 1.f / sum[i];
          row_delta[row] = dl[i] / sum[i];
        }
      }
    }
    __syncwarp();

    // P and dS of q tile qt (its A operands aq, ag) against kv chunk kc from
    // the row statistics: P normalised in fp32 (rows >= S and columns >= S
    // zero), dS = P o (dP - delta) * scale
    auto p_ds = [&](float (&s)[2][4], float (&dp)[2][4], const ATile<DP>& aq,
                    const ATile<DP>& ag, int qt, int kc) {
      aq.scores(s, ks + kc * TILE, lane);
      ag.scores(dp, vs + kc * TILE, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qt * 16 + r0 + 8 * i;
        const float m = row_max[row], iv = row < S ? row_inv[row] : 0.f, de = row_delta[row];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 2 * i + j;
            const float p = col_ok(kc, n, e) ? exp2f((s[n][e] - m) * scale_log2) * iv : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - de) * scale;
          }
      }
    };

    // dQ = dS K, a q tile and a 64-column panel at a time over the chunks
    for (int qt = 0; qt < nt; ++qt) {
      const ATile<DP> aq(qs + qt * TILE, lane), ag(gs + qt * TILE, lane);
      for (int pn = 0; pn < G::NPN && pn * 64 < dh; ++pn) {
        float acc[8][4];
        zero_acc(acc);
        for (int kc = 0; kc < nt; ++kc) {
          float s[2][4], dp[2][4];
          p_ds(s, dp, aq, ag, qt, kc);
          const uint32_t ds_a[4] = {
              bya::pack_bf16(dp[0][0], dp[0][1]), bya::pack_bf16(dp[0][2], dp[0][3]),
              bya::pack_bf16(dp[1][0], dp[1][1]), bya::pack_bf16(dp[1][2], dp[1][3])};
          mma_a_tile_add<8, G::LDS>(acc, ds_a, ks + kc * TILE + pn * 64, lane);
        }
        write_tile<DP>(dq, base, ld, stg + pn * 64, acc, qt, pn, S, ch, lane);
      }
    }

    // dV = P^T G and dK = dS^T Q, a kv chunk and a panel at a time over the
    // q tiles (P^T and dS^T transposed 8x8 block by block, as the one-tile body)
    for (int kc = 0; kc < nt; ++kc)
      for (int pn = 0; pn < G::NPN && pn * 64 < dh; ++pn) {
        float acc_k[8][4], acc_v[8][4];
        zero_acc(acc_k);
        zero_acc(acc_v);
        for (int qt = 0; qt < nt; ++qt) {
          const ATile<DP> aq(qs + qt * TILE, lane), ag(gs + qt * TILE, lane);
          float s[2][4], dp[2][4];
          p_ds(s, dp, aq, ag, qt, kc);
          const uint32_t pt_a[4] = {transpose8(bya::pack_bf16(s[0][0], s[0][1])),
                                    transpose8(bya::pack_bf16(s[1][0], s[1][1])),
                                    transpose8(bya::pack_bf16(s[0][2], s[0][3])),
                                    transpose8(bya::pack_bf16(s[1][2], s[1][3]))};
          const uint32_t dst_a[4] = {transpose8(bya::pack_bf16(dp[0][0], dp[0][1])),
                                     transpose8(bya::pack_bf16(dp[1][0], dp[1][1])),
                                     transpose8(bya::pack_bf16(dp[0][2], dp[0][3])),
                                     transpose8(bya::pack_bf16(dp[1][2], dp[1][3]))};
          mma_a_tile_add<8, G::LDS>(acc_v, pt_a, gs + qt * TILE + pn * 64, lane);
          mma_a_tile_add<8, G::LDS>(acc_k, dst_a, qs + qt * TILE + pn * 64, lane);
        }
        write_tile<DP>(dk, base, ld, stg + pn * 64, acc_k, kc, pn, S, ch, lane);
        write_tile<DP>(dv, base, ld, stg + pn * 64, acc_v, kc, pn, S, ch, lane);
      }
  }
}

template <int DP, int S>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int M, int H, int dh,
                   float scale, cudaStream_t st) {
  using G = Geo<DP>;
  static int fit = 0;
  cudaError_t err = resident_blocks(tiny_seq_kernel<DP, S>, G::WARPS * 32, G::FWD_SMEM, &fit);
  if (err != cudaSuccess) return err;
  constexpr int PACK = 16 / S;
  const long long n_items = (long long)M * H;
  const long long need = ((n_items + PACK - 1) / PACK + G::WARPS - 1) / G::WARPS;
  const unsigned blocks = (unsigned)(need < fit ? need : fit);
  tiny_seq_kernel<DP, S><<<blocks, G::WARPS * 32, G::FWD_SMEM, st>>>(q, k, v, o, n_items, H, dh,
                                                                     scale);
  return cudaGetLastError();
}

template <int DP, int S>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq,
                       bf16* dk, bf16* dv, int M, int H, int dh, float scale, cudaStream_t st) {
  using G = Geo<DP>;
  static int fit = 0;
  cudaError_t err =
      resident_blocks(tiny_seq_bwd_kernel<DP, S>, G::WARPS * 32, G::BWD_SMEM, &fit);
  if (err != cudaSuccess) return err;
  const long long n_items = (long long)M * H;
  const long long need = (n_items + G::WARPS - 1) / G::WARPS;
  const unsigned blocks = (unsigned)(need < fit ? need : fit);
  tiny_seq_bwd_kernel<DP, S><<<blocks, G::WARPS * 32, G::BWD_SMEM, st>>>(
      q, k, v, g, dq, dk, dv, n_items, H, dh, scale);
  return cudaGetLastError();
}

// the long bodies: one-warp blocks, one item a warp at a time; the resident
// blocks depend on S through the item's smem, so one count per tile count
template <int DP, bool DH_IS_DP>
cudaError_t launch_long(const bf16* q, const bf16* k, const bf16* v, bf16* o, int M, int S,
                        int H, int dh, float scale, cudaStream_t st) {
  using G = Geo<DP>;
  static int fit[G::LONG_NT + 1];
  const int nt = (S + 15) / 16, smem = G::long_fwd_smem(nt);
  cudaError_t err = resident_blocks(tiny_seq_long_kernel<DP, DH_IS_DP>, 32, smem, &fit[nt],
                                    G::long_fwd_smem(G::LONG_NT));
  if (err != cudaSuccess) return err;
  const long long n_items = (long long)M * H;
  const unsigned blocks = (unsigned)(n_items < fit[nt] ? n_items : fit[nt]);
  tiny_seq_long_kernel<DP, DH_IS_DP><<<blocks, 32, smem, st>>>(q, k, v, o, n_items, H, S, dh,
                                                                scale);
  return cudaGetLastError();
}

template <int DP, bool DH_IS_DP>
cudaError_t launch_long_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                            bf16* dq, bf16* dk, bf16* dv, int M, int S, int H, int dh,
                            float scale, cudaStream_t st) {
  using G = Geo<DP>;
  static int fit[G::LONG_NT + 1];
  const int nt = (S + 15) / 16, smem = G::long_bwd_smem(nt);
  cudaError_t err = resident_blocks(tiny_seq_long_bwd_kernel<DP, DH_IS_DP>, 32, smem, &fit[nt],
                                    G::long_bwd_smem(G::LONG_NT));
  if (err != cudaSuccess) return err;
  const long long n_items = (long long)M * H;
  const unsigned blocks = (unsigned)(n_items < fit[nt] ? n_items : fit[nt]);
  tiny_seq_long_bwd_kernel<DP, DH_IS_DP><<<blocks, 32, smem, st>>>(q, k, v, g, dq, dk, dv,
                                                                    n_items, H, S, dh, scale);
  return cudaGetLastError();
}

// the forward on the DP-column body (S checked by the caller)
template <int DP>
cudaError_t forward(const bf16* q, const bf16* k, const bf16* v, bf16* o, int M, int S, int H,
                    int dh, float scale, cudaStream_t st) {
  if (S > MAX_S)
    return dh == DP ? launch_long<DP, true>(q, k, v, o, M, S, H, dh, scale, st)
                    : launch_long<DP, false>(q, k, v, o, M, S, H, dh, scale, st);
  switch (S) {
#define BYA_TINY_CASE(n) \
  case n:                \
    return launch<DP, n>(q, k, v, o, M, H, dh, scale, st);
    BYA_TINY_CASE(1) BYA_TINY_CASE(2) BYA_TINY_CASE(3) BYA_TINY_CASE(4)
    BYA_TINY_CASE(5) BYA_TINY_CASE(6) BYA_TINY_CASE(7) BYA_TINY_CASE(8)
    BYA_TINY_CASE(9) BYA_TINY_CASE(10) BYA_TINY_CASE(11) BYA_TINY_CASE(12)
    BYA_TINY_CASE(13) BYA_TINY_CASE(14) BYA_TINY_CASE(15) BYA_TINY_CASE(16)
#undef BYA_TINY_CASE
  }
  return cudaErrorInvalidValue;
}

// the backward on the DP-column body (S checked by the caller)
template <int DP>
cudaError_t backward(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq,
                     bf16* dk, bf16* dv, int M, int S, int H, int dh, float scale,
                     cudaStream_t st) {
  if (S > MAX_S)
    return dh == DP ? launch_long_bwd<DP, true>(q, k, v, g, dq, dk, dv, M, S, H, dh, scale, st)
                    : launch_long_bwd<DP, false>(q, k, v, g, dq, dk, dv, M, S, H, dh, scale, st);
  switch (S) {
#define BYA_TINY_BWD_CASE(n) \
  case n:                    \
    return launch_bwd<DP, n>(q, k, v, g, dq, dk, dv, M, H, dh, scale, st);
    BYA_TINY_BWD_CASE(8) BYA_TINY_BWD_CASE(9) BYA_TINY_BWD_CASE(10) BYA_TINY_BWD_CASE(11)
    BYA_TINY_BWD_CASE(12) BYA_TINY_BWD_CASE(13) BYA_TINY_BWD_CASE(14) BYA_TINY_BWD_CASE(15)
    BYA_TINY_BWD_CASE(16)
#undef BYA_TINY_BWD_CASE
  }
  return cudaErrorInvalidValue;
}

// the longest S of a body (bya::body_of)
int long_max_s(int body) {
  return body == 64 ? Geo<64>::LONG_MAX_S : body == 128 ? Geo<128>::LONG_MAX_S
                                                        : Geo<256>::LONG_MAX_S;
}

}  // namespace

// q, k, v, o: [M, S, H*D] bf16, contiguous, 16-byte aligned; D % 8 == 0 up
// to 256 (on the narrowest body that holds it); 1 <= S <= the body's
// LONG_MAX_S (the one-tile body up to 16, the long body past it).  Returns
// the cudaError_t of the launch, or cudaErrorInvalidValue for a shape it
// does not take.
extern "C" int bya_tiny_seq_attention(const void* q, const void* k, const void* v, void* o,
                                      int M, int S, int H, int D, float scale, void* stream) {
  const int body = bya::body_of(D);
  if (body == 0 || S < 1 || S > long_max_s(body) || M < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 64) return (int)forward<64>(qp, kp, vp, op, M, S, H, D, scale, st);
  if (body == 128) return (int)forward<128>(qp, kp, vp, op, M, S, H, D, scale, st);
  return (int)forward<256>(qp, kp, vp, op, M, S, H, D, scale, st);
}

// B8: q, k, v, g (the output gradient), dq, dk, dv: [M, S, H*D] bf16,
// contiguous, 16-byte aligned; D as the forward; 8 <= S <= the body's
// LONG_MAX_S.  Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int bya_tiny_seq_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* g, void* dq, void* dk, void* dv, int M,
                                          int S, int H, int D, float scale, void* stream) {
  const int body = bya::body_of(D);
  if (body == 0 || S < 8 || S > long_max_s(body) || M < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 64) return (int)backward<64>(qp, kp, vp, gp, dqp, dkp, dvp, M, S, H, D, scale, st);
  if (body == 128)
    return (int)backward<128>(qp, kp, vp, gp, dqp, dkp, dvp, M, S, H, D, scale, st);
  return (int)backward<256>(qp, kp, vp, gp, dqp, dkp, dvp, M, S, H, D, scale, st);
}
