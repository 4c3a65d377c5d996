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
// written flat [M, S, H*64] in the input dtype.  Memory bound as the
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
// item's smem sets the cap: LONG_MAX_S = 192 (the backward's two buffers
// of four tensors take 225,792 bytes there).
#include "mma_utils.cuh"

namespace {

using bya::bf16;

constexpr int DH = 64;
constexpr int MAX_S = 16;         // the one-tile bodies
constexpr int LONG_MAX_S = 192;   // the whole-item bodies (see the notes at the top)
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// B8 on the tensor cores: a warp takes one (m, head) item at a time, a
// [S, 64] tile of each of q, k, v and g padded to 16 rows, in shared
// memory rows of LDS elements.  Per item, with A from ldmatrix (or from
// the fp32 score fragments), B from ldmatrix (.trans where the operand is
// row-major along n) and mma.sync m16n8k16 bf16 -> fp32:
//   S = Q K^T, dP = G V^T          (2 x 8 products)
//   P = softmax(S * scale) in fp32 in the fragments, key columns >= S and
//   query rows >= S zeroed; delta = rowsum(P o dP); dS = P o (dP - delta) * scale
//   dV = P^T G, dQ = dS K, dK = dS^T Q   (3 x 8 products; P and dS rounded
//   to bf16 as their A operand, P^T and dS^T by movmatrix)
// 40 products an item, where the warp-shuffle version reduced ~1,690
// scores and dP entries across the warp.  The outputs leave through the
// item's own tiles (dV over g, dQ over k, dK over q, each once its
// operand is read) as 16-byte rows.
constexpr int BWD_WARPS = 4;
constexpr int LDS = DH + 8;            // padded smem row: conflict-free ldmatrix
constexpr int TILE = 16 * LDS;         // one [16, 64] operand tile, bf16 elements
constexpr int ITEM = 4 * TILE;         // q, k, v, g of one item
constexpr int BWD_SMEM = BWD_WARPS * 2 * ITEM * (int)sizeof(bf16);  // double-buffered

// movmatrix: the transpose of the 8x8 bf16 matrix whose fragment (lane
// holds row lane / 4, columns 2 (lane % 4) + 0, 1) is x, in the same layout
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// acc[nd] += A (16 x 16) * T (16 x 64) for T row-major in a [16, LDS] tile
__device__ __forceinline__ void mma_a_tile_add(float (&acc)[8][4], const uint32_t (&a)[4],
                                               const bf16* tile, int lane) {
#pragma unroll
  for (int nd = 0; nd < 8; nd += 2) {
    uint32_t b0, b1, b2, b3;
    bya::ldmatrix_x4_trans(b0, b1, b2, b3, tile + (lane & 15) * LDS + (nd + (lane >> 4)) * 8);
    bya::mma_bf16(acc[nd], a, b0, b1);
    bya::mma_bf16(acc[nd + 1], a, b2, b3);
  }
}

// acc[nd] = A (16 x 16) * T (16 x 64)
__device__ __forceinline__ void mma_a_tile(float (&acc)[8][4], const uint32_t (&a)[4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  mma_a_tile_add(acc, a, tile, lane);
}

// the rows < `rows` of a [16, 64] fp32 result into a tile, as bf16
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&acc)[8][4], int lane,
                                           int rows) {
  const int r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) {
    if (r < rows)
      *reinterpret_cast<uint32_t*>(tile + r * LDS + nd * 8 + c) =
          bya::pack_bf16(acc[nd][0], acc[nd][1]);
    if (r + 8 < rows)
      *reinterpret_cast<uint32_t*>(tile + (r + 8) * LDS + nd * 8 + c) =
          bya::pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

template <int S>
__device__ __forceinline__ void stage(bf16* tile, const float (&acc)[8][4], int lane) {
  stage_rows(tile, acc, lane, S);
}

// B5 / B5': a warp takes one tile at a time, PACK = 16 / S consecutive
// (m, head) items of S rows each ([PACK * S, 64] of q, k and v, padded to
// 16 rows); see the design at the top.
constexpr int FWD_WARPS = 4;
constexpr int FWD_TILES = 3 * TILE;                                     // q, k, v
constexpr int FWD_SMEM = FWD_WARPS * 2 * FWD_TILES * (int)sizeof(bf16);  // double-buffered

template <int S>
__global__ void __launch_bounds__(FWD_WARPS * 32)
tiny_seq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, long long n_items, int H,
                float scale) {
  constexpr int PACK = 16 / S;
  constexpr int ROWS = PACK * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* sm = reinterpret_cast<bf16*>(smem_raw) + warp * 2 * FWD_TILES;  // this warp's two tiles
  const long long ld = (long long)H * DH;
  const long long n_tiles = (n_items + PACK - 1) / PACK;
  const long long step = (long long)gridDim.x * FWD_WARPS;
  const float scale_log2 = scale * LOG2E;

  // rows ROWS..15 of every tile stay zero: loads and the staged output
  // touch rows < ROWS only
  if constexpr (ROWS < 16) {
    for (int i = lane; i < 2 * 3 * 16 * 8; i += 32) {
      const int r = (i >> 3) & 15;
      if (r >= ROWS)
        *reinterpret_cast<uint4*>(sm + (i >> 7) * TILE + r * LDS + (i & 7) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // a tile's first item and its (m, head): one division a tile
  struct First {
    long long item, m;
    int h;
  };
  auto first_of = [&](long long tile) {
    const long long item = tile * PACK, m = item / H;
    return First{item, m, (int)(item - m * H)};
  };
  // the offset in [M, S, H*64] of the tile's 16-byte chunk i (row i / 8 of
  // the tile: row (i / 8) % S of its item (i / 8) / S), or -1 for an item
  // past the end
  auto chunk_offset = [&](const First& f, int i) -> long long {
    const int r = i >> 3, j = r / S;
    if (f.item + j >= n_items) return -1;
    long long m = f.m;
    int h = f.h + j;
    for (; h >= H; h -= H) ++m;
    return m * S * ld + (long long)h * DH + (long long)(r - j * S) * ld + (i & 7) * 8;
  };
  const bf16* const srcs[3] = {q, k, v};
  // tile `tile`'s rows of q, k and v into buffer `buf`, the rows of items
  // past the end zero-filled (an empty group past the last tile)
  auto load = [&](int buf, long long tile) {
    if (tile < n_tiles) {
      const First f = first_of(tile);
      for (int i = lane; i < ROWS * 8; i += 32) {
        const long long off = chunk_offset(f, i);
        const int dst = (i >> 3) * LDS + (i & 7) * 8;
#pragma unroll
        for (int t = 0; t < 3; ++t)
          bya::cp_async16(sm + buf * FWD_TILES + t * TILE + dst, srcs[t] + (off < 0 ? 0 : off),
                          off < 0 ? 0 : 16);
      }
    }
    bya::cp_async_commit();
  };

  long long tile = (long long)blockIdx.x * FWD_WARPS + warp;
  int buf = 0;
  load(0, tile);
  for (; tile < n_tiles; tile += step, buf ^= 1) {
    load(buf ^ 1, tile + step);
    bya::cp_async_wait<1>();
    __syncwarp();
    bf16* qs = sm + buf * FWD_TILES;
    const bf16* ks = qs + TILE;
    const bf16* vs = ks + TILE;

    // S = Q K^T; fragment element (nt, e) is row r0 + 8 (e >> 1), column
    // nt * 8 + c0 + (e & 1)
    uint32_t af[4][4];
    float s[2][4] = {};
    bya::load_a_frags<4, LDS>(af, qs, lane);
    bya::qk_scores<2, 4, LDS>(s, af, ks, lane);

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
    float acc[8][4];
    mma_a_tile(acc, p_a, vs, lane);
    __syncwarp();  // every lane's q fragments are read: O goes over q
    stage<ROWS>(qs, acc, lane);
    __syncwarp();
    const First f = first_of(tile);
    for (int i = lane; i < ROWS * 8; i += 32) {
      const long long off = chunk_offset(f, i);
      if (off >= 0)
        *reinterpret_cast<uint4*>(o + off) =
            *reinterpret_cast<const uint4*>(qs + (i >> 3) * LDS + (i & 7) * 8);
    }
    __syncwarp();
  }
}

template <int S>
__global__ void __launch_bounds__(BWD_WARPS * 32)
tiny_seq_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    long long n_items, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* sm = reinterpret_cast<bf16*>(smem_raw) + warp * 2 * ITEM;  // this warp's two items
  const long long ld = (long long)H * DH;
  const long long step = (long long)gridDim.x * BWD_WARPS;
  const float scale_log2 = scale * LOG2E;

  // rows S..15 of every tile stay zero: loads and staged outputs touch rows < S only
  if constexpr (S < 16) {
    for (int i = lane; i < 2 * 4 * 16 * 8; i += 32) {
      const int r = (i >> 3) & 15;
      if (r >= S)
        *reinterpret_cast<uint4*>(sm + (i >> 7) * TILE + r * LDS + (i & 7) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const bf16* const srcs[4] = {q, k, v, g};
  auto base_of = [&](long long it) {
    return (it / H) * S * ld + (long long)(it % H) * DH;
  };
  // item `it`'s rows of q, k, v and g into buffer `buf` (an empty group past the end)
  auto load = [&](int buf, long long it) {
    if (it < n_items) {
      const long long base = base_of(it);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        for (int i = lane; i < S * 8; i += 32)
          bya::cp_async16(sm + buf * ITEM + t * TILE + (i >> 3) * LDS + (i & 7) * 8,
                          srcs[t] + base + (i >> 3) * ld + (i & 7) * 8, 16);
    }
    bya::cp_async_commit();
  };

  long long item = (long long)blockIdx.x * BWD_WARPS + warp;
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
    uint32_t af[4][4];
    float s[2][4] = {}, dp[2][4] = {};
    bya::load_a_frags<4, LDS>(af, qs, lane);
    bya::qk_scores<2, 4, LDS>(s, af, ks, lane);
    bya::load_a_frags<4, LDS>(af, gs, lane);
    bya::qk_scores<2, 4, LDS>(dp, af, vs, lane);

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
    float acc[8][4];
    mma_a_tile(acc, pt_a, gs, lane);  // dV = P^T G, staged over g
    __syncwarp();
    stage<S>(gs, acc, lane);
    mma_a_tile(acc, ds_a, ks, lane);  // dQ = dS K, over k
    __syncwarp();
    stage<S>(ks, acc, lane);
    mma_a_tile(acc, dst_a, qs, lane);  // dK = dS^T Q, over q
    __syncwarp();
    stage<S>(qs, acc, lane);
    __syncwarp();

    const long long base = base_of(item);
    bf16* const outs[3] = {dk, dq, dv};
    const bf16* const tiles[3] = {qs, ks, gs};
#pragma unroll
    for (int t = 0; t < 3; ++t)
      for (int i = lane; i < S * 8; i += 32)
        *reinterpret_cast<uint4*>(outs[t] + base + (i >> 3) * ld + (i & 7) * 8) =
            *reinterpret_cast<const uint4*>(tiles[t] + (i >> 3) * LDS + (i & 7) * 8);
    __syncwarp();
  }
}

// ---- the long bodies, 16 < S <= LONG_MAX_S: one warp a whole item ----
// An item's tensor takes nt = ceil(S / 16) tiles of 16 rows in shared memory.

constexpr int long_fwd_smem(int nt) { return 2 * 3 * nt * TILE * (int)sizeof(bf16); }
// two buffers of q, k, v, g; one staging tile; each row's max, 1 / sum, delta
constexpr int long_bwd_smem(int nt) {
  return (2 * 4 * nt + 1) * TILE * (int)sizeof(bf16) + 3 * nt * 16 * (int)sizeof(float);
}
static_assert(long_bwd_smem(LONG_MAX_S / 16) <= 232448, "B8's long body past the smem of a block");
static_assert(LONG_MAX_S % 16 == 0, "LONG_MAX_S is a whole number of tiles");

// rows S .. 16 nt - 1 of `count` item tensors (`span` elements apart) to zero:
// loads and staged outputs touch rows < S only, so they stay zero
__device__ __forceinline__ void zero_pad_rows(bf16* sm, int count, int span, int S, int nt,
                                              int lane) {
  const int pad = 16 * nt - S;
  for (int i = lane; i < count * pad * 8; i += 32) {
    const int t = i / (pad * 8), r = S + (i >> 3) % pad;
    *reinterpret_cast<uint4*>(sm + t * span + r * LDS + (i & 7) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// the 16 x 16 score block of q tile A fragments `a` against the 16 rows of
// `rows` (k for S, v for dP); fragment element (nt, e) is row r0 + 8 (e >> 1),
// column nt * 8 + c0 + (e & 1) of the block
__device__ __forceinline__ void scores16(float (&s)[2][4], const uint32_t (&a)[4][4],
                                         const bf16* rows, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  bya::qk_scores<2, 4, LDS>(s, a, rows, lane);
}

// rows [tile * 16, tile * 16 + 16) < S of a [16, 64] fp32 result out to
// [M, S, H*64] at `base` (row stride `ld`) through the staging tile `stg`
__device__ __forceinline__ void write_tile(bf16* __restrict__ out, long long base, long long ld,
                                           bf16* stg, const float (&acc)[8][4], int tile, int S,
                                           int lane) {
  const int rows = min(16, S - tile * 16);
  __syncwarp();
  stage_rows(stg, acc, lane, rows);
  __syncwarp();
  for (int i = lane; i < rows * 8; i += 32)
    *reinterpret_cast<uint4*>(out + base + (long long)(tile * 16 + (i >> 3)) * ld + (i & 7) * 8) =
        *reinterpret_cast<const uint4*>(stg + (i >> 3) * LDS + (i & 7) * 8);
  __syncwarp();
}

// `count` tensors of item `it` ([M, S, H*64], the item's rows at `base`)
// into consecutive spans of `dst` as one cp.async group
__device__ __forceinline__ void load_item(bf16* dst, int span, const bf16* const* srcs,
                                          int count, long long base, long long ld, int S,
                                          int lane) {
  for (int t = 0; t < count; ++t)
    for (int i = lane; i < S * 8; i += 32)
      bya::cp_async16(dst + t * span + (i >> 3) * LDS + (i & 7) * 8,
                      srcs[t] + base + (long long)(i >> 3) * ld + (i & 7) * 8, 16);
}

__global__ void __launch_bounds__(32)
tiny_seq_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, long long n_items, int H,
                     int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x;
  const int nt = (S + 15) >> 4, span = nt * TILE;
  const long long ld = (long long)H * DH;
  const float scale_log2 = scale * LOG2E;
  const int c0 = 2 * (lane & 3);
  zero_pad_rows(sm, 2 * 3, span, S, nt, lane);
  const bf16* const srcs[3] = {q, k, v};
  auto base_of = [&](long long it) { return (it / H) * S * ld + (long long)(it % H) * DH; };
  auto load = [&](int buf, long long it) {
    if (it < n_items) load_item(sm + buf * 3 * span, span, srcs, 3, base_of(it), ld, S, lane);
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
      uint32_t af[4][4];
      bya::load_a_frags<4, LDS>(af, qs + qt * TILE, lane);
      // the row max and sum over every key column < S, the sum rescaled as
      // the max grows chunk by chunk
      float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f};
      for (int kc = 0; kc < nt; ++kc) {
        float s[2][4];
        scores16(s, af, ks + kc * TILE, lane);
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
      // O = P V over the chunks, P normalised in fp32, then rounded to bf16
      float acc[8][4];
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
      for (int kc = 0; kc < nt; ++kc) {
        float s[2][4];
        scores16(s, af, ks + kc * TILE, lane);
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
        mma_a_tile_add(acc, p_a, vs + kc * TILE, lane);
      }
      // O leaves over its own q tile: this tile's q is in the fragments
      write_tile(o, base, ld, qs + qt * TILE, acc, qt, S, lane);
    }
  }
}

__global__ void __launch_bounds__(32)
tiny_seq_long_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                         long long n_items, int H, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x;
  const int nt = (S + 15) >> 4, span = nt * TILE;
  const long long ld = (long long)H * DH;
  const float scale_log2 = scale * LOG2E;
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
  bf16* const stg = sm + 2 * 4 * span;
  float* const row_max = reinterpret_cast<float*>(stg + TILE);
  float* const row_inv = row_max + nt * 16;
  float* const row_delta = row_inv + nt * 16;
  zero_pad_rows(sm, 2 * 4, span, S, nt, lane);
  const bf16* const srcs[4] = {q, k, v, g};
  auto base_of = [&](long long it) { return (it / H) * S * ld + (long long)(it % H) * DH; };
  auto load = [&](int buf, long long it) {
    if (it < n_items) load_item(sm + buf * 4 * span, span, srcs, 4, base_of(it), ld, S, lane);
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
      uint32_t aq[4][4], ag[4][4];
      bya::load_a_frags<4, LDS>(aq, qs + qt * TILE, lane);
      bya::load_a_frags<4, LDS>(ag, gs + qt * TILE, lane);
      float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
      for (int kc = 0; kc < nt; ++kc) {
        float s[2][4], dp[2][4];
        scores16(s, aq, ks + kc * TILE, lane);
        scores16(dp, ag, vs + kc * TILE, lane);
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

    // P and dS of q tile qt against kv chunk kc from the fragments and the
    // row statistics: P normalised in fp32 (rows >= S and columns >= S
    // zero), dS = P o (dP - delta) * scale
    auto p_ds = [&](float (&s)[2][4], float (&dp)[2][4], const uint32_t (&aq)[4][4],
                    const uint32_t (&ag)[4][4], int qt, int kc) {
      scores16(s, aq, ks + kc * TILE, lane);
      scores16(dp, ag, vs + kc * TILE, lane);
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

    // dQ = dS K, a q tile at a time over the chunks
    for (int qt = 0; qt < nt; ++qt) {
      uint32_t aq[4][4], ag[4][4];
      bya::load_a_frags<4, LDS>(aq, qs + qt * TILE, lane);
      bya::load_a_frags<4, LDS>(ag, gs + qt * TILE, lane);
      float acc[8][4];
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
      for (int kc = 0; kc < nt; ++kc) {
        float s[2][4], dp[2][4];
        p_ds(s, dp, aq, ag, qt, kc);
        const uint32_t ds_a[4] = {
            bya::pack_bf16(dp[0][0], dp[0][1]), bya::pack_bf16(dp[0][2], dp[0][3]),
            bya::pack_bf16(dp[1][0], dp[1][1]), bya::pack_bf16(dp[1][2], dp[1][3])};
        mma_a_tile_add(acc, ds_a, ks + kc * TILE, lane);
      }
      write_tile(dq, base, ld, stg, acc, qt, S, lane);
    }

    // dV = P^T G and dK = dS^T Q, a kv chunk at a time over the q tiles
    // (P^T and dS^T transposed 8x8 block by block, as the one-tile body)
    for (int kc = 0; kc < nt; ++kc) {
      float acc_k[8][4], acc_v[8][4];
#pragma unroll
      for (int nd = 0; nd < 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.f;
      for (int qt = 0; qt < nt; ++qt) {
        uint32_t aq[4][4], ag[4][4];
        bya::load_a_frags<4, LDS>(aq, qs + qt * TILE, lane);
        bya::load_a_frags<4, LDS>(ag, gs + qt * TILE, lane);
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
        mma_a_tile_add(acc_v, pt_a, gs + qt * TILE, lane);
        mma_a_tile_add(acc_k, dst_a, qs + qt * TILE, lane);
      }
      write_tile(dk, base, ld, stg, acc_k, kc, S, lane);
      write_tile(dv, base, ld, stg, acc_v, kc, S, lane);
    }
  }
}

// The blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) resident on the card at once, computed on first use into `*fit`
// (the kernel's dynamic shared memory limit set to `max_smem`, default
// `smem`: a long body's limit is that of its largest S, whatever S comes first)
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem, int* fit, int max_smem = 0) {
  if (*fit > 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         max_smem > 0 ? max_smem : smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  *fit = sms * per_sm;
  return cudaSuccess;
}

template <int S>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int M, int H,
                   float scale, cudaStream_t st) {
  static int fit = 0;
  cudaError_t err = resident_blocks(tiny_seq_kernel<S>, FWD_WARPS * 32, FWD_SMEM, &fit);
  if (err != cudaSuccess) return err;
  constexpr int PACK = 16 / S;
  const long long n_items = (long long)M * H;
  const long long need = ((n_items + PACK - 1) / PACK + FWD_WARPS - 1) / FWD_WARPS;
  const unsigned blocks = (unsigned)(need < fit ? need : fit);
  tiny_seq_kernel<S><<<blocks, FWD_WARPS * 32, FWD_SMEM, st>>>(q, k, v, o, n_items, H, scale);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq,
                       bf16* dk, bf16* dv, int M, int H, float scale, cudaStream_t st) {
  static int fit = 0;
  cudaError_t err = resident_blocks(tiny_seq_bwd_kernel<S>, BWD_WARPS * 32, BWD_SMEM, &fit);
  if (err != cudaSuccess) return err;
  const long long n_items = (long long)M * H;
  const long long need = (n_items + BWD_WARPS - 1) / BWD_WARPS;
  const unsigned blocks = (unsigned)(need < fit ? need : fit);
  tiny_seq_bwd_kernel<S><<<blocks, BWD_WARPS * 32, BWD_SMEM, st>>>(q, k, v, g, dq, dk, dv,
                                                                  n_items, H, scale);
  return cudaGetLastError();
}

// the long bodies: one-warp blocks, one item a warp at a time; the resident
// blocks depend on S through the item's smem, so one count per tile count
cudaError_t launch_long(const bf16* q, const bf16* k, const bf16* v, bf16* o, int M, int S,
                        int H, float scale, cudaStream_t st) {
  static int fit[LONG_MAX_S / 16 + 1];
  const int nt = (S + 15) / 16, smem = long_fwd_smem(nt);
  cudaError_t err = resident_blocks(tiny_seq_long_kernel, 32, smem, &fit[nt],
                                    long_fwd_smem(LONG_MAX_S / 16));
  if (err != cudaSuccess) return err;
  const long long n_items = (long long)M * H;
  const unsigned blocks = (unsigned)(n_items < fit[nt] ? n_items : fit[nt]);
  tiny_seq_long_kernel<<<blocks, 32, smem, st>>>(q, k, v, o, n_items, H, S, scale);
  return cudaGetLastError();
}

cudaError_t launch_long_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                            bf16* dq, bf16* dk, bf16* dv, int M, int S, int H, float scale,
                            cudaStream_t st) {
  static int fit[LONG_MAX_S / 16 + 1];
  const int nt = (S + 15) / 16, smem = long_bwd_smem(nt);
  cudaError_t err = resident_blocks(tiny_seq_long_bwd_kernel, 32, smem, &fit[nt],
                                    long_bwd_smem(LONG_MAX_S / 16));
  if (err != cudaSuccess) return err;
  const long long n_items = (long long)M * H;
  const unsigned blocks = (unsigned)(n_items < fit[nt] ? n_items : fit[nt]);
  tiny_seq_long_bwd_kernel<<<blocks, 32, smem, st>>>(q, k, v, g, dq, dk, dv, n_items, H, S,
                                                     scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [M, S, H*64] bf16, contiguous; 1 <= S <= LONG_MAX_S (the
// one-tile body up to 16, the long body past it).  Returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for a shape it does
// not take.
extern "C" int bya_tiny_seq_attention(const void* q, const void* k, const void* v, void* o,
                                      int M, int S, int H, int D, float scale, void* stream) {
  if (D != DH || S < 1 || S > LONG_MAX_S || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > MAX_S) return (int)launch_long(qp, kp, vp, op, M, S, H, scale, st);
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
// contiguous; 8 <= S <= LONG_MAX_S.  Returns the cudaError_t of the launch,
// or cudaErrorInvalidValue for a shape it does not take.
extern "C" int bya_tiny_seq_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* g, void* dq, void* dk, void* dv, int M,
                                          int S, int H, int D, float scale, void* stream) {
  if (D != DH || S < 8 || S > LONG_MAX_S || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > MAX_S) return (int)launch_long_bwd(qp, kp, vp, gp, dqp, dkp, dvp, M, S, H, scale, st);
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
