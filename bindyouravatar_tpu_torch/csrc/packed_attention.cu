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
#include "mma_utils.cuh"

namespace {

using bya::bf16;

constexpr int DH = 64;
constexpr int MAX_S = 16;
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

// acc[nd] = A (16 x 16) * T (16 x 64) for T row-major in a [16, LDS] tile
__device__ __forceinline__ void mma_a_tile(float (&acc)[8][4], const uint32_t (&a)[4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
#pragma unroll
  for (int nd = 0; nd < 8; nd += 2) {
    uint32_t b0, b1, b2, b3;
    bya::ldmatrix_x4_trans(b0, b1, b2, b3, tile + (lane & 15) * LDS + (nd + (lane >> 4)) * 8);
    bya::mma_bf16(acc[nd], a, b0, b1);
    bya::mma_bf16(acc[nd + 1], a, b2, b3);
  }
}

// the rows < S of a [16, 64] fp32 result into a tile, as bf16
template <int S>
__device__ __forceinline__ void stage(bf16* tile, const float (&acc)[8][4], int lane) {
  const int r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) {
    if (r < S)
      *reinterpret_cast<uint32_t*>(tile + r * LDS + nd * 8 + c) =
          bya::pack_bf16(acc[nd][0], acc[nd][1]);
    if (r + 8 < S)
      *reinterpret_cast<uint32_t*>(tile + (r + 8) * LDS + nd * 8 + c) =
          bya::pack_bf16(acc[nd][2], acc[nd][3]);
  }
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

// The blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) resident on the card at once, computed on first use into `*fit`
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem, int* fit) {
  if (*fit > 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

}  // namespace

// q, k, v, o: [M, S, H*64] bf16, contiguous; 1 <= S <= 16.  Returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for a shape it does
// not take.
extern "C" int bya_tiny_seq_attention(const void* q, const void* k, const void* v, void* o,
                                      int M, int S, int H, int D, float scale, void* stream) {
  if (D != DH || S < 1 || S > MAX_S || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
// contiguous; 8 <= S <= 16.  Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int bya_tiny_seq_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* g, void* dq, void* dk, void* dv, int M,
                                          int S, int H, int D, float scale, void* stream) {
  if (D != DH || S < 8 || S > MAX_S || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
