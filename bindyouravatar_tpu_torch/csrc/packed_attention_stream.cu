// B5 / B5' and B8 past each long body's cap (`packed_attention.cu`: the
// one-tile and long bodies, the C entry points that dispatch here): the
// streamed bodies, in a source of their own so that nvcc builds them beside
// the rest, with C entry points of their own that the wrapper calls past a
// body's cap.  Same function, math and roundings as the long bodies.
#include "packed_attention.cuh"

namespace {

// ---- the streamed bodies, S > LONG_MAX_S: fixed shared memory at any S ----
// A block of four warps takes one unit at a time: an item's group of 64
// rows (four 16-row tiles, a tile a warp), held in shared memory, while the
// other side's rows stream through two buffers of CT-tile chunks by
// cp.async (the next chunk in flight while the block computes on the
// current one).  No unit shares a sum with another, so the bodies stay
// bitwise repeatable, and each warp makes its tile's sums in the long
// bodies' order (16-row kv chunks in order, the same fragments).
//   forward (B5, B5'): a group of q rows; K streamed once for the row max
//     and sum, then K and V once a 64-column output panel (the scores
//     recomputed), P normalised in fp32 before it is rounded to bf16;
//   backward (B8), two kernels: a group of q and g rows, K and V streamed
//     once for each row's max, 1 / sum and delta (saved to `stats`, fp32),
//     then once a panel for dQ = dS K; then a group of k and v rows, q, g
//     and the rows' statistics streamed once a panel for dV = P^T G and
//     dK = dS^T Q.
// Rows past S load as zeros and their key columns are masked (p = 0), so a
// ragged last chunk or group adds nothing; rows past S are never stored.
template <int DP>
struct Stream {
  static constexpr int LDS = DP + 8, TILE = 16 * LDS;
  static constexpr int WARPS = 4, THREADS = 32 * WARPS;
  static constexpr int GROUP = 16 * WARPS;      // the rows of a unit
  static constexpr int CT = DP == 64 ? 4 : 2;   // the tiles of a streamed chunk
  static constexpr int CHUNK = 16 * CT;
  static constexpr int BUF = 2 * CT * TILE;     // a buffer: two tensors' chunks
  // the forward: the q group and two buffers of K and V
  static constexpr int FWD_SMEM = (WARPS + 2 * 2 * CT) * TILE * (int)sizeof(bf16);
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

template <int DP>
__global__ void __launch_bounds__(Stream<DP>::THREADS)
tiny_seq_stream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, long long n_items, int H,
                       int S, int dh, float scale) {
  using G = Stream<DP>;
  constexpr int LDS = G::LDS, TILE = G::TILE, CT = G::CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const qg = reinterpret_cast<bf16*>(smem_raw);  // warp w's q tile at w * TILE
  bf16* const kv = qg + G::WARPS * TILE;               // buffer b: K at b * BUF, V after it
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ld = (long long)H * dh;
  const int ch = dh / 8;
  const float scale_log2 = scale * LOG2E;
  const int c0 = 2 * (lane & 3);
  const int groups = (S + G::GROUP - 1) / G::GROUP, n_chunks = (S + G::CHUNK - 1) / G::CHUNK;
  const long long n_units = n_items * groups;
  zero_smem_block<G::THREADS>(qg, (G::WARPS + 2 * 2 * CT) * TILE, tid);  // columns past dh

  for (long long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const long long item = unit / groups;
    const int row0 = (int)(unit - item * groups) * G::GROUP;
    const long long base = (item / H) * S * ld + (item % H) * dh;
    const int qt = row0 / 16 + warp;  // this warp's q tile
    const bool active = qt * 16 < S;
    __syncthreads();  // the last unit's staged outputs are read
    load_stream_rows<DP>(qg, q + base, ld, row0, G::GROUP, S, ch, tid);
    bya::cp_async_commit();
    bya::cp_async_wait<0>();
    __syncthreads();
    uint32_t af[DP / 16][4];
    bya::load_a_frags<DP / 16, LDS>(af, qg + warp * TILE, lane);
    auto load_k = [&](int buf, int c) {
      load_stream_rows<DP>(kv + buf * G::BUF, k + base, ld, c * G::CHUNK, G::CHUNK, S, ch, tid);
    };
    auto load_kv = [&](int buf, int c) {
      load_k(buf, c);
      load_stream_rows<DP>(kv + buf * G::BUF + CT * TILE, v + base, ld, c * G::CHUNK, G::CHUNK,
                           S, ch, tid);
    };

    // the row max and sum over every key column < S, the sum rescaled as
    // the max grows chunk by chunk
    float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f};
    stream_chunks(n_chunks, load_k, [&](int buf, int c) {
      if (!active) return;
      for (int j = 0; j < CT && (c * CT + j) * 16 < S; ++j) {
        const int kc = c * CT + j;
        float s[2][4];
        scores16<DP>(s, af, kv + buf * G::BUF + j * TILE, lane);
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
    });
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
      inv[i] = 1.f / sum[i];
    }
    // O = P V over the chunks, a 64-column panel at a time
    for (int pn = 0; pn < DP / 64 && pn * 64 < dh; ++pn) {
      float acc[8][4];
      zero_acc(acc);
      stream_chunks(n_chunks, load_kv, [&](int buf, int c) {
        if (!active) return;
        for (int j = 0; j < CT && (c * CT + j) * 16 < S; ++j) {
          const int kc = c * CT + j;
          float s[2][4];
          scores16<DP>(s, af, kv + buf * G::BUF + j * TILE, lane);
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
          mma_a_tile_add<8, LDS>(acc, p_a, kv + buf * G::BUF + (CT + j) * TILE + pn * 64, lane);
        }
      });
      // O leaves over the warp's own q tile (its q is in the fragments)
      if (active) write_tile<DP>(o, base, ld, qg + warp * TILE + pn * 64, acc, qt, pn, S, ch, lane);
    }
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

// the streamed bodies: four-warp blocks, one unit (an item's group of 64
// rows) a block at a time; their shared memory does not depend on S
template <int DP>
cudaError_t launch_stream(const bf16* q, const bf16* k, const bf16* v, bf16* o, int M, int S,
                          int H, int dh, float scale, cudaStream_t st) {
  using G = Stream<DP>;
  static int fit = 0;
  cudaError_t err = resident_blocks(tiny_seq_stream_kernel<DP>, G::THREADS, G::FWD_SMEM, &fit);
  if (err != cudaSuccess) return err;
  const long long n_items = (long long)M * H, units = n_items * ((S + G::GROUP - 1) / G::GROUP);
  const unsigned blocks = (unsigned)(units < fit ? units : fit);
  tiny_seq_stream_kernel<DP><<<blocks, G::THREADS, G::FWD_SMEM, st>>>(q, k, v, o, n_items, H, S,
                                                                       dh, scale);
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
  if (body == 64) return (int)launch_stream<64>(qp, kp, vp, op, M, S, H, D, scale, st);
  if (body == 128) return (int)launch_stream<128>(qp, kp, vp, op, M, S, H, D, scale, st);
  return (int)launch_stream<256>(qp, kp, vp, op, M, S, H, D, scale, st);
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
