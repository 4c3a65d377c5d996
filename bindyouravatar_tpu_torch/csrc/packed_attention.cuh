// The helpers that B5 / B5' / B8's bodies share (`packed_attention.cu`: the
// one-tile and long bodies; `packed_attention_stream.cu`: the streamed
// bodies past each long body's cap).  Each source that includes this gets
// its own copy.
#pragma once

#include "mma_utils.cuh"

namespace {

using bya::bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int SMEM_LIMIT = 232448;  // the shared memory a block may have

// movmatrix: the transpose of the 8x8 bf16 matrix whose fragment (lane
// holds row lane / 4, columns 2 (lane % 4) + 0, 1) is x, in the same layout
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// acc[nd] += A (16 x 16) * T (16 x 8 ND) for T row-major in a [16, LDS] tile
template <int ND, int LDS>
__device__ __forceinline__ void mma_a_tile_add(float (&acc)[ND][4], const uint32_t (&a)[4],
                                               const bf16* tile, int lane) {
#pragma unroll
  for (int nd = 0; nd < ND; nd += 2) {
    uint32_t b0, b1, b2, b3;
    bya::ldmatrix_x4_trans(b0, b1, b2, b3, tile + (lane & 15) * LDS + (nd + (lane >> 4)) * 8);
    bya::mma_bf16(acc[nd], a, b0, b1);
    bya::mma_bf16(acc[nd + 1], a, b2, b3);
  }
}

template <int ND>
__device__ __forceinline__ void zero_acc(float (&acc)[ND][4]) {
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
}

// the rows < `rows` of a [16, 8 ND] fp32 result into a [16, LDS] tile, as bf16
template <int ND, int LDS>
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&acc)[ND][4], int lane,
                                           int rows) {
  const int r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (r < rows)
      *reinterpret_cast<uint32_t*>(tile + r * LDS + nd * 8 + c) =
          bya::pack_bf16(acc[nd][0], acc[nd][1]);
    if (r + 8 < rows)
      *reinterpret_cast<uint32_t*>(tile + (r + 8) * LDS + nd * 8 + c) =
          bya::pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

// the 16 x 16 score block of q tile A fragments `a` against the 16 rows of
// `rows` (k for S, v for dP); fragment element (nt, e) is row r0 + 8 (e >> 1),
// column nt * 8 + c0 + (e & 1) of the block
template <int DP>
__device__ __forceinline__ void scores16(float (&s)[2][4], const uint32_t (&a)[DP / 16][4],
                                         const bf16* rows, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  bya::qk_scores<2, DP / 16, DP + 8>(s, a, rows, lane);
}

// the same with the A operand read from its [16, LDS] tile as it goes (two
// k steps of fragments live at a time); the same sums in the same order
template <int DP>
__device__ __forceinline__ void scores16_smem(float (&s)[2][4], const bf16* a_tile,
                                              const bf16* rows, int lane) {
  constexpr int LDS = DP + 8;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; kk += 2) {
    uint32_t a[2][4];
    bya::load_a_frags<2, LDS>(a, a_tile + kk * 16, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t b0, b1, b2, b3;
      bya::ldmatrix_x4(b0, b1, b2, b3,
                       rows + (nt * 8 + (lane & 7)) * LDS + kk * 16 + (lane >> 3) * 8);
      bya::mma_bf16(s[nt], a[0], b0, b1);
      bya::mma_bf16(s[nt], a[1], b2, b3);
    }
  }
}

// The A operand of one 16-row tile of q or g for the long backward's score
// blocks: its fragments held in registers (DP / 4 a thread: 16 at DP = 64,
// 32 at 128), or at DP = 256, where q's and g's would take 128 registers
// beside two panels' sums, read from the tile as each block is made.
template <int DP, bool HOLD = (DP <= 128)>
struct ATile {
  uint32_t f[DP / 16][4];
  __device__ __forceinline__ ATile(const bf16* tile, int lane) {
    bya::load_a_frags<DP / 16, DP + 8>(f, tile, lane);
  }
  __device__ __forceinline__ void scores(float (&s)[2][4], const bf16* rows, int lane) const {
    scores16<DP>(s, f, rows, lane);
  }
};
template <int DP>
struct ATile<DP, false> {
  const bf16* tile;
  __device__ __forceinline__ ATile(const bf16* t, int) : tile(t) {}
  __device__ __forceinline__ void scores(float (&s)[2][4], const bf16* rows, int lane) const {
    scores16_smem<DP>(s, tile, rows, lane);
  }
};

// rows [tile * 16, tile * 16 + 16) < S, output panel `pn` (columns 64 pn ..
// 64 pn + 63, those < dh) of a [16, 64] fp32 result out to [M, S, H*dh] at
// `base` (row stride `ld`) through the staging tile `stg` (its panel's columns)
template <int DP>
__device__ __forceinline__ void write_tile(bf16* __restrict__ out, long long base, long long ld,
                                           bf16* stg, const float (&acc)[8][4], int tile, int pn,
                                           int S, int ch, int lane) {
  constexpr int LDS = DP + 8;
  const int rows = min(16, S - tile * 16);
  __syncwarp();
  stage_rows<8, LDS>(stg, acc, lane, rows);
  __syncwarp();
  for (int i = lane; i < rows * 8; i += 32) {
    const int r = i >> 3, c = pn * 8 + (i & 7);
    if (c < ch)
      *reinterpret_cast<uint4*>(out + base + (long long)(tile * 16 + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(stg + r * LDS + (i & 7) * 8);
  }
  __syncwarp();
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

}  // namespace
