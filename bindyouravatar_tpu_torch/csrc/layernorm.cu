// Row LayerNorm forward: kernel B6.
//
//   y[r, :] = (x[r, :] - mean_r) * rsqrt(var_r + eps) * scale + bias
//
// over rows of D bf16 values (D % 128 == 0, D <= 8192), with fp32 mean, the
// centred variance by a second pass over the row held in registers, the
// affine in fp32 and one bf16 rounding: the math of the TPU kernel
// `_ln_kernel` (bindyouravatar_tpu/ops/layernorm.py), reached from
// `LayerNorm(fused=True)`: the audio `norm_q` over [B*S, 3072] in every
// audio layer, and on the face path the perceiver norms ([B*S, 3072] and
// the face tokens), the router norms ([B*S, 2048]) and the trunk and STAB
// norms ([B*I*S, 512]), and the audio projection's norm ([.., 768]) once
// per clip.
//
// What bounds it on the H100: memory.  It reads and writes each element
// once (4 bytes) for ~8 FLOP, far below the ~295 FLOP/B ridge: 431 MB at
// [35100, 3072], 0.129 ms at 3.35 TB/s.
//
// Design, against what held the one-program-per-row Triton kernel back (a
// power-of-two block that leaves 25% of the lanes masked at D = 3072, the
// affine reloaded per row, and at the face path's narrow widths 35,100 to
// 70,200 programs of a few KB each):
//  * persistent blocks of 8 warps, a few per SM (the occupancy the
//    compiler leaves), stride over the rows;
//  * a row belongs to one warp for D <= 1024, else to a group of WPR = 2, 4
//    or 8 warps (the least power of two with D <= 1024 WPR); the block
//    takes 8 / WPR rows a step;
//  * each thread holds its part of the row as NV 16-byte vectors of 8 bf16
//    (16-byte chunk t + j * 32 WPR of the row, j < NV), so loads are whole
//    16-byte words, neighbouring lanes on neighbouring addresses; chunks
//    past the row's end (D = 128, 640, 1152, ...) are predicated off;
//  * each row group keeps its next two or three rows in flight in as many
//    register buffers, so a row's loads are issued rows before its
//    reductions and its memory latency hides behind the arithmetic of the
//    rows between;
//  * scale and bias are read once per block into shared memory as fp32, in
//    two halves (elements 0-3 and 4-7 of each chunk) so each lane's 16-byte
//    shared loads are conflict-free;
//  * the mean and the variance are warp shuffles, and for WPR > 1 a sum of
//    the group's warp partials through shared memory (double-buffered),
//    behind a named barrier of the group alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;  // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(p[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// NV: 16-byte chunks per thread (1..4); wpr: warps per row (1, 2, 4, 8)
template <int NV>
__global__ void __launch_bounds__(NTHREADS) layernorm_rows_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int rows, int D, int wpr,
    float eps) {
  extern __shared__ float4 sAff[];  // [2][D / 8] scale halves, then [2][D / 8] bias halves
  __shared__ float red[2][NWARPS];  // warp partials of the row sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nch = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < D / 4; i += NTHREADS) {
    const int c = i >> 1, half = i & 1;
    sAff[half * nch + c] = reinterpret_cast<const float4*>(scale)[i];
    sAff[(2 + half) * nch + c] = reinterpret_cast<const float4*>(bias)[i];
  }
  __syncthreads();

  const int rpb = NWARPS / wpr;                       // rows per block step
  const int grp = warp / wpr;                         // this warp's row slot
  const int t = (warp % wpr) * 32 + lane, tpr = wpr * 32;
  const long long step = (long long)gridDim.x * rpb;
  const float inv_d = 1.0f / (float)D;
  int par = 0;

  // the row group's sum of v: a warp shuffle, then for WPR > 1 the group's
  // warp partials through shared memory behind the group's own named
  // barrier (id 1 + grp), so row groups never wait for each other
  auto row_sum = [&](float v) {
    v = warp_sum(v);
    if (wpr == 1) return v;
    if (lane == 0) red[par][warp] = v;
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * wpr) : "memory");
    float s = 0.f;
    for (int k = 0; k < wpr; ++k) s += red[par][grp * wpr + k];
    par ^= 1;
    return s;
  };
  auto load = [&](uint4 (&dst)[NV], long long row) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = t + j * tpr;
      dst[j] = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows && c < nch)
        dst[j] = __ldcs(reinterpret_cast<const uint4*>(x + row * (long long)D) + c);
    }
  };
  // LN of one row held in `cur` (the group calls it for rows past the end
  // too, for the barriers, and stores nothing there): the row in fp32
  // registers, centred in place for the variance and the output
  auto norm_row = [&](const uint4 (&cur)[NV], long long row) {
    float f[NV][8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack8(cur[j], f[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += f[j][e];
    }
    const float mean = row_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const bool in_row = t + j * tpr < nch;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        f[j][e] -= mean;
        sq += in_row ? f[j][e] * f[j][e] : 0.f;
      }
    }
    const float rstd = rsqrtf(row_sum(sq) * inv_d + eps);
    if (row >= rows) return;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = t + j * tpr;
      if (c >= nch) continue;
      const float4 s0 = sAff[c], s1 = sAff[nch + c];
      const float4 b0 = sAff[2 * nch + c], b1 = sAff[3 * nch + c];
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = __floats2bfloat162_rn(f[j][2 * e] * rstd * sc[2 * e] + bi[2 * e],
                                     f[j][2 * e + 1] * rstd * sc[2 * e + 1] + bi[2 * e + 1]);
      __stcs(reinterpret_cast<uint4*>(y + row * (long long)D) + c, out);
    }
  };

  // the group's rows are row, row + step, row + 2 step, ...: DEPTH of them
  // in flight in as many register buffers, each refilled right after its
  // row is done.  Three where a thread holds three chunks (D = 3072: 0.155
  // against 0.163 ms with two), two elsewhere (three were slower at 2048
  // and 512; kernel records on an H100 80GB HBM3 at 700 W)
  constexpr int DEPTH = NV == 3 ? 3 : 2;
  uint4 xb[DEPTH][NV];
  long long row = (long long)blockIdx.x * rpb + grp;
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) load(xb[k], row + k * step);
  while (row - grp < rows) {
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      if (row - grp >= rows) break;
      norm_row(xb[k], row);
      load(xb[k], row + DEPTH * step);
      row += step;
    }
  }
}

template <int NV>
int launch(const void* x, const float* scale, const float* bias, void* y, int rows, int D,
           int wpr, float eps, cudaStream_t st) {
  static int sms = 0, per_sm[8192 / 128 + 1] = {};
  const int smem = 2 * D * (int)sizeof(float);  // scale and bias
  if (per_sm[D / 128] == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaFuncSetAttribute(layernorm_rows_kernel<NV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           2 * 8192 * (int)sizeof(float));
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, layernorm_rows_kernel<NV>,
                                                          NTHREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (n == 0) return (int)cudaErrorInvalidConfiguration;
    per_sm[D / 128] = n;
  }
  const long long steps = ((long long)rows + NWARPS / wpr - 1) / (NWARPS / wpr);
  const long long fit = (long long)sms * per_sm[D / 128];
  layernorm_rows_kernel<NV><<<(unsigned)(steps < fit ? steps : fit), NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), scale, bias, static_cast<__nv_bfloat16*>(y), rows,
      D, wpr, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// B6.  x, y: [rows, D] bf16, contiguous, 16-byte aligned; scale, bias: [D]
// fp32, 16-byte aligned; D % 128 == 0, 128 <= D <= 8192.  Returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for a D it does not
// take.
extern "C" int bya_layernorm_fwd(const void* x, const float* scale, const float* bias, void* y,
                                 int rows, int D, float eps, void* stream) {
  if (D < 128 || D > 8192 || D % 128 != 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int wpr = 1;
  while (D > 1024 * wpr) wpr *= 2;
  const int nv = (D / 8 + 32 * wpr - 1) / (32 * wpr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 1: return launch<1>(x, scale, bias, y, rows, D, wpr, eps, st);
    case 2: return launch<2>(x, scale, bias, y, rows, D, wpr, eps, st);
    case 3: return launch<3>(x, scale, bias, y, rows, D, wpr, eps, st);
    default: return launch<4>(x, scale, bias, y, rows, D, wpr, eps, st);
  }
}
