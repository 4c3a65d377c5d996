// Row LayerNorm forward and backward: kernels B6 and B9.
//
//   B6:  y[r, :] = (x[r, :] - mean_r) * rsqrt(var_r + eps) * scale + bias
//   B9:  xhat = (x - mean_r) r_r,  gy = g * scale,
//        dx = r_r (gy - mean(gy) - xhat mean(gy xhat))     (means over the row)
//        dscale = sum_r g * xhat,  dbias = sum_r g         (fp32, over all rows)
//
// over rows of D bf16 values (D % 128 == 0, D <= 8192), with fp32 mean, the
// centred variance by a second pass over the row held in registers, the
// affine in fp32 and one bf16 rounding: the math of the TPU kernels
// `_ln_kernel` and `_ln_bwd_kernel` (bindyouravatar_tpu/ops/layernorm.py),
// reached from `LayerNorm(fused=True)`: the audio `norm_q` over
// [B*S, 3072] in every audio layer, and on the face path the perceiver
// norms ([B*S, 3072] and the face tokens), the router norms ([B*S, 2048])
// and the trunk and STAB norms ([B*I*S, 512]), and the audio projection's
// norm ([.., 768]) once per clip (forward only: it is frozen).
//
// What bounds them on the H100: memory.  The forward reads and writes each
// element once (4 bytes) for ~8 FLOP, far below the ~295 FLOP/B ridge:
// 431 MB at [35100, 3072], 0.129 ms at 3.35 TB/s.  The backward reads x and
// g and writes dx (6 bytes an element) for ~12 FLOP: 323 MB at
// [17550, 3072], 0.097 ms.
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
//
// B9 takes the same rows, against what held the Triton kernel it replaces
// back (528 programs that each walked ceil(M / 528) rows one after another
// with only the current row's loads in flight, a power-of-two block, and
// two torch sums after it to fold its [programs, D] partials of dscale and
// dbias, most of the call at [64, 2048]):
//  * the forward's row machinery with two rows (x and g) a step, two steps
//    in flight per row group; WPR is the least power of two that leaves a
//    thread at most three chunks (D = 3072: 4 warps a row, 2048: 4, 512: 1);
//  * registers are the budget: with the dscale/dbias partials in registers
//    and gy kept unpacked, D = 3072 took 210 registers a thread (one block
//    an SM, 0.149 ms at [17550, 3072]).  So only x stays unpacked (gy is
//    unpacked again where it is needed), and a thread's partials, the same
//    columns in every row of its group, are added in shared memory, one
//    slice per row group: 126 registers at D = 3072, two blocks an SM,
//    0.129 ms (kernel records, H100 80GB HBM3 at 700 W; three blocks an SM
//    at one or two chunks a thread were 1% faster at 2048, 12% slower at
//    512).  After the rows, the block adds its groups' slices in group
//    order and writes one [2, D] partial row;
//  * the partial rows are folded in the same launch: the grid is launched
//    cooperatively (every block resident at once), meets at a grid barrier,
//    and then the grid's warps fold the columns, lane l summing the partial
//    rows l, l + 32, ... in order and the warp adding its lanes by a fixed
//    xor tree: deterministic, no float atomics, no second launch.  The
//    barrier and the fold cost ~2.5 us at [64, 2048] and ~5 us at the
//    large shapes with a fold that waited on each load in turn (measured
//    against a copy without them); the fold now has a lane's loads of up
//    to four columns or eight partial rows in flight at once;
//  * rows past M load as zeros and add nothing; every block has rows.
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

// ---------------------------------------------------------------- B9

// A grid-wide barrier for a cooperative launch (every block resident).  The
// counter flips its top bit once all gridDim.x blocks have arrived (block 0
// adds 2^31 - (gridDim.x - 1), the others 1) and its low 31 bits return to
// where they were, so a counter zeroed once serves every later launch (a
// start with low bits near 2^31 could carry into the top bit early).
// Launches that share a counter must not overlap.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old, now;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(bar), "r"(add) : "memory");
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(now) : "l"(bar) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  __syncthreads();
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// The fold of the grid's partial rows part4 ([gridDim.x][n4] float4) into
// dsb4 ([n4]): warp w of the grid takes float4 columns w, w + nw, ...,
// U of them at a time, and lane l adds partial rows l, l + 32, ... in that
// order, K rows of each column loaded before any is added; the lanes then
// add by a fixed xor tree.  U and K only choose how many loads are in
// flight at once (U = 4 where a lane has one row a column, K = 8 where it
// has several); the order of the sums is the same.
template <int U, int K>
__device__ __forceinline__ void fold(const float4* part4, float4* dsb4, int n4, int warp_id,
                                     int nw, int lane) {
  const int nb = (int)gridDim.x;
  for (int i0 = warp_id; i0 < n4; i0 += U * nw) {
    float4 a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b0 = lane; b0 < nb; b0 += 32 * K) {
      float4 v[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int b = b0 + 32 * k, i = i0 + u * nw;
          v[u][k] = b < nb && i < n4 ? __ldcg(part4 + (long long)b * n4 + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (b0 + 32 * k < nb) add4(a[u], v[u][k]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        add4(a[u], make_float4(__shfl_xor_sync(FULL, a[u].x, o), __shfl_xor_sync(FULL, a[u].y, o),
                               __shfl_xor_sync(FULL, a[u].z, o), __shfl_xor_sync(FULL, a[u].w, o)));
      if (lane == 0 && i0 + u * nw < n4) dsb4[i0 + u * nw] = a[u];
    }
  }
}

// NV: 16-byte chunks per thread (1..4); wpr: warps per row (1, 2, 4, 8).
// part: [gridDim.x][2][D] fp32 partial rows; dsb: [2][D] fp32 (dscale, dbias)
template <int NV>
__global__ void __launch_bounds__(NTHREADS, NV < 4 ? 2 : 1) layernorm_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dx, float* part,
    float* __restrict__ dsb, unsigned* bar, int rows, int D, int wpr, float eps) {
  // [2][D / 8] scale halves (elements 0-3 and 4-7 of each chunk, as the
  // forward's affine), then per row group [4][D / 8]: its dscale and dbias
  // partials, halves the same way
  extern __shared__ float4 smem[];
  __shared__ float2 red[2][NWARPS];  // warp partials of the row sums, two at a time
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nch = D / 8;
  const int rpb = NWARPS / wpr;
  const int grp = warp / wpr;
  const int t = (warp % wpr) * 32 + lane, tpr = wpr * 32;
  const long long step = (long long)gridDim.x * rpb;
  const float inv_d = 1.0f / (float)D;
  float4* acc = smem + 2 * nch + grp * 4 * nch;  // this row group's partials
  for (int i = tid; i < D / 4; i += NTHREADS)
    smem[(i & 1) * nch + (i >> 1)] = reinterpret_cast<const float4*>(scale)[i];
  for (int i = tid; i < rpb * 4 * nch; i += NTHREADS)
    smem[2 * nch + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  int par = 0;

  // the row group's sums of (a, b), as the forward's row_sum
  auto row_sum2 = [&](float a, float b) {
    a = warp_sum(a);
    b = warp_sum(b);
    if (wpr == 1) return make_float2(a, b);
    if (lane == 0) red[par][warp] = make_float2(a, b);
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * wpr) : "memory");
    float2 s = make_float2(0.f, 0.f);
    for (int k = 0; k < wpr; ++k) {
      const float2 v = red[par][grp * wpr + k];
      s.x += v.x;
      s.y += v.y;
    }
    par ^= 1;
    return s;
  };
  auto load = [&](uint4 (&dst)[NV], const __nv_bfloat16* src, long long row) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = t + j * tpr;
      dst[j] = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows && c < nch)
        dst[j] = __ldcs(reinterpret_cast<const uint4*>(src + row * (long long)D) + c);
    }
  };
  // gy = g * scale of chunk j of a row held in gc (zeros past the row's end)
  auto scaled = [&](const uint4& gc, int j, float (&gy)[8]) {
    const int c = t + j * tpr;
    unpack8(gc, gy);
    if (c < nch) {
      const float4 s0 = smem[c], s1 = smem[nch + c];
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) gy[e] *= sc[e];
    }
  };

  // the backward of one row held in (xc, gc); called for rows past the end
  // too (for the barriers), which store and add nothing.  Only x stays
  // unpacked in registers; gy is unpacked again where it is needed, and a
  // thread's dscale / dbias partials (the same columns in every row of its
  // group) are added in shared memory, so two blocks fit an SM at D = 3072.
  auto bwd_row = [&](const uint4 (&xc)[NV], const uint4 (&gc)[NV], long long row) {
    float xf[NV][8], gy[8];
    float sx = 0.f, sg = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack8(xc[j], xf[j]);
      scaled(gc[j], j, gy);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sx += xf[j][e];
        sg += gy[e];
      }
    }
    const float2 m1 = row_sum2(sx, sg);
    const float mean = m1.x * inv_d, mg = m1.y * inv_d;
    float sq = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const bool in_row = t + j * tpr < nch;
      scaled(gc[j], j, gy);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xf[j][e] -= mean;
        sq += in_row ? xf[j][e] * xf[j][e] : 0.f;
        sgx += gy[e] * xf[j][e];  // gy is 0 past the row's end
      }
    }
    const float2 m2 = row_sum2(sq, sgx);
    const float r = rsqrtf(m2.x * inv_d + eps);
    const float mgx = m2.y * inv_d * r;  // mean(gy * xhat)
    if (row >= rows) return;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = t + j * tpr;
      if (c >= nch) continue;
      float gf[8], h[8];
      unpack8(gc[j], gf);
      scaled(gc[j], j, gy);
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = xf[j][e] * r;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = __floats2bfloat162_rn(r * (gy[2 * e] - mg - h[2 * e] * mgx),
                                     r * (gy[2 * e + 1] - mg - h[2 * e + 1] * mgx));
      __stcs(reinterpret_cast<uint4*>(dx + row * (long long)D) + c, out);
      add4(acc[c], make_float4(gf[0] * h[0], gf[1] * h[1], gf[2] * h[2], gf[3] * h[3]));
      add4(acc[nch + c], make_float4(gf[4] * h[4], gf[5] * h[5], gf[6] * h[6], gf[7] * h[7]));
      add4(acc[2 * nch + c], make_float4(gf[0], gf[1], gf[2], gf[3]));
      add4(acc[3 * nch + c], make_float4(gf[4], gf[5], gf[6], gf[7]));
    }
  };

  constexpr int DEPTH = 2;
  uint4 xb[DEPTH][NV], gb[DEPTH][NV];
  long long row = (long long)blockIdx.x * rpb + grp;
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    load(xb[k], x, row + k * step);
    load(gb[k], g, row + k * step);
  }
  __syncthreads();  // scale and partials in shared memory (the rows' loads overlap)
  while (row - grp < rows) {
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      if (row - grp >= rows) break;
      bwd_row(xb[k], gb[k], row);
      load(xb[k], x, row + DEPTH * step);
      load(gb[k], g, row + DEPTH * step);
      row += step;
    }
  }
  __syncthreads();

  // the block's partial row, the row groups' partials added in group
  // order.  float4 i of the [2][D] row: columns 4i.. of dscale (i < D / 4)
  // or of dbias; chunk (i % (D / 4)) / 2, half i % 2
  const int n4 = D / 2;
  float4* part4 = reinterpret_cast<float4*>(part);
  for (int i = tid; i < n4; i += NTHREADS) {
    const int q = i % (D / 4), which = i / (D / 4);
    const float4* src = smem + 2 * nch + (2 * which + (q & 1)) * nch + (q >> 1);
    float4 a = src[0];
    for (int k = 1; k < rpb; ++k) add4(a, src[k * 4 * nch]);
    __stcg(part4 + (long long)blockIdx.x * n4 + i, a);
  }

  grid_barrier(bar);

  const int nw = gridDim.x * NWARPS;
  if (gridDim.x <= 32)
    fold<4, 1>(part4, reinterpret_cast<float4*>(dsb), n4, blockIdx.x * NWARPS + warp, nw, lane);
  else
    fold<1, 8>(part4, reinterpret_cast<float4*>(dsb), n4, blockIdx.x * NWARPS + warp, nw, lane);
}

// B9's warps per row: the least power of two (at most 8) that leaves a
// thread at most three 16-byte chunks of a row
int bwd_wpr(int D) {
  int wpr = 1;
  while (wpr < 8 && D / 8 > 3 * 32 * wpr) wpr *= 2;
  return wpr;
}

// B9's shared memory: the scale, and dscale / dbias partials per row group
int bwd_smem(int D, int wpr) { return (D + (NWARPS / wpr) * 2 * D) * (int)sizeof(float); }

// the grid of B9 at (rows, D): min(row steps, blocks resident on the card)
template <int NV>
cudaError_t bwd_grid(int rows, int D, int wpr, int* blocks) {
  static int sms = 0, per_sm[8192 / 128 + 1] = {};
  if (per_sm[D / 128] == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaFuncSetAttribute(layernorm_bwd_kernel<NV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bwd_smem(8192, 8));
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, layernorm_bwd_kernel<NV>,
                                                          NTHREADS, bwd_smem(D, wpr));
    if (err != cudaSuccess) return err;
    if (n == 0) return cudaErrorInvalidConfiguration;
    per_sm[D / 128] = n;
  }
  const long long steps = ((long long)rows + NWARPS / wpr - 1) / (NWARPS / wpr);
  const long long fit = (long long)sms * per_sm[D / 128];
  *blocks = (int)(steps < fit ? steps : fit);
  return cudaSuccess;
}

template <int NV>
cudaError_t launch_bwd(const void* x, const float* scale, const void* g, void* dx, float* part,
                       int part_rows, float* dsb, unsigned* bar, int rows, int D, int wpr,
                       float eps, cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = bwd_grid<NV>(rows, D, wpr, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks > part_rows) return cudaErrorInvalidValue;
  void* args[] = {(void*)&x, (void*)&scale, (void*)&g, (void*)&dx, (void*)&part,
                  (void*)&dsb, (void*)&bar, (void*)&rows, (void*)&D, (void*)&wpr, (void*)&eps};
  err = cudaLaunchCooperativeKernel((const void*)layernorm_bwd_kernel<NV>, dim3(blocks),
                                    dim3(NTHREADS), args, bwd_smem(D, wpr), st);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// B9's grid at (rows, D): the number of [2, D] fp32 partial rows that
// bya_layernorm_bwd needs.  Returns a cudaError_t (cudaErrorInvalidValue
// for a shape it does not take).
extern "C" int bya_layernorm_bwd_blocks(int rows, int D, int* blocks) {
  if (D < 128 || D > 8192 || D % 128 != 0 || rows < 1) return (int)cudaErrorInvalidValue;
  const int wpr = bwd_wpr(D);
  switch ((D / 8 + 32 * wpr - 1) / (32 * wpr)) {
    case 1: return (int)bwd_grid<1>(rows, D, wpr, blocks);
    case 2: return (int)bwd_grid<2>(rows, D, wpr, blocks);
    case 3: return (int)bwd_grid<3>(rows, D, wpr, blocks);
    default: return (int)bwd_grid<4>(rows, D, wpr, blocks);
  }
}

// B9.  x, g, dx: [rows, D] bf16, contiguous, 16-byte aligned; scale: [D]
// fp32, 16-byte aligned; part: [part_rows, 2, D] fp32 scratch, part_rows at
// least bya_layernorm_bwd_blocks' count; dsb: [2, D] fp32, dscale then
// dbias; bar: one unsigned counter, zeroed before its first use and then
// left to the kernel, that no launch running beside this one uses.  D % 128 == 0, 128 <= D <= 8192, rows >= 1.
// Returns the cudaError_t of the launch, or cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int bya_layernorm_bwd(const void* x, const float* scale, const void* g, void* dx,
                                 float* part, int part_rows, float* dsb, void* bar, int rows,
                                 int D, float eps, void* stream) {
  if (D < 128 || D > 8192 || D % 128 != 0 || rows < 1) return (int)cudaErrorInvalidValue;
  const int wpr = bwd_wpr(D);
  unsigned* b = static_cast<unsigned*>(bar);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D / 8 + 32 * wpr - 1) / (32 * wpr)) {
#define BYA_LN_BWD_CASE(n) \
  return (int)launch_bwd<n>(x, scale, g, dx, part, part_rows, dsb, b, rows, D, wpr, eps, st);
    case 1: BYA_LN_BWD_CASE(1)
    case 2: BYA_LN_BWD_CASE(2)
    case 3: BYA_LN_BWD_CASE(3)
    default: BYA_LN_BWD_CASE(4)
#undef BYA_LN_BWD_CASE
  }
}
