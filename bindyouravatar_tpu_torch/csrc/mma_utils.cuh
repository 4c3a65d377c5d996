// Warp-level tensor-core helpers shared by the port's attention kernels.
//
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) fragment layouts, with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..)
//                         a2 = (g, 8+2t..)     a3 = (g+8, 8+2t..)
//   B (16x8, col-major):  b0 = (k=2t..2t+1, n=g)  b1 = (k=8+2t.., n=g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1)   c2,c3 = (g+8, 2t..)
// Tiles live in shared memory as rows of D bf16 padded to LDS elements, so
// the eight 16-byte row reads of one ldmatrix phase hit distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bya {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// c += a * b  (m16n8k16, bf16 x bf16 -> fp32)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global->shared copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two floats -> packed bf16x2 (lo in the low half: the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [r0, r0 + ROWS) of a row-major matrix (row stride `ld`
// elements, D bf16 per row read, D a multiple of 8) into shared memory rows
// of `lds` elements.  Rows at or past `r_lim` are zero-filled.
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_rows(bf16* sm, int lds, const bf16* base, long long ld,
                                          int r0, int r_lim, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int gr = r0 + r;
    const bool ok = gr < r_lim;
    const bf16* src = base + (ok ? (long long)gr * ld : 0) + c;
    cp_async16(sm + r * lds + c, src, ok ? 16 : 0);
  }
}

// The KS A fragments (k = 0..16*KS-1) of a warp's 16 rows of a [*, LDS] tile.
template <int KS, int LDS>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[KS][4], const bf16* tile_rows,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bf16* p = tile_rows + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(f[kk][0], f[kk][1], f[kk][2], f[kk][3], p);
  }
}

// s[nt] += A (16 x 16*KS) * B^T for B rows nt*8..nt*8+7 of a [*, LDS] tile:
// the score block of 16 query rows against NT*8 key rows (KS even).
template <int NT, int KS, int LDS>
__device__ __forceinline__ void qk_scores(float (&s)[NT][4], const uint32_t (&qf)[KS][4],
                                          const bf16* ks, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      uint32_t b0, b1, b2, b3;
      const bf16* p = ks + (nt * 8 + (lane & 7)) * LDS + kk * 16 + (lane >> 3) * 8;
      ldmatrix_x4(b0, b1, b2, b3, p);
      mma_bf16(s[nt], qf[kk], b0, b1);
      mma_bf16(s[nt], qf[kk + 1], b2, b3);
    }
  }
}

// o[nd] += P (16 x NT*8, fp32 score fragments rounded to bf16) * V
// (NT*8 x 8*ND) with V row-major in a [*, LDS] tile (NT, ND even).
template <int NT, int ND, int LDS>
__device__ __forceinline__ void pv_accumulate(float (&o)[ND][4], const float (&p)[NT][4],
                                              const bf16* vs, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t b0, b1, b2, b3;
      const bf16* ptr = vs + (kk * 16 + (lane & 15)) * LDS + (nd + (lane >> 4)) * 8;
      ldmatrix_x4_trans(b0, b1, b2, b3, ptr);
      mma_bf16(o[nd], a, b0, b1);
      mma_bf16(o[nd + 1], a, b2, b3);
    }
  }
}

// the body a head of width dh runs on in the attention kernels: 64, 128 or
// 256 columns (the narrowest that holds it), or 0 for a width none takes
// (dh % 8 != 0, or outside 8..256)
inline int body_of(int dh) {
  if (dh < 8 || dh % 8 != 0 || dh > 256) return 0;
  return dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

}  // namespace bya
