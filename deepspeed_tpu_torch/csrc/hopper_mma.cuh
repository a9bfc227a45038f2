// Tensor-core and asynchronous-copy helpers shared by the flash-attention
// kernels: cp.async staging, ldmatrix fragment loads and the
// mma.sync.m16n8k16 product with fp32 accumulation, for bf16 and fp16
// inputs. Built for sm_90a with the kernels that include it.
//
// Fragment layouts of mma.m16n8k16 (row.col), for lane l with g = l / 4 and
// c = l % 4:
//   A (16 x 16, row-major), 4 registers of two values each:
//     a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 2c+8..), a3 = (g+8, 2c+8..)
//   B (16 x 8, k x n), 2 registers: b0 = (k 2c..2c+1, n g), b1 = (k 2c+8.., n g)
//   C (16 x 8 fp32), 4 floats: c0, c1 = (g, 2c..2c+1), c2, c3 = (g+8, 2c..)
// So the C fragments of two neighbouring n-tiles are, packed to 16 bits, the
// A fragment of one 16-wide k-step: a product's result feeds the next
// product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cmath>
#include <cstdint>

namespace hopper {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; when !in the 16 bytes are zeroed
// and nothing is read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes global -> shared; zero when !in.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit values; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i in the A/B/C
// fragment order (row l / 4, columns 2 (l % 4) ..+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The same, transposed: register i receives (rows 2 (l % 4) ..+1, column
// l / 4) of matrix i, the B fragment of a row-major k x n tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b on the tensor cores, fp32 accumulation
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to the input type, lo in the low 16 bits
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x (ex2.approx, ~2 ulp); 2^-inf = 0
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Stage rows [r0, r0 + ROWS) of a (t, D) row-major slice into a shared tile
// with row stride D + 8 elements (16 bytes of padding, so the eight row
// addresses of an ldmatrix fall in eight different bank groups), 16 bytes a
// thread by cp.async; rows past t are zero-filled. NT threads take part.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src, int r0,
                                                int t) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * kChunks) % NT == 0, "tile chunks must divide over the threads");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < t;
    cp_async_16(dst + r * (D + 8) + c * 8,
                src + static_cast<size_t>(in ? r0 + r : 0) * D + c * 8, in);
  }
}

// The gathering variant: a 64-row tile of the same shared layout made of four
// 16-row chunks, chunk i from rows rows[i] .. rows[i] + 15 of the (t, D)
// slice. A chunk with rows[i] < 0 is not loaded: its rows keep what they
// held, so no reader may take them.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_chunks_async(T* dst, const T* __restrict__ src,
                                                  const int (&rows)[4]) {
  constexpr int kChunks = D / 8;          // 16-byte pieces per row
  constexpr int kPieces = 16 * kChunks;   // per 16-row chunk
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    if (rows[ch] < 0) continue;
#pragma unroll
    for (int i0 = 0; i0 < kPieces; i0 += NT) {
      const int i = i0 + threadIdx.x;
      if (kPieces % NT == 0 || i < kPieces) {
        const int r = i / kChunks, c = i % kChunks;
        cp_async_16(dst + (ch * 16 + r) * (D + 8) + c * 8,
                    src + static_cast<size_t>(rows[ch] + r) * D + c * 8, true);
      }
    }
  }
}

}  // namespace hopper
