// Tensor-core and asynchronous-copy building blocks of the port's bf16
// kernels (flash_attention.cu, the FFN backward in ffn_kernels.cuh).
//
// They use the Ampere-era warp-level instructions, which Hopper keeps:
// `mma.sync.aligned.m16n8k16` (bf16 operands, float32 accumulators),
// `ldmatrix` to load operand fragments from shared memory (`.trans` for an
// operand stored with its reduction index along rows), and `cp.async` to
// copy 16-byte chunks from global to shared memory without passing through
// registers, so a block can load its next tile while it computes on the
// current one.
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16
// with floating point type"), for lane = 4 g + t:
//   A (16 x 16, row-major) a[0..3]: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//     (g+8, 2t+8..);
//   B (16 x 8, k x n) b[0..1]: (2t..2t+1, g), (2t+8..2t+9, g);
//   C (16 x 8) c[0..3]: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// The lower column (or k) index of a pair sits in the lower 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace espnet_port {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes < 16 zero-fills the rest (0: no read,
// `src` need only be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared, zero-filled when bytes == 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives its fragment.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two matrices (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += A (16 x 16) B (16 x 8), bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed, `lo` in the lower 16 bits.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace espnet_port
