// Warp-level tensor-core and asynchronous-copy helpers shared by the bf16
// kernels of flash_attention.cu and ssd_scan.cu (sm_80 instructions, all
// available on sm_90a): 16-byte cp.async copies into shared memory,
// ldmatrix loads of 8 x 8 bf16 tiles, and the m16n8k16 bf16 mma with f32
// accumulation; and the host-side shared-memory opt-in of every launch in
// both sources.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (lane = 4 g + t):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..2t+1),
//                           a2 = (g, 2t+8..2t+9), a3 = (g + 8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b0 = (2t..2t+1, g), b1 = (2t+8..2t+9, g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, ..)
// ldmatrix.x4 gives register i the 8 x 8 tile whose row addresses lanes
// 8 i .. 8 i + 7 supply; lane 4 g + t receives row g, columns 2t..2t+1 of
// it, or with .trans rows 2t..2t+1 of column g.
//
// Shared-memory tiles keep rows of kPad extra bf16 (16 bytes), so the 8 row
// addresses of one ldmatrix tile fall in 8 distinct 16-byte bank groups
// whenever a row holds a multiple of 16 values.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile_mma {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without passing through registers;
// when !valid nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows r0 .. r0 + 63 (of `cols` contiguous bf16, cols % 8 == 0) of a
// strided operand into a 64-row shared tile with row stride ld; rows at or
// past `rows` are zero-filled. Issued by all `threads` threads of the block.
template <int kThreads>
__device__ __forceinline__ void load_tile64(bf16* dst, int ld,
                                            const bf16* __restrict__ src,
                                            int64_t row_stride, int r0,
                                            int rows, int cols) {
  const int cpr = cols / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const bool in = r0 + r < rows;
    cp_async16(dst + r * ld + c,
               src + int64_t(in ? r0 + r : 0) * row_stride + c, in);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (denormal results flushed to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to bf16 (nearest even, as torch's .to()), lo in the low
// half: the register layout of an A fragment's column pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane offsets of an ldmatrix.x4 over a 16 x 16 block of a row-major tile,
// in (row, column) within the block. `a_layout`: the four tiles are
// (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) — an A
// fragment, or with .trans a B fragment pair over two n-tiles whose k runs
// along the rows. Otherwise (0-7, 0-7), (0-7, 8-15), (8-15, 0-7),
// (8-15, 8-15) — a B fragment pair over two n-tiles whose k runs along the
// columns, or with .trans an A fragment whose rows run along the columns.
__device__ __forceinline__ int ldm_row(int lane, bool a_layout) {
  return (a_layout ? (lane / 8) % 2 : lane / 16) * 8 + lane % 8;
}
__device__ __forceinline__ int ldm_col(int lane, bool a_layout) {
  return (a_layout ? lane / 16 : (lane / 8) % 2) * 8;
}

// Raise kern's dynamic shared-memory limit on the current device when a
// launch needs more than the last one did (above 48 KB a launch fails
// without it). Not on every launch: a launch may be captured in a CUDA
// graph. opted: the bytes granted so far, one entry per device.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kern, int smem, int (&opted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > opted[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace tile_mma
