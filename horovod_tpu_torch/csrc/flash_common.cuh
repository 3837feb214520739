// Building blocks of the flash-attention kernels: for flash_bwd.cu, bf16
// tiles staged in shared memory with 16-byte `cp.async` copies, fragments
// loaded with `ldmatrix`, and the tensor-core product
// `mma.sync.m16n8k16` (bf16 operands, fp32 accumulators); for both
// kernels, the constants, the quad reductions over a row of an m16n8 C
// fragment (which a wgmma accumulator repeats), bf16 packing and the
// shared-memory limit.  flash_fwd.cu's Hopper helpers (TMA, mbarrier,
// wgmma) are in hopper_common.cuh.
//
// Tiles.  A tile is `rows x D` bf16 values, one row of the [B, S, heads, D]
// tensor per tile row (D = 64 or 128).  Each row is D / 8 chunks of 16
// bytes; chunk c of row r is stored at chunk position c ^ (r & 7), so the
// eight rows an `ldmatrix` reads at one chunk column fall in eight
// different bank groups.
//
// Fragments of m16n8k16 (a warp of 32 lanes, lane = 4 * g + t):
// - A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//   a2 = A[g][8+2t..], a3 = A[g+8][8+2t..];
// - B (16 x 8, "col"): b0 = B[2t..2t+1][g], b1 = B[8+2t..][g];
// - C (16 x 8, fp32): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..].
// Two C fragments side by side (16 x 16) are, rounded to bf16, the A
// fragment of the next product: that is how P and dS feed P.V, dS.K, P^T.dO
// and dS^T.Q without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the mask value of the Pallas kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Largest dynamic shared memory a CTA may ask for on Hopper.
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Element offset of chunk c (8 bf16 values) of row r in a swizzled tile.
template <int D> __device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// Stage ROWS rows of D bf16 values, `stride` elements apart in device
// memory, into a swizzled tile, as 16-byte asynchronous copies (not
// committed here).
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, size_t stride) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    cp_async16(tile + swz<D>(r, c), src + (size_t)r * stride + c * 8);
  }
}

// Stage n fp32 values (n a multiple of 4) as 16-byte asynchronous copies.
template <int NT>
__device__ __forceinline__ void load_f32(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += NT) cp_async16(dst + 4 * i, src + 4 * i);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b, one m16n8k16 tensor-core product.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (rows m0..m0+15, k columns 16kk..16kk+15) of a row-major
// swizzled tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int m0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, smem_u32(tile + swz<D>(m0 + (lane & 15), 2 * kk + (lane >> 4))));
}

// B fragments of B = T^T for a tile T whose rows are the n index and whose
// columns are the k index (K in Q.K^T): n rows n0..n0+15, k columns
// 16kk..16kk+15.  b[0], b[1] serve n0..n0+7 and b[2], b[3] n0+8..n0+15.
template <int D>
__device__ __forceinline__ void load_b_rows_n(uint32_t (&b)[4], const bf16* tile, int n0,
                                              int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, smem_u32(tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                                        2 * kk + ((lane >> 3) & 1))));
}

// B fragments of B = T for a tile T whose rows are the k index and whose
// columns are the n index (V in P.V): k rows 16kk..16kk+15, n columns
// n0..n0+15.  b[0], b[1] serve n0..n0+7 and b[2], b[3] n0+8..n0+15.
template <int D>
__device__ __forceinline__ void load_b_rows_k(uint32_t (&b)[4], const bf16* tile, int kk,
                                              int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, smem_u32(tile + swz<D>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                              (n0 >> 3) + (lane >> 4))));
}

// The A fragment of k columns 16kk..16kk+15 from C fragments c[2kk] and
// c[2kk + 1], rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Reductions over the four lanes that hold one row of a C fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store a warp's 16 x D fp32 accumulator (C fragments acc[D / 8]) as bf16
// rows `stride` elements apart.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, const float (&acc)[D / 8][4],
                                           float s0, float s1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + (size_t)g * stride + col) =
        pack_bf16(acc[j][0] * s0, acc[j][1] * s0);
    *reinterpret_cast<uint32_t*>(dst + (size_t)(g + 8) * stride + col) =
        pack_bf16(acc[j][2] * s1, acc[j][3] * s1);
  }
}

// Set the dynamic shared memory of a kernel above the 48 KB default.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace flash
