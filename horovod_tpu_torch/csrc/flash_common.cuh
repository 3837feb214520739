// Numerics shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the constants of the Pallas kernels, base-2 exponentials,
// bf16 packing, the quad reductions over a row of an accumulator, and the
// shared-memory limit.  The Hopper machinery (TMA, mbarrier, wgmma,
// setmaxnreg) is in hopper_common.cuh.
//
// A wgmma accumulator repeats the m16n8 C fragment along n: lane 4 g + t
// of a warp holds columns 2t and 2t + 1 of rows g and g + 8 in each 8-wide
// column block, so the four lanes 4 g .. 4 g + 3 hold one row.  Packed to
// bf16 in pairs, two such blocks side by side are the m16n8k16 A fragment
// of 16 k columns: that is how P and dS feed the next product from
// registers, without a trip through shared memory.

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

// 2^x in one MUFU instruction; results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Reductions over the four lanes that hold one row of an accumulator.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A grid of `tiles` x `heads` CTAs whose (b, head) index is blockIdx.y +
// gridDim.y * blockIdx.z: y holds up to 65535 of them and z the rest.
inline dim3 head_grid(int tiles, int heads) {
  const int y = heads < 65535 ? heads : 65535;
  return dim3(tiles, y, (heads + y - 1) / y);
}

// Set the dynamic shared memory of a kernel above the 48 KB default.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace flash
