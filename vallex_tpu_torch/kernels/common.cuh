// Shared helpers for the hand-written Hopper kernels of vallex_tpu_torch.
//
// Each kernel exports one extern "C" launcher that takes raw device pointers
// (from torch.Tensor.data_ptr()), plain ints and floats, and the CUDA stream
// (torch.cuda.current_stream().cuda_stream). It launches on that stream,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VX_FULL_MASK 0xffffffffu
#define VX_NEG_BIG (-1e30f)

__device__ __forceinline__ float vx_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(VX_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float vx_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(VX_FULL_MASK, v, o));
  return v;
}

// Unpack 8 bf16 values held in one 16-byte word into floats.
__device__ __forceinline__ void vx_bf16x8_to_f32(const uint4 raw, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
