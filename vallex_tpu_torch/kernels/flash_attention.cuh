// Shared by flash_attention.cu (the bf16 kernels on the tensor cores) and
// the f32 kernels on the CUDA cores, flash_attention_f32.cu (the forward) and
// flash_attention_f32_bwd.cu (dQ and dK/dV): the tile of 64 rows, the strides
// the launchers take, the mask, the 16-lane row reductions, and the f32
// launchers. Each f32 source is its own translation unit: compiled beside the
// bf16 kernels, f32 code changed how nvcc compiles them (5-12% slower in an
// A/B run on the card).
#pragma once

#include <limits.h>
#include <math.h>

#include "common.cuh"

#define FA_TILE 64

struct FaStrides {
  long long b, h, t;
};

// max / sum over the 16 lanes that share a row group (tx = lane & 15)
__device__ __forceinline__ float fa_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(VX_FULL_MASK, v, o));
  return v;
}
__device__ __forceinline__ float fa_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(VX_FULL_MASK, v, o);
  return v;
}

// Rows past T carry distinct pads in the query and key tiles, so they never
// match: INT_MIN for keys, INT_MIN + 1 for queries.
#define FA_PAD_K (-2147483647 - 1)
#define FA_PAD_Q (-2147483647)

__device__ __forceinline__ bool fa_valid(int i, int j, int P, int seg_i, int seg_j) {
  return seg_i == seg_j && j <= max(i, P - 1);
}

// The f32 forward (flash_attention_f32.cu) for head dim hd (64 or 128),
// with the arguments of vx_flash_attention_fwd; returns a CUDA error code.
int fa_fwd_f32(const void* q, const long long* qs, const void* k, const void* v,
               const long long* kvs, const int* qseg, const int* kvseg, void* o,
               const long long* os, float* lse, int hd, int B, int H, int T_len, int P,
               float scale, cudaStream_t s);

// The f32 dQ kernel (also writes di) and dK/dV kernel
// (flash_attention_f32_bwd.cu) with the arguments of vx_flash_attention_bwd_dq
// and vx_flash_attention_bwd_dkv; each returns a CUDA error code.
int fa_bwd_dq_f32(const void* q, const long long* qs, const void* k, const void* v,
                  const long long* kvs, const void* o, const long long* os, const void* dout,
                  const long long* dos, const int* qseg, const int* kvseg, const float* lse,
                  float* di, void* dq, int hd, int B, int H, int T_len, int P, float scale,
                  cudaStream_t s);
int fa_bwd_dkv_f32(const void* q, const long long* qs, const void* k, const void* v,
                   const long long* kvs, const void* dout, const long long* dos,
                   const int* qseg, const int* kvseg, const float* lse, const float* di,
                   void* dk, void* dv, int hd, int B, int H, int T_len, int P, float scale,
                   cudaStream_t s);
