// gemm_small_m: Y[M, N] = epilogue(prologue(X)[M, K] . W[N, K]^T) for the
// few rows of a decode step.
//
// Replaces the matrix products inside two TPU kernels:
//   vallex_tpu/ops/decode_block.py  decode_block_fused (_kernel: `mat`, `_ffn`,
//                                   the fused head) -- the K-1 int8 draft steps,
//                                   the int8 serving blocks, and batched
//                                   requests (and their best_of samples) at
//                                   M = R * beams rows;
//   vallex_tpu/ops/decode_verify.py decode_verify (_kernel) -- the verify
//                                   pass over K = 8 positions.
// Each product there is LN -> matvec (QKV), matvec + residual (out-proj),
// LN -> matvec + bias -> ReLU (FFN1), matvec + bias + residual (FFN2) or
// LN -> matvec (head) on M rows of f32 hidden state. The W8A8 kind carries
// the same products of decode_block_fused(act_quant=True) and
// decode_step(act_quant=True) (the TPU kernels' `qmat`,
// vallex_tpu/ops/decode_block.py:160-165, decode_step.py:124-132).
//
// Bound on the H100: weight bytes. At M <= 8 every weight byte is used for at
// most 8 multiply-adds, far below the ~295 operations per byte where the
// tensor cores would become the limit, so the kernel is a weight stream.
// Design: weights are stored [N, K] (K contiguous) so one warp computes one
// output column with 16-byte coalesced loads along K (8 bf16, 16 int8 or 4
// f32 per lane per load), and N/8 blocks of 8 warps keep every SM streaming.
// The prologue (LayerNorm or a plain cast) writes the activation rows once
// per block into shared memory: rounded to bf16 for bf16 and int8 weights,
// as the TPU kernel casts the activations to bf16 before its MXU product, and
// kept in f32 for f32 weights (compute_dtype="float32", the TPU kernel's f32
// `mat`). Accumulation is f32; int8 weights carry f32 per-output-channel
// scales applied after the sum (W8A16).
//
// Rows: a block holds at most 8 rows; more rows (batched requests with their
// best_of samples) tile into groups of 8 along grid.y, each group streaming
// the weights again (the second and later groups mostly from L2). Each row's
// result does not depend on M or on the other rows: row m's LayerNorm runs in
// one warp alone, and its sum runs over k in the same per-lane order and the
// same warp reduction for any M and any group, so it is bitwise the row's
// M = 1 product (chip_smoke.py checks this at M = 4, 8, 16 and 20).
//
// W8A8 (w_kind 3): int8 weights with f32 per-output-channel scales, and
// int8 activations with a dynamic scale per row, as the TPU kernels' `qmat`:
//   sx = max(max_k |x[m, k]|, 1e-6) * (1/127)
//   xq = clip(round_half_even(x / sx), -127, 127)     (IEEE division)
//   y  = float(sum_k xq * w) * (sx * srow)            (int32 sum, exact)
// then bias, ReLU and residual. The warp that writes row m's activations
// also takes its max |x|, so the prologue reads x twice (the LayerNorm is
// recomputed with the same rounded operations, not stored in f32). The main
// loop keeps the 16-byte weight loads and multiplies 4 int8 pairs per
// `__dp4a` into an int32 sum; an integer sum is exact in any order. The
// epilogue rounds each operation on its own (no fused multiply-add), so a
// product whose prologue is a plain cast is bitwise the plain version's.
#include "common.cuh"

#define GEMM_ROWS 8  // rows per block (one row group)
#define GEMM_WARPS 8

// Weight kinds: the launcher's `w_kind`.
#define W_BF16 0
#define W_INT8 1
#define W_F32 2
#define W_W8A8 3

template <int WK>
struct Act {  // activation type in shared memory: bf16, or f32 with f32 weights
  typedef __nv_bfloat16 T;
};
template <>
struct Act<W_F32> {
  typedef float T;
};
template <>
struct Act<W_W8A8> {
  typedef int8_t T;
};

// one LayerNorm output, each operation rounded on its own, so the W8A8
// prologue's two passes (max, then quantize) compute the same value
__device__ __forceinline__ float vx_ln_at(const float* xr, int k, float mean, float rstd,
                                          const float* ln_s, const float* ln_b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xr[k], mean), rstd), ln_s[k]), ln_b[k]);
}

__device__ __forceinline__ void vx_store_act(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void vx_store_act(float* p, float v) { *p = v; }

template <int WK>
__global__ void __launch_bounds__(GEMM_WARPS * 32)
gemm_small_m_kernel(const float* __restrict__ x, int ldx, const void* __restrict__ w,
                    const float* __restrict__ wscale, const float* __restrict__ bias,
                    const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                    const float* __restrict__ resid, int ldr, float* __restrict__ y,
                    int ldy, int M, int N, int K, int relu, float eps) {
  typedef typename Act<WK>::T TA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* xs = reinterpret_cast<TA*>(smem_raw);  // [rows][K] activations
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // this block's row group
  const int m0 = blockIdx.y * GEMM_ROWS;
  x += (size_t)m0 * ldx;
  y += (size_t)m0 * ldy;
  if (resid != nullptr) resid += (size_t)m0 * ldr;
  M = min(GEMM_ROWS, M - m0);

  __shared__ float sx_row[GEMM_ROWS];  // W8A8: each row's activation scale

  // ---- prologue: warp m prepares activation row m -------------------------
  for (int m = warp; m < M; m += GEMM_WARPS) {
    const float* xr = x + (size_t)m * ldx;
    TA* xo = xs + (size_t)m * K;
    float mean = 0.f, rstd = 0.f;
    if (ln_s != nullptr) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += xr[k];
      mean = vx_warp_sum(s) / (float)K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = xr[k] - mean;
        v += d * d;
      }
      rstd = rsqrtf(vx_warp_sum(v) / (float)K + eps);
    }
    if constexpr (WK == W_W8A8) {
      float amax = 0.f;
      for (int k = lane; k < K; k += 32)
        amax = fmaxf(amax, fabsf(ln_s != nullptr ? vx_ln_at(xr, k, mean, rstd, ln_s, ln_b)
                                                  : xr[k]));
      const float sx = fmaxf(vx_warp_max(amax), 1e-6f) * (1.0f / 127.0f);
      for (int k = lane; k < K; k += 32) {
        const float a = ln_s != nullptr ? vx_ln_at(xr, k, mean, rstd, ln_s, ln_b) : xr[k];
        const float q = fminf(fmaxf(rintf(__fdiv_rn(a, sx)), -127.f), 127.f);
        xo[k] = (int8_t)__float2int_rn(q);
      }
      if (lane == 0) sx_row[m] = sx;
    } else {
      if (ln_s != nullptr) {
        for (int k = lane; k < K; k += 32)
          vx_store_act(xo + k, (xr[k] - mean) * rstd * ln_s[k] + ln_b[k]);
      } else {
        for (int k = lane; k < K; k += 32) vx_store_act(xo + k, xr[k]);
      }
    }
  }
  __syncthreads();

  const int n = blockIdx.x * GEMM_WARPS + warp;
  if (n >= N) return;

  float acc[GEMM_ROWS];
#pragma unroll
  for (int m = 0; m < GEMM_ROWS; ++m) acc[m] = 0.f;

  if constexpr (WK == W_BF16) {
    const __nv_bfloat16* wr = reinterpret_cast<const __nv_bfloat16*>(w) + (size_t)n * K;
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(xs);
#pragma unroll 4
    for (int k0 = lane * 8; k0 < K; k0 += 32 * 8) {
      float wf[8];
      vx_bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(wr + k0)), wf);
#pragma unroll
      for (int m = 0; m < GEMM_ROWS; ++m) {
        if (m < M) {
          float xf[8];
          vx_bf16x8_to_f32(*reinterpret_cast<const uint4*>(xb + (size_t)m * K + k0), xf);
          float a = acc[m];
#pragma unroll
          for (int i = 0; i < 8; ++i) a = fmaf(xf[i], wf[i], a);
          acc[m] = a;
        }
      }
    }
  } else if constexpr (WK == W_INT8) {
    const int8_t* wr = reinterpret_cast<const int8_t*>(w) + (size_t)n * K;
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(xs);
#pragma unroll 2
    for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(wr + k0));
      const int8_t* wb = reinterpret_cast<const int8_t*>(&raw);
      float wf[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) wf[i] = (float)wb[i];
#pragma unroll
      for (int m = 0; m < GEMM_ROWS; ++m) {
        if (m < M) {
          float xf[16];
          const uint4* xp = reinterpret_cast<const uint4*>(xb + (size_t)m * K + k0);
          vx_bf16x8_to_f32(xp[0], xf);
          vx_bf16x8_to_f32(xp[1], xf + 8);
          float a = acc[m];
#pragma unroll
          for (int i = 0; i < 16; ++i) a = fmaf(xf[i], wf[i], a);
          acc[m] = a;
        }
      }
    }
  } else if constexpr (WK == W_W8A8) {
    // int8 x int8: 4 pairs per __dp4a into an exact int32 sum
    const int8_t* wr = reinterpret_cast<const int8_t*>(w) + (size_t)n * K;
    const int8_t* xq = reinterpret_cast<const int8_t*>(xs);
    int iacc[GEMM_ROWS];
#pragma unroll
    for (int m = 0; m < GEMM_ROWS; ++m) iacc[m] = 0;
#pragma unroll 2
    for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
      const int4 wv = __ldg(reinterpret_cast<const int4*>(wr + k0));
#pragma unroll
      for (int m = 0; m < GEMM_ROWS; ++m) {
        if (m < M) {
          const int4 xv = *reinterpret_cast<const int4*>(xq + (size_t)m * K + k0);
          int a = iacc[m];
          a = __dp4a(xv.x, wv.x, a);
          a = __dp4a(xv.y, wv.y, a);
          a = __dp4a(xv.z, wv.z, a);
          a = __dp4a(xv.w, wv.w, a);
          iacc[m] = a;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < GEMM_ROWS; ++m) {
      int a = iacc[m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(VX_FULL_MASK, a, o);
      iacc[m] = a;
    }
    if (lane == 0) {
      const float srow = wscale[n];
      const float b = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
      for (int m = 0; m < GEMM_ROWS; ++m) {
        if (m < M) {
          // float(acc) * (sx * srow), then + bias, ReLU, + residual, each
          // rounded on its own (as the plain version)
          float v = __fmul_rn(__int2float_rn(iacc[m]), __fmul_rn(sx_row[m], srow));
          if (bias != nullptr) v = __fadd_rn(v, b);
          if (relu) v = fmaxf(v, 0.f);
          if (resid != nullptr) v = __fadd_rn(v, resid[(size_t)m * ldr + n]);
          y[(size_t)m * ldy + n] = v;
        }
      }
    }
    return;
  } else {  // W_F32
    const float* wr = reinterpret_cast<const float*>(w) + (size_t)n * K;
    const float* xf32 = reinterpret_cast<const float*>(xs);
#pragma unroll 4
    for (int k0 = lane * 4; k0 < K; k0 += 32 * 4) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + k0));
#pragma unroll
      for (int m = 0; m < GEMM_ROWS; ++m) {
        if (m < M) {
          const float4 xv = *reinterpret_cast<const float4*>(xf32 + (size_t)m * K + k0);
          float a = acc[m];
          a = fmaf(xv.x, wv.x, a);
          a = fmaf(xv.y, wv.y, a);
          a = fmaf(xv.z, wv.z, a);
          a = fmaf(xv.w, wv.w, a);
          acc[m] = a;
        }
      }
    }
  }

  // ---- epilogue: scale, bias, ReLU, residual ------------------------------
#pragma unroll
  for (int m = 0; m < GEMM_ROWS; ++m) acc[m] = vx_warp_sum(acc[m]);
  if (lane == 0) {
    const float sc = wscale != nullptr ? wscale[n] : 1.f;
    const float b = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
    for (int m = 0; m < GEMM_ROWS; ++m) {
      if (m < M) {
        float v = acc[m] * sc + b;
        if (relu) v = fmaxf(v, 0.f);
        if (resid != nullptr) v += resid[(size_t)m * ldr + n];
        y[(size_t)m * ldy + n] = v;
      }
    }
  }
}

template <int WK>
static cudaError_t launch(const float* x, int ldx, const void* w, const float* wscale,
                          const float* bias, const float* ln_s, const float* ln_b,
                          const float* resid, int ldr, float* y, int ldy, int M, int N,
                          int K, int relu, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)min(M, GEMM_ROWS) * K * sizeof(typename Act<WK>::T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_small_m_kernel<WK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + GEMM_WARPS - 1) / GEMM_WARPS, (M + GEMM_ROWS - 1) / GEMM_ROWS);
  gemm_small_m_kernel<WK><<<grid, GEMM_WARPS * 32, smem, stream>>>(
      x, ldx, w, wscale, bias, ln_s, ln_b, resid, ldr, y, ldy, M, N, K, relu, eps);
  return cudaGetLastError();
}

// w_kind: 0 = bf16 w, 1 = int8 w with wscale [N] required (W8A16), 2 = f32
// w, 3 = int8 w with wscale [N] required and int8 activations (W8A8). w is
// [N, K]. wscale, bias, ln_s/ln_b, resid may be null. Requires M >= 1,
// K % 16 == 0, 16-byte aligned rows; the Python wrapper checks these.
extern "C" int vx_gemm_small_m(const float* x, int ldx, const void* w, int w_kind,
                               const float* wscale, const float* bias, const float* ln_s,
                               const float* ln_b, const float* resid, int ldr, float* y,
                               int ldy, int M, int N, int K, int relu, float eps,
                               void* stream) {
  if (M < 1 || (M + GEMM_ROWS - 1) / GEMM_ROWS > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (w_kind) {
    case W_BF16:
      return (int)launch<W_BF16>(x, ldx, w, wscale, bias, ln_s, ln_b, resid, ldr, y, ldy, M,
                                 N, K, relu, eps, s);
    case W_INT8:
      return (int)launch<W_INT8>(x, ldx, w, wscale, bias, ln_s, ln_b, resid, ldr, y, ldy, M,
                                 N, K, relu, eps, s);
    case W_F32:
      return (int)launch<W_F32>(x, ldx, w, wscale, bias, ln_s, ln_b, resid, ldr, y, ldy, M,
                                N, K, relu, eps, s);
    case W_W8A8:
      return (int)launch<W_W8A8>(x, ldx, w, wscale, bias, ln_s, ln_b, resid, ldr, y, ldy, M,
                                 N, K, relu, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
