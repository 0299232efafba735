// gemm_small_m: Y[M, N] = epilogue(prologue(X)[M, K] . W[N, K]^T), M <= 8.
//
// Replaces the matrix products inside two TPU kernels:
//   vallex_tpu/ops/decode_block.py  decode_block_fused (_kernel: `mat`, `_ffn`,
//                                   the fused head) -- the K-1 int8 draft steps,
//                                   the int8 serving blocks, and batched
//                                   requests at M = R <= 8;
//   vallex_tpu/ops/decode_verify.py decode_verify (_kernel) -- the bf16 verify
//                                   pass over K = 8 positions.
// Each product there is LN -> matvec (QKV), matvec + residual (out-proj),
// LN -> matvec + bias -> ReLU (FFN1), matvec + bias + residual (FFN2) or
// LN -> matvec (head) on M <= 8 rows of f32 hidden state.
//
// Bound on the H100: weight bytes. At M <= 8 every weight byte is used for at
// most 8 multiply-adds, far below the ~295 operations per byte where the
// tensor cores would become the limit, so the kernel is a weight stream.
// Design: weights are stored [N, K] (K contiguous) so one warp computes one
// output column with 16-byte coalesced loads along K (8 bf16 or 16 int8 per
// lane per load), and N/8 blocks of 8 warps keep every SM streaming. The
// prologue (LayerNorm or a plain cast) rounds the M activation rows to bf16
// once per block into shared memory, as the TPU kernel casts the activations
// to bf16 before its MXU product; accumulation is f32; int8 weights carry f32
// per-output-channel scales applied after the sum (W8A16).
//
// Batched requests (M = R rows, one per request): each row's result does not
// depend on M or on the other rows. Row m's LayerNorm runs in warp m alone,
// and its sum runs over k in the same per-lane order and the same warp
// reduction for any M, so it is bitwise the row's M = 1 product
// (chip_smoke.py phase 3b checks this at M = 4 and 8).
#include "common.cuh"

#define GEMM_MAX_M 8
#define GEMM_WARPS 8

template <bool INT8>
__global__ void __launch_bounds__(GEMM_WARPS * 32)
gemm_small_m_kernel(const float* __restrict__ x, int ldx, const void* __restrict__ w,
                    const float* __restrict__ wscale, const float* __restrict__ bias,
                    const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                    const float* __restrict__ resid, int ldr, float* __restrict__ y,
                    int ldy, int M, int N, int K, int relu, float eps) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];  // [M][K] bf16 activations
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // ---- prologue: warp m prepares activation row m -------------------------
  for (int m = warp; m < M; m += GEMM_WARPS) {
    const float* xr = x + (size_t)m * ldx;
    __nv_bfloat16* xo = xs + (size_t)m * K;
    if (ln_s != nullptr) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += xr[k];
      const float mean = vx_warp_sum(s) / (float)K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = xr[k] - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(vx_warp_sum(v) / (float)K + eps);
      for (int k = lane; k < K; k += 32)
        xo[k] = __float2bfloat16((xr[k] - mean) * rstd * ln_s[k] + ln_b[k]);
    } else {
      for (int k = lane; k < K; k += 32) xo[k] = __float2bfloat16(xr[k]);
    }
  }
  __syncthreads();

  const int n = blockIdx.x * GEMM_WARPS + warp;
  if (n >= N) return;

  float acc[GEMM_MAX_M];
#pragma unroll
  for (int m = 0; m < GEMM_MAX_M; ++m) acc[m] = 0.f;

  if (!INT8) {
    const __nv_bfloat16* wr = reinterpret_cast<const __nv_bfloat16*>(w) + (size_t)n * K;
#pragma unroll 4
    for (int k0 = lane * 8; k0 < K; k0 += 32 * 8) {
      float wf[8];
      vx_bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(wr + k0)), wf);
#pragma unroll
      for (int m = 0; m < GEMM_MAX_M; ++m) {
        if (m < M) {
          float xf[8];
          vx_bf16x8_to_f32(*reinterpret_cast<const uint4*>(xs + (size_t)m * K + k0), xf);
          float a = acc[m];
#pragma unroll
          for (int i = 0; i < 8; ++i) a = fmaf(xf[i], wf[i], a);
          acc[m] = a;
        }
      }
    }
  } else {
    const int8_t* wr = reinterpret_cast<const int8_t*>(w) + (size_t)n * K;
#pragma unroll 2
    for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(wr + k0));
      const int8_t* wb = reinterpret_cast<const int8_t*>(&raw);
      float wf[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) wf[i] = (float)wb[i];
#pragma unroll
      for (int m = 0; m < GEMM_MAX_M; ++m) {
        if (m < M) {
          float xf[16];
          const uint4* xp = reinterpret_cast<const uint4*>(xs + (size_t)m * K + k0);
          vx_bf16x8_to_f32(xp[0], xf);
          vx_bf16x8_to_f32(xp[1], xf + 8);
          float a = acc[m];
#pragma unroll
          for (int i = 0; i < 16; ++i) a = fmaf(xf[i], wf[i], a);
          acc[m] = a;
        }
      }
    }
  }

  // ---- epilogue: scale, bias, ReLU, residual ------------------------------
#pragma unroll
  for (int m = 0; m < GEMM_MAX_M; ++m) acc[m] = vx_warp_sum(acc[m]);
  if (lane == 0) {
    const float sc = wscale != nullptr ? wscale[n] : 1.f;
    const float b = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
    for (int m = 0; m < GEMM_MAX_M; ++m) {
      if (m < M) {
        float v = acc[m] * sc + b;
        if (relu) v = fmaxf(v, 0.f);
        if (resid != nullptr) v += resid[(size_t)m * ldr + n];
        y[(size_t)m * ldy + n] = v;
      }
    }
  }
}

template <bool INT8>
static cudaError_t launch(const float* x, int ldx, const void* w, const float* wscale,
                          const float* bias, const float* ln_s, const float* ln_b,
                          const float* resid, int ldr, float* y, int ldy, int M, int N,
                          int K, int relu, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)M * K * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_small_m_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + GEMM_WARPS - 1) / GEMM_WARPS);
  gemm_small_m_kernel<INT8><<<grid, GEMM_WARPS * 32, smem, stream>>>(
      x, ldx, w, wscale, bias, ln_s, ln_b, resid, ldr, y, ldy, M, N, K, relu, eps);
  return cudaGetLastError();
}

// w_int8 != 0: w is int8 [N, K] and wscale [N] is required; else w is bf16.
// wscale, bias, ln_s/ln_b, resid may be null. Requires M <= 8, K % 16 == 0,
// 16-byte aligned rows; the Python wrapper checks these.
extern "C" int vx_gemm_small_m(const float* x, int ldx, const void* w, int w_int8,
                               const float* wscale, const float* bias, const float* ln_s,
                               const float* ln_b, const float* resid, int ldr, float* y,
                               int ldy, int M, int N, int K, int relu, float eps,
                               void* stream) {
  if (M < 1 || M > GEMM_MAX_M) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(w_int8 ? launch<true>(x, ldx, w, wscale, bias, ln_s, ln_b, resid, ldr, y,
                                     ldy, M, N, K, relu, eps, s)
                      : launch<false>(x, ldx, w, wscale, bias, ln_s, ln_b, resid, ldr, y,
                                      ldy, M, N, K, relu, eps, s));
}
