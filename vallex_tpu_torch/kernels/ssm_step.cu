// The hybrid AR's decode-step kernels (models/granite_hybrid.py, one step
// of a Mamba-2 layer and the pieces around it), each a plain launch:
//
// * ssm_step_kernel: one Mamba-2 state update a (row, head), in place on an
//   f32 state S [M, H, P, N]:
//     dt = softplus(dt_raw + dt_bias[h]);  dA = exp(dt · -exp(A_log[h]))
//     S[p, :] = dA · S[p, :] + (dt · x[p]) · B        (B, C: [N], one group)
//     y[p] = (S[p, :] · C + D[h] · x[p]) · silu(z[p])
//   A block of 8 warps takes one (row, head); warp w owns the head's rows
//   p = w, w + 8, ..., lane l the state columns [4l, 4l + 4). Every warp
//   issues its 8 rows' float4 loads before any arithmetic, so 128 bytes a
//   lane are in flight; each element of S is read and written by one thread.
//   Built for P = 64, N = 128 (the published Mamba-2 head and state).
// * conv_step_kernel: the causal depthwise convolution of width 4 at one
//   step, a thread a (row, channel): out = silu(b + w0·s0 + w1·s1 + w2·s2 +
//   w3·x) over the channel's last three inputs s [3, C] (oldest first) and
//   this step's x, then s ← (s1, s2, x), in place.
// * rms_norm_rows_kernel: y = x · rsqrt(mean(x²) + eps) · g, a block a row.
// * swiglu_rows_kernel: y[:, j] = silu(x[:, j]) · x[:, F + j].
//
// f32 in and out; the weights come as f32 vectors. Launchers return
// cudaGetLastError() (common.cuh).
#include "common.cuh"

#define SSM_P 64
#define SSM_N 128
#define SSM_WARPS 8
#define SSM_ROWS (SSM_P / SSM_WARPS)  // state rows a warp

__device__ __forceinline__ float ssm_silu(float v) { return v / (1.f + expf(-v)); }

__global__ void __launch_bounds__(SSM_WARPS * 32)
ssm_step_kernel(const float* __restrict__ xbc, int ldxbc, const float* __restrict__ zd,
                int ldzd, int z_off, int dt_off, float* __restrict__ S,
                const float* __restrict__ dt_bias, const float* __restrict__ A_log,
                const float* __restrict__ Dp, float* __restrict__ y, int ldy, int H) {
  const int h = blockIdx.x, m = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xr = xbc + (size_t)m * ldxbc;
  const float* zr = zd + (size_t)m * ldzd;
  float* Sh = S + ((size_t)m * H + h) * (SSM_P * SSM_N);
  const float4 b = reinterpret_cast<const float4*>(xr + H * SSM_P)[lane];
  const float4 c = reinterpret_cast<const float4*>(xr + H * SSM_P + SSM_N)[lane];
  float4 s[SSM_ROWS];
  float x[SSM_ROWS];
#pragma unroll
  for (int i = 0; i < SSM_ROWS; ++i) {
    const int p = warp + i * SSM_WARPS;
    s[i] = reinterpret_cast<const float4*>(Sh + p * SSM_N)[lane];
    x[i] = xr[h * SSM_P + p];
  }
  float dt = zr[dt_off + h] + dt_bias[h];
  dt = dt > 20.f ? dt : log1pf(expf(dt));
  const float dA = expf(dt * -expf(A_log[h]));
  const float Dh = Dp[h];
#pragma unroll
  for (int i = 0; i < SSM_ROWS; ++i) {
    const float dx = dt * x[i];
    float4 v = s[i];
    v.x = fmaf(dA, v.x, dx * b.x);
    v.y = fmaf(dA, v.y, dx * b.y);
    v.z = fmaf(dA, v.z, dx * b.z);
    v.w = fmaf(dA, v.w, dx * b.w);
    s[i] = v;
    reinterpret_cast<float4*>(Sh + (warp + i * SSM_WARPS) * SSM_N)[lane] = v;
  }
#pragma unroll
  for (int i = 0; i < SSM_ROWS; ++i) {
    const int p = warp + i * SSM_WARPS;
    float acc = s[i].x * c.x + s[i].y * c.y + s[i].z * c.z + s[i].w * c.w;
    acc = vx_warp_sum(acc);
    if (lane == 0) {
      const float z = zr[z_off + h * SSM_P + p];
      y[(size_t)m * ldy + h * SSM_P + p] = fmaf(Dh, x[i], acc) * ssm_silu(z);
    }
  }
}

__global__ void __launch_bounds__(256)
conv_step_kernel(const float* __restrict__ zd, int ldzd, int x_off, float* __restrict__ state,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, int ldout, int C) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x, m = blockIdx.y;
  if (ch >= C) return;
  float* st = state + (size_t)m * 3 * C;
  const float x = zd[(size_t)m * ldzd + x_off + ch];
  const float s0 = st[ch], s1 = st[C + ch], s2 = st[2 * C + ch];
  const float4 wc = reinterpret_cast<const float4*>(w)[ch];
  float v = bias[ch];
  v = fmaf(wc.x, s0, v);
  v = fmaf(wc.y, s1, v);
  v = fmaf(wc.z, s2, v);
  v = fmaf(wc.w, x, v);
  out[(size_t)m * ldout + ch] = ssm_silu(v);
  st[ch] = s1;
  st[C + ch] = s2;
  st[2 * C + ch] = x;
}

__global__ void __launch_bounds__(256)
rms_norm_rows_kernel(const float* __restrict__ x, int ldx, const float* __restrict__ g,
                     float* __restrict__ y, int ldy, int K, float eps) {
  __shared__ float part[8];
  const int m = blockIdx.x;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)m * ldx);
  float ss = 0.f;
  for (int i = threadIdx.x; i < K / 4; i += blockDim.x) {
    const float4 v = xr[i];
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  ss = vx_warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) tot += part[i];
  const float r = rsqrtf(tot / (float)K + eps);
  float4* yr = reinterpret_cast<float4*>(y + (size_t)m * ldy);
  const float4* gr = reinterpret_cast<const float4*>(g);
  for (int i = threadIdx.x; i < K / 4; i += blockDim.x) {
    const float4 v = xr[i], gv = gr[i];
    yr[i] = make_float4(v.x * r * gv.x, v.y * r * gv.y, v.z * r * gv.z, v.w * r * gv.w);
  }
}

__global__ void __launch_bounds__(256)
swiglu_rows_kernel(const float* __restrict__ x, int ldx, float* __restrict__ y, int ldy, int F) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, m = blockIdx.y;
  if (j >= F) return;
  const float* xr = x + (size_t)m * ldx;
  y[(size_t)m * ldy + j] = ssm_silu(xr[j]) * xr[F + j];
}

static bool ssm_aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

extern "C" int vx_ssm_step(const float* xbc, int ldxbc, const float* zd, int ldzd, int z_off,
                           int dt_off, float* S, const float* dt_bias, const float* A_log,
                           const float* D, float* y, int ldy, int M, int H, int P, int N,
                           void* stream) {
  if (M < 1 || H < 1 || M > 65535 || P != SSM_P || N != SSM_N || !ssm_aligned(xbc) ||
      (ldxbc & 3) || (H * SSM_P) & 3 || !ssm_aligned(S))
    return (int)cudaErrorInvalidValue;
  ssm_step_kernel<<<dim3(H, M), SSM_WARPS * 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      xbc, ldxbc, zd, ldzd, z_off, dt_off, S, dt_bias, A_log, D, y, ldy, H);
  return (int)cudaGetLastError();
}

extern "C" int vx_conv_step(const float* zd, int ldzd, int x_off, float* state, const float* w,
                            const float* bias, float* out, int ldout, int M, int C,
                            void* stream) {
  if (M < 1 || M > 65535 || C < 1 || !ssm_aligned(w)) return (int)cudaErrorInvalidValue;
  conv_step_kernel<<<dim3((C + 255) / 256, M), 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      zd, ldzd, x_off, state, w, bias, out, ldout, C);
  return (int)cudaGetLastError();
}

extern "C" int vx_rms_norm_rows(const float* x, int ldx, const float* g, float* y, int ldy, int M,
                                int K, float eps, void* stream) {
  if (M < 1 || K < 4 || (K & 3) || (ldx & 3) || (ldy & 3) || !ssm_aligned(x) ||
      !ssm_aligned(y) || !ssm_aligned(g))
    return (int)cudaErrorInvalidValue;
  rms_norm_rows_kernel<<<M, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(x, ldx, g, y, ldy,
                                                                              K, eps);
  return (int)cudaGetLastError();
}

extern "C" int vx_swiglu_rows(const float* x, int ldx, float* y, int ldy, int M, int F,
                              void* stream) {
  if (M < 1 || M > 65535 || F < 1) return (int)cudaErrorInvalidValue;
  swiglu_rows_kernel<<<dim3((F + 255) / 256, M), 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, ldx, y, ldy, F);
  return (int)cudaGetLastError();
}
