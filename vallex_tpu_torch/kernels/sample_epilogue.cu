// sample_epilogue: one pass over [rows, VP] logits -> (token, its logprob).
//
// Replaces the sampling epilogue of vallex_tpu/ops/decode_block.py
// decode_block_fused (_ffn, last layer): lanes >= vocab masked, temperature
// scaling, Gumbel-argmax over scaled + g(u) (or argmax of the masked logits
// when greedy), token clipped to vocab - 1, and the chosen token's
// log-softmax of the scaled logits. The TPU kernel drew u from the core's own
// PRNG, which a GPU cannot reproduce; here the caller draws u with its
// torch.Generator, so the kernel and its plain version see the same noise.
//
// Bound on the H100: the logits and uniforms bytes (a few KB per row), i.e.
// launch latency. One block per row; each thread scans a strided slice, then
// block reductions give the best (score, lowest index) and the log-sum-exp.
#include "common.cuh"

#define SAMPLE_THREADS 256

__device__ __forceinline__ void vx_argmax_merge(float& s, int& i, float s2, int i2) {
  if (s2 > s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_epilogue_kernel(const float* __restrict__ logits, int ldl, const float* __restrict__ u,
                       int ldu, int VP, int vocab, float temperature, int greedy,
                       int* __restrict__ tok_out, float* __restrict__ logp_out) {
  __shared__ float red_s[SAMPLE_THREADS / 32];
  __shared__ int red_i[SAMPLE_THREADS / 32];
  __shared__ float red_m[SAMPLE_THREADS / 32];
  __shared__ int tok_sh;
  __shared__ float max_sh;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* lr = logits + (size_t)row * ldl;
  const float* ur = greedy ? nullptr : u + (size_t)row * ldu;
  const float t = fmaxf(temperature, 1e-6f);

  const float neg_inf = __int_as_float(0xff800000);
  float best = neg_inf, smax = neg_inf;
  int bi = VP;
  for (int i = tid; i < VP; i += SAMPLE_THREADS) {
    const float masked = i < vocab ? lr[i] : VX_NEG_BIG;
    const float scaled = masked / t;
    float score = masked;
    if (!greedy) score = scaled - logf(-logf(ur[i] + 1e-10f) + 1e-10f);
    vx_argmax_merge(best, bi, score, i);
    smax = fmaxf(smax, scaled);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_xor_sync(VX_FULL_MASK, best, o);
    const int i2 = __shfl_xor_sync(VX_FULL_MASK, bi, o);
    vx_argmax_merge(best, bi, s2, i2);
    smax = fmaxf(smax, __shfl_xor_sync(VX_FULL_MASK, smax, o));
  }
  if (lane == 0) {
    red_s[warp] = best;
    red_i[warp] = bi;
    red_m[warp] = smax;
  }
  __syncthreads();
  if (tid == 0) {
    float b = red_s[0], mx = red_m[0];
    int ix = red_i[0];
    for (int w = 1; w < SAMPLE_THREADS / 32; ++w) {
      vx_argmax_merge(b, ix, red_s[w], red_i[w]);
      mx = fmaxf(mx, red_m[w]);
    }
    tok_sh = min(ix, vocab - 1);
    max_sh = mx;
  }
  __syncthreads();
  const float mx = max_sh;
  float se = 0.f;
  for (int i = tid; i < VP; i += SAMPLE_THREADS) {
    const float masked = i < vocab ? lr[i] : VX_NEG_BIG;
    se += expf(masked / t - mx);
  }
  se = vx_warp_sum(se);
  __syncthreads();
  if (lane == 0) red_m[warp] = se;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int w = 0; w < SAMPLE_THREADS / 32; ++w) tot += red_m[w];
    const int tk = tok_sh;
    tok_out[row] = tk;
    logp_out[row] = lr[tk] / t - mx - logf(tot);
  }
}

// logits: [rows, VP] f32 (row stride ldl); u: [rows, VP] f32 uniforms in
// [0, 1) (row stride ldu), ignored when greedy; outputs tok [rows] int32 and
// logp [rows] f32.
extern "C" int vx_sample_epilogue(const float* logits, int ldl, const float* u, int ldu,
                                  int rows, int VP, int vocab, float temperature, int greedy,
                                  int* tok, float* logp, void* stream) {
  if (rows < 1 || vocab < 1 || vocab > VP) return (int)cudaErrorInvalidValue;
  sample_epilogue_kernel<<<rows, SAMPLE_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      logits, ldl, u, ldu, VP, vocab, temperature, greedy, tok, logp);
  return cudaGetLastError();
}
