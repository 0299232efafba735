// sample_epilogue: one pass over [rows, VP] logits -> (token, its logprob).
//
// Replaces the sampling epilogue of vallex_tpu/ops/decode_block.py
// decode_block_fused (_ffn, last layer): lanes >= vocab masked, temperature
// scaling, optionally (filtered mode, `filtered=True` there) the top-k then
// top-p keep mask of vallex_tpu/ops/sampling.py::filtered_keep_mask,
// Gumbel-argmax over the kept scaled logits + g(u) (or argmax of the masked
// logits when greedy), token clipped to vocab - 1, and the chosen token's
// log-softmax over the kept scaled logits. The TPU kernel drew u from the
// core's own PRNG, which a GPU cannot reproduce; here the caller draws u with
// its torch.Generator, so the kernel and its plain version see the same noise.
//
// Filtered mode, the TPU kernel's arithmetic in the order it runs it:
//   keys = sortable int32 keys of the scaled logits (same total order);
//   top-k (top_k > 0): tau = the min key v with #(keys > v) <= k - 1, by
//     32-step integer bisection (overflow-safe floor midpoint); keep keys >=
//     tau, so ties at the k-th value are all kept;
//   top-p (top_p < 1): on the top-k-filtered logits (removed ones at -1e9),
//     p = softmax; tau = the min key v with mass(keys > v) <= top_p, by the
//     same bisection; keep keys >= tau: a token stays iff the mass strictly
//     above it is <= top_p, so the crossing token is kept;
//   removed logits go to -1e30 before the Gumbel draw and the log-softmax.
// The masses are f32 block sums, in another order than the plain version's:
// a token whose mass above lies within rounding of top_p can go either way.
//
// Bound on the H100: the logits and uniforms bytes (a few KB per row), i.e.
// launch latency; the 64 bisection steps of the filtered mode are block-wide
// reductions over the row held in shared memory. One block per row; each
// thread scans a strided slice.
#include <climits>

#include "common.cuh"

#define SAMPLE_THREADS 256
#define SAMPLE_WARPS (SAMPLE_THREADS / 32)
#define FILTER_NEG (-1e9f)  // vallex_tpu/ops/sampling.py NEG_INF

__device__ __forceinline__ void vx_argmax_merge(float& s, int& i, float s2, int i2) {
  if (s2 > s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

// f32 -> signed int32 key with the same total order
__device__ __forceinline__ int vx_sortable_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// block-wide sums; every thread gets the total (red: SAMPLE_WARPS slots)
__device__ __forceinline__ int vx_block_sum_int(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(VX_FULL_MASK, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < SAMPLE_WARPS; ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float vx_block_sum(float v, float* red) {
  v = vx_warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < SAMPLE_WARPS; ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float vx_block_max(float v, float* red) {
  v = vx_warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < SAMPLE_WARPS; ++w) t = fmaxf(t, red[w]);
  return t;
}

// One bisection step of _bisect_min_key: floor midpoint without overflow.
__device__ __forceinline__ int vx_mid(int lo, int hi) { return (lo >> 1) + (hi >> 1) + (lo & hi & 1); }

__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_epilogue_kernel(const float* __restrict__ logits, int ldl, const float* __restrict__ u,
                       int ldu, int VP, int vocab, float temperature, int greedy, int filtered,
                       int top_k, float top_p, int* __restrict__ tok_out,
                       float* __restrict__ logp_out, unsigned char* __restrict__ keep_out,
                       int ldk) {
  extern __shared__ float sc[];  // [VP] scaled (then kept) logits
  int* keys = reinterpret_cast<int*>(sc + VP);  // [VP] filtered mode
  __shared__ float red_s[SAMPLE_WARPS];
  __shared__ int red_i[SAMPLE_WARPS];
  __shared__ float red_m[SAMPLE_WARPS];
  __shared__ int tok_sh;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* lr = logits + (size_t)row * ldl;
  const float* ur = greedy ? nullptr : u + (size_t)row * ldu;
  const float t = fmaxf(temperature, 1e-6f);

  for (int i = tid; i < VP; i += SAMPLE_THREADS) sc[i] = (i < vocab ? lr[i] : VX_NEG_BIG) / t;
  __syncthreads();

  if (filtered) {
    // ---- top-k: tau = min key v with #(keys > v) <= k - 1 -----------------
    for (int i = tid; i < VP; i += SAMPLE_THREADS) keys[i] = vx_sortable_key(sc[i]);
    __syncthreads();
    if (top_k > 0) {
      const int k = min(max(top_k, 1), VP);
      int lo = INT_MIN, hi = INT_MAX;
      for (int it = 0; it < 32; ++it) {
        const int mid = vx_mid(lo, hi);
        int cnt = 0;
        for (int i = tid; i < VP; i += SAMPLE_THREADS) cnt += keys[i] > mid;
        const bool too_many = vx_block_sum_int(cnt, red_i) > k - 1;
        lo = too_many ? (int)((unsigned)mid + 1u) : lo;
        hi = too_many ? hi : mid;
      }
      for (int i = tid; i < VP; i += SAMPLE_THREADS)
        if (keys[i] < hi) sc[i] = VX_NEG_BIG;  // removed: marked, set below
      __syncthreads();
    }
    // ---- top-p on the top-k-filtered logits (removed ones at -1e9) --------
    if (top_p < 1.f) {
      float mx = __int_as_float(0xff800000);
      for (int i = tid; i < VP; i += SAMPLE_THREADS) {
        const float f = sc[i] == VX_NEG_BIG && top_k > 0 ? FILTER_NEG : sc[i];
        keys[i] = vx_sortable_key(f);
        mx = fmaxf(mx, f);
      }
      mx = vx_block_max(mx, red_m);
      float se = 0.f;
      for (int i = tid; i < VP; i += SAMPLE_THREADS)
        se += expf((sc[i] == VX_NEG_BIG && top_k > 0 ? FILTER_NEG : sc[i]) - mx);
      const float lse = mx + logf(vx_block_sum(se, red_m));
      int lo = INT_MIN, hi = INT_MAX;
      for (int it = 0; it < 32; ++it) {
        const int mid = vx_mid(lo, hi);
        float mass = 0.f;
        for (int i = tid; i < VP; i += SAMPLE_THREADS)
          if (keys[i] > mid)
            mass += expf((sc[i] == VX_NEG_BIG && top_k > 0 ? FILTER_NEG : sc[i]) - lse);
        const bool too_many = vx_block_sum(mass, red_m) > top_p;
        lo = too_many ? (int)((unsigned)mid + 1u) : lo;
        hi = too_many ? hi : mid;
      }
      for (int i = tid; i < VP; i += SAMPLE_THREADS)
        if (keys[i] < hi) sc[i] = VX_NEG_BIG;
      __syncthreads();
    }
  }
  if (keep_out != nullptr)
    for (int i = tid; i < VP; i += SAMPLE_THREADS)
      keep_out[(size_t)row * ldk + i] = sc[i] != VX_NEG_BIG || !filtered;

  const float neg_inf = __int_as_float(0xff800000);
  float best = neg_inf, smax = neg_inf;
  int bi = VP;
  for (int i = tid; i < VP; i += SAMPLE_THREADS) {
    const float scaled = sc[i];
    float score;
    if (greedy) score = i < vocab ? lr[i] : VX_NEG_BIG;
    else score = scaled - logf(-logf(ur[i] + 1e-10f) + 1e-10f);
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
  __syncthreads();
  if (lane == 0) {
    red_s[warp] = best;
    red_i[warp] = bi;
    red_m[warp] = smax;
  }
  __syncthreads();
  if (tid == 0) {
    float b = red_s[0];
    int ix = red_i[0];
    for (int w = 1; w < SAMPLE_WARPS; ++w) vx_argmax_merge(b, ix, red_s[w], red_i[w]);
    tok_sh = min(ix, vocab - 1);
  }
  float mx = red_m[0];
  for (int w = 1; w < SAMPLE_WARPS; ++w) mx = fmaxf(mx, red_m[w]);
  float se = 0.f;
  for (int i = tid; i < VP; i += SAMPLE_THREADS) se += expf(sc[i] - mx);
  const float tot = vx_block_sum(se, red_m);  // its syncs also publish tok_sh
  if (tid == 0) {
    const int tk = tok_sh;
    tok_out[row] = tk;
    logp_out[row] = sc[tk] - mx - logf(tot);
  }
}

// logits: [rows, VP] f32 (row stride ldl); u: [rows, VP] f32 uniforms in
// [0, 1) (row stride ldu), ignored when greedy; filtered != 0 applies top_k
// (<= 0: off) then top_p (>= 1: off); outputs tok [rows] int32 and logp
// [rows] f32, and, when keep_out is not null, the kept set [rows, VP] uint8
// (row stride ldk).
extern "C" int vx_sample_epilogue(const float* logits, int ldl, const float* u, int ldu,
                                  int rows, int VP, int vocab, float temperature, int greedy,
                                  int filtered, int top_k, float top_p, int* tok, float* logp,
                                  unsigned char* keep_out, int ldk, void* stream) {
  if (rows < 1 || vocab < 1 || vocab > VP) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)VP * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sample_epilogue_kernel<<<rows, SAMPLE_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      logits, ldl, u, ldu, VP, vocab, temperature, greedy, filtered, top_k, top_p, tok, logp,
      keep_out, ldk);
  return (int)cudaGetLastError();
}
