// masked_attention: online-softmax attention of Tq queries per head over the
// keys of a [text | audio] cache, for head_dim 64, with per-row key bounds.
//
// Replaces the attention inside three TPU kernels:
//   vallex_tpu/ops/decode_block.py  decode_block_fused (_attention with
//       _hbm_fold_single, and _hbm_fold_batched for batched requests): one
//       query per step over the valid cache rows;
//   vallex_tpu/ops/decode_verify.py decode_verify: K = 8 queries, query k also
//       seeing this pass's columns j <= k;
//   vallex_tpu/models/layers.py attention_core_flash (the JAX library's Pallas
//       flash attention, forward, non-causal, key-padding segments): the NAR's
//       Tq = T queries at s_text + t_audio >= 1536, one row per request.
// Row b of the batch has its own bounds, read from `lens` ([3, B] int32 on
// the device: x_len, a1_len, a2_len), so no bound travels through the host.
// Key c is valid for row b and query qi iff
//   c < x_len[b]
//   or a1_lo <= c < a1_lo + a1_len[b]                 (range 1)
//   or a2_lo <= c < a2_lo + a2_len[b] + q_off * qi    (range 2).
// The single-request layout of engine/ar.py and engine/nar.py leaves range 1
// empty and puts the audio rows in range 2 (decode: a2_len = pos0 + 1,
// q_off = 1, with the new columns already written into the cache; NAR:
// a2_len = t_len, q_off = 0). The batched layout of ar_generate_batch puts
// each request's BOS + prompt rows in range 1 (a1_lo = s_text, a1_len =
// prompt_len + 1) and the generated rows, shared by position, in range 2
// (a2_lo = s_text + p_audio). Padding keys are skipped, not masked: the loop
// walks the valid keys only. Each range is clamped into the cache [0, C), so
// a wrong bound cannot read outside it.
//
// Bound on the H100: in decode, the K/V bytes of the valid rows (a memory
// stream); in the NAR, the 4*T*T*hd operations per head. This first version
// runs the dot products on the CUDA cores: one warp owns one query, lane j
// scores key j of a 32-key tile against the whole query held in registers,
// then the tile's probabilities are broadcast by shuffles into a per-lane
// 2-dim slice of the f32 accumulator. With at most 8 queries (decode) each
// block takes one query and its 8 warps split the keys, merging their
// (max, sum, acc) states through shared memory at the end; with more (the
// NAR) each of the 8 warps of a block owns one query. Softmax state is f32;
// K/V are bf16; Q and the output are f32 (decode) or bf16 (NAR).
#include "common.cuh"

#define ATT_WARPS 8
#define ATT_HD 64

template <typename T>
__device__ __forceinline__ float vx_to_f32(T v);
template <>
__device__ __forceinline__ float vx_to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float vx_to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void vx_store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void vx_store2<float>(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}
template <>
__device__ __forceinline__ void vx_store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Strides are in elements; the head dim has stride 1 for q, k, v and o.
template <typename TQ, typename TO>
__global__ void __launch_bounds__(ATT_WARPS * 32)
masked_attention_kernel(const TQ* __restrict__ q, long long q_sb, long long q_sh, long long q_st,
                        const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                        long long kv_sb, long long kv_sh, long long kv_st, TO* __restrict__ o,
                        long long o_sb, long long o_sh, long long o_st, int B, int Tq, int C,
                        const int* __restrict__ lens, int a1_lo, int a2_lo, int q_off,
                        float scale, int qb, int nsplit) {
  __shared__ float st_m[ATT_WARPS];
  __shared__ float st_l[ATT_WARPS];
  __shared__ float st_acc[ATT_WARPS][ATT_HD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi_local = warp % qb;
  const int split = warp / qb;
  const int qi = blockIdx.x * qb + qi_local;
  const bool active = split < nsplit && qi < Tq;

  float m = VX_NEG_BIG, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  if (active) {
    const TQ* qp = q + b * q_sb + h * q_sh + (long long)qi * q_st;
    float qf[ATT_HD];
#pragma unroll
    for (int d = 0; d < ATT_HD; ++d) qf[d] = vx_to_f32<TQ>(qp[d]) * scale;
    const __nv_bfloat16* kb = k + b * kv_sb + h * kv_sh;
    const __nv_bfloat16* vb = v + b * kv_sb + h * kv_sh;
    // virtual key index vk: [0, x_len) text rows, then range 1, then range 2
    const int x_len = min(max(lens[b], 0), C);
    const int a1_len = min(max(lens[B + b], 0), max(C - a1_lo, 0));
    const int a2_len = min(max(lens[2 * B + b] + q_off * qi, 0), max(C - a2_lo, 0));
    const int x_a1 = x_len + a1_len;
    const int nkeys = x_a1 + a2_len;
    for (int t0 = split * 32; t0 < nkeys; t0 += nsplit * 32) {
      const int vk = t0 + lane;
      const bool valid = vk < nkeys;
      const int c = !valid ? 0
                    : vk < x_len ? vk
                    : vk < x_a1 ? a1_lo + (vk - x_len)
                                : a2_lo + (vk - x_a1);
      float s = VX_NEG_BIG;
      if (valid) {
        const uint4* kr = reinterpret_cast<const uint4*>(kb + (long long)c * kv_st);
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < ATT_HD / 8; ++j) {
          float kf[8];
          vx_bf16x8_to_f32(__ldg(kr + j), kf);
#pragma unroll
          for (int i = 0; i < 8; ++i) dot = fmaf(qf[8 * j + i], kf[i], dot);
        }
        s = dot;
      }
      const float m_new = fmaxf(m, vx_warp_max(s));
      const float p = valid ? __expf(s - m_new) : 0.f;
      const float corr = __expf(m - m_new);
      l = l * corr + vx_warp_sum(p);
      acc0 *= corr;
      acc1 *= corr;
      m = m_new;
      const int nvalid = min(32, nkeys - t0);
      for (int j = 0; j < nvalid; ++j) {
        const float pj = __shfl_sync(VX_FULL_MASK, p, j);
        const int cj = __shfl_sync(VX_FULL_MASK, c, j);
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vb + (long long)cj * kv_st + 2 * lane));
        acc0 = fmaf(pj, vv.x, acc0);
        acc1 = fmaf(pj, vv.y, acc1);
      }
    }
  }
  if (nsplit == 1) {
    if (active) {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      TO* op = o + b * o_sb + h * o_sh + (long long)qi * o_st;
      vx_store2<TO>(op + 2 * lane, acc0 * inv, acc1 * inv);
    }
    return;
  }
  // merge the key splits of each query (warps qi_local + s * qb)
  if (lane == 0) {
    st_m[warp] = m;
    st_l[warp] = l;
  }
  st_acc[warp][2 * lane] = acc0;
  st_acc[warp][2 * lane + 1] = acc1;
  __syncthreads();
  if (split == 0 && qi < Tq) {
    float mm = VX_NEG_BIG;
    for (int s = 0; s < nsplit; ++s) mm = fmaxf(mm, st_m[qi_local + s * qb]);
    float ll = 0.f, a0 = 0.f, a1 = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const int w2 = qi_local + s * qb;
      const float f = __expf(st_m[w2] - mm);
      ll += st_l[w2] * f;
      a0 += st_acc[w2][2 * lane] * f;
      a1 += st_acc[w2][2 * lane + 1] * f;
    }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    TO* op = o + b * o_sb + h * o_sh + (long long)qi * o_st;
    vx_store2<TO>(op + 2 * lane, a0 * inv, a1 * inv);
  }
}

template <typename TQ, typename TO>
static cudaError_t launch(const void* q, const long long* qs, const void* k, const void* v,
                          const long long* kvs, void* o, const long long* os, int B, int H,
                          int Tq, int C, const int* lens, int a1_lo, int a2_lo, int q_off,
                          float scale, cudaStream_t stream) {
  // decode (Tq <= 8): one query per block, its keys split over the 8 warps
  const int qb = Tq <= ATT_WARPS ? 1 : ATT_WARPS;
  const int nsplit = ATT_WARPS / qb;
  const dim3 grid((Tq + qb - 1) / qb, H, B);
  masked_attention_kernel<TQ, TO><<<grid, ATT_WARPS * 32, 0, stream>>>(
      reinterpret_cast<const TQ*>(q), qs[0], qs[1], qs[2],
      reinterpret_cast<const __nv_bfloat16*>(k), reinterpret_cast<const __nv_bfloat16*>(v),
      kvs[0], kvs[1], kvs[2], reinterpret_cast<TO*>(o), os[0], os[1], os[2], B, Tq, C, lens,
      a1_lo, a2_lo, q_off, scale, qb, nsplit);
  return cudaGetLastError();
}

// q: [B, H, Tq, 64] (f32 if io_bf16 == 0, else bf16); k, v: [B, H, C, 64]
// bf16; o: [B, H, Tq, 64] of q's type. qs/kvs/os: the (b, h, t) strides in
// elements, three int64 each. lens: device pointer to [3, B] int32
// (x_len, a1_len, a2_len per row), contiguous.
extern "C" int vx_masked_attention(const void* q, const long long* qs, const void* k,
                                   const void* v, const long long* kvs, void* o,
                                   const long long* os, int io_bf16, int B, int H, int Tq,
                                   int C, const void* lens, int a1_lo, int a2_lo, int q_off,
                                   float scale, void* stream) {
  if (Tq < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* l = reinterpret_cast<const int*>(lens);
  if (io_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(q, qs, k, v, kvs, o, os, B, H, Tq, C, l,
                                                      a1_lo, a2_lo, q_off, scale, s);
  return (int)launch<float, float>(q, qs, k, v, kvs, o, os, B, H, Tq, C, l, a1_lo, a2_lo,
                                   q_off, scale, s);
}
