// masked_attention: online-softmax attention of Tq queries per head over the
// keys of a [text | audio] cache, for head_dim 64, with per-row key bounds.
//
// Replaces the attention inside three TPU kernels:
//   vallex_tpu/ops/decode_block.py  decode_block_fused (_attention with
//       _hbm_fold_single; _hbm_fold_batched for batched requests;
//       _hbm_fold_beams and _hbm_fold_batched_grouped for best_of samples,
//       the grouped mode below): one query per step over the valid cache rows;
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
// walks the valid keys only. Each range is clamped into the rows it reads,
// so a wrong bound cannot read outside them.
//
// Grouped mode (best_of samples, `prefix` non-null): the B = R * beams rows
// are request-major (row b is request b / beams's sample b % beams), the text
// and range-1 keys of row b come from the prefix [R, H, P, 64] row b / beams
// -- one copy per request, shared by its samples -- and the range-2
// (generated) keys from the row's own cache [B, H, C, 64], where a2_lo = 0.
// The walk over the keys (tiles of 32 virtual indices) does not depend on
// where the keys live, so the grouped mode gives results bitwise equal to
// the prefix copied into each row's cache in front of its generated rows; it
// reads the prefix bytes once per request instead of once per sample (the
// reason for the TPU's grouped layout).
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
// K/V are bf16, or f32 with compute_dtype="float32"; Q and the output are
// f32 (decode) or the K/V type (NAR).
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

// q . k for one key row of 64 values, 16-byte loads
__device__ __forceinline__ float vx_dot64(const float* qf, const __nv_bfloat16* kr) {
  const uint4* p = reinterpret_cast<const uint4*>(kr);
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < ATT_HD / 8; ++j) {
    float kf[8];
    vx_bf16x8_to_f32(__ldg(p + j), kf);
#pragma unroll
    for (int i = 0; i < 8; ++i) dot = fmaf(qf[8 * j + i], kf[i], dot);
  }
  return dot;
}
__device__ __forceinline__ float vx_dot64(const float* qf, const float* kr) {
  const float4* p = reinterpret_cast<const float4*>(kr);
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < ATT_HD / 4; ++j) {
    const float4 kv = __ldg(p + j);
    dot = fmaf(qf[4 * j], kv.x, dot);
    dot = fmaf(qf[4 * j + 1], kv.y, dot);
    dot = fmaf(qf[4 * j + 2], kv.z, dot);
    dot = fmaf(qf[4 * j + 3], kv.w, dot);
  }
  return dot;
}

__device__ __forceinline__ float2 vx_load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 vx_load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Strides are in elements; the head dim has stride 1 for q, k, v, the prefix
// and o. pk/pv null: no prefix (every key from k/v).
template <typename TQ, typename TKV, typename TO>
__global__ void __launch_bounds__(ATT_WARPS * 32)
masked_attention_kernel(const TQ* __restrict__ q, long long q_sb, long long q_sh, long long q_st,
                        const TKV* __restrict__ k, const TKV* __restrict__ v,
                        long long kv_sb, long long kv_sh, long long kv_st,
                        const TKV* __restrict__ pk, const TKV* __restrict__ pv,
                        long long p_sb, long long p_sh, long long p_st, int P, int beams,
                        TO* __restrict__ o, long long o_sb, long long o_sh, long long o_st,
                        int B, int Tq, int C, const int* __restrict__ lens, int a1_lo,
                        int a2_lo, int q_off, float scale, int qb, int nsplit) {
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
    const TKV* kb = k + b * kv_sb + h * kv_sh;
    const TKV* vb = v + b * kv_sb + h * kv_sh;
    // the text and range-1 keys: the prefix row of this row's request, or
    // the row's own cache
    const bool grouped = pk != nullptr;
    const long long pr = (long long)(b / beams) * p_sb + h * p_sh;
    const int C1 = grouped ? P : C;
    // virtual key index vk: [0, x_len) text rows, then range 1, then range 2
    const int x_len = min(max(lens[b], 0), C1);
    const int a1_len = min(max(lens[B + b], 0), max(C1 - a1_lo, 0));
    const int a2_len = min(max(lens[2 * B + b] + q_off * qi, 0), max(C - a2_lo, 0));
    const int x_a1 = x_len + a1_len;
    const TKV* kp = grouped ? pk + pr : kb;
    const TKV* vp = grouped ? pv + pr : vb;
    const long long p_row = grouped ? p_st : kv_st;
    const int nkeys = x_a1 + a2_len;
    for (int t0 = split * 32; t0 < nkeys; t0 += nsplit * 32) {
      const int vk = t0 + lane;
      const bool valid = vk < nkeys;
      // row c of the prefix side (text, range 1) or of the row's own cache
      const int c = !valid ? 0
                    : vk < x_len ? vk
                    : vk < x_a1 ? a1_lo + (vk - x_len)
                                : a2_lo + (vk - x_a1);
      const TKV* krow = vk < x_a1 ? kp + (long long)c * p_row : kb + (long long)c * kv_st;
      const float s = valid ? vx_dot64(qf, krow) : VX_NEG_BIG;
      const float m_new = fmaxf(m, vx_warp_max(s));
      const float p = valid ? __expf(s - m_new) : 0.f;
      const float corr = __expf(m - m_new);
      l = l * corr + vx_warp_sum(p);
      acc0 *= corr;
      acc1 *= corr;
      m = m_new;
      const int nvalid = min(32, nkeys - t0);
      if (t0 + 32 <= x_a1 || t0 >= x_a1) {
        // the whole tile on one side (warp-uniform): one base, one stride
        const bool side_p = t0 < x_a1;
        const TKV* vl = (side_p ? vp : vb) + 2 * lane;
        const long long st = side_p ? p_row : kv_st;
        for (int j = 0; j < nvalid; ++j) {
          const float pj = __shfl_sync(VX_FULL_MASK, p, j);
          const int cj = __shfl_sync(VX_FULL_MASK, c, j);
          const float2 vv = vx_load2(vl + (long long)cj * st);
          acc0 = fmaf(pj, vv.x, acc0);
          acc1 = fmaf(pj, vv.y, acc1);
        }
      } else {
        // the one tile that crosses from the prefix side to the cache
        for (int j = 0; j < nvalid; ++j) {
          const float pj = __shfl_sync(VX_FULL_MASK, p, j);
          const int cj = __shfl_sync(VX_FULL_MASK, c, j);
          const float2 vv = vx_load2((t0 + j < x_a1 ? vp + (long long)cj * p_row
                                                    : vb + (long long)cj * kv_st) + 2 * lane);
          acc0 = fmaf(pj, vv.x, acc0);
          acc1 = fmaf(pj, vv.y, acc1);
        }
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

template <typename TQ, typename TKV, typename TO>
static cudaError_t launch(const void* q, const long long* qs, const void* k, const void* v,
                          const long long* kvs, const void* pk, const void* pv,
                          const long long* ps, int P, int beams, void* o, const long long* os,
                          int B, int H, int Tq, int C, const int* lens, int a1_lo, int a2_lo,
                          int q_off, float scale, cudaStream_t stream) {
  // decode (Tq <= 8): one query per block, its keys split over the 8 warps
  const int qb = Tq <= ATT_WARPS ? 1 : ATT_WARPS;
  const int nsplit = ATT_WARPS / qb;
  const dim3 grid((Tq + qb - 1) / qb, H, B);
  masked_attention_kernel<TQ, TKV, TO><<<grid, ATT_WARPS * 32, 0, stream>>>(
      reinterpret_cast<const TQ*>(q), qs[0], qs[1], qs[2], reinterpret_cast<const TKV*>(k),
      reinterpret_cast<const TKV*>(v), kvs[0], kvs[1], kvs[2],
      reinterpret_cast<const TKV*>(pk), reinterpret_cast<const TKV*>(pv),
      pk != nullptr ? ps[0] : 0, pk != nullptr ? ps[1] : 0, pk != nullptr ? ps[2] : 0, P,
      beams, reinterpret_cast<TO*>(o), os[0], os[1], os[2], B, Tq, C, lens, a1_lo, a2_lo,
      q_off, scale, qb, nsplit);
  return cudaGetLastError();
}

// q: [B, H, Tq, 64]; k, v: [B, H, C, 64]; o: [B, H, Tq, 64] of q's type.
// kinds: 0 = f32 q/o with bf16 k/v (decode), 1 = bf16 q/o/k/v (NAR),
// 2 = f32 q/o/k/v (compute_dtype="float32"). qs/kvs/os: the (b, h, t)
// strides in elements, three int64 each. lens: device pointer to [3, B]
// int32 (x_len, a1_len, a2_len per row), contiguous. pk/pv: null, or the
// grouped mode's prefix [B / beams, H, P, 64] of the k/v type with strides ps.
extern "C" int vx_masked_attention(const void* q, const long long* qs, const void* k,
                                   const void* v, const long long* kvs, const void* pk,
                                   const void* pv, const long long* ps, int P, int beams,
                                   void* o, const long long* os, int kinds, int B, int H,
                                   int Tq, int C, const void* lens, int a1_lo, int a2_lo,
                                   int q_off, float scale, void* stream) {
  if (Tq < 1 || B < 1 || B > 65535 || beams < 1 || B % beams) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* l = reinterpret_cast<const int*>(lens);
  switch (kinds) {
    case 0:
      return (int)launch<float, __nv_bfloat16, float>(q, qs, k, v, kvs, pk, pv, ps, P, beams,
                                                      o, os, B, H, Tq, C, l, a1_lo, a2_lo,
                                                      q_off, scale, s);
    case 1:
      return (int)launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
          q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H, Tq, C, l, a1_lo, a2_lo, q_off,
          scale, s);
    case 2:
      return (int)launch<float, float, float>(q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B,
                                              H, Tq, C, l, a1_lo, a2_lo, q_off, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
