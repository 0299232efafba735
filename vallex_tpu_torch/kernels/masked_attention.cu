// masked_attention: online-softmax attention of Tq queries per head over the
// keys of a [text | audio] cache, for head_dim 64 or 128, with per-row key
// bounds.
//
// Replaces the decode attention inside the TPU kernels (the NAR's
// full-sequence attention is flash_attention.cu's):
//   vallex_tpu/ops/decode_block.py  decode_block_fused (_attention with
//       _hbm_fold_single; _hbm_fold_batched for batched requests;
//       _hbm_fold_beams and _hbm_fold_batched_grouped for best_of samples,
//       the grouped mode below): one query per step over the valid cache rows;
//   vallex_tpu/ops/decode_verify.py decode_verify: K = decode_steps queries
//       (any K), query k also seeing this pass's columns j <= k;
//   and the single steps of the own-column mode below.
// Row b of the batch has its own bounds, read from `lens` ([3, B] int32 on
// the device: x_len, a1_len, a2_len), so no bound travels through the host.
// Each query has a block of its own (grid.x = Tq, up to 65535), so any number
// of queries runs, each with its own causal bound q_off * qi, in every mode
// that takes more than one query (plain, per-row bounds, grouped).
// Key c is valid for row b and query qi iff
//   c < x_len[b]
//   or a1_lo <= c < a1_lo + a1_len[b]                 (range 1)
//   or a2_lo <= c < a2_lo + a2_len[b] + q_off * qi    (range 2).
// The single-request layout of engine/ar.py leaves range 1 empty and puts
// the audio rows in range 2 (a2_len = pos0 + 1, q_off = 1, with the new
// columns already written into the cache). The batched layout of ar_generate_batch puts
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
// int8 K/V (kinds 3): the int8 KV cache of decode_block_fused(kv_scales=...)
// (vallex_tpu/ops/decode_block.py:249-266, :528-544). K/V hold
// clip(round(x / scale)) with one static f32 scale per (layer, head) for
// each of K and V (`ks`, `vs`: [H] for this layer). The k-scale folds into
// the query (q * ks), the v-scale into the output (out * vs), so the walk
// runs on the int8 values as they are, in "cache units". The grouped
// prefix is int8 too, with the same scales.
//
// Own-column mode (`nk` non-null, Tq = 1): the decode steps of
// decode_step / decode_step_fused (vallex_tpu/ops/decode_step.py:553),
// decode_attention (vallex_tpu/ops/decode_attention.py:207) and the int8kv
// blocks. The kernel takes this step's new k/v in f32 ([B, H, 1, 64],
// strides `ns`), walks the cache only up to the `slot` row (range 2 is cut
// there), then folds the new column in unrounded, as the TPU kernels do
// (int8 K/V: divided by the scale into cache units, unrounded). Warps 0-1 of
// the block of (row, head) write the column into the cache row `slot`:
// rounded to the cache type, or for int8 K/V quantized as clip(rint(x / s),
// -127, 127). No block reads that row, so the write needs no ordering.
//
// Bound on the H100: the K/V bytes of the valid rows (a memory stream). The
// dot products run on the CUDA cores: a warp scores one query, lane j key j
// of a 32-key tile against the whole query held in registers, then the
// tile's probabilities are broadcast by shuffles into a per-lane slice of
// HD / 32 dims (2 at head dim 64, 4 at 128) of the f32 accumulator. Each block takes one query and its 8 warps split
// the keys, merging their (max, sum, acc) states through shared memory at
// the end. Softmax state is f32; K/V are bf16, int8, or f32 with
// compute_dtype="float32"; Q and the output are f32.
#include "common.cuh"

#define ATT_WARPS 8

// one value of this step's column in the cache's type (int8: quantized
// with the head's scale `s`)
__device__ __forceinline__ void vx_store_col(float* p, float v, float) { *p = v; }
__device__ __forceinline__ void vx_store_col(__nv_bfloat16* p, float v, float) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void vx_store_col(int8_t* p, float v, float s) {
  *p = (int8_t)__float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

// q . k for one key row of HD values, 16-byte loads
template <int HD>
__device__ __forceinline__ float vx_dot(const float* qf, const __nv_bfloat16* kr) {
  const uint4* p = reinterpret_cast<const uint4*>(kr);
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    float kf[8];
    vx_bf16x8_to_f32(__ldg(p + j), kf);
#pragma unroll
    for (int i = 0; i < 8; ++i) dot = fmaf(qf[8 * j + i], kf[i], dot);
  }
  return dot;
}
template <int HD>
__device__ __forceinline__ float vx_dot(const float* qf, const float* kr) {
  const float4* p = reinterpret_cast<const float4*>(kr);
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) {
    const float4 kv = __ldg(p + j);
    dot = fmaf(qf[4 * j], kv.x, dot);
    dot = fmaf(qf[4 * j + 1], kv.y, dot);
    dot = fmaf(qf[4 * j + 2], kv.z, dot);
    dot = fmaf(qf[4 * j + 3], kv.w, dot);
  }
  return dot;
}

template <int HD>
__device__ __forceinline__ float vx_dot(const float* qf, const int8_t* kr) {
  const int4* p = reinterpret_cast<const int4*>(kr);
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    const int4 raw = __ldg(p + j);
    const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) dot = fmaf(qf[16 * j + i], (float)kb[i], dot);
  }
  return dot;
}

// a lane's N = HD / 32 consecutive v values (2 or 4) as floats
template <int N>
__device__ __forceinline__ void vx_load_dims(const int8_t* p, float* out) {
  if constexpr (N == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = (float)c.x;
    out[1] = (float)c.y;
  } else {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = (float)c.x;
    out[1] = (float)c.y;
    out[2] = (float)c.z;
    out[3] = (float)c.w;
  }
}
template <int N>
__device__ __forceinline__ void vx_load_dims(const __nv_bfloat16* p, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void vx_load_dims(const float* p, float* out) {
  if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x;
    out[1] = f.y;
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
}

// Strides are in elements; the head dim has stride 1 for q, k, v, the prefix,
// the new column and o. pk/pv null: no prefix (every key from k/v). ks/vs
// null: no K/V scales. nk/nv null: no own column (kw/vw, n_sb/n_sh and slot
// unused).
template <typename TKV, int HD>
__global__ void __launch_bounds__(ATT_WARPS * 32)
masked_attention_kernel(const float* __restrict__ q, long long q_sb, long long q_sh, long long q_st,
                        const TKV* __restrict__ k, const TKV* __restrict__ v,
                        long long kv_sb, long long kv_sh, long long kv_st,
                        const TKV* __restrict__ pk, const TKV* __restrict__ pv,
                        long long p_sb, long long p_sh, long long p_st, int P, int beams,
                        float* __restrict__ o, long long o_sb, long long o_sh, long long o_st,
                        int B, int Tq, int C, const int* __restrict__ lens, int a1_lo,
                        int a2_lo, int q_off, float scale,
                        const float* __restrict__ ks, const float* __restrict__ vs,
                        const float* __restrict__ nk, const float* __restrict__ nv,
                        long long n_sb, long long n_sh, int slot, TKV* kw, TKV* vw) {
  __shared__ float st_m[ATT_WARPS];
  __shared__ float st_l[ATT_WARPS];
  __shared__ float st_acc[ATT_WARPS][HD];
  constexpr int DPL = HD / 32;  // accumulator dims per lane

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi = blockIdx.x;  // one query per block, its keys split over the warps
  const int split = warp;
  const int nsplit = ATT_WARPS;

  const bool own = nk != nullptr;
  const long long n_off = b * n_sb + h * n_sh;
  if (own && threadIdx.x < 2 * HD) {
    // this step's column into the cache row `slot` (k by the first HD
    // threads, v by the next HD)
    const int d = threadIdx.x & (HD - 1);
    const long long c_off = b * kv_sb + h * kv_sh + (long long)slot * kv_st + d;
    if (threadIdx.x < HD)
      vx_store_col(kw + c_off, nk[n_off + d], ks != nullptr ? ks[h] : 1.f);
    else
      vx_store_col(vw + c_off, nv[n_off + d], vs != nullptr ? vs[h] : 1.f);
  }

  float m = VX_NEG_BIG, l = 0.f, acc[DPL];
  float s_own = VX_NEG_BIG, ov[DPL];  // own column: score, v
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = ov[i] = 0.f;
  {
    const float* qp = q + b * q_sb + h * q_sh + (long long)qi * q_st;
    // int8 K/V: the k-scale folds into the query (q * ks), so the scores
    // come out of the int8 rows as they are
    const float qscale = ks != nullptr ? ks[h] : 1.f;
    float qf[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) qf[d] = qp[d] * qscale * scale;
    if (own && split == 0) {
      // the new key in cache units (int8 K/V: k / ks, unrounded); every lane
      // takes the whole dot, lane j keeps v dims DPL j .. DPL j + DPL - 1
      const float* kn = nk + n_off;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d)
        dot = fmaf(qf[d], ks != nullptr ? __fdiv_rn(kn[d], ks[h]) : kn[d], dot);
      s_own = dot;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        ov[i] = nv[n_off + DPL * lane + i];
        if (vs != nullptr) ov[i] = __fdiv_rn(ov[i], vs[h]);
      }
    }
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
    // own column: the walk stops before the slot, whatever the bounds say
    const int a2_end = own ? min(C, slot) : C;
    const int a2_len = min(max(lens[2 * B + b] + q_off * qi, 0), max(a2_end - a2_lo, 0));
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
      const float s = valid ? vx_dot<HD>(qf, krow) : VX_NEG_BIG;
      const float m_new = fmaxf(m, vx_warp_max(s));
      const float p = valid ? __expf(s - m_new) : 0.f;
      const float corr = __expf(m - m_new);
      l = l * corr + vx_warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= corr;
      m = m_new;
      const int nvalid = min(32, nkeys - t0);
      if (t0 + 32 <= x_a1 || t0 >= x_a1) {
        // the whole tile on one side (warp-uniform): one base, one stride
        const bool side_p = t0 < x_a1;
        const TKV* vl = (side_p ? vp : vb) + DPL * lane;
        const long long st = side_p ? p_row : kv_st;
        for (int j = 0; j < nvalid; ++j) {
          const float pj = __shfl_sync(VX_FULL_MASK, p, j);
          const int cj = __shfl_sync(VX_FULL_MASK, c, j);
          float vv[DPL];
          vx_load_dims<DPL>(vl + (long long)cj * st, vv);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, vv[i], acc[i]);
        }
      } else {
        // the one tile that crosses from the prefix side to the cache
        for (int j = 0; j < nvalid; ++j) {
          const float pj = __shfl_sync(VX_FULL_MASK, p, j);
          const int cj = __shfl_sync(VX_FULL_MASK, c, j);
          float vv[DPL];
          vx_load_dims<DPL>((t0 + j < x_a1 ? vp + (long long)cj * p_row
                                           : vb + (long long)cj * kv_st) + DPL * lane, vv);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, vv[i], acc[i]);
        }
      }
    }
  }
  // int8 K/V: the v-scale folds into the output
  const float oscale = vs != nullptr ? vs[h] : 1.f;
  // merge the key splits of the query (one per warp)
  if (lane == 0) {
    st_m[warp] = m;
    st_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) st_acc[warp][DPL * lane + i] = acc[i];
  __syncthreads();
  if (split == 0) {
    float mm = VX_NEG_BIG;
    for (int s = 0; s < nsplit; ++s) mm = fmaxf(mm, st_m[s]);
    if (own) mm = fmaxf(mm, s_own);
    float ll = 0.f, a[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) a[i] = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float f = __expf(st_m[s] - mm);
      ll += st_l[s] * f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) a[i] += st_acc[s][DPL * lane + i] * f;
    }
    if (own) {  // the new column, after the cache rows
      const float p = __expf(s_own - mm);
      ll += p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) a[i] = fmaf(p, ov[i], a[i]);
    }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    float* op = o + b * o_sb + h * o_sh + (long long)qi * o_st;
#pragma unroll
    for (int i = 0; i < DPL; ++i) op[DPL * lane + i] = a[i] * inv * oscale;
  }
}

template <typename TKV, int HD>
static cudaError_t launch(const void* q, const long long* qs, const void* k, const void* v,
                          const long long* kvs, const void* pk, const void* pv,
                          const long long* ps, int P, int beams, void* o, const long long* os,
                          int B, int H, int Tq, int C, const int* lens, int a1_lo, int a2_lo,
                          int q_off, float scale, const float* ks, const float* vs,
                          const float* nk, const float* nv, const long long* ns, int slot,
                          cudaStream_t stream) {
  // one query per block, its keys split over the 8 warps
  const dim3 grid(Tq, H, B);
  masked_attention_kernel<TKV, HD><<<grid, ATT_WARPS * 32, 0, stream>>>(
      reinterpret_cast<const float*>(q), qs[0], qs[1], qs[2], reinterpret_cast<const TKV*>(k),
      reinterpret_cast<const TKV*>(v), kvs[0], kvs[1], kvs[2],
      reinterpret_cast<const TKV*>(pk), reinterpret_cast<const TKV*>(pv),
      pk != nullptr ? ps[0] : 0, pk != nullptr ? ps[1] : 0, pk != nullptr ? ps[2] : 0, P,
      beams, reinterpret_cast<float*>(o), os[0], os[1], os[2], B, Tq, C, lens, a1_lo, a2_lo,
      q_off, scale, ks, vs, nk, nv, nk != nullptr ? ns[0] : 0,
      nk != nullptr ? ns[1] : 0, slot, reinterpret_cast<TKV*>(const_cast<void*>(k)),
      reinterpret_cast<TKV*>(const_cast<void*>(v)));
  return cudaGetLastError();
}

// q: [B, H, Tq, hd] with 1 <= Tq <= 65535 and hd 64 or 128; k, v: [B, H, C,
// hd]; o: [B, H, Tq, hd] f32. kinds: 0 = f32 q/o with bf16 k/v, 2 = f32
// q/o/k/v (compute_dtype="float32"), 3 = f32 q/o with int8 k/v and the
// scales ks/vs [H] (int8 KV cache). qs/kvs/os: the (b, h, t) strides in
// elements, three int64 each. lens: device pointer to [3, B] int32 (x_len,
// a1_len, a2_len per row), contiguous. pk/pv: null, or the grouped mode's
// prefix [B / beams, H, P, hd] of the k/v type with strides ps. nk/nv:
// null, or the own-column mode's new k/v [B, H, 1, hd] f32 with (b, h, t)
// strides ns, written into row `slot` of k/v (Tq must be 1).
template <typename TKV>
static cudaError_t launch_hd(int hd, const void* q, const long long* qs, const void* k,
                             const void* v, const long long* kvs, const void* pk, const void* pv,
                             const long long* ps, int P, int beams, void* o, const long long* os,
                             int B, int H, int Tq, int C, const int* lens, int a1_lo, int a2_lo,
                             int q_off, float scale, const float* ks, const float* vs,
                             const float* nk, const float* nv, const long long* ns, int slot,
                             cudaStream_t stream) {
  if (hd == 64)
    return launch<TKV, 64>(q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H, Tq, C, lens,
                           a1_lo, a2_lo, q_off, scale, ks, vs, nk, nv, ns, slot, stream);
  if (hd == 128)
    return launch<TKV, 128>(q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H, Tq, C, lens,
                            a1_lo, a2_lo, q_off, scale, ks, vs, nk, nv, ns, slot, stream);
  return cudaErrorInvalidValue;
}

extern "C" int vx_masked_attention(const void* q, const long long* qs, const void* k,
                                   const void* v, const long long* kvs, const void* pk,
                                   const void* pv, const long long* ps, int P, int beams,
                                   void* o, const long long* os, int kinds, int B, int H,
                                   int Tq, int C, int hd, const void* lens, int a1_lo,
                                   int a2_lo, int q_off, float scale, const void* ks,
                                   const void* vs, const void* nk, const void* nv,
                                   const long long* ns, int slot, void* stream) {
  if (Tq < 1 || Tq > 65535 || B < 1 || B > 65535 || H < 1 || H > 65535 || beams < 1 ||
      B % beams)
    return (int)cudaErrorInvalidValue;
  if ((kinds == 3) != (ks != nullptr && vs != nullptr)) return (int)cudaErrorInvalidValue;
  if (nk != nullptr && (Tq != 1 || nv == nullptr || slot < 0 || slot >= C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* l = reinterpret_cast<const int*>(lens);
  const float* fks = reinterpret_cast<const float*>(ks);
  const float* fvs = reinterpret_cast<const float*>(vs);
  const float* fnk = reinterpret_cast<const float*>(nk);
  const float* fnv = reinterpret_cast<const float*>(nv);
  switch (kinds) {
    case 0:
      return (int)launch_hd<__nv_bfloat16>(hd, q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B,
                                           H, Tq, C, l, a1_lo, a2_lo, q_off, scale, fks, fvs, fnk,
                                           fnv, ns, slot, s);
    case 2:
      return (int)launch_hd<float>(hd, q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H, Tq,
                                   C, l, a1_lo, a2_lo, q_off, scale, fks, fvs, fnk, fnv, ns, slot,
                                   s);
    case 3:
      return (int)launch_hd<int8_t>(hd, q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H, Tq,
                                    C, l, a1_lo, a2_lo, q_off, scale, fks, fvs, fnk, fnv, ns,
                                    slot, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
