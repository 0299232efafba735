// flash_attention: the training attention of VALL-E X, forward and backward,
// for head_dim 64, with segment ids and a prefix-causal bound.
//
// Replaces the JAX library's Pallas flash attention as the JAX package calls
// it for training (vallex_tpu/models/layers.py):
//   attention_core_flash (:205) with segment ids, causal=False or True, and
//   attention_core_flash_prefix (:259), the AR training mask, built there
//   from two calls of :205 (a causal pass over the whole sequence and a
//   non-causal pass over the text block whose rows replace the causal
//   output's text rows);
//   and the library's backward (_flash_attention_bwd: _flash_attention_bwd_dkv
//   and _flash_attention_bwd_dq) for both.
//
// One mask for all three uses. Key j is valid for query i iff
//     q_seg[b, i] == kv_seg[b, j]  and  j <= max(i, P - 1).
// P = T gives the non-causal (key padding, packed segments) call, P = 0 the
// causal one, P = text_len the prefix-causal one. The last is the two-call
// composition in one launch: for a text row i < P the bound is j <= P - 1,
// the non-causal pass over the text block alone (keys j >= P are out); for an
// audio row i >= P it is j <= i, the causal pass over the whole sequence.
//
// Kernels (one block of 256 threads per (query or key tile of 64, head, row)):
//   flash_fwd_kernel: loops over the key tiles a query tile can see (up to
//       max(q0 + 64, P)), online softmax in f32, writes O in the input type
//       and the row log-sum-exp (f32) for the backward;
//   flash_bwd_dq_kernel: per query tile, di = sum(O * dO) in f32 from O as
//       stored (written out for the dK/dV kernel), then dQ over the key tiles;
//   flash_bwd_dkv_kernel: per key tile, dK and dV over the query tiles that
//       can see it (all of them when the tile starts below P, else from the
//       tile's own row on). It runs after the dQ kernel on the same stream
//       and reads its di.
// Neither backward kernel uses atomics: each output element is one block's
// sum in a fixed order, so the gradients are the same from run to run.
// Rounding follows the library: scores in f32 (q.k, then times the scale),
// p cast to V's type before P.V, p and ds cast to the input type before
// their products in the backward, every product summed in f32.
// Rows without a valid key (not produced by the callers, whose (seg, seg)
// always keeps the diagonal) give O = 0, lse = 0 and zero gradients.
//
// Bound on the H100: operations, 4 * hd per valid (query, key) pair forward
// and 10 * hd backward. This first version runs the products on the CUDA
// cores from f32 tiles in shared memory (row stride 65, so a half-warp
// reading 16 rows hits 16 banks): each thread owns a 4 x 4 tile of the
// 64 x 64 scores, read from shared memory in the order of its products.
// Tensor cores (mma / wgmma) are the next version's work.
#include <math.h>

#include "common.cuh"

#define FA_HD 64
#define FA_TILE 64
#define FA_LD (FA_HD + 1)
#define FA_THREADS 256
#define FA_TILE_FLOATS (FA_TILE * FA_LD)

template <typename T>
__device__ __forceinline__ float fa_ld(const T* p);
template <>
__device__ __forceinline__ float fa_ld<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float fa_ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// x rounded to T and back (the library's .astype(v.dtype) before a product)
template <typename T>
__device__ __forceinline__ float fa_round(float x);
template <>
__device__ __forceinline__ float fa_round<float>(float x) { return x; }
template <>
__device__ __forceinline__ float fa_round<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void fa_st(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// rows [t0, t0 + 64) of one (b, h) slice into a [64][65] f32 tile, zeros
// past T
template <typename T>
__device__ __forceinline__ void fa_load_tile(float* dst, const T* src, long long st, int t0,
                                             int T_len) {
  for (int idx = threadIdx.x; idx < FA_TILE * FA_HD; idx += FA_THREADS) {
    const int r = idx / FA_HD, c = idx % FA_HD, t = t0 + r;
    dst[r * FA_LD + c] = t < T_len ? fa_ld(src + t * st + c) : 0.f;
  }
}

// segment ids of rows [t0, t0 + 64); rows past T get a flag no id equals
__device__ __forceinline__ void fa_load_seg(int* dst, const int* seg, int t0, int T_len,
                                            int pad) {
  for (int r = threadIdx.x; r < FA_TILE; r += FA_THREADS)
    dst[r] = t0 + r < T_len ? seg[t0 + r] : pad;
}

// Rows past T carry distinct pads in the query and key tiles, so they never
// match: INT_MIN for keys, INT_MIN + 1 for queries.
#define FA_PAD_K (-2147483647 - 1)
#define FA_PAD_Q (-2147483647)

__device__ __forceinline__ bool fa_valid(int i, int j, int P, int seg_i, int seg_j) {
  return seg_i == seg_j && j <= max(i, P - 1);
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
    flash_fwd_kernel(const T* __restrict__ q, FaStrides qs, const T* __restrict__ k,
                     const T* __restrict__ v, FaStrides kvs, const int* __restrict__ qseg,
                     const int* __restrict__ kvseg, T* __restrict__ o, FaStrides os,
                     float* __restrict__ lse, int H, int T_len, int P, float scale) {
  extern __shared__ float fa_smem[];
  float* Qs = fa_smem;
  float* Ks = Qs + FA_TILE_FLOATS;
  float* Vs = Ks + FA_TILE_FLOATS;
  float* Ps = Vs + FA_TILE_FLOATS;
  int* segq = reinterpret_cast<int*>(Ps + FA_TILE_FLOATS);
  int* segk = segq + FA_TILE;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * kvs.b + h * kvs.h;
  const T* vb = v + b * kvs.b + h * kvs.h;
  const int* qsg = qseg + (long long)b * T_len;
  const int* ksg = kvseg + (long long)b * T_len;

  fa_load_tile(Qs, qb, qs.t, q0, T_len);
  fa_load_seg(segq, qsg, q0, T_len, FA_PAD_Q);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  }
  // the last key any row of this tile sees is max(q0 + 63, P - 1)
  const int kend = min(T_len, max(q0 + FA_TILE, P));
  for (int k0 = 0; k0 < kend; k0 += FA_TILE) {
    __syncthreads();  // the previous tile's reads of Ks, Vs, Ps are done
    fa_load_tile(Ks, kb, kvs.t, k0, T_len);
    fa_load_tile(Vs, vb, kvs.t, k0, T_len);
    fa_load_seg(segk, ksg, k0, T_len, FA_PAD_K);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < FA_HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = Qs[(ty * 4 + a) * FA_LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * FA_LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = fmaf(qv[a], kv[j], s[a][j]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a, i = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[a][j] = fa_valid(i, k0 + c, P, segq[r], segk[c]) ? s[a][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][j]);
      }
      const float m_new = fmaxf(m[a], fa_max16(mx));
      float alpha = 1.f, psum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[a] - m_new);  // 0 while the row had no valid key
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[a][j] - m_new);
          psum += p;
          Ps[r * FA_LD + tx + 16 * j] = fa_round<T>(p);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[r * FA_LD + tx + 16 * j] = 0.f;
      }
      l[a] = l[a] * alpha + fa_sum16(psum);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FA_TILE; ++kk) {
      float vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * FA_LD + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = Ps[(ty * 4 + a) * FA_LD + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(p, vv[j], acc[a][j]);
      }
    }
  }
  T* ob = o + b * os.b + h * os.h;
  float* lb = lse + ((long long)b * H + h) * T_len;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty * 4 + a;
    if (i >= T_len) continue;
    const float inv = l[a] > 0.f ? 1.f / l[a] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) fa_st(ob + i * os.t + tx + 16 * j, acc[a][j] * inv);
    if (tx == 0) lb[i] = l[a] > 0.f ? m[a] + logf(l[a]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, FaStrides qs, const T* __restrict__ k,
                        const T* __restrict__ v, FaStrides kvs, const T* __restrict__ o,
                        FaStrides os, const T* __restrict__ dout, FaStrides dos,
                        const int* __restrict__ qseg, const int* __restrict__ kvseg,
                        const float* __restrict__ lse, float* __restrict__ di_out,
                        T* __restrict__ dq, int H, int T_len, int P, float scale) {
  extern __shared__ float fa_smem[];
  float* Qs = fa_smem;
  float* dOs = Qs + FA_TILE_FLOATS;
  float* Ks = dOs + FA_TILE_FLOATS;
  float* Vs = Ks + FA_TILE_FLOATS;
  float* dSs = Vs + FA_TILE_FLOATS;
  int* segq = reinterpret_cast<int*>(dSs + FA_TILE_FLOATS);
  int* segk = segq + FA_TILE;
  float* lse_s = reinterpret_cast<float*>(segk + FA_TILE);
  float* di_s = lse_s + FA_TILE;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const T* kb = k + b * kvs.b + h * kvs.h;
  const T* vb = v + b * kvs.b + h * kvs.h;
  const T* ob = o + b * os.b + h * os.h;
  const int* ksg = kvseg + (long long)b * T_len;

  fa_load_tile(Qs, q + b * qs.b + h * qs.h, qs.t, q0, T_len);
  fa_load_tile(dOs, dout + b * dos.b + h * dos.h, dos.t, q0, T_len);
  fa_load_seg(segq, qseg + (long long)b * T_len, q0, T_len, FA_PAD_Q);
  // di = sum_c O[i, c] * dO[i, c] in f32, four lanes per row
  {
    const int r = tid >> 2, part = tid & 3, i = q0 + r;
    __syncthreads();  // dOs is loaded
    float acc = 0.f;
    if (i < T_len) {
      for (int c = part * 16; c < part * 16 + 16; ++c)
        acc = fmaf(fa_ld(ob + i * os.t + c), dOs[r * FA_LD + c], acc);
    }
    acc += __shfl_xor_sync(VX_FULL_MASK, acc, 1);
    acc += __shfl_xor_sync(VX_FULL_MASK, acc, 2);
    if (part == 0) {
      di_s[r] = acc;
      lse_s[r] = i < T_len ? lse[bh * T_len + i] : 0.f;
      if (i < T_len) di_out[bh * T_len + i] = acc;
    }
  }

  float dqa[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) dqa[a][j] = 0.f;
  const int kend = min(T_len, max(q0 + FA_TILE, P));
  for (int k0 = 0; k0 < kend; k0 += FA_TILE) {
    __syncthreads();
    fa_load_tile(Ks, kb, kvs.t, k0, T_len);
    fa_load_tile(Vs, vb, kvs.t, k0, T_len);
    fa_load_seg(segk, ksg, k0, T_len, FA_PAD_K);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < FA_HD; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qv[a] = Qs[(ty * 4 + a) * FA_LD + d];
        dov[a] = dOs[(ty * 4 + a) * FA_LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * FA_LD + d];
        vv[j] = Vs[(tx + 16 * j) * FA_LD + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[a][j] = fmaf(qv[a], kv[j], s[a][j]);
          dp[a][j] = fmaf(dov[a], vv[j], dp[a][j]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a, i = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (fa_valid(i, k0 + c, P, segq[r], segk[c])) {
          const float p = expf(s[a][j] * scale - lse_s[r]);
          ds = p * (dp[a][j] - di_s[r]) * scale;
        }
        dSs[r * FA_LD + c] = fa_round<T>(ds);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FA_TILE; ++kk) {
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[kk * FA_LD + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = dSs[(ty * 4 + a) * FA_LD + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) dqa[a][j] = fmaf(ds, kv[j], dqa[a][j]);
      }
    }
  }
  T* dqb = dq + bh * T_len * FA_HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty * 4 + a;
    if (i >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) fa_st(dqb + (long long)i * FA_HD + tx + 16 * j, dqa[a][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, FaStrides qs, const T* __restrict__ k,
                         const T* __restrict__ v, FaStrides kvs, const T* __restrict__ dout,
                         FaStrides dos, const int* __restrict__ qseg,
                         const int* __restrict__ kvseg, const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                         int H, int T_len, int P, float scale) {
  extern __shared__ float fa_smem[];
  float* Ks = fa_smem;
  float* Vs = Ks + FA_TILE_FLOATS;
  float* Qs = Vs + FA_TILE_FLOATS;
  float* dOs = Qs + FA_TILE_FLOATS;
  float* Pts = dOs + FA_TILE_FLOATS;  // p transposed: [key][query]
  float* dSts = Pts + FA_TILE_FLOATS;  // ds transposed: [key][query]
  int* segk = reinterpret_cast<int*>(dSts + FA_TILE_FLOATS);
  int* segq = segk + FA_TILE;
  float* lse_s = reinterpret_cast<float*>(segq + FA_TILE);
  float* di_s = lse_s + FA_TILE;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const int* qsg = qseg + (long long)b * T_len;

  fa_load_tile(Ks, k + b * kvs.b + h * kvs.h, kvs.t, k0, T_len);
  fa_load_tile(Vs, v + b * kvs.b + h * kvs.h, kvs.t, k0, T_len);
  fa_load_seg(segk, kvseg + (long long)b * T_len, k0, T_len, FA_PAD_K);

  float dka[4][4], dva[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[a][j] = dva[a][j] = 0.f;
  // rows below this tile see it only through the prefix (keys j < P)
  const int qstart = k0 < P ? 0 : k0;
  for (int q0 = qstart; q0 < T_len; q0 += FA_TILE) {
    __syncthreads();
    fa_load_tile(Qs, qb, qs.t, q0, T_len);
    fa_load_tile(dOs, dob, dos.t, q0, T_len);
    fa_load_seg(segq, qsg, q0, T_len, FA_PAD_Q);
    for (int r = tid; r < FA_TILE; r += FA_THREADS) {
      const bool in = q0 + r < T_len;
      lse_s[r] = in ? lse[bh * T_len + q0 + r] : 0.f;
      di_s[r] = in ? di[bh * T_len + q0 + r] : 0.f;
    }
    __syncthreads();

    // s^T and dp^T: key rows ty*4 + a, query columns tx + 16 j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[a][j] = dpt[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < FA_HD; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kv[a] = Ks[(ty * 4 + a) * FA_LD + d];
        vv[a] = Vs[(ty * 4 + a) * FA_LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * FA_LD + d];
        dov[j] = dOs[(tx + 16 * j) * FA_LD + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[a][j] = fmaf(kv[a], qv[j], st[a][j]);
          dpt[a][j] = fmaf(vv[a], dov[j], dpt[a][j]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kr = ty * 4 + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (fa_valid(q0 + c, k0 + kr, P, segq[c], segk[kr])) {
          p = expf(st[a][j] * scale - lse_s[c]);
          ds = p * (dpt[a][j] - di_s[c]) * scale;
        }
        Pts[kr * FA_LD + c] = fa_round<T>(p);
        dSts[kr * FA_LD + c] = fa_round<T>(ds);
      }
    }
    __syncthreads();
    // dV += p^T dO, dK += ds^T Q: key rows ty*4 + a, head columns tx + 16 j
#pragma unroll 4
    for (int i = 0; i < FA_TILE; ++i) {
      float dov[4], qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dov[j] = dOs[i * FA_LD + tx + 16 * j];
        qv[j] = Qs[i * FA_LD + tx + 16 * j];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = Pts[(ty * 4 + a) * FA_LD + i];
        const float ds = dSts[(ty * 4 + a) * FA_LD + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dva[a][j] = fmaf(p, dov[j], dva[a][j]);
          dka[a][j] = fmaf(ds, qv[j], dka[a][j]);
        }
      }
    }
  }
  T* dkb = dk + bh * T_len * FA_HD;
  T* dvb = dv + bh * T_len * FA_HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty * 4 + a;
    if (j >= T_len) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      fa_st(dkb + (long long)j * FA_HD + tx + 16 * c, dka[a][c]);
      fa_st(dvb + (long long)j * FA_HD + tx + 16 * c, dva[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers. Strides arrive as three long longs (b, h, t) in elements; the
// last stride is 1. Gradients and lse / di are contiguous [B, H, T(, 64)].
// kind 0: f32, kind 1: bf16 (q, k, v, O, dO and the gradients alike).
// ---------------------------------------------------------------------------

static FaStrides fa_strides(const long long* s) { return FaStrides{s[0], s[1], s[2]}; }

static const size_t FA_FWD_SMEM = 4 * FA_TILE_FLOATS * sizeof(float) + 2 * FA_TILE * sizeof(int);
static const size_t FA_DQ_SMEM =
    5 * FA_TILE_FLOATS * sizeof(float) + 2 * FA_TILE * sizeof(int) + 2 * FA_TILE * sizeof(float);
static const size_t FA_DKV_SMEM =
    6 * FA_TILE_FLOATS * sizeof(float) + 2 * FA_TILE * sizeof(int) + 2 * FA_TILE * sizeof(float);

template <typename K>
static cudaError_t fa_allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static bool fa_shape_ok(int kind, int B, int H, int T_len) {
  return (kind == 0 || kind == 1) && B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && T_len >= 1;
}

template <typename T>
static cudaError_t fa_fwd(const void* q, const long long* qs, const void* k, const void* v,
                          const long long* kvs, const int* qseg, const int* kvseg, void* o,
                          const long long* os, float* lse, int B, int H, int T_len, int P,
                          float scale, cudaStream_t s) {
  cudaError_t e = fa_allow_smem(flash_fwd_kernel<T>, FA_FWD_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + FA_TILE - 1) / FA_TILE, H, B);
  flash_fwd_kernel<T><<<grid, FA_THREADS, FA_FWD_SMEM, s>>>(
      reinterpret_cast<const T*>(q), fa_strides(qs), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), fa_strides(kvs), qseg, kvseg, reinterpret_cast<T*>(o),
      fa_strides(os), lse, H, T_len, P, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t fa_bwd_dq(const void* q, const long long* qs, const void* k, const void* v,
                             const long long* kvs, const void* o, const long long* os,
                             const void* dout, const long long* dos, const int* qseg,
                             const int* kvseg, const float* lse, float* di, void* dq, int B,
                             int H, int T_len, int P, float scale, cudaStream_t s) {
  cudaError_t e = fa_allow_smem(flash_bwd_dq_kernel<T>, FA_DQ_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + FA_TILE - 1) / FA_TILE, H, B);
  flash_bwd_dq_kernel<T><<<grid, FA_THREADS, FA_DQ_SMEM, s>>>(
      reinterpret_cast<const T*>(q), fa_strides(qs), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), fa_strides(kvs), reinterpret_cast<const T*>(o),
      fa_strides(os), reinterpret_cast<const T*>(dout), fa_strides(dos), qseg, kvseg, lse, di,
      reinterpret_cast<T*>(dq), H, T_len, P, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t fa_bwd_dkv(const void* q, const long long* qs, const void* k, const void* v,
                              const long long* kvs, const void* dout, const long long* dos,
                              const int* qseg, const int* kvseg, const float* lse,
                              const float* di, void* dk, void* dv, int B, int H, int T_len,
                              int P, float scale, cudaStream_t s) {
  cudaError_t e = fa_allow_smem(flash_bwd_dkv_kernel<T>, FA_DKV_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + FA_TILE - 1) / FA_TILE, H, B);
  flash_bwd_dkv_kernel<T><<<grid, FA_THREADS, FA_DKV_SMEM, s>>>(
      reinterpret_cast<const T*>(q), fa_strides(qs), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), fa_strides(kvs), reinterpret_cast<const T*>(dout),
      fa_strides(dos), qseg, kvseg, lse, di, reinterpret_cast<T*>(dk), reinterpret_cast<T*>(dv),
      H, T_len, P, scale);
  return cudaGetLastError();
}

extern "C" int vx_flash_attention_fwd(const void* q, const long long* qs, const void* k,
                                      const void* v, const long long* kvs, const void* qseg,
                                      const void* kvseg, void* o, const long long* os,
                                      void* lse, int kind, int B, int H, int T_len, int P,
                                      float scale, void* stream) {
  if (!fa_shape_ok(kind, B, H, T_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* qsg = reinterpret_cast<const int*>(qseg);
  const int* ksg = reinterpret_cast<const int*>(kvseg);
  float* l = reinterpret_cast<float*>(lse);
  if (kind == 0)
    return (int)fa_fwd<float>(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H, T_len, P, scale, s);
  return (int)fa_fwd<__nv_bfloat16>(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H, T_len, P, scale,
                                    s);
}

extern "C" int vx_flash_attention_bwd_dq(const void* q, const long long* qs, const void* k,
                                         const void* v, const long long* kvs, const void* o,
                                         const long long* os, const void* dout,
                                         const long long* dos, const void* qseg,
                                         const void* kvseg, const void* lse, void* di, void* dq,
                                         int kind, int B, int H, int T_len, int P, float scale,
                                         void* stream) {
  if (!fa_shape_ok(kind, B, H, T_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* qsg = reinterpret_cast<const int*>(qseg);
  const int* ksg = reinterpret_cast<const int*>(kvseg);
  const float* l = reinterpret_cast<const float*>(lse);
  float* d = reinterpret_cast<float*>(di);
  if (kind == 0)
    return (int)fa_bwd_dq<float>(q, qs, k, v, kvs, o, os, dout, dos, qsg, ksg, l, d, dq, B, H,
                                 T_len, P, scale, s);
  return (int)fa_bwd_dq<__nv_bfloat16>(q, qs, k, v, kvs, o, os, dout, dos, qsg, ksg, l, d, dq,
                                       B, H, T_len, P, scale, s);
}

extern "C" int vx_flash_attention_bwd_dkv(const void* q, const long long* qs, const void* k,
                                          const void* v, const long long* kvs, const void* dout,
                                          const long long* dos, const void* qseg,
                                          const void* kvseg, const void* lse, const void* di,
                                          void* dk, void* dv, int kind, int B, int H, int T_len,
                                          int P, float scale, void* stream) {
  if (!fa_shape_ok(kind, B, H, T_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* qsg = reinterpret_cast<const int*>(qseg);
  const int* ksg = reinterpret_cast<const int*>(kvseg);
  const float* l = reinterpret_cast<const float*>(lse);
  const float* d = reinterpret_cast<const float*>(di);
  if (kind == 0)
    return (int)fa_bwd_dkv<float>(q, qs, k, v, kvs, dout, dos, qsg, ksg, l, d, dk, dv, B, H,
                                  T_len, P, scale, s);
  return (int)fa_bwd_dkv<__nv_bfloat16>(q, qs, k, v, kvs, dout, dos, qsg, ksg, l, d, dk, dv, B,
                                        H, T_len, P, scale, s);
}
