// flash_attention: full-sequence attention of VALL-E X for head_dim 64 or 128, with
// segment ids and a prefix-causal bound: the NAR's key-padded attention when
// serving, and the training attention, forward and backward.
//
// Replaces the JAX library's Pallas flash attention as the JAX package calls
// it (vallex_tpu/models/layers.py):
//   attention_core_flash (:205) with segment ids, causal=False or True: the
//   NAR at s_text + t_audio >= 1536 (vallex_tpu/engine/nar.py:97-102, the
//   key-padding rule as segments (ok, ok)) and the padded or packed rows of
//   training;
//   attention_core_flash_prefix (:259), the AR training mask, built there
//   from two calls of :205 (a causal pass over the whole sequence and a
//   non-causal pass over the text block whose rows replace the causal
//   output's text rows);
//   and the library's backward (_flash_attention_bwd: _flash_attention_bwd_dkv
//   and _flash_attention_bwd_dq) for both.
//
// One mask for all uses. Key j is valid for query i iff
//     q_seg[b, i] == kv_seg[b, j]  and  j <= max(i, P - 1).
// P = T gives the non-causal (key padding, packed segments) call, P = 0 the
// causal one, P = text_len the prefix-causal one. The last is the two-call
// composition in one launch: for a text row i < P the bound is j <= P - 1,
// the non-causal pass over the text block alone (keys j >= P are out); for an
// audio row i >= P it is j <= i, the causal pass over the whole sequence.
//
// Kernels, picked by kind and head dim (neither stands in for the other):
//   flash_fwd_tc_kernel (bf16, hd 64): the forward on the tensor cores, below;
//   flash_fwd_kernel<float, hd> (f32) and flash_fwd_kernel<bf16, 128>: the
//       forward on the CUDA cores (tensor cores in f32 would be TF32, which
//       changes the f32 numbers; the tensor-core kernels hold their 64 x hd
//       tiles in one warpgroup's registers and are written for hd 64), one
//       block of 256 threads per (query tile of 64, head, row); f32 tiles in
//       shared memory (row stride hd + 1, so a half-warp reading 16 rows hits
//       16 banks), each thread a 4 x 4 tile of the 64 x 64 scores and a
//       4 x hd/16 tile of the output;
//   flash_bwd_dq_tc_kernel (bf16, hd 64) / flash_bwd_dq_kernel<T, hd>: per
//       query tile, di = sum(O * dO) in f32 from O as stored (written out for
//       the dK/dV kernel), then dQ over the key tiles;
//   flash_bwd_dkv_tc_kernel (bf16, hd 64) / flash_bwd_dkv_kernel<T, hd>: per
//       key tile, dK and dV over the query tiles that can see it (all of them
//       when the tile starts below P, else from the tile's own row on). It
//       runs after the dQ kernel on the same stream and reads its di.
// Both forwards write O in the input type and the row log-sum-exp (f32) for
// the backward. The bf16 kernels at hd 64 run on the tensor cores (wgmma,
// TMA, mbarrier; sm_90a), the f32 ones and bf16 at hd 128 on the CUDA cores
// in the f32 layout above.
// Neither backward uses atomics: each output element is one block's sum in a
// fixed order, so the gradients are the same from run to run.
// Rounding follows the library: scores in f32 (q.k, then times the scale),
// p cast to V's type before P.V, p and ds cast to the input type before
// their products in the backward, every product summed in f32.
// Rows without a valid key give O = 0, lse = 0 and zero gradients.
//
// Bound on the H100: operations, 4 * hd per valid (query, key) pair forward
// (bf16 at 989 TFLOP/s), 6 * hd in the dQ kernel (q.k, dO.v, ds.k) and
// 8 * hd in the dK/dV kernel (q.k, dO.v, p.dO, ds.q); the bf16 backward's
// design is with its kernels below. The bf16 forward's design for that bound:
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)
#include <limits.h>
#include <math.h>

#include "common.cuh"

#define FA_HD 64  // the tensor-core kernels' head dim
#define FA_TILE 64
#define FA_PLD (FA_TILE + 1)  // row stride of the CUDA-core kernels' 64 x 64 p / ds tiles
#define FA_THREADS 256

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

// rows [t0, t0 + 64) of one (b, h) slice into a [64][HD + 1] f32 tile,
// zeros past T
template <typename T, int HD>
__device__ __forceinline__ void fa_load_tile(float* dst, const T* src, long long st, int t0,
                                             int T_len) {
  for (int idx = threadIdx.x; idx < FA_TILE * HD; idx += FA_THREADS) {
    const int r = idx / HD, c = idx % HD, t = t0 + r;
    dst[r * (HD + 1) + c] = t < T_len ? fa_ld(src + t * st + c) : 0.f;
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

// The CUDA-core kernels, for head dim HD (64 or 128): f32, and bf16 at 128.
// Thread (ty, tx) of the 16 x 16 grid holds query (or key) rows ty * 4 + a
// and head columns tx + 16 j (j < HD / 16) of its outputs.
template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
    flash_fwd_kernel(const T* __restrict__ q, FaStrides qs, const T* __restrict__ k,
                     const T* __restrict__ v, FaStrides kvs, const int* __restrict__ qseg,
                     const int* __restrict__ kvseg, T* __restrict__ o, FaStrides os,
                     float* __restrict__ lse, int H, int T_len, int P, float scale) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float fa_smem[];
  float* Qs = fa_smem;
  float* Ks = Qs + FA_TILE * LD;
  float* Vs = Ks + FA_TILE * LD;
  float* Ps = Vs + FA_TILE * LD;
  int* segq = reinterpret_cast<int*>(Ps + FA_TILE * FA_PLD);
  int* segk = segq + FA_TILE;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * kvs.b + h * kvs.h;
  const T* vb = v + b * kvs.b + h * kvs.h;
  const int* qsg = qseg + (long long)b * T_len;
  const int* ksg = kvseg + (long long)b * T_len;

  fa_load_tile<T, HD>(Qs, qb, qs.t, q0, T_len);
  fa_load_seg(segq, qsg, q0, T_len, FA_PAD_Q);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }
  // the last key any row of this tile sees is max(q0 + 63, P - 1)
  const int kend = min(T_len, max(q0 + FA_TILE, P));
  for (int k0 = 0; k0 < kend; k0 += FA_TILE) {
    __syncthreads();  // the previous tile's reads of Ks, Vs, Ps are done
    fa_load_tile<T, HD>(Ks, kb, kvs.t, k0, T_len);
    fa_load_tile<T, HD>(Vs, vb, kvs.t, k0, T_len);
    fa_load_seg(segk, ksg, k0, T_len, FA_PAD_K);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = Qs[(ty * 4 + a) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
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
          Ps[r * FA_PLD + tx + 16 * j] = fa_round<T>(p);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[r * FA_PLD + tx + 16 * j] = 0.f;
      }
      l[a] = l[a] * alpha + fa_sum16(psum);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FA_TILE; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = Ps[(ty * 4 + a) * FA_PLD + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[a][j] = fmaf(p, vv[j], acc[a][j]);
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
    for (int j = 0; j < NJ; ++j) fa_st(ob + i * os.t + tx + 16 * j, acc[a][j] * inv);
    if (tx == 0) lb[i] = l[a] > 0.f ? m[a] + logf(l[a]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores (wgmma, TMA, mbarrier; sm_90a).
// ---------------------------------------------------------------------------

#define FW_THREADS 128  // one warpgroup: 64 query rows, 16 per warp
#define FW_STAGES 2     // the K/V ring
#define FW_TILE_BYTES (FA_TILE * FA_HD * 2)
// key-tile classes (the low bit of a listed tile)
#define FW_FULL 0
#define FW_MASKED 1

// Where the tensor map puts each outer dimension of a [B, H, T, 64] view:
// its coordinate slot (1..3; slot 0 is the head dim).
struct FaTmaPos {
  int t, h, b;
};

__device__ __forceinline__ uint32_t fw_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fw_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(fw_smem(bar)) : "memory");
}

__device__ __forceinline__ void fw_bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(fw_smem(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void fw_bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(fw_smem(bar)), "r"(parity)
        : "memory");
  }
}

// one 64 x 64 box of a 4-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void fw_tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            FaTmaPos pos, int t0, int h, int b) {
  int c[4] = {0, 0, 0, 0};
  c[pos.t] = t0;
  c[pos.h] = h;
  c[pos.b] = b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(fw_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(fw_smem(bar)), "r"(c[0]), "r"(c[1]), "r"(c[2]),
      "r"(c[3])
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; the tile starts on a
// 1024-byte boundary (base offset 0)
__device__ __forceinline__ uint64_t fw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fw_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void fw_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fw_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma region
__device__ __forceinline__ void fw_hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FW_D32                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define FW_REGS32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory, both
// K-major (S = Q K^T: Q rows and K rows hold the head dim contiguously)
__device__ __forceinline__ void fw_mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FW_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FW_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (bf16 pairs), B from
// shared memory MN-major (O += P V: V rows hold the head dim, the N side)
__device__ __forceinline__ void fw_mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FW_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FW_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t fw_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float fw_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(VX_FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(VX_FULL_MASK, v, 2));
}
__device__ __forceinline__ float fw_quad_sum(float v) {
  v += __shfl_xor_sync(VX_FULL_MASK, v, 1);
  return v + __shfl_xor_sync(VX_FULL_MASK, v, 2);
}

// the A fragments of the four k-steps: the f32 accumulator x rounded to bf16
// pairs (the fragment of columns 16 kk..16 kk + 15 is k-step kk's)
__device__ __forceinline__ void fw_frag(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = fw_pack(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = fw_pack(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = fw_pack(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = fw_pack(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// d = A B^T over the head dim, both 64 x 64 tiles K-major in shared memory:
// four k-steps of 16, each 32 bytes further into the 128-byte swizzled rows
__device__ __forceinline__ void fw_mma_kk(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    fw_mma_ss(d, fw_desc(a_addr + 32 * kk, 16, 1024), fw_desc(b_addr + 32 * kk, 16, 1024), kk);
}

// d += A B: A from registers (fw_frag's fragments), B a 64 x 64 tile MN-major
// in shared memory (its rows are the k dim, the head dim contiguous; k-step
// kk is 16 rows further on)
__device__ __forceinline__ void fw_mma_rk(float (&d)[32], const uint32_t (&a)[4][4],
                                          uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fw_mma_rs(d, a[kk], fw_desc(b_addr + 2048 * kk, 8192, 1024));
}

// The tiles of the other side that a block's own tile of 64 rows meets,
// classified before any is loaded (the bf16 forward and both bf16 backward
// kernels), one warp per tile: the own ids' min / max against the tile's,
// then an exact vote. A tile is skipped when no own id equals one of its ids
// (every pair is masked, so it adds exactly 0); FULL when every pair has one
// id and lies inside T and the causal bound (its scores are used as they
// are); else MASKED, pair by pair. own_seg: the own tile's ids in shared
// memory, pads past T; other_seg: the other side's ids of this batch row;
// own_is_query says which side is the block's. Writes the visited tiles of
// [t_lo, t_hi), in order, as (tile << 1 | class) to tiles[] and their number
// to *count, and returns it to every thread.
__device__ int fa_visit(const int* own_seg, bool own_is_query, int own0, const int* other_seg,
                        int t_lo, int t_hi, int T_len, int P, int* tiles, int* count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int omin, omax;
  {
    const int a = own_seg[lane], c = own_seg[lane + 32];
    const bool ia = own0 + lane < T_len, ic = own0 + lane + 32 < T_len;
    omin = min(ia ? a : INT_MAX, ic ? c : INT_MAX);
    omax = max(ia ? a : INT_MIN, ic ? c : INT_MIN);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      omin = min(omin, __shfl_xor_sync(VX_FULL_MASK, omin, s));
      omax = max(omax, __shfl_xor_sync(VX_FULL_MASK, omax, s));
    }
  }
  const bool own_whole = own0 + FA_TILE <= T_len && omin == omax;
  const int pad = own_is_query ? FA_PAD_K : FA_PAD_Q;
  for (int t = t_lo + warp; t < t_hi; t += blockDim.x >> 5) {
    const int x0 = t * FA_TILE;
    const bool ia = x0 + lane < T_len, ic = x0 + lane + 32 < T_len;
    const int xa = ia ? other_seg[x0 + lane] : pad, xc = ic ? other_seg[x0 + lane + 32] : pad;
    int xmin = min(ia ? xa : INT_MAX, ic ? xc : INT_MAX);
    int xmax = max(ia ? xa : INT_MIN, ic ? xc : INT_MIN);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      xmin = min(xmin, __shfl_xor_sync(VX_FULL_MASK, xmin, s));
      xmax = max(xmax, __shfl_xor_sync(VX_FULL_MASK, xmax, s));
    }
    // max(q0, P - 1) is the least bound max(i, P - 1) of the query tile's rows
    const int q0 = own_is_query ? own0 : x0, k0 = own_is_query ? x0 : own0;
    int cls = -1;  // skipped
    if (xmax < omin || xmin > omax) {
      cls = -1;
    } else if (own_whole && xmin == xmax && xmin == omin && x0 + FA_TILE <= T_len &&
               k0 + FA_TILE - 1 <= max(q0, P - 1)) {
      cls = FW_FULL;
    } else {
      bool hit = false;  // the vote: any own id equal to one of this lane's ids
      for (int r = 0; r < FA_TILE; ++r) {
        const int so = own_seg[r];
        hit |= (so == xa) | (so == xc);
      }
      cls = __any_sync(VX_FULL_MASK, hit) ? FW_MASKED : -1;
    }
    if (lane == 0) tiles[t - t_lo] = cls;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = t_lo; t < t_hi; ++t)
      if (tiles[t - t_lo] >= 0) tiles[n++] = (t << 1) | tiles[t - t_lo];
    *count = n;
  }
  __syncthreads();
  return *count;
}

// Shared memory: Q tile, FW_STAGES K and V tiles (each 64 rows of 128 bytes,
// 1024-byte aligned for the swizzle), the barriers (Q, then one per stage),
// the query tile's segment ids, the count and list of key tiles to visit.
#define FW_SMEM_FIXED (1024 + (1 + 2 * FW_STAGES) * FW_TILE_BYTES + 8 * (1 + FW_STAGES) + 4 * FA_TILE + 16)

__global__ void __launch_bounds__(FW_THREADS)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, FaTmaPos qpos, FaTmaPos kvpos,
                        const int* __restrict__ qseg, const int* __restrict__ kvseg,
                        __nv_bfloat16* __restrict__ o, FaStrides os, float* __restrict__ lse,
                        int H, int T_len, int P, float scale_log2) {
  extern __shared__ unsigned char fw_raw[];
  unsigned char* base = fw_raw + ((1024 - (fw_smem(fw_raw) & 1023)) & 1023);
  unsigned char* Qs = base;
  unsigned char* Ks = Qs + FW_TILE_BYTES;
  unsigned char* Vs = Ks + FW_STAGES * FW_TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + FW_STAGES * FW_TILE_BYTES);
  int* segq = reinterpret_cast<int*>(bars + 1 + FW_STAGES);
  int* count = segq + FA_TILE;
  int* tiles = count + 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int* qsg = qseg + (long long)b * T_len;
  const int* ksg = kvseg + (long long)b * T_len;

  if (tid < FA_TILE) segq[tid] = q0 + tid < T_len ? qsg[q0 + tid] : FA_PAD_Q;
  if (tid == 0) {
    for (int i = 0; i < 1 + FW_STAGES; ++i) fw_bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // the query tile, once
    fw_bar_expect(bars, FW_TILE_BYTES);
    fw_tma_load(Qs, &qmap, bars, qpos, q0, h, b);
  }

  // the key tiles this tile can see (up to max(q0 + 64, P)), classified
  const int kend = min(T_len, max(q0 + FA_TILE, P));
  const int n = fa_visit(segq, true, q0, ksg, 0, (kend + FA_TILE - 1) / FA_TILE, T_len, P, tiles,
                         count);
  if (tid == 0) {
    for (int i = 0; i < min(n, FW_STAGES); ++i) {
      fw_bar_expect(bars + 1 + i, 2 * FW_TILE_BYTES);
      fw_tma_load(Ks + i * FW_TILE_BYTES, &kmap, bars + 1 + i, kvpos, (tiles[i] >> 1) * FA_TILE, h, b);
      fw_tma_load(Vs + i * FW_TILE_BYTES, &vmap, bars + 1 + i, kvpos, (tiles[i] >> 1) * FA_TILE, h, b);
    }
  }

  // this thread's rows of the accumulators: r0 and r0 + 8; its columns
  // 8 j + 2 tq + {0, 1}, j = 0..7 (wgmma's m64nNk16 fragment)
  const int r0 = warp * 16 + (lane >> 2), tq = lane & 3;
  const int seg0 = segq[r0], seg1 = segq[r0 + 8];
  const int i0 = q0 + r0, i1 = i0 + 8;
  const int lim0 = max(i0, P - 1), lim1 = max(i1, P - 1);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only

  const uint32_t q_addr = fw_smem(Qs);
  fw_bar_wait(bars, 0);  // (also when no tile is visited: the load must land first)
  for (int it = 0; it < n; ++it) {
    const int stage = it % FW_STAGES;
    const int e = tiles[it], k0 = (e >> 1) * FA_TILE;
    const uint32_t k_addr = fw_smem(Ks + stage * FW_TILE_BYTES);
    const uint32_t v_addr = fw_smem(Vs + stage * FW_TILE_BYTES);
    fw_bar_wait(bars + 1 + stage, (it / FW_STAGES) & 1);

    // S = Q K^T, f32
    float s[32];
    fw_fence();
    fw_mma_kk(s, q_addr, k_addr);
    fw_commit();
    fw_wait_all();
    fw_hold(s);

    // scores times the scale (in log2 units), masked where the tile needs it
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    if (e & FW_MASKED) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int col = k0 + 8 * j + 2 * tq + x;
          const int sk = col < T_len ? ksg[col] : FA_PAD_K;
          if (!(sk == seg0 && col <= lim0)) s[4 * j + x] = -INFINITY;
          if (!(sk == seg1 && col <= lim1)) s[4 * j + 2 + x] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, fw_quad_max(mx0)), mn1 = fmaxf(m1, fw_quad_max(mx1));
    // a row with no valid key yet keeps p = 0 (exp2(-inf)), alpha 0
    const float b0 = mn0 == -INFINITY ? 0.f : mn0, b1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - b0), al1 = exp2f(m1 - b1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = exp2f(s[4 * j] - b0);
      s[4 * j + 1] = exp2f(s[4 * j + 1] - b0);
      s[4 * j + 2] = exp2f(s[4 * j + 2] - b1);
      s[4 * j + 3] = exp2f(s[4 * j + 3] - b1);
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
      acc[4 * j] *= al0;
      acc[4 * j + 1] *= al0;
      acc[4 * j + 2] *= al1;
      acc[4 * j + 3] *= al1;
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;

    // O += P V: p rounded to bf16 as the A operand, V MN-major
    uint32_t pa[4][4];
    fw_frag(pa, s);
    fw_hold(acc);
    fw_fence();
    fw_mma_rk(acc, pa, v_addr);
    fw_commit();
    fw_wait_all();
    fw_hold(acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && it + FW_STAGES < n) {
      const int t = tiles[it + FW_STAGES] >> 1;
      fw_bar_expect(bars + 1 + stage, 2 * FW_TILE_BYTES);
      fw_tma_load(Ks + stage * FW_TILE_BYTES, &kmap, bars + 1 + stage, kvpos, t * FA_TILE, h, b);
      fw_tma_load(Vs + stage * FW_TILE_BYTES, &vmap, bars + 1 + stage, kvpos, t * FA_TILE, h, b);
    }
  }

  l0 = fw_quad_sum(l0);
  l1 = fw_quad_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    if (i0 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + i0 * os.t + c) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (i1 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + i1 * os.t + c) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  if (tq == 0) {
    float* lb = lse + ((long long)b * H + h) * T_len;
    if (i0 < T_len) lb[i0] = l0 > 0.f ? (m0 + log2f(l0)) * 0.69314718055994531f : 0.f;
    if (i1 < T_len) lb[i1] = l1 > 0.f ? (m1 + log2f(l1)) * 0.69314718055994531f : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, FaStrides qs, const T* __restrict__ k,
                        const T* __restrict__ v, FaStrides kvs, const T* __restrict__ o,
                        FaStrides os, const T* __restrict__ dout, FaStrides dos,
                        const int* __restrict__ qseg, const int* __restrict__ kvseg,
                        const float* __restrict__ lse, float* __restrict__ di_out,
                        T* __restrict__ dq, int H, int T_len, int P, float scale) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float fa_smem[];
  float* Qs = fa_smem;
  float* dOs = Qs + FA_TILE * LD;
  float* Ks = dOs + FA_TILE * LD;
  float* Vs = Ks + FA_TILE * LD;
  float* dSs = Vs + FA_TILE * LD;
  int* segq = reinterpret_cast<int*>(dSs + FA_TILE * FA_PLD);
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

  fa_load_tile<T, HD>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, T_len);
  fa_load_tile<T, HD>(dOs, dout + b * dos.b + h * dos.h, dos.t, q0, T_len);
  fa_load_seg(segq, qseg + (long long)b * T_len, q0, T_len, FA_PAD_Q);
  // di = sum_c O[i, c] * dO[i, c] in f32, four lanes per row
  {
    const int r = tid >> 2, part = tid & 3, i = q0 + r;
    __syncthreads();  // dOs is loaded
    float acc = 0.f;
    if (i < T_len) {
      for (int c = part * (HD / 4); c < (part + 1) * (HD / 4); ++c)
        acc = fmaf(fa_ld(ob + i * os.t + c), dOs[r * LD + c], acc);
    }
    acc += __shfl_xor_sync(VX_FULL_MASK, acc, 1);
    acc += __shfl_xor_sync(VX_FULL_MASK, acc, 2);
    if (part == 0) {
      di_s[r] = acc;
      lse_s[r] = i < T_len ? lse[bh * T_len + i] : 0.f;
      if (i < T_len) di_out[bh * T_len + i] = acc;
    }
  }

  float dqa[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqa[a][j] = 0.f;
  const int kend = min(T_len, max(q0 + FA_TILE, P));
  for (int k0 = 0; k0 < kend; k0 += FA_TILE) {
    __syncthreads();
    fa_load_tile<T, HD>(Ks, kb, kvs.t, k0, T_len);
    fa_load_tile<T, HD>(Vs, vb, kvs.t, k0, T_len);
    fa_load_seg(segk, ksg, k0, T_len, FA_PAD_K);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qv[a] = Qs[(ty * 4 + a) * LD + d];
        dov[a] = dOs[(ty * 4 + a) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
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
        dSs[r * FA_PLD + c] = fa_round<T>(ds);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FA_TILE; ++kk) {
      float kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = dSs[(ty * 4 + a) * FA_PLD + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) dqa[a][j] = fmaf(ds, kv[j], dqa[a][j]);
      }
    }
  }
  T* dqb = dq + bh * T_len * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty * 4 + a;
    if (i >= T_len) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) fa_st(dqb + (long long)i * HD + tx + 16 * j, dqa[a][j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, FaStrides qs, const T* __restrict__ k,
                         const T* __restrict__ v, FaStrides kvs, const T* __restrict__ dout,
                         FaStrides dos, const int* __restrict__ qseg,
                         const int* __restrict__ kvseg, const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                         int H, int T_len, int P, float scale) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float fa_smem[];
  float* Ks = fa_smem;
  float* Vs = Ks + FA_TILE * LD;
  float* Qs = Vs + FA_TILE * LD;
  float* dOs = Qs + FA_TILE * LD;
  float* Pts = dOs + FA_TILE * LD;       // p transposed: [key][query]
  float* dSts = Pts + FA_TILE * FA_PLD;  // ds transposed: [key][query]
  int* segk = reinterpret_cast<int*>(dSts + FA_TILE * FA_PLD);
  int* segq = segk + FA_TILE;
  float* lse_s = reinterpret_cast<float*>(segq + FA_TILE);
  float* di_s = lse_s + FA_TILE;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const int* qsg = qseg + (long long)b * T_len;

  fa_load_tile<T, HD>(Ks, k + b * kvs.b + h * kvs.h, kvs.t, k0, T_len);
  fa_load_tile<T, HD>(Vs, v + b * kvs.b + h * kvs.h, kvs.t, k0, T_len);
  fa_load_seg(segk, kvseg + (long long)b * T_len, k0, T_len, FA_PAD_K);

  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[a][j] = dva[a][j] = 0.f;
  // rows below this tile see it only through the prefix (keys j < P)
  const int qstart = k0 < P ? 0 : k0;
  for (int q0 = qstart; q0 < T_len; q0 += FA_TILE) {
    __syncthreads();
    fa_load_tile<T, HD>(Qs, qb, qs.t, q0, T_len);
    fa_load_tile<T, HD>(dOs, dob, dos.t, q0, T_len);
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
    for (int d = 0; d < HD; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kv[a] = Ks[(ty * 4 + a) * LD + d];
        vv[a] = Vs[(ty * 4 + a) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * LD + d];
        dov[j] = dOs[(tx + 16 * j) * LD + d];
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
        Pts[kr * FA_PLD + c] = fa_round<T>(p);
        dSts[kr * FA_PLD + c] = fa_round<T>(ds);
      }
    }
    __syncthreads();
    // dV += p^T dO, dK += ds^T Q: key rows ty*4 + a, head columns tx + 16 j
#pragma unroll 4
    for (int i = 0; i < FA_TILE; ++i) {
      float dov[NJ], qv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dov[j] = dOs[i * LD + tx + 16 * j];
        qv[j] = Qs[i * LD + tx + 16 * j];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = Pts[(ty * 4 + a) * FA_PLD + i];
        const float ds = dSts[(ty * 4 + a) * FA_PLD + i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dva[a][j] = fmaf(p, dov[j], dva[a][j]);
          dka[a][j] = fmaf(ds, qv[j], dka[a][j]);
        }
      }
    }
  }
  T* dkb = dk + bh * T_len * HD;
  T* dvb = dv + bh * T_len * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty * 4 + a;
    if (j >= T_len) continue;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      fa_st(dkb + (long long)j * HD + tx + 16 * c, dka[a][c]);
      fa_st(dvb + (long long)j * HD + tx + 16 * c, dva[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores (wgmma, TMA, mbarrier; sm_90a).
//
// Replaces the JAX library's Pallas backward kernels
// (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dq, :1287, and _flash_attention_bwd_dkv, :941) for
// the bf16 calls of attention_core_flash (vallex_tpu/models/layers.py:205)
// and attention_core_flash_prefix (:259). Bound on the H100 at the training
// shapes (B = 4, H = 16, T = 1152, 29 M valid pairs at prefix 128): the
// bytes, ~0.017 ms each (q, k, v, O, dO read once, the gradients written
// once), ahead of the operations (6 * hd per valid pair for dQ, 8 * hd for
// dK/dV: 11.1 and 14.8 GFLOP, 0.011 and 0.015 ms at 989 TFLOP/s; at prefix
// T, 57 M pairs, the operations lead: 0.022 and 0.030 ms). What the design
// does about it:
//  - every product runs on the tensor cores, in the two wgmma forms of the
//    forward, with no transpose through shared memory: S = Q K^T, dP = dO V^T
//    (dQ kernel) and S^T = K Q^T, dP^T = V dO^T (dK/dV kernel) take both
//    operands K-major from shared memory; dQ += dS K, dV += P^T dO and
//    dK += dS^T Q take p or ds from registers (the f32 accumulator fragment
//    of keys / queries 16 kk..16 kk + 15, rounded to bf16 pairs, is the A
//    fragment of k-step kk) and B MN-major with the transpose bit. Computing
//    S^T and dP^T directly is what puts p^T and ds^T in that fragment;
//  - one warpgroup per block, as the forward: the dQ kernel per (query tile
//    of 64, head, row) holds S, dP and dQ (96 f32 registers a thread), the
//    dK/dV kernel per (key tile of 64, head, row) holds S^T, dP^T, dK and dV
//    (128);
//  - the tiles a block keeps (Q and dO, or K and V) come in once by TMA, the
//    other side's through a ring of FW_STAGES stages with mbarrier
//    completion, one thread refilling a stage once the warpgroup is done
//    with it; TMA's zero fill covers the ragged last tile;
//  - masked work is skipped as in the forward (fa_visit): the dQ kernel
//    visits the key tiles the forward visits, the dK/dV kernel the query
//    tiles from (k0 < P ? 0 : k0) on with the roles swapped; a tile without
//    an equal id is never loaded, a FULL one uses its scores unmasked; a key
//    tile no query tile reaches writes zeros;
//  - no atomics: dQ is summed per query tile, dK and dV per key tile, each in
//    the order of its tile list, so two runs are bitwise equal.
// ---------------------------------------------------------------------------

// p = exp(s * scale - lse) and ds = p (dp - di) scale for one pair in f32,
// 0 where the pair is masked; s arrives unscaled, lse2 = lse * log2(e).
// Leaves p in s and ds in dp.
__device__ __forceinline__ void fb_pds(float& s, float& dp, bool ok, float lse2, float di,
                                       float scale, float scale_log2) {
  const float p = ok ? exp2f(fmaf(s, scale_log2, -lse2)) : 0.f;
  dp = p * (dp - di) * scale;
  s = p;
}

// the 64 x 64 accumulator fragment as bf16 rows [t0, t0 + 64) of a
// contiguous [T, 64] slice, rows past T dropped
__device__ __forceinline__ void fb_store(__nv_bfloat16* dst, const float (&x)[32], int r0, int tq,
                                         int t0, int T_len) {
  const int i0 = t0 + r0, i1 = i0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    if (i0 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)i0 * FA_HD + c) =
          __floats2bfloat162_rn(x[4 * j], x[4 * j + 1]);
    if (i1 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)i1 * FA_HD + c) =
          __floats2bfloat162_rn(x[4 * j + 2], x[4 * j + 3]);
  }
}

// Shared memory of the dQ kernel: Q and dO tiles, FW_STAGES K and V tiles,
// the barriers (Q + dO, then one per stage), the query tile's segment ids and
// di, the count and list of key tiles to visit.
#define FB_DQ_SMEM_FIXED \
  (1024 + (2 + 2 * FW_STAGES) * FW_TILE_BYTES + 8 * (1 + FW_STAGES) + 8 * FA_TILE + 16)

__global__ void __launch_bounds__(FW_THREADS)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap, FaTmaPos qpos,
                           FaTmaPos kvpos, FaTmaPos dopos, const __nv_bfloat16* __restrict__ o,
                           FaStrides os, const __nv_bfloat16* __restrict__ dout, FaStrides dos,
                           const int* __restrict__ qseg, const int* __restrict__ kvseg,
                           const float* __restrict__ lse, float* __restrict__ di_out,
                           __nv_bfloat16* __restrict__ dq, int H, int T_len, int P, float scale) {
  extern __shared__ unsigned char fw_raw[];
  unsigned char* base = fw_raw + ((1024 - (fw_smem(fw_raw) & 1023)) & 1023);
  unsigned char* Qs = base;
  unsigned char* dOs = Qs + FW_TILE_BYTES;
  unsigned char* Ks = dOs + FW_TILE_BYTES;
  unsigned char* Vs = Ks + FW_STAGES * FW_TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + FW_STAGES * FW_TILE_BYTES);
  int* segq = reinterpret_cast<int*>(bars + 1 + FW_STAGES);
  float* di_s = reinterpret_cast<float*>(segq + FA_TILE);
  int* count = reinterpret_cast<int*>(di_s + FA_TILE);
  int* tiles = count + 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const int* qsg = qseg + (long long)b * T_len;
  const int* ksg = kvseg + (long long)b * T_len;
  const float scale_log2 = scale * 1.4426950408889634f;

  if (tid < FA_TILE) segq[tid] = q0 + tid < T_len ? qsg[q0 + tid] : FA_PAD_Q;
  if (tid == 0) {
    for (int i = 0; i < 1 + FW_STAGES; ++i) fw_bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // the query and dO tiles, once
    fw_bar_expect(bars, 2 * FW_TILE_BYTES);
    fw_tma_load(Qs, &qmap, bars, qpos, q0, h, b);
    fw_tma_load(dOs, &domap, bars, dopos, q0, h, b);
  }
  // di = sum_c O[i, c] dO[i, c] in f32 from O as stored, two threads a row
  // (16-byte loads: the wrapper checked the bases and strides)
  {
    const int r = tid >> 1, half = tid & 1, i = q0 + r;
    float acc = 0.f;
    if (i < T_len) {
      const uint4* op =
          reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + i * os.t) + 4 * half;
      const uint4* dp =
          reinterpret_cast<const uint4*>(dout + b * dos.b + h * dos.h + i * dos.t) + 4 * half;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float x[8], y[8];
        vx_bf16x8_to_f32(op[u], x);
        vx_bf16x8_to_f32(dp[u], y);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc = fmaf(x[c], y[c], acc);
      }
    }
    acc += __shfl_xor_sync(VX_FULL_MASK, acc, 1);
    if (half == 0) {
      di_s[r] = acc;
      if (i < T_len) di_out[bh * T_len + i] = acc;
    }
  }

  // the key tiles the forward visits (up to max(q0 + 64, P)), classified
  const int kend = min(T_len, max(q0 + FA_TILE, P));
  const int n = fa_visit(segq, true, q0, ksg, 0, (kend + FA_TILE - 1) / FA_TILE, T_len, P, tiles,
                         count);
  if (tid == 0) {
    for (int i = 0; i < min(n, FW_STAGES); ++i) {
      const int t0 = (tiles[i] >> 1) * FA_TILE;
      fw_bar_expect(bars + 1 + i, 2 * FW_TILE_BYTES);
      fw_tma_load(Ks + i * FW_TILE_BYTES, &kmap, bars + 1 + i, kvpos, t0, h, b);
      fw_tma_load(Vs + i * FW_TILE_BYTES, &vmap, bars + 1 + i, kvpos, t0, h, b);
    }
  }

  // this thread's query rows r0 and r0 + 8, key columns 8 j + 2 tq + {0, 1}
  const int r0 = warp * 16 + (lane >> 2), tq = lane & 3;
  const int seg0 = segq[r0], seg1 = segq[r0 + 8];
  const int i0 = q0 + r0, i1 = i0 + 8;
  const int lim0 = max(i0, P - 1), lim1 = max(i1, P - 1);
  const float lse0 = i0 < T_len ? lse[bh * T_len + i0] * 1.4426950408889634f : 0.f;
  const float lse1 = i1 < T_len ? lse[bh * T_len + i1] * 1.4426950408889634f : 0.f;
  const float di0 = di_s[r0], di1 = di_s[r0 + 8];
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const uint32_t q_addr = fw_smem(Qs), do_addr = fw_smem(dOs);
  fw_bar_wait(bars, 0);  // (also when no tile is visited: the loads must land first)
  for (int it = 0; it < n; ++it) {
    const int stage = it % FW_STAGES;
    const int e = tiles[it], k0 = (e >> 1) * FA_TILE;
    const uint32_t k_addr = fw_smem(Ks + stage * FW_TILE_BYTES);
    const uint32_t v_addr = fw_smem(Vs + stage * FW_TILE_BYTES);
    fw_bar_wait(bars + 1 + stage, (it / FW_STAGES) & 1);

    // S = Q K^T and dP = dO V^T, f32
    float s[32], dp[32];
    fw_fence();
    fw_mma_kk(s, q_addr, k_addr);
    fw_mma_kk(dp, do_addr, v_addr);
    fw_commit();
    fw_wait_all();
    fw_hold(s);
    fw_hold(dp);

    // p and ds, 0 on the masked pairs of a MASKED tile
    const bool masked = e & FW_MASKED;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = k0 + 8 * j + 2 * tq + x;
        const int sk = masked && col < T_len ? ksg[col] : FA_PAD_K;
        fb_pds(s[4 * j + x], dp[4 * j + x], !masked || (sk == seg0 && col <= lim0), lse0, di0,
               scale, scale_log2);
        fb_pds(s[4 * j + 2 + x], dp[4 * j + 2 + x], !masked || (sk == seg1 && col <= lim1), lse1,
               di1, scale, scale_log2);
      }

    // dQ += dS K: ds rounded to bf16 as the A operand, K MN-major
    uint32_t da[4][4];
    fw_frag(da, dp);
    fw_hold(acc);
    fw_fence();
    fw_mma_rk(acc, da, k_addr);
    fw_commit();
    fw_wait_all();
    fw_hold(acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && it + FW_STAGES < n) {
      const int t0 = (tiles[it + FW_STAGES] >> 1) * FA_TILE;
      fw_bar_expect(bars + 1 + stage, 2 * FW_TILE_BYTES);
      fw_tma_load(Ks + stage * FW_TILE_BYTES, &kmap, bars + 1 + stage, kvpos, t0, h, b);
      fw_tma_load(Vs + stage * FW_TILE_BYTES, &vmap, bars + 1 + stage, kvpos, t0, h, b);
    }
  }
  fb_store(dq + bh * T_len * FA_HD, acc, r0, tq, q0, T_len);
}

// Shared memory of the dK/dV kernel: K and V tiles, FW_STAGES Q and dO
// tiles, the barriers (K + V, then one per stage), the key tile's segment
// ids, the count, two buffers of a query tile's segment ids, lse (log2
// units) and di, and the list of query tiles to visit.
#define FB_DKV_SMEM_FIXED                                                                  \
  (1024 + (2 + 2 * FW_STAGES) * FW_TILE_BYTES + 8 * (1 + FW_STAGES) + 4 * FA_TILE + 16 + \
   2 * 3 * 4 * FA_TILE)

__global__ void __launch_bounds__(FW_THREADS)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap, FaTmaPos qpos,
                            FaTmaPos kvpos, FaTmaPos dopos, const int* __restrict__ qseg,
                            const int* __restrict__ kvseg, const float* __restrict__ lse,
                            const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int H, int T_len, int P,
                            float scale) {
  extern __shared__ unsigned char fw_raw[];
  unsigned char* base = fw_raw + ((1024 - (fw_smem(fw_raw) & 1023)) & 1023);
  unsigned char* Ks = base;
  unsigned char* Vs = Ks + FW_TILE_BYTES;
  unsigned char* Qs = Vs + FW_TILE_BYTES;
  unsigned char* dOs = Qs + FW_STAGES * FW_TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dOs + FW_STAGES * FW_TILE_BYTES);
  int* segk = reinterpret_cast<int*>(bars + 1 + FW_STAGES);
  int* count = segk + FA_TILE;
  int* cseg = count + 4;                                       // [2][64]
  float* clse = reinterpret_cast<float*>(cseg + 2 * FA_TILE);  // [2][64]
  float* cdi = clse + 2 * FA_TILE;                             // [2][64]
  int* tiles = reinterpret_cast<int*>(cdi + 2 * FA_TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const int* qsg = qseg + (long long)b * T_len;
  const int* ksg = kvseg + (long long)b * T_len;
  const float scale_log2 = scale * 1.4426950408889634f;

  if (tid < FA_TILE) segk[tid] = k0 + tid < T_len ? ksg[k0 + tid] : FA_PAD_K;
  if (tid == 0) {
    for (int i = 0; i < 1 + FW_STAGES; ++i) fw_bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // the key and value tiles, once
    fw_bar_expect(bars, 2 * FW_TILE_BYTES);
    fw_tma_load(Ks, &kmap, bars, kvpos, k0, h, b);
    fw_tma_load(Vs, &vmap, bars, kvpos, k0, h, b);
  }

  // the query tiles that can see this key tile (rows below it only through
  // the prefix, keys j < P), classified
  const int nq = (T_len + FA_TILE - 1) / FA_TILE;
  const int n =
      fa_visit(segk, false, k0, qsg, k0 < P ? 0 : k0 / FA_TILE, nq, T_len, P, tiles, count);
  if (tid == 0) {
    for (int i = 0; i < min(n, FW_STAGES); ++i) {
      const int t0 = (tiles[i] >> 1) * FA_TILE;
      fw_bar_expect(bars + 1 + i, 2 * FW_TILE_BYTES);
      fw_tma_load(Qs + i * FW_TILE_BYTES, &qmap, bars + 1 + i, qpos, t0, h, b);
      fw_tma_load(dOs + i * FW_TILE_BYTES, &domap, bars + 1 + i, dopos, t0, h, b);
    }
  }
  // a query tile's ids, lse and di into buffer buf (threads 0..63)
  auto load_cols = [&](int buf, int q0) {
    const int i = q0 + tid;
    const bool in = i < T_len;
    cseg[buf * FA_TILE + tid] = in ? qsg[i] : FA_PAD_Q;
    clse[buf * FA_TILE + tid] = in ? lse[bh * T_len + i] * 1.4426950408889634f : 0.f;
    cdi[buf * FA_TILE + tid] = in ? di[bh * T_len + i] : 0.f;
  };
  if (tid < FA_TILE && n > 0) load_cols(0, (tiles[0] >> 1) * FA_TILE);
  __syncthreads();

  // this thread's key rows r0 and r0 + 8, query columns 8 j + 2 tq + {0, 1}
  const int r0 = warp * 16 + (lane >> 2), tq = lane & 3;
  const int sk0 = segk[r0], sk1 = segk[r0 + 8];
  const int j0 = k0 + r0, j1 = j0 + 8;
  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

  const uint32_t k_addr = fw_smem(Ks), v_addr = fw_smem(Vs);
  fw_bar_wait(bars, 0);  // (also when no tile is visited: the loads must land first)
  for (int it = 0; it < n; ++it) {
    const int stage = it % FW_STAGES, buf = it & 1;
    const int e = tiles[it], q0 = (e >> 1) * FA_TILE;
    const uint32_t q_addr = fw_smem(Qs + stage * FW_TILE_BYTES);
    const uint32_t do_addr = fw_smem(dOs + stage * FW_TILE_BYTES);
    fw_bar_wait(bars + 1 + stage, (it / FW_STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, f32; the next tile's columns load
    // meanwhile (their buffer was last read before the previous barrier)
    float st[32], dpt[32];
    fw_fence();
    fw_mma_kk(st, k_addr, q_addr);
    fw_mma_kk(dpt, v_addr, do_addr);
    fw_commit();
    if (tid < FA_TILE && it + 1 < n) load_cols(buf ^ 1, (tiles[it + 1] >> 1) * FA_TILE);
    fw_wait_all();
    fw_hold(st);
    fw_hold(dpt);

    // p^T and ds^T, 0 on the masked pairs of a MASKED tile
    const bool masked = e & FW_MASKED;
    const int* cs = cseg + buf * FA_TILE;
    const float* cl = clse + buf * FA_TILE;
    const float* cd = cdi + buf * FA_TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int c = 8 * j + 2 * tq + x, lim = max(q0 + c, P - 1), sq = cs[c];
        fb_pds(st[4 * j + x], dpt[4 * j + x], !masked || (sq == sk0 && j0 <= lim), cl[c], cd[c],
               scale, scale_log2);
        fb_pds(st[4 * j + 2 + x], dpt[4 * j + 2 + x], !masked || (sq == sk1 && j1 <= lim), cl[c],
               cd[c], scale, scale_log2);
      }

    // dV += P^T dO and dK += dS^T Q: p and ds rounded to bf16 as the A
    // operands, dO and Q MN-major
    uint32_t pa[4][4], da[4][4];
    fw_frag(pa, st);
    fw_frag(da, dpt);
    fw_hold(dva);
    fw_hold(dka);
    fw_fence();
    fw_mma_rk(dva, pa, do_addr);
    fw_mma_rk(dka, da, q_addr);
    fw_commit();
    fw_wait_all();
    fw_hold(dva);
    fw_hold(dka);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && it + FW_STAGES < n) {
      const int t0 = (tiles[it + FW_STAGES] >> 1) * FA_TILE;
      fw_bar_expect(bars + 1 + stage, 2 * FW_TILE_BYTES);
      fw_tma_load(Qs + stage * FW_TILE_BYTES, &qmap, bars + 1 + stage, qpos, t0, h, b);
      fw_tma_load(dOs + stage * FW_TILE_BYTES, &domap, bars + 1 + stage, dopos, t0, h, b);
    }
  }
  fb_store(dk + bh * T_len * FA_HD, dka, r0, tq, k0, T_len);
  fb_store(dv + bh * T_len * FA_HD, dva, r0, tq, k0, T_len);
}

// ---------------------------------------------------------------------------
// Launchers. Strides arrive as three long longs (b, h, t) in elements; the
// last stride is 1. Gradients and lse / di are contiguous [B, H, T(, hd)].
// kind 0: f32, kind 1: bf16 (q, k, v, O, dO and the gradients alike); hd 64
// or 128. Each launcher picks its kernel by (kind, hd): bf16 at hd 64 on the
// tensor cores, bf16 at hd 128 and f32 on the CUDA cores; neither stands in
// for the other.
// ---------------------------------------------------------------------------

static FaStrides fa_strides(const long long* s) { return FaStrides{s[0], s[1], s[2]}; }

// the CUDA-core kernels' dynamic shared memory: f32 tiles of [64][hd + 1]
// (q, k, v, dO as each kernel needs them) and of [64][65] (p, ds), the
// segment ids, lse and di of a tile
static size_t fa_core_smem(int hd, int hd_tiles, int p_tiles) {
  return ((size_t)hd_tiles * FA_TILE * (hd + 1) + (size_t)p_tiles * FA_TILE * FA_PLD) *
             sizeof(float) +
         4 * FA_TILE * sizeof(int);
}

template <typename K>
static cudaError_t fa_allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static bool fa_shape_ok(int kind, int hd, int B, int H, int T_len) {
  return (kind == 0 || kind == 1) && (hd == 64 || hd == 128) && B >= 1 && B <= 65535 &&
         H >= 1 && H <= 65535 && T_len >= 1;
}

template <typename T, int HD>
static cudaError_t fa_fwd_core(const void* q, const long long* qs, const void* k, const void* v,
                               const long long* kvs, const int* qseg, const int* kvseg, void* o,
                               const long long* os, float* lse, int B, int H, int T_len, int P,
                               float scale, cudaStream_t s) {
  const size_t smem = fa_core_smem(HD, 3, 1);
  cudaError_t e = fa_allow_smem(flash_fwd_kernel<T, HD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + FA_TILE - 1) / FA_TILE, H, B);
  flash_fwd_kernel<T, HD><<<grid, FA_THREADS, smem, s>>>(
      reinterpret_cast<const T*>(q), fa_strides(qs), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), fa_strides(kvs), qseg, kvseg, reinterpret_cast<T*>(o),
      fa_strides(os), lse, H, T_len, P, scale);
  return cudaGetLastError();
}

typedef CUresult (*FaEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
static FaEncodeTiled fa_encoder() {
  static FaEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<FaEncodeTiled>(p);
  }
  return fn;
}

// A 4-d tensor map over a bf16 [B, H, T, 64] view with element strides st
// (b, h, t) and a unit head-dim stride: the outer dims ordered by stride (a
// dim of size 1 last, its stride then immaterial), a box of 64 rows of t by
// the 64 head-dim values, 128-byte swizzle, zeros past T. pos gets each
// dim's coordinate slot. The caller checked the 16-byte alignment of the
// base and of each stride.
static CUresult fa_tensor_map(CUtensorMap* map, FaTmaPos* pos, const void* base,
                              const long long* st, int B, int H, int T_len) {
  struct Dim {
    long long stride, size;
    int which;  // 0: t, 1: h, 2: b
  } d[3] = {{st[2], T_len, 0}, {st[1], H, 1}, {st[0], B, 2}};
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j + 1 < 3 - i; ++j) {
      const long long a = d[j].size == 1 ? LLONG_MAX : d[j].stride;
      const long long c = d[j + 1].size == 1 ? LLONG_MAX : d[j + 1].stride;
      if (a > c) {
        const Dim t = d[j];
        d[j] = d[j + 1];
        d[j + 1] = t;
      }
    }
  cuuint64_t dims[4] = {FA_HD, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {FA_HD, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  long long span = FA_HD * 2;  // bytes the dims so far cover
  for (int i = 0; i < 3; ++i) {
    const long long bytes = d[i].size == 1 ? span : d[i].stride * 2;
    dims[i + 1] = (cuuint64_t)d[i].size;
    strides[i] = (cuuint64_t)bytes;
    span = bytes * d[i].size;
    if (d[i].which == 0) {
      box[i + 1] = FA_TILE;
      pos->t = i + 1;
    } else if (d[i].which == 1) {
      pos->h = i + 1;
    } else {
      pos->b = i + 1;
    }
  }
  FaEncodeTiled enc = fa_encoder();
  if (enc == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

static size_t fa_fwd_tc_smem(int T_len) {
  return FW_SMEM_FIXED + (size_t)((T_len + FA_TILE - 1) / FA_TILE) * sizeof(int);
}

// the bf16 forward on the tensor cores; a refused tensor map returns
// 1000 + its CUresult
static int fa_fwd_tc(const void* q, const long long* qs, const void* k, const void* v,
                     const long long* kvs, const int* qseg, const int* kvseg, void* o,
                     const long long* os, float* lse, int B, int H, int T_len, int P, float scale,
                     cudaStream_t s) {
  CUtensorMap qm, km, vm;
  FaTmaPos qp, kvp;
  CUresult r = fa_tensor_map(&qm, &qp, q, qs, B, H, T_len);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(&km, &kvp, k, kvs, B, H, T_len);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(&vm, &kvp, v, kvs, B, H, T_len);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const int nq = (T_len + FA_TILE - 1) / FA_TILE;
  const size_t smem = fa_fwd_tc_smem(T_len);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = fa_allow_smem(flash_fwd_tc_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_tc_kernel<<<dim3(nq, H, B), FW_THREADS, smem, s>>>(
      qm, km, vm, qp, kvp, qseg, kvseg, reinterpret_cast<__nv_bfloat16*>(o), fa_strides(os), lse,
      H, T_len, P, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

static size_t fa_bwd_dq_tc_smem(int T_len) {
  return FB_DQ_SMEM_FIXED + (size_t)((T_len + FA_TILE - 1) / FA_TILE) * sizeof(int);
}
static size_t fa_bwd_dkv_tc_smem(int T_len) {
  return FB_DKV_SMEM_FIXED + (size_t)((T_len + FA_TILE - 1) / FA_TILE) * sizeof(int);
}

// the tensor maps of q, k, v and dO for the bf16 backward; 1000 + its
// CUresult when one is refused, else 0
static int fa_bwd_maps(CUtensorMap* m, FaTmaPos* pos, const void* q, const long long* qs,
                       const void* k, const void* v, const long long* kvs, const void* dout,
                       const long long* dos, int B, int H, int T_len) {
  CUresult r = fa_tensor_map(m, pos, q, qs, B, H, T_len);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(m + 1, pos + 1, k, kvs, B, H, T_len);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(m + 2, pos + 1, v, kvs, B, H, T_len);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(m + 3, pos + 2, dout, dos, B, H, T_len);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// the bf16 dQ kernel on the tensor cores
static int fa_bwd_dq_tc(const void* q, const long long* qs, const void* k, const void* v,
                        const long long* kvs, const void* o, const long long* os, const void* dout,
                        const long long* dos, const int* qseg, const int* kvseg, const float* lse,
                        float* di, void* dq, int B, int H, int T_len, int P, float scale,
                        cudaStream_t s) {
  CUtensorMap m[4];
  FaTmaPos pos[3];
  const int rc = fa_bwd_maps(m, pos, q, qs, k, v, kvs, dout, dos, B, H, T_len);
  if (rc != 0) return rc;
  const size_t smem = fa_bwd_dq_tc_smem(T_len);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = fa_allow_smem(flash_bwd_dq_tc_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_tc_kernel<<<dim3((T_len + FA_TILE - 1) / FA_TILE, H, B), FW_THREADS, smem, s>>>(
      m[0], m[1], m[2], m[3], pos[0], pos[1], pos[2],
      reinterpret_cast<const __nv_bfloat16*>(o), fa_strides(os),
      reinterpret_cast<const __nv_bfloat16*>(dout), fa_strides(dos), qseg, kvseg, lse, di,
      reinterpret_cast<__nv_bfloat16*>(dq), H, T_len, P, scale);
  return (int)cudaGetLastError();
}

// the bf16 dK/dV kernel on the tensor cores
static int fa_bwd_dkv_tc(const void* q, const long long* qs, const void* k, const void* v,
                         const long long* kvs, const void* dout, const long long* dos,
                         const int* qseg, const int* kvseg, const float* lse, const float* di,
                         void* dk, void* dv, int B, int H, int T_len, int P, float scale,
                         cudaStream_t s) {
  CUtensorMap m[4];
  FaTmaPos pos[3];
  const int rc = fa_bwd_maps(m, pos, q, qs, k, v, kvs, dout, dos, B, H, T_len);
  if (rc != 0) return rc;
  const size_t smem = fa_bwd_dkv_tc_smem(T_len);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = fa_allow_smem(flash_bwd_dkv_tc_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_tc_kernel<<<dim3((T_len + FA_TILE - 1) / FA_TILE, H, B), FW_THREADS, smem, s>>>(
      m[0], m[1], m[2], m[3], pos[0], pos[1], pos[2], qseg, kvseg, lse, di,
      reinterpret_cast<__nv_bfloat16*>(dk), reinterpret_cast<__nv_bfloat16*>(dv), H, T_len, P,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
static cudaError_t fa_bwd_dq_core(const void* q, const long long* qs, const void* k,
                                  const void* v, const long long* kvs, const void* o,
                                  const long long* os, const void* dout, const long long* dos,
                                  const int* qseg, const int* kvseg, const float* lse, float* di,
                                  void* dq, int B, int H, int T_len, int P, float scale,
                                  cudaStream_t s) {
  const size_t smem = fa_core_smem(HD, 4, 1);
  cudaError_t e = fa_allow_smem(flash_bwd_dq_kernel<T, HD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + FA_TILE - 1) / FA_TILE, H, B);
  flash_bwd_dq_kernel<T, HD><<<grid, FA_THREADS, smem, s>>>(
      reinterpret_cast<const T*>(q), fa_strides(qs), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), fa_strides(kvs), reinterpret_cast<const T*>(o),
      fa_strides(os), reinterpret_cast<const T*>(dout), fa_strides(dos), qseg, kvseg, lse, di,
      reinterpret_cast<T*>(dq), H, T_len, P, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
static cudaError_t fa_bwd_dkv_core(const void* q, const long long* qs, const void* k,
                                   const void* v, const long long* kvs, const void* dout,
                                   const long long* dos, const int* qseg, const int* kvseg,
                                   const float* lse, const float* di, void* dk, void* dv, int B,
                                   int H, int T_len, int P, float scale, cudaStream_t s) {
  const size_t smem = fa_core_smem(HD, 4, 2);
  cudaError_t e = fa_allow_smem(flash_bwd_dkv_kernel<T, HD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + FA_TILE - 1) / FA_TILE, H, B);
  flash_bwd_dkv_kernel<T, HD><<<grid, FA_THREADS, smem, s>>>(
      reinterpret_cast<const T*>(q), fa_strides(qs), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), fa_strides(kvs), reinterpret_cast<const T*>(dout),
      fa_strides(dos), qseg, kvseg, lse, di, reinterpret_cast<T*>(dk), reinterpret_cast<T*>(dv),
      H, T_len, P, scale);
  return cudaGetLastError();
}

extern "C" int vx_flash_attention_fwd(const void* q, const long long* qs, const void* k,
                                      const void* v, const long long* kvs, const void* qseg,
                                      const void* kvseg, void* o, const long long* os,
                                      void* lse, int kind, int hd, int B, int H, int T_len, int P,
                                      float scale, void* stream) {
  if (!fa_shape_ok(kind, hd, B, H, T_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* qsg = reinterpret_cast<const int*>(qseg);
  const int* ksg = reinterpret_cast<const int*>(kvseg);
  float* l = reinterpret_cast<float*>(lse);
  if (kind == 1 && hd == 64)
    return fa_fwd_tc(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H, T_len, P, scale, s);
  if (kind == 1)
    return (int)fa_fwd_core<__nv_bfloat16, 128>(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H,
                                                 T_len, P, scale, s);
  if (hd == 64)
    return (int)fa_fwd_core<float, 64>(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H, T_len, P,
                                       scale, s);
  return (int)fa_fwd_core<float, 128>(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H, T_len, P,
                                      scale, s);
}

// the bf16 kernels' dynamic shared memory per block at this T, in bytes
extern "C" int vx_flash_attention_fwd_smem(int T_len) { return (int)fa_fwd_tc_smem(T_len); }
extern "C" int vx_flash_attention_bwd_smem(int T_len, int dkv) {
  return (int)(dkv ? fa_bwd_dkv_tc_smem(T_len) : fa_bwd_dq_tc_smem(T_len));
}

extern "C" int vx_flash_attention_bwd_dq(const void* q, const long long* qs, const void* k,
                                         const void* v, const long long* kvs, const void* o,
                                         const long long* os, const void* dout,
                                         const long long* dos, const void* qseg,
                                         const void* kvseg, const void* lse, void* di, void* dq,
                                         int kind, int hd, int B, int H, int T_len, int P,
                                         float scale, void* stream) {
  if (!fa_shape_ok(kind, hd, B, H, T_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* qsg = reinterpret_cast<const int*>(qseg);
  const int* ksg = reinterpret_cast<const int*>(kvseg);
  const float* l = reinterpret_cast<const float*>(lse);
  float* d = reinterpret_cast<float*>(di);
  if (kind == 1 && hd == 64)
    return fa_bwd_dq_tc(q, qs, k, v, kvs, o, os, dout, dos, qsg, ksg, l, d, dq, B, H, T_len, P,
                        scale, s);
  if (kind == 1)
    return (int)fa_bwd_dq_core<__nv_bfloat16, 128>(q, qs, k, v, kvs, o, os, dout, dos, qsg, ksg,
                                                    l, d, dq, B, H, T_len, P, scale, s);
  if (hd == 64)
    return (int)fa_bwd_dq_core<float, 64>(q, qs, k, v, kvs, o, os, dout, dos, qsg, ksg, l, d, dq,
                                          B, H, T_len, P, scale, s);
  return (int)fa_bwd_dq_core<float, 128>(q, qs, k, v, kvs, o, os, dout, dos, qsg, ksg, l, d, dq,
                                         B, H, T_len, P, scale, s);
}

extern "C" int vx_flash_attention_bwd_dkv(const void* q, const long long* qs, const void* k,
                                          const void* v, const long long* kvs, const void* dout,
                                          const long long* dos, const void* qseg,
                                          const void* kvseg, const void* lse, const void* di,
                                          void* dk, void* dv, int kind, int hd, int B, int H,
                                          int T_len, int P, float scale, void* stream) {
  if (!fa_shape_ok(kind, hd, B, H, T_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* qsg = reinterpret_cast<const int*>(qseg);
  const int* ksg = reinterpret_cast<const int*>(kvseg);
  const float* l = reinterpret_cast<const float*>(lse);
  const float* d = reinterpret_cast<const float*>(di);
  if (kind == 1 && hd == 64)
    return fa_bwd_dkv_tc(q, qs, k, v, kvs, dout, dos, qsg, ksg, l, d, dk, dv, B, H, T_len, P,
                         scale, s);
  if (kind == 1)
    return (int)fa_bwd_dkv_core<__nv_bfloat16, 128>(q, qs, k, v, kvs, dout, dos, qsg, ksg, l, d,
                                                     dk, dv, B, H, T_len, P, scale, s);
  if (hd == 64)
    return (int)fa_bwd_dkv_core<float, 64>(q, qs, k, v, kvs, dout, dos, qsg, ksg, l, d, dk, dv, B,
                                           H, T_len, P, scale, s);
  return (int)fa_bwd_dkv_core<float, 128>(q, qs, k, v, kvs, dout, dos, qsg, ksg, l, d, dk, dv, B,
                                          H, T_len, P, scale, s);
}
