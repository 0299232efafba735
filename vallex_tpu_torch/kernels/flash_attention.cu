// flash_attention: full-sequence attention of VALL-E X for head_dim 64, with
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
// Kernels:
//   flash_fwd_tc_kernel (bf16): the forward on the tensor cores, below;
//   flash_fwd_kernel<float> (f32): the forward on the CUDA cores (tensor
//       cores in f32 would be TF32, which changes the f32 numbers), one block
//       of 256 threads per (query tile of 64, head, row); f32 tiles in shared
//       memory (row stride 65, so a half-warp reading 16 rows hits 16 banks),
//       each thread a 4 x 4 tile of the 64 x 64 scores;
//   flash_bwd_dq_kernel: per query tile, di = sum(O * dO) in f32 from O as
//       stored (written out for the dK/dV kernel), then dQ over the key tiles;
//   flash_bwd_dkv_kernel: per key tile, dK and dV over the query tiles that
//       can see it (all of them when the tile starts below P, else from the
//       tile's own row on). It runs after the dQ kernel on the same stream
//       and reads its di.
// Both forwards write O in the input type and the row log-sum-exp (f32) for
// the backward, which runs on the CUDA cores (the f32 layout above) in both
// types. Neither backward kernel uses atomics: each output element is one
// block's sum in a fixed order, so the gradients are the same from run to run.
// Rounding follows the library: scores in f32 (q.k, then times the scale),
// p cast to V's type before P.V, p and ds cast to the input type before
// their products in the backward, every product summed in f32.
// Rows without a valid key give O = 0, lse = 0 and zero gradients.
//
// Bound on the H100: operations, 4 * hd per valid (query, key) pair forward
// (bf16 at 989 TFLOP/s) and 10 * hd backward. The bf16 forward's design for
// that bound:
//  - one block of one warpgroup (128 threads) per (query tile of 64, head,
//    row); S = Q K^T by wgmma m64n64k16, bf16 in, f32 out, with Q (loaded
//    once) and the key tile in shared memory, both K-major: a row of 64 bf16
//    is exactly one 128-byte line, so TMA's 128-byte swizzle and the wgmma
//    descriptor's agree and the reads are free of bank conflicts;
//  - the online softmax runs on the S accumulator in registers (a row's max
//    across the 4 threads that hold it; each thread keeps its own partial
//    sum), O is rescaled in registers;
//  - O += P V by wgmma with P as the register A operand: the f32 S fragment,
//    rounded to bf16 pairs, is m64nNk16's A fragment; V is stored head-dim
//    contiguous, so it is MN-major, read with the transpose bit for B;
//  - K/V tiles come through a ring of 2 stages in shared memory, loaded by
//    TMA (4-d tensor maps over the strided [B, H, T, 64] views, built on the
//    host, passed as __grid_constant__) with mbarrier completion; one thread
//    refills a stage once the warpgroup is done with it. TMA's zero fill
//    covers the ragged last tile;
//  - work that is all masked is skipped: the key loop ends at
//    max(q0 + 64, P), and a block first classifies its key tiles from the
//    segment ids by a vote: a tile with no pair of equal ids adds exactly 0
//    to every row and is never loaded (the NAR's padding in the middle and
//    at the end of a row); a tile whose pairs all have one id and lie inside
//    the causal bound and T uses its scores as they are; only the rest are
//    masked pair by pair.
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)
#include <limits.h>
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

  // Classify the key tiles this tile can see (up to max(q0 + 64, P)), one
  // warp per tile: FULL when every pair has equal ids and no pair is cut by
  // the causal bound or T; skipped when no query id equals a key id (such a
  // tile adds exactly 0 to every row); else MASKED, pair by pair.
  const int kend = min(T_len, max(q0 + FA_TILE, P));
  const int nk = (kend + FA_TILE - 1) / FA_TILE;
  int qmin, qmax;
  {
    const int a = segq[lane], c = segq[lane + 32];
    const bool ia = q0 + lane < T_len, ic = q0 + lane + 32 < T_len;
    qmin = min(ia ? a : INT_MAX, ic ? c : INT_MAX);
    qmax = max(ia ? a : INT_MIN, ic ? c : INT_MIN);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(VX_FULL_MASK, qmin, s));
      qmax = max(qmax, __shfl_xor_sync(VX_FULL_MASK, qmax, s));
    }
  }
  const bool q_whole = q0 + FA_TILE <= T_len && qmin == qmax;
  const int bound_lo = max(q0, P - 1);  // the least max(i, P - 1) of the tile's rows
  for (int t = warp; t < nk; t += FW_THREADS / 32) {
    const int k0 = t * FA_TILE;
    const bool ia = k0 + lane < T_len, ic = k0 + lane + 32 < T_len;
    const int ka = ia ? ksg[k0 + lane] : FA_PAD_K, kc = ic ? ksg[k0 + lane + 32] : FA_PAD_K;
    int kmin = min(ia ? ka : INT_MAX, ic ? kc : INT_MAX);
    int kmax = max(ia ? ka : INT_MIN, ic ? kc : INT_MIN);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(VX_FULL_MASK, kmin, s));
      kmax = max(kmax, __shfl_xor_sync(VX_FULL_MASK, kmax, s));
    }
    int cls = -1;  // skipped
    if (kmax < qmin || kmin > qmax) {
      cls = -1;
    } else if (q_whole && kmin == kmax && kmin == qmin && k0 + FA_TILE <= T_len &&
               k0 + FA_TILE - 1 <= bound_lo) {
      cls = FW_FULL;
    } else {
      bool hit = false;  // the vote: any query id equal to one of this lane's key ids
      for (int r = 0; r < FA_TILE; ++r) {
        const int sq = segq[r];
        hit |= (sq == ka) | (sq == kc);
      }
      cls = __any_sync(VX_FULL_MASK, hit) ? FW_MASKED : -1;
    }
    if (lane == 0) tiles[t] = cls;
  }
  __syncthreads();
  if (tid == 0) {  // the visited tiles, in order, as (tile << 1 | class)
    int n = 0;
    for (int t = 0; t < nk; ++t)
      if (tiles[t] >= 0) tiles[n++] = (t << 1) | tiles[t];
    *count = n;
    for (int i = 0; i < min(n, FW_STAGES); ++i) {
      fw_bar_expect(bars + 1 + i, 2 * FW_TILE_BYTES);
      fw_tma_load(Ks + i * FW_TILE_BYTES, &kmap, bars + 1 + i, kvpos, (tiles[i] >> 1) * FA_TILE, h, b);
      fw_tma_load(Vs + i * FW_TILE_BYTES, &vmap, bars + 1 + i, kvpos, (tiles[i] >> 1) * FA_TILE, h, b);
    }
  }
  __syncthreads();
  const int n = *count;

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

    // S = Q K^T, f32: four k-steps of 16 along the head dim (32 bytes
    // further into each 128-byte swizzled row)
    float s[32];
    fw_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      fw_mma_ss(s, fw_desc(q_addr + 32 * kk, 16, 1024), fw_desc(k_addr + 32 * kk, 16, 1024), kk);
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

    // O += P V: p rounded to bf16 (the S fragment of keys 16 kk..16 kk + 15
    // is the A fragment of k-step kk); V's k-step kk is 16 rows further on
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = fw_pack(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = fw_pack(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = fw_pack(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = fw_pack(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fw_hold(acc);
    fw_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      fw_mma_rs(acc, pa[kk], fw_desc(v_addr + 2048 * kk, 8192, 1024));
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
// kind 0: f32, kind 1: bf16 (q, k, v, O, dO and the gradients alike). The
// forward picks its kernel by kind: bf16 on the tensor cores, f32 on the
// CUDA cores; neither stands in for the other.
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

static cudaError_t fa_fwd_f32(const void* q, const long long* qs, const void* k, const void* v,
                              const long long* kvs, const int* qseg, const int* kvseg, void* o,
                              const long long* os, float* lse, int B, int H, int T_len, int P,
                              float scale, cudaStream_t s) {
  cudaError_t e = fa_allow_smem(flash_fwd_kernel<float>, FA_FWD_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + FA_TILE - 1) / FA_TILE, H, B);
  flash_fwd_kernel<float><<<grid, FA_THREADS, FA_FWD_SMEM, s>>>(
      reinterpret_cast<const float*>(q), fa_strides(qs), reinterpret_cast<const float*>(k),
      reinterpret_cast<const float*>(v), fa_strides(kvs), qseg, kvseg, reinterpret_cast<float*>(o),
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
    return (int)fa_fwd_f32(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H, T_len, P, scale, s);
  return fa_fwd_tc(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H, T_len, P, scale, s);
}

// the bf16 forward's dynamic shared memory per block at this T, in bytes
extern "C" int vx_flash_attention_fwd_smem(int T_len) { return (int)fa_fwd_tc_smem(T_len); }

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
