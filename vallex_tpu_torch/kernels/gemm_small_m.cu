// gemm_small_m: Y[M, N] = epilogue(prologue(X)[M, K] . W[N, K]^T) for the
// few rows of a decode step.
//
// Replaces the matrix products inside two TPU kernels:
//   vallex_tpu/ops/decode_block.py  decode_block_fused (_kernel: `mat`, `_ffn`,
//                                   the fused head) -- the K-1 int8 draft steps,
//                                   the int8 serving blocks, and batched
//                                   requests (and their best_of samples) at
//                                   M = R * beams rows;
//   vallex_tpu/ops/decode_verify.py decode_verify (_kernel) -- the verify
//                                   pass over K = decode_steps positions.
// Each product there is LN -> matvec (QKV), matvec + residual (out-proj),
// LN -> matvec + bias -> ReLU (FFN1), matvec + bias + residual (FFN2) or
// LN -> matvec (head) on M rows of f32 hidden state. The W8A8 kind carries
// the same products of decode_block_fused(act_quant=True) and
// decode_step(act_quant=True) (the TPU kernels' `qmat`,
// vallex_tpu/ops/decode_block.py:160-165, decode_step.py:124-132).
//
// Bound on the H100: weight bytes. At M <= 24 every weight byte is used for
// at most 24 multiply-adds, far below the ~295 operations per byte where the
// tensor cores would become the limit, so a product is a weight stream; at
// 2-8 MB per product, what it costs beyond the bytes is its fixed time (the
// launch, the prologue, the ramp of the stream).
//
// Design (bf16, int8 W8A16 and W8A8 kinds):
// * The prologue runs once per product. A LayerNorm prologue, and every W8A8
//   product, first launches gemm_prep_kernel (one block per activation row,
//   256 threads, 1024 for rows longer than 2048) that holds the row in
//   shared memory and writes its activations to scratch: bf16 for bf16 and int8
//   weights (as the TPU kernel casts them before its MXU product), f32 for
//   f32 weights, or int8 codes with the row's scale for W8A8:
//     sx = max(max_k |a[m, k]|, 1e-6) * (1/127)
//     xq = clip(round_half_even(a / sx), -127, 127)     (IEEE division)
//   as the TPU kernels' `qmat`. A cast prologue over 16-byte aligned rows
//   needs no prep: the product reads x itself (rounding it to bf16 as it
//   loads it for bf16 / int8 weights).
// * The product runs on the tensor cores (mma.sync): the weights are the
//   16-row A side (row-major, K contiguous), the activation rows the narrow
//   n = 8 side (one n8 tile per 8 rows, up to 3 tiles = 24 rows; more rows
//   take further row groups along grid.y, each streaming the weights again,
//   mostly from L2). bf16: m16n8k16 with f32 sums; int8 weights convert to
//   bf16 in registers (exact for |w| <= 127) and their per-channel scale
//   applies after the sum (W8A16); W8A8: m16n8k32 s8 x s8 -> s32. A lane
//   loads 16 contiguous weight bytes of each of its two A rows and the
//   matching activation bytes of its B row: the same permutation of k on
//   both sides leaves every dot product unchanged, so no shared-memory
//   transpose is needed. M = 1 runs the same n8 tile with 7 zero columns.
// * A cluster of CS blocks takes 16 output columns (NT = 1 tile per warp)
//   and all of K, split over its CS x 8 warps in chunks fixed by K alone.
//   CS (1, 2 or 4) is a function of N: it fills the card when N is small
//   (N = 1024: 64 column tiles x 4 = 256 blocks on 132 SMs). There, above 8
//   rows, a warp takes NT = 2 column tiles, so that each activation
//   fragment it loads serves 32 weight rows (half the activation reads). Each block adds its 8 warps' partial
//   sums in warp order in shared memory; block 0 of the cluster adds the
//   blocks' sums in rank order, reading them through distributed shared
//   memory, and runs the epilogue. No atomics: a product is bitwise the same
//   from run to run, and each row of any M is bitwise its M = 1 product
//   (every output element is the same sequence of mma steps and the same
//   ordered sums whatever the other rows are). An int32 sum is exact in any order, so
//   a W8A8 product with a cast prologue is bitwise the plain version's.
// * Programmatic dependent launch overlaps the products: the prep and the
//   product kernels start with griddepcontrol.launch_dependents and are
//   launched with programmatic stream serialization, so a product's blocks
//   start while the previous kernel is still running. Before
//   griddepcontrol.wait a product only touches what no earlier kernel
//   writes: it issues cp.async.bulk L2 prefetches of its weight slice and
//   loads its first weight chunks. x, resid, the scratch rows and y are read
//   or written only after the wait.
//
// The f32 kind (compute_dtype="float32"; the TPU kernel's f32 `mat`) runs on
// the CUDA cores (the tensor cores would round to TF32) with the same
// structure: the prologue once per product (the prep kernel's f32 rows for a
// LayerNorm, else x itself), then gemm_ffma_kernel: f32 FMAs, rows in groups
// of 8 (MR = 1, 2, 4 or 8 of them computed, the rest along grid.y).
// * A warp owns FF_BW = 4 output columns (a block of 4 warps 16) over the
//   block's K range; each lane loads 16 weight bytes of every column per
//   step along K, U = 4 steps (2 at MR = 8) in flight in a ring of
//   registers (32 KB per block). The block's slice of the activation rows
//   sits in shared memory, read by all four warps.
// * K splits over a cluster of CS = 8, 4, 2 or 1 blocks, the largest that
//   keeps the product within FF_MAX_BLOCKS = 2 blocks per SM (32-64 KB in
//   flight per SM), a function of N alone. At most 128 registers a thread
//   let four blocks share an SM, so the next product's blocks find room
//   while this one runs: they prefetch their weights into L2 and load their
//   first steps before their griddepcontrol.wait.
// * Sums in a fixed order: a lane's steps in order, the warp's lanes by one
//   shuffle tree (lane 0's), the cluster's blocks in rank order in rank 0
//   through distributed shared memory, which runs the epilogue. No atomics:
//   two runs are bitwise equal and each row bitwise its M = 1 product.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

#define GEMM_ROWS 8  // f32 kind: rows per row group
#define FF_WARPS 4   // f32 kind: warps per block
#define FF_BW 4      // f32 kind: output columns per warp
#define FF_MAX_BLOCKS 264  // f32 kind: a product's blocks, at most (two per SM of four)

#define TC_WARPS 8       // K split over the warps of a block
#define TC_N 16          // output columns (weight rows) per block
#define TC_ROWS 24       // activation rows per block: up to three n8 tiles
#define TC_MAX_BLOCKS 300  // a product's blocks, at most, when K splits over a cluster

// Weight kinds: the launcher's `w_kind`.
#define W_BF16 0
#define W_INT8 1
#define W_F32 2
#define W_W8A8 3

// ---- programmatic dependent launch ------------------------------------------
// Both are no-ops in a grid launched without the attribute.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p), "r"(bytes) : "memory");
}

// ---- tensor-core steps --------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7},"
      " {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7},"
      " {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bytes 2i, 2i + 1 of an int8 word as a bf16 pair (exact)
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w, int i) {
  return pack_bf16x2((float)(int8_t)(w >> (16 * i)), (float)(int8_t)(w >> (16 * i + 8)));
}

template <int WK>
struct TcKind;
template <>
struct TcKind<W_BF16> {  // 16 bytes of a weight row = 8 bf16 = k32 over 4 lanes
  static constexpr int KC = 32, ESZ = 2;
};
template <>
struct TcKind<W_INT8> {  // 16 bytes = 16 int8 = k64 over 4 lanes
  static constexpr int KC = 64, ESZ = 1;
};
template <>
struct TcKind<W_W8A8> {
  static constexpr int KC = 64, ESZ = 1;
};

// The B fragment of one chunk for one n8 tile: activation row `r` (or zeros
// past M) at the lane's k offset `k` (16 consecutive k for the int8 kinds, 8
// for bf16), as bf16 pairs (or int8 quads for W8A8). XF32: the f32 rows of
// x, rounded to bf16 here (the cast prologue).
template <int WK, bool XF32>
struct BFrag {
  static constexpr int NW = (WK == W_INT8) ? 8 : 4;  // 32-bit words
  uint32_t v[NW];
  __device__ __forceinline__ void load(const void* act, int lda, int r, bool in, int k) {
    if (!in) {
#pragma unroll
      for (int i = 0; i < NW; ++i) v[i] = 0u;
      return;
    }
    if constexpr (XF32) {
      const float4* p = reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(act) + (size_t)r * lda + k);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) {
        const float4 f = p[i];
        v[2 * i] = pack_bf16x2(f.x, f.y);
        v[2 * i + 1] = pack_bf16x2(f.z, f.w);
      }
    } else if constexpr (WK == W_W8A8) {
      const uint4 u = *reinterpret_cast<const uint4*>(reinterpret_cast<const int8_t*>(act) +
                                                      (size_t)r * lda + k);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(
          reinterpret_cast<const __nv_bfloat16*>(act) + (size_t)r * lda + k);
#pragma unroll
      for (int i = 0; i < NW / 4; ++i) {
        const uint4 u = p[i];
        v[4 * i] = u.x, v[4 * i + 1] = u.y, v[4 * i + 2] = u.z, v[4 * i + 3] = u.w;
      }
    }
  }
};

// One chunk's products for one n8 tile. wa / wb: 16 bytes of weight rows g
// and g + 8 at the lane's k offset. Lane (g, t) supplies to each mma the
// logical k {2t, 2t+1, 2t+8, 2t+9} (bf16) or {4t..4t+3, 4t+16..4t+19} (s8)
// from its own 16 contiguous bytes, on the A and the B side alike.
template <int WK, typename Acc>
__device__ __forceinline__ void chunk_mma(Acc* c, const uint4& wa, const uint4& wb,
                                          const uint32_t* x) {
  if constexpr (WK == W_BF16) {
    mma_bf16(c, wa.x, wb.x, wa.y, wb.y, x[0], x[1]);
    mma_bf16(c, wa.z, wb.z, wa.w, wb.w, x[2], x[3]);
  } else if constexpr (WK == W_W8A8) {
    mma_s8(c, wa.x, wb.x, wa.y, wb.y, x[0], x[1]);
    mma_s8(c, wa.z, wb.z, wa.w, wb.w, x[2], x[3]);
  } else {  // int8 weights as bf16: 4 bytes of each row per k16 step
    const uint32_t ra[4] = {wa.x, wa.y, wa.z, wa.w}, rb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mma_bf16(c, i8x2_bf16x2(ra[i], 0), i8x2_bf16x2(rb[i], 0), i8x2_bf16x2(ra[i], 1),
               i8x2_bf16x2(rb[i], 1), x[2 * i], x[2 * i + 1]);
  }
}

// The product: grid (ceil(N / 16) * CS, ceil(M / 24)) in clusters of (CS, 1),
// TC_WARPS warps; MT n8 tiles. act: the bf16 / int8 scratch rows of the prep
// kernel (lda = K), or with XF32 the f32 rows of x (lda = ldx). sx: W8A8 row
// scales.
template <int WK, int MT, int NT, bool XF32, int CS>
__global__ void __launch_bounds__(TC_WARPS * 32)
gemm_tc_kernel(const void* __restrict__ act, int lda, const float* __restrict__ sx,
               const void* __restrict__ w, const float* __restrict__ wscale,
               const float* __restrict__ bias, const float* __restrict__ resid, int ldr,
               float* __restrict__ y, int ldy, int M, int N, int K, int relu) {
  typedef typename std::conditional<WK == W_W8A8, int, float>::type Acc;
  constexpr int KC = TcKind<WK>::KC, ESZ = TcKind<WK>::ESZ;
  constexpr int U = NT == 1 ? 2 : 1;  // chunks in flight per lane, beside the next ones
  constexpr int BN = TC_N * NT;       // output columns of the block
  __shared__ Acc red[TC_WARPS][MT * 8][BN];
  __shared__ Acc part[MT * 8 * BN];  // this block's sum, read by cluster rank 0

  pdl_launch_dependents();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x % CS;  // the block's rank in its cluster
  const int n0 = blockIdx.x / CS * BN, m0 = blockIdx.y * TC_ROWS;
  const int rows = min(TC_ROWS, M - m0);
  // this warp's chunks: a function of K (and of CS, a function of N) alone
  const int nchunks = K / KC, gw = split * TC_WARPS + warp;
  const int c_lo = gw * nchunks / (TC_WARPS * CS), c_hi = (gw + 1) * nchunks / (TC_WARPS * CS);
  const unsigned char* wbytes = reinterpret_cast<const unsigned char*>(w);
  // A rows of tile i: n0 + 16 i + g and n0 + 16 i + g + 8
  const unsigned char* wr[NT][2];
  bool in[NT][2];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 16 * i + 8 * h + g;
      in[i][h] = n < N;
      wr[i][h] = wbytes + (size_t)n * K * ESZ + t * 16;
    }
  auto load_a = [&](uint4 (&a)[NT][2], int c) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[i][h] = (c < c_hi && in[i][h])
                      ? __ldg(reinterpret_cast<const uint4*>(wr[i][h] + (size_t)c * KC * ESZ))
                      : z;
  };

  // before the wait: the weights only (no earlier kernel writes them)
  if (lane < BN && n0 + lane < N && c_hi > c_lo)
    prefetch_l2(wbytes + ((size_t)(n0 + lane) * K + (size_t)c_lo * KC) * ESZ,
                (unsigned)((c_hi - c_lo) * KC * ESZ));
  uint4 wa[U][NT][2];
#pragma unroll
  for (int u = 0; u < U; ++u) load_a(wa[u], c_lo + u);

  Acc acc[NT][MT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  pdl_wait();  // the activations (x or the prep's rows) are written
  // activation element offset of the lane's k within a chunk
  constexpr int KL = (WK == W_BF16) ? 8 : 16;
  for (int c0 = c_lo; c0 < c_hi; c0 += U) {
    BFrag<WK, XF32> xb[U][MT];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int r = 8 * j + g;
        xb[u][j].load(act, lda, m0 + r, c0 + u < c_hi && r < rows, (c0 + u) * KC + t * KL);
      }
    uint4 na[U][NT][2];
#pragma unroll
    for (int u = 0; u < U; ++u) load_a(na[u], c0 + U + u);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < c_hi) {
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j)
            chunk_mma<WK>(acc[i][j], wa[u][i][0], wa[u][i][1], xb[u][j].v);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        wa[u][i][0] = na[u][i][0];
        wa[u][i][1] = na[u][i][1];
      }
  }

  // the warps' partial sums, their ordered sum per block, then the blocks'
  // sums in rank order in cluster rank 0, and the epilogue
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      red[warp][8 * j + 2 * t][16 * i + g] = acc[i][j][0];
      red[warp][8 * j + 2 * t + 1][16 * i + g] = acc[i][j][1];
      red[warp][8 * j + 2 * t][16 * i + g + 8] = acc[i][j][2];
      red[warp][8 * j + 2 * t + 1][16 * i + g + 8] = acc[i][j][3];
    }
  __syncthreads();
  const int total = rows * BN;
  for (int e = threadIdx.x; e < total; e += TC_WARPS * 32) {
    const int ml = e / BN, nl = e % BN;
    Acc s = red[0][ml][nl];
#pragma unroll
    for (int q = 1; q < TC_WARPS; ++q) s += red[q][ml][nl];
    part[e] = s;
  }
  namespace cg = cooperative_groups;
  if constexpr (CS > 1) cg::this_cluster().sync();  // every block's `part` is written
  else __syncthreads();
  for (int e = threadIdx.x; e < total && split == 0; e += TC_WARPS * 32) {
    const int ml = e / BN, nl = e % BN, n = n0 + nl, m = m0 + ml;
    Acc s = part[e];
    if constexpr (CS > 1) {
#pragma unroll
      for (int r = 1; r < CS; ++r) s += cg::this_cluster().map_shared_rank(part, r)[e];
    }
    if (n >= N) continue;
    float v;
    if constexpr (WK == W_W8A8) {
      // float(acc) * (sx * srow), then + bias, ReLU, + residual, each
      // rounded on its own (as the plain version)
      v = __fmul_rn(__int2float_rn(s), __fmul_rn(sx[m], wscale[n]));
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      if (relu) v = fmaxf(v, 0.f);
      if (resid != nullptr) v = __fadd_rn(v, resid[(size_t)m * ldr + n]);
    } else {
      v = s * (wscale != nullptr ? wscale[n] : 1.f) + (bias != nullptr ? bias[n] : 0.f);
      if (relu) v = fmaxf(v, 0.f);
      if (resid != nullptr) v += resid[(size_t)m * ldr + n];
    }
    y[(size_t)m * ldy + n] = v;
  }
  if constexpr (CS > 1) cg::this_cluster().sync();  // rank 0 has read the others' sums
}

// ---- the prologue, once per product -------------------------------------------
template <int THREADS>
__device__ __forceinline__ float prep_block_sum(float v, float* red) {
  v = vx_warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) s += red[i];  // in warp order
  __syncthreads();
  return s;
}
template <int THREADS>
__device__ __forceinline__ float prep_block_max(float v, float* red) {
  v = vx_warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) s = fmaxf(s, red[i]);
  __syncthreads();
  return s;
}

// The prep kernel's outputs (the launcher's `out`)
#define PREP_BF16 0
#define PREP_W8A8 1
#define PREP_F32 2

// One block per activation row m: the LayerNorm (or the f32 row itself),
// then bf16 rows (PREP_BF16), int8 codes and sx[m] (PREP_W8A8) or f32 rows
// (PREP_F32) into the scratch `act` [M, K]. Each thread keeps the same k's in
// every pass, so the row in shared memory needs no barrier between passes.
// THREADS (256, or 1024 for rows longer than 2048) is a function of K alone.
template <int OUT, int THREADS>
__global__ void __launch_bounds__(THREADS)
gemm_prep_kernel(const float* __restrict__ x, int ldx, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, int K, float eps, void* __restrict__ act,
                 float* __restrict__ sx) {
  extern __shared__ float prow[];  // [K]
  __shared__ float red[THREADS / 32];
  pdl_launch_dependents();
  const int m = blockIdx.x;
  pdl_wait();  // x is the previous kernel's output
  const float* xr = x + (size_t)m * ldx;
  float s = 0.f;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const float v = xr[k];
    prow[k] = v;
    s += v;
  }
  if (ln_s != nullptr) {
    const float mean = prep_block_sum<THREADS>(s, red) / (float)K;
    float var = 0.f;
    for (int k = threadIdx.x; k < K; k += THREADS) {
      const float d = prow[k] - mean;
      var += d * d;
    }
    const float rstd = rsqrtf(prep_block_sum<THREADS>(var, red) / (float)K + eps);
    for (int k = threadIdx.x; k < K; k += THREADS)
      prow[k] = (prow[k] - mean) * rstd * ln_s[k] + ln_b[k];
  }
  if constexpr (OUT == PREP_W8A8) {
    float amax = 0.f;
    for (int k = threadIdx.x; k < K; k += THREADS) amax = fmaxf(amax, fabsf(prow[k]));
    const float sxm = fmaxf(prep_block_max<THREADS>(amax, red), 1e-6f) * (1.0f / 127.0f);
    int8_t* q = reinterpret_cast<int8_t*>(act) + (size_t)m * K;
    for (int k = threadIdx.x; k < K; k += THREADS)
      q[k] = (int8_t)__float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(prow[k], sxm)), -127.f), 127.f));
    if (threadIdx.x == 0) sx[m] = sxm;
  } else if constexpr (OUT == PREP_F32) {
    float* o = reinterpret_cast<float*>(act) + (size_t)m * K;
    for (int k = threadIdx.x; k < K; k += THREADS) o[k] = prow[k];
  } else {
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(act) + (size_t)m * K;
    for (int k = threadIdx.x; k < K; k += THREADS) o[k] = __float2bfloat16_rn(prow[k]);
  }
}

// ---- the f32 kind on the CUDA cores --------------------------------------------
// grid (ceil(N / 16) * CS, ceil(M / 8)) in clusters of (CS, 1); MR rows of a
// group computed (zeros past M). act: the prep kernel's f32 rows (lda = K)
// or x (lda = ldx), 16-byte aligned rows.
template <int MR, int CS>
__global__ void __launch_bounds__(FF_WARPS * 32, 4)
gemm_ffma_kernel(const float* __restrict__ act, int lda, const float* __restrict__ w,
                 const float* __restrict__ wscale, const float* __restrict__ bias,
                 const float* __restrict__ resid, int ldr, float* __restrict__ y, int ldy, int M,
                 int N, int K, int relu) {
  constexpr int BN = FF_WARPS * FF_BW;  // output columns of the block
  // weight steps in flight per lane; 2 at MR = 8 keeps the accumulators
  // and the ring within 128 registers (ptxas spills at 4 there)
  constexpr int U = MR < 8 ? 4 : 2;
  extern __shared__ __align__(16) float4 ff_xs[];  // [MR][kb] the block's slice of the rows
  __shared__ float part[BN * MR];  // the warps' sums, read by cluster rank 0

  pdl_launch_dependents();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x % CS;  // the block's rank in its cluster
  const int nb = blockIdx.x / CS * BN, n0 = nb + warp * FF_BW;
  const int m0 = blockIdx.y * GEMM_ROWS, rows = min(GEMM_ROWS, M - m0);
  // the block's K range in float4s: a function of K (and of CS, of N) alone
  const int n4 = K >> 2, lo = n4 * rank / CS, kb = n4 * (rank + 1) / CS - lo;
  const int steps = (kb + 31) >> 5;
  const float4* wr[FF_BW];
  bool in[FF_BW];
#pragma unroll
  for (int c = 0; c < FF_BW; ++c) {
    in[c] = n0 + c < N;
    wr[c] = reinterpret_cast<const float4*>(w + (size_t)(in[c] ? n0 + c : 0) * K) + lo;
  }
  auto load_w = [&](float4 (&a)[FF_BW], int st) {
    const int k4 = lane + 32 * st;
#pragma unroll
    for (int c = 0; c < FF_BW; ++c)
      a[c] = (st < steps && k4 < kb && in[c]) ? __ldg(wr[c] + k4) : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  // before the wait: the weights only (no earlier kernel writes them)
  if (lane < FF_BW && n0 + lane < N && kb > 0)
    prefetch_l2(w + (size_t)(n0 + lane) * K + 4 * lo, (unsigned)(kb * 16));
  float4 wa[U][FF_BW];  // a ring: step s in wa[s % U]
#pragma unroll
  for (int u = 0; u < U; ++u) load_w(wa[u], u);
  float acc[FF_BW][MR];
#pragma unroll
  for (int c = 0; c < FF_BW; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[c][r] = 0.f;

  pdl_wait();  // the activations (x or the prep's rows) are written
  const float4* x4 = reinterpret_cast<const float4*>(act);
  for (int e = threadIdx.x; e < MR * kb; e += FF_WARPS * 32) {
    const int r = e / kb, c = e - r * kb;
    ff_xs[e] = r < rows ? x4[(size_t)(m0 + r) * (lda >> 2) + lo + c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  for (int s0 = 0; s0 < steps; s0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k4 = lane + 32 * (s0 + u);
      if (s0 + u < steps && k4 < kb) {
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const float4 xv = ff_xs[r * kb + k4];
#pragma unroll
          for (int c = 0; c < FF_BW; ++c) {
            float a = acc[c][r];
            a = fmaf(xv.x, wa[u][c].x, a);
            a = fmaf(xv.y, wa[u][c].y, a);
            a = fmaf(xv.z, wa[u][c].z, a);
            acc[c][r] = fmaf(xv.w, wa[u][c].w, a);
          }
        }
      }
      load_w(wa[u], s0 + u + U);  // the slot's next step
    }
  }

  // each column's sum over the warp's lanes (lane 0's shuffle tree), over
  // the cluster's blocks in rank order in rank 0, then the epilogue
#pragma unroll
  for (int c = 0; c < FF_BW; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const float t = vx_warp_sum(acc[c][r]);
      if (lane == 0) part[(warp * FF_BW + c) * MR + r] = t;
    }
  namespace cg = cooperative_groups;
  if constexpr (CS > 1) cg::this_cluster().sync();  // every block's `part` is written
  else __syncthreads();
  for (int e = threadIdx.x; e < rows * BN && rank == 0; e += FF_WARPS * 32) {
    const int r = e / BN, nl = e % BN, n = nb + nl, m = m0 + r;
    float s = part[nl * MR + r];
    if constexpr (CS > 1) {
#pragma unroll
      for (int q = 1; q < CS; ++q) s += cg::this_cluster().map_shared_rank(part, q)[nl * MR + r];
    }
    if (n >= N) continue;
    float v = s * (wscale != nullptr ? wscale[n] : 1.f) + (bias != nullptr ? bias[n] : 0.f);
    if (relu) v = fmaxf(v, 0.f);
    if (resid != nullptr) v += resid[(size_t)m * ldr + n];
    y[(size_t)m * ldy + n] = v;
  }
  if constexpr (CS > 1) cg::this_cluster().sync();  // rank 0 has read the others' sums
}

// ---- launchers ---------------------------------------------------------------------
// a launch with programmatic stream serialization, in clusters of (cs, 1, 1)
template <typename... Kp, typename... Args>
static cudaError_t launch_pdl(void (*kernel)(Kp...), dim3 grid, dim3 block, size_t smem,
                              int cs, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cs;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int WK, int MT, int NT, bool XF32, int CS>
static cudaError_t launch_tc(const void* act, int lda, const float* sx, const void* w,
                             const float* wscale, const float* bias, const float* resid, int ldr,
                             float* y, int ldy, int M, int N, int K, int relu, cudaStream_t s) {
  const dim3 grid((N + TC_N * NT - 1) / (TC_N * NT) * CS, (M + TC_ROWS - 1) / TC_ROWS);
  return launch_pdl(gemm_tc_kernel<WK, MT, NT, XF32, CS>, grid, dim3(TC_WARPS * 32), 0, CS, s,
                    act, lda, sx, w, wscale, bias, resid, ldr, y, ldy, M, N, K, relu);
}

// K splits over a cluster of CS blocks, CS the largest of 4, 2, 1 that keeps
// the product within TC_MAX_BLOCKS blocks of 16 columns per row group: a
// function of N alone, as the split of K must be for each row to be bitwise
// its M = 1 product (NT changes only which columns a warp takes)
template <int WK, int MT, bool XF32>
static cudaError_t launch_tc_cs(const void* act, int lda, const float* sx, const void* w,
                                const float* wscale, const float* bias, const float* resid,
                                int ldr, float* y, int ldy, int M, int N, int K, int relu,
                                cudaStream_t s) {
  const int tiles = (N + TC_N - 1) / TC_N;
  if (4 * tiles <= TC_MAX_BLOCKS) {
    // few columns: above 8 rows each activation fragment serves two column tiles
    if constexpr (MT > 1)
      return launch_tc<WK, MT, 2, XF32, 4>(act, lda, sx, w, wscale, bias, resid, ldr, y, ldy, M,
                                           N, K, relu, s);
    return launch_tc<WK, MT, 1, XF32, 4>(act, lda, sx, w, wscale, bias, resid, ldr, y, ldy, M, N,
                                         K, relu, s);
  }
  if (2 * tiles <= TC_MAX_BLOCKS)
    return launch_tc<WK, MT, 1, XF32, 2>(act, lda, sx, w, wscale, bias, resid, ldr, y, ldy, M, N,
                                         K, relu, s);
  return launch_tc<WK, MT, 1, XF32, 1>(act, lda, sx, w, wscale, bias, resid, ldr, y, ldy, M, N, K,
                                       relu, s);
}

// MT n8 tiles for the rows of a group (more rows: grid.y)
template <int WK, bool XF32>
static cudaError_t launch_tc_mt(const void* act, int lda, const float* sx, const void* w,
                                const float* wscale, const float* bias, const float* resid,
                                int ldr, float* y, int ldy, int M, int N, int K, int relu,
                                cudaStream_t s) {
  const int tiles = (min(M, TC_ROWS) + 7) / 8;
  if (tiles == 1)
    return launch_tc_cs<WK, 1, XF32>(act, lda, sx, w, wscale, bias, resid, ldr, y, ldy, M, N, K,
                                     relu, s);
  if (tiles == 2)
    return launch_tc_cs<WK, 2, XF32>(act, lda, sx, w, wscale, bias, resid, ldr, y, ldy, M, N, K,
                                     relu, s);
  return launch_tc_cs<WK, 3, XF32>(act, lda, sx, w, wscale, bias, resid, ldr, y, ldy, M, N, K,
                                   relu, s);
}

// the prep kernel (LayerNorm or a cast; bf16 rows, W8A8 codes or f32 rows)
// into scratch
template <int OUT, int THREADS>
static cudaError_t launch_prep_t(const float* x, int ldx, const float* ln_s, const float* ln_b,
                                 int M, int K, float eps, void* act, float* sx, cudaStream_t s) {
  const size_t smem = (size_t)K * sizeof(float);
  cudaError_t e = allow_smem(gemm_prep_kernel<OUT, THREADS>, smem);
  if (e != cudaSuccess) return e;
  return launch_pdl(gemm_prep_kernel<OUT, THREADS>, dim3(M), dim3(THREADS), smem, 1, s, x, ldx,
                    ln_s, ln_b, K, eps, act, sx);
}
template <int OUT>
static cudaError_t launch_prep(const float* x, int ldx, const float* ln_s, const float* ln_b,
                               int M, int K, float eps, void* act, float* sx, cudaStream_t s) {
  if (K > 2048)
    return launch_prep_t<OUT, 1024>(x, ldx, ln_s, ln_b, M, K, eps, act, sx, s);
  return launch_prep_t<OUT, 256>(x, ldx, ln_s, ln_b, M, K, eps, act, sx, s);
}

// the f32 product: MR rows a group, K over a cluster of CS blocks
template <int MR, int CS>
static cudaError_t launch_ffma(const float* act, int lda, const float* w, const float* wscale,
                               const float* bias, const float* resid, int ldr, float* y, int ldy,
                               int M, int N, int K, int relu, cudaStream_t s) {
  const size_t smem = (size_t)MR * (((K >> 2) + CS - 1) / CS) * 16;  // the widest K range
  if (smem + FF_WARPS * FF_BW * MR * sizeof(float) > 232448) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(gemm_ffma_kernel<MR, CS>, smem);
  if (e != cudaSuccess) return e;
  const int BN = FF_WARPS * FF_BW;
  const dim3 grid((N + BN - 1) / BN * CS, (M + GEMM_ROWS - 1) / GEMM_ROWS);
  return launch_pdl(gemm_ffma_kernel<MR, CS>, grid, dim3(FF_WARPS * 32), smem, CS, s, act, lda, w,
                    wscale, bias, resid, ldr, y, ldy, M, N, K, relu);
}

// CS the largest of 8, 4, 2, 1 that keeps the product within FF_MAX_BLOCKS
// blocks per row group: a function of N alone
template <int MR>
static cudaError_t launch_ffma_cs(const float* act, int lda, const float* w, const float* wscale,
                                  const float* bias, const float* resid, int ldr, float* y,
                                  int ldy, int M, int N, int K, int relu, cudaStream_t s) {
  const int groups = (N + FF_WARPS * FF_BW - 1) / (FF_WARPS * FF_BW);
  if (8 * groups <= FF_MAX_BLOCKS)
    return launch_ffma<MR, 8>(act, lda, w, wscale, bias, resid, ldr, y, ldy, M, N, K, relu, s);
  if (4 * groups <= FF_MAX_BLOCKS)
    return launch_ffma<MR, 4>(act, lda, w, wscale, bias, resid, ldr, y, ldy, M, N, K, relu, s);
  if (2 * groups <= FF_MAX_BLOCKS)
    return launch_ffma<MR, 2>(act, lda, w, wscale, bias, resid, ldr, y, ldy, M, N, K, relu, s);
  return launch_ffma<MR, 1>(act, lda, w, wscale, bias, resid, ldr, y, ldy, M, N, K, relu, s);
}

// MR: the rows of a group, rounded up to 1, 2, 4 or 8
static cudaError_t launch_ffma_mr(const float* act, int lda, const float* w, const float* wscale,
                                  const float* bias, const float* resid, int ldr, float* y,
                                  int ldy, int M, int N, int K, int relu, cudaStream_t s) {
  const int r = min(M, GEMM_ROWS);
  if (r == 1)
    return launch_ffma_cs<1>(act, lda, w, wscale, bias, resid, ldr, y, ldy, M, N, K, relu, s);
  if (r == 2)
    return launch_ffma_cs<2>(act, lda, w, wscale, bias, resid, ldr, y, ldy, M, N, K, relu, s);
  if (r <= 4)
    return launch_ffma_cs<4>(act, lda, w, wscale, bias, resid, ldr, y, ldy, M, N, K, relu, s);
  return launch_ffma_cs<8>(act, lda, w, wscale, bias, resid, ldr, y, ldy, M, N, K, relu, s);
}

// The prep kernel alone (the check of its rows): x [M, K] f32 (ldx), LayerNorm
// with ln_s / ln_b or a cast, into act [M, K] bf16 (out 0), int8 codes with
// sx [M] (out 1) or f32 (out 2).
extern "C" int vx_gemm_small_m_prep(const float* x, int ldx, const float* ln_s,
                                    const float* ln_b, int M, int K, float eps, int out,
                                    void* act, float* sx, void* stream) {
  if (M < 1 || K < 1 || (ln_s == nullptr) != (ln_b == nullptr) || out < 0 || out > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out == PREP_W8A8  ? launch_prep<PREP_W8A8>(x, ldx, ln_s, ln_b, M, K, eps, act, sx, s)
      : out == PREP_F32 ? launch_prep<PREP_F32>(x, ldx, ln_s, ln_b, M, K, eps, act, nullptr, s)
                        : launch_prep<PREP_BF16>(x, ldx, ln_s, ln_b, M, K, eps, act, nullptr, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// w_kind: 0 = bf16 w, 1 = int8 w with wscale [N] required (W8A16), 2 = f32
// w, 3 = int8 w with wscale [N] required and int8 activations (W8A8). w is
// [N, K]. wscale, bias, ln_s/ln_b, resid may be null.
// scratch: M * K bytes (W8A8: int8 codes, then M f32 scales at the next
// 16-byte boundary), 2 * M * K bytes (bf16 rows) or 4 * M * K bytes (f32
// rows), from the caller, for a LayerNorm or x rows that are not 16-byte
// aligned; null where no prep runs: a cast prologue whose x rows are 16-byte
// aligned (the product reads them). Requires M >= 1, K % 64 == 0 (f32:
// K % 16), 16-byte aligned rows of w; the Python wrapper checks these. One
// product is one call, whatever it launches.
extern "C" int vx_gemm_small_m(const float* x, int ldx, const void* w, int w_kind,
                               const float* wscale, const float* bias, const float* ln_s,
                               const float* ln_b, const float* resid, int ldr, float* y,
                               int ldy, int M, int N, int K, int relu, float eps, void* scratch,
                               void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (w_kind == W_F32) {
    if ((M + GEMM_ROWS - 1) / GEMM_ROWS > 65535 || K % 16) return (int)cudaErrorInvalidValue;
    const float* act = x;
    int lda = ldx;
    cudaError_t e = cudaSuccess;
    if (scratch != nullptr) {  // the LayerNorm (or unaligned) rows as f32, once
      e = launch_prep<PREP_F32>(x, ldx, ln_s, ln_b, M, K, eps, scratch, nullptr, s);
      act = reinterpret_cast<const float*>(scratch);
      lda = K;
    } else if (ln_s != nullptr || reinterpret_cast<uintptr_t>(x) % 16 || ldx % 4) {
      return (int)cudaErrorInvalidValue;
    }
    if (e == cudaSuccess)
      e = launch_ffma_mr(act, lda, reinterpret_cast<const float*>(w), wscale, bias, resid, ldr, y,
                         ldy, M, N, K, relu, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if ((M + TC_ROWS - 1) / TC_ROWS > 65535 || K % 64) return (int)cudaErrorInvalidValue;
  // the prep kernel runs where the caller gives scratch; it must for W8A8
  // and a LayerNorm
  const bool prep = scratch != nullptr;
  if ((w_kind == W_W8A8 || ln_s != nullptr) && !prep) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  switch (w_kind) {
    case W_W8A8: {
      float* sx = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(scratch) +
                                           (((size_t)M * K + 15) / 16) * 16);
      e = launch_prep<PREP_W8A8>(x, ldx, ln_s, ln_b, M, K, eps, scratch, sx, s);
      if (e == cudaSuccess)
        e = launch_tc_mt<W_W8A8, false>(scratch, K, sx, w, wscale, bias, resid, ldr, y, ldy, M,
                                        N, K, relu, s);
      break;
    }
    case W_BF16:
    case W_INT8:
      if (prep) {
        e = launch_prep<PREP_BF16>(x, ldx, ln_s, ln_b, M, K, eps, scratch, nullptr, s);
        if (e != cudaSuccess) break;
        e = w_kind == W_BF16
                ? launch_tc_mt<W_BF16, false>(scratch, K, nullptr, w, wscale, bias, resid, ldr, y,
                                              ldy, M, N, K, relu, s)
                : launch_tc_mt<W_INT8, false>(scratch, K, nullptr, w, wscale, bias, resid, ldr, y,
                                              ldy, M, N, K, relu, s);
      } else {
        e = w_kind == W_BF16
                ? launch_tc_mt<W_BF16, true>(x, ldx, nullptr, w, wscale, bias, resid, ldr, y, ldy,
                                             M, N, K, relu, s)
                : launch_tc_mt<W_INT8, true>(x, ldx, nullptr, w, wscale, bias, resid, ldr, y, ldy,
                                             M, N, K, relu, s);
      }
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
