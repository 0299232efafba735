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
// Kernels, picked by kind (bf16 or f32) and head dim HD (64 or 128); neither
// kind stands in for the other:
//   bf16 on the tensor cores (wgmma, TMA, mbarrier; sm_90a), templated on HD:
//     flash_fwd_tc_kernel<HD>: the forward, one warpgroup per query tile of
//       64 (design below);
//     flash_bwd_dq_tc_kernel<HD>: per query tile, di = sum(O * dO) in f32
//       from O as stored (written out for the dK/dV kernel), then dQ over the
//       key tiles; one warpgroup;
//     flash_bwd_dkv_tc_kernel<HD>: per key tile, dK and dV over the query
//       tiles that can see it (all of them when the tile starts below P, else
//       from the tile's own row on), HD / 64 warpgroups; it runs after the dQ
//       kernel on the same stream and reads its di;
//   f32 on the CUDA cores (tensor cores in f32 would round to TF32 and change
//     the f32 numbers), the same three roles:
//     flash_fwd_ffma_kernel<HD>: the forward, one block of 256 threads per
//       query tile of 128, K and V through a ring of cp.async stages,
//       masked key tiles skipped (flash_attention_f32.cu, its own
//       translation unit; its design is there);
//     flash_bwd_dq_ffma_kernel<HD> then flash_bwd_dkv_ffma_kernel<HD>: the
//       backward, one block of 256 threads per own tile of 8192 / HD rows,
//       the other side's tiles through a ring of cp.async stages, masked
//       tiles skipped (flash_attention_f32_bwd.cu, its own translation unit;
//       its design is there).
// Both forwards write O in the input type and the row log-sum-exp (f32) for
// the backward.
// Neither backward uses atomics: each output element is one block's sum in a
// fixed order, so the gradients are the same from run to run.
// Rounding follows the library: scores in f32 (q.k, then times the scale),
// p cast to V's type before P.V, p and ds cast to the input type before
// their products in the backward, every product summed in f32.
// Rows without a valid key give O = 0, lse = 0 and zero gradients.
//
// Bound on the H100: operations, 4 * hd per valid (query, key) pair forward
// (bf16 at 989 TFLOP/s), 6 * hd in the dQ kernel (q.k, dO.v, ds.k) and
// 8 * hd in the dK/dV kernel (q.k, dO.v, p.dO, ds.q), or the bytes (q, k, v,
// O, dO read once, the outputs written once) where fewer pairs are valid.
// The bf16 kernels' designs for that bound are with them below.
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)

#include "flash_attention.cuh"

// ---------------------------------------------------------------------------
// The bf16 kernels on the tensor cores (wgmma, TMA, mbarrier; sm_90a).
//
// Tiles. A 64-row tile of q, k, v or dO holds 64 x HD bf16 values. It comes
// into shared memory by TMA as HD / 64 boxes of 64 rows by 64 head columns
// (128 bytes a row, the span of the 128-byte swizzle), each box 8 KB, 1024-
// byte aligned, box c holding head columns 64 c..64 c + 63; one barrier
// counts the bytes of all of a tile's boxes. Every product reads these boxes
// in one of two wgmma forms:
//  - K-major from shared memory (S = Q K^T, and the backward's dP = dO V^T,
//    S^T = K Q^T, dP^T = V dO^T): HD / 16 k-steps of m64n64k16, four in each
//    box, each 32 bytes further into the swizzled rows;
//  - A from registers, B MN-major with the transpose bit (O += P V, and the
//    backward's dQ += dS K, dV += P^T dO, dK += dS^T Q): the f32 accumulator
//    fragment of keys (or queries) 16 kk..16 kk + 15, rounded to bf16 pairs,
//    is the A fragment of k-step kk; the B descriptor's leading byte offset
//    is the 8 KB between boxes, so one m64n128k16 covers both boxes at
//    HD = 128 (a 64-register accumulator) and m64n64k16 one box.
//
// The forward (flash_fwd_tc_kernel<HD>), at the training shapes (B = 4,
// T = 1152; H = 16 at hd 64, 8 at hd 128: the same operations and bytes)
// bounded by the bytes at prefix 128 and by the operations at prefix T
// (0.011 / 0.015 ms): one warpgroup per 64-row query tile; S = Q K^T from
// shared memory; the online softmax on the S accumulator in registers (exp2
// in log2 units, p rounded to bf16 as the P.V operand at the running row
// max, as the library's kernel); O += P V with the O accumulator in
// registers (32 f32 a thread at hd 64, 64 at hd 128); K/V through a ring of
// FW_STAGES stages (TMA, mbarrier completion), one thread refilling a stage
// once the warpgroup is done with it; the Q tile once. Masked work is skipped
// before any load (fa_visit): a key tile without an id equal to one of the
// query tile's is never loaded, a FULL one uses its scores unmasked.
// ---------------------------------------------------------------------------

#define FW_THREADS 128  // one warpgroup: 64 rows, 16 per warp
#define FW_STAGES 2     // the ring of the other side's tiles
#define FW_BOX_BYTES (FA_TILE * 64 * 2)        // one 64 x 64 bf16 box (8 KB)
#define FW_TILE_BYTES(hd) (FA_TILE * (hd) * 2)  // a 64-row tile: hd / 64 boxes
// key-tile classes (the low bit of a listed tile)
#define FW_FULL 0
#define FW_MASKED 1

// Where the tensor map puts each outer dimension of a [B, H, T, hd] view:
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

// one 64 x 64 box of a 4-d tensor map (head columns c0..c0 + 63) into shared
// memory, completing on bar
__device__ __forceinline__ void fw_tma_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           FaTmaPos pos, int c0, int t0, int h, int b) {
  int c[4] = {c0, 0, 0, 0};
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

// one 64-row tile (rows t0..t0 + 63): its HD / 64 boxes, 8 KB apart
template <int HD>
__device__ __forceinline__ void fw_tma_tile(unsigned char* dst, const CUtensorMap* map,
                                            uint64_t* bar, FaTmaPos pos, int t0, int h, int b) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) fw_tma_box(dst + c * FW_BOX_BYTES, map, bar, pos, 64 * c, t0, h, b);
}

// wgmma shared-memory descriptor, 128-byte swizzle; the box starts on a
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
template <int N>
__device__ __forceinline__ void fw_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
#define FW_D64                                                                                 \
  FW_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),        \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),            \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),            \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
      "+f"(d[62]), "+f"(d[63])
#define FW_REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

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

// the same with N = 128: d[64 x 128] += A[64 x 16] B[16 x 128], B's two
// 64-column boxes a leading byte offset apart
__device__ __forceinline__ void fw_mma_rs128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FW_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FW_D64
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

// d = A B^T over the head dim, both 64 x HD tiles K-major in shared memory:
// HD / 16 k-steps of 16, four in each box, each 32 bytes further into the
// box's 128-byte swizzled rows
template <int HD>
__device__ __forceinline__ void fw_mma_kk(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk >> 2) * FW_BOX_BYTES + 32 * (kk & 3);
    fw_mma_ss(d, fw_desc(a_addr + off, 16, 1024), fw_desc(b_addr + off, 16, 1024), kk);
  }
}

// d += A B: A from registers (fw_frag's fragments), B the N head columns of
// a 64-row tile MN-major in shared memory (its rows are the k dim, the head
// dim contiguous; k-step kk is 16 rows further on); N = 64 reads one box,
// N = 128 both, the box stride as the leading byte offset
template <int N>
__device__ __forceinline__ void fw_mma_rk(float (&d)[N / 2], const uint32_t (&a)[4][4],
                                          uint32_t b_addr) {
  static_assert(N == 64 || N == 128, "one or two 64-column boxes");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = fw_desc(b_addr + 2048 * kk, FW_BOX_BYTES, 1024);
    if constexpr (N == 64)
      fw_mma_rs(d, a[kk], db);
    else
      fw_mma_rs128(d, a[kk], db);
  }
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

// Shared memory: Q tile, FW_STAGES K and V tiles (1024-byte aligned boxes
// for the swizzle), the barriers (Q, then one per stage), the query tile's
// segment ids, the count and list of key tiles to visit.
#define FW_SMEM_FIXED(hd) \
  (1024 + (1 + 2 * FW_STAGES) * FW_TILE_BYTES(hd) + 8 * (1 + FW_STAGES) + 4 * FA_TILE + 16)

template <int HD>
__global__ void __launch_bounds__(FW_THREADS)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, FaTmaPos qpos, FaTmaPos kvpos,
                        const int* __restrict__ qseg, const int* __restrict__ kvseg,
                        __nv_bfloat16* __restrict__ o, FaStrides os, float* __restrict__ lse,
                        int H, int T_len, int P, float scale_log2) {
  constexpr int TB = FW_TILE_BYTES(HD);
  extern __shared__ unsigned char fw_raw[];
  unsigned char* base = fw_raw + ((1024 - (fw_smem(fw_raw) & 1023)) & 1023);
  unsigned char* Qs = base;
  unsigned char* Ks = Qs + TB;
  unsigned char* Vs = Ks + FW_STAGES * TB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + FW_STAGES * TB);
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
    fw_bar_expect(bars, TB);
    fw_tma_tile<HD>(Qs, &qmap, bars, qpos, q0, h, b);
  }

  // the key tiles this tile can see (up to max(q0 + 64, P)), classified
  const int kend = min(T_len, max(q0 + FA_TILE, P));
  const int n = fa_visit(segq, true, q0, ksg, 0, (kend + FA_TILE - 1) / FA_TILE, T_len, P, tiles,
                         count);
  if (tid == 0) {
    for (int i = 0; i < min(n, FW_STAGES); ++i) {
      fw_bar_expect(bars + 1 + i, 2 * TB);
      fw_tma_tile<HD>(Ks + i * TB, &kmap, bars + 1 + i, kvpos, (tiles[i] >> 1) * FA_TILE, h, b);
      fw_tma_tile<HD>(Vs + i * TB, &vmap, bars + 1 + i, kvpos, (tiles[i] >> 1) * FA_TILE, h, b);
    }
  }

  // this thread's rows of the accumulators: r0 and r0 + 8; its columns
  // 8 j + 2 tq + {0, 1}, j = 0..N/8 - 1 (wgmma's m64nNk16 fragment)
  const int r0 = warp * 16 + (lane >> 2), tq = lane & 3;
  const int seg0 = segq[r0], seg1 = segq[r0 + 8];
  const int i0 = q0 + r0, i1 = i0 + 8;
  const int lim0 = max(i0, P - 1), lim1 = max(i1, P - 1);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only

  const uint32_t q_addr = fw_smem(Qs);
  fw_bar_wait(bars, 0);  // (also when no tile is visited: the load must land first)
  for (int it = 0; it < n; ++it) {
    const int stage = it % FW_STAGES;
    const int e = tiles[it], k0 = (e >> 1) * FA_TILE;
    const uint32_t k_addr = fw_smem(Ks + stage * TB);
    const uint32_t v_addr = fw_smem(Vs + stage * TB);
    fw_bar_wait(bars + 1 + stage, (it / FW_STAGES) & 1);

    // S = Q K^T, f32
    float s[32];
    fw_fence();
    fw_mma_kk<HD>(s, q_addr, k_addr);
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
      // O's columns 8 j.. of each 64-column box (interleaved with the exps:
      // the hd-64 schedule)
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        acc[32 * c + 4 * j] *= al0;
        acc[32 * c + 4 * j + 1] *= al0;
        acc[32 * c + 4 * j + 2] *= al1;
        acc[32 * c + 4 * j + 3] *= al1;
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;

    // O += P V: p rounded to bf16 as the A operand, V MN-major
    uint32_t pa[4][4];
    fw_frag(pa, s);
    fw_hold(acc);
    fw_fence();
    fw_mma_rk<HD>(acc, pa, v_addr);
    fw_commit();
    fw_wait_all();
    fw_hold(acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && it + FW_STAGES < n) {
      const int t = tiles[it + FW_STAGES] >> 1;
      fw_bar_expect(bars + 1 + stage, 2 * TB);
      fw_tma_tile<HD>(Ks + stage * TB, &kmap, bars + 1 + stage, kvpos, t * FA_TILE, h, b);
      fw_tma_tile<HD>(Vs + stage * TB, &vmap, bars + 1 + stage, kvpos, t * FA_TILE, h, b);
    }
  }

  l0 = fw_quad_sum(l0);
  l1 = fw_quad_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
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

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores.
//
// Replaces the JAX library's Pallas backward kernels
// (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dq, :1287, and _flash_attention_bwd_dkv, :941) for
// the bf16 calls of attention_core_flash (vallex_tpu/models/layers.py:205)
// and attention_core_flash_prefix (:259). Bound on the H100 at the training
// shapes (B = 4, T = 1152, H = 16 at hd 64 or 8 at hd 128, 29 M valid pairs
// per 16 heads at prefix 128): the bytes, ~0.017 ms each (q, k, v, O, dO read
// once, the gradients written once), ahead of the operations (6 * hd per
// valid pair for dQ, 8 * hd for dK/dV: 11.1 and 14.8 GFLOP, 0.011 and 0.015
// ms at 989 TFLOP/s; at prefix T, 57 M pairs, the operations lead: 0.022 and
// 0.030 ms). What the design does about it:
//  - every product runs on the tensor cores in the two forms above, with no
//    transpose through shared memory: S = Q K^T, dP = dO V^T (dQ kernel) and
//    S^T = K Q^T, dP^T = V dO^T (dK/dV kernel) take both operands K-major;
//    dQ += dS K, dV += P^T dO and dK += dS^T Q take p or ds from registers
//    and B MN-major. Computing S^T and dP^T directly is what puts p^T and
//    ds^T in that fragment;
//  - the dQ kernel is one warpgroup per (query tile of 64, head, row): S, dP
//    and dQ are 32 + 32 + HD / 2 f32 registers a thread;
//  - the dK/dV kernel per (key tile of 64, head, row) holds S^T and dP^T
//    (32 + 32) and dK and dV. At hd 64 one warpgroup holds all of them (128
//    f32 a thread, 164 registers in all). At hd 128 dK and dV alone are 128,
//    192 with S^T and dP^T before any fragment or address, past the 255 a
//    thread can have without spills. So the kernel runs HD / 64 consumer
//    warpgroups per key tile, warpgroup w owning head columns 64 w..64 w + 63
//    of dK and dV (32 + 32 registers, as at hd 64); each computes the whole
//    S^T and dP^T (the reduction runs over the full head dim, 8 k-steps)
//    and its own p^T and ds^T. That repeats S^T and dP^T: 12 * hd
//    operations per pair instead of 8 * hd, and the exp and mask work twice.
//    It was chosen over a 128-key tile of two warpgroups with a producer
//    warp and setmaxnreg (no operation repeated, ~240 registers a consumer)
//    because it keeps the hd-64 kernel's structure, synchronisation and
//    register budget unchanged; the tensor cores are not what bounds these
//    kernels at these shapes (they run at 110-250 TFLOP/s, PERF.md);
//  - the tiles a block keeps (Q and dO, or K and V) come in once by TMA, the
//    other side's through a ring of FW_STAGES stages with mbarrier
//    completion, one thread refilling a stage once every warpgroup is done
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

// an accumulator fragment of N head columns (from col0) as bf16 rows
// [t0, t0 + 64) of a contiguous [T, HD] slice, rows past T dropped
template <int HD, int N>
__device__ __forceinline__ void fb_store(__nv_bfloat16* dst, const float (&x)[N / 2], int r0,
                                         int tq, int t0, int T_len, int col0) {
  const int i0 = t0 + r0, i1 = i0 + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = col0 + 8 * j + 2 * tq;
    if (i0 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)i0 * HD + c) =
          __floats2bfloat162_rn(x[4 * j], x[4 * j + 1]);
    if (i1 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)i1 * HD + c) =
          __floats2bfloat162_rn(x[4 * j + 2], x[4 * j + 3]);
  }
}

// Shared memory of the dQ kernel: Q and dO tiles, FW_STAGES K and V tiles,
// the barriers (Q + dO, then one per stage), the query tile's segment ids and
// di, the count and list of key tiles to visit.
#define FB_DQ_SMEM_FIXED(hd) \
  (1024 + (2 + 2 * FW_STAGES) * FW_TILE_BYTES(hd) + 8 * (1 + FW_STAGES) + 8 * FA_TILE + 16)

template <int HD>
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
  constexpr int TB = FW_TILE_BYTES(HD);
  extern __shared__ unsigned char fw_raw[];
  unsigned char* base = fw_raw + ((1024 - (fw_smem(fw_raw) & 1023)) & 1023);
  unsigned char* Qs = base;
  unsigned char* dOs = Qs + TB;
  unsigned char* Ks = dOs + TB;
  unsigned char* Vs = Ks + FW_STAGES * TB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + FW_STAGES * TB);
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
    fw_bar_expect(bars, 2 * TB);
    fw_tma_tile<HD>(Qs, &qmap, bars, qpos, q0, h, b);
    fw_tma_tile<HD>(dOs, &domap, bars, dopos, q0, h, b);
  }
  // di = sum_c O[i, c] dO[i, c] in f32 from O as stored, two threads a row
  // (16-byte loads: the wrapper checked the bases and strides)
  {
    const int r = tid >> 1, half = tid & 1, i = q0 + r;
    float acc = 0.f;
    if (i < T_len) {
      const uint4* op =
          reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + i * os.t) + (HD / 16) * half;
      const uint4* dp =
          reinterpret_cast<const uint4*>(dout + b * dos.b + h * dos.h + i * dos.t) +
          (HD / 16) * half;
#pragma unroll
      for (int u = 0; u < HD / 16; ++u) {
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
      fw_bar_expect(bars + 1 + i, 2 * TB);
      fw_tma_tile<HD>(Ks + i * TB, &kmap, bars + 1 + i, kvpos, t0, h, b);
      fw_tma_tile<HD>(Vs + i * TB, &vmap, bars + 1 + i, kvpos, t0, h, b);
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
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  const uint32_t q_addr = fw_smem(Qs), do_addr = fw_smem(dOs);
  fw_bar_wait(bars, 0);  // (also when no tile is visited: the loads must land first)
  for (int it = 0; it < n; ++it) {
    const int stage = it % FW_STAGES;
    const int e = tiles[it], k0 = (e >> 1) * FA_TILE;
    const uint32_t k_addr = fw_smem(Ks + stage * TB);
    const uint32_t v_addr = fw_smem(Vs + stage * TB);
    fw_bar_wait(bars + 1 + stage, (it / FW_STAGES) & 1);

    // S = Q K^T and dP = dO V^T, f32
    float s[32], dp[32];
    fw_fence();
    fw_mma_kk<HD>(s, q_addr, k_addr);
    fw_mma_kk<HD>(dp, do_addr, v_addr);
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
    fw_mma_rk<HD>(acc, da, k_addr);
    fw_commit();
    fw_wait_all();
    fw_hold(acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && it + FW_STAGES < n) {
      const int t0 = (tiles[it + FW_STAGES] >> 1) * FA_TILE;
      fw_bar_expect(bars + 1 + stage, 2 * TB);
      fw_tma_tile<HD>(Ks + stage * TB, &kmap, bars + 1 + stage, kvpos, t0, h, b);
      fw_tma_tile<HD>(Vs + stage * TB, &vmap, bars + 1 + stage, kvpos, t0, h, b);
    }
  }
  fb_store<HD, HD>(dq + bh * T_len * HD, acc, r0, tq, q0, T_len, 0);
}

// Shared memory of the dK/dV kernel: K and V tiles, FW_STAGES Q and dO
// tiles, the barriers (K + V, then one per stage), the key tile's segment
// ids, the count, two buffers of a query tile's segment ids, lse (log2
// units) and di, and the list of query tiles to visit.
#define FB_DKV_SMEM_FIXED(hd)                                                                  \
  (1024 + (2 + 2 * FW_STAGES) * FW_TILE_BYTES(hd) + 8 * (1 + FW_STAGES) + 4 * FA_TILE + 16 + \
   2 * 3 * 4 * FA_TILE)

template <int HD>
__global__ void __launch_bounds__(FW_THREADS * (HD / 64))
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap, FaTmaPos qpos,
                            FaTmaPos kvpos, FaTmaPos dopos, const int* __restrict__ qseg,
                            const int* __restrict__ kvseg, const float* __restrict__ lse,
                            const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int H, int T_len, int P,
                            float scale) {
  constexpr int TB = FW_TILE_BYTES(HD);
  extern __shared__ unsigned char fw_raw[];
  unsigned char* base = fw_raw + ((1024 - (fw_smem(fw_raw) & 1023)) & 1023);
  unsigned char* Ks = base;
  unsigned char* Vs = Ks + TB;
  unsigned char* Qs = Vs + TB;
  unsigned char* dOs = Qs + FW_STAGES * TB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dOs + FW_STAGES * TB);
  int* segk = reinterpret_cast<int*>(bars + 1 + FW_STAGES);
  int* count = segk + FA_TILE;
  int* cseg = count + 4;                                       // [2][64]
  float* clse = reinterpret_cast<float*>(cseg + 2 * FA_TILE);  // [2][64]
  float* cdi = clse + 2 * FA_TILE;                             // [2][64]
  int* tiles = reinterpret_cast<int*>(cdi + 2 * FA_TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // warpgroup wg owns dK's and dV's head columns 64 wg..64 wg + 63 (its box)
  const int wg = HD == 64 ? 0 : warp >> 2;
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
    fw_bar_expect(bars, 2 * TB);
    fw_tma_tile<HD>(Ks, &kmap, bars, kvpos, k0, h, b);
    fw_tma_tile<HD>(Vs, &vmap, bars, kvpos, k0, h, b);
  }

  // the query tiles that can see this key tile (rows below it only through
  // the prefix, keys j < P), classified
  const int nq = (T_len + FA_TILE - 1) / FA_TILE;
  const int n =
      fa_visit(segk, false, k0, qsg, k0 < P ? 0 : k0 / FA_TILE, nq, T_len, P, tiles, count);
  if (tid == 0) {
    for (int i = 0; i < min(n, FW_STAGES); ++i) {
      const int t0 = (tiles[i] >> 1) * FA_TILE;
      fw_bar_expect(bars + 1 + i, 2 * TB);
      fw_tma_tile<HD>(Qs + i * TB, &qmap, bars + 1 + i, qpos, t0, h, b);
      fw_tma_tile<HD>(dOs + i * TB, &domap, bars + 1 + i, dopos, t0, h, b);
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
  const int r0 = (warp & 3) * 16 + (lane >> 2), tq = lane & 3;
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
    const uint32_t q_addr = fw_smem(Qs + stage * TB);
    const uint32_t do_addr = fw_smem(dOs + stage * TB);
    fw_bar_wait(bars + 1 + stage, (it / FW_STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, f32 (every warpgroup the whole tile);
    // the next tile's columns load meanwhile (their buffer was last read
    // before the previous barrier)
    float st[32], dpt[32];
    fw_fence();
    fw_mma_kk<HD>(st, k_addr, q_addr);
    fw_mma_kk<HD>(dpt, v_addr, do_addr);
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

    // dV += P^T dO and dK += dS^T Q over this warpgroup's head columns: p
    // and ds rounded to bf16 as the A operands, dO and Q MN-major (its box)
    uint32_t pa[4][4], da[4][4];
    fw_frag(pa, st);
    fw_frag(da, dpt);
    fw_hold(dva);
    fw_hold(dka);
    fw_fence();
    fw_mma_rk<64>(dva, pa, do_addr + wg * FW_BOX_BYTES);
    fw_mma_rk<64>(dka, da, q_addr + wg * FW_BOX_BYTES);
    fw_commit();
    fw_wait_all();
    fw_hold(dva);
    fw_hold(dka);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && it + FW_STAGES < n) {
      const int t0 = (tiles[it + FW_STAGES] >> 1) * FA_TILE;
      fw_bar_expect(bars + 1 + stage, 2 * TB);
      fw_tma_tile<HD>(Qs + stage * TB, &qmap, bars + 1 + stage, qpos, t0, h, b);
      fw_tma_tile<HD>(dOs + stage * TB, &domap, bars + 1 + stage, dopos, t0, h, b);
    }
  }
  fb_store<HD, 64>(dk + bh * T_len * HD, dka, r0, tq, k0, T_len, 64 * wg);
  fb_store<HD, 64>(dv + bh * T_len * HD, dva, r0, tq, k0, T_len, 64 * wg);
}

// ---------------------------------------------------------------------------
// Launchers. Strides arrive as three long longs (b, h, t) in elements; the
// last stride is 1. Gradients and lse / di are contiguous [B, H, T(, hd)].
// kind 0: f32, kind 1: bf16 (q, k, v, O, dO and the gradients alike); hd 64
// or 128. Each launcher picks its kernel by (kind, hd): bf16 on the tensor
// cores, f32 on the CUDA cores; neither stands in for the other. Both
// forwards read q, k, v in 16-byte pieces (TMA boxes, cp.async), so their
// base addresses and strides must be multiples of 16 bytes (the wrapper
// checks).
// ---------------------------------------------------------------------------

static FaStrides fa_strides(const long long* s) { return FaStrides{s[0], s[1], s[2]}; }

template <typename K>
static cudaError_t fa_allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static bool fa_shape_ok(int kind, int hd, int B, int H, int T_len) {
  return (kind == 0 || kind == 1) && (hd == 64 || hd == 128) && B >= 1 && B <= 65535 &&
         H >= 1 && H <= 65535 && T_len >= 1;
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

// A 4-d tensor map over a bf16 [B, H, T, hd] view with element strides st
// (b, h, t) and a unit head-dim stride: the outer dims ordered by stride (a
// dim of size 1 last, its stride then immaterial), a box of 64 rows of t by
// 64 head-dim values (a tile is hd / 64 such boxes), 128-byte swizzle, zeros
// past T. pos gets each dim's coordinate slot. The caller checked the
// 16-byte alignment of the base and of each stride.
static CUresult fa_tensor_map(CUtensorMap* map, FaTmaPos* pos, const void* base,
                              const long long* st, int B, int H, int T_len, int hd) {
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
  cuuint64_t dims[4] = {(cuuint64_t)hd, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  long long span = (long long)hd * 2;  // bytes the dims so far cover
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

static size_t fa_tiles_list(int T_len) {
  return (size_t)((T_len + FA_TILE - 1) / FA_TILE) * sizeof(int);
}
static size_t fa_fwd_tc_smem(int T_len, int hd) { return FW_SMEM_FIXED(hd) + fa_tiles_list(T_len); }
static size_t fa_bwd_dq_tc_smem(int T_len, int hd) {
  return FB_DQ_SMEM_FIXED(hd) + fa_tiles_list(T_len);
}
static size_t fa_bwd_dkv_tc_smem(int T_len, int hd) {
  return FB_DKV_SMEM_FIXED(hd) + fa_tiles_list(T_len);
}

// the bf16 forward on the tensor cores; a refused tensor map returns
// 1000 + its CUresult
template <int HD>
static int fa_fwd_tc(const void* q, const long long* qs, const void* k, const void* v,
                     const long long* kvs, const int* qseg, const int* kvseg, void* o,
                     const long long* os, float* lse, int B, int H, int T_len, int P, float scale,
                     cudaStream_t s) {
  CUtensorMap qm, km, vm;
  FaTmaPos qp, kvp;
  CUresult r = fa_tensor_map(&qm, &qp, q, qs, B, H, T_len, HD);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(&km, &kvp, k, kvs, B, H, T_len, HD);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(&vm, &kvp, v, kvs, B, H, T_len, HD);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const int nq = (T_len + FA_TILE - 1) / FA_TILE;
  const size_t smem = fa_fwd_tc_smem(T_len, HD);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = fa_allow_smem(flash_fwd_tc_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_tc_kernel<HD><<<dim3(nq, H, B), FW_THREADS, smem, s>>>(
      qm, km, vm, qp, kvp, qseg, kvseg, reinterpret_cast<__nv_bfloat16*>(o), fa_strides(os), lse,
      H, T_len, P, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// the tensor maps of q, k, v and dO for the bf16 backward; 1000 + its
// CUresult when one is refused, else 0
static int fa_bwd_maps(CUtensorMap* m, FaTmaPos* pos, const void* q, const long long* qs,
                       const void* k, const void* v, const long long* kvs, const void* dout,
                       const long long* dos, int B, int H, int T_len, int hd) {
  CUresult r = fa_tensor_map(m, pos, q, qs, B, H, T_len, hd);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(m + 1, pos + 1, k, kvs, B, H, T_len, hd);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(m + 2, pos + 1, v, kvs, B, H, T_len, hd);
  if (r == CUDA_SUCCESS) r = fa_tensor_map(m + 3, pos + 2, dout, dos, B, H, T_len, hd);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// the bf16 dQ kernel on the tensor cores
template <int HD>
static int fa_bwd_dq_tc(const void* q, const long long* qs, const void* k, const void* v,
                        const long long* kvs, const void* o, const long long* os, const void* dout,
                        const long long* dos, const int* qseg, const int* kvseg, const float* lse,
                        float* di, void* dq, int B, int H, int T_len, int P, float scale,
                        cudaStream_t s) {
  CUtensorMap m[4];
  FaTmaPos pos[3];
  const int rc = fa_bwd_maps(m, pos, q, qs, k, v, kvs, dout, dos, B, H, T_len, HD);
  if (rc != 0) return rc;
  const size_t smem = fa_bwd_dq_tc_smem(T_len, HD);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = fa_allow_smem(flash_bwd_dq_tc_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_tc_kernel<HD>
      <<<dim3((T_len + FA_TILE - 1) / FA_TILE, H, B), FW_THREADS, smem, s>>>(
          m[0], m[1], m[2], m[3], pos[0], pos[1], pos[2],
          reinterpret_cast<const __nv_bfloat16*>(o), fa_strides(os),
          reinterpret_cast<const __nv_bfloat16*>(dout), fa_strides(dos), qseg, kvseg, lse, di,
          reinterpret_cast<__nv_bfloat16*>(dq), H, T_len, P, scale);
  return (int)cudaGetLastError();
}

// the bf16 dK/dV kernel on the tensor cores (HD / 64 warpgroups a block)
template <int HD>
static int fa_bwd_dkv_tc(const void* q, const long long* qs, const void* k, const void* v,
                         const long long* kvs, const void* dout, const long long* dos,
                         const int* qseg, const int* kvseg, const float* lse, const float* di,
                         void* dk, void* dv, int B, int H, int T_len, int P, float scale,
                         cudaStream_t s) {
  CUtensorMap m[4];
  FaTmaPos pos[3];
  const int rc = fa_bwd_maps(m, pos, q, qs, k, v, kvs, dout, dos, B, H, T_len, HD);
  if (rc != 0) return rc;
  const size_t smem = fa_bwd_dkv_tc_smem(T_len, HD);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = fa_allow_smem(flash_bwd_dkv_tc_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_tc_kernel<HD>
      <<<dim3((T_len + FA_TILE - 1) / FA_TILE, H, B), FW_THREADS * (HD / 64), smem, s>>>(
          m[0], m[1], m[2], m[3], pos[0], pos[1], pos[2], qseg, kvseg, lse, di,
          reinterpret_cast<__nv_bfloat16*>(dk), reinterpret_cast<__nv_bfloat16*>(dv), H, T_len,
          P, scale);
  return (int)cudaGetLastError();
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
  if (kind == 1)
    return hd == 64 ? fa_fwd_tc<64>(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H, T_len, P, scale, s)
                    : fa_fwd_tc<128>(q, qs, k, v, kvs, qsg, ksg, o, os, l, B, H, T_len, P, scale,
                                     s);
  return fa_fwd_f32(q, qs, k, v, kvs, qsg, ksg, o, os, l, hd, B, H, T_len, P, scale, s);
}

// the bf16 kernels' dynamic shared memory per block at this T and head dim,
// in bytes
extern "C" int vx_flash_attention_fwd_smem(int T_len, int hd) {
  return (int)fa_fwd_tc_smem(T_len, hd);
}
extern "C" int vx_flash_attention_bwd_smem(int T_len, int dkv, int hd) {
  return (int)(dkv ? fa_bwd_dkv_tc_smem(T_len, hd) : fa_bwd_dq_tc_smem(T_len, hd));
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
  if (kind == 1)
    return hd == 64 ? fa_bwd_dq_tc<64>(q, qs, k, v, kvs, o, os, dout, dos, qsg, ksg, l, d, dq, B,
                                       H, T_len, P, scale, s)
                    : fa_bwd_dq_tc<128>(q, qs, k, v, kvs, o, os, dout, dos, qsg, ksg, l, d, dq,
                                        B, H, T_len, P, scale, s);
  return fa_bwd_dq_f32(q, qs, k, v, kvs, o, os, dout, dos, qsg, ksg, l, d, dq, hd, B, H, T_len, P,
                       scale, s);
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
  if (kind == 1)
    return hd == 64 ? fa_bwd_dkv_tc<64>(q, qs, k, v, kvs, dout, dos, qsg, ksg, l, d, dk, dv, B, H,
                                        T_len, P, scale, s)
                    : fa_bwd_dkv_tc<128>(q, qs, k, v, kvs, dout, dos, qsg, ksg, l, d, dk, dv, B,
                                         H, T_len, P, scale, s);
  return fa_bwd_dkv_f32(q, qs, k, v, kvs, dout, dos, qsg, ksg, l, d, dk, dv, hd, B, H, T_len, P,
                        scale, s);
}
