// The pieces the f32 flash kernels on the CUDA cores share: the forward
// (flash_attention_f32.cu) and the backward (flash_attention_f32_bwd.cu).
// Blocks of FF_THREADS threads; tiles in shared memory with rows HD + 4
// floats apart (16-byte aligned, and sixteen rows read along d fall in
// distinct bank quads), filled by 16-byte cp.async.cg copies; the rule that
// skips masked tiles before any load (ff_visit).
#pragma once

#include "flash_attention.cuh"

#define FF_THREADS 256         // 8 warps, a 16 x 16 grid of threads
#define FF_PLD (FA_TILE + 16)  // row stride of a [rows][64] p or ds tile
// tile classes (the low bit of a listed tile), as flash_attention.cu's
#define FF_FULL 0
#define FF_MASKED 1

__device__ __forceinline__ void ff_cp16(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
// one 4-byte word; zero when !in (its source not read)
__device__ __forceinline__ void ff_cp4(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void ff_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are pending
template <int N>
__device__ __forceinline__ void ff_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [t0, t0 + ROWS) of one (b, h) slice into a [ROWS][HD + 4] f32 tile by
// 16-byte cp.async; rows past T are zero-filled and their source not read
template <int HD, int ROWS>
__device__ __forceinline__ void ff_load_tile(float* dst, const float* src, long long st, int t0,
                                             int T_len) {
  constexpr int C4 = HD / 4;
#pragma unroll
  for (int i = 0; i < ROWS * C4 / FF_THREADS; ++i) {
    const int idx = threadIdx.x + i * FF_THREADS, r = idx / C4, c = idx % C4, t = t0 + r;
    const bool in = t < T_len;
    ff_cp16(dst + r * (HD + 4) + 4 * c, src + (in ? t * st : 0) + 4 * c, in);
  }
}

// The tiles of 64 rows of the other side, [t_lo, t_hi), that a block's own
// tile of OWN rows meets, classified as flash_attention.cu's fa_visit
// classifies them (one warp per tile): skipped when no own id equals one of
// the tile's ids (every pair is masked, so it adds exactly 0); FULL when every
// pair has one id and lies inside T and the causal bound; else MASKED, pair
// by pair. OWN_IS_QUERY: the own tile holds queries (the forward and the dQ
// kernel list key tiles) or keys (the dK/dV kernel lists query tiles).
// own_seg: the own tile's ids in shared memory; other_seg: the other side's
// ids of this batch row. Lists the visited tiles in order as
// (tile << 1 | class) in tiles[], their number in *count, and returns it to
// every thread. kernels/flash_attention.py's visit_tiles_plain is its plain
// version.
template <int OWN, bool OWN_IS_QUERY>
__device__ int ff_visit(const int* own_seg, int own0, const int* other_seg, int t_lo, int t_hi,
                        int T_len, int P, int* tiles, int* count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int omin = INT_MAX, omax = INT_MIN;
#pragma unroll
  for (int r = lane; r < OWN; r += 32) {
    const bool in = own0 + r < T_len;
    omin = min(omin, in ? own_seg[r] : INT_MAX);
    omax = max(omax, in ? own_seg[r] : INT_MIN);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    omin = min(omin, __shfl_xor_sync(VX_FULL_MASK, omin, s));
    omax = max(omax, __shfl_xor_sync(VX_FULL_MASK, omax, s));
  }
  const bool own_whole = own0 + OWN <= T_len && omin == omax;
  const int pad = OWN_IS_QUERY ? FA_PAD_K : FA_PAD_Q;
  for (int t = t_lo + warp; t < t_hi; t += FF_THREADS / 32) {
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
    // the last key against max(q0, P - 1), the least bound of the query rows
    const int q0 = OWN_IS_QUERY ? own0 : x0;
    const int k_last = OWN_IS_QUERY ? x0 + FA_TILE - 1 : own0 + OWN - 1;
    int cls = -1;  // skipped
    if (xmax < omin || xmin > omax) {
      cls = -1;
    } else if (own_whole && xmin == xmax && xmin == omin && x0 + FA_TILE <= T_len &&
               k_last <= max(q0, P - 1)) {
      cls = FF_FULL;
    } else {
      bool hit = false;  // the vote: any own id equal to one of this lane's ids
      for (int r = 0; r < OWN; ++r) {
        const int so = own_seg[r];
        hit |= (so == xa) | (so == xc);
      }
      cls = __any_sync(VX_FULL_MASK, hit) ? FF_MASKED : -1;
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

__device__ __forceinline__ float ff_at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
