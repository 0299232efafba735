// flash_attention_f32_bwd: the f32 backward of flash_attention on the CUDA
// cores, flash_bwd_dq_ffma_kernel<HD> then flash_bwd_dkv_ffma_kernel<HD>
// (hd 64 and 128), for --dtype float32 training.
//
// Replaces, for f32, the JAX library's Pallas flash attention backward
// (_flash_attention_bwd_dq and _flash_attention_bwd_dkv) as
// vallex_tpu/models/layers.py reaches it through attention_core_flash (:205)
// and attention_core_flash_prefix (:259), with the mask of
// flash_attention.cu: key j is valid for query i iff q_seg[b, i] ==
// kv_seg[b, j] and j <= max(i, P - 1). Launched by vx_flash_attention_bwd_dq
// and vx_flash_attention_bwd_dkv (flash_attention.cu) for kind 0, on one
// stream: the dQ kernel writes di = sum(O * dO) for the dK/dV kernel.
//
// Every product is an f32 FMA (tensor cores in f32 would round to TF32).
// p = exp2(s * scale * log2(e) - lse * log2(e)) on the valid pairs, 0 on the
// others; ds = p * (dp - di) * scale. No atomics: each output element is one
// block's sum in a fixed order, so two runs are bitwise equal. Rows without a
// valid key give zero gradients.
//
// Bound on the H100 at the training shapes (B = 4, T = 1152; H = 16 at hd
// 64, 8 at hd 128): the operations, 6 * hd per valid pair in the dQ kernel
// (q.k, dO.v, ds.k) and 8 * hd in the dK/dV kernel (k.q, v.dO, p.dO, ds.q)
// at 67 TFLOP/s (0.17 / 0.22 ms at prefix 128, 0.33 / 0.44 ms at prefix T).
// What the design does about it:
//  - one block of FF_THREADS = 256 threads (8 warps) per own tile of
//    FG_ROWS = 64 rows, one block per SM; the own tile's two operands stay
//    in shared memory (Q and dO in the dQ kernel, K and V in the dK/dV
//    kernel), the other side's two operands stream as pairs of tiles of 64
//    rows (V and K; Q and dO) through a ring of FG_SLOTS = 2 pairs of
//    [64][HD + 4] (16-byte cp.async.cg copies, rows past T zero-filled, one
//    commit group per pair, one pair ahead). Shared memory at T = 2304: dQ
//    125,856 / 224,160 bytes, dK/dV 147,360 / 225,184 (hd 64 / 128).
//  - masked work is skipped before any load (ff_visit): the dQ kernel lists
//    the key tiles [0, max(q0 + 64, P)) its query tile meets, the dK/dV
//    kernel the query tiles from its key tile on (from 0 when the key tile
//    starts below P); a skipped tile is never loaded, a FULL one uses its
//    scores unmasked.
//  - a 1-d grid over every head and row, longest blocks first: the dQ
//    kernel takes the latest query tiles first, the dK/dV kernel the
//    earliest key tiles (under a causal bound both see the most).
//  - the two score products of a pair run side by side: warps 0-3 (group
//    0) S = Q K^T (S^T = K Q^T) and p, warps 4-7 (group 1) dP = dO V^T
//    (dP^T = V dO^T). Thread (gy, tx) of a group's 8 x 16 grid (a warp: two
//    gy, sixteen tx) holds own rows gy + 8 a (a < 8) against streamed rows
//    tx + 16 j (j < 4): an 8 x 4 tile read along d by ld.shared.v4
//    (fg_scores: per 4 d, 8 + 4 float4 for 128 FMAs; a row group's sixteen
//    lanes read each own float4 as one broadcast, rows HD + 4 floats apart
//    put the sixteen streamed rows in distinct bank quads). p crosses to
//    group 1 through a [64][FF_PLD] tile (rows 80 floats apart: a warp's
//    two rows 16 banks apart), where group 1 makes ds = p (dp - di) scale.
//  - the output products keep 8 x 4 tiles too (fg_accumulate: per 4
//    streamed rows, 8 + 4 float4 for 128 FMAs): in the dQ kernel each group
//    sums dQ = ds K over half the keys of every tile (8 x HD / 16 a thread),
//    and the two halves are added once at the end, group 0's plus group
//    1's; in the dK/dV kernel at hd 64 group 0 sums dV = p^T dO and group 1
//    dK = ds^T Q from a tile each, at hd 128 (no room for the second tile)
//    ds^T replaces p^T after dV and every thread sums both outputs over
//    its group's 64 head columns.
// // ---------------------------------------------------------------------------
#include "flash_attention_f32.cuh"

#define FG_ROWS 64   // a block's own rows
#define FG_SLOTS 2   // the ring of streamed pairs of tiles of 64 rows
#define FG_LOG2E 1.4426950408889634f
// 2^x by ex2.approx (a few ulp; denormal results flush to 0)
__device__ __forceinline__ float fg_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s[a][j] = sum_d A[gy + 8 a][d] * X[tx + 16 j][d]: own rows A against the
// streamed rows X, both [64][HD + 4]
template <int HD>
__device__ __forceinline__ void fg_scores(const float* A, const float* X, int tx, int gy,
                                          float (&s)[8][4]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[8], xv[4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (gy + 8 * a) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xv[j] = *reinterpret_cast<const float4*>(X + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[a][j];
        x = fmaf(av[a].x, xv[j].x, x);
        x = fmaf(av[a].y, xv[j].y, x);
        x = fmaf(av[a].z, xv[j].z, x);
        s[a][j] = fmaf(av[a].w, xv[j].w, x);
      }
  }
}

// acc[a][4 c + u] += sum_kk W[gy + 8 a][kk] * X[kk][col0 + 4 tx + 64 c + u]
// over kk in [kk0, kk0 + KK), in order, UNROLL steps of 4 at a time: W
// [64][FF_PLD] (p, ds or their transposes), X [64][HD + 4]
template <int HD, int NC, int KK, int UNROLL>
__device__ __forceinline__ void fg_accumulate(const float* W, const float* X, int kk0, int col0,
                                              int tx, int gy, float (&acc)[8][4 * NC]) {
  constexpr int LD = HD + 4;
#pragma unroll UNROLL
  for (int kk = kk0; kk < kk0 + KK; kk += 4) {
    float4 wv[8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
      wv[a] = *reinterpret_cast<const float4*>(W + (gy + 8 * a) * FF_PLD + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 xv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        xv[c] = *reinterpret_cast<const float4*>(X + (kk + u) * LD + col0 + 4 * tx + 64 * c);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float w = ff_at(wv[a], u);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[a][4 * c] = fmaf(w, xv[c].x, acc[a][4 * c]);
          acc[a][4 * c + 1] = fmaf(w, xv[c].y, acc[a][4 * c + 1]);
          acc[a][4 * c + 2] = fmaf(w, xv[c].z, acc[a][4 * c + 2]);
          acc[a][4 * c + 3] = fmaf(w, xv[c].w, acc[a][4 * c + 3]);
        }
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void fg_zero(float (&acc)[8][N]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < N; ++c) acc[a][c] = 0.f;
}

// a thread's rows t0 + gy + 8 a (those below T), columns col0 + 4 tx + 64 c,
// of one (b, h) slice of a contiguous [B, H, T, HD] output
template <int HD, int NC>
__device__ __forceinline__ void fg_store(float* out, const float (&acc)[8][4 * NC], int t0,
                                         int col0, int T_len, int tx, int gy) {
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int t = t0 + gy + 8 * a;
    if (t >= T_len) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(out + (long long)t * HD + col0 + 4 * tx + 64 * c) =
          make_float4(acc[a][4 * c], acc[a][4 * c + 1], acc[a][4 * c + 2], acc[a][4 * c + 3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(FF_THREADS, 1)
    flash_bwd_dq_ffma_kernel(const float* __restrict__ q, FaStrides qs,
                             const float* __restrict__ k, const float* __restrict__ v,
                             FaStrides kvs, const float* __restrict__ o, FaStrides os,
                             const float* __restrict__ dout, FaStrides dos,
                             const int* __restrict__ qseg, const int* __restrict__ kvseg,
                             const float* __restrict__ lse, float* __restrict__ di_out,
                             float* __restrict__ dq, int H, int T_len, int P, float scale) {
  constexpr int LD = HD + 4, R = FG_ROWS, TILE = FA_TILE * LD, NC = HD / 64;
  extern __shared__ __align__(16) float fg_smem[];
  float* Qs = fg_smem;
  float* dOs = Qs + R * LD;
  float* ring = dOs + R * LD;  // FG_SLOTS pairs: V, then K of a key tile
  float* Ws = ring + FG_SLOTS * 2 * TILE;  // p, then ds in place
  float* lse_s = Ws + R * FF_PLD;           // log2 units
  float* di_s = lse_s + R;
  int* segq = reinterpret_cast<int*>(di_s + R);
  int* count = segq + R;
  int* tiles = count + 4;

  // warps 0-3 (group 0) and 4-7 (group 1): thread (gy, tx) of its group's
  // 8 x 16 grid holds rows gy + 8 a
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = warp >> 2, gy = 2 * (warp & 3) + (lane >> 4), tx = lane & 15;
  // the latest query tiles (under a causal bound the longest) first
  const int nq = (T_len + R - 1) / R, B = gridDim.x / (nq * H);
  const int h = blockIdx.x % H, rest = blockIdx.x / H, b = rest % B;
  const int q0 = (nq - 1 - rest / B) * R;
  const long long bh = (long long)b * H + h;
  const float* kb = k + b * kvs.b + h * kvs.h;
  const float* vb = v + b * kvs.b + h * kvs.h;
  const int* ksg = kvseg + (long long)b * T_len;
  const float scale_log2 = scale * FG_LOG2E;

  ff_load_tile<HD, R>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, T_len);
  ff_load_tile<HD, R>(dOs, dout + b * dos.b + h * dos.h, dos.t, q0, T_len);
  {  // di = sum_c O[i, c] dO[i, c] in f32, four lanes a row; lse, ids
    const int r = tid >> 2, part = tid & 3, i = q0 + r;
    float acc = 0.f;
    if (i < T_len) {
      const float* orow = o + b * os.b + h * os.h + i * os.t;
      const float* drow = dout + b * dos.b + h * dos.h + i * dos.t;
#pragma unroll 4
      for (int c = 4 * part; c < HD; c += 16) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(drow + c);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
    acc += __shfl_xor_sync(VX_FULL_MASK, acc, 1);
    acc += __shfl_xor_sync(VX_FULL_MASK, acc, 2);
    if (part == 0) {
      di_s[r] = acc;
      lse_s[r] = i < T_len ? lse[bh * T_len + i] * FG_LOG2E : 0.f;
      segq[r] = i < T_len ? qseg[(long long)b * T_len + i] : FA_PAD_Q;
      if (i < T_len) di_out[bh * T_len + i] = acc;
    }
  }
  __syncthreads();
  // the key tiles this tile can see (up to max(q0 + R, P)), classified
  const int kend = min(T_len, max(q0 + R, P));
  const int n =
      ff_visit<R, true>(segq, q0, ksg, 0, (kend + FA_TILE - 1) / FA_TILE, T_len, P, tiles, count);
  // pair t: V and K of visited key tile t; a group even when empty
  auto issue = [&](int t) {
    if (t < n) {
      float* slot = ring + (t % FG_SLOTS) * 2 * TILE;
      const int k0 = (tiles[t] >> 1) * FA_TILE;
      ff_load_tile<HD, FA_TILE>(slot, vb, kvs.t, k0, T_len);
      ff_load_tile<HD, FA_TILE>(slot + TILE, kb, kvs.t, k0, T_len);
    }
    ff_commit();
  };
  issue(0);  // in one group with the Q and dO tiles

  float acc[8][HD / 16];  // dQ over keys 32 group .. 32 group + 31 of every tile
  fg_zero(acc);
  for (int t = 0; t < n; ++t) {
    // pair t has landed for every thread, and every thread is done with
    // pair t - 1, whose slot pair t + 1 then takes
    ff_wait<0>();
    __syncthreads();
    issue(t + 1);
    const float* Vt = ring + (t % FG_SLOTS) * 2 * TILE;
    const float* Kt = Vt + TILE;
    const int e = tiles[t], k0 = (e >> 1) * FA_TILE;
    float sc[8][4];
    if (group == 0) {
      // p = exp2(s * scale - lse) on the valid pairs into Ws
      fg_scores<HD>(Qs, Kt, tx, gy, sc);
      const bool masked = e & FF_MASKED;
      int sk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        sk[j] = masked && c < T_len ? ksg[c] : FA_PAD_K;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = gy + 8 * a;
        const float lr = lse_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = fg_exp2(fmaf(sc[a][j], scale_log2, -lr));
          const bool ok = !masked || fa_valid(q0 + r, k0 + tx + 16 * j, P, segq[r], sk[j]);
          Ws[r * FF_PLD + tx + 16 * j] = ok ? p : 0.f;
        }
      }
    } else {
      fg_scores<HD>(dOs, Vt, tx, gy, sc);  // dP = dO V^T, then (dP - di) scale
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float dr = di_s[gy + 8 * a];
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[a][j] = (sc[a][j] - dr) * scale;
      }
    }
    __syncthreads();
    if (group == 1)  // ds = p (dp - di) scale, in place
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ws[(gy + 8 * a) * FF_PLD + tx + 16 * j] *= sc[a][j];
    __syncthreads();
    fg_accumulate<HD, NC, 32, 8>(Ws, Kt, 32 * group, 0, tx, gy, acc);  // dQ += dS K
  }
  // dQ = group 0's sum + group 1's, through the ring once every copy and
  // every read of it is done
  ff_wait<0>();
  __syncthreads();
  if (group == 1)
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        *reinterpret_cast<float4*>(ring + (gy + 8 * a) * LD + 4 * tx + 64 * c) =
            make_float4(acc[a][4 * c], acc[a][4 * c + 1], acc[a][4 * c + 2], acc[a][4 * c + 3]);
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(ring + (gy + 8 * a) * LD + 4 * tx +
                                                          64 * c);
        acc[a][4 * c] += x.x;
        acc[a][4 * c + 1] += x.y;
        acc[a][4 * c + 2] += x.z;
        acc[a][4 * c + 3] += x.w;
      }
    fg_store<HD, NC>(dq + bh * T_len * HD, acc, q0, 0, T_len, tx, gy);
  }
}

template <int HD>
__global__ void __launch_bounds__(FF_THREADS, 1)
    flash_bwd_dkv_ffma_kernel(const float* __restrict__ q, FaStrides qs,
                              const float* __restrict__ k, const float* __restrict__ v,
                              FaStrides kvs, const float* __restrict__ dout, FaStrides dos,
                              const int* __restrict__ qseg, const int* __restrict__ kvseg,
                              const float* __restrict__ lse, const float* __restrict__ di,
                              float* __restrict__ dk, float* __restrict__ dv, int H, int T_len,
                              int P, float scale) {
  // at hd 64 p^T and ds^T have a tile each and group 0 sums dV, group 1 dK;
  // at hd 128 (no room for the second tile) ds^T replaces p^T and every
  // thread sums both, group g over head columns 64 g .. 64 g + 63
  constexpr bool TWO_W = HD == 64;
  constexpr int LD = HD + 4, R = FG_ROWS, TILE = FA_TILE * LD, UNROLL = TWO_W ? 4 : 16;
  extern __shared__ __align__(16) float fg_smem[];
  float* Ks = fg_smem;
  float* Vs = Ks + R * LD;
  float* ring = Vs + R * LD;                // FG_SLOTS pairs: Q, then dO of a query tile
  float* Pt = ring + FG_SLOTS * 2 * TILE;  // p^T: [key][query]
  float* dSt = TWO_W ? Pt + R * FF_PLD : Pt;  // ds^T
  float* clse = dSt + R * FF_PLD;          // [2][64] a query tile's lse,
  float* cdi = clse + 2 * FA_TILE;         // di
  int* cseg = reinterpret_cast<int*>(cdi + 2 * FA_TILE);  // and ids, by tile parity
  int* segk = cseg + 2 * FA_TILE;
  int* count = segk + R;
  int* tiles = count + 4;

  // warps 0-3 (group 0) and 4-7 (group 1): thread (gy, tx) of its group's
  // 8 x 16 grid holds key rows gy + 8 a
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = warp >> 2, gy = 2 * (warp & 3) + (lane >> 4), tx = lane & 15;
  // the earliest key tiles (under a causal bound the longest) first
  const int nk = (T_len + R - 1) / R, B = gridDim.x / (nk * H);
  const int h = blockIdx.x % H, rest = blockIdx.x / H, b = rest % B;
  const int k0 = rest / B * R;
  const long long bh = (long long)b * H + h;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const int* qsg = qseg + (long long)b * T_len;
  const float scale_log2 = scale * FG_LOG2E;

  ff_load_tile<HD, R>(Ks, k + b * kvs.b + h * kvs.h, kvs.t, k0, T_len);
  ff_load_tile<HD, R>(Vs, v + b * kvs.b + h * kvs.h, kvs.t, k0, T_len);
  if (tid < R) segk[tid] = k0 + tid < T_len ? kvseg[(long long)b * T_len + k0 + tid] : FA_PAD_K;
  __syncthreads();
  // the query tiles that can see this key tile (rows below it only through
  // the prefix, keys j < P), classified
  const int n = ff_visit<R, false>(segk, k0, qsg, k0 < P ? 0 : k0 / FA_TILE,
                                   (T_len + FA_TILE - 1) / FA_TILE, T_len, P, tiles, count);
  // pair t: Q and dO of visited query tile t, with its lse, di and ids; a
  // group even when empty
  auto issue = [&](int t) {
    if (t < n) {
      float* slot = ring + (t % FG_SLOTS) * 2 * TILE;
      const int t0 = (tiles[t] >> 1) * FA_TILE;
      ff_load_tile<HD, FA_TILE>(slot, qb, qs.t, t0, T_len);
      ff_load_tile<HD, FA_TILE>(slot + TILE, dob, dos.t, t0, T_len);
      if (tid < FA_TILE) {
        const int col = (t & 1) * FA_TILE + tid, i = t0 + tid;
        const bool in = i < T_len;
        const long long at = bh * T_len + (in ? i : 0);
        ff_cp4(clse + col, lse + at, in);
        ff_cp4(cdi + col, di + at, in);
        if (in)
          ff_cp4(cseg + col, qsg + i, true);
        else
          cseg[col] = FA_PAD_Q;
      }
    }
    ff_commit();
  };
  issue(0);  // in one group with the K and V tiles

  float dva[8][4], dka[8][4];
  fg_zero(dva);
  fg_zero(dka);
  const int col0 = TWO_W ? 0 : 64 * group;
  for (int t = 0; t < n; ++t) {
    // pair t has landed for every thread, and every thread is done with
    // pair t - 1, whose slot pair t + 1 then takes
    ff_wait<0>();
    __syncthreads();
    issue(t + 1);
    const float* Qt = ring + (t % FG_SLOTS) * 2 * TILE;
    const float* dOt = Qt + TILE;
    const int e = tiles[t], q0 = (e >> 1) * FA_TILE, buf = (t & 1) * FA_TILE;
    float sc[8][4];
    if (group == 0) {
      // p^T on the valid pairs into Pt: key rows gy + 8 a, query columns tx + 16 j
      fg_scores<HD>(Ks, Qt, tx, gy, sc);
      const bool masked = e & FF_MASKED;
      float lc[4];
      int sq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lc[j] = clse[buf + tx + 16 * j] * FG_LOG2E;
        sq[j] = cseg[buf + tx + 16 * j];
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = gy + 8 * a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = fg_exp2(fmaf(sc[a][j], scale_log2, -lc[j]));
          const bool ok = !masked || fa_valid(q0 + tx + 16 * j, k0 + r, P, sq[j], segk[r]);
          Pt[r * FF_PLD + tx + 16 * j] = ok ? p : 0.f;
        }
      }
    } else {
      fg_scores<HD>(Vs, dOt, tx, gy, sc);  // dP^T = V dO^T, then (dP^T - di) scale
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dc = cdi[buf + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 8; ++a) sc[a][j] = (sc[a][j] - dc) * scale;
      }
    }
    __syncthreads();
    if (group == 1)  // ds^T = p^T (dp^T - di) scale
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[a][j] *= Pt[(gy + 8 * a) * FF_PLD + tx + 16 * j];
    if (TWO_W) {
      if (group == 1)
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) dSt[(gy + 8 * a) * FF_PLD + tx + 16 * j] = sc[a][j];
      __syncthreads();
      if (group == 0)
        fg_accumulate<HD, 1, 64, UNROLL>(Pt, dOt, 0, 0, tx, gy, dva);  // dV += P^T dO
      else
        fg_accumulate<HD, 1, 64, UNROLL>(dSt, Qt, 0, 0, tx, gy, dka);  // dK += dS^T Q
    } else {
      fg_accumulate<HD, 1, 64, UNROLL>(Pt, dOt, 0, col0, tx, gy, dva);  // dV += P^T dO
      __syncthreads();  // every read of p^T done
      if (group == 1)
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) dSt[(gy + 8 * a) * FF_PLD + tx + 16 * j] = sc[a][j];
      __syncthreads();
      fg_accumulate<HD, 1, 64, UNROLL>(dSt, Qt, 0, col0, tx, gy, dka);  // dK += dS^T Q
    }
  }
  ff_wait<0>();  // no copy outlives the block (K and V when no query tile is visited)
  if (!TWO_W || group == 0) fg_store<HD, 1>(dv + bh * T_len * HD, dva, k0, col0, T_len, tx, gy);
  if (!TWO_W || group == 1) fg_store<HD, 1>(dk + bh * T_len * HD, dka, k0, col0, T_len, tx, gy);
}

// dynamic shared memory: the own tile's two operands, the ring, the p / ds
// tile (two for dK/dV at hd 64), then the dQ kernel's lse, di and ids of its
// rows or the dK/dV kernel's two column buffers and its key ids; the count
// and tile list
static size_t fa_bwd_ffma_smem(int T_len, int hd, int dkv) {
  const size_t floats = (size_t)(2 * FG_ROWS + FG_SLOTS * 2 * FA_TILE) * (hd + 4) +
                        (dkv && hd == 64 ? 2 : 1) * FG_ROWS * FF_PLD;
  const size_t words = (dkv ? 3 * 2 * FA_TILE + FG_ROWS : 3 * FG_ROWS) + 4 +
                       (T_len + FA_TILE - 1) / FA_TILE;
  return (floats + words) * sizeof(float);
}

template <typename K>
static cudaError_t fg_prepare(K kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// one block per own tile, head and row
static long long fg_blocks(int B, int H, int T_len) {
  return (long long)((T_len + FG_ROWS - 1) / FG_ROWS) * H * B;
}

static FaStrides fg_strides(const long long* s) { return FaStrides{s[0], s[1], s[2]}; }

template <int HD>
static int fa_bwd_dq_ffma(const void* q, const long long* qs, const void* k, const void* v,
                          const long long* kvs, const void* o, const long long* os,
                          const void* dout, const long long* dos, const int* qseg,
                          const int* kvseg, const float* lse, float* di, void* dq, int B, int H,
                          int T_len, int P, float scale, cudaStream_t s) {
  const size_t smem = fa_bwd_ffma_smem(T_len, HD, 0);
  const cudaError_t e = fg_prepare(flash_bwd_dq_ffma_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = fg_blocks(B, H, T_len);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_bwd_dq_ffma_kernel<HD><<<(unsigned)blocks, FF_THREADS, smem, s>>>(
      reinterpret_cast<const float*>(q), fg_strides(qs), reinterpret_cast<const float*>(k),
      reinterpret_cast<const float*>(v), fg_strides(kvs), reinterpret_cast<const float*>(o),
      fg_strides(os), reinterpret_cast<const float*>(dout), fg_strides(dos), qseg, kvseg, lse,
      di, reinterpret_cast<float*>(dq), H, T_len, P, scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int fa_bwd_dkv_ffma(const void* q, const long long* qs, const void* k, const void* v,
                           const long long* kvs, const void* dout, const long long* dos,
                           const int* qseg, const int* kvseg, const float* lse, const float* di,
                           void* dk, void* dv, int B, int H, int T_len, int P, float scale,
                           cudaStream_t s) {
  const size_t smem = fa_bwd_ffma_smem(T_len, HD, 1);
  const cudaError_t e = fg_prepare(flash_bwd_dkv_ffma_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = fg_blocks(B, H, T_len);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_bwd_dkv_ffma_kernel<HD><<<(unsigned)blocks, FF_THREADS, smem, s>>>(
      reinterpret_cast<const float*>(q), fg_strides(qs), reinterpret_cast<const float*>(k),
      reinterpret_cast<const float*>(v), fg_strides(kvs), reinterpret_cast<const float*>(dout),
      fg_strides(dos), qseg, kvseg, lse, di, reinterpret_cast<float*>(dk),
      reinterpret_cast<float*>(dv), H, T_len, P, scale);
  return (int)cudaGetLastError();
}

int fa_bwd_dq_f32(const void* q, const long long* qs, const void* k, const void* v,
                  const long long* kvs, const void* o, const long long* os, const void* dout,
                  const long long* dos, const int* qseg, const int* kvseg, const float* lse,
                  float* di, void* dq, int hd, int B, int H, int T_len, int P, float scale,
                  cudaStream_t s) {
  return hd == 64 ? fa_bwd_dq_ffma<64>(q, qs, k, v, kvs, o, os, dout, dos, qseg, kvseg, lse, di,
                                       dq, B, H, T_len, P, scale, s)
                  : fa_bwd_dq_ffma<128>(q, qs, k, v, kvs, o, os, dout, dos, qseg, kvseg, lse,
                                        di, dq, B, H, T_len, P, scale, s);
}

int fa_bwd_dkv_f32(const void* q, const long long* qs, const void* k, const void* v,
                   const long long* kvs, const void* dout, const long long* dos,
                   const int* qseg, const int* kvseg, const float* lse, const float* di,
                   void* dk, void* dv, int hd, int B, int H, int T_len, int P, float scale,
                   cudaStream_t s) {
  return hd == 64 ? fa_bwd_dkv_ffma<64>(q, qs, k, v, kvs, dout, dos, qseg, kvseg, lse, di, dk,
                                        dv, B, H, T_len, P, scale, s)
                  : fa_bwd_dkv_ffma<128>(q, qs, k, v, kvs, dout, dos, qseg, kvseg, lse, di, dk,
                                         dv, B, H, T_len, P, scale, s);
}

template <typename K>
static int fg_warps(K kernel, size_t smem) {
  int blocks = 0;
  cudaError_t e = fg_prepare(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, FF_THREADS, smem);
  return e == cudaSuccess ? blocks * (FF_THREADS / 32) : -(int)e;
}

// the f32 dQ (dkv = 0) or dK/dV (dkv = 1) kernel's dynamic shared memory per
// block at this T and head dim, in bytes
extern "C" int vx_flash_attention_bwd_f32_smem(int T_len, int dkv, int hd) {
  return (int)fa_bwd_ffma_smem(T_len, hd, dkv);
}

// the f32 dQ (dkv = 0) or dK/dV (dkv = 1) kernel's resident warps per SM at
// this T and head dim (its dynamic shared memory allowed first); a negative
// CUDA error on failure
extern "C" int vx_flash_attention_bwd_f32_warps(int T_len, int dkv, int hd) {
  const size_t smem = fa_bwd_ffma_smem(T_len, hd, dkv);
  if (dkv)
    return hd == 64 ? fg_warps(flash_bwd_dkv_ffma_kernel<64>, smem)
                    : fg_warps(flash_bwd_dkv_ffma_kernel<128>, smem);
  return hd == 64 ? fg_warps(flash_bwd_dq_ffma_kernel<64>, smem)
                  : fg_warps(flash_bwd_dq_ffma_kernel<128>, smem);
}
