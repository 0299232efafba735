// flash_attention_f32: the f32 forward of flash_attention on the CUDA cores,
// flash_fwd_ffma_kernel<HD> (hd 64 and 128), for compute_dtype="float32"
// serving (the NAR at s_text + t_audio >= 1536) and --dtype float32 training.
//
// Replaces, for f32, the JAX library's Pallas flash attention forward as
// vallex_tpu/models/layers.py calls it: attention_core_flash (:205, segment
// ids, causal or not) and attention_core_flash_prefix (:259, the AR's
// prefix-causal mask), with the mask of flash_attention.cu: key j is valid
// for query i iff q_seg[b, i] == kv_seg[b, j] and j <= max(i, P - 1).
// Launched by vx_flash_attention_fwd (flash_attention.cu) for kind 0.
#include "flash_attention_f32.cuh"

// ---------------------------------------------------------------------------
// Every product is an f32 FMA (tensor cores in f32 would round q, k, v and p
// to TF32). Bound on the H100 at the training shapes (B = 4, T = 1152; H = 16
// at hd 64, 8 at hd 128): the operations, 4 * hd per valid pair at 67 TFLOP/s
// (0.11 ms at prefix 128, 0.22 ms at prefix T). What the design does about it:
//  - one block of FF_THREADS = 256 threads (8 warps) per query tile of
//    FF_ROWS = 128 rows, one block per SM at either head dim (8 warps
//    resident); a 1-d grid ordered by query tile, the latest (under a
//    causal bound the longest) first over all heads and rows. Shared
//    memory: the Q tile [128][HD + 4], a ring of FF_SLOTS = 3 slots
//    [64][HD + 4], P [128][64 + 16], the query tile's ids and the list of
//    visited key tiles: 210,592 bytes at hd 128 and 128,672 at hd 64
//    (T = 2304).
//  - K and V are separate items of the ring (K of the first visited tile, its
//    V, K of the next, ...): while one item is computed the next two load by
//    16-byte cp.async.cg copies, one commit group per item; rows past T are
//    zero-filled (src-size 0), since a leftover NaN times p = 0 is NaN. One
//    __syncthreads per item: after it, the item has landed for every thread
//    and every thread is done with the previous item, whose slot the next
//    load then takes.
//  - masked work is skipped before any load, by flash_attention.cu's
//    fa_visit rule over the 128-row tile (ff_visit): a key tile without an id equal to one of the
//    query tile's is never loaded, a FULL one uses its scores unmasked.
//  - thread (ty, tx) of a 16 x 16 grid (a warp: two ty, sixteen tx) holds the
//    query rows ty + 16 a (a < 8): an 8 x 4 tile of the scores (keys
//    tx + 16 j) and an 8 x HD / 16 tile of O (columns 4 tx + 64 c, one
//    float4 per c < HD / 64). The online softmax's row max and sum run over
//    the sixteen tx lanes by shuffles.
//  - S = Q K^T reads Q and K with ld.shared.v4 along d: per 4 d, 8 + 4
//    float4 for 128 FMAs; P V reads P along keys and V along d: per 4 keys,
//    8 + 4 HD / 64 float4 for 32 HD / 16 FMAs (0.25 words per FMA at hd 128).
//    The sixteen lanes of a row group read each Q (P) float4 as one
//    broadcast, so a warp's S step reads 16 wavefronts of 128 bytes per 4,096
//    FMAs (0.125 words per FMA for the SM). Rows are HD + 4 floats apart:
//    16-byte aligned, and the sixteen K rows a warp reads along d fall in
//    distinct bank quads (two wavefronts per 256 bytes, no conflict); P's
//    row stride of 80 floats puts a warp's two rows 16 banks apart for its
//    scalar stores.
//  - scores are q.k in f32, times scale * log2(e) (exp2 in log2 units); lse
//    leaves in natural-log units.
// ---------------------------------------------------------------------------

#define FF_ROWS 128            // the forward's query tile
#define FF_SLOTS 3             // its ring of K / V items of 64 keys

template <int HD>
__global__ void __launch_bounds__(FF_THREADS, 1)
    flash_fwd_ffma_kernel(const float* __restrict__ q, FaStrides qs, const float* __restrict__ k,
                          const float* __restrict__ v, FaStrides kvs,
                          const int* __restrict__ qseg, const int* __restrict__ kvseg,
                          float* __restrict__ o, FaStrides os, float* __restrict__ lse, int H,
                          int T_len, int P, float scale_log2) {
  constexpr int LD = HD + 4, NC = HD / 64;
  extern __shared__ __align__(16) float ff_smem[];
  float* Qs = ff_smem;
  float* ring = Qs + FF_ROWS * LD;
  float* Ps = ring + FF_SLOTS * FA_TILE * LD;
  int* segq = reinterpret_cast<int*>(Ps + FF_ROWS * FF_PLD);
  int* count = segq + FF_ROWS;
  int* tiles = count + 4;

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane & 15, ty = 2 * (tid >> 5) + (lane >> 4);
  // a 1-d grid, the query tiles that see the most keys (under a causal
  // bound) first across every head and row, so the last blocks are short
  const int nq = (T_len + FF_ROWS - 1) / FF_ROWS, B = gridDim.x / (nq * H);
  const int h = blockIdx.x % H, rest = blockIdx.x / H, b = rest % B;
  const int q0 = (nq - 1 - rest / B) * FF_ROWS;
  const float* kb = k + b * kvs.b + h * kvs.h;
  const float* vb = v + b * kvs.b + h * kvs.h;
  const int* ksg = kvseg + (long long)b * T_len;

  ff_load_tile<HD, FF_ROWS>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, T_len);
  if (tid < FF_ROWS)
    segq[tid] = q0 + tid < T_len ? qseg[(long long)b * T_len + q0 + tid] : FA_PAD_Q;
  __syncthreads();
  // the key tiles this tile can see (up to max(q0 + 128, P)), classified
  const int kend = min(T_len, max(q0 + FF_ROWS, P));
  const int n = ff_visit<FF_ROWS, true>(segq, q0, ksg, 0, (kend + FA_TILE - 1) / FA_TILE, T_len,
                                        P, tiles, count);
  const int items = 2 * n;  // item 2 i: K of visited tile i, 2 i + 1: its V
  auto issue = [&](int it) {  // into slot it % FF_SLOTS; a group even when empty
    if (it < items)
      ff_load_tile<HD, FA_TILE>(ring + (it % FF_SLOTS) * (FA_TILE * LD), (it & 1) ? vb : kb,
                                kvs.t, (tiles[it >> 1] >> 1) * FA_TILE, T_len);
    ff_commit();
  };
  issue(0);  // in one group with the Q tile
  issue(1);

  float acc[8][4 * NC], m[8], l[8];  // l: this thread's keys only
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[a][c] = 0.f;
  }
  for (int it = 0; it < items; ++it) {
    ff_wait<1>();  // this thread's copies of item it (and of Q) have landed
    __syncthreads();
    issue(it + 2);  // into the slot of item it - 1, which every thread is done with
    const float* X = ring + (it % FF_SLOTS) * (FA_TILE * LD);
    if ((it & 1) == 0) {
      // S = Q K^T over this thread's 8 x 4 tile, f32
      const int e = tiles[it >> 1], k0 = (e >> 1) * FA_TILE;
      float s[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 qv[8], kv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a)
          qv[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(X + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = s[a][j];
            x = fmaf(qv[a].x, kv[j].x, x);
            x = fmaf(qv[a].y, kv[j].y, x);
            x = fmaf(qv[a].z, kv[j].z, x);
            s[a][j] = fmaf(qv[a].w, kv[j].w, x);
          }
      }
      // times the scale (log2 units), masked where the tile needs it; the
      // online softmax; p into P
      const bool masked = e & FF_MASKED;
      int sk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        sk[j] = masked && c < T_len ? ksg[c] : FA_PAD_K;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = ty + 16 * a, i = q0 + r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[a][j] * scale_log2;
          if (masked && !fa_valid(i, k0 + tx + 16 * j, P, segq[r], sk[j])) x = -INFINITY;
          s[a][j] = x;
          mx = fmaxf(mx, x);
        }
        const float mn = fmaxf(m[a], fa_max16(mx));
        // a row with no valid key yet keeps p = 0 (exp2(-inf)), alpha 0
        const float base = mn == -INFINITY ? 0.f : mn;
        const float al = exp2f(m[a] - base);
        m[a] = mn;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2f(s[a][j] - base);
          ps += p;
          Ps[r * FF_PLD + tx + 16 * j] = p;
        }
        l[a] = l[a] * al + ps;
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) acc[a][c] *= al;
      }
    } else {
      // O += P V, keys in order
#pragma unroll 2
      for (int kk = 0; kk < FA_TILE; kk += 4) {
        float4 pv[8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
          pv[a] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * a) * FF_PLD + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4 vv[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            vv[c] = *reinterpret_cast<const float4*>(X + (kk + u) * LD + 4 * tx + 64 * c);
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const float p = ff_at(pv[a], u);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              acc[a][4 * c] = fmaf(p, vv[c].x, acc[a][4 * c]);
              acc[a][4 * c + 1] = fmaf(p, vv[c].y, acc[a][4 * c + 1]);
              acc[a][4 * c + 2] = fmaf(p, vv[c].z, acc[a][4 * c + 2]);
              acc[a][4 * c + 3] = fmaf(p, vv[c].w, acc[a][4 * c + 3]);
            }
          }
        }
      }
    }
  }
  ff_wait<0>();  // no copy outlives the block (the Q tile when no key tile is visited)

  float* ob = o + b * os.b + h * os.h;
  float* lb = lse + ((long long)b * H + h) * T_len;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float lt = fa_sum16(l[a]);
    const int i = q0 + ty + 16 * a;
    if (i >= T_len) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(ob + i * os.t + 4 * tx + 64 * c) =
          make_float4(acc[a][4 * c] * inv, acc[a][4 * c + 1] * inv, acc[a][4 * c + 2] * inv,
                      acc[a][4 * c + 3] * inv);
    if (tx == 0) lb[i] = lt > 0.f ? (m[a] + log2f(lt)) * 0.69314718055994531f : 0.f;
  }
}

// the f32 forward's dynamic shared memory: the Q tile, the ring, P (f32), the
// query tile's ids, the count and list of visited key tiles
static size_t fa_fwd_ffma_smem(int T_len, int hd) {
  return ((size_t)(FF_ROWS + FF_SLOTS * FA_TILE) * (hd + 4) + (size_t)FF_ROWS * FF_PLD) *
             sizeof(float) +
         (FF_ROWS + 4) * sizeof(int) + (size_t)((T_len + FA_TILE - 1) / FA_TILE) * sizeof(int);
}

// the f32 forward on the CUDA cores
template <int HD>
static int fa_fwd_ffma(const void* q, const long long* qs, const void* k, const void* v,
                       const long long* kvs, const int* qseg, const int* kvseg, void* o,
                       const long long* os, float* lse, int B, int H, int T_len, int P,
                       float scale, cudaStream_t s) {
  const size_t smem = fa_fwd_ffma_smem(T_len, HD);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_ffma_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((T_len + FF_ROWS - 1) / FF_ROWS) * H * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_fwd_ffma_kernel<HD><<<(unsigned)blocks, FF_THREADS, smem, s>>>(
      reinterpret_cast<const float*>(q), FaStrides{qs[0], qs[1], qs[2]},
      reinterpret_cast<const float*>(k), reinterpret_cast<const float*>(v),
      FaStrides{kvs[0], kvs[1], kvs[2]}, qseg, kvseg, reinterpret_cast<float*>(o),
      FaStrides{os[0], os[1], os[2]}, lse, H, T_len, P,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int fa_fwd_f32(const void* q, const long long* qs, const void* k, const void* v,
               const long long* kvs, const int* qseg, const int* kvseg, void* o,
               const long long* os, float* lse, int hd, int B, int H, int T_len, int P,
               float scale, cudaStream_t s) {
  return hd == 64 ? fa_fwd_ffma<64>(q, qs, k, v, kvs, qseg, kvseg, o, os, lse, B, H, T_len, P,
                                    scale, s)
                  : fa_fwd_ffma<128>(q, qs, k, v, kvs, qseg, kvseg, o, os, lse, B, H, T_len, P,
                                     scale, s);
}

// the f32 forward's resident warps per SM at this T and head dim (its
// dynamic shared memory allowed first); a negative CUDA error on failure
extern "C" int vx_flash_attention_fwd_f32_warps(int T_len, int hd) {
  const size_t smem = fa_fwd_ffma_smem(T_len, hd);
  int blocks = 0;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = hd == 64 ? cudaFuncSetAttribute(flash_fwd_ffma_kernel<64>, attr, (int)smem)
                           : cudaFuncSetAttribute(flash_fwd_ffma_kernel<128>, attr, (int)smem);
  if (e == cudaSuccess)
    e = hd == 64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, flash_fwd_ffma_kernel<64>, FF_THREADS, smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, flash_fwd_ffma_kernel<128>, FF_THREADS, smem);
  return e == cudaSuccess ? blocks * (FF_THREADS / 32) : -(int)e;
}
