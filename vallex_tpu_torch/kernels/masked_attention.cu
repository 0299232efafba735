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
//   vallex_tpu/ops/decode_attention.py decode_attention and the single steps
//       of decode_step.py: the own-column mode below.
// Row b of the batch has its own bounds, read from `lens` ([3, B] int32 on
// the device: x_len, a1_len, a2_len), so no bound travels through the host.
// Key c is valid for row b and query qi iff
//   c < x_len[b]
//   or a1_lo <= c < a1_lo + a1_len[b]                 (range 1)
//   or a2_lo <= c < a2_lo + a2_len[b] + q_off * qi    (range 2).
// The single-request layout of engine/ar.py leaves range 1 empty and puts
// the audio rows in range 2 (a2_len = pos0 + 1, q_off = 1, with the new
// columns already written into the cache). The batched layout of
// ar_generate_batch puts each request's BOS + prompt rows in range 1 (a1_lo =
// s_text, a1_len = prompt_len + 1) and the generated rows, shared by
// position, in range 2 (a2_lo = s_text + p_audio). Each range is clamped into
// the rows it reads, so a wrong bound cannot read outside them.
//
// The walk runs over a row's VIRTUAL key index vk: [0, x_len) the text rows,
// then range 1, then range 2. Query qi sees the first nkeys(qi) virtual keys
// (range 2 is last, so its causal bound only shortens the count). Padding
// keys are never loaded.
//
// Grouped mode (best_of samples, `prefix` non-null): the B = R * beams rows
// are request-major (row b is request b / beams's sample b % beams), the text
// and range-1 keys of row b come from the prefix [R, H, P, hd] row b / beams
// -- one copy per request, shared by its samples -- and the range-2
// (generated) keys from the row's own cache [B, H, C, hd], where a2_lo = 0.
// Rows are addressed one by one, so a tile that crosses from the prefix into
// the row's cache needs no special path.
//
// int8 K/V (kind 3): the int8 KV cache of decode_block_fused(kv_scales=...)
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
// blocks. The kernel takes this step's new k/v in f32 ([B, H, 1, hd], strides
// `ns`), walks the cache only up to the `slot` row (range 2 is cut there),
// then folds the new column in unrounded, last, as the TPU kernels do (int8
// K/V: divided by the scale into cache units, unrounded). Cluster rank 0
// writes the column into the cache row `slot`: rounded to the cache type, or
// for int8 K/V quantized as clip(rint(x / s), -127, 127). No block reads that
// row, so the write needs no ordering.
//
// Bound on the H100: the K/V bytes of the valid rows (a memory stream; Tq <=
// 16 FMAs per key element, far below the ridge). The design spreads those
// bytes over many SMs and keeps copies in flight:
// * A cluster of ATT_CLUSTER blocks takes one (row, head, group of up to
//   ATT_QG queries); grid (ATT_CLUSTER * ceil(Tq / ATT_QG), H, B), which
//   depends on the shapes alone. The row's virtual keys, counted for the
//   group's last query, fall into tiles of ATT_TILE; block rank r takes the
//   r-th run of ceil(tiles / ATT_CLUSTER) tiles (empty runs only at the end).
//   The partition is a function of that count alone -- not of C, B, where
//   the keys live or the other rows -- so grouped rows equal their expanded
//   rows, and batch rows their requests alone, bitwise.
//   kernels/masked_attention.py's split_chunks_plain is its plain version.
// * Every query of the group shares one read of K/V: the block's warps take
//   its tiles in turn, each warp with a slot of its own (ATT_RING) filled by
//   16-byte cp.async copies, so every warp of the cluster has its tile in
//   flight at once (rows 16 bytes longer than the data, so eight lanes
//   reading eight rows at one offset hit distinct bank quads). Lane j scores
//   key j against each query (held in shared memory, f32, scaled); the
//   queries' maxes and sums are reduced side by side, lane qq keeping query
//   qq's running (m, l); the tile's probabilities go through shared memory
//   to P.V, where lane j keeps HD / 32 dims of each query's f32 sum. Query
//   qi's own count masks inside the shared tiles. Softmax state and sums
//   are f32.
// * Each warp leaves its (m, l, sum) per query; the block merges its warps
//   in warp order and pushes each dim's state into the inbox of the rank
//   that merges that dim (HD / ATT_CLUSTER dims a rank) through distributed
//   shared memory. After one cluster barrier each rank merges its inbox in
//   rank order 0..ATT_CLUSTER-1 (no remote reads, so no second barrier),
//   folds the own column in last and writes the output with the v-scale. No
//   workspace, no atomics: two runs are bitwise equal. An empty run, or a
//   row with no keys, leaves m = VX_NEG_BIG, l = 0 and gives output 0.
// * Programmatic dependent launch, as gemm_small_m's: the blocks start while
//   the kernel before runs and wait (griddepcontrol.wait) before they read
//   anything; after the walk they let the next kernel start.
// Each of these choices measured faster on the H100 than its alternative: a
// cluster of 16, two slots a warp, 8 warps a block, no programmatic
// dependent launch, the loops unrolled as at one query (PERF.md §6;
// tools/torch_decode_variants.py times each).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define ATT_CLUSTER 8  // blocks a (row, head, query group): the keys split over them
#define ATT_TILE 32    // keys a tile; lane j scores key j
#define ATT_QG 16      // queries a group, sharing one read of K/V
#define ATT_RING 1     // slots of a warp's ring: tiles in flight per warp (one:
                       // half the shared memory of two, more resident blocks,
                       // twice the warps at hd 128)

// bytes of one K or V row in shared memory, padded by 16 bytes
template <typename TKV, int HD>
__host__ __device__ constexpr int att_row() { return HD * (int)sizeof(TKV) + 16; }
// bytes of one ring slot: a tile's K rows, then its V rows
template <typename TKV, int HD>
__host__ __device__ constexpr int att_slot() { return 2 * ATT_TILE * att_row<TKV, HD>(); }
// warps a block: as many as keep the rings within ~80 KB (1 to 4), so two or
// three blocks fit an SM
template <typename TKV, int HD>
__host__ __device__ constexpr int att_warps() {
  return 81920 / (ATT_RING * att_slot<TKV, HD>()) >= 4   ? 4
         : 81920 / (ATT_RING * att_slot<TKV, HD>()) >= 2 ? 2
                                                         : 1;
}
// row stride of a warp's probabilities [ATT_TILE][QP] (QMAX > 1: padded so
// the 32 lanes' writes of one query spread over the banks, 16-byte rows)
template <int QMAX>
__host__ __device__ constexpr int att_qp() { return QMAX == 1 ? 1 : QMAX + 4; }
// dynamic shared memory: the rings (after the walk: the warps' sums), the
// queries, the warps' probabilities and (m, l), the inbox of the merge, the
// own column's score
template <typename TKV, int HD, int QMAX>
__host__ __device__ constexpr int att_smem() {
  return att_warps<TKV, HD>() * ATT_RING * att_slot<TKV, HD>() +
         4 * (QMAX * HD + att_warps<TKV, HD>() * (ATT_TILE * att_qp<QMAX>() + 2 * QMAX) +
              QMAX * HD + 2 * ATT_CLUSTER * QMAX + 4);
}

// one value of this step's column in the cache's type (int8: quantized
// with the head's scale `s`)
__device__ __forceinline__ void vx_store_col(float* p, float v, float) { *p = v; }
__device__ __forceinline__ void vx_store_col(__nv_bfloat16* p, float v, float) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void vx_store_col(int8_t* p, float v, float s) {
  *p = (int8_t)__float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

// the 16 bytes at p (shared memory) as 16 / sizeof(T) floats
__device__ __forceinline__ void vx_chunk(const __nv_bfloat16* p, float* out) {
  vx_bf16x8_to_f32(*reinterpret_cast<const uint4*>(p), out);
}
__device__ __forceinline__ void vx_chunk(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
__device__ __forceinline__ void vx_chunk(const int8_t* p, float* out) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)c[i];
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

// 16 bytes global -> shared; zero-filled, and the source not read, when !in
__device__ __forceinline__ void att_cp16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void att_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void att_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the virtual keys query qi sees: the text and range 1, then range 2 up to
// its causal bound
__device__ __forceinline__ int att_nkeys(int x_a1, int a2_len0, int q_off, int a2_cap, int qi) {
  return x_a1 + min(max(a2_len0 + q_off * qi, 0), a2_cap);
}

// virtual keys [vk0, vk0 + ATT_TILE)'s K and V rows into a warp's slot (K
// rows, then V rows, ROW bytes apart), by 16-byte cp.async, one row at a
// time: the text and range-1 rows from kp/vp (row stride p_row), range 2
// from kb/vb (kv_st); rows past nk_max zero-filled, their source not read
template <typename TKV, int HD>
__device__ __forceinline__ void att_load_tile(unsigned char* dst, int vk0, int nk_max, int x_len,
                                              int x_a1, int a1_lo, int a2_lo, const TKV* kp,
                                              const TKV* vp, long long p_row, const TKV* kb,
                                              const TKV* vb, long long kv_st, int lane) {
  constexpr int ROW = att_row<TKV, HD>(), EPC = 16 / (int)sizeof(TKV), CPR = HD / EPC;
  unsigned char* dv = dst + ATT_TILE * ROW;
#pragma unroll
  for (int u = 0; u < CPR; ++u) {  // ATT_TILE * CPR chunks, 32 a pass
    const int r = (lane + 32 * u) / CPR, c = (lane + 32 * u) % CPR, vk = vk0 + r;
    const bool in = vk < nk_max;
    const bool side_p = vk < x_a1;
    const long long row = !in ? 0
                          : vk < x_len ? (long long)vk * p_row
                          : side_p     ? (long long)(a1_lo + vk - x_len) * p_row
                                       : (long long)(a2_lo + vk - x_a1) * kv_st;
    att_cp16(dst + r * ROW + 16 * c, (side_p ? kp : kb) + row + c * EPC, in);
    att_cp16(dv + r * ROW + 16 * c, (side_p ? vp : vb) + row + c * EPC, in);
  }
  att_commit();
}

// Strides are in elements; the head dim has stride 1 for q, k, v, the prefix,
// the new column and o. pk/pv null: no prefix (every key from k/v). ks/vs
// null: no K/V scales. nk/nv null: no own column (kw/vw, n_sb/n_sh and the
// slot unused). The own column's row is *slot_d when slot_d is given (read
// after the dependency wait; a row outside [0, C) writes nothing), else
// slot_h. QMAX: the queries a group holds at most (1, 8 or ATT_QG).
template <typename TKV, int HD, int QMAX>
__global__ void __launch_bounds__(att_warps<TKV, HD>() * 32, 1)
masked_attention_split_kernel(const float* __restrict__ q, long long q_sb, long long q_sh,
                              long long q_st, const TKV* __restrict__ k,
                              const TKV* __restrict__ v, long long kv_sb, long long kv_sh,
                              long long kv_st, const TKV* __restrict__ pk,
                              const TKV* __restrict__ pv, long long p_sb, long long p_sh,
                              long long p_st, int P, int beams, float* __restrict__ o,
                              long long o_sb, long long o_sh, long long o_st, int B, int Tq,
                              int C, const int* __restrict__ lens, int a1_lo, int a2_lo,
                              int q_off, float scale, const float* __restrict__ ks,
                              const float* __restrict__ vs, const float* __restrict__ nk,
                              const float* __restrict__ nv, long long n_sb, long long n_sh,
                              int slot_h, const int* __restrict__ slot_d, TKV* kw, TKV* vw) {
  constexpr int NW = att_warps<TKV, HD>(), NT = NW * 32;
  constexpr int ROW = att_row<TKV, HD>(), SLOT = att_slot<TKV, HD>();
  constexpr int EPC = 16 / (int)sizeof(TKV);  // elements in a 16-byte chunk
  constexpr int CPR = HD / EPC;               // 16-byte chunks a row
  constexpr int DPL = HD / 32;                // accumulator dims a lane
  constexpr int QP = att_qp<QMAX>();
  constexpr int DR = HD / ATT_CLUSTER;        // output dims a rank merges
  // 8 or 16 queries hold ILP enough in one 16-byte chunk of a key row (or two
  // V rows); unrolled further, ptxas spills at head dim 128
  constexpr int C_UNROLL = QMAX >= 8 ? 1 : CPR;
  constexpr int PV_UNROLL = QMAX >= 8 ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rings = smem;  // [NW][ATT_RING] slots
  float* qs = reinterpret_cast<float*>(smem + NW * ATT_RING * SLOT);  // [QMAX][HD]
  float* pbuf = qs + QMAX * HD;                  // [NW][ATT_TILE][QP]
  float* wml = pbuf + NW * ATT_TILE * QP;        // [NW][2][QMAX]: the warps' m, l
  float* in_acc = wml + NW * 2 * QMAX;           // [ATT_CLUSTER][QMAX][DR]: the merge's inbox
  float* in_ml = in_acc + QMAX * HD;             // [ATT_CLUSTER][2][QMAX]
  float* s_own = in_ml + ATT_CLUSTER * 2 * QMAX;
  float* wacc = reinterpret_cast<float*>(smem);  // after the walk: [NW][QMAX][HD]
  static_assert(QMAX * HD * 4 <= ATT_RING * SLOT, "the warps' sums fit in the rings");

  // programmatic dependent launch: q, the cache and the bounds may come
  // from the kernel before this one
  asm volatile("griddepcontrol.wait;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int q0 = (blockIdx.x / ATT_CLUSTER) * ATT_QG;
  const int nq = min(ATT_QG, Tq - q0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool own = nk != nullptr;
  const int slot = slot_d != nullptr ? *slot_d : slot_h;

  // the bounds: the text and range-1 keys from the prefix row of this row's
  // request, or from the row's own cache; own column: range 2 stops before
  // the slot, whatever the bounds say
  const bool grouped = pk != nullptr;
  const int C1 = grouped ? P : C;
  const int x_len = min(max(lens[b], 0), C1);
  const int x_a1 = x_len + min(max(lens[B + b], 0), max(C1 - a1_lo, 0));
  const int a2_cap = max((own ? min(C, slot) : C) - a2_lo, 0);
  const int a2_len0 = lens[2 * B + b];
  const int nk_max = max(att_nkeys(x_a1, a2_len0, q_off, a2_cap, q0),
                         att_nkeys(x_a1, a2_len0, q_off, a2_cap, q0 + nq - 1));
  // this rank's tiles: a function of nk_max alone
  const int n_tiles = (nk_max + ATT_TILE - 1) / ATT_TILE;
  const int per_rank = (n_tiles + ATT_CLUSTER - 1) / ATT_CLUSTER;
  const int t_begin = min(rank * per_rank, n_tiles);
  const int t_end = min(t_begin + per_rank, n_tiles);

  if (own && rank == 0 && slot >= 0 && slot < C) {
    // this step's column into the cache row `slot`
    const long long n_off = b * n_sb + h * n_sh;
    const float ksh = ks != nullptr ? ks[h] : 1.f, vsh = vs != nullptr ? vs[h] : 1.f;
    for (int i = threadIdx.x; i < 2 * HD; i += NT) {
      const int d = i % HD;
      const long long c_off = b * kv_sb + h * kv_sh + (long long)slot * kv_st + d;
      if (i < HD)
        vx_store_col(kw + c_off, nk[n_off + d], ksh);
      else
        vx_store_col(vw + c_off, nv[n_off + d], vsh);
    }
  }
  {
    // the group's queries, scaled; int8 K/V: the k-scale folds into the
    // query (q * ks), so the scores come out of the int8 rows as they are
    const float qscale = ks != nullptr ? ks[h] : 1.f;
    const float* qb = q + b * q_sb + h * q_sh;
    for (int i = threadIdx.x; i < QMAX * HD; i += NT) {
      const int qi = i / HD, d = i % HD;
      qs[i] = qi < nq ? qb[(long long)(q0 + qi) * q_st + d] * qscale * scale : 0.f;
    }
  }
  __syncthreads();

  // ---- the walk: warp w takes this rank's tiles t_begin + w, + NW, ... ------
  const TKV* kb = k + b * kv_sb + h * kv_sh;
  const TKV* vb = v + b * kv_sb + h * kv_sh;
  const long long pr = grouped ? (long long)(b / beams) * p_sb + h * p_sh : 0;
  const TKV* kp = grouped ? pk + pr : kb;
  const TKV* vp = grouped ? pv + pr : vb;
  const long long p_row = grouped ? p_st : kv_st;
  unsigned char* ring = rings + warp * ATT_RING * SLOT;
  float* pw = pbuf + warp * ATT_TILE * QP;
  const int first = t_begin + warp;
  const int mine = first < t_end ? (t_end - first + NW - 1) / NW : 0;

  // lane qq keeps query qq's running max and sum; every lane DPL dims of
  // each query's sum of p v
  float m_q = VX_NEG_BIG, l_q = 0.f, acc[QMAX][DPL];
#pragma unroll
  for (int qq = 0; qq < QMAX; ++qq) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[qq][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < ATT_RING; ++i) {
    if (i < mine)
      att_load_tile<TKV, HD>(ring + i * SLOT, (first + i * NW) * ATT_TILE, nk_max, x_len, x_a1,
                             a1_lo, a2_lo, kp, vp, p_row, kb, vb, kv_st, lane);
    else
      att_commit();  // an empty group keeps the wait count uniform
  }
  for (int i = 0; i < mine; ++i) {
    att_wait<ATT_RING - 1>();
    __syncwarp();
    const int t = first + i * NW, vk0 = t * ATT_TILE;
    const unsigned char* sk = ring + (i % ATT_RING) * SLOT;
    const TKV* vt = reinterpret_cast<const TKV*>(sk + ATT_TILE * ROW);
    // scores: lane j against key j, every query of the group
    float s[QMAX];
#pragma unroll
    for (int qq = 0; qq < QMAX; ++qq) s[qq] = 0.f;
    const TKV* krow = reinterpret_cast<const TKV*>(sk + lane * ROW);
#pragma unroll C_UNROLL
    for (int c = 0; c < CPR; ++c) {
      float kf[EPC];
      vx_chunk(krow + c * EPC, kf);
#pragma unroll
      for (int qq = 0; qq < QMAX; ++qq) {
        const float4* qv = reinterpret_cast<const float4*>(qs + qq * HD + c * EPC);
#pragma unroll
        for (int e4 = 0; e4 < EPC / 4; ++e4) {
          const float4 qf = qv[e4];
          s[qq] = fmaf(qf.x, kf[4 * e4], s[qq]);
          s[qq] = fmaf(qf.y, kf[4 * e4 + 1], s[qq]);
          s[qq] = fmaf(qf.z, kf[4 * e4 + 2], s[qq]);
          s[qq] = fmaf(qf.w, kf[4 * e4 + 3], s[qq]);
        }
      }
    }
    // the online softmax of each query over the keys it sees in this tile:
    // the queries' maxes, then their sums, reduced side by side
    unsigned valid = 0;
    float red[QMAX];  // the tile max, then the sum of p
#pragma unroll
    for (int qq = 0; qq < QMAX; ++qq) {
      if (qq < nq && vk0 + lane < att_nkeys(x_a1, a2_len0, q_off, a2_cap, q0 + qq))
        valid |= 1u << qq;
      red[qq] = valid >> qq & 1u ? s[qq] : VX_NEG_BIG;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int qq = 0; qq < QMAX; ++qq)
        red[qq] = fmaxf(red[qq], __shfl_xor_sync(VX_FULL_MASK, red[qq], o));
    }
    float c_q = 1.f;
#pragma unroll
    for (int qq = 0; qq < QMAX; ++qq) {
      const float m_old = __shfl_sync(VX_FULL_MASK, m_q, qq);
      const float m_new = fmaxf(m_old, red[qq]);
      const float p = valid >> qq & 1u ? __expf(s[qq] - m_new) : 0.f;
      const float corr = __expf(m_old - m_new);
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[qq][d] *= corr;
      pw[lane * QP + qq] = p;
      red[qq] = p;
      if (lane == qq) {
        m_q = m_new;
        c_q = corr;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int qq = 0; qq < QMAX; ++qq) red[qq] += __shfl_xor_sync(VX_FULL_MASK, red[qq], o);
    }
#pragma unroll
    for (int qq = 0; qq < QMAX; ++qq)
      if (lane == qq) l_q = l_q * c_q + red[qq];
    __syncwarp();
    // P.V over the rows loaded: lane j keeps dims DPL j .. DPL j + DPL - 1
    const int rows = min(ATT_TILE, nk_max - vk0);
#pragma unroll PV_UNROLL
    for (int j = 0; j < rows; ++j) {
      float vv[DPL];
      vx_load_dims<DPL>(vt + j * (ROW / (int)sizeof(TKV)) + DPL * lane, vv);
      if constexpr (QMAX == 1) {
        const float pj = pw[j];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[0][d] = fmaf(pj, vv[d], acc[0][d]);
      } else {
#pragma unroll
        for (int q4 = 0; q4 < QMAX; q4 += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pw + j * QP + q4);
#pragma unroll
          for (int d = 0; d < DPL; ++d) {
            acc[q4][d] = fmaf(p4.x, vv[d], acc[q4][d]);
            acc[q4 + 1][d] = fmaf(p4.y, vv[d], acc[q4 + 1][d]);
            acc[q4 + 2][d] = fmaf(p4.z, vv[d], acc[q4 + 2][d]);
            acc[q4 + 3][d] = fmaf(p4.w, vv[d], acc[q4 + 3][d]);
          }
        }
      }
    }
    __syncwarp();  // the slot and pw are free again
    if (i + ATT_RING < mine)
      att_load_tile<TKV, HD>(ring + (i % ATT_RING) * SLOT, (first + (i + ATT_RING) * NW) * ATT_TILE,
                             nk_max, x_len, x_a1, a1_lo, a2_lo, kp, vp, p_row, kb, vb, kv_st, lane);
    else
      att_commit();
  }
  // the next kernel may start its prologue; it waits for this one's end
  // before it reads anything
  asm volatile("griddepcontrol.launch_dependents;");
  att_wait<0>();
  __syncthreads();  // every warp is done with the rings

  // ---- the block's state: its warps merged in warp order ---------------------
  if (lane < QMAX) {
    wml[warp * 2 * QMAX + lane] = m_q;
    wml[warp * 2 * QMAX + QMAX + lane] = l_q;
  }
#pragma unroll
  for (int qq = 0; qq < QMAX; ++qq) {
#pragma unroll
    for (int d = 0; d < DPL; ++d) wacc[(warp * QMAX + qq) * HD + DPL * lane + d] = acc[qq][d];
  }
  if (own && warp == 0) {
    // the new key in cache units (int8 K/V: k / ks, unrounded)
    const long long n_off = b * n_sb + h * n_sh;
    const float ksh = ks != nullptr ? ks[h] : 1.f;
    float dot = 0.f;
#pragma unroll
    for (int d = lane; d < HD; d += 32)
      dot = fmaf(qs[d], ks != nullptr ? __fdiv_rn(nk[n_off + d], ksh) : nk[n_off + d], dot);
    dot = vx_warp_sum(dot);
    if (lane == 0) *s_own = dot;
  }
  __syncthreads();
  // each (query, dim): the warps merged, then pushed into the inbox of the
  // rank that merges that dim (rank d / DR) through distributed shared memory
  for (int i = threadIdx.x; i < nq * HD; i += NT) {
    const int qq = i / HD, d = i % HD;
    float mm = VX_NEG_BIG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wml[w * 2 * QMAX + qq]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = __expf(wml[w * 2 * QMAX + qq] - mm);
      ll += wml[w * 2 * QMAX + QMAX + qq] * f;
      a += wacc[(w * QMAX + qq) * HD + d] * f;
    }
    const int dst = d / DR;
    cluster.map_shared_rank(in_acc, dst)[(rank * QMAX + qq) * DR + d % DR] = a;
    if (d % DR == 0) {
      float* ml = cluster.map_shared_rank(in_ml, dst) + rank * 2 * QMAX;
      ml[qq] = mm;
      ml[QMAX + qq] = ll;
    }
  }
  cluster.sync();  // every rank's state is in its inbox; nothing remote after this

  // ---- rank r merges dims [r DR, r DR + DR) of every query, ranks in order --
  // int8 K/V: the v-scale folds into the output
  const float oscale = vs != nullptr ? vs[h] : 1.f;
  for (int i = threadIdx.x; i < nq * DR; i += NT) {
    const int qq = i / DR, dd = i % DR, d = rank * DR + dd;
    float mm = own ? *s_own : VX_NEG_BIG;
#pragma unroll
    for (int r = 0; r < ATT_CLUSTER; ++r) mm = fmaxf(mm, in_ml[r * 2 * QMAX + qq]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < ATT_CLUSTER; ++r) {
      const float f = __expf(in_ml[r * 2 * QMAX + qq] - mm);
      ll += in_ml[r * 2 * QMAX + QMAX + qq] * f;
      a += in_acc[(r * QMAX + qq) * DR + dd] * f;
    }
    if (own) {  // the new column, after the cache rows
      const float p = __expf(*s_own - mm);
      float vn = nv[b * n_sb + h * n_sh + d];
      if (vs != nullptr) vn = __fdiv_rn(vn, vs[h]);
      ll += p;
      a = fmaf(p, vn, a);
    }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    o[b * o_sb + h * o_sh + (long long)(q0 + qq) * o_st + d] = a * inv * oscale;
  }
}

// the instance's dynamic shared memory limit, raised once per device (a
// host call, kept off the per-launch path)
template <typename TKV, int HD, int QMAX>
static cudaError_t allow_smem() {
  static unsigned long long done = 0;  // a bit per device, for this instance
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(masked_attention_split_kernel<TKV, HD, QMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             att_smem<TKV, HD, QMAX>());
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

// one instance's launch configuration: clusters of ATT_CLUSTER blocks along
// x, its dynamic shared memory, programmatic stream serialization (used in
// place: cfg points at attr)
template <typename TKV, int HD, int QMAX>
struct AttLaunch {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = {};
  AttLaunch(dim3 grid, cudaStream_t stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(att_warps<TKV, HD>() * 32);
    cfg.dynamicSmemBytes = att_smem<TKV, HD, QMAX>();
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ATT_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
  }
};

template <typename TKV, int HD, int QMAX>
static cudaError_t launch(const void* q, const long long* qs, const void* k, const void* v,
                          const long long* kvs, const void* pk, const void* pv,
                          const long long* ps, int P, int beams, void* o, const long long* os,
                          int B, int H, int Tq, int C, const int* lens, int a1_lo, int a2_lo,
                          int q_off, float scale, const float* ks, const float* vs,
                          const float* nk, const float* nv, const long long* ns, int slot,
                          const int* slot_d, cudaStream_t stream) {
  cudaError_t err = allow_smem<TKV, HD, QMAX>();
  if (err != cudaSuccess) return err;
  AttLaunch<TKV, HD, QMAX> l(dim3(ATT_CLUSTER * ((Tq + ATT_QG - 1) / ATT_QG), H, B), stream);
  err = cudaLaunchKernelEx(
      &l.cfg, masked_attention_split_kernel<TKV, HD, QMAX>, reinterpret_cast<const float*>(q),
      qs[0], qs[1], qs[2], reinterpret_cast<const TKV*>(k), reinterpret_cast<const TKV*>(v),
      kvs[0], kvs[1], kvs[2], reinterpret_cast<const TKV*>(pk), reinterpret_cast<const TKV*>(pv),
      pk != nullptr ? ps[0] : 0LL, pk != nullptr ? ps[1] : 0LL, pk != nullptr ? ps[2] : 0LL, P,
      beams, reinterpret_cast<float*>(o), os[0], os[1], os[2], B, Tq, C, lens, a1_lo, a2_lo,
      q_off, scale, ks, vs, nk, nv, nk != nullptr ? ns[0] : 0LL, nk != nullptr ? ns[1] : 0LL,
      slot, slot_d, reinterpret_cast<TKV*>(const_cast<void*>(k)),
      reinterpret_cast<TKV*>(const_cast<void*>(v)));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the kernel's instance for (kinds, hd, Tq): its dynamic shared memory,
// threads a block and the clusters the card holds at once
template <typename TKV, int HD, int QMAX>
static cudaError_t info(int* out) {
  cudaError_t err = allow_smem<TKV, HD, QMAX>();
  if (err != cudaSuccess) return err;
  AttLaunch<TKV, HD, QMAX> l(dim3(ATT_CLUSTER), nullptr);
  out[0] = l.cfg.dynamicSmemBytes;
  out[1] = l.cfg.blockDim.x;
  out[3] = ATT_CLUSTER;
  return cudaOccupancyMaxActiveClusters(&out[2], masked_attention_split_kernel<TKV, HD, QMAX>,
                                        &l.cfg);
}

// the instance for Tq queries: groups of 1, up to 8, or up to ATT_QG
template <typename TKV, int HD>
static cudaError_t launch_q(int Tq, const void* q, const long long* qs, const void* k,
                            const void* v, const long long* kvs, const void* pk, const void* pv,
                            const long long* ps, int P, int beams, void* o, const long long* os,
                            int B, int H, int C, const int* lens, int a1_lo, int a2_lo,
                            int q_off, float scale, const float* ks, const float* vs,
                            const float* nk, const float* nv, const long long* ns, int slot,
                            const int* slot_d, cudaStream_t stream) {
#define VX_ATT_ARGS                                                                          \
  q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H, Tq, C, lens, a1_lo, a2_lo, q_off, scale, \
      ks, vs, nk, nv, ns, slot, slot_d, stream
  if (Tq == 1) return launch<TKV, HD, 1>(VX_ATT_ARGS);
  if (Tq <= 8) return launch<TKV, HD, 8>(VX_ATT_ARGS);
  return launch<TKV, HD, ATT_QG>(VX_ATT_ARGS);
#undef VX_ATT_ARGS
}

template <typename TKV>
static cudaError_t launch_hd(int hd, int Tq, const void* q, const long long* qs, const void* k,
                             const void* v, const long long* kvs, const void* pk, const void* pv,
                             const long long* ps, int P, int beams, void* o, const long long* os,
                             int B, int H, int C, const int* lens, int a1_lo, int a2_lo,
                             int q_off, float scale, const float* ks, const float* vs,
                             const float* nk, const float* nv, const long long* ns, int slot,
                             const int* slot_d, cudaStream_t stream) {
  if (hd == 64)
    return launch_q<TKV, 64>(Tq, q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H, C, lens,
                             a1_lo, a2_lo, q_off, scale, ks, vs, nk, nv, ns, slot, slot_d,
                             stream);
  if (hd == 128)
    return launch_q<TKV, 128>(Tq, q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H, C, lens,
                              a1_lo, a2_lo, q_off, scale, ks, vs, nk, nv, ns, slot, slot_d,
                              stream);
  return cudaErrorInvalidValue;
}

// q: [B, H, Tq, hd] with 1 <= Tq <= 65535 and hd 64 or 128; k, v: [B, H, C,
// hd]; o: [B, H, Tq, hd] f32. kinds: 0 = f32 q/o with bf16 k/v, 2 = f32
// q/o/k/v (compute_dtype="float32"), 3 = f32 q/o with int8 k/v and the
// scales ks/vs [H] (int8 KV cache). qs/kvs/os: the (b, h, t) strides in
// elements, three int64 each. lens: device pointer to [3, B] int32 (x_len,
// a1_len, a2_len per row), contiguous. pk/pv: null, or the grouped mode's
// prefix [B / beams, H, P, hd] of the k/v type with strides ps. nk/nv:
// null, or the own-column mode's new k/v [B, H, 1, hd] f32 with (b, h, t)
// strides ns, written into row `slot` of k/v (Tq must be 1), or into row
// *slot_d when slot_d (a device int32) is not null. k/v rows (and the
// prefix's) must start on 16-byte boundaries.
extern "C" int vx_masked_attention(const void* q, const long long* qs, const void* k,
                                   const void* v, const long long* kvs, const void* pk,
                                   const void* pv, const long long* ps, int P, int beams,
                                   void* o, const long long* os, int kinds, int B, int H,
                                   int Tq, int C, int hd, const void* lens, int a1_lo,
                                   int a2_lo, int q_off, float scale, const void* ks,
                                   const void* vs, const void* nk, const void* nv,
                                   const long long* ns, int slot, const void* slot_d,
                                   void* stream) {
  if (Tq < 1 || Tq > 65535 || B < 1 || B > 65535 || H < 1 || H > 65535 || beams < 1 ||
      B % beams)
    return (int)cudaErrorInvalidValue;
  if ((kinds == 3) != (ks != nullptr && vs != nullptr)) return (int)cudaErrorInvalidValue;
  if (nk != nullptr &&
      (Tq != 1 || nv == nullptr || (slot_d == nullptr && (slot < 0 || slot >= C))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* l = reinterpret_cast<const int*>(lens);
  const float* fks = reinterpret_cast<const float*>(ks);
  const float* fvs = reinterpret_cast<const float*>(vs);
  const float* fnk = reinterpret_cast<const float*>(nk);
  const float* fnv = reinterpret_cast<const float*>(nv);
  const int* sd = reinterpret_cast<const int*>(slot_d);
  switch (kinds) {
    case 0:
      return (int)launch_hd<__nv_bfloat16>(hd, Tq, q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os,
                                           B, H, C, l, a1_lo, a2_lo, q_off, scale, fks, fvs, fnk,
                                           fnv, ns, slot, sd, s);
    case 2:
      return (int)launch_hd<float>(hd, Tq, q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H,
                                   C, l, a1_lo, a2_lo, q_off, scale, fks, fvs, fnk, fnv, ns, slot,
                                   sd, s);
    case 3:
      return (int)launch_hd<int8_t>(hd, Tq, q, qs, k, v, kvs, pk, pv, ps, P, beams, o, os, B, H,
                                    C, l, a1_lo, a2_lo, q_off, scale, fks, fvs, fnk, fnv, ns,
                                    slot, sd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out[4] <- the instance for (kinds, hd, Tq): dynamic shared memory bytes,
// threads a block, clusters resident at once (cudaOccupancyMaxActiveClusters)
// and blocks a cluster. Returns a CUDA error code.
extern "C" int vx_masked_attention_info(int kinds, int hd, int Tq, int* out) {
#define VX_INFO(T)                                                                      \
  (hd == 64    ? (Tq == 1 ? info<T, 64, 1>(out) : Tq <= 8 ? info<T, 64, 8>(out)        \
                                                         : info<T, 64, ATT_QG>(out))  \
   : hd == 128 ? (Tq == 1 ? info<T, 128, 1>(out) : Tq <= 8 ? info<T, 128, 8>(out)      \
                                                          : info<T, 128, ATT_QG>(out)) \
               : cudaErrorInvalidValue)
  switch (kinds) {
    case 0:
      return (int)VX_INFO(__nv_bfloat16);
    case 2:
      return (int)VX_INFO(float);
    case 3:
      return (int)VX_INFO(int8_t);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VX_INFO
}
