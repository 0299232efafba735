// sample_epilogue: one pass over [rows, VP] logits -> (token, its logprob).
//
// Replaces the sampling epilogue of vallex_tpu/ops/decode_block.py
// decode_block_fused (_ffn, last layer): lanes >= vocab masked, temperature
// scaling, optionally (filtered mode, `filtered=True` there) the top-k then
// top-p keep mask of vallex_tpu/ops/sampling.py::filtered_keep_mask,
// Gumbel-argmax over the kept scaled logits + g(u) (or argmax of the masked
// logits when greedy), token clipped to vocab - 1, and the chosen token's
// log-softmax over the kept scaled logits. The TPU kernel drew u from the
// core's own PRNG, which a GPU cannot reproduce; here the caller draws u with
// its torch.Generator, so the kernel and its plain version see the same noise.
//
// The row sits in registers: thread t of a row holds the float4 chunks
// c = 0..NC-1 at elements 4 * (c * threads + t) .. + 3 (coalesced warp loads,
// all issued before any use). Rows share nothing, so a row's result does not
// depend on the rows beside it in the launch.
//
// Unfiltered and greedy (sample_epilogue_draw_kernel): SE_ROW_WARPS warps a
// row, one pass. Each thread keeps its first best score, the max of the
// scaled row and, per warp, the sum of exp; a warp merges by integer reduxes
// on sortable keys and five shuffles; one named barrier merges the warps
// through a few words of shared memory. No __syncthreads.
//
// Filtered (sample_epilogue_filter_kernel): one warp a row, with the TPU
// kernel's semantics (sortable int32 keys give the floats' total order):
//   top-k (top_k > 0): tau_k = the min key v with #(keys > v) <= k - 1, which
//     is the k-th largest key counted with multiplicity. Found exactly by a
//     radix select: up to 4 passes of 8 bits, each a 256-bin count histogram
//     (shared memory, integer atomics: two runs are bitwise equal) of the
//     keys that match the bits chosen so far, a warp scan over the bins (8 a
//     lane) from the top, and the bin where the count crosses k; when that
//     bin holds exactly what is left of k, tau_k is its least key. Keys >=
//     tau_k are kept, so ties at the k-th value all stay.
//   top-p (top_p < 1), on the top-k-filtered row (removed ones at -1e9): the
//     bisection's kept set is exactly {i : mass(keys > key_i) <= top_p}. The
//     candidates are the top-k set when it has at most SE_CAP members (the
//     others carry no mass: exp(-1e9 - lse) is 0 in f32), else the SE_CAP
//     largest keys by the same radix select, which hold the whole nucleus
//     when their mass exceeds top_p. They are compacted by ballot into shared
//     memory, sorted in the warp (bitonic, by shuffles), and their exclusive
//     prefix sums of p taken; tau_p = the least key whose prefix is <= top_p
//     (the prefix at the first of a group of equal keys is the mass strictly
//     above the group). Otherwise the bisection runs on the registers (warp
//     sums by shuffles) from [least key with mass, largest key].
//   the draw: the kept set, when at most SE_LIST, is compacted and only its
//     members take the Gumbel logs and the exps (removed logits sit at -1e30,
//     add nothing to the softmax and cannot win the draw); a larger kept set
//     runs the whole row.
// The masses are f32 sums in another order than the plain version's: a
// token whose mass above lies within rounding of top_p can go either way.
//
// Bound on the H100: the logits and uniforms bytes (a few KB per row), i.e.
// launch latency.
#include <cfloat>
#include <climits>

#include "common.cuh"

#define SE_ROW_WARPS 4  // warps a row, unfiltered (one named barrier merges them)
#define SE_WARPS 4      // rows a block, filtered: one warp each
#define SE_CAP 64       // candidates a warp sorts (2 a lane)
#define SE_LIST 256     // kept logits the draw takes from the list (8 a lane)
#define SE_VP_MAX 2048  // the ceiling on VP
#define FILTER_NEG (-1e9f)  // vallex_tpu/ops/sampling.py NEG_INF

// f32 -> signed int32 key with the same total order (an involution: the same
// map takes a key back to the float's bits)
__device__ __forceinline__ int vx_sortable_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float vx_key_float(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF)); }

// One bisection step of _bisect_min_key: floor midpoint without overflow.
__device__ __forceinline__ int vx_mid(int lo, int hi) { return (lo >> 1) + (hi >> 1) + (lo & hi & 1); }

// The top-k-filtered value that top-p measures: removed logits at -1e9.
__device__ __forceinline__ float vx_topk_filtered(float x, int tau_k) {
  return vx_sortable_key(x) < tau_k ? FILTER_NEG : x;
}

__device__ __forceinline__ float vx_f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The Gumbel term the score subtracts: log(-log(u + 1e-10) + 1e-10).
__device__ __forceinline__ float vx_gumbel_log(float u) { return logf(-logf(u + 1e-10f) + 1e-10f); }

// masked / t, where t = max(temperature, 1e-6): exact, and no division at t == 1
__device__ __forceinline__ float vx_scale(float m, float t) { return t == 1.f ? m : m / t; }

// One count of the radix histogram (256 bins, then a trash bin per lane that
// takes the count when `on` is false: no branch). All lanes call it.
__device__ __forceinline__ void vx_hist_add(unsigned* hist, unsigned bin, bool on, int lane) {
  atomicAdd(&hist[on ? bin : 256u + lane], 1u);
}

// The k-th largest key (1 <= k <= the valid elements) of a warp's row held as
// NC float4 chunks a lane, by radix select over a 256-bin histogram; n_ge:
// how many keys are >= it.
template <int NC>
__device__ __forceinline__ int vx_radix_topk_key(const float (&sc)[NC][4], int VP, int k,
                                                 unsigned* hist, int lane, int& n_ge) {
  unsigned prefix = 0u, pmask = 0u, krem = (unsigned)k;
  uint4* h4 = reinterpret_cast<uint4*>(hist);
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    h4[2 * lane] = make_uint4(0u, 0u, 0u, 0u);
    h4[2 * lane + 1] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned uk = (unsigned)vx_sortable_key(sc[c][e]) ^ 0x80000000u;
        vx_hist_add(hist, (uk >> shift) & 255u, (c * 32 + lane) * 4 < VP && (uk & pmask) == prefix,
                    lane);
      }
    __syncwarp();
    // lane l holds bins 8l .. 8l+7; the higher lanes hold the higher bins
    const uint4 a = h4[2 * lane], b = h4[2 * lane + 1];
    const unsigned cnt[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    unsigned tot = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) tot += cnt[j];
    unsigned suf = tot;  // this lane's bins and every higher lane's
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_down_sync(VX_FULL_MASK, suf, o);
      if (lane + o < 32) suf += v;
    }
    const unsigned above = suf - tot;
    const int src = __ffs(__ballot_sync(VX_FULL_MASK, above < krem && krem <= suf)) - 1;
    int d = -1;
    unsigned abv = above, in_bin = 0u;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (d < 0) {
        if (abv + cnt[j] >= krem) {
          d = 8 * lane + j;
          in_bin = cnt[j];
        } else {
          abv += cnt[j];
        }
      }
    }
    d = __shfl_sync(VX_FULL_MASK, d, src);
    abv = __shfl_sync(VX_FULL_MASK, abv, src);
    in_bin = __shfl_sync(VX_FULL_MASK, in_bin, src);
    krem -= abv;
    prefix |= (unsigned)d << shift;
    pmask |= 0xFFu << shift;
    n_ge = k - krem + in_bin;  // above the bin, and all of it (its keys are one value after pass 4)
    if (in_bin == krem && shift > 0) {
      // the bin holds exactly the rest of k: its least key is the answer
      unsigned lo = 0xFFFFFFFFu;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned uk = (unsigned)vx_sortable_key(sc[c][e]) ^ 0x80000000u;
          if ((c * 32 + lane) * 4 < VP && (uk & pmask) == prefix) lo = min(lo, uk);
        }
      prefix = __reduce_min_sync(VX_FULL_MASK, lo);
      __syncwarp();
      break;
    }
    __syncwarp();  // every lane has read the bins before the next pass clears them
  }
  return (int)(prefix ^ 0x80000000u);
}

// One compare-exchange of the warp's bitonic sort (descending by key): the
// element at index i meets its partner at i ^ j; the lower index of a pair
// keeps the larger key in a descending block ((i & kk) == 0).
__device__ __forceinline__ void vx_bitonic_step(int& key, float& p, int i, int j, int kk) {
  const int pk = __shfl_xor_sync(VX_FULL_MASK, key, j);
  const float pp = __shfl_xor_sync(VX_FULL_MASK, p, j);
  const bool lower = (i & j) == 0, desc = (i & kk) == 0;
  if (lower == desc ? pk > key : pk < key) {
    key = pk;
    p = pp;
  }
}

// tau_p over n <= SE_CAP candidates, (k0, p0) at index lane and (k1, p1) at
// lane + 32 (INT_MIN and 0 past n): the least key whose exclusive prefix of
// p, in descending key order, is <= top_p (INT_MAX when there is none).
__device__ __forceinline__ int vx_topp_sorted(int k0, float p0, int k1, float p1, int n,
                                              float top_p, int lane) {
#pragma unroll
  for (int kk = 2; kk <= 32; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
      vx_bitonic_step(k0, p0, lane, j, kk);
      vx_bitonic_step(k1, p1, lane + 32, j, kk);
    }
  }
  // the last merge (kk = 64, descending everywhere): j = 32 within the lane
  if (k1 > k0) {
    const int tk = k0;
    const float tp = p0;
    k0 = k1;
    p0 = p1;
    k1 = tk;
    p1 = tp;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    vx_bitonic_step(k0, p0, lane, j, 64);
    vx_bitonic_step(k1, p1, lane + 32, j, 64);
  }
  // inclusive scans of p over the sorted positions, then the exclusive ones
  float s0 = p0, s1 = p1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v0 = __shfl_up_sync(VX_FULL_MASK, s0, o);
    const float v1 = __shfl_up_sync(VX_FULL_MASK, s1, o);
    if (lane >= o) {
      s0 += v0;
      s1 += v1;
    }
  }
  const float t0 = __shfl_sync(VX_FULL_MASK, s0, 31);
  s1 += t0;
  float e0 = __shfl_up_sync(VX_FULL_MASK, s0, 1), e1 = __shfl_up_sync(VX_FULL_MASK, s1, 1);
  if (lane == 0) {
    e0 = 0.f;
    e1 = t0;
  }
  const int m0 = lane < n && e0 <= top_p ? k0 : INT_MAX;
  const int m1 = lane + 32 < n && e1 <= top_p ? k1 : INT_MAX;
  return __reduce_min_sync(VX_FULL_MASK, min(m0, m1));
}

// A thread's first best (score, index, the scaled value there) and max of the
// scaled row over its chunks; greedy scores the masked logit, else sc - w.
template <int NC, int THREADS>
__device__ __forceinline__ void vx_local_draw(const float (&sc)[NC][4], const float (&w)[NC][4],
                                              int VP, int tid, bool greedy, float& best, int& bi,
                                              float& sb, float& ml) {
  best = -FLT_MAX;
  bi = INT_MAX;
  sb = 0.f;
  ml = -FLT_MAX;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if ((c * THREADS + tid) * 4 < VP) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float score = greedy ? w[c][e] : sc[c][e] - w[c][e];
        if (score > best || bi == INT_MAX) {
          best = score;
          bi = (c * THREADS + tid) * 4 + e;
          sb = sc[c][e];
        }
        ml = fmaxf(ml, sc[c][e]);
      }
    }
  }
}

// A warp's merge of vx_local_draw: its best score's key (-0 counts as +0, as
// the float compare does), the least index that holds it, the scaled value
// there (from the lane that holds it), and the max of the scaled row.
__device__ __forceinline__ void vx_warp_draw(float best, int& bi, float& sb, float& ml, int& bkey) {
  bkey = __reduce_max_sync(VX_FULL_MASK, vx_sortable_key(best + 0.f));
  const int mine = vx_sortable_key(best + 0.f) == bkey ? bi : INT_MAX;
  const int win = __reduce_min_sync(VX_FULL_MASK, mine);
  const int holder = __ffs(__ballot_sync(VX_FULL_MASK, mine == win)) - 1;
  sb = __shfl_sync(VX_FULL_MASK, sb, holder);
  bi = win;
  ml = vx_key_float(__reduce_max_sync(VX_FULL_MASK, vx_sortable_key(ml)));
}

// ---------------------------------------------------------------------------
// Unfiltered and greedy: SE_ROW_WARPS warps a row.
// ---------------------------------------------------------------------------
template <int NC>
__global__ void __launch_bounds__(SE_ROW_WARPS * 32)
sample_epilogue_draw_kernel(const float* __restrict__ logits, int ldl, const float* __restrict__ u,
                            int ldu, int VP, int vocab, float temperature, int greedy,
                            int* __restrict__ tok_out, float* __restrict__ logp_out,
                            unsigned char* __restrict__ keep_out, int ldk) {
  constexpr int THREADS = SE_ROW_WARPS * 32;
  __shared__ int part_i[SE_ROW_WARPS][2];    // (best key, its least index)
  __shared__ float part_f[SE_ROW_WARPS][3];  // (scaled value there, max, sum of exp)
  const int row = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  const float* lr = logits + (size_t)row * ldl;

  float4 xv[NC], uv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i0 = (c * THREADS + tid) * 4;
    xv[c] = i0 < VP ? *reinterpret_cast<const float4*>(lr + i0) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (!greedy) {
    const float* ur = u + (size_t)row * ldu;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i0 = (c * THREADS + tid) * 4;
      uv[c] = i0 < VP ? *reinterpret_cast<const float4*>(ur + i0) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const float t = fmaxf(temperature, 1e-6f);
  float sc[NC][4], w[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = (c * THREADS + tid) * 4 + e < vocab ? vx_f4(xv[c], e) : VX_NEG_BIG;
      sc[c][e] = vx_scale(m, t);
      w[c][e] = m;
    }
  if (!greedy) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[c][e] = vx_gumbel_log(vx_f4(uv[c], e));
  }
  if (keep_out != nullptr) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i0 = (c * THREADS + tid) * 4;
      if (i0 < VP) *reinterpret_cast<uchar4*>(keep_out + (size_t)row * ldk + i0) = make_uchar4(1, 1, 1, 1);
    }
  }
  float best, sb, ml;
  int bi, bkey;
  vx_local_draw<NC, THREADS>(sc, w, VP, tid, greedy, best, bi, sb, ml);
  vx_warp_draw(best, bi, sb, ml, bkey);
  float se = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if ((c * THREADS + tid) * 4 < VP)
#pragma unroll
      for (int e = 0; e < 4; ++e) se += expf(sc[c][e] - ml);
  se = vx_warp_sum(se);
  if (SE_ROW_WARPS > 1) {
    // the warps' partials, merged in warp order after one named barrier
    if ((tid & 31) == 0) {
      part_i[warp][0] = bkey;
      part_i[warp][1] = bi;
      part_f[warp][0] = sb;
      part_f[warp][1] = ml;
      part_f[warp][2] = se;
    }
    asm volatile("bar.sync 1, %0;" ::"r"(THREADS) : "memory");
    if (tid != 0) return;
    bkey = part_i[0][0];
    bi = part_i[0][1];
    sb = part_f[0][0];
    ml = part_f[0][1];
#pragma unroll
    for (int v = 1; v < SE_ROW_WARPS; ++v) {
      const int k2 = part_i[v][0], i2 = part_i[v][1];
      if (k2 > bkey || (k2 == bkey && i2 < bi)) {
        bkey = k2;
        bi = i2;
        sb = part_f[v][0];
      }
      ml = fmaxf(ml, part_f[v][1]);
    }
    se = 0.f;
#pragma unroll
    for (int v = 0; v < SE_ROW_WARPS; ++v) se += part_f[v][2] * expf(part_f[v][1] - ml);
  } else if (tid != 0) {
    return;
  }
  const int tok = min(bi, vocab - 1);
  if (tok != bi) sb = vx_scale(lr[tok], t);  // clipped: lane vocab - 1 is a real logit
  tok_out[row] = tok;
  logp_out[row] = sb - ml - logf(se);
}

// ---------------------------------------------------------------------------
// Filtered: a warp a row.
// ---------------------------------------------------------------------------
template <int NC>
__global__ void __launch_bounds__(SE_WARPS * 32)
sample_epilogue_filter_kernel(const float* __restrict__ logits, int ldl, const float* __restrict__ u,
                              int ldu, int rows, int VP, int vocab, float temperature, int greedy,
                              int top_k, float top_p, int* __restrict__ tok_out,
                              float* __restrict__ logp_out, unsigned char* __restrict__ keep_out,
                              int ldk) {
  __shared__ __align__(16) unsigned hist_sh[SE_WARPS][256 + 32];
  // the compacted candidates or kept set: scaled value, the draw's source
  // (u, or the masked logit when greedy) and index; then a trash slot a lane
  __shared__ int list_idx[SE_WARPS][SE_LIST + 32];
  __shared__ float list_sc[SE_WARPS][SE_LIST + 32], list_src[SE_WARPS][SE_LIST + 32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * SE_WARPS + warp;
  if (row >= rows) return;
  const float* lr = logits + (size_t)row * ldl;
  int* lidx = list_idx[warp];
  float* lsc = list_sc[warp];
  float* lsrc = list_src[warp];
  const unsigned lt = (1u << lane) - 1u;

  float4 xv[NC], uv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i0 = (c * 32 + lane) * 4;
    xv[c] = i0 < VP ? *reinterpret_cast<const float4*>(lr + i0) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (!greedy) {
    const float* ur = u + (size_t)row * ldu;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i0 = (c * 32 + lane) * 4;
      uv[c] = i0 < VP ? *reinterpret_cast<const float4*>(ur + i0) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const float t = fmaxf(temperature, 1e-6f);
  // sc: the scaled logits; src: the draw's source (the masked logit when
  // greedy, else u)
  float sc[NC][4], src[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = (c * 32 + lane) * 4 + e < vocab ? vx_f4(xv[c], e) : VX_NEG_BIG;
      sc[c][e] = vx_scale(m, t);
      src[c][e] = greedy ? m : vx_f4(uv[c], e);
    }

  // Compact the elements with pred (in index order) into the list; their count.
  auto compact = [&](auto pred) {
    __syncwarp();  // every lane has read the list before it is written again
    int n = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool on = (c * 32 + lane) * 4 < VP && pred(sc[c][e]);
        const unsigned bal = __ballot_sync(VX_FULL_MASK, on);
        const int pos = n + __popc(bal & lt);
        const int at = on && pos < SE_LIST ? pos : SE_LIST + lane;  // no branch
        lsc[at] = sc[c][e];
        lsrc[at] = src[c][e];
        lidx[at] = (c * 32 + lane) * 4 + e;
        n += __popc(bal);
      }
    __syncwarp();
    return n;
  };

  // a logit is kept iff its key >= tau_k and its top-k-filtered value's key
  // >= tau_p; INT_MIN keeps all
  int tau_k = INT_MIN, tau_p = INT_MIN;
  int listed = -1;  // the list holds a superset of the kept set, this many
  int nk = VP;       // the top-k set's size
  if (top_k > 0) tau_k = vx_radix_topk_key<NC>(sc, VP, min(top_k, VP), hist_sh[warp], lane, nk);
  if (top_p < 1.f) {
    // the candidates: the top-k set itself when small (it holds all the mass),
    // else the SE_CAP largest keys
    const bool whole = nk <= SE_CAP;
    int nc = nk;
    const int tau_c = whole ? tau_k : vx_radix_topk_key<NC>(sc, VP, min(SE_CAP, VP), hist_sh[warp], lane, nc);
    const int n = nc <= SE_LIST ? compact([&](float x) { return vx_sortable_key(x) >= tau_c; }) : nc;
    float lse;
    if (whole) {
      // softmax over the candidates: the other logits sit at -1e9, exp 0
      const float c0 = lane < n ? lsc[lane] : -FLT_MAX, c1 = lane + 32 < n ? lsc[lane + 32] : -FLT_MAX;
      const float m = vx_key_float(__reduce_max_sync(VX_FULL_MASK, vx_sortable_key(fmaxf(c0, c1))));
      lse = m + logf(vx_warp_sum((lane < n ? expf(c0 - m) : 0.f) + (lane + 32 < n ? expf(c1 - m) : 0.f)));
    } else {
      int kmax = INT_MIN;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if ((c * 32 + lane) * 4 < VP)
#pragma unroll
          for (int e = 0; e < 4; ++e) kmax = max(kmax, vx_sortable_key(vx_topk_filtered(sc[c][e], tau_k)));
      const float m = vx_key_float(__reduce_max_sync(VX_FULL_MASK, kmax));
      float se = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if ((c * 32 + lane) * 4 < VP)
#pragma unroll
          for (int e = 0; e < 4; ++e) se += expf(vx_topk_filtered(sc[c][e], tau_k) - m);
      lse = m + logf(vx_warp_sum(se));
    }
    bool sorted = false;
    if (n <= SE_CAP) {
      const float p0 = lane < n ? expf(lsc[lane] - lse) : 0.f;
      const float p1 = lane + 32 < n ? expf(lsc[lane + 32] - lse) : 0.f;
      // the SE_CAP largest hold the nucleus iff their mass exceeds top_p
      if (whole || vx_warp_sum(p0 + p1) > top_p) {
        tau_p = vx_topp_sorted(lane < n ? vx_sortable_key(lsc[lane]) : INT_MIN, p0,
                               lane + 32 < n ? vx_sortable_key(lsc[lane + 32]) : INT_MIN, p1, n,
                               top_p, lane);
        sorted = true;
        listed = n;  // the kept set: the candidates with key >= tau_p
      }
    }
    if (!sorted) {
      // the bisection on the registers, from the least key with mass; four
      // partial sums a lane (a fixed order: two runs are bitwise equal)
      float p[NC][4];
      int kf[NC][4];
      float t4[4] = {0.f, 0.f, 0.f, 0.f};
      int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (c * 32 + lane) * 4 < VP;
          const float f = vx_topk_filtered(sc[c][e], tau_k);
          p[c][e] = ok ? expf(f - lse) : 0.f;
          kf[c][e] = vx_sortable_key(f);
          t4[e] += p[c][e];
          if (p[c][e] > 0.f) kmin = min(kmin, kf[c][e]);
          if (ok) kmax = max(kmax, kf[c][e]);
        }
      const float tot = vx_warp_sum((t4[0] + t4[1]) + (t4[2] + t4[3]));
      kmin = __reduce_min_sync(VX_FULL_MASK, kmin);
      kmax = __reduce_max_sync(VX_FULL_MASK, kmax);
      if (top_p < 0.f) {
        tau_p = INT_MAX;
      } else if (tot > top_p) {  // else every logit stays (tau_p = INT_MIN)
        int lo = kmin, hi = kmax;
        while (lo < hi) {
          const int mid = vx_mid(lo, hi);
          float m4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) m4[e] += kf[c][e] > mid ? p[c][e] : 0.f;
          if (vx_warp_sum((m4[0] + m4[1]) + (m4[2] + m4[3])) > top_p) lo = mid + 1;
          else hi = mid;
        }
        tau_p = hi;
      }
    }
  }
  // ---- the kept set -----------------------------------------------------------
  auto kept = [&](float x) {
    return vx_sortable_key(x) >= tau_k && vx_sortable_key(vx_topk_filtered(x, tau_k)) >= tau_p;
  };
  if (keep_out != nullptr) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i0 = (c * 32 + lane) * 4;
      if (i0 < VP)
        *reinterpret_cast<uchar4*>(keep_out + (size_t)row * ldk + i0) =
            make_uchar4(kept(sc[c][0]), kept(sc[c][1]), kept(sc[c][2]), kept(sc[c][3]));
    }
  }
  if (listed < 0) listed = top_p >= 1.f && nk > SE_LIST ? nk : compact(kept);

  // ---- the draw and the log-softmax ------------------------------------------
  float best, sb, ml, se = 0.f;
  int bi, bkey;
  bool done = false;
  if (listed >= 1 && listed <= SE_LIST) {
    // over the kept set alone
    best = -FLT_MAX;
    bi = INT_MAX;
    sb = 0.f;
    ml = -FLT_MAX;
#pragma unroll 1
    for (int j = lane; j < listed; j += 32) {
      if (kept(lsc[j])) {
        const float s = lsc[j];
        const float score = greedy ? lsrc[j] : s - vx_gumbel_log(lsrc[j]);
        if (score > best || bi == INT_MAX) {
          best = score;
          bi = lidx[j];
          sb = s;
        }
        ml = fmaxf(ml, s);
      }
    }
    vx_warp_draw(best, bi, sb, ml, bkey);
    // a removed logit scores -1e30 (greedy: its masked logit, below the kept
    // maximum): the kept set's winner is the row's unless it is no better
    done = (greedy || vx_key_float(bkey) > VX_NEG_BIG) && bi < vocab;
    if (done) {
#pragma unroll 1
      for (int j = lane; j < listed; j += 32)
        if (kept(lsc[j])) se += expf(lsc[j] - ml);
    }
  }
  if (!done) {
    // the whole row, removed logits at -1e30
    float w[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!kept(sc[c][e])) sc[c][e] = VX_NEG_BIG;
        w[c][e] = greedy ? src[c][e] : vx_gumbel_log(src[c][e]);
      }
    vx_local_draw<NC, 32>(sc, w, VP, lane, greedy, best, bi, sb, ml);
    vx_warp_draw(best, bi, sb, ml, bkey);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if ((c * 32 + lane) * 4 < VP)
#pragma unroll
        for (int e = 0; e < 4; ++e) se += expf(sc[c][e] - ml);
    if (bi > vocab - 1) {
      // clipped: the scaled (kept or -1e30) value at vocab - 1
      float mine = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((c * 32 + lane) * 4 + e == vocab - 1) mine = sc[c][e];
      sb = __shfl_sync(VX_FULL_MASK, mine, ((vocab - 1) >> 2) & 31);
    }
  }
  se = vx_warp_sum(se);
  if (lane == 0) {
    tok_out[row] = min(bi, vocab - 1);
    logp_out[row] = sb - ml - logf(se);
  }
}

template <int NC>
static cudaError_t launch_draw(const float* logits, int ldl, const float* u, int ldu, int rows,
                               int VP, int vocab, float temperature, int greedy, int* tok,
                               float* logp, unsigned char* keep_out, int ldk, cudaStream_t s) {
  sample_epilogue_draw_kernel<NC><<<rows, SE_ROW_WARPS * 32, 0, s>>>(
      logits, ldl, u, ldu, VP, vocab, temperature, greedy, tok, logp, keep_out, ldk);
  return cudaGetLastError();
}

template <int NC>
static cudaError_t launch_filter(const float* logits, int ldl, const float* u, int ldu, int rows,
                                 int VP, int vocab, float temperature, int greedy, int top_k,
                                 float top_p, int* tok, float* logp, unsigned char* keep_out,
                                 int ldk, cudaStream_t s) {
  sample_epilogue_filter_kernel<NC><<<(rows + SE_WARPS - 1) / SE_WARPS, SE_WARPS * 32, 0, s>>>(
      logits, ldl, u, ldu, rows, VP, vocab, temperature, greedy, top_k, top_p, tok, logp, keep_out,
      ldk);
  return cudaGetLastError();
}

// logits: [rows, VP] f32 (row stride ldl); u: [rows, VP] f32 uniforms in
// [0, 1) (row stride ldu), ignored when greedy; filtered != 0 applies top_k
// (<= 0: off) then top_p (>= 1: off); outputs tok [rows] int32 and logp
// [rows] f32, and, when keep_out is not null, the kept set [rows, VP] uint8
// (row stride ldk). VP <= SE_VP_MAX and a multiple of 4; the logits, the
// uniforms and keep_out start on 16-, 16- and 4-byte boundaries and their
// row strides are multiples of 4 elements.
extern "C" int vx_sample_epilogue(const float* logits, int ldl, const float* u, int ldu,
                                  int rows, int VP, int vocab, float temperature, int greedy,
                                  int filtered, int top_k, float top_p, int* tok, float* logp,
                                  unsigned char* keep_out, int ldk, void* stream) {
  if (rows < 1 || vocab < 1 || vocab > VP || VP > SE_VP_MAX || (VP & 3) ||
      ((uintptr_t)logits & 15) || (ldl & 3) ||
      (!greedy && (((uintptr_t)u & 15) || (ldu & 3))) ||
      (keep_out != nullptr && (((uintptr_t)keep_out & 3) || (ldk & 3))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!filtered) {
    const int nc = (VP + 128 * SE_ROW_WARPS - 1) / (128 * SE_ROW_WARPS);
#define SE_ARGS logits, ldl, u, ldu, rows, VP, vocab, temperature, greedy, tok, logp, keep_out, ldk, s
    return (int)(nc <= 1   ? launch_draw<1>(SE_ARGS)
                 : nc <= 2 ? launch_draw<2>(SE_ARGS)
                 : nc <= 3 ? launch_draw<3>(SE_ARGS)
                 : nc <= 4 ? launch_draw<4>(SE_ARGS)
                 : nc <= 9 ? launch_draw<9>(SE_ARGS)
                           : launch_draw<16>(SE_ARGS));
#undef SE_ARGS
  }
  const int nc = (VP + 127) / 128;
#define SE_ARGS logits, ldl, u, ldu, rows, VP, vocab, temperature, greedy, top_k, top_p, tok, logp, \
                keep_out, ldk, s
  return (int)(nc <= 1   ? launch_filter<1>(SE_ARGS)
               : nc <= 2 ? launch_filter<2>(SE_ARGS)
               : nc <= 4 ? launch_filter<4>(SE_ARGS)
               : nc <= 9 ? launch_filter<9>(SE_ARGS)
                         : launch_filter<16>(SE_ARGS));
#undef SE_ARGS
}
