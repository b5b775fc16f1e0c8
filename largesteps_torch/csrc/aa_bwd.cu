// aa_bwd: nvdiffrast antialias, backward.
//
// Replaces: largesteps_tpu/render/pallas_core.py, aa_bwd_pallas (line 1819)
// / _aa_bwd_kernel (line 1706).  The TPU kernel gathers owner records and
// reduces the endpoint gradients per slot with one-hot bf16 matmuls keyed by
// face id, and writes three colour-cotangent planes that XLA shifts and adds.
//
// Bound on the H100: bytes.  A pixel reads its id, depth, colour and output
// cotangent and writes its colour cotangent; the arithmetic of the pairs
// whose ids differ is small beside that.
//
// Design: the grid, the pair list, the owner tables and the phases of
// aa_fwd.cu.
// - d_color is written whole: a pixel sums its own two pairs' cotangents,
//   then adds d_out, then the shares of the pairs anchored at its left and
//   lower neighbour, in the plain version's order
//   (render/kernels.py:_aa_bwd_combine).
// - The screen-space gradients of the winning edge's two endpoints, through
//   the crossing parameter t, are summed for the pairs anchored in the strip
//   only, at the owner's slot of this tile, in a fixed order (common.cuh,
//   "Fixed-order sums"; global float atomics would add in the order the
//   strips arrive, and two launches would differ in their last bits).  A
//   blending pair writes its six endpoint values to its own place in a
//   scratch of the strip's anchored pairs and appends its key, slot << 13 |
//   strip << 11 | the pair's place, to the strip's list (an integer
//   counter, so the list's order changes from launch to launch).  A second
//   kernel, aa_bwd_sums, one block a tile, zeroes the tile's output rows,
//   sorts the tile's keys on every bit (ls::block_sort: the keys are
//   distinct, so their order is fixed whatever order they came in) and adds
//   each slot's pairs in key order, one thread a slot: pairs a slot are
//   few, on the silhouette.
// - Row shards: as aa_fwd.cu's, with the output cotangent's halo row; the
//   endpoint gradients of a pair anchored at the last row go to this
//   shard's slots, as the TPU kernel's per-tile sums do.
// - Sliver guard, as pallas_core.py:1786: a non-finite endpoint contribution
//   (a near-zero crossing denominator overflows 1/den²) is zeroed.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sane(float x) {
  return fabsf(x) < ls::BIG ? x : 0.0f;   // false for inf and NaN alike
}

// The strip's anchored pairs: a place each, right and down pair of every
// pixel of the strip.
constexpr int AA_PAIRS = 2 * ls::STRIP_H * ls::TILE_W;
constexpr int PAIR_BITS = 11;
static_assert(AA_PAIRS == 1 << PAIR_BITS && ls::STRIPS == 4,
              "a tile's pairs fit the key's low 13 bits");
constexpr int KEY_SHIFT = PAIR_BITS + 2;    // slot << 13 | strip << 11 | pair

// Where the strips of the block's tile leave their pairs: region
// tile * STRIPS + strip holds AA_PAIRS keys and the pairs' six endpoint
// values (eight floats a place), and n[region] the keys listed.
struct PairLists {
  unsigned* keys;
  float* vals;
  int* n;
};

// The endpoint gradients of a blending pair anchored in the strip, through
// t, at its owner's slot of this tile: the pair's six values (zero but the
// taken edge's four) at its place, its key on the strip's list.
template <int D>
__device__ __forceinline__ void endpoint_grads(
    const ls::OwnerTable& tab, const ls::AaItem& q, int slot, int take,
    float t, const float* __restrict__ color, const float* __restrict__ dout,
    const ls::AaGrid& g, const PairLists& pl, int strip, int* listed) {
  float c0[D], cn[D], d0[D], dn[D];
  ls::load_px<D>(color, q.p, c0);
  const ls::Px pc = ls::aa_nb_px(color, g.hcol, q);
  ls::load_px<D>(pc.p, pc.i, cn);
  ls::load_px<D>(dout, q.p, d0);
  const ls::Px pd = ls::aa_nb_px(dout, g.hdout, q);
  ls::load_px<D>(pd.p, pd.i, dn);
  const bool lo = t < 0.5f;           // else t >= 0.5: the pair blends
  float dt = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) dt = dt - (cn[k] - c0[k]) * (lo ? d0[k] : dn[k]);
  float fld[9];
  ls::aa_fields(tab.rb + (size_t)slot * 32, fld);
  const float pbx = q.pax + q.d_ex;
  const float pby = q.pay + q.d_ey;
  float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 3; ++e) {     // only the taken edge has dt != 0
    if (e != take) continue;
    const ls::Edge g = ls::aa_edge(fld, e, q.pax, q.pay, q.d_ex, q.d_ey);
    const float inv_d2 = 1.0f / (g.den * g.den);
    const float dea = sane(dt * (-g.eb) * inv_d2);
    const float deb = sane(dt * g.ea * inv_d2);
    const int j0 = e, j1 = (e + 1) % 3;
    v[2 * j0] = dea * (g.by - q.pay) + deb * (g.by - pby);
    v[2 * j0 + 1] = dea * (q.pax - g.bx) + deb * (pbx - g.bx);
    v[2 * j1] = dea * (q.pay - g.ay) + deb * (pby - g.ay);
    v[2 * j1 + 1] = dea * (g.ax - q.pax) + deb * (g.ax - pbx);
  }
  const int place = (q.r * ls::TILE_W + q.c) * 2 + q.dir;
  const size_t region = (size_t)blockIdx.x * AA_PAIRS;
  float4* o = reinterpret_cast<float4*>(pl.vals + (region + place) * 8);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], 0.0f, 0.0f);
  pl.keys[region + atomicAdd(listed, 1)] =
      ((unsigned)slot << KEY_SHIFT) | ((unsigned)strip << PAIR_BITS) |
      (unsigned)place;
}

template <int D>
__global__ void __launch_bounds__(ls::AA_THREADS)
aa_bwd_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
              const float* __restrict__ fidp, const float* __restrict__ zp,
              const float* __restrict__ color, const float* __restrict__ dout,
              float* __restrict__ dcol, const PairLists pl,
              const ls::AaGrid g) {
  extern __shared__ unsigned long long smem[];   // the owner tables
  __shared__ ls::AaShared sh;
  __shared__ int listed;
  const int H = g.H, W = g.W;
  const ls::StripBlock b = ls::strip_block(g.TY, g.TX);
  if (threadIdx.x == 0) listed = 0;
  const ls::AaTables T = ls::aa_collect(rec, counts, fidp, smem, g, b, sh);

  // phase 2: the crossings of the listed pairs; the endpoint gradients of
  // those anchored in the strip
  for (int k = threadIdx.x; k < sh.count; k += blockDim.x) {
    const ls::AaItem q = ls::aa_item(sh.list[k], b, g);
    const ls::OwnerTable tab = T.get(q.table);
    float t = 0.0f;
    int slot, take;
    const bool act = ls::aa_pair(tab, fidp[q.p], zp[q.p],
                                 ls::aa_nb(fidp, g.hfid, q),
                                 ls::aa_nb(zp, g.hz, q), q.pax, q.pay, q.d_ex,
                                 q.d_ey, t, slot, take);
    if (act) sh.t[q.code] = t;
    if (act && q.table == 0 && q.r >= 0)
      endpoint_grads<D>(tab, q, slot, take, t, color, dout, g, pl, b.strip,
                        &listed);
  }
  __syncthreads();
  if (threadIdx.x == 0) pl.n[blockIdx.x] = listed;

  // phase 3: own pairs' cotangents, plus d_out, plus the left and the
  // lower neighbour's shares
  const int c = threadIdx.x % ls::TILE_W;
  const int x = b.tx * ls::TILE_W + c;
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    const int r = threadIdx.x / ls::TILE_W + ls::AA_ROWS * i;
    const int y = b.ty * ls::TILE_H + b.strip * ls::STRIP_H + r;
    const size_t p = ((size_t)b.c * H + y) * W + x;
    const ls::AaWeights w = ls::aa_weights_at(sh, r, c);
    float d0[D], dn[D], o[D];
    ls::load_px<D>(dout, p, d0);
    ls::load_px<D>(dout, p - x + min(x + 1, W - 1), dn);
#pragma unroll
    for (int k = 0; k < D; ++k) o[k] = 0.0f - w.wa_h * d0[k] + w.wb_h * dn[k];
    const ls::Px pd = ls::aa_down(dout, g.hdout, b.c, y, x, H, W);
    ls::load_px<D>(pd.p, pd.i, dn);
#pragma unroll
    for (int k = 0; k < D; ++k)
      o[k] = (o[k] - w.wa_v * d0[k] + w.wb_v * dn[k]) + d0[k];
    if (g.share != nullptr && y + 1 == H) {   // the next shard's row 0
      float s[D];
#pragma unroll
      for (int k = 0; k < D; ++k) s[k] = w.wa_v * d0[k] - w.wb_v * dn[k];
      ls::store_px<D>(g.share, (size_t)b.c * W + x, s);
    }
    if (x > 0) ls::load_px<D>(dout, p - 1, dn);
#pragma unroll
    for (int k = 0; k < D; ++k)
      o[k] = o[k] + (x > 0 ? w.wa_l * dn[k] - w.wb_l * d0[k] : 0.0f);
    if (y > 0) ls::load_px<D>(dout, p - W, dn);
#pragma unroll
    for (int k = 0; k < D; ++k)
      o[k] = o[k] + (y > 0 ? w.wa_b * dn[k] - w.wb_b * d0[k] : 0.0f);
    ls::store_px<D>(dcol, p, o);
  }
}

constexpr int AS_THREADS = 1024;
constexpr int AS_ITEMS = ls::STRIPS * AA_PAIRS / AS_THREADS;   // at most
constexpr int AS_HIST = ls::SORT_RADIX * AS_ITEMS * AS_THREADS / 32;
constexpr size_t AS_SMEM = (2 * AS_THREADS * AS_ITEMS + AS_HIST) * 4;

// The n keys sorted on their bits [0, hi), with as few items a thread as n
// allows (a pass costs in proportion to them).
template <int ITEMS>
__device__ __forceinline__ const unsigned* sort_pairs(unsigned* keys,
                                                      unsigned* tmp,
                                                      int* hist,
                                                      int* warp_tot, int n,
                                                      int hi) {
  if constexpr (ITEMS > 1) {
    if (n <= AS_THREADS * ITEMS / 2)
      return sort_pairs<ITEMS / 2>(keys, tmp, hist, warp_tot, n, hi);
  }
  return ls::block_sort<AS_THREADS, ITEMS>(keys, tmp, hist, warp_tot, n, 0,
                                           hi);
}

// One block a tile: zeroes the tile's (cap, 8) rows of dslot, sorts the keys
// its strips listed, and writes each listed slot's six endpoint sums, its
// pairs added in key order (strip, then the pair's place) by one thread.
__global__ void __launch_bounds__(AS_THREADS, 1)
aa_bwd_sums(const PairLists pl, float* __restrict__ dslot, int cap,
            int slot_bits) {
  extern __shared__ float4 smem4[];
  unsigned* keys = reinterpret_cast<unsigned*>(smem4);
  unsigned* tmp = keys + AS_THREADS * AS_ITEMS;
  int* hist = reinterpret_cast<int*>(tmp + AS_THREADS * AS_ITEMS);
  __shared__ int warp_tot[32], start[ls::STRIPS + 1];
  const int tile = blockIdx.x;
  float4* ob = reinterpret_cast<float4*>(dslot + (size_t)tile * cap * 8);
  for (int i = threadIdx.x; i < cap * 2; i += blockDim.x)
    ob[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int k = 0; k < ls::STRIPS; ++k) {
      start[k] = n;
      n += pl.n[tile * ls::STRIPS + k];
    }
    start[ls::STRIPS] = n;
  }
  __syncthreads();
  const int n = start[ls::STRIPS];
  if (n == 0) return;
  for (int k = 0; k < ls::STRIPS; ++k) {
    const unsigned* src = pl.keys + (size_t)(tile * ls::STRIPS + k) * AA_PAIRS;
    for (int i = threadIdx.x; i < start[k + 1] - start[k]; i += blockDim.x)
      keys[start[k] + i] = src[i];
  }
  __syncthreads();
  const unsigned* S = sort_pairs<AS_ITEMS>(keys, tmp, hist, warp_tot, n,
                                           KEY_SHIFT + slot_bits);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned s = S[i] >> KEY_SHIFT;
    if (i > 0 && S[i - 1] >> KEY_SHIFT == s) continue;   // not the first
    float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = i; j < n && S[j] >> KEY_SHIFT == s; ++j) {
      const unsigned k = S[j];
      const size_t region = (size_t)tile * ls::STRIPS + ((k >> PAIR_BITS) & 3);
      const float4* v = reinterpret_cast<const float4*>(
          pl.vals + (region * AA_PAIRS + (k & (AA_PAIRS - 1))) * 8);
      const float4 v0 = v[0], v1 = v[1];
      a[0] += v0.x;
      a[1] += v0.y;
      a[2] += v0.z;
      a[3] += v0.w;
      a[4] += v1.x;
      a[5] += v1.y;
    }
    ob[2 * s] = make_float4(a[0], a[1], a[2], a[3]);
    ob[2 * s + 1] = make_float4(a[4], a[5], 0.0f, 0.0f);
  }
}

}  // namespace

// D = 4 (shaded) or 3 (silhouette) colour channels; `scratch`, the planes'
// rows and the halo as aa_fwd's (ls_aa_scratch and ls_aa_fwd in aa_fwd.cu),
// with the output cotangent's halo row hdout.  `pairs` holds the strips'
// pair lists, ls_aa_pairs_bytes(tiles) bytes; dslot needs no zeroing.
extern "C" long long ls_aa_pairs_bytes(int tiles) {
  return (long long)tiles * ls::STRIPS * (AA_PAIRS * (4 + 32) + 4);
}

extern "C" int ls_aa_bwd(const float* rec, const int* counts, const float* fid,
                         const float* z, const float* color, const float* dout,
                         float* dcol, float* dslot, void* scratch, void* pairs,
                         const float* hfid, const float* hz, const float* hcol,
                         const float* hdout, float* share, int C, int TY,
                         int TX, int cap, int H, int W, int D, int row0,
                         float sxs, float sys, void* stream) {
  const ls::AaGrid g{nullptr, nullptr, TY, TX, cap, 0, H, W, sxs, sys,
                     row0, hfid, hz, hcol, hdout, share};
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = C * TY * TX;
  const int slot_bits = ls::bits_for(cap);
  if (KEY_SHIFT + slot_bits > 32) return (int)cudaErrorInvalidValue;
  const size_t regions = (size_t)tiles * ls::STRIPS;
  float* vals = static_cast<float*>(pairs);
  unsigned* keys = reinterpret_cast<unsigned*>(vals + regions * AA_PAIRS * 8);
  const PairLists pl{keys, vals,
                     reinterpret_cast<int*>(keys + regions * AA_PAIRS)};
  int e;
  switch (D) {
    case 3:
      e = ls::aa_launch<aa_bwd_kernel<3>>(g, C, scratch, s, rec, counts, fid,
                                          z, color, dout, dcol, pl);
      break;
    case 4:
      e = ls::aa_launch<aa_bwd_kernel<4>>(g, C, scratch, s, rec, counts, fid,
                                          z, color, dout, dcol, pl);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || tiles == 0) return e;
  const cudaError_t o = ls::smem_opt_in<aa_bwd_sums>(AS_SMEM, 160);
  if (o != cudaSuccess) return (int)o;
  aa_bwd_sums<<<tiles, AS_THREADS, AS_SMEM, s>>>(pl, dslot, cap, slot_bits);
  return (int)cudaGetLastError();
}
