// aa_fwd: nvdiffrast antialias, forward.
//
// Replaces: largesteps_tpu/render/pallas_core.py, aa_fwd_pallas (line 1635)
// / _aa_fwd_kernel (line 1524).  The TPU kernel fetches each pair owner's
// record with a one-hot bf16 matmul keyed by face id and writes three
// planes (the anchor's blend and the right and down neighbours' shares),
// which XLA shifts back and adds (pallas_core.py:1696-1701).
//
// Bound on the H100: bytes.  A pixel reads its id, depth and colour and
// writes its colour; only the pairs whose ids differ (about 14 % on the main
// path) run the few dozen float ops of the crossing test.
//
// Design, to move little more than those bytes:
// - Only the pairs whose ids differ run a lookup and an edge test, each
//   once: a block first lists them (compacted, so every lane of a warp has
//   one), then combines (common.cuh, "A block works in three phases").
// - Owner lookup in O(1): hash tables face id -> lowest live slot, built
//   from the bins' id column (common.cuh:OwnerTable), where a search of the
//   tile's bin (hundreds of ids) for every pair took most of the time.  A
//   block builds its tables in shared memory; at large caps each tile's
//   table is built once in global memory and shared (common.cuh, AA_TABLES).
// - The shift-and-add is fused: a pixel adds, in the order of the plain
//   version (render/kernels.py:_aa_fwd_combine), its own blend, the share
//   of the pair anchored at its left neighbour and that of the pair
//   anchored at its lower neighbour, and writes the final colour.  A pair
//   anchored in the tile to the left or below is looked up in that tile's
//   bin, as the plain version does, so the result is the same even where
//   bins overflow.
// - A grid that fills the card: one block of 512 threads per (camera, tile,
//   8-row strip), two pixels a thread (832 blocks at 13 views of 256²).
// - Colour moves as one float4 a pixel when D = 4; no per-thread array is
//   indexed at run time, so nothing lives on the stack.
// - Row shards (pallas_core.py:_shift_up_halo, _shift_down_ch_halo): pixel
//   centres are the image's (tile row + row0).  The down neighbours of the
//   last row come from the halo rows, and the share that a pair anchored
//   there gives its neighbour, which the TPU path's shift would carry onto
//   the next shard, is written to a share row instead; the pair below row
//   0 is not listed there (its anchor is the previous shard's), so the
//   caller's add of that shard's share row completes row 0 in the plain
//   version's order.
#include "common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(ls::AA_THREADS)
aa_fwd_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
              const float* __restrict__ fidp, const float* __restrict__ zp,
              const float* __restrict__ color, float* __restrict__ out,
              const ls::AaGrid g) {
  extern __shared__ unsigned long long smem[];   // the owner tables
  __shared__ ls::AaShared sh;
  const int H = g.H, W = g.W;
  const ls::StripBlock b = ls::strip_block(g.TY, g.TX);
  const ls::AaTables T = ls::aa_collect(rec, counts, fidp, smem, g, b, sh);

  // phase 2: the crossings of the listed pairs
  for (int k = threadIdx.x; k < sh.count; k += blockDim.x) {
    const ls::AaItem q = ls::aa_item(sh.list[k], b, g);
    float t = 0.0f;
    int slot, take;
    if (ls::aa_pair(T.get(q.table), fidp[q.p], zp[q.p],
                    ls::aa_nb(fidp, g.hfid, q), ls::aa_nb(zp, g.hz, q),
                    q.pax, q.pay, q.d_ex, q.d_ey, t, slot, take))
      sh.t[q.code] = t;
  }
  __syncthreads();

  // phase 3: own blend, plus the left and the lower neighbour's share
  const int c = threadIdx.x % ls::TILE_W;
  const int x = b.tx * ls::TILE_W + c;
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    const int r = threadIdx.x / ls::TILE_W + ls::AA_ROWS * i;
    const int y = b.ty * ls::TILE_H + b.strip * ls::STRIP_H + r;
    const size_t p = ((size_t)b.c * H + y) * W + x;
    const ls::AaWeights w = ls::aa_weights_at(sh, r, c);
    float c0[D], cn[D], o[D];
    ls::load_px<D>(color, p, c0);
    ls::load_px<D>(color, p - x + min(x + 1, W - 1), cn);
#pragma unroll
    for (int k = 0; k < D; ++k) o[k] = c0[k] + w.wa_h * (cn[k] - c0[k]);
    const ls::Px dn = ls::aa_down(color, g.hcol, b.c, y, x, H, W);
    ls::load_px<D>(dn.p, dn.i, cn);
#pragma unroll
    for (int k = 0; k < D; ++k) o[k] = o[k] + w.wa_v * (cn[k] - c0[k]);
    if (g.share != nullptr && y + 1 == H) {   // the next shard's row 0
      float s[D];
#pragma unroll
      for (int k = 0; k < D; ++k) s[k] = -w.wb_v * (cn[k] - c0[k]);
      ls::store_px<D>(g.share, (size_t)b.c * W + x, s);
    }
    if (x > 0) ls::load_px<D>(color, p - 1, cn);
#pragma unroll
    for (int k = 0; k < D; ++k)
      o[k] = o[k] + (x > 0 ? -w.wb_l * (c0[k] - cn[k]) : 0.0f);
    if (y > 0) ls::load_px<D>(color, p - W, cn);
#pragma unroll
    for (int k = 0; k < D; ++k)
      o[k] = o[k] + (y > 0 ? -w.wb_b * (c0[k] - cn[k]) : 0.0f);
    ls::store_px<D>(out, p, o);
  }
}

}  // namespace

// Bytes of the zeroed global scratch the owner tables of both antialias
// kernels need for `tiles` tiles (0: they fit shared memory).
extern "C" long long ls_aa_scratch(int tiles, int cap) {
  return ls::aa_scratch_bytes(tiles, cap);
}

// D = 4 (shaded) or 3 (silhouette) colour channels.  Row shards (AaGrid in
// common.cuh): the planes are H = 32 TY rows from tile row row0; hfid, hz,
// hcol the halo rows and share the share row, or all null.
extern "C" int ls_aa_fwd(const float* rec, const int* counts,
                         const float* fid, const float* z, const float* color,
                         float* out, void* scratch, const float* hfid,
                         const float* hz, const float* hcol, float* share,
                         int C, int TY, int TX, int cap, int H, int W, int D,
                         int row0, float sxs, float sys, void* stream) {
  const ls::AaGrid g{nullptr, nullptr, TY, TX, cap, 0, H, W, sxs, sys,
                     row0, hfid, hz, hcol, nullptr, share};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 3:
      return ls::aa_launch<aa_fwd_kernel<3>>(g, C, scratch, s, rec, counts,
                                             fid, z, color, out);
    case 4:
      return ls::aa_launch<aa_fwd_kernel<4>>(g, C, scratch, s, rec, counts,
                                             fid, z, color, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
