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
//   the crossing parameter t, are added for the pairs anchored in the strip
//   only, at the owner's slot of this tile, into the zeroed output with
//   global atomics (four a blending pair; a per-block shared table flushed
//   at the end measured slower on the H100, since the tile's strips share
//   the slots).
// - Sliver guard, as pallas_core.py:1786: a non-finite endpoint contribution
//   (a near-zero crossing denominator overflows 1/den²) is zeroed.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sane(float x) {
  return fabsf(x) < ls::BIG ? x : 0.0f;   // false for inf and NaN alike
}

// The endpoint gradients of a blending pair anchored in the strip, through
// t, added at its owner's slot of this tile's rows of dslot (`ob`).
template <int D>
__device__ __forceinline__ void endpoint_grads(
    const ls::OwnerTable& tab, const ls::AaItem& q, int slot, int take,
    float t, const float* __restrict__ color, const float* __restrict__ dout,
    float* ob) {
  float c0[D], cn[D], d0[D], dn[D];
  ls::load_px<D>(color, q.p, c0);
  ls::load_px<D>(color, q.pn, cn);
  ls::load_px<D>(dout, q.p, d0);
  ls::load_px<D>(dout, q.pn, dn);
  const bool lo = t < 0.5f;           // else t >= 0.5: the pair blends
  float dt = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) dt = dt - (cn[k] - c0[k]) * (lo ? d0[k] : dn[k]);
  float fld[9];
  ls::aa_fields(tab.rb + (size_t)slot * 32, fld);
  float* row = ob + (size_t)slot * 8;
  const float pbx = q.pax + q.d_ex;
  const float pby = q.pay + q.d_ey;
#pragma unroll
  for (int e = 0; e < 3; ++e) {     // only the taken edge has dt != 0
    if (e != take) continue;
    const ls::Edge g = ls::aa_edge(fld, e, q.pax, q.pay, q.d_ex, q.d_ey);
    const float inv_d2 = 1.0f / (g.den * g.den);
    const float dea = sane(dt * (-g.eb) * inv_d2);
    const float deb = sane(dt * g.ea * inv_d2);
    const int j0 = e, j1 = (e + 1) % 3;
    atomicAdd(row + 2 * j0, dea * (g.by - q.pay) + deb * (g.by - pby));
    atomicAdd(row + 2 * j0 + 1, dea * (q.pax - g.bx) + deb * (pbx - g.bx));
    atomicAdd(row + 2 * j1, dea * (q.pay - g.ay) + deb * (pby - g.ay));
    atomicAdd(row + 2 * j1 + 1, dea * (g.ax - q.pax) + deb * (g.ax - pbx));
  }
}

template <int D>
__global__ void __launch_bounds__(ls::AA_THREADS)
aa_bwd_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
              const float* __restrict__ fidp, const float* __restrict__ zp,
              const float* __restrict__ color, const float* __restrict__ dout,
              float* __restrict__ dcol, float* __restrict__ dslot,
              const ls::AaGrid g) {
  extern __shared__ unsigned long long smem[];   // the owner tables
  __shared__ ls::AaShared sh;
  const int H = g.H, W = g.W;
  const ls::StripBlock b = ls::strip_block(g.TY, g.TX);
  float* ob = dslot + (size_t)b.tile * g.cap * 8;
  const ls::AaTables T = ls::aa_collect(rec, counts, fidp, smem, g, b, sh);

  // phase 2: the crossings of the listed pairs; the endpoint gradients of
  // those anchored in the strip
  for (int k = threadIdx.x; k < sh.count; k += blockDim.x) {
    const ls::AaItem q = ls::aa_item(sh.list[k], b, H, W, g.sxs, g.sys);
    const ls::OwnerTable tab = T.get(q.table);
    float t = 0.0f;
    int slot, take;
    const bool act = ls::aa_pair(tab, fidp[q.p], zp[q.p], fidp[q.pn],
                                 zp[q.pn], q.pax, q.pay, q.d_ex, q.d_ey, t,
                                 slot, take);
    if (act) sh.t[q.code] = t;
    if (act && q.table == 0 && q.r >= 0)
      endpoint_grads<D>(tab, q, slot, take, t, color, dout, ob);
  }
  __syncthreads();

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
    ls::load_px<D>(dout, ((size_t)b.c * H + min(y + 1, H - 1)) * W + x, dn);
#pragma unroll
    for (int k = 0; k < D; ++k)
      o[k] = (o[k] - w.wa_v * d0[k] + w.wb_v * dn[k]) + d0[k];
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

}  // namespace

// D = 4 (shaded) or 3 (silhouette) colour channels; `scratch` as aa_fwd's
// (ls_aa_scratch in aa_fwd.cu).
extern "C" int ls_aa_bwd(const float* rec, const int* counts, const float* fid,
                         const float* z, const float* color, const float* dout,
                         float* dcol, float* dslot, void* scratch, int C,
                         int TY, int TX, int cap, int H, int W, int D,
                         float sxs, float sys, void* stream) {
  const ls::AaGrid g{nullptr, nullptr, TY, TX, cap, 0, H, W, sxs, sys};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 3:
      return ls::aa_launch<aa_bwd_kernel<3>>(g, C, scratch, s, rec, counts,
                                             fid, z, color, dout, dcol, dslot);
    case 4:
      return ls::aa_launch<aa_bwd_kernel<4>>(g, C, scratch, s, rec, counts,
                                             fid, z, color, dout, dcol, dslot);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
