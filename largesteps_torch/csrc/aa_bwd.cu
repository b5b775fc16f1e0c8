// aa_bwd: nvdiffrast antialias, backward.
//
// Replaces: largesteps_tpu/render/pallas_core.py, aa_bwd_pallas /
// _aa_bwd_kernel (the TPU kernel gathers owner records and reduces the
// endpoint gradients per slot with one-hot bf16 matmuls keyed by face id;
// here a bin search finds the owner's slot and atomics sum per slot).
//
// Bound on the H100: bytes.  Per pixel it reads the id, depth, colour and
// output-cotangent planes of the pixel and its two neighbours and writes
// three cotangent planes; the arithmetic on the pairs whose ids differ is
// small beside that.
//
// Design: the grid, the pixel mapping and the owner search of aa_fwd.cu.
// The colour cotangents go out as the JAX kernel's three planes (the
// anchor's own and the right and down neighbours' shares, shifted back by
// the wrapper).  The screen-space gradients of the winning edge's two
// endpoints, through the crossing parameter t, are summed over both pair
// directions into a (cap, 6) shared-memory table per owner slot (18 KB at
// cap 768), or straight into the zeroed output with global atomics where the
// table does not fit.  The sliver guard zeroes non-finite contributions, as
// pallas_core.py:1786 does.
#include "common.cuh"

namespace {

constexpr int CH = 1024;   // face ids per shared-memory chunk

__device__ __forceinline__ float sane(float x) {
  return fabsf(x) < ls::BIG ? x : 0.0f;   // false for inf and NaN alike
}

__global__ void __launch_bounds__(ls::THREADS)
aa_bwd_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
              const float* __restrict__ fidp, const float* __restrict__ zp,
              const float* __restrict__ color, const float* __restrict__ dout,
              float* __restrict__ dcol, float* __restrict__ dslot, int C,
              int TY, int TX, int cap, int H, int W, int D, float sxs,
              float sys, int use_smem) {
  __shared__ float sfid[CH];
  extern __shared__ float tab[];          // (cap, 6) when use_smem
  const ls::Tile t = ls::tile_of_block(TY, TX);
  const int n = min(counts[t.b], cap);
  const float* rb = rec + (size_t)t.b * cap * 32;
  float* ob = dslot + (size_t)t.b * cap * 8;
  const int col = threadIdx.x % ls::TILE_W;
  const int x = t.tx * ls::TILE_W + col;
  const int xr = min(x + 1, W - 1);
  if (use_smem)
    for (int i = threadIdx.x; i < cap * 6; i += blockDim.x) tab[i] = 0.0f;

  float key[2 * ls::PPT], own[2 * ls::PPT], oth[2 * ls::PPT];
  int slot[2 * ls::PPT];
#pragma unroll
  for (int i = 0; i < ls::PPT; ++i) {
    const int y = t.ty * ls::TILE_H + threadIdx.x / ls::TILE_W + 2 * i;
    const int yd = min(y + 1, H - 1);
    const size_t pix = ((size_t)t.c * H + y) * W + x;
    const size_t pr = ((size_t)t.c * H + y) * W + xr;
    const size_t pd = ((size_t)t.c * H + yd) * W + x;
    bool dif;
    ls::aa_common(fidp[pix], zp[pix], fidp[pr], zp[pr], own[2 * i],
                  oth[2 * i], dif);
    key[2 * i] = dif ? own[2 * i] : 0.0f;
    ls::aa_common(fidp[pix], zp[pix], fidp[pd], zp[pd], own[2 * i + 1],
                  oth[2 * i + 1], dif);
    key[2 * i + 1] = dif ? own[2 * i + 1] : 0.0f;
    slot[2 * i] = slot[2 * i + 1] = -1;
  }
  ls::find_slots(rb, n, sfid, CH, key, slot);   // syncs: table zeroed too

  const float pax = ls::pixel_x(t.tx, col, sxs);
  const size_t plane = (size_t)C * H * W * D;
#pragma unroll 1
  for (int i = 0; i < ls::PPT; ++i) {
    const int row = threadIdx.x / ls::TILE_W + 2 * i;
    const int y = t.ty * ls::TILE_H + row;
    const int yd = min(y + 1, H - 1);
    const float pay = ls::pixel_y(t.ty, row, sys);
    const size_t pix = ((size_t)t.c * H + y) * W + x;
    const size_t pn[2] = {((size_t)t.c * H + y) * W + xr,
                          ((size_t)t.c * H + yd) * W + x};
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int dir = 0; dir < 2; ++dir) {
      const int s = slot[2 * i + dir];
      const float d_ex = dir == 0 ? sxs : 0.0f;
      const float d_ey = dir == 0 ? 0.0f : sys;
      bool found = false, take[3] = {false, false, false};
      ls::EdgeGeo geo[3];
      float tt = 0.0f;
      if (s >= 0) {
        const float* f = rb + (size_t)s * 32;
        const float fld[9] = {f[9], f[10], f[11], f[12], f[13], f[14],
                              f[23], f[24], f[25]};
        tt = ls::aa_pair_t(fld, pax, pay, d_ex, d_ey, oth[2 * i + dir],
                           found, take, geo);
      }
      const bool lo = found && tt < 0.5f;
      const bool hi = found && tt >= 0.5f;
      const float wa = lo ? 0.5f - tt : 0.0f;
      const float wb = hi ? tt - 0.5f : 0.0f;
      float dt = 0.0f;
      for (int cc = 0; cc < D; ++cc) {
        const float c0 = color[pix * D + cc];
        const float diff = color[pn[dir] * D + cc] - c0;
        const float d0 = dout[pix * D + cc];
        const float dn = dout[pn[dir] * D + cc];
        acc[cc] = acc[cc] - wa * d0 + wb * dn;
        dcol[(1 + dir) * plane + pix * D + cc] = wa * d0 - wb * dn;
        dt = dt - diff * (lo ? d0 : (hi ? dn : 0.0f));
      }
      if (!found) continue;
      const float pbx = pax + d_ex;
      const float pby = pay + d_ey;
      float ds[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const ls::EdgeGeo& g = geo[e];
        const float dtm = take[e] ? dt : 0.0f;
        const float inv_d2 = 1.0f / (g.den * g.den);
        const float dea = sane(dtm * (-g.eb) * inv_d2);
        const float deb = sane(dtm * g.ea * inv_d2);
        const int j0 = e, j1 = (e + 1) % 3;
        ds[2 * j0] = ds[2 * j0] + (dea * (g.by - pay) + deb * (g.by - pby));
        ds[2 * j0 + 1] =
            ds[2 * j0 + 1] + (dea * (pax - g.bx) + deb * (pbx - g.bx));
        ds[2 * j1] = ds[2 * j1] + (dea * (pay - g.ay) + deb * (pby - g.ay));
        ds[2 * j1 + 1] =
            ds[2 * j1 + 1] + (dea * (g.ax - pax) + deb * (g.ax - pbx));
      }
      if (use_smem) {
#pragma unroll
        for (int q = 0; q < 6; ++q) atomicAdd(&tab[s * 6 + q], ds[q]);
      } else {
#pragma unroll
        for (int q = 0; q < 6; ++q) atomicAdd(&ob[(size_t)s * 8 + q], ds[q]);
      }
    }
    for (int cc = 0; cc < D; ++cc) dcol[pix * D + cc] = acc[cc];
  }
  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < cap * 6; i += blockDim.x) {
      const int s = i / 6;
      ob[(size_t)s * 8 + (i - s * 6)] = tab[i];
    }
  }
}

}  // namespace

extern "C" int ls_aa_bwd(const float* rec, const int* counts, const float* fid,
                         const float* z, const float* color, const float* dout,
                         float* dcol, float* dslot, int C, int TY, int TX,
                         int cap, int H, int W, int D, float sxs, float sys,
                         void* stream) {
  if (D > 4) return (int)cudaErrorInvalidValue;
  const int blocks = C * TY * TX;
  const size_t table = (size_t)cap * 6 * sizeof(float);
  const int use_smem = table <= (size_t)ls::SMEM_TABLE_MAX;
  const size_t smem = use_smem ? table : 0;
  if (smem + CH * sizeof(float) > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        aa_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0)
    aa_bwd_kernel<<<blocks, ls::THREADS, smem, (cudaStream_t)stream>>>(
        rec, counts, fid, z, color, dout, dcol, dslot, C, TY, TX, cap, H, W,
        D, sxs, sys, use_smem);
  return (int)cudaGetLastError();
}
