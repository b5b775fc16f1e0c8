// aa_fwd: nvdiffrast antialias, forward.
//
// Replaces: largesteps_tpu/render/pallas_core.py, aa_fwd_pallas /
// _aa_fwd_kernel (the TPU kernel fetches the owner's record with a one-hot
// bf16 matmul keyed by face id; here a search of the tile's bin finds its
// slot and the pixel reads the record directly).
//
// Bound on the H100: bytes.  The work per pixel pair is a few dozen float
// ops on the three-edge crossing test, and only pairs whose face ids differ
// do it; the id, depth and colour planes dominate the traffic.
//
// Design: one block of 256 threads per (camera, tile), 16 pixels a thread.
// For each pixel and each pair direction (right and down neighbour, row 0 at
// the image bottom, the last row and column paired with themselves) the
// owner is the nearer face; its slot is found by a linear search over the
// tile's face ids, staged through shared memory in chunks of 1024 (the bins
// use a 1 px expanded bbox, so an owner across the tile border is in them).
// The kernel writes the JAX kernel's three planes: the anchor's blend and the
// right and down neighbours' shares, which the wrapper shifts back and adds.
#include "common.cuh"

namespace {

constexpr int CH = 1024;   // face ids per shared-memory chunk

__global__ void __launch_bounds__(ls::THREADS)
aa_fwd_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
              const float* __restrict__ fidp, const float* __restrict__ zp,
              const float* __restrict__ color, float* __restrict__ out,
              int C, int TY, int TX, int cap, int H, int W, int D, float sxs,
              float sys) {
  __shared__ float sfid[CH];
  const ls::Tile t = ls::tile_of_block(TY, TX);
  const int n = min(counts[t.b], cap);
  const float* rb = rec + (size_t)t.b * cap * 32;
  const int col = threadIdx.x % ls::TILE_W;
  const int x = t.tx * ls::TILE_W + col;
  const int xr = min(x + 1, W - 1);

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
  ls::find_slots(rb, n, sfid, CH, key, slot);

  const float pax = ls::pixel_x(t.tx, col, sxs);
#pragma unroll 1
  for (int i = 0; i < ls::PPT; ++i) {
    const int row = threadIdx.x / ls::TILE_W + 2 * i;
    const int y = t.ty * ls::TILE_H + row;
    const int yd = min(y + 1, H - 1);
    const float pay = ls::pixel_y(t.ty, row, sys);
    float wa[2] = {0.0f, 0.0f}, wb[2] = {0.0f, 0.0f};
#pragma unroll
    for (int dir = 0; dir < 2; ++dir) {
      const int s = slot[2 * i + dir];
      if (s < 0) continue;                 // no differing pair, or no owner
      const float* f = rb + (size_t)s * 32;
      const float fld[9] = {f[9], f[10], f[11], f[12], f[13], f[14],
                            f[23], f[24], f[25]};
      bool found, take[3];
      ls::EdgeGeo geo[3];
      const float tt = ls::aa_pair_t(fld, pax, pay, dir == 0 ? sxs : 0.0f,
                                     dir == 0 ? 0.0f : sys, oth[2 * i + dir],
                                     found, take, geo);
      if (!found) continue;
      wa[dir] = tt < 0.5f ? 0.5f - tt : 0.0f;
      wb[dir] = tt >= 0.5f ? tt - 0.5f : 0.0f;
    }
    const size_t pix = ((size_t)t.c * H + y) * W + x;
    const size_t pr = ((size_t)t.c * H + y) * W + xr;
    const size_t pd = ((size_t)t.c * H + yd) * W + x;
    const size_t plane = (size_t)C * H * W * D;
    for (int cc = 0; cc < D; ++cc) {
      const float c0 = color[pix * D + cc];
      const float dh = color[pr * D + cc] - c0;
      const float dv = color[pd * D + cc] - c0;
      out[pix * D + cc] = c0 + wa[0] * dh + wa[1] * dv;
      out[plane + pix * D + cc] = -wb[0] * dh;
      out[2 * plane + pix * D + cc] = -wb[1] * dv;
    }
  }
}

}  // namespace

extern "C" int ls_aa_fwd(const float* rec, const int* counts,
                         const float* fid, const float* z, const float* color,
                         float* out, int C, int TY, int TX, int cap, int H,
                         int W, int D, float sxs, float sys, void* stream) {
  const int blocks = C * TY * TX;
  if (blocks > 0)
    aa_fwd_kernel<<<blocks, ls::THREADS, 0, (cudaStream_t)stream>>>(
        rec, counts, fid, z, color, out, C, TY, TX, cap, H, W, D, sxs, sys);
  return (int)cudaGetLastError();
}
