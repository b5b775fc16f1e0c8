// raster_fwd: z-buffered rasterization + perspective-correct interpolation.
//
// Replaces: largesteps_tpu/render/pallas_core.py, raster_fwd_pallas /
// _fwd_kernel (the TPU kernel gathers the winner's record with a one-hot
// bf16 matmul; here each pixel reads it directly).
//
// Bound on the H100: bytes.  The function must write eight output planes
// and read the z-loop fields of every live slot; its float ops (~22 per
// z-test of a slot at a pixel of its bbox) are small beside that.  What
// costs a kernel more is z-testing slots at pixels they cannot cover: the
// record has no x-range, and a tile's bin holds some 400 slots of
// triangles a few pixels wide.
//
// Design: one block of 256 threads per (camera, tile, strip of 8 rows), 832
// blocks at the main path.  The block culls its tile's bin 256 slots at a
// time, one a thread, with coalesced 16-byte reads of record columns 0-15:
// a slot stays if its 1 px expanded y-range meets the strip and no edge
// function rules the strip out at its corners (rf_misses, with a margin
// that covers the per-pixel rounding).  The survivors go, in ascending slot
// order (warp ballots and a prefix over the warps), to a shared list whose
// z-loop fields are staged struct-of-arrays.  Each warp owns 16 columns by 8
// rows, culls 32 list entries at once against its own columns with a
// ballot, and z-tests only those left, four pixels a lane: the edge tests
// first, the depth only where a lane of the warp is covered.  Each pixel
// keeps the (depth, face id)-lexicographic minimum, the lowest slot on a
// tie (the list's order), then reads the winner's record once to
// interpolate.  Under row shards the planes hold TY tile rows of the image
// from its tile row R0: pixel centres and the records' rows are the
// image's, the stores the planes' own (pallas_core.py:_fwd_kernel, row0).
#include "common.cuh"

namespace {

struct Shared {
  float f[ls::RF_FIELDS][ls::RF_CHUNK];   // columns 0-11, 14 of the list
  int slot[ls::RF_CHUNK];
  int warp_n[ls::RF_THREADS / 32];        // survivors of each warp's slots
};

__global__ void __launch_bounds__(ls::RF_THREADS)
raster_fwd_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
                  float* __restrict__ out, int C, int TY, int TX, int cap,
                  int H, int W, int R0, float sxs, float sys) {
  __shared__ Shared sh;
  const ls::StripBlock b = ls::strip_block(TY, TX);
  const int n = min(counts[b.tile], cap);
  const float* rb = rec + (size_t)b.tile * cap * 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = b.strip * ls::STRIP_H;                  // in the tile
  const int col = warp * ls::RF_BAND + lane % ls::RF_BAND;
  const int rows = row0 + ls::RF_ROWS * (lane / ls::RF_BAND);

  // the strip's and the warp's corner pixel centres, and the strip's rows
  const float sx0 = ls::pixel_x(b.tx, 0, sxs);
  const float sx1 = ls::pixel_x(b.tx, ls::TILE_W - 1, sxs);
  const float wx0 = ls::pixel_x(b.tx, warp * ls::RF_BAND, sxs);
  const float wx1 = ls::pixel_x(b.tx, warp * ls::RF_BAND + ls::RF_BAND - 1,
                                sxs);
  // pixel centres and record rows are the image's: tile row b.ty + R0
  const int gty = b.ty + R0;
  const float sy0 = ls::pixel_y(gty, row0, sys);
  const float sy1 = ls::pixel_y(gty, row0 + ls::STRIP_H - 1, sys);
  const float row_lo = (float)(gty * ls::TILE_H + row0);
  const float row_hi = row_lo + (float)(ls::STRIP_H - 1);

  const float px = ls::pixel_x(b.tx, col, sxs);
  float py[ls::RF_ROWS], bd[ls::RF_ROWS], bf[ls::RF_ROWS];
  int bs[ls::RF_ROWS];
#pragma unroll
  for (int k = 0; k < ls::RF_ROWS; ++k) {
    py[k] = ls::pixel_y(gty, rows + k, sys);
    bd[k] = ls::BIG;
    bf[k] = ls::BIG;
    bs[k] = -1;
  }

  for (int base = 0; base < n; base += ls::RF_CHUNK) {
    // cull: one slot a thread
    const int j = base + threadIdx.x;
    bool keep = false;
    float4 a0, a1, a2, a3;
    if (j < n) {
      const float* r = rb + (size_t)j * 32;
      a3 = ls::ld4(r + 12);                 // ymin ymax fid -
      a0 = ls::ld4(r);
      a1 = ls::ld4(r + 4);
      a2 = ls::ld4(r + 8);
      const float e[9] = {a0.x, a0.y, a0.z, a0.w, a1.x,
                          a1.y, a1.z, a1.w, a2.x};
      keep = !(a3.y < row_lo || a3.x > row_hi) &&
             !ls::rf_misses(e, sx0, sx1, sy0, sy1);
    }
    const unsigned vote = __ballot_sync(ls::FULL, keep);
    __syncthreads();                      // the last chunk's list is read
    if (lane == 0) sh.warp_n[warp] = __popc(vote);
    __syncthreads();
    int pos = __popc(vote & ((1u << lane) - 1u)), m = 0;
#pragma unroll
    for (int w = 0; w < ls::RF_THREADS / 32; ++w) {
      const int c = sh.warp_n[w];
      pos += w < warp ? c : 0;
      m += c;
    }
    if (keep) {
      const float v[ls::RF_FIELDS] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z,
                                      a1.w, a2.x, a2.y, a2.z, a2.w, a3.z};
#pragma unroll
      for (int k = 0; k < ls::RF_FIELDS; ++k) sh.f[k][pos] = v[k];
      sh.slot[pos] = j;
    }
    __syncthreads();

    // z-loop: each warp culls 32 entries against its columns, then z-tests
    // the entries left, in list order
    for (int e0 = 0; e0 < m; e0 += 32) {
      const int i = e0 + lane;
      bool hit = false;
      if (i < m) {
        float r[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) r[k] = sh.f[k][i];
        hit = !ls::rf_misses(r, wx0, wx1, sy0, sy1);
      }
      for (unsigned hits = __ballot_sync(ls::FULL, hit); hits;
           hits &= hits - 1u) {
        const int e = e0 + __ffs(hits) - 1;
        float r[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) r[k] = sh.f[k][e];
        bool cov[ls::RF_ROWS], any = false;
#pragma unroll
        for (int k = 0; k < ls::RF_ROWS; ++k) {
          const float x = px, y = py[k];
          const float q0 = r[0] * x + r[1] * y + r[2];
          const float q1 = r[3] * x + r[4] * y + r[5];
          const float s = r[6] * x + r[7] * y + r[8];
          const float q2 = s - q0 - q1;
          cov[k] = q0 >= 0.0f && q1 >= 0.0f && q2 >= 0.0f && s > 0.0f;
          any = any || cov[k];
        }
        if (!__any_sync(ls::FULL, any)) continue;
        const float d0 = sh.f[9][e], d1 = sh.f[10][e], d2 = sh.f[11][e];
        const float fid = sh.f[12][e];
        const int slot = sh.slot[e];
#pragma unroll
        for (int k = 0; k < ls::RF_ROWS; ++k) {
          const float d = d0 * px + d1 * py[k] + d2;
          if (cov[k] && d < ls::BIG &&
              (d < bd[k] || (d == bd[k] && fid < bf[k]))) {
            bd[k] = d;
            bf[k] = fid;
            bs[k] = slot;
          }
        }
      }
    }
  }

  const size_t plane = (size_t)C * H * W;
#pragma unroll
  for (int k = 0; k < ls::RF_ROWS; ++k) {
    const int y = b.ty * ls::TILE_H + rows + k;
    const int x = b.tx * ls::TILE_W + col;
    float* o = out + ((size_t)b.c * H + y) * W + x;
    float u = 0.0f, v = 0.0f, z = 0.0f, fid = 0.0f;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    if (bs[k] >= 0) {
      const float* f = rb + (size_t)bs[k] * 32;
      const float4 f0 = ls::ld4(f), f1 = ls::ld4(f + 4), f2 = ls::ld4(f + 8);
      const float4 f4 = ls::ld4(f + 16), f5 = ls::ld4(f + 20);
      const float X = px, Y = py[k];
      const float q0 = f0.x * X + f0.y * Y + f0.z;
      const float q1 = f0.w * X + f1.x * Y + f1.y;
      const float s = f1.z * X + f1.w * Y + f2.x;
      const float inv_s = 1.0f / (s == 0.0f ? 1.0f : s);
      u = q0 * inv_s;
      v = q1 * inv_s;
      z = bd[k];
      fid = bf[k];
      c0 = u * f4.x + v * f4.y + f4.z;
      c1 = u * f4.w + v * f5.x + f5.y;
      c2 = u * f5.z + v * f5.w + f[24];
    }
    o[0] = u;
    o[plane] = v;
    o[2 * plane] = z;
    o[3 * plane] = fid;
    o[4 * plane] = (float)bs[k];
    o[5 * plane] = c0;
    o[6 * plane] = c1;
    o[7 * plane] = c2;
  }
}

}  // namespace

// The planes hold TY tile rows (H = 32 TY pixel rows) of an image whose
// pixel pitch is (sxs, sys), from its tile row R0 (0 without row shards).
extern "C" int ls_raster_fwd(const float* rec, const int* counts, float* out,
                             int C, int TY, int TX, int cap, int H, int W,
                             int R0, float sxs, float sys, void* stream) {
  const int blocks = C * TY * TX * ls::STRIPS;
  if (blocks > 0)
    raster_fwd_kernel<<<blocks, ls::RF_THREADS, 0, (cudaStream_t)stream>>>(
        rec, counts, out, C, TY, TX, cap, H, W, R0, sxs, sys);
  return (int)cudaGetLastError();
}
