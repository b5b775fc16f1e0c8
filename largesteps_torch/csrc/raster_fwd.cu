// raster_fwd: z-buffered rasterization + perspective-correct interpolation.
//
// Replaces: largesteps_tpu/render/pallas_core.py, raster_fwd_pallas /
// _fwd_kernel (the TPU kernel gathers the winner's record with a one-hot
// bf16 matmul; here each pixel reads it directly).
//
// Bound on the H100: bytes.  The function must write eight output planes
// and read the z-loop fields of every live slot; its float ops (~22 per
// z-test of a slot at a pixel of its bbox) are small beside that.  This
// kernel tests each slot at every pixel of the warp rows its bbox reaches,
// which costs it more operations than the function needs.
//
// Design: one block of 256 threads per (camera, tile).  Warp w owns tile
// rows 4w..4w+3 and lane l the columns l, l+32, l+64, l+96, so a slot whose
// 1 px expanded y-range misses a warp's four rows is skipped by the whole
// warp without divergence.  The z-loop fields (record columns 0-14) are
// staged through shared memory in chunks of 256 slots, so any cap works.
// Each pixel keeps the (depth, face id)-lexicographic minimum and its slot in
// registers, then reads the winner's full record once to interpolate.
#include "common.cuh"

namespace {

constexpr int CH = 256;   // slots per shared-memory chunk
constexpr int NF = 15;    // record columns the z-loop reads

__global__ void __launch_bounds__(ls::THREADS)
raster_fwd_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
                  float* __restrict__ out, int C, int TY, int TX, int cap,
                  int H, int W, float sxs, float sys) {
  __shared__ float sf[CH * NF];
  const ls::Tile t = ls::tile_of_block(TY, TX);
  const int n = min(counts[t.b], cap);
  const float* rb = rec + (size_t)t.b * cap * 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_in = warp * 4;                       // first tile row
  const float row_lo = (float)(t.ty * ls::TILE_H + row_in);
  const float row_hi = row_lo + 3.0f;

  float px[4], py[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) px[k] = ls::pixel_x(t.tx, lane + 32 * k, sxs);
#pragma unroll
  for (int r = 0; r < 4; ++r) py[r] = ls::pixel_y(t.ty, row_in + r, sys);

  float bd[16], bf[16];
  int bs[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    bd[i] = ls::BIG;
    bf[i] = ls::BIG;
    bs[i] = -1;
  }

  for (int base = 0; base < n; base += CH) {
    const int m = min(CH, n - base);
    __syncthreads();
    for (int i = threadIdx.x; i < m * NF; i += blockDim.x) {
      const int j = i / NF;
      sf[i] = rb[(size_t)(base + j) * 32 + (i - j * NF)];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float* r = sf + j * NF;
      if (r[13] < row_lo || r[12] > row_hi) continue;   // warp-uniform
      const float fid = r[14];
      const int slot = base + j;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float x = px[k], y = py[rr];
          const float q0 = r[0] * x + r[1] * y + r[2];
          const float q1 = r[3] * x + r[4] * y + r[5];
          const float s = r[6] * x + r[7] * y + r[8];
          const float d = r[9] * x + r[10] * y + r[11];
          const float q2 = s - q0 - q1;
          const int i = rr * 4 + k;
          if (q0 >= 0.0f && q1 >= 0.0f && q2 >= 0.0f && s > 0.0f &&
              d < ls::BIG && (d < bd[i] || (d == bd[i] && fid < bf[i]))) {
            bd[i] = d;
            bf[i] = fid;
            bs[i] = slot;
          }
        }
      }
    }
  }

  const size_t plane = (size_t)C * H * W;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = rr * 4 + k;
      const int y = t.ty * ls::TILE_H + row_in + rr;
      const int x = t.tx * ls::TILE_W + lane + 32 * k;
      float* o = out + ((size_t)t.c * H + y) * W + x;
      float u = 0.0f, v = 0.0f, z = 0.0f, fid = 0.0f;
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
      if (bs[i] >= 0) {
        const float* f = rb + (size_t)bs[i] * 32;
        const float X = px[k], Y = py[rr];
        const float q0 = f[0] * X + f[1] * Y + f[2];
        const float q1 = f[3] * X + f[4] * Y + f[5];
        const float s = f[6] * X + f[7] * Y + f[8];
        const float inv_s = 1.0f / (s == 0.0f ? 1.0f : s);
        u = q0 * inv_s;
        v = q1 * inv_s;
        z = bd[i];
        fid = f[14];
        c0 = u * f[16] + v * f[17] + f[18];
        c1 = u * f[19] + v * f[20] + f[21];
        c2 = u * f[22] + v * f[23] + f[24];
      }
      o[0] = u;
      o[plane] = v;
      o[2 * plane] = z;
      o[3 * plane] = fid;
      o[4 * plane] = (float)bs[i];
      o[5 * plane] = c0;
      o[6 * plane] = c1;
      o[7 * plane] = c2;
    }
  }
}

}  // namespace

extern "C" int ls_raster_fwd(const float* rec, const int* counts, float* out,
                             int C, int TY, int TX, int cap, int H, int W,
                             float sxs, float sys, void* stream) {
  const int blocks = C * TY * TX;
  if (blocks > 0)
    raster_fwd_kernel<<<blocks, ls::THREADS, 0, (cudaStream_t)stream>>>(
        rec, counts, out, C, TY, TX, cap, H, W, sxs, sys);
  return (int)cudaGetLastError();
}
