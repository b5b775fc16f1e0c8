// raster_bwd: the backward of raster_fwd, summed per (camera, tile, slot).
//
// Replaces: largesteps_tpu/render/pallas_core.py, raster_bwd_pallas /
// _bwd_kernel (the TPU kernel gathers owner records and reduces per slot
// with one-hot bf16 matmuls; here each pixel reads its owner's record and
// adds into a per-slot table with atomics).
//
// Bound on the H100: bytes.  Each covered pixel does ~90 float ops for its
// 18 gradient fields, against reads of the slot plane, five cotangent
// values and the owner record, and the (cap, 32) output table.  The
// contention of atomics on the slots of large triangles is the risk.
//
// Design: one block of 256 threads per (camera, tile), 16 pixels a thread.
// The 18 per-slot sums accumulate in a (cap, 18) shared-memory table
// (55 KB at cap 768, dynamic shared memory); the block then writes columns
// 0-17 of its (cap, 32) output rows.  Where the table does not fit, the same
// kernel adds straight into the zeroed output with global atomics.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(ls::THREADS)
raster_bwd_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
                  const float* __restrict__ slot_plane,
                  const float* __restrict__ dcol, const float* __restrict__ du_p,
                  const float* __restrict__ dv_p, float* __restrict__ out,
                  int TY, int TX, int cap, int H, int W, float sxs, float sys,
                  int use_smem) {
  extern __shared__ float tab[];          // (cap, 18) when use_smem
  const ls::Tile t = ls::tile_of_block(TY, TX);
  const float* rb = rec + (size_t)t.b * cap * 32;
  float* ob = out + (size_t)t.b * cap * 32;
  if (use_smem) {
    for (int i = threadIdx.x; i < cap * 18; i += blockDim.x) tab[i] = 0.0f;
    __syncthreads();
  }
  for (int it = 0; it < ls::PPT; ++it) {
    const int p = threadIdx.x + it * ls::THREADS;
    const int row = p / ls::TILE_W, col = p % ls::TILE_W;
    const size_t pix = ((size_t)t.c * H + t.ty * ls::TILE_H + row) * W +
                       t.tx * ls::TILE_W + col;
    const int s_ = (int)slot_plane[pix];
    if (s_ < 0 || s_ >= cap) continue;
    const float* f = rb + (size_t)s_ * 32;
    const float px = ls::pixel_x(t.tx, col, sxs);
    const float py = ls::pixel_y(t.ty, row, sys);
    const float dc0 = dcol[pix * 3], dc1 = dcol[pix * 3 + 1],
                dc2 = dcol[pix * 3 + 2];

    const float b0 = f[0] * px + f[1] * py + f[2];
    const float b1 = f[3] * px + f[4] * py + f[5];
    const float iw0 = f[6], iw1 = f[7], iw2 = f[8];
    const float du = dc0 * f[16] + dc1 * f[18] + dc2 * f[20] + du_p[pix];
    const float dv = dc0 * f[17] + dc1 * f[19] + dc2 * f[21] + dv_p[pix];
    const float b2 = 1.0f - b0 - b1;
    const float s = b0 * iw0 + b1 * iw1 + b2 * iw2;
    const float inv_s = 1.0f / (s == 0.0f ? 1.0f : s);
    const float u = b0 * iw0 * inv_s;
    const float v = b1 * iw1 * inv_s;
    const float w2 = s == 0.0f ? 0.0f : 1.0f - u - v;
    const float h = du * u + dv * v;
    const float db0 = (du * iw0 - h * (iw0 - iw2)) * inv_s;
    const float db1 = (dv * iw1 - h * (iw1 - iw2)) * inv_s;
    const float inva = f[15];
    const float g0 = db0 * inva;
    const float g1 = db1 * inva;
    const float garea = -(b0 * db0 + b1 * db1) * inva;
    const float sx0 = f[9], sy0 = f[10], sx1 = f[11], sy1 = f[12],
                sx2 = f[13], sy2 = f[14];
    const float G[18] = {
        g1 * (py - sy2) + garea * (sy1 - sy2),
        g1 * (sx2 - px) + garea * (sx2 - sx1),
        g0 * (sy2 - py) + garea * (sy2 - sy0),
        g0 * (px - sx2) + garea * (sx0 - sx2),
        g0 * (py - sy1) + g1 * (sy0 - py) + garea * (sy0 - sy1),
        g0 * (sx1 - px) + g1 * (px - sx0) + garea * (sx1 - sx0),
        b0 * (du - h) * inv_s,
        b1 * (dv - h) * inv_s,
        -h * b2 * inv_s,
        dc0 * u, dc1 * u, dc2 * u,
        dc0 * v, dc1 * v, dc2 * v,
        dc0 * w2, dc1 * w2, dc2 * w2,
    };
    if (use_smem) {
#pragma unroll
      for (int q = 0; q < 18; ++q) atomicAdd(&tab[s_ * 18 + q], G[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 18; ++q) atomicAdd(&ob[(size_t)s_ * 32 + q], G[q]);
    }
  }
  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < cap * 18; i += blockDim.x) {
      const int s_ = i / 18;
      ob[(size_t)s_ * 32 + (i - s_ * 18)] = tab[i];
    }
  }
}

}  // namespace

extern "C" int ls_raster_bwd(const float* rec, const int* counts,
                             const float* slot, const float* dcol,
                             const float* du, const float* dv, float* out,
                             int C, int TY, int TX, int cap, int H, int W,
                             float sxs, float sys, void* stream) {
  const int blocks = C * TY * TX;
  const size_t table = (size_t)cap * 18 * sizeof(float);
  const int use_smem = table <= (size_t)ls::SMEM_TABLE_MAX;
  const size_t smem = use_smem ? table : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0)
    raster_bwd_kernel<<<blocks, ls::THREADS, smem, (cudaStream_t)stream>>>(
        rec, counts, slot, dcol, du, dv, out, TY, TX, cap, H, W, sxs, sys,
        use_smem);
  return (int)cudaGetLastError();
}
