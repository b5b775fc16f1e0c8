// raster_bwd: the backward of raster_fwd, summed per (camera, tile, slot).
//
// Replaces: largesteps_tpu/render/pallas_core.py, raster_bwd_pallas /
// _bwd_kernel (the TPU kernel gathers owner records and reduces per slot
// with one-hot bf16 matmuls; here each pixel reads its owner's record and
// the sums are added per slot).
//
// Bound on the H100: bytes.  Each covered pixel does ~90 float ops for its
// 18 gradient fields, against reads of the slot plane, five cotangent
// values and the owner record, and the (cap, 32) output table.  What costs
// a kernel more is the adding: a float atomicAdd to shared memory is a
// compare-and-swap loop on this card (ATOMS.CAST.SPIN), and neighbouring
// pixels mostly share their owner, so one add a pixel and field contends.
//
// Design: one block of 1,024 threads per (camera, tile), a warp a row, one
// pixel a lane in each of four steps, so that every lane reads its own
// owner's record at once.  A segmented shuffle scan sums each run of
// neighbouring lanes that name one slot, and the run's first lane adds the
// 18 sums: one add a run and field, not one a pixel.  The adds go to a
// (cap, 18) table in shared memory (55 KB at cap 768), which the block then
// writes out as whole 32-column rows, zeros in columns 18-31 and in the
// rows no pixel names.  Past RB_TABLE_MAX the adds go straight to the
// output with global atomics (native adds in L2); only this block adds to
// its tile's rows, so it zeroes them itself first, behind a fence and a
// barrier.  Either way the output needs no memset.
#include "common.cuh"

namespace {

using Sums = float[ls::RB_SUMS];

// The 18 gradient fields of one pixel (render/kernels.py:_raster_bwd_fields)
// from its owner's record columns 0-21 (f0-f5, 4 each).
__device__ __forceinline__ void pixel_fields(const float4 (&f)[6], float px,
                                             float py, float dc0, float dc1,
                                             float dc2, float du_in,
                                             float dv_in, Sums& G) {
  const float b0 = f[0].x * px + f[0].y * py + f[0].z;
  const float b1 = f[0].w * px + f[1].x * py + f[1].y;
  const float iw0 = f[1].z, iw1 = f[1].w, iw2 = f[2].x;
  const float du = dc0 * f[4].x + dc1 * f[4].z + dc2 * f[5].x + du_in;
  const float dv = dc0 * f[4].y + dc1 * f[4].w + dc2 * f[5].y + dv_in;
  const float b2 = 1.0f - b0 - b1;
  const float s = b0 * iw0 + b1 * iw1 + b2 * iw2;
  const float inv_s = 1.0f / (s == 0.0f ? 1.0f : s);
  const float u = b0 * iw0 * inv_s;
  const float v = b1 * iw1 * inv_s;
  const float w2 = s == 0.0f ? 0.0f : 1.0f - u - v;
  const float h = du * u + dv * v;
  const float db0 = (du * iw0 - h * (iw0 - iw2)) * inv_s;
  const float db1 = (dv * iw1 - h * (iw1 - iw2)) * inv_s;
  const float inva = f[3].w;
  const float g0 = db0 * inva;
  const float g1 = db1 * inva;
  const float garea = -(b0 * db0 + b1 * db1) * inva;
  const float sx0 = f[2].y, sy0 = f[2].z, sx1 = f[2].w, sy1 = f[3].x,
              sx2 = f[3].y, sy2 = f[3].z;
  G[0] = g1 * (py - sy2) + garea * (sy1 - sy2);
  G[1] = g1 * (sx2 - px) + garea * (sx2 - sx1);
  G[2] = g0 * (sy2 - py) + garea * (sy2 - sy0);
  G[3] = g0 * (px - sx2) + garea * (sx0 - sx2);
  G[4] = g0 * (py - sy1) + g1 * (sy0 - py) + garea * (sy0 - sy1);
  G[5] = g0 * (sx1 - px) + g1 * (px - sx0) + garea * (sx1 - sx0);
  G[6] = b0 * (du - h) * inv_s;
  G[7] = b1 * (dv - h) * inv_s;
  G[8] = -h * b2 * inv_s;
  G[9] = dc0 * u;
  G[10] = dc1 * u;
  G[11] = dc2 * u;
  G[12] = dc0 * v;
  G[13] = dc1 * v;
  G[14] = dc2 * v;
  G[15] = dc0 * w2;
  G[16] = dc1 * w2;
  G[17] = dc2 * w2;
}

template <bool SMEM>
__global__ void __launch_bounds__(ls::RB_THREADS, 1)
raster_bwd_kernel(const float* __restrict__ rec,
                  const float* __restrict__ slot_plane,
                  const float* __restrict__ dcol, const float* __restrict__ du_p,
                  const float* __restrict__ dv_p, float* __restrict__ out,
                  int TY, int TX, int cap, int H, int W, float sxs, float sys) {
  extern __shared__ float4 tab4[];     // (cap, 18) floats when SMEM
  const ls::Tile t = ls::tile_of_block(TY, TX);
  const float* rb = rec + (size_t)t.b * cap * 32;
  float* ob = out + (size_t)t.b * cap * 32;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (SMEM) {
    for (int i = threadIdx.x; i < (cap * ls::RB_SUMS + 3) / 4; i += blockDim.x)
      tab4[i] = zero;
  } else {
    for (int i = threadIdx.x; i < cap * 8; i += blockDim.x)
      reinterpret_cast<float4*>(ob)[i] = zero;
  }
  float* sums = SMEM ? reinterpret_cast<float*>(tab4) : ob;
  const int stride = SMEM ? ls::RB_SUMS : 32;

  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t pix0 = ((size_t)t.c * H + t.ty * ls::TILE_H + row) * W +
                      t.tx * ls::TILE_W + lane;
  const float py = ls::pixel_y(t.ty, row, sys);
  int slots[ls::RB_STEPS];
#pragma unroll
  for (int k = 0; k < ls::RB_STEPS; ++k) {
    const int s = (int)slot_plane[pix0 + 32 * k];
    slots[k] = s < 0 || s >= cap ? -1 : s;
  }
  if (!SMEM) __threadfence();          // the zeros reach L2 before any add
  __syncthreads();

#pragma unroll
  for (int k = 0; k < ls::RB_STEPS; ++k) {
    const int s = slots[k];
    if (!__ballot_sync(ls::FULL, s >= 0)) continue;    // a background step
    const size_t p = pix0 + 32 * k;
    Sums G;
    if (s >= 0) {
      const float* r = rb + (size_t)s * 32;
      float4 f[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) f[j] = ls::ld4(r + 4 * j);
      pixel_fields(f, ls::pixel_x(t.tx, lane + 32 * k, sxs), py,
                   dcol[p * 3], dcol[p * 3 + 1], dcol[p * 3 + 2], du_p[p],
                   dv_p[p], G);
    } else {
#pragma unroll
      for (int q = 0; q < ls::RB_SUMS; ++q) G[q] = 0.0f;
    }
    // runs of lanes that name one slot: each lane sums to its run's end
    const int prev = __shfl_up_sync(ls::FULL, s, 1);
    const int next = __shfl_down_sync(ls::FULL, s, 1);
    const unsigned ends = __ballot_sync(ls::FULL, lane == 31 || next != s);
    const int end = lane + __ffs(ends >> lane) - 1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int q = 0; q < ls::RB_SUMS; ++q) {
        const float o = __shfl_down_sync(ls::FULL, G[q], d);
        if (lane + d <= end) G[q] += o;
      }
    }
    if (s >= 0 && (lane == 0 || prev != s)) {
      float* o = sums + (size_t)s * stride;
#pragma unroll
      for (int q = 0; q < ls::RB_SUMS; ++q) atomicAdd(o + q, G[q]);
    }
  }

  if (SMEM) {
    // whole rows, 16 bytes a thread: sums in columns 0-17, zeros after
    __syncthreads();
    for (int i = threadIdx.x; i < cap * 8; i += blockDim.x) {
      const int r = i >> 3, c = 4 * (i & 7);
      const float* q = sums + r * ls::RB_SUMS + c;
      float4 v = zero;
      if (c < 16) v = make_float4(q[0], q[1], q[2], q[3]);
      if (c == 16) v = make_float4(q[0], q[1], 0.0f, 0.0f);
      reinterpret_cast<float4*>(ob)[i] = v;
    }
  }
}

}  // namespace

extern "C" int ls_raster_bwd(const float* rec, const float* slot,
                             const float* dcol, const float* du,
                             const float* dv, float* out, int C, int TY,
                             int TX, int cap, int H, int W, float sxs,
                             float sys, void* stream) {
  const int blocks = C * TY * TX;
  const size_t table = ((size_t)cap * ls::RB_SUMS + 3) / 4 * 16;
  const cudaStream_t st = (cudaStream_t)stream;
  if (blocks == 0) return (int)cudaGetLastError();
  if (table <= (size_t)ls::RB_TABLE_MAX) {
    const cudaError_t e = ls::smem_opt_in<raster_bwd_kernel<true>>(table, 0);
    if (e != cudaSuccess) return (int)e;
    raster_bwd_kernel<true><<<blocks, ls::RB_THREADS, table, st>>>(
        rec, slot, dcol, du, dv, out, TY, TX, cap, H, W, sxs, sys);
  } else {
    raster_bwd_kernel<false><<<blocks, ls::RB_THREADS, 0, st>>>(
        rec, slot, dcol, du, dv, out, TY, TX, cap, H, W, sxs, sys);
  }
  return (int)cudaGetLastError();
}
