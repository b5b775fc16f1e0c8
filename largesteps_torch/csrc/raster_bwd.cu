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
// a kernel more is the adding, and it must add in a fixed order: float
// atomics (into a shared table, or global ones past its size) add in the
// order the warps arrive, so two launches on the same inputs would differ
// in their last bits, and the optimizer's steps on the card would not
// repeat.
//
// Design: one block of 1,024 threads per (camera, tile), sums in a fixed
// order (common.cuh, "Fixed-order sums"), no float atomics.
// 1. The block zeroes its tile's (cap, 32) output rows, and keys each of
//    its 4,096 pixels by slot << 12 | pixel (row * 128 + column; no slot
//    keys as slot cap), and sorts the keys (ls::block_sort over the slot
//    bits): each slot's pixels in a row, in pixel order.  A tile with no
//    covered pixel stops after the zeros.
// 2. In four steps of 1,024 sorted terms, a lane a term, each warp takes a
//    chunk of 32 consecutive terms, computes each term's 18 fields from its
//    owner's record (neighbouring lanes mostly read one record), and sums
//    each run of lanes on one slot with a segmented shuffle scan into the
//    run's first lane.  A run that starts and ends in its chunk is a whole
//    slot: that lane writes the slot's row.  A run cut by a chunk border
//    leaves its part in the chunk's head (the run that came in) or tail
//    (the run that goes on) in shared memory.
// 3. Each field of a slot whose terms span chunks is added by one thread:
//    the tail of the chunk it starts in, then the heads after, in order.
// Under row shards the pixel centres are those of the image's tile row
// t.ty + R0 (pallas_core.py:_bwd_kernel, row0); the planes are the shard's.
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

constexpr int PIX = ls::TILE_H * ls::TILE_W;          // pixels a tile
constexpr int PIX_BITS = 12;                            // a pixel's key bits
static_assert(PIX == 1 << PIX_BITS, "a pixel's place fits its key bits");
constexpr int CHUNKS = PIX / 32;                        // warp chunks
constexpr int HIST = ls::SORT_RADIX * ls::RB_STEPS * ls::RB_THREADS / 32;

// dynamic shared bytes: the keys twice, the sort's counts, each chunk's
// head and tail sums and whether it has a tail
constexpr size_t SMEM = (2 * PIX + HIST) * 4 +
                        2 * CHUNKS * ls::RB_SUMS * 4 + CHUNKS * 4;

__device__ __forceinline__ int slot_of(unsigned key) {
  return (int)(key >> PIX_BITS);
}

__device__ __forceinline__ void store_row(float* o, const Sums& G) {
  float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o4[i] = make_float4(G[4 * i], G[4 * i + 1], G[4 * i + 2], G[4 * i + 3]);
  reinterpret_cast<float2*>(o)[8] = make_float2(G[16], G[17]);
}

__global__ void __launch_bounds__(ls::RB_THREADS, 1)
raster_bwd_kernel(const float* __restrict__ rec,
                  const float* __restrict__ slot_plane,
                  const float* __restrict__ dcol, const float* __restrict__ du_p,
                  const float* __restrict__ dv_p, float* __restrict__ out,
                  int TY, int TX, int cap, int H, int W, int R0, float sxs,
                  float sys, int slot_bits) {
  extern __shared__ float4 smem4[];
  unsigned* keys = reinterpret_cast<unsigned*>(smem4);
  unsigned* tmp = keys + PIX;
  int* hist = reinterpret_cast<int*>(tmp + PIX);
  float* heads = reinterpret_cast<float*>(hist + HIST);   // (CHUNKS, 18)
  float* tails = heads + CHUNKS * ls::RB_SUMS;            // (CHUNKS, 18)
  int* has_tail = reinterpret_cast<int*>(tails + CHUNKS * ls::RB_SUMS);
  __shared__ int warp_tot[32];
  const ls::Tile t = ls::tile_of_block(TY, TX);
  const float* rb = rec + (size_t)t.b * cap * 32;
  float* ob = out + (size_t)t.b * cap * 32;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < cap * 8; i += blockDim.x)
    reinterpret_cast<float4*>(ob)[i] = zero;

  // 1. the keys, in pixel order, and their sort
  const size_t pix0 = ((size_t)t.c * H + t.ty * ls::TILE_H) * W +
                      t.tx * ls::TILE_W;
  bool any = false;
#pragma unroll
  for (int j = 0; j < ls::RB_STEPS; ++j) {
    const int q = j * ls::RB_THREADS + threadIdx.x;
    int s = (int)slot_plane[pix0 + (size_t)(q >> 7) * W + (q & 127)];
    s = s < 0 || s >= cap ? cap : s;
    any = any || s < cap;
    keys[q] = ((unsigned)s << PIX_BITS) | (unsigned)q;
  }
  if (threadIdx.x < CHUNKS) has_tail[threadIdx.x] = 0;
  if (!__syncthreads_or(any)) return;
  const unsigned* S = ls::block_sort<ls::RB_THREADS, ls::RB_STEPS>(
      keys, tmp, hist, warp_tot, PIX, PIX_BITS, PIX_BITS + slot_bits);

  // 2. the fields of each sorted term, summed by runs within a chunk
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int k = 0; k < ls::RB_STEPS; ++k) {
    const int pos = k * ls::RB_THREADS + threadIdx.x;
    const unsigned key = S[pos];
    const int s = slot_of(key);
    if (!__ballot_sync(ls::FULL, s < cap)) continue;     // background only
    Sums G;
    if (s < cap) {
      const int q = (int)(key & (PIX - 1));
      const int row = q >> 7, col = q & 127;
      const size_t p = pix0 + (size_t)row * W + col;
      const float* r = rb + (size_t)s * 32;
      float4 f[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) f[j] = ls::ld4(r + 4 * j);
      pixel_fields(f, ls::pixel_x(t.tx, col, sxs),
                   ls::pixel_y(t.ty + R0, row, sys), dcol[p * 3],
                   dcol[p * 3 + 1], dcol[p * 3 + 2], du_p[p], dv_p[p], G);
    } else {
#pragma unroll
      for (int q = 0; q < ls::RB_SUMS; ++q) G[q] = 0.0f;
    }
    // runs of lanes on one slot: each lane sums to its run's end
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
    if (s < cap && (lane == 0 || prev != s)) {
      const int last = pos - lane + end;              // the run's last term
      const bool starts = pos == 0 || slot_of(S[pos - 1]) != s;
      const bool stops = last == PIX - 1 || slot_of(S[last + 1]) != s;
      const int c = pos >> 5;
      if (starts && stops) {
        store_row(ob + (size_t)s * 32, G);
      } else {
        float* o = (starts ? tails : heads) + c * ls::RB_SUMS;
#pragma unroll
        for (int q = 0; q < ls::RB_SUMS; ++q) o[q] = G[q];
        if (starts) has_tail[c] = 1;
      }
    }
  }
  __syncthreads();

  // 3. slots whose terms span chunks, a field a thread: the tail of the
  // chunk the slot starts in, then the heads of the chunks after, in order
  for (int i = threadIdx.x; i < CHUNKS * ls::RB_SUMS; i += blockDim.x) {
    const int c = i / ls::RB_SUMS, q = i - c * ls::RB_SUMS;
    const int p0 = 32 * c;
    const int s = slot_of(S[p0]);
    if (s >= cap || p0 == 0 || slot_of(S[p0 - 1]) != s) continue;
    if (p0 + 32 < PIX && slot_of(S[p0 + 31]) == s &&
        slot_of(S[p0 + 32]) == s)
      continue;                                  // goes on past the chunk
    int c0 = c - 1;
    while (!has_tail[c0]) --c0;
    float v = tails[c0 * ls::RB_SUMS + q];
    for (int j = c0 + 1; j <= c; ++j) v += heads[j * ls::RB_SUMS + q];
    ob[(size_t)s * 32 + q] = v;
  }
}

}  // namespace

extern "C" int ls_raster_bwd(const float* rec, const float* slot,
                             const float* dcol, const float* du,
                             const float* dv, float* out, int C, int TY,
                             int TX, int cap, int H, int W, int R0,
                             float sxs, float sys, void* stream) {
  const int blocks = C * TY * TX;
  const int slot_bits = ls::bits_for(cap);
  if (PIX_BITS + slot_bits > 32) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  const cudaError_t e = ls::smem_opt_in<raster_bwd_kernel>(SMEM, 128);
  if (e != cudaSuccess) return (int)e;
  raster_bwd_kernel<<<blocks, ls::RB_THREADS, SMEM, (cudaStream_t)stream>>>(
      rec, slot, dcol, du, dv, out, TY, TX, cap, H, W, R0, sxs, sys,
      slot_bits);
  return (int)cudaGetLastError();
}
