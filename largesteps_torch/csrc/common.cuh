// Shared definitions of the four render kernels (see each .cu file's note).
//
// Layouts are the JAX package's: records (C, TY, TX, cap, 32) float32,
// counts (C, TY, TX) int32, planes (C, H, W) float32 with row 0 at the image
// bottom, colours (C, H, W, D), 32x128 pixel tiles.  One block works on one
// (camera, tile); blockIdx.x = (c * TY + ty) * TX + tx.
//
// Every expression is written in the operation order of the plain PyTorch
// version in render/kernels.py, and the library is built with -fmad=false,
// so a kernel rounds exactly as its plain version does.
#pragma once

#include <cuda_runtime.h>

namespace ls {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int TILE_P = TILE_H * TILE_W;
constexpr int THREADS = 256;
constexpr int PPT = TILE_P / THREADS;        // pixels per thread
constexpr float BIG = 3.4e38f;
// dynamic shared memory a per-slot table may take before a kernel falls
// back to accumulating straight into global memory
constexpr int SMEM_TABLE_MAX = 200 * 1024;

struct Tile {
  int b, c, ty, tx;
};

__device__ __forceinline__ Tile tile_of_block(int TY, int TX) {
  Tile t;
  t.b = blockIdx.x;
  t.tx = t.b % TX;
  t.ty = (t.b / TX) % TY;
  t.c = t.b / (TX * TY);
  return t;
}

// NDC centre of pixel column x (global) and row y (global)
__device__ __forceinline__ float pixel_x(int tx, int col, float sxs) {
  return (((float)(tx * TILE_W) + (float)col) + 0.5f) * sxs - 1.0f;
}
__device__ __forceinline__ float pixel_y(int ty, int row, float sys) {
  return (((float)(ty * TILE_H) + (float)row) + 0.5f) * sys - 1.0f;
}

// Owner and other face ids of one pixel pair (background depth +inf).
__device__ __forceinline__ void aa_common(float fid, float z, float fid_n,
                                          float z_n, float& owner,
                                          float& other, bool& differs) {
  const float da = fid > 0.0f ? z : BIG;
  const float db = fid_n > 0.0f ? z_n : BIG;
  const bool owner_is_a = da <= db;
  owner = owner_is_a ? fid : fid_n;
  other = owner_is_a ? fid_n : fid;
  differs = fid != fid_n;
}

// Geometry of one owner edge, kept for the backward.
struct EdgeGeo {
  float ea, eb, den, ax, ay, bx, by;
};

// Crossing parameter of one pair direction (pallas_core.py:_aa_pair_t).
// fld: sx0 sy0 sx1 sy1 sx2 sy2 opp1 opp2 opp3 of the owner.
__device__ __forceinline__ float aa_pair_t(const float* fld, float pax,
                                           float pay, float d_ex, float d_ey,
                                           float other, bool& found,
                                           bool take[3], EdgeGeo geo[3]) {
  float best_t = 0.0f;
  found = false;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int e1 = (e + 1) % 3;
    const float ax = fld[2 * e], ay = fld[2 * e + 1];
    const float bx = fld[2 * e1], by = fld[2 * e1 + 1];
    const float ex = bx - ax, ey = by - ay;
    const float ea = ex * (pay - ay) - ey * (pax - ax);
    // eb directly at the neighbour pixel, not incrementally from ea
    const float eb = ex * ((pay + d_ey) - ay) - ey * ((pax + d_ex) - ax);
    const bool separates = (ea > 0.0f) != (eb > 0.0f);
    const float denom = ea - eb;
    const float safe_den = denom == 0.0f ? 1.0f : denom;
    const float t = ea / safe_den;
    const float cx = pax + t * d_ex;
    const float cy = pay + t * d_ey;
    const float along = (cx - ax) * ex + (cy - ay) * ey;
    const bool within = (along >= 0.0f) && (along <= ex * ex + ey * ey);
    const bool silhouette = (other == 0.0f) || (fld[6 + e] != other);
    const bool valid = separates && within && silhouette;
    take[e] = valid && !found;
    if (take[e]) best_t = t;
    found = found || valid;
    geo[e] = EdgeGeo{ea, eb, safe_den, ax, ay, bx, by};
  }
  return best_t;
}

// Slot of face id `key` in this tile's bin, staged through shared memory
// in chunks of `chunk` ids: keys[i] > 0 are looked up, slots[i] set (or
// left -1).  All threads of the block must call it.
template <int N>
__device__ __forceinline__ void find_slots(const float* __restrict__ rb,
                                           int n, float* sfid, int chunk,
                                           const float (&keys)[N],
                                           int (&slots)[N]) {
  for (int base = 0; base < n; base += chunk) {
    const int m = min(chunk, n - base);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x)
      sfid[j] = rb[(size_t)(base + j) * 32 + 22];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (keys[i] > 0.0f && slots[i] < 0) {
        for (int j = 0; j < m; ++j) {
          if (sfid[j] == keys[i]) {
            slots[i] = base + j;
            break;
          }
        }
      }
    }
  }
}

}  // namespace ls
