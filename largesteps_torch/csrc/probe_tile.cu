// probe_tile: one 32x128 tile's owner gather and per-slot sums, for a batch
// of B tiles.
//
//   fields[b, r, p] = recT[b, r, slot[b, p]]   (0 where slot[b, p] names no
//                                               column of recT)
//   S[b, c, i]      = sum over p with slot[b, p] == c of g0[b, p] * (i + 1)
//
// slot (B, 32, 128) float holding integral values in -1..cap-1 (p = row *
// 128 + column), recT (B, 32, cap), g0 (B, 32, 128) → fields (B, 32, 4096),
// S (B, cap, 18), all float32.  A slot s names column c only if s == (float)c
// and 0 <= c < cap, exactly when the one-hot of the TPU kernel matches.
//
// Replaces: benchmarks/probe_mosaic.py, kernel (the TPU probe builds the
// (cap, 4096) one-hot of the slot plane in VMEM, gathers with recT @ onehot
// and reduces with onehot @ g^T on the MXU, one tile a call).
//
// Bound on the H100: bytes.  A tile reads 32 * cap record floats and two
// planes of 4,096 and writes 32 * 4,096 fields and cap * 18 sums; the gather
// is one shared-memory read a field and the sums 18 adds a pixel, far below
// the card's rates.  The one-hot products the TPU ran are cap times that work.
//
// Design: one block of 1,024 threads per tile, a warp a row, one pixel a
// lane in each of four steps.  The tile's recT goes to shared memory (96 KB
// at cap 768, past the 48 KB default: smem_opt_in), beside a (cap, 18) table
// of the sums.  Each lane turns its slot into a column once; the fields are
// written row by row, neighbouring lanes on neighbouring addresses.  For the
// sums, neighbouring pixels mostly share a slot, so a segmented shuffle scan
// adds each run of lanes that name one slot, as raster_bwd does, and the
// run's first lane adds its 18 sums to the shared table: one add a run and
// sum.  The block then writes its table out whole, so S needs no memset.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;      // a warp a row of the tile
constexpr int STEPS = ls::TILE_W / 32;
constexpr int P = ls::TILE_H * ls::TILE_W;
constexpr int NS = 18;             // sums a slot

// the column of recT that slot value s names, or -1
__device__ __forceinline__ int slot_column(float s, int cap) {
  if (!(s >= 0.0f && s < (float)cap)) return -1;
  const int c = (int)s;
  return (float)c == s ? c : -1;
}

__global__ void __launch_bounds__(THREADS, 1)
probe_tile_kernel(const float* __restrict__ slot,
                  const float* __restrict__ recT,
                  const float* __restrict__ g0, float* __restrict__ fields,
                  float* __restrict__ S, int cap) {
  extern __shared__ float smem[];
  float* rec = smem;                          // (32, cap)
  float* tab = smem + (size_t)32 * cap;       // (cap, 18)
  const size_t b = blockIdx.x;
  const float* rb = recT + b * 32 * cap;
  for (int i = threadIdx.x; i < 32 * cap; i += blockDim.x) rec[i] = rb[i];
  for (int i = threadIdx.x; i < cap * NS; i += blockDim.x) tab[i] = 0.0f;

  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t pix0 = b * P + row * ls::TILE_W + lane;
  int cols[STEPS];
#pragma unroll
  for (int k = 0; k < STEPS; ++k) cols[k] = slot_column(slot[pix0 + 32 * k], cap);
  __syncthreads();

  // the owner gather, one field row at a time
  float* fb = fields + b * 32 * P + row * ls::TILE_W + lane;
  for (int r = 0; r < 32; ++r) {
#pragma unroll
    for (int k = 0; k < STEPS; ++k)
      fb[(size_t)r * P + 32 * k] = cols[k] >= 0 ? rec[r * cap + cols[k]] : 0.0f;
  }

  // the per-slot sums: each run of lanes on one slot is summed by a
  // segmented suffix scan, and its first lane adds the run's sums
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    const int s = cols[k];
    if (!__ballot_sync(ls::FULL, s >= 0)) continue;
    const float g = g0[pix0 + 32 * k];
    float G[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) G[i] = s >= 0 ? g * (float)(i + 1) : 0.0f;
    const int prev = __shfl_up_sync(ls::FULL, s, 1);
    const int next = __shfl_down_sync(ls::FULL, s, 1);
    const unsigned ends = __ballot_sync(ls::FULL, lane == 31 || next != s);
    const int end = lane + __ffs(ends >> lane) - 1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float o = __shfl_down_sync(ls::FULL, G[i], d);
        if (lane + d <= end) G[i] += o;
      }
    }
    if (s >= 0 && (lane == 0 || prev != s)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) atomicAdd(tab + s * NS + i, G[i]);
    }
  }
  __syncthreads();
  float* sb = S + b * cap * NS;
  for (int i = threadIdx.x; i < cap * NS; i += blockDim.x) sb[i] = tab[i];
}

}  // namespace

// bytes of shared memory a block takes at `cap`
extern "C" long long ls_probe_tile_smem(int cap) {
  return (long long)(32 + NS) * cap * (long long)sizeof(float);
}

extern "C" int ls_probe_tile(const float* slot, const float* recT,
                             const float* g0, float* fields, float* S, int B,
                             int cap, void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)ls_probe_tile_smem(cap);
  const cudaError_t e = ls::smem_opt_in<probe_tile_kernel>(smem, 0);
  if (e != cudaSuccess) return (int)e;
  probe_tile_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      slot, recT, g0, fields, S, cap);
  return (int)cudaGetLastError();
}
