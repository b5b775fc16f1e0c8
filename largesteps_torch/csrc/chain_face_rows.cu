// chain_face_rows: the backward glue of a prebinned pipe that holds the
// face→slot inverse of its bins (render/pipeline.py:_chain_scatter).
//
//   dface[c, f, :] = Σ over the live slots s of fslots[c, f, :]  chain(s)
//
// dslot (C, S, 32), dslot_aa (C, S, 8) and rbb (C, S, 32) float32 (S = T·cap
// slots a camera, 16-byte aligned); fslots (C, F+1, K) int64, each face's
// slots as flat indices t·cap + p in tile order, the sentinel S (or any
// index outside [0, S)) naming none; dface (C, F+1, 18) float32, per corner
// [dx dy dw dA0 dA1 dA2] in clip space.  chain(s) is the slot's row of
// render/pipeline.py:chain_planes: its screen-space sums (dslot cols 0-17,
// dslot_aa cols 0-5 scaled by boost) chained through the slot's record
// (rbb cols 6-14: iw and the corners' sx, sy).
//
// Replaces chain_planes' (C, T, cap, 18) table, built over every one of the
// C·T·cap slots, live or dead (some 40 elementwise launches, a stack and a
// where), and slot_face_rows' concatenation, gather and
// torch.segment_reduce.  Replaces no Pallas kernel: the JAX package's
// _chain_planes and _scatter_via_slots
// (largesteps_tpu/render/pallas_core.py:1201-1235, 1260-1321) are XLA glue.
//
// Bound on the H100: bytes.  Of each live entry it reads the 32-byte
// sectors that hold dslot cols 0-17 (96 bytes), dslot_aa cols 0-5 (32) and
// rbb cols 6-14 (64); besides, fslots (8·K bytes a face) and dface (72
// bytes a face).  Some 40 float operations an entry are far from the
// card's rate.
//
// Design: one thread a (camera, face) row.  It reads the row's K slot
// indices (twice: for the split below, then for the sums), gathers each
// live slot's columns with 16- and 8-byte loads, chains the 18 values in
// registers, and keeps two sets of 18 running sums in registers.
//
// The bits of slot_face_rows(chain_planes(...)) (torch.equal on the card):
// - each chained value is made with chain_planes' operations in its order,
//   each rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn; the library
//   is built with -fmad=false besides), as PyTorch's separate elementwise
//   kernels round; a value that is not finite or has |x| ≥ BIG becomes
//   +0.0, as chain_planes' torch.where makes it;
// - slot_face_rows cuts a face's K slots at n_up, one past its last slot in
//   the first up_rows tile rows, and torch.segment_reduce adds each of the
//   two runs in slot order from +0.0, one sequential loop an output; here
//   each run is added in the same order from +0.0, then the two runs, as
//   slot_face_rows adds its halves.  A sentinel slot is a zero row there and
//   is skipped here: a sum that starts at +0.0 never becomes −0.0, so
//   adding +0.0 leaves it as it was.  Row F, all sentinels, comes out zero.
// - one thread writes each output; no atomics: every launch the same bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROW = 18;

struct Chain {
  const float* dslot;
  const float* aa;
  const float* rbb;
  const long long* fslots;
  float* dface;
  long long S;          // slots a camera, T·cap
  long long row_slots;  // slots a tile row, TX·cap
  long long rows;       // C·(F+1)
  int F1, K, up_rows;
  float boost;
};

__device__ __forceinline__ float keep(float x) {
  return fabsf(x) < ls::BIG ? x : 0.0f;
}

// corner k's six chained values of one slot, as chain_planes makes them
__device__ __forceinline__ void corner(const float* d, const float* a,
                                       float boost, float iw, float sx,
                                       float sy, int k, float* v) {
  const float dsx = __fadd_rn(d[2 * k], __fmul_rn(boost, a[2 * k]));
  const float dsy = __fadd_rn(d[2 * k + 1], __fmul_rn(boost, a[2 * k + 1]));
  const float diw = d[6 + k];
  // dw = −iw²·diw − iw·(dsx·sx + dsy·sy)
  const float t0 = __fmul_rn(__fmul_rn(-iw, iw), diw);
  const float t1 =
      __fmul_rn(iw, __fadd_rn(__fmul_rn(dsx, sx), __fmul_rn(dsy, sy)));
  v[6 * k + 0] = keep(__fmul_rn(dsx, iw));
  v[6 * k + 1] = keep(__fmul_rn(dsy, iw));
  v[6 * k + 2] = keep(__fsub_rn(t0, t1));
  v[6 * k + 3] = keep(d[9 + 3 * k]);
  v[6 * k + 4] = keep(d[10 + 3 * k]);
  v[6 * k + 5] = keep(d[11 + 3 * k]);
}

// slot e's (camera-major row) 18 chained values added into acc
__device__ __forceinline__ void add_slot(const Chain& p, long long e,
                                         float* acc) {
  const float4* ds = reinterpret_cast<const float4*>(p.dslot + e * 32);
  const float4* as = reinterpret_cast<const float4*>(p.aa + e * 8);
  const float* rb = p.rbb + e * 32;
  float d[18], a[6];
  const float4 d0 = __ldg(ds), d1 = __ldg(ds + 1), d2 = __ldg(ds + 2),
               d3 = __ldg(ds + 3);
  const float2 d4 = __ldg(reinterpret_cast<const float2*>(ds + 4));
  const float4 a0 = __ldg(as);
  const float2 a1 = __ldg(reinterpret_cast<const float2*>(as + 1));
  const float2 r0 = __ldg(reinterpret_cast<const float2*>(rb + 6));
  const float4 r1 = __ldg(reinterpret_cast<const float4*>(rb + 8));
  const float2 r2 = __ldg(reinterpret_cast<const float2*>(rb + 12));
  const float r3 = __ldg(rb + 14);
  d[0] = d0.x; d[1] = d0.y; d[2] = d0.z; d[3] = d0.w;
  d[4] = d1.x; d[5] = d1.y; d[6] = d1.z; d[7] = d1.w;
  d[8] = d2.x; d[9] = d2.y; d[10] = d2.z; d[11] = d2.w;
  d[12] = d3.x; d[13] = d3.y; d[14] = d3.z; d[15] = d3.w;
  d[16] = d4.x; d[17] = d4.y;
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y;
  // rbb cols 6-8 iw0 iw1 iw2, 9-14 sx0 sy0 sx1 sy1 sx2 sy2
  float v[ROW];
  corner(d, a, p.boost, r0.x, r1.y, r1.z, 0, v);
  corner(d, a, p.boost, r0.y, r1.w, r2.x, 1, v);
  corner(d, a, p.boost, r1.x, r2.y, r3, 2, v);
#pragma unroll
  for (int j = 0; j < ROW; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
}

__global__ void __launch_bounds__(THREADS)
    chain_face_rows_kernel(const Chain p) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= p.rows) return;
  const long long c = r / p.F1;
  const long long* fs = p.fslots + r * p.K;
  // the split: one past the last slot in the first up_rows tile rows
  int n_up = 0;
  for (int k = 0; k < p.K; ++k) {
    const long long s = __ldg(fs + k);
    if (s >= 0 && s < p.S && s / p.row_slots < p.up_rows) n_up = k + 1;
  }
  float lo[ROW], hi[ROW];
#pragma unroll
  for (int j = 0; j < ROW; ++j) lo[j] = hi[j] = 0.0f;
  for (int k = 0; k < n_up; ++k) {
    const long long s = __ldg(fs + k);
    if (s >= 0 && s < p.S) add_slot(p, c * p.S + s, lo);
  }
  for (int k = n_up; k < p.K; ++k) {
    const long long s = __ldg(fs + k);
    if (s >= 0 && s < p.S) add_slot(p, c * p.S + s, hi);
  }
  float2* out = reinterpret_cast<float2*>(p.dface + r * ROW);
#pragma unroll
  for (int j = 0; j < ROW / 2; ++j)
    out[j] = make_float2(__fadd_rn(lo[2 * j], hi[2 * j]),
                         __fadd_rn(lo[2 * j + 1], hi[2 * j + 1]));
}

}  // namespace

// dslot (C, S, 32), dslot_aa (C, S, 8), rbb (C, S, 32), fslots (C, F1, K)
// int64, dface (C, F1, 18); S = T·cap, row_slots = TX·cap, up_rows the
// tile rows of the first half.
extern "C" int ls_chain_face_rows(const float* dslot, const float* dslot_aa,
                                  const float* rbb, const long long* fslots,
                                  float* dface, int C, int F1, int K,
                                  long long S, long long row_slots,
                                  int up_rows, float boost, void* stream) {
  if (C < 0 || F1 < 0 || K < 0 || S < 0 || row_slots < 1)
    return (int)cudaErrorInvalidValue;
  Chain p{};
  p.dslot = dslot;
  p.aa = dslot_aa;
  p.rbb = rbb;
  p.fslots = fslots;
  p.dface = dface;
  p.S = S;
  p.row_slots = row_slots;
  p.rows = (long long)C * F1;
  p.F1 = F1;
  p.K = K;
  p.up_rows = up_rows;
  p.boost = boost;
  if (p.rows == 0) return (int)cudaGetLastError();
  const long long blocks = (p.rows + THREADS - 1) / THREADS;
  chain_face_rows_kernel<<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
