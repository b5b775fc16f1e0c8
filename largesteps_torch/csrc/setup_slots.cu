// setup_slots: the prebinned pipe's forward setup (render/pipeline.py:
// setup_from_bins).  Each (camera, tile, slot) row of the binned records is
// computed from its face and written once:
//
//   rfb[c, t, p, :] = rec_fwd of face bins[c, t, p] in camera c
//   rbb[c, t, p, :] = rec_bwd of the same
//
// v_clip (C, V, 4) float32 (16-byte aligned), faces and opp (F, 3) int64,
// attrs (V, 3) float32, bins (C, T, cap) int32 or int64 with any strides
// (a row shard's slice of whole-image bins), −1 (or any id outside
// [0, F)) for a dead slot; rfb and rbb (C, T, cap, 32) float32, rfb null
// for the backward's recompute.  A dead slot's rbb row is zeros, its rfb row
// zeros but for an empty y-range (col 12 = 1e9, col 13 = −1e9).
//
// Replaces the face-major route: render/pipeline.py:_setup_core's ~100
// elementwise (C, F) planes, a torch.stack of 32 of them a record, then a
// torch.cat with the fill row and a gather of whole rows by bins
// (kernels.setup_slots_plain).  Replaces no Pallas kernel: the JAX
// package's setup_from_bins (largesteps_tpu/render/pallas_core.py:245) is
// XLA glue.
//
// Bound on the H100: bytes written.  The two tables are 2 · 128 bytes a
// slot (2.82 GB at nefertiti's 13 cameras, 16 tiles, cap 52,992); the
// inputs (bins, and v_clip, faces, attrs and opp, which mostly stay in the
// 50 MB L2) are a few per cent of that.  A live slot costs some 100 float
// operations, far from the card's rate; a face in ~1.4 slots has its
// record computed once a slot.
//
// Design: a block owns THREADS consecutive slots of one bin (grid: cap
// chunks × T × C), one thread a slot.  A thread loads its bin entry, the
// face's corner ids, its three clip-space corners (one float4 each), their
// attributes and opp, and computes both 32-float rows in registers.  The
// block stages one table at a time in shared memory (16 KB, float4 columns
// XOR-swizzled by row, so neither the row-wise writes nor the column-wise
// reads conflict on banks), then writes its contiguous stretch of the
// table with coalesced 16-byte streaming stores: a warp writes 512
// contiguous bytes an instruction, where a thread writing its own 128-byte
// row would stride 128 bytes a lane.
//
// The bits of the face-major route on the card (torch.equal on int32
// views): every value is made with _setup_core's operations in its order,
// each rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn; the
// library is built with -fmad=false besides), as PyTorch's separate
// elementwise kernels round.  1.0 / t is an IEEE division 1.0f / t (PyTorch
// takes reciprocal(t) * 1.0), x / w a true division; the comparisons with
// 1e-9 and 1e-12 are in float32, as PyTorch casts the scalar; the where
// guards (valid, w == 0, area == 0) and their fills are _setup_core's.  A
// NaN result is the card's canonical NaN on both routes, and R (a copy of
// the third corner's attribute) keeps its bits.  One thread writes each
// output element; no atomics: every launch the same bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // slots a block, one a thread
constexpr int ROW = 32;       // floats a record row
constexpr int VEC = ROW / 4;  // float4s a row

struct Setup {
  const float4* v_clip;
  const long long* faces;
  const float* attrs;
  const long long* opp;
  const void* bins;
  float* rfb;  // null: rbb alone
  float* rbb;
  long long bin_c, bin_t, bin_p;  // the bins' strides, in elements
  long long V, F;
  int T, cap, bins64;
  float half_h;  // height / 2
};

// rec_fwd (rf) and rec_bwd (rb) of face f in camera c, as _setup_core
// makes them with fid = f + 1 and opp1 = opp + 1
__device__ __forceinline__ void record(const Setup& p, int c, long long f,
                                       float* rf, float* rb) {
  const long long* fv = p.faces + f * 3;
  const long long id[3] = {__ldg(fv), __ldg(fv + 1), __ldg(fv + 2)};
  const float4* vc = p.v_clip + (long long)c * p.V;
  float x[3], y[3], z[3], w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 v = __ldg(vc + id[k]);
    x[k] = v.x;
    y[k] = v.y;
    z[k] = v.z;
    w[k] = v.w;
  }
  bool valid = w[0] > 1e-9f && w[1] > 1e-9f && w[2] > 1e-9f;
  float iw[3], sx[3], sy[3], zw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sw = w[k] == 0.0f ? 1.0f : w[k];
    iw[k] = valid ? __fdiv_rn(1.0f, sw) : 0.0f;
    sx[k] = valid ? __fdiv_rn(x[k], sw) : 0.0f;
    sy[k] = valid ? __fdiv_rn(y[k], sw) : 0.0f;
    zw[k] = valid ? __fdiv_rn(z[k], sw) : 0.0f;
  }
  const float area =
      __fsub_rn(__fmul_rn(__fsub_rn(sx[1], sx[0]), __fsub_rn(sy[2], sy[0])),
                __fmul_rn(__fsub_rn(sy[1], sy[0]), __fsub_rn(sx[2], sx[0])));
  valid = valid && fabsf(area) >= 1e-12f;
  const float inv_area =
      valid ? __fdiv_rn(1.0f, area == 0.0f ? 1.0f : area) : 0.0f;

  const float b0a = __fmul_rn(-__fsub_rn(sy[2], sy[1]), inv_area);
  const float b0b = __fmul_rn(__fsub_rn(sx[2], sx[1]), inv_area);
  const float b0c =
      __fmul_rn(__fsub_rn(__fmul_rn(sx[1], __fsub_rn(sy[2], sy[1])),
                          __fmul_rn(sy[1], __fsub_rn(sx[2], sx[1]))),
                inv_area);
  const float b1a = __fmul_rn(-__fsub_rn(sy[0], sy[2]), inv_area);
  const float b1b = __fmul_rn(__fsub_rn(sx[0], sx[2]), inv_area);
  const float b1c =
      __fmul_rn(__fsub_rn(__fmul_rn(sx[2], __fsub_rn(sy[0], sy[2])),
                          __fmul_rn(sy[2], __fsub_rn(sx[0], sx[2]))),
                inv_area);

  const float d02 = __fsub_rn(iw[0], iw[2]), d12 = __fsub_rn(iw[1], iw[2]);
  const float z02 = __fsub_rn(zw[0], zw[2]), z12 = __fsub_rn(zw[1], zw[2]);
  // bbox in pixel rows, 1 px expanded
  const float mn = fminf(fminf(sy[0], sy[1]), sy[2]);
  const float mx = fmaxf(fmaxf(sy[0], sy[1]), sy[2]);
  const float ymin =
      valid ? __fsub_rn(__fsub_rn(__fmul_rn(__fadd_rn(mn, 1.0f), p.half_h),
                                  0.5f),
                        1.0f)
            : 1e9f;
  const float ymax =
      valid ? __fadd_rn(__fsub_rn(__fmul_rn(__fadd_rn(mx, 1.0f), p.half_h),
                                  0.5f),
                        1.0f)
            : -1e9f;
  const float fid = __ll2float_rn(f + 1);

  // corner attributes: colour_c = u·P + v·Q + R
  float P[3], Q[3], R[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float a0 = __ldg(p.attrs + id[0] * 3 + ch);
    const float a1 = __ldg(p.attrs + id[1] * 3 + ch);
    R[ch] = __ldg(p.attrs + id[2] * 3 + ch);
    P[ch] = __fsub_rn(a0, R[ch]);
    Q[ch] = __fsub_rn(a1, R[ch]);
  }
  const long long* ov = p.opp + f * 3;

  rb[0] = b0a;
  rb[1] = b0b;
  rb[2] = b0c;
  rb[3] = b1a;
  rb[4] = b1b;
  rb[5] = b1c;
  rb[6] = iw[0];
  rb[7] = iw[1];
  rb[8] = iw[2];
  rb[9] = sx[0];
  rb[10] = sy[0];
  rb[11] = sx[1];
  rb[12] = sy[1];
  rb[13] = sx[2];
  rb[14] = sy[2];
  rb[15] = inv_area;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    rb[16 + 2 * ch] = P[ch];
    rb[17 + 2 * ch] = Q[ch];
  }
  rb[22] = fid;
#pragma unroll
  for (int k = 0; k < 3; ++k) rb[23 + k] = __ll2float_rn(__ldg(ov + k) + 1);
  rb[26] = ymin;
  rb[27] = ymax;
#pragma unroll
  for (int j = 28; j < ROW; ++j) rb[j] = 0.0f;

  rf[0] = __fmul_rn(b0a, iw[0]);
  rf[1] = __fmul_rn(b0b, iw[0]);
  rf[2] = valid ? __fmul_rn(b0c, iw[0]) : -1.0f;
  rf[3] = __fmul_rn(b1a, iw[1]);
  rf[4] = __fmul_rn(b1b, iw[1]);
  rf[5] = valid ? __fmul_rn(b1c, iw[1]) : -1.0f;
  rf[6] = __fadd_rn(__fmul_rn(b0a, d02), __fmul_rn(b1a, d12));
  rf[7] = __fadd_rn(__fmul_rn(b0b, d02), __fmul_rn(b1b, d12));
  rf[8] = __fadd_rn(__fadd_rn(__fmul_rn(b0c, d02), __fmul_rn(b1c, d12)),
                    iw[2]);
  rf[9] = __fadd_rn(__fmul_rn(b0a, z02), __fmul_rn(b1a, z12));
  rf[10] = __fadd_rn(__fmul_rn(b0b, z02), __fmul_rn(b1b, z12));
  rf[11] = __fadd_rn(__fadd_rn(__fmul_rn(b0c, z02), __fmul_rn(b1c, z12)),
                     zw[2]);
  rf[12] = ymin;
  rf[13] = ymax;
  rf[14] = fid;
  rf[15] = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    rf[16 + 3 * ch] = P[ch];
    rf[17 + 3 * ch] = Q[ch];
    rf[18 + 3 * ch] = R[ch];
  }
#pragma unroll
  for (int j = 25; j < ROW; ++j) rf[j] = 0.0f;
}

// the block's rows of one table: each thread's row into shared memory
// (float4 column j of row r at r·VEC + (j ^ (r & 7))), then n rows out
// from `out`, 16 bytes a thread, consecutive threads on consecutive bytes
__device__ __forceinline__ void stage_out(float4* buf, const float* row,
                                          float* out, int n) {
  const int r = threadIdx.x;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    buf[r * VEC + (j ^ (r & 7))] =
        make_float4(row[4 * j], row[4 * j + 1], row[4 * j + 2],
                    row[4 * j + 3]);
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out);
  for (int q = threadIdx.x; q < n * VEC; q += THREADS) {
    const int rr = q / VEC, col = q % VEC;
    __stcs(o + q, buf[rr * VEC + (col ^ (rr & 7))]);
  }
  __syncthreads();  // the buffer is free for the next table
}

__global__ void __launch_bounds__(THREADS) setup_slots_kernel(const Setup p) {
  __shared__ float4 buf[THREADS * VEC];
  const int c = blockIdx.z, t = blockIdx.y;
  const int p0 = blockIdx.x * THREADS;
  const int k = p0 + threadIdx.x;
  long long f = -1;
  if (k < p.cap) {
    const long long at = c * p.bin_c + t * p.bin_t + k * p.bin_p;
    f = p.bins64 ? __ldg(static_cast<const long long*>(p.bins) + at)
                 : (long long)__ldg(static_cast<const int*>(p.bins) + at);
  }
  float rf[ROW], rb[ROW];
  if (f >= 0 && f < p.F) {
    record(p, c, f, rf, rb);
  } else {
#pragma unroll
    for (int j = 0; j < ROW; ++j) rf[j] = rb[j] = 0.0f;
    rf[12] = 1e9f;
    rf[13] = -1e9f;
  }
  const int n = min(THREADS, p.cap - p0);
  const long long first = (((long long)c * p.T + t) * p.cap + p0) * ROW;
  stage_out(buf, rb, p.rbb + first, n);
  if (p.rfb != nullptr) stage_out(buf, rf, p.rfb + first, n);
}

}  // namespace

// v_clip (C, V, 4), faces (F, 3), attrs (V, 3), opp (F, 3), bins (C, T, cap)
// of strides (bin_c, bin_t, bin_p) elements, int64 if bins64 else int32;
// rfb (or null) and rbb (C, T, cap, 32); half_h = height / 2.
extern "C" int ls_setup_slots(const float* v_clip, const long long* faces,
                              const float* attrs, const long long* opp,
                              const void* bins, float* rfb, float* rbb, int C,
                              int T, int cap, long long V, long long F,
                              long long bin_c, long long bin_t,
                              long long bin_p, int bins64, float half_h,
                              void* stream) {
  if (C < 0 || T < 0 || cap < 0 || V < 0 || F < 0 || C > 65535 ||
      T > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long long)C * T * cap == 0) return (int)cudaGetLastError();
  Setup p{};
  p.v_clip = reinterpret_cast<const float4*>(v_clip);
  p.faces = faces;
  p.attrs = attrs;
  p.opp = opp;
  p.bins = bins;
  p.rfb = rfb;
  p.rbb = rbb;
  p.bin_c = bin_c;
  p.bin_t = bin_t;
  p.bin_p = bin_p;
  p.V = V;
  p.F = F;
  p.T = T;
  p.cap = cap;
  p.bins64 = bins64;
  p.half_h = half_h;
  const dim3 grid((unsigned)((cap + THREADS - 1) / THREADS), (unsigned)T,
                  (unsigned)C);
  setup_slots_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
