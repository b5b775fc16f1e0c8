// onehot_scatter: the segment sum of a rasterizer backward's per-pixel rows
// into per-face rows, summed over cameras.
//
//   out[f, :] = sum over (c, p) with ids[c, p] == f of m[c, p, :]
//
// ids (C, P) int32, m (C, P, ch) float32 (16-byte aligned), out (n_faces,
// ch) float32; ids outside [0, n_faces) add nothing.  The launcher zeroes
// out on the stream before the kernel adds into it.
//
// Replaces: benchmarks/micro_scatter.py, onehot_scatter /
// onehot_matmul_kernel (the TPU kernel builds a (4096, 512) one-hot block of
// pixels against faces in VMEM and multiplies it into the rows on the MXU,
// padding P to a multiple of 4,096 and the faces to 512).
//
// Bound on the H100: bytes.  Each entry reads one id and ch floats and adds
// them once; the one-hot product the TPU ran is n_faces times the work of
// the sum.  What held the first design back is the number of operations
// that reach L2: one scalar float reduction (RED.E.ADD.F32) an entry and
// channel, 27.3M at the main path's shape and 15.3M at nefertiti's, and on
// the main path's own traffic (scatter_via_faces: each tile's bin ends in
// a run of sentinel ids) whole warps of them on one address.
//
// Design: a warp takes 32 consecutive entries, a lane an entry.
// 1. The warp copies the 32 rows' channels of its window (below) into its
//    own slice of shared memory with 16-, 8- or 4-byte loads (the widest
//    that the row length allows), neighbouring lanes on neighbouring
//    addresses; the slice's row stride is padded so that lane l reading
//    row l meets no bank conflict.
// 2. Runs of lanes with one id are summed by a segmented shuffle scan, in
//    as many steps as the warp's longest run (none for distinct ids), and
//    the run's first lane adds the run's sum once: one reduction a run.
// 3. The reductions are vectors: red.global.add.v4.f32 where a row is
//    16-byte aligned (ch % 4 == 0), v2 where it is 8-byte aligned, scalar
//    otherwise: 4x and 2x fewer L2 operations than scalar adds.
// The grid is one wave of resident blocks of 256 threads (fewer where the
// chunks run out), warps taking every (blocks x 8)-th chunk; a row of more
// than 64 channels is cut into windows of 64, one grid row each.
//
// What bounds it on this card (PERF.md): L2's float adds.  A v4
// reduction costs about 2.5 scalar ones there and a v2 about 1.8, so the
// main path's shape (27.3M float adds into 164k addresses) takes about
// 0.1 ms however they are packed, and adds that meet on one address queue
// behind each other.  Private slabs of the output in shared memory would
// keep the adds out of L2, but shared memory has no float add: atomicAdd
// there is a compare-and-swap loop (ATOMS.CAST.SPIN), and a variant with a
// slab of 5,121 faces x 8 channels a block measured 3.4x slower at the main
// path's shape and 4.5x slower on 64 faces.
#include "common.cuh"

namespace {

constexpr unsigned FULL = ls::FULL;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WIDE = 64;                   // widest window, channels

// The slice row stride for rows of W channels read VEC at a time: the
// least S >= W with S / VEC odd, so the 8 (VEC 4), 16 (VEC 2) or 32 lanes
// of one shared-memory wavefront read distinct banks.
__host__ __device__ __forceinline__ int stride_of(int W, int vec) {
  int S = (W + vec - 1) / vec;
  if (S % 2 == 0) ++S;
  return S * vec;
}

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> ld(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else if constexpr (VEC == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    r.v[0] = q.x; r.v[1] = q.y;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void st(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  else if constexpr (VEC == 2)
    *reinterpret_cast<float2*>(p) = make_float2(r.v[0], r.v[1]);
  else
    *p = r.v[0];
}

// One L2 reduction of VEC floats (p aligned to VEC floats).
template <int VEC>
__device__ __forceinline__ void red(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4)
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "f"(r.v[0]), "f"(r.v[1]), "f"(r.v[2]), "f"(r.v[3])
                 : "memory");
  else if constexpr (VEC == 2)
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p),
                 "f"(r.v[0]), "f"(r.v[1])
                 : "memory");
  else
    atomicAdd(p, r.v[0]);
}

// Block (part, window): window y covers channels y * W .. + w - 1 (w = W
// but for the last window).
template <int VEC>
__global__ void __launch_bounds__(THREADS)
onehot_scatter_kernel(const int* __restrict__ ids, const float* __restrict__ m,
                      float* __restrict__ out, long long n_entries, int ch,
                      int n_faces, int W, int S) {
  extern __shared__ float4 smem4[];
  const int c0 = blockIdx.y * W;
  const int w = min(W, ch - c0);
  const int wv = w / VEC;                    // vectors a row of the window
  const int lane = threadIdx.x & 31;
  float* slice = reinterpret_cast<float*>(smem4) +
                 (size_t)(threadIdx.x >> 5) * 32 * S;
  // this lane's first vector of a chunk's copy, and the step of 32 vectors
  const int r0 = lane / wv, v0 = lane - r0 * wv;
  const int dr = 32 / wv, dv = 32 - dr * wv;
  const long long chunks = (n_entries + 31) / 32;
  for (long long k = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       k < chunks; k += (long long)gridDim.x * WARPS) {
    const long long e0 = k * 32;
    const int rows = (int)min(32ll, n_entries - e0);
    const int id = lane < rows ? ids[e0 + lane] : -1;
    const float* src = m + e0 * ch + c0;
    int r = r0, v = v0;
#pragma unroll 4
    for (int u = lane; u < rows * wv; u += 32) {
      st<VEC>(slice + r * S + v * VEC, ld<VEC>(src + (size_t)r * ch + v * VEC));
      v += dv;
      r += dr;
      if (v >= wv) {
        v -= wv;
        ++r;
      }
    }
    __syncwarp();
    const int prev = __shfl_up_sync(FULL, id, 1);
    const int next = __shfl_down_sync(FULL, id, 1);
    const bool head = lane == 0 || prev != id;
    const unsigned ends = __ballot_sync(FULL, lane == 31 || next != id);
    const int end = lane + __ffs(ends >> lane) - 1;
    const int longest = __reduce_max_sync(FULL, head ? end - lane + 1 : 0);
    const bool adds = head && id >= 0 && id < n_faces;
    for (int c = 0; c < wv; ++c) {
      Vec<VEC> x;
      if (lane < rows) {
        x = ld<VEC>(slice + lane * S + c * VEC);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) x.v[j] = 0.0f;
      }
      for (int d = 1; d < longest; d <<= 1) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float o = __shfl_down_sync(FULL, x.v[j], d);
          if (lane + d <= end) x.v[j] += o;
        }
      }
      if (adds) red<VEC>(out + (size_t)id * ch + c0 + c * VEC, x);
    }
    __syncwarp();                            // the slice is rewritten next
  }
}

// How a call runs: the vector width, the window W and its slice stride S,
// the grid (parts, windows), dynamic shared bytes a block and blocks an SM
// holds.
struct Plan {
  int vec, W, S, parts, windows, per_sm;
  long long smem;
};

template <int VEC>
Plan plan_vec(long long n_entries, int ch) {
  Plan p;
  p.vec = VEC;
  p.W = ch <= WIDE ? ch : WIDE / VEC * VEC;
  p.windows = (ch + p.W - 1) / p.W;
  p.S = stride_of(p.W, VEC);
  p.smem = 4ll * WARPS * 32 * p.S;
  p.per_sm = ls::resident<onehot_scatter_kernel<VEC>>(THREADS, p.smem);
  // one wave of resident blocks, fewer where the chunks run out
  const long long full = (long long)ls::sm_count() * p.per_sm;
  const long long want = ((n_entries + 31) / 32 + WARPS - 1) / WARPS;
  p.parts = (int)(want < full ? want : full);
  return p;
}

Plan plan_of(long long n_entries, int ch) {
  return ch % 4 == 0   ? plan_vec<4>(n_entries, ch)
         : ch % 2 == 0 ? plan_vec<2>(n_entries, ch)
                       : plan_vec<1>(n_entries, ch);
}

template <int VEC>
cudaError_t launch(const Plan& p, const int* ids, const float* m, float* out,
                   long long n_entries, int ch, int n_faces,
                   cudaStream_t stream) {
  const cudaError_t e =
      ls::smem_opt_in<onehot_scatter_kernel<VEC>>(p.smem, 0);
  if (e != cudaSuccess) return e;
  onehot_scatter_kernel<VEC>
      <<<dim3(p.parts, p.windows), THREADS, p.smem, stream>>>(
          ids, m, out, n_entries, ch, n_faces, p.W, p.S);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ls_onehot_scatter(const int* ids, const float* m, float* out,
                                 long long n_entries, int ch, int n_faces,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_faces == 0 || ch == 0) return (int)cudaGetLastError();
  cudaError_t e = cudaMemsetAsync(out, 0, 4ull * n_faces * ch, s);
  if (e != cudaSuccess || n_entries == 0) return (int)e;
  const Plan p = plan_of(n_entries, ch);
  e = p.vec == 4   ? launch<4>(p, ids, m, out, n_entries, ch, n_faces, s)
      : p.vec == 2 ? launch<2>(p, ids, m, out, n_entries, ch, n_faces, s)
                   : launch<1>(p, ids, m, out, n_entries, ch, n_faces, s);
  return (int)e;
}

// The plan of a call at (n_entries, ch): {vector width, window, blocks a
// window, windows, threads a block, dynamic shared bytes a block, blocks
// an SM holds}.
extern "C" void ls_onehot_scatter_plan(long long n_entries, int ch,
                                       long long* out) {
  const Plan p = plan_of(n_entries, ch);
  const long long v[7] = {p.vec, p.W,    p.parts, p.windows,
                          THREADS, p.smem, p.per_sm};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}
