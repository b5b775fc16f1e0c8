// onehot_scatter: the segment sum of a rasterizer backward's per-pixel rows
// into per-face rows, summed over cameras.
//
//   out[f, :] = sum over (c, p) with ids[c, p] == f of m[c, p, :]
//
// ids (C, P) int32, m (C, P, ch) float32, out (n_faces, ch) float32, zeroed
// by the wrapper; ids outside [0, n_faces) add nothing.
//
// Replaces: benchmarks/micro_scatter.py, onehot_scatter /
// onehot_matmul_kernel (the TPU kernel builds a (4096, 512) one-hot block of
// pixels against faces in VMEM and multiplies it into the rows on the MXU,
// padding P to a multiple of 4,096 and the faces to 512).
//
// Bound on the H100: bytes.  Each entry reads one id and ch floats and adds
// them once; there is no arithmetic to speak of, and the one-hot product the
// TPU ran is n_faces times more work than the sum it computes.  The adds
// are float atomics to global memory, which the card performs in L2
// (RED.E.ADD.F32), so the output (20 KB a channel at 5,121 faces) stays in
// L2 while the rows stream through once.
//
// Design: one thread per (entry, group of 4 channels), the groups of one
// entry on neighbouring threads so that a warp reads m in order; a thread
// whose id is out of range adds nothing.  Any P works.  Neighbouring
// entries of a real slot table mostly name different faces, so the adds
// rarely meet on one address; a warp-aggregated or sorted variant is later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 4;              // channels a thread

__global__ void __launch_bounds__(THREADS)
onehot_scatter_kernel(const int* __restrict__ ids, const float* __restrict__ m,
                      float* __restrict__ out, long long n_entries, int ch,
                      int groups, int n_faces) {
  const long long total = n_entries * groups;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i / groups;
    const int c0 = (int)(i - e * groups) * GROUP;
    const int f = ids[e];
    if (f < 0 || f >= n_faces) continue;
    const float* src = m + e * ch + c0;
    float* dst = out + (size_t)f * ch + c0;
    const int n = min(GROUP, ch - c0);
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (k < n) atomicAdd(dst + k, src[k]);
  }
}

}  // namespace

extern "C" int ls_onehot_scatter(const int* ids, const float* m, float* out,
                                 long long n_entries, int ch, int n_faces,
                                 void* stream) {
  const int groups = (ch + GROUP - 1) / GROUP;
  const long long total = n_entries * groups;
  if (total == 0 || n_faces == 0) return (int)cudaGetLastError();
  // enough blocks for a few waves of 132 SMs, then a grid-stride loop
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  onehot_scatter_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      ids, m, out, n_entries, ch, groups, n_faces);
  return (int)cudaGetLastError();
}
