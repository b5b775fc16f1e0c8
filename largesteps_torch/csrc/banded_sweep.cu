// banded_sweep: the solve of the banded tier's block LDLᵀ factor
// (core/banded.py), both sweeps in one persistent cooperative launch.
//
//   forward   y₀ = b₀,  yᵢ = bᵢ − Lᵢ·yᵢ₋₁                  i = 1 .. nb−1
//   diagonal  zᵢ = inv(D′ᵢ)·yᵢ                              every i at once
//   backward  x_{nb−1} = z_{nb−1},  xᵢ = zᵢ − Lᵢ₊₁ᵀ·xᵢ₊₁     i = nb−2 .. 0
//
// invD, L (nb, B, B) float32, b (n, k) float32, perm (n,) int64 (row p of
// the permuted system is row perm[p] of b), out (n, k): out[perm[p]] = x[p].
// The scratch is 2·nb·B·k 8-byte words, y then z (overwritten by x), each
// a float and its tag; the launcher zeroes it on the stream.  B a multiple
// of 128 up to 2048, k from 1 to 4, n ≤ nb·B (rows p ≥ n are the zero
// padding).
//
// Replaces no Pallas kernel: the JAX package's sweeps are two lax.scan
// loops (largesteps_tpu/core/banded.py:_solve_blocks), ported first as a
// Python loop of 3·nb library products, one (B × B)·(B × k) each: 642
// launches a solve at nefertiti's B = 768, nb = 214, run twice a step.
//
// Bound on the H100: bytes.  The sweeps read L twice and inv(D′) once:
// 3·nb·B²·4 bytes, 1.51 GB a solve at nefertiti, 0.45 ms at 3.35 TB/s
// (2.3 GFLOP, 0.03 ms at 67 TFLOP/s).  But 2·(nb−1) of the steps form one
// serial chain, each waiting for the whole B × k vector of the step before.
//
// Design: one block of 384 threads an SM, all resident (cooperative
// launch), so a block may wait for another's results.
// - The chain's matrices do not depend on the carry.  Block g < NS holds
//   strip g of every Lᵢ: U rows in the forward sweep, U columns in the
//   backward one (U a multiple of 4, NS = B / U strips, U·B floats either
//   way).  It copies its strips into a ring of S stages of shared memory
//   with cp.async; a step refills the slot its predecessor read before it
//   waits for its carry, so the copies are issued, and in flight, while
//   the block waits.
// - A result travels with its tag in one 8-byte word (the step that wrote
//   it), stored and loaded whole.  A step waits by polling the carry's
//   words in L2 until each carries its tag: no grid barrier, no fence, and
//   the wait ends with the data in hand.  A step's serial path is the
//   producer's stores reaching L2, one poll, and dot products from shared
//   memory.
// - The z products do not depend on each other: every block takes a share
//   of the nb·NS row strips of inv(D′) through the same ring, each as soon
//   as its yᵢ is tagged; the blocks without a strip take the early blocks'
//   items, larger shares, while the forward sweep runs.  The backward chain
//   then holds one product a step.  Lᵀ is read as column strips of L, no
//   transposed copy.
// - b is read through perm (zero past n) and each x row written through
//   perm as it is made: the solve is one launch (and the scratch's memset).
//
// Fixed order (two launches give the same bits, whatever the grid): every
// dot of length B is summed as lane l of a warp sums terms 32·t + l, t
// running through a quarter of 0 .. B/32 − 1, a butterfly of shuffles adds
// the 32 lanes, and the four quarters are added in order.  Each output is
// written by one thread; there are no float atomics.  core/banded.py's
// banded_sweep_plain repeats this order operation for operation (the
// library is built with -fmad=false).  Full float32, no TF32.
#include "common.cuh"

namespace {

constexpr int THREADS = 384;
constexpr int WARPS = THREADS / 32;
constexpr int PARTS = 4;                 // quarters of a dot's lane sums
constexpr int MAX_STAGES = 8;
constexpr int MAX_B = 2048;
constexpr int MAX_K = 4;
// pairs of words of a carry vector a thread loads, at most
constexpr int CARRY2 = (MAX_B * MAX_K / 2 + THREADS - 1) / THREADS;
// z items a block without a strip takes for one a strip's block takes
constexpr long long Z_WEIGHT = 3;

struct Sweep {
  const float* invD;
  const float* L;
  const float* b;
  const long long* perm;
  float* out;
  unsigned long long* y;    // (nb, B, k) tagged words: yᵢ
  unsigned long long* xz;   // (nb, B, k) tagged words: zᵢ, then xᵢ
  int n, B, nb;
  int U;     // rows (forward, z) or columns (backward) of a block's strip
  int NS;    // strips a block: ceil(B / U)
  int S;     // stages of the ring
};

// This block's stages, in the order it consumes them: nF forward strips,
// nZ row strips of inv(D′) from item q0 (item q: block q / NS, strip
// q % NS), nX backward strips.
struct Plan {
  int nF, nZ, nX;
  long long q0;
};

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most S − 1 of this thread's copy groups are in flight:
// the oldest, the stage about to be read, has landed.
__device__ __forceinline__ void wait_stage(int S) {
  switch (S) {
    case 1: wait_n<0>(); break;
    case 2: wait_n<1>(); break;
    case 3: wait_n<2>(); break;
    case 4: wait_n<3>(); break;
    case 5: wait_n<4>(); break;
    case 6: wait_n<5>(); break;
    case 7: wait_n<6>(); break;
    default: wait_n<7>(); break;
  }
}

// A value travels with its tag in one 8-byte word (tag in the high half),
// stored and loaded whole: a reader that sees the tag it waits for sees
// the value written with it, with no fence and no barrier.
__device__ __forceinline__ void put(unsigned long long* p, float v,
                                    unsigned tag) {
  const unsigned long long w =
      ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.volatile.global.u64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ ulonglong2 get2(const unsigned long long* p) {
  ulonglong2 r;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(r.x), "=l"(r.y)
               : "l"(p)
               : "memory");
  return r;
}

__device__ __forceinline__ bool tagged(unsigned long long w, unsigned tag) {
  return (unsigned)(w >> 32) == tag;
}

__device__ __forceinline__ float value(unsigned long long w) {
  return __uint_as_float((unsigned)w);
}

__device__ __forceinline__ unsigned long long get1(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.volatile.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

// The value of word w, loaded from p earlier, once p carries `tag`.
__device__ __forceinline__ float take(const unsigned long long* p,
                                      unsigned long long w, unsigned tag) {
  while (!tagged(w, tag)) {
    __nanosleep(32);
    w = get1(p);
  }
  return value(w);
}

// Thread 0 polls one word until it carries `tag`, backing off from 32 ns
// to 1 µs, so that a block that waits long (a z item of a late block)
// polls L2 seldom; the block then goes on.
__device__ __forceinline__ void wait_word(const unsigned long long* p,
                                          unsigned tag) {
  if (threadIdx.x == 0) {
    unsigned ns = 32;
    while (!tagged(get1(p), tag)) {
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
  }
  __syncthreads();
}

// Copy stage m of this block's plan into its ring slot; one commit group a
// call, empty past the plan's end.
__device__ void issue(const Sweep& a, const Plan& p, float* ring, int m) {
  const int nT = p.nF + p.nZ + p.nX;
  if (m < nT) {
    const int B = a.B, U = a.U;
    const size_t BB = (size_t)B * B;
    float* dst = ring + (size_t)(m % a.S) * U * B;
    if (m >= p.nF && m < p.nF + p.nZ) {
      // z pass: U rows of inv(D′ᵢ), contiguous
      const long long q = p.q0 + (m - p.nF);
      const int i = (int)(q / a.NS), s = (int)(q % a.NS);
      const int rows = min(U, B - s * U);
      const float* src = a.invD + i * BB + (size_t)s * U * B;
      for (int e = threadIdx.x; e < rows * B / 4; e += THREADS)
        cp16(dst + 4 * e, src + 4 * e);
    } else if (m < p.nF) {
      // forward step i = m + 1: rows g·U .. of Lᵢ, contiguous
      const int g = blockIdx.x, rows = min(U, B - g * U);
      const float* src = a.L + (size_t)(m + 1) * BB + (size_t)g * U * B;
      for (int e = threadIdx.x; e < rows * B / 4; e += THREADS)
        cp16(dst + 4 * e, src + 4 * e);
    } else {
      // backward step i = nb − 2 − (m − nF − nZ): columns g·U .. of Lᵢ₊₁,
      // stored as U/4 groups of 4 columns, each group B float4 in row order
      const int i = a.nb - 2 - (m - p.nF - p.nZ);
      const int g = blockIdx.x, v4 = min(U, B - g * U) / 4;
      const float* src = a.L + (size_t)(i + 1) * BB + (size_t)g * U;
      for (int e = threadIdx.x; e < B * v4; e += THREADS) {
        const int r = e / v4, v = e - r * v4;
        cp16(dst + 4 * ((size_t)v * B + r), src + (size_t)r * B + 4 * v);
      }
    }
  }
  commit();
}

// The B × K vector at src (row-major tagged words) into shared memory as K
// rows of B, once every word carries `tag`.
template <int K>
__device__ __forceinline__ void wait_carry(float* vs,
                                           const unsigned long long* src,
                                           int B, unsigned tag) {
  const int n2 = B * K / 2;
  ulonglong2 v[CARRY2];
#pragma unroll
  for (int j = 0; j < CARRY2; ++j) {
    const int e = threadIdx.x + j * THREADS;
    if (e < n2) v[j] = get2(src + 2 * e);
  }
  for (;;) {
    bool ready = true;
#pragma unroll
    for (int j = 0; j < CARRY2; ++j) {
      const int e = threadIdx.x + j * THREADS;
      if (e < n2 && !(tagged(v[j].x, tag) && tagged(v[j].y, tag)))
        ready = false;
    }
    if (ready) break;
    __nanosleep(32);
#pragma unroll
    for (int j = 0; j < CARRY2; ++j) {
      const int e = threadIdx.x + j * THREADS;
      if (e < n2 && !(tagged(v[j].x, tag) && tagged(v[j].y, tag)))
        v[j] = get2(src + 2 * e);
    }
  }
#pragma unroll
  for (int j = 0; j < CARRY2; ++j) {
    const int e = threadIdx.x + j * THREADS;
    if (e < n2) {
      const unsigned long long w[2] = {v[j].x, v[j].y};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = 2 * e + q, r = f / K, c = f - r * K;
        vs[c * B + r] = value(w[q]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void butterfly(float (&s)[N]) {
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1)
#pragma unroll
    for (int c = 0; c < N; ++c)
      s[c] = s[c] + __shfl_xor_sync(ls::FULL, s[c], w);
}

// Quarter sums of the dots of `rows` rows of the stage (row-major, B
// floats a row) with the K vectors vs: part[(h·U + row)·K + c].
template <int K>
__device__ __forceinline__ void row_parts(const float* st, int rows,
                                          const float* vs, float* part, int B,
                                          int U) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T4 = B / 128;
  for (int task = warp; task < rows * PARTS; task += WARPS) {
    const int row = task / PARTS, h = task - row * PARTS;
    const float* a = st + (size_t)row * B;
    float s[K];
#pragma unroll
    for (int c = 0; c < K; ++c) s[c] = 0.0f;
#pragma unroll 4
    for (int t = h * T4; t < (h + 1) * T4; ++t) {
      const int j = 32 * t + lane;
      const float w = a[j];
#pragma unroll
      for (int c = 0; c < K; ++c) s[c] = s[c] + w * vs[c * B + j];
    }
    butterfly(s);
    if (lane == 0)
#pragma unroll
      for (int c = 0; c < K; ++c) part[(h * U + row) * K + c] = s[c];
  }
}

// Quarter sums of the dots of `cols` columns of the stage (groups of 4
// columns, B float4 each in row order) with the K vectors vs.
template <int K>
__device__ __forceinline__ void col_parts(const float* st, int cols,
                                          const float* vs, float* part, int B,
                                          int U) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T4 = B / 128;
  const float4* a4 = reinterpret_cast<const float4*>(st);
  for (int task = warp; task < cols / 4 * PARTS; task += WARPS) {
    const int v = task / PARTS, h = task - v * PARTS;
    float s[4 * K];
#pragma unroll
    for (int c = 0; c < 4 * K; ++c) s[c] = 0.0f;
#pragma unroll 4
    for (int t = h * T4; t < (h + 1) * T4; ++t) {
      const int r = 32 * t + lane;
      const float4 w4 = a4[(size_t)v * B + r];
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float xv = vs[c * B + r];
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q * K + c] = s[q * K + c] + w[q] * xv;
      }
    }
    butterfly(s);
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < K; ++c)
          part[(h * U + 4 * v + q) * K + c] = s[q * K + c];
  }
}

// The four quarters of output o (o = row or column · K + c), in order.
__device__ __forceinline__ float quarters(const float* part, int o, int UK) {
  return ((part[o] + part[UK + o]) + part[2 * UK + o]) + part[3 * UK + o];
}

// The z items (nb·NS row strips of inv(D′), item q: block q / NS, strip
// q % NS) that block g takes, [first, last): blocks without a strip (g ≥
// NS, idle in the sweeps) come first in the order and take Z_WEIGHT shares
// each, so that they work through the early blocks' items while the
// forward sweep runs.
__device__ __forceinline__ void z_items(int g, int G, int NS, long long Q,
                                        long long& first, long long& last) {
  const long long idle = G - NS, total = Z_WEIGHT * idle + NS;
  const long long pos = g >= NS ? Z_WEIGHT * (g - NS) : Z_WEIGHT * idle + g;
  first = Q * pos / total;
  last = Q * (pos + (g >= NS ? Z_WEIGHT : 1)) / total;
}

template <int K>
__global__ void __launch_bounds__(THREADS, 1) banded_sweep_kernel(Sweep a) {
  extern __shared__ float4 smem4[];
  const int B = a.B, U = a.U, nb = a.nb, UK = a.U * K;
  float* ring = reinterpret_cast<float*>(smem4);
  float* vs = ring + (size_t)a.S * U * B;
  float* part = vs + K * B;
  const int g = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const size_t BK = (size_t)B * K;
  // this block's strip in the sweeps (0 if it has none)
  const int own = g < a.NS ? min(U, B - g * U) : 0;
  const bool out_thread = tid < own * K;
  Plan p;
  p.nF = p.nX = own ? nb - 1 : 0;
  long long q1;
  z_items(g, G, a.NS, (long long)nb * a.NS, p.q0, q1);
  p.nZ = (int)(q1 - p.q0);
  for (int m = 0; m < a.S; ++m) issue(a, p, ring, m);
  // Step m (its stage m) refills the slot that step m − 1 read with stage
  // m − 1 + S before it waits for its carry, so the copy's issue overlaps
  // the wait.
  auto refill = [&](int m) {
    if (m > 0) issue(a, p, ring, m - 1 + a.S);
  };
  // perm of row r of block i of this block's strip (−1 past n)
  auto perm_of = [&](int i) -> long long {
    const size_t row = i * (size_t)B + (size_t)g * U + tid / K;
    return i < nb && row < (size_t)a.n ? a.perm[row] : -1;
  };
  auto rhs = [&](long long pr) {
    return pr >= 0 ? a.b[pr * K + tid % K] : 0.0f;
  };

  // forward: y₀ = b₀, yᵢ = bᵢ − Lᵢ·yᵢ₋₁ (tag i + 1).  Each out thread
  // loads bᵢ₊₁ and the perm entry of step i + 2 a step ahead.
  float b_next = 0.0f;
  long long p_next = -1;
  if (out_thread) {
    put(a.y + (size_t)g * UK + tid, rhs(perm_of(0)), 1u);
    b_next = rhs(perm_of(1));
    p_next = perm_of(2);
  }
  int m = 0;
  for (int i = 1; i < nb && own; ++i) {
    const float base = b_next;
    refill(m);
    wait_carry<K>(vs, a.y + (i - 1) * BK, B, (unsigned)i);
    wait_stage(a.S);
    __syncthreads();
    row_parts<K>(ring + (size_t)(m % a.S) * U * B, own, vs, part, B, U);
    __syncthreads();
    ++m;
    if (out_thread) {
      put(a.y + (i * (size_t)B + (size_t)g * U) * K + tid,
          base - quarters(part, tid, UK), (unsigned)i + 1);
      b_next = rhs(p_next);
      p_next = perm_of(i + 2);
    }
  }

  // zᵢ = inv(D′ᵢ)·yᵢ (tag i + 1); z_{nb−1} is x_{nb−1}: out at once
  int cur = -1;
  for (int z = 0; z < p.nZ; ++z) {
    const long long q = p.q0 + z;
    const int i = (int)(q / a.NS), s = (int)(q % a.NS);
    const int rows = min(U, B - s * U);
    const size_t row = i * (size_t)B + (size_t)s * U + tid / K;
    long long to = -1;
    if (i == nb - 1 && tid < rows * K && row < (size_t)a.n)
      to = a.perm[row] * K + tid % K;
    refill(m);
    if (i != cur) {
      wait_word(a.y + (i + 1) * BK - 1, (unsigned)i + 1);
      wait_carry<K>(vs, a.y + i * BK, B, (unsigned)i + 1);
      cur = i;
    }
    wait_stage(a.S);
    __syncthreads();
    row_parts<K>(ring + (size_t)(m % a.S) * U * B, rows, vs, part, B, U);
    __syncthreads();
    ++m;
    if (tid < rows * K) {
      const float zv = quarters(part, tid, UK);
      put(a.xz + (i * (size_t)B + (size_t)s * U) * K + tid, zv,
          (unsigned)i + 1);
      if (to >= 0) a.out[to] = zv;
    }
  }

  // backward: xᵢ = zᵢ − Lᵢ₊₁ᵀ·xᵢ₊₁ (tag nb + i + 1, over zᵢ's word).  Each
  // out thread loads zᵢ₋₁'s word and its perm entry a step ahead.
  auto word_at = [&](int i) {
    return a.xz + (i * (size_t)B + (size_t)g * U) * K + tid;
  };
  unsigned long long z_next = 0;
  long long to_next = -1;
  if (out_thread && nb > 1 && own) {
    z_next = get1(word_at(nb - 2));
    to_next = perm_of(nb - 2);
  }
  for (int i = nb - 2; i >= 0 && own; --i) {
    float base = 0.0f;
    const long long to = to_next;
    refill(m);
    if (out_thread) base = take(word_at(i), z_next, (unsigned)i + 1);
    wait_carry<K>(vs, a.xz + (i + 1) * BK, B,
                  (unsigned)(i + 1 == nb - 1 ? nb : nb + i + 2));
    wait_stage(a.S);
    __syncthreads();
    col_parts<K>(ring + (size_t)(m % a.S) * U * B, own, vs, part, B, U);
    __syncthreads();
    ++m;
    if (out_thread) {
      const float xv = base - quarters(part, tid, UK);
      put(word_at(i), xv, (unsigned)(nb + i + 1));
      if (to >= 0) a.out[to * K + tid % K] = xv;
      if (i > 0) {
        z_next = get1(word_at(i - 1));
        to_next = perm_of(i - 1);
      }
    }
  }
}

// The launch plan at (B, k): {blocks, threads, U, NS, stages, dynamic
// shared bytes, blocks an SM holds}; blocks 0 where (B, k) is out of range.
template <int K>
void plan_for(int B, long long* out) {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      optin = 227 * 1024;
  }
  const int G = ls::sm_count();
  const int w = ((B + G - 1) / G + 3) / 4 * 4;
  const int U = w > 4 ? w : 4;
  const size_t fixed = ((size_t)K * B + (size_t)PARTS * U * K) * 4;
  const size_t stage = (size_t)U * B * 4;
  long long S = fixed < (size_t)optin ? (optin - fixed) / stage : 0;
  if (S > MAX_STAGES) S = MAX_STAGES;
  const size_t smem = fixed + S * stage;
  out[0] = S > 0 && U * K <= THREADS ? G : 0;
  out[1] = THREADS;
  out[2] = U;
  out[3] = (B + U - 1) / U;
  out[4] = S;
  out[5] = (long long)smem;
  out[6] = S > 0 ? ls::resident<banded_sweep_kernel<K>>(THREADS, smem) : 0;
}

template <int K>
int launch(const Sweep& base, unsigned long long* scratch,
           cudaStream_t stream) {
  long long pl[7];
  plan_for<K>(base.B, pl);
  if (pl[0] == 0) return (int)cudaErrorInvalidValue;
  Sweep a = base;
  a.U = (int)pl[2];
  a.NS = (int)pl[3];
  a.S = (int)pl[4];
  const size_t smem = (size_t)pl[5];
  cudaError_t e = ls::smem_opt_in<banded_sweep_kernel<K>>(smem, 0);
  if (e != cudaSuccess) return (int)e;
  // every tag 0: nothing written yet
  e = cudaMemsetAsync(scratch, 0, 2 * (size_t)a.nb * a.B * K * 8, stream);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)banded_sweep_kernel<K>,
                                  dim3((unsigned)pl[0]), dim3(THREADS), args,
                                  smem, stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" void ls_banded_sweep_plan(int B, int k, long long* out) {
  for (int j = 0; j < 7; ++j) out[j] = 0;
  if (B < 128 || B > MAX_B || B % 128 != 0) return;
  switch (k) {
    case 1: plan_for<1>(B, out); break;
    case 2: plan_for<2>(B, out); break;
    case 3: plan_for<3>(B, out); break;
    case 4: plan_for<4>(B, out); break;
    default: break;
  }
}

// scratch: 2·nb·B·k 8-byte words (y, then z and x).
extern "C" int ls_banded_sweep(const float* invD, const float* L,
                               const float* b, const long long* perm,
                               float* out, unsigned long long* scratch, int n,
                               int B, int nb, int k, void* stream) {
  if (B < 128 || B > MAX_B || B % 128 != 0 || nb < 1 || n < 1 ||
      (long long)n > (long long)nb * B)
    return (int)cudaErrorInvalidValue;
  Sweep a{};
  a.invD = invD;
  a.L = L;
  a.b = b;
  a.perm = perm;
  a.out = out;
  a.y = scratch;
  a.xz = scratch + (size_t)nb * B * k;
  a.n = n;
  a.B = B;
  a.nb = nb;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch<1>(a, scratch, s);
    case 2: return launch<2>(a, scratch, s);
    case 3: return launch<3>(a, scratch, s);
    case 4: return launch<4>(a, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
