// probe_tile: one 32x128 tile's owner gather and per-slot sums, for a batch
// of B tiles.
//
//   fields[b, r, p] = recT[b, r, slot[b, p]]   (0 where slot[b, p] names no
//                                               column of recT)
//   S[b, c, i]      = sum over p with slot[b, p] == c of g0[b, p] * (i + 1)
//
// slot (B, 32, 128) float holding integral values in -1..cap-1 (p = row *
// 128 + column), recT (B, 32, cap), g0 (B, 32, 128) → fields (B, 32, 4096),
// S (B, cap, 18), all float32, every pointer 16-byte aligned.  A slot s
// names column c only if s == (float)c and 0 <= c < cap, exactly when the
// one-hot of the TPU kernel matches.
//
// Replaces: benchmarks/probe_mosaic.py, kernel (the TPU probe builds the
// (cap, 4096) one-hot of the slot plane in VMEM, gathers with recT @ onehot
// and reduces with onehot @ g^T on the MXU, one tile a call).
//
// Bound on the H100: bytes, and most of them are stores.  A tile reads
// 32 * cap record floats and two planes of 4,096 and writes 32 * 4,096
// fields and cap * 18 sums: at cap 768, 512 KB of its 693 KB are fields.
// The gather is one shared-memory read a field and the sums 18 adds a
// pixel, far below the card's rates.
//
// What held the first design back (PERF.md): the per-slot sums.
// One block of 1,024 threads a tile added each run of equal slots into a
// shared (cap, 18) table with float atomicAdd, which shared memory runs as
// a compare-and-swap loop, so one tile's sums took some 50 us of latency;
// and one 151 KB block an SM ran its record load, field stores and sums
// one after another, in 1.58 waves at 208 tiles.
//
// Design: a tile's work is B sums items and 4 B field items, walked by a
// persistent grid of resident 256-thread blocks (two an SM at cap 768),
// block k taking items k, k + gridDim.x, ...  The sums items come first,
// as the longest.
// - A field item writes 8 of the tile's 32 field rows.  Its 8 record rows
//   (24 KB at cap 768) arrive by one bulk copy (cp.async.bulk, completing
//   on an mbarrier) into one of two buffers, issued one item ahead, so the
//   copy runs under the previous item's stores.  A thread turns its 16
//   pixels' slots into columns once and writes four neighbouring pixels
//   as one 16-byte streaming store (st.global.cs: never read again here).
// - A sums item is a counting sort of the tile's pixels by slot with no
//   float atomics (sums_block, below); its sums go out as whole lines.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int P = ls::TILE_H * ls::TILE_W;   // pixels a tile
constexpr int NS = 18;                       // sums a slot
constexpr int ROWS = 8;                      // field rows a field item
constexpr int GROUPS = 32 / ROWS;            // field items a tile
constexpr int QUADS = P / 4 / THREADS;       // float4 of pixels a thread
constexpr int WARPS = THREADS / 32;
constexpr int SUM_STEPS = P / 32 / WARPS;    // 32-pixel steps a warp
constexpr int SMALL = 32;                    // a bucket one thread sums
constexpr int CHUNK = P / NS / 32 * 32;      // slots of S staged a pass
static_assert(QUADS * 4 * THREADS == P, "threads span the tile");
static_assert(SUM_STEPS * 32 * WARPS == P, "warps span the tile");

// the column of recT that slot value s names, or -1
__device__ __forceinline__ int slot_column(float s, int cap) {
  if (!(s >= 0.0f && s < (float)cap)) return -1;
  const int c = (int)s;
  return (float)c == s ? c : -1;
}

// The columns that the slots of this thread's 16 pixels name; pixel 4 *
// (threadIdx.x + q * THREADS) + j is col[q][j].
struct Cols {
  int c[QUADS][4];
};

__device__ __forceinline__ void load_slots(const float* __restrict__ slot,
                                           int b, float4 (&s)[QUADS]) {
  const float4* s4 = reinterpret_cast<const float4*>(slot + (size_t)b * P);
#pragma unroll
  for (int q = 0; q < QUADS; ++q) s[q] = s4[threadIdx.x + q * THREADS];
}

__device__ __forceinline__ Cols to_cols(const float4 (&s)[QUADS], int cap) {
  Cols k;
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    k.c[q][0] = slot_column(s[q].x, cap);
    k.c[q][1] = slot_column(s[q].y, cap);
    k.c[q][2] = slot_column(s[q].z, cap);
    k.c[q][3] = slot_column(s[q].w, cap);
  }
  return k;
}

// Writes field rows g * ROWS .. + ROWS - 1 of tile b from the staged rows
// `rec` (ROWS, cap).
__device__ __forceinline__ void store_fields(float* __restrict__ fields,
                                             const float* rec, const Cols& k,
                                             int b, int g, int cap) {
  float4* f4 = reinterpret_cast<float4*>(
      fields + ((size_t)b * 32 + (size_t)g * ROWS) * P);
#pragma unroll 2
  for (int r = 0; r < ROWS; ++r) {
    const float* rr = rec + r * cap;
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      const int* c = k.c[q];
      const float4 v = make_float4(c[0] >= 0 ? rr[c[0]] : 0.0f,
                                   c[1] >= 0 ? rr[c[1]] : 0.0f,
                                   c[2] >= 0 ? rr[c[2]] : 0.0f,
                                   c[3] >= 0 ? rr[c[3]] : 0.0f);
      __stcs(f4 + (size_t)r * (P / 4) + threadIdx.x + q * THREADS, v);
    }
  }
}

// Shared bytes the sums item takes: each slot's count and start, each
// pixel's rank in its slot's bucket, the bucketed g0 values.
__host__ __device__ __forceinline__ size_t sums_smem(int cap) {
  return ((size_t)2 * cap + 2 * P) * sizeof(float);
}

// Exclusive prefix sum of a[0..n) into out[0..n) by the block's THREADS
// threads, each taking a contiguous run of ceil(n / THREADS) entries.
__device__ __forceinline__ void block_scan(const int* a, int* out, int n,
                                           int* warp_tot) {
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(ls::FULL, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  int run = base + incl - sum;
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run += a[i];
  }
}

// The sums item of tile b, without float atomics: a counting sort of the
// tile's pixels by slot, then each slot's 18 sums in bucket order.
// 1. Warp w takes pixels w * 512 .. + 511, 32 a step, a lane a pixel; each
//    run of lanes on one slot takes its ranks in the slot's bucket with
//    one shared integer add (native, where a float add is a CAS loop).
// 2. An exclusive scan of the counts gives each bucket's start.
// 3. Each pixel's g0 goes to its place in the buckets.
// 4. Thread c sums bucket c into S[b, c, 0..17] (zeros for an empty one),
//    the plain version's products g0 * (i + 1) added in bucket order; a
//    bucket of more than SMALL pixels goes to a warp, its lanes striding
//    over it with compensated (Kahan) sums and a shuffle tree adding
//    theirs: fewer steps in a row, and a bucket of thousands of pixels
//    keeps the rounding of a short sum.  The sums go out CHUNK slots at a
//    time, staged in the ranks' space, as whole lines.
__device__ __forceinline__ void sums_block(const float* __restrict__ slot,
                                           const float* __restrict__ g0,
                                           float* __restrict__ S, float* sm,
                                           int b, int cap) {
  int* count = reinterpret_cast<int*>(sm);       // (cap)
  int* start = count + cap;                      // (cap)
  int* rank = start + cap;                       // (P)
  float* bucket = reinterpret_cast<float*>(rank + P);   // (P)
  __shared__ int warp_tot[WARPS];
  for (int i = threadIdx.x; i < cap; i += THREADS) count[i] = 0;
  const int lane = threadIdx.x & 31;
  const int p0 = (threadIdx.x >> 5) * (SUM_STEPS * 32) + lane;
  const float* sb = slot + (size_t)b * P;
  float sv[SUM_STEPS];
#pragma unroll
  for (int k = 0; k < SUM_STEPS; ++k) sv[k] = sb[p0 + 32 * k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SUM_STEPS; ++k) {
    const int s = slot_column(sv[k], cap);
    const int prev = __shfl_up_sync(ls::FULL, s, 1);
    const int next = __shfl_down_sync(ls::FULL, s, 1);
    const bool head = lane == 0 || prev != s;
    const unsigned heads = __ballot_sync(ls::FULL, head);
    const unsigned ends = __ballot_sync(ls::FULL, lane == 31 || next != s);
    const int len = __ffs(ends >> lane);         // from a head to its end
    int r = head && s >= 0 ? atomicAdd(count + s, len) : 0;
    const int first = 31 - __clz(heads & (ls::FULL >> (31 - lane)));
    r = __shfl_sync(ls::FULL, r, first) + lane - first;
    if (s >= 0) rank[p0 + 32 * k] = r;
  }
  __syncthreads();
  block_scan(count, start, cap, warp_tot);
  __syncthreads();
  const float* gb = g0 + (size_t)b * P;
#pragma unroll
  for (int k = 0; k < SUM_STEPS; ++k) {
    const int p = p0 + 32 * k;
    const int s = slot_column(sv[k], cap);
    if (s >= 0) bucket[start[s] + rank[p]] = gb[p];
  }
  __syncthreads();
  // S goes out CHUNK slots at a time through the ranks' space, so that
  // its stores are whole lines
  float* out = S + (size_t)b * cap * NS;
  float* tab = reinterpret_cast<float*>(rank);
  for (int c0 = 0; c0 < cap; c0 += CHUNK) {
    const int n = min(CHUNK, cap - c0);
    for (int t = threadIdx.x; t < n; t += THREADS) {
      const int lo = start[c0 + t], hi = lo + count[c0 + t];
      if (hi - lo > SMALL) continue;           // a warp's, below
      float G[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) G[i] = 0.0f;
      for (int k = lo; k < hi; ++k) {
        const float v = bucket[k];
#pragma unroll
        for (int i = 0; i < NS; ++i) G[i] += v * (float)(i + 1);
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) tab[t * NS + i] = G[i];
    }
    // the larger buckets: a warp each, lanes striding with compensated
    // sums, then a shuffle tree; nine sums a pass
    for (int t = threadIdx.x >> 5; t < n; t += WARPS) {
      const int lo = start[c0 + t], hi = lo + count[c0 + t];
      if (hi - lo <= SMALL) continue;          // the same in every lane
#pragma unroll 1
      for (int h = 0; h < NS; h += NS / 2) {
        float G[NS / 2], E[NS / 2];
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) G[i] = E[i] = 0.0f;
        for (int k = lo + lane; k < hi; k += 32) {
          const float v = bucket[k];
#pragma unroll
          for (int i = 0; i < NS / 2; ++i) {   // Kahan: E the lost part
            const float y = v * (float)(h + i + 1) - E[i];
            const float u = G[i] + y;
            E[i] = (u - G[i]) - y;
            G[i] = u;
          }
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
          for (int i = 0; i < NS / 2; ++i)
            G[i] += __shfl_xor_sync(ls::FULL, G[i], d);
        }
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < NS / 2; ++i) tab[t * NS + h + i] = G[i];
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * NS; i += THREADS)
      __stcs(out + (size_t)c0 * NS + i, tab[i]);
    __syncthreads();
  }
}

// The bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on mbarrier `bar`, issued by
// one thread; and the wait for a barrier's phase of parity `parity`.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Dynamic shared memory a block takes: two buffers of 8 record rows, and
// the sums item's counts, starts, ranks and buckets.
__host__ __device__ __forceinline__ size_t smem_bytes(int cap) {
  return (size_t)2 * ROWS * cap * sizeof(float) + sums_smem(cap);
}

// Work item i of B tiles: i < B the sums of tile i; then tile (i - B) /
// GROUPS's field rows of group (i - B) % GROUPS.
__device__ __forceinline__ int tile_of(int i, int B) {
  return i < B ? i : (i - B) / GROUPS;
}
__device__ __forceinline__ int group_of(int i, int B) {
  return (i - B) % GROUPS;
}

// Items first .. first + n - 1 (ls_probe_tile: all 5 B; kernel_probe.py
// also times the sums items and the field items alone).
__global__ void __launch_bounds__(THREADS)
probe_tile_kernel(const float* __restrict__ slot,
                  const float* __restrict__ recT,
                  const float* __restrict__ g0, float* __restrict__ fields,
                  float* __restrict__ S, int B, int cap, int first, int n) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) unsigned long long bar[2];
  float* slabs = reinterpret_cast<float*>(smem4);   // two of ROWS * cap
  float* sums = slabs + 2 * ROWS * cap;
  const unsigned bytes = ROWS * cap * sizeof(float);
  auto rows_of = [&](int i) {
    return recT + ((size_t)tile_of(i, B) * 32 + (size_t)group_of(i, B) * ROWS)
                  * cap;
  };
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
        smem_addr(&bar[0])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
        smem_addr(&bar[1])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int end = first + n;
  int buf = 0;
  unsigned phases = 0u;              // bit k: the parity buffer k waits on
  const int i0 = first + blockIdx.x;
  if (threadIdx.x == 0 && i0 < end && i0 >= B)
    bulk_load(slabs, rows_of(i0), bytes, &bar[0]);
  for (int i = i0; i < end; i += gridDim.x, buf ^= 1) {
    const int next = i + gridDim.x;
    if (threadIdx.x == 0 && next < end && next >= B)
      bulk_load(slabs + (buf ^ 1) * ROWS * cap, rows_of(next), bytes,
                &bar[buf ^ 1]);
    const int b = tile_of(i, B);
    if (i >= B) {
      float4 sl[QUADS];
      load_slots(slot, b, sl);
      const Cols k = to_cols(sl, cap);
      bulk_wait(&bar[buf], (phases >> buf) & 1u);
      phases ^= 1u << buf;
      store_fields(fields, slabs + buf * ROWS * cap, k, b, group_of(i, B),
                   cap);
    } else {
      sums_block(slot, g0, S, sums, b, cap);
    }
    __syncthreads();                 // this buffer and the buckets are free
  }
}

// Blocks of a launch over n items: every resident block, fewer where the
// items run out.
int blocks_for(int n, int cap) {
  const long long full = (long long)ls::sm_count() *
      ls::resident<probe_tile_kernel>(THREADS, smem_bytes(cap));
  return (int)(n < full ? n : full);
}

}  // namespace

// Items first .. first + n - 1 of B tiles (ls_probe_tile: all of them).
extern "C" int ls_probe_tile_items(const float* slot, const float* recT,
                                   const float* g0, float* fields, float* S,
                                   int B, int cap, int first, int n,
                                   void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(cap);
  const cudaError_t e = ls::smem_opt_in<probe_tile_kernel>(smem, 0);
  if (e != cudaSuccess) return (int)e;
  probe_tile_kernel<<<blocks_for(n, cap), THREADS, smem,
                      (cudaStream_t)stream>>>(slot, recT, g0, fields, S, B,
                                              cap, first, n);
  return (int)cudaGetLastError();
}

extern "C" int ls_probe_tile(const float* slot, const float* recT,
                             const float* g0, float* fields, float* S, int B,
                             int cap, void* stream) {
  return ls_probe_tile_items(slot, recT, g0, fields, S, B, cap, 0,
                             B * (GROUPS + 1), stream);
}

// The launch shape of ls_probe_tile at (B, cap): {blocks, threads a block,
// dynamic shared bytes a block, blocks an SM holds, work items}.
extern "C" void ls_probe_tile_grid(int B, int cap, long long* out) {
  const int n = B * (GROUPS + 1);
  out[0] = blocks_for(n, cap);
  out[1] = THREADS;
  out[2] = (long long)smem_bytes(cap);
  out[3] = ls::resident<probe_tile_kernel>(THREADS, smem_bytes(cap));
  out[4] = n;
}
