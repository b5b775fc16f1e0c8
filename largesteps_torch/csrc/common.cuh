// Shared definitions of the four render kernels (see each .cu file's note),
// and the launch helpers of every kernel.
//
// Layouts are the JAX package's: records (C, TY, TX, cap, 32) float32,
// counts (C, TY, TX) int32, planes (C, H, W) float32 with row 0 at the image
// bottom, colours (C, H, W, D), 32x128 pixel tiles.  raster_bwd's blocks
// each work on one (camera, tile): blockIdx.x = (c * TY + ty) * TX + tx.
// The other kernels' blocks each work on one strip of STRIP_H rows of a
// tile: blockIdx.x = tile * STRIPS + strip.
//
// Every expression is written in the operation order of the plain PyTorch
// version in render/kernels.py, and the library is built with -fmad=false,
// so a kernel rounds exactly as its plain version does.
#pragma once

#include <cuda_runtime.h>

namespace ls {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int STRIP_H = 8;
constexpr int STRIPS = TILE_H / STRIP_H;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

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

struct StripBlock {
  int tile, c, ty, tx, strip;
};

__device__ __forceinline__ StripBlock strip_block(int TY, int TX) {
  StripBlock b;
  b.strip = blockIdx.x % STRIPS;
  b.tile = blockIdx.x / STRIPS;
  b.tx = b.tile % TX;
  b.ty = (b.tile / TX) % TY;
  b.c = b.tile / (TX * TY);
  return b;
}

// NDC centre of pixel column col (row) of tile tx (ty); col and row may
// reach one pixel past the tile, the sums stay exact
__device__ __forceinline__ float pixel_x(int tx, int col, float sxs) {
  return (((float)(tx * TILE_W) + (float)col) + 0.5f) * sxs - 1.0f;
}
__device__ __forceinline__ float pixel_y(int ty, int row, float sys) {
  return (((float)(ty * TILE_H) + (float)row) + 0.5f) * sys - 1.0f;
}

// 16 bytes of a 16-byte-aligned float array
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Lets kernel K take `dyn` bytes of dynamic shared memory beside `stat`
// bytes of static.  The opt-in is per kernel and device and costs
// microseconds, so it is made once.
constexpr int DEVICES = 64;    // devices whose opt-in is remembered
template <auto K>
cudaError_t smem_opt_in(size_t dyn, size_t stat) {
  if (dyn + stat <= 48 * 1024) return cudaSuccess;
  static size_t opted[DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= DEVICES || opted[dev] < dyn)) {
    e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
    if (e == cudaSuccess && dev < DEVICES) opted[dev] = dyn;
  }
  return e;
}

// The SMs of the current device, asked once (132 on the H100 SXM).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// Blocks of kernel K that one SM holds at `threads` threads and `smem`
// dynamic shared bytes, after K's opt-in to them; the last answer is kept,
// as callers repeat their shapes.
template <auto K>
int resident(int threads, size_t smem) {
  static size_t last_smem = ~(size_t)0;
  static int last_threads = 0, last = 1;
  if (smem != last_smem || threads != last_threads) {
    int n = 0;
    if (smem_opt_in<K>(smem, 0) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, K, threads, smem) !=
            cudaSuccess || n < 1)
      n = 1;
    last_smem = smem;
    last_threads = threads;
    last = n;
  }
  return last;
}

// ---------------------------------------------------------------------------
// Raster (raster_fwd.cu, raster_bwd.cu)
// ---------------------------------------------------------------------------
// raster_fwd: RF_THREADS threads a strip.  Warp w owns the strip's columns
// RF_BAND * w .. + RF_BAND - 1, all STRIP_H rows; lane l the column
// RF_BAND * w + l % RF_BAND in the RF_ROWS rows from RF_ROWS * (l / RF_BAND).
// Bins are culled RF_CHUNK slots at a time, one a thread.
constexpr int RF_THREADS = 256;
constexpr int RF_BAND = 16;
constexpr int RF_ROWS = 4;
static_assert(RF_BAND * (RF_THREADS / 32) == TILE_W, "warps span the strip");
static_assert(32 / RF_BAND * RF_ROWS == STRIP_H, "lanes span a band");
constexpr int RF_CHUNK = RF_THREADS;
constexpr int RF_FIELDS = 13;      // z-loop's record columns 0-11 and 14
// margin of the cull (rf_misses): relative, absolute, largest
constexpr float RF_EPS = 1e-6f;
constexpr float RF_TINY = 1e-30f;
constexpr float RF_HUGE = 1e30f;

// Whether no pixel centre (x, y) with x0 <= x <= x1 and y0 <= y <= y1 can
// pass the z-test's edge tests q0 >= 0, q1 >= 0, q2 = s - q0 - q1 >= 0, for
// the edge and denominator coefficients r = record columns 0-8.  True only
// if one of q0, q1, q2 is below -e at all four corners, e = RF_EPS * M +
// RF_TINY, M = the sum over q0, q1, s of |a| X + |b| Y + |c|, X = max(|x0|,
// |x1|), Y = max(|y0|, |y1|).
// Why no covered pixel is lost: the pixel centres of a range of columns
// lie between the float centres of its end columns (pixel_x is a chain of
// rounded monotone operations), and each of q0, q1, s is linear in (x, y),
// so its exact value L at any centre is at most its largest corner value.
// A value computed as (a*x + b*y) + c in float differs from L by at most
// 3u (|ax| + |by| + |c|) (u = 2^-24; products that underflow add
// 2^-149), and q2 from s - q0 - q1 by at most about 5u M.  A covered pixel
// thus has exact q2 >= -3e-7 M, so at some corner the computed q2 is
// >= -6e-7 M > -e; likewise q0 and q1.  Non-finite or huge coefficients
// (e not below RF_HUGE, or a NaN corner value) never cull.
__device__ __forceinline__ bool rf_misses(const float (&r)[9], float x0,
                                          float x1, float y0, float y1) {
  const float X = fmaxf(fabsf(x0), fabsf(x1));
  const float Y = fmaxf(fabsf(y0), fabsf(y1));
  const float M = ((fabsf(r[0]) * X + fabsf(r[1]) * Y + fabsf(r[2])) +
                   (fabsf(r[3]) * X + fabsf(r[4]) * Y + fabsf(r[5]))) +
                  (fabsf(r[6]) * X + fabsf(r[7]) * Y + fabsf(r[8]));
  const float e = RF_EPS * M + RF_TINY;
  if (!(e < RF_HUGE)) return false;
  bool out0 = true, out1 = true, out2 = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = k & 1 ? x1 : x0, y = k & 2 ? y1 : y0;
    const float q0 = r[0] * x + r[1] * y + r[2];
    const float q1 = r[3] * x + r[4] * y + r[5];
    const float s = r[6] * x + r[7] * y + r[8];
    const float q2 = s - q0 - q1;
    out0 = out0 && q0 < -e;
    out1 = out1 && q1 < -e;
    out2 = out2 && q2 < -e;
  }
  return out0 || out1 || out2;
}

// raster_bwd: RB_THREADS threads a tile, a warp a row; lane l takes the
// row's pixels l, l + 32, l + 64, l + 96, one step each.
constexpr int RB_THREADS = 32 * TILE_H;
constexpr int RB_STEPS = TILE_W / 32;
constexpr int RB_SUMS = 18;        // per-slot sums, output columns 0-17
// the largest per-slot table kept in shared memory (cap 2,844)
constexpr int RB_TABLE_MAX = 200 * 1024;

// ---------------------------------------------------------------------------
// Antialias (aa_fwd.cu, aa_bwd.cu)
// ---------------------------------------------------------------------------
// One block per (camera, tile, strip).  AA_THREADS threads, neighbouring
// threads on neighbouring columns; each thread takes the pixel of its
// column in rows r and r + AA_ROWS of the strip.
//
// A block works in three phases (aa_collect, then each kernel's own):
// 1. It lists the pixel pairs whose ids differ (about 14 % on the main
//    path) that touch the strip: those anchored in it, and those anchored
//    one pixel left of it or below it that end in it.  Only these run a
//    lookup and an edge test, each once, with every lane of a warp busy.
// 2. Each listed pair's crossing t goes to a shared grid of the strip's
//    anchors, rows -1..STRIP_H-1 by columns -1..TILE_W-1; a pair that
//    does not blend (equal ids, no owner, no crossing) keeps AA_NO_T.
// 3. Each pixel combines its own pairs' and its left and lower neighbours'
//    weights with its colours, in the plain version's order.
constexpr int AA_THREADS = 512;
constexpr int AA_ROWS = AA_THREADS / TILE_W;
static_assert(AA_ROWS * 2 == STRIP_H, "two pixels a thread");
constexpr int AA_CW = TILE_W + 1;                  // columns -1..127
constexpr int AA_CELLS = (STRIP_H + 1) * AA_CW;    // rows -1..7
constexpr int AA_LIST = 2 * STRIP_H * TILE_W + STRIP_H + TILE_W;
constexpr float AA_NO_T = -1.0f;   // a blending pair's t lies in [-0, 1]
// Owner tables: a block looks owners up in its own tile's bin and, for the
// pairs anchored across its left and lower border, in that tile's bin.
// Where three tables of the cap fit AA_HASH_SMEM_MAX bytes, each block
// builds those it needs in shared memory.  Past that (large caps), each
// tile's table lives once in a global scratch buffer that the wrapper
// zeroes, shared by the tile's strips and its right and upper neighbours:
// the first block that needs a table claims it (flag 0 -> 1), builds it and
// publishes it (-> 2); the others wait for it only after publishing every
// table they claimed, so no block waits while holding a claim.
constexpr int AA_TABLES = 3;
constexpr long long AA_HASH_SMEM_MAX = 96 * 1024;
constexpr unsigned long long AA_EMPTY = 0ull;   // no id > 0 has 0 bits

// log2 of an owner table's size: the least power of two >= 2n, at least 32
__host__ __device__ __forceinline__ int aa_table_bits(int n) {
  int bits = 5;
  while ((1 << bits) < 2 * n) ++bits;
  return bits;
}

// Global scratch the owner tables need (0 when they fit shared memory): a
// table of the cap for each tile, then a flag for each (8 bytes, so the
// buffer stays whole 8-byte words).
inline long long aa_scratch_bytes(int tiles, int cap) {
  const long long table = (1ll << aa_table_bits(cap)) * 8;
  return AA_TABLES * table <= AA_HASH_SMEM_MAX ? 0 : tiles * (table + 8);
}

// What both antialias kernels take besides their planes.  Under row shards
// the planes hold H = 32 TY rows of the image from its tile row row0, and
// the halo rows (C, W[, D]) are the next shard's first rows of the id,
// depth, colour and (backward) output-cotangent planes: the down neighbours
// of the last row, which is the image's own last row on the last shard.  A
// vertical pair anchored at the last row writes its share of the
// neighbour's value to `share` (C, W, D), which the caller adds to the next
// shard's row 0; the pair below row 0 is the previous shard's.  Without row
// shards row0 is 0 and the halo pointers are null.
struct AaGrid {
  unsigned long long* tables;   // global owner tables, a tile's each; or null
  int* flags;                   // 0 free, 1 being built, 2 ready
  int TY, TX, cap, ts, H, W;    // ts: entries a table region holds
  float sxs, sys;
  int row0;
  const float *hfid, *hz, *hcol, *hdout;
  float* share;
};

// A pixel of a plane with `ch` values a pixel: the plane and the index.
struct Px {
  const float* p;
  size_t i;
};

// The down neighbour of pixel (c, y, x) of a plane (row 0 the image
// bottom): the next row; past the last row the halo row where there is
// one, else the last row itself (the image's edge replication).
__device__ __forceinline__ Px aa_down(const float* plane, const float* halo,
                                      int c, int y, int x, int H, int W) {
  if (y + 1 < H) return Px{plane, ((size_t)c * H + y + 1) * W + x};
  if (halo != nullptr) return Px{halo, (size_t)c * W + x};
  return Px{plane, ((size_t)c * H + y) * W + x};
}

// Open-addressing hash table, face id -> lowest live slot of one tile's
// bin.  An entry packs (id bits << 32 | slot); AA_EMPTY marks a free one.
// It is at most half full, so every probe ends.
struct OwnerTable {
  unsigned long long* e;   // shared or global memory
  const float* rb;         // the tile's records (cap, 32)
  int bits;
};

__device__ __forceinline__ unsigned aa_home(unsigned key, int bits) {
  return (key * 0x9E3779B1u) >> (32 - bits);     // Fibonacci hashing
}

__device__ __forceinline__ void table_clear(OwnerTable t) {
  for (int i = threadIdx.x; i < (1 << t.bits); i += blockDim.x)
    t.e[i] = AA_EMPTY;
}

// Slot of face id `id` in the table's bin, -1 for id <= 0 or an absent id.
// The volatile load reads the atomics' result past L1 for a global table.
__device__ __forceinline__ int table_find(OwnerTable t, float id) {
  if (!(id > 0.0f)) return -1;
  const unsigned key = __float_as_uint(id);
  const unsigned mask = (1u << t.bits) - 1u;
  for (unsigned h = aa_home(key, t.bits);; h = (h + 1u) & mask) {
    const unsigned long long e =
        *reinterpret_cast<volatile unsigned long long*>(&t.e[h]);
    if (e == AA_EMPTY) return -1;
    if ((unsigned)(e >> 32) == key) return (int)(unsigned)e;
  }
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

// Edge functions of owner edge e (endpoints e, e+1) at the pixel and at its
// neighbour (eb directly at the neighbour, not incrementally from ea), and
// the crossing's denominator, as pallas_core.py:_aa_pair_t computes them.
// fld: sx0 sy0 sx1 sy1 sx2 sy2 opp1 opp2 opp3 of the owner.
struct Edge {
  float ax, ay, bx, by, ex, ey, ea, eb, den;
};

__device__ __forceinline__ Edge aa_edge(const float* fld, int e, float pax,
                                        float pay, float d_ex, float d_ey) {
  Edge g;
  const int e1 = (e + 1) % 3;
  g.ax = fld[2 * e];
  g.ay = fld[2 * e + 1];
  g.bx = fld[2 * e1];
  g.by = fld[2 * e1 + 1];
  g.ex = g.bx - g.ax;
  g.ey = g.by - g.ay;
  g.ea = g.ex * (pay - g.ay) - g.ey * (pax - g.ax);
  g.eb = g.ex * ((pay + d_ey) - g.ay) - g.ey * ((pax + d_ex) - g.ax);
  const float denom = g.ea - g.eb;
  g.den = denom == 0.0f ? 1.0f : denom;
  return g;
}

// Crossing parameter t of one pair direction (pallas_core.py:_aa_pair_t):
// the first owner edge that separates the two pixel centres, within its
// extent, and is a silhouette against `other`.  `take` is that edge, or -1.
__device__ __forceinline__ float aa_pair_t(const float* fld, float pax,
                                           float pay, float d_ex, float d_ey,
                                           float other, int& take) {
  take = -1;
  float best_t = 0.0f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const Edge g = aa_edge(fld, e, pax, pay, d_ex, d_ey);
    const bool separates = (g.ea > 0.0f) != (g.eb > 0.0f);
    const float t = g.ea / g.den;
    const float cx = pax + t * d_ex;
    const float cy = pay + t * d_ey;
    const float along = (cx - g.ax) * g.ex + (cy - g.ay) * g.ey;
    const bool within = (along >= 0.0f) && (along <= g.ex * g.ex + g.ey * g.ey);
    const bool silhouette = (other == 0.0f) || (fld[6 + e] != other);
    if (take < 0 && separates && within && silhouette) {
      take = e;
      best_t = t;
    }
  }
  return best_t;
}

// The owner's edge fields (record columns 9-14, 23-25).
__device__ __forceinline__ void aa_fields(const float* f, float (&fld)[9]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) fld[k] = f[9 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) fld[6 + k] = f[23 + k];
}

// One pixel pair (a, and its neighbour n at NDC offset (d_ex, d_ey)),
// anchored at pixel centre (pax, pay).  Returns whether the pair blends:
// the ids differ, the owner is in the anchor tile's bin (`slot`), and an
// owner edge crosses (`take`, at `t`).
__device__ __forceinline__ bool aa_pair(OwnerTable tab, float fa,
                                        float za, float fn, float zn,
                                        float pax, float pay, float d_ex,
                                        float d_ey, float& t, int& slot,
                                        int& take) {
  float owner, other;
  bool differs;
  aa_common(fa, za, fn, zn, owner, other, differs);
  slot = differs ? table_find(tab, owner) : -1;
  if (slot < 0) return false;
  float fld[9];
  aa_fields(tab.rb + (size_t)slot * 32, fld);
  t = aa_pair_t(fld, pax, pay, d_ex, d_ey, other, take);
  return take >= 0;
}

// Blend weights of a pair: the anchor's share wa (t < 0.5) and the
// neighbour's wb (t >= 0.5).
__device__ __forceinline__ void aa_weights(bool act, float t, float& wa,
                                           float& wb) {
  wa = act && t < 0.5f ? 0.5f - t : 0.0f;
  wb = act && t >= 0.5f ? t - 0.5f : 0.0f;
}

// A pixel's D channels; D = 4 moves as one 16-byte access.
template <int D>
__device__ __forceinline__ void load_px(const float* __restrict__ p, size_t i,
                                        float (&v)[D]) {
  if constexpr (D == 4) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = p[i * D + c];
  }
}

template <int D>
__device__ __forceinline__ void store_px(float* __restrict__ p, size_t i,
                                         const float (&v)[D]) {
  if constexpr (D == 4) {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) p[i * D + c] = v[c];
  }
}

// The block's owner tables: its own tile's always, the left (k = 1) and the
// lower (k = 2) tile's where the strip has such a neighbour.  Only the
// region and the sizes are kept; get(k) rebuilds a table's handle, so none
// is selected through memory.  Table k of tile t starts k * kstride +
// t * tstride entries into the region: shared memory holds the block's
// three tables, the global scratch one table a tile.
struct AaTables {
  unsigned long long* region;
  const float* rec;
  int tile, TX, cap, kstride, tstride, bits0, bits1, bits2;

  __device__ __forceinline__ int tile_of(int k) const {
    return tile - (k == 1 ? 1 : 0) - (k == 2 ? TX : 0);
  }
  __device__ __forceinline__ OwnerTable get(int k) const {
    const int t = tile_of(k);
    return OwnerTable{region + (size_t)k * kstride + (size_t)t * tstride,
                      rec + (size_t)t * cap * 32,
                      k == 0 ? bits0 : (k == 1 ? bits1 : bits2)};
  }
};

// A pair's code in the list: its anchor's cell * 2 + direction (0 right,
// 1 down); cells count rows and columns from -1.
__device__ __forceinline__ int aa_code(int r, int c, int dir) {
  return ((r + 1) * AA_CW + (c + 1)) * 2 + dir;
}

struct AaShared {
  float t[2 * AA_CELLS];            // crossing t by code, or AA_NO_T
  unsigned short list[AA_LIST];     // codes of the pairs whose ids differ
  int count, need;                  // list length; neighbour tables needed
  int mine;                         // tables k this block builds (bit k)
};

// Appends each of a thread's N codes whose flag holds, with one warp scan
// and one shared atomic per warp.  All lanes of the warp must call it.
template <int N>
__device__ __forceinline__ void aa_push(const bool (&pred)[N],
                                        const int (&code)[N], AaShared& sh) {
  const int lane = threadIdx.x & 31;
  int k = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) k += pred[i] ? 1 : 0;
  int incl = k;                          // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += v;
  }
  int base = 0;
  if (lane == 31 && incl > 0) base = atomicAdd(&sh.count, incl);
  int pos = __shfl_sync(FULL, base, 31) + incl - k;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (pred[i]) sh.list[pos++] = (unsigned short)code[i];
}

// Inserts id `id` of slot `s` (skipped for a dead slot); a repeated id
// keeps its lowest slot, as the plain version's first-match search does.
__device__ __forceinline__ void table_insert(OwnerTable t, float id, int s) {
  if (!(id > 0.0f)) return;
  const unsigned mask = (1u << t.bits) - 1u;
  const unsigned key = __float_as_uint(id);
  const unsigned long long v = ((unsigned long long)key << 32) | (unsigned)s;
  for (unsigned h = aa_home(key, t.bits);; h = (h + 1u) & mask) {
    const unsigned long long prev = atomicCAS(&t.e[h], AA_EMPTY, v);
    if (prev == AA_EMPTY) return;
    if ((unsigned)(prev >> 32) == key) {
      atomicMin(&t.e[h], v);
      return;
    }
  }
}

// Fills table t from its bin's n live slots.  The ids of slots threadIdx.x
// and threadIdx.x + blockDim.x were loaded early (id0, id1); the kernel
// reads the rest here.
__device__ __forceinline__ void table_fill(OwnerTable t, int n, float id0,
                                           float id1) {
  const int s0 = threadIdx.x, s1 = threadIdx.x + blockDim.x;
  if (s0 < n) table_insert(t, id0, s0);
  if (s1 < n) table_insert(t, id1, s1);
  for (int s = s1 + blockDim.x; s < n; s += blockDim.x)
    table_insert(t, t.rb[(size_t)s * 32 + 22], s);
}

// The ids of a bin's first two slots of this thread (0 past the cap).
struct IdPair {
  float a, b;
};

__device__ __forceinline__ IdPair early_ids(const float* rb, int cap) {
  const int s0 = threadIdx.x, s1 = threadIdx.x + blockDim.x;
  return IdPair{s0 < cap ? rb[(size_t)s0 * 32 + 22] : 0.0f,
                s1 < cap ? rb[(size_t)s1 * 32 + 22] : 0.0f};
}

// A global owner table's claim (AA_TABLES note), each by one thread: a
// claim holds where no block had claimed tile t's table; a publish follows
// a barrier behind the claimer's fill; a wait returns once it is published.
__device__ __forceinline__ bool aa_claim(int* flags, int t) {
  return atomicCAS(&flags[t], 0, 1) == 0;
}
__device__ __forceinline__ void aa_publish(int* flags, int t) {
  __threadfence();
  atomicExch(&flags[t], 2);
}
__device__ __forceinline__ void aa_wait(const int* flags, int t) {
  while (*reinterpret_cast<const volatile int*>(&flags[t]) != 2)
    __nanosleep(32);
  __threadfence();
}

// Phase 1: marks every pair as not blending, lists the strip's differing
// pairs and makes ready the owner tables the list needs: the own tile's,
// and the left or lower tile's where a listed pair is anchored there.  The
// loads are issued before their first use (the neighbours' ids
// speculatively), so their latencies overlap.  Returns with all of it
// visible to the block; all threads must call it.
__device__ __forceinline__ AaTables aa_collect(
    const float* __restrict__ rec, const int* __restrict__ counts,
    const float* __restrict__ fidp, unsigned long long* smem,
    const AaGrid& g, const StripBlock& b, AaShared& sh) {
  const int TX = g.TX, cap = g.cap, H = g.H, W = g.W;
  const bool global = g.tables != nullptr;
  const bool has_l = b.tx > 0;
  const bool has_b = b.strip == 0 && b.ty > 0;
  const int n0 = min(counts[b.tile], cap);
  const int n1 = has_l ? min(counts[b.tile - 1], cap) : 0;
  const int n2 = has_b ? min(counts[b.tile - TX], cap) : 0;
  const AaTables T{global ? g.tables : smem, rec, b.tile, TX, cap,
                   global ? 0 : g.ts, global ? g.ts : 0, aa_table_bits(n0),
                   aa_table_bits(n1), aa_table_bits(n2)};
  const IdPair i0 = early_ids(T.get(0).rb, cap);
  const IdPair i1 = has_l ? early_ids(T.get(1).rb, cap) : IdPair{0.0f, 0.0f};
  const IdPair i2 = has_b ? early_ids(T.get(2).rb, cap) : IdPair{0.0f, 0.0f};

  // the ids that decide which pairs differ: pixel, right and down neighbour
  // in two rows, the left neighbour, the lower neighbour
  const int c = threadIdx.x % TILE_W;
  const int x = b.tx * TILE_W + c;
  const int r0 = threadIdx.x / TILE_W;
  const int y0 = b.ty * TILE_H + b.strip * STRIP_H + r0;
  float f[2], fr[2], fd[2], fl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int y = y0 + AA_ROWS * i;
    const size_t row = ((size_t)b.c * H + y) * W;
    f[i] = fidp[row + x];
    fr[i] = fidp[row + min(x + 1, W - 1)];
    const Px d = aa_down(fidp, g.hfid, b.c, y, x, H, W);
    fd[i] = d.p[d.i];
    fl[i] = c == 0 && has_l ? fidp[row + x - 1] : f[i];
  }
  const bool low = r0 == 0 && y0 > 0;
  const float fb = low ? fidp[((size_t)b.c * H + y0 - 1) * W + x] : f[0];

  for (int i = threadIdx.x; i < 2 * AA_CELLS; i += blockDim.x)
    sh.t[i] = AA_NO_T;
  if (threadIdx.x == 0) {
    sh.count = sh.need = 0;
    sh.mine = !global || aa_claim(g.flags, b.tile);   // build the own table
  }
  if (!global) table_clear(T.get(0));
  __syncthreads();

  if (sh.mine) table_fill(T.get(0), n0, i0.a, i0.b);
  const int r1 = r0 + AA_ROWS;
  const bool pred[7] = {f[0] != fr[0], f[0] != fd[0], fl[0] != f[0],
                        f[1] != fr[1], f[1] != fd[1], fl[1] != f[1],
                        fb != f[0]};
  const int code[7] = {aa_code(r0, c, 0), aa_code(r0, c, 1),
                       aa_code(r0, -1, 0), aa_code(r1, c, 0),
                       aa_code(r1, c, 1), aa_code(r1, -1, 0),
                       aa_code(-1, c, 1)};
  aa_push(pred, code, sh);
  const int wants = (pred[2] || pred[5] ? 1 : 0) | (pred[6] && has_b ? 2 : 0);
  if (wants) atomicOr(&sh.need, wants);
  __syncthreads();

  const int need = sh.need;    // the same in every thread
  if (global) {
    // publish the own table if built here, claim and build the neighbour
    // tables needed that no block has claimed, publish them, and only then
    // wait for every table the block needs
    if (threadIdx.x == 0) {
      if (sh.mine) aa_publish(g.flags, b.tile);
      sh.mine = ((need & 1) && aa_claim(g.flags, T.tile_of(1)) ? 1 : 0) |
                ((need & 2) && aa_claim(g.flags, T.tile_of(2)) ? 2 : 0);
    }
    __syncthreads();
    const int mine = sh.mine;
    if (mine & 1) table_fill(T.get(1), n1, i1.a, i1.b);
    if (mine & 2) table_fill(T.get(2), n2, i2.a, i2.b);
    __syncthreads();
    if (threadIdx.x == 0) {
      if (mine & 1) aa_publish(g.flags, T.tile_of(1));
      if (mine & 2) aa_publish(g.flags, T.tile_of(2));
      aa_wait(g.flags, b.tile);
      if (need & 1) aa_wait(g.flags, T.tile_of(1));
      if (need & 2) aa_wait(g.flags, T.tile_of(2));
    }
    __syncthreads();
  } else if (need) {
    if (need & 1) table_clear(T.get(1));
    if (need & 2) table_clear(T.get(2));
    __syncthreads();
    if (need & 1) table_fill(T.get(1), n1, i1.a, i1.b);
    if (need & 2) table_fill(T.get(2), n2, i2.a, i2.b);
    __syncthreads();
  }
  return T;
}

// One listed pair, decoded: its anchor (r, c) in the strip, direction, the
// anchor pixel p, the neighbour pixel (pn; in the halo rows at ph where nh),
// the anchor's NDC centre and the owner table of the anchor's tile (1:
// left, 2: lower, 0: this one).
struct AaItem {
  int code, r, c, dir, table;
  bool nh;
  size_t p, pn, ph;
  float pax, pay, d_ex, d_ey;
};

__device__ __forceinline__ AaItem aa_item(int code, const StripBlock& b,
                                          const AaGrid& g) {
  AaItem q;
  q.code = code;
  q.dir = code & 1;
  const int cell = code >> 1;
  q.r = cell / AA_CW - 1;
  q.c = cell % AA_CW - 1;
  q.table = q.c < 0 ? 1 : (q.r < 0 && b.strip == 0 ? 2 : 0);
  const int row = b.strip * STRIP_H + q.r;       // in the tile
  const int y = b.ty * TILE_H + row, x = b.tx * TILE_W + q.c;
  q.p = ((size_t)b.c * g.H + y) * g.W + x;
  // listed pairs differ: no edge pixel, except a down pair of the last row
  // whose neighbour is in the halo row
  q.nh = q.dir && y + 1 == g.H && g.hfid != nullptr;
  q.pn = q.p + (q.dir ? g.W : 1);
  q.ph = (size_t)b.c * g.W + x;
  q.pax = pixel_x(b.tx, q.c, g.sxs);
  q.pay = pixel_y(b.ty + g.row0, row, g.sys);
  q.d_ex = q.dir ? 0.0f : g.sxs;
  q.d_ey = q.dir ? g.sys : 0.0f;
  return q;
}

// The pair's neighbour value in a plane and its halo row.
__device__ __forceinline__ float aa_nb(const float* __restrict__ plane,
                                       const float* halo, const AaItem& q) {
  return q.nh ? halo[q.ph] : plane[q.pn];
}

// The pair's neighbour pixel in a plane of D values a pixel and its halo.
__device__ __forceinline__ Px aa_nb_px(const float* plane, const float* halo,
                                       const AaItem& q) {
  return q.nh ? Px{halo, q.ph} : Px{plane, q.pn};
}

// The blend weights that a pixel (r, c) of the strip combines, from the
// grid of crossings: its own right and down pairs' (h, v), the right pair
// of its left neighbour (l) and the down pair of its lower neighbour (b).
struct AaWeights {
  float wa_h, wb_h, wa_v, wb_v, wa_l, wb_l, wa_b, wb_b;
};

__device__ __forceinline__ AaWeights aa_weights_at(const AaShared& sh, int r,
                                                   int c) {
  AaWeights w;
  float t = sh.t[aa_code(r, c, 0)];
  aa_weights(t != AA_NO_T, t, w.wa_h, w.wb_h);
  t = sh.t[aa_code(r, c, 1)];
  aa_weights(t != AA_NO_T, t, w.wa_v, w.wb_v);
  t = sh.t[aa_code(r, c - 1, 0)];
  aa_weights(t != AA_NO_T, t, w.wa_l, w.wb_l);
  t = sh.t[aa_code(r - 1, c, 1)];
  aa_weights(t != AA_NO_T, t, w.wa_b, w.wb_b);
  return w;
}

// Launches antialias kernel K(planes..., g) over the C views of g's tiles:
// places the owner tables (shared memory, or `scratch`, zeroed, of
// aa_scratch_bytes) and opts K in to the shared memory they take.
template <auto K, typename... Planes>
int aa_launch(AaGrid g, int C, void* scratch, cudaStream_t stream,
              Planes... planes) {
  const int tiles = C * g.TY * g.TX;
  g.ts = 1 << aa_table_bits(g.cap);
  const bool global = aa_scratch_bytes(tiles, g.cap) > 0;
  if (global && scratch == nullptr) return (int)cudaErrorInvalidValue;
  g.tables = global ? static_cast<unsigned long long*>(scratch) : nullptr;
  g.flags = global ? reinterpret_cast<int*>(g.tables + (size_t)tiles * g.ts)
                   : nullptr;
  const size_t smem = global ? 0 : (size_t)AA_TABLES * g.ts * 8;
  const cudaError_t e = smem_opt_in<K>(smem, sizeof(AaShared));
  if (e != cudaSuccess) return (int)e;
  if (tiles > 0)
    K<<<tiles * STRIPS, AA_THREADS, smem, stream>>>(planes..., g);
  return (int)cudaGetLastError();
}

}  // namespace ls
