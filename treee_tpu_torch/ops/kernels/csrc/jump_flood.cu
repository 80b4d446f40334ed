// Jump-flood Voronoi over a stack of bands: the nearest seed slot per cell.
//
// Replaces treee_tpu/ops/pallas_kernels.py::_jfa_kernel (called through
// jump_flood_pallas, one band per call; here all bands at once, as
// treee_tpu/segmentation.py::_jump_flood batches them).  Contract: seed_slot
// i32[B,G,G] (negative where no seed), seed_pos f32[B,G,G,2] (the seeds'
// absolute x, z), cell_center f32[G,G,2]; out i32[B,G,G].  For each step
// s = G/2, G/4, ..., 1 and each direction (dy, dx), dy in (-s, 0, s) outer
// and dx in (-s, 0, s) inner, skipping (0, 0), every cell (i, j) looks at
// the cell ((i - dy) mod G, (j - dx) mod G) (the roll wraps, and a wrapped
// seed is a real candidate) and takes its seed when that seed's squared
// distance (sx - cx)^2 + (sz - cz)^2 is strictly smaller than its own.  Each
// direction reads the state the previous direction left.  The output equals
// the plain PyTorch version bit for bit (__fsub_rn/__fmul_rn/__fadd_rn under
// -fmad=false round as its separate torch ops do).
//
// The state is one i32 a cell, its origin: every update copies a
// neighbour's whole (slot, sx, sz), so at every moment a cell holds the seed
// of one seed cell o of its band, (seed_slot[o], seed_pos[o]), or its own
// unseeded start.  Carrying o (or -1) in place of the triple is exact for any
// input (duplicate slots, ties, positions that do not follow from the slot)
// and moves 4 bytes a cell instead of 12.  The distances are recomputed from
// seed_pos[o] where a candidate differs from the cell's own origin; where it
// is the same origin or none, the strict < cannot take it and nothing is
// read.  The output is seed_slot[o], or the cell's own seed_slot where no
// seed reached it.
//
// What bounds it on the H100: the TPU kernel keeps one band's whole state in
// VMEM for all 8 log2(G) directions; done one direction per launch (the
// earlier design here, 64 launches at G = 384) every direction reads and
// writes the whole state in device memory, ~64x the bytes the function must
// move.  Design: one thread-block cluster of 8 CTAs (the portable size) per
// band, one launch per call, as cc_sweep.cu.  The CTAs split the band's rows
// (48 each at G = 384; a ragged G leaves the last CTAs fewer, or none) and,
// up to G = 480, keep their rows' origins in shared memory, double-buffered
// (144 KB a CTA at G = 384).  Each direction a warp walks a contiguous run
// of (row, 32-column chunk) units; a cell's candidate origin comes from
// whichever CTA holds the source row (DSMEM: ld.shared::cluster at a 32-bit
// address from mapa, which keeps a cell's address arithmetic short), the
// candidate's and its own seed position through the read-only path
// (seed_pos, 1.18 MB a band, stays in L2; the few seeds' lines in L1).
// Cell centres are read once: where a CTA's rows hold them as a grid (x
// constant along a row, z along a column, bit for bit, as the segmentation
// builds them) it keeps one z a column in shared memory and reads a row's x
// once a row; any other centre plane is read from L2 wherever a distance is
// needed, with the same values.
// Chunks go in batches of kBatch so that their loads are in flight together.
// One cluster.sync() a direction (release/acquire at cluster scope) keeps the
// directions in order: a CTA writes only its next plane while the others
// read its current one.  A band without a seed copies seed_slot and returns
// after one barrier.  There is no early exit on an unchanged direction: it
// says nothing about the next offset.  A larger G keeps the origins in `out`
// and `tmp` in device memory instead, read through ld.global.cg so that no
// SM's L1 serves a stale row; the wrapper picks the route by G.
//
// Occupancy and what bounds it now (H100 80GB HBM3, compare_kernels.py):
// 15 clusters resident at G = 384 (one CTA an SM), ptxas 55-60 registers,
// no spills.  One band alone takes ~0.4 ms, ~6 us a direction, the same as
// one wave of 15, so the bands do not compete for L2; a stack of 64 seeded
// bands takes 5 waves.  Of a direction, the compared candidates' distances
// are about a quarter, the cluster barrier about a seventh and the remote
// (DSMEM) reads about a ninth; halving the index and address work a cell
// (two columns a lane) did not move the time.  The own distance is
// recomputed each direction: keeping it in a third shared plane (which fits
// only up to G = 392) was 2-4% faster, not worth a third route.
//
// The grid flood (treee_jump_flood_grid) runs the same cell update over ONE
// rectangular [h, w] grid with the caller's step list: the raster flood of
// treee_tpu/rasters.py::jfa_fill (XLA rolls in the JAX package, no TPU
// kernel of its own), whose schedule is next_pow2(max(h, w))/2, ..., 1, 2, 1
// and whose grids reach 4096 x 4096.  Each axis wraps modulo its own size,
// for any step length.  It takes the positions in two forms: given (seed_pos
// and cell_center, as the band kernel reads them), or the rasters' own,
// where each seed sits at its cell and each centre is its cell's (row, col).
// There an origin is its seed cell's (row << 16 | col) and the f32
// coordinates come from integer bits (2^23 + x): a direction gathers
// nothing, reads no centre plane and converts nothing, and a seed cell, at
// distance 0 from its own seed, never changes.  The first design launched
// once a direction over the whole grid (2 + 8 x steps launches), each
// direction moving ~12 bytes a cell and gathering the seeds' positions.
// Now the whole flood is one cooperative launch (a step list longer than
// one launch takes is split) of one 1024-thread block an SM, a grid barrier
// between steps.  Along an axis of n cells a step s moves a seed along the
// cycle x, x + s, x + 2s, ... (mod n), one of gcd(s, n) cycles of
// n / gcd(s, n) cells, and the step's 8 directions reach at most 3
// positions along it each way.  A tile holds, on each axis, q adjacent
// cycles by t consecutive positions plus a halo of 3 positions a side, or
// whole cycles and no halo; a shift by s is a shift by q cells of the tile.
// A block loads a tile's origins and their distances into shared memory,
// lists the cells that can change, runs the step's 8 directions over the
// list (two origin planes; each cell's distance kept as it changes) and
// writes its core once: a step reads and writes each cell about once, where
// the first design moved ~100 bytes a cell a step.  Columns take at least 8
// adjacent cycles, so a tile's rows are read in runs of 32 bytes even where
// s is large; the wrapper picks (q, t) for each axis and step
// (jump_flood.grid_plan).  A cell outside the core reads neighbours wrapped
// modulo the tile's length (or, where both axes are windows, by its flat
// offset): wrong values that the core never reads.  The first step starts
// from seed_slot, the last writes the slots.  What bounds it on the H100
// (compare_kernels.py --only grid): the instructions a listed cell takes a
// direction (~35-45, issued at ~2 a cycle an SM), then at small grids each
// step's fixed cost (the tile's tables, loads and stores, and the grid
// barrier behind the slowest tile).  One cluster of 16 CTAs holding both
// origin planes in distributed shared memory (up to ~670 x 670 cells, one
// cluster.sync() a direction) was 2-3x slower at 256², 512² and 640²: 16
// SMs against 132.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "packed.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 8;                    // CTAs a cluster (portable size)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 3;                   // chunks a warp loads at once
constexpr int kFlags = 4;                   // the seed flag (+3 pad)
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kInf = 3.0e38f;

__host__ __device__ int rows_per_cta(int g) {
  return (g + kCtas - 1) / kCtas;
}

// Shared memory a CTA needs for its rows' origins, double-buffered, the
// flag and one centre z a column; the wrapper keeps the rows there where
// this fits a block.
size_t shared_plane_bytes(int g) {
  return sizeof(int) *
         (2 * static_cast<size_t>(rows_per_cta(g)) * g + kFlags + g);
}

__device__ __forceinline__ float sq_dist(float2 p, float2 c) {
  const float ex = __fsub_rn(p.x, c.x);
  const float ez = __fsub_rn(p.y, c.y);
  return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ez, ez));
}

template <bool kShared>
__device__ __forceinline__ int load(const int* p) {
  return kShared ? *p : __ldcg(p);
}

__device__ __forceinline__ uint32_t shared_address(const int* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address in the shared::cluster window of CTA `rank`'s copy of this
// CTA's shared address `addr`.
__device__ __forceinline__ uint32_t cluster_address(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ int load_cluster(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.b32 %0, [%1];"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// kShared: the band's origins in the CTAs' shared memory; otherwise in `out`
// and `tmp`, alternately, in device memory.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
jump_flood_cluster(const int* __restrict__ seed_slot,
                   const float2* __restrict__ seed_pos,
                   const float2* __restrict__ center, int* out, int* tmp,
                   int g) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per = rows_per_cta(g);
  const int r0 = min(rank * rows_per, g);
  const int h = min(r0 + rows_per, g) - r0;   // this CTA's rows
  const int cell0 = r0 * g;                   // its first cell in the band
  const int n = h * g;
  const size_t band = static_cast<size_t>(blockIdx.x / kCtas) * g * g;
  const int* slot_b = seed_slot + band;
  const float2* pos_b = seed_pos + band;

  extern __shared__ int smem[];
  int* flag = smem;
  // this CTA's rows of the origin plane being read and of the one written
  int* cur = out + band + cell0;
  int* nxt = tmp + band + cell0;
  float* col_z = reinterpret_cast<float*>(smem + kFlags);
  if (kShared) {
    cur = smem + kFlags;
    nxt = cur + rows_per * g;
    col_z = reinterpret_cast<float*>(nxt + rows_per * g);
  }
  for (int j = threadIdx.x; j < g && h > 0; j += kThreads)
    col_z[j] = center[cell0 + j].y;
  bool any = false;
  bool grid = true;  // centre x constant along each row, z along each column
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int o = slot_b[cell0 + k] >= 0 ? cell0 + k : -1;
    cur[k] = o;
    any |= o >= 0;
    const int i = k / g;
    const float2 c = center[cell0 + k];
    grid &= __float_as_int(c.x) == __float_as_int(center[cell0 + i * g].x) &&
            __float_as_int(c.y) == __float_as_int(center[cell0 + k - i * g].y);
  }
  grid = __syncthreads_and(grid);
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) *flag = any;
  cluster.sync();                             // every CTA's rows are loaded
  const bool seeded = __any_sync(
      kFull, lane < kCtas && *cluster.map_shared_rank(flag, lane) != 0);
  if (!seeded) {                              // the same in every CTA
    for (int k = threadIdx.x; k < n; k += kThreads)
      out[band + cell0 + k] = slot_b[cell0 + k];
    cluster.sync();  // no CTA leaves while another may read its flag
    return;
  }

  // this warp's share of the CTA's (row, chunk) units, contiguous in
  // row-major order
  const int chunks = (g + 31) / 32;
  const int units = h * chunks;
  const int u_lo = warp * units / kWarps;
  const int u_hi = (warp + 1) * units / kWarps;
  for (int s = g / 2; s >= 1; s /= 2) {
    for (int dy = -s; dy <= s; dy += s) {
      for (int dx = -s; dx <= s; dx += s) {
        if (dy == 0 && dx == 0) continue;
        for (int u = u_lo; u < u_hi;) {
          const int r = u / chunks;
          const int ch0 = u - r * chunks;
          const int ch1 = min(chunks, ch0 + (u_hi - u));
          int si = r0 + r - dy;               // the source row, wrapped
          if (si < 0) si += g;
          else if (si >= g) si -= g;
          // the source row: a 32-bit shared::cluster address in the CTA
          // that holds it, or a device-memory pointer
          const int* src = cur + (si - r0) * g;
          uint32_t src_c = 0;
          if (kShared) {
            const int owner = si / rows_per;
            src_c = cluster_address(
                shared_address(cur + (si - owner * rows_per) * g), owner);
          }
          const int* own = cur + r * g;
          int* dst = nxt + r * g;
          const float2* crow = center + static_cast<size_t>(r0 + r) * g;
          const float row_x = crow[0].x;
          for (int ch = ch0; ch < ch1; ch += kBatch) {
            int j[kBatch], o[kBatch], co[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              j[q] = (ch + q) * 32 + lane;
              o[q] = -1;
              co[q] = -1;
              if (ch + q < ch1 && j[q] < g) {
                int sj = j[q] - dx;
                if (sj < 0) sj += g;
                else if (sj >= g) sj -= g;
                co[q] = kShared ? load_cluster(src_c + 4u * sj)
                                : load<false>(src + sj);
                o[q] = load<kShared>(own + j[q]);
              } else {
                j[q] = -1;
              }
            }
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              if (co[q] >= 0 && co[q] != o[q]) {
                const float2 c = grid ? make_float2(row_x, col_z[j[q]])
                                      : __ldg(crow + j[q]);
                // origins index the band from 0: unsigned offsets keep
                // the address arithmetic to one wide multiply-add
                const float cd =
                    sq_dist(__ldg(pos_b + static_cast<unsigned>(co[q])), c);
                const float d =
                    o[q] >= 0
                        ? sq_dist(__ldg(pos_b + static_cast<unsigned>(o[q])), c)
                        : kInf;
                if (cd < d) o[q] = co[q];
              }
            }
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              if (j[q] >= 0) dst[j[q]] = o[q];
            }
          }
          u += ch1 - ch0;
        }
        cluster.sync();                       // the direction is done
        int* done = nxt;
        nxt = cur;
        cur = done;
      }
    }
  }
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int o = load<kShared>(cur + k);
    out[band + cell0 + k] = slot_b[o >= 0 ? o : cell0 + k];
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// ---- The grid flood (treee_jump_flood_grid) ----
constexpr int kTileHalo = 3;        // halo positions on each side of a window
constexpr int kTileMaxSteps = 16;   // steps the grid flood takes a launch
constexpr int kTileBatch = 4;       // cells a thread loads at once
constexpr int kTileThreads = 1024;  // threads of a grid flood's block
constexpr int kTileCells = 15360;   // cells of a tile (3 + 1/2 4-byte planes)
constexpr int kTileAxis = 1024;     // cells of a tile along one axis
constexpr int kCopyThreads = 256;
constexpr int kFloatBase = 0x4B000000;  // 2^23 as f32 bits

// x as f32 plus 2^23, exactly, for 0 <= x < 2^23 (no conversion
// instruction): the difference of two such values is x - y as f32.
__device__ __forceinline__ float biased(int x) {
  return __int_as_float(kFloatBase | x);
}

// q = x / d and x - q d for 0 <= x < 2^31 by a multiply-high (Divider::make
// on the divisor, once).
struct Divider {
  int d;
  unsigned magic;
  int shift;
  __host__ __device__ static Divider make(int d) {
    int shift = 0;
    while ((1LL << shift) < d) ++shift;
    const unsigned long long m =
        ((1ULL << 32) * ((1ULL << shift) - static_cast<unsigned>(d))) /
            static_cast<unsigned>(d) + 1;
    return Divider{d, static_cast<unsigned>(m), shift};
  }
  __device__ __forceinline__ int div(int x) const {
    const unsigned u = static_cast<unsigned>(x);
    return static_cast<int>((__umulhi(u, magic) + u) >> shift);
  }
};

// The rasters' form: a seed sits at its cell, a cell's centre is its (row,
// col), as the f32 values the plain version's planes hold.  An origin is
// its seed cell's (row << 16 | col) (rows < 2^15, columns < 2^16), so that
// a candidate's coordinates come from two bit operations; a seed cell's own
// origin is at distance 0, which nothing beats, so it never changes.
struct CellPos {
  static constexpr bool kSettles = true;
  int w;
  __device__ __forceinline__ int origin(int i, int j, int) const {
    return i << 16 | j;
  }
  __device__ __forceinline__ int flat(int o) const {
    return (o >> 16) * w + (o & 0xFFFF);
  }
  // squared distance of seed o from the centre of cell (i, j), rounded as
  // the plain version's (sx - cx)^2 + (sz - cz)^2
  __device__ __forceinline__ float dist(int o, int i, int j) const {
    const float ex = __fsub_rn(biased(o >> 16), biased(i));
    const float ez = __fsub_rn(biased(o & 0xFFFF), biased(j));
    return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ez, ez));
  }
};

// The given form: seed_pos and cell_center, through the read-only path; an
// origin is its seed cell's flat index.
struct GivenPos {
  static constexpr bool kSettles = false;
  const float2* pos;
  const float2* center;
  int w;
  __device__ __forceinline__ int origin(int, int, int k) const { return k; }
  __device__ __forceinline__ int flat(int o) const { return o; }
  __device__ __forceinline__ float dist(int o, int i, int j) const {
    return sq_dist(__ldg(pos + static_cast<unsigned>(o)),
                   __ldg(center + static_cast<unsigned>(i * w + j)));
  }
};

// The cell update at cell (i, j): the candidate origin co where its seed is
// strictly nearer than that of the cell's own origin o.
template <class Pos>
__device__ __forceinline__ int nearer(const Pos& p, int o, int co, int i,
                                      int j) {
  if (co < 0 || co == o) return o;
  const float d = o >= 0 ? p.dist(o, i, j) : kInf;
  return p.dist(co, i, j) < d ? co : o;
}

// One axis of the grid flood's tiles for one step (see the note at the top),
// with the dividers a block needs, made on the host.
struct TileAxis {
  int n;      // the axis' cells
  int s;      // the step modulo n
  int g;      // cycles: gcd(s, n) (n where s is 0)
  int p;      // a cycle's positions: n / g
  int q;      // adjacent cycles a tile
  int t;      // core positions a tile
  int halo;   // halo positions on each side: 0 where t == p (whole cycles)
  int len;    // the tile's cells along the axis: (t + 2 halo) q
  int wins;   // windows along a cycle: ceil(p / t)
  int tiles;  // tiles along the axis: ceil(g / q) wins
  int small;  // a cycle's offsets (< g + p n) fit an int
  Divider by_q, by_p, by_n, by_len;
};

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Axis `a` of length n for step s with q cycles and t positions a tile;
// false where they do not make a tile.
bool tile_axis(int n, int s, int q, int t, TileAxis* a) {
  a->n = n;
  a->s = s % n;
  a->g = gcd(a->s, n);
  a->p = n / a->g;
  if (q < 1 || q > a->g || t < 1 || t > a->p) return false;
  a->q = q;
  a->t = t;
  a->halo = t == a->p ? 0 : kTileHalo;
  const long long len = static_cast<long long>(t + 2 * a->halo) * q;
  if (len > kTileAxis) return false;
  a->len = static_cast<int>(len);
  a->wins = (a->p + t - 1) / t;
  a->tiles = (a->g + q - 1) / q * a->wins;
  a->small = static_cast<long long>(a->p) * n + a->g < 0x7FFFFFFFLL;
  a->by_q = Divider::make(q);
  a->by_p = Divider::make(a->p);
  a->by_n = Divider::make(n);
  a->by_len = Divider::make(a->len);
  return true;
}

// The steps of one launch of the grid flood, each step's two axes.
struct TilePlan {
  int n;                   // steps in this launch
  int first;               // the flood's index of this launch's first step
  int total;               // the flood's steps
  TileAxis step[kTileMaxSteps][2];
};

// The cell along axis `a` of each of tile `tile`'s local indices (-1 past
// the last cycle) and whether it is in the tile's core.  Local index l is
// cycle c0 + l % q at position k0 + l / q - halo (wrapped along the cycle).
__device__ void axis_cells(const TileAxis& a, int tile, int* cell, int* core) {
  const int c0 = tile / a.wins * a.q;
  const int k0 = tile % a.wins * a.t;
  for (int l = threadIdx.x; l < a.len; l += kTileThreads) {
    const int m = a.by_q.div(l);
    const int cycle = c0 + l - m * a.q;
    const int k = k0 + m - a.halo;
    const int x = k + kTileHalo * a.p;        // >= 0
    const int kk = x - a.by_p.div(x) * a.p;
    const bool ok = cycle < a.g;
    int at = -1;
    if (ok && a.small) {
      const int y = cycle + kk * a.s;
      at = y - a.by_n.div(y) * a.n;
    } else if (ok) {
      at = static_cast<int>((cycle + static_cast<long long>(kk) * a.s) % a.n);
    }
    cell[l] = at;
    core[l] = ok && m >= a.halo && m < a.halo + a.t && k < a.p;
  }
}

// One step over one tile: load the tile's origins (from seed_slot for the
// flood's first step) and their distances, and list the cells that may
// change (not past the last cycle, and in the rasters' form not a seed
// cell, which is at distance 0 from its own seed); run the 8 directions in
// shared memory over the listed cells; write the core's origins to `dst`
// (their slots to `out` after the flood's last step).  A thread takes
// cells f, f + kTileThreads, ... kTileBatch at a time so that their loads
// are in flight together.  Both origin planes start equal, so a cell off
// the list is never written.
template <class Pos>
__device__ void tile_step(const Pos& p, const int* __restrict__ seed_slot,
                          const int* src_g, int* dst_g, const TileAxis& ar,
                          const TileAxis& ac, int tile, int w, bool first,
                          bool last, int* smem) {
  int* count = smem;
  int* row_cell = smem + 4;
  int* row_core = row_cell + ar.len;
  int* col_cell = row_core + ar.len;
  int* col_core = col_cell + ac.len;
  const int lw = ac.len;
  const int cells = ar.len * lw;
  int* cur = col_core + lw;
  int* nxt = cur + cells;
  float* dist = reinterpret_cast<float*>(nxt + cells);
  unsigned short* list = reinterpret_cast<unsigned short*>(dist + cells);
  const int lane = threadIdx.x & 31;
  const int tr = tile / ac.tiles;
  axis_cells(ar, tr, row_cell, row_core);
  axis_cells(ac, tile - tr * ac.tiles, col_cell, col_core);
  if (threadIdx.x == 0) *count = 0;
  const Divider& by_lw = ac.by_len;
  __syncthreads();

  // warp-uniform bounds, so that the whole warp takes part in the ballot
  for (int f0 = threadIdx.x - lane; f0 < cells;
       f0 += kTileBatch * kTileThreads) {
    int v[kTileBatch], k[kTileBatch], gc[kTileBatch], gr[kTileBatch];
#pragma unroll
    for (int b = 0; b < kTileBatch; ++b) {
      const int f = f0 + lane + b * kTileThreads;
      v[b] = -1;
      k[b] = -1;
      if (f < cells) {
        const int r = by_lw.div(f);
        gr[b] = row_cell[r];
        gc[b] = col_cell[f - r * lw];
        if (gr[b] >= 0 && gc[b] >= 0) {
          k[b] = gr[b] * w + gc[b];
          v[b] = first ? __ldg(seed_slot + k[b]) : __ldcg(src_g + k[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kTileBatch; ++b) {
      const int f = f0 + lane + b * kTileThreads;
      bool active = false;
      if (f < cells) {
        const int o =
            first ? (v[b] >= 0 ? p.origin(gr[b], gc[b], k[b]) : -1) : v[b];
        const float d = o >= 0 ? p.dist(o, gr[b], gc[b]) : kInf;
        cur[f] = o;
        nxt[f] = o;
        dist[f] = d;
        active = k[b] >= 0 && !(Pos::kSettles && d == 0.0f);
      }
      const unsigned m = __ballot_sync(kFull, active);
      int at = 0;
      if (lane == 0 && m != 0) at = atomicAdd(count, __popc(m));
      at = __shfl_sync(kFull, at, 0);
      if (active)
        list[at + __popc(m & ((1u << lane) - 1))] =
            static_cast<unsigned short>(f);
    }
  }
  __syncthreads();
  const int n_active = *count;
  // both axes are windows: every wrap a direction needs is a halo cell's
  const bool windows = ar.halo != 0 && ac.halo != 0;

  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int kr = dy * ar.q;               // |kr| <= ar.len
      const int kc = dx * ac.q;
      const int off = kr * lw + kc;
      for (int i0 = threadIdx.x; i0 < n_active;
           i0 += kTileBatch * kTileThreads) {
        int co[kTileBatch], o[kTileBatch], at[kTileBatch];
        float d[kTileBatch];
#pragma unroll
        for (int b = 0; b < kTileBatch; ++b) {
          const int i = i0 + b * kTileThreads;
          at[b] = -1;
          if (i < n_active) {
            const int f = list[i];
            int src;
            if (windows) {
              // the source by its flat offset: one that crosses the
              // tile's side (or end) is a halo cell's, which the core
              // never reads
              src = min(max(f - off, 0), cells - 1);
            } else {
              const int r = by_lw.div(f);
              int sr = r - kr;
              if (sr < 0) sr += ar.len;
              else if (sr >= ar.len) sr -= ar.len;
              int sc = f - r * lw - kc;
              if (sc < 0) sc += lw;
              else if (sc >= lw) sc -= lw;
              src = sr * lw + sc;
            }
            d[b] = dist[f];
            co[b] = cur[src];
            o[b] = cur[f];
            at[b] = f;
          }
        }
#pragma unroll
        for (int b = 0; b < kTileBatch; ++b) {
          if (at[b] < 0) continue;
          if (co[b] >= 0 && co[b] != o[b]) {
            const int r = by_lw.div(at[b]);
            const float cd = p.dist(co[b], row_cell[r],
                                    col_cell[at[b] - r * lw]);
            if (cd < d[b]) {
              o[b] = co[b];
              dist[at[b]] = cd;
            }
          }
          nxt[at[b]] = o[b];
        }
      }
      __syncthreads();                        // the direction is done
      int* done = nxt;
      nxt = cur;
      cur = done;
    }
  }

  for (int f = threadIdx.x; f < cells; f += kTileThreads) {
    const int r = by_lw.div(f);
    const int c = f - r * lw;
    if (row_core[r] && col_core[c]) {
      const int k = row_cell[r] * w + col_cell[c];
      const int o = cur[f];
      dst_g[k] = last ? __ldg(seed_slot + (o >= 0 ? p.flat(o) : k)) : o;
    }
  }
  __syncthreads();                  // the next tile reuses shared memory
}

// The grid flood, one launch for up to kTileMaxSteps steps: every block
// takes tiles of a step in turn, then the grid synchronises (a cooperative
// launch) before the next step reads the plane this one wrote.  Planes
// between steps are read through L2 (ld.global.cg): an SM's L1 may hold
// lines of the plane from two steps before.
template <class Pos>
__global__ void __launch_bounds__(kTileThreads, 1)
grid_tiles(Pos p, const int* __restrict__ seed_slot, int* out, int* tmp,
           TilePlan plan, int h, int w) {
  extern __shared__ int smem[];
  cg::grid_group grid = cg::this_grid();
  for (int q = 0; q < plan.n; ++q) {
    const int step = plan.first + q;            // the flood's step index
    const TileAxis& ar = plan.step[q][0];
    const TileAxis& ac = plan.step[q][1];
    // step k reads plane k and writes plane k + 1: plane 0 is seed_slot,
    // the last is `out`, and those between alternate so that no step reads
    // the plane it writes
    const int* src = (plan.total - step) % 2 ? tmp : out;
    int* dst = (plan.total - step - 1) % 2 ? tmp : out;
    const int tiles = ar.tiles * ac.tiles;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      tile_step(p, seed_slot, src, dst, ar, ac, tile, w, step == 0,
                step == plan.total - 1, smem);
    if (q + 1 < plan.n) {
      __threadfence();
      grid.sync();
    }
  }
}

// A flood of no step: each cell keeps its own slot.
__global__ void __launch_bounds__(kCopyThreads)
grid_copy(const int* __restrict__ seed_slot, int* __restrict__ out, int n) {
  const int k = blockIdx.x * kCopyThreads + threadIdx.x;
  if (k < n) out[k] = seed_slot[k];
}

cudaLaunchConfig_t config(int b, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kShared>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(jump_flood_cluster<kShared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t route_bytes(int shared, int g) {
  return shared ? shared_plane_bytes(g) : sizeof(int) * (kFlags + g);
}

// A refused call leaves no error behind for the next launch to report.
int failed(cudaError_t err) {
  cudaGetLastError();
  return err;
}

// The grid flood's host side.

constexpr size_t kTileBytes =
    sizeof(int) * (4 + 4 * kTileAxis) +
    (3 * sizeof(int) + sizeof(unsigned short)) * kTileCells;

// Blocks of the grid flood's cooperative launch: as many as the card holds
// at once (one an SM), at most `tiles`; 0 on an error, left in *err.  The
// count is asked for once a device (it costs more host time than the
// launch) and kept.
template <class Pos>
int tile_blocks(int tiles, cudaError_t* err) {
  constexpr int kDevices = 64;
  static int held[kDevices] = {};
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kDevices && held[dev] > 0) return std::min(tiles, held[dev]);
  *err = cudaFuncSetAttribute(grid_tiles<Pos>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kTileBytes));
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_tiles<Pos>, kTileThreads, kTileBytes);
  if (*err != cudaSuccess) return 0;
  if (dev < kDevices) held[dev] = sms * per_sm;
  return std::min(tiles, sms * per_sm);
}

template <class Pos>
int launch_grid_tiles(const Pos& p, const int* seed_slot, int* out, int* tmp,
                      const int* steps, const int* tiles, int n_steps, int h,
                      int w, cudaStream_t stream) {
  if (n_steps == 0) {
    const int n = h * w;
    grid_copy<<<(n + kCopyThreads - 1) / kCopyThreads, kCopyThreads, 0,
                stream>>>(seed_slot, out, n);
    return cudaGetLastError();
  }
  if (tiles == nullptr || (n_steps > 1 && tmp == nullptr))
    return cudaErrorInvalidValue;
  TileAxis ar, ac;
  int most = 1;
  for (int q = 0; q < n_steps; ++q) {           // a bad plan launches nothing
    const int* t = tiles + 4 * q;
    if (!tile_axis(h, steps[q], t[0], t[1], &ar) ||
        !tile_axis(w, steps[q], t[2], t[3], &ac) ||
        static_cast<long long>(ar.len) * ac.len > kTileCells ||
        static_cast<long long>(ar.tiles) * ac.tiles > 0x7FFFFFFFLL)
      return cudaErrorInvalidValue;
    most = std::max(most, ar.tiles * ac.tiles);
  }
  cudaError_t err;
  const int blocks = tile_blocks<Pos>(most, &err);
  if (blocks == 0) return failed(err == cudaSuccess ? cudaErrorInvalidValue
                                                    : err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = kTileBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  for (int q0 = 0; q0 < n_steps; q0 += kTileMaxSteps) {
    TilePlan plan = {};
    plan.n = std::min(kTileMaxSteps, n_steps - q0);
    plan.first = q0;
    plan.total = n_steps;
    for (int q = 0; q < plan.n; ++q) {
      const int* t = tiles + 4 * (q0 + q);
      tile_axis(h, steps[q0 + q], t[0], t[1], &plan.step[q][0]);
      tile_axis(w, steps[q0 + q], t[2], t[3], &plan.step[q][1]);
    }
    err = cudaLaunchKernelEx(&cfg, grid_tiles<Pos>, p, seed_slot, out, tmp,
                             plan, h, w);
    if (err != cudaSuccess) return failed(err);
  }
  return cudaGetLastError();
}

}  // namespace

// seed_slot i32[b,g,g], seed_pos f32[b,g,g,2], cell_center f32[g,g,2], read
// only; out i32[b,g,g]; tmp i32[b,g,g] scratch for the device-memory route
// (shared == 0), unused otherwise.  `shared` nonzero keeps each band's
// origins in its cluster's shared memory, which CUDA refuses above the
// block's 227 KB (g > 480); the caller chooses by g.  One cluster launch on
// `stream`.  Returns its CUDA error, or 0.
extern "C" int treee_jump_flood(const int* seed_slot, const float* seed_pos,
                                const float* cell_center, int* out, int* tmp,
                                int b, int g, int shared, cudaStream_t stream) {
  if (b <= 0 || g <= 0 || (!shared && tmp == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = route_bytes(shared, g);
  const auto pos = reinterpret_cast<const float2*>(seed_pos);
  const auto cc = reinterpret_cast<const float2*>(cell_center);
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (shared) {
    err = prepare<true>(smem);
    if (err != cudaSuccess) return failed(err);
    const cudaLaunchConfig_t cfg = config(b, smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, jump_flood_cluster<true>, seed_slot, pos,
                             cc, out, tmp, g);
  } else {
    err = prepare<false>(smem);
    if (err != cudaSuccess) return failed(err);
    const cudaLaunchConfig_t cfg = config(b, smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, jump_flood_cluster<false>, seed_slot, pos,
                             cc, out, tmp, g);
  }
  if (err != cudaSuccess) return failed(err);
  return cudaGetLastError();
}

// How many of the route's 8-CTA clusters the card holds at once at grid g
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int treee_jump_flood_clusters(int g, int shared) {
  const size_t smem = route_bytes(shared, g);
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t err;
  if (shared) {
    err = prepare<true>(smem);
    const cudaLaunchConfig_t cfg = config(1, smem, nullptr, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, jump_flood_cluster<true>, &cfg);
  } else {
    err = prepare<false>(smem);
    const cudaLaunchConfig_t cfg = config(1, smem, nullptr, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, jump_flood_cluster<false>, &cfg);
  }
  return err == cudaSuccess ? n : -failed(err);
}

// The grid flood: seed_slot i32[h,w] (negative where no seed); seed_pos
// f32[h,w,2] and cell_center f32[h,w,2], read only, or both null for seeds
// at their own cells and centres at (row, col) (then h < 2^15, w < 2^16);
// out i32[h,w]; tmp i32[h,w] scratch for two steps or more (may be null
// otherwise).  `steps` a HOST array of n_steps step lengths (each >= 1),
// taken in order, 8 directions each as in the band kernel; `tiles` a HOST
// array of 4 ints a step (q and t of the rows, then of the columns;
// TileAxis).  One cooperative launch on `stream` a kTileMaxSteps steps (one
// plain launch for no step); h * w < 2^31.  Returns the first CUDA error,
// or 0.
extern "C" int treee_jump_flood_grid(const int* seed_slot,
                                     const float* seed_pos,
                                     const float* cell_center, int* out,
                                     int* tmp, const int* steps,
                                     const int* tiles, int n_steps, int h,
                                     int w, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || n_steps < 0 ||
      static_cast<long long>(h) * w > 0x7FFFFFFFLL ||
      (n_steps > 0 && steps == nullptr) ||
      (seed_pos == nullptr) != (cell_center == nullptr))
    return cudaErrorInvalidValue;
  for (int q = 0; q < n_steps; ++q)
    if (steps[q] < 1) return cudaErrorInvalidValue;
  if (seed_pos == nullptr) {
    if (h > 0x7FFF || w > 0xFFFF) return cudaErrorInvalidValue;
    return launch_grid_tiles(CellPos{w}, seed_slot, out, tmp, steps, tiles,
                             n_steps, h, w, stream);
  }
  const GivenPos p{reinterpret_cast<const float2*>(seed_pos),
                   reinterpret_cast<const float2*>(cell_center), w};
  return launch_grid_tiles(p, seed_slot, out, tmp, steps, tiles, n_steps, h,
                           w, stream);
}

TREEE_PACKED(treee_jump_flood)
TREEE_PACKED(treee_jump_flood_grid)
