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
// and whose grids reach 4096 x 4096.  One cluster a band would put 8 of the
// card's 132 SMs on up to 16.7M cells, so it launches once per direction
// over the whole grid instead, one thread a cell, the origins ping-ponging
// between `out` and `tmp` in device memory (two more launches: the start
// and the slot lookup).  Each direction moves ~12 bytes a cell, so it is
// bound by device memory and the launches, not by the compares; each axis
// wraps modulo its own size, for any step length.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

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

// The grid flood (treee_jump_flood_grid): one [h, w] grid, whole-grid
// launches.  A cell's state is its origin, as in the cluster kernel.
constexpr int kGridThreads = 256;

__global__ void __launch_bounds__(kGridThreads)
grid_start(const int* __restrict__ seed_slot, int* cur, int n) {
  const int k = blockIdx.x * kGridThreads + threadIdx.x;
  if (k < n) cur[k] = seed_slot[k] >= 0 ? k : -1;
}

// One direction: cell (i, j) looks at ((i - dy) mod h, (j - dx) mod w),
// given as the shifts sh = (dy mod h) and sw = (dx mod w) in [0, h) x
// [0, w), and takes the source's origin where that seed is strictly nearer
// than its own, as the cluster kernel's cell update does.
__global__ void __launch_bounds__(kGridThreads)
grid_direction(const float2* __restrict__ seed_pos,
               const float2* __restrict__ center, const int* __restrict__ cur,
               int* __restrict__ nxt, int h, int w, int sh, int sw) {
  const int k = blockIdx.x * kGridThreads + threadIdx.x;
  if (k >= h * w) return;
  const int i = k / w;
  const int j = k - i * w;
  int si = i - sh;
  if (si < 0) si += h;
  int sj = j - sw;
  if (sj < 0) sj += w;
  const int co = cur[si * w + sj];
  int o = cur[k];
  if (co >= 0 && co != o) {
    const float2 c = center[k];
    const float cd = sq_dist(__ldg(seed_pos + co), c);
    const float d = o >= 0 ? sq_dist(__ldg(seed_pos + o), c) : kInf;
    if (cd < d) o = co;
  }
  nxt[k] = o;
}

// The origins in `out` become their seeds' slots, in place.
__global__ void __launch_bounds__(kGridThreads)
grid_finish(const int* __restrict__ seed_slot, int* out, int n) {
  const int k = blockIdx.x * kGridThreads + threadIdx.x;
  if (k >= n) return;
  const int o = out[k];
  out[k] = seed_slot[o >= 0 ? o : k];
}

int positive_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
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

// The grid flood: seed_slot i32[h,w] (negative where no seed), seed_pos
// f32[h,w,2], cell_center f32[h,w,2], read only; out i32[h,w]; tmp i32[h,w]
// scratch (may be null when n_steps is 0); `steps` a HOST array of n_steps
// step lengths (each >= 1), taken in order, 8 directions each as in the
// cluster kernel.  2 + 8 * n_steps launches on `stream`; h * w < 2^31.
// Returns the first CUDA error, or 0.
extern "C" int treee_jump_flood_grid(const int* seed_slot,
                                     const float* seed_pos,
                                     const float* cell_center, int* out,
                                     int* tmp, const int* steps, int n_steps,
                                     int h, int w, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || n_steps < 0 ||
      static_cast<long long>(h) * w > 0x7FFFFFFFLL ||
      (n_steps > 0 && (steps == nullptr || tmp == nullptr)))
    return cudaErrorInvalidValue;
  for (int q = 0; q < n_steps; ++q)
    if (steps[q] < 1) return cudaErrorInvalidValue;
  const int n = h * w;
  const int blocks = (n + kGridThreads - 1) / kGridThreads;
  const auto pos = reinterpret_cast<const float2*>(seed_pos);
  const auto cc = reinterpret_cast<const float2*>(cell_center);
  grid_start<<<blocks, kGridThreads, 0, stream>>>(seed_slot, out, n);
  cudaError_t err = cudaGetLastError();
  int* cur = out;
  int* nxt = tmp;
  for (int q = 0; q < n_steps && err == cudaSuccess; ++q) {
    const int s = steps[q];
    for (int dy = -s; dy <= s && err == cudaSuccess; dy += s) {
      for (int dx = -s; dx <= s && err == cudaSuccess; dx += s) {
        if (dy == 0 && dx == 0) continue;
        grid_direction<<<blocks, kGridThreads, 0, stream>>>(
            pos, cc, cur, nxt, h, w, positive_mod(dy, h),
            positive_mod(dx, w));
        err = cudaGetLastError();
        int* done = nxt;
        nxt = cur;
        cur = done;
      }
    }
  }
  // 8 directions a step: the last one wrote `out`
  if (err == cudaSuccess) {
    grid_finish<<<blocks, kGridThreads, 0, stream>>>(seed_slot, out, n);
    err = cudaGetLastError();
  }
  return err;
}

TREEE_PACKED(treee_jump_flood)
TREEE_PACKED(treee_jump_flood_grid)
