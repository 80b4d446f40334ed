// Connected-component label sweeps over a stack of band grids.
//
// Replaces treee_tpu/ops/pallas_kernels.py::_cc_sweep_kernel (:244, called
// through cc_sweep_pallas at :278).  Contract: exactly `sweeps` synchronous
// 3x3 min-pool sweeps per band over i32[B,G,G] labels, where 0x7FFFFFFF marks
// an empty cell that stays empty, occupied cells take the minimum over their
// 3x3 window, and cells outside the grid count as empty.  The output equals
// the plain PyTorch version bit for bit after any number of sweeps.
//
// What bounds it on the H100: a band plane at G=384 is 576 KB, more than the
// 227 KB of shared memory one block can hold, and each sweep is a handful of
// integer mins per cell, so the work is latency and synchronisation, not
// bytes: done one sweep per launch it would move 75 MB per sweep at B=64.
//
// Design: one thread-block cluster of 8 CTAs (the portable size) per band,
// one launch per call.  The CTAs split the band's rows (48 each at G=384; a
// ragged G leaves the last CTAs fewer, or none).  Up to G=480 they keep their
// rows in shared memory, double-buffered (144 KB a CTA at G=384), so the
// plane is read from device memory once and written once, and the rows just
// above and below a CTA's own come from the neighbour CTAs' shared memory
// (DSMEM).  A larger G sweeps the same way between `out` and `tmp` in device
// memory, reading through ld.global.cg so that no SM's L1 serves a stale
// row.  Each sweep, a warp
// walks a strip of 32 columns down a run of rows: it holds the rows above,
// at and below in registers (one load a cell), takes the vertical min of
// three with __vimin3_s32, and the horizontal neighbours' through
// __shfl_up/down; the strip's two edge lanes only feed their neighbours, so
// strips overlap by two columns and 30 cells a row are written.  One
// cluster.sync() a sweep (release/acquire at cluster scope) keeps the sweeps
// synchronous (Jacobi): a CTA writes only its next plane while its
// neighbours read its current one.  Each sweep also ORs a "changed" flag
// over the cluster (a flag a CTA, three slots in rotation, read by every CTA
// after the sync); once a whole sweep leaves the band unchanged the band is
// at a fixpoint of the sweep map, every further sweep would leave it
// unchanged too, and the cluster stops early with the same output.
//
// Occupancy: each CTA needs one SM (1024 threads, 144 KB of shared memory at
// G=384); on an H100 80GB HBM3, cudaOccupancyMaxActiveClusters gives 15 such
// clusters at once at G=384, so 120 of the 132 SMs work and 64 bands take
// about five waves, fewer where bands stop early.  ptxas (nvcc 12.9, sm_90a):
// 58 registers (56 for the device-memory form), no spills.  What bounds it
// now: a sweep of a band costs about 5 us on the card, of which about 2 us
// is the cluster barrier and the flag exchange, so a band that runs all 64
// sweeps (the ground band) sets the call's time, and a stack of many such
// bands takes one such time per wave of 15.  The device-memory form waits
// on its L2 loads, and on DRAM once the 15 resident clusters' two planes
// each outgrow the 50 MB L2 (G above ~650): 64 busy bands take 1.6x the
// time of the 8-launch tiled design it replaced at G=512 and 2.7x at
// G=1024 (compare_kernels.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "packed.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kIBig = 0x7FFFFFFF;
constexpr int kCtas = 8;                    // CTAs a cluster (portable size)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 30;                    // cells a warp writes per row
constexpr int kFlags = 4;                   // 3 flags in rotation (+1 pad)
constexpr int kMaxSmem = 232448;            // opt-in shared memory per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ int rows_per_cta(int g) {
  return (g + kCtas - 1) / kCtas;
}

// Shared memory a CTA needs to hold its rows, double-buffered, and the flags.
size_t shared_plane_bytes(int g) {
  return sizeof(int) * (2 * static_cast<size_t>(rows_per_cta(g)) * g + kFlags);
}

template <bool kShared>
__device__ __forceinline__ int load(const int* p) {
  return kShared ? *p : __ldcg(p);
}

// kShared: the band's rows in the CTAs' shared memory; otherwise in `dst`
// and `tmp`, alternately, in device memory.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
cc_sweep_cluster(const int* src, int* dst, int* tmp, int g, int sweeps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int band = static_cast<int>(blockIdx.x) / kCtas;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per = rows_per_cta(g);

  extern __shared__ int smem[];
  int* flags = smem;                        // [3], in rotation
  const int r0 = min(rank * rows_per, g);
  const int h = min(r0 + rows_per, g) - r0;  // this CTA's rows
  const size_t base = (static_cast<size_t>(band) * g + r0) * g;
  // this CTA's rows of the plane being read and of the one being written
  const int* cur = src + base;
  int* nxt = dst + base;
  if (kShared) {
    int* rows = smem + kFlags;
    for (int i = threadIdx.x; i < h * g; i += kThreads) rows[i] = src[base + i];
    cur = rows;
    nxt = rows + rows_per * g;
  }
  if (threadIdx.x < 3) flags[threadIdx.x] = 0;
  const bool has_prev = h > 0 && r0 > 0;
  const bool has_next = h > 0 && r0 + h < g;

  // this warp's share of the CTA's (strip, row) steps, contiguous in
  // strip-major order: at most two runs of rows
  const int strips = (g + kOut - 1) / kOut;
  const int steps = strips * h;
  const int f_lo = warp * steps / kWarps;
  const int f_hi = (warp + 1) * steps / kWarps;
  cluster.sync();                           // every CTA's rows are loaded

  for (int s = 0; s < sweeps; ++s) {
    if (threadIdx.x == 0) flags[(s + 1) % 3] = 0;  // read two sweeps ago
    // the rows just above and below this CTA's: the neighbours' last and
    // first (in shared memory, at the same offset in every CTA)
    const int* prev_row = nullptr;
    const int* next_row = nullptr;
    if (kShared) {
      if (has_prev)
        prev_row = cluster.map_shared_rank(cur, rank - 1) + (rows_per - 1) * g;
      if (has_next) next_row = cluster.map_shared_rank(cur, rank + 1);
    } else {
      if (has_prev) prev_row = cur - g;
      if (has_next) next_row = cur + h * g;
    }
    bool changed = false;
    for (int f = f_lo; f < f_hi;) {
      const int strip = f / h;
      const int r = f % h;
      const int r_end = min(h, r + (f_hi - f));
      const int c = strip * kOut + lane - 1;
      const bool in = c >= 0 && c < g;
      const bool writes = in && lane >= 1 && lane <= kOut;
      auto at = [&](int row) -> int {
        if (!in) return kIBig;
        if (row < 0) return prev_row ? load<kShared>(prev_row + c) : kIBig;
        if (row >= h) return next_row ? load<kShared>(next_row + c) : kIBig;
        return load<kShared>(cur + row * g + c);
      };
      int up = at(r - 1);
      int mid = at(r);
      for (int row = r; row < r_end; ++row) {
        const int down = at(row + 1);
        const int v = __vimin3_s32(up, mid, down);
        const int left = __shfl_up_sync(kFull, v, 1);
        const int right = __shfl_down_sync(kFull, v, 1);
        const int m = mid == kIBig ? kIBig : __vimin3_s32(left, v, right);
        if (writes) {
          nxt[row * g + c] = m;
          changed |= m != mid;
        }
        up = mid;
        mid = down;
      }
      f += r_end - r;
    }
    if (__any_sync(kFull, changed) && lane == 0) flags[s % 3] = 1;
    cluster.sync();                         // sweep s is done everywhere
    // the next sweep reads what this one wrote and writes the other plane
    // (never `src`)
    int* done = nxt;
    if (kShared) {
      nxt = const_cast<int*>(cur);
    } else {
      nxt = done == dst + base ? tmp + base : dst + base;
    }
    cur = done;
    const bool any = __any_sync(
        kFull, lane < kCtas &&
                   *cluster.map_shared_rank(flags + s % 3, lane) != 0);
    if (!any) break;                        // a fixpoint: the same decision
                                            // in every CTA
  }
  if (cur != dst + base) {
    for (int i = threadIdx.x; i < h * g; i += kThreads)
      dst[base + i] = load<kShared>(cur + i);
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

template <bool kShared>
cudaError_t launch(const int* lbl, int* out, int* tmp, int b, int g,
                   int sweeps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cc_sweep_cluster<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cc_sweep_cluster<kShared>, lbl, out, tmp, g,
                           sweeps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// lbl, out, tmp: i32[b,g,g] on the device; lbl is read only, and tmp is
// scratch that only a g whose rows do not fit in the cluster's shared
// memory (g > 480) uses.  One cluster launch on `stream`.  Returns its CUDA
// error, or 0.
extern "C" int treee_cc_sweep(const int* lbl, int* out, int* tmp, int b,
                              int g, int sweeps, cudaStream_t stream) {
  if (b <= 0 || g <= 0 || sweeps <= 0) return cudaErrorInvalidValue;
  const size_t smem = shared_plane_bytes(g);
  if (smem <= static_cast<size_t>(kMaxSmem))
    return launch<true>(lbl, out, tmp, b, g, sweeps, smem, stream);
  if (tmp == nullptr) return cudaErrorInvalidValue;
  return launch<false>(lbl, out, tmp, b, g, sweeps, sizeof(int) * kFlags,
                       stream);
}

TREEE_PACKED(treee_cc_sweep)
