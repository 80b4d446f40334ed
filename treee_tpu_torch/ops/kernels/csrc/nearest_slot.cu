// The step's occupied-cell Voronoi: each occupied cell's nearest active
// tracked slot of its band.
//
// Replaces no TPU kernel.  The JAX package computes this stage with XLA ops
// (treee_tpu/segmentation.py::_bruteforce_voronoi), and so did the port, in
// chunks of 256 slots a pass; on the H100 that was two thirds of the step
// (32 of 49.6 ms): each chunk gathered a [rows, 256, 2] block of slot
// positions and a [rows, 256] block of flags through device memory, padding
// rows included.  The plain version beside the wrapper
// (nearest_slot.py::nearest_slot_plain) is that code.  Contract, for the
// rows of occ_idx whose occ_valid is set: the cell at global flat index
// q = band * G * G + i * G + j has its centre cx = lo[0] + (i + 0.5) * s,
// cz = lo[2] + (j + 0.5) * s, each operation rounded as torch rounds it;
// the distance to slot t is ex*ex + ez*ez with ex = cx - x_t, ez = cz - z_t,
// each operation rounded (the library is built with -fmad=false, and the
// _rn intrinsics say so again); the cell takes the active slot of the least
// distance below 3e38, ties to the lowest slot (strict <, slots in
// ascending order), or -1 where none is.  Every other cell of the
// [B, G, G] grid is -1.  So the output equals the plain version bit for bit.
//
// What bounds it on the H100: operations.  The work is 5 operations per
// valid row and active slot of its band (2.1e8 pairs on the 15M bench scan:
// 16 us at 67 TFLOP/s); the bytes are the rows (2.5 MB), the slots (1.2 MB)
// and the output grid (37.7 MB at G = 384, 64 bands: 12 us, its -1 fill).
// Design: the rows come from torch.nonzero, so they are sorted by band.  A
// CTA takes a tile of kTileRows consecutive rows, kRows a thread, strided so
// that the row loads and the output stores of a warp are neighbours.  For
// each band its rows touch, in ascending order (any order of rows works:
// each band is one more pass), the CTA stages the band's active slots in
// shared memory as (x, z) float2 and their slot ids, compacted in ascending
// slot order by a ballot and a prefix over the warps, at most kStageSlots at
// once (a band with more takes several passes, in slot order).  Each thread
// then walks the staged slots as shared-memory broadcasts against its rows'
// centres kept in registers; a row of another band carries a NaN centre,
// whose distances never compare below, so the walk has no branch.  A CTA
// whose rows are all padding returns at once.  The -1 fill is a memset
// before the launch, on the same stream; nothing here synchronizes the host.
// The walk issues 8 instructions a pair (2 sub, 2 mul, add, compare, 2
// selects), so the card's issue rate bounds it near 56 us on the 15M scan;
// it takes ~100 us.  Tiles of 512 rows (2 a thread) measured 0.110 ms a call
// there against 0.135 for 1024 (4 a thread): 546 tiles over 132 SMs even
// out the bands' unequal slot counts better than 273.  Taking each group of
// 4 slots' least distance first and resolving the winner's slot after the
// pass saved 7% more (0.102) for a second walk; not taken.
#include <cuda_runtime.h>

#include <climits>

#include "packed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;                        // rows per thread
constexpr int kTileRows = kThreads * kRows;     // rows per CTA
constexpr int kStageSlots = 2048;               // staged slots per pass
constexpr unsigned kNoBand = 0xFFFFFFFFu;
constexpr float kInf = 3.0e38f;                 // segmentation.py's INF

static_assert(kStageSlots % kThreads == 0, "a pass stages whole rounds");

// Least of v over the CTA; every thread gets it.
__device__ __forceinline__ unsigned block_min(unsigned v, unsigned* scratch) {
  v = __reduce_min_sync(0xFFFFFFFFu, v);
  __syncthreads();                  // the last call's readers are done
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned m = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = min(m, scratch[w]);
  return m;
}

__global__ void __launch_bounds__(kThreads)
nearest_slot_kernel(const int* __restrict__ occ_idx,
                    const unsigned char* __restrict__ occ_valid,
                    const float2* __restrict__ pos,
                    const unsigned char* __restrict__ active,
                    const float* __restrict__ lo, const float* __restrict__ s,
                    int* __restrict__ out, int n_rows, int n_bands,
                    int t_cap, int g) {
  __shared__ float2 slot_pos[kStageSlots];
  __shared__ int slot_id[kStageSlots];
  __shared__ int warp_count[kWarps];
  __shared__ unsigned warp_min[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gg = g * g;
  const int cells = n_bands * gg;
  const float lo_x = lo[0], lo_z = lo[2], step = s[0];
  const float nan = __int_as_float(0x7FFFFFFF);

  int at[kRows];                    // the row's cell, a global flat index
  unsigned band[kRows];             // kNoBand: padding, or out of range
  float cx[kRows], cz[kRows], best_d[kRows];
  int best[kRows];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = static_cast<long long>(blockIdx.x) * kTileRows +
                          r * kThreads + threadIdx.x;
    band[r] = kNoBand;
    at[r] = 0;
    cx[r] = cz[r] = nan;
    best_d[r] = kInf;
    best[r] = -1;
    if (row < n_rows && occ_valid[row]) {
      const int q = occ_idx[row];
      if (q >= 0 && q < cells) {
        const int b = q / gg;
        const int c = q - b * gg;
        const int i = c / g;
        const int j = c - i * g;
        band[r] = b;
        at[r] = q;
        cx[r] = __fadd_rn(lo_x, __fmul_rn(__fadd_rn(__int2float_rn(i), 0.5f),
                                          step));
        cz[r] = __fadd_rn(lo_z, __fmul_rn(__fadd_rn(__int2float_rn(j), 0.5f),
                                          step));
        any = true;
      }
    }
  }
  if (!__syncthreads_or(any)) return;

  unsigned lowest = kNoBand;
#pragma unroll
  for (int r = 0; r < kRows; ++r) lowest = min(lowest, band[r]);
  unsigned cur = block_min(lowest, warp_min);
  const unsigned below = (1u << lane) - 1u;
  while (cur != kNoBand) {
    // this band's rows keep their centres, the others walk NaNs
    float px[kRows], pz[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      px[r] = band[r] == cur ? cx[r] : nan;
      pz[r] = band[r] == cur ? cz[r] : nan;
    }
    const float2* bpos = pos + static_cast<size_t>(cur) * t_cap;
    const unsigned char* bact = active + static_cast<size_t>(cur) * t_cap;
    int j0 = 0;
    while (j0 < t_cap) {
      // one pass: stage up to kStageSlots active slots, in slot order
      __syncthreads();              // the last pass's walk is done
      int count = 0;
      while (j0 < t_cap && count + kThreads <= kStageSlots) {
        const int j = j0 + threadIdx.x;
        const bool live = j < t_cap && bact[j];
        const unsigned m = __ballot_sync(0xFFFFFFFFu, live);
        if (lane == 0) warp_count[warp] = __popc(m);
        __syncthreads();
        int off = count, round = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          off += w < warp ? warp_count[w] : 0;
          round += warp_count[w];
        }
        if (live) {
          const int k = off + __popc(m & below);
          slot_pos[k] = bpos[j];
          slot_id[k] = j;
        }
        count += round;
        j0 += kThreads;
        __syncthreads();            // warp_count is written again next round
      }
      int hit[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) hit[r] = -1;
#pragma unroll 4
      for (int k = 0; k < count; ++k) {
        const float2 p = slot_pos[k];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float ex = __fsub_rn(px[r], p.x);
          const float ez = __fsub_rn(pz[r], p.y);
          const float d = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ez, ez));
          if (d < best_d[r]) {
            best_d[r] = d;
            hit[r] = k;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (hit[r] >= 0) best[r] = slot_id[hit[r]];
      }
    }
    unsigned next = kNoBand;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (band[r] != kNoBand && band[r] > cur) next = min(next, band[r]);
    }
    cur = block_min(next, warp_min);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (band[r] != kNoBand) out[at[r]] = best[r];
  }
}

}  // namespace

// occ_idx i32[n_rows] global flat cell indices, occ_valid bool[n_rows],
// pos f32[n_bands, t_cap, 2] (8-byte aligned), active bool[n_bands, t_cap],
// lo f32[>= 3], s f32[1], out i32[n_bands, g, g]; all contiguous on the
// device.  A valid row whose index lies outside the grid writes nothing.
// One memset and at most one launch on `stream`; returns their CUDA error,
// or 0.
extern "C" int treee_nearest_slot(const int* occ_idx,
                                  const unsigned char* occ_valid,
                                  const float* pos,
                                  const unsigned char* active,
                                  const float* lo, const float* s, int* out,
                                  int n_rows, int n_bands, int t_cap, int g,
                                  cudaStream_t stream) {
  if (n_rows < 0 || n_bands < 0 || t_cap < 0 || g < 0) {
    return cudaErrorInvalidValue;
  }
  const long long cells = static_cast<long long>(n_bands) * g * g;
  if (cells > INT_MAX) return cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(pos) % alignof(float2)) {
    return cudaErrorMisalignedAddress;
  }
  const cudaError_t err =
      cudaMemsetAsync(out, 0xFF, static_cast<size_t>(cells) * sizeof(int),
                      stream);
  if (err != cudaSuccess) return err;
  if (n_rows == 0 || cells == 0) return cudaSuccess;
  const unsigned blocks =
      static_cast<unsigned>((n_rows + kTileRows - 1LL) / kTileRows);
  nearest_slot_kernel<<<blocks, kThreads, 0, stream>>>(
      occ_idx, occ_valid, reinterpret_cast<const float2*>(pos), active, lo, s,
      out, n_rows, n_bands, t_cap, g);
  return cudaGetLastError();
}

TREEE_PACKED(treee_nearest_slot)
