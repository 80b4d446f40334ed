// Top-down band tracking: mutual-nearest matching of each band's clusters to
// the tracked centroids, then allocation of free slots to the new clusters.
//
// Replaces treee_tpu/ops/pallas_kernels.py::_match_kernel (:302, called
// through match_scan_pallas at :417), which mirrors
// treee_tpu/segmentation.py::_match_band.  Per band, `rounds` rounds of:
// distance d[t][c] = sqrt(dx*dx + dz*dz) between active slot t and untaken
// cluster c (3e38 otherwise); each slot's nearest cluster and each cluster's
// nearest slot, ties to the lowest index; pairs that choose each other within
// the radius move the slot onto the cluster and take the cluster.  Then the
// k-th new cluster takes the k-th free slot by index.  Per-band snapshots of
// (position, active) and the final allocation count are the outputs.
// Compiled without FMA contraction, so the distances, argmins and outputs
// equal the plain PyTorch version bit for bit.
//
// What bounds it on the H100: the bands are sequential, since each one
// matches against the state the previous one left, and each band-round is a
// small tile (at most T=2048 slots x C=256 clusters) whose cost is the
// correctly rounded sqrt of every distance; launching per band or per round
// costs more than the work, and one SM alone (the first design) leaves 131
// idle for the whole scan.
//
// Design: one thread-block cluster of kCtas CTAs (8, the portable size) in
// one launch.  Every CTA keeps a replica of the tracked state (x, z, active
// of all T slots) and of the band's clusters in shared memory, and applies
// the same updates to it, so the allocation and the snapshots need no
// exchange; only the distance tile is split.  Per round the active slots and
// the untaken clusters are compacted (in index order), and CTA k takes the
// k-th contiguous share of the active slots (split by count, not by slot
// index: the active slots crowd the low indices).  Its threads split that
// share x the untaken clusters two-dimensionally (lanes over up to 8
// clusters each, slots over warps and lane groups), and each distance is
// computed once and fed to both argmins as a packed (value bits << 32 |
// index) key: the minimum key is the lowest index among the smallest values,
// since the values are non-negative floats.  A slot's nearest cluster is
// finished inside its CTA (shuffles, then a shared-memory atomicMin); a
// cluster's nearest slot is a per-CTA partial.  After cluster.sync() every
// CTA reduces the kCtas partials of each cluster from the other CTAs' shared
// memory (DSMEM), reads the winning slot's row key from its owner CTA, and
// applies the mutual pairs to its replica; no CTA writes another's shared
// memory.  The per-round keys are double-buffered, so one cluster.sync() a
// round suffices.  The k-th new cluster takes the k-th free slot as before,
// each CTA on its replica, and CTA k writes the snapshots of its T/kCtas
// slots.  The argmins compare the sqrt values, as JAX does: a squared
// distance would break ties that the rounded sqrt makes.  A band without new
// clusters skips the allocation's scan.
//
// ptxas (nvcc 12.9, sm_90a): 99 registers, no spills, 512 threads a CTA.  A
// 16-CTA cluster (the non-portable size) was 1% faster on the main path's
// inputs, within the spread, so the kernel keeps the portable 8.  What
// bounds it now: the ~6 block barriers and one cluster barrier of each round
// and band, not the distances (64 bands, 14 of them with clusters, on the
// main path's 15M scan).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 8;                    // CTAs a cluster (portable size)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                    // clusters a lane holds per pass
constexpr int kMaxSmem = 232448;            // opt-in shared memory per block
constexpr float kInf = 3.0e38f;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ float distance(float x, float z, float cx,
                                          float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dz = __fsub_rn(z, cz);
  return sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)));
}

__device__ __forceinline__ unsigned long long pack(float v, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         static_cast<unsigned>(i);
}

__device__ __forceinline__ float key_val(unsigned long long k) {
  return __uint_as_float(static_cast<unsigned>(k >> 32));
}

__device__ __forceinline__ int key_idx(unsigned long long k) {
  return static_cast<int>(k & 0xFFFFFFFFu);
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return b < a ? b : a;
}

// Exclusive prefix sum of one int per thread over the block; *total gets the
// block sum.  `warp_sums` holds kWarps ints of shared memory.
__device__ int block_exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int prefix = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return prefix;
}

// The untaken clusters in index order into `ulist`; returns their count.
__device__ int compact_untaken(const int* taken, int c_cap, int* ulist,
                               int* warp_sums) {
  const int c_per = (c_cap + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * c_per, c_cap);
  const int hi = min(lo + c_per, c_cap);
  int n = 0;
  for (int c = lo; c < hi; ++c) n += taken[c] ? 0 : 1;
  int total;
  int k = block_exclusive_sum(n, warp_sums, &total);
  for (int c = lo; c < hi; ++c) {
    if (!taken[c]) ulist[k++] = c;
  }
  __syncthreads();
  return total;
}

size_t smem_bytes(int c_cap, int t_cap, int n_cta) {
  const size_t chunk_cap = (t_cap + n_cta - 1) / n_cta;
  return 8 * (2 * chunk_cap + 2 * static_cast<size_t>(c_cap)) +
         4 * (4 * static_cast<size_t>(t_cap) + 5 * static_cast<size_t>(c_cap) +
              kWarps);
}

__global__ void __launch_bounds__(kThreads, 1)
match_scan_cluster(const float* __restrict__ cents,
                   const uint8_t* __restrict__ cmask, int n_bands, int c_cap,
                   int t_cap, int rounds, float radius,
                   float* __restrict__ out_pos, uint8_t* __restrict__ out_act,
                   int* __restrict__ out_n_alloc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk_cap = (t_cap + n_cta - 1) / n_cta;

  extern __shared__ unsigned long long smem_keys[];
  unsigned long long* row_key = smem_keys;                   // [2][chunk_cap]
  unsigned long long* col_part = row_key + 2 * chunk_cap;    // [2][C]
  float* px = reinterpret_cast<float*>(col_part + 2 * c_cap);  // [T]
  float* pz = px + t_cap;                                    // [T]
  int* act = reinterpret_cast<int*>(pz + t_cap);             // [T]
  int* alist = act + t_cap;            // [T] active slots in index order
  float* cx = reinterpret_cast<float*>(alist + t_cap);       // [C]
  float* cz = cx + c_cap;                                    // [C]
  int* taken = reinterpret_cast<int*>(cz + c_cap);           // [C]
  int* ulist = taken + c_cap;          // [C] untaken clusters in index order
  int* moved = ulist + c_cap;          // [C] slot that takes ulist[u], or -1
  int* warp_sums = moved + c_cap;                            // [kWarps]

  const int t_per = (t_cap + kThreads - 1) / kThreads;
  const int t_lo = min(tid * t_per, t_cap);
  const int t_hi = min(t_lo + t_per, t_cap);
  const int o_lo = min(rank * chunk_cap, t_cap);  // this CTA's snapshot slots
  const int o_hi = min(o_lo + chunk_cap, t_cap);

  for (int t = tid; t < t_cap; t += kThreads) {
    px[t] = 0.0f;
    pz[t] = 0.0f;
    act[t] = 0;
  }
  int n_alloc = 0;
  int n_act = 0;     // active slots; alist[0, n_act) lists them
  int parity = 0;    // which half of row_key / col_part this round uses

  for (int band = 0; band < n_bands; ++band) {
    const size_t cb = static_cast<size_t>(band) * c_cap;
    for (int c = tid; c < c_cap; c += kThreads) {
      cx[c] = cents[2 * (cb + c)];
      cz[c] = cents[2 * (cb + c) + 1];
      taken[c] = cmask[cb + c] ? 0 : 1;
    }
    __syncthreads();
    int n_un = compact_untaken(taken, c_cap, ulist, warp_sums);

    for (int r = 0; r < rounds && n_act > 0 && n_un > 0; ++r) {
      // this CTA's share of the active slots, by count
      const int chunk = (n_act + n_cta - 1) / n_cta;
      const int i_lo = min(rank * chunk, n_act);
      const int n_mine = min(i_lo + chunk, n_act) - i_lo;
      unsigned long long* rk = row_key + parity * chunk_cap;
      unsigned long long* cp = col_part + parity * c_cap;
      for (int i = tid; i < n_mine; i += kThreads) rk[i] = kNone;
      for (int u = tid; u < n_un; u += kThreads) cp[u] = kNone;
      __syncthreads();

      // the n_mine x n_un tile: tx_n lanes share a slot, each holding up to
      // kCols clusters; the warp's 32 / tx_n lane groups take other slots
      int tx_n = 1;
      while (tx_n < 32 && tx_n * kCols < n_un) tx_n <<= 1;
      const int groups = 32 / tx_n;
      const int tx = lane & (tx_n - 1);
      const int gy = lane / tx_n;
      for (int u0 = 0; u0 < n_un; u0 += tx_n * kCols) {
        int cid[kCols];
        float ccx[kCols], ccz[kCols];
        unsigned long long col[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int u = u0 + tx + j * tx_n;
          cid[j] = u < n_un ? ulist[u] : -1;
          ccx[j] = cid[j] >= 0 ? cx[cid[j]] : 0.0f;
          ccz[j] = cid[j] >= 0 ? cz[cid[j]] : 0.0f;
          col[j] = kNone;
        }
        for (int i0 = warp * groups; i0 < n_mine; i0 += kWarps * groups) {
          const int il = i0 + gy;
          const bool ok = il < n_mine;
          const int i = i_lo + il;
          float x = 0.0f, z = 0.0f;
          if (ok) {
            const int t = alist[i];
            x = px[t];
            z = pz[t];
          }
          unsigned long long rowk = kNone;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            if (ok && cid[j] >= 0) {
              const float d = distance(x, z, ccx[j], ccz[j]);
              rowk = kmin(rowk, pack(d, cid[j]));
              col[j] = kmin(col[j], pack(d, i));
            }
          }
          for (int o = tx_n >> 1; o > 0; o >>= 1)
            rowk = kmin(rowk, __shfl_xor_sync(kFull, rowk, o));
          if (ok && tx == 0) atomicMin(&rk[il], rowk);
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          for (int o = 16; o >= tx_n; o >>= 1)
            col[j] = kmin(col[j], __shfl_xor_sync(kFull, col[j], o));
          if (gy == 0 && cid[j] >= 0)
            atomicMin(&cp[u0 + tx + j * tx_n], col[j]);
        }
      }
      cluster.sync();   // every CTA's row keys and column partials are done

      // each cluster's nearest slot over the CTAs, and whether that slot
      // chose the cluster back within the radius
      for (int u = tid; u < n_un; u += kThreads) {
        unsigned long long best = kNone;
        for (int k = 0; k < n_cta; ++k)
          best = kmin(best, *cluster.map_shared_rank(cp + u, k));
        int mv = -1;
        if (best != kNone) {
          const int i = key_idx(best);
          const int owner = i / chunk;
          const unsigned long long rkk =
              *cluster.map_shared_rank(rk + (i - owner * chunk), owner);
          if (key_idx(rkk) == ulist[u] && key_val(rkk) <= radius)
            mv = alist[i];
        }
        moved[u] = mv;
      }
      __syncthreads();
      for (int u = tid; u < n_un; u += kThreads) {
        const int t = moved[u];
        if (t >= 0) {
          const int c = ulist[u];
          px[t] = cx[c];
          pz[t] = cz[c];
          taken[c] = 1;
        }
      }
      __syncthreads();
      parity ^= 1;
      n_un = compact_untaken(taken, c_cap, ulist, warp_sums);
    }

    // the k-th new (untaken) cluster takes the k-th free slot by index; the
    // active list is rebuilt on the way: an active slot's rank is its index
    // less the free slots before it that stay free
    if (n_un > 0) {
      int f_mine = 0;
      for (int t = t_lo; t < t_hi; ++t) f_mine += act[t] ? 0 : 1;
      int n_free;
      int frank = block_exclusive_sum(f_mine, warp_sums, &n_free);
      const int n_ok = min(n_un, n_free);
      for (int t = t_lo; t < t_hi; ++t) {
        if (act[t]) {
          alist[t - max(0, frank - n_ok)] = t;
          continue;
        }
        if (frank < n_ok) {
          const int c = ulist[frank];
          px[t] = cx[c];
          pz[t] = cz[c];
          act[t] = 1;
          alist[t] = t;
        }
        ++frank;
      }
      n_alloc += n_ok;
      n_act += n_ok;
    }
    __syncthreads();

    const size_t tb = static_cast<size_t>(band) * t_cap;
    for (int t = o_lo + tid; t < o_hi; t += kThreads) {
      reinterpret_cast<float2*>(out_pos)[tb + t] = make_float2(px[t], pz[t]);
      out_act[tb + t] = act[t] ? 1 : 0;
    }
  }
  if (rank == 0 && tid == 0) *out_n_alloc = n_alloc;
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

}  // namespace

// cents f32[b,c,2], cmask u8[b,c] -> tracked_pos f32[b,t,2], active u8[b,t],
// n_alloc i32[1], all on the device.  One cluster launch on `stream`.
// Returns its CUDA error, or 0.
extern "C" int treee_match_scan(const float* cents, const uint8_t* cmask,
                                int b, int c_cap, int t_cap, int rounds,
                                float radius, float* tracked_pos,
                                uint8_t* active, int* n_alloc,
                                cudaStream_t stream) {
  if (b <= 0 || c_cap <= 0 || t_cap <= 0 || rounds < 0 || !(radius < kInf))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(c_cap, t_cap, kCtas);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      match_scan_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, match_scan_cluster, cents, cmask, b, c_cap,
                           t_cap, rounds, radius, tracked_pos, active,
                           n_alloc);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

TREEE_PACKED(treee_match_scan)
