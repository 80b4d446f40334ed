// The focused view's exact k nearest neighbours: for each row of a tree's
// compacted member rows, the k rows nearest to it among the valid ones.
//
// Replaces no TPU kernel.  The JAX package selects with lax.top_k over a
// [tile, N] distance block (treee_tpu/ops/neighbors.py::knn_bruteforce), and
// so did the port: 40 tiles of 1024 queries at 40,960 rows, each building a
// [1024, N] f32 distance block and a [1024, N] int64 key block in device
// memory and running torch.topk's radix select over the keys: 127.9 of the
// 133.7 ms of a 40k tree's first open on the H100.  The plain version beside
// the wrapper (knn_select.py::knn_select_plain) is that code.  Contract,
// for every row q (valid or not) and every candidate row j: the distance is
// (dx*dx + dy*dy) + dz*dz with dx = x_q - x_j, each operation rounded (the
// library is built with -fmad=false, and the _rn intrinsics say so again);
// an invalid candidate's distance is exactly 3.0e38f; the key of (q, j) is
// the distance's bits as a signed i32 above j, a signed i64, as the plain
// version builds it; row q gets the k candidates of least key, ascending.
// So a query with fewer than k valid candidates is padded with the lowest
// invalid rows at 3.0e38, and the output equals the plain version's bit for
// bit whatever the bits of a distance are (inf and NaN included).
//
// What bounds it on the H100: operations.  The work is 8 operations a pair
// of rows (3 subtractions, 3 products, 2 sums): 1.34e10 at 40,960 rows, or
// 0.20 ms at 67 TFLOP/s; without FMA contraction each is one instruction,
// so the card's issue rate (128 lanes an SM a cycle) makes ~0.4 ms the
// floor.  The bytes are 13 a row in and 8k a row out (10 MB at 40,960 rows
// and k = 31: 3 us of HBM, hidden under the arithmetic).  Selection is
// cheap when a running threshold rejects most candidates: in a random
// order only k (1 + ln(N / k)) of N candidates ever improve a row's list.
// Design: a CTA takes a tile of kTileRows consecutive query rows, kQueries a
// warp, each warp's queries in registers of every lane.  The CTA stages the
// candidates kChunk at a time in shared memory as (x, y, z, fill) float4,
// double-buffered (the next chunk's loads issue before this chunk's walk),
// starting at the chunk of its own rows and wrapping, so rows stored near
// each other, often near in space, tighten the thresholds first.  A fill
// word carries what the contract asks of the candidate: 0 for a valid row,
// the bits of 3.0e38f for an invalid one, 0x7FFFFFFF for the padding past N
// (a key above every real one), applied as (bits & mask) | fill.  Each lane
// walks kPer candidates a step against its warp's kQueries queries and
// tests each distance's bits against the query's running k-th key: one
// compare a pair, with <= so that a tie on the distance goes on to the
// exact key compare.  The rare survivors go through the warp together: a
// query's k best keys lie sorted across the lanes' registers (position i in
// lane i % 32, register i / 32), and a survivor is inserted by one shuffle
// of the list up a lane, taking the new k-th key from its lane.  The
// insertion order does not matter: the k least keys of the whole set come
// out.  No [T, N] block touches device memory, and nothing synchronizes the
// host.  The candidate axis is not split over CTAs: tiles of 16 rows give
// 512 CTAs at 8,192 rows and 2,560 at 40,960, four resident an SM, and no
// merge pass or scratch is needed.  The insertions take about half of the
// time: with 4 queries a warp the distances and compares alone measured
// 0.043 / 0.141 / 0.741 ms at 8,192 / 16,384 / 40,960 rows of a tree; the
// whole kernel, 2 a warp, 0.175 / 0.409 / 1.555 ms.  More queries a warp
// share each staged candidate among more pairs but leave fewer warps to
// hide each insertion's chain of shuffles: 4 a warp measured 0.217 /
// 0.489 / 1.596 ms, 8 a warp 0.357 / 0.491 / 1.866; one candidate a lane
// a step was slower.
#include <cuda_runtime.h>

#include <climits>

#include "packed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueries = 2;                       // query rows a warp
constexpr int kTileRows = kWarps * kQueries;      // query rows a CTA
constexpr int kPer = 2;                           // candidates a lane a step
constexpr int kStep = 32 * kPer;                  // candidates a warp a step
constexpr int kChunk = 1024;                      // candidates staged a pass
constexpr int kStagePer = kChunk / kThreads;      // staged by each thread
constexpr int kMaxK = 64;                         // two list entries a lane
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPadFill = 0x7FFFFFFF;              // past N: above every key
constexpr long long kEmpty = LLONG_MAX;           // an unfilled list entry

static_assert(kChunk % kStep == 0, "a chunk is whole steps");
static_assert(kChunk % kThreads == 0, "every thread stages alike");

// Candidate j as staged: its coordinates and the fill word of its kind.
__device__ __forceinline__ float4 candidate(const float* __restrict__ pos,
                                            const unsigned char* __restrict__ valid,
                                            int j, int n, int inf_bits) {
  if (j >= n) return make_float4(0.0f, 0.0f, 0.0f, __int_as_float(kPadFill));
  const float* p = pos + 3LL * j;
  return make_float4(p[0], p[1], p[2],
                     __int_as_float(valid[j] ? 0 : inf_bits));
}

// The key of a candidate: its distance's bits as a signed i32 above its
// row, a signed i64 (the plain version's int64 key).
__device__ __forceinline__ long long key(int bits, int j) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(bits)) << 32) |
      static_cast<unsigned>(j));
}

// Insert key x into the sorted list held across the warp (position i in
// lane i % 32 of e0 for i < 32, of e1 above); entries past k stay empty.
// Returns the new k-th key.  Every lane of the warp calls it alike.
__device__ __forceinline__ long long insert(long long& e0, long long& e1,
                                            long long x, int k, int lane) {
  const long long p0 = __shfl_up_sync(kFull, e0, 1);
  const long long n0 = e0 < x ? e0 : ((lane == 0 || p0 < x) ? x : p0);
  if (k > 32) {
    const long long last0 = __shfl_sync(kFull, e0, 31);
    long long p1 = __shfl_up_sync(kFull, e1, 1);
    if (lane == 0) p1 = last0;
    const long long n1 = e1 < x ? e1 : (p1 < x ? x : p1);
    e1 = lane + 32 < k ? n1 : kEmpty;
  }
  e0 = lane < k ? n0 : kEmpty;
  return __shfl_sync(kFull, k > 32 ? e1 : e0, (k - 1) & 31);
}

__global__ void __launch_bounds__(kThreads, 2)
knn_select_kernel(const float* __restrict__ pos,
                  const unsigned char* __restrict__ valid,
                  int* __restrict__ idx, float* __restrict__ dist, int n,
                  int k) {
  __shared__ float4 stage[2][kChunk];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile0 = blockIdx.x * kTileRows;
  const int q0 = tile0 + warp * kQueries;
  const int inf_bits = __float_as_int(3.0e38f);   // neighbors.py's INF

  float qx[kQueries], qy[kQueries], qz[kQueries];
  long long e0[kQueries], e1[kQueries];
  int thr[kQueries];                // the k-th key's distance bits
#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    const int row = q0 + q;
    qx[q] = qy[q] = qz[q] = 0.0f;
    if (row < n) {
      qx[q] = pos[3LL * row];
      qy[q] = pos[3LL * row + 1];
      qz[q] = pos[3LL * row + 2];
    }
    e0[q] = e1[q] = kEmpty;
    thr[q] = INT_MAX;
  }

  const int n_chunks = (n + kChunk - 1) / kChunk;
  const int first = tile0 / kChunk;
#pragma unroll
  for (int r = 0; r < kStagePer; ++r) {
    const int s = r * kThreads + threadIdx.x;
    stage[0][s] = candidate(pos, valid, first * kChunk + s, n, inf_bits);
  }
  __syncthreads();

  for (int t = 0; t < n_chunks; ++t) {
    int c = first + t;
    if (c >= n_chunks) c -= n_chunks;
    const bool more = t + 1 < n_chunks;
    float4 next[kStagePer];
    if (more) {
      const int cn = c + 1 < n_chunks ? c + 1 : 0;
#pragma unroll
      for (int r = 0; r < kStagePer; ++r) {
        next[r] = candidate(pos, valid, cn * kChunk + r * kThreads +
                            threadIdx.x, n, inf_bits);
      }
    }
    const float4* buf = stage[t & 1];
    const int base = c * kChunk;
    for (int s = 0; s < kChunk; s += kStep) {
      float cx[kPer], cy[kPer], cz[kPer];
      int fill[kPer], mask[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const float4 p = buf[s + u * 32 + lane];
        cx[u] = p.x;
        cy[u] = p.y;
        cz[u] = p.z;
        fill[u] = __float_as_int(p.w);
        mask[u] = fill[u] ? 0 : -1;
      }
      int bits[kQueries][kPer];
      bool hit = false;
#pragma unroll
      for (int q = 0; q < kQueries; ++q) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const float dx = __fsub_rn(qx[q], cx[u]);
          const float dy = __fsub_rn(qy[q], cy[u]);
          const float dz = __fsub_rn(qz[q], cz[u]);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                              __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          bits[q][u] = (__float_as_int(d) & mask[u]) | fill[u];
          hit |= bits[q][u] <= thr[q];
        }
      }
      if (!__any_sync(kFull, hit)) continue;
#pragma unroll
      for (int q = 0; q < kQueries; ++q) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          unsigned live = __ballot_sync(kFull, bits[q][u] <= thr[q]);
          if (!live) continue;
          long long kth = __shfl_sync(kFull, k > 32 ? e1[q] : e0[q],
                                      (k - 1) & 31);
          while (live) {
            const int src = __ffs(live) - 1;
            live &= live - 1;
            const int b = __shfl_sync(kFull, bits[q][u], src);
            const long long x = key(b, base + s + u * 32 + src);
            if (x < kth) kth = insert(e0[q], e1[q], x, k, lane);
          }
          thr[q] = static_cast<int>(kth >> 32);
        }
      }
    }
    if (more) {
#pragma unroll
      for (int r = 0; r < kStagePer; ++r) {
        stage[(t + 1) & 1][r * kThreads + threadIdx.x] = next[r];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    const long long row = q0 + q;
    if (row >= n) continue;
    if (lane < k) {
      idx[row * k + lane] = static_cast<int>(e0[q] & 0xFFFFFFFFLL);
      dist[row * k + lane] = __int_as_float(static_cast<int>(e0[q] >> 32));
    }
    if (lane + 32 < k) {
      idx[row * k + lane + 32] = static_cast<int>(e1[q] & 0xFFFFFFFFLL);
      dist[row * k + lane + 32] =
          __int_as_float(static_cast<int>(e1[q] >> 32));
    }
  }
}

}  // namespace

// pos f32[n, 3], valid bool[n], idx i32[n, k], dist f32[n, k]; all
// contiguous on the device; 1 <= k <= 64 and k <= n unless n is 0.
// At most one launch on `stream`; returns its CUDA error, or 0.
extern "C" int treee_knn_select(const float* pos, const unsigned char* valid,
                                int* idx, float* dist, int n, int k,
                                cudaStream_t stream) {
  if (n < 0 || k < 1 || k > kMaxK || (n > 0 && k > n)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const unsigned blocks =
      static_cast<unsigned>((n + kTileRows - 1LL) / kTileRows);
  knn_select_kernel<<<blocks, kThreads, 0, stream>>>(pos, valid, idx, dist,
                                                     n, k);
  return cudaGetLastError();
}

TREEE_PACKED(treee_knn_select)
