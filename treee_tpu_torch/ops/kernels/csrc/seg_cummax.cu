// Forward inclusive cumulative max within runs of equal sorted keys.
//
// Replaces treee_tpu/ops/pallas_kernels.py::_seg_cummax_kernel (called
// through segmented_cummax_pallas).  key i32[N] is sorted ascending, so each
// run of equal keys is contiguous; val and out are f32[N,C], row-major, C in
// 1..16.  out[i,c] = max of val[j,c] over the j <= i in i's run.  Keys are
// compared as integers, so there is no 2^24 limit.
//
// The max and its tie rule.  Every value is mapped to an i32 whose signed
// order is the order of the floats, -0.0 just below +0.0, every NaN at one
// place above +inf:
//     order(x) = isnan(x) ? 0x7FC00000 : bits ^ ((bits >> 31) & 0x7FFFFFFF)
// The scan is an integer max over these, and the same map (it is its own
// inverse) turns the result back into a float.  An integer max gives the
// same bits in any grouping, so the kernel is free to combine in any order
// and still equals the plain PyTorch version, which does the same, bit for
// bit: max(+0.0, -0.0) is +0.0 whichever comes first (as XLA's maximum has
// it), and a run that has met a NaN holds the NaN 0x7FC00000 from there on.
//
// What bounds it on the H100: device memory (at N=15M, C=8: 480 MB of values
// in, 480 MB out, 60 MB of keys); one integer max a value is far below the
// card's rate.  So the design reads key and val once, writes out once, all in
// 16-byte coalesced accesses, in one launch, and keeps nothing else in
// device memory but one descriptor a tile:
//   - A tile is R = 256 * K consecutive rows, one contiguous span of R*C*4
//     bytes whatever C.  K rows a thread: 16 for C <= 2, 8 for C <= 4, else 4,
//     so a tile holds 16 to 64 KB of values and three to five tiles fit an
//     SM; the loads of one overlap the scans and stores of the others.  The
//     span comes in with 16-byte cp.async copies (values and keys alike).
//   - In shared memory thread t's K*C values (a multiple of 4) lie together,
//     and each thread's region starts one 16-byte chunk further when its
//     length in chunks is even, so that the threads' 16-byte reads and writes
//     of their own regions meet no bank conflict.
//   - A thread scans its K rows serially, twice over shared memory: first
//     the running max from its own first row (written back in place) and the
//     max of its trailing run; after the carries are known, the max carried
//     into its leading run is folded in and the floats restored.  A row's
//     "head" flag (its key differs from the row before, read once from the
//     keys) replaces every later key compare.
//   - Across the 256 threads the (has a head, trailing max) pairs are
//     scanned by shuffles inside each warp (the segment start of a lane comes
//     from one ballot), and the 8 warp totals are combined through shared
//     memory: two block barriers, no log2(256) loop.
//   - Across tiles: a decoupled look-back.  A CTA takes its tile number from
//     an atomic counter, so a tile only ever waits for tiles that already
//     run.  It publishes the C maxima of its trailing run and a status:
//     INCLUSIVE when the tile holds a head (the maxima are then final for
//     that key), else AGGREGATE (the whole tile continues its predecessor's
//     run).  A tile whose first row continues a run looks back with one
//     warp, 32 predecessors a step: it takes every AGGREGATE up to the
//     nearest INCLUSIVE, stops there, and if it was itself an AGGREGATE
//     publishes its INCLUSIVE maxima.  Whether a tile continues a run is read
//     from the keys (key[lo-1] == key[lo]), so a descriptor is a status word
//     and C values.  The values are stored first, the status after them with
//     st.release.gpu; a reader takes the status with ld.acquire.gpu and the
//     values after it, past L1.  The carry is folded into the tile before its
//     one write of out.
//   - The statuses and the counter are cleared by a cudaMemsetAsync on the
//     same stream on every call (4 bytes a tile).
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = INT32_MIN;  // below order(x) of every float x
constexpr int kEmpty = 0, kAggregate = 1, kInclusive = 2;

// rows of a tile: 256 threads of 16, 8 or 4 rows each
__host__ __device__ constexpr int rows_per_tile(int c) {
  return kThreads * (c <= 2 ? 16 : c <= 4 ? 8 : 4);
}

template <int C>
struct Shape {
  static constexpr int R = rows_per_tile(C);   // rows a tile
  static constexpr int K = R / kThreads;       // rows a thread
  // 16-byte chunks of one thread's values and keys, and the chunks from one
  // thread's region to the next (odd, so 8 lanes' chunks fall in 8 banks)
  static constexpr int VM = K * C / 4;
  static constexpr int VP = VM + (VM % 2 == 0);
  static constexpr int KM = K / 4;
  static constexpr int KP = KM + (KM % 2 == 0);
  static constexpr int smem = (VP + KP) * kThreads * 16;
};

// the order-preserving map between float bits and i32 (its own inverse on
// everything but the NaNs, which all become 0x7FC00000)
__device__ __forceinline__ int order(int bits) {
  return (bits & 0x7FFFFFFF) > 0x7F800000
             ? 0x7FC00000
             : bits ^ ((bits >> 31) & 0x7FFFFFFF);
}
__device__ __forceinline__ int unorder(int k) {
  return k ^ ((k >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Maxima carried into tile `tile` from the tiles before it, which all lie in
// the run of its first row up to the nearest INCLUSIVE one.  Called by one
// whole warp; every lane returns the same acc.
template <int C>
__device__ __forceinline__ void look_back(int tile, const int* status,
                                          const int* agg, const int* incl,
                                          int lane, int (&acc)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = kNone;
  for (int base = tile - 1;; base -= 32) {
    const int p = base - lane;  // tile 0 is INCLUSIVE, so p < 0 is never used
    int st, first;
    for (;;) {
      st = p >= 0 ? ld_acquire(status + p) : kInclusive;
      const unsigned inc = __ballot_sync(~0u, st == kInclusive);
      const unsigned emp = __ballot_sync(~0u, st == kEmpty);
      first = inc ? __ffs(inc) - 1 : 32;
      // every tile nearer than the first INCLUSIVE one must have published
      const unsigned upto = first >= 31 ? ~0u : (2u << first) - 1;
      if ((emp & upto) == 0) break;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int x = kNone;
      if (lane < first) x = __ldcg(agg + static_cast<long long>(p) * C + c);
      if (lane == first) x = __ldcg(incl + static_cast<long long>(p) * C + c);
      acc[c] = max(acc[c], __reduce_max_sync(~0u, x));
    }
    if (first < 32) return;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
scan_tiles(const int* __restrict__ key, const float* __restrict__ val,
           float* __restrict__ out, long long n, int* __restrict__ counter,
           int* __restrict__ status, int* __restrict__ agg,
           int* __restrict__ incl) {
  using S = Shape<C>;
  constexpr int K = S::K;
  extern __shared__ int4 smem[];
  int4* s_val = smem;                        // kThreads regions of VP chunks
  int4* s_key = smem + S::VP * kThreads;     // kThreads regions of KP chunks
  __shared__ int s_tile;
  __shared__ int s_wv[kWarps][C];
  __shared__ int s_wf[kWarps];
  __shared__ int s_agg[C];
  __shared__ int s_carry[C];
  __shared__ int s_has_head;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long lo = static_cast<long long>(tile) * S::R;
  const int rows = static_cast<int>(n - lo < S::R ? n - lo : S::R);
  const int words = rows * C;
  const int v_chunks = (words + 3) / 4, k_chunks = (rows + 3) / 4;

  // the tile's values and keys, 16 bytes a copy, neighbouring threads on
  // neighbouring addresses; the last chunk of a ragged tile is cut short
  const float* v_src = val + lo * C;
  for (int g = tid; g < v_chunks; g += kThreads) {
    const int left = (words - 4 * g) * 4;
    cp_async16(s_val + (g / S::VM) * S::VP + g % S::VM, v_src + 4 * g,
               left < 16 ? left : 16);
  }
  for (int g = tid; g < k_chunks; g += kThreads) {
    const int left = (rows - 4 * g) * 4;
    cp_async16(s_key + (g / S::KM) * S::KP + g % S::KM, key + lo + 4 * g,
               left < 16 ? left : 16);
  }
  // the key before this thread's first row: the tile's first row looks into
  // the tile before it
  int prev_key = 0;
  if (tid == 0 && tile > 0) prev_key = key[lo - 1];
  cp_async_wait_all();
  __syncthreads();

  // head flags: bit i says that row i of this thread starts a run
  const int kt = min(max(rows - tid * K, 0), K);  // this thread's rows
  unsigned heads = 0;
  {
    if (tid > 0) {
      const int g = (tid * K - 1) / 4;
      prev_key = reinterpret_cast<const int*>(
          s_key + (g / S::KM) * S::KP + g % S::KM)[3];
    }
    const bool first_of_all = tid == 0 && tile == 0;
#pragma unroll
    for (int j = 0; j < S::KM; ++j) {
      const int4 q = s_key[tid * S::KP + j];
      const int k[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * j + u;
        if (i < kt && (k[u] != prev_key || (i == 0 && first_of_all)))
          heads |= 1u << i;
        prev_key = k[u];
      }
    }
  }

  // pass 1: running max from this thread's first row, in place, as order()
  // values; v ends as the max of the thread's trailing run
  int v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = kNone;
#pragma unroll
  for (int j = 0; j < S::VM; ++j) {
    int4 q = s_val[tid * S::VP + j];
    int e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = (4 * j + u) / C, c = (4 * j + u) % C;
      if (i < kt) {
        const int x = order(e[u]);
        v[c] = (heads >> i & 1) ? x : max(v[c], x);
        e[u] = v[c];
      }
    }
    s_val[tid * S::VP + j] = make_int4(e[0], e[1], e[2], e[3]);
  }

  // inclusive segmented max over the threads of a warp: lane l takes the
  // lanes back to the nearest one at or before it that holds a head
  const unsigned head_lanes = __ballot_sync(~0u, heads != 0);
  const unsigned at_or_before = head_lanes & ((2u << lane) - 1);
  const int seg_start = at_or_before ? 31 - __clz(at_or_before) : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool take = lane >= d && lane - d >= seg_start;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int o = __shfl_up_sync(~0u, v[c], d);
      if (take) v[c] = max(v[c], o);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < C; ++c) s_wv[warp][c] = v[c];
    s_wf[warp] = head_lanes != 0;
  }
  __syncthreads();

  // p: the max of the run that reaches this warp's first row, over the warps
  // before it; p_head: whether that run starts inside the tile
  int p[C];
  bool p_head = false;
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = kNone;
  for (int w = 0; w < warp; ++w) {
    const bool f = s_wf[w] != 0;
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = f ? s_wv[w][c] : max(p[c], s_wv[w][c]);
    p_head |= f;
  }
  if (tid == kThreads - 1) {
    // the tile's trailing run
#pragma unroll
    for (int c = 0; c < C; ++c)
      s_agg[c] = at_or_before ? v[c] : max(p[c], v[c]);
    s_has_head = at_or_before != 0 || p_head;
  }
  // e: the max carried into this thread's leading run from inside the tile;
  // e_head: whether that run starts inside the tile
  const bool before = (head_lanes & ((1u << lane) - 1)) != 0;
  const bool e_head = before || p_head;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int o = __shfl_up_sync(~0u, v[c], 1);
    v[c] = lane == 0 ? p[c] : before ? o : max(p[c], o);
  }
  __syncthreads();

  if (warp == 0) {
    // publish, look back, publish again
    const bool has_head = s_has_head != 0;
    const bool continues = !__shfl_sync(~0u, heads & 1u, 0);
    int* mine = (has_head ? incl : agg) + static_cast<long long>(tile) * C;
    if (lane < C) __stcg(mine + lane, s_agg[lane]);
    __threadfence();
    __syncwarp();
    if (lane == 0) st_release(status + tile, has_head ? kInclusive : kAggregate);
    int acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = kNone;
    if (continues) look_back<C>(tile, status, agg, incl, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) s_carry[c] = acc[c];
    }
    if (!has_head) {
      __syncwarp();
      if (lane < C)
        __stcg(incl + static_cast<long long>(tile) * C + lane,
               max(s_agg[lane], s_carry[lane]));
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(status + tile, kInclusive);
    }
  }
  __syncthreads();
  if (!e_head) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = max(v[c], s_carry[c]);
  }

  // pass 2: fold the carry into the rows before this thread's first head,
  // back to floats
  const int lead = heads ? __ffs(heads) - 1 : K;
#pragma unroll
  for (int j = 0; j < S::VM; ++j) {
    int4 q = s_val[tid * S::VP + j];
    int e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = (4 * j + u) / C, c = (4 * j + u) % C;
      if (i < kt) e[u] = unorder(i < lead ? max(e[u], v[c]) : e[u]);
    }
    s_val[tid * S::VP + j] = make_int4(e[0], e[1], e[2], e[3]);
  }
  __syncthreads();

  float* o_dst = out + lo * C;
  for (int g = tid; g < v_chunks; g += kThreads) {
    const int4 q = s_val[(g / S::VM) * S::VP + g % S::VM];
    if (4 * g + 4 <= words) {
      reinterpret_cast<int4*>(o_dst)[g] = q;
    } else {
      const int e[4] = {q.x, q.y, q.z, q.w};
      for (int u = 0; 4 * g + u < words; ++u)
        o_dst[4 * g + u] = __int_as_float(e[u]);
    }
  }
}

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

long long n_tiles(long long n, int c) {
  const int r = rows_per_tile(c);
  return (n + r - 1) / r;
}

// the cleared part: the tile counter and one status a tile
size_t cleared_bytes(long long nb) { return align256(sizeof(int) * (1 + nb)); }

template <int C>
cudaError_t run(const int* key, const float* val, float* out, long long n,
                char* scratch, cudaStream_t stream) {
  const long long nb = n_tiles(n, C);
  int* counter = reinterpret_cast<int*>(scratch);
  int* status = counter + 1;
  int* agg = reinterpret_cast<int*>(scratch + cleared_bytes(nb));
  int* incl = agg + nb * C;
  cudaError_t err = cudaMemsetAsync(scratch, 0, cleared_bytes(nb), stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scan_tiles<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape<C>::smem);
  if (err != cudaSuccess) return err;
  scan_tiles<C><<<static_cast<unsigned>(nb), kThreads, Shape<C>::smem,
                  stream>>>(key, val, out, n, counter, status, agg, incl);
  return cudaGetLastError();
}

}  // namespace

// scratch: the tile counter and the statuses, then each tile's AGGREGATE and
// INCLUSIVE maxima (c values each)
extern "C" long long treee_seg_cummax_scratch_bytes(long long n, int c) {
  if (n <= 0 || c < 1 || c > 16) return 0;
  const long long nb = n_tiles(n, c);
  return static_cast<long long>(cleared_bytes(nb) + 2 * sizeof(int) * nb * c);
}

// key i32[n], val/out f32[n,c] on the device, each 16-byte aligned; scratch
// holds treee_seg_cummax_scratch_bytes(n, c) bytes and needs no clearing.
// One memset and one launch on `stream`.  Returns the first CUDA error, or 0.
extern "C" int treee_seg_cummax(const int* key, const float* val, float* out,
                                long long n, int c, void* scratch,
                                cudaStream_t stream) {
  if (n <= 0 || n >= (1LL << 40)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(key) | reinterpret_cast<uintptr_t>(val) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  char* s = static_cast<char*>(scratch);
  switch (c) {
#define TREEE_CASE(C) \
  case C:             \
    return run<C>(key, val, out, n, s, stream);
    TREEE_CASE(1) TREEE_CASE(2) TREEE_CASE(3) TREEE_CASE(4)
    TREEE_CASE(5) TREEE_CASE(6) TREEE_CASE(7) TREEE_CASE(8)
    TREEE_CASE(9) TREEE_CASE(10) TREEE_CASE(11) TREEE_CASE(12)
    TREEE_CASE(13) TREEE_CASE(14) TREEE_CASE(15) TREEE_CASE(16)
#undef TREEE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

TREEE_PACKED(treee_seg_cummax)
