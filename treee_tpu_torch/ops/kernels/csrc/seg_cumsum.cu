// Forward inclusive sum within runs of equal sorted keys, in the TPU
// kernel's summation order.
//
// Replaces treee_tpu/ops/pallas_kernels.py::_seg_cumsum_kernel (called
// through segmented_cumsum_pallas).  key i32[N] is sorted ascending; val and
// out are f32[N,C], row-major.  A float sum depends on its order, and the
// order is part of what the TPU kernel computes, so this kernel keeps it:
//   1. the rows are cut into blocks of `block` rows (a power of two);
//   2. inside a block, steps s = 1, 2, 4, ... < block each add to every row
//      r the value of row r-s when r >= s and both keys are equal, and +0.0
//      otherwise (so a -0.0 turns into +0.0, as in JAX);
//   3. block by block, the rows whose key equals the previous block's last
//      key add that last row's final value (its own sum plus its carry).
// The output equals the plain PyTorch version bit for bit: every addition
// is one IEEE f32 add of the same two values (__fadd_rn, -fmad=false).
// Keys are compared as integers, so there is no 2^24 limit.
//
// What bounds it on the H100: device memory first (at N = 15M, C = 3: 180 MB
// of values in, 180 MB out, 60 MB of keys), and close behind it the
// log2(block) = 13 additions a value: ten of them need a round trip through
// shared memory, which at 8 bytes a value and step is as much time as the
// device memory takes.  What the design does about both:
//   - One CTA a block, all channels at once, one launch.  The block's rows
//     are one contiguous span of block*C*4 bytes; it comes into shared memory
//     with 16-byte cp.async copies, neighbouring threads on neighbouring
//     addresses, is scanned there in place in its row-major layout, takes its
//     carry there, and leaves with 16-byte stores: val is read once and out
//     written once, whatever C.  8192 rows of up to 6 channels fit beside the
//     block's keys (224 KB, one CTA an SM); a wider C at that block size
//     takes one launch for every 6 channels, gathered and scattered element
//     by element.
//   - Thread t of T = min(block, 1024) owns rows t, t+T, t+2T, ... and keeps
//     their values in registers, up to 4 channels at a time.  A step s < T
//     reads row r-s from shared memory (lanes on consecutive rows, 4, 8 or
//     16 bytes an access so that no bank is met twice), one barrier, writes
//     the new value, one barrier: two barriers a step for all the channels
//     of a group, not two a channel.  A step s >= T pairs rows of one thread
//     and touches neither shared memory nor a barrier.  At the default block
//     size the width is a template parameter, so that a thread's rows lie at
//     constant offsets and its 64 registers go to the values.
//   - "Same run as the row s back" is s <= r - start(r), where start(r), the
//     first row of r's run inside the block, is found once a block from the
//     rows' head flags (a ballot inside each warp's 32 rows, one small scan
//     across them), while the values are still on their way, and kept in a
//     register.
//   - The carry is a recurrence over the blocks in a fixed order:
//     inc(b) = last row of b, plus inc(b-1) where b holds no run start.  It
//     is neither reassociated nor waited for block by block.  A block takes
//     its number from an atomic counter (so every block before it already
//     runs), publishes its last row (values, then a status with
//     st.release.gpu), and where it continues a run, one warp walks back to
//     the nearest block whose inc is already known (any block that holds a
//     run start; a block that has published its inc), then forward again,
//     adding each last row in the recurrence's own order.  The walk is as
//     long as the blocks in flight, not as the run.  The carry goes into the
//     leading run before the block's one write of out.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxItems = 8;   // 8192 rows / 1024 threads, rows a thread
constexpr int kMaxWhole = 6;   // channels of 8192 rows that fit a CTA whole
constexpr int kEmpty = 0, kLast = 1, kInc = 2;   // a block's status
constexpr int kMaxChannels = 16;
constexpr int kSmemLimit = 230000;  // of the 232,448 bytes a CTA can have

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// waits until at most `Pending` of this thread's committed groups are open
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(Pending) : "memory");
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

// G consecutive floats between shared memory and registers, VW (1, 2 or 4)
// floats an access; p is aligned to VW floats
template <int G, int VW>
__device__ __forceinline__ void load_row(const float* p, float (&v)[G]) {
#pragma unroll
  for (int c = 0; c < G; c += VW) {
    if (VW == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + c);
      v[c] = q.x; v[c + 1] = q.y; v[c + 2] = q.z; v[c + 3] = q.w;
    } else if (VW == 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + c);
      v[c] = q.x; v[c + 1] = q.y;
    } else {
      v[c] = p[c];
    }
  }
}
template <int G, int VW>
__device__ __forceinline__ void store_row(float* p, const float (&v)[G]) {
#pragma unroll
  for (int c = 0; c < G; c += VW) {
    if (VW == 4) {
      *reinterpret_cast<float4*>(p + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
    } else if (VW == 2) {
      *reinterpret_cast<float2*>(p + c) = make_float2(v[c], v[c + 1]);
    } else {
      p[c] = v[c];
    }
  }
}

// The step s = Q*T pairs row j of a thread with its own row j - Q: from the
// last row down, so that each reads its partner's value of the step before.
template <int ITEMS, int G, int Q>
__device__ __forceinline__ void pair_rows(float (&v)[ITEMS][G],
                                          const int (&dist)[ITEMS],
                                          int threads) {
  if constexpr (Q < ITEMS) {
#pragma unroll
    for (int j = ITEMS - 1; j >= 0; --j) {
      const bool ok = j >= Q && dist[j] >= Q * threads;
#pragma unroll
      for (int c = 0; c < G; ++c)
        v[j][c] = __fadd_rn(v[j][c], ok ? v[j >= Q ? j - Q : 0][c] : 0.0f);
    }
  }
}

// The doubling steps of channels [g0, g0 + G) of the tile (rows of `stride`
// floats), in place.  This thread's rows are r = j*T + t, j < ITEMS;
// dist[j] = r - start(r).  Shared memory is touched VW floats an access:
// with VW the largest power of two in `stride`, the lanes of a warp, on
// consecutive rows, meet no bank conflict.  W > 0 is the stride at compile
// time: with it (and T = 1024 whenever a thread has several rows) a
// thread's rows lie at constant offsets from one address, which leaves the
// registers to the values (1024 threads have 64 each).
template <int ITEMS, int G, int VW, int W>
__device__ __forceinline__ void scan_group(float* tile, int w, int g0,
                                           const int (&dist)[ITEMS], int block,
                                           bool active) {
  const int t = threadIdx.x;
  const int threads = ITEMS > 1 ? kMaxThreads : blockDim.x;
  const int stride = W > 0 ? W : w;
  float v[ITEMS][G];
  if (active) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      load_row<G, VW>(tile + (j * threads + t) * stride + g0, v[j]);
  }
  const int shared_end = block < threads ? block : threads;
  for (int s = 1; s < shared_end; s <<= 1) {
    if (active) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        float p[G];
#pragma unroll
        for (int c = 0; c < G; ++c) p[c] = 0.0f;
        if (dist[j] >= s)
          load_row<G, VW>(tile + (j * threads + t - s) * stride + g0, p);
#pragma unroll
        for (int c = 0; c < G; ++c) v[j][c] = __fadd_rn(v[j][c], p[c]);
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        store_row<G, VW>(tile + (j * threads + t) * stride + g0, v[j]);
    }
    __syncthreads();
  }
  if constexpr (ITEMS == 1) return;
  // the steps s = Q*T, Q = 1, 2, 4 < ITEMS <= 8
  pair_rows<ITEMS, G, 1>(v, dist, threads);
  pair_rows<ITEMS, G, 2>(v, dist, threads);
  pair_rows<ITEMS, G, 4>(v, dist, threads);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    store_row<G, VW>(tile + (j * threads + t) * stride + g0, v[j]);
  __syncthreads();
}

// All the channels of a tile of W > 0 floats a row from channel G0 on, in
// register groups: of 4 where W is a multiple of 4 (16-byte accesses), of 4
// and 2 where it is even (8-byte accesses), of 3 and 2 where it is odd.
template <int ITEMS, int W, int G0>
__device__ __forceinline__ void scan_from(float* tile,
                                          const int (&dist)[ITEMS], int block,
                                          bool active) {
  constexpr int left = W - G0;
  if constexpr (left > 0) {
    constexpr int vw = W % 4 == 0 ? 4 : W % 2 == 0 ? 2 : 1;
    constexpr int g = vw == 4 ? 4
                      : vw == 2 ? (left >= 4 ? 4 : 2)
                      : left == 4 ? 2 : left >= 3 ? 3 : left;
    scan_group<ITEMS, g, vw, W>(tile, W, G0, dist, block, active);
    scan_from<ITEMS, W, G0 + g>(tile, dist, block, active);
  }
}

// The same for a width known only at run time (W = 0), in groups of 2 and 1.
template <int ITEMS, int W>
__device__ __forceinline__ void scan_tile(float* tile, int w,
                                          const int (&dist)[ITEMS], int block,
                                          bool active) {
  if constexpr (W > 0) {
    scan_from<ITEMS, W, 0>(tile, dist, block, active);
  } else {
    int g0 = 0;
    if (w % 2 == 0) {
      for (; g0 < w; g0 += 2)
        scan_group<ITEMS, 2, 2, 0>(tile, w, g0, dist, block, active);
    } else {
      for (; g0 + 2 <= w; g0 += 2)
        scan_group<ITEMS, 2, 1, 0>(tile, w, g0, dist, block, active);
      scan_group<ITEMS, 1, 1, 0>(tile, w, g0, dist, block, active);
    }
  }
}

// The carry into block b, which continues block b-1's last run: inc(b-1),
// where inc(k) = last(k) if block k holds a run start (it is "closed"), else
// last(k) + inc(k-1).  One warp walks back over the blocks before b to the
// nearest one whose inc is known (a closed block that has published its last
// row, or an open one that has published its inc), waiting only for blocks
// that already run, then forward again, adding each open block's last row
// in the chain's own order.  `carry` comes back in lanes 0..w-1.
__device__ __forceinline__ float chain_carry(
    const int* key, long long n, int block, int b, int w, const int* status,
    const float* last_val, const float* inc_val, float (*s_rows)[kMaxChannels],
    int lane) {
  int anchor = 0;
  bool anchor_closed = true;
  for (int base = b - 1;; base -= 32) {
    const int q = base - lane;
    bool closed = true;
    if (q > 0) {
      const long long end = static_cast<long long>(q + 1) * block;
      closed = key[static_cast<long long>(q) * block - 1] !=
               key[(end < n ? end : n) - 1];
    }
    unsigned found;
    for (;;) {
      const int st = q >= 0 ? ld_acquire(status + q) : kInc;
      found = __ballot_sync(~0u, closed ? st != kEmpty : st == kInc);
      const unsigned empty = __ballot_sync(~0u, st == kEmpty);
      const int first = found ? __ffs(found) - 1 : 32;
      // every block nearer than the anchor has published its last row
      const unsigned upto = first >= 31 ? ~0u : (2u << first) - 1;
      if ((empty & upto) == 0) break;
    }
    if (found) {
      const int first = __ffs(found) - 1;
      anchor = base - first;   // block 0 is closed, so anchor >= 0
      anchor_closed = __shfl_sync(~0u, closed, first);
      break;
    }
  }
  float inc = 0.0f;
  if (lane < w)
    inc = __ldcg((anchor_closed ? last_val : inc_val) +
                 static_cast<long long>(anchor) * w + lane);
  for (int k = anchor + 1; k < b; k += 32) {
    const int cnt = b - k < 32 ? b - k : 32;
    if (lane < cnt)
      for (int ch = 0; ch < w; ++ch)
        s_rows[lane][ch] =
            __ldcg(last_val + static_cast<long long>(k + lane) * w + ch);
    __syncwarp();
    if (lane < w)
      for (int i = 0; i < cnt; ++i) inc = __fadd_rn(s_rows[i][lane], inc);
    __syncwarp();
  }
  return inc;
}

// One launch scans channels [c0, c0 + w) of every row: val and out have
// `c` floats a row.  W > 0: w == c == W at compile time and c0 == 0.
// status: one int a block; last_val, inc_val: w floats a block.
template <int ITEMS, int W>
__global__ void __launch_bounds__(kMaxThreads)
scan_block(const int* __restrict__ key, const float* __restrict__ val,
           float* __restrict__ out, long long n, int c, int c0, int w,
           int block, int* __restrict__ counter, int* __restrict__ status,
           float* __restrict__ last_val, float* __restrict__ inc_val) {
  extern __shared__ int4 smem[];
  int* s_key = reinterpret_cast<int*>(smem);
  float* tile = reinterpret_cast<float*>(smem) + (block < 4 ? 4 : block);
  __shared__ int s_b;
  __shared__ float s_carry[kMaxChannels];
  __shared__ float s_rows[32][kMaxChannels];

  const int t = threadIdx.x;
  const int threads = ITEMS > 1 ? kMaxThreads : blockDim.x;
  if (W > 0) {
    c = w = W;
    c0 = 0;
  }
  if (t == 0) s_b = atomicAdd(counter, 1);
  __syncthreads();
  const int b = s_b;
  const long long lo = static_cast<long long>(b) * block;
  const int rows = static_cast<int>(n - lo < block ? n - lo : block);
  const bool active = t < block;   // block < 32 leaves lanes idle
  // 16-byte copies need the block's first key and value on a 16-byte
  // boundary, and the values all the channels of a row
  const bool vec = block % 4 == 0;
  const bool flat = vec && w == c;
  const int words = rows * w;

  if (vec) {
    for (int g = t; 4 * g < rows; g += threads) {
      const int left = (rows - 4 * g) * 4;
      cp_async16(s_key + 4 * g, key + lo + 4 * g, left < 16 ? left : 16);
    }
    cp_async_commit();
    if (flat) {
      for (int g = t; 4 * g < words; g += threads) {
        const int left = (words - 4 * g) * 4;
        cp_async16(tile + 4 * g, val + lo * c + 4 * g, left < 16 ? left : 16);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();   // the keys are in; the values still on their way
  } else {
    for (int r = t; r < rows; r += threads) s_key[r] = key[lo + r];
  }
  if (!flat) {
    for (int e = t; e < words; e += threads)
      tile[e] = val[(lo + e / w) * c + c0 + e % w];
  }
  __syncthreads();
  if (rows < block) {
    // rows past the end follow the real ones, and a row only reads rows
    // before it; their keys keep the block's keys sorted
    for (int r = rows + t; r < block; r += threads) s_key[r] = INT32_MAX;
    __syncthreads();
  }

  // dist = r - start(r), while the values arrive.  A row is a head where its
  // key differs from the row before; start(r) is the last head at or before
  // r.  Inside a warp's 32 consecutive rows it comes from one ballot; a row
  // with no head before it in its warp's rows takes the last head of the
  // rows before them, a running max over the (item, warp) segments in row
  // order that warp 0 scans.
  int dist[ITEMS];
  {
    const int lane = t & 31, warp = t >> 5, warps = threads >> 5;
    int* seg = reinterpret_cast<int*>(s_rows);   // ITEMS * warps <= 256 ints
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int r = j * threads + t;
      const bool head = active && (r == 0 || s_key[r] != s_key[r - 1]);
      const unsigned heads = __ballot_sync(~0u, head) & ((2u << lane) - 1);
      dist[j] = heads ? lane - (31 - __clz(heads)) : -1;
      // the last lane's is the last head of the whole segment
      if (lane == 31) seg[j * warps + warp] = heads ? r - dist[j] : -1;
    }
    __syncthreads();
    if (warp == 0) {
      const int total = ITEMS * warps, per = (total + 31) / 32;
      int run = -1;   // exclusive running max inside this lane's entries
      for (int i = 0; i < per; ++i) {
        const int idx = lane * per + i;
        if (idx < total) {
          const int x = seg[idx];
          seg[idx] = run;
          run = max(run, x);
        }
      }
      int incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(~0u, incl, d);
        if (lane >= d) incl = max(incl, o);
      }
      int before = __shfl_up_sync(~0u, incl, 1);
      if (lane == 0) before = -1;
      for (int i = 0; i < per; ++i) {
        const int idx = lane * per + i;
        if (idx < total) seg[idx] = max(seg[idx], before);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (dist[j] < 0) dist[j] = j * threads + t - seg[j * warps + warp];
  }
  cp_async_wait<0>();
  __syncthreads();

  scan_tile<ITEMS, W>(tile, w, dist, block, active);

  // The carry.  This block's last row goes out first (values, then the
  // status), so that no block after it waits for more than this scan.
  const int k0 = s_key[0];
  const bool continues = b > 0 && key[lo - 1] == k0;
  const bool open = continues && s_key[rows - 1] == k0;  // no run start here
  if (t < 32) {
    const long long mine = static_cast<long long>(b) * w + t;
    if (t < w) __stcg(last_val + mine, tile[(rows - 1) * w + t]);
    __threadfence();
    __syncwarp();
    if (t == 0) st_release(status + b, kLast);
    if (continues) {
      const float carry = chain_carry(key, n, block, b, w, status, last_val,
                                      inc_val, s_rows, t);
      if (t < w) s_carry[t] = carry;
      if (open) {
        // the blocks after this one may start from its inc
        if (t < w)
          __stcg(inc_val + mine, __fadd_rn(tile[(rows - 1) * w + t], carry));
        __threadfence();
        __syncwarp();
        if (t == 0) st_release(status + b, kInc);
      }
    }
  }
  if (continues) {
    // into the leading run, before the block's one write of out
    __syncthreads();
    int lead = rows;
    if (!open) {
      int a = 0, z = rows;
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (s_key[mid] <= k0) a = mid + 1; else z = mid;
      }
      lead = a;
    }
    for (int e = t; e < lead * w; e += threads)
      tile[e] = __fadd_rn(tile[e], s_carry[e % w]);
    __syncthreads();
  }

  if (flat) {
    float* dst = out + lo * c;
    for (int g = t; 4 * g < words; g += threads) {
      if (4 * g + 4 <= words) {
        reinterpret_cast<float4*>(dst)[g] =
            reinterpret_cast<const float4*>(tile)[g];
      } else {
        for (int e = 4 * g; e < words; ++e) dst[e] = tile[e];
      }
    }
  } else {
    for (int e = t; e < words; e += threads)
      out[(lo + e / w) * c + c0 + e % w] = tile[e];
  }
}

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

long long n_blocks(long long n, int block) { return (n + block - 1) / block; }

// the cleared part: the block counter and one status a block
size_t cleared_bytes(long long nb) { return align256(sizeof(int) * (1 + nb)); }

// the channels of a block that fit a CTA's shared memory beside its keys
int channels_that_fit(int block) {
  return (kSmemLimit - (block < 4 ? 4 : block) * 4) / (block * 4);
}

}  // namespace

// scratch: the counter and the statuses (cleared before every launch), then
// last_val and inc_val (nb * min(c, channels that fit) floats each)
extern "C" long long treee_seg_cumsum_scratch_bytes(long long n, int c,
                                                    int block) {
  if (n <= 0 || c <= 0 || block < 1 || block > kMaxThreads * kMaxItems)
    return 0;
  const long long nb = n_blocks(n, block);
  const int fit = channels_that_fit(block);
  return static_cast<long long>(
      cleared_bytes(nb) +
      2 * align256(sizeof(float) * nb * (c < fit ? c : fit)));
}

// key i32[n], val/out f32[n,c] on the device, each 16-byte aligned; block a
// power of two in [1, 8192]; scratch holds
// treee_seg_cumsum_scratch_bytes(n, c, block) bytes and needs no clearing.
// One memset and one launch on `stream` for every window of channels (one
// window up to 6 channels at block 8192).  Returns the first CUDA error, or 0.
extern "C" int treee_seg_cumsum(const int* key, const float* val, float* out,
                                long long n, int c, int block, void* scratch,
                                cudaStream_t stream) {
  if (n <= 0 || c <= 0 || c > kMaxChannels || block < 1 ||
      block > kMaxThreads * kMaxItems || (block & (block - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(key) | reinterpret_cast<uintptr_t>(val) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  const long long nb = n_blocks(n, block);
  if (nb > INT32_MAX) return cudaErrorInvalidValue;
  const int fit = channels_that_fit(block);
  const int window = c < fit ? c : fit;
  char* s = static_cast<char*>(scratch);
  int* counter = reinterpret_cast<int*>(s);
  int* status = counter + 1;
  s += cleared_bytes(nb);
  float* last_val = reinterpret_cast<float*>(s);
  s += align256(sizeof(float) * nb * window);
  float* inc_val = reinterpret_cast<float*>(s);

  const int threads = block < 32 ? 32 : block < kMaxThreads ? block : kMaxThreads;
  const int items = block / threads;
  cudaError_t err = cudaSuccess;
#define TREEE_LAUNCH(ITEMS, W)                                                \
  {                                                                           \
    err = cudaFuncSetAttribute(scan_block<ITEMS, W>,                          \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                               smem);                                         \
    if (err != cudaSuccess) return err;                                       \
    scan_block<ITEMS, W><<<static_cast<unsigned>(nb), threads, smem, stream>>>( \
        key, val, out, n, c, c0, w, block, counter, status, last_val,         \
        inc_val);                                                             \
  }
  for (int c0 = 0; c0 < c; c0 += window) {
    const int w = c - c0 < window ? c - c0 : window;
    const int smem = 4 * ((block < 4 ? 4 : block) + block * w);
    err = cudaMemsetAsync(scratch, 0, cleared_bytes(nb), stream);
    if (err != cudaSuccess) return err;
    // the default block size at the widths that fit whole has the width at
    // compile time; every other block size and width shares four kernels
    if (items == kMaxItems && c <= kMaxWhole) {
      switch (c) {
        case 1: TREEE_LAUNCH(kMaxItems, 1) break;
        case 2: TREEE_LAUNCH(kMaxItems, 2) break;
        case 3: TREEE_LAUNCH(kMaxItems, 3) break;
        case 4: TREEE_LAUNCH(kMaxItems, 4) break;
        case 5: TREEE_LAUNCH(kMaxItems, 5) break;
        default: TREEE_LAUNCH(kMaxItems, 6) break;
      }
    } else {
      switch (items) {
        case 8: TREEE_LAUNCH(8, 0) break;
        case 4: TREEE_LAUNCH(4, 0) break;
        case 2: TREEE_LAUNCH(2, 0) break;
        default: TREEE_LAUNCH(1, 0) break;   // block <= threads: a row a thread
      }
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
#undef TREEE_LAUNCH
  return cudaSuccess;
}

TREEE_PACKED(treee_seg_cumsum)
