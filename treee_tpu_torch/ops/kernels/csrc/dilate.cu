// Splat dilation over a packed key image.
//
// Replaces treee_tpu/ops/pallas_kernels.py::_dilate_kernel (called through
// dilate_pallas) and computes what the TPU runs by default, the XLA scan of
// treee_tpu/render/splat.py::resolve_keys.  Contract: `radius` passes over
// an i32[H,W] image of (23-bit depth << 8 | palette) keys, 0x7FFFFFFF where
// empty.  A pass is eight whole-image steps, one per direction (dy, dx) in
// the scan's order; in each step a pixel takes the key of its neighbour at
// (row-dy, col-dx) when that neighbour lies in the image, the key is
// smaller, and the pixel lies in the key's splat circle: cdx^2 + cdy^2 <=
// r^2, with (cdx, cdy) the offset back to the splat's source pixel and r the
// splat's pixel radius, a function of its key.  The output equals the plain
// PyTorch version bit for bit: r^2 is taken in the same f32 operations (IEEE
// division, no FMA: the library is built with -fmad=false), and the offsets
// are carried at full width (int16 pairs), not in the Pallas kernel's 4-bit
// fields, which hold only |7|.
//
// What bounds it on the H100: the work, a few integer operations a pixel
// and step (24 steps at radius 3), all of it on chip.  Design: temporal
// blocking.  One pass moves a key at most 3 pixels along an axis, so a block
// loads a 64x64 core with a halo of 3 pixels a pass (82x82 = 6,724 pixels,
// 1.64x the core) and runs up to kPasses passes there; after each step the
// stale ring it leaves is one pixel wider on one side, so after P passes
// exactly the core is exact.  At 720p that is 240 blocks of 512 threads,
// two an SM: one wave on 132 SMs, in which a busy tile shares its SM with
// an empty one where the frame has them (128x64 cores, one block an SM, are
// 10% faster where every tile is busy and 15-20% slower on the frame).
// Each pixel's key and its (packed offsets, r^2) pair live in shared
// memory once (12 bytes, 80 KB a block); a step reads every source into
// registers, waits at a barrier, then each thread writes only the pixels
// it changed, so the state is not double-buffered.  r^2 is computed once a
// pixel as the tile loads and travels with its key, as the scan carries
// `rd`, so the step has no division.  A thread walks its 14 pixels by row
// and column counters fixed at compile time; nothing is tested a pixel
// and step but the key: sources outside the
// image hold the empty key, targets outside it hold the least int in
// registers, and sources beyond the span's side read the next row's pixel,
// a wrong value only inside the stale ring.  Two exact shortcuts: a tile
// whose span holds no key writes the empty key and returns, and a tile in
// which a whole pass changed nothing stops, since every later pass starts
// from the same state.  ceil(radius/kPasses) launches carry keys and
// offsets between them; the last writes keys only.
#include <cuda_runtime.h>

#include "packed.cuh"

namespace {

constexpr int kIBig = 0x7FFFFFFF;
constexpr int kIMin = -0x7FFFFFFF - 1;
constexpr int kPasses = 3;
constexpr int kHalo = 3 * kPasses;
constexpr int kCoreW = 64;
constexpr int kCoreH = 64;
constexpr int kThreads = 512;
constexpr int kSpanW = kCoreW + 2 * kHalo;
constexpr int kSpanH = kCoreH + 2 * kHalo;
constexpr int kArea = kSpanW * kSpanH;
// 1024 threads an SM: 64 registers a thread
constexpr int kBlocksPerSm = 1024 / kThreads;
// pixel j of a thread is tid + j * kThreads: kRowStep rows and kColStep
// columns further on than pixel j - 1
constexpr int kPix = (kArea + kThreads - 1) / kThreads;
constexpr int kRowStep = kThreads / kSpanW;
constexpr int kColStep = kThreads % kSpanW;
// the key plane has a row and a pixel of empty keys before and after it:
// the sources of the span's first and last rows
constexpr int kPad = kSpanW + 1;
// the keys (padded, rounded up to 8 bytes), then (packed offsets, bits of
// r^2) pairs
constexpr int kKeyInts = (kArea + 2 * kPad + 1) / 2 * 2;
constexpr int kSmemBytes =
    (kKeyInts + 2 * kArea) * static_cast<int>(sizeof(int));
static_assert(kPix <= 32, "a step's changed pixels are one 32-bit mask");
static_assert(kSmemBytes <= 232448, "the state must fit in shared memory");

// the eight directions (dy, dx) of a pass, in the scan's order:
// (-1,0) (1,0) (0,-1) (0,1) (-1,-1) (-1,1) (1,-1) (1,1)
__host__ __device__ constexpr int dir_dy(int d) {
  return d < 2 ? 2 * d - 1 : d < 4 ? 0 : d < 6 ? -1 : 1;
}
__host__ __device__ constexpr int dir_dx(int d) {
  return d < 2 ? 0 : d < 4 ? 2 * d - 5 : 2 * (d % 2) - 1;
}

struct RadiusParams {
  float p22, p23, coef, zscale;
};

// The r^2 a key carries, as bits: the plain version's f32 radius (invert
// z01 to the view depth d, then coef / d, at least 0.71), squared once.
__device__ __forceinline__ int radius_sq(int k, RadiusParams p) {
  const float z01 = __fmul_rn(static_cast<float>(k >> 8), p.zscale);
  const float d = __fdiv_rn(p.p23, fminf(__fadd_rn(z01, p.p22), -1e-9f));
  const float r = fmaxf(__fdiv_rn(p.coef, fmaxf(d, 1e-6f)), 0.71f);
  return __float_as_int(__fmul_rn(r, r));
}

// (dx, dy) as two int16 halves of one int: dy high, dx low.
__device__ __forceinline__ int pack(int dx, int dy) {
  return static_cast<int>((static_cast<unsigned>(dy) << 16) |
                          (static_cast<unsigned>(dx) & 0xFFFFu));
}

// One step in direction D: every pixel reads its source, the block waits,
// and each thread writes back the pixels it changed.  A source outside the
// span is a pixel of the row before or after (or the padding): a wrong
// value, but only where the stale ring is wrong anyway.  A source outside
// the image holds the empty key, and a target outside it or beyond the
// span holds kIMin in `own`, so neither takes part.
template <int D>
__device__ __forceinline__ void step(int* key, int2* aux, int (&own)[kPix],
                                     bool& changed) {
  constexpr int dy = dir_dy(D);
  constexpr int dx = dir_dx(D);
  constexpr int delta = dy * kSpanW + dx;
  // the last pixel of a thread may lie beyond the span
  const bool tail = static_cast<int>(threadIdx.x) + (kPix - 1) * kThreads <
                    kArea;
  int2 got[kPix];
  unsigned took = 0;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (j < kPix - 1 || tail) {
      const int s = static_cast<int>(threadIdx.x) + j * kThreads - delta;
      const int ck = key[s];
      // ck < own[j] <= 0x7FFFFFFF, so ck holds a key
      if (ck < own[j]) {
        const int2 ca = aux[s];
        const int cdx = static_cast<short>(ca.x & 0xFFFF) + dx;
        const int cdy = (ca.x >> 16) + dy;
        const float fx = static_cast<float>(cdx);
        const float fy = static_cast<float>(cdy);
        if (__fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy)) <=
            __int_as_float(ca.y)) {
          own[j] = ck;
          got[j] = make_int2(pack(cdx, cdy), ca.y);
          took |= 1u << j;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if ((took >> j) & 1u) {
      const int p = static_cast<int>(threadIdx.x) + j * kThreads;
      key[p] = own[j];
      aux[p] = got[j];
    }
  }
  changed |= took != 0;
}

// stats, where not null: [tiles, tiles with no key in their span, tiles
// stopped before their last pass, passes run], added up over the launch.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
dilate_tile(const int* __restrict__ key_in, const int* __restrict__ off_in,
            int* __restrict__ key_out, int* __restrict__ off_out, int h,
            int w, int passes, RadiusParams p, int* __restrict__ stats) {
  extern __shared__ int smem[];
  int* key = smem + kPad;
  int2* aux = reinterpret_cast<int2*>(smem + kKeyInts);
  const int r0 = static_cast<int>(blockIdx.y) * kCoreH - kHalo;
  const int c0 = static_cast<int>(blockIdx.x) * kCoreW - kHalo;
  // the span's rows and columns that lie in the image
  const int rlo = max(0, -r0), rhi = min(kSpanH, h - r0);
  const int clo = max(0, -c0), chi = min(kSpanW, w - c0);
  const int lr0 = static_cast<int>(threadIdx.x) / kSpanW;
  const int lc0 = static_cast<int>(threadIdx.x) % kSpanW;

  for (int i = static_cast<int>(threadIdx.x); i < kPad; i += kThreads) {
    key[i - kPad] = kIBig;
    key[kArea + i] = kIBig;
  }
  int own[kPix];
  bool any = false;
  {
    int lr = lr0, lc = lc0;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const bool live = lr >= rlo && lr < rhi && lc >= clo && lc < chi;
      int k = kIBig;
      int o = 0;
      if (live) {
        const size_t g = static_cast<size_t>(r0 + lr) * w + (c0 + lc);
        k = key_in[g];
        if (off_in != nullptr) o = off_in[g];
      }
      if (lr < kSpanH) {
        const int q = static_cast<int>(threadIdx.x) + j * kThreads;
        key[q] = k;
        aux[q] = make_int2(o, k != kIBig ? radius_sq(k, p) : 0);
      }
      own[j] = live ? k : kIMin;
      any |= k != kIBig;
      lc += kColStep;
      lr += kRowStep;
      if (lc >= kSpanW) {
        lc -= kSpanW;
        ++lr;
      }
    }
  }

  const bool empty = !__syncthreads_or(any);
  int run = 0;
  if (!empty) {
    for (int pass = 0; pass < passes; ++pass) {
      bool changed = false;
      step<0>(key, aux, own, changed);
      __syncthreads();
      step<1>(key, aux, own, changed);
      __syncthreads();
      step<2>(key, aux, own, changed);
      __syncthreads();
      step<3>(key, aux, own, changed);
      __syncthreads();
      step<4>(key, aux, own, changed);
      __syncthreads();
      step<5>(key, aux, own, changed);
      __syncthreads();
      step<6>(key, aux, own, changed);
      __syncthreads();
      step<7>(key, aux, own, changed);
      ++run;
      // a pass that changed nothing leaves a state every later pass keeps
      if (!__syncthreads_or(changed)) break;
    }
  }

  {
    int lr = lr0, lc = lc0;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (lr >= kHalo && lr < kHalo + kCoreH && lc >= kHalo &&
          lc < kHalo + kCoreW && lr < rhi && lc < chi) {
        const size_t g = static_cast<size_t>(r0 + lr) * w + (c0 + lc);
        key_out[g] = own[j];
        if (off_out != nullptr && !empty) {
          off_out[g] = aux[static_cast<int>(threadIdx.x) + j * kThreads].x;
        }
      }
      lc += kColStep;
      lr += kRowStep;
      if (lc >= kSpanW) {
        lc -= kSpanW;
        ++lr;
      }
    }
  }
  if (stats != nullptr && threadIdx.x == 0) {
    atomicAdd(stats, 1);
    atomicAdd(stats + 1, empty ? 1 : 0);
    atomicAdd(stats + 2, !empty && run < passes ? 1 : 0);
    atomicAdd(stats + 3, run);
  }
}

}  // namespace

extern "C" int treee_dilate_passes_per_launch() { return kPasses; }
extern "C" int treee_dilate_core_rows() { return kCoreH; }
extern "C" int treee_dilate_core_cols() { return kCoreW; }

// kimg, out: i32[h,w] keys on the device, kimg read only.  Runs
// ceil(radius/kPasses) launches on `stream`.  With more than one launch,
// tmp (i32[h,w]) holds keys and off_a (and, from three launches, off_b;
// i32[h,w] each) the packed offsets between launches, alternating so that
// the last launch writes `out`; with one launch they may be null.  stats,
// where not null, is i32[4] on the device, zeroed by the caller: see
// dilate_tile.  Returns the first CUDA error, or 0.
extern "C" int treee_dilate(const int* kimg, int* out, int* tmp, int* off_a,
                            int* off_b, int h, int w, int radius, float p22,
                            float p23, float coef, float zscale, int* stats,
                            cudaStream_t stream) {
  if (h <= 0 || w <= 0 || radius <= 0 || 3 * radius > 32767) {
    return cudaErrorInvalidValue;
  }
  const int launches = (radius + kPasses - 1) / kPasses;
  if ((launches > 1 && (tmp == nullptr || off_a == nullptr)) ||
      (launches > 2 && off_b == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const RadiusParams p{p22, p23, coef, zscale};
  cudaError_t err = cudaFuncSetAttribute(
      dilate_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kCoreW - 1) / kCoreW, (h + kCoreH - 1) / kCoreH);
  const int* key_src = kimg;
  const int* off_src = nullptr;  // the first launch starts from zero offsets
  for (int i = 0; i < launches; ++i) {
    const bool last = i == launches - 1;
    int* key_dst = (launches - 1 - i) % 2 == 0 ? out : tmp;
    int* off_dst = last ? nullptr : (i % 2 == 0 ? off_a : off_b);
    const int n = last ? radius - kPasses * i : kPasses;
    dilate_tile<<<grid, kThreads, kSmemBytes, stream>>>(
        key_src, off_src, key_dst, off_dst, h, w, n, p, stats);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    key_src = key_dst;
    off_src = off_dst;
  }
  return cudaSuccess;
}

TREEE_PACKED(treee_dilate)
