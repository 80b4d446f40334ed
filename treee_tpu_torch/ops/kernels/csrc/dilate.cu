// Splat dilation over a packed key image.
//
// Replaces treee_tpu/ops/pallas_kernels.py::_dilate_kernel (called through
// dilate_pallas) and computes what the TPU runs by default, the XLA scan of
// treee_tpu/render/splat.py::resolve_keys.  Contract: `radius` passes over
// an i32[H,W] image of (23-bit depth << 8 | palette) keys, 0x7FFFFFFF where
// empty.  A pass is eight whole-image steps, one per direction (dy, dx) in
// the scan's order; in each step a pixel takes the key of its neighbour at
// (row-dy, col-dx) when that neighbour lies in the image, holds a key, the
// key is smaller, and the pixel lies in the key's splat circle:
// cdx^2 + cdy^2 <= r^2, with (cdx, cdy) the offset back to the splat's
// source pixel and r the splat's pixel radius recomputed from its key.  The
// output equals the plain PyTorch version bit for bit: the radius is taken
// in the same f32 operations (IEEE division, no FMA: the library is built
// with -fmad=false), and the offsets are carried at full width (int16
// pairs), not in the Pallas kernel's 4-bit fields, which hold only |7|.
//
// What bounds it on the H100: as torch ops the scan is 24 steps of about 15
// elementwise launches over a 720p plane each; the work itself is a few
// integer compares per pixel and step.  Design: temporal blocking, as in
// cc_sweep.cu.  Each step reads the state the previous direction left, so it
// is a Jacobi update with a double buffer in shared memory.  One pass moves a
// key at most 3 pixels along an axis (one axial and two diagonal steps of
// the same sign), so a block loads a 32x32 output tile with a halo of 3
// pixels per pass, runs up to kPasses passes there, and writes the core back;
// after each step the halo ring it leaves stale is one pixel thinner on one
// side, so after P passes exactly the core is exact.  ceil(radius/kPasses)
// launches make up the passes and carry keys and offsets between them.  The
// edge masks test image coordinates, never tile coordinates.
#include <cuda_runtime.h>

#include "packed.cuh"

namespace {

constexpr int kIBig = 0x7FFFFFFF;
constexpr int kTile = 32;
constexpr int kPasses = 3;
constexpr int kHalo = 3 * kPasses;
constexpr int kSpan = kTile + 2 * kHalo;
constexpr int kArea = kSpan * kSpan;
constexpr int kThreads = 256;
// keys and packed offsets, each double-buffered
constexpr int kSmemBytes = 4 * kArea * static_cast<int>(sizeof(int));

__constant__ int kDy[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
__constant__ int kDx[8] = {0, 0, -1, 1, -1, 1, -1, 1};

struct RadiusParams {
  float p22, p23, coef, zscale;
};

// The splat's pixel radius from its key, in the plain version's f32 order.
__device__ __forceinline__ float radius_from_key(int k, RadiusParams p) {
  const float z01 = __fmul_rn(static_cast<float>(k >> 8), p.zscale);
  const float d = __fdiv_rn(p.p23, fminf(__fadd_rn(z01, p.p22), -1e-9f));
  return fmaxf(__fdiv_rn(p.coef, fmaxf(d, 1e-6f)), 0.71f);
}

// (dx, dy) as two int16 halves of one int: dy high, dx low.
__device__ __forceinline__ int pack(int dx, int dy) {
  return static_cast<int>((static_cast<unsigned>(dy) << 16) |
                          (static_cast<unsigned>(dx) & 0xFFFFu));
}

__global__ void __launch_bounds__(kThreads)
dilate_tile(const int* __restrict__ key_in, const int* __restrict__ off_in,
            int* __restrict__ key_out, int* __restrict__ off_out, int h,
            int w, int passes, RadiusParams p) {
  extern __shared__ int smem[];
  int* key[2] = {smem, smem + kArea};
  int* off[2] = {smem + 2 * kArea, smem + 3 * kArea};
  const int r0 = static_cast<int>(blockIdx.y) * kTile - kHalo;
  const int c0 = static_cast<int>(blockIdx.x) * kTile - kHalo;

  for (int i = threadIdx.x; i < kArea; i += kThreads) {
    const int r = r0 + i / kSpan;
    const int c = c0 + i % kSpan;
    const bool in = r >= 0 && r < h && c >= 0 && c < w;
    const size_t g = static_cast<size_t>(r) * w + c;
    key[0][i] = in ? key_in[g] : kIBig;
    off[0][i] = (in && off_in != nullptr) ? off_in[g] : 0;
  }
  __syncthreads();

  int cur = 0;
  for (int pass = 0; pass < passes; ++pass) {
    for (int dir = 0; dir < 8; ++dir) {
      const int dy = kDy[dir];
      const int dx = kDx[dir];
      for (int i = threadIdx.x; i < kArea; i += kThreads) {
        const int lr = i / kSpan;
        const int lc = i % kSpan;
        const int sr = lr - dy;
        const int sc = lc - dx;
        const int gsr = r0 + sr;
        const int gsc = c0 + sc;
        int k = key[cur][i];
        int o = off[cur][i];
        // the source must lie in the tile (else this pixel is in the stale
        // ring) and in the image (the scan's src_ok)
        if (sr >= 0 && sr < kSpan && sc >= 0 && sc < kSpan && gsr >= 0 &&
            gsr < h && gsc >= 0 && gsc < w) {
          const int s = sr * kSpan + sc;
          const int ck = key[cur][s];
          if (ck != kIBig && ck < k) {
            const int co = off[cur][s];
            const int cdx = static_cast<short>(co & 0xFFFF) + dx;
            const int cdy = (co >> 16) + dy;
            const float fx = static_cast<float>(cdx);
            const float fy = static_cast<float>(cdy);
            const float crd = radius_from_key(ck, p);
            if (__fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy)) <=
                __fmul_rn(crd, crd)) {
              k = ck;
              o = pack(cdx, cdy);
            }
          }
        }
        key[cur ^ 1][i] = k;
        off[cur ^ 1][i] = o;
      }
      __syncthreads();
      cur ^= 1;
    }
  }

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int lr = kHalo + i / kTile;
    const int lc = kHalo + i % kTile;
    const int r = r0 + lr;
    const int c = c0 + lc;
    if (r < h && c < w) {
      const size_t g = static_cast<size_t>(r) * w + c;
      key_out[g] = key[cur][lr * kSpan + lc];
      off_out[g] = off[cur][lr * kSpan + lc];
    }
  }
}

}  // namespace

extern "C" int treee_dilate_passes_per_launch() { return kPasses; }

// kimg, out, tmp: i32[h,w] keys; off_a, off_b: i32[h,w] scratch for the
// packed offsets; all on the device, kimg read only.  Runs
// ceil(radius/kPasses) launches on `stream`, alternating between the two
// buffer pairs so that the last one writes `out`.  Returns the first CUDA
// error, or 0.
extern "C" int treee_dilate(const int* kimg, int* out, int* tmp, int* off_a,
                            int* off_b, int h, int w, int radius, float p22,
                            float p23, float coef, float zscale,
                            cudaStream_t stream) {
  if (h <= 0 || w <= 0 || radius <= 0 || 3 * radius > 32767) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      dilate_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  const RadiusParams p{p22, p23, coef, zscale};
  const int launches = (radius + kPasses - 1) / kPasses;
  const int* key_src = kimg;
  const int* off_src = nullptr;  // the first launch starts from zero offsets
  for (int i = 0; i < launches; ++i) {
    const bool last_parity = (launches - 1 - i) % 2 == 0;
    int* key_dst = last_parity ? out : tmp;
    int* off_dst = last_parity ? off_a : off_b;
    const int n = (i == launches - 1) ? radius - kPasses * i : kPasses;
    dilate_tile<<<grid, kThreads, kSmemBytes, stream>>>(key_src, off_src,
                                                        key_dst, off_dst, h,
                                                        w, n, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    key_src = key_dst;
    off_src = off_dst;
  }
  return cudaSuccess;
}

TREEE_PACKED(treee_dilate)
