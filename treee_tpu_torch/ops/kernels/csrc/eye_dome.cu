// Eye-dome lighting over a rendered frame.
//
// Replaces treee_tpu/ops/pallas_kernels.py::_eye_dome_kernel (called through
// eye_dome_pallas) and computes the XLA path of
// treee_tpu/render/splat.py::eye_dome.  Contract: for f32[H,W] depth z01 and
// f32[H,W,3] colour, lin = 1 where z01 >= 1, else 2n / ((f+n) - z01*(f-n));
// m = the max of lin over the pixel and its 4 neighbours, with reads clamped
// at the image edges; m = min(m, lin + s); alpha = (m - lin) / s where
// z01 < 1, else 0; out = colour * (1 - alpha) + ed * alpha.  Every value is
// taken in the plain PyTorch version's f32 order (IEEE division, no FMA: the
// library is built with -fmad=false), so the output equals it bit for bit.
// That matters: s = 0.3^6 ~ 7.3e-4 divides (m - lin), so one ulp of lin
// would move alpha by ~1,400 ulps.
//
// What bounds it on the H100: device memory.  At 720p it reads 3.7 MB of
// depth (five times, through L1/L2) and 11 MB of colour and writes 11 MB;
// as torch ops the same is about 20 launches over [H,W] planes.  Design: one
// thread per pixel, colour read and written in HWC layout directly (the
// Pallas kernel's [3,H,W] moveaxis is a TPU tiling choice), the four
// neighbour depths read through the read-only cache.
#include <cuda_runtime.h>

#include "packed.cuh"

namespace {

constexpr int kThreads = 256;

struct EyeDomeParams {
  float n2, fpn, fmn, s, ed0, ed1, ed2;
};

__device__ __forceinline__ float linearize(float d, const EyeDomeParams& p) {
  return d >= 1.0f ? 1.0f
                   : __fdiv_rn(p.n2, __fsub_rn(p.fpn, __fmul_rn(d, p.fmn)));
}

__device__ __forceinline__ float blend(float c, float e, float alpha) {
  return __fadd_rn(__fmul_rn(c, __fsub_rn(1.0f, alpha)), __fmul_rn(e, alpha));
}

__global__ void __launch_bounds__(kThreads)
eye_dome_px(const float* __restrict__ color, const float* __restrict__ z01,
            float* __restrict__ out, int h, int w, EyeDomeParams p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(h) * w) return;
  const int r = static_cast<int>(i / w);
  const int c = static_cast<int>(i % w);
  const size_t row = static_cast<size_t>(r) * w;
  const float z = __ldg(z01 + i);
  const float lin = linearize(z, p);
  const float up = linearize(__ldg(z01 + row - (r > 0 ? w : 0) + c), p);
  const float down = linearize(__ldg(z01 + row + (r < h - 1 ? w : 0) + c), p);
  const float left = linearize(__ldg(z01 + row + (c > 0 ? c - 1 : c)), p);
  const float right = linearize(__ldg(z01 + row + (c < w - 1 ? c + 1 : c)), p);
  float m = fmaxf(fmaxf(up, down), fmaxf(left, right));
  m = fmaxf(m, lin);
  m = fminf(m, __fadd_rn(lin, p.s));
  const float alpha = z < 1.0f ? __fdiv_rn(__fsub_rn(m, lin), p.s) : 0.0f;
  const float* src = color + 3 * i;
  float* dst = out + 3 * i;
  dst[0] = blend(src[0], p.ed0, alpha);
  dst[1] = blend(src[1], p.ed1, alpha);
  dst[2] = blend(src[2], p.ed2, alpha);
}

}  // namespace

// color, out: f32[h,w,3]; z01: f32[h,w]; all on the device, contiguous.
// One launch on `stream`.  Returns the CUDA error of the launch, or 0.
extern "C" int treee_eye_dome(const float* color, const float* z01,
                              float* out, int h, int w, float n2, float fpn,
                              float fmn, float s, float ed0, float ed1,
                              float ed2, cudaStream_t stream) {
  if (h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(h) * w;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const EyeDomeParams p{n2, fpn, fmn, s, ed0, ed1, ed2};
  eye_dome_px<<<blocks, kThreads, 0, stream>>>(color, z01, out, h, w, p);
  return cudaGetLastError();
}

TREEE_PACKED(treee_eye_dome)
