// Eye-dome lighting as a 2-D tile of linearized depths in shared memory: a
// design timed against csrc/eye_dome.cu by `compare_kernels.py --only
// frame`, not built into the package.  Same contract, C entry point and
// bit-for-bit result as csrc/eye_dome.cu (see its head note).
//
// A block of 8 warps takes a core of 16 rows by 128 columns.  It loads the
// core's depths and a one-pixel halo around it (reads clamped at the image
// edges, as the plain version clamps them), linearizes each once (18 x 130
// for 16 x 128, 1.14 linearizations a depth) into shared memory, and loads
// its colour, 16 bytes an access, before the barrier; after it each thread
// blends its two groups of 4 pixels from the tile and writes them.  Groups
// that do not start on a 16-byte boundary, or that W cuts short, take
// scalar accesses.
#include <cuda_runtime.h>

#include "packed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoreW = 128;
constexpr int kCoreH = 16;
// a tile row: the left halo at kLeft, the core from kLeft + 1, the right
// halo after it; the core starts on a 16-byte boundary
constexpr int kLeft = 3;
constexpr int kPitch = kCoreW + 8;

struct EyeDomeParams {
  float n2, fpn, fmn, s, ed0, ed1, ed2;
};

__device__ __forceinline__ float linearize(float d, const EyeDomeParams& p) {
  return d >= 1.0f ? 1.0f
                   : __fdiv_rn(p.n2, __fsub_rn(p.fpn, __fmul_rn(d, p.fmn)));
}

__device__ __forceinline__ float4 linearize4(float4 z,
                                             const EyeDomeParams& p) {
  return make_float4(linearize(z.x, p), linearize(z.y, p), linearize(z.z, p),
                     linearize(z.w, p));
}

__device__ __forceinline__ float blend(float c, float e, float alpha) {
  return __fadd_rn(__fmul_rn(c, __fsub_rn(1.0f, alpha)), __fmul_rn(e, alpha));
}

__device__ __forceinline__ bool whole(int r, int c, int w) {
  return c + 4 <= w && (static_cast<size_t>(r) * w + c) % 4 == 0;
}

// four depths of row r from column c on, each column clamped to the image
__device__ __forceinline__ float4 load_depth(const float* __restrict__ z01,
                                             int r, int c, int w) {
  const size_t f = static_cast<size_t>(r) * w + c;
  if (whole(r, c, w)) return *reinterpret_cast<const float4*>(z01 + f);
  const float* row = z01 + static_cast<size_t>(r) * w;
  return make_float4(row[min(c, w - 1)], row[min(c + 1, w - 1)],
                     row[min(c + 2, w - 1)], row[min(c + 3, w - 1)]);
}

struct Rgb {
  float4 a, b, c;
};

__device__ __forceinline__ Rgb load_color(const float* __restrict__ color,
                                          int r, int c, int w) {
  const size_t f = static_cast<size_t>(r) * w + c;
  if (whole(r, c, w)) {
    const float4* src = reinterpret_cast<const float4*>(color + 3 * f);
    return Rgb{src[0], src[1], src[2]};
  }
  float v[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    v[i] = c + i / 3 < w ? color[3 * f + i] : 0.0f;
  }
  return Rgb{make_float4(v[0], v[1], v[2], v[3]),
             make_float4(v[4], v[5], v[6], v[7]),
             make_float4(v[8], v[9], v[10], v[11])};
}

__global__ void __launch_bounds__(kThreads)
eye_dome_tile(const float* __restrict__ color, const float* __restrict__ z01,
              float* __restrict__ out, int h, int w, EyeDomeParams p) {
  __shared__ __align__(16) float lin[kCoreH + 2][kPitch];
  const int t = static_cast<int>(threadIdx.x);
  const int g = t % 32;
  const int r0 = static_cast<int>(blockIdx.y) * kCoreH;
  const int c0 = static_cast<int>(blockIdx.x) * kCoreW;
  const int c = c0 + 4 * g;
  auto row = [&](int i) { return min(max(r0 + i - 1, 0), h - 1); };

  // the thread's two groups: tile rows 1 + t/32 and 9 + t/32
  float4 z[2];
  Rgb rgb[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = 1 + t / 32 + 8 * k;
    z[k] = load_depth(z01, row(i), c, w);
    rgb[k] = load_color(color, row(i), c, w);
  }
  // the halo: rows 0 and kCoreH + 1, then the columns left and right
  float4 zh = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (t < 64) zh = load_depth(z01, row(t < 32 ? 0 : kCoreH + 1), c, w);
  float ze = 0.0f;
  const int e = t - 64;
  if (e >= 0 && e < 2 * (kCoreH + 2)) {
    const int col = e < kCoreH + 2 ? max(c0 - 1, 0) : min(c0 + kCoreW, w - 1);
    ze = z01[static_cast<size_t>(row(e % (kCoreH + 2))) * w + col];
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    *reinterpret_cast<float4*>(&lin[1 + t / 32 + 8 * k][kLeft + 1 + 4 * g]) =
        linearize4(z[k], p);
  }
  if (t < 64) {
    *reinterpret_cast<float4*>(
        &lin[t < 32 ? 0 : kCoreH + 1][kLeft + 1 + 4 * g]) = linearize4(zh, p);
  }
  if (e >= 0 && e < 2 * (kCoreH + 2)) {
    lin[e % (kCoreH + 2)][e < kCoreH + 2 ? kLeft : kLeft + 1 + kCoreW] =
        linearize(ze, p);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = 1 + t / 32 + 8 * k;
    const int r = r0 + i - 1;
    if (r >= h || c >= w) continue;
    const float* mid = &lin[i][kLeft + 1 + 4 * g];
    const float4 up = *reinterpret_cast<const float4*>(&lin[i - 1][kLeft + 1 +
                                                                  4 * g]);
    const float4 dn = *reinterpret_cast<const float4*>(&lin[i + 1][kLeft + 1 +
                                                                  4 * g]);
    const float u[4] = {up.x, up.y, up.z, up.w};
    const float d[4] = {dn.x, dn.y, dn.z, dn.w};
    const float zz[4] = {z[k].x, z[k].y, z[k].z, z[k].w};
    float a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float l = mid[j];
      float m = fmaxf(fmaxf(u[j], d[j]), fmaxf(mid[j - 1], mid[j + 1]));
      m = fmaxf(m, l);
      m = fminf(m, __fadd_rn(l, p.s));
      a[j] = zz[j] < 1.0f ? __fdiv_rn(__fsub_rn(m, l), p.s) : 0.0f;
    }
    const float v[12] = {rgb[k].a.x, rgb[k].a.y, rgb[k].a.z, rgb[k].a.w,
                         rgb[k].b.x, rgb[k].b.y, rgb[k].b.z, rgb[k].b.w,
                         rgb[k].c.x, rgb[k].c.y, rgb[k].c.z, rgb[k].c.w};
    const float ed[3] = {p.ed0, p.ed1, p.ed2};
    float o[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) o[j] = blend(v[j], ed[j % 3], a[j / 3]);
    const size_t f = static_cast<size_t>(r) * w + c;
    if (whole(r, c, w)) {
      float4* dst = reinterpret_cast<float4*>(out + 3 * f);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
      dst[2] = make_float4(o[8], o[9], o[10], o[11]);
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        if (c + j / 3 < w) out[3 * f + j] = o[j];
      }
    }
  }
}

}  // namespace

extern "C" int treee_eye_dome(const float* color, const float* z01,
                              float* out, int h, int w, float n2, float fpn,
                              float fmn, float s, float ed0, float ed1,
                              float ed2, cudaStream_t stream) {
  if (h <= 0 || w <= 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<size_t>(color) | reinterpret_cast<size_t>(z01) |
       reinterpret_cast<size_t>(out)) % 16) {
    return cudaErrorMisalignedAddress;
  }
  const dim3 grid((w + kCoreW - 1) / kCoreW, (h + kCoreH - 1) / kCoreH);
  const EyeDomeParams p{n2, fpn, fmn, s, ed0, ed1, ed2};
  eye_dome_tile<<<grid, kThreads, 0, stream>>>(color, z01, out, h, w, p);
  return cudaGetLastError();
}

TREEE_PACKED(treee_eye_dome)
