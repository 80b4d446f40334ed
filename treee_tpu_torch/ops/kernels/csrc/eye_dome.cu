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
// What bounds it on the H100: device memory.  At 720p it must read 3.7 MB
// of depth and 11 MB of colour and write 11 MB: 7.7 us at 3.35 TB/s.
// Design: a warp takes a strip of 128 columns by kStripRows rows, each
// thread 4 neighbouring pixels of a row, and walks the strip down a row at a
// time with no barrier: the next row's depth and colour loads go out before
// the current row's arithmetic, so every warp keeps loads and stores in
// flight at once.  A group of 4 pixels moves its depth as one 16-byte access
// and its colour (HWC, 48 bytes) as three, where it starts on a 16-byte
// boundary (every group when W is a multiple of 4); a group that does not,
// or that W cuts short, takes scalar accesses.  Each depth is linearized
// once in its strip and the rows above and below it once more (twice a
// depth in all, the first design five times), its left and right
// neighbours come from the thread's own registers and the neighbouring
// lanes' (shuffles), the two columns beyond the strip from lanes 0 and 31.
// A 2-D tile of linearized depths in shared memory (1.14 linearizations a
// depth) measured slower, as did taller strips: with a barrier between its
// loads and its stores, or fewer warps in flight, a wave's reads and writes
// do not overlap, and a division costs nothing beside the bytes.
#include <cuda_runtime.h>

#include "packed.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStripRows = 2;
constexpr int kStripW = 32 * 4;

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

// whether the group of 4 pixels from (r, c) on lies whole in its row on a
// 16-byte boundary
__device__ __forceinline__ bool whole(int r, int c, int w) {
  return c + 4 <= w && (static_cast<size_t>(r) * w + c) % 4 == 0;
}

// four depths from (r, c) on, each column clamped to the image
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
eye_dome_strip(const float* __restrict__ color, const float* __restrict__ z01,
               float* __restrict__ out, int h, int w, EyeDomeParams p) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int r0 = (static_cast<int>(blockIdx.y) * kWarps + warp) * kStripRows;
  if (r0 >= h) return;
  const int col0 = static_cast<int>(blockIdx.x) * kStripW;
  const int c = col0 + 4 * lane;
  const int cl = max(col0 - 1, 0), cr = min(col0 + kStripW, w - 1);
  const float* zrow = z01 + static_cast<size_t>(r0) * w;

  float4 lin_prev = linearize4(load_depth(z01, max(r0 - 1, 0), c, w), p);
  float4 z_cur = load_depth(z01, r0, c, w);
  float4 z_next = load_depth(z01, min(r0 + 1, h - 1), c, w);
  Rgb rgb = load_color(color, r0, c, w);
  // the depths left and right of the strip, read by lanes 0 and 31
  float edge = lane == 0 ? zrow[cl] : lane == 31 ? zrow[cr] : 0.0f;
  float4 lin_cur = linearize4(z_cur, p);
#pragma unroll
  for (int i = 0; i < kStripRows; ++i) {
    const int r = r0 + i;
    if (r >= h) break;
    const float4 lin_next = linearize4(z_next, p);
    const float lin_edge = linearize(edge, p);
    // the next row's loads go out before this row's arithmetic
    float4 z_after = z_next;
    Rgb rgb_next = rgb;
    float edge_next = edge;
    if (i + 1 < kStripRows && r + 1 < h) {
      z_after = load_depth(z01, min(r + 2, h - 1), c, w);
      rgb_next = load_color(color, r + 1, c, w);
      const float* nrow = z01 + static_cast<size_t>(r + 1) * w;
      edge_next = lane == 0 ? nrow[cl] : lane == 31 ? nrow[cr] : 0.0f;
    }
    float left = __shfl_up_sync(0xFFFFFFFFu, lin_cur.w, 1);
    float right = __shfl_down_sync(0xFFFFFFFFu, lin_cur.x, 1);
    if (lane == 0) left = lin_edge;
    if (lane == 31) right = lin_edge;
    const float l[4] = {lin_cur.x, lin_cur.y, lin_cur.z, lin_cur.w};
    const float lt[4] = {left, lin_cur.x, lin_cur.y, lin_cur.z};
    const float rt[4] = {lin_cur.y, lin_cur.z, lin_cur.w, right};
    const float u[4] = {lin_prev.x, lin_prev.y, lin_prev.z, lin_prev.w};
    const float d[4] = {lin_next.x, lin_next.y, lin_next.z, lin_next.w};
    const float zz[4] = {z_cur.x, z_cur.y, z_cur.z, z_cur.w};
    float a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float m = fmaxf(fmaxf(u[k], d[k]), fmaxf(lt[k], rt[k]));
      m = fmaxf(m, l[k]);
      m = fminf(m, __fadd_rn(l[k], p.s));
      a[k] = zz[k] < 1.0f ? __fdiv_rn(__fsub_rn(m, l[k]), p.s) : 0.0f;
    }
    const float v[12] = {rgb.a.x, rgb.a.y, rgb.a.z, rgb.a.w,
                         rgb.b.x, rgb.b.y, rgb.b.z, rgb.b.w,
                         rgb.c.x, rgb.c.y, rgb.c.z, rgb.c.w};
    const float ed[3] = {p.ed0, p.ed1, p.ed2};
    float o[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) o[k] = blend(v[k], ed[k % 3], a[k / 3]);
    if (c < w) {
      const size_t f = static_cast<size_t>(r) * w + c;
      if (whole(r, c, w)) {
        float4* dst = reinterpret_cast<float4*>(out + 3 * f);
        dst[0] = make_float4(o[0], o[1], o[2], o[3]);
        dst[1] = make_float4(o[4], o[5], o[6], o[7]);
        dst[2] = make_float4(o[8], o[9], o[10], o[11]);
      } else {
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          if (c + k / 3 < w) out[3 * f + k] = o[k];
        }
      }
    }
    lin_prev = lin_cur;
    lin_cur = lin_next;
    z_cur = z_next;
    z_next = z_after;
    rgb = rgb_next;
    edge = edge_next;
  }
}

}  // namespace

// color, out: f32[h,w,3]; z01: f32[h,w]; all on the device, contiguous and
// starting on a 16-byte boundary.  One launch on `stream`.  Returns the
// CUDA error of the launch, or 0.
extern "C" int treee_eye_dome(const float* color, const float* z01,
                              float* out, int h, int w, float n2, float fpn,
                              float fmn, float s, float ed0, float ed1,
                              float ed2, cudaStream_t stream) {
  if (h <= 0 || w <= 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<size_t>(color) | reinterpret_cast<size_t>(z01) |
       reinterpret_cast<size_t>(out)) % 16) {
    return cudaErrorMisalignedAddress;
  }
  constexpr int kBlockRows = kWarps * kStripRows;
  const dim3 grid((w + kStripW - 1) / kStripW,
                  (h + kBlockRows - 1) / kBlockRows);
  const EyeDomeParams p{n2, fpn, fmn, s, ed0, ed1, ed2};
  eye_dome_strip<<<grid, kThreads, 0, stream>>>(color, z01, out, h, w, p);
  return cudaGetLastError();
}

TREEE_PACKED(treee_eye_dome)
