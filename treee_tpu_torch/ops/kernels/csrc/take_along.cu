// Gather from a table: take_along_axis on axis 0 or 1 of a 2-D f32 table, or
// a 1-D f32 table indexed by an index array of any shape.
//
// Replaces the Mosaic gather probe tools/probe_extract.py::try_kernel (the
// pl.pallas_call at :97) with its bodies k_taa0 (:109, take_along_axis on
// axis 0), k_taa1 (:123, axis 1) and k_take (:129, tab[0, idx2d]).  That probe
// asked whether a TPU kernel can gather inside its fast memory (VMEM).
//
// All three forms are one gather over the flat output index e:
// out[e] = tab[base(e) + idx[e] * stride].  Axis 0 (tab[R,L], idx[M,L]):
// base = e mod L, stride = L, R entries along the gather.  Axis 1 (tab[R,L],
// idx[R,M]): base = (e / M) * L, stride 1, L entries.  1-D: base 0, stride
// 1.  An index outside the gathered axis gives NaN (JAX's fill value for an
// out-of-bounds gather).
//
// What bounds it on the H100: bytes, and at the probe's shapes (at most
// 256 x 128) the launch itself: a call moves a few hundred KB, far less than
// one launch's latency.  So each thread reads its indices (coalesced) and
// gathers straight from the table through the read-only path (L1 / L2),
// kPer outputs a thread in one pass; a probe shape of 1024 outputs is one
// CTA.  The earlier design staged the table in 48 KB chunks of shared memory
// with two barriers a chunk (compare_kernels.py --only gather times the two).
#include <cuda_runtime.h>

#include "packed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                         // outputs per thread
constexpr int kTile = kThreads * kPer;          // outputs per block

__global__ void __launch_bounds__(kThreads)
take_along_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                  float* __restrict__ out, long long n, int n_q, int cols,
                  int m, int axis) {
  const long long e0 = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  int q[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long e = e0 + k * kThreads;
    q[k] = e < n ? __ldg(idx + e) : -1;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long e = e0 + k * kThreads;
    if (e >= n) continue;
    float v = __int_as_float(0x7FC00000);       // NaN
    if (q[k] >= 0 && q[k] < n_q) {
      long long at;
      if (axis == 0) {
        at = e % cols + static_cast<long long>(q[k]) * cols;
      } else if (axis == 1) {
        at = e / m * cols + q[k];
      } else {
        at = q[k];
      }
      v = __ldg(tab + at);
    }
    out[e] = v;
  }
}

}  // namespace

// tab f32, idx i32, out f32 (shaped as idx), all contiguous on the device.
// axis 0: tab[R,L], idx[M,L] -> out[m,l] = tab[idx[m,l], l].
// axis 1: tab[R,L], idx[R,M] -> out[r,m] = tab[r, idx[r,m]].
// axis -1 (none): tab[L], idx of n_idx values -> out[i] = tab[idx[i]].
// rows/cols are tab's shape (rows = 1 for the 1-D form) and m the indices per
// row or column (n_idx for the 1-D form).  One launch on `stream`; returns
// its CUDA error, or 0.
extern "C" int treee_take_along(const float* tab, const int* idx, float* out,
                                int rows, int cols, int m, int axis,
                                cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || m < 0) return cudaErrorInvalidValue;
  if (axis != 0 && axis != 1 && !(axis == -1 && rows == 1))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  // outputs, and the entries along the gathered axis
  const long long n = static_cast<long long>(m) * (axis == 0 ? cols
                                                   : axis == 1 ? rows : 1);
  const int n_q = axis == 0 ? rows : cols;
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  take_along_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      tab, idx, out, n, n_q, cols, m, axis);
  return cudaGetLastError();
}

TREEE_PACKED(treee_take_along)
