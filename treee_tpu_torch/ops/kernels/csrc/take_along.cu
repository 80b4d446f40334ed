// Gather from a table staged in shared memory: take_along_axis on axis 0 or
// 1 of a 2-D f32 table, or a 1-D f32 table indexed by an index array of any
// shape.
//
// Replaces the Mosaic gather probe tools/probe_extract.py::try_kernel (the
// pl.pallas_call at :97) with its bodies k_taa0 (:109, take_along_axis on
// axis 0), k_taa1 (:123, axis 1) and k_take (:129, tab[0, idx2d]).  That probe
// asked whether a TPU kernel can gather inside its fast memory (VMEM); the
// Hopper counterpart gathers from shared memory.
//
// All three forms are one gather along q of a strided table view TT[p, q]:
// out[p, j] = TT[p, idx[p, j]].  Axis 1: p is the row, q the column.  Axis 0:
// p is the column and q the row (unit stride along p, so threads run along p
// for coalesced loads).  1-D: one p, the indices flattened along j.  A block
// owns a tile of pb (p) x jb (j) = 1024 outputs, four a thread, reads its
// indices once into registers, then stages the table's rows [p0, p0+pb) in
// chunks of up to `qc` columns (48 KB of shared memory) and picks each output
// from the chunk that holds its index.  A table larger than shared memory
// therefore takes several chunks, each read once per block.  An index outside
// [0, Q) matches no chunk and gives NaN (JAX's fill value for an
// out-of-bounds gather).
//
// What bounds it on the H100: bytes.  Each output costs one 4-byte index read
// and one 4-byte write, and the table is read once per block tile; at the
// probe's shapes (at most 256 x 128) the whole call is a few hundred KB, so a
// launch takes longer than the traffic.  ptxas (nvcc 12.9, sm_90a): 48
// registers, no spills.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                         // outputs per thread
constexpr int kTile = kThreads * kPer;          // outputs per block
constexpr int kSmemFloats = 48 * 1024 / 4;      // 48 KB of staged table

__global__ void __launch_bounds__(kThreads)
take_along_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                  float* __restrict__ out, int n_p, int n_q, int n_j,
                  long long sp, long long sq, long long ip, long long ij,
                  int pb, int jb, int qc, int p_fast) {
  extern __shared__ float stage[];              // [pb][qc + 1]
  const int qs = qc + 1;                        // padded row stride
  const int j_tiles = (n_j + jb - 1) / jb;
  const int p0 = static_cast<int>(blockIdx.x / j_tiles) * pb;
  const int j0 = static_cast<int>(blockIdx.x % j_tiles) * jb;

  int pl[kPer], q_of[kPer];
  long long off[kPer];
  float val[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int a = p_fast ? e % pb : e / jb;
    const int b = p_fast ? e / pb : e % jb;
    const int p = p0 + a;
    const int j = j0 + b;
    const bool ok = e < pb * jb && p < n_p && j < n_j;
    pl[k] = a;
    off[k] = ok ? static_cast<long long>(p) * ip + static_cast<long long>(j) * ij
                : -1;
    q_of[k] = ok ? idx[off[k]] : -1;
    val[k] = __int_as_float(0x7FC00000);        // NaN
  }

  for (int q0 = 0; q0 < n_q; q0 += qc) {
    const int n = min(qc, n_q - q0);
    __syncthreads();                            // the last chunk is read
    for (int e = threadIdx.x; e < pb * n; e += kThreads) {
      const int a = p_fast ? e % pb : e / n;
      const int b = p_fast ? e / pb : e % n;
      const int p = p0 + a;
      stage[a * qs + b] =
          p < n_p ? tab[static_cast<long long>(p) * sp +
                        static_cast<long long>(q0 + b) * sq]
                  : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = q_of[k] - q0;
      if (q >= 0 && q < n) val[k] = stage[pl[k] * qs + q];
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (off[k] >= 0) out[off[k]] = val[k];
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
  if (m == 0) return cudaSuccess;
  int n_p, n_q, pb, jb, p_fast;
  long long sp, sq, ip, ij;
  if (axis == 0) {          // p = column, q = row, j = index row
    n_p = cols, n_q = rows, sp = 1, sq = cols, ip = 1, ij = cols;
    pb = 32, jb = kTile / 32, p_fast = 1;
  } else if (axis == 1) {   // p = row, q = column, j = index column
    n_p = rows, n_q = cols, sp = cols, sq = 1, ip = m, ij = 1;
    pb = 8, jb = kTile / 8, p_fast = 0;
  } else if (axis == -1 && rows == 1) {
    n_p = 1, n_q = cols, sp = 0, sq = 1, ip = 0, ij = 1;
    pb = 1, jb = kTile, p_fast = 0;
  } else {
    return cudaErrorInvalidValue;
  }
  const int qc = min(n_q, kSmemFloats / pb - 1);
  const size_t smem = sizeof(float) * pb * (qc + 1);
  const long long blocks = static_cast<long long>((m + jb - 1) / jb) *
                           ((n_p + pb - 1) / pb);
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  take_along_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      tab, idx, out, n_p, n_q, m, sp, sq, ip, ij, pb, jb, qc, p_fast);
  return cudaGetLastError();
}
