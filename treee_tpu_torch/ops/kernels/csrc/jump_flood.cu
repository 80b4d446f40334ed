// Jump-flood Voronoi over a stack of bands: the nearest seed slot per cell.
//
// Replaces treee_tpu/ops/pallas_kernels.py::_jfa_kernel (called through
// jump_flood_pallas, one band per call; here all bands at once, as
// treee_tpu/segmentation.py::_jump_flood batches them).  Contract: seed_slot
// i32[B,G,G] (-1 where no seed), seed_pos f32[B,G,G,2] (the seeds' absolute
// x, z), cell_center f32[G,G,2]; out i32[B,G,G].  For each step s = G/2,
// G/4, ..., 1 and each direction (dy, dx), dy in (-s, 0, s) outer and dx
// in (-s, 0, s) inner, skipping (0, 0), every cell (i, j) looks at the cell
// ((i - dy) mod G, (j - dx) mod G) (the roll wraps, and a wrapped seed is a
// real candidate) and takes its seed when that seed's squared distance
// (sx - cx)^2 + (sz - cz)^2 is strictly smaller than its own.  Each
// direction reads the state the previous direction left.  The distance is
// recomputed from the carried (sx, sz) rather than carried: it is the same
// f32 value (__fmul_rn/__fadd_rn, -fmad=false, as the plain version's
// separate torch ops round), so the output equals the plain PyTorch version
// bit for bit.
//
// What bounds it on the H100: the TPU kernel keeps one band's whole state in
// VMEM for all 8 log2(G) directions.  At G = 384 one band's state (slot,
// sx, sz) is 1.77 MB, far above a CTA's 227 KB of shared memory, and each
// direction needs the whole band updated before the next reads it.  So the
// simple right design is one launch per direction over all bands, one
// thread per cell, with ping-pong state buffers: 64 launches at G = 384.
// Each launch reads the state twice (own cell and candidate, the latter
// mostly from L2) and writes it once, so it is bound by device memory at
// ~64x the 152 MB the function must move.  A cluster or cooperative design
// that keeps bands on chip across directions is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 3.0e38f;

__device__ __forceinline__ float sq_dist(float sx, float sz, float cx,
                                         float cz) {
  const float ex = __fsub_rn(sx, cx);
  const float ez = __fsub_rn(sz, cz);
  return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ez, ez));
}

__global__ void __launch_bounds__(kThreads)
flood_direction(const int* __restrict__ slot_in,
                const float2* __restrict__ pos_in,
                const float2* __restrict__ center, int* __restrict__ slot_out,
                float2* __restrict__ pos_out, int b, int g, int dy, int dx) {
  const long long gg = static_cast<long long>(g) * g;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= gg * b) return;
  const long long band = idx / gg;
  const int cell = static_cast<int>(idx - band * gg);
  const int i = cell / g;
  const int j = cell - i * g;
  int si = (i - dy) % g;
  if (si < 0) si += g;
  int sj = (j - dx) % g;
  if (sj < 0) sj += g;
  const long long src = band * gg + static_cast<long long>(si) * g + sj;

  const float2 c = center[cell];
  int s = slot_in[idx];
  float2 p = pos_in[idx];
  const float d = s >= 0 ? sq_dist(p.x, p.y, c.x, c.y) : kInf;
  const int cs = slot_in[src];
  if (cs >= 0) {
    const float2 cp = pos_in[src];
    if (sq_dist(cp.x, cp.y, c.x, c.y) < d) {
      s = cs;
      p = cp;
    }
  }
  slot_out[idx] = s;
  pos_out[idx] = p;
}

}  // namespace

// seed_slot i32[b,g,g], seed_pos f32[b,g,g,2], cell_center f32[g,g,2], read
// only; out and tmp i32[b,g,g], pos_a and pos_b f32[b,g,g,2] scratch; all on
// the device.  Runs 8 launches per step on `stream`, alternating between
// (out, pos_a) and (tmp, pos_b) so that the last one writes `out` (a copy of
// seed_slot when g < 2 makes no step).  Returns the first CUDA error, or 0.
extern "C" int treee_jump_flood(const int* seed_slot, const float* seed_pos,
                                const float* cell_center, int* out, int* tmp,
                                float* pos_a, float* pos_b, int b, int g,
                                cudaStream_t stream) {
  if (b <= 0 || g <= 0) return cudaErrorInvalidValue;
  int n_steps = 0;
  for (int s = g / 2; s >= 1; s /= 2) ++n_steps;
  const long long cells = static_cast<long long>(b) * g * g;
  if (n_steps == 0) {
    return cudaMemcpyAsync(out, seed_slot, sizeof(int) * cells,
                           cudaMemcpyDeviceToDevice, stream);
  }
  const unsigned blocks = static_cast<unsigned>((cells + kThreads - 1) / kThreads);
  const int launches = 8 * n_steps;
  const int* slot_src = seed_slot;
  const float2* pos_src = reinterpret_cast<const float2*>(seed_pos);
  const float2* center = reinterpret_cast<const float2*>(cell_center);
  int i = 0;
  for (int s = g / 2; s >= 1; s /= 2) {
    for (int dy = -s; dy <= s; dy += s) {
      for (int dx = -s; dx <= s; dx += s) {
        if (dy == 0 && dx == 0) continue;
        const bool last_parity = (launches - 1 - i) % 2 == 0;
        int* slot_dst = last_parity ? out : tmp;
        float2* pos_dst = reinterpret_cast<float2*>(last_parity ? pos_a : pos_b);
        flood_direction<<<blocks, kThreads, 0, stream>>>(
            slot_src, pos_src, center, slot_dst, pos_dst, b, g, dy, dx);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        slot_src = slot_dst;
        pos_src = pos_dst;
        ++i;
      }
    }
  }
  return cudaSuccess;
}
