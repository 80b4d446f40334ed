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
// What bounds it on the H100: device memory.  At N = 15M, C = 3 it must read
// 180 MB of values and 60 MB of keys and write 180 MB.  Design: one CTA per
// block (1024 threads, block/1024 rows each).  The block's keys and one
// channel at a time sit in shared memory (64 KB at block 8192, whatever C),
// and the log2(block) doubling steps run there, each thread holding its
// rows' new values in registers between the read and the write barrier.
// The carry is a sequential recurrence over the nb = N/block blocks; one
// thread per channel walks it over block summaries staged in shared memory
// (a second launch), and a third launch adds each carry to the leading run
// of its block.  Only blocks that continue a run are touched again.  A
// decoupled look-back in one launch would save the second and third
// launches' traffic; that is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxItems = 8;  // 8192 rows / 1024 threads
constexpr int kChain = 1024;  // block summaries staged per chain round

__global__ void __launch_bounds__(kThreads)
scan_block(const int* __restrict__ key, const float* __restrict__ val,
           float* __restrict__ out, long long n, int c, int block,
           int* __restrict__ last_key, float* __restrict__ last_val) {
  extern __shared__ int smem[];
  int* s_key = smem;
  float* s_val = reinterpret_cast<float*>(smem + block);
  const long long lo = static_cast<long long>(blockIdx.x) * block;
  const int rows = static_cast<int>(n - lo < block ? n - lo : block);
  const int threads = blockDim.x;
  const int items = block / threads;

  for (int r = threadIdx.x; r < block; r += threads)
    s_key[r] = r < rows ? key[lo + r] : 0;
  for (int ch = 0; ch < c; ++ch) {
    __syncthreads();
    for (int r = threadIdx.x; r < block; r += threads)
      s_val[r] = r < rows ? val[(lo + r) * c + ch] : 0.0f;
    __syncthreads();
    for (int s = 1; s < block; s <<= 1) {
      float nv[kMaxItems];
#pragma unroll
      for (int j = 0; j < kMaxItems; ++j) {
        const int r = threadIdx.x + j * threads;
        if (j < items) {
          const float cand =
              (r >= s && s_key[r] == s_key[r - s]) ? s_val[r - s] : 0.0f;
          nv[j] = __fadd_rn(s_val[r], cand);
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxItems; ++j)
        if (j < items) s_val[threadIdx.x + j * threads] = nv[j];
      __syncthreads();
    }
    for (int r = threadIdx.x; r < rows; r += threads)
      out[(lo + r) * c + ch] = s_val[r];
    if (threadIdx.x == 0)
      last_val[static_cast<long long>(blockIdx.x) * c + ch] = s_val[rows - 1];
  }
  if (threadIdx.x == 0) last_key[blockIdx.x] = s_key[rows - 1];
}

// carry[i*c + ch] for i >= 1: block i-1's last row after its own carry.
// One thread per channel walks the blocks in order.
__global__ void __launch_bounds__(kThreads)
chain(const int* __restrict__ last_key, const float* __restrict__ last_val,
      float* __restrict__ carry, int nb, int c) {
  extern __shared__ int smem[];
  int* s_key = smem;                                      // kChain + 1
  float* s_val = reinterpret_cast<float*>(smem + kChain + 1);  // kChain * c
  const int ch = threadIdx.x;
  float inc = 0.0f;
  for (int base = 0; base < nb; base += kChain) {
    const int m = nb - base < kChain ? nb - base : kChain;
    __syncthreads();
    for (int i = threadIdx.x; i <= m; i += blockDim.x)
      s_key[i] = base + i >= 1 ? last_key[base + i - 1] : 0;
    for (int i = threadIdx.x; i < m * c; i += blockDim.x)
      s_val[i] = last_val[static_cast<long long>(base) * c + i];
    __syncthreads();
    if (ch < c) {
      for (int i = 0; i < m; ++i) {
        const int b = base + i;
        const float v = s_val[i * c + ch];
        if (b == 0) {
          inc = v;
        } else {
          carry[static_cast<long long>(b) * c + ch] = inc;
          // s_key[i] is block b-1's last key, s_key[i+1] block b's
          inc = s_key[i + 1] == s_key[i] ? __fadd_rn(v, inc) : v;
        }
      }
    }
  }
}

// Rows of block b >= 1 whose key equals block b-1's last key add carry[b].
__global__ void __launch_bounds__(kThreads)
fold_carry(const int* __restrict__ key, float* __restrict__ out, long long n,
           int c, int block, const int* __restrict__ last_key,
           const float* __restrict__ carry) {
  const int b = blockIdx.x + 1;
  const int k0 = last_key[b - 1];
  const long long lo = static_cast<long long>(b) * block;
  if (key[lo] != k0) return;
  const long long hi = lo + block < n ? lo + block : n;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    if (key[i] != k0) break;
    for (int ch = 0; ch < c; ++ch)
      out[i * c + ch] = __fadd_rn(out[i * c + ch],
                                  carry[static_cast<long long>(b) * c + ch]);
  }
}

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

long long n_blocks(long long n, int block) { return (n + block - 1) / block; }

constexpr int kMaxChannels = 16;

}  // namespace

// scratch: last_key (nb ints), last_val and carry (nb*c floats each)
extern "C" long long treee_seg_cumsum_scratch_bytes(long long n, int c,
                                                    int block) {
  const long long nb = n_blocks(n, block);
  return static_cast<long long>(align256(sizeof(int) * nb) +
                                2 * align256(sizeof(float) * nb * c));
}

// key i32[n], val/out f32[n,c] on the device; block a power of two in
// [1, 8192]; scratch holds treee_seg_cumsum_scratch_bytes(n, c, block)
// bytes.  Launches on `stream`.  Returns the first CUDA error, or 0.
extern "C" int treee_seg_cumsum(const int* key, const float* val, float* out,
                                long long n, int c, int block, void* scratch,
                                cudaStream_t stream) {
  if (n <= 0 || c <= 0 || c > kMaxChannels || block < 1 ||
      block > kThreads * kMaxItems || (block & (block - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const long long nb = n_blocks(n, block);
  char* s = static_cast<char*>(scratch);
  int* last_key = reinterpret_cast<int*>(s);
  s += align256(sizeof(int) * nb);
  float* last_val = reinterpret_cast<float*>(s);
  s += align256(sizeof(float) * nb * c);
  float* carry = reinterpret_cast<float*>(s);

  const int threads = block < kThreads ? block : kThreads;
  const int smem = 2 * block * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      scan_block, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  scan_block<<<static_cast<unsigned>(nb), threads, smem, stream>>>(
      key, val, out, n, c, block, last_key, last_val);
  err = cudaGetLastError();
  if (err != cudaSuccess || nb == 1) return err;

  const int chain_smem =
      static_cast<int>(sizeof(int) * (kChain + 1) + sizeof(float) * kChain * c);
  err = cudaFuncSetAttribute(chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             chain_smem);
  if (err != cudaSuccess) return err;
  chain<<<1, kThreads, chain_smem, stream>>>(last_key, last_val, carry,
                                             static_cast<int>(nb), c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_carry<<<static_cast<unsigned>(nb - 1), kThreads, 0, stream>>>(
      key, out, n, c, block, last_key, carry);
  return cudaGetLastError();
}
