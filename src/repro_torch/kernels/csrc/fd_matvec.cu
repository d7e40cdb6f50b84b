// fd_matvec: the full-gradient-phase margins of one dense feature block,
//
//     out[n] = sum_k w[k] * D[k, n]        D row-major [d, N], k < d, n < N
//
// Replaces the Pallas TPU kernel repro/kernels/fd_matvec.py (fd_matvec,
// the pallas_call at :61), a tiled GEMV on the MXU with a float32
// accumulator.  w and D are float32 or bfloat16 (the template's T); every
// product is formed and summed in float32 (a bfloat16 product is exact in
// float32), and out is float32.
//
// What bounds it on an H100: bytes.  D is read once: 13.5 GB in float32
// for news20 block 0 at q = 8 (d = 169,399, N = 19,954; 3,380,187,646
// elements, more than 2^31), 4.04 ms at 3.35 TB/s, half that in bfloat16.
// Two flops per element are 0.1 ms at 67 TFLOP/s.  No reuse: each element
// of D feeds one FMA, so a plain FFMA kernel that keeps enough loads in
// flight is enough, and tensor cores would buy nothing at one column of w.
//
// Design: two launches, no atomics, so the result is deterministic.
//   1. fd_matvec_partial_kernel — grid (column blocks, row slices), blocks
//      of `threads` threads: one thread per column n, coalesced reads
//      along N; the block's slice of `slice_rows` rows of w is staged in
//      dynamic shared memory as float32, and each thread sums its
//      column's slice in increasing k with fmaf into partial[slice, n].
//      The slices are what fills the card: at N = 1 (one sampled column)
//      the rows alone give the parallelism.
//   2. fd_matvec_reduce_kernel — one thread per column adds the slices'
//      partials in slice order, from 0.0.
// Offsets into D are size_t: k * N + n passes 2^31 once k > 107,619 at
// N = 19,954.  Any d, N >= 1 works (the ragged last slice and the last
// column block are masked).  The wrapper (kernels/fd_matvec.py) owns the
// geometry: it chooses `threads` and `slice_rows` from the card's SM
// count and allocates the float32 partials [ceil(d / slice_rows), N];
// this file checks them only against the launch limits.
//
// Preconditions (checked by the wrapper): w [d] and D [d, N] of one dtype
// (0 = float32, 1 = bfloat16), float32 partial/out, all contiguous, on the
// current device.  Returns cudaErrorInvalidValue unless threads is in
// [1, 1024], the staged slice fits the 48 KB of dynamic shared memory a
// launch gets without opting in, and ceil(d / slice_rows) <= 65535; else
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 256;
constexpr size_t kMaxStagedBytes = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__global__ void fd_matvec_partial_kernel(const T* __restrict__ w,
                                         const T* __restrict__ D,
                                         float* __restrict__ partial, int d,
                                         int n, int slice_rows) {
  extern __shared__ float ws[];  // slice_rows floats
  const int k0 = blockIdx.y * slice_rows;
  const int rows = min(slice_rows, d - k0);
  for (int k = threadIdx.x; k < rows; k += blockDim.x) {
    ws[k] = to_f32(w[k0 + k]);
  }
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const T* p = D + static_cast<size_t>(k0) * n + col;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < rows; ++k) {
    acc = fmaf(ws[k], to_f32(p[static_cast<size_t>(k) * n]), acc);
  }
  partial[static_cast<size_t>(blockIdx.y) * n + col] = acc;
}

__global__ void __launch_bounds__(kReduceThreads)
fd_matvec_reduce_kernel(const float* __restrict__ partial,
                        float* __restrict__ out, int n, int slices) {
  const int col = blockIdx.x * kReduceThreads + threadIdx.x;
  if (col >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < slices; ++s) {
    acc = __fadd_rn(acc, partial[static_cast<size_t>(s) * n + col]);
  }
  out[col] = acc;
}

template <class T>
void launch_partial(const void* w, const void* D, float* partial, int d,
                    int n, int slice_rows, int slices, int threads,
                    cudaStream_t stream) {
  const dim3 grid((n + threads - 1) / threads, slices);
  const size_t staged = static_cast<size_t>(slice_rows) * sizeof(float);
  fd_matvec_partial_kernel<T><<<grid, threads, staged, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(D), partial, d, n,
      slice_rows);
}

}  // namespace

extern "C" int repro_fd_matvec(const void* w, const void* D, float* partial,
                               float* out, int d, int n, int slice_rows,
                               int threads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || slice_rows < 1 ||
      static_cast<size_t>(slice_rows) * sizeof(float) > kMaxStagedBytes ||
      threads < 1 || threads > 1024 || d < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slices = (d + slice_rows - 1) / slice_rows;
  if (slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (slices > 0) {
    if (dtype == 0) {
      launch_partial<float>(w, D, partial, d, n, slice_rows, slices, threads,
                            s);
    } else {
      launch_partial<__nv_bfloat16>(w, D, partial, d, n, slice_rows, slices,
                                    threads, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fd_matvec_reduce_kernel<<<(n + kReduceThreads - 1) / kReduceThreads,
                            kReduceThreads, 0, s>>>(partial, out, n, slices);
  return static_cast<int>(cudaGetLastError());
}
