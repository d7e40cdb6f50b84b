// fd_matvec: the full-gradient-phase margins of one dense feature block,
//
//     out[n] = sum_k w[k] * D[k, n]        D [d, N], element (k, n) at k * ld + n
//
// Replaces the Pallas TPU kernel repro/kernels/fd_matvec.py (fd_matvec,
// the pallas_call at :61), a tiled GEMV on the MXU with a float32
// accumulator.  w and D are float32 or bfloat16 (the template's T); every
// product is formed and summed in float32 (a bfloat16 product is exact in
// float32), and out is float32.  D's columns have unit stride and its rows
// any stride ld >= N, so one column of a larger matrix (D[:, i:i+1]) is
// read in place.
//
// What bounds it on an H100: bytes.  D is read once: 13.5 GB in float32
// for news20 block 0 at q = 8 (d = 169,399, N = 19,954; 3,380,187,646
// elements, more than 2^31), 4.04 ms at 3.35 TB/s, half that in bfloat16.
// Two flops per element are 0.1 ms at 67 TFLOP/s.  No reuse: each element
// of D feeds one FMA, so the design is about keeping HBM busy:
//   * every thread loads VEC adjacent columns of each row it visits in one
//     load, VEC the widest (at most 16 bytes) that N, ld and D's address
//     allow: a row of 19,954 float32 is 8 bytes past a 16-byte boundary
//     every other row, so there VEC = 2 (8 bytes; 4 in bfloat16);
//   * UR = 8 rows are loaded before their FMAs, eight loads in flight a
//     thread; the wrapper cuts the rows into slices of ~800 so the grid is
//     many waves of short blocks.  On an H100 80GB HBM3 at 700 W, more
//     loads a thread (32 bytes of a row as 2-8 chunks), longer slices, or
//     whole rows per block measured slower, bfloat16 markedly;
//   * at wide N, w's slice is staged in shared memory as float32 and read
//     once per row for all of a thread's columns (a broadcast); at narrow N
//     each thread reads its rows' w beside D (one trip to memory, not two);
//   * at small N the block's threads split the rows too: TX threads along
//     the columns, TY = 256 / TX along the rows (N = 1: TX = 1, TY = 256,
//     eight rows a thread), then a fixed tree over TY in shared memory.
// One launch, no float atomics, so the result is deterministic: grid
// (column blocks, row slices); each block sums its slice in increasing k
// (rows ty, ty + TY, ... then the tree) into partial[slice, n]; the last
// block of a column block to finish (an int ticket taken after
// __threadfence(), then reset to 0 for the next launch) adds the slices'
// partials in slice order, from 0.0, into out (at few columns through
// shared memory, so their loads are one trip, not one a slice).  The tickets are the
// wrapper's per-stream buffer, zero between launches.
// Offsets into D are size_t: k * N + n passes 2^31 once k > 107,619 at
// N = 19,954.  The wrapper (kernels/fd_matvec.py) owns the geometry (VEC,
// TX and the slice rows, from N, ld and the card's SM count) and allocates
// the float32 partials [ceil(d / slice_rows), N]; this file checks them
// only against the launch limits.
//
// Preconditions (checked by the wrapper): w [d] contiguous and D of one
// dtype (0 = float32, 1 = bfloat16), N, ld and D's address multiples of
// VEC, float32 partial/out contiguous, tickets int32 >= the column blocks
// and zero, all on the current device.  Returns cudaErrorInvalidValue
// unless d, N >= 1, ld >= N, TX is a power of two <= 256, VEC is a power
// of two with VEC * sizeof(T) <= 16, the staged slice and the tree's
// scratch fit 48 KB beside the static shared memory, and the grid fits;
// else cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // rows whose loads are issued before their FMAs
constexpr size_t kMaxSharedBytes = 48 * 1024 - 1088;  // dynamic, beside `stage` and `last`

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T, int VEC>
struct alignas(sizeof(T) * VEC) Chunk {
  T v[VEC];
};

template <class T, int VEC>
__global__ void __launch_bounds__(kThreads)
fd_matvec_kernel(const T* __restrict__ w, const T* __restrict__ D,
                 float* __restrict__ partial, float* __restrict__ out,
                 int* __restrict__ tickets, int d, int n, long long ld,
                 int slice_rows, int tx_log2) {
  extern __shared__ float smem[];
  float* ws = smem;                // slice_rows floats
  float* red = smem + slice_rows;  // [256][VEC] when TY > 1
  __shared__ bool last;

  const int tx_n = 1 << tx_log2;
  const int ty_n = kThreads >> tx_log2;
  const int tx = threadIdx.x & (tx_n - 1);
  const int ty = threadIdx.x >> tx_log2;
  const int k0 = blockIdx.y * slice_rows;
  const int rows = min(slice_rows, d - k0);
  // Wide N: w's slice is staged once for the block's columns.  Narrow N (TY
  // > 1): each thread reads its rows' w beside D, so the two loads share
  // one trip to memory.
  const bool narrow = ty_n > 1;
  if (!narrow) {
    for (int k = threadIdx.x; k < rows; k += kThreads) ws[k] = to_f32(w[k0 + k]);
  }
  __syncthreads();
  auto w_at = [&](int k) { return narrow ? to_f32(w[k0 + k]) : ws[k]; };

  const int base = blockIdx.x * tx_n * VEC;
  const int col = base + tx * VEC;
  const bool ok = col < n;  // N is a multiple of VEC: a chunk is all in or out
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  const T* p = D + static_cast<size_t>(k0) * ld + col;
  int k = ty;
  if (ok) {
    for (; k + (kUnroll - 1) * ty_n < rows; k += kUnroll * ty_n) {
      Chunk<T, VEC> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        x[u] = *reinterpret_cast<const Chunk<T, VEC>*>(p + static_cast<size_t>(k + u * ty_n) * ld);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float wk = w_at(k + u * ty_n);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wk, to_f32(x[u].v[e]), acc[e]);
      }
    }
#pragma unroll 4
    for (; k < rows; k += ty_n) {
      const Chunk<T, VEC> x =
          *reinterpret_cast<const Chunk<T, VEC>*>(p + static_cast<size_t>(k) * ld);
      const float wk = w_at(k);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wk, to_f32(x.v[e]), acc[e]);
    }
  }

  // The rows' partial sums over TY, in a fixed tree.
  if (ty_n > 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[threadIdx.x * VEC + e] = acc[e];
    __syncthreads();
    for (int s = ty_n >> 1; s > 0; s >>= 1) {
      if (ty < s) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          red[threadIdx.x * VEC + e] =
              __fadd_rn(red[threadIdx.x * VEC + e], red[(threadIdx.x + s * tx_n) * VEC + e]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = red[threadIdx.x * VEC + e];
  }
  if (ty == 0 && ok) {
    float* prow = partial + static_cast<size_t>(blockIdx.y) * n + col;
#pragma unroll
    for (int e = 0; e < VEC; ++e) prow[e] = acc[e];
  }

  // The last block of this column block adds the slices in slice order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&tickets[blockIdx.x], 1) == static_cast<int>(gridDim.y) - 1;
  }
  __syncthreads();
  if (!last) return;
  const int slices = gridDim.y;
  const int cols = min(tx_n * VEC, n - base);
  if (cols <= kThreads / 8) {
    // Few columns: the block loads kThreads / cols slices' partials at a
    // time into shared memory, and one thread a column adds them in order.
    __shared__ float stage[kThreads];
    const int per = kThreads / cols;
    float s = 0.0f;
    for (int b0 = 0; b0 < slices; b0 += per) {
      const int m = min(per, slices - b0);
      if (static_cast<int>(threadIdx.x) < m * cols) {
        stage[threadIdx.x] = __ldcg(partial + static_cast<size_t>(b0 + threadIdx.x / cols) * n +
                                    base + threadIdx.x % cols);
      }
      __syncthreads();
      if (static_cast<int>(threadIdx.x) < cols) {
        for (int i = 0; i < m; ++i) s = __fadd_rn(s, stage[i * cols + threadIdx.x]);
      }
      __syncthreads();
    }
    if (static_cast<int>(threadIdx.x) < cols) out[base + threadIdx.x] = s;
  } else {
    for (int j = threadIdx.x; j < cols; j += kThreads) {
      float s = 0.0f;
#pragma unroll 8
      for (int i = 0; i < slices; ++i) {
        s = __fadd_rn(s, __ldcg(partial + static_cast<size_t>(i) * n + base + j));
      }
      out[base + j] = s;
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

template <class T, int VEC>
int launch(const void* w, const void* D, float* partial, float* out,
           int* tickets, int d, int n, long long ld, int slice_rows,
           int tx_log2, cudaStream_t stream) {
  const int tx_n = 1 << tx_log2;
  const long long col_blocks = (n + static_cast<long long>(tx_n) * VEC - 1) /
                               (static_cast<long long>(tx_n) * VEC);
  const int slices = (d + slice_rows - 1) / slice_rows;
  const size_t smem = sizeof(float) * (static_cast<size_t>(slice_rows) +
                                       (tx_n < kThreads ? kThreads * VEC : 0));
  if (col_blocks > 2147483647LL || slices > 65535 || smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fd_matvec_kernel<T, VEC>
      <<<dim3(static_cast<unsigned>(col_blocks), slices), kThreads, smem,
         stream>>>(static_cast<const T*>(w), static_cast<const T*>(D),
                   partial, out, tickets, d, n, ld, slice_rows, tx_log2);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int by_vec(int vec, const void* w, const void* D, float* partial, float* out,
           int* tickets, int d, int n, long long ld, int slice_rows,
           int tx_log2, cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1>(w, D, partial, out, tickets, d, n, ld, slice_rows, tx_log2, s);
    case 2: return launch<T, 2>(w, D, partial, out, tickets, d, n, ld, slice_rows, tx_log2, s);
    case 4: return launch<T, 4>(w, D, partial, out, tickets, d, n, ld, slice_rows, tx_log2, s);
    case 8:
      if constexpr (sizeof(T) == 2) {
        return launch<T, 8>(w, D, partial, out, tickets, d, n, ld, slice_rows, tx_log2, s);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_fd_matvec(const void* w, const void* D, float* partial,
                               float* out, int* tickets, int d, int n,
                               long long ld, int slice_rows, int tx_log2,
                               int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || d < 1 || n < 1 || ld < n ||
      slice_rows < 1 || tx_log2 < 0 || tx_log2 > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dtype == 0 ? by_vec<float>(vec, w, D, partial, out, tickets, d, n, ld,
                                    slice_rows, tx_log2, s)
                    : by_vec<__nv_bfloat16>(vec, w, D, partial, out, tickets, d, n, ld,
                                            slice_rows, tx_log2, s);
}
