// block_scatter: the snapshot's block-local scatter of the full gradient,
//
//     z[id] = sum over flat positions p with idx[p] = id, in increasing p,
//             of values[p] * coeffs[p / nnz_l]
//
// over one block's padded rows (values [N, nnz_l] float32, row-major, so
// p = row * nnz_l + slot), z float32 [dim_l].  This is the port's own
// kernel: the TPU package scatters with a plain `.at[].add`
// (repro/data/block_csr.py, local_scatter), which has no pallas_call.  It
// replaces `index_add_`, whose float atomics add a feature's terms in an
// order that changes from run to run.  Here every sum starts from +0.0f
// and takes its terms with __fmul_rn then __fadd_rn in flat order, with no
// atomics: exactly what the CPU's `index_add_` and the reference's
// `.at[].add` do, so the result equals theirs bit for bit.
//
// The flat order comes from an index built once per layout (BlockCSR.
// scatter_index, data/block_csr.py): perm (int32) lists the flat positions
// grouped by local id, increasing within each id (a stable sort), and id's
// terms are perm[starts[id] .. starts[id + 1]).  Entries whose stored value
// is 0.0 (the padding at local id 0) are left out of the index.  That keeps
// the bits: their product is +-0.0 (the coefficients are finite), a sum
// that starts at +0.0 never becomes -0.0 under round-to-nearest, and
// x + (+-0.0) == x for every other x.
//
// What bounds it on an H100: the longest dependent chain, not bytes.  The
// generator's duplicate ids put about 80 copies of one id (local 12,539 of
// news20 block 0 at q = 8) in every row: 1.66M terms that must be added one
// after another, ~4 cycles each, ~3.4 ms at 1.98 GHz.  The bytes (perm and
// values once, coeffs, starts, z) are ~21 MB, 0.006 ms at 3.35 TB/s.  So
// the design keeps that chain fed:
//   * heavy ids (more than `heavy_min` terms; the wrapper lists them,
//     longest first, so they start in the first wave) get one block each.
//     Warps 1..7 gather and multiply the next tile of kTile terms into one
//     half of a shared-memory double buffer (8 gathers a thread in flight)
//     while thread 0 folds the other half in order.  The chain then runs
//     from shared memory with its loads issued ahead of the adds.
//   * every other id gets one thread, which folds its terms from global
//     memory (at most heavy_min, loads unrolled ahead of the adds).
// One launch; blocks [0, n_heavy) are the heavy ones, the rest cover the
// ids in order.  int32 offsets: N * nnz_l < 2^31 (checked by the wrapper).
//
// Preconditions (checked by the wrapper): values float32 [N, nnz_l] and
// coeffs float32 [N] contiguous; perm, starts, heavy int32 from the index
// of these rows; z float32 [dim_l]; all on the current device.  Returns
// cudaErrorInvalidValue unless nnz_l >= 1, dim_l >= 1, n_heavy >= 0 and
// heavy_min >= 1; else cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // terms per half of the heavy blocks' buffer

__device__ __forceinline__ float term(const float* __restrict__ values,
                                      const float* __restrict__ coeffs,
                                      int p, int nnz_l) {
  return __fmul_rn(values[p], coeffs[p / nnz_l]);
}

__global__ void __launch_bounds__(kThreads)
block_scatter_kernel(const float* __restrict__ values,
                     const float* __restrict__ coeffs,
                     const int* __restrict__ perm,
                     const int* __restrict__ starts,
                     const int* __restrict__ heavy, float* __restrict__ z,
                     int nnz_l, int dim, int n_heavy, int heavy_min) {
  __shared__ __align__(16) float buf[2][kTile];
  if (static_cast<int>(blockIdx.x) < n_heavy) {
    const int id = heavy[blockIdx.x];
    const int beg = starts[id];
    const int end = starts[id + 1];
    // Tile 0 by every thread, then: warps 1.. stage tile t + 1 while
    // thread 0 folds tile t.
#pragma unroll 8
    for (int j = threadIdx.x; j < min(kTile, end - beg); j += kThreads) {
      buf[0][j] = term(values, coeffs, perm[beg + j], nnz_l);
    }
    __syncthreads();
    float acc = 0.0f;
    int half = 0;
    for (int t0 = beg; t0 < end; t0 += kTile) {
      const int t1 = t0 + kTile;
      if (threadIdx.x >= 32) {
        const int cnt = min(kTile, end - t1);
#pragma unroll 8
        for (int j = threadIdx.x - 32; j < cnt; j += kThreads - 32) {
          buf[half ^ 1][j] = term(values, coeffs, perm[t1 + j], nnz_l);
        }
      } else if (threadIdx.x == 0) {
        // Four terms a shared-memory load, in order.
        const int cnt = min(kTile, end - t0);
        const float4* b4 = reinterpret_cast<const float4*>(buf[half]);
#pragma unroll 8
        for (int j = 0; j < cnt / 4; ++j) {
          const float4 x = b4[j];
          acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, x.x), x.y), x.z), x.w);
        }
        for (int j = cnt & ~3; j < cnt; ++j) acc = __fadd_rn(acc, buf[half][j]);
      }
      __syncthreads();
      half ^= 1;
    }
    if (threadIdx.x == 0) z[id] = acc;
    return;
  }
  const int id = (blockIdx.x - n_heavy) * kThreads + threadIdx.x;
  if (id >= dim) return;
  const int beg = starts[id];
  const int end = starts[id + 1];
  if (end - beg > heavy_min) return;  // a heavy block writes it
  float acc = 0.0f;
#pragma unroll 8
  for (int j = beg; j < end; ++j) {
    acc = __fadd_rn(acc, term(values, coeffs, perm[j], nnz_l));
  }
  z[id] = acc;
}

}  // namespace

extern "C" int repro_block_scatter(const float* values, const float* coeffs,
                                   const int* perm, const int* starts,
                                   const int* heavy, float* z, int nnz_l,
                                   int dim, int n_heavy, int heavy_min,
                                   void* stream) {
  if (nnz_l < 1 || dim < 1 || n_heavy < 0 || heavy_min < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = n_heavy + (dim + kThreads - 1) / kThreads;
  block_scatter_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      values, coeffs, perm, starts, heavy, z, nnz_l, dim, n_heavy, heavy_min);
  return static_cast<int>(cudaGetLastError());
}
