// sparse_margin: fused gather-margin over block-local padded CSR rows.
//
//     out[i] = sum_k w[idx[i, k]] * val[i, k]        i < rows, k < nnz
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_margin.py
// (sparse_margin, the pallas_call at :56).  FD-SVRG runs it per feature
// block for every instance in the snapshot (rows = N, Alg 1 line 4) and
// for the u sampled rows of every inner step (rows = u, line 9).
//
// What bounds it on an H100: bytes.  The padded idx/val rows are read once
// (8 B per entry; 19,954 x 161 entries = 25.7 MB for block 0 of news20 at
// q = 8) plus the gathered w entries; the FMAs are negligible against the
// card's 67 TFLOP/s float32.  The w block (d/q floats, 0.68 MB for news20
// at q = 8) sits in the 50 MB L2, so the random gathers hit L2, not HBM.
// With rows = u = 1 (the inner step) one warp does the whole launch and
// the call is bound by launch latency, not by the card.
//
// Design: one warp per row.  Lane j walks entries j, j+32, ... of the row,
// so the 32 lanes read idx/val coalesced; each lane keeps a sequential
// fmaf chain, and the 32 partial sums are combined with a shuffle tree
// (fixed order: the result is deterministic from run to run).  Any row
// width works (no power-of-two requirement: news20 block budgets are
// 161, 75, 75, 93, 69, 109, 47, 72 at q = 8 and 455 at q = 1).  Padding
// entries (local id 0, value 0.0) add w[0] * 0 = 0 and are inert.
//
// Preconditions (checked by the Python wrapper, kernels/sparse_margin.py):
// float32 w/val/out, int32 idx in [0, d_block), all contiguous, on the
// current device.  The launch goes onto the caller's stream and the
// function returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void sparse_margin_kernel(const float* __restrict__ w,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ val,
                                     float* __restrict__ out,
                                     int rows, int nnz) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform: whole warps leave together
  const int* ri = idx + static_cast<size_t>(row) * nnz;
  const float* rv = val + static_cast<size_t>(row) * nnz;
  float acc = 0.0f;
  for (int k = lane; k < nnz; k += 32) {
    acc = fmaf(__ldg(w + __ldg(ri + k)), __ldg(rv + k), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[row] = acc;
}

}  // namespace

extern "C" int repro_sparse_margin(const float* w, const int* idx,
                                   const float* val, float* out, int rows,
                                   int nnz, void* stream) {
  if (rows > 0) {
    const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    sparse_margin_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        w, idx, val, out, rows, nnz);
  }
  return static_cast<int>(cudaGetLastError());
}
