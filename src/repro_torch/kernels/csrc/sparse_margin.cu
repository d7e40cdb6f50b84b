// sparse_margin: fused gather-margin over the q feature blocks' block-local
// padded CSR rows, one launch for all q blocks:
//
//     parts[l, r] = sum_k w[lo_l + idx_l[row(r), k]] * val_l[row(r), k]
//     s[r]        = parts[0, r] + ... + parts[q - 1, r]  in tree order
//
// for r < R, with row(r) = ids[r] (the step's sampled rows) or r (every
// row: the snapshot, R = N).  Replaces the Pallas TPU kernel
// repro/kernels/sparse_margin.py (sparse_margin, the pallas_call at :56),
// which FD-SVRG runs once per feature block for every instance in the
// snapshot (Alg 1 line 4) and for the u sampled rows of every inner step
// (line 9), and the tree-order sum of the q partials (dist/tree.py,
// tree_order_sum) and the torch gathers of the sampled rows around it.
// With q = 1 and no ids it is one block's margins.
//
// What bounds it on an H100: a snapshot moves bytes, the padded rows read
// once (8 B an entry: 19,954 x 701 entries = 112 MB for news20 at q = 8,
// 0.033 ms at 3.35 TB/s) plus the gathered w entries, which sit in the
// 50 MB L2 (the whole w is 5.4 MB); the FMAs are negligible.  An inner
// step (R = u = 1) is latency: two dependent global rounds (the row's ids,
// then w at them), a shuffle tree and the tree sum.  q launches a step in
// a row cost q of those; one launch costs one, and also leaves out the 2q
// torch gathers of the rows and the q - 1 adds of the tree sum.
//
// Design: a CTA of 8 warps takes max(1, P / q) rows and its warps go over
// the (row, block) pairs: P = 8 (one pair a warp) for a step's few rows,
// P = 32 for more than kManyRows rows (a snapshot: fewer, longer CTAs,
// 12 % faster at news20's N on an H100 than P = 8).  Lane j walks entries j, j+32,
// ... of the pair's row (coalesced), loading up to kAhead of them and then
// their w entries at once, each lane a sequential fmaf chain in entry
// order, and the 32 partial sums meet in a shuffle tree: each partial is
// bit for bit the same function of its row whatever q.  The partials go to shared memory;
// one thread a row adds them in tree_order_sum's order (stride 1, 2, 4,
// ...: acc[k] = acc[k] + acc[k + stride]) with __fadd_rn, so s is bit for
// bit q one-block launches followed by tree_order_sum.  On request the
// launch also writes the partials [q, R] and the step's gathered rows:
// block l's [R, nnz_l] ids and values at R * off_l of two flat buffers,
// exact copies, which the touched-pass kernels read in place of the torch
// gathers.  Padding entries (local id 0, value 0.0) add w[lo_l] * 0 = 0
// and are inert.
//
// Preconditions (checked by the Python wrappers, kernels/sparse_margin.py
// and the BlockRows built by kernels/_build.py): float32 w/val/s/parts,
// int32 idx with ids in [0, d_l), int64 row ids in [0, N), all contiguous,
// on the current device; rows points to a host BlockRows of q blocks.  The
// launch goes onto the caller's stream; the function returns
// cudaErrorInvalidValue unless 1 <= q <= kMaxBlocks, else
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "touched.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kAhead = 4;  // entries a lane loads at once (128 a warp)
constexpr int kManyRows = 4096;  // above it, 32 (row, block) pairs a CTA

__global__ void __launch_bounds__(kWarps * 32)
margins_kernel(const BlockRows rows, int q, const float* __restrict__ w,
               const long long* __restrict__ ids, int n_rows,
               float* __restrict__ s, float* __restrict__ parts,
               int* __restrict__ row_idx, float* __restrict__ row_val, int rows_per_cta) {
  __shared__ float part[kMaxBlocks];  // [rows_per_cta][q]: max(32, q) at most
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows_per_cta;
  for (int p = warp; p < rows_per_cta * q; p += kWarps) {
    const int rr = p / q, l = p - rr * q;
    const int r = r0 + rr;
    if (r >= n_rows) break;  // warp-uniform; later pairs lie further on
    const int nnz = rows.nnz[l];
    const long long src = ids != nullptr ? __ldg(ids + r) : r;
    const int* ri = rows.idx[l] + src * nnz;
    const float* rv = rows.val[l] + src * nnz;
    const float* wl = w + rows.lo[l];
    float acc = 0.0f;
    // Lane j's entries j, j + 32, ... in batches of kAhead: a batch's ids
    // and values load together, then its w entries, then the fmaf chain
    // runs over the batch in order (two dependent rounds a batch).
    for (int k0 = lane; k0 < nnz; k0 += 32 * kAhead) {
      int j[kAhead];
      float v[kAhead], x[kAhead];
#pragma unroll
      for (int t = 0; t < kAhead; ++t) {
        const int k = k0 + 32 * t;
        j[t] = k < nnz ? __ldg(ri + k) : 0;
        v[t] = k < nnz ? __ldg(rv + k) : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < kAhead; ++t) x[t] = k0 + 32 * t < nnz ? __ldg(wl + j[t]) : 0.0f;
      if (row_idx != nullptr) {
        const size_t out = static_cast<size_t>(n_rows) * rows.off[l] +
                           static_cast<size_t>(r) * nnz;
#pragma unroll
        for (int t = 0; t < kAhead; ++t) {
          const int k = k0 + 32 * t;
          if (k < nnz) {
            row_idx[out + k] = j[t];
            row_val[out + k] = v[t];
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kAhead; ++t) {
        if (k0 + 32 * t < nnz) acc = fmaf(x[t], v[t], acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) part[p] = acc;
  }
  __syncthreads();
  const int rr = threadIdx.x;
  const int r = r0 + rr;
  if (rr < rows_per_cta && r < n_rows) {
    float* a = part + rr * q;
    if (parts != nullptr) {
      for (int l = 0; l < q; ++l) parts[static_cast<size_t>(l) * n_rows + r] = a[l];
    }
    for (int stride = 1; stride < q; stride <<= 1) {
      for (int k = 0; k + stride < q; k += 2 * stride) a[k] = __fadd_rn(a[k], a[k + stride]);
    }
    s[r] = a[0];
  }
}

}  // namespace

// rows is a host BlockRows (void here: the type has internal linkage, and
// a C entry point that named it would not be exported).
extern "C" int repro_sparse_margin(const void* rows, int q, const float* w,
                                   const long long* ids, int n_rows, float* s,
                                   float* parts, int* row_idx, float* row_val,
                                   void* stream) {
  if (q < 1 || q > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    const int pairs = n_rows > kManyRows ? 4 * kWarps : kWarps;
    const int rows_per_cta = q < pairs ? pairs / q : 1;
    margins_kernel<<<(n_rows + rows_per_cta - 1) / rows_per_cta, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        *static_cast<const BlockRows*>(rows), q, w, ids, n_rows, s, parts, row_idx,
        row_val, rows_per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}
