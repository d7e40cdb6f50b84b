// prox_update: fused scatter-grad + proximal variance-reduced update on one
// feature block (FD-Prox-SVRG inner step, Alg 1 line 11 + block-local prox):
//
//     g   = sum_i coef_i * x_i                    (scatter of u padded rows)
//     v   = w - eta * ((g + z) + lam * w)
//     out = sign(v) * max(|v| - eta*lam1, 0)      if lam1 != 0 or lam2 != 0
//     out = out / (1 + eta*lam2)                  if lam2 != 0
//
// Replaces the Pallas TPU kernel repro/kernels/prox_update.py (prox_update,
// the pallas_call at :84).  eta, lam, lam1 and lam2 are runtime float
// arguments, so one kernel serves l2, l1, elastic_net and none, and the
// Option II step mask (eta = 0) needs no recompile.
//
// What bounds it on an H100: bytes.  The dense pass reads w and z and
// writes out once (12 B per feature: 2.0 MB for d_block = 169,399, news20
// at q = 8); the scatter touches u * nnz_l <= 8 * 161 entries.  At the
// inner step's shapes that is well under a microsecond of HBM time, so in
// practice the two launches' latency bounds it.
//
// Design: two launches on the caller's stream, no scratch vector
// (launch_dense_then_touched of touched.cuh).
//   1. the dense pass — one thread per feature computes the update with
//      g = 0.0 (every feature's value when no sampled row touches it).
//   2. the touched pass of touched.cuh — one block, ids and contributions
//      staged in shared memory; for each id's first occurrence in the
//      u * nnz_l flattened rows, the owning warp sums that id's
//      contributions in increasing flat position from 0.0 (the reference's
//      .at[].add order, no float atomics: deterministic) and rewrites
//      out[j] with that g.  Padding entries (local id 0, value 0.0)
//      contribute 0 * coef and are inert.  (The first version, one thread
//      per entry walking global memory, took 44 us per launch at
//      u * nnz_l = 161 on an H100.)
// Every float operation uses the __f*_rn intrinsics, which nvcc never
// contracts into an FMA: each step rounds exactly like the separate
// float32 operations of the plain PyTorch version, so the kernel can equal
// it bitwise (on the card, at u = 1 where index_add_'s atomics add at most
// zeros to one address).
//
// Preconditions (checked by the Python wrapper, kernels/prox_update.py):
// float32 w/z/out/val/coef, int32 idx in [0, d), all contiguous, on the
// current device.  Returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include "touched.cuh"

extern "C" int repro_prox_update(const float* w, const int* idx,
                                 const float* val, const float* coef,
                                 const float* z, float* out, int d, int u,
                                 int nnz, float eta, float lam, float lam1,
                                 float lam2, void* stream) {
  return launch_dense_then_touched(
      idx, val, coef, d, u, nnz, ProxUpdate{w, z, out, eta, lam, lam1, lam2},
      static_cast<cudaStream_t>(stream));
}
