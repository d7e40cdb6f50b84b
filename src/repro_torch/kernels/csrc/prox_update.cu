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
// What bounds it on an H100: bytes.  The dense step reads w and z and
// writes out once (12 B per feature: 2.0 MB for d_block = 169,399, news20
// at q = 8); the scatter touches u * nnz_l <= 8 * 161 entries.  At the
// inner step's shapes that is well under a microsecond of HBM time, so in
// practice the latency of one launch and of its few dependent rounds
// (load the entries, compact, fold, store) bounds it.
//
// Design: one launch on the caller's stream, no scratch vector
// (launch_range of touched.cuh).  Block b owns the features [b * 2048,
// (b + 1) * 2048): each thread loads w and z of its 8 features, the block
// keeps the sampled entries whose id falls in its range (a stable
// compaction, so flat order survives), warp 0 sums each id's
// contributions in increasing flat position from 0.0 (the reference's
// .at[].add order, no float atomics: deterministic), and every feature's
// thread writes out[j] once, with g = 0.0 (no sampled row touches j) or
// with its flat-order sum.  Padding entries (local id 0, value 0.0)
// contribute 0 * coef and are inert.  out may alias w.  (Earlier designs:
// one thread per entry walking global memory, 44 us per launch at
// u * nnz_l = 161; then a dense launch plus a one-block touched pass with
// an O(entries^2) ownership scan, 11 us at u = 1 and 90 us at u = 8.)
// Every float operation uses the __f*_rn intrinsics, which nvcc never
// contracts into an FMA: each step rounds exactly like the separate
// float32 operations of the plain PyTorch version, so the kernel equals
// it bitwise on the CPU, whose index_add_ adds in flat order.
//
// Preconditions (checked by the Python wrapper, kernels/prox_update.py):
// float32 w/z/out/val/coef, int32 idx in [0, d), all contiguous, on the
// current device.  Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "touched.cuh"

extern "C" int repro_prox_update(const float* w, const int* idx,
                                 const float* val, const float* coef,
                                 const float* z, float* out, int d, int u,
                                 int nnz, float eta, float lam, float lam1,
                                 float lam2, void* stream) {
  return launch_range(idx, val, coef, d, u, nnz,
                            ProxUpdate{w, z, out, eta, lam, lam1, lam2},
                            static_cast<cudaStream_t>(stream));
}
