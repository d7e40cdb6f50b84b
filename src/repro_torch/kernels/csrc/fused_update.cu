// fused_update: fused scatter-grad + variance-reduced update on one feature
// block, the L2 family (Alg 1 line 11):
//
//     g   = sum_i coef_i * x_i                    (scatter of u padded rows)
//     out = w - eta * ((g + z) + lam * w)
//
// Replaces the Pallas TPU kernel repro/kernels/fused_update.py
// (fused_update, the pallas_call at :73).  It is prox_update.cu with both
// prox strengths zero: the same dense step (prox_step of touched.cuh with
// lam1 = lam2 = 0, compile-time here, so the prox stages vanish) and the
// same deterministic touched pass, so it equals the prox_update kernel at
// lam1 = lam2 = 0 bit for bit.  eta (the Option II mask, eta = 0 on a
// masked step) and lam are runtime floats.
//
// What bounds it on an H100: bytes, as prox_update.  The dense step reads
// w and z and writes out once (12 B per feature: 2.0 MB for d_block =
// 169,399, news20 block 0 at q = 8, 0.0006 ms at 3.35 TB/s); the scatter
// touches u * nnz_l <= 8 * 161 entries.  In practice the latency of one
// launch and its few dependent rounds bounds it.
//
// Design: one launch on the caller's stream, no scratch vector
// (launch_range of touched.cuh, as prox_update.cu): block b owns
// 2,048 features, keeps the sampled entries in its range in flat order,
// sums each touched id's contributions in increasing flat position from
// 0.0 (the reference's .at[].add order, no float atomics), and each
// feature's thread writes out[j] once, with g = 0.0 or with that sum.
// Every float op is an __f*_rn intrinsic, never contracted into an FMA.
//
// Preconditions (checked by the Python wrapper, kernels/fused_update.py):
// float32 w/z/out/val/coef, int32 idx in [0, d), all contiguous, on the
// current device.  Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "touched.cuh"

namespace {

// update(j, g): the dense step with no prox stages.
struct FusedUpdate {
  const float* w;
  const float* z;
  float* out;
  float eta, lam;
  struct In {
    float w, z;
  };
  __device__ __forceinline__ In load(int j) const { return {w[j], z[j]}; }
  __device__ __forceinline__ void store(int j, In in, float g) const {
    out[j] = prox_step(in.w, g, in.z, eta, lam, 0.0f, 0.0f);
  }
};

}  // namespace

extern "C" int repro_fused_update(const float* w, const int* idx,
                                  const float* val, const float* coef,
                                  const float* z, float* out, int d, int u,
                                  int nnz, float eta, float lam,
                                  void* stream) {
  return launch_range(idx, val, coef, d, u, nnz,
                            FusedUpdate{w, z, out, eta, lam},
                            static_cast<cudaStream_t>(stream));
}
