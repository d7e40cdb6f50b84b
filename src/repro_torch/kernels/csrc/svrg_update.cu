// svrg_update: the fused dense SVRG parameter update (Alg 1 line 11, L2):
//
//     out[j] = c * w[j] - e * (g[j] + z[j]),   c = f32(1 - eta*lam), e = f32(eta)
//
// Replaces the Pallas TPU kernel repro/kernels/svrg_update.py
// (svrg_update, the pallas_call at :49).  The reference closes over eta
// and lam as Python floats, so 1 - eta*lam is reckoned in double and
// rounded to float32 once; the wrapper (kernels/svrg_update.py) does the
// same on the host and passes c and e by value, so one kernel serves every
// step size with no recompile.
//
// What bounds it on an H100: bytes.  Three float32 reads and one write per
// feature, 16 B: 2.7 MB at d = 169,399 (news20 block 0 at q = 8) and
// 478 MB at d = 29,890,095 (kdd2010), 0.143 ms at 3.35 TB/s.  Three
// multiplies and two adds per feature are negligible against 67 TFLOP/s.
//
// Design: one thread per feature, grid-stride free (d < 2^31 features),
// coalesced reads.  Every float operation is an __f*_rn intrinsic, which
// nvcc never contracts into an FMA, so each op rounds exactly like the
// separate float32 operations of the plain PyTorch version and the two
// agree bitwise.
//
// Preconditions (checked by the Python wrapper): float32 w/g/z/out, all
// contiguous and of length d, on the current device.  Returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
svrg_update_kernel(const float* __restrict__ w, const float* __restrict__ g,
                   const float* __restrict__ z, float* __restrict__ out, int d,
                   float c, float e) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < d) {
    out[j] = __fsub_rn(__fmul_rn(c, __ldg(w + j)),
                       __fmul_rn(e, __fadd_rn(__ldg(g + j), __ldg(z + j))));
  }
}

}  // namespace

extern "C" int repro_svrg_update(const float* w, const float* g,
                                 const float* z, float* out, int d, float c,
                                 float e, void* stream) {
  if (d > 0) {
    svrg_update_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(w, g, z, out, d,
                                                              c, e);
  }
  return static_cast<int>(cudaGetLastError());
}
