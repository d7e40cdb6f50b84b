// logistic_grad: the fused logistic loss and margin derivative,
//
//     z = -y*s,  zpos = max(z, 0),  ez = exp(z - zpos),  e0 = exp(-zpos)
//     loss  = zpos + log(e0 + ez)           = log(1 + e^{-ys}), stably
//     dloss = -y * (ez / (e0 + ez))         = -y * sigmoid(-ys)
//
// Replaces the Pallas TPU kernel repro/kernels/logistic_grad.py
// (logistic_grad, the pallas_call at :46): the same expression, not the
// logaddexp of ref.logistic_grad_ref.  s and y are float32 or bfloat16
// (the template's T), converted to float32 first; both outputs are
// float32.  expf and logf are the full-precision functions (the build has
// no -use_fast_math, so no __expf / __logf); the other float ops are
// __f*_rn intrinsics, never contracted into an FMA.
//
// What bounds it on an H100: bytes.  Two reads of sizeof(T) and two
// float32 writes per element: 16 B in float32, 0.31 GB at N = 19,264,097
// (kdd2010), 0.092 ms at 3.35 TB/s.  Two exps and a log per element are
// about 40 operations, well under the bytes at 67 TFLOP/s.
//
// Design: one thread per element, coalesced; the tail is masked here, so
// the caller pads nothing (the reference pads y with 1.0 to a tile).
//
// Preconditions (checked by the Python wrapper): s and y of one dtype
// (dtype 0 = float32, 1 = bfloat16), float32 loss/dloss, all contiguous
// and of length n, on the current device.  Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
logistic_grad_kernel(const T* __restrict__ s, const T* __restrict__ y,
                     float* __restrict__ loss, float* __restrict__ dloss,
                     int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float yi = to_f32(y[i]);
  const float z = __fmul_rn(-yi, to_f32(s[i]));
  const float zpos = fmaxf(z, 0.0f);
  const float ez = expf(__fsub_rn(z, zpos));
  const float e0 = expf(-zpos);
  const float den = __fadd_rn(e0, ez);
  loss[i] = __fadd_rn(zpos, logf(den));
  dloss[i] = __fmul_rn(-yi, __fdiv_rn(ez, den));
}

template <class T>
void launch(const void* s, const void* y, float* loss, float* dloss, int n,
            cudaStream_t stream) {
  logistic_grad_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(static_cast<const T*>(s),
                                      static_cast<const T*>(y), loss, dloss,
                                      n);
}

}  // namespace

extern "C" int repro_logistic_grad(const void* s, const void* y, float* loss,
                                   float* dloss, int n, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    if (dtype == 0) {
      launch<float>(s, y, loss, dloss, n, st);
    } else {
      launch<__nv_bfloat16>(s, y, loss, dloss, n, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
