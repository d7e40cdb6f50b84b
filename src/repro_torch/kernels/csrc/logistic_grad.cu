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
//
// Beside it, the coefficients of the FD-SVRG main path, where the TPU
// kernel's "derivative w.r.t. the margin (for the update)" is used
// (repro_logistic_step_coef, repro_logistic_snapshot_coef): the logistic
// loss's derivative as the port's
// core/losses.py writes it, op for op as PyTorch's CUDA kernels compute
// it, so the kernel path keeps the bits of the chain it replaces:
//
//     dl(s, y) = (-y) * sigmoid((-y) * s),  sigmoid(x) = 1 / (1 + expf(-x))
//     step:     coef[i]   = (dl(s_m[i], y) - dl(s0[r], y)) / u,  r = ids[i],
//                           y = labels[r]
//     snapshot: coeffs[i] = dl(s0[i], labels[i]) / N
//
// (PyTorch's sigmoid is 1 / (1 + exp(-x)) in float32 with the full
// expf; its division by a 0-dim device tensor is a true division.)  Not
// the TPU kernel's ez / (e0 + ez) form: that rounds otherwise.  One
// launch replaces the 14 PyTorch kernels of the chain (two gathers, five
// ops for each derivative, a subtraction and a division).
//
// What bounds them on an H100: the step's, launch latency.  u = 1 to 64
// rows; a dependent round for the row ids, then one for the label and
// s0 at each (s_m and u loaded beside the id).  u <= 1,024 is one CTA.  The
// snapshot's, bytes: 12 B a row (s0, label, coefficient), 0.24 MB at
// news20's N = 19,954.

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

// d/ds log(1 + e^{-ys}) = (-y) * sigmoid((-y) * s), PyTorch's op order.
__device__ __forceinline__ float logistic_dvalue(float s, float y) {
  const float ny = -y;
  const float z = __fmul_rn(ny, s);
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
  return __fmul_rn(ny, sig);
}

// A step's coefficients, one thread a row: u = *u_t, the 0-dim tensor
// the plain chain divides by (loaded beside the row id).
__global__ void __launch_bounds__(1024)
step_coef_kernel(const float* __restrict__ s_m, const long long* __restrict__ ids,
                 const float* __restrict__ labels, const float* __restrict__ s0,
                 const float* __restrict__ u_t, float* __restrict__ coef, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float si = s_m[i];
  const float u = *u_t;
  const long long r = ids[i];
  const float y = labels[r];
  const float d = __fsub_rn(logistic_dvalue(si, y), logistic_dvalue(s0[r], y));
  coef[i] = __fdiv_rn(d, u);
}

// A snapshot's coefficients over its n rows, one thread a row.
__global__ void __launch_bounds__(1024)
snapshot_coef_kernel(const float* __restrict__ s0, const float* __restrict__ labels,
                     float* __restrict__ coef, int n, float divisor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  coef[i] = __fdiv_rn(logistic_dvalue(s0[i], labels[i]), divisor);
}

// n <= 1,024 rows: one CTA of n rounded up to a warp; else CTAs of kThreads.
int coef_threads(int n) { return n <= 1024 ? (n + 31) / 32 * 32 : kThreads; }

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

// The main path's coefficients.  The step's: s_m the step's n = u
// margins, ids its int64 rows, s0 the snapshot's N margins, u_t a device
// float32 scalar holding u.  The snapshot's: s0 and labels of its n rows,
// divisor N rounded to float32.
extern "C" int repro_logistic_step_coef(const float* s_m, const long long* ids,
                                        const float* labels, const float* s0,
                                        const float* u_t, float* coef, int n,
                                        void* stream) {
  if (n > 0) {
    const int threads = coef_threads(n);
    step_coef_kernel<<<(n + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(s_m, ids, labels, s0, u_t, coef, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_logistic_snapshot_coef(const float* s0, const float* labels,
                                            float* coef, int n, float divisor,
                                            void* stream) {
  if (n > 0) {
    const int threads = coef_threads(n);
    snapshot_coef_kernel<<<(n + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(s0, labels, coef, n, divisor);
  }
  return static_cast<int>(cudaGetLastError());
}
