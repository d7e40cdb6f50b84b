// lazy_update: the delayed-decay (lazy) FD-SVRG inner step on one feature
// block, four kernels.  The dense step moves every feature of the block;
// these move only the u * nnz_l features of the sampled rows and defer the
// rest:
//
//   lazy_catchup       — before step m reads its margins, each touched
//                        feature j replays its deferred steps last[j]..m-1
//                        (the dense step with g = 0.0): k_active =
//                        max(min(stop, m) - last[j], 0) active steps, then
//                        one masked (eta = 0) step if step m-1 was masked;
//                        then last[j] = m + 1.  Replaces
//                        repro/kernels/lazy_update.py:125 (lazy_catchup).
//   lazy_touch_update  — the dense prox step at the touched features only
//                        (launch_entries of touched.cuh, writing w in
//                        place).  Replaces lazy_update.py:177.
//   lazy_flush         — at epoch end, every feature replays its remaining
//                        deferred steps up to total.  Replaces
//                        lazy_update.py:224.
//   lazy_proba_update  — the probabilistic variant: touched features only,
//                        the decay (z + lam * w) and both prox strengths
//                        scaled by corr[j] = 1 / P(j touched per step).
//                        Replaces lazy_update.py:266.
//
// All four update w (and last) in place; the Python wrappers
// (kernels/lazy_update.py) say so.  eta, lam, lam1, lam2 are runtime
// floats; m, stop, total runtime ints.  Every float operation is an
// __f*_rn intrinsic and the replayed step is prox_step of touched.cuh,
// the same function the dense kernel (prox_update.cu) applies: a feature
// caught up k steps holds the bits the dense kernel would have given it
// after the same k steps, so the exact lazy epoch equals the dense epoch
// bit for bit on the card.
//
// Duplicate ids: the sampled rows repeat ids (padding at local id 0, and
// the generator's piled ids).  The reference's .at[flat].set is benign
// because every duplicate lane computes from the same OLD w[j] and
// last[j]; here a lane that read w[j] after another lane's write would
// replay the gap twice.  So only the first-occurrence owner of an id
// (seen_before of touched.cuh) replays and writes it.
//
// What bounds them on an H100:
//   catch-up — operations, and in practice the latency of the longest
//     replay chain: a feature last touched early in the epoch replays
//     ~m dependent steps.  One warp per entry, across blocks, so the
//     chains run concurrently; lane 0 of the owner replays.
//   touch / proba — launch latency: u * nnz_l entries, a few dependent
//     rounds (load, hash, compact, fold, store).  The grid is sized to
//     the entries, not to d_block: ceil(u * nnz_l / 256) blocks of
//     touched.cuh's entries_kernel (1 at u = 1, 6 at u = 8, 41 at u = 64
//     for news20 block 0 at q = 8), each owning the ids first met in its
//     256 flat positions and reading every entry once, so a step costs
//     the same at d_block = 169,399 as at kdd2010's 29.9M.
//   flush — operations: sum_j k_j replayed steps over the whole block,
//     one thread per feature (d_block = 169,399 for news20 block 0).
//
// Preconditions (checked by the Python wrappers): float32 w/z/val/coef/
// corr, int32 last and idx with ids in [0, d_block), all contiguous, on
// the current device.  Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "touched.cuh"

namespace {

constexpr int kCatchupWarps = 4;  // entries per block
constexpr int kFlushThreads = 256;

// k_active active steps (eta), then at most one masked step (eta * 0.0).
__device__ __forceinline__ float lazy_replay(float w, float z, float eta,
                                             int k_active, bool has_masked,
                                             float lam, float lam1,
                                             float lam2) {
  for (int i = 0; i < k_active; ++i) {
    w = prox_step(w, 0.0f, z, eta, lam, lam1, lam2);
  }
  if (has_masked) {
    w = prox_step(w, 0.0f, z, __fmul_rn(eta, 0.0f), lam, lam1, lam2);
  }
  return w;
}

__global__ void __launch_bounds__(kCatchupWarps * 32)
lazy_catchup_kernel(float* w, int* last, const float* __restrict__ z,
                    const int* __restrict__ idx, int entries, float eta,
                    int m, int stop, float lam, float lam1, float lam2) {
  const int k = blockIdx.x * kCatchupWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= entries) return;  // warp-uniform
  auto id_at = [&](int p) { return __ldg(idx + p); };
  const int j = id_at(k);
  if (seen_before(id_at, k, j, lane)) return;  // an earlier entry owns j
  if (lane == 0) {
    const int ll = last[j];
    const int k_active = max(min(stop, m) - ll, 0);
    const bool has_masked = (m - ll) > k_active;
    w[j] = lazy_replay(w[j], z[j], eta, k_active, has_masked, lam, lam1, lam2);
    last[j] = m + 1;
  }
}

__global__ void __launch_bounds__(kFlushThreads)
lazy_flush_kernel(float* w, const int* __restrict__ last,
                  const float* __restrict__ z, int d, float eta, int total,
                  int stop, float lam, float lam1, float lam2) {
  const int j = blockIdx.x * kFlushThreads + threadIdx.x;
  if (j >= d) return;
  const int ll = last[j];
  const int k_active = max(min(stop, total) - ll, 0);
  const bool has_masked = (total - ll) > k_active;
  w[j] = lazy_replay(w[j], z[j], eta, k_active, has_masked, lam, lam1, lam2);
}

// update(j, g) of the probabilistic step, in the reference's order:
//   v = w - eta * (g + c * (z + lam * w))
//   v = sign(v) * max(|v| - (eta * lam1) * c, 0) [/ (1 + (eta * lam2) * c)]
struct ProbaUpdate {
  float* w;
  const float* z;
  const float* corr;
  float eta, lam, lam1, lam2;
  struct In {
    float w, z, c;
  };
  __device__ __forceinline__ In load(int j) const { return {w[j], z[j], corr[j]}; }
  __device__ __forceinline__ void store(int j, In in, float g) const {
    const float wl = in.w;
    const float c = in.c;
    const float decay = __fmul_rn(c, __fadd_rn(in.z, __fmul_rn(lam, wl)));
    float v = __fsub_rn(wl, __fmul_rn(eta, __fadd_rn(g, decay)));
    if (lam1 != 0.0f || lam2 != 0.0f) {
      const float s = static_cast<float>((0.0f < v) - (v < 0.0f));
      v = __fmul_rn(s, fmaxf(__fsub_rn(fabsf(v),
                                       __fmul_rn(__fmul_rn(eta, lam1), c)),
                             0.0f));
      if (lam2 != 0.0f) {
        v = __fdiv_rn(v, __fadd_rn(1.0f, __fmul_rn(__fmul_rn(eta, lam2), c)));
      }
    }
    w[j] = v;
  }
};

}  // namespace

extern "C" int repro_lazy_catchup(float* w, int* last, const float* z,
                                  const int* idx, int u, int nnz, float eta,
                                  int m, int stop, float lam, float lam1,
                                  float lam2, void* stream) {
  const int entries = u * nnz;
  if (entries > 0) {
    lazy_catchup_kernel<<<(entries + kCatchupWarps - 1) / kCatchupWarps,
                          kCatchupWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        w, last, z, idx, entries, eta, m, stop, lam, lam1, lam2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_lazy_touch_update(float* w, const int* idx,
                                       const float* val, const float* coef,
                                       const float* z, int u, int nnz,
                                       float eta, float lam, float lam1,
                                       float lam2, void* stream) {
  return launch_entries(idx, val, coef, u, nnz,
                        ProxUpdate{w, z, w, eta, lam, lam1, lam2},
                        static_cast<cudaStream_t>(stream));
}

extern "C" int repro_lazy_flush(float* w, const int* last, const float* z,
                                int d, float eta, int total, int stop,
                                float lam, float lam1, float lam2,
                                void* stream) {
  if (d > 0) {
    lazy_flush_kernel<<<(d + kFlushThreads - 1) / kFlushThreads,
                        kFlushThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        w, last, z, d, eta, total, stop, lam, lam1, lam2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_lazy_proba_update(float* w, const int* idx,
                                       const float* val, const float* coef,
                                       const float* z, const float* corr,
                                       int u, int nnz, float eta, float lam,
                                       float lam1, float lam2, void* stream) {
  return launch_entries(idx, val, coef, u, nnz,
                        ProbaUpdate{w, z, corr, eta, lam, lam1, lam2},
                        static_cast<cudaStream_t>(stream));
}
