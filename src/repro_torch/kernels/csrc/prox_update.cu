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
// Design: two launches on the caller's stream, no scratch vector.
//   1. prox_dense_kernel — one thread per feature computes the update with
//      g = 0.0 (every feature's value when no sampled row touches it).
//   2. prox_touched_kernel — one block, ids and contributions staged in
//      shared memory.  For each entry k of the u * nnz_l
//      flattened rows whose id j = idx[k] does not occur at an earlier
//      position, the owning warp sums ALL contributions val[p]*coef[p/nnz]
//      with idx[p] == j in increasing flat position p, starting from 0.0,
//      and rewrites out[j] with that g.  That is the reference's
//      jnp.zeros(d).at[idx.ravel()].add(contrib.ravel()) accumulation
//      order, and it is deterministic: no float atomics, so duplicate ids
//      across the u rows give the same bits on every run.  Padding entries
//      (local id 0, value 0.0) contribute 0 * coef and are inert.
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

namespace {

constexpr int kDenseThreads = 256;
constexpr int kTouchedThreads = 256;
// Entries (an int id and a float contribution each) staged in shared
// memory without opting in to more than 48 KB.
constexpr int kMaxStagedEntries = 48 * 1024 / 8;

__device__ __forceinline__ float prox_step(float w, float g, float z,
                                           float eta, float lam, float lam1,
                                           float lam2) {
  // v = w - eta * ((g + z) + lam * w), association as in the reference.
  float v = __fsub_rn(w, __fmul_rn(eta, __fadd_rn(__fadd_rn(g, z),
                                                  __fmul_rn(lam, w))));
  if (lam1 != 0.0f || lam2 != 0.0f) {
    // sign as torch.sign computes it: (0 < v) - (v < 0).
    const float s = static_cast<float>((0.0f < v) - (v < 0.0f));
    v = __fmul_rn(s, fmaxf(__fsub_rn(fabsf(v), __fmul_rn(eta, lam1)), 0.0f));
    if (lam2 != 0.0f) {
      v = __fdiv_rn(v, __fadd_rn(1.0f, __fmul_rn(eta, lam2)));
    }
  }
  return v;
}

__global__ void __launch_bounds__(kDenseThreads)
prox_dense_kernel(const float* __restrict__ w, const float* __restrict__ z,
                  float* __restrict__ out, int d, float eta, float lam,
                  float lam1, float lam2) {
  const int j = blockIdx.x * kDenseThreads + threadIdx.x;
  if (j < d) out[j] = prox_step(w[j], 0.0f, z[j], eta, lam, lam1, lam2);
}

// One warp per entry k (warps stride over the entries).  The warp's 32
// lanes test 32 earlier positions at a time for the same id (first
// occurrence?), then ballot the matching positions p >= k chunk by chunk
// and add their contributions in increasing p — every lane the same
// chain, so the order stays the flat order.  kStaged: ids and
// contributions val[p] * coef[p / nnz] are first copied into shared
// memory.  (The first version, one thread per entry walking global
// memory, took 44 us per launch at u * nnz_l = 161 on an H100: the owner
// of id 0 walked the row's ~100 trailing padding entries as a chain of
// dependent loads.)  Rows too wide to stage run unstaged, same arithmetic.
template <bool kStaged>
__global__ void __launch_bounds__(kTouchedThreads)
prox_touched_kernel(const float* __restrict__ w, const int* __restrict__ idx,
                    const float* __restrict__ val,
                    const float* __restrict__ coef,
                    const float* __restrict__ z, float* __restrict__ out,
                    int entries, int nnz, float eta, float lam, float lam1,
                    float lam2) {
  extern __shared__ int staged[];
  int* staged_ids = staged;
  float* staged_contrib = reinterpret_cast<float*>(staged + entries);
  if (kStaged) {
    for (int k = threadIdx.x; k < entries; k += kTouchedThreads) {
      staged_ids[k] = __ldg(idx + k);
      staged_contrib[k] = __fmul_rn(__ldg(val + k), __ldg(coef + k / nnz));
    }
    __syncthreads();
  }
  auto id_at = [&](int p) { return kStaged ? staged_ids[p] : __ldg(idx + p); };
  auto contrib_at = [&](int p) {
    return kStaged ? staged_contrib[p]
                   : __fmul_rn(__ldg(val + p), __ldg(coef + p / nnz));
  };
  const int lane = threadIdx.x & 31;
  constexpr int kWarps = kTouchedThreads / 32;
  for (int k = threadIdx.x >> 5; k < entries; k += kWarps) {
    const int j = id_at(k);
    bool seen = false;
    for (int base = 0; base < k && !seen; base += 32) {
      const int p = base + lane;
      seen = __any_sync(0xffffffffu, p < k && id_at(p) == j);
    }
    if (seen) continue;  // warp-uniform: an earlier entry owns id j
    float g = 0.0f;
    for (int base = k; base < entries; base += 32) {
      const int p = base + lane;
      unsigned hits = __ballot_sync(0xffffffffu, p < entries && id_at(p) == j);
      while (hits) {
        g = __fadd_rn(g, contrib_at(base + __ffs(hits) - 1));
        hits &= hits - 1;
      }
    }
    if (lane == 0) out[j] = prox_step(w[j], g, z[j], eta, lam, lam1, lam2);
  }
}

}  // namespace

extern "C" int repro_prox_update(const float* w, const int* idx,
                                 const float* val, const float* coef,
                                 const float* z, float* out, int d, int u,
                                 int nnz, float eta, float lam, float lam1,
                                 float lam2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 0) {
    prox_dense_kernel<<<(d + kDenseThreads - 1) / kDenseThreads,
                        kDenseThreads, 0, s>>>(w, z, out, d, eta, lam, lam1,
                                               lam2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int entries = u * nnz;
  if (entries > 0 && entries <= kMaxStagedEntries) {
    prox_touched_kernel<true><<<1, kTouchedThreads, entries * 8, s>>>(
        w, idx, val, coef, z, out, entries, nnz, eta, lam, lam1, lam2);
  } else if (entries > 0) {
    prox_touched_kernel<false><<<1, kTouchedThreads, 0, s>>>(
        w, idx, val, coef, z, out, entries, nnz, eta, lam, lam1, lam2);
  }
  return static_cast<int>(cudaGetLastError());
}
