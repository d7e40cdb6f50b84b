// touched.cuh: the pieces the proximal inner-step kernels share.
//
//   prox_step       — the dense inner step at one feature, in the
//                     reference's association order, every float op an
//                     __f*_rn intrinsic (nvcc contracts none into an FMA);
//   seen_before     — warp-level: does feature id j occur at an earlier
//                     flat position of the sampled rows?
//   flat_order_sum  — warp-level: the sum of the contributions to id j in
//                     increasing flat position, starting from 0.0;
//   launch_touched  — one block over the u * nnz_l flattened entries: for
//                     each first occurrence of an id, the owning warp sums
//                     that id's contributions in flat order and its lane 0
//                     calls update(j, g);
//   launch_dense_then_touched — the dense step of a whole block: update(j,
//                     0.0) at every feature (one thread each), then the
//                     touched pass rewrites the sampled rows' features.
//
// Adding each feature's contributions in flat order from 0.0 is the
// order of the reference's jnp.zeros(d).at[idx.ravel()].add(contrib), and
// one owner per id means no float atomics: the result is deterministic,
// and an update may read and write w[j] in place.  Used by prox_update.cu
// and fused_update.cu (the dense step) and lazy_update.cu (the lazy touch
// and probabilistic updates, and the catch-up's ownership test).
//
// Everything here sits in an anonymous namespace: each translation unit
// that includes it gets its own copy of the templates and kernels.

#pragma once

#include <cuda_runtime.h>

namespace {

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

// The warp's 32 lanes test 32 earlier positions at a time.  Warp-uniform.
template <class IdAt>
__device__ __forceinline__ bool seen_before(IdAt id_at, int k, int j,
                                           int lane) {
  bool seen = false;
  for (int base = 0; base < k && !seen; base += 32) {
    const int p = base + lane;
    seen = __any_sync(0xffffffffu, p < k && id_at(p) == j);
  }
  return seen;
}

// Ballot the positions p >= k holding id j, chunk by chunk, and add their
// contributions in increasing p: every lane runs the same chain, so every
// lane ends with the same sum.
template <class IdAt, class ContribAt>
__device__ __forceinline__ float flat_order_sum(IdAt id_at,
                                                ContribAt contrib_at, int k,
                                                int entries, int j,
                                                int lane) {
  float g = 0.0f;
  for (int base = k; base < entries; base += 32) {
    const int p = base + lane;
    unsigned hits = __ballot_sync(0xffffffffu, p < entries && id_at(p) == j);
    while (hits) {
      g = __fadd_rn(g, contrib_at(base + __ffs(hits) - 1));
      hits &= hits - 1;
    }
  }
  return g;
}

// One warp per entry k (warps stride over the entries).  kStaged: ids and
// contributions val[p] * coef[p / nnz] are first copied into shared
// memory, so the owner of id 0 does not walk a row's trailing padding as
// a chain of dependent global loads.  Rows too wide to stage run
// unstaged, same arithmetic.
template <bool kStaged, class Update>
__global__ void __launch_bounds__(kTouchedThreads)
touched_kernel(const int* __restrict__ idx, const float* __restrict__ val,
               const float* __restrict__ coef, int entries, int nnz,
               Update update) {
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
    if (seen_before(id_at, k, j, lane)) continue;  // an earlier entry owns j
    const float g = flat_order_sum(id_at, contrib_at, k, entries, j, lane);
    if (lane == 0) update(j, g);
  }
}

// Launch the touched pass on stream s; returns cudaGetLastError().
template <class Update>
int launch_touched(const int* idx, const float* val, const float* coef,
                   int u, int nnz, Update update, cudaStream_t s) {
  const int entries = u * nnz;
  if (entries > 0 && entries <= kMaxStagedEntries) {
    touched_kernel<true, Update><<<1, kTouchedThreads, entries * 8, s>>>(
        idx, val, coef, entries, nnz, update);
  } else if (entries > 0) {
    touched_kernel<false, Update><<<1, kTouchedThreads, 0, s>>>(
        idx, val, coef, entries, nnz, update);
  }
  return static_cast<int>(cudaGetLastError());
}

// One thread per feature: update(j, 0.0f), the step of every feature that
// no sampled row touches.
template <class Update>
__global__ void __launch_bounds__(kTouchedThreads)
dense_kernel(int d, Update update) {
  const int j = blockIdx.x * kTouchedThreads + threadIdx.x;
  if (j < d) update(j, 0.0f);
}

// The dense step on stream s: two launches, the dense pass and then the
// touched pass, which overwrites the touched features.  update's output
// must not alias w: the dense pass writes every out[j] before the touched
// pass reads w[j].  Returns cudaGetLastError().
template <class Update>
int launch_dense_then_touched(const int* idx, const float* val,
                              const float* coef, int d, int u, int nnz,
                              Update update, cudaStream_t s) {
  if (d > 0) {
    dense_kernel<Update><<<(d + kTouchedThreads - 1) / kTouchedThreads,
                           kTouchedThreads, 0, s>>>(d, update);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_touched(idx, val, coef, u, nnz, update, s);
}

// update(j, g) of the dense prox step: out[j] = prox_step(w[j], g, z[j]).
// out may be w itself (each id has one owner, which reads w[j] first).
struct ProxUpdate {
  const float* w;
  const float* z;
  float* out;
  float eta, lam, lam1, lam2;
  __device__ __forceinline__ void operator()(int j, float g) const {
    out[j] = prox_step(w[j], g, z[j], eta, lam, lam1, lam2);
  }
};

}  // namespace
