// lazy_update: the delayed-decay (lazy) FD-SVRG inner step, four kernels.
// The dense step moves every feature of the block; these move only the
// u * nnz_l features of the sampled rows and defer the rest:
//
//   lazy_catchup       — before step m reads its margins, each touched
//                        feature j replays its deferred steps last[j]..m-1
//                        (the dense step with g = 0.0): k_active =
//                        max(min(stop, m) - last[j], 0) active steps, then
//                        one masked (eta = 0) step if step m-1 was masked;
//                        then last[j] = m + 1.  One launch covers the
//                        step's rows in all q blocks (BlockRows of
//                        touched.cuh, with w, last and z whole); one
//                        block's rows are the q = 1 case.  Replaces
//                        repro/kernels/lazy_update.py:125 (lazy_catchup),
//                        which runs once per block.
//   lazy_touch_update  — the dense prox step at the touched features only
//                        (launch_entries of touched.cuh, writing w in
//                        place).  One launch covers the step's gathered
//                        rows in all q blocks (BlockRows, with w and z
//                        whole); one block's rows are the q = 1 case.
//                        Replaces lazy_update.py:177, which runs once per
//                        block.
//   lazy_flush         — at epoch end, every feature replays its remaining
//                        deferred steps up to total.  A feature's replay
//                        reads its own w, last and z only, so one launch
//                        over the q blocks' w, last and z whole (d
//                        features) is the q one-block flushes at once,
//                        bit for bit.  Replaces lazy_update.py:224, which
//                        runs once per block.
//   lazy_proba_update  — the probabilistic variant: touched features only,
//                        the decay (z + lam * w) and both prox strengths
//                        scaled by corr[j] = 1 / P(j touched per step);
//                        the touched pass's kernel on one block's rows.
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
// last[j]; here a thread that read w[j] after another's write would
// replay the gap twice.  So each id has one owner: a CTA of the catch-up
// takes kOwn = 256 flat positions of one block's sampled rows, enters
// their ids in a shared hash table (touched.cuh's home_slot,
// table_insert), marks foreign every key that an earlier position of the
// block holds (table_find), and owns the rest.  Blocks hold disjoint
// features, so only one block's ids meet.  (The touched pass owns its ids
// by a hash instead: touched.cuh.)
//
// What bounds them on an H100:
//   catch-up — the latency of the longest replay chain: a feature last
//     touched early in the epoch replays ~m dependent steps, each 4
//     dependent float ops at l2 (~16 cycles), ~4 us for m = 500 at 1.98
//     GHz.  The bytes and operations are negligible.  One thread replays
//     each owned id, and one grid of sum_l ceil(u * nnz_l / 256) CTAs (8
//     at u = 1 for news20 at q = 8) covers every block, so a step costs
//     its longest chain over all q blocks plus three dependent global
//     rounds (the row ids, the ids, then w, last and z) and one table
//     insert, where q launches in a row cost the sum of each block's.
//     Each thread loads its id's w, last and z before the table, so those
//     loads overlap the inserts and the ownership scan.  The scan grows
//     with the entries: at u = 64 block 0's last CTA reads ~10,000 earlier
//     positions, and that, not the chain, sets the step's time.
//   touch / proba — a CTA's read of its block and its fold, then the
//     longest chain of one id.  touched.cuh's entries_kernel gives block l
//     ceil(u * nnz_l / 1024) CTAs, each owning the ids whose hash falls in
//     its part (9 a block for news20 at u = 128, 16 for webspam at u = 64;
//     72 and 256 CTAs in the step's one launch), and each thread adds its
//     ids' kept contributions in flat order.  With a row holding each id
//     once an id's chain is at most u adds (128 * 4 cycles, ~0.26 us at
//     1.98 GHz), and the padding's +-0.0 terms are skipped (they leave a
//     sum from +0.0 as it is), so the padding id's chain holds its genuine
//     entries only.  What sets the time is each CTA's pass over all of
//     its block's u * nnz_l ids and values (2 spans of up to 8,192 on
//     either cell, each warp its share with one chunk loaded ahead) and a
//     fold a span (a counting sort by key, a few barriers): 24.6 us a step
//     on news20 and 29.9 us on webspam (NVIDIA H100 80GB HBM3).  Owned by
//     their first flat position instead, the popular ids all fell to a
//     block's first CTA (88-93 % of its entries on these rows).  The grid
//     is sized to the entries, not to d_block.
//   flush — operations: sum_j k_j replayed steps, one feature a thread,
//     a grid sized to d (1,355,191 features for news20, ~672M replayed
//     steps after a 500-step epoch: ~5 waves of 2,048 threads on 132 SMs,
//     where a block's launch was under one).  The replayed ops are rounded
//     __f*_rn and never fuse, so each costs one issue slot: at 132 SMs x
//     128 lanes x 1.98 GHz an l2 step's four ops bound the launch, not the
//     67 TFLOP/s that count an FMA as two.
//
// Preconditions (checked by the Python wrappers): float32 w/z/val/coef/
// corr, int32 last and idx with ids in [0, d_block), int64 row ids, all
// contiguous, on the current device.  Each entry point returns
// cudaGetLastError() (the catch-up, the touch and the proba update
// cudaErrorInvalidValue unless 1 <= q <= kMaxBlocks).

#include <cuda_runtime.h>

#include "touched.cuh"

namespace {

constexpr int kFlushThreads = 256;
constexpr int kRowCache = 256;  // catch-up: sampled row ids kept in shared memory
constexpr int kScanAhead = 8;   // catch-up: earlier positions loaded at once

// k_active active steps (eta), then at most one masked step (eta * 0.0).
// The loop is taken apart on the prox strengths once, outside it, and
// unrolled, so an l2 step is its four dependent float operations and no
// branch (the same operations in the same order either way).
__device__ __forceinline__ float lazy_replay(float w, float z, float eta,
                                             int k_active, bool has_masked,
                                             float lam, float lam1,
                                             float lam2) {
  if (lam1 != 0.0f || lam2 != 0.0f) {
#pragma unroll 4
    for (int i = 0; i < k_active; ++i) {
      w = prox_step(w, 0.0f, z, eta, lam, lam1, lam2);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < k_active; ++i) {
      w = prox_step(w, 0.0f, z, eta, lam, 0.0f, 0.0f);
    }
  }
  if (has_masked) {
    w = prox_step(w, 0.0f, z, __fmul_rn(eta, 0.0f), lam, lam1, lam2);
  }
  return w;
}

// One CTA per kOwn flat positions of one block's sampled rows (the blocks'
// CTAs in turn); it replays the ids it owns, one thread each.  Thread tid
// loads the id at its own position and that id's w, last and z at once,
// then enters the id in the table; the one whose insert claims the id's
// slot is its candidate.  A CTA whose positions come first in its block
// (own_lo = 0, every CTA at u = 1 for news20) owns all its keys and goes
// straight on to the replay; any other first marks foreign the keys an
// earlier position holds.  (A lane that does not own its id loaded its
// inputs for nothing: it writes nothing.)
__global__ void __launch_bounds__(kTouchedThreads)
lazy_catchup_kernel(const BlockRows rows, int q, const long long* __restrict__ ids,
                    int u, float* w, int* last, const float* __restrict__ z,
                    float eta, int m, int stop, float lam, float lam1, float lam2) {
  __shared__ int keys[kTable];
  __shared__ unsigned char foreign[kTable];
  __shared__ long long row_of[kRowCache];  // the sampled rows' ids, the first kRowCache
  const int tid = threadIdx.x;
  int l = 0, c = blockIdx.x;
  for (; l < q - 1; ++l) {
    const int ctas = (u * rows.nnz[l] + kOwn - 1) / kOwn;
    if (c < ctas) break;
    c -= ctas;
  }
  const int nnz = rows.nnz[l];
  const int entries = u * nnz;
  const int own_lo = c * kOwn;
  const int* __restrict__ idx = rows.idx[l];
  // The id at flat position p of the block's sampled rows; the row ids
  // from shared memory once it holds them.
  const auto id_at = [&](int p, bool cached) {
    const int r = p / nnz;
    const long long src = ids == nullptr ? r
                          : cached && r < kRowCache ? row_of[r] : __ldg(ids + r);
    return __ldg(idx + src * nnz + (p - r * nnz));
  };
  const int own = own_lo + tid < entries ? id_at(own_lo + tid, false) : kEmpty;
  const int j = rows.lo[l] + own;
  int ll = 0;
  float wj = 0.0f, zj = 0.0f;
  if (own != kEmpty) {
    ll = last[j];
    wj = w[j];
    zj = z[j];
  }
  for (int s = tid; s < kTable; s += kTouchedThreads) {
    keys[s] = kEmpty;
    foreign[s] = 0;
  }
  // The rows of the flat positions [0, own_lo), which the scan reads.
  const int scanned_rows = own_lo > 0 ? min(u, (own_lo - 1) / nnz + 1) : 0;
  if (ids != nullptr && tid < min(scanned_rows, kRowCache)) row_of[tid] = __ldg(ids + tid);
  __syncthreads();
  const int slot = own != kEmpty ? table_insert(keys, own) : -1;
  if (own_lo > 0) {  // CTA-uniform
    __syncthreads();  // every own id entered
    for (int p0 = tid; p0 < own_lo; p0 += kTouchedThreads * kScanAhead) {
      int id[kScanAhead];
#pragma unroll
      for (int t = 0; t < kScanAhead; ++t) {
        const int p = p0 + t * kTouchedThreads;
        id[t] = p < own_lo ? id_at(p, true) : kEmpty;
      }
#pragma unroll
      for (int t = 0; t < kScanAhead; ++t) {
        if (id[t] != kEmpty) {
          const int s = table_find(keys, id[t]);
          if (s >= 0) foreign[s] = 1;  // an earlier CTA owns it
        }
      }
    }
    __syncthreads();
  }
  // The table's probes leave a warp's lanes apart; without this the lanes
  // that replay would run the loop once per such group, one after another.
  __syncwarp();
  if (slot >= 0 && !foreign[slot]) {
    const int k_active = max(min(stop, m) - ll, 0);
    const bool has_masked = (m - ll) > k_active;
    w[j] = lazy_replay(wj, zj, eta, k_active, has_masked, lam, lam1, lam2);
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

// rows is a host BlockRows (void: see repro_sparse_margin).
extern "C" int repro_lazy_catchup(const void* block_rows, int q,
                                  const long long* ids, int u, float* w,
                                  int* last, const float* z, float eta, int m,
                                  int stop, float lam, float lam1, float lam2,
                                  void* stream) {
  if (q < 1 || q > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  const BlockRows* rows = static_cast<const BlockRows*>(block_rows);
  int ctas = 0;
  for (int l = 0; l < q; ++l) ctas += (u * rows->nnz[l] + kOwn - 1) / kOwn;
  if (ctas > 0) {
    lazy_catchup_kernel<<<ctas, kTouchedThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        *rows, q, ids, u, w, last, z, eta, m, stop, lam, lam1, lam2);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows is a host BlockRows; idx and val hold the step's gathered rows,
// block l's at u * off[l]; w and z are whole (the q blocks' concatenated).
extern "C" int repro_lazy_touch_update(const void* block_rows, int q,
                                       const int* idx, const float* val,
                                       const float* coef, float* w,
                                       const float* z, int u, float eta,
                                       float lam, float lam1, float lam2,
                                       void* stream) {
  return launch_entries(*static_cast<const BlockRows*>(block_rows), q, idx, val,
                        coef, u, ProxUpdate{w, z, w, eta, lam, lam1, lam2},
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

// The same launch as the touch update, the decay and prox strengths
// scaled by corr (whole, like w and z).
extern "C" int repro_lazy_proba_update(const void* block_rows, int q,
                                       const int* idx, const float* val,
                                       const float* coef, float* w,
                                       const float* z, const float* corr,
                                       int u, float eta, float lam,
                                       float lam1, float lam2, void* stream) {
  return launch_entries(*static_cast<const BlockRows*>(block_rows), q, idx, val,
                        coef, u, ProbaUpdate{w, z, corr, eta, lam, lam1, lam2},
                        static_cast<cudaStream_t>(stream));
}
