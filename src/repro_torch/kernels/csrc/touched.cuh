// touched.cuh: the pieces the proximal inner-step kernels share.
//
//   prox_step       — the dense inner step at one feature, in the
//                     reference's association order, every float op an
//                     __f*_rn intrinsic (nvcc contracts none into an FMA);
//   seen_before     — warp-level: does feature id j occur at an earlier
//                     flat position of the sampled rows?  (lazy_catchup's
//                     ownership test);
//   launch_range    — the dense step of a whole block in one launch
//                     (range_kernel, parallel over feature ranges): block
//                     b owns the features [b * kRange, (b + 1) * kRange)
//                     and writes each once, update(j, g) with g = 0.0
//                     where no sampled row touches j (prox_update.cu,
//                     fused_update.cu);
//   launch_entries  — the step at the touched features only
//                     (entries_kernel, parallel over the entries): block b
//                     owns the ids whose first occurrence lies in the flat
//                     positions [b * kOwn, (b + 1) * kOwn), a grid of
//                     ceil(u * nnz / kOwn) blocks whatever d is
//                     (lazy_update.cu's touch and probabilistic updates).
//
// The contract: each touched id has one owner, which adds that id's
// contributions val[p] * coef[p / nnz] in increasing flat position p of
// the u * nnz flattened rows, from 0.0, with __fadd_rn: the order of the
// reference's jnp.zeros(d).at[idx.ravel()].add(contrib) and of the CPU's
// index_add_.  No float atomics, so the result is deterministic, and an
// update may read and write w[j] in place.
//
// How a block finds its ids' terms without the one-block O(entries^2)
// ownership scan these replace: it reads the entries (u * nnz int32 ids
// and float32 values, L2-resident: 1.3 KB at u = 1, 10 KB at u = 8 for
// news20 block 0 at q = 8) in windows of kWindow flat positions.  It keeps
// those whose id it owns with a stable compaction (a ballot per warp and
// slot, then an exclusive prefix over the (slot, warp) counts in flat
// order), staging (slot, contribution) in shared memory.  Warp 0 then
// folds the short list 32 entries at a time: __match_any_sync groups the
// lanes that hold one slot (all warps mark the chunks' groups first, in
// parallel), and the group's first lane adds the group's contributions in
// lane order (= flat order) to the slot's running sum acc[slot] in shared
// memory; chunks follow one another in flat order, so each id's sum is one
// chain in flat order, across windows too.  The generator's heavy id
// (local 12,539 of news20 block 0, ~80 copies a row) has one owner: a
// chain of ~80 * u adds there.  Any number of entries runs, window by
// window.
//   * range_kernel: an id's slot is its offset in the block's range.  The
//     grid covers d, since the dense step writes every feature anyway.
//   * entries_kernel: the slots are a shared hash table (open addressing,
//     kTable = 2 * kOwn slots, keys claimed with an integer atomicCAS).
//     The block first enters the ids of its own kOwn = 256 positions (one
//     slot of the window that holds them, loaded first), at most kOwn
//     distinct keys, so the table is never full and a probe always ends;
//     then it loads the update's inputs of its keys, which overlap the
//     rest.  It reads every entry once: a table id met before its own
//     positions marks the slot foreign (an earlier block owns it); from
//     its own positions on it keeps the entries whose id is in the table
//     and not foreign.  Last it updates each slot that holds a key and is
//     not foreign.  Each block's work is O(entries), with no term in d:
//     the lazy step stays O(u * nnz) however wide the block.  kOwn = 256
//     keeps the owner of the heavy id (block 0) from owning much else.
//
// Everything here sits in an anonymous namespace: each translation unit
// that includes it gets its own copy of the templates and kernels.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTouchedThreads = 256;
constexpr int kTouchedWarps = kTouchedThreads / 32;
constexpr int kFeaturesPerThread = 8;
constexpr int kRange = kTouchedThreads * kFeaturesPerThread;  // a range block's features
constexpr int kSlots = 8;  // flat positions a thread stages per window
constexpr int kWindow = kTouchedThreads * kSlots;
constexpr int kOwn = kTouchedThreads;  // flat positions whose ids an entries block owns
constexpr int kTableBits = 9;
constexpr int kTable = 1 << kTableBits;  // its hash slots, at most half full
constexpr int kEmpty = -1;               // a free slot's key (ids are >= 0)
static_assert(kSlots * kTouchedWarps == 64, "the prefix gives each lane two counts");
static_assert(kTable == 2 * kOwn, "the table stays at most half full");

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

// A window's kept entries in flat order: their slots and contributions,
// each 32-entry chunk's group masks, the (slot, warp) counts' prefix.
struct __align__(16) Staging {
  float c[kWindow];
  int slot[kWindow];
  unsigned lead[kWindow];
  int offsets[kSlots * kTouchedWarps + 1];
};

// All warps, one 32-entry chunk of the window's list each in turn: mark
// each chunk's groups.  lead[e] = the mask of the chunk's lanes holding
// e's slot if e is the first of them, else 0.  Lanes past the end hold
// distinct negative slots.
__device__ __forceinline__ void mark_groups(Staging& st, int total, int tid) {
  const int lane = tid & 31;
  for (int b = tid & ~31; b < total; b += kTouchedThreads) {
    const int e = b + lane;
    const int r = e < total ? st.slot[e] : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    if (e < total) st.lead[e] = __ffs(peers) - 1 == lane ? peers : 0u;
  }
}

// Warp 0: fold the window's list into acc, one chunk after another.  A
// group's first lane adds the group's contributions in lane order to
// acc[slot].  Where the chunk has no repeated slot each leader adds its
// own term; else the chunk's 32 contributions come in as eight float4
// broadcast loads and each leader runs one chain of 32 adds, +0.0 in
// place of another group's term.  That keeps the bits: a sum that starts
// at +0.0 is never -0.0 under round-to-nearest, and x + (+0.0) == x for
// every other x; and the chain has no branch in it.  (Eight warps, each
// folding the slots r with r % 8 == its index, with the next window's
// loads issued before this one's fold, measured 2-20 % slower on an
// H100, and range_kernel spilled.)
__device__ __forceinline__ void fold_list(const Staging& st, int total,
                                          float* acc, int lane) {
  for (int b = 0; b < total; b += 32) {
    const int e = b + lane;
    const unsigned m = e < total ? st.lead[e] : 0u;
    const bool single = __all_sync(0xffffffffu, m == 0u || m == 1u << lane);
    if (m != 0u) {
      const int r = st.slot[e];
      float a = acc[r];
      if (single) {
        a = __fadd_rn(a, st.c[e]);
      } else {
        const float4* c4 = reinterpret_cast<const float4*>(st.c + b);
        float v[32];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 x = c4[i];
          v[4 * i] = x.x;
          v[4 * i + 1] = x.y;
          v[4 * i + 2] = x.z;
          v[4 * i + 3] = x.w;
        }
#pragma unroll
        for (int k = 0; k < 32; ++k) a = __fadd_rn(a, (m >> k) & 1u ? v[k] : 0.0f);
      }
      acc[r] = a;
    }
    __syncwarp();
  }
}

// A thread's kSlots flat positions of one window: base + k * 256 + tid.
struct Window {
  int base;
  int id[kSlots];  // kEmpty past the entries
  float x[kSlots], y[kSlots];  // val[p], coef[p / nnz]
};

// Load a window's ids, values and coefficients: all loads in flight at
// once, nothing waits on them here.
__device__ __forceinline__ void load_window(const int* __restrict__ idx,
                                            const float* __restrict__ val,
                                            const float* __restrict__ coef,
                                            int entries, int nnz, int base,
                                            Window& win, int tid) {
  win.base = base;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int p = base + k * kTouchedThreads + tid;
    win.id[k] = kEmpty;
    win.x[k] = win.y[k] = 0.0f;
    if (p < entries) {
      win.id[k] = __ldg(idx + p);
      win.x[k] = __ldg(val + p);
      win.y[k] = __ldg(coef + p / nnz);
    }
  }
}

// All threads: keep the loaded window's positions p with slot_of(p, id)
// >= 0 in flat order, then warp 0 adds their contributions to acc[slot].
// acc is written by warp 0 only, after the window's barriers; the next
// window's barriers order it before any later read.
template <class SlotOf>
__device__ __forceinline__ void fold_window(const Window& win, SlotOf slot_of,
                                            Staging& st, float* acc, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  int rel[kSlots];
  float c[kSlots];
  unsigned kept[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int p = win.base + k * kTouchedThreads + tid;
    rel[k] = win.id[k] == kEmpty ? -1 : slot_of(p, win.id[k]);
    c[k] = rel[k] >= 0 ? __fmul_rn(win.x[k], win.y[k]) : 0.0f;
    kept[k] = __ballot_sync(0xffffffffu, rel[k] >= 0);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) st.offsets[k * kTouchedWarps + warp] = __popc(kept[k]);
  }
  __syncthreads();
  if (warp == 0) {
    // Exclusive prefix of the 64 counts in (slot, warp) order, which is
    // flat order: two a lane, then a scan across the lanes.
    const int a = st.offsets[2 * lane], b = st.offsets[2 * lane + 1];
    int incl = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    st.offsets[2 * lane] = incl - a - b;
    st.offsets[2 * lane + 1] = incl - b;
    if (lane == 31) st.offsets[kSlots * kTouchedWarps] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (rel[k] >= 0) {
      const int o = st.offsets[k * kTouchedWarps + warp] + __popc(kept[k] & below);
      st.slot[o] = rel[k];
      st.c[o] = c[k];
    }
  }
  __syncthreads();
  const int total = st.offsets[kSlots * kTouchedWarps];
  mark_groups(st, total, tid);
  __syncthreads();
  if (warp == 0) fold_list(st, total, acc, lane);
}

// One block per kRange features; every feature of the range is updated,
// its inputs loaded before the windows so their latency overlaps the
// staging.  Update provides In load(j) and store(j, In, g).
template <class Update>
__global__ void __launch_bounds__(kTouchedThreads)
range_kernel(const int* __restrict__ idx, const float* __restrict__ val,
             const float* __restrict__ coef, int entries, int nnz, int d,
             Update update) {
  __shared__ Staging st;
  __shared__ float acc[kRange];
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * kRange;
  const int width = min(kRange, d - lo);
  typename Update::In in[kFeaturesPerThread];
#pragma unroll
  for (int k = 0; k < kFeaturesPerThread; ++k) {
    const int r = k * kTouchedThreads + tid;
    if (r < width) in[k] = update.load(lo + r);
  }
  for (int r = tid; r < kRange; r += kTouchedThreads) acc[r] = 0.0f;
  const auto slot_of = [lo, width](int, int j) {
    const int r = j - lo;
    return r >= 0 && r < width ? r : -1;
  };
  for (int base = 0; base < entries; base += kWindow) {
    Window win;
    load_window(idx, val, coef, entries, nnz, base, win, tid);
    fold_window(win, slot_of, st, acc, tid);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kFeaturesPerThread; ++k) {
    const int r = k * kTouchedThreads + tid;
    if (r < width) update.store(lo + r, in[k], acc[r]);
  }
}

// The table's home slot of an id: Fibonacci hashing, the top kTableBits
// bits of id * 2^32 / phi.
__device__ __forceinline__ int home_slot(int id) {
  return static_cast<int>((static_cast<unsigned>(id) * 0x9E3779B1u) >>
                          (32 - kTableBits));
}

// Enter id (linear probing); a slot's key, once claimed, never changes.
__device__ __forceinline__ void table_insert(int* keys, int id) {
  for (int s = home_slot(id);; s = (s + 1) & (kTable - 1)) {
    const int prev = atomicCAS(keys + s, kEmpty, id);
    if (prev == kEmpty || prev == id) return;
  }
}

// id's slot, or -1 if the table does not hold it.
__device__ __forceinline__ int table_find(const int* keys, int id) {
  for (int s = home_slot(id);; s = (s + 1) & (kTable - 1)) {
    const int k = keys[s];
    if (k == id) return s;
    if (k == kEmpty) return -1;
  }
}

// One block per kOwn flat positions; only the ids it owns are updated.
// kOwn is one slot of a window: the block's own positions are slot
// own_k of the window that holds them, whose loads start first.
template <class Update>
__global__ void __launch_bounds__(kTouchedThreads)
entries_kernel(const int* __restrict__ idx, const float* __restrict__ val,
               const float* __restrict__ coef, int entries, int nnz,
               Update update) {
  __shared__ Staging st;
  __shared__ int keys[kTable];
  __shared__ float acc[kTable];
  __shared__ unsigned char foreign[kTable];
  const int tid = threadIdx.x;
  const int own_lo = blockIdx.x * kOwn;
  const int first = own_lo / kWindow * kWindow;  // the window holding own_lo
  const int own_k = (own_lo - first) / kTouchedThreads;
  Window win;
  load_window(idx, val, coef, entries, nnz, first, win, tid);
  for (int s = tid; s < kTable; s += kTouchedThreads) {
    keys[s] = kEmpty;
    acc[s] = 0.0f;
    foreign[s] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (k == own_k && win.id[k] != kEmpty) table_insert(keys, win.id[k]);
  }
  __syncthreads();
  // The keys are final: load each one's update inputs now, so their
  // latency overlaps the windows.  (A foreign key's inputs are loaded and
  // never used.)
  int key[kTable / kTouchedThreads];
  typename Update::In in[kTable / kTouchedThreads];
#pragma unroll
  for (int k = 0; k < kTable / kTouchedThreads; ++k) {
    key[k] = keys[k * kTouchedThreads + tid];
    if (key[k] != kEmpty) in[k] = update.load(key[k]);
  }
  // The positions before the first window only mark.
#pragma unroll 8
  for (int p = tid; p < first; p += kTouchedThreads) {
    const int s = table_find(keys, __ldg(idx + p));
    if (s >= 0) foreign[s] = 1;
  }
  __syncthreads();
  // From the first window on: a position before own_lo marks (a window's
  // kept entry of a slot marked in that same window is folded but never
  // stored); from own_lo on, an entry of a table id not foreign is kept.
  const auto slot_of = [&](int p, int j) {
    const int s = table_find(keys, j);
    if (s < 0) return -1;
    if (p < own_lo) {
      foreign[s] = 1;
      return -1;
    }
    return foreign[s] ? -1 : s;
  };
  fold_window(win, slot_of, st, acc, tid);
  for (int base = first + kWindow; base < entries; base += kWindow) {
    load_window(idx, val, coef, entries, nnz, base, win, tid);
    fold_window(win, slot_of, st, acc, tid);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTable / kTouchedThreads; ++k) {
    const int s = k * kTouchedThreads + tid;
    if (key[k] != kEmpty && !foreign[s]) update.store(key[k], in[k], acc[s]);
  }
}

// The dense step of a whole block on stream s (every out[j] written
// once).  Returns cudaGetLastError().
template <class Update>
int launch_range(const int* idx, const float* val, const float* coef, int d,
                 int u, int nnz, Update update, cudaStream_t s) {
  if (d > 0) {
    range_kernel<Update><<<(d + kRange - 1) / kRange, kTouchedThreads, 0, s>>>(
        idx, val, coef, u * nnz, nnz, d, update);
  }
  return static_cast<int>(cudaGetLastError());
}

// The step at the touched features only, on stream s.  Returns
// cudaGetLastError().
template <class Update>
int launch_entries(const int* idx, const float* val, const float* coef,
                   int u, int nnz, Update update, cudaStream_t s) {
  const int entries = u * nnz;
  if (entries > 0) {
    entries_kernel<Update><<<(entries + kOwn - 1) / kOwn, kTouchedThreads, 0,
                             s>>>(idx, val, coef, entries, nnz, update);
  }
  return static_cast<int>(cudaGetLastError());
}

// update(j, g) of the dense prox step: out[j] = prox_step(w[j], g, z[j]).
// out may be w itself (each feature has one owner, which reads w[j]
// before it writes out[j]).
struct ProxUpdate {
  const float* w;
  const float* z;
  float* out;
  float eta, lam, lam1, lam2;
  struct In {
    float w, z;
  };
  __device__ __forceinline__ In load(int j) const { return {w[j], z[j]}; }
  __device__ __forceinline__ void store(int j, In in, float g) const {
    out[j] = prox_step(in.w, g, in.z, eta, lam, lam1, lam2);
  }
};

}  // namespace
