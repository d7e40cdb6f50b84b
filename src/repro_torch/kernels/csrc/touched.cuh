// touched.cuh: the pieces the inner-step kernels share.
//
//   BlockRows       — the q feature blocks' padded rows, passed by value:
//                     each block's int32 ids and float32 values pointers,
//                     its width nnz_l, its first global feature lo_l and
//                     the offset of its part in a step's gathered rows
//                     (sparse_margin.cu's margins, lazy_update.cu's
//                     step catch-up and touched pass);
//   prox_step       — the dense inner step at one feature, in the
//                     reference's association order, every float op an
//                     __f*_rn intrinsic (nvcc contracts none into an FMA);
//   launch_range    — the dense step of a whole block in one launch
//                     (range_kernel, parallel over feature ranges): block
//                     b owns the features [b * kRange, (b + 1) * kRange)
//                     and writes each once, update(j, g) with g = 0.0
//                     where no sampled row touches j (prox_update.cu,
//                     fused_update.cu);
//   home_slot, table_insert, table_find — a shared hash table of ids,
//                     which lazy_update.cu's step catch-up uses to own
//                     the ids first met in its kOwn flat positions;
//   launch_entries  — the step at the touched features only, over the q
//                     blocks' gathered rows in one launch (entries_kernel,
//                     parallel over ids): lazy_update.cu's touch and
//                     probabilistic updates.
//
// The contract: each touched id has one owner, which adds that id's
// contributions val[p] * coef[p / nnz] in increasing flat position p of
// the u * nnz flattened rows, from +0.0, with __fadd_rn: the order of the
// reference's jnp.zeros(d).at[idx.ravel()].add(contrib) and of the CPU's
// index_add_.  No float atomics, so the result is deterministic, and an
// update may read and write w[j] in place.
//
// range_kernel (fold_window, fold_list, Staging, load_window): a block
// reads the entries in windows of kWindow flat positions and keeps those
// whose id lies in its range with a stable compaction (a ballot per warp
// and slot, then an exclusive prefix over the (slot, warp) counts in flat
// order), staging (slot, contribution) in shared memory.  Warp 0 then
// folds the short list 32 entries at a time: __match_any_sync groups the
// lanes that hold one slot, and the group's first lane adds the group's
// contributions in lane order (= flat order) to acc[slot]; chunks follow
// one another in flat order, so each id's sum is one chain in flat order,
// across windows too.  An id's slot is its offset in the range; the grid
// covers d, since the dense step writes every feature anyway.
//
// entries_kernel: an id's owner is chosen by a hash of the id, not by
// where the id first occurs.  Block l gets P_l = ceil(u * nnz_l / 1024)
// id parts, one CTA each, all q blocks in one grid; an id's part is the
// high word of spread(id) * P_l, spread a bijection of the 32-bit ids.  A
// Zipf-drawn step puts its popular ids in every row; owned by where they
// first occur they all fell to a block's first CTA, whose single warp
// folded ~90 % of the block's entries as one chain of chunks.  Hashed,
// each CTA owns about 1 / P_l of the block's distinct ids wherever they
// occur, so no CTA marks foreign ids and none carries the popular ones
// alone.  Each CTA reads all of its block's ids and values (L2-resident:
// 73 KB for a news20 block at u = 128), in spans of kSpan = 8,192
// positions.  A span is cut into 8 contiguous shares, one a warp, so
// that the warps' shares follow one another in flat order and each warp
// scans its own with no barrier, a 256-position chunk loaded ahead: it
// lists the chunk's positions whose id lies in its part (a hash and a
// ballot a position), then takes the listed entries one a lane: it
// enters the id in a shared table (a dense key index each, two keys a
// thread) and appends (slot, c = val * coef) to its warp's region in
// flat order.  After a barrier, fold_span sorts the span's regions by key
// (a stable counting sort) and thread t adds the runs of its two keys,
// each in flat order, from +0.0.  So an id's sum is one thread's chain,
// as long as the id's kept entries: at most u for an id that a row holds
// once (the benchmark's rows, where a popular id is in every row), and
// never longer than the id's occurrences.
//   * A kept entry has c != +-0.0.  The padding (id 0, value 0.0) gives
//     +-0.0, and skipping it keeps the bits: the sum starts at +0.0; under
//     round-to-nearest x + (+-0.0) == x for x != 0 and +0.0 + -0.0 ==
//     +0.0, so a chain from +0.0 is never -0.0 and an added +-0.0 never
//     changes it.  c, not val, is tested, so a NaN or Inf coefficient
//     still reaches the sum; an id that only padding touched is still
//     updated, with g = +0.0, as the dense step updates it.
//   * A round holds at most kKeyCap = 512 keys.  A part with more ids
//     (rows of mostly distinct ids, ~1,024 a part) overflows; the CTA then
//     runs the part again on its two halves by the next bit of the low
//     spread word, as often as needed (one id a round at worst), reading
//     the block's entries once a round.  Nothing is stored before a round
//     ends, and rounds own disjoint ids.
//   * Work: each CTA reads u * nnz_l ids and values, so a block's reads
//     grow as (u * nnz_l)^2 / 1024; they stay in L2.  The kernel's 110 KB
//     of shared memory leave room for two CTAs an SM, 264 on the card
//     (webspam's step launches 256).
//   * The pass is bound by the instructions its warps issue, ~9 of 10 of
//     the positions a CTA reads lying outside its part: so a position
//     costs a hash and a ballot, and the divisions, loads and table
//     probes run densely on the listed entries only (entering each of a
//     lane's 8 positions in turn cost ~1,200 instructions a warp for 256
//     positions).
//
// range_kernel keeps fold_window, fold_list, Staging and load_window, and
// the catch-up keeps home_slot, table_insert, table_find, kOwn and kTable;
// the touched pass shares prox_step and BlockRows with them, nothing else.
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
constexpr int kOwn = kTouchedThreads;  // flat positions whose ids a catch-up CTA owns
constexpr int kTableBits = 9;
constexpr int kTable = 1 << kTableBits;  // its hash slots, at most half full
constexpr int kEmpty = -1;               // a free slot's key (ids are >= 0)
static_assert(kSlots * kTouchedWarps == 64, "the prefix gives each lane two counts");
static_assert(kTable == 2 * kOwn, "the table stays at most half full");

constexpr int kMaxBlocks = 128;  // BlockRows: 3.5 KB of the 4 KB of parameters

// Block l's rows are idx[l], val[l] (int32 local ids, float32), [N, nnz[l]]
// row-major; its features are the global ids [lo[l], lo[l] + d_l); a
// step's u gathered rows of it go to [u * off[l], u * (off[l] + nnz[l])) of
// the gathered buffers, off[l] = nnz[0] + ... + nnz[l - 1].  Unused blocks'
// entries are never read.  The layout is kernels/_build.py's BlockRows.
struct BlockRows {
  const int* idx[kMaxBlocks];
  const float* val[kMaxBlocks];
  int nnz[kMaxBlocks];
  int lo[kMaxBlocks];
  int off[kMaxBlocks];
};
static_assert(sizeof(BlockRows) == 3584, "the ctypes layout of kernels/_build.py");

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
// Returns the slot if this call claimed it, -1 if the table held id: of
// the threads that enter one id, exactly one gets its slot.
__device__ __forceinline__ int table_insert(int* keys, int id) {
  for (int s = home_slot(id);; s = (s + 1) & (kTable - 1)) {
    const int prev = atomicCAS(keys + s, kEmpty, id);
    if (prev == kEmpty) return s;
    if (prev == id) return -1;
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

// ---------------------------------------------------------------------------
// The touched pass: entries_kernel.  Ownership goes by a hash of the id, so
// the popular ids of a Zipf-drawn step spread over the card; see the notes
// at the top of this file.

constexpr int kPartEntries = 1024;  // a block's entries per id part, one CTA a part
constexpr int kKeyCap = 2 * kTouchedThreads;  // keys a round holds: two a thread
constexpr int kKeyTableBits = 10;
constexpr int kKeyTable = 1 << kKeyTableBits;  // their hash slots
constexpr int kScanLoads = 8;  // flat positions a lane loads at once
constexpr int kChunk = 32 * kScanLoads;  // a warp's positions loaded at once
constexpr int kWarpSpan = 4 * kChunk;  // a warp's contiguous positions of a span
constexpr int kSpan = kTouchedWarps * kWarpSpan;  // positions staged before a fold
constexpr int kChain = 8;  // a fold's terms of a run loaded at once
static_assert(kKeyTable >= kKeyCap + kTouchedThreads, "a probe always finds room");
static_assert(kKeyCap + kTouchedThreads <= 65536, "key indices fit 16 bits");
static_assert(kKeyTable <= 65536 && kSpan <= 65536, "slots and offsets fit 16 bits");

// The id parts of a block of `entries` flat positions: one CTA each.
__host__ __device__ __forceinline__ int touch_parts(int entries) {
  return (entries + kPartEntries - 1) / kPartEntries;
}

// An id's spread over `parts` parts: a bijection of the 32-bit ids
// (Fibonacci hashing) times parts.  The high word is the id's part; the
// low word orders the ids of one part, distinct for distinct ids.
__device__ __forceinline__ unsigned long long spread(int id, int parts) {
  return static_cast<unsigned long long>(static_cast<unsigned>(id) * 0x9E3779B1u) *
         static_cast<unsigned>(parts);
}

// An id's home slot in KeyStaging's table: another multiplier than
// spread's, whose high bits a part's ids share.
__device__ __forceinline__ int key_home(int id) {
  return static_cast<int>((static_cast<unsigned>(id) * 0x85EBCA6Bu) >>
                          (32 - kKeyTableBits));
}

// One entries_kernel CTA's shared memory (dynamic, 110 KB: two CTAs an SM).
struct __align__(16) KeyStaging {
  float c[kSpan];       // warp w's kept contributions at [w * kWarpSpan, ...)
  float sorted[kSpan];  // a fold: the span's, grouped by key, each key's in flat order
  int keys[kKeyTable];  // the table's ids, kEmpty where free
  int key_of[kKeyCap];  // a key index's id
  int start[kKeyCap];   // a fold: where a key's run starts in sorted
  unsigned short key[kSpan];  // beside c: each kept entry's slot, then its key index
  unsigned short index[kKeyTable];  // a slot's key index
  unsigned short count[kTouchedWarps][kKeyCap];  // a fold: a warp's entries of a key
  union {
    struct {  // the scan: a chunk's positions of the part and their values
      unsigned short at[kTouchedWarps][kChunk];
      float v[kTouchedWarps][kChunk];
    } mine;
    unsigned char lane_of[kTouchedWarps][kKeyCap];  // a fold: a key's lane in a chunk
  } u;
  int kept[kTouchedWarps];  // each warp's kept entries of the span
  int warp_sum[kTouchedWarps];
  int nkeys;
  int overflow;
};
constexpr int kStagingBytes = static_cast<int>(sizeof(KeyStaging));
static_assert(2 * (sizeof(KeyStaging) + 1024) <= 228 * 1024, "two CTAs an SM");

// Enter id: its slot, or -1 if the round cannot take another key (the
// caller then runs the part again on finer sub-parts).  Of the threads that
// enter one id, one claims its slot and gives it the next key index.  A
// slot is read before it is claimed, so an id entered before costs no
// atomic: the padding id comes to one CTA in every row.  A thread claims
// only while fewer than kKeyCap keys are counted, so at most kKeyCap +
// kTouchedThreads - 1 slots are ever claimed and a probe finds the id or a
// free slot.
__device__ __forceinline__ int key_insert(KeyStaging& st, int id) {
  if (*reinterpret_cast<volatile int*>(&st.nkeys) >= kKeyCap) return -1;
  const volatile int* keys = st.keys;
  int s = key_home(id);
  for (int n = 0; n < kKeyTable; ++n, s = (s + 1) & (kKeyTable - 1)) {
    int prev = keys[s];
    if (prev == kEmpty) prev = atomicCAS(st.keys + s, kEmpty, id);
    if (prev == id) return s;
    if (prev == kEmpty) {
      const int k = atomicAdd(&st.nkeys, 1);
      st.index[s] = static_cast<unsigned short>(k);
      if (k < kKeyCap) st.key_of[k] = id;
      return s;
    }
  }
  return -1;
}

// A chunk's ids and values: flat positions base + j * 32 + lane, kEmpty
// (and 0.0) from `end` on.
__device__ __forceinline__ void load_chunk(const int* __restrict__ idx,
                                           const float* __restrict__ val, int end,
                                           int base, int (&id)[kScanLoads],
                                           float (&v)[kScanLoads], int lane) {
#pragma unroll
  for (int j = 0; j < kScanLoads; ++j) {
    const int p = base + j * 32 + lane;
    id[j] = kEmpty;
    v[j] = 0.0f;
    if (p < end) {
      id[j] = __ldg(idx + p);
      v[j] = __ldg(val + p);
    }
  }
}

// Lane's key k among the warp's 32: how many lower lanes hold k, and
// whether no higher lane does.  (__match_any_sync over 32 distinct keys
// measured far slower than these shuffles.)
__device__ __forceinline__ void peers(int k, int lane, int& earlier, bool& last) {
  earlier = 0;
  last = true;
#pragma unroll
  for (int src = 0; src < 32; ++src) {
    const int other = __shfl_sync(0xffffffffu, k, src);
    earlier += src < lane && other == k;
    last = last && !(src > lane && other == k);
  }
}

// Whether the warp's lanes with in set hold distinct keys k: each writes
// its lane at its key, and a key two lanes hold keeps one of them.  Rows
// that hold each id once give 32 distinct keys nearly always.
__device__ __forceinline__ bool distinct_keys(KeyStaging& st, int warp, int lane, bool in,
                                              int k) {
  if (in) st.u.lane_of[warp][k] = static_cast<unsigned char>(lane);
  __syncwarp();
  const bool alone = !in || st.u.lane_of[warp][k] == lane;
  const bool all = __all_sync(0xffffffffu, alone);
  __syncwarp();
  return all;
}

// Fold a span's kept entries into the owners' sums: a stable counting sort
// by key index, then thread t adds the runs of keys 2t and 2t + 1, each in
// flat order, to acc[0] and acc[1].  Warp w's entries, at [w * kWarpSpan,
// + kept[w]), follow warp w - 1's in flat order.  Warp w counts its
// entries of each key (count[w][key], chunk by chunk); each key's counts
// become the warps' offsets in its run, the runs start at the prefix of
// the keys' totals, and warp w places its entries again chunk by chunk,
// each at its key's start + offset + rank.  A chunk's ranks come from
// peers only where its keys repeat.
__device__ __forceinline__ void fold_span(KeyStaging& st, float (&acc)[2], int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int n = st.kept[warp];  // warp-uniform
  const int first = warp * kWarpSpan;
  unsigned* count = reinterpret_cast<unsigned*>(&st.count[0][0]);
  for (int i = tid; i < kTouchedWarps * kKeyCap / 2; i += kTouchedThreads) count[i] = 0u;
  __syncthreads();
  const int nkeys = st.nkeys;
  unsigned repeats = 0u;  // bit i: chunk i's keys repeat
  for (int i = 0; i < n; i += 32) {
    const bool in = i + lane < n;
    int k = -1 - lane;
    if (in) {
      k = st.index[st.key[first + i + lane]];
      st.key[first + i + lane] = static_cast<unsigned short>(k);
    }
    int earlier = 0;
    bool last = true;
    if (!distinct_keys(st, warp, lane, in, k)) {
      repeats |= 1u << (i / 32);
      peers(k, lane, earlier, last);
    }
    const int before = in ? st.count[warp][k] : 0;
    __syncwarp();
    if (in && last) st.count[warp][k] = static_cast<unsigned short>(before + earlier + 1);
    __syncwarp();
  }
  __syncthreads();
  int tot[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int k = 2 * tid + t;
    int sum = 0;
    if (k < nkeys) {
      for (int w = 0; w < kTouchedWarps; ++w) {
        const int c = st.count[w][k];
        st.count[w][k] = static_cast<unsigned short>(sum);
        sum += c;
      }
    }
    tot[t] = sum;
  }
  const int pair = tot[0] + tot[1];
  int incl = pair;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) st.warp_sum[warp] = incl;
  __syncthreads();
  int start = incl - pair;
  for (int w = 0; w < warp; ++w) start += st.warp_sum[w];
  st.start[2 * tid] = start;
  st.start[2 * tid + 1] = start + tot[0];
  __syncthreads();
  for (int i = 0; i < n; i += 32) {
    const bool in = i + lane < n;
    const int k = in ? st.key[first + i + lane] : -1 - lane;
    int earlier = 0;
    bool last = true;
    if ((repeats >> (i / 32)) & 1u) peers(k, lane, earlier, last);
    const int before = in ? st.count[warp][k] : 0;
    __syncwarp();
    if (in) {
      st.sorted[st.start[k] + before + earlier] = st.c[first + i + lane];
      if (last) st.count[warp][k] = static_cast<unsigned short>(before + earlier + 1);
    }
    __syncwarp();
  }
  __syncthreads();
  // kChain terms of each run loaded at once, +0.0 past a run's end (it
  // leaves the sum as it is).
  const int longest = max(tot[0], tot[1]);
  for (int i = 0; i < longest; i += kChain) {
    float a[kChain], b[kChain];
#pragma unroll
    for (int t = 0; t < kChain; ++t) {
      a[t] = i + t < tot[0] ? st.sorted[start + i + t] : 0.0f;
      b[t] = i + t < tot[1] ? st.sorted[start + tot[0] + i + t] : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kChain; ++t) {
      acc[0] = __fadd_rn(acc[0], a[t]);
      acc[1] = __fadd_rn(acc[1], b[t]);
    }
  }
  __syncthreads();
}

// One CTA per (block, id part).  Block l's u gathered rows lie at [u *
// off[l], u * (off[l] + nnz[l])) of idx and val; its ids are local to the
// features from lo[l].  The CTA reads all of the block's entries, keeps
// those whose id lies in its part, and updates each such id once.
// Update provides In load(j) and store(j, In, g).
template <class Update>
__global__ void __launch_bounds__(kTouchedThreads, 2)
entries_kernel(const BlockRows rows, int q, const int* __restrict__ idx_all,
               const float* __restrict__ val_all, const float* __restrict__ coef, int u,
               Update update) {
  extern __shared__ __align__(16) unsigned char touch_smem[];
  KeyStaging& st = *reinterpret_cast<KeyStaging*>(touch_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  int l = 0, part = blockIdx.x;
  for (; l < q - 1; ++l) {
    const int parts = touch_parts(u * rows.nnz[l]);
    if (part < parts) break;
    part -= parts;
  }
  const int nnz = rows.nnz[l];
  const int entries = u * nnz;
  const int parts = touch_parts(entries);
  const long long first = static_cast<long long>(u) * rows.off[l];
  const int* __restrict__ idx = idx_all + first;
  const float* __restrict__ val = val_all + first;
  // A round takes the part's ids whose low spread word starts with the
  // depth bits of sub: all of them at depth 0.  A round that meets more
  // than kKeyCap keys is run again on its two halves (depth + 1); after
  // a round the next sub-part of the finest depth follows, and the depth
  // rises again when a half's sibling is done.  At depth 32 a round holds
  // one id, so the rounds end.
  int depth = 0;
  unsigned long long sub = 0;
  for (;;) {
    __syncthreads();  // the last round's readers are done
    for (int s = tid; s < kKeyTable; s += kTouchedThreads) st.keys[s] = kEmpty;
    if (tid == 0) {
      st.nkeys = 0;
      st.overflow = 0;
    }
    __syncthreads();
    const auto in_round = [&](int id) {
      const unsigned long long h = spread(id, parts);
      return static_cast<int>(h >> 32) == part &&
             (depth == 0 || (static_cast<unsigned>(h) >> (32 - depth)) == sub);
    };
    float acc[2] = {0.0f, 0.0f};
    int j[2] = {-1, -1};
    typename Update::In in[2];
    bool overflow = false;
    for (int span = 0; span < entries; span += kSpan) {
      // Warp w scans its share of the span, a chunk ahead, with no
      // barrier.  First each lane tests its 8 positions of a chunk and the
      // warp lists those of the part, in flat order, with their values;
      // then each lane takes one listed entry at a time: it enters the id
      // and appends the entry, if its contribution is not +-0.0 (padding),
      // to the warp's region in flat order as (slot, c).  A +-0.0 term
      // leaves a sum from +0.0 as it is; the product, not the value, is
      // tested, so a NaN or Inf coefficient still reaches the sum.
      // The span's positions split evenly, 32 at a time: warp w's share is
      // [lo, hi).
      const int share = (min(kSpan, entries - span) + kTouchedThreads - 1) / kTouchedThreads * 32;
      const int lo = span + warp * share;
      const int hi = min(lo + share, entries);
      int id[kScanLoads];
      float v[kScanLoads];
      load_chunk(idx, val, hi, lo, id, v, lane);
      int n = 0;  // the region's entries, warp-uniform
      bool full = false;
      for (int base = lo; base < hi; base += kChunk) {
        int m = 0;  // the chunk's listed entries, warp-uniform
#pragma unroll
        for (int t = 0; t < kScanLoads; ++t) {
          const bool mine = id[t] != kEmpty && in_round(id[t]);
          const unsigned listed = __ballot_sync(0xffffffffu, mine);
          if (mine) {
            const int o = m + __popc(listed & below);
            st.u.mine.at[warp][o] = static_cast<unsigned short>(t * 32 + lane);
            st.u.mine.v[warp][o] = v[t];
          }
          m += __popc(listed);
        }
        load_chunk(idx, val, hi, base + kChunk, id, v, lane);
        __syncwarp();
        for (int i = lane; i - lane < m; i += 32) {
          const bool in = i < m;
          int s = -1;
          float c = 0.0f;
          if (in) {
            const int p = base + st.u.mine.at[warp][i];
            const float y = __ldg(coef + p / nnz);
            s = key_insert(st, __ldg(idx + p));
            full = full || s < 0;
            c = __fmul_rn(st.u.mine.v[warp][i], y);
          }
          const bool keep = s >= 0 && c != 0.0f;
          const unsigned kept = __ballot_sync(0xffffffffu, keep);
          if (keep) {
            const int o = warp * kWarpSpan + n + __popc(kept & below);
            st.key[o] = static_cast<unsigned short>(s);
            st.c[o] = c;
          }
          n += __popc(kept);
        }
        __syncwarp();
      }
      if (full) st.overflow = 1;
      if (lane == 0) st.kept[warp] = n;
      __syncthreads();
      if (st.overflow || st.nkeys > kKeyCap) {  // CTA-uniform
        overflow = true;
        break;
      }
      if (span + kSpan >= entries) {
        // The keys are final: load their inputs, which the fold overlaps.
        const int nkeys = st.nkeys;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int k = 2 * tid + t;
          j[t] = k < nkeys ? rows.lo[l] + st.key_of[k] : -1;
          if (j[t] >= 0) in[t] = update.load(j[t]);
        }
      }
      fold_span(st, acc, tid);
    }
    if (overflow) {
      ++depth;
      sub <<= 1;
      continue;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (j[t] >= 0) update.store(j[t], in[t], acc[t]);
    }
    if (depth == 0) break;
    ++sub;
    while (depth > 0 && (sub & 1u) == 0u) {
      sub >>= 1;
      --depth;
    }
    if (depth == 0) break;
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

// The touched pass over the q blocks' gathered rows on stream s, one
// launch: sum_l touch_parts(u * nnz[l]) CTAs.  Returns cudaGetLastError()
// (cudaErrorInvalidValue unless 1 <= q <= kMaxBlocks).  The kernel's
// shared memory is dynamic, above the 48 KB a launch gets by default: the
// limit is raised for the current device at every launch.
template <class Update>
int launch_entries(const BlockRows& rows, int q, const int* idx, const float* val,
                   const float* coef, int u, Update update, cudaStream_t s) {
  if (q < 1 || q > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  for (int l = 0; l < q; ++l) ctas += touch_parts(u * rows.nnz[l]);
  if (ctas == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = cudaFuncSetAttribute(
      entries_kernel<Update>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStagingBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  entries_kernel<Update><<<ctas, kTouchedThreads, kStagingBytes, s>>>(rows, q, idx, val,
                                                                      coef, u, update);
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
