// block_scatter: the snapshot's scatter of the full gradient over all q
// feature blocks in one launch,
//
//     z[J] = sum over flat positions p of block l(J) with idx_l[p] = J - b_l,
//            in increasing p, of values_l[p] * coeffs[p / nnz_l]
//
// for every global feature id J in [0, d), where block l holds the ids
// [b_l, b_{l+1}) and padded rows values_l float32 [N, nnz_l] (row-major,
// p = row * nnz_l + slot); coeffs float32 [N] is shared by all blocks and
// z float32 [d] is the blocks' outputs concatenated.  With q = 1 it is one
// block's scatter.  This is the port's own kernel: the TPU package
// scatters with a plain `.at[].add` (repro/data/block_csr.py,
// local_scatter), which has no pallas_call.  It replaces `index_add_`,
// whose float atomics add a feature's terms in an order that changes from
// run to run.  Here every sum starts from +0.0f and takes its terms with
// __fmul_rn then __fadd_rn in flat order, with no atomics: exactly what the
// CPU's `index_add_` and the reference's `.at[].add` do, so the result
// equals theirs bit for bit.
//
// The order comes from an index built once per layout and device
// (snapshot_index in kernels/block_scatter.py, cached by BlockCSR): perm
// (int32) lists each block's flat positions grouped by global id,
// increasing within each id (a stable sort), and J's terms are
// perm[starts[J] .. starts[J + 1]) with int64 starts, so the concatenated
// index may pass 2^31 entries while each block's positions stay int32.
// The launch takes each block's values pointer and nnz_l by value (Rows,
// at most kMaxBlocks blocks, in the kernel's parameter space); bounds
// [q + 1] holds the blocks' first ids.  Entries whose stored value is 0.0 (the padding at
// local id 0) are left out of the index.  That keeps the bits: their
// product is +-0.0 (the coefficients are finite), a sum that starts at
// +0.0 never becomes -0.0 under round-to-nearest, and x + (+-0.0) == x for
// every other x.
//
// What bounds it on an H100: the longest dependent chain, not bytes.  The
// generator's duplicate ids put about 80 copies of one id (local 12,539 of
// news20 block 0 at q = 8) in every row: 1.66M terms that must be added one
// after another, ~4 cycles each, ~3.4 ms at 1.98 GHz.  The bytes (perm and
// values once, coeffs, starts, z) are ~70 MB for a whole snapshot, 0.02 ms
// at 3.35 TB/s.  One launch for all q blocks makes a snapshot cost the
// LONGEST chain of any block, not the sum of each block's longest, and the
// design keeps that chain fed:
//   * heavy ids (more than `heavy_min` terms; the index lists them across
//     all blocks, longest first, so the longest chains start in the first
//     wave) get one block each.  Warps 1..7 gather and multiply the id's
//     terms into a ring of kStages tiles of kTile terms in shared memory,
//     each stage guarded by two mbarriers (full: the 224 stagers arrived;
//     empty: thread 0 is done with it), so the stagers run up to kStages
//     tiles ahead and thread 0 waits only when the ring is empty.  A stager
//     holds its 9 terms of a tile in registers: it loads the next tile's
//     positions and gathers this tile's terms before it waits for a free
//     stage, so a tile costs it one memory round trip.  Thread 0
//     folds a tile in groups of 32 terms, loading group g + 1 (eight
//     float4) into registers before it adds group g, so the shared loads'
//     latency stays off the chain of adds.
//   * every other id gets one thread, which folds its terms from global
//     memory (at most heavy_min, loads unrolled ahead of the adds).
// Blocks [0, n_heavy) are the heavy ones, the rest cover the ids in order.
// If `timing` is not null, heavy block b writes the %globaltimer (ns) at
// the start and end of its fold to timing[2b], timing[2b + 1]: the chain's
// own time inside the launch.
//
// Preconditions (checked by the wrapper, kernels/block_scatter.py): values
// float32 [N, nnz_l] contiguous with N * nnz_l < 2^31, coeffs float32 [N];
// perm, starts, heavy, bounds and heavy_min from the index of these rows;
// z float32 [d]; all on the current device; values and nnz are host
// arrays of q entries.  Returns cudaErrorInvalidValue unless 1 <= q <=
// kMaxBlocks, dim >= 1, n_heavy >= 0 and heavy_min >= 1; else
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStagers = kThreads - 32;  // warps 1..7
constexpr int kStages = 4;
constexpr int kPerStager = 9;                    // terms a stager gathers a tile
constexpr int kTile = kStagers * kPerStager;     // terms per stage: 2,016
constexpr int kGroup = 32;  // terms thread 0 loads at once: eight float4
static_assert(kTile % kGroup == 0, "a stage holds whole groups");

constexpr int kMaxBlocks = 128;  // Rows: 1.5 KB of the 4 KB of parameters

struct Rows {
  const float* values[kMaxBlocks];
  int nnz[kMaxBlocks];
};

__device__ __forceinline__ float term(const float* __restrict__ values,
                                      const float* __restrict__ coeffs,
                                      int p, int nnz_l) {
  return __fmul_rn(values[p], coeffs[p / nnz_l]);
}

// The block l with bounds[l] <= j < bounds[l + 1] (the last such l when a
// block is empty).
__device__ __forceinline__ int block_of(const int* __restrict__ bounds, int q,
                                        int j) {
  int lo = 0, hi = q;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(bounds + mid) <= j) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

// Arrive with release semantics: this thread's shared stores before it
// are visible to a thread whose wait sees the phase complete.
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem(bar))
      : "memory");
}

// Wait (acquire) until the phase of parity `parity` has completed; parity
// 1 on a fresh barrier passes at once (the phase before the first).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float add4(float acc, float4 x) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, x.x), x.y), x.z), x.w);
}

// Fold buf[0 .. cnt) into acc in order, a group of kGroup terms at a time:
// group g + 1 is loaded into registers before group g is added, so the
// shared loads' latency stays off the chain of adds.  The look-ahead past
// the last group reads up to kGroup floats past the tile (the ring is
// padded for it) and is never added.  (Two register sets taking turns,
// with no copies in the loop, measured 4 % slower.)
__device__ __forceinline__ float fold_tile(const float* buf, int cnt,
                                           float acc) {
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  const int groups = cnt / kGroup;
  float4 cur[kGroup / 4];
#pragma unroll
  for (int i = 0; i < kGroup / 4; ++i) cur[i] = b4[i];
  for (int g = 0; g < groups; ++g) {
    float4 nxt[kGroup / 4];
#pragma unroll
    for (int i = 0; i < kGroup / 4; ++i) nxt[i] = b4[(g + 1) * (kGroup / 4) + i];
#pragma unroll
    for (int i = 0; i < kGroup / 4; ++i) acc = add4(acc, cur[i]);
#pragma unroll
    for (int i = 0; i < kGroup / 4; ++i) cur[i] = nxt[i];
  }
  for (int j = groups * kGroup; j < cnt; ++j) acc = __fadd_rn(acc, buf[j]);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
block_scatter_kernel(const Rows rows, const int* __restrict__ bounds, int q,
                     const float* __restrict__ coeffs,
                     const int* __restrict__ perm,
                     const long long* __restrict__ starts,
                     const int* __restrict__ heavy, int n_heavy, int heavy_min,
                     float* __restrict__ z, int dim, long long* timing) {
  __shared__ __align__(16) float ring[kStages * kTile + kGroup];
  __shared__ __align__(8) unsigned long long full[kStages];
  __shared__ __align__(8) unsigned long long empty[kStages];
  if (static_cast<int>(blockIdx.x) < n_heavy) {
    const int id = heavy[blockIdx.x];
    const long long beg = starts[id];
    const int n = static_cast<int>(starts[id + 1] - beg);
    const int l = block_of(bounds, q, id);
    const float* values = rows.values[l];
    const int nnz = rows.nnz[l];
    const int* p = perm + beg;
    const int tiles = (n + kTile - 1) / kTile;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], kStagers);
        mbar_init(&empty[s], 1);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= 32) {
      // Stager k takes terms k, k + kStagers, ... of each tile: kPerStager
      // of a full tile.  Its positions for tile t + 1 are loaded, and its
      // terms of tile t gathered and multiplied into registers, before it
      // waits for tile t's stage to be free: one memory round trip a tile,
      // overlapped with the fold.
      const int k0 = threadIdx.x - 32;
      int pos[kPerStager];
#pragma unroll
      for (int i = 0; i < kPerStager; ++i) {
        const int j = k0 + i * kStagers;
        pos[i] = j < n ? p[j] : 0;
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        const int base = t * kTile;
        const int cnt = min(kTile, n - base);
        float x[kPerStager];
#pragma unroll
        for (int i = 0; i < kPerStager; ++i) {
          x[i] = k0 + i * kStagers < cnt ? term(values, coeffs, pos[i], nnz) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kPerStager; ++i) {
          const int j = base + kTile + k0 + i * kStagers;
          pos[i] = j < n ? p[j] : 0;
        }
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        float* buf = ring + s * kTile;
#pragma unroll
        for (int i = 0; i < kPerStager; ++i) {
          if (k0 + i * kStagers < cnt) buf[k0 + i * kStagers] = x[i];
        }
        mbar_arrive(&full[s]);
      }
    } else if (threadIdx.x == 0) {
      const long long t_start = timing != nullptr ? global_ns() : 0;
      float acc = 0.0f;
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&full[s], (t / kStages) & 1);
        acc = fold_tile(ring + s * kTile, min(kTile, n - t * kTile), acc);
        mbar_arrive(&empty[s]);
      }
      z[id] = acc;
      if (timing != nullptr) {
        timing[2 * blockIdx.x] = t_start;
        timing[2 * blockIdx.x + 1] = global_ns();
      }
    }
    return;
  }
  const int id = (blockIdx.x - n_heavy) * kThreads + threadIdx.x;
  if (id >= dim) return;
  const long long beg = starts[id];
  const long long end = starts[id + 1];
  if (end - beg > heavy_min) return;  // a heavy block writes it
  const int l = block_of(bounds, q, id);
  const float* values = rows.values[l];
  const int nnz = rows.nnz[l];
  float acc = 0.0f;
#pragma unroll 8
  for (long long j = beg; j < end; ++j) {
    acc = __fadd_rn(acc, term(values, coeffs, perm[j], nnz));
  }
  z[id] = acc;
}

}  // namespace

extern "C" int repro_block_scatter(const float* const* values, const int* nnz,
                                   const int* bounds, int q,
                                   const float* coeffs, const int* perm,
                                   const long long* starts, const int* heavy,
                                   int n_heavy, int heavy_min, float* z,
                                   int dim, long long* timing, void* stream) {
  if (q < 1 || q > kMaxBlocks || dim < 1 || n_heavy < 0 || heavy_min < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rows rows = {};
  for (int l = 0; l < q; ++l) {
    rows.values[l] = values[l];
    rows.nnz[l] = nnz[l];
  }
  const int blocks = n_heavy + (dim + kThreads - 1) / kThreads;
  block_scatter_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rows, bounds, q, coeffs, perm, starts, heavy, n_heavy, heavy_min, z,
      dim, timing);
  return static_cast<int>(cudaGetLastError());
}
