// flash_decode: one-token GQA attention over a KV cache, a decode batch at once,
//
//     out[b, j, g, :] = sum_{s < length} softmax_s(scale * q[b, j, g] . k[b, s, j])
//                                        * v[b, s, j]
//
// q [B, Hkv, G, Dh], k and v [B, S, Hkv, Dh] (batch stride passed in, the
// rest contiguous), float32 or bfloat16; out float32 [B, Hkv, G, Dh].
// Query head h = j * G + g uses KV head j = h / G, the grouping of the
// reference's decode (q.reshape(b, hkv, g, dh)).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// (flash_decode, the pallas_call at :97), which sweeps S sequentially per
// KV head with an online-softmax accumulator in VMEM and masks with an
// additive bias (0 / -1e30).  Here the positions at or past `length` are
// skipped: in the reference each of them adds exp(-1e30 - m) = 0 in
// float32, so skipping is exact.
//
// What bounds it on an H100: bytes.  Every K and V byte of the valid
// prefix is read once: 2 * B * length * Hkv * Dh * sizeof(T), 134.2 MB in
// bfloat16 for qwen3-14b (Hkv 8, Dh 128) at 32,768 positions, 0.0401 ms at
// 3.35 TB/s per layer.  The 4 * B * H * length * Dh float32 operations are
// a quarter of that time at 67 TFLOP/s.  So the design keeps HBM busy
// whatever the arithmetic does:
//   * Loads are decoupled from compute.  Each warp owns a ring of kStages
//     tiles in shared memory (RT rows of K and RT rows of V, rows padded by
//     16 bytes) and fills it with cp.async, 16 bytes a lane, one commit
//     group per tile; it waits for tile i while tiles i + 1 .. i + kStages -
//     1 are in flight.  No block-wide barrier inside the loop.  At qwen3-14b's
//     shapes (bfloat16, Dh 128, RT = 16) a stage is 8.7 KB, a block's four
//     warps hold 104 KB and two blocks an SM keep ~139 KB in flight.
//   * The arithmetic goes where the card is fastest for the dtype.  In
//     bfloat16 at Dh <= 128 (qwen3-14b) the scores and P.V are tensor-core
//     products, P kept in float32 precision as three bfloat16 parts: see
//     flash_decode_mma_kernel.  In float32, and in bfloat16 at Dh 256,
//     flash_decode_split_kernel uses float32 FFMA:
//   * Scores without a butterfly per row.  RT rows are spread over the
//     lanes (lane = part * RT + row, P = 32 / RT parts of Dh each), q's G
//     rows are float32 in shared memory and read as broadcasts, so a lane
//     computes all G partial dots of its row; log2(P) shuffles combine the
//     parts.  The padded rows put the 32 lanes' 16-byte reads on distinct
//     banks.  Then per tile and head one warp max and one warp sum over
//     the rows (log2(RT) shuffles each).
//   * P.V in float32 FFMA from shared memory: lane c owns Dh / 32 columns;
//     the tile's weights p[g][row] go through a per-warp shared array (float4
//     reads, 4 rows at a time).  P is never rounded to bfloat16.
// Flash-decoding split over S for the parallelism: grid (B * Hkv, n_split);
// warp w of a split takes its tiles w, w + 4, ...; each keeps (m, l, acc)
// per head, m from -1e30 as in the TPU kernel; the warps combine in warp
// order through shared memory.  With n_split == 1 that block divides by
// max(l, 1e-30) and writes out itself: one launch.  Otherwise it leaves one
// (m, l, acc) per split and flash_decode_combine_kernel combines the splits
// in split order.  No atomics, so the result is deterministic.  An empty
// warp keeps m = -1e30, l = 0, acc = 0 and combines with weight 0, never a
// NaN; rows past the split's end are zero-filled by cp.async (src-size 0)
// and get weight 0.  expf, not __expf; size_t offsets (B = 4 at S =
// 524,288 is 2.1e9 elements per tensor).  The wrapper
// (kernels/flash_decode.py) owns the geometry (n_split, rows_per_split from
// the card's SM count) and allocates the float32 split partials; the
// launcher opts the split pass into its dynamic shared memory (up to 215 KB
// at float32, Dh 128, G 16).
//
// Preconditions (checked by the wrapper): q, k, v of one dtype (0 =
// float32, 1 = bfloat16) on the current device, q and out contiguous, k
// and v [S, Hkv, Dh] contiguous per request with the same batch stride, k,
// v and their batch stride 16-byte aligned.  Returns cudaErrorInvalidValue
// unless Dh is 32, 64, 128 or 256, 1 <= G <= 16, G * Dh <= 2048, 1 <=
// length, 1 <= n_split <= 65535 and (n_split - 1) * rows_per_split <
// length; else cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kPad = 16;  // bytes after each K/V row in shared memory
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows of one tile: 16 unless a K row is wider than 512 bytes (float32 at
// Dh 256), then 8, so a stage stays under 17 KB.
template <class T, int DH>
struct Geo {
  static constexpr int RT = DH * sizeof(T) <= 512 ? 16 : 8;
  static constexpr int ROWB = DH * sizeof(T) + kPad;  // bytes per smem row
  static constexpr int STAGE = 2 * RT * ROWB;         // K rows then V rows
  static constexpr int CPR = DH * sizeof(T) / 16;     // 16-byte chunks a row
};

// Dynamic shared memory of the split passes: the FFMA kernel also keeps q
// and the tile's weights there (`fixed`), the tensor-core one does not.
template <class T, int DH>
size_t smem_bytes(int group, bool mma) {
  using G = Geo<T, DH>;
  const size_t ring = static_cast<size_t>(kWarps) * kStages * G::STAGE;
  const size_t combine = sizeof(float) * kWarps * group * (DH + 2);
  const size_t fixed = sizeof(float) * (static_cast<size_t>(group) * DH +
                                        kWarps * 16 * G::RT);
  return (mma ? 0 : fixed) + (ring > combine ? ring : combine);
}

// Issue the cp.async copies of rows [s0, s0 + RT) of one KV head's K and V
// into a stage (K rows, then V rows, each padded to ROWB bytes); rows at or
// past s_end are zero-filled.  One warp, 16 bytes a lane.
template <class T, int DH>
__device__ __forceinline__ void issue_tile(unsigned char* st, const T* kb, const T* vb,
                                           size_t row_stride, int s0, int s_end,
                                           int lane) {
  using G = Geo<T, DH>;
  constexpr int VPC = 16 / sizeof(T);
#pragma unroll 4
  for (int c = lane; c < 2 * G::RT * G::CPR; c += 32) {
    const int kv = c / (G::RT * G::CPR);
    const int r = (c / G::CPR) % G::RT;
    const int ch = c % G::CPR;
    const bool ok = s0 + r < s_end;
    const T* src = (kv ? vb : kb) +
                   (ok ? static_cast<size_t>(s0 + r) * row_stride : 0) + ch * VPC;
    cp_async16(st + (kv * G::RT + r) * G::ROWB + ch * 16, src, ok ? 16 : 0);
  }
}

// The block's warps left (m, l, acc) per head in wm / wl [kWarps][group] and
// wacc [kWarps][group][DH]: combine them in warp order into the split's
// partial, or, with one split, into out.
template <int DH>
__device__ __forceinline__ void finish_split(const float* wm, const float* wl,
                                             const float* wacc, float* m_part,
                                             float* l_part, float* acc_part,
                                             float* out, int group, int bj,
                                             int split) {
  for (int i = threadIdx.x; i < group * DH; i += kThreads) {
    const int g = i / DH;
    const int col = i - g * DH;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * group + g]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w * group + g] - mx);
      lsum = fmaf(wl[w * group + g], c, lsum);
      asum = fmaf(wacc[(w * group + g) * DH + col], c, asum);
    }
    if (gridDim.y == 1) {
      out[(static_cast<size_t>(bj) * group + g) * DH + col] = asum / fmaxf(lsum, 1e-30f);
    } else {
      const size_t o = (static_cast<size_t>(bj) * gridDim.y + split) * group + g;
      acc_part[o * DH + col] = asum;
      if (col == 0) {
        m_part[o] = mx;
        l_part[o] = lsum;
      }
    }
  }
}

template <class T, int DH, int MAXG>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ m_part,
                          float* __restrict__ l_part,
                          float* __restrict__ acc_part,
                          float* __restrict__ out, int hkv, int group,
                          long long kv_bstride, int length, int rows_per_split,
                          float scale) {
  using G = Geo<T, DH>;
  constexpr int RT = G::RT;
  constexpr int P = 32 / RT;           // lanes per row in the score phase
  constexpr int VPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPP = G::CPR / P;      // chunks per part of a row
  constexpr int E = DH / 32;           // columns per lane in P.V
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [group][DH]
  float* p_all = q_s + group * DH;              // [kWarps][16][RT]
  unsigned char* ring = reinterpret_cast<unsigned char*>(p_all + kWarps * 16 * RT);

  const int bj = blockIdx.x;  // b * hkv + j
  const int b = bj / hkv;
  const int j = bj - b * hkv;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const T* qb = q + static_cast<size_t>(bj) * group * DH;
  for (int i = threadIdx.x; i < group * DH; i += kThreads) q_s[i] = to_f32(qb[i]);
  __syncthreads();

  const int s_begin = split * rows_per_split;
  const int s_end = min(length, s_begin + rows_per_split);
  const int n_tiles = (s_end - s_begin + RT - 1) / RT;
  const size_t row_stride = static_cast<size_t>(hkv) * DH;
  const size_t head_off = static_cast<size_t>(b) * kv_bstride + static_cast<size_t>(j) * DH;
  const T* kb = k + head_off;
  const T* vb = v + head_off;
  unsigned char* my_ring = ring + static_cast<size_t>(warp) * kStages * G::STAGE;
  float* p_s = p_all + warp * 16 * RT;  // [g][RT]

  // This warp's i-th tile into stage i % kStages, then close a commit group
  // (empty past the warp's last tile).
  auto issue = [&](int i) {
    const int t = warp + i * kWarps;
    if (t < n_tiles) {
      issue_tile<T, DH>(my_ring + (i % kStages) * G::STAGE, kb, vb, row_stride,
                        s_begin + t * RT, s_end, lane);
    }
    cp_async_commit();
  };

  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kMaskValue;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  const int row = lane % RT;
  const int part = lane / RT;
  for (int i = 0; warp + i * kWarps < n_tiles; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* st = my_ring + (i % kStages) * G::STAGE;
    const int s0 = s_begin + (warp + i * kWarps) * RT;
    const bool valid = s0 + row < s_end;

    // Scores: this lane's part of its row against every head's q.
    float sc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) sc[g] = 0.0f;
    const unsigned char* krow = st + row * G::ROWB + part * CPP * 16;
#pragma unroll
    for (int ch = 0; ch < CPP; ++ch) {
      const Vec<T, VPC> kx = reinterpret_cast<const Vec<T, VPC>*>(krow)[ch];
      float kf[VPC];
#pragma unroll
      for (int e = 0; e < VPC; ++e) kf[e] = to_f32(kx.v[e]);
      const int col0 = (part * CPP + ch) * VPC;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < group) {
#pragma unroll
          for (int e4 = 0; e4 < VPC; e4 += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(q_s + g * DH + col0 + e4);
            sc[g] = fmaf(qv.x, kf[e4], sc[g]);
            sc[g] = fmaf(qv.y, kf[e4 + 1], sc[g]);
            sc[g] = fmaf(qv.z, kf[e4 + 2], sc[g]);
            sc[g] = fmaf(qv.w, kf[e4 + 3], sc[g]);
          }
        }
      }
    }
    // Parts -> rows, then one max and one sum per head over the tile.
    float alpha[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {
        float s = sc[g];
#pragma unroll
        for (int o = 16; o >= RT; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        s *= scale;
        float tmax = valid ? s : kMaskValue;
#pragma unroll
        for (int o = RT / 2; o > 0; o >>= 1) {
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        }
        const float m_new = fmaxf(m[g], tmax);
        alpha[g] = expf(m[g] - m_new);
        const float p = valid ? expf(s - m_new) : 0.0f;
        float psum = p;
#pragma unroll
        for (int o = RT / 2; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
        l[g] = l[g] * alpha[g] + psum;
        m[g] = m_new;
        if (part == 0) p_s[g * RT + row] = p;
      }
    }
    __syncwarp();

    // P.V: lane owns columns lane * E .. lane * E + E - 1.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha[g];
      }
    }
    const unsigned char* vbase = st + RT * G::ROWB + lane * E * sizeof(T);
#pragma unroll
    for (int r4 = 0; r4 < RT; r4 += 4) {
      float4 pw[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < group) pw[g] = *reinterpret_cast<const float4*>(p_s + g * RT + r4);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const Vec<T, E> vx = *reinterpret_cast<const Vec<T, E>*>(vbase + (r4 + rr) * G::ROWB);
        float vf[E];
#pragma unroll
        for (int e = 0; e < E; ++e) vf[e] = to_f32(vx.v[e]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < group) {
            const float pg = rr == 0 ? pw[g].x : rr == 1 ? pw[g].y : rr == 2 ? pw[g].z : pw[g].w;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
          }
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it below

  // The warps' (m, l, acc) -> one per split, combined in warp order.
  float* wm = reinterpret_cast<float*>(ring);  // [kWarps][group]
  float* wl = wm + kWarps * group;              // [kWarps][group]
  float* wacc = wl + kWarps * group;            // [kWarps][group][DH]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group) {
      if (lane == 0) {
        wm[warp * group + g] = m[g];
        wl[warp * group + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) wacc[(warp * group + g) * DH + lane * E + e] = acc[g][e];
    }
  }
  __syncthreads();
  finish_split<DH>(wm, wl, wacc, m_part, l_part, acc_part, out, group, bj, split);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += a * b: a 16 x 16 bfloat16 (row), b 16 x 8 bfloat16 (col), d float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
// (x0, x1) = hi + mid + lo, three bfloat16 pairs; each rounding leaves at
// most 2^-8 of what it rounds, so x0 - (hi + mid + lo) is within 2^-24 |x0|.
__device__ __forceinline__ void split3(float x0, float x1, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(h);
  x1 -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(m);
  x1 -= __high2float(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}

// The bfloat16 split pass at Dh <= 128 on the tensor cores (mma.sync
// m16n8k16, float32 accumulators), with the warps' rings and the combine of
// flash_decode_split_kernel.  A tile is 16 rows; the 16 rows of the A
// operand are the heads (g and g + 8 for lane group g = lane / 4; rows past
// G are zero), so every G <= 16 is one product:
//   * scores S = Q K^T: Q's fragments stay in registers for the whole walk,
//     K's come from the ring with ldmatrix; a bfloat16 product is exact in
//     float32.  Each lane then holds 4 scores of head g and 4 of g + 8; one
//     max and one sum per head take two quad shuffles each.
//   * P V: the scores' accumulator layout is the A operand's, so P stays in
//     registers, as three bfloat16 parts hi + mid + lo (split3: within 2^-24
//     of P, so the output is within ~1e-7 * max|v| of an exact float32 P.V;
//     P is never rounded to one bfloat16).  V's fragments come from the ring
//     with ldmatrix.trans; three products per 8 columns.
// The accumulators sum in the tensor cores' order, not in FFMA order: the
// tolerance against the plain version is the same 2e-5 * max|v|.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        float* __restrict__ m_part, float* __restrict__ l_part,
                        float* __restrict__ acc_part, float* __restrict__ out,
                        int hkv, int group, long long kv_bstride, int length,
                        int rows_per_split, float scale) {
  using G = Geo<__nv_bfloat16, DH>;
  constexpr int RT = G::RT;
  static_assert(RT == 16, "one m16n8k16 k-step of P.V per tile");
  constexpr int KS = DH / 16;  // k-steps of Q K^T
  constexpr int NT = DH / 8;   // 8-column tiles of P V
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;

  const int bj = blockIdx.x;  // b * hkv + j
  const int b = bj / hkv;
  const int j = bj - b * hkv;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;  // heads gq and gq + 8
  const int tq = lane & 3;

  // Q as the A operand: rows are heads, zero past the group.
  const __nv_bfloat16* qb = q + static_cast<size_t>(bj) * group * DH;
  unsigned qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = gq + (r & 1) * 8;
      const int col = ks * 16 + (r >> 1) * 8 + 2 * tq;
      qa[ks][r] = g < group ? *reinterpret_cast<const unsigned*>(qb + g * DH + col) : 0u;
    }
  }

  const int s_begin = split * rows_per_split;
  const int s_end = min(length, s_begin + rows_per_split);
  const int n_tiles = (s_end - s_begin + RT - 1) / RT;
  const size_t row_stride = static_cast<size_t>(hkv) * DH;
  const size_t head_off = static_cast<size_t>(b) * kv_bstride + static_cast<size_t>(j) * DH;
  const __nv_bfloat16* kb = k + head_off;
  const __nv_bfloat16* vb = v + head_off;
  unsigned char* my_ring = ring + static_cast<size_t>(warp) * kStages * G::STAGE;

  auto issue = [&](int i) {
    const int t = warp + i * kWarps;
    if (t < n_tiles) {
      issue_tile<__nv_bfloat16, DH>(my_ring + (i % kStages) * G::STAGE, kb, vb,
                                    row_stride, s_begin + t * RT, s_end, lane);
    }
    cp_async_commit();
  };

  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; warp + i * kWarps < n_tiles; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* ks_base = my_ring + (i % kStages) * G::STAGE;
    const unsigned char* vs_base = ks_base + RT * G::ROWB;
    const int s0 = s_begin + (warp + i * kWarps) * RT;

    // sc[nt][0..1]: head gq, rows 8 nt + 2 tq + {0, 1}; sc[nt][2..3]: head gq + 8.
    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned kf[4];
      ldsm_x4(kf, ks_base + ((lane >> 4) * 8 + (lane & 7)) * G::ROWB +
                      (ks * 16 + ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(sc[0], qa[ks], kf[0], kf[1]);
      mma_bf16(sc[1], qa[ks], kf[2], kf[3]);
    }

    // Online softmax per head over the tile's 16 rows (h = 0: head gq, 1: gq + 8).
    float p[2][4], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[4];
      bool ok[4];
      float tmax = kMaskValue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e >> 1) * 8 + 2 * tq + (e & 1);
        ok[e] = s0 + r < s_end;
        x[e] = sc[e >> 1][2 * h + (e & 1)] * scale;
        if (ok[e]) tmax = fmaxf(tmax, x[e]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[h], tmax);
      alpha[h] = expf(m[h] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[h][e] = ok[e] ? expf(x[e] - m_new) : 0.0f;
        psum += p[h][e];
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[h] = l[h] * alpha[h] + psum;
      m[h] = m_new;
    }

    // P as the A operand (rows heads, columns the tile's rows), in three parts.
    unsigned pa[3][4];
    split3(p[0][0], p[0][1], pa[0][0], pa[1][0], pa[2][0]);
    split3(p[1][0], p[1][1], pa[0][1], pa[1][1], pa[2][1]);
    split3(p[0][2], p[0][3], pa[0][2], pa[1][2], pa[2][2]);
    split3(p[1][2], p[1][3], pa[0][3], pa[1][3], pa[2][3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      unsigned vf[4];
      ldsm_x4_trans(vf, vs_base + (((lane >> 3) & 1) * 8 + (lane & 7)) * G::ROWB +
                            (nt + (lane >> 4)) * 16);
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        mma_bf16(acc[nt], pa[part], vf[0], vf[1]);
        mma_bf16(acc[nt + 1], pa[part], vf[2], vf[3]);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it below

  float* wm = reinterpret_cast<float*>(ring);  // [kWarps][group]
  float* wl = wm + kWarps * group;              // [kWarps][group]
  float* wacc = wl + kWarps * group;            // [kWarps][group][DH]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = gq + 8 * h;
    if (g < group) {
      if (tq == 0) {
        wm[warp * group + g] = m[h];
        wl[warp * group + g] = l[h];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        wacc[(warp * group + g) * DH + nt * 8 + 2 * tq] = acc[nt][2 * h];
        wacc[(warp * group + g) * DH + nt * 8 + 2 * tq + 1] = acc[nt][2 * h + 1];
      }
    }
  }
  __syncthreads();
  finish_split<DH>(wm, wl, wacc, m_part, l_part, acc_part, out, group, bj, split);
}

// One block per (b, j, g), one thread per column of Dh: the splits'
// (m, l, acc) combined in split order, then / max(l, 1e-30), as the
// reference's decode divides.  The splits' m and l are read a chunk of Dh
// at a time into shared memory (one load each, in parallel), so the walk
// over the splits waits on memory once a chunk, not once a split.
__global__ void flash_decode_combine_kernel(const float* __restrict__ m_part,
                                            const float* __restrict__ l_part,
                                            const float* __restrict__ acc_part,
                                            float* __restrict__ out, int group,
                                            int dh, int n_split) {
  __shared__ float red[256];
  __shared__ float c_s[256];
  __shared__ float l_s[256];
  const int bj = blockIdx.x / group;
  const int g = blockIdx.x - bj * group;
  const int col = threadIdx.x;
  const size_t base = static_cast<size_t>(bj) * n_split * group + g;
  float mx = kMaskValue;
  for (int s = col; s < n_split; s += dh) {
    mx = fmaxf(mx, m_part[base + static_cast<size_t>(s) * group]);
  }
  red[col] = mx;
  __syncthreads();
  for (int o = dh >> 1; o > 0; o >>= 1) {  // max is exact in any order
    if (col < o) red[col] = fmaxf(red[col], red[col + o]);
    __syncthreads();
  }
  mx = red[0];
  float lsum = 0.0f, asum = 0.0f;
  for (int s0 = 0; s0 < n_split; s0 += dh) {
    const int m = min(dh, n_split - s0);
    __syncthreads();
    if (col < m) {
      const size_t o = base + static_cast<size_t>(s0 + col) * group;
      c_s[col] = expf(m_part[o] - mx);
      l_s[col] = l_part[o];
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < m; ++i) {
      const size_t o = base + static_cast<size_t>(s0 + i) * group;
      lsum = fmaf(l_s[i], c_s[i], lsum);
      asum = fmaf(acc_part[o * dh + col], c_s[i], asum);
    }
  }
  out[(static_cast<size_t>(bj) * group + g) * dh + col] =
      asum / fmaxf(lsum, 1e-30f);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* m_part;
  float* l_part;
  float* acc_part;
  float* out;
  int batch_heads, hkv, group;
  long long kv_bstride;
  int length, rows_per_split, n_split;
  float scale;
  cudaStream_t stream;
};

template <class T, class K>
cudaError_t launch(K kernel, size_t smem, const Args& a) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.batch_heads, a.n_split), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.m_part, a.l_part, a.acc_part, a.out, a.hkv, a.group, a.kv_bstride, a.length,
      a.rows_per_split, a.scale);
  return cudaGetLastError();
}

template <class T, int DH>
cudaError_t dispatch_group(const Args& a) {
  if constexpr (sizeof(T) == 2 && DH <= 128) {  // bfloat16: the tensor cores
    return launch<T>(flash_decode_mma_kernel<DH>, smem_bytes<T, DH>(a.group, true), a);
  } else {
    const size_t smem = smem_bytes<T, DH>(a.group, false);
    if (a.group <= 1) return launch<T>(flash_decode_split_kernel<T, DH, 1>, smem, a);
    if (a.group <= 4) return launch<T>(flash_decode_split_kernel<T, DH, 4>, smem, a);
    if (a.group <= 8) return launch<T>(flash_decode_split_kernel<T, DH, 8>, smem, a);
    if constexpr (DH <= 128) {  // G * Dh <= 2048
      return launch<T>(flash_decode_split_kernel<T, DH, 16>, smem, a);
    }
    return cudaErrorInvalidValue;
  }
}

template <class T>
cudaError_t dispatch_dh(const Args& a, int dh) {
  switch (dh) {
    case 32: return dispatch_group<T, 32>(a);
    case 64: return dispatch_group<T, 64>(a);
    case 128: return dispatch_group<T, 128>(a);
    default: return dispatch_group<T, 256>(a);  // checked by the entry point
  }
}

bool args_ok(int group, int dh, int dtype) {
  const bool dh_ok = dh == 32 || dh == 64 || dh == 128 || dh == 256;
  return dh_ok && group >= 1 && group <= 16 && group * dh <= 2048 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  float* m_part, float* l_part,
                                  float* acc_part, float* out, int batch,
                                  int hkv, int group, int dh,
                                  long long kv_bstride, int length,
                                  int rows_per_split, int n_split, float scale,
                                  int dtype, void* stream) {
  if (!args_ok(group, dh, dtype) || batch < 1 || hkv < 1 || length < 1 ||
      rows_per_split < 1 || n_split < 1 || n_split > 65535 ||
      static_cast<long long>(n_split - 1) * rows_per_split >= length) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, m_part, l_part, acc_part, out, batch * hkv, hkv, group,
               kv_bstride, length, rows_per_split, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dtype == 0 ? dispatch_dh<float>(a, dh)
                                     : dispatch_dh<__nv_bfloat16>(a, dh);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_split > 1) {
    flash_decode_combine_kernel<<<a.batch_heads * group, dh, 0, a.stream>>>(
        m_part, l_part, acc_part, out, group, dh, n_split);
  }
  return static_cast<int>(cudaGetLastError());
}
