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
// a quarter of that time at 67 TFLOP/s.
//
// Design (simple first; flash-decoding split over S):
//   1. flash_decode_split_kernel — grid (B * Hkv, n_split), kWarps warps.
//      A block stages its KV head's G query rows in shared memory as
//      float32 and walks its range of positions [split * rows_per_split,
//      ...) clipped to [0, length): one warp per key row, kRows rows per
//      warp per iteration with their K and V loads issued together, each
//      lane holding E = Dh / 32 consecutive elements (one 8- or 16-byte
//      load at Dh = 128), and a butterfly warp-shuffle sum per (head, row)
//      score.  Each warp keeps (m, l, acc) per head, m starting at -1e30 as
//      in the TPU kernel; the warps combine in warp order through shared
//      memory into one (m, l, acc) per split.
//   2. flash_decode_combine_kernel — one block per (b, j, g), one thread
//      per column: combines the splits in split order and divides by
//      max(l, 1e-30), as the reference's decode does.
// No atomics, so the result is deterministic.  An empty split or warp
// keeps m = -1e30, l = 0, acc = 0 and combines with weight 0 (or 1 times
// zeros), never a NaN.  expf, not __expf; size_t offsets (B = 4 at S =
// 524,288 is 2.1e9 elements per tensor).  The wrapper
// (kernels/flash_decode.py) owns the geometry (n_split, rows_per_split
// from the card's SM count) and allocates the float32 split partials.
//
// Preconditions (checked by the wrapper): q, k, v of one dtype (0 =
// float32, 1 = bfloat16) on the current device, q and out contiguous, k
// and v [S, Hkv, Dh] contiguous per request with the same batch stride,
// pointers aligned to E elements.  Returns cudaErrorInvalidValue unless
// Dh is 32, 64, 128 or 256, 1 <= G <= 16, G * Dh <= 2048, 1 <= length,
// 1 <= n_split <= 65535 and (n_split - 1) * rows_per_split < length; else
// cudaGetLastError() after the two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;  // key rows per warp per iteration
constexpr float kMaskValue = -1e30f;

template <int E>
struct alignas(4 * E) F32Vec {
  float v[E];
};
template <int E>
struct alignas(2 * E) Bf16Vec {
  __nv_bfloat16 v[E];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&out)[E]) {
  const F32Vec<E> x = *reinterpret_cast<const F32Vec<E>*>(p);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = x.v[e];
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&out)[E]) {
  const Bf16Vec<E> x = *reinterpret_cast<const Bf16Vec<E>*>(p);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = __bfloat162float(x.v[e]);
}

// Rows s0 .. s0 + R - 1 of one KV head's K and V; zeros past s_end (their
// weights are 0, and 0 * 0 keeps the sums free of stale values).
template <int E, int R, class T>
__device__ __forceinline__ void load_rows(const T* kb, const T* vb,
                                          size_t row_stride, int s0, int s_end,
                                          float (&kr)[R][E], float (&vr)[R][E]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (s0 + r < s_end) {
      const size_t off = static_cast<size_t>(s0 + r) * row_stride;
      load_row<E>(kb + off, kr[r]);
      load_row<E>(vb + off, vr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kr[r][e] = vr[r][e] = 0.0f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  // Butterfly: every lane ends with the same bits.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <class T, int E, int MAXG>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ m_part,
                          float* __restrict__ l_part,
                          float* __restrict__ acc_part, int hkv, int group,
                          long long kv_bstride, int length, int rows_per_split,
                          float scale) {
  constexpr int DH = 32 * E;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [group][DH]
  float* wm = q_s + group * DH;           // [kWarps][group]
  float* wl = wm + kWarps * group;        // [kWarps][group]
  float* wacc = wl + kWarps * group;      // [kWarps][group][DH]

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
  const size_t row_stride = static_cast<size_t>(hkv) * DH;
  const size_t head_off = static_cast<size_t>(b) * kv_bstride +
                          static_cast<size_t>(j) * DH + lane * E;
  const T* kb = k + head_off;
  const T* vb = v + head_off;

  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kMaskValue;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }

  for (int s0 = s_begin + warp * kRows; s0 < s_end; s0 += kWarps * kRows) {
    float kr[kRows][E], vr[kRows][E];
    load_rows<E, kRows>(kb, vb, row_stride, s0, s_end, kr, vr);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {
        float qv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) qv[e] = q_s[g * DH + lane * E + e];
        float sc[kRows];
        float cmax = kMaskValue;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e) d = fmaf(qv[e], kr[r][e], d);
          sc[r] = warp_sum(d) * scale;
          if (s0 + r < s_end) cmax = fmaxf(cmax, sc[r]);
        }
        const float m_new = fmaxf(m[g], cmax);
        const float alpha = expf(m[g] - m_new);
        float p[kRows];
        float psum = 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          p[r] = (s0 + r < s_end) ? expf(sc[r] - m_new) : 0.0f;
          psum += p[r];
        }
        l[g] = l[g] * alpha + psum;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int r = 0; r < kRows; ++r) a = fmaf(p[r], vr[r][e], a);
          acc[g][e] = a;
        }
        m[g] = m_new;
      }
    }
  }

  // The warps' (m, l, acc) -> one per split, combined in warp order.
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group) {
      if (lane == 0) {
        wm[warp * group + g] = m[g];
        wl[warp * group + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        wacc[(warp * group + g) * DH + lane * E + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
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
    const size_t o = (static_cast<size_t>(bj) * gridDim.y + split) * group + g;
    acc_part[o * DH + col] = asum;
    if (col == 0) {
      m_part[o] = mx;
      l_part[o] = lsum;
    }
  }
}

__global__ void flash_decode_combine_kernel(const float* __restrict__ m_part,
                                            const float* __restrict__ l_part,
                                            const float* __restrict__ acc_part,
                                            float* __restrict__ out, int group,
                                            int dh, int n_split) {
  // One block per (b, j, g), one thread per column of Dh.
  const int bj = blockIdx.x / group;
  const int g = blockIdx.x - bj * group;
  const int col = threadIdx.x;
  const size_t base = static_cast<size_t>(bj) * n_split * group + g;
  float mx = kMaskValue;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m_part[base + s * group]);
  float lsum = 0.0f, asum = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const size_t o = base + static_cast<size_t>(s) * group;
    const float c = expf(m_part[o] - mx);
    lsum = fmaf(l_part[o], c, lsum);
    asum = fmaf(acc_part[o * dh + col], c, asum);
  }
  out[(static_cast<size_t>(bj) * group + g) * dh + col] =
      asum / fmaxf(lsum, 1e-30f);
}

template <class T, int E, int MAXG>
void launch_split(const void* q, const void* k, const void* v, float* m_part,
                  float* l_part, float* acc_part, int batch_heads, int hkv,
                  int group, long long kv_bstride, int length,
                  int rows_per_split, int n_split, float scale,
                  cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(group) * 32 * E * (1 + kWarps) +
                       2 * kWarps * group);
  flash_decode_split_kernel<T, E, MAXG>
      <<<dim3(batch_heads, n_split), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), m_part, l_part, acc_part, hkv, group,
          kv_bstride, length, rows_per_split, scale);
}

template <class T, int E>
void dispatch_group(const void* q, const void* k, const void* v, float* m_part,
                    float* l_part, float* acc_part, int batch_heads, int hkv,
                    int group, long long kv_bstride, int length,
                    int rows_per_split, int n_split, float scale,
                    cudaStream_t stream) {
#define REPRO_FLASH_SPLIT(MAXG)                                            \
  launch_split<T, E, MAXG>(q, k, v, m_part, l_part, acc_part, batch_heads, \
                           hkv, group, kv_bstride, length, rows_per_split, \
                           n_split, scale, stream)
  if (group <= 1) {
    REPRO_FLASH_SPLIT(1);
  } else if (group <= 4) {
    REPRO_FLASH_SPLIT(4);
  } else if (group <= 8) {
    REPRO_FLASH_SPLIT(8);
  } else if constexpr (E <= 4) {
    REPRO_FLASH_SPLIT(16);  // G * Dh <= 2048 keeps E = 8 at G <= 8
  }
#undef REPRO_FLASH_SPLIT
}

template <class T>
void dispatch_dh(const void* q, const void* k, const void* v, float* m_part,
                 float* l_part, float* acc_part, int batch_heads, int hkv,
                 int group, int dh, long long kv_bstride, int length,
                 int rows_per_split, int n_split, float scale,
                 cudaStream_t stream) {
  switch (dh) {
    case 32:
      dispatch_group<T, 1>(q, k, v, m_part, l_part, acc_part, batch_heads, hkv,
                           group, kv_bstride, length, rows_per_split, n_split,
                           scale, stream);
      break;
    case 64:
      dispatch_group<T, 2>(q, k, v, m_part, l_part, acc_part, batch_heads, hkv,
                           group, kv_bstride, length, rows_per_split, n_split,
                           scale, stream);
      break;
    case 128:
      dispatch_group<T, 4>(q, k, v, m_part, l_part, acc_part, batch_heads, hkv,
                           group, kv_bstride, length, rows_per_split, n_split,
                           scale, stream);
      break;
    default:  // 256, checked by the entry point
      dispatch_group<T, 8>(q, k, v, m_part, l_part, acc_part, batch_heads, hkv,
                           group, kv_bstride, length, rows_per_split, n_split,
                           scale, stream);
      break;
  }
}

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  float* m_part, float* l_part,
                                  float* acc_part, float* out, int batch,
                                  int hkv, int group, int dh,
                                  long long kv_bstride, int length,
                                  int rows_per_split, int n_split, float scale,
                                  int dtype, void* stream) {
  const bool dh_ok = dh == 32 || dh == 64 || dh == 128 || dh == 256;
  if (!dh_ok || group < 1 || group > 16 || group * dh > 2048 || batch < 1 ||
      hkv < 1 || length < 1 || rows_per_split < 1 || n_split < 1 ||
      n_split > 65535 ||
      static_cast<long long>(n_split - 1) * rows_per_split >= length ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int batch_heads = batch * hkv;
  if (dtype == 0) {
    dispatch_dh<float>(q, k, v, m_part, l_part, acc_part, batch_heads, hkv,
                       group, dh, kv_bstride, length, rows_per_split, n_split,
                       scale, s);
  } else {
    dispatch_dh<__nv_bfloat16>(q, k, v, m_part, l_part, acc_part, batch_heads,
                               hkv, group, dh, kv_bstride, length,
                               rows_per_split, n_split, scale, s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<<<batch_heads * group, dh, 0, s>>>(
      m_part, l_part, acc_part, out, group, dh, n_split);
  return static_cast<int>(cudaGetLastError());
}
