// Fused serving-decode attention for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel src/repro/kernels/attention_decode.py
// (_decode_kernel, launched by attention_decode_pallas). One launch per
// layer per decode step computes, for every slot row b:
//   (a) the KV ring append: new_k/new_v written in place into
//       k_cache/v_cache[b, slot] with slot = pos[b] % T (windowed) or
//       pos[b] (global), clamped into [0, T) as jax's
//       dynamic_update_slice clamps;
//   (b) the validity predicate from pos[b] alone (no mask tensor);
//   (c) grouped-query attention of the grp = H / Hkv query heads of one
//       KV head over the T cached keys, with scores, online softmax and
//       the probs.V sum all in f32; the output is written in q's dtype.
//
// What bounds it on this card: bytes. Each decode launch must read the
// K/V pool of its layer once (2 * B * T * Hkv * Dh elements) and does
// only 4 * H * Dh flops per cached key row, far below the ~20 flop/byte
// the f32 units need to be the limit. The design streams each K/V
// element from device memory exactly once, as 16-byte vector loads of
// whole rows into a shared-memory tile, and keeps scores, softmax state
// and the accumulator in shared memory, never in device memory. The
// appended row is written before the block reads its tile; the block is
// the only reader of its (b, kv head) column, so a __syncthreads()
// orders the write before the reads and the pool is updated in place.
//
// Simple on purpose: one block per (slot, kv head) and no overlap of a
// tile's loads with the previous tile's arithmetic. At 8 slots x 8 KV
// heads that fills 64 of 132 SMs; splitting T across blocks
// (flash-decoding), cp.async/TMA double buffering are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -2.0e38f;  // f32-safe mask value (= NEG_INF)
constexpr int kTileBytes = 16384;    // per operand (K or V) per tile
constexpr int kMaxTile = 64;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Python-style floor modulo (pos is never negative in serving, but the
// predicate must agree with the reference for any int32).
__device__ __forceinline__ int py_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// Key row k of a ring of length t holds absolute position k + wraps
// (k <= slot) or k + wraps - t (not yet overwritten this lap); it is
// valid iff that position lies in (pos - window, pos]. Global layers
// (window <= 0): k <= pos.
__device__ __forceinline__ bool key_valid(int k, int pos, int slot, int t,
                                          int window) {
  if (window <= 0) return k <= pos;
  int wraps = (pos - py_mod(pos, t));
  int a = k + (k <= slot ? wraps : wraps - t);
  return a >= 0 && a <= pos && a > pos - window;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid: B * Hkv blocks, block (b, kvh) = blockIdx.x / Hkv, % Hkv.
// q, out: [B, H, Dh]; new_k, new_v: [B, Hkv, Dh] (cache dtype);
// k_cache, v_cache: [B, T, Hkv, Dh]; pos: [B] int32.
template <typename QT, typename CT>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const QT* q, const CT* new_k, const CT* new_v, CT* k_cache,
              CT* v_cache, const int32_t* pos_vec, QT* out, int t, int h,
              int hkv, int dh, int window, int tile, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = h / hkv;
  // layout: ks, vs [tile * dh] CT | qs, acc [grp * dh] f32 |
  //         sc [grp * tile] f32 | m, l, alpha [grp] f32
  CT* ks = reinterpret_cast<CT*>(smem);
  CT* vs = ks + (size_t)tile * dh;
  float* qs = reinterpret_cast<float*>(vs + (size_t)tile * dh);
  float* acc = qs + grp * dh;
  float* sc = acc + grp * dh;
  float* m_s = sc + grp * tile;
  float* l_s = m_s + grp;
  float* alpha_s = l_s + grp;

  const int b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int pos = pos_vec[b];
  const int ring_slot = window > 0 ? py_mod(pos, t) : pos;
  const int slot = min(max(ring_slot, 0), t - 1);

  const size_t row_stride = (size_t)hkv * dh;  // elements between keys
  CT* kcol = k_cache + ((size_t)b * t * hkv + kvh) * dh;
  CT* vcol = v_cache + ((size_t)b * t * hkv + kvh) * dh;

  // (a) in-place ring append of this block's own (b, kvh) row.
  const CT* nk = new_k + ((size_t)b * hkv + kvh) * dh;
  const CT* nv = new_v + ((size_t)b * hkv + kvh) * dh;
  for (int d = tid; d < dh; d += kThreads) {
    kcol[(size_t)slot * row_stride + d] = nk[d];
    vcol[(size_t)slot * row_stride + d] = nv[d];
  }
  // the grp query heads of this KV head are contiguous in [H, Dh]
  const QT* qb = q + ((size_t)b * h + (size_t)kvh * grp) * dh;
  for (int i = tid; i < grp * dh; i += kThreads) {
    qs[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < grp; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();  // the append is visible to the tile loads below

  constexpr int kVec = 16 / sizeof(CT);  // elements per 16-byte load
  const int vec_per_row = dh / kVec;
  for (int t0 = 0; t0 < t; t0 += tile) {
    const int n = min(tile, t - t0);
    // load the K and V tiles: n rows of dh contiguous elements each
    for (int c = tid; c < n * vec_per_row; c += kThreads) {
      const int r = c / vec_per_row;
      const int j = (c - r * vec_per_row) * kVec;
      const size_t src = (size_t)(t0 + r) * row_stride + j;
      *reinterpret_cast<uint4*>(ks + (size_t)r * dh + j) =
          *reinterpret_cast<const uint4*>(kcol + src);
      *reinterpret_cast<uint4*>(vs + (size_t)r * dh + j) =
          *reinterpret_cast<const uint4*>(vcol + src);
    }
    __syncthreads();

    // scores: one warp per key row, lanes split the head dim
    for (int r = warp; r < n; r += kWarps) {
      const bool ok = key_valid(t0 + r, pos, ring_slot, t, window);
      for (int g = 0; g < grp; ++g) {
        float s = 0.f;
        for (int d = lane; d < dh; d += 32)
          s += qs[g * dh + d] * to_f32(ks[(size_t)r * dh + d]);
        s = warp_sum(s);
        if (lane == 0) sc[g * tile + r] = ok ? s * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < grp; g += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sc[g * tile + r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const bool ok = key_valid(t0 + r, pos, ring_slot, t, window);
        const float p = ok ? expf(sc[g * tile + r] - m_new) : 0.f;
        sc[g * tile + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // probs . V into the f32 accumulator (each thread owns its entries)
    for (int i = tid; i < grp * dh; i += kThreads) {
      const int g = i / dh;
      const int d = i - g * dh;
      float a = acc[i] * alpha_s[g];
      const float* p = sc + g * tile;
      for (int r = 0; r < n; ++r) a += p[r] * to_f32(vs[(size_t)r * dh + d]);
      acc[i] = a;
    }
    __syncthreads();  // tiles, probs and alpha are rewritten next round
  }

  QT* ob = out + ((size_t)b * h + (size_t)kvh * grp) * dh;
  for (int i = tid; i < grp * dh; i += kThreads)
    ob[i] = from_f32<QT>(acc[i] / l_s[i / dh]);
}

template <typename CT>
int tile_rows(int t, int dh) {
  int tile = kTileBytes / (dh * (int)sizeof(CT));
  tile = tile < 1 ? 1 : (tile > kMaxTile ? kMaxTile : tile);
  return tile < t ? tile : t;
}

template <typename QT, typename CT>
int launch(const void* q, const void* new_k, const void* new_v,
           void* k_cache, void* v_cache, const void* pos, void* out, int b,
           int t, int h, int hkv, int dh, int window, cudaStream_t stream) {
  const int grp = h / hkv;
  const int tile = tile_rows<CT>(t, dh);
  const size_t smem = 2 * (size_t)tile * dh * sizeof(CT) +
                      (2 * (size_t)grp * dh + (size_t)grp * tile +
                       3 * (size_t)grp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<QT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)dh);
  decode_kernel<QT, CT><<<b * hkv, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(new_k),
      static_cast<const CT*>(new_v), static_cast<CT*>(k_cache),
      static_cast<CT*>(v_cache), static_cast<const int32_t*>(pos),
      static_cast<QT*>(out), t, h, hkv, dh, window, tile, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. window <= 0 means a global
// layer. Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for an unsupported dtype pair.
extern "C" int repro_attention_decode(const void* q, const void* new_k,
                                      const void* new_v, void* k_cache,
                                      void* v_cache, const void* pos,
                                      void* out, int q_dtype, int c_dtype,
                                      int b, int t, int h, int hkv, int dh,
                                      int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && c_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, new_k, new_v, k_cache, v_cache, pos, out, b, t, h, hkv, dh,
        window, s);
  if (q_dtype == 0 && c_dtype == 0)
    return launch<float, float>(q, new_k, new_v, k_cache, v_cache, pos, out,
                                b, t, h, hkv, dh, window, s);
  if (q_dtype == 1 && c_dtype == 0)
    return launch<__nv_bfloat16, float>(q, new_k, new_v, k_cache, v_cache,
                                        pos, out, b, t, h, hkv, dh, window,
                                        s);
  if (q_dtype == 0 && c_dtype == 1)
    return launch<float, __nv_bfloat16>(q, new_k, new_v, k_cache, v_cache,
                                        pos, out, b, t, h, hkv, dh, window,
                                        s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one launch needs, so the wrapper can refuse shapes
// beyond the 227 KB a block may use before launching.
extern "C" long long repro_attention_decode_smem(int c_dtype, int t, int h,
                                                 int hkv, int dh) {
  const int grp = h / hkv;
  const int csize = c_dtype == 1 ? 2 : 4;
  const int tile = c_dtype == 1 ? tile_rows<__nv_bfloat16>(t, dh)
                                : tile_rows<float>(t, dh);
  return 2LL * tile * dh * csize +
         (2LL * grp * dh + (long long)grp * tile + 3LL * grp) * 4;
}
