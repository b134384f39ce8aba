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
//       KV head over the cached keys, with scores, online softmax and
//       the probs.V sum all in f32; the output is written in q's dtype.
//
// The partial mode (a cache split over T across the ranks of a model
// row): the cache holds keys [t0, t0 + T) of a sequence of tg keys.
// Positions, the ring's slot and the mask use the global key index
// t0 + k, the append lands only where its global slot falls in the
// block, and the launch also writes lse = m + log(l) per (row, query
// head), f32, so the ranks can merge their outputs. A row with no
// needed key in the block reads no K/V and returns out = 0, lse = -inf.
// With t0 = 0 and tg = T the launch is the unsplit one.
//
// What bounds it on this card: bytes. A launch must read the valid K/V
// rows of its layer once and does only 4 * grp * Dh flops per key row
// and KV head, far below what the f32 units need to be the limit. The
// design is about how many bytes are in flight, how many are needed and
// how many SMs ask for them:
//
// * Keys split across blocks (flash-decoding). The grid is
//   (B * Hkv * head groups) x S splits of L keys. L depends on T, Dh and
//   the cache dtype only (kernels/attention_decode.py::decode_plan), so
//   a row's result does not depend on how many rows share the launch.
// * Stop at the last valid key. Global layers need k <= pos, a ring with
//   pos < T needs k <= pos, otherwise every key. A split wholly past that
//   key writes an empty partial (m = NEG_INF, l = 0) and reads no K/V;
//   inside a split the row loop ends there. The per-key predicate stays
//   for windows shorter than the ring.
// * Bytes in flight. Each warp owns key rows a chunk at a time (kRows
//   rows, kChunkBytes of K and as many of V at Dh 256; the warp's chunks
//   are interleaved over the split) and keeps a ring of kStages chunks
//   in shared memory, filled by cp.async 16-byte copies
//   (cp.async rather than TMA: a chunk is kRows rows of one KV head,
//   strided by Hkv * Dh in the cache, which needs no tensor map, and
//   every lane copies exactly the 16-byte pieces it later reads, so no
//   barrier or mbarrier orders the ring). The next chunks load while the
//   current one is computed.
// * Few barriers. A lane holds its 16-byte pieces of q and of the f32
//   accumulator for the G query heads of the block in registers, with
//   the running m and l; a warp reduces a chunk's kRows * G scores
//   together with shuffles only (warp_sums). The warps merge in fixed
//   order at the end of the split (two barriers).
// * Deterministic combine in the same launch. Each split writes its f32
//   partial (m, l, acc[G, Dh]) to a workspace; the last block of a
//   (b, kv head, head group) to arrive, on an integer ticket taken after
//   __threadfence(), merges the partials in split order and resets the
//   ticket to 0 for the next launch. No float atomics.
// * The append. The head-group-0 block whose split holds the write slot
//   writes the new row; no block reads that row from the cache: every
//   reader of key `slot` copies it from new_k/new_v instead, so nothing
//   has to order the write before the reads and the updated caches equal
//   the plain version's bit for bit.
//
// What holds it back (H100 80GB HBM3 at 700 W, tools/decode_sweep.py):
// the chunk ring alone, with the arithmetic taken out, moves the K/V
// bytes at about 55% of the memory rate in bf16 and 65% in f32; the
// kernel runs within about 10% of that, so a faster kernel needs more
// bytes in flight per SM (TMA bulk copies, deeper rings), not less math.
//
// Two more modes serve a cache split over the head dim (cache_pspecs'
// Dh fallback: the model axis divides neither the KV heads nor T, e.g.
// whisper-large-v3's 20 heads and 1500 cross frames at model 8). A rank
// holds Dl = Dh / M of every KV head's dims, so its scores are partial
// sums the model row must add before the softmax; the caller sums them
// between the two launches:
//   scores_kernel: the append of the rank's block of new_k / new_v at
//     the row's slot (same slot, ring and clamp rules as above; readers
//     of key `slot` take it from new_k), then s[b, h, k] = q[b, h, blk] .
//     K[b, k, kv(h), blk] in f32 for every key up to the row's last
//     needed key, and 0 past it (no K byte past that key is read). One
//     thread a key, the G query heads of a block in turn, so the writes
//     of s are coalesced along T.
//   apply_kernel: from the summed s, the mask from pos, the scale of the
//     WHOLE head dim (1 / sqrt(Dh), passed in), an f32 softmax over T
//     (block-wide max and sum in a fixed order) and probs . V over the
//     block, written in the output dtype. Threads are (16-byte piece of
//     a V row, key lane); the key lanes' sums are added in lane order.
// A block of the dims may be as narrow as one element (whisper's 8 at
// model 8, 4 in the smoke configs): rows are read with 16-byte loads
// where the row's bytes and the caches' addresses are multiples of 16,
// else one element at a time (the wrapper's piece_bytes), never by the
// plain version. Both modes are bound by bytes on this card: the scores mode
// reads B * T * Hkv * Dl cache elements and writes B * H * T f32 scores
// (a Dl of 8 in bf16 writes 2 * G times the bytes it reads), the apply
// mode reads those scores and the V block; each does 2 * G * Dl flops a
// key and KV head. They are written to be right, not fast: a thread
// reads its own key row, and a launch of few rows is a handful of
// blocks, so it is latency-bound (chip_smoke.py phase 21 times both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;           // ring depth of each warp's K/V chunks
constexpr int kChunkBytes = 1024;    // K bytes of one chunk: 2 bf16 rows of
                                     // 256, 1 f32 row
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -2.0e38f;  // f32-safe mask value (= NEG_INF)

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

// 16 bytes of a cache row as f32 values (4 f32 or 8 bf16).
__device__ __forceinline__ void unpack16(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// 16-byte global -> shared copy; fill == false writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Python-style floor modulo (pos is never negative in serving, but the
// predicate must agree with the reference for any int32).
__device__ __forceinline__ int py_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// Key row k (a global index) of a ring of length t holds absolute
// position k + wraps (k <= slot) or k + wraps - t (not yet overwritten
// this lap), with wraps = pos - pos mod t; it is valid iff that position
// lies in (pos - window, pos]. Global layers (window <= 0): k <= pos.
__device__ __forceinline__ bool key_valid(int k, int pos, int slot,
                                          int wraps, int t, int window) {
  if (window <= 0) return k <= pos;
  int a = k + (k <= slot ? wraps : wraps - t);
  return a >= 0 && a <= pos && a > pos - window;
}

// The warp sums of N per-lane values (N a power of two up to 32), in a
// fixed order, returned to every lane in v. The values are halved
// between lane pairs at offsets 16, 8, ... until each lane carries one
// (N - 1 shuffles), summed over the remaining offsets, then each sum is
// read from a lane that holds it (N shuffles): 2N + 4 - log2(N) shuffles
// where N separate butterflies take 5N.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "power of two");
  int off = 16;
#pragma unroll
  for (int n = N; n > 1; n >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float sum = v[0];
#pragma unroll
  for (; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  // lane l holds the sum of value i where i's bits, most significant
  // first, are l's bits at offsets 16, 8, ...
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int src = 0;
#pragma unroll
    for (int b = N >> 1, o = 16; b > 0; b >>= 1, o >>= 1)
      if (i & b) src |= o;
    v[i] = __shfl_sync(0xffffffffu, sum, src);
  }
}

// key rows in one chunk
template <typename CT> __host__ __device__ constexpr int chunk_rows() {
  return kChunkBytes / (kMaxHeadDim * (int)sizeof(CT));
}

size_t smem_bytes(int csize, int dh, int g) {
  const int rows = csize == 2 ? chunk_rows<__nv_bfloat16>()
                              : chunk_rows<float>();
  const size_t ring = (size_t)kWarps * kStages * rows * 2 * dh * csize;
  const size_t merge = ((size_t)2 * kWarps * g + (size_t)kWarps * g * dh) *
                       sizeof(float);
  return ring > merge ? ring : merge;
}

// grid: (B * Hkv * Hg, S); block x = (b * Hkv + kvh) * Hg + hg covers the
// G query heads hg*G .. hg*G+G-1 of KV head kvh, block y = split.
// q, out: [B, H, Dh]; new_k, new_v: [B, Hkv, Dh] (cache dtype); k_cache,
// v_cache: [B, T, Hkv, Dh], keys [t0, t0 + T) of tg; pos: [B] int32; ws:
// [B*Hkv*Hg, S, 2G + G*Dh] f32; tickets: [B*Hkv*Hg] u32, 0 between
// launches; lse: [B, H] f32 or null.
template <typename QT, typename CT, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const QT* __restrict__ q, const CT* __restrict__ new_k,
              const CT* __restrict__ new_v, CT* k_cache, CT* v_cache,
              const int32_t* __restrict__ pos_vec, QT* __restrict__ out,
              float* __restrict__ ws, unsigned* __restrict__ tickets,
              float* __restrict__ lse, int t, int t0, int tg, int h, int hkv,
              int dh, int window, int keys, int splits, float scale) {
  constexpr int kVec = 16 / sizeof(CT);          // elements in 16 bytes
  constexpr int kLane = kMaxHeadDim / kVec / 32;  // 16-byte pieces a lane
  constexpr int kRows = chunk_rows<CT>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool is_last;

  const int grp = h / hkv;
  const int hgroups = grp / G;
  const int bkg = blockIdx.x;
  const int hg = bkg % hgroups;
  const int b = bkg / hgroups / hkv;
  const int kvh = bkg / hgroups % hkv;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int pos = pos_vec[b];
  const int ring_slot = window > 0 ? py_mod(pos, tg) : pos;   // global
  const int wraps = pos - ring_slot;   // ring layers: laps before this one
  // the write slot in this block's rows (outside [0, t): another block's)
  const int slot = min(max(ring_slot, 0), tg - 1) - t0;
  // the last key of this block the row needs (negative: none)
  const int last =
      (window > 0 ? (pos < tg ? pos : tg - 1) : min(pos, tg - 1)) - t0;

  const size_t row_stride = (size_t)hkv * dh;  // elements between keys
  CT* kcol = k_cache + ((size_t)b * t * hkv + kvh) * dh;
  CT* vcol = v_cache + ((size_t)b * t * hkv + kvh) * dh;
  const CT* nk = new_k + ((size_t)b * hkv + kvh) * dh;
  const CT* nv = new_v + ((size_t)b * hkv + kvh) * dh;

  const int s0 = split * keys;
  const int s1 = min(s0 + keys, t);
  // (a) the append, by one block of the (b, kvh) column
  if (hg == 0 && slot >= s0 && slot < s1) {
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      kcol[(size_t)slot * row_stride + d] = nk[d];
      vcol[(size_t)slot * row_stride + d] = nv[d];
    }
  }

  const int stride = 2 * G + G * dh;  // floats of one partial
  float* part = ws + ((size_t)bkg * splits + split) * stride;
  const int e = min(s1, last + 1);    // this split's keys: [s0, e)
  if (e > s0) {
    const int pieces = dh / kVec;     // 16-byte pieces of a row
    const int row_bytes = dh * (int)sizeof(CT);
    const QT* qb =
        q + ((size_t)b * h + (size_t)kvh * grp + (size_t)hg * G) * dh;
    float qr[G][kLane][kVec], acc[G][kLane][kVec], m[G], l[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kLane; ++j) {
        const int c = lane + 32 * j;
#pragma unroll
        for (int x = 0; x < kVec; ++x) {
          qr[g][j][x] = c < pieces ? to_f32(qb[g * dh + c * kVec + x]) : 0.f;
          acc[g][j][x] = 0.f;
        }
      }
    }

    // this warp's ring: kStages x kRows x (K row, V row)
    unsigned char* ring =
        smem + (size_t)warp * kStages * kRows * 2 * row_bytes;
    const int chunks = (e - s0 + kRows - 1) / kRows;
    const int mine =
        chunks > warp ? (chunks - warp + kWarps - 1) / kWarps : 0;
    auto stage = [&](int i) {   // chunk i of this warp: K, V rows in turn
      return ring + (size_t)(i % kStages) * kRows * 2 * row_bytes;
    };

    // the i-th chunk of this warp into its stage (an empty group past
    // the end keeps the wait count uniform)
    auto issue = [&](int i) {
      if (i < mine) {
        const int r0 = s0 + (warp + i * kWarps) * kRows;
        unsigned char* st = stage(i);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int k = r0 + r;
          const bool ok = k < e;
          const size_t off = (size_t)(ok ? k : s0) * row_stride;
          const CT* ks = k == slot ? nk : kcol + off;
          const CT* vs = k == slot ? nv : vcol + off;
#pragma unroll
          for (int j = 0; j < kLane; ++j) {
            const int c = lane + 32 * j;
            if (c < pieces) {
              cp_async16(st + (size_t)(2 * r) * row_bytes + c * 16,
                         ks + c * kVec, ok);
              cp_async16(st + (size_t)(2 * r + 1) * row_bytes + c * 16,
                         vs + c * kVec, ok);
            }
          }
        }
      }
      cp_async_commit();
    };

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    for (int i = 0; i < mine; ++i) {
      issue(i + kStages - 1);
      cp_async_wait<kStages - 1>();   // this lane's pieces of chunk i
      const unsigned char* st = stage(i);
      const int r0 = s0 + (warp + i * kWarps) * kRows;
      float s[kRows * G];   // scores, row-major
      bool valid[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float kv[kLane][kVec];
#pragma unroll
        for (int j = 0; j < kLane; ++j) {
          const int c = lane + 32 * j;
          if (c < pieces) {
            unpack16(reinterpret_cast<const CT*>(
                         st + (size_t)(2 * r) * row_bytes + c * 16), kv[j]);
          } else {
#pragma unroll
            for (int x = 0; x < kVec; ++x) kv[j][x] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < kLane; ++j)
#pragma unroll
            for (int x = 0; x < kVec; ++x) dot += qr[g][j][x] * kv[j][x];
          s[r * G + g] = dot;
        }
        const int k = r0 + r;
        valid[r] =
            k < e && key_valid(t0 + k, pos, ring_slot, wraps, tg, window);
      }
      warp_sums<kRows * G>(s, lane);
      // online softmax over the chunk's rows
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r * G + g] *= scale;
          if (valid[r]) mx = fmaxf(mx, s[r * G + g]);
        }
        const float alpha = expf(m[g] - mx);
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = valid[r] ? expf(s[r * G + g] - mx) : 0.f;
          s[r * G + g] = p;
          sum += p;
        }
        l[g] = l[g] * alpha + sum;
        m[g] = mx;
#pragma unroll
        for (int j = 0; j < kLane; ++j)
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc[g][j][x] *= alpha;
      }
      // probs . V
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float vv[kLane][kVec];
#pragma unroll
        for (int j = 0; j < kLane; ++j) {
          const int c = lane + 32 * j;
          if (c < pieces) {
            unpack16(reinterpret_cast<const CT*>(
                         st + (size_t)(2 * r + 1) * row_bytes + c * 16),
                     vv[j]);
          } else {
#pragma unroll
            for (int x = 0; x < kVec; ++x) vv[j][x] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int j = 0; j < kLane; ++j)
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              acc[g][j][x] += s[r * G + g] * vv[j][x];
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with its ring: the merge reuses it

    // merge the warps in order 0..kWarps-1 into this split's partial
    float* mw = reinterpret_cast<float*>(smem);
    float* lw = mw + kWarps * G;
    float* aw = lw + kWarps * G;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        mw[warp * G + g] = m[g];
        lw[warp * G + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < kLane; ++j) {
        const int c = lane + 32 * j;
        if (c < pieces) {
#pragma unroll
          for (int x = 0; x < kVec; ++x)
            aw[(size_t)(warp * G + g) * dh + c * kVec + x] = acc[g][j][x];
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * dh; i += kThreads) {
      const int g = i / dh;
      const int d = i - g * dh;
      float mm = kNegInf;
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, mw[w * G + g]);
      float ll = 0.f, a = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(mw[w * G + g] - mm);
        ll += lw[w * G + g] * f;
        a += aw[(size_t)(w * G + g) * dh + d] * f;
      }
      if (d == 0) {
        part[g] = mm;
        part[G + g] = ll;
      }
      part[2 * G + i] = a;
    }
  } else if (threadIdx.x < G) {
    part[threadIdx.x] = kNegInf;   // an empty partial: no K/V read
    part[G + threadIdx.x] = 0.f;
  }

  // the last split of this (b, kvh, hg) to arrive combines them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(tickets + bkg, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[bkg] = 0u;   // ready for the next launch
  const float* base = ws + (size_t)bkg * splits * stride;
  QT* ob = out + ((size_t)b * h + (size_t)kvh * grp + (size_t)hg * G) * dh;
  for (int i = threadIdx.x; i < G * dh; i += kThreads) {
    const int g = i / dh;
    float mm = kNegInf;
    for (int sp = 0; sp < splits; ++sp) {
      const float* p = base + (size_t)sp * stride;
      if (__ldcg(p + G + g) > 0.f) mm = fmaxf(mm, __ldcg(p + g));
    }
    float ll = 0.f, a = 0.f;
    for (int sp = 0; sp < splits; ++sp) {   // in split order; empty skipped
      const float* p = base + (size_t)sp * stride;
      const float lp = __ldcg(p + G + g);
      if (lp > 0.f) {
        const float f = expf(__ldcg(p + g) - mm);
        ll += lp * f;
        a += __ldcg(p + 2 * G + i) * f;
      }
    }
    // a row with no needed key in this block: out 0, lse -inf (no 0 / 0)
    ob[i] = from_f32<QT>(ll > 0.f ? a / ll : 0.f);
    if (lse != nullptr && i - g * dh == 0)
      lse[(size_t)b * h + (size_t)kvh * grp + (size_t)hg * G + g] =
          ll > 0.f ? mm + logf(ll) : -INFINITY;
  }
}

template <typename QT, typename CT, int G>
int launch(const void* q, const void* new_k, const void* new_v,
           void* k_cache, void* v_cache, const void* pos, void* out,
           void* ws, void* tickets, void* lse, int b, int t, int t0, int tg,
           int h, int hkv, int dh, int window, int keys, int splits,
           cudaStream_t stream) {
  // the shared-memory opt-in, once per device and instantiation
  static size_t granted[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes((int)sizeof(CT), dh, G);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (granted[dev] < smem) {
    e = cudaFuncSetAttribute(decode_kernel<QT, CT, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted[dev] = smem;
  }
  const float scale = 1.0f / sqrtf((float)dh);
  const dim3 grid((unsigned)(b * hkv * (h / hkv / G)), (unsigned)splits);
  decode_kernel<QT, CT, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(new_k),
      static_cast<const CT*>(new_v), static_cast<CT*>(k_cache),
      static_cast<CT*>(v_cache), static_cast<const int32_t*>(pos),
      static_cast<QT*>(out), static_cast<float*>(ws),
      static_cast<unsigned*>(tickets), static_cast<float*>(lse), t, t0, tg,
      h, hkv, dh, window, keys, splits, scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT>
int launch_g(int g, const void* q, const void* new_k, const void* new_v,
             void* k_cache, void* v_cache, const void* pos, void* out,
             void* ws, void* tickets, void* lse, int b, int t, int t0,
             int tg, int h, int hkv, int dh, int window, int keys,
             int splits, cudaStream_t s) {
#define REPRO_DECODE_G(N)                                                   \
  case N:                                                                   \
    return launch<QT, CT, N>(q, new_k, new_v, k_cache, v_cache, pos, out,   \
                             ws, tickets, lse, b, t, t0, tg, h, hkv, dh,    \
                             window, keys, splits, s);
  switch (g) {
    REPRO_DECODE_G(1)
    REPRO_DECODE_G(2)
    REPRO_DECODE_G(4)
    REPRO_DECODE_G(8)
  }
#undef REPRO_DECODE_G
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// The head-dim split: the scores and apply modes.

constexpr int kScoreThreads = 128;   // keys of one scores block
constexpr int kApplyThreads = 256;

// W bytes of a cache row (16, or one element) as f32.
template <typename CT, int W>
__device__ __forceinline__ void load_piece(const CT* p, float* f) {
  if constexpr (W == 16) {
    unpack16(p, f);
  } else {
    static_assert(W == (int)sizeof(CT), "16 bytes or one element");
    f[0] = to_f32(*p);
  }
}

// The block's max (kMax) or sum of one value a thread, in a fixed order
// (warp butterflies, then the warps in order), returned to every thread.
// red holds a float per warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  __syncthreads();   // every thread is done reading red's last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// grid: (B * Hkv * Hg, ceil(T / kScoreThreads)); block x as decode_kernel's
// (the G query heads hg*G .. of KV head kvh of row b), thread = one key.
// q: [B, H, Dl] (q_dtype); new_k, new_v: [B, Hkv, Dl]; caches [B, T, Hkv,
// Dl]; s: [B, H, T] f32.
template <typename CT, int G, int W>
__global__ void __launch_bounds__(kScoreThreads)
scores_kernel(const void* __restrict__ q, int q_dtype,
              const CT* __restrict__ new_k, const CT* __restrict__ new_v,
              CT* k_cache, CT* v_cache, const int32_t* __restrict__ pos_vec,
              float* __restrict__ s, int t, int h, int hkv, int dl,
              int window) {
  constexpr int kN = W / (int)sizeof(CT);
  extern __shared__ __align__(16) float qs[];   // [G][Dl] f32
  const int grp = h / hkv;
  const int hgroups = grp / G;
  const int bkg = blockIdx.x;
  const int hg = bkg % hgroups;
  const int kvh = bkg / hgroups % hkv;
  const int b = bkg / hgroups / hkv;
  const int h0 = kvh * grp + hg * G;

  const int pos = pos_vec[b];
  const int ring_slot = window > 0 ? py_mod(pos, t) : pos;
  const int slot = min(max(ring_slot, 0), t - 1);
  const int last = window > 0 ? (pos < t ? pos : t - 1) : min(pos, t - 1);
  const size_t row_stride = (size_t)hkv * dl;
  CT* kcol = k_cache + ((size_t)b * t * hkv + kvh) * dl;
  CT* vcol = v_cache + ((size_t)b * t * hkv + kvh) * dl;
  const CT* nk = new_k + ((size_t)b * hkv + kvh) * dl;
  const CT* nv = new_v + ((size_t)b * hkv + kvh) * dl;

  const int k0 = blockIdx.y * kScoreThreads;
  // the append, by the head-group-0 block whose keys hold the slot
  if (hg == 0 && slot >= k0 && slot < k0 + kScoreThreads) {
    for (int d = threadIdx.x; d < dl; d += kScoreThreads) {
      kcol[(size_t)slot * row_stride + d] = nk[d];
      vcol[(size_t)slot * row_stride + d] = nv[d];
    }
  }
  const size_t q0 = ((size_t)b * h + h0) * dl;
  for (int i = threadIdx.x; i < G * dl; i += kScoreThreads)
    qs[i] = q_dtype == 1
                ? __bfloat162float(
                      static_cast<const __nv_bfloat16*>(q)[q0 + i])
                : static_cast<const float*>(q)[q0 + i];
  __syncthreads();

  const int k = k0 + threadIdx.x;
  if (k >= t) return;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  if (k <= last) {
    const CT* row = k == slot ? nk : kcol + (size_t)k * row_stride;
    for (int c = 0; c < dl; c += kN) {
      float f[kN];
      load_piece<CT, W>(row + c, f);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int x = 0; x < kN; ++x) acc[g] += qs[g * dl + c + x] * f[x];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) s[((size_t)b * h + h0 + g) * t + k] = acc[g];
}

// grid: B * Hkv * Hg blocks (as scores_kernel's x). s: [B, H, T] f32, the
// row's summed scores; v_cache: [B, T, Hkv, Dl]; out: [B, H, Dl] in
// out_dtype.
template <typename CT, int G, int W>
__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(const float* __restrict__ s, const CT* __restrict__ v_cache,
             const int32_t* __restrict__ pos_vec, void* __restrict__ out,
             int out_dtype, int t, int h, int hkv, int dl, int window,
             float scale) {
  constexpr int kN = W / (int)sizeof(CT);
  extern __shared__ __align__(16) float part[];   // [key lanes][Dl]
  __shared__ float red[kApplyThreads / 32];
  __shared__ float m_s[G], l_s[G];
  const int grp = h / hkv;
  const int hgroups = grp / G;
  const int bkg = blockIdx.x;
  const int hg = bkg % hgroups;
  const int kvh = bkg / hgroups % hkv;
  const int b = bkg / hgroups / hkv;
  const int h0 = kvh * grp + hg * G;

  const int pos = pos_vec[b];
  const int ring_slot = window > 0 ? py_mod(pos, t) : pos;
  const int wraps = pos - ring_slot;
  const int last = window > 0 ? (pos < t ? pos : t - 1) : min(pos, t - 1);
  const float* sb = s + ((size_t)b * h + h0) * t;

  // the softmax's max and sum over the valid keys, a head at a time
  for (int g = 0; g < G; ++g) {
    float mx = kNegInf;
    for (int k = threadIdx.x; k <= last; k += kApplyThreads)
      if (key_valid(k, pos, ring_slot, wraps, t, window))
        mx = fmaxf(mx, sb[(size_t)g * t + k] * scale);
    mx = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int k = threadIdx.x; k <= last; k += kApplyThreads)
      if (key_valid(k, pos, ring_slot, wraps, t, window))
        sum += expf(sb[(size_t)g * t + k] * scale - mx);
    sum = block_reduce<false>(sum, red);
    if (threadIdx.x == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // probs . V: thread (piece c of a row, key lane j)
  const int pieces = dl / kN;
  const int lanes = kApplyThreads / pieces;
  const int c = threadIdx.x % pieces;
  const int j = threadIdx.x / pieces;
  const size_t row_stride = (size_t)hkv * dl;
  const CT* vcol = v_cache + ((size_t)b * t * hkv + kvh) * dl + c * kN;
  float acc[G][kN];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int x = 0; x < kN; ++x) acc[g][x] = 0.f;
  if (j < lanes) {
    for (int k = j; k <= last; k += lanes) {
      if (!key_valid(k, pos, ring_slot, wraps, t, window)) continue;
      float f[kN];
      load_piece<CT, W>(vcol + (size_t)k * row_stride, f);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(sb[(size_t)g * t + k] * scale - m_s[g]);
#pragma unroll
        for (int x = 0; x < kN; ++x) acc[g][x] += p * f[x];
      }
    }
  }
  // the key lanes' sums added in lane order, a head at a time
#pragma unroll
  for (int g = 0; g < G; ++g) {
    __syncthreads();
    if (j < lanes) {
#pragma unroll
      for (int x = 0; x < kN; ++x)
        part[(size_t)j * dl + c * kN + x] = acc[g][x];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < dl; i += kApplyThreads) {
      float a = 0.f;
      for (int jj = 0; jj < lanes; ++jj) a += part[(size_t)jj * dl + i];
      const float v = l_s[g] > 0.f ? a / l_s[g] : 0.f;
      const size_t o = ((size_t)b * h + h0 + g) * dl + i;
      if (out_dtype == 1)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
}

struct ModeArgs {
  const void* q;      // scores: q; apply: unused
  const void* new_k;
  const void* new_v;
  void* k_cache;      // scores: both caches; apply: v_cache only
  void* v_cache;
  const void* pos;
  void* s;
  void* out;
  int dtype;          // scores: q's dtype code; apply: the output's
  int b, t, h, hkv, dl, window;
  float scale;
  cudaStream_t stream;
};

template <typename CT, int G, int W>
int run_mode(const ModeArgs& a, bool scores) {
  const unsigned blocks = (unsigned)(a.b * a.hkv * (a.h / a.hkv / G));
  if (scores) {
    const dim3 grid(blocks,
                    (unsigned)((a.t + kScoreThreads - 1) / kScoreThreads));
    scores_kernel<CT, G, W>
        <<<grid, kScoreThreads, (size_t)G * a.dl * sizeof(float),
           a.stream>>>(a.q, a.dtype, static_cast<const CT*>(a.new_k),
                       static_cast<const CT*>(a.new_v),
                       static_cast<CT*>(a.k_cache),
                       static_cast<CT*>(a.v_cache),
                       static_cast<const int32_t*>(a.pos),
                       static_cast<float*>(a.s), a.t, a.h, a.hkv, a.dl,
                       a.window);
  } else {
    constexpr int kN = W / (int)sizeof(CT);
    const int lanes = kApplyThreads / (a.dl / kN);
    apply_kernel<CT, G, W>
        <<<blocks, kApplyThreads, (size_t)lanes * a.dl * sizeof(float),
           a.stream>>>(static_cast<const float*>(a.s),
                       static_cast<const CT*>(a.v_cache),
                       static_cast<const int32_t*>(a.pos), a.out, a.dtype,
                       a.t, a.h, a.hkv, a.dl, a.window, a.scale);
  }
  return (int)cudaGetLastError();
}

// 16-byte loads where a row's bytes and the addresses allow them, else
// one element at a time (two instantiations a mode, not four: the build
// time of the whole source is the script's)
template <typename CT, int G>
int mode_w(const ModeArgs& a, int w, bool scores) {
  if (w == 16) return run_mode<CT, G, 16>(a, scores);
  if (w == (int)sizeof(CT)) return run_mode<CT, G, (int)sizeof(CT)>(a, scores);
  return (int)cudaErrorInvalidValue;
}

template <typename CT>
int mode_g(const ModeArgs& a, int g, int w, bool scores) {
  switch (g) {
    case 1:
      return mode_w<CT, 1>(a, w, scores);
    case 2:
      return mode_w<CT, 2>(a, w, scores);
    case 4:
      return mode_w<CT, 4>(a, w, scores);
    case 8:
      return mode_w<CT, 8>(a, w, scores);
  }
  return (int)cudaErrorInvalidValue;
}

int run_block_mode(const ModeArgs& a, int c_dtype, int heads, int piece,
                   bool scores) {
  const int csize = c_dtype == 1 ? 2 : 4;
  if (a.b < 1 || a.t < 1 || a.hkv < 1 || a.h % a.hkv || heads < 1 ||
      (a.h / a.hkv) % heads || a.dl < 1 || a.dl > kMaxHeadDim ||
      piece < csize || (a.dl * csize) % piece || (a.dtype != 0 &&
      a.dtype != 1) || (c_dtype != 0 && c_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (c_dtype == 1) return mode_g<__nv_bfloat16>(a, heads, piece, scores);
  return mode_g<float>(a, heads, piece, scores);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. window <= 0 means a global
// layer. keys / splits / heads are the plan of
// kernels/attention_decode.py::decode_plan (L, S, G) for the block's T.
// The cache holds keys [t0, t0 + t) of tg (t0 = 0, tg = t: the whole
// sequence); lse is a [B, H] f32 output, or null. Returns
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for operands or a plan the kernel does not take.
extern "C" int repro_attention_decode(const void* q, const void* new_k,
                                      const void* new_v, void* k_cache,
                                      void* v_cache, const void* pos,
                                      void* out, void* ws, void* tickets,
                                      void* lse, int q_dtype, int c_dtype,
                                      int b, int t, int t0, int tg, int h,
                                      int hkv, int dh, int window, int keys,
                                      int splits, int heads, void* stream) {
  const int csize = c_dtype == 1 ? 2 : 4;
  if (b < 1 || t < 1 || t0 < 0 || tg < t0 + t || hkv < 1 || h % hkv ||
      heads < 1 || (h / hkv) % heads || dh < 1 || dh > kMaxHeadDim ||
      (dh * csize) % 16 || keys < 1 || splits != (t + keys - 1) / keys)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && c_dtype == 1)
    return launch_g<__nv_bfloat16, __nv_bfloat16>(
        heads, q, new_k, new_v, k_cache, v_cache, pos, out, ws, tickets, lse,
        b, t, t0, tg, h, hkv, dh, window, keys, splits, s);
  if (q_dtype == 0 && c_dtype == 0)
    return launch_g<float, float>(heads, q, new_k, new_v, k_cache, v_cache,
                                  pos, out, ws, tickets, lse, b, t, t0, tg, h,
                                  hkv, dh, window, keys, splits, s);
  if (q_dtype == 1 && c_dtype == 0)
    return launch_g<__nv_bfloat16, float>(
        heads, q, new_k, new_v, k_cache, v_cache, pos, out, ws, tickets, lse,
        b, t, t0, tg, h, hkv, dh, window, keys, splits, s);
  if (q_dtype == 0 && c_dtype == 1)
    return launch_g<float, __nv_bfloat16>(
        heads, q, new_k, new_v, k_cache, v_cache, pos, out, ws, tickets, lse,
        b, t, t0, tg, h, hkv, dh, window, keys, splits, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block takes (the K/V rings, or the warps'
// merge area when that is larger), so the wrapper's plan can be held
// against the kernel's own count.
extern "C" long long repro_attention_decode_smem(int c_dtype, int dh,
                                                 int heads) {
  return (long long)smem_bytes(c_dtype == 1 ? 2 : 4, dh, heads);
}

// The head-dim split's scores mode: q [B, H, Dl] (q_dtype), new_k / new_v
// [B, Hkv, Dl] and the caches [B, T, Hkv, Dl] (c_dtype, updated in place),
// pos [B] int32, s [B, H, T] f32 out. heads = G a block; piece = the load
// width in bytes (16, 8, 4 or 2, dividing Dl's bytes and the addresses).
extern "C" int repro_attention_decode_scores(
    const void* q, const void* new_k, const void* new_v, void* k_cache,
    void* v_cache, const void* pos, void* s, int q_dtype, int c_dtype, int b,
    int t, int h, int hkv, int dl, int window, int heads, int piece,
    void* stream) {
  ModeArgs a{q, new_k, new_v, k_cache, v_cache, pos, s, nullptr, q_dtype,
             b, t, h, hkv, dl, window, 0.f,
             static_cast<cudaStream_t>(stream)};
  return run_block_mode(a, c_dtype, heads, piece, true);
}

// The head-dim split's apply mode: s [B, H, T] f32 (summed over the model
// row), v_cache [B, T, Hkv, Dl] (c_dtype), pos [B] int32, out [B, H, Dl]
// (out_dtype); scale = 1 / sqrt(the whole head dim).
extern "C" int repro_attention_decode_apply(
    const void* s, const void* v_cache, const void* pos, void* out,
    int out_dtype, int c_dtype, int b, int t, int h, int hkv, int dl,
    int window, int heads, int piece, float scale, void* stream) {
  ModeArgs a{nullptr, nullptr, nullptr, nullptr,
             const_cast<void*>(v_cache), pos, const_cast<void*>(s), out,
             out_dtype, b, t, h, hkv, dl, window, scale,
             static_cast<cudaStream_t>(stream)};
  return run_block_mode(a, c_dtype, heads, piece, false);
}
