// Segmented layer-wise optimizer update for Hopper (sm_90a), plain C
// entry points.
//
// Replaces the four TPU kernel bodies of
// src/repro/kernels/segmented_update.py (launched by
// segmented_update_pallas):
//   _seg_norm_lars  -> seg_norm_kernel<T, false>   pass 1, modes lars/paper
//   _seg_norm_lamb  -> seg_norm_kernel<T, true>    pass 1, mode lamb
//   _seg_apply_lars -> seg_apply_kernel<T, kLars|kPaper, ...>  pass 2
//   _seg_apply_lamb -> seg_apply_kernel<T, kLamb, ...>         pass 2
// over the flat (rows, 128) substrate of repro_torch.core.flatten: every
// row belongs to one segment, the segments are contiguous row ranges in
// increasing id order, and a (rows,) int32 column gives each row's id.
// One optimizer step is two launches: pass 1 writes the per-segment
// (sum w^2, sum b^2) table, PyTorch turns it into the trust table
// (sg, sw) on the card, pass 2 applies it.
//
// What bounds it on this card: bytes. Both passes do a handful of flops
// per element they stream (pass 1 reads w, g (+ mu, nu); pass 2 reads
// w, g, the state and writes the state and an f32 delta), far below the
// ~20 flop/byte at which the f32 units would be the limit. The design
// reads every element once per pass with 16-byte (f32) or 8-byte (bf16)
// vector loads, one warp per 128-lane row, and keeps all intermediate
// values in registers and shared memory.
//
// Pass 1 is a deterministic two-stage segmented sum in ONE launch, with
// no float atomics, so the table repeats bit for bit from run to run:
//   (1) block c sums its kChunkRows rows: each warp reduces a row with a
//       fixed butterfly, then one thread per run of equal ids adds that
//       run's row sums in row order and stores the partial at slot
//       (id - first id of the chunk) of chunk c;
//   (2) the block that finishes last (an integer ticket, after a
//       __threadfence) sums, one warp per segment, the partials of the
//       chunks the segment spans (found by binary search in the sorted
//       id column) with a fixed lane assignment and butterfly.
// Segments span 1 row up to millions (a 151936 x 2048 embedding), so a
// block per segment would not do; chunks bound the work of a block.
//
// Rounding: the elementwise arithmetic uses __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn / __fsqrt_rn, so nvcc contracts nothing into an
// FMA and each op rounds where the plain PyTorch version rounds: given
// the same trust table, pass 2 is bitwise equal to it. bf16 state is
// stored round-to-nearest-even (__float2bfloat16_rn, as .to()) or, in
// the _sr policies, stochastically: add the low 16 bits of
// hash(global element index mod 2^32, seed + buf * 0x9E3779B9) to the
// f32 bit pattern and keep the top half; inf/nan are not perturbed.
// The element index is computed in uint32 arithmetic, wrapping past
// 2^32 elements exactly as the reference's int32 iota read as uint32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunkRows = 128;        // rows per pass-1 block
constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kApplyThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum Mode { kLars = 0, kPaper = 1, kLamb = 2 };

// ---- loads / stores of 4 consecutive elements ----------------------------

__device__ __forceinline__ void load4(const float* p, size_t i, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p + i);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, size_t i,
                                      float v[4]) {
  // bf16 -> f32 is exact: the bf16 bits are the top half of the f32
  const uint2 x = *reinterpret_cast<const uint2*>(p + i);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t seed) {
  uint32_t x = idx * 2654435761u;
  x = x + seed;
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  x *= 3266489917u;
  return x ^ (x >> 16);
}

// f32 -> bf16 bits: round to nearest even, or stochastic with `bits`.
template <bool kSR>
__device__ __forceinline__ uint32_t bf16_bits(float x, uint32_t bits) {
  if (kSR && isfinite(x)) {
    const uint32_t u = (__float_as_uint(x) + (bits & 0xFFFFu)) & 0xFFFF0000u;
    return u >> 16;
  }
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Store 4 f32 values of state buffer `buf` at element e0 (the global flat
// index of the first one).
template <bool kSR>
__device__ __forceinline__ void store4(float* p, size_t e0, const float v[4],
                                       uint32_t, int) {
  *reinterpret_cast<float4*>(p + e0) = make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kSR>
__device__ __forceinline__ void store4(__nv_bfloat16* p, size_t e0,
                                       const float v[4], uint32_t seed,
                                       int buf) {
  uint32_t h[4] = {0u, 0u, 0u, 0u};
  if (kSR) {
    const uint32_t s = seed + static_cast<uint32_t>(buf) * 0x9E3779B9u;
    const uint32_t idx = static_cast<uint32_t>(e0);  // mod 2^32
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = hash_bits(idx + k, s);
  }
  uint2 x;
  x.x = bf16_bits<kSR>(v[0], h[0]) | (bf16_bits<kSR>(v[1], h[1]) << 16);
  x.y = bf16_bits<kSR>(v[2], h[2]) | (bf16_bits<kSR>(v[3], h[3]) << 16);
  *reinterpret_cast<uint2*>(p + e0) = x;
}

// ---- the shared elementwise math (kernels/ref.py, op for op) -------------

struct AdamConst {
  float b1, omb1, b2, omb2, eps;   // omb = (float)(1.0 - b) from the host
};

// LAMB's moments and direction: new_mu = b1*mu + (1-b1)*g,
// new_nu = b2*nu + (1-b2)*(g*g), d = (new_mu/bc1) / (sqrt(new_nu/bc2)+eps)
__device__ __forceinline__ float adam_dir(float g, float mu, float nu,
                                          const AdamConst& a, float bc1,
                                          float bc2, float* new_mu,
                                          float* new_nu) {
  *new_mu = __fadd_rn(__fmul_rn(a.b1, mu), __fmul_rn(a.omb1, g));
  *new_nu = __fadd_rn(__fmul_rn(a.b2, nu), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  return __fdiv_rn(__fdiv_rn(*new_mu, bc1),
                   __fadd_rn(__fsqrt_rn(__fdiv_rn(*new_nu, bc2)), a.eps));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// first row r with ids[r] >= s (ids sorted ascending)
__device__ __forceinline__ long long lower_bound(const int32_t* ids,
                                                 long long rows, int s) {
  long long lo = 0, hi = rows;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ids[mid] < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---- pass 1: per-segment sum w^2, sum b^2 --------------------------------

template <typename T, bool kLambMode>
__global__ void __launch_bounds__(kNormThreads) seg_norm_kernel(
    const T* __restrict__ w, const T* __restrict__ g,
    const T* __restrict__ mu, const T* __restrict__ nu,
    const int32_t* __restrict__ ids, long long rows, int nseg,
    const float* __restrict__ bc, AdamConst a, float wd,
    float2* __restrict__ partial, int stride,
    unsigned int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float row_w[kChunkRows];
  __shared__ float row_b[kChunkRows];
  __shared__ int row_id[kChunkRows];
  __shared__ bool is_last;

  const long long chunk = blockIdx.x;
  const long long row0 = chunk * kChunkRows;
  const long long left = rows - row0;
  const int nrows = left < kChunkRows ? static_cast<int>(left) : kChunkRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float bc1 = 1.0f, bc2 = 1.0f;
  if (kLambMode) { bc1 = bc[0]; bc2 = bc[1]; }

  // (1a) row sums: one warp per row, 4 elements per lane
  for (int r = warp; r < nrows; r += kNormWarps) {
    const size_t e = static_cast<size_t>(row0 + r) * kLanes + lane * 4;
    float wv[4], gv[4];
    load4(w, e, wv);
    load4(g, e, gv);
    float sw = 0.0f, sb = 0.0f;
    if (kLambMode) {
      float mv[4], nv[4];
      load4(mu, e, mv);
      load4(nu, e, nv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float m2, n2;
        const float d = adam_dir(gv[k], mv[k], nv[k], a, bc1, bc2, &m2, &n2);
        const float b = __fadd_rn(d, __fmul_rn(wd, wv[k]));
        sb = __fadd_rn(sb, __fmul_rn(b, b));
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) sb = __fadd_rn(sb, __fmul_rn(gv[k], gv[k]));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) sw = __fadd_rn(sw, __fmul_rn(wv[k], wv[k]));
    sw = warp_sum(sw);
    sb = warp_sum(sb);
    if (lane == 0) { row_w[r] = sw; row_b[r] = sb; }
  }
  for (int t = threadIdx.x; t < nrows; t += kNormThreads)
    row_id[t] = ids[row0 + t];
  __syncthreads();

  // (1b) one partial per (chunk, segment): the thread at the start of a
  // run of equal ids adds the run's row sums in row order
  const int first = row_id[0];
  for (int t = threadIdx.x; t < nrows; t += kNormThreads) {
    if (t == 0 || row_id[t] != row_id[t - 1]) {
      float aw = 0.0f, ab = 0.0f;
      for (int u = t; u < nrows && row_id[u] == row_id[t]; ++u) {
        aw = __fadd_rn(aw, row_w[u]);
        ab = __fadd_rn(ab, row_b[u]);
      }
      partial[chunk * stride + (row_id[t] - first)] = make_float2(aw, ab);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // (2) the last block: one warp per segment over the chunks it spans
  for (int s = warp; s < nseg; s += kNormWarps) {
    const long long lo = lower_bound(ids, rows, s);
    const long long hi = lower_bound(ids, rows, s + 1);
    float aw = 0.0f, ab = 0.0f;
    if (lo < hi) {
      const long long c1 = lo / kChunkRows, c2 = (hi - 1) / kChunkRows;
      for (long long c = c1 + lane; c <= c2; c += 32) {
        const int slot = s - __ldcg(ids + c * kChunkRows);
        const float2 p = __ldcg(partial + c * stride + slot);
        aw = __fadd_rn(aw, p.x);
        ab = __fadd_rn(ab, p.y);
      }
    }
    aw = warp_sum(aw);
    ab = warp_sum(ab);
    if (lane == 0) { out[s] = aw; out[nseg + s] = ab; }
  }
}

// ---- pass 2: gathered-scale apply ----------------------------------------

template <typename T, int kMode, bool kNesterov, bool kSR>
__global__ void __launch_bounds__(kApplyThreads) seg_apply_kernel(
    const T* __restrict__ w, const T* __restrict__ g, T* m, T* nu,
    float* __restrict__ delta, const int32_t* __restrict__ ids,
    const float* __restrict__ table, int nseg, long long groups,
    const float* __restrict__ bc, const int32_t* __restrict__ seed_ptr,
    float momentum, AdamConst a) {
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  float bc1 = 1.0f, bc2 = 1.0f;
  if (kMode == kLamb) { bc1 = bc[0]; bc2 = bc[1]; }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < groups; q += step) {
    const size_t e0 = static_cast<size_t>(q) * 4;
    const int s = ids[e0 / kLanes];
    const float sg = table[s], sw = table[nseg + s];
    float wv[4], gv[4], mv[4], dv[4];
    load4(w, e0, wv);
    load4(g, e0, gv);
    load4(m, e0, mv);
    if (kMode == kLamb) {
      float nv[4];
      load4(nu, e0, nv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float m2, n2;
        const float d = adam_dir(gv[k], mv[k], nv[k], a, bc1, bc2, &m2, &n2);
        dv[k] = -__fadd_rn(__fmul_rn(sg, d), __fmul_rn(sw, wv[k]));
        mv[k] = m2;
        nv[k] = n2;
      }
      store4<kSR>(nu, e0, nv, seed, 1);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float scaled =
            __fadd_rn(__fmul_rn(sg, gv[k]), __fmul_rn(sw, wv[k]));
        if (kMode == kPaper) {
          const float proposed = __fsub_rn(wv[k], scaled);
          dv[k] = __fadd_rn(__fsub_rn(proposed, wv[k]),
                            __fmul_rn(momentum, __fsub_rn(proposed, mv[k])));
          mv[k] = proposed;
        } else {
          const float new_m = __fadd_rn(__fmul_rn(momentum, mv[k]), scaled);
          dv[k] = kNesterov
                      ? -__fadd_rn(scaled, __fmul_rn(momentum, new_m))
                      : -new_m;
          mv[k] = new_m;
        }
      }
    }
    store4<kSR>(m, e0, mv, seed, 0);
    *reinterpret_cast<float4*>(delta + e0) =
        make_float4(dv[0], dv[1], dv[2], dv[3]);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess || n <= 0)
    return 132;
  return n;
}

template <typename T>
int launch_norm(int lamb, const void* w, const void* g, const void* mu,
                const void* nu, const void* ids, long long rows, int nseg,
                const void* bc, AdamConst a, float wd, void* partial,
                int stride, void* ticket, void* out, cudaStream_t stream) {
  const long long chunks = (rows + kChunkRows - 1) / kChunkRows;
  const dim3 grid(static_cast<unsigned>(chunks));
  auto* part = static_cast<float2*>(partial);
  auto* tk = static_cast<unsigned int*>(ticket);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* b = static_cast<const float*>(bc);
  if (lamb)
    seg_norm_kernel<T, true><<<grid, kNormThreads, 0, stream>>>(
        static_cast<const T*>(w), static_cast<const T*>(g),
        static_cast<const T*>(mu), static_cast<const T*>(nu), id, rows, nseg,
        b, a, wd, part, stride, tk, static_cast<float*>(out));
  else
    seg_norm_kernel<T, false><<<grid, kNormThreads, 0, stream>>>(
        static_cast<const T*>(w), static_cast<const T*>(g), nullptr, nullptr,
        id, rows, nseg, b, a, wd, part, stride, tk,
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMode, bool kNesterov, bool kSR>
void apply_one(const void* w, const void* g, void* m, void* nu, void* delta,
               const void* ids, const void* table, int nseg, long long groups,
               const void* bc, const void* seed, float momentum, AdamConst a,
               cudaStream_t stream) {
  long long blocks = (groups + kApplyThreads - 1) / kApplyThreads;
  const long long cap = 8LL * sm_count();
  if (blocks > cap) blocks = cap;
  seg_apply_kernel<T, kMode, kNesterov, kSR>
      <<<static_cast<unsigned>(blocks), kApplyThreads, 0, stream>>>(
          static_cast<const T*>(w), static_cast<const T*>(g),
          static_cast<T*>(m), static_cast<T*>(nu),
          static_cast<float*>(delta), static_cast<const int32_t*>(ids),
          static_cast<const float*>(table), nseg, groups,
          static_cast<const float*>(bc), static_cast<const int32_t*>(seed),
          momentum, a);
}

template <typename T, bool kSR>
int launch_apply(int mode, int nesterov, const void* w, const void* g,
                 void* m, void* nu, void* delta, const void* ids,
                 const void* table, int nseg, long long groups,
                 const void* bc, const void* seed, float momentum,
                 AdamConst a, cudaStream_t stream) {
  if (mode == kLamb)
    apply_one<T, kLamb, false, kSR>(w, g, m, nu, delta, ids, table, nseg,
                                    groups, bc, seed, momentum, a, stream);
  else if (mode == kPaper)
    apply_one<T, kPaper, false, kSR>(w, g, m, nu, delta, ids, table, nseg,
                                     groups, bc, seed, momentum, a, stream);
  else if (nesterov)
    apply_one<T, kLars, true, kSR>(w, g, m, nu, delta, ids, table, nseg,
                                   groups, bc, seed, momentum, a, stream);
  else
    apply_one<T, kLars, false, kSR>(w, g, m, nu, delta, ids, table, nseg,
                                    groups, bc, seed, momentum, a, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Chunk rows of pass 1 (the Python wrapper sizes the partial buffer as
// ceil(rows / chunk) * min(chunk, nseg) float2).
int repro_seg_chunk_rows() { return kChunkRows; }

// Pass 1. dtype: 0 = f32, 1 = bf16. lamb: 0 = b is g (lars, paper),
// 1 = b is the wd-augmented Adam direction (mu, nu, bc used). `ticket`
// is one zeroed uint32; `out` is (2, nseg) f32. Returns the CUDA error
// of the launch (0 = launched).
int repro_seg_norm(int lamb, int dtype, const void* w, const void* g,
                   const void* mu, const void* nu, const void* ids,
                   long long rows, int nseg, const void* bc, float b1,
                   float omb1, float b2, float omb2, float eps, float wd,
                   void* partial, int stride, void* ticket, void* out,
                   void* stream) {
  const AdamConst a{b1, omb1, b2, omb2, eps};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_norm<__nv_bfloat16>(lamb, w, g, mu, nu, ids, rows, nseg,
                                      bc, a, wd, partial, stride, ticket,
                                      out, s);
  return launch_norm<float>(lamb, w, g, mu, nu, ids, rows, nseg, bc, a, wd,
                            partial, stride, ticket, out, s);
}

// Pass 2. mode: 0 = lars, 1 = paper, 2 = lamb. m (and nu for lamb) are
// updated in place at the storage dtype; delta (rows*128 f32) is
// written. table is (2, nseg) f32; bc two f32 on the card; seed one
// int32 on the card. Returns the CUDA error of the launch.
int repro_seg_apply(int mode, int nesterov, int sr, int dtype, const void* w,
                    const void* g, void* m, void* nu, void* delta,
                    const void* ids, const void* table, int nseg,
                    long long rows, const void* bc, const void* seed,
                    float momentum, float b1, float omb1, float b2,
                    float omb2, float eps, void* stream) {
  const AdamConst a{b1, omb1, b2, omb2, eps};
  const long long groups = rows * (kLanes / 4);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (sr)
      return launch_apply<__nv_bfloat16, true>(mode, nesterov, w, g, m, nu,
                                               delta, ids, table, nseg,
                                               groups, bc, seed, momentum, a,
                                               s);
    return launch_apply<__nv_bfloat16, false>(mode, nesterov, w, g, m, nu,
                                              delta, ids, table, nseg, groups,
                                              bc, seed, momentum, a, s);
  }
  return launch_apply<float, false>(mode, nesterov, w, g, m, nu, delta, ids,
                                    table, nseg, groups, bc, seed, momentum,
                                    a, s);
}

}  // extern "C"
