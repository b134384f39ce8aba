// Per-tensor LARS update for Hopper (sm_90a), plain C entry points.
//
// Replaces the two TPU kernels of src/repro/kernels/lars_update.py (the
// use_kernel="per_tensor" path of the layer-wise optimizers):
//   _norm2_kernel -> lars_norm2_kernel   sum w^2, sum g^2 of one segment
//   _apply_kernel -> lars_apply_kernel   scaled = lr*ratio*(g + wd*w),
//                                        m' = mu*m + scaled,
//                                        delta = -(scaled + mu*m') | -m'
// One optimizer step is two launches per kernel segment. A segment is
// one leaf of the JAX package's tree; on an LM tree that leaf stacks up
// to 36 per-layer tensors of the port, so a launch walks a table of
// member tensors (all of one shape), multi-tensor style: the table of
// pointers is passed by value in the kernel's parameter space, as
// PyTorch's multi_tensor_apply does, so a step copies nothing to the
// card. grid = (chunks of kChunk elements, members).
//
// What bounds it on this card: bytes. The norm reads w and g once (4 B
// an element in bf16, 8 B in f32) for 4 flops; the apply reads w, g and
// the f32 momentum and writes the momentum and an f32 delta (16 B an
// element with bf16 w, g) for 7 flops. Both stream every element once
// with 4-element vector loads where the members are aligned, keep the
// sums in registers and shared memory, and read nothing back to the
// host: the apply's prologue turns the norm's two sums into the trust
// ratio and the scale on the card.
//
// The norm is a deterministic two-stage sum in ONE launch, without float
// atomics: every block writes the partial of its chunk, and the block
// that finishes last (an integer ticket after __threadfence) adds all
// partials in a fixed order. The result repeats bit for bit.
//
// Rounding: every operation of the apply, its prologue included, is a
// __f*_rn intrinsic, so nvcc contracts nothing into an FMA and each op
// rounds where the plain PyTorch version (kernels/ref.py lars_ratio,
// lars_apply) rounds: given the same sums, the apply is bitwise equal to
// it. bf16 -> f32 loads are exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 8192;     // elements of one member per block
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Members {
  const void* w[kMaxMembers];
  const void* g[kMaxMembers];
  float* m[kMaxMembers];
  float* d[kMaxMembers];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(x))
                         << 16);
}

__device__ __forceinline__ void load4(const float* p, long long i,
                                      float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p + i);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long i,
                                      float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p + i);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Sum (a, b) over the block in a fixed order; the result is valid in
// thread 0.
__device__ __forceinline__ float2 block_sum(float a, float b) {
  __shared__ float red_a[kWarps], red_b[kWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { red_a[warp] = a; red_b[warp] = b; }
  __syncthreads();
  float sa = 0.0f, sb = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) {
      sa = __fadd_rn(sa, red_a[i]);
      sb = __fadd_rn(sb, red_b[i]);
    }
  }
  return make_float2(sa, sb);
}

// ---- norm: out[0] = sum w^2, out[1] = sum g^2 over all members ----------

template <typename TW, typename TG, bool kVec>
__global__ void __launch_bounds__(kThreads) lars_norm2_kernel(
    Members mem, long long n, float2* __restrict__ partial,
    unsigned int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ bool is_last;
  const TW* w = static_cast<const TW*>(mem.w[blockIdx.y]);
  const TG* g = static_cast<const TG*>(mem.g[blockIdx.y]);
  const long long e0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long e1 = e0 + kChunk < n ? e0 + kChunk : n;
  float sw = 0.0f, sg = 0.0f;
  if (kVec) {        // n % 4 == 0 and aligned members: whole groups of 4
    for (long long e = e0 + 4 * threadIdx.x; e < e1; e += 4 * kThreads) {
      float wv[4], gv[4];
      load4(w, e, wv);
      load4(g, e, gv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sw = __fadd_rn(sw, __fmul_rn(wv[k], wv[k]));
        sg = __fadd_rn(sg, __fmul_rn(gv[k], gv[k]));
      }
    }
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) {
      const float wv = to_f32(w[e]), gv = to_f32(g[e]);
      sw = __fadd_rn(sw, __fmul_rn(wv, wv));
      sg = __fadd_rn(sg, __fmul_rn(gv, gv));
    }
  }
  const float2 s = block_sum(sw, sg);
  const unsigned nblocks = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    partial[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = s;
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == nblocks - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block: every partial, thread t taking t, t + 256, ... in
  // order, then the fixed block reduction
  float aw = 0.0f, ag = 0.0f;
  for (long long i = threadIdx.x; i < nblocks; i += kThreads) {
    const float2 p = __ldcg(partial + i);
    aw = __fadd_rn(aw, p.x);
    ag = __fadd_rn(ag, p.y);
  }
  const float2 t = block_sum(aw, ag);
  if (threadIdx.x == 0) { out[0] = t.x; out[1] = t.y; }
}

// ---- apply ---------------------------------------------------------------

template <typename TW, typename TG, bool kVec, bool kNesterov>
__global__ void __launch_bounds__(kThreads) lars_apply_kernel(
    Members mem, long long n, const float* __restrict__ sums,
    const float* __restrict__ base_lr, float eta, float wd, float eps,
    float mu, float* __restrict__ stats) {
  // prologue: the trust ratio and the scale, in lars_ratio's op order
  const float wn = __fsqrt_rn(sums[0]);
  const float gn = __fsqrt_rn(sums[1]);
  const float ratio =
      (wn > 0.0f && gn > 0.0f)
          ? __fdiv_rn(__fmul_rn(eta, wn),
                      __fadd_rn(__fadd_rn(gn, __fmul_rn(wd, wn)), eps))
          : 1.0f;
  const float scale = __fmul_rn(base_lr[0], ratio);
  if (stats != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0) {
    stats[0] = wn; stats[1] = gn; stats[2] = ratio;
  }
  const TW* w = static_cast<const TW*>(mem.w[blockIdx.y]);
  const TG* g = static_cast<const TG*>(mem.g[blockIdx.y]);
  float* m = mem.m[blockIdx.y];
  float* d = mem.d[blockIdx.y];
  const long long e0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long e1 = e0 + kChunk < n ? e0 + kChunk : n;
  if (kVec) {
    for (long long e = e0 + 4 * threadIdx.x; e < e1; e += 4 * kThreads) {
      float wv[4], gv[4], mv[4], dv[4];
      load4(w, e, wv);
      load4(g, e, gv);
      load4(m, e, mv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float scaled =
            __fmul_rn(scale, __fadd_rn(gv[k], __fmul_rn(wd, wv[k])));
        const float new_m = __fadd_rn(__fmul_rn(mu, mv[k]), scaled);
        dv[k] = kNesterov ? -__fadd_rn(scaled, __fmul_rn(mu, new_m))
                          : -new_m;
        mv[k] = new_m;
      }
      *reinterpret_cast<float4*>(m + e) = make_float4(mv[0], mv[1], mv[2],
                                                      mv[3]);
      *reinterpret_cast<float4*>(d + e) = make_float4(dv[0], dv[1], dv[2],
                                                      dv[3]);
    }
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) {
      const float wv = to_f32(w[e]), gv = to_f32(g[e]);
      const float scaled = __fmul_rn(scale, __fadd_rn(gv, __fmul_rn(wd, wv)));
      const float new_m = __fadd_rn(__fmul_rn(mu, m[e]), scaled);
      d[e] = kNesterov ? -__fadd_rn(scaled, __fmul_rn(mu, new_m)) : -new_m;
      m[e] = new_m;
    }
  }
}

// ---- dispatch ------------------------------------------------------------

Members make_members(int count, const void* const* w, const void* const* g,
                     void* const* m, void* const* d) {
  Members mem = {};
  for (int i = 0; i < count; ++i) {
    mem.w[i] = w[i];
    mem.g[i] = g[i];
    if (m != nullptr) mem.m[i] = static_cast<float*>(m[i]);
    if (d != nullptr) mem.d[i] = static_cast<float*>(d[i]);
  }
  return mem;
}

dim3 grid_of(long long n, int count) {
  return dim3(static_cast<unsigned>((n + kChunk - 1) / kChunk),
              static_cast<unsigned>(count));
}

template <typename TW, typename TG>
void norm_typed(bool vec, const Members& mem, long long n, int count,
                float2* partial, unsigned* ticket, float* out,
                cudaStream_t s) {
  if (vec)
    lars_norm2_kernel<TW, TG, true><<<grid_of(n, count), kThreads, 0, s>>>(
        mem, n, partial, ticket, out);
  else
    lars_norm2_kernel<TW, TG, false><<<grid_of(n, count), kThreads, 0, s>>>(
        mem, n, partial, ticket, out);
}

template <typename TW, typename TG, bool kNesterov>
void apply_nest(bool vec, const Members& mem, long long n, int count,
                const float* sums, const float* lr, float eta, float wd,
                float eps, float mu, float* stats, cudaStream_t s) {
  if (vec)
    lars_apply_kernel<TW, TG, true, kNesterov>
        <<<grid_of(n, count), kThreads, 0, s>>>(mem, n, sums, lr, eta, wd,
                                                eps, mu, stats);
  else
    lars_apply_kernel<TW, TG, false, kNesterov>
        <<<grid_of(n, count), kThreads, 0, s>>>(mem, n, sums, lr, eta, wd,
                                                eps, mu, stats);
}

template <typename TW, typename TG>
void apply_typed(bool vec, int nesterov, const Members& mem, long long n,
                 int count, const float* sums, const float* lr, float eta,
                 float wd, float eps, float mu, float* stats,
                 cudaStream_t s) {
  if (nesterov)
    apply_nest<TW, TG, true>(vec, mem, n, count, sums, lr, eta, wd, eps, mu,
                             stats, s);
  else
    apply_nest<TW, TG, false>(vec, mem, n, count, sums, lr, eta, wd, eps,
                              mu, stats, s);
}

}  // namespace

extern "C" {

// Largest member count of one launch.
int repro_lars_max_members() { return kMaxMembers; }

// Elements of one member per block (the wrapper sizes the partial buffer
// as ceil(n / chunk) * count float2).
long long repro_lars_chunk() { return kChunk; }

// Norm. w_dtype / g_dtype: 0 = f32, 1 = bf16; f32 w with bf16 g is not
// taken (returns -1: no path makes it). w, g: `count` device
// pointers each (host arrays), every member n elements. vec: all members
// 16-byte (f32) / 8-byte (bf16) aligned and n % 4 == 0. ticket: one
// zeroed uint32; out: 2 f32 on the card. Returns the CUDA error of the
// launch (0 = launched).
int repro_lars_norm2(int w_dtype, int g_dtype, int vec, int count,
                     const void* const* w, const void* const* g, long long n,
                     void* partial, void* ticket, void* out, void* stream) {
  if (count < 1 || count > kMaxMembers || n < 1) return -1;
  const Members mem = make_members(count, w, g, nullptr, nullptr);
  auto* part = static_cast<float2*>(partial);
  auto* tk = static_cast<unsigned*>(ticket);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 1 && g_dtype == 1)
    norm_typed<__nv_bfloat16, __nv_bfloat16>(vec, mem, n, count, part, tk, o,
                                             s);
  else if (w_dtype == 1)
    norm_typed<__nv_bfloat16, float>(vec, mem, n, count, part, tk, o, s);
  else if (g_dtype == 0)
    norm_typed<float, float>(vec, mem, n, count, part, tk, o, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

// Apply. m (f32, updated in place) and d (f32 delta, written): `count`
// device pointers each. sums: the norm's 2 f32; base_lr: 1 f32 on the
// card; stats: 3 f32 (w_norm, g_norm, ratio) written, or null. Returns
// the CUDA error of the launch.
int repro_lars_apply(int w_dtype, int g_dtype, int vec, int nesterov,
                     int count, const void* const* w, const void* const* g,
                     void* const* m, void* const* d, long long n,
                     const void* sums, const void* base_lr, float eta,
                     float wd, float eps, float mu, void* stats,
                     void* stream) {
  if (count < 1 || count > kMaxMembers || n < 1) return -1;
  const Members mem = make_members(count, w, g, m, d);
  const auto* sm = static_cast<const float*>(sums);
  const auto* lr = static_cast<const float*>(base_lr);
  auto* st = static_cast<float*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 1 && g_dtype == 1)
    apply_typed<__nv_bfloat16, __nv_bfloat16>(vec, nesterov, mem, n, count,
                                              sm, lr, eta, wd, eps, mu, st,
                                              s);
  else if (w_dtype == 1)
    apply_typed<__nv_bfloat16, float>(vec, nesterov, mem, n, count, sm, lr,
                                      eta, wd, eps, mu, st, s);
  else if (g_dtype == 0)
    apply_typed<float, float>(vec, nesterov, mem, n, count, sm, lr, eta, wd,
                              eps, mu, st, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
