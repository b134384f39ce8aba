// RMSNorm for Hopper (sm_90a), plain C entry point.
//
// Replaces src/repro/kernels/rmsnorm.py::_rmsnorm_kernel:
//   y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// over the rows of x (rows, d), computed in f32 and stored in x's dtype.
//
// What bounds it on this card: bytes. It reads x once and writes y once
// (plus d weights per row, from cache) for about 5 flops an element. Two
// kernels hold a row in registers, so x is read from device memory
// exactly once:
//
// * rows of d <= 2048 (qwen2.5-3b's 2048 among them): one warp per row,
//   kRowsPerBlock rows per block. A lane loads 16-byte vectors (8 bf16 /
//   f16 or 4 f32 values), at most kMaxVecs of them, all issued before the
//   first use; the sum of squares is reduced by warp shuffles alone, with
//   no __syncthreads(). Needs x, y and w 16-byte aligned.
// * wider rows (gemma3-12b's 3840), or operands that are not 16-byte
//   aligned: one block per row, blockDim = min(256, d / 4) threads, each
//   with up to kMaxGroups groups of 4 consecutive elements (16 B in f32,
//   8 B in bf16/f16), the warps' sums added in order through shared
//   memory. d must be a multiple of 128 up to 8192.
//
// Both take the sum of squares in a fixed order (each lane its values in
// order, a warp butterfly, then for the wide kernel the warps' sums in
// order), so a row's result repeats bit for bit. mean = sum / d
// (__fdiv_rn) and r = rsqrtf(mean + eps): CUDA's rsqrtf, which PyTorch's
// torch.rsqrt also calls on the card (the plain version), within 2 ulp of
// 1/sqrt. The products (x*r)*(1+w) use __fmul_rn / __fadd_rn in the plain
// version's order; the cast to bf16/f16 rounds to nearest even.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 8;          // d <= 4 * 8 * 256 = 8192
constexpr int kNarrowMaxD = 2048;      // widest row of the warp-per-row kernel
constexpr int kRowsPerBlock = 4;       // warps (rows) per narrow block
constexpr unsigned kFull = 0xFFFFFFFFu;

// one 32-bit word of T values as f32, and back
template <typename T> __device__ __forceinline__ void unpack(uint32_t u,
                                                             float* f);
template <> __device__ __forceinline__ void unpack<float>(uint32_t u,
                                                          float* f) {
  f[0] = __uint_as_float(u);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint32_t u, float* f) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xFFFF0000u);
}
template <> __device__ __forceinline__ void unpack<__half>(uint32_t u,
                                                           float* f) {
  f[0] = __half2float(__ushort_as_half(static_cast<unsigned short>(u)));
  f[1] = __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
}

template <typename T> __device__ __forceinline__ uint32_t pack(const float* f);
template <> __device__ __forceinline__ uint32_t pack<float>(const float* f) {
  return __float_as_uint(f[0]);
}
template <>
__device__ __forceinline__ uint32_t pack<__nv_bfloat16>(const float* f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f[0])))
         | (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(f[1]))) << 16);
}
template <> __device__ __forceinline__ uint32_t pack<__half>(const float* f) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(f[0])))
         | (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(f[1])))
            << 16);
}

// N consecutive T values at p (N * sizeof(T) = 8, 16 or 32 bytes, as
// aligned) as f32, by 8- or 16-byte vector loads; and the store back.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // values a word
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int u = 0; u < kBytes / 16; ++u) {
      const uint4 r = reinterpret_cast<const uint4*>(p)[u];
      unpack<T>(r.x, f + (4 * u) * kPer);
      unpack<T>(r.y, f + (4 * u + 1) * kPer);
      unpack<T>(r.z, f + (4 * u + 2) * kPer);
      unpack<T>(r.w, f + (4 * u + 3) * kPer);
    }
  } else {
    static_assert(kBytes == 8, "8, 16 or 32 bytes");
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    unpack<T>(r.x, f);
    unpack<T>(r.y, f + kPer);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));
  if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack<T>(f), pack<T>(f + kPer), pack<T>(f + 2 * kPer),
        pack<T>(f + 3 * kPer));
  } else {
    static_assert(kBytes == 8, "8 or 16 bytes");
    *reinterpret_cast<uint2*>(p) = make_uint2(pack<T>(f), pack<T>(f + kPer));
  }
}

__device__ __forceinline__ float warp_sum_rn(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// Narrow rows: warp w of block i normalises row i * kRowsPerBlock + w.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kRowsPerBlock * 32) rmsnorm_rows_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ y,
    long long rows, int d, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TX));
  constexpr int kMaxVecs = kNarrowMaxD / kVec / 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int vecs = d / kVec;
  const long long base = row * d;
  float v[kMaxVecs][kVec];
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j) {
    const int c = lane + 32 * j;
    if (c < vecs) load_vec<TX, kVec>(x + base + c * kVec, v[j]);
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j) {
    if (lane + 32 * j < vecs) {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        s = __fadd_rn(s, __fmul_rn(v[j][k], v[j][k]));
    }
  }
  s = warp_sum_rn(s);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(s, static_cast<float>(d)), eps));
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j) {
    const int c = lane + 32 * j;
    if (c < vecs) {
      float wv[kVec], out[kVec];
      load_vec<TW, kVec>(w + c * kVec, wv);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        out[k] = __fmul_rn(__fmul_rn(v[j][k], r), __fadd_rn(1.0f, wv[k]));
      store_vec<TX, kVec>(y + base + c * kVec, out);
    }
  }
}

// Wide rows: one block per row.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ y,
    int d, float eps) {
  __shared__ float red[kMaxThreads / 32];
  __shared__ float r_row;
  const int groups = d / 4;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  float v[kMaxGroups][4];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxGroups; ++j) {
    const int q = threadIdx.x + j * blockDim.x;
    if (q < groups) {
      load_vec<TX, 4>(x + base + 4LL * q, v[j]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s = __fadd_rn(s, __fmul_rn(v[j][k], v[j][k]));
    }
  }
  s = warp_sum_rn(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i)
      t = __fadd_rn(t, red[i]);
    r_row = rsqrtf(__fadd_rn(__fdiv_rn(t, static_cast<float>(d)), eps));
  }
  __syncthreads();
  const float r = r_row;
#pragma unroll
  for (int j = 0; j < kMaxGroups; ++j) {
    const int q = threadIdx.x + j * blockDim.x;
    if (q < groups) {
      float wv[4], out[4];
      load_vec<TW, 4>(w + 4LL * q, wv);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out[k] = __fmul_rn(__fmul_rn(v[j][k], r), __fadd_rn(1.0f, wv[k]));
      store_vec<TX, 4>(y + base + 4LL * q, out);
    }
  }
}

template <typename TX, typename TW>
void launch(bool narrow, const void* x, const void* w, void* y,
            long long rows, int d, float eps, cudaStream_t s) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (narrow) {
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    rmsnorm_rows_kernel<TX, TW>
        <<<static_cast<unsigned>(blocks), kRowsPerBlock * 32, 0, s>>>(
            xp, wp, yp, rows, d, eps);
  } else {
    const int threads = d / 4 < kMaxThreads ? d / 4 : kMaxThreads;
    rmsnorm_kernel<TX, TW><<<static_cast<unsigned>(rows), threads, 0, s>>>(
        xp, wp, yp, d, eps);
  }
}

template <typename TX>
void launch_w(int w_dtype, bool narrow, const void* x, const void* w,
              void* y, long long rows, int d, float eps, cudaStream_t s) {
  if (w_dtype == 1)
    launch<TX, __nv_bfloat16>(narrow, x, w, y, rows, d, eps, s);
  else if (w_dtype == 2)
    launch<TX, __half>(narrow, x, w, y, rows, d, eps, s);
  else
    launch<TX, float>(narrow, x, w, y, rows, d, eps, s);
}

}  // namespace

extern "C" {

// x, y: (rows, d) contiguous; w: (d,). Dtype codes: 0 = f32, 1 = bf16,
// 2 = f16. narrow != 0 asks for the warp-per-row kernel (d <= 2048, x, w
// and y 16-byte aligned), else the block-per-row one (x, w, y aligned to
// 4 elements). Returns the CUDA error of the launch (0 = launched), -1
// for a d, row count or alignment the chosen kernel does not take.
int repro_rmsnorm(int x_dtype, int w_dtype, const void* x, const void* w,
                  void* y, long long rows, int d, float eps, int narrow,
                  void* stream) {
  if (d < 128 || d % 128 != 0 || d > 4 * kMaxGroups * kMaxThreads ||
      rows < 1 || rows > 2147483647LL)
    return -1;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y);
  if (narrow && (d > kNarrowMaxD || bits % 16 != 0)) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1)
    launch_w<__nv_bfloat16>(w_dtype, narrow != 0, x, w, y, rows, d, eps, s);
  else if (x_dtype == 2)
    launch_w<__half>(w_dtype, narrow != 0, x, w, y, rows, d, eps, s);
  else
    launch_w<float>(w_dtype, narrow != 0, x, w, y, rows, d, eps, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
