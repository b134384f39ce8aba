// RMSNorm for Hopper (sm_90a), plain C entry point.
//
// Replaces src/repro/kernels/rmsnorm.py::_rmsnorm_kernel:
//   y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// over the rows of x (rows, d), computed in f32 and stored in x's dtype.
//
// What bounds it on this card: bytes. It reads x once and writes y once
// (plus d weights per row, from cache) for about 5 flops an element. One
// block per row holds the row in registers: blockDim = min(256, d / 4)
// threads, each with up to kMaxGroups groups of 4 consecutive elements
// loaded as one vector (16 B in f32, 8 B in bf16/f16), so x is read from
// device memory exactly once. d must be a multiple of 128 up to 8192:
// 2048 (qwen2.5-3b) and 3840 (gemma3-12b) among them.
//
// The sum of squares is taken in a fixed order (each thread its groups in
// order, a warp butterfly, the warps' sums in order), so a row's result
// repeats bit for bit. mean = sum / d (__fdiv_rn) and r = rsqrtf(mean +
// eps): CUDA's rsqrtf, which PyTorch's torch.rsqrt also calls on the card
// (the plain version), within 2 ulp of 1/sqrt. The products (x*r)*(1+w)
// use __fmul_rn / __fadd_rn in the plain version's order; the cast to
// bf16/f16 rounds to nearest even.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 8;          // d <= 4 * 8 * 256 = 8192
constexpr unsigned kFull = 0xFFFFFFFFu;

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

__device__ __forceinline__ void load4(const __half* p, long long i,
                                      float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p + i);
  const __half2 a = *reinterpret_cast<const __half2*>(&x.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&x.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(float* p, long long i,
                                       const float v[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i,
                                       const float v[4]) {
  uint2 x;
  x.x = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[0])))
        | (static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(v[1]))) << 16);
  x.y = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2])))
        | (static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(v[3]))) << 16);
  *reinterpret_cast<uint2*>(p + i) = x;
}

__device__ __forceinline__ void store4(__half* p, long long i,
                                       const float v[4]) {
  uint2 x;
  x.x = static_cast<uint32_t>(__half_as_ushort(__float2half_rn(v[0])))
        | (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(v[1])))
           << 16);
  x.y = static_cast<uint32_t>(__half_as_ushort(__float2half_rn(v[2])))
        | (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(v[3])))
           << 16);
  *reinterpret_cast<uint2*>(p + i) = x;
}

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
      load4(x, base + 4LL * q, v[j]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s = __fadd_rn(s, __fmul_rn(v[j][k], v[j][k]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
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
      load4(w, 4LL * q, wv);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out[k] = __fmul_rn(__fmul_rn(v[j][k], r), __fadd_rn(1.0f, wv[k]));
      store4(y, base + 4LL * q, out);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* y, long long rows, int d,
            float eps, cudaStream_t s) {
  const int threads = d / 4 < kMaxThreads ? d / 4 : kMaxThreads;
  rmsnorm_kernel<TX, TW><<<static_cast<unsigned>(rows), threads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), d, eps);
}

template <typename TX>
void launch_w(int w_dtype, const void* x, const void* w, void* y,
              long long rows, int d, float eps, cudaStream_t s) {
  if (w_dtype == 1)
    launch<TX, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  else if (w_dtype == 2)
    launch<TX, __half>(x, w, y, rows, d, eps, s);
  else
    launch<TX, float>(x, w, y, rows, d, eps, s);
}

}  // namespace

extern "C" {

// x, y: (rows, d) contiguous, 16-byte aligned; w: (d,). Dtype codes: 0 =
// f32, 1 = bf16, 2 = f16. Returns the CUDA error of the launch (0 =
// launched), -1 for a d the kernel does not take.
int repro_rmsnorm(int x_dtype, int w_dtype, const void* x, const void* w,
                  void* y, long long rows, int d, float eps, void* stream) {
  if (d < 128 || d % 128 != 0 || d > 4 * kMaxGroups * kMaxThreads ||
      rows < 1 || rows > 2147483647LL)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1)
    launch_w<__nv_bfloat16>(w_dtype, x, w, y, rows, d, eps, s);
  else if (x_dtype == 2)
    launch_w<__half>(w_dtype, x, w, y, rows, d, eps, s);
  else
    launch_w<float>(w_dtype, x, w, y, rows, d, eps, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
