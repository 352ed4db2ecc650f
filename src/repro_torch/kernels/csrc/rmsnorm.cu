// Fused RMSNorm over the rows of a (rows, d) matrix, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas.
// out = x * rsqrt(mean(x^2) + eps) * w, computed in fp32: the weight is
// multiplied in fp32 and the product cast to the output type last, the
// TPU kernel's order.
//
// Bound: bytes.  Each row is read once and written once (about 4 bytes
// per bf16 element, 8 per fp32), with a handful of flops per element,
// far below the card's compute-to-bandwidth ratio.  Design: one block of
// 256 threads per row; each thread keeps its strided slice of the row in
// registers between the reduction and the scale, so the row is read from
// device memory once; the sum of squares is reduced with warp shuffles
// and one shared-memory pass.
//
// C interface (ctypes): rmsnorm_launch(x, w, out, rows, d, eps, dtype,
// stream) with dtype 0 = float32, 1 = bfloat16 (x, w and out share it).
// Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 32;  // d <= 256 * 32 = 8192

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  const long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float vals[kMaxPerThread];
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    vals[i] = c < d ? to_f32(xr[c]) : 0.f;
    sq += vals[i] * vals[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sq;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  const float rstd = rsqrtf(total / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < d) orow[c] = from_f32<T>(vals[i] * rstd * to_f32(w[c]));
  }
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int rows, int d, float eps, int dtype,
                              cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || d > kThreads * kMaxPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows), block(kThreads);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), d, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
