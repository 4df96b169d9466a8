// Fused RMSNorm forward for Hopper (K6).
//
// Replaces the Pallas kernel _rmsnorm_kernel of
// src/repro/kernels/fused_rmsnorm.py (fused_rmsnorm):
//
//     y = x * rsqrt(mean(x*x) + eps) * (1 + scale)     (f32 statistics)
//
// x is (rows, d) in float32 or bfloat16, scale (d,) float32, y has x's
// dtype.  The kernel also writes the per-row rstd in float32, which the
// backward (plain torch, closed form) reads instead of an f32 copy of x.
//
// Bound: device-memory bytes.  Each row is read once for its statistics
// and once more for the output (the second read hits L1/L2: one row of
// smollm-360m is 960 values), so HBM sees rows*d*(in+out) bytes plus
// the scale and rstd; the flops (~4 per element) are negligible.
// Design: one warp per row, any d (960 is not a power of two); lanes
// stride the row so loads coalesce; a shuffle tree sums the squares.
//
// Numerics: the mean is the sum over d divided by d, rstd is
// 1.0f / sqrtf(mean + eps) under -prec-div=true -prec-sqrt=true (not the
// approximate rsqrtf intrinsic), and -fmad=false keeps every product
// and sum rounded on its own, as in the plain version.  The sum's order
// differs from torch's mean; the bound is stated in the tests.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ y, float* __restrict__ rstd,
                               long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32(xr[c]);
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
  if (lane == 0) rstd[row] = r;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32(xr[c]);
    yr[c] = from_f32<T>((v * r) * (1.0f + scale[c]));
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* y, float* rstd,
           long long rows, int d, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                      stream>>>(static_cast<const T*>(x), scale,
                                static_cast<T*>(y), rstd, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int rmsnorm_fwd(int dtype, const void* x, const float* scale,
                           void* y, float* rstd, long long rows, int d,
                           float eps, void* stream) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, y, rstd, rows, d, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, y, rstd, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
