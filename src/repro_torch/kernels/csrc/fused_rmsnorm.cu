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
// Bound: device-memory bytes, rows*d*(in+out) plus the scale and rstd;
// the flops (~4 per element) are negligible.
//
// Design: a row is read from device memory once.  On the vector path
// (x, y and scale 16-byte aligned, d a multiple of the vector width of 8
// bf16 or 4 f32 values, d at most kMaxVecs vectors) each thread issues
// the loads of its NV 16-byte vectors of the row before anything else,
// keeps them in registers, sums their squares, and once the row's sum is
// known writes y from the same registers as 16-byte vectors.  A row of
// up to 1024 values takes one warp (8 rows to a 256-thread block); a
// wider row takes a block of 128 threads (256 above 1024 vectors), whose
// warps add their sums through shared memory.  NV is a template parameter
// that the launcher picks from d.  Other widths and misaligned pointers
// take the scalar path of the same kernel and block shape: one value at
// a time, the row read a second time for the output.
//
// Numerics: the mean is the row's sum divided by d, rstd is
// 1.0f / sqrtf(mean + eps) under -prec-div=true -prec-sqrt=true (not the
// approximate rsqrtf intrinsic), and -fmad=false keeps every product
// and sum rounded on its own, as in the plain version.  The sum's order
// differs from torch's mean; the bound is stated in the tests.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpBlock = 256;   // threads of a block of one-warp rows
constexpr int kWarpMaxValues = 1024;
constexpr int kMaxNV = 8;         // vectors a thread keeps
constexpr int kMaxVecs = 256 * kMaxNV;

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

// The W = 16 / sizeof(T) values of a 16-byte vector, as f32 (exact).
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);          // the lower element
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// The sum of v over the THREADS threads of a row (a warp, or a block
// through shared memory), the same value in every thread.
template <int THREADS>
__device__ __forceinline__ float row_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (THREADS > 32) {
    __shared__ float part[THREADS / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) v += part[w];
  }
  return v;
}

// THREADS 32: one warp per row, kWarpBlock / 32 rows a block; else one
// row per block of THREADS.  kVec: NV 16-byte vectors a thread, held in
// registers; else the scalar path (NV unused).
template <typename T, int THREADS, int NV, bool kVec>
__global__ void __launch_bounds__(THREADS == 32 ? kWarpBlock : THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd,
                   long long rows, int d, float eps) {
  constexpr int W = 16 / sizeof(T);
  const int tid = THREADS == 32 ? threadIdx.x & 31 : threadIdx.x;
  const long long row =
      THREADS == 32 ? static_cast<long long>(blockIdx.x) * (kWarpBlock / 32) +
                          (threadIdx.x >> 5)
                    : static_cast<long long>(blockIdx.x);
  if (row >= rows) return;  // a whole warp (the last block's spare rows)
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.0f;
  float r;
  if constexpr (kVec) {
    const int nv = d / W;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4 buf[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = tid + i * THREADS;
      if (v < nv) buf[i] = xv[v];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (tid + i * THREADS < nv) {
        float f[W];
        unpack(buf[i], f);
#pragma unroll
        for (int e = 0; e < W; ++e) ss += f[e] * f[e];
      }
    }
    r = 1.0f / sqrtf(row_sum<THREADS>(ss) / static_cast<float>(d) + eps);
    const float4* sv = reinterpret_cast<const float4*>(scale);
    uint4* yv = reinterpret_cast<uint4*>(yr);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = tid + i * THREADS;
      if (v < nv) {
        float f[W], s[W];
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const float4 s4 = sv[v * (W / 4) + q];
          s[4 * q] = s4.x;
          s[4 * q + 1] = s4.y;
          s[4 * q + 2] = s4.z;
          s[4 * q + 3] = s4.w;
        }
        unpack(buf[i], f);
#pragma unroll
        for (int e = 0; e < W; ++e) f[e] = (f[e] * r) * (1.0f + s[e]);
        yv[v] = pack(f);
      }
    }
  } else {
    for (int c = tid; c < d; c += THREADS) {
      const float v = to_f32(xr[c]);
      ss += v * v;
    }
    r = 1.0f / sqrtf(row_sum<THREADS>(ss) / static_cast<float>(d) + eps);
    for (int c = tid; c < d; c += THREADS) {
      const float v = to_f32(xr[c]);
      yr[c] = from_f32<T>((v * r) * (1.0f + scale[c]));
    }
  }
  if (tid == 0) rstd[row] = r;
}

template <typename T, int THREADS, int NV, bool kVec>
int go(const void* x, const float* scale, void* y, float* rstd,
       long long rows, int d, float eps, cudaStream_t stream) {
  const long long per_block = THREADS == 32 ? kWarpBlock / 32 : 1;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_kernel<T, THREADS, NV, kVec>
      <<<static_cast<unsigned>(blocks), THREADS == 32 ? kWarpBlock : THREADS,
         0, stream>>>(static_cast<const T*>(x), scale, static_cast<T*>(y),
                      rstd, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation with NV vectors a thread, NV in 1..kMaxNV.
template <typename T, int THREADS, int NV = 1>
int go_vec(int nv_needed, const void* x, const float* scale, void* y,
           float* rstd, long long rows, int d, float eps,
           cudaStream_t stream) {
  if constexpr (NV > kMaxNV) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (nv_needed <= NV)
      return go<T, THREADS, NV, true>(x, scale, y, rstd, rows, d, eps,
                                      stream);
    return go_vec<T, THREADS, NV + 1>(nv_needed, x, scale, y, rstd, rows, d,
                                      eps, stream);
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* y, float* rstd,
           long long rows, int d, float eps, int vec, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const int nvec = d / W;
  const bool warp = d <= kWarpMaxValues;
  if (!vec)
    return warp ? go<T, 32, 1, false>(x, scale, y, rstd, rows, d, eps, stream)
                : go<T, 256, 1, false>(x, scale, y, rstd, rows, d, eps,
                                       stream);
  if (d % W != 0 || nvec > kMaxVecs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (warp)
    return go_vec<T, 32>((nvec + 31) / 32, x, scale, y, rstd, rows, d, eps,
                         stream);
  if (nvec <= 128 * kMaxNV)
    return go_vec<T, 128>((nvec + 127) / 128, x, scale, y, rstd, rows, d, eps,
                          stream);
  return go_vec<T, 256, 5>((nvec + 255) / 256, x, scale, y, rstd, rows, d,
                           eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec != 0 takes the vector path: the
// caller guarantees that x, y and scale are 16-byte aligned, that d is a
// multiple of the vector width and that the row has at most
// rmsnorm_max_vecs() vectors.  Returns a cudaError_t.
extern "C" int rmsnorm_fwd(int dtype, const void* x, const float* scale,
                           void* y, float* rstd, long long rows, int d,
                           float eps, int vec, void* stream) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, y, rstd, rows, d, eps, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, y, rstd, rows, d, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The widest row, in 16-byte vectors, that the vector path takes.
extern "C" int rmsnorm_max_vecs() { return kMaxVecs; }
