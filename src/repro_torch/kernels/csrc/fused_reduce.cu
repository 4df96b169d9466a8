// Fused chunk reduction for Hopper: the paper's C2 on-device reduction.
//
// Replaces the Pallas kernel _reduce_kernel of
// src/repro/kernels/fused_reduce.py (fused_reduce, K4): (k, n) -> (n,), the
// k stacked chunks summed in float32 and cast to the output type.  It is
// the terminal sum of the parameter-server pattern (core/reducers.py
// ps_gather with fused hops), k = the ranks, n = a fusion bucket.
//
// Each input element is read once and each output written once against
// k-1 adds per column: ~0.125 operations per byte in float32, so
// device-memory bandwidth bounds it.  The TPU kernel tiles n in VMEM and
// pads n to its tile; here a grid-stride loop walks the columns and masks
// nothing, so n needs no padding:
//
//   reduce_vec     each thread owns the 16 bytes of one row's adjacent
//                  columns (4 float32 or 8 bfloat16) and loads every row
//                  as one 16-byte vector; taken when n is a multiple of
//                  that width and the base is 16-byte aligned, so every
//                  row starts aligned;
//   reduce_scalar  one column per thread, any n and alignment (a ragged
//                  bucket).
//
// Both add rows 0..k-1 in that order in float32 to a +0 start, as the
// plain torch version does and as XLA's reduce adds to its init value (a
// column of -0 sums to +0), and cast with round-to-nearest-even.  Built
// with -ftz=true (see kernels/backend.py): subnormal addends and sums flush
// to zero, as XLA's do on the CPU and the TPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

unsigned grid_for(long long units) {
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One 16-byte load of a row's columns, widened to float32.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {          // little-endian: low half first
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]),
                                            pack_bf16(v[2], v[3]));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

template <typename Tin, typename Tout>
__global__ void reduce_vec(const Tin* __restrict__ x, int k, long long n,
                           Tout* __restrict__ out) {
  constexpr int kVec = 16 / sizeof(Tin);
  const long long groups = n / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; g < groups; g += stride) {
    const long long c = g * kVec;
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < k; ++i) {
      float v[kVec];
      load_vec(x + static_cast<long long>(i) * n + c, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = acc[j] + v[j];
    }
    store_vec(out + c, acc);
  }
}

template <typename Tin, typename Tout>
__global__ void reduce_scalar(const Tin* __restrict__ x, int k, long long n,
                              Tout* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; c < n; c += stride) {
    float acc = 0.0f;
#pragma unroll 4
    for (int i = 0; i < k; ++i) {
      acc = acc + to_f32(x[static_cast<long long>(i) * n + c]);
    }
    store1(out + c, acc);
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, int k, long long n, void* out, int vec,
           cudaStream_t stream) {
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* o = static_cast<Tout*>(out);
  if (vec) {
    reduce_vec<Tin, Tout><<<grid_for(n / (16 / sizeof(Tin))), kThreads, 0,
                            stream>>>(xi, k, n, o);
  } else {
    reduce_scalar<Tin, Tout><<<grid_for(n), kThreads, 0, stream>>>(xi, k, n,
                                                                    o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_code / out_code: 0 = float32, 1 = bfloat16.  vec != 0 takes the
// 16-byte vector path; the caller guarantees n % (16 / sizeof(in)) == 0
// and a 16-byte-aligned x (out is a fresh allocation).
extern "C" int fused_reduce(int in_code, int out_code, const void* x, int k,
                            long long n, void* out, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (in_code == 0 && out_code == 0)
    return launch<float, float>(x, k, n, out, vec, s);
  if (in_code == 0 && out_code == 1)
    return launch<float, __nv_bfloat16>(x, k, n, out, vec, s);
  if (in_code == 1 && out_code == 0)
    return launch<__nv_bfloat16, float>(x, k, n, out, vec, s);
  if (in_code == 1 && out_code == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, k, n, out, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
