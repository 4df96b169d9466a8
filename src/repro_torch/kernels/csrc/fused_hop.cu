// Fused codec'd reduction hop for Hopper: the paper's GDR-Opt kernel.
//
// Replaces the Pallas kernels of src/repro/kernels/fused_hop.py:
//   absmax_kernel       <- _absmax_kernel       (hop_absmax, K1)
//   encode_kernel       <- _bf16/_int8/_fp8_encode_kernel (hop_encode, K2)
//   decode_add_kernel   <- _make_decode_add     (hop_decode_add, K3)
//
// All three are flat streaming passes over (n,) buffers, so they are
// bound by device-memory bytes: K1 reads 4n; K2 reads 4n and writes n
// (int8/fp8) or 2n (bf16); K3 reads n..4n of payload plus 4n of partial
// and writes 4n.  K1 and K3 are grid-stride loops of one element per
// thread per iteration over a fixed grid; the work per element is a
// handful of instructions.
//
// K2 is built for the card's memory system.  Its vector path (x and the
// payload 16-byte aligned) gives each thread units of 16 bytes of
// payload: 8 bf16 or 16 int8/fp8 values, read as 2 or 4 float4 loads
// that are all issued before any value is converted, then packed in
// registers into one 16-byte store.  Loads and stores carry the
// streaming hint (.cs, evict first): measured on the H100, K1 followed
// by the int8/fp8 pass was faster with the hints than without, though
// the pass alone was not; the likely reason is that the payload, which
// this kernel does not read back, then does not push out of L2 the part
// of x that K1 read last.  A tail of fewer than one unit, and a whole
// buffer that is not 16-byte aligned (a hop chunk may start at any
// 4-byte address), take a scalar loop in the same kernel.  The grid has
// one thread per unit: measured on the H100, a one-wave grid (SMs times
// the blocks an SM holds) looping over the units was slower, at every
// codec, than letting the block scheduler hand out blocks as SMs free
// up.
//
// K1 needs a reduction across blocks, which the TPU's sequential grid did
// not: each block reduces its partial max in registers and shared memory,
// then one atomicMax per block on the float's bit pattern.  |x| >= 0, so
// the unsigned order of the bits is the float order; max is order-free,
// so the result is exact, and a NaN (bits above 0x7f800000) propagates as
// jnp.max does.  Subnormals flush to zero, as XLA's do.
//
// The encode kernels derive the scale from the absmax on the card (no host
// round trip): safe = absmax > 0 ? absmax : 1; s = max(safe/127, FLT_MIN)
// (int8) or max(safe/448, FLT_MIN) (fp8), copying core/codec.py.  Built
// with -ftz=true -prec-div=true -fmad=false (see kernels/backend.py), so
// x/s and p*s + a round exactly as the plain torch versions do.
#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// A subnormal becomes a zero of the same sign (the reference's FTZ/DAZ).
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}

__device__ __forceinline__ unsigned abs_bits(float x) {
  unsigned b = __float_as_uint(x) & 0x7fffffffu;
  return b < 0x00800000u ? 0u : b;
}

__global__ void absmax_kernel(const float* __restrict__ x, long long n,
                              unsigned* __restrict__ out_bits) {
  __shared__ unsigned warp_max[kThreads / 32];
  unsigned m = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; i < n; i += stride) {
    m = max(m, abs_bits(x[i]));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(out_bits, m);
  }
}

__device__ __forceinline__ float hop_scale(const unsigned* absmax_bits,
                                           float denom) {
  const float a = __uint_as_float(*absmax_bits);
  const float safe = a > 0.0f ? a : 1.0f;
  return fmaxf(safe / denom, FLT_MIN);
}

// Round to nearest even, as torch's and XLA's f32 -> bf16 casts do; no
// arithmetic, so subnormals pass through like the reference's astype.
__device__ __forceinline__ uint16_t bf16_rne(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// The codecs of K2: the payload's element type and one value's encoding.
// Int8/Fp8 derive the scale from K1's bits; block 0 writes it once.
struct Bf16 {
  using Out = uint16_t;
  __device__ Bf16(const unsigned*, float*) {}
  __device__ Out operator()(float v) const { return bf16_rne(v); }
};

struct Int8 {
  using Out = uint8_t;
  float s;
  __device__ Int8(const unsigned* absmax_bits, float* scale_out)
      : s(hop_scale(absmax_bits, 127.0f)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;
  }
  __device__ Out operator()(float v) const {
    float q = rintf(flush(v) / s);                // half to even
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    return static_cast<uint8_t>(static_cast<int8_t>(q));
  }
};

// |x/s| <= 448 (plus rounding) because s = absmax/448, and on that range
// the saturating round-to-nearest-even cvt equals ml_dtypes' e4m3fn cast.
struct Fp8 {
  using Out = uint8_t;
  float s;
  __device__ Fp8(const unsigned* absmax_bits, float* scale_out)
      : s(hop_scale(absmax_bits, 448.0f)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;
  }
  __device__ Out operator()(float v) const {
    return static_cast<Out>(
        __nv_cvt_float_to_fp8(flush(v) / s, __NV_SATFINITE, __NV_E4M3));
  }
};

// 16 bytes of payload values, element 0 in the lowest byte.
template <typename Out, int kPer>
__device__ __forceinline__ uint4 pack(const Out (&o)[kPer]) {
  constexpr int kPerWord = 4 / sizeof(Out);
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = 0;
#pragma unroll
    for (int j = 0; j < kPerWord; ++j)
      w[k] |= static_cast<unsigned>(o[k * kPerWord + j])
              << (8 * sizeof(Out) * j);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// kVec: x and out are 16-byte aligned; units of kPer values, then the
// ragged tail.  Otherwise the scalar loop over all of x.
template <class Codec, bool kVec>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ x, long long n,
              const unsigned* __restrict__ absmax_bits,
              typename Codec::Out* __restrict__ out,
              float* __restrict__ scale_out) {
  using Out = typename Codec::Out;
  constexpr int kPer = 16 / sizeof(Out);          // values per store
  constexpr int kLoads = kPer / 4;                // float4 loads per store
  const Codec enc(absmax_bits, scale_out);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long head = 0;                             // values done as units
  if constexpr (kVec) {
    const long long units = n / kPer;
    const float4* xv = reinterpret_cast<const float4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long u = tid; u < units; u += stride) {
      float4 v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) v[k] = __ldcs(xv + u * kLoads + k);
      Out o[kPer];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        o[4 * k] = enc(v[k].x);
        o[4 * k + 1] = enc(v[k].y);
        o[4 * k + 2] = enc(v[k].z);
        o[4 * k + 3] = enc(v[k].w);
      }
      __stcs(ov + u, pack(o));
    }
    head = units * kPer;
  }
  for (long long i = head + tid; i < n; i += stride) out[i] = enc(x[i]);
}

template <class Codec, bool kVec>
int launch_encode(const float* x, long long n, const unsigned* absmax_bits,
                  void* out, float* scale_out, cudaStream_t stream) {
  using Out = typename Codec::Out;
  constexpr long long kPer = 16 / sizeof(Out);
  // One thread per unit (or per value of the scalar loop or the tail).
  const long long work = kVec ? (n / kPer > n % kPer ? n / kPer : n % kPer)
                              : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  encode_kernel<Codec, kVec><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(x, n, absmax_bits,
                                         static_cast<Out*>(out), scale_out);
  return static_cast<int>(cudaGetLastError());
}

template <class Codec>
int launch_codec(const float* x, long long n, const unsigned* absmax_bits,
                 void* out, float* scale_out, int vec,
                 cudaStream_t stream) {
  return vec ? launch_encode<Codec, true>(x, n, absmax_bits, out, scale_out,
                                          stream)
             : launch_encode<Codec, false>(x, n, absmax_bits, out, scale_out,
                                           stream);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {     // bf16 bits
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(uint8_t v) {      // e4m3fn bits
  __nv_fp8_e4m3 f;
  f.__x = v;
  return static_cast<float>(f);
}

// Branching on SCALED/ADD (rather than a unit scale or a zero addend)
// keeps the no-scale and no-add paths bit-identical to the reference:
// x + 0.0 would turn -0.0 into +0.0.
template <typename P, bool SCALED, bool ADD>
__global__ void decode_add_kernel(const P* __restrict__ payload,
                                  const float* __restrict__ scale,
                                  const float* add, float* out, long long n) {
  const float s = SCALED ? *scale : 1.0f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; i < n; i += stride) {
    float v = to_f32(payload[i]);
    if (SCALED) v = v * s;
    if (ADD) v = v + add[i];
    out[i] = v;
  }
}

template <typename P>
void launch_decode(const void* payload, const float* scale, const float* add,
                   float* out, long long n, cudaStream_t stream) {
  const P* p = static_cast<const P*>(payload);
  const unsigned grid = grid_for(n);
  if (scale && add)
    decode_add_kernel<P, true, true><<<grid, kThreads, 0, stream>>>(
        p, scale, add, out, n);
  else if (scale)
    decode_add_kernel<P, true, false><<<grid, kThreads, 0, stream>>>(
        p, scale, add, out, n);
  else if (add)
    decode_add_kernel<P, false, true><<<grid, kThreads, 0, stream>>>(
        p, scale, add, out, n);
  else
    decode_add_kernel<P, false, false><<<grid, kThreads, 0, stream>>>(
        p, scale, add, out, n);
}

}  // namespace

// Payload type codes shared with kernels/fused_hop.py.
enum { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

extern "C" int hop_absmax_f32(const float* x, long long n,
                              unsigned* out_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out_bits, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<<<grid_for(n), kThreads, 0, s>>>(x, n, out_bits);
  return static_cast<int>(cudaGetLastError());
}

// codec: kBF16, kI8 or kFP8.  absmax_bits/scale_out are unused for bf16.
// vec != 0 takes the vector path: the caller guarantees a 16-byte
// aligned x and out.
extern "C" int hop_encode_f32(int codec, const float* x, long long n,
                              const unsigned* absmax_bits, void* out,
                              float* scale_out, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (codec) {
    case kBF16:
      return launch_codec<Bf16>(x, n, absmax_bits, out, scale_out, vec, s);
    case kI8:
      return launch_codec<Int8>(x, n, absmax_bits, out, scale_out, vec, s);
    case kFP8:
      return launch_codec<Fp8>(x, n, absmax_bits, out, scale_out, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// scale and add may be null (the unscaled / no-add variants).
extern "C" int hop_decode_add(int ptype, const void* payload,
                              const float* scale, const float* add,
                              float* out, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ptype) {
    case kF32: launch_decode<float>(payload, scale, add, out, n, s); break;
    case kBF16: launch_decode<uint16_t>(payload, scale, add, out, n, s); break;
    case kI8: launch_decode<int8_t>(payload, scale, add, out, n, s); break;
    case kFP8: launch_decode<uint8_t>(payload, scale, add, out, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
