// One-pass AdamW update for Hopper.
//
// Replaces the Pallas kernel _adamw_kernel of
// src/repro/kernels/fused_adamw.py (adamw_update, K5).  The update streams
// (p, g, m, v) once and writes (p', m', v'): 16n bytes read and 12n
// written in float32, against ~15 flops per element, so device-memory
// bandwidth bounds it.
//
// The design is built for the card's memory system.  On the vector path
// (all seven pointers 16-byte aligned) each thread takes two float4s of
// each input a grid stride apart, issues all eight loads before it
// computes anything, and writes p', m' and v' as float4s.  Loads and
// stores carry the streaming hint (.cs, evict first): every byte is
// touched once.  Each element is read and written by one thread only,
// and a thread reads all of its vectors before it writes any, so the
// outputs may alias the inputs (the optimizer updates in place); the
// aliasing pointers are therefore not __restrict__.  The ragged tail
// (n % 4 elements), and whole buffers that are not 16-byte aligned, take
// a scalar loop in the same kernel.  The grid has one thread per pair of
// vectors: measured on the H100, a one-wave grid looping over the
// buffer was slower than letting the block scheduler hand out blocks as
// SMs free up.
//
// Arithmetic follows src/repro/kernels/ref.py:adamw_update_ref term for
// term; the host passes the scalars already rounded to float32 (including
// 1-b1 and 1-b2 and the bias corrections).  Built with -fmad=false
// -prec-div=true -prec-sqrt=true, so each product and quotient rounds
// once, as in the plain torch version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ void update(float pi, float gi, float mi, float vi,
                                       const Hyper& h, float& p_out,
                                       float& m_out, float& v_out) {
  const float mn = h.b1 * mi + h.one_minus_b1 * gi;
  const float vn = h.b2 * vi + (h.one_minus_b2 * gi) * gi;
  const float upd = (mn / h.bc1) / (sqrtf(vn / h.bc2) + h.eps) + h.wd * pi;
  p_out = pi - h.lr * upd;
  m_out = mn;
  v_out = vn;
}

__device__ __forceinline__ void update4(const float4& p, const float4& g,
                                        const float4& m, const float4& v,
                                        const Hyper& h, float4& p_out,
                                        float4& m_out, float4& v_out) {
  update(p.x, g.x, m.x, v.x, h, p_out.x, m_out.x, v_out.x);
  update(p.y, g.y, m.y, v.y, h, p_out.y, m_out.y, v_out.y);
  update(p.z, g.z, m.z, v.z, h, p_out.z, m_out.z, v_out.z);
  update(p.w, g.w, m.w, v.w, h, p_out.w, m_out.w, v_out.w);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const float* p, const float* __restrict__ g, const float* m,
             const float* v, float* p_out, float* m_out, float* v_out,
             long long n, Hyper h) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long head = 0;                         // elements done as vectors
  if constexpr (kVec) {
    const long long nv = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    float4* po4 = reinterpret_cast<float4*>(p_out);
    float4* mo4 = reinterpret_cast<float4*>(m_out);
    float4* vo4 = reinterpret_cast<float4*>(v_out);
    for (long long i = tid; i < nv; i += 2 * stride) {
      const long long j = i + stride;
      const bool two = j < nv;
      float4 pv[2], gv[2], mv[2], vv[2];
      pv[0] = __ldcs(p4 + i);
      gv[0] = __ldcs(g4 + i);
      mv[0] = __ldcs(m4 + i);
      vv[0] = __ldcs(v4 + i);
      if (two) {
        pv[1] = __ldcs(p4 + j);
        gv[1] = __ldcs(g4 + j);
        mv[1] = __ldcs(m4 + j);
        vv[1] = __ldcs(v4 + j);
      }
      float4 po, mo, vo;
      update4(pv[0], gv[0], mv[0], vv[0], h, po, mo, vo);
      __stcs(po4 + i, po);
      __stcs(mo4 + i, mo);
      __stcs(vo4 + i, vo);
      if (two) {
        update4(pv[1], gv[1], mv[1], vv[1], h, po, mo, vo);
        __stcs(po4 + j, po);
        __stcs(mo4 + j, mo);
        __stcs(vo4 + j, vo);
      }
    }
    head = nv * 4;
  }
  for (long long i = head + tid; i < n; i += stride)
    update(p[i], g[i], m[i], v[i], h, p_out[i], m_out[i], v_out[i]);
}

template <bool kVec>
int launch(const float* p, const float* g, const float* m, const float* v,
           float* p_out, float* m_out, float* v_out, long long n,
           const Hyper& h, cudaStream_t stream) {
  // A thread takes two vectors (or one value of the scalar loop or the
  // tail, which has fewer than 4).
  const long long work = kVec ? (n / 4 + 1) / 2 + n % 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  adamw_kernel<kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      p, g, m, v, p_out, m_out, v_out, n, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec != 0 takes the vector path: the caller guarantees that all seven
// pointers are 16-byte aligned.
extern "C" int adamw_update_f32(const float* p, const float* g,
                                const float* m, const float* v, float* p_out,
                                float* m_out, float* v_out, long long n,
                                float lr, float b1, float one_minus_b1,
                                float b2, float one_minus_b2, float eps,
                                float wd, float bc1, float bc2, int vec,
                                void* stream) {
  const Hyper h{lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, bc1, bc2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(p, g, m, v, p_out, m_out, v_out, n, h, s)
             : launch<false>(p, g, m, v, p_out, m_out, v_out, n, h, s);
}
