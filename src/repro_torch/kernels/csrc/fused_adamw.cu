// One-pass AdamW update for Hopper.
//
// Replaces the Pallas kernel _adamw_kernel of
// src/repro/kernels/fused_adamw.py (adamw_update, K5).  The update streams
// (p, g, m, v) once and writes (p', m', v'): 16n bytes read and 12n
// written in float32, against ~15 flops per element, so device-memory
// bandwidth bounds it.  A grid-stride loop over the flat buffer; each
// element is read and written by one thread only, so the outputs may alias
// the inputs (the optimizer updates in place).
//
// Arithmetic follows src/repro/kernels/ref.py:adamw_update_ref term for
// term; the host passes the scalars already rounded to float32 (including
// 1-b1 and 1-b2 and the bias corrections).  Built with -fmad=false
// -prec-div=true -prec-sqrt=true, so each product and quotient rounds
// once, as in the plain torch version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__global__ void adamw_kernel(const float* p, const float* __restrict__ g,
                             const float* m, const float* v, float* p_out,
                             float* m_out, float* v_out, long long n, float lr,
                             float b1, float one_minus_b1, float b2,
                             float one_minus_b2, float eps, float wd,
                             float bc1, float bc2) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; i < n; i += stride) {
    const float gi = g[i];
    const float pi = p[i];
    const float mn = b1 * m[i] + one_minus_b1 * gi;
    const float vn = b2 * v[i] + (one_minus_b2 * gi) * gi;
    const float upd = (mn / bc1) / (sqrtf(vn / bc2) + eps) + wd * pi;
    p_out[i] = pi - lr * upd;
    m_out[i] = mn;
    v_out[i] = vn;
  }
}

}  // namespace

extern "C" int adamw_update_f32(const float* p, const float* g,
                                const float* m, const float* v, float* p_out,
                                float* m_out, float* v_out, long long n,
                                float lr, float b1, float one_minus_b1,
                                float b2, float one_minus_b2, float eps,
                                float wd, float bc1, float bc2, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adamw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, p_out, m_out, v_out, n, lr, b1, one_minus_b1, b2,
      one_minus_b2, eps, wd, bc1, bc2);
  return static_cast<int>(cudaGetLastError());
}
