// Flash attention for Hopper: forward (K7) and the FlashAttention-2
// backward (K8: a dq pass and a dk/dv pass).
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attention.py:
// _flash_fwd_kernel (flash_attention_fwd, K7), _flash_dq_kernel and
// _flash_dkv_kernel (flash_attention_bwd, K8).
//
// Layout: q, k, v, out, dout, dq, dk, dv are (B, S, H, D) row-major with
// the kv heads already repeated to H; lse and delta are (B, H, S) f32.
// Positions are 0..S-1; a key is visible to a query when both lie below
// S, and (causal) k <= q, and (window > 0) q - k < window.  A masked
// score is the reference's finite NEG_INF = -1e30, so a fully masked
// row stays finite; l is clamped at 1e-30 as in the reference.
//
// Bound: tensor-core operations (4*B*H*S^2*D/2 for the causal forward,
// 8*B*H*S^2*D/2 for the backward's four products) — far above the bytes
// moved.  This first design does not reach the tensor cores: 64x64
// tiles in shared memory as f32, 256 threads, each owning 4 rows and
// every 16th column of a tile, f32 arithmetic on the CUDA cores, built
// with -fmad=false like every kernel here.  Tiles wholly above the
// diagonal or outside the window are skipped; the forward and dq grids
// start with the heaviest (last) query tiles.  Every output tile is
// owned by one thread block (dq by query tile, dk/dv by key tile): no
// atomics, so the result is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;          // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 16 x 16: ty owns rows, tx columns
constexpr int kPitchP = kB + 1; // pitch of a score tile in shared memory
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ bool visible(int q, int k, int S, int causal,
                                        int window) {
  if (q >= S || k >= S) return false;
  if (causal && k > q) return false;
  if (window > 0 && q - k >= window) return false;
  return true;
}

// Key tiles [lo, hi) that can hold a key visible to query tile qt.
__device__ __forceinline__ void key_range(int qt, int S, int causal,
                                          int window, int* lo, int* hi) {
  const int nt = (S + kB - 1) / kB;
  const int q_first = qt * kB;
  const int q_last = min(q_first + kB - 1, S - 1);
  *hi = causal ? min(nt, q_last / kB + 1) : nt;
  *lo = window > 0 ? max(0, (q_first - window + 1) / kB) : 0;
}

// Query tiles [lo, hi) that can see a key of key tile kt.
__device__ __forceinline__ void query_range(int kt, int S, int causal,
                                            int window, int* lo, int* hi) {
  const int nt = (S + kB - 1) / kB;
  const int k_first = kt * kB;
  const int k_last = min(k_first + kB - 1, S - 1);
  *lo = causal ? k_first / kB : 0;
  *hi = window > 0 ? min(nt, (k_last + window - 1) / kB + 1) : nt;
}

// Rows [r0, r0 + kB) of head (b, h) into a (kB, D + 1) f32 tile; rows at
// or past S read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long base, int r0, int S,
                                          int row_stride) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int s = r0 + r;
    dst[r * (D + 1) + c] =
        s < S ? to_f32(src[base + static_cast<long long>(s) * row_stride + c])
              : 0.0f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long base, int r0, int S) {
  for (int i = threadIdx.x; i < kB; i += kThreads)
    dst[i] = r0 + i < S ? src[base + r0 + i] : 0.0f;
}

// Max and sum over the 16 lanes that share a ty (one half-warp).
__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

// ---------------------------------------------------------------------------
// K7: forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int H, float scale,
                     int causal, int window) {
  constexpr int P = D + 1;
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kB * P;
  float* Vs = Ks + kB * P;
  float* Ps = Vs + kB * P;  // (kB, kPitchP)

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_stride = H * D;
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const int q0 = qt * kB;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D>(Qs, q, base, q0, S, row_stride);
  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.0f;
  }
  int lo, hi;
  key_range(qt, S, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile<T, D>(Ks, k, base, k0, S, row_stride);
    load_tile<T, D>(Vs, v, base, k0, S, row_stride);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bk[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x =
            visible(qi, k0 + tx + 16 * j, S, causal, window) ? s[i][j] * scale
                                                             : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * kPitchP + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float p[4], vv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kPitchP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] += p[i] * vv[c];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const long long o = base + static_cast<long long>(qi) * row_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      out[o + tx + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
    if (tx == 0)
      lse[static_cast<long long>(bh) * S + qi] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// K8, pass 1: dq, one block per query tile
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int H, float scale, int causal, int window) {
  constexpr int P = D + 1;
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * P;
  float* Ks = dOs + kB * P;
  float* Vs = Ks + kB * P;
  float* dSs = Vs + kB * P;        // (kB, kPitchP)
  float* lse_s = dSs + kB * kPitchP;
  float* delta_s = lse_s + kB;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_stride = H * D;
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const long long row_base = static_cast<long long>(bh) * S;
  const int q0 = qt * kB;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D>(Qs, q, base, q0, S, row_stride);
  load_tile<T, D>(dOs, dout, base, q0, S, row_stride);
  load_rows(lse_s, lse, row_base, q0, S);
  load_rows(delta_s, delta, row_base, q0, S);
  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.0f;
  int lo, hi;
  key_range(qt, S, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile<T, D>(Ks, k, base, k0, S, row_stride);
    load_tile<T, D>(Vs, v, base, k0, S, row_stride);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * P + d];
        g[i] = dOs[(ty * 4 + i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Ks[(tx + 16 * j) * P + d];
        bv[j] = Vs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[i] * bk[j];
          dp[i][j] += g[i] * bv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x =
            visible(q0 + r, k0 + c, S, causal, window) ? s[i][j] * scale
                                                       : kNegInf;
        const float p = expf(x - lse_s[r]);
        dSs[r * kPitchP + c] = (p * (dp[i][j] - delta_s[r])) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float ds[4], kv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * kPitchP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Ks[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] += ds[i] * kv[c];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const long long o = base + static_cast<long long>(qi) * row_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) dq[o + tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// K8, pass 2: dk and dv, one block per key tile
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, float scale,
                         int causal, int window) {
  constexpr int P = D + 1;
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * P;
  float* Qs = Vs + kB * P;
  float* dOs = Qs + kB * P;
  float* Pt = dOs + kB * P;        // (kB keys, kPitchP) = P transposed
  float* dSt = Pt + kB * kPitchP;  // dS transposed
  float* lse_s = dSt + kB * kPitchP;
  float* delta_s = lse_s + kB;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_stride = H * D;
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const long long row_base = static_cast<long long>(bh) * S;
  const int k0 = kt * kB;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D>(Ks, k, base, k0, S, row_stride);
  load_tile<T, D>(Vs, v, base, k0, S, row_stride);
  float dk_acc[4][CD], dv_acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;
  int lo, hi;
  query_range(kt, S, causal, window, &lo, &hi);
  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();
    load_tile<T, D>(Qs, q, base, q0, S, row_stride);
    load_tile<T, D>(dOs, dout, base, q0, S, row_stride);
    load_rows(lse_s, lse, row_base, q0, S);
    load_rows(delta_s, delta, row_base, q0, S);
    __syncthreads();
    // s[i][j]: key ty*4+i against query tx+16j (the forward's products
    // in the forward's order, so p is the forward's p).
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = Qs[(tx + 16 * j) * P + d];
        g[j] = dOs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bk[i] = Ks[(ty * 4 + i) * P + d];
        bv[i] = Vs[(ty * 4 + i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[j] * bk[i];
          dp[i][j] += g[j] * bv[i];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x =
            visible(q0 + c, k0 + r, S, causal, window) ? s[i][j] * scale
                                                       : kNegInf;
        const float p = expf(x - lse_s[c]);
        Pt[r * kPitchP + c] = p;
        dSt[r * kPitchP + c] = (p * (dp[i][j] - delta_s[c])) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kB; ++qq) {
      float p[4], ds[4], gv[CD], qv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Pt[(ty * 4 + i) * kPitchP + qq];
        ds[i] = dSt[(ty * 4 + i) * kPitchP + qq];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        gv[c] = dOs[qq * P + tx + 16 * c];
        qv[c] = Qs[qq * P + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[i][c] += p[i] * gv[c];
          dk_acc[i][c] += ds[i] * qv[c];
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty * 4 + i;
    if (ki >= S) continue;
    const long long o = base + static_cast<long long>(ki) * row_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[o + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dv[o + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kB * (D + 1) + kB * kPitchP);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kB * (D + 1) + kB * kPitchP + 2 * kB);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * kPitchP + 2 * kB);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int S, int H, float scale, int causal, int window,
        cudaStream_t stream) {
  const int rc = prepare(flash_fwd_kernel<T, D>, fwd_smem<D>());
  if (rc != 0) return rc;
  const dim3 grid((S + kB - 1) / kB, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        int B, int S, int H, float scale, int causal, int window,
        cudaStream_t stream) {
  int rc = prepare(flash_bwd_dq_kernel<T, D>, dq_smem<D>());
  if (rc != 0) return rc;
  rc = prepare(flash_bwd_dkv_kernel<T, D>, dkv_smem<D>());
  if (rc != 0) return rc;
  const dim3 grid((S + kB - 1) / kB, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, scale, causal, window);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, dkv_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

#define FLASH_DISPATCH(CALL)                                          \
  switch (head_dim) {                                                 \
    case 16: return dtype == 0 ? CALL(float, 16) : CALL(__nv_bfloat16, 16); \
    case 32: return dtype == 0 ? CALL(float, 32) : CALL(__nv_bfloat16, 32); \
    case 64: return dtype == 0 ? CALL(float, 64) : CALL(__nv_bfloat16, 64); \
    case 128:                                                         \
      return dtype == 0 ? CALL(float, 128) : CALL(__nv_bfloat16, 128); \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim one of 16, 32, 64, 128.
// Each returns a cudaError_t.
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* out,
                                   float* lse, int B, int S, int H,
                                   float scale, int causal, int window,
                                   void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_CALL(T, D) \
  fwd<T, D>(q, k, v, out, lse, B, S, H, scale, causal, window, st)
  FLASH_DISPATCH(FWD_CALL)
#undef FWD_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq, void* dk,
                                   void* dv, int B, int S, int H, float scale,
                                   int causal, int window, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_CALL(T, D)                                                    \
  bwd<T, D>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, scale, causal, \
            window, st)
  FLASH_DISPATCH(BWD_CALL)
#undef BWD_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
