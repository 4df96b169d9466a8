// Flash attention for Hopper: forward (K7) and the FlashAttention-2
// backward (K8: a dq pass and a dk/dv pass).
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attention.py:
// _flash_fwd_kernel (flash_attention_fwd, K7), _flash_dq_kernel and
// _flash_dkv_kernel (flash_attention_bwd, K8), and the einsum for
// rowsum(dO∘O) that flash_attention_bwd runs before them (K8's delta
// kernel, flash_delta_kernel, below).
//
// Layout: q, out, dout, dq are (B, Sq, H, D) and k, v, dk, dv (B, Sk, H, D),
// row-major, with the kv heads already repeated to H; lse and delta are
// (B, H, Sq) f32.  Query row i stands at position q_off + i, key row j at
// j (the square case: Sq = Sk, q_off = 0; a sequence split over ranks
// gives each rank its queries at an offset against every key).  A key is
// visible to a query when both rows lie below Sq and Sk, and (causal)
// k <= q, and (window > 0) q - k < window, in positions.  A masked
// score is the reference's finite NEG_INF = -1e30, so a fully masked
// row stays finite; l is clamped at 1e-30 as in the reference.
//
// Bound: tensor-core operations (4*B*H*S^2*D/2 for the causal forward,
// 8*B*H*S^2*D/2 for the backward's four products) -- far above the bytes
// moved.  Common to both designs below: tiles wholly above the diagonal
// or outside the window are skipped and the partial ones masked; the
// forward and dq grids start with the heaviest (last) query tiles, the
// dk/dv grid with the heaviest (first) key tiles; every output tile is
// owned by one thread block (dq by query tile, dk/dv by key tile), so
// there are no atomics and two calls give the same bits.
//
// bfloat16 runs on the tensor cores (sm_90a). A block owns 128 rows
// (queries in the forward and the dq pass, keys in the dk/dv pass) and has
// two consumer warpgroups of 64 rows each plus a producer warpgroup whose
// first thread issues every copy; setmaxnreg lowers the producer to 24
// registers and raises the consumers to 240 (it trades registers between
// whole warpgroups, so a lone producer warp would leave the consumers at
// 168 and the dk/dv pass spilling). The producer brings the block's own
// tiles in once and streams the other side's 64-row tiles (K/V, or Q/dO in
// the dk/dv pass) through a 2-stage shared-memory ring with TMA;
// full/empty mbarriers hand each stage over. Every product is a
// wgmma.mma_async with bf16 operands and f32 accumulators: S = Q K^T, dP =
// dO V^T, S^T = K Q^T and dP^T = V dO^T from shared memory; P V, dS K, P^T
// dO and dS^T Q with P or dS from registers, rounded to bf16 (as
// FlashAttention-2/3 do), and the shared-memory operand read N-major
// through the descriptor's transpose bit. m, l, the softmax (in base 2)
// and the outputs stay f32. TMA writes each tile in the swizzle that the
// wgmma descriptors name: 128-byte rows at D = 64 (two or four boxes of
// 64 columns at D = 128 or 256), 64-byte at D = 32 (three boxes of 32
// columns at D = 96), 32-byte at D = 16.
// The tensor maps' outer extent is S per (batch, head), so rows past S
// arrive as zeros. The wrapper checks that every pointer is 16-byte
// aligned (TMA's rule; the row stride H*D*2 always is).
//
// At D = 256 (gemma-7b) the forward has a design of its own
// (flash_fwd_wide_tc: 64 KiB of Q and a 128 KiB ring whose K and V have
// slots and barriers of their own, P V at N = 256), and so has the
// backward at D = 96 (phi-3-vision; flash_dq_full_tc, flash_dkv_full_tc:
// each accumulating product one m64n96k16 instruction, lse and delta of
// the streamed tile in shared memory); both compute what the design
// above computes, in the same order.  The backward at D = 256 has a
// design of its own (flash_dq_wide_tc, flash_dkv_wide_tc):
// 128 own rows would take 128 KiB beside the ring, and the dk/dv pass
// would hold dK and dV in 2 x 128 f32 registers a thread.  A block owns
// 64 rows, streams the other side in 64-row tiles, and its two consumer
// warpgroups split each tile by columns: each forms its half of the score
// products, the halves of P and dS meet in shared memory, and each
// warpgroup accumulates its half of the head dimension (WideSmem below).
// P and dS round to bf16 as at other widths.
//
// float32 stays on the CUDA cores: the tensor cores would take it only as
// TF32 (about 3 digits), which the f32 tolerances refuse.  Its kernels
// use R x R f32 tiles in shared memory (R = 64; 32 in the backward at
// D = 256), 256 threads each owning R/16 rows and every 16th column of a
// tile, built with -fmad=false like every kernel here.  The C entry
// points send bfloat16 to the tensor-core kernels and float32 to these;
// neither falls back to the other.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes via dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {


constexpr int kB = 64;          // rows of an f32 forward tile (queries, keys)
constexpr int kThreads = 256;   // 16 x 16: ty owns rows, tx columns
constexpr float kNegInf = -1e30f;

// Rows of an f32 backward tile at head_dim D: 64 up to 128; at 256 four
// (64, 257) f32 tiles alone take 263 KB of the 227 KB a block may have,
// so the backward tiles by 32 rows (136 KB for dq, 140 KB for dk/dv).
template <int D>
constexpr int f32_bwd_rows() {
  return D > 128 ? 32 : 64;
}

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// The rows of one call: sq queries at positions qoff .. qoff + sq - 1,
// sk keys at 0 .. sk - 1.
struct Seqs {
  int sq, sk, qoff;
};

// The rows as a kernel sees them.  Every kernel comes in two builds: the
// square one (OFF false) folds sk = sq and qoff = 0 at compile time, so
// its code is the square kernel's; the other takes any sq, sk and qoff.
template <bool OFF>
__device__ __forceinline__ Seqs rows_of(Seqs s) {
  return OFF ? s : Seqs{s.sq, s.sq, 0};
}

// Query row q (its position q + qoff) against key row k.
__device__ __forceinline__ bool visible(int q, int k, Seqs L, int causal,
                                        int window) {
  if (q >= L.sq || k >= L.sk) return false;
  const int qp = q + L.qoff;
  if (causal && k > qp) return false;
  if (window > 0 && qp - k >= window) return false;
  return true;
}

// Key tiles (`tile` rows each) [lo, hi) that can hold a key visible to a
// query row in [q_first, q_first + n); empty when no such row lies below
// sq.
__device__ __forceinline__ void keys_for(int q_first, int n, int tile, Seqs L,
                                         int causal, int window, int* lo,
                                         int* hi) {
  *lo = *hi = 0;
  if (q_first >= L.sq) return;
  const int nt = (L.sk + tile - 1) / tile;
  const int q_last = min(q_first + n - 1, L.sq - 1) + L.qoff;
  *hi = causal ? min(nt, q_last / tile + 1) : nt;
  *lo = window > 0 ? max(0, (q_first + L.qoff - window + 1) / tile) : 0;
}

// Query-row tiles (`tile` rows each) [lo, hi) that can see a key in
// [k_first, k_first + n); empty when no such key lies below sk.
__device__ __forceinline__ void queries_for(int k_first, int n, int tile,
                                            Seqs L, int causal, int window,
                                            int* lo, int* hi) {
  *lo = *hi = 0;
  if (k_first >= L.sk) return;
  const int nt = (L.sq + tile - 1) / tile;
  const int k_last = min(k_first + n - 1, L.sk - 1);
  *lo = causal ? max(0, k_first - L.qoff) / tile : 0;
  const int q_last = k_last + window - 1 - L.qoff;  // the last row that sees
  *hi = window <= 0 ? nt : (q_last < 0 ? 0 : min(nt, q_last / tile + 1));
}

// Rows [r0, r0 + R) of head (b, h) into an (R, D + 1) f32 tile; rows at
// or past S read as zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long base, int r0, int S,
                                          int row_stride) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int s = r0 + r;
    dst[r * (D + 1) + c] =
        s < S ? to_f32(src[base + static_cast<long long>(s) * row_stride + c])
              : 0.0f;
  }
}

template <int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long base, int r0, int S) {
  for (int i = threadIdx.x; i < R; i += kThreads)
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

// The f32 kernels tile by R rows (queries and keys alike): thread (ty, tx)
// owns rows ty*RI .. ty*RI + RI-1 of a tile (RI = R/16) and, of an (R, R)
// score tile, columns tx + 16 j (j < RI); of a (R, D) output, columns
// tx + 16 c (c < D/16).

// ---------------------------------------------------------------------------
// K7: forward
// ---------------------------------------------------------------------------

template <typename T, int D, int R, bool OFF>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, Seqs seqs, int H, float scale,
                     int causal, int window) {
  const Seqs L = rows_of<OFF>(seqs);
  constexpr int P = D + 1;
  constexpr int PP = R + 1;  // pitch of a score tile in shared memory
  constexpr int CD = D / 16;
  constexpr int RI = R / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + R * P;
  float* Vs = Ks + R * P;
  float* Ps = Vs + R * P;  // (R, PP)

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_stride = H * D;
  const long long qbase = (static_cast<long long>(b) * L.sq * H + h) * D;
  const long long kbase = (static_cast<long long>(b) * L.sk * H + h) * D;
  const int q0 = qt * R;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D, R>(Qs, q, qbase, q0, L.sq, row_stride);
  float m[RI], l[RI], acc[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.0f;
  }
  int lo, hi;
  keys_for(q0, R, R, L, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_tile<T, D, R>(Ks, k, kbase, k0, L.sk, row_stride);
    load_tile<T, D, R>(Vs, v, kbase, k0, L.sk, row_stride);
    __syncthreads();
    float s[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RI], bk[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = Qs[(ty * RI + i) * P + d];
#pragma unroll
      for (int j = 0; j < RI; ++j) bk[j] = Ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] += a[i] * bk[j];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty * RI + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const float x =
            visible(qi, k0 + tx + 16 * j, L, causal, window) ? s[i][j] * scale
                                                             : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * RI + i) * PP + tx + 16 * j] = p;
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
    for (int kk = 0; kk < R; ++kk) {
      float p[RI], vv[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = Ps[(ty * RI + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] += p[i] * vv[c];
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty * RI + i;
    if (qi >= L.sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const long long o = qbase + static_cast<long long>(qi) * row_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      out[o + tx + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
    if (tx == 0)
      lse[static_cast<long long>(bh) * L.sq + qi] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// K8, pass 1: dq, one block per query tile
// ---------------------------------------------------------------------------

template <typename T, int D, int R, bool OFF>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Seqs seqs, int H, float scale, int causal, int window) {
  const Seqs L = rows_of<OFF>(seqs);
  constexpr int P = D + 1;
  constexpr int PP = R + 1;
  constexpr int CD = D / 16;
  constexpr int RI = R / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + R * P;
  float* Ks = dOs + R * P;
  float* Vs = Ks + R * P;
  float* dSs = Vs + R * P;        // (R, PP)
  float* lse_s = dSs + R * PP;
  float* delta_s = lse_s + R;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_stride = H * D;
  const long long qbase = (static_cast<long long>(b) * L.sq * H + h) * D;
  const long long kbase = (static_cast<long long>(b) * L.sk * H + h) * D;
  const long long row_base = static_cast<long long>(bh) * L.sq;
  const int q0 = qt * R;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D, R>(Qs, q, qbase, q0, L.sq, row_stride);
  load_tile<T, D, R>(dOs, dout, qbase, q0, L.sq, row_stride);
  load_rows<R>(lse_s, lse, row_base, q0, L.sq);
  load_rows<R>(delta_s, delta, row_base, q0, L.sq);
  float acc[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.0f;
  int lo, hi;
  keys_for(q0, R, R, L, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_tile<T, D, R>(Ks, k, kbase, k0, L.sk, row_stride);
    load_tile<T, D, R>(Vs, v, kbase, k0, L.sk, row_stride);
    __syncthreads();
    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RI], g[RI], bk[RI], bv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        a[i] = Qs[(ty * RI + i) * P + d];
        g[i] = dOs[(ty * RI + i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        bk[j] = Ks[(tx + 16 * j) * P + d];
        bv[j] = Vs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] += a[i] * bk[j];
          dp[i][j] += g[i] * bv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty * RI + i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const float x =
            visible(q0 + r, k0 + c, L, causal, window) ? s[i][j] * scale
                                                       : kNegInf;
        const float p = expf(x - lse_s[r]);
        dSs[r * PP + c] = (p * (dp[i][j] - delta_s[r])) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
      float ds[RI], kv[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = dSs[(ty * RI + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Ks[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] += ds[i] * kv[c];
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty * RI + i;
    if (qi >= L.sq) continue;
    const long long o = qbase + static_cast<long long>(qi) * row_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) dq[o + tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// K8, pass 2: dk and dv, one block per key tile
// ---------------------------------------------------------------------------

template <typename T, int D, int R, bool OFF>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, Seqs seqs, int H, float scale,
                         int causal, int window) {
  const Seqs L = rows_of<OFF>(seqs);
  constexpr int P = D + 1;
  constexpr int PP = R + 1;
  constexpr int CD = D / 16;
  constexpr int RI = R / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + R * P;
  float* Qs = Vs + R * P;
  float* dOs = Qs + R * P;
  float* Pt = dOs + R * P;        // (R keys, PP) = P transposed
  float* dSt = Pt + R * PP;       // dS transposed
  float* lse_s = dSt + R * PP;
  float* delta_s = lse_s + R;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_stride = H * D;
  const long long qbase = (static_cast<long long>(b) * L.sq * H + h) * D;
  const long long kbase = (static_cast<long long>(b) * L.sk * H + h) * D;
  const long long row_base = static_cast<long long>(bh) * L.sq;
  const int k0 = kt * R;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D, R>(Ks, k, kbase, k0, L.sk, row_stride);
  load_tile<T, D, R>(Vs, v, kbase, k0, L.sk, row_stride);
  float dk_acc[RI][CD], dv_acc[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;
  int lo, hi;
  queries_for(k0, R, R, L, causal, window, &lo, &hi);
  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * R;
    __syncthreads();
    load_tile<T, D, R>(Qs, q, qbase, q0, L.sq, row_stride);
    load_tile<T, D, R>(dOs, dout, qbase, q0, L.sq, row_stride);
    load_rows<R>(lse_s, lse, row_base, q0, L.sq);
    load_rows<R>(delta_s, delta, row_base, q0, L.sq);
    __syncthreads();
    // s[i][j]: key ty*RI+i against query tx+16j (the forward's products
    // in the forward's order, so p is the forward's p).
    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RI], g[RI], bk[RI], bv[RI];
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        a[j] = Qs[(tx + 16 * j) * P + d];
        g[j] = dOs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        bk[i] = Ks[(ty * RI + i) * P + d];
        bv[i] = Vs[(ty * RI + i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] += a[j] * bk[i];
          dp[i][j] += g[j] * bv[i];
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty * RI + i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const float x =
            visible(q0 + c, k0 + r, L, causal, window) ? s[i][j] * scale
                                                       : kNegInf;
        const float p = expf(x - lse_s[c]);
        Pt[r * PP + c] = p;
        dSt[r * PP + c] = (p * (dp[i][j] - delta_s[c])) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < R; ++qq) {
      float p[RI], ds[RI], gv[CD], qv[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        p[i] = Pt[(ty * RI + i) * PP + qq];
        ds[i] = dSt[(ty * RI + i) * PP + qq];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        gv[c] = dOs[qq * P + tx + 16 * c];
        qv[c] = Qs[qq * P + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[i][c] += p[i] * gv[c];
          dk_acc[i][c] += ds[i] * qv[c];
        }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int ki = k0 + ty * RI + i;
    if (ki >= L.sk) continue;
    const long long o = kbase + static_cast<long long>(ki) * row_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[o + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dv[o + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// K8's rowsum(dO∘O): delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d]
// ---------------------------------------------------------------------------
//
// Replaces the einsum that src/repro/kernels/flash_attention.py:220 runs
// before K8's two pallas_calls (in the port: _delta, two f32 copies of O
// and dO written and read back).  Bound: bytes, 2*B*S*H*D*size read and
// 4*B*H*S written (0.015 ms at phi-3-vision's (1, 4096, 32, 96) bf16 over
// 3.35 TB/s).  Design: LPR lanes a row, each reading every LPR-th 16-byte
// vector of it (dh 96 bf16: 12 vectors, 4 lanes of 3), the products and
// the sum in f32 in a fixed order (a lane's vectors, then its elements;
// then a butterfly over the row's lanes), so two calls give the same bits.
// A block's rows are consecutive positions of one (b, h), so its f32
// writes coalesce.  vec 0 reads element by element (an f32 view off a
// 16-byte boundary), in the same order.

template <typename T, int D>
struct DeltaGeo {
  static constexpr int VE = 16 / sizeof(T);    // elements of a vector
  static constexpr int NV = D / VE;            // vectors of a row
  static constexpr int LPR = NV < 4 ? NV : 4;  // lanes of a row
  static constexpr int PER = NV / LPR;         // vectors of a lane
  static constexpr int ROWS = kThreads / LPR;  // rows of a block
  static_assert(NV % LPR == 0 && 32 % LPR == 0, "a row splits over lanes");
};

// The 16 bytes at p as f32: four floats, or eight bf16 widened exactly.
__device__ __forceinline__ void load16(float (&f)[4], const float* p,
                                       int vec) {
  if (vec) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __ldg(p + e);
  }
}
__device__ __forceinline__ void load16(float (&f)[8],
                                       const __nv_bfloat16* p, int vec) {
  uint32_t w[4];
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __ldg(h + 2 * i) | (static_cast<uint32_t>(__ldg(h + 2 * i + 1))
                                 << 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int S, int H, int vec) {
  using G = DeltaGeo<T, D>;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x % G::LPR;
  const int s = blockIdx.y * G::ROWS + threadIdx.x / G::LPR;
  float acc = 0.0f;
  if (s < S) {
    const long long row = ((static_cast<long long>(b) * S + s) * H + h) * D;
#pragma unroll
    for (int i = 0; i < G::PER; ++i) {
      const int c = (lane + i * G::LPR) * G::VE;
      float o[G::VE], g[G::VE];
      load16(o, out + row + c, vec);
      load16(g, dout + row + c, vec);
#pragma unroll
      for (int e = 0; e < G::VE; ++e) acc += g[e] * o[e];
    }
  }
#pragma unroll
  for (int off = G::LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (s < S && lane == 0) delta[static_cast<long long>(bh) * S + s] = acc;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: wgmma, TMA and mbarriers (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kTile = 64;     // rows of a warpgroup, and of a streamed tile
constexpr int kOwn = 128;     // rows a block owns: two consumer warpgroups
constexpr int kStages = 2;    // depth of the shared-memory ring
constexpr int kConsumers = 256;
// + a producer warpgroup, of which one thread issues the copies.
// setmaxnreg trades registers between whole warpgroups: with the
// launch's 168 a thread (65536 over 384 threads), the producer's drop to
// 24 frees 144 x 128, which the consumers take as 240 - 168 = 72 x 256.
constexpr int kTcThreads = kConsumers + 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// A wait that outlasts this many cycles (~9 s at 1.98 GHz) traps (or
// faults, in the wide kernels: mbar_wait): a lost copy then fails the
// launch instead of hanging the card.
constexpr long long kWaitLimit = 1ll << 34;
constexpr uint32_t kSmemLimit = 232448;  // opt-in shared memory of a block

// A row of D bf16 is cut into NB boxes of CW columns, the widest of 64,
// 32 and 16 that divides D (96 = 3 x 32: three 64-byte boxes); each box
// is one swizzle atom wide (ROWB bytes), and a tile of R rows keeps its
// boxes one after another, each R x ROWB bytes.
template <int D>
struct Geo {
  static constexpr int CW = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
  static constexpr int NB = D / CW;
  static_assert(D % 16 == 0 && NB * CW == D,
                "a bf16 row must split into whole swizzle boxes");
  static constexpr int ROWB = 2 * CW;
  // descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
  static constexpr uint32_t SWZ = ROWB == 128 ? 1u : (ROWB == 64 ? 2u : 3u);
  static constexpr uint32_t SBO = 8 * ROWB;  // bytes between 8-row groups
  static constexpr int KSTEPS = D / 16;
};

// Shared memory: NOWN own tiles of OWN rows, then kStages stages of two
// streamed tiles of TN rows, then the mbarriers (own, full[], empty[]).
// Every tile starts on a 1024-byte boundary (the 128-byte swizzle's
// period), so TMA and wgmma agree on the swizzle.
template <int D, int NOWN, int OWN, int TN>
struct Smem {
  static constexpr uint32_t own = OWN * D * 2;
  static constexpr uint32_t tile = TN * D * 2;
  static constexpr uint32_t stream = NOWN * own;
  static constexpr uint32_t bars = stream + kStages * 2 * tile;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

// The bf16 backward above head_dim 128 (the "wide" kernels).  Up to 128 a
// block owns 128 rows (two consumer warpgroups of 64) and streams the
// other side in 64-row tiles.  At 256 that needs 2 x 64 KiB of own tiles
// plus a 128 KiB ring, past the 227 KiB a block may have, and the dk/dv
// pass would hold dK and dV in 2 x 128 f32 registers a thread.  So a wide
// block owns 64 rows (2 x 32 KiB) beside the same 128 KiB ring, and after
// them come NX exchange tiles of 64 x 64 bf16 (8 KiB each): the halves of
// P and dS that the two consumer warpgroups form, double-buffered (NX =
// 2 for dS in the dq pass, 4 for P^T and dS^T in the dk/dv pass), then
// the mbarriers.
template <int D>
constexpr bool kWide = D > 128;

template <int D, int NX>
struct WideSmem {
  using S = Smem<D, 2, kTile, kTile>;
  static constexpr uint32_t xtile = kTile * kTile * 2;
  static constexpr uint32_t xch = S::bars;  // the exchange tiles
  static constexpr uint32_t bars = xch + NX * xtile;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

// The bf16 forward at head_dim 256 (flash_fwd_wide_tc): Smem<D, 1, kOwn,
// kTile>'s tiles, its ring's K and V slots each with barriers of their
// own (two rings of kStages).
template <int D>
struct FwdWideSmem {
  using S = Smem<D, 1, kOwn, kTile>;
  static constexpr uint32_t bars = S::bars;
  static constexpr uint32_t bytes = bars + 8 * (1 + 4 * kStages) + 1024;
};

// The bf16 backward at head_dim 96 (the "full" kernels: each product's N
// spans the whole head width).  The dk/dv pass keeps, after Smem<D, 2,
// kOwn, kTile>'s tiles, each consumer warpgroup's lse (base 2) and delta
// of the streamed query tile, double-buffered: 2 x 2 x 2 x 64 f32.
template <int D>
constexpr bool kFull = D == 96;

template <int D>
struct FullSmem {
  using S = Smem<D, 2, kOwn, kTile>;
  static constexpr uint32_t rows = S::bars;
  static constexpr uint32_t bars = rows + 2 * 2 * 2 * kTile * 4;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
struct TcSmem {
  static constexpr uint32_t fwd =
      kWide<D> ? FwdWideSmem<D>::bytes : Smem<D, 1, kOwn, kTile>::bytes;
  static constexpr uint32_t dq =
      kWide<D> ? WideSmem<D, 2>::bytes : Smem<D, 2, kOwn, kTile>::bytes;
  static constexpr uint32_t dkv =
      kWide<D> ? WideSmem<D, 4>::bytes
               : (kFull<D> ? FullSmem<D>::bytes
                           : Smem<D, 2, kOwn, kTile>::bytes);
  static_assert(fwd <= kSmemLimit && dq <= kSmemLimit && dkv <= kSmemLimit,
                "a tensor-core kernel's tiles exceed the shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// After the own tiles' barrier, each ring r (one in most kernels; K and V
// apart in flash_fwd_wide_tc) has kStages full barriers, then kStages
// empty ones.
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s,
                                             int r = 0) {
  return bars + 8 * (1 + 2 * kStages * r + s);
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s,
                                              int r = 0) {
  return full_bar(bars, s, r) + 8 * kStages;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// kFault: a wait past kWaitLimit ends the launch with a store to address
// 0 (an illegal-address fault, cudaError 700) instead of __trap().  With
// a trap on that path ptxas spills bodies that fit setmaxnreg's 240
// without one (the wide dk/dv pass stops at R165 and spills; with the
// store it reaches R198 and spills nothing), so the wide kernels take the
// store (PERF.md, PR 17).
template <bool kFault = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWaitLimit) {
      if constexpr (kFault)
        asm volatile("st.global.u32 [%0], 0;\n" ::"l"(0ull) : "memory");
      else
        __trap();
    }
  }
}

// One box of a (B, S, H, D) tensor: columns [c0, c0 + CW) of head h,
// rows [s0, s0 + box rows) of batch b.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int h, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(h),
      "r"(s0), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A shared-memory matrix descriptor: start address, leading byte offset
// 16 (unused by these swizzled layouts), stride byte offset between
// 8-row groups, swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t swz) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swz) << 62);
}

// K-major operand: rows [row0, row0 + 64) of a tile of `rows` rows, the
// 16 columns of step ks along the reduction (D).  Within a box the step
// moves the start by 32 bytes; the hardware swizzles the address.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0,
                                           int ks) {
  using G = Geo<D>;
  const int c = ks * 16;
  return make_desc(tile + (c / G::CW) * rows * G::ROWB + row0 * G::ROWB +
                       (c % G::CW) * 2,
                   G::SBO, G::SWZ);
}

// N-major operand (the transpose bit): rows [16 ks, 16 ks + 16) of a tile
// run along the reduction, the CW columns of box nb along N.
template <int D>
__device__ __forceinline__ uint64_t desc_n(uint32_t tile, int rows, int ks,
                                           int nb) {
  using G = Geo<D>;
  return make_desc(tile + nb * rows * G::ROWB + ks * 16 * G::ROWB, G::SBO,
                   G::SWZ);
}

// N-major operand several boxes wide (N a multiple of CW: as many boxes
// as the product's N spans): as desc_n from box nb, each next box one
// leading byte offset (rows * ROWB) further along N.
template <int D>
__device__ __forceinline__ uint64_t desc_nx(uint32_t tile, int rows, int ks,
                                            int nb = 0) {
  using G = Geo<D>;
  const uint64_t lbo = static_cast<uint64_t>((rows * G::ROWB) >> 4) << 16;
  return (desc_n<D>(tile, rows, ks, nb) & ~(0x3FFFull << 16)) | lbo;
}

// D (64xN, f32) (+)= A (64x16, smem) * B (16xN, smem, K-major); N is 64
// (32 accumulators a thread) or 32 (16).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64xN, f32) += A (64x16, registers) * B (16xN, smem, N-major:
// the transpose bit set).  N is the width of one swizzle box (16, 32,
// 64), or of the whole row (96, 256).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// N = 96 and 256: one instruction over three or four swizzle boxes (the
// B descriptor from desc_nx).
__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64x128, f32) += A (64x16, smem, K-major) * B (16x128, smem, N-major:
// the transpose bit set, two swizzle boxes LBO bytes apart).
__device__ __forceinline__ void wgmma_ss_n(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The wide kernels' consumer warpgroups meet at named barrier 1 (the
// producer warpgroup has left by then).  A thread that stored to an
// exchange tile fences its stores into the async proxy first, since the
// next products read the tile through wgmma.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Stores the bf16 pair v at row r, columns c and c + 1 (c even) of a 64 x
// 64 bf16 exchange tile, in the 128-byte swizzle that desc_k<64> reads.
__device__ __forceinline__ void st_xch(uint32_t tile, int r, int c,
                                       uint32_t v) {
  const uint32_t off = r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(tile + off), "r"(v)
               : "memory");
}

// Accumulator fragments (m64nN, f32): in a warpgroup, warp w holds rows
// 16w..16w+15; lane (g = lane/4, t = lane%4) holds element e at row
// 16w + g + 8*((e>>1)&1), column 8*(e>>2) + 2t + (e&1).  Elements 8kk..
// 8kk+7 of a 64-column accumulator, packed in pairs, are exactly the A
// fragment of reduction step kk of the next product.

// Whether every (query, key) pair of queries [q0, q0 + nq) and keys
// [k0, k0 + nk) is visible, so the tile needs no mask.
__device__ __forceinline__ bool all_visible(int q0, int nq, int k0, int nk,
                                            Seqs L, int causal, int window) {
  return q0 + nq <= L.sq && k0 + nk <= L.sk &&
         (!causal || k0 + nk - 1 <= q0 + L.qoff) &&
         (window <= 0 || q0 + L.qoff + nq - 1 - k0 < window);
}

// Barriers (of `rings` rings), then the roles split for good: the
// producer warp returns when its copies are issued; the consumers never
// meet it at a __syncthreads.
__device__ __forceinline__ uint32_t setup(unsigned char* raw,
                                          uint32_t bar_off,
                                          uint32_t* base, int rings = 1) {
  const uint32_t b0 = smem_u32(raw);
  *base = (b0 + 1023u) & ~1023u;
  const uint32_t bars = *base + bar_off;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int r = 0; r < rings; ++r)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full_bar(bars, s, r), 1);
        mbar_init(empty_bar(bars, s, r), kConsumers);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bars;
}

// The producer (one thread): the block's own tiles of OWN rows (own0,
// and own1 when NOWN is 2) from row `own_row`, then TN-row tiles lo..hi-1
// of the streamed pair (str0, str1) through the ring.  kFault as in
// mbar_wait.
template <int D, int NOWN, int OWN, int TN, bool kFault = false>
__device__ __forceinline__ void produce(uint32_t base, uint32_t bars,
                                        const CUtensorMap* own0,
                                        const CUtensorMap* own1,
                                        const CUtensorMap* str0,
                                        const CUtensorMap* str1, int h, int b,
                                        int own_row, int lo, int hi) {
  using G = Geo<D>;
  using L = Smem<D, NOWN, OWN, TN>;
  mbar_expect_tx(bars, NOWN * L::own);
  for (int nb = 0; nb < G::NB; ++nb) {
    tma_load(base + nb * OWN * G::ROWB, own0, bars, nb * G::CW, h, own_row,
             b);
    if (NOWN == 2)
      tma_load(base + L::own + nb * OWN * G::ROWB, own1, bars, nb * G::CW,
               h, own_row, b);
  }
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    mbar_wait<kFault>(empty_bar(bars, s), ((i / kStages) & 1) ^ 1);
    mbar_expect_tx(full_bar(bars, s), 2 * L::tile);
    const uint32_t st = base + L::stream + s * 2 * L::tile;
    for (int nb = 0; nb < G::NB; ++nb) {
      tma_load(st + nb * TN * G::ROWB, str0, full_bar(bars, s),
               nb * G::CW, h, j * TN, b);
      tma_load(st + L::tile + nb * TN * G::ROWB, str1, full_bar(bars, s),
               nb * G::CW, h, j * TN, b);
    }
  }
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// Stores rows `row` and `row + 8` (this lane's) of a 64 x D accumulator
// set acc[NB][CW/2], divided per row by div[], as bf16 into a (B, S, H, D)
// tensor at element offset `base`; rows at or past S are skipped.
template <int D>
__device__ __forceinline__ void store_rows(
    __nv_bfloat16* __restrict__ dst, long long base, long long row_stride,
    int row, int S, const float (&acc)[Geo<D>::NB][Geo<D>::CW / 2],
    const float (&div)[2]) {
  using G = Geo<D>;
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    if (r >= S) continue;
    __nv_bfloat16* out = dst + base + r * row_stride;
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
      for (int n8 = 0; n8 < G::CW / 8; ++n8) {
        const int e = 4 * n8 + 2 * hf;
        *reinterpret_cast<uint32_t*>(out + nb * G::CW + 8 * n8 + 2 * t) =
            pack_bf16(acc[nb][e] / div[hf], acc[nb][e + 1] / div[hf]);
      }
  }
}

// Stores rows `row` and `row + 8` (this lane's) of a 64 x 128 accumulator
// (an m64n128 fragment) as bf16 into columns [col0, col0 + 128) of a
// (B, S, H, D) tensor at element offset `base`; rows at or past S are
// skipped.
__device__ __forceinline__ void store_half(__nv_bfloat16* __restrict__ dst,
                                           long long base,
                                           long long row_stride, int row,
                                           int S, int col0,
                                           const float (&acc)[64]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    if (r >= S) continue;
    __nv_bfloat16* out = dst + base + r * row_stride + col0;
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      const int e = 4 * n8 + 2 * hf;
      *reinterpret_cast<uint32_t*>(out + 8 * n8 + 2 * t) =
          pack_bf16(acc[e], acc[e + 1]);
    }
  }
}

// K7 on the tensor cores up to head_dim 128.  Grid (B*H, query tiles of
// kOwn rows, last first); warpgroup wg owns queries q0 + 64 wg .. + 63.
// The keys stream in 64-row tiles.
template <int D, bool OFF>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 Seqs seqs, int H, float scale_log2, int causal, int window) {
  const Seqs L = rows_of<OFF>(seqs);
  static_assert(!kWide<D>, "head_dim 256 takes flash_fwd_wide_tc");
  using G = Geo<D>;
  using M = Smem<D, 1, kOwn, kTile>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  const uint32_t bars = setup(smem_raw, M::bars, &base);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  int lo, hi;
  keys_for(q0, kOwn, kTile, L, causal, window, &lo, &hi);
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers)
      produce<D, 1, kOwn, kTile>(base, bars, &tq, nullptr, &tk, &tv, h, b,
                                 q0, lo, hi);
    return;
  }
  consumer_regs();
  const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int qw = q0 + wg * kTile;
  const int row = qw + wi * 16 + g;  // and row + 8
  int wlo, whi;
  keys_for(qw, kTile, kTile, L, causal, window, &wlo, &whi);
  float o[G::NB][G::CW / 2];
#pragma unroll
  for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
    for (int e = 0; e < G::CW / 2; ++e) o[nb][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  mbar_wait(bars, 0);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    mbar_wait(full_bar(bars, s), (i / kStages) & 1);
    if (j >= wlo && j < whi) {
      const uint32_t k_s = base + M::stream + s * 2 * M::tile;
      const uint32_t v_s = k_s + M::tile;
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks)
        wgmma_ss(sc, desc_k<D>(base, kOwn, wg * kTile, ks),
                 desc_k<D>(k_s, kTile, 0, ks), 1);
      wg_commit();
      wg_wait0();
      const int k0 = j * kTile;
      const bool mask = !all_visible(qw, kTile, k0, kTile, L, causal, window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hf = (e >> 1) & 1;
        float x = __fmul_rn(sc[e], scale_log2);
        if (mask && !visible(row + 8 * hf, k0 + 8 * (e >> 2) + 2 * t + (e & 1),
                             L, causal, window))
          x = kNegInf;
        sc[e] = x;
        mx[hf] = fmaxf(mx[hf], x);
      }
      float corr[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m[hf], mx[hf]);
        corr[hf] = exp2f(m[hf] - m_new);
        m[hf] = m_new;
        l[hf] *= corr[hf];
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hf = (e >> 1) & 1;
        const float p0 = exp2f(sc[e] - m[hf]);
        const float p1 = exp2f(sc[e + 1] - m[hf]);
        l[hf] += p0 + p1;
        pa[e >> 3][(e >> 1) & 3] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
        for (int e = 0; e < G::CW / 2; ++e) o[nb][e] *= corr[(e >> 1) & 1];
      wg_fence();
#pragma unroll
      for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(o[nb], pa[kk], desc_n<D>(v_s, kTile, kk, nb));
      wg_commit();
      wg_wait0();
    }
    mbar_arrive(empty_bar(bars, s));
  }
  float l_safe[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    l_safe[hf] = fmaxf(lt, 1e-30f);
  }
  const long long row_stride = static_cast<long long>(H) * D;
  store_rows<D>(out, (static_cast<long long>(b) * L.sq * H + h) * D,
                row_stride, row, L.sq, o, l_safe);
  if (t == 0)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row + 8 * hf < L.sq)
        lse[static_cast<long long>(bh) * L.sq + row + 8 * hf] =
            m[hf] * kLn2 + logf(l_safe[hf]);
}

// The producer of flash_fwd_wide_tc (one thread): the block's Q tile of
// kOwn rows, then key tiles lo..hi-1, K and V into slots of their own,
// each slot with its own full and empty barrier (ring 0: K, ring 1: V).
template <int D>
__device__ __forceinline__ void produce_split(uint32_t base, uint32_t bars,
                                              const CUtensorMap* tq,
                                              const CUtensorMap* tk,
                                              const CUtensorMap* tv, int h,
                                              int b, int q0, int lo,
                                              int hi) {
  using G = Geo<D>;
  using L = Smem<D, 1, kOwn, kTile>;
  mbar_expect_tx(bars, L::own);
  for (int nb = 0; nb < G::NB; ++nb)
    tma_load(base + nb * kOwn * G::ROWB, tq, bars, nb * G::CW, h, q0, b);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    const uint32_t par = ((i / kStages) & 1) ^ 1;
    const uint32_t k_s = base + L::stream + s * 2 * L::tile;
    for (int r = 0; r < 2; ++r) {
      mbar_wait<true>(empty_bar(bars, s, r), par);
      mbar_expect_tx(full_bar(bars, s, r), L::tile);
      for (int nb = 0; nb < G::NB; ++nb)
        tma_load(k_s + r * L::tile + nb * kTile * G::ROWB, r ? tv : tk,
                 full_bar(bars, s, r), nb * G::CW, h, j * kTile, b);
    }
  }
}

// K7 on the tensor cores at head_dim 256 (gemma-7b), in place of
// flash_fwd_tc's design there.  Replaces the Pallas _flash_fwd_kernel
// (src/repro/kernels/flash_attention.py:73).  Bound: tensor-core
// operations, 4*B*H*S^2*D/2 causal (0.139 ms at (1, 4096, 16, 256) on
// 989 TFLOP/s).  flash_fwd_tc's design, at 256, spilled (528 B) and
// had ptxas serialize its wgmma for want of registers; S = Q K^T waited
// for V's copy too, since K and V of a stage shared one barrier (and the
// stage freed only after P V); and P V took 16 m64n64k16 products a
// tile, re-feeding P from registers four times.  Here K and V have slots
// of their own in the same 128 KiB ring (four slots of 32 KiB), each
// with its own full and empty barrier: S_j waits for K_j alone, V_j
// streams in under S_j and the softmax, and K_j's slot frees as soon as
// S_j is done.  P V is four m64n256k16 products a tile, V read N-major
// over its four 128-byte boxes (desc_nx), into one 128-float fragment;
// the waits fault instead of trapping (kFault); each product's issue and
// wait stay in one branch.  It builds with no spill and no serialized
// wgmma.  FlashAttention-3's turns between the two consumer warpgroups
// (named barriers ordering their products) measured 2% slower and went
// (PERF.md).  The arithmetic and its order are flash_fwd_tc's:
// the same bits.  Grid (B*H, query tiles of kOwn rows, last first);
// warpgroup wg owns queries q0 + 64 wg .. + 63.
template <int D, bool OFF>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_wide_tc(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, Seqs seqs, int H,
                      float scale_log2, int causal, int window) {
  const Seqs L = rows_of<OFF>(seqs);
  static_assert(kWide<D>, "the forward at head_dim 256");
  using G = Geo<D>;
  using M = Smem<D, 1, kOwn, kTile>;
  constexpr int NO = G::NB * G::CW / 2;  // output accumulators (m64nD)
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  const uint32_t bars = setup(smem_raw, FwdWideSmem<D>::bars, &base, 2);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  int lo, hi;
  keys_for(q0, kOwn, kTile, L, causal, window, &lo, &hi);
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers)
      produce_split<D>(base, bars, &tq, &tk, &tv, h, b, q0, lo, hi);
    return;
  }
  consumer_regs();
  const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int qw = q0 + wg * kTile;
  const int row = qw + wi * 16 + g;  // and row + 8
  int wlo, whi;
  keys_for(qw, kTile, kTile, L, causal, window, &wlo, &whi);
  float o[NO];
#pragma unroll
  for (int e = 0; e < NO; ++e) o[e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  mbar_wait<true>(bars, 0);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    const uint32_t par = (i / kStages) & 1;
    const uint32_t k_s = base + M::stream + s * 2 * M::tile;
    const uint32_t v_s = k_s + M::tile;
    mbar_wait<true>(full_bar(bars, s, 0), par);
    if (j >= wlo && j < whi) {
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks)
        wgmma_ss(sc, desc_k<D>(base, kOwn, wg * kTile, ks),
                 desc_k<D>(k_s, kTile, 0, ks), 1);
      wg_commit();
      wg_wait0();
      mbar_arrive(empty_bar(bars, s, 0));  // K_j's slot: S_j is done
      const int k0 = j * kTile;
      const bool mask = !all_visible(qw, kTile, k0, kTile, L, causal, window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hf = (e >> 1) & 1;
        float x = __fmul_rn(sc[e], scale_log2);
        if (mask && !visible(row + 8 * hf, k0 + 8 * (e >> 2) + 2 * t + (e & 1),
                             L, causal, window))
          x = kNegInf;
        sc[e] = x;
        mx[hf] = fmaxf(mx[hf], x);
      }
      float corr[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m[hf], mx[hf]);
        corr[hf] = exp2f(m[hf] - m_new);
        m[hf] = m_new;
        l[hf] *= corr[hf];
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hf = (e >> 1) & 1;
        const float p0 = exp2f(sc[e] - m[hf]);
        const float p1 = exp2f(sc[e + 1] - m[hf]);
        l[hf] += p0 + p1;
        pa[e >> 3][(e >> 1) & 3] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int e = 0; e < NO; ++e) o[e] *= corr[(e >> 1) & 1];
      mbar_wait<true>(full_bar(bars, s, 1), par);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o, pa[kk], desc_nx<D>(v_s, kTile, kk));
      wg_commit();
      wg_wait0();
    } else {  // the slots are freed only after their copies arrived
      mbar_arrive(empty_bar(bars, s, 0));
      mbar_wait<true>(full_bar(bars, s, 1), par);
    }
    mbar_arrive(empty_bar(bars, s, 1));  // V_j's slot: P_j V_j is done
  }
  float l_safe[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    l_safe[hf] = fmaxf(lt, 1e-30f);
  }
  const long long row_stride = static_cast<long long>(H) * D;
  // o[32 nb + e] is element e of box nb's accumulator: store_rows's layout
  store_rows<D>(out, (static_cast<long long>(b) * L.sq * H + h) * D,
                row_stride, row, L.sq,
                reinterpret_cast<const float(&)[G::NB][G::CW / 2]>(o),
                l_safe);
  if (t == 0)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row + 8 * hf < L.sq)
        lse[static_cast<long long>(bh) * L.sq + row + 8 * hf] =
            m[hf] * kLn2 + logf(l_safe[hf]);
}

// K8, dq pass on the tensor cores up to head_dim 128 (but 96): grid as the
// forward's; Q and dO are the block's own tiles, K and V stream in
// TN-row tiles.
template <int D, bool OFF>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_dq_tc(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, Seqs seqs, int H, float scale,
                float scale_log2, int causal, int window) {
  const Seqs L = rows_of<OFF>(seqs);
  static_assert(!kWide<D> && !kFull<D>,
                "head_dim 256 takes flash_dq_wide_tc, 96 flash_dq_full_tc");
  using G = Geo<D>;
  constexpr int TN = kTile;
  constexpr int NS = TN / 2;   // accumulators of a 64 x TN score tile
  constexpr int KK = TN / 16;  // reduction steps over a streamed tile
  using M = Smem<D, 2, kOwn, TN>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  const uint32_t bars = setup(smem_raw, M::bars, &base);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  int lo, hi;
  keys_for(q0, kOwn, TN, L, causal, window, &lo, &hi);
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers)
      produce<D, 2, kOwn, TN>(base, bars, &tq, &tdo, &tk, &tv, h, b, q0, lo,
                              hi);
    return;
  }
  consumer_regs();
  const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int qw = q0 + wg * kTile;
  const int row = qw + wi * 16 + g;  // and row + 8
  int wlo, whi;
  keys_for(qw, kTile, TN, L, causal, window, &wlo, &whi);
  const long long rbase = static_cast<long long>(bh) * L.sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    lse2[hf] = r < L.sq ? __fmul_rn(lse[rbase + r], kLog2e) : 0.0f;
    dl[hf] = r < L.sq ? delta[rbase + r] : 0.0f;
  }
  float acc[G::NB][G::CW / 2];
#pragma unroll
  for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
    for (int e = 0; e < G::CW / 2; ++e) acc[nb][e] = 0.0f;
  const uint32_t do_own = base + M::own;
  mbar_wait(bars, 0);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    mbar_wait(full_bar(bars, s), (i / kStages) & 1);
    if (j >= wlo && j < whi) {
      const uint32_t k_s = base + M::stream + s * 2 * M::tile;
      const uint32_t v_s = k_s + M::tile;
      float sc[NS], dp[NS];
#pragma unroll
      for (int e = 0; e < NS; ++e) sc[e] = dp[e] = 0.0f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks) {
        wgmma_ss(sc, desc_k<D>(base, kOwn, wg * kTile, ks),
                 desc_k<D>(k_s, TN, 0, ks), 1);
        wgmma_ss(dp, desc_k<D>(do_own, kOwn, wg * kTile, ks),
                 desc_k<D>(v_s, TN, 0, ks), 1);
      }
      wg_commit();
      wg_wait0();
      const int k0 = j * TN;
      const bool mask = !all_visible(qw, kTile, k0, TN, L, causal, window);
      uint32_t da[KK][4];
#pragma unroll
      for (int e = 0; e < NS; e += 2) {
        const int hf = (e >> 1) & 1;
        float ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int x = e + u;
          float p = 0.0f;
          if (!mask || visible(row + 8 * hf, k0 + 8 * (x >> 2) + 2 * t + u, L,
                               causal, window))
            p = exp2f(__fmul_rn(sc[x], scale_log2) - lse2[hf]);
          ds[u] = __fmul_rn(__fmul_rn(p, dp[x] - dl[hf]), scale);
        }
        da[e >> 3][(e >> 1) & 3] = pack_bf16(ds[0], ds[1]);
      }
      wg_fence();
#pragma unroll
      for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          wgmma_rs(acc[nb], da[kk], desc_n<D>(k_s, TN, kk, nb));
      wg_commit();
      wg_wait0();
    }
    mbar_arrive(empty_bar(bars, s));
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows<D>(dq, (static_cast<long long>(b) * L.sq * H + h) * D,
                static_cast<long long>(H) * D, row, L.sq, acc, one);
}

// K8, dk/dv pass on the tensor cores up to head_dim 128 (but 96): grid
// (B*H, key tiles of kOwn rows, first first); K and V are the block's
// own tiles, Q and dO stream.  The products run transposed (S^T = K
// Q^T, dP^T = V dO^T), so P^T and dS^T come out as the A fragments of dV
// += P^T dO and dK += dS^T Q.
template <int D, bool OFF>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_dkv_tc(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, Seqs seqs, int H, float scale,
                 float scale_log2, int causal, int window) {
  const Seqs L = rows_of<OFF>(seqs);
  static_assert(!kWide<D> && !kFull<D>,
                "head_dim 256 takes flash_dkv_wide_tc, 96 flash_dkv_full_tc");
  using G = Geo<D>;
  using M = Smem<D, 2, kOwn, kTile>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  const uint32_t bars = setup(smem_raw, M::bars, &base);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kOwn;
  int lo, hi;
  queries_for(k0, kOwn, kTile, L, causal, window, &lo, &hi);
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers)
      produce<D, 2, kOwn, kTile>(base, bars, &tk, &tv, &tq, &tdo, h, b, k0,
                                 lo, hi);
    return;
  }
  consumer_regs();
  const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int kw = k0 + wg * kTile;
  const int row = kw + wi * 16 + g;  // keys row and row + 8
  int wlo, whi;
  queries_for(kw, kTile, kTile, L, causal, window, &wlo, &whi);
  const long long rbase = static_cast<long long>(bh) * L.sq;
  float acc_k[G::NB][G::CW / 2], acc_v[G::NB][G::CW / 2];
#pragma unroll
  for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
    for (int e = 0; e < G::CW / 2; ++e) acc_k[nb][e] = acc_v[nb][e] = 0.0f;
  const uint32_t v_own = base + M::own;
  mbar_wait(bars, 0);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    const int q0 = j * kTile;
    const bool active = j >= wlo && j < whi;
    // lse (base 2) and delta of this lane's 16 query columns
    float lq[16], dl[16];
    if (active) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int q = q0 + 8 * (c >> 1) + 2 * t + (c & 1);
        lq[c] = q < L.sq ? __fmul_rn(lse[rbase + q], kLog2e) : 0.0f;
        dl[c] = q < L.sq ? delta[rbase + q] : 0.0f;
      }
    }
    mbar_wait(full_bar(bars, s), (i / kStages) & 1);
    if (active) {
      const uint32_t q_s = base + M::stream + s * 2 * M::tile;
      const uint32_t do_s = q_s + M::tile;
      float sc[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.0f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks) {
        wgmma_ss(sc, desc_k<D>(base, kOwn, wg * kTile, ks),
                 desc_k<D>(q_s, kTile, 0, ks), 1);
        wgmma_ss(dp, desc_k<D>(v_own, kOwn, wg * kTile, ks),
                 desc_k<D>(do_s, kTile, 0, ks), 1);
      }
      wg_commit();
      wg_wait0();
      const bool mask = !all_visible(q0, kTile, kw, kTile, L, causal, window);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hf = (e >> 1) & 1;
        float p[2], ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int x = e + u;
          const int c = 2 * (x >> 2) + u;  // this lane's column index
          p[u] = 0.0f;
          if (!mask || visible(q0 + 8 * (x >> 2) + 2 * t + u, row + 8 * hf, L,
                               causal, window))
            p[u] = exp2f(__fmul_rn(sc[x], scale_log2) - lq[c]);
          ds[u] = __fmul_rn(__fmul_rn(p[u], dp[x] - dl[c]), scale);
        }
        pa[e >> 3][(e >> 1) & 3] = pack_bf16(p[0], p[1]);
        da[e >> 3][(e >> 1) & 3] = pack_bf16(ds[0], ds[1]);
      }
      wg_fence();
#pragma unroll
      for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs(acc_v[nb], pa[kk], desc_n<D>(do_s, kTile, kk, nb));
          wgmma_rs(acc_k[nb], da[kk], desc_n<D>(q_s, kTile, kk, nb));
        }
      wg_commit();
      wg_wait0();
    }
    mbar_arrive(empty_bar(bars, s));
  }
  const float one[2] = {1.0f, 1.0f};
  const long long obase = (static_cast<long long>(b) * L.sk * H + h) * D;
  const long long row_stride = static_cast<long long>(H) * D;
  store_rows<D>(dk, obase, row_stride, row, L.sk, acc_k, one);
  store_rows<D>(dv, obase, row_stride, row, L.sk, acc_v, one);
}

// K8 at head_dim 96 (phi-3-vision): flash_dq_full_tc and
// flash_dkv_full_tc, in place of flash_dq_tc's and flash_dkv_tc's design
// there.  They replace the Pallas _flash_dq_kernel and _flash_dkv_kernel
// (src/repro/kernels/flash_attention.py:202).  Bound: tensor-core
// operations, 8*B*H*S^2*D/2 causal for the backward's four products (the
// two passes do seven: 0.209 ms at (1, 4096, 32, 96) on 989 TFLOP/s).
// The design at 64 cut every product at 96 into three m64n32k16 ones, a
// 64-byte box each, re-feeding the same A fragment from registers; kept
// the lse and delta of its 16 query columns in 32 registers of each lane
// of the dk/dv pass, whose ~224 live values spilled under setmaxnreg's
// 240 (a __trap() on the waits' time-out path makes ptxas spill bodies
// that fit), and ptxas serialized its wgmma for want of registers.
// Here every product that accumulates over the head width is one
// m64n96k16 instruction, B read N-major over the row's three boxes
// (desc_nx), into one 48-float fragment; the dk/dv pass's lse and delta
// of the streamed tile sit in shared memory (FullSmem), loaded once a
// tile by each consumer warpgroup (the next tile's fetched into one
// register while this one computes); the waits fault instead of trapping
// (kFault).  Both passes build with no spill and no serialized wgmma.
// FlashAttention-3's turns between the two consumer warpgroups measured
// 1-6% slower here and went (PERF.md).  The arithmetic and its
// order are the earlier kernels': the same bits.

// K8, dq pass at head_dim 96: grid as the forward's; Q and dO are the
// block's own tiles, K and V stream in 64-row tiles.
template <int D, bool OFF>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_dq_full_tc(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, Seqs seqs, int H,
                     float scale, float scale_log2, int causal, int window) {
  const Seqs L = rows_of<OFF>(seqs);
  static_assert(kFull<D>, "a full kernel");
  using G = Geo<D>;
  constexpr int NA = G::NB * G::CW / 2;  // accumulators of a 64 x D tile
  using M = Smem<D, 2, kOwn, kTile>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  const uint32_t bars = setup(smem_raw, M::bars, &base);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  int lo, hi;
  keys_for(q0, kOwn, kTile, L, causal, window, &lo, &hi);
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers)
      produce<D, 2, kOwn, kTile, true>(base, bars, &tq, &tdo, &tk, &tv, h,
                                       b, q0, lo, hi);
    return;
  }
  consumer_regs();
  const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int qw = q0 + wg * kTile;
  const int row = qw + wi * 16 + g;  // and row + 8
  int wlo, whi;
  keys_for(qw, kTile, kTile, L, causal, window, &wlo, &whi);
  const long long rbase = static_cast<long long>(bh) * L.sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    lse2[hf] = r < L.sq ? __fmul_rn(lse[rbase + r], kLog2e) : 0.0f;
    dl[hf] = r < L.sq ? delta[rbase + r] : 0.0f;
  }
  float acc[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = 0.0f;
  const uint32_t do_own = base + M::own;
  mbar_wait<true>(bars, 0);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    const uint32_t k_s = base + M::stream + s * 2 * M::tile;
    const uint32_t v_s = k_s + M::tile;
    mbar_wait<true>(full_bar(bars, s), (i / kStages) & 1);
    if (j >= wlo && j < whi) {
      float sc[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.0f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks) {
        wgmma_ss(sc, desc_k<D>(base, kOwn, wg * kTile, ks),
                 desc_k<D>(k_s, kTile, 0, ks), 1);
        wgmma_ss(dp, desc_k<D>(do_own, kOwn, wg * kTile, ks),
                 desc_k<D>(v_s, kTile, 0, ks), 1);
      }
      wg_commit();
      wg_wait0();
      const int k0 = j * kTile;
      const bool mask = !all_visible(qw, kTile, k0, kTile, L, causal, window);
      uint32_t da[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hf = (e >> 1) & 1;
        float ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int x = e + u;
          float p = 0.0f;
          if (!mask || visible(row + 8 * hf, k0 + 8 * (x >> 2) + 2 * t + u, L,
                               causal, window))
            p = exp2f(__fmul_rn(sc[x], scale_log2) - lse2[hf]);
          ds[u] = __fmul_rn(__fmul_rn(p, dp[x] - dl[hf]), scale);
        }
        da[e >> 3][(e >> 1) & 3] = pack_bf16(ds[0], ds[1]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, da[kk], desc_nx<D>(k_s, kTile, kk));
      wg_commit();
      wg_wait0();
    }
    mbar_arrive(empty_bar(bars, s));
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows<D>(dq, (static_cast<long long>(b) * L.sq * H + h) * D,
                static_cast<long long>(H) * D, row, L.sq,
                reinterpret_cast<const float(&)[G::NB][G::CW / 2]>(acc), one);
}

// K8, dk/dv pass at head_dim 96: grid (B*H, key tiles of kOwn rows, first
// first); K and V are the block's own tiles, Q and dO stream.  The
// products run transposed (S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T
// come out as the A fragments of dV += P^T dO and dK += dS^T Q.
template <int D, bool OFF>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_dkv_full_tc(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, Seqs seqs, int H,
                      float scale, float scale_log2, int causal,
                      int window) {
  const Seqs L = rows_of<OFF>(seqs);
  static_assert(kFull<D>, "a full kernel");
  using G = Geo<D>;
  constexpr int NA = G::NB * G::CW / 2;  // accumulators of a 64 x D tile
  using M = FullSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  const uint32_t bars = setup(smem_raw, M::bars, &base);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kOwn;
  int lo, hi;
  queries_for(k0, kOwn, kTile, L, causal, window, &lo, &hi);
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers)
      produce<D, 2, kOwn, kTile, true>(base, bars, &tk, &tv, &tq, &tdo, h,
                                       b, k0, lo, hi);
    return;
  }
  consumer_regs();
  const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int wt = threadIdx.x % 128;
  const int kw = k0 + wg * kTile;
  const int row = kw + wi * 16 + g;  // keys row and row + 8
  int wlo, whi;
  queries_for(kw, kTile, kTile, L, causal, window, &wlo, &whi);
  const long long rbase = static_cast<long long>(bh) * L.sq;
  // This warpgroup's two buffers of a streamed tile's 64 lse (base 2)
  // then 64 delta; thread wt fills entry wt of one.
  float* const rows_s = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + M::rows) + wg * 2 * 2 * kTile;
  const auto fetch = [&](int j) {
    const int q = j * kTile + wt % kTile;
    if (q >= L.sq) return 0.0f;
    return wt < kTile ? __fmul_rn(lse[rbase + q], kLog2e) : delta[rbase + q];
  };
  float next = wlo < whi ? fetch(wlo) : 0.0f;
  float acc_k[NA], acc_v[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc_k[e] = acc_v[e] = 0.0f;
  const uint32_t v_own = base + Smem<D, 2, kOwn, kTile>::own;
  mbar_wait<true>(bars, 0);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    const int q0 = j * kTile;
    const uint32_t q_s = base + M::S::stream + s * 2 * M::S::tile;
    const uint32_t do_s = q_s + M::S::tile;
    float* const lq = rows_s + (j & 1) * 2 * kTile;  // lse, then delta
    const bool active = j >= wlo && j < whi;
    if (active) {
      lq[wt] = next;
      asm volatile("bar.sync %0, 128;\n" ::"r"(4 + wg) : "memory");
      if (j + 1 < whi) next = fetch(j + 1);
    }
    mbar_wait<true>(full_bar(bars, s), (i / kStages) & 1);
    if (active) {
      float sc[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.0f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks) {
        wgmma_ss(sc, desc_k<D>(base, kOwn, wg * kTile, ks),
                 desc_k<D>(q_s, kTile, 0, ks), 1);
        wgmma_ss(dp, desc_k<D>(v_own, kOwn, wg * kTile, ks),
                 desc_k<D>(do_s, kTile, 0, ks), 1);
      }
      wg_commit();
      wg_wait0();
      const bool mask = !all_visible(q0, kTile, kw, kTile, L, causal, window);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hf = (e >> 1) & 1;
        float p[2], ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int x = e + u;
          const int c = 8 * (x >> 2) + 2 * t + u;  // the query's column
          p[u] = 0.0f;
          if (!mask || visible(q0 + c, row + 8 * hf, L, causal, window))
            p[u] = exp2f(__fmul_rn(sc[x], scale_log2) - lq[c]);
          ds[u] = __fmul_rn(__fmul_rn(p[u], dp[x] - lq[kTile + c]), scale);
        }
        pa[e >> 3][(e >> 1) & 3] = pack_bf16(p[0], p[1]);
        da[e >> 3][(e >> 1) & 3] = pack_bf16(ds[0], ds[1]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc_v, pa[kk], desc_nx<D>(do_s, kTile, kk));
        wgmma_rs(acc_k, da[kk], desc_nx<D>(q_s, kTile, kk));
      }
      wg_commit();
      wg_wait0();
    }
    mbar_arrive(empty_bar(bars, s));
  }
  const float one[2] = {1.0f, 1.0f};
  const long long obase = (static_cast<long long>(b) * L.sk * H + h) * D;
  const long long row_stride = static_cast<long long>(H) * D;
  store_rows<D>(dk, obase, row_stride, row, L.sk,
                reinterpret_cast<const float(&)[G::NB][G::CW / 2]>(acc_k),
                one);
  store_rows<D>(dv, obase, row_stride, row, L.sk,
                reinterpret_cast<const float(&)[G::NB][G::CW / 2]>(acc_v),
                one);
}

// The wide kernels' score products for one streamed tile: sc += A0 B0^T
// and dp += A1 B1^T over the head dimension, A0 and A1 the block's own
// 64-row tiles, B0 and B1 the 32 rows from col0 of the streamed ones
// (m64n32k16).  Each k-step builds its own descriptors.  Commits without
// waiting.
template <int D>
__device__ __forceinline__ void wide_scores(float (&sc)[16], float (&dp)[16],
                                            uint32_t a0, uint32_t b0,
                                            uint32_t a1, uint32_t b1,
                                            int col0) {
#pragma unroll
  for (int e = 0; e < 16; ++e) sc[e] = dp[e] = 0.0f;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < Geo<D>::KSTEPS; ++ks) {
    wgmma_ss(sc, desc_k<D>(a0, kTile, 0, ks), desc_k<D>(b0, kTile, col0, ks),
             1);
    wgmma_ss(dp, desc_k<D>(a1, kTile, 0, ks), desc_k<D>(b1, kTile, col0, ks),
             1);
  }
  wg_commit();
}

// acc += X B[:, 128 wg : 128 wg + 128] over a streamed tile's 64 rows: X
// a 64 x 64 exchange tile (K-major), B the streamed tile read N-major.
template <int D>
__device__ __forceinline__ void wide_half(float (&acc)[64], uint32_t x,
                                          uint32_t b, int wg, int kk) {
  wgmma_ss_n(acc, desc_k<64>(x, kTile, 0, kk),
             desc_nx<D>(b, kTile, kk, 2 * wg));
}

// What a consumer thread of a wide kernel keeps in f32 registers while
// it forms the score products: the dk/dv pass's dK and dV halves (2 x
// 64), the S and dP tiles (2 x 16) and the lse and delta of its 8
// columns, with 48 left for addresses, indices and the softmax's
// temporaries.  setmaxnreg gives the consumers 240, which ptxas uses once
// the body cannot reach a trap (mbar_wait<true>).
constexpr int kConsumerRegs = 240;
static_assert(2 * 64 + 2 * 16 + 2 * 8 + 48 <= kConsumerRegs,
              "the dk/dv pass's registers exceed the consumers' budget");

// K8, dq pass on the tensor cores at head_dim 256: grid (B*H, query tiles
// of 64 rows, last first); Q and dO are the block's own tiles, K and V
// stream in 64-row tiles.  For each key tile, warpgroup wg forms S = Q K^T
// and dP = dO V^T for key columns [32 wg, 32 wg + 32) and writes dS there,
// in bf16, to an exchange tile; after the consumers' barrier it
// accumulates dq[:, 128 wg : 128 wg + 128] += dS K over all 64 keys.
// Three products a tile; both warpgroups do the same work.
template <int D, bool OFF>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_dq_wide_tc(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, Seqs seqs, int H,
                     float scale, float scale_log2, int causal, int window) {
  const Seqs L = rows_of<OFF>(seqs);
  static_assert(kWide<D> && Geo<D>::NB % 2 == 0, "a wide kernel");
  using M = WideSmem<D, 2>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  const uint32_t bars = setup(smem_raw, M::bars, &base);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  int lo, hi;
  keys_for(q0, kTile, kTile, L, causal, window, &lo, &hi);
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers)
      produce<D, 2, kTile, kTile, true>(base, bars, &tq, &tdo, &tk, &tv, h,
                                        b, q0, lo, hi);
    return;
  }
  consumer_regs();
  const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = wi * 16 + g;  // this lane's tile rows r0 and r0 + 8
  const int row = q0 + r0;
  const int c0 = wg * 32;      // this warpgroup's key columns of a tile
  const long long rbase = static_cast<long long>(bh) * L.sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    lse2[hf] = r < L.sq ? __fmul_rn(lse[rbase + r], kLog2e) : 0.0f;
    dl[hf] = r < L.sq ? delta[rbase + r] : 0.0f;
  }
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  const uint32_t do_own = base + M::S::own;
  mbar_wait<true>(bars, 0);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    const uint32_t k_s = base + M::S::stream + s * 2 * M::S::tile;
    const uint32_t v_s = k_s + M::S::tile;
    const uint32_t ds_s = base + M::xch + (i & 1) * M::xtile;
    float sc[16], dp[16];
    mbar_wait<true>(full_bar(bars, s), (i / kStages) & 1);
    wide_scores<D>(sc, dp, base, k_s, do_own, v_s, c0);
    wg_wait0();
    const int k0 = j * kTile;
    const bool mask = !all_visible(q0, kTile, k0, kTile, L, causal, window);
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const int hf = (e >> 1) & 1;
      float ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int x = e + u;
        float p = 0.0f;
        if (!mask || visible(row + 8 * hf, k0 + c0 + 8 * (x >> 2) + 2 * t + u,
                             L, causal, window))
          p = exp2f(__fmul_rn(sc[x], scale_log2) - lse2[hf]);
        ds[u] = __fmul_rn(__fmul_rn(p, dp[x] - dl[hf]), scale);
      }
      st_xch(ds_s, r0 + 8 * hf, c0 + 8 * (e >> 2) + 2 * t,
             pack_bf16(ds[0], ds[1]));
    }
    consumers_sync();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wide_half<D>(acc, ds_s, k_s, wg, kk);
    wg_commit();
    wg_wait0();
    mbar_arrive(empty_bar(bars, s));
  }
  store_half(dq, (static_cast<long long>(b) * L.sq * H + h) * D,
             static_cast<long long>(H) * D, row, L.sq, 128 * wg, acc);
}

// K8, dk/dv pass on the tensor cores at head_dim 256: grid (B*H, key
// tiles of 64 rows, first first); K and V are the block's own tiles, Q
// and dO stream in 64-row tiles.  For each query tile, warpgroup wg forms
// S^T = K Q^T and dP^T = V dO^T for query columns [32 wg, 32 wg + 32) and
// writes P^T and dS^T there, in bf16, to two exchange tiles; after the
// consumers' barrier it accumulates dV[:, 128 wg : 128 wg + 128] += P^T dO
// and dK[:, 128 wg : 128 wg + 128] += dS^T Q over all 64 queries.  Four
// products a tile; both warpgroups do the same work.
template <int D, bool OFF>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_dkv_wide_tc(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, Seqs seqs, int H,
                      float scale, float scale_log2, int causal,
                      int window) {
  const Seqs L = rows_of<OFF>(seqs);
  static_assert(kWide<D> && Geo<D>::NB % 2 == 0, "a wide kernel");
  using M = WideSmem<D, 4>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  const uint32_t bars = setup(smem_raw, M::bars, &base);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  int lo, hi;
  queries_for(k0, kTile, kTile, L, causal, window, &lo, &hi);
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers)
      produce<D, 2, kTile, kTile, true>(base, bars, &tk, &tv, &tq, &tdo, h,
                                        b, k0, lo, hi);
    return;
  }
  consumer_regs();
  const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = wi * 16 + g;  // this lane's tile rows r0 and r0 + 8
  const int row = k0 + r0;     // keys
  const int c0 = wg * 32;      // this warpgroup's query columns of a tile
  const long long rbase = static_cast<long long>(bh) * L.sq;
  float acc_k[64], acc_v[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc_k[e] = acc_v[e] = 0.0f;
  const uint32_t v_own = base + M::S::own;
  mbar_wait<true>(bars, 0);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages;
    const int q0 = j * kTile;
    const uint32_t q_s = base + M::S::stream + s * 2 * M::S::tile;
    const uint32_t do_s = q_s + M::S::tile;
    const uint32_t pt_s = base + M::xch + (i & 1) * 2 * M::xtile;
    const uint32_t dst_s = pt_s + M::xtile;
    float sc[16], dp[16];
    mbar_wait<true>(full_bar(bars, s), (i / kStages) & 1);
    wide_scores<D>(sc, dp, base, q_s, v_own, do_s, c0);
    // lse (base 2) and delta of this lane's 8 query columns, loaded while
    // the products run
    float lq[8], dl[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int q = q0 + c0 + 8 * (c >> 1) + 2 * t + (c & 1);
      lq[c] = q < L.sq ? __fmul_rn(lse[rbase + q], kLog2e) : 0.0f;
      dl[c] = q < L.sq ? delta[rbase + q] : 0.0f;
    }
    wg_wait0();
    const bool mask = !all_visible(q0, kTile, k0, kTile, L, causal, window);
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const int hf = (e >> 1) & 1;
      float p[2], ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int x = e + u;
        const int c = 2 * (x >> 2) + u;  // this lane's column index
        p[u] = 0.0f;
        if (!mask || visible(q0 + c0 + 8 * (x >> 2) + 2 * t + u, row + 8 * hf,
                             L, causal, window))
          p[u] = exp2f(__fmul_rn(sc[x], scale_log2) - lq[c]);
        ds[u] = __fmul_rn(__fmul_rn(p[u], dp[x] - dl[c]), scale);
      }
      const int cc = c0 + 8 * (e >> 2) + 2 * t;
      st_xch(pt_s, r0 + 8 * hf, cc, pack_bf16(p[0], p[1]));
      st_xch(dst_s, r0 + 8 * hf, cc, pack_bf16(ds[0], ds[1]));
    }
    consumers_sync();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wide_half<D>(acc_v, pt_s, do_s, wg, kk);
      wide_half<D>(acc_k, dst_s, q_s, wg, kk);
    }
    wg_commit();
    wg_wait0();
    mbar_arrive(empty_bar(bars, s));
  }
  const long long obase = (static_cast<long long>(b) * L.sk * H + h) * D;
  const long long row_stride = static_cast<long long>(H) * D;
  store_half(dk, obase, row_stride, row, L.sk, 128 * wg, acc_k);
  store_half(dv, obase, row_stride, row, L.sk, 128 * wg, acc_v);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D, int R>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * R * (D + 1) + R * (R + 1));
}
template <int D, int R>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * R * (D + 1) + R * (R + 1) + 2 * R);
}
template <int D, int R>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int D, bool OFF>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, Seqs L, int H, float scale, int causal, int window,
        cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D, kB>();
  static_assert(smem <= kSmemLimit, "f32 forward tiles exceed shared memory");
  const int rc = prepare(flash_fwd_kernel<T, D, kB, OFF>, smem);
  if (rc != 0) return rc;
  const dim3 grid((L.sq + kB - 1) / kB, B * H);
  flash_fwd_kernel<T, D, kB, OFF><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, L, H, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool OFF>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        int B, Seqs L, int H, float scale, int causal, int window, int passes,
        cudaStream_t stream) {
  constexpr int R = f32_bwd_rows<D>();
  constexpr size_t smem_dq = dq_smem<D, R>(), smem_dkv = dkv_smem<D, R>();
  static_assert(smem_dq <= kSmemLimit && smem_dkv <= kSmemLimit,
                "f32 backward tiles exceed shared memory");
  int rc = prepare(flash_bwd_dq_kernel<T, D, R, OFF>, smem_dq);
  if (rc != 0) return rc;
  rc = prepare(flash_bwd_dkv_kernel<T, D, R, OFF>, smem_dkv);
  if (rc != 0) return rc;
  const dim3 grid_q((L.sq + R - 1) / R, B * H);
  const dim3 grid_k((L.sk + R - 1) / R, B * H);
  if (passes & 1) {
    flash_bwd_dq_kernel<T, D, R, OFF><<<grid_q, kThreads, smem_dq, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), L, H, scale, causal, window);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (passes & 2) {
    flash_bwd_dkv_kernel<T, D, R, OFF><<<grid_k, kThreads, smem_dkv, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale, causal,
        window);
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}

template <typename T, int D>
int delta_launch(const void* out, const void* dout, float* delta, int B,
                 int S, int H, int vec, cudaStream_t stream) {
  using G = DeltaGeo<T, D>;
  const dim3 grid(B * H, (S + G::ROWS - 1) / G::ROWS);
  flash_delta_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, S, H,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled from the driver library the process already has
// loaded (through the CUDA runtime), so the build needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Returned when the driver has no tensor-map encoder or refuses the map
// (then kMapError + the CUresult).
constexpr int kMapError = 1000;

// A map of a (B, S, H, D) bf16 tensor (S: Sq or Sk) whose box is `rows`
// rows of one head by CW columns, in the swizzle that Geo<D> names.
// Coordinates past S read as zeros (OOB fill NONE fills zeros).
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
             int rows) {
  using G = Geo<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kMapError;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(H) * D * 2,
      static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::CW), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      G::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : (G::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                      : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

template <int D, bool OFF>
int fwd_tc(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, Seqs L, int H, float scale, int causal,
           int window, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = make_map<D>(&mq, q, B, L.sq, H, kOwn);
  if (rc == 0) rc = make_map<D>(&mk, k, B, L.sk, H, kTile);
  if (rc == 0) rc = make_map<D>(&mv, v, B, L.sk, H, kTile);
  if (rc != 0) return rc;
  constexpr uint32_t smem = TcSmem<D>::fwd;
  const dim3 grid(B * H, (L.sq + kOwn - 1) / kOwn);
  __nv_bfloat16* out_ = static_cast<__nv_bfloat16*>(out);
  if constexpr (kWide<D>) {
    rc = prepare(flash_fwd_wide_tc<D, OFF>, smem);
    if (rc != 0) return rc;
    flash_fwd_wide_tc<D, OFF><<<grid, kTcThreads, smem, stream>>>(
        mq, mk, mv, out_, lse, L, H, scale * kLog2e, causal, window);
  } else {
    rc = prepare(flash_fwd_tc<D, OFF>, smem);
    if (rc != 0) return rc;
    flash_fwd_tc<D, OFF><<<grid, kTcThreads, smem, stream>>>(
        mq, mk, mv, out_, lse, L, H, scale * kLog2e, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

// passes: bit 0 launches the dq pass, bit 1 the dk/dv pass.
template <int D, bool OFF>
int bwd_tc(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int B, Seqs L, int H, float scale, int causal, int window,
           int passes, cudaStream_t stream) {
  constexpr int OWN = kWide<D> ? kTile : kOwn;  // rows a block owns
  CUtensorMap q_own, do_own, k_str, v_str, k_own, v_own, q_str, do_str;
  int rc = make_map<D>(&q_own, q, B, L.sq, H, OWN);
  if (rc == 0) rc = make_map<D>(&do_own, dout, B, L.sq, H, OWN);
  if (rc == 0) rc = make_map<D>(&k_str, k, B, L.sk, H, kTile);
  if (rc == 0) rc = make_map<D>(&v_str, v, B, L.sk, H, kTile);
  if (rc == 0) rc = make_map<D>(&k_own, k, B, L.sk, H, OWN);
  if (rc == 0) rc = make_map<D>(&v_own, v, B, L.sk, H, OWN);
  if (rc == 0) rc = make_map<D>(&q_str, q, B, L.sq, H, kTile);
  if (rc == 0) rc = make_map<D>(&do_str, dout, B, L.sq, H, kTile);
  if (rc != 0) return rc;
  constexpr uint32_t smem_dq = TcSmem<D>::dq, smem_dkv = TcSmem<D>::dkv;
  const float scale_log2 = scale * kLog2e;
  const dim3 grid_q(B * H, (L.sq + OWN - 1) / OWN);
  const dim3 grid_k(B * H, (L.sk + OWN - 1) / OWN);
  __nv_bfloat16* dq_ = static_cast<__nv_bfloat16*>(dq);
  __nv_bfloat16* dk_ = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv_ = static_cast<__nv_bfloat16*>(dv);
  if (passes & 1) {
    if constexpr (kWide<D>) {
      rc = prepare(flash_dq_wide_tc<D, OFF>, smem_dq);
      if (rc != 0) return rc;
      flash_dq_wide_tc<D, OFF><<<grid_q, kTcThreads, smem_dq, stream>>>(
          q_own, do_own, k_str, v_str, lse, delta, dq_, L, H, scale,
          scale_log2, causal, window);
    } else if constexpr (kFull<D>) {
      rc = prepare(flash_dq_full_tc<D, OFF>, smem_dq);
      if (rc != 0) return rc;
      flash_dq_full_tc<D, OFF><<<grid_q, kTcThreads, smem_dq, stream>>>(
          q_own, do_own, k_str, v_str, lse, delta, dq_, L, H, scale,
          scale_log2, causal, window);
    } else {
      rc = prepare(flash_dq_tc<D, OFF>, smem_dq);
      if (rc != 0) return rc;
      flash_dq_tc<D, OFF><<<grid_q, kTcThreads, smem_dq, stream>>>(
          q_own, do_own, k_str, v_str, lse, delta, dq_, L, H, scale,
          scale_log2, causal, window);
    }
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (passes & 2) {
    if constexpr (kWide<D>) {
      rc = prepare(flash_dkv_wide_tc<D, OFF>, smem_dkv);
      if (rc != 0) return rc;
      flash_dkv_wide_tc<D, OFF><<<grid_k, kTcThreads, smem_dkv, stream>>>(
          k_own, v_own, q_str, do_str, lse, delta, dk_, dv_, L, H, scale,
          scale_log2, causal, window);
    } else if constexpr (kFull<D>) {
      rc = prepare(flash_dkv_full_tc<D, OFF>, smem_dkv);
      if (rc != 0) return rc;
      flash_dkv_full_tc<D, OFF><<<grid_k, kTcThreads, smem_dkv, stream>>>(
          k_own, v_own, q_str, do_str, lse, delta, dk_, dv_, L, H, scale,
          scale_log2, causal, window);
    } else {
      rc = prepare(flash_dkv_tc<D, OFF>, smem_dkv);
      if (rc != 0) return rc;
      flash_dkv_tc<D, OFF><<<grid_k, kTcThreads, smem_dkv, stream>>>(
          k_own, v_own, q_str, do_str, lse, delta, dk_, dv_, L, H, scale,
          scale_log2, causal, window);
    }
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}

// float32 to the CUDA-core kernels, bfloat16 to the tensor-core ones.
#define FLASH_DISPATCH(F32, BF16)                         \
  switch (head_dim) {                                     \
    case 16: return dtype == 0 ? F32(16) : BF16(16);      \
    case 32: return dtype == 0 ? F32(32) : BF16(32);      \
    case 64: return dtype == 0 ? F32(64) : BF16(64);      \
    case 96: return dtype == 0 ? F32(96) : BF16(96);      \
    case 128: return dtype == 0 ? F32(128) : BF16(128);   \
    case 256: return dtype == 0 ? F32(256) : BF16(256);   \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <int D>
int tc_smem(int kernel) {
  return static_cast<int>(kernel == 0   ? TcSmem<D>::fwd
                          : kernel == 1 ? TcSmem<D>::dq
                                        : TcSmem<D>::dkv);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim one of 16, 32, 64, 96, 128,
// 256; Sq query rows at positions q_off.., Sk key rows at 0...
// Each returns a cudaError_t, or kMapError (+ the CUresult) when a
// tensor map cannot be made.
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* out,
                                   float* lse, int B, int Sq, int Sk,
                                   int q_off, int H, float scale, int causal,
                                   int window, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || Sq < 1 || Sk < 1 || q_off < 0 ||
      H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seqs L = {Sq, Sk, q_off};
  const bool off = q_off != 0 || Sq != Sk;
#define FWD_ARGS q, k, v, out, lse, B, L, H, scale, causal, window, st
#define FWD_F32(D) \
  (off ? fwd<float, D, true>(FWD_ARGS) : fwd<float, D, false>(FWD_ARGS))
#define FWD_BF16(D) \
  (off ? fwd_tc<D, true>(FWD_ARGS) : fwd_tc<D, false>(FWD_ARGS))
  FLASH_DISPATCH(FWD_F32, FWD_BF16)
#undef FWD_F32
#undef FWD_BF16
#undef FWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a bf16 tensor-core kernel (0 forward, 1 dq
// pass, 2 dk/dv pass) at head_dim, in bytes; 0 for other arguments.
extern "C" int flash_attention_tc_smem(int kernel, int head_dim) {
  if (kernel < 0 || kernel > 2) return 0;
  switch (head_dim) {
    case 16: return tc_smem<16>(kernel);
    case 32: return tc_smem<32>(kernel);
    case 64: return tc_smem<64>(kernel);
    case 96: return tc_smem<96>(kernel);
    case 128: return tc_smem<128>(kernel);
    case 256: return tc_smem<256>(kernel);
    default: return 0;
  }
}

// passes: 3 for the whole backward; 1 (the dq pass alone) and 2 (the dk/dv
// pass alone) time the passes apart.
extern "C" int flash_attention_bwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq, void* dk,
                                   void* dv, int B, int Sq, int Sk, int q_off,
                                   int H, float scale, int causal, int window,
                                   int passes, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || Sq < 1 || Sk < 1 || q_off < 0 ||
      H < 1 || passes < 1 || passes > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seqs L = {Sq, Sk, q_off};
  const bool off = q_off != 0 || Sq != Sk;
#define BWD_ARGS                                                          \
  q, k, v, dout, lse, delta, dq, dk, dv, B, L, H, scale, causal, window,  \
      passes, st
#define BWD_F32(D) \
  (off ? bwd<float, D, true>(BWD_ARGS) : bwd<float, D, false>(BWD_ARGS))
#define BWD_BF16(D) \
  (off ? bwd_tc<D, true>(BWD_ARGS) : bwd_tc<D, false>(BWD_ARGS))
  FLASH_DISPATCH(BWD_F32, BWD_BF16)
#undef BWD_F32
#undef BWD_BF16
#undef BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8's rowsum(dO∘O) into delta (B, H, S) f32, from out and dout (B, S,
// H, head_dim) of dtype (0 float32, 1 bfloat16); vec 1 reads 16-byte
// vectors (both pointers 16-byte aligned), 0 elements.
extern "C" int flash_attention_delta(int dtype, int head_dim,
                                     const void* out, const void* dout,
                                     float* delta, int B, int S, int H,
                                     int vec, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DELTA_ARGS out, dout, delta, B, S, H, vec, st
#define DELTA_F32(D) delta_launch<float, D>(DELTA_ARGS)
#define DELTA_BF16(D) delta_launch<__nv_bfloat16, D>(DELTA_ARGS)
  FLASH_DISPATCH(DELTA_F32, DELTA_BF16)
#undef DELTA_F32
#undef DELTA_BF16
#undef DELTA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
