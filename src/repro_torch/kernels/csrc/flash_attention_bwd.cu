// Backward of causal GQA attention for sm_90a: dQ, dK and dV from q, k,
// v, the output's gradient dO and the forward's per-row log-sum-exp
// (flash_attention.cu writes it), fp32 or bf16.
//
// Replaces jax.grad of src/repro/models/attention.py::_sdpa_block (the
// JAX package differentiates its attention as plain einsums; no Pallas
// kernel there has a backward).  Shapes as the forward: q, dO
// (B, Hq, Lq, D), k, v (B, Hkv, Lk, D), all contiguous and of one type;
// query head h reads kv head h / (Hq / Hkv); causal rows are the last Lq
// of the Lk positions, and rows past Lq or keys past Lk are masked, as
// the forward masks them.  Every sum is taken in fp32 and each output is
// cast last.
//
// Bound: operations.  The FA-2 schedule recomputes P = exp(s - lse) from
// q, k and the saved row statistics instead of storing the (Lq x Lk)
// probabilities, and splits the work into two passes with no float
// atomics, so every launch on the same inputs gives the same bits
// (gemma-2b is MQA: one kv head's dK / dV sums over all 8 query heads,
// and atomics would add them in a different order each run):
//   1. dq_kernel: a block per (batch, q head, q tile) holds its Q and dO
//      rows and walks the causal key tiles: S = Q K^T, P, dP = dO V^T,
//      A += (P o dP) K, B += P K and D += rowsum(P o dP); at the end
//      dQ = scale (A - D B), and D goes to `delta` for pass 2.  D is
//      the row sum of dO o O taken over the keys in fp32 (folded into
//      this pass) rather than from the bf16-rounded output, whose
//      rounding moved dQ of rows with few keys by up to 3x the bf16
//      gate on an H100;
//   2. dkdv_kernel: a block per (batch, kv head, key tile) holds its dK
//      and dV in registers and walks the group's query heads and, for
//      each, the causal q tiles in order: dS = P (dP - D) scale,
//      dV += P^T dO, dK += dS^T Q.
// Both passes recompute S and dP: 8 products of the forward's size per
// tile pair against the forward's 2 (4x its flops; a kernel that adds
// dQ with atomics needs 5).  The bf16 kernels sum D in a first sweep of
// the dQ pass instead and feed P and dS as two terms (12 products).
//
// The input type chooses the kernels, as in the forward: bf16 runs on
// the tensor cores (dq_mma, dkdv_mma: mma.sync with ldmatrix, described
// below), fp32 on the CUDA cores (dq_kernel, dkdv_kernel), since an fp32
// tensor-core product is TF32.  The fp32 kernels stage tiles in shared
// memory as fp32 rows padded to D + 4 floats (D + 1 at D = 32), so that
// a thread reads four head-dim values of a row as one 16-byte load and
// 16 threads reading 16 different rows at one column hit 16 different
// banks; each thread keeps a (tile rows / 16) x (tile columns / 16)
// block of S and dP and a (rows / 16) x (D / 16) block of each
// accumulator.  At D = 256 a key tile is 32 rows (dK and dV are 32 x 256
// fp32 each: 64 registers a thread), at D = 128 64 rows; q tiles are 32
// rows at D >= 128, 64 below.
//
// C interface (ctypes): flash_attention_bwd_launch(q, k, v, dout, lse,
// delta, dq, dk, dv, B, Hq, Hkv, Lq, Lk, D, causal, scale, dtype, stream)
// with dtype 0 = float32, 1 = bfloat16, D in {32, 64, 128, 256}, every
// tensor pointer 16-byte aligned; lse is the forward's fp32 (B, Hq, Lq)
// natural log-sum-exp of the scaled logits and delta an fp32 (B, Hq, Lq)
// scratch buffer the first pass fills.  Launches the two kernels in
// order on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int kBK = D == 256 ? 32 : 64;  // keys of a tile
  static constexpr int kBQ = D >= 128 ? 32 : 64;  // q rows of a tile
  static constexpr int kVec = D >= 64 ? 4 : 1;    // floats a column read
  static constexpr int kStride = kVec == 4 ? D + 4 : D + 1;
  static constexpr int kCols = D / (16 * kVec);   // column groups a thread
  static constexpr int kPStride = kBK + 1;        // a row of P / dS
  // shared memory: two tiles of kBQ rows (Q, dO), two of kBK (K, V),
  // P and dS (kBQ x kBK), lse and delta of the q tile
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(2) * (kBQ + kBK) * kStride +
                       size_t(2) * kBQ * kPStride + 2 * kBQ);
};

// rows [r0, r0 + rows) of a (L, D) matrix of T into a tile of fp32 rows of
// `stride` floats; rows past L read as zeros.  16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ tile,
                                          const T* __restrict__ src, int r0,
                                          int rows, int L, int stride) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int kUnits = D / kPer;      // loads a row
  for (int idx = threadIdx.x; idx < rows * kUnits; idx += kThreads) {
    const int r = idx / kUnits, u = idx % kUnits;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < L)
      raw = __ldg(reinterpret_cast<const uint4*>(src + size_t(r0 + r) * D) +
                  u);
    float f[kPer];
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (sizeof(T) == 4) {
        f[e] = __uint_as_float(w[e]);
      } else {
        f[2 * e] = __uint_as_float(w[e] << 16);
        f[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
      }
    }
    float* dst = tile + r * stride + u * kPer;
    if (stride % 4 == 0) {  // 16-byte stores into a padded row
#pragma unroll
      for (int e = 0; e < kPer; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) dst[e] = f[e];
    }
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two tiles of fp32
// rows (`stride` floats apart)
template <int D, int SI, int SJ>
__device__ __forceinline__ void tile_dot(float (&s)[SI][SJ],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         int ty, int tx) {
  using C = Tiles<D>;
#pragma unroll
  for (int i = 0; i < SI; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j) s[i][j] = 0.f;
  if constexpr (C::kVec == 4) {
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[SI], b[SJ];
#pragma unroll
      for (int i = 0; i < SI; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            A + (ty + 16 * i) * C::kStride + d);
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(
            B + (tx + 16 * j) * C::kStride + d);
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          float x = s[i][j];
          x = fmaf(a[i].x, b[j].x, x);
          x = fmaf(a[i].y, b[j].y, x);
          x = fmaf(a[i].z, b[j].z, x);
          s[i][j] = fmaf(a[i].w, b[j].w, x);
        }
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[SI], b[SJ];
#pragma unroll
      for (int i = 0; i < SI; ++i) a[i] = A[(ty + 16 * i) * C::kStride + d];
#pragma unroll
      for (int j = 0; j < SJ; ++j) b[j] = B[(tx + 16 * j) * C::kStride + d];
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
  }
}

// acc[i][c][e] += sum_r W[r][ty + 16 i] X[r][col(c, e)] over the `rows`
// rows of a weight tile W (kPStride floats a row; the weights of output
// row ty + 16 i sit in its column) and a value tile X; output column
// col(c, e) = 64 c + 4 tx + e (16 tx + ... at D = 32: tx + 16 c)
template <int D, int AI>
__device__ __forceinline__ void tile_accumulate(
    float (&acc)[AI][Tiles<D>::kCols][Tiles<D>::kVec],
    const float* __restrict__ W, const float* __restrict__ X, int rows,
    int ty, int tx) {
  using C = Tiles<D>;
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    float w[AI];
#pragma unroll
    for (int i = 0; i < AI; ++i) w[i] = W[r * C::kPStride + ty + 16 * i];
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) {
      if constexpr (C::kVec == 4) {
        const float4 x = *reinterpret_cast<const float4*>(
            X + r * C::kStride + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < AI; ++i) {
          acc[i][c][0] = fmaf(w[i], x.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(w[i], x.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(w[i], x.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(w[i], x.w, acc[i][c][3]);
        }
      } else {
        const float x = X[r * C::kStride + 16 * c + tx];
#pragma unroll
        for (int i = 0; i < AI; ++i) acc[i][c][0] = fmaf(w[i], x, acc[i][c][0]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]);

template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [r0, r0 + AI * 16) of a (L, D) output of T from a thread's
// accumulator block; rows past L are not written
template <typename T, int D, int AI>
__device__ __forceinline__ void store_rows(
    T* __restrict__ dst, const float (&acc)[AI][Tiles<D>::kCols]
                                            [Tiles<D>::kVec],
    int r0, int L, int ty, int tx) {
  using C = Tiles<D>;
#pragma unroll
  for (int i = 0; i < AI; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= L) continue;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) {
      if constexpr (C::kVec == 4)
        store4<T>(dst + size_t(r) * D + 64 * c + 4 * tx, acc[i][c]);
      else
        store1(dst + size_t(r) * D + 16 * c + tx, acc[i][c][0]);
    }
  }
}

// P and dP of one (q tile, key tile) pair in the S layout (row
// ty + 16 i, key tx + 16 j); lse2 holds the q tile's rows' log-sum-exp
// in base 2.  P is 0 past Lq, Lk and the diagonal.
template <int D, int SI, int SJ>
__device__ __forceinline__ void probs(
    float (&p)[SI][SJ], float (&dp)[SI][SJ], const float* __restrict__ Qs,
    const float* __restrict__ Ks, const float* __restrict__ Vs,
    const float* __restrict__ dOs, const float* __restrict__ lse2, int q0,
    int k0, int Lq, int Lk, int off, int causal, float scale_log2, int ty,
    int tx) {
  tile_dot<D, SI, SJ>(p, Qs, Ks, ty, tx);
  tile_dot<D, SI, SJ>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < SI; ++i) {
    const int r = ty + 16 * i;
    const int q = q0 + r;
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int k = k0 + tx + 16 * j;
      const bool valid = q < Lq && k < Lk && (!causal || k <= q + off);
      p[i][j] = valid ? exp2f(p[i][j] * scale_log2 - lse2[r]) : 0.f;
    }
  }
}

// ---- pass 1: dQ and D, a block per (batch * Hq + h, q tile)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta,
          T* __restrict__ dq, int Hq, int Hkv, int Lq, int Lk, int causal,
          float scale) {
  using C = Tiles<D>;
  constexpr int SI = C::kBQ / 16, SJ = C::kBK / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + C::kBQ * C::kStride;
  float* Ks = dOs + C::kBQ * C::kStride;
  float* Vs = Ks + C::kBK * C::kStride;
  float* Ws = Vs + C::kBK * C::kStride;   // P o dP
  float* Ps = Ws + C::kBQ * C::kPStride;  // P
  float* lse2 = Ps + C::kBQ * C::kPStride;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;  // long first
  const int q0 = qt * C::kBQ;
  const int bh = blockIdx.y;
  const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int off = Lk - Lq;
  const float scale_log2 = scale * kLog2e;

  load_tile<T, D>(Qs, q + size_t(bh) * Lq * D, q0, C::kBQ, Lq, C::kStride);
  load_tile<T, D>(dOs, dout + size_t(bh) * Lq * D, q0, C::kBQ, Lq,
                  C::kStride);
  for (int r = tid; r < C::kBQ; r += kThreads)
    lse2[r] = q0 + r < Lq ? lse[size_t(bh) * Lq + q0 + r] * kLog2e : 0.f;

  // A = sum_k P dP K and B = sum_k P K, by rows ty + 16 i; D by the same
  // rows, this thread's keys only until the end
  float acc_a[SI][C::kCols][C::kVec], acc_b[SI][C::kCols][C::kVec];
  float dsum[SI];
#pragma unroll
  for (int i = 0; i < SI; ++i) {
    dsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c)
#pragma unroll
      for (int e = 0; e < C::kVec; ++e) acc_a[i][c][e] = acc_b[i][c][e] = 0.f;
  }

  int n_kt = (Lk + C::kBK - 1) / C::kBK;
  if (causal)
    n_kt = min(n_kt, (min(q0 + C::kBQ, Lq) - 1 + off) / C::kBK + 1);
  const T* kb = k + size_t(bhk) * Lk * D;
  const T* vb = v + size_t(bhk) * Lk * D;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * C::kBK;
    __syncthreads();  // the previous tiles are consumed
    load_tile<T, D>(Ks, kb, k0, C::kBK, Lk, C::kStride);
    load_tile<T, D>(Vs, vb, k0, C::kBK, Lk, C::kStride);
    __syncthreads();
    float p[SI][SJ], dp[SI][SJ];
    probs<D, SI, SJ>(p, dp, Qs, Ks, Vs, dOs, lse2, q0, k0, Lq, Lk, off,
                     causal, scale_log2, ty, tx);
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const float w = p[i][j] * dp[i][j];
        dsum[i] += w;
        Ws[(ty + 16 * i) * C::kPStride + tx + 16 * j] = w;
        Ps[(ty + 16 * i) * C::kPStride + tx + 16 * j] = p[i][j];
      }
    __syncthreads();
    // A[q][d] += sum_k W[q][k] K[k][d], B[q][d] += sum_k P[q][k] K[k][d]
#pragma unroll 2
    for (int kk = 0; kk < C::kBK; ++kk) {
      float wa[SI], wb[SI];
#pragma unroll
      for (int i = 0; i < SI; ++i) {
        wa[i] = Ws[(ty + 16 * i) * C::kPStride + kk];
        wb[i] = Ps[(ty + 16 * i) * C::kPStride + kk];
      }
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) {
        if constexpr (C::kVec == 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              Ks + kk * C::kStride + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < SI; ++i) {
            acc_a[i][c][0] = fmaf(wa[i], x.x, acc_a[i][c][0]);
            acc_a[i][c][1] = fmaf(wa[i], x.y, acc_a[i][c][1]);
            acc_a[i][c][2] = fmaf(wa[i], x.z, acc_a[i][c][2]);
            acc_a[i][c][3] = fmaf(wa[i], x.w, acc_a[i][c][3]);
            acc_b[i][c][0] = fmaf(wb[i], x.x, acc_b[i][c][0]);
            acc_b[i][c][1] = fmaf(wb[i], x.y, acc_b[i][c][1]);
            acc_b[i][c][2] = fmaf(wb[i], x.z, acc_b[i][c][2]);
            acc_b[i][c][3] = fmaf(wb[i], x.w, acc_b[i][c][3]);
          }
        } else {
          const float x = Ks[kk * C::kStride + 16 * c + tx];
#pragma unroll
          for (int i = 0; i < SI; ++i) {
            acc_a[i][c][0] = fmaf(wa[i], x, acc_a[i][c][0]);
            acc_b[i][c][0] = fmaf(wb[i], x, acc_b[i][c][0]);
          }
        }
      }
    }
  }
  // D of each row: the 16 lanes holding its keys (one half-warp)
#pragma unroll
  for (int i = 0; i < SI; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], o);
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < Lq) delta[size_t(bh) * Lq + r] = dsum[i];
#pragma unroll
    for (int c = 0; c < C::kCols; ++c)
#pragma unroll
      for (int e = 0; e < C::kVec; ++e)
        acc_a[i][c][e] = scale * (acc_a[i][c][e] - dsum[i] * acc_b[i][c][e]);
  }
  store_rows<T, D, SI>(dq + size_t(bh) * Lq * D, acc_a, q0, Lq, ty, tx);
}

// ---- pass 2: dK and dV, a block per (batch * Hkv + kv head, key tile)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Lq,
            int Lk, int causal, float scale) {
  using C = Tiles<D>;
  constexpr int SI = C::kBQ / 16, SJ = C::kBK / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + C::kBQ * C::kStride;
  float* Ks = dOs + C::kBQ * C::kStride;
  float* Vs = Ks + C::kBK * C::kStride;
  float* Ps = Vs + C::kBK * C::kStride;
  float* dSs = Ps + C::kBQ * C::kPStride;
  float* lse2 = dSs + C::kBQ * C::kPStride;
  float* dlt = lse2 + C::kBQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * C::kBK;  // the first key tiles work longest
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, group = Hq / Hkv;
  const int off = Lk - Lq;
  const float scale_log2 = scale * kLog2e;

  load_tile<T, D>(Ks, k + size_t(bhk) * Lk * D, k0, C::kBK, Lk, C::kStride);
  load_tile<T, D>(Vs, v + size_t(bhk) * Lk * D, k0, C::kBK, Lk, C::kStride);

  constexpr int AI = C::kBK / 16;
  float acc_k[AI][C::kCols][C::kVec], acc_v[AI][C::kCols][C::kVec];
#pragma unroll
  for (int i = 0; i < AI; ++i)
#pragma unroll
    for (int c = 0; c < C::kCols; ++c)
#pragma unroll
      for (int e = 0; e < C::kVec; ++e) acc_k[i][c][e] = acc_v[i][c][e] = 0.f;

  const int n_qt = (Lq + C::kBQ - 1) / C::kBQ;
  // causal: rows r with r + off >= k0 see this tile
  const int qt_first = causal ? max(0, k0 - off) / C::kBQ : 0;
  for (int g = 0; g < group; ++g) {
    const int bh = b * Hq + hk * group + g;
    const T* qb = q + size_t(bh) * Lq * D;
    const T* db = dout + size_t(bh) * Lq * D;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * C::kBQ;
      __syncthreads();  // the previous tiles are consumed
      load_tile<T, D>(Qs, qb, q0, C::kBQ, Lq, C::kStride);
      load_tile<T, D>(dOs, db, q0, C::kBQ, Lq, C::kStride);
      for (int r = tid; r < C::kBQ; r += kThreads) {
        const bool in = q0 + r < Lq;
        lse2[r] = in ? lse[size_t(bh) * Lq + q0 + r] * kLog2e : 0.f;
        dlt[r] = in ? delta[size_t(bh) * Lq + q0 + r] : 0.f;
      }
      __syncthreads();
      float p[SI][SJ], dp[SI][SJ];
      probs<D, SI, SJ>(p, dp, Qs, Ks, Vs, dOs, lse2, q0, k0, Lq, Lk, off,
                       causal, scale_log2, ty, tx);
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const int at = (ty + 16 * i) * C::kPStride + tx + 16 * j;
          Ps[at] = p[i][j];
          dSs[at] = p[i][j] * (dp[i][j] - dlt[ty + 16 * i]) * scale;
        }
      __syncthreads();
      // dV[k][d] += sum_q P[q][k] dO[q][d]; dK[k][d] += sum_q dS[q][k] Q[q][d]
      tile_accumulate<D, AI>(acc_v, Ps, dOs, C::kBQ, ty, tx);
      tile_accumulate<D, AI>(acc_k, dSs, Qs, C::kBQ, ty, tx);
    }
  }
  store_rows<T, D, AI>(dk + size_t(bhk) * Lk * D, acc_k, k0, Lk, ty, tx);
  store_rows<T, D, AI>(dv + size_t(bhk) * Lk * D, acc_v, k0, Lk, ty, tx);
}

// ===================== bf16: tensor cores (mma.sync) =====================
//
// The same two passes on bf16 inputs, every product on the tensor cores
// by mma.sync m16n8k16 (bf16 operands, fp32 sums) with ldmatrix loads:
// tiles sit in shared memory as bf16 rows of D + 8 values (16 bytes of
// padding, so the 8 rows an ldmatrix reads hit 8 different bank
// groups), a block is 8 warps.  Q K^T and dO V^T take both operands
// straight from the tiles; P^T dO and dS^T Q take P^T and dS^T by
// transposed ldmatrix from P and dS stored by rows; dS K takes K by
// transposed ldmatrix.  D = rowsum(P o dP) and dS = P (dP - D) are
// formed in fp32, and P and dS enter their products as two bf16 terms
// each, hi = bf16(x) and lo = bf16(x - hi), as the forward feeds P: a
// single bf16 rounding put dQ at 2.29x the bf16 gate's allowance per
// element on an H100.  That makes 12 products of the forward's size.
//   * dq_mma: a block per (b, q head, 64 q rows), two sweeps over the
//     causal key tiles of 64: the first sums D (4 x 2 warps each own 16
//     rows x 32 keys of S and dP), the second forms dS into shared memory
//     and adds dS K, each warp owning 16 rows x D / 2 columns of dQ;
//   * dkdv_mma: a block per (b, kv head, BK keys; BK = 32 at D = 256,
//     else 64), for each query head of the group and each causal q tile
//     of 64 rows, S and dP by 4 x 2 warps, P and dS into shared memory,
//     then dV += P^T dO and dK += dS^T Q, each warp owning 16 keys x
//     D BK / 128 columns of both (64 fp32 registers a thread).

constexpr int kMmaQ = 64;  // q rows of a tile

template <int D>
struct MmaTiles {
  static constexpr int kRow = D + 8;               // bf16 a tile row
  static constexpr int kBK = D == 256 ? 32 : 64;   // keys of a dK/dV block
  static constexpr int kPRow = 64 + 8;             // bf16 a P / dS row
};

// ldmatrix x4 address of lane `lane` for the 16 x 16 block at (r0, c0) of
// a bf16 tile of `row` values a row: matrices (rows 0-7, cols 0-7),
// (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) of the block
__device__ __forceinline__ uint32_t ldsm_addr(const __nv_bfloat16* tile,
                                              int row, int r0, int c0,
                                              int lane) {
  return hopper::smem_u32(tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                     row +
                          c0 + (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 as two bf16 pairs whose sum keeps ~16 significant bits: hi the
// nearest bf16 values, lo the nearest bf16 values of the remainders
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(x0 - back.x, x1 - back.y);
}

// rows [r0, r0 + rows) of a (L, D) bf16 matrix into a tile of `row`
// values a row, 16 bytes a thread; rows past L are zeros
template <int D>
__device__ __forceinline__ void load_bf16(__nv_bfloat16* tile,
                                         const __nv_bfloat16* src, int r0,
                                         int rows, int L, int row) {
  constexpr int kUnits = D / 8;
  for (int idx = threadIdx.x; idx < rows * kUnits; idx += kThreads) {
    const int r = idx / kUnits, u = idx % kUnits;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < L)
      v = __ldg(reinterpret_cast<const uint4*>(src + size_t(r0 + r) * D) +
                u);
    *reinterpret_cast<uint4*>(tile + r * row + u * 8) = v;
  }
}

// s (+)= A B^T for one warp: A rows [a0, a0 + 16) of tile `a`, B rows
// [b0, b0 + 8 NT) of tile `b`, both (rows x D) bf16; s[nt] is the
// fragment of B rows b0 + 8 nt .. + 7
template <int D, int NT>
__device__ __forceinline__ void warp_abt(float (&s)[NT][4],
                                         const __nv_bfloat16* a, int a0,
                                         const __nv_bfloat16* b, int b0,
                                         int lane) {
  constexpr int R = MmaTiles<D>::kRow;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t fa[4];
    hopper::ldmatrix_x4(fa, ldsm_addr(a, R, a0, kk, lane));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t fb[4];
      hopper::ldmatrix_x4(fb, ldsm_addr(b, R, b0 + 16 * np, kk, lane));
      hopper::mma_bf16_16816(s[2 * np], fa[0], fa[1], fa[2], fa[3], fb[0],
                             fb[2]);
      hopper::mma_bf16_16816(s[2 * np + 1], fa[0], fa[1], fa[2], fa[3],
                             fb[1], fb[3]);
    }
  }
}

// P and dP of a warp's 16 q rows x 8 NT keys: P = exp2(s scale log2 e -
// lse) masked past Lq, Lk and the diagonal; rows w0 + g, w0 + g + 8 of
// the tile (lse2 by tile row), keys k0 + 8 nt + 2 t (+ 1)
template <int NT>
__device__ __forceinline__ void mma_probs(float (&s)[NT][4],
                                          const float* lse2, int w0,
                                          int q0, int k0, int Lq, int Lk,
                                          int off, int causal,
                                          float scale_log2, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = w0 + g + 8 * (e >> 1);
      const int q = q0 + r;
      const int k = k0 + 8 * nt + 2 * t + (e & 1);
      const bool valid = q < Lq && k < Lk && (!causal || k <= q + off);
      s[nt][e] = valid ? exp2f(s[nt][e] * scale_log2 - lse2[r]) : 0.f;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_mma(const __nv_bfloat16* __restrict__ q,
       const __nv_bfloat16* __restrict__ k,
       const __nv_bfloat16* __restrict__ v,
       const __nv_bfloat16* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta,
       __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Lq, int Lk,
       int causal, float scale) {
  using C = MmaTiles<D>;
  constexpr int R = C::kRow, BK = 64, NT = BK / 2 / 8, DW = D / 2;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* dOs = Qs + kMmaQ * R;
  __nv_bfloat16* Ks = dOs + kMmaQ * R;
  __nv_bfloat16* Vs = Ks + BK * R;
  __nv_bfloat16* dSs = Vs + BK * R;                    // [q][key], hi
  __nv_bfloat16* dSl = dSs + kMmaQ * C::kPRow;         // lo
  float* lse2 = reinterpret_cast<float*>(dSl + kMmaQ * C::kPRow);
  float* dlt = lse2 + kMmaQ;
  float* red = dlt + kMmaQ;                            // [2][kMmaQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wq = warp & 3, wk = warp >> 2;  // S: rows 16 wq, keys 32 wk
  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kMmaQ;
  const int bh = blockIdx.y;
  const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int off = Lk - Lq;
  const float scale_log2 = scale * kLog2e;
  const __nv_bfloat16* kb = k + size_t(bhk) * Lk * D;
  const __nv_bfloat16* vb = v + size_t(bhk) * Lk * D;

  load_bf16<D>(Qs, q + size_t(bh) * Lq * D, q0, kMmaQ, Lq, R);
  load_bf16<D>(dOs, dout + size_t(bh) * Lq * D, q0, kMmaQ, Lq, R);
  for (int r = threadIdx.x; r < kMmaQ; r += kThreads)
    lse2[r] = q0 + r < Lq ? lse[size_t(bh) * Lq + q0 + r] * kLog2e : 0.f;
  int n_kt = (Lk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + kMmaQ, Lq) - 1 + off) / BK + 1);

  // sweep 1: D = rowsum(P o dP) over every key
  float dsum[2] = {0.f, 0.f};
  for (int tk = 0; tk < n_kt; ++tk) {
    const int k0 = tk * BK;
    __syncthreads();
    load_bf16<D>(Ks, kb, k0, BK, Lk, R);
    load_bf16<D>(Vs, vb, k0, BK, Lk, R);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    warp_abt<D, NT>(s, Qs, 16 * wq, Ks, 32 * wk, lane);
    warp_abt<D, NT>(dp, dOs, 16 * wq, Vs, 32 * wk, lane);
    mma_probs<NT>(s, lse2, 16 * wq, q0, k0 + 32 * wk, Lq, Lk, off, causal,
                  scale_log2, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[e >> 1] += s[nt][e] * dp[nt][e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 1);
    dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 2);
    if (t == 0) red[wk * kMmaQ + 16 * wq + g + 8 * i] = dsum[i];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kMmaQ; r += kThreads) {
    dlt[r] = red[r] + red[kMmaQ + r];
    if (q0 + r < Lq) delta[size_t(bh) * Lq + q0 + r] = dlt[r];
  }

  // sweep 2: dS = P (dP - D) scale, dQ += dS K
  float acc[DW / 8][4];
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int tk = 0; tk < n_kt; ++tk) {
    const int k0 = tk * BK;
    __syncthreads();  // dlt is written; the previous tiles are consumed
    load_bf16<D>(Ks, kb, k0, BK, Lk, R);
    load_bf16<D>(Vs, vb, k0, BK, Lk, R);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    warp_abt<D, NT>(s, Qs, 16 * wq, Ks, 32 * wk, lane);
    warp_abt<D, NT>(dp, dOs, 16 * wq, Vs, 32 * wk, lane);
    mma_probs<NT>(s, lse2, 16 * wq, q0, k0 + 32 * wk, Lq, Lk, off, causal,
                  scale_log2, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wq + g + 8 * h;
        const int at = r * C::kPRow + 32 * wk + 8 * nt + 2 * t;
        const float d0 = dlt[r];
        split2(s[nt][2 * h] * (dp[nt][2 * h] - d0) * scale,
               s[nt][2 * h + 1] * (dp[nt][2 * h + 1] - d0) * scale,
               *reinterpret_cast<uint32_t*>(dSs + at),
               *reinterpret_cast<uint32_t*>(dSl + at));
      }
    __syncthreads();
    // dQ rows 16 wq.., columns DW wk..: A = dS (hi, lo), B = K
    // (transposed loads)
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t fh[4], fl[4];
      hopper::ldmatrix_x4(fh, ldsm_addr(dSs, C::kPRow, 16 * wq, kk, lane));
      hopper::ldmatrix_x4(fl, ldsm_addr(dSl, C::kPRow, 16 * wq, kk, lane));
#pragma unroll
      for (int np = 0; np < DW / 16; ++np) {
        uint32_t fb[4];
        hopper::ldmatrix_x4_trans(
            fb, ldsm_addr(Ks, R, kk, DW * wk + 16 * np, lane));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          hopper::mma_bf16_16816(acc[2 * np + j], fh[0], fh[1], fh[2],
                                 fh[3], fb[2 * j], fb[2 * j + 1]);
          hopper::mma_bf16_16816(acc[2 * np + j], fl[0], fl[1], fl[2],
                                 fl[3], fb[2 * j], fb[2 * j + 1]);
        }
      }
    }
  }
  __nv_bfloat16* ob = dq + size_t(bh) * Lq * D;
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + 16 * wq + g + 8 * h;
      if (r < Lq)
        *reinterpret_cast<uint32_t*>(ob + size_t(r) * D + DW * wk + 8 * nt +
                                     2 * t) =
            pack2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_mma(const __nv_bfloat16* __restrict__ q,
         const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
         int Hq, int Hkv, int Lq, int Lk, int causal, float scale) {
  using C = MmaTiles<D>;
  constexpr int R = C::kRow, BK = C::kBK;
  constexpr int NT = BK / 2 / 8;          // S: n-tiles a warp (BK/2 keys)
  constexpr int WK = BK / 16;             // dK/dV: warps along the keys
  constexpr int DW = D / (8 / WK);        // dK/dV: columns a warp
  extern __shared__ __align__(16) uint8_t mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* dOs = Qs + kMmaQ * R;
  __nv_bfloat16* Ks = dOs + kMmaQ * R;
  __nv_bfloat16* Vs = Ks + BK * R;
  // P and dS by rows [q][key], each as hi and lo terms
  __nv_bfloat16* Ps = Vs + BK * R;
  __nv_bfloat16* Pl = Ps + kMmaQ * C::kPRow;
  __nv_bfloat16* dSs = Pl + kMmaQ * C::kPRow;
  __nv_bfloat16* dSl = dSs + kMmaQ * C::kPRow;
  float* lse2 = reinterpret_cast<float*>(dSl + kMmaQ * C::kPRow);
  float* dlt = lse2 + kMmaQ;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wq = warp & 3, ws = warp >> 2;   // S: rows 16 wq, keys BK/2 ws
  const int wk = warp % WK, wd = warp / WK;  // dK, dV: keys 16 wk, cols DW wd
  const int k0 = blockIdx.x * BK;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, group = Hq / Hkv;
  const int off = Lk - Lq;
  const float scale_log2 = scale * kLog2e;

  load_bf16<D>(Ks, k + size_t(bhk) * Lk * D, k0, BK, Lk, R);
  load_bf16<D>(Vs, v + size_t(bhk) * Lk * D, k0, BK, Lk, R);
  float acc_k[DW / 8][4], acc_v[DW / 8][4];
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nt][e] = acc_v[nt][e] = 0.f;

  const int n_qt = (Lq + kMmaQ - 1) / kMmaQ;
  const int qt_first = causal ? max(0, k0 - off) / kMmaQ : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int bh = b * Hq + hk * group + gi;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * kMmaQ;
      __syncthreads();
      load_bf16<D>(Qs, q + size_t(bh) * Lq * D, q0, kMmaQ, Lq, R);
      load_bf16<D>(dOs, dout + size_t(bh) * Lq * D, q0, kMmaQ, Lq, R);
      for (int r = threadIdx.x; r < kMmaQ; r += kThreads) {
        const bool in = q0 + r < Lq;
        lse2[r] = in ? lse[size_t(bh) * Lq + q0 + r] * kLog2e : 0.f;
        dlt[r] = in ? delta[size_t(bh) * Lq + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[NT][4], dp[NT][4];
      warp_abt<D, NT>(s, Qs, 16 * wq, Ks, (BK / 2) * ws, lane);
      warp_abt<D, NT>(dp, dOs, 16 * wq, Vs, (BK / 2) * ws, lane);
      mma_probs<NT>(s, lse2, 16 * wq, q0, k0 + (BK / 2) * ws, Lq, Lk, off,
                    causal, scale_log2, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + g + 8 * h;
          const int at = r * C::kPRow + (BK / 2) * ws + 8 * nt + 2 * t;
          const float d0 = dlt[r];
          split2(s[nt][2 * h], s[nt][2 * h + 1],
                 *reinterpret_cast<uint32_t*>(Ps + at),
                 *reinterpret_cast<uint32_t*>(Pl + at));
          split2(s[nt][2 * h] * (dp[nt][2 * h] - d0) * scale,
                 s[nt][2 * h + 1] * (dp[nt][2 * h + 1] - d0) * scale,
                 *reinterpret_cast<uint32_t*>(dSs + at),
                 *reinterpret_cast<uint32_t*>(dSl + at));
        }
      __syncthreads();
      // keys 16 wk.., columns DW wd..: A = P^T / dS^T (hi, lo; transposed
      // loads of rows q, so the fragment's registers come as 0, 2, 1, 3),
      // B = dO / Q (transposed loads)
#pragma unroll
      for (int kq = 0; kq < kMmaQ; kq += 16) {
        uint32_t a[4][4];  // P hi, P lo, dS hi, dS lo
        const __nv_bfloat16* src[4] = {Ps, Pl, dSs, dSl};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          hopper::ldmatrix_x4_trans(
              a[i], ldsm_addr(src[i], C::kPRow, kq, 16 * wk, lane));
#pragma unroll
        for (int np = 0; np < DW / 16; ++np) {
          uint32_t fo[4], fq[4];
          hopper::ldmatrix_x4_trans(
              fo, ldsm_addr(dOs, R, kq, DW * wd + 16 * np, lane));
          hopper::ldmatrix_x4_trans(
              fq, ldsm_addr(Qs, R, kq, DW * wd + 16 * np, lane));
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              hopper::mma_bf16_16816(acc_v[2 * np + j], a[i][0], a[i][2],
                                     a[i][1], a[i][3], fo[2 * j],
                                     fo[2 * j + 1]);
              hopper::mma_bf16_16816(acc_k[2 * np + j], a[2 + i][0],
                                     a[2 + i][2], a[2 + i][1], a[2 + i][3],
                                     fq[2 * j], fq[2 * j + 1]);
            }
        }
      }
    }
  }
  __nv_bfloat16* kbo = dk + size_t(bhk) * Lk * D;
  __nv_bfloat16* vbo = dv + size_t(bhk) * Lk * D;
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = k0 + 16 * wk + g + 8 * h;
      if (r >= Lk) continue;
      const size_t at = size_t(r) * D + DW * wd + 8 * nt + 2 * t;
      *reinterpret_cast<uint32_t*>(kbo + at) =
          pack2(acc_k[nt][2 * h], acc_k[nt][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(vbo + at) =
          pack2(acc_v[nt][2 * h], acc_v[nt][2 * h + 1]);
    }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lk,
               int causal, float scale, cudaStream_t stream) {
  using C = MmaTiles<D>;
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dt = static_cast<const bf*>(dout);
  if (long(B) * Hq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int dq_bytes = static_cast<int>(
      sizeof(bf) * (2 * (kMmaQ + 64) * C::kRow + 2 * kMmaQ * C::kPRow) +
      sizeof(float) * 4 * kMmaQ);
  cudaError_t err = cudaFuncSetAttribute(
      dq_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_mma<D><<<dim3((Lq + kMmaQ - 1) / kMmaQ, B * Hq), kThreads, dq_bytes,
              stream>>>(qt, kt, vt, dt, lse, delta, static_cast<bf*>(dq), Hq,
                        Hkv, Lq, Lk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kv_bytes = static_cast<int>(
      sizeof(bf) * (2 * (kMmaQ + C::kBK) * C::kRow + 4 * kMmaQ * C::kPRow) +
      sizeof(float) * 2 * kMmaQ);
  err = cudaFuncSetAttribute(
      dkdv_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_mma<D><<<dim3((Lk + C::kBK - 1) / C::kBK, B * Hkv), kThreads,
                kv_bytes, stream>>>(qt, kt, vt, dt, lse, delta,
                                    static_cast<bf*>(dk),
                                    static_cast<bf*>(dv), Hq, Hkv, Lq, Lk,
                                    causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lk,
           int causal, float scale, cudaStream_t stream) {
  using C = Tiles<D>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const int n_qt = (Lq + C::kBQ - 1) / C::kBQ;
  const int n_kt = (Lk + C::kBK - 1) / C::kBK;
  if (long(B) * Hq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = static_cast<int>(C::kSmem);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, D><<<dim3(n_qt, B * Hq), kThreads, bytes, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), Hq, Hkv, Lq, Lk,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, D><<<dim3(n_kt, B * Hkv), kThreads, bytes, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hkv, Lq, Lk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const void* q, const void* k, const void* v,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lk,
             int causal, float scale, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                            Hkv, Lq, Lk, causal, scale, stream);
  return launch_mma<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv,
                       Lq, Lk, causal, scale, stream);
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
    int Hq, int Hkv, int Lq, int Lk, int D, int causal, float scale,
    int dtype, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0 ||
      (causal && Lq > Lk) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  if (ptrs & 15) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return dispatch<32>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                          Hkv, Lq, Lk, causal, scale, dtype, stream);
    case 64:
      return dispatch<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                          Hkv, Lq, Lk, causal, scale, dtype, stream);
    case 128:
      return dispatch<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                           Hkv, Lq, Lk, causal, scale, dtype, stream);
    case 256:
      return dispatch<256>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                           Hkv, Lq, Lk, causal, scale, dtype, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
