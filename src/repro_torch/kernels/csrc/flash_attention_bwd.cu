// Backward of causal GQA attention for sm_90a: dQ, dK and dV from q, k,
// v, the output's gradient dO and the forward's per-row log-sum-exp
// (flash_attention.cu writes it), fp32 or bf16.
//
// Replaces jax.grad of src/repro/models/attention.py::_sdpa_block (the
// JAX package differentiates its attention as plain einsums; no Pallas
// kernel there has a backward).  Shapes as the forward: q (B, Hq, Lq, D),
// dO (B, Hq, Lq, Dv), k (B, Hkv, Lk, D), v (B, Hkv, Lk, Dv), all
// contiguous and of one type, the head dims a template pair <D, Dv> as in
// the forward (Dv = D, or (192, 128) for MLA, where the dQ pass sums
// 64 x 192 and the dK / dV pass 64 x 192 and 64 x 128);
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
//   1. dQ: a block per (batch, q head, q tile) holds its Q and dO rows
//      and walks the causal key tiles; it sums D = rowsum(P o dP) in
//      fp32 (not from the bf16-rounded output, whose rounding moved dQ
//      of rows with few keys by up to 3x the bf16 gate on an H100), then
//      dQ = scale * sum_k P (dP - D) K;
//   2. dK / dV: a block per (batch, kv head, key tile) holds its dK and
//      dV and walks the group's query heads and, for each, the causal q
//      tiles in order: dS = P (dP - D) scale, dV += P^T dO,
//      dK += dS^T Q.
// The input type chooses the kernels, as in the forward: bf16 runs on
// the tensor cores (dq_wgmma, dkdv_wgmma, below), fp32 on the CUDA cores
// (dq_kernel, dkdv_kernel), since an fp32 tensor-core product is TF32.
//
// fp32 (dq_kernel, dkdv_kernel): both passes recompute S and dP, 8
// products of the forward's size per tile pair against the forward's 2.
// Tiles sit in shared memory as fp32 rows padded to D + 4 floats (D + 1
// at D = 32), so that a thread reads four head-dim values of a row as one
// 16-byte load and 16 threads reading 16 different rows at one column hit
// 16 different banks; each thread keeps a (tile rows / 16) x (tile
// columns / 16) block of S and dP and a (rows / 16) x (D / 16) block of
// each accumulator.  At D = 256 a key tile is 32 rows (dK and dV are
// 32 x 256 fp32 each: 64 registers a thread), at D = 128 64 rows; q tiles
// are 32 rows at D >= 128, 64 below.
//
// bf16 (dq_wgmma, dkdv_wgmma, dkdv_reduce): the forward's Hopper pieces
// (hopper.cuh; flash_attention.cu's schedule and tensor maps).  Every
// product is wgmma (bf16 in, fp32 sums in registers); tiles arrive by TMA
// in the forward's swizzled layout (128-byte rows, 64-byte at D = 32,
// a row of D values as D / 64 column chunks of one swizzle atom each);
// P and dS enter their products as two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi) (a single rounding of dS put dQ at 2.29x the bf16
// gate's element allowance on an H100): 12 products of the forward's
// size per tile pair, two sweeps of 2 and 4 in the dQ pass, 6 in the
// dK / dV pass.
//   * dq_wgmma: a block of three warpgroups per (b, q head, 128 q rows),
//     the heaviest causal q tiles first (the grid's slow axis counts
//     down).  Warpgroup 2 is the producer (setmaxnreg 24): one thread
//     loads Q and dO once by TMA, then streams the 64-key K and V tiles
//     through two rings of stages, twice over (one sweep each), each
//     stage's arrival counted on an mbarrier in bytes and its release
//     on another by every consumer warp; no block-wide barrier in the key
//     loop.  Each consumer warpgroup (setmaxnreg 240) owns 64 rows:
//     S = Q K^T and dP = dO V^T by wgmma.m64n64k16 from shared memory,
//     P = exp2(S scale log2 e - lse log2 e) in registers.  Sweep 1 sums
//     D over the keys; sweep 2 forms dS in the accumulator's registers,
//     whose layout is the A fragment's, and adds dQ += dS K by
//     wgmma.m64nDk16 with K as the MN-major operand (the transpose bit),
//     as the forward adds P V; V's stage is released as soon as dP is
//     done.  Key tiles past a warpgroup's last row are skipped.  At
//     D = 256 a thread holds dQ 128 + S 32 + dP 32 fp32 registers.  The
//     pass also writes each row's lse log2 e and D, padded to Lq_pad =
//     64 ceil(Lq / 64) rows per head (+inf and 0 past Lq, so that padded
//     rows give P = 0 without a mask), to the scratch buffer for pass 2.
//     Shared memory: Q and dO 128 x D each, K and V stages of 64 x D:
//     at D = 256 two K stages and one V stage (64 + 64 + 64 + 32 =
//     224 KB of the SM's 227; two V stages would need 256), four of each
//     below (192, 96 and 48 KB at D = 128, 64, 32); at (192, 128) Q 48
//     KB, dO 32 KB and three stages each of K (24 KB) and V (16 KB),
//     200 KB, with dQ 96 fp32 registers a thread.
//   * dkdv_wgmma: a block of three warpgroups per (b, kv head, 64 keys,
//     head split), key tiles with the most causal q tiles first on the
//     grid's slow axis.  The producer loads K and V once, then streams
//     Q, dO (64 rows each, TMA) and their rows' lse log2 e and D (256
//     bytes each, bulk copies from the scratch) through a ring, over the
//     split's query heads and each head's causal q tiles in order.  With
//     the keys as M, S^T = K Q^T and dP^T = V dO^T sit in the A
//     fragment's layout, so dV += P^T dO and dK += dS^T Q take P^T and
//     dS^T from registers and dO and Q as MN-major operands: no
//     transposed loads.  dK and dV of 64 keys at D = 256 are 256 fp32
//     registers a thread in one warpgroup, so the two consumer
//     warpgroups split the roles: warpgroup 0 forms S^T and P^T (fp32,
//     16 KB of shared memory, handed over behind two named barriers,
//     full and empty) and owns dV; warpgroup 1 forms dP^T, reads P^T,
//     forms dS^T and owns dK; each holds 128 + 32 accumulator registers
//     at D = 256 and runs three products of the forward's size a tile
//     pair.  Shared memory: K, V 64 x D each, stages of Q and dO 64 x D
//     each plus 512 bytes of row statistics, P^T 16 KB: at D = 256 two
//     stages, 64 + 128 + 16 + 1 = 209 KB; four stages below (at (192,
//     128): 40 + 4 x 40.5 + 16 = 218 KB, dV 64 and dK 96 registers).
//   * MQA balance: where the grid of (b, kv head, key tile) blocks would
//     be under two waves (gemma-2b: 4 x 1 x 32 = 128 blocks on 132
//     SMs, the first key tile walking 8 heads x 32 q tiles and the last
//     8 x 1), the caller splits each query group over S_h blocks of at
//     least two heads each (kernels/flash_attention.py bwd_plan; gemma-2b
//     S_h = 4, 512 blocks).  Each block then writes fp32 partial dK and
//     dV to the scratch, and dkdv_reduce, a second launch of the same
//     call, sums them in split order and casts: the bits do not depend
//     on which block ends first.
//
// C interface (ctypes): flash_attention_bwd_launch(q, k, v, dout, lse,
// delta, scratch, dq, dk, dv, B, Hq, Hkv, Lq, Lk, D, Dv, causal, scale,
// head_splits, dtype, stream) with dtype 0 = float32, 1 = bfloat16, (D, Dv)
// one of (32, 32), (64, 64), (128, 128), (256, 256) and (192, 128) (a head
// split only with D = Dv), every tensor pointer 16-byte aligned; lse is the
// forward's fp32 (B, Hq, Lq) natural log-sum-exp of the scaled logits.
// fp32 takes delta, an fp32 (B, Hq, Lq) buffer the first pass fills, and
// no scratch (head_splits 1); bf16 takes no delta and an fp32 scratch of
// 2 B Hq Lq_pad floats (the padded row statistics) plus, when
// head_splits > 1, 2 head_splits B Hkv Lk_pad D (the partial dK and dV;
// Lk_pad = 64 ceil(Lk / 64)); head_splits divides Hq / Hkv.  Launches
// the kernels in order on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// an fp32 tile of W-wide rows: the floats a thread reads of a row at
// once, the padded row length, and a thread's column groups
template <int W>
struct Cols {
  static constexpr int kVec = W >= 64 ? 4 : 1;
  static constexpr int kStride = kVec == 4 ? W + 4 : W + 1;
  static constexpr int kCols = W / (16 * kVec);
};

// DK: the head dim of q and k (and dq, dk); DV: of v and dO (and dv)
template <int DK, int DV>
struct Tiles {
  static constexpr int kMax = DK > DV ? DK : DV;
  static constexpr int kBK = kMax == 256 ? 32 : 64;  // keys of a tile
  static constexpr int kBQ = kMax >= 128 ? 32 : 64;  // q rows of a tile
  static constexpr int kPStride = kBK + 1;           // a row of P / dS
  static constexpr int kQK = Cols<DK>::kStride, kV = Cols<DV>::kStride;
  // shared memory: Q (kBQ x DK), dO (kBQ x DV), K (kBK x DK), V (kBK x
  // DV), P and dS (kBQ x kBK), lse and delta of the q tile
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(kBQ + kBK) * (kQK + kV) +
                       size_t(2) * kBQ * kPStride + 2 * kBQ);
};

// rows [r0, r0 + rows) of a (L, W) matrix of T into a tile of fp32 rows of
// `stride` floats; rows past L read as zeros.  16-byte loads.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* __restrict__ tile,
                                          const T* __restrict__ src, int r0,
                                          int rows, int L, int stride) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int kUnits = W / kPer;      // loads a row
  for (int idx = threadIdx.x; idx < rows * kUnits; idx += kThreads) {
    const int r = idx / kUnits, u = idx % kUnits;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < L)
      raw = __ldg(reinterpret_cast<const uint4*>(src + size_t(r0 + r) * W) +
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
// rows of W values (Cols<W>::kStride floats apart)
template <int W, int SI, int SJ>
__device__ __forceinline__ void tile_dot(float (&s)[SI][SJ],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         int ty, int tx) {
  using C = Cols<W>;
#pragma unroll
  for (int i = 0; i < SI; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j) s[i][j] = 0.f;
  if constexpr (C::kVec == 4) {
#pragma unroll 4
    for (int d = 0; d < W; d += 4) {
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
    for (int d = 0; d < W; ++d) {
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

// acc[i][c][e] += sum_r P[r][ty + 16 i] X[r][col(c, e)] over the `rows`
// rows of a weight tile P (PS floats a row; the weights of output row
// ty + 16 i sit in its column) and a value tile X of W-wide rows; output
// column col(c, e) = 64 c + 4 tx + e (at W = 32: tx + 16 c)
template <int W, int AI, int PS>
__device__ __forceinline__ void tile_accumulate(
    float (&acc)[AI][Cols<W>::kCols][Cols<W>::kVec],
    const float* __restrict__ P, const float* __restrict__ X, int rows,
    int ty, int tx) {
  using C = Cols<W>;
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    float w[AI];
#pragma unroll
    for (int i = 0; i < AI; ++i) w[i] = P[r * PS + ty + 16 * i];
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

// rows [r0, r0 + AI * 16) of a (L, W) output of T from a thread's
// accumulator block; rows past L are not written
template <typename T, int W, int AI>
__device__ __forceinline__ void store_rows(
    T* __restrict__ dst, const float (&acc)[AI][Cols<W>::kCols]
                                            [Cols<W>::kVec],
    int r0, int L, int ty, int tx) {
  using C = Cols<W>;
#pragma unroll
  for (int i = 0; i < AI; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= L) continue;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) {
      if constexpr (C::kVec == 4)
        store4<T>(dst + size_t(r) * W + 64 * c + 4 * tx, acc[i][c]);
      else
        store1(dst + size_t(r) * W + 16 * c + tx, acc[i][c][0]);
    }
  }
}

// P and dP of one (q tile, key tile) pair in the S layout (row
// ty + 16 i, key tx + 16 j); lse2 holds the q tile's rows' log-sum-exp
// in base 2.  P is 0 past Lq, Lk and the diagonal.
template <int DK, int DV, int SI, int SJ>
__device__ __forceinline__ void probs(
    float (&p)[SI][SJ], float (&dp)[SI][SJ], const float* __restrict__ Qs,
    const float* __restrict__ Ks, const float* __restrict__ Vs,
    const float* __restrict__ dOs, const float* __restrict__ lse2, int q0,
    int k0, int Lq, int Lk, int off, int causal, float scale_log2, int ty,
    int tx) {
  tile_dot<DK, SI, SJ>(p, Qs, Ks, ty, tx);
  tile_dot<DV, SI, SJ>(dp, dOs, Vs, ty, tx);
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

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta,
          T* __restrict__ dq, int Hq, int Hkv, int Lq, int Lk, int causal,
          float scale) {
  using C = Tiles<DK, DV>;
  using QK = Cols<DK>;
  constexpr int SI = C::kBQ / 16, SJ = C::kBK / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + C::kBQ * C::kQK;
  float* Ks = dOs + C::kBQ * C::kV;
  float* Vs = Ks + C::kBK * C::kQK;
  float* Ws = Vs + C::kBK * C::kV;        // P o dP
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

  load_tile<T, DK>(Qs, q + size_t(bh) * Lq * DK, q0, C::kBQ, Lq, C::kQK);
  load_tile<T, DV>(dOs, dout + size_t(bh) * Lq * DV, q0, C::kBQ, Lq, C::kV);
  for (int r = tid; r < C::kBQ; r += kThreads)
    lse2[r] = q0 + r < Lq ? lse[size_t(bh) * Lq + q0 + r] * kLog2e : 0.f;

  // A = sum_k P dP K and B = sum_k P K, by rows ty + 16 i; D by the same
  // rows, this thread's keys only until the end
  float acc_a[SI][QK::kCols][QK::kVec], acc_b[SI][QK::kCols][QK::kVec];
  float dsum[SI];
#pragma unroll
  for (int i = 0; i < SI; ++i) {
    dsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < QK::kCols; ++c)
#pragma unroll
      for (int e = 0; e < QK::kVec; ++e)
        acc_a[i][c][e] = acc_b[i][c][e] = 0.f;
  }

  int n_kt = (Lk + C::kBK - 1) / C::kBK;
  if (causal)
    n_kt = min(n_kt, (min(q0 + C::kBQ, Lq) - 1 + off) / C::kBK + 1);
  const T* kb = k + size_t(bhk) * Lk * DK;
  const T* vb = v + size_t(bhk) * Lk * DV;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * C::kBK;
    __syncthreads();  // the previous tiles are consumed
    load_tile<T, DK>(Ks, kb, k0, C::kBK, Lk, C::kQK);
    load_tile<T, DV>(Vs, vb, k0, C::kBK, Lk, C::kV);
    __syncthreads();
    float p[SI][SJ], dp[SI][SJ];
    probs<DK, DV, SI, SJ>(p, dp, Qs, Ks, Vs, dOs, lse2, q0, k0, Lq, Lk, off,
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
      for (int c = 0; c < QK::kCols; ++c) {
        if constexpr (QK::kVec == 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              Ks + kk * C::kQK + 64 * c + 4 * tx);
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
          const float x = Ks[kk * C::kQK + 16 * c + tx];
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
    for (int c = 0; c < QK::kCols; ++c)
#pragma unroll
      for (int e = 0; e < QK::kVec; ++e)
        acc_a[i][c][e] = scale * (acc_a[i][c][e] - dsum[i] * acc_b[i][c][e]);
  }
  store_rows<T, DK, SI>(dq + size_t(bh) * Lq * DK, acc_a, q0, Lq, ty, tx);
}

// ---- pass 2: dK and dV, a block per (batch * Hkv + kv head, key tile)

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Lq,
            int Lk, int causal, float scale) {
  using C = Tiles<DK, DV>;
  using QK = Cols<DK>;
  using VV = Cols<DV>;
  constexpr int SI = C::kBQ / 16, SJ = C::kBK / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + C::kBQ * C::kQK;
  float* Ks = dOs + C::kBQ * C::kV;
  float* Vs = Ks + C::kBK * C::kQK;
  float* Ps = Vs + C::kBK * C::kV;
  float* dSs = Ps + C::kBQ * C::kPStride;
  float* lse2 = dSs + C::kBQ * C::kPStride;
  float* dlt = lse2 + C::kBQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * C::kBK;  // the first key tiles work longest
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, group = Hq / Hkv;
  const int off = Lk - Lq;
  const float scale_log2 = scale * kLog2e;

  load_tile<T, DK>(Ks, k + size_t(bhk) * Lk * DK, k0, C::kBK, Lk, C::kQK);
  load_tile<T, DV>(Vs, v + size_t(bhk) * Lk * DV, k0, C::kBK, Lk, C::kV);

  constexpr int AI = C::kBK / 16;
  float acc_k[AI][QK::kCols][QK::kVec], acc_v[AI][VV::kCols][VV::kVec];
#pragma unroll
  for (int i = 0; i < AI; ++i) {
#pragma unroll
    for (int c = 0; c < QK::kCols; ++c)
#pragma unroll
      for (int e = 0; e < QK::kVec; ++e) acc_k[i][c][e] = 0.f;
#pragma unroll
    for (int c = 0; c < VV::kCols; ++c)
#pragma unroll
      for (int e = 0; e < VV::kVec; ++e) acc_v[i][c][e] = 0.f;
  }

  const int n_qt = (Lq + C::kBQ - 1) / C::kBQ;
  // causal: rows r with r + off >= k0 see this tile
  const int qt_first = causal ? max(0, k0 - off) / C::kBQ : 0;
  for (int g = 0; g < group; ++g) {
    const int bh = b * Hq + hk * group + g;
    const T* qb = q + size_t(bh) * Lq * DK;
    const T* db = dout + size_t(bh) * Lq * DV;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * C::kBQ;
      __syncthreads();  // the previous tiles are consumed
      load_tile<T, DK>(Qs, qb, q0, C::kBQ, Lq, C::kQK);
      load_tile<T, DV>(dOs, db, q0, C::kBQ, Lq, C::kV);
      for (int r = tid; r < C::kBQ; r += kThreads) {
        const bool in = q0 + r < Lq;
        lse2[r] = in ? lse[size_t(bh) * Lq + q0 + r] * kLog2e : 0.f;
        dlt[r] = in ? delta[size_t(bh) * Lq + q0 + r] : 0.f;
      }
      __syncthreads();
      float p[SI][SJ], dp[SI][SJ];
      probs<DK, DV, SI, SJ>(p, dp, Qs, Ks, Vs, dOs, lse2, q0, k0, Lq, Lk,
                            off, causal, scale_log2, ty, tx);
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
      tile_accumulate<DV, AI, C::kPStride>(acc_v, Ps, dOs, C::kBQ, ty, tx);
      tile_accumulate<DK, AI, C::kPStride>(acc_k, dSs, Qs, C::kBQ, ty, tx);
    }
  }
  store_rows<T, DK, AI>(dk + size_t(bhk) * Lk * DK, acc_k, k0, Lk, ty, tx);
  store_rows<T, DV, AI>(dv + size_t(bhk) * Lk * DV, acc_v, k0, Lk, ty, tx);
}


// ======================= bf16: tensor cores (wgmma) ======================

constexpr int kTile = 64;          // keys of a K/V tile, q rows of a Q/dO tile
constexpr int kDqRows = 128;       // q rows of a dQ block (two warpgroups)
constexpr int kWgThreads = 128;
constexpr int kThreadsWg = 3 * kWgThreads;
constexpr int kConsumerWarps = 8;
constexpr int kPFull = 1, kPEmpty = 2;  // named barriers of the P^T handover

// bf16 rows of W values as swizzled column chunks of one atom each
template <int W>
struct Swz {
  static constexpr int kSwizzle = W >= 64 ? 128 : 64;  // bytes a tile row
  static constexpr int kChunkCols = kSwizzle / 2;      // bf16 a tile row
  static constexpr int kChunks = W / kChunkCols;
  static_assert(kChunks * kChunkCols == W, "rows of whole chunks");
  static constexpr int kStepsPerChunk = kChunkCols / 16;
  static constexpr uint32_t kDescSwizzle = kSwizzle == 128 ? 1 : 2;
  static constexpr uint32_t kChunk64 = kTile * kSwizzle;  // a 64-row chunk
  static constexpr uint32_t kTile64 = kChunks * kChunk64;  // 64 x W bf16
};

// DK: the head dim of q and k; DV: of v and dO
template <int DK, int DV>
struct DqCfg {
  using QK = Swz<DK>;
  using V = Swz<DV>;
  static constexpr int kKStages = DK == 256 ? 2 : (DK == DV ? 4 : 3);
  static constexpr int kVStages = DK == 256 ? 1 : (DK == DV ? 4 : 3);
  static constexpr uint32_t kQChunk = kDqRows * QK::kSwizzle;
  static constexpr uint32_t kDOChunk = kDqRows * V::kSwizzle;
  static constexpr uint32_t kQBytes = QK::kChunks * kQChunk;   // 128 x DK
  static constexpr uint32_t kDOBytes = V::kChunks * kDOChunk;  // 128 x DV
  static constexpr uint32_t kDOOff = kQBytes;
  static constexpr uint32_t kKOff = kQBytes + kDOBytes;
  static constexpr uint32_t kVOff = kKOff + kKStages * QK::kTile64;
  static constexpr uint32_t kBarOff = kVOff + kVStages * V::kTile64;
  // barriers: Q and dO full; per K stage full, empty; per V stage full,
  // empty; plus 1 KB to align the base to the swizzle atom
  static constexpr uint32_t kSmem =
      kBarOff + 8 * (1 + 2 * kKStages + 2 * kVStages) + 1024;
  static_assert(kSmem <= 227 * 1024, "fits an SM's shared memory");
};

template <int DK, int DV>
struct KvCfg {
  using QK = Swz<DK>;
  using V = Swz<DV>;
  static constexpr int kStages = DK == 256 ? 2 : 4;
  static constexpr uint32_t kKOff = 0;
  static constexpr uint32_t kVOff = QK::kTile64;
  // stage s: Q (64 x DK), then dO (64 x DV)
  static constexpr uint32_t kStageBytes = QK::kTile64 + V::kTile64;
  static constexpr uint32_t kQOff = QK::kTile64 + V::kTile64;
  static constexpr uint32_t kPOff = kQOff + kStages * kStageBytes;
  static constexpr uint32_t kStatOff = kPOff + kTile * kTile * 4;
  static constexpr uint32_t kStatBytes = 2 * kTile * 4;  // lse2, delta
  static constexpr uint32_t kBarOff = kStatOff + kStages * kStatBytes;
  // barriers: K and V full; per stage full, empty
  static constexpr uint32_t kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= 227 * 1024, "fits an SM's shared memory");
  static constexpr uint32_t kStageTx = kStageBytes + kStatBytes;
};

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

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// acc (64 x 64, fp32) = A B^T over W: A the 64 rows at `a` of a tile whose
// column chunks lie `a_chunk` bytes apart, B the 64 rows at `b` (chunks
// `b_chunk` apart), both K-major in the swizzled layout of W-wide rows
template <int WD>
__device__ __forceinline__ void wgmma_abt(float (&acc)[32], uint32_t a,
                                          uint32_t a_chunk, uint32_t b,
                                          uint32_t b_chunk) {
  using W = Swz<WD>;
#pragma unroll
  for (int kk = 0; kk < WD / 16; ++kk) {
    const int c = kk / W::kStepsPerChunk;
    const uint32_t at = (kk % W::kStepsPerChunk) * 32;
    hopper::wgmma_ss_m64n64(
        acc,
        hopper::make_desc(a + c * a_chunk + at, 16, 8 * W::kSwizzle,
                          W::kDescSwizzle),
        hopper::make_desc(b + c * b_chunk + at, 16, 8 * W::kSwizzle,
                          W::kDescSwizzle),
        kk > 0);
  }
}

// acc (64 x N) += (hi + lo) B over 64 rows of k: A from registers (the
// 64 x 64 accumulator layout of S, split into bf16 hi and lo terms), B
// the 64 x N tile at `b` (64-row chunks), MN-major
template <int N>
__device__ __forceinline__ void wgmma_rs_split(float (&acc)[N / 2],
                                               const uint32_t (&hi)[16],
                                               const uint32_t (&lo)[16],
                                               uint32_t b) {
  using W = Swz<N>;
#pragma unroll
  for (int ks = 0; ks < kTile / 16; ++ks) {
    const uint64_t desc = hopper::make_desc(
        b + ks * 16 * W::kSwizzle, W::kChunk64, 8 * W::kSwizzle,
        W::kDescSwizzle);
    const uint32_t a_hi[4] = {hi[4 * ks], hi[4 * ks + 1], hi[4 * ks + 2],
                              hi[4 * ks + 3]};
    const uint32_t a_lo[4] = {lo[4 * ks], lo[4 * ks + 1], lo[4 * ks + 2],
                              lo[4 * ks + 3]};
    hopper::WgmmaRS<N>::run(acc, a_hi, desc);
    hopper::WgmmaRS<N>::run(acc, a_lo, desc);
  }
}

// Accumulator element j of lane `lane` (m64nN layout): row 16 warp +
// lane / 4 + 8 ((j >> 1) & 1), column 8 (j >> 2) + 2 (lane & 3) + (j & 1).
__device__ __forceinline__ int acc_col(int j, int lane) {
  return 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
}

// ---- pass 1: dQ, and the padded row statistics for pass 2

template <int DK, int DV>
__global__ void __launch_bounds__(kThreadsWg, 1)
dq_wgmma(const __grid_constant__ CUtensorMap q_map,
         const __grid_constant__ CUtensorMap do_map,
         const __grid_constant__ CUtensorMap k_map,
         const __grid_constant__ CUtensorMap v_map,
         const float* __restrict__ lse, float* __restrict__ lse2_pad,
         float* __restrict__ delta_pad, __nv_bfloat16* __restrict__ dq,
         int Hq, int Hkv, int Lq, int Lk, int Lq_pad, int causal,
         float scale) {
  using C = DqCfg<DK, DV>;
  using QK = typename C::QK;
  using V = typename C::V;
  constexpr int SK = C::kKStages, SV = C::kVStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::smem_u32(aligned_smem(smem_raw));
  const uint32_t q_s = base, do_s = base + C::kDOOff;
  const uint32_t k_s = base + C::kKOff, v_s = base + C::kVOff;
  const uint32_t qd_full = base + C::kBarOff;
  auto k_full = [&](int s) { return qd_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return qd_full + 8 * (1 + SK + s); };
  auto v_full = [&](int s) { return qd_full + 8 * (1 + 2 * SK + s); };
  auto v_empty = [&](int s) { return qd_full + 8 * (1 + 2 * SK + SV + s); };

  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kDqRows;
  const int bh = blockIdx.x;  // b * Hq + h
  const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int off = Lk - Lq;  // q row r sits at key position r + off
  int n_kt = (Lk + kTile - 1) / kTile;
  if (causal)
    n_kt = min(n_kt, (min(q0 + kDqRows, Lq) - 1 + off) / kTile + 1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < SK; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(k_empty(s), kConsumerWarps);
    }
    for (int s = 0; s < SV; ++s) {
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(v_empty(s), kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    // ---- producer: Q and dO once, then K and V twice (one sweep each)
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * kWgThreads) {
      hopper::mbar_expect_tx(qd_full, C::kQBytes + C::kDOBytes);
#pragma unroll
      for (int c = 0; c < QK::kChunks; ++c)
        hopper::tma_load_3d(q_s + c * C::kQChunk, &q_map, qd_full,
                            c * QK::kChunkCols, q0, bh);
#pragma unroll
      for (int c = 0; c < V::kChunks; ++c)
        hopper::tma_load_3d(do_s + c * C::kDOChunk, &do_map, qd_full,
                            c * V::kChunkCols, q0, bh);
      for (int t = 0; t < 2 * n_kt; ++t) {
        const int k0 = (t < n_kt ? t : t - n_kt) * kTile;
        const int sk = t % SK, sv = t % SV;
        hopper::mbar_wait(k_empty(sk), ((t / SK) & 1) ^ 1);
        hopper::mbar_expect_tx(k_full(sk), QK::kTile64);
#pragma unroll
        for (int c = 0; c < QK::kChunks; ++c)
          hopper::tma_load_3d(k_s + sk * QK::kTile64 + c * QK::kChunk64,
                              &k_map, k_full(sk), c * QK::kChunkCols, k0,
                              bhk);
        hopper::mbar_wait(v_empty(sv), ((t / SV) & 1) ^ 1);
        hopper::mbar_expect_tx(v_full(sv), V::kTile64);
#pragma unroll
        for (int c = 0; c < V::kChunks; ++c)
          hopper::tma_load_3d(v_s + sv * V::kTile64 + c * V::kChunk64,
                              &v_map, v_full(sv), c * V::kChunkCols, k0,
                              bhk);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg ...
  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int wg_first = q0 + wg * kTile;
  const int row0 = wg_first + warp * 16 + lane / 4;  // and row0 + 8
  const uint32_t q_wg = q_s + wg * kTile * QK::kSwizzle;
  const uint32_t do_wg = do_s + wg * kTile * V::kSwizzle;
  const float scale_log2 = scale * kLog2e;
  // key tiles this warpgroup reads: none past its last row (causal) and
  // none at all when its rows all lie past Lq
  int wg_kt = wg_first < Lq ? n_kt : 0;
  if (causal && wg_first < Lq)
    wg_kt = min(wg_kt, (min(wg_first + kTile, Lq) - 1 + off) / kTile + 1);
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    lse2[i] = r < Lq ? lse[size_t(bh) * Lq + r] * kLog2e : 0.f;
  }

  // P in place of S (element j: row row0 + 8 ((j >> 1) & 1), key k0 +
  // acc_col(j)), 0 past Lk and the diagonal
  auto probs = [&](float (&s)[32], int k0) {
    const bool masked =
        k0 + kTile > Lk || (causal && k0 + kTile - 1 > wg_first + off);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      float p = exp2f(s[j] * scale_log2 - lse2[i]);
      if (masked) {
        const int key = k0 + acc_col(j, lane);
        if (key >= Lk || (causal && key > row0 + 8 * i + off)) p = 0.f;
      }
      s[j] = p;
    }
  };
  // the stages of sweep step t wait to land; a tile this warpgroup skips
  // still waits for both before releasing them, or its arrivals would
  // complete a stage's previous phase while the other warpgroup reads it
  auto skip = [&](int t) {
    hopper::mbar_wait(k_full(t % SK), (t / SK) & 1);
    hopper::mbar_wait(v_full(t % SV), (t / SV) & 1);
    __syncwarp();
    if (lane == 0) {
      hopper::mbar_arrive(k_empty(t % SK));
      hopper::mbar_arrive(v_empty(t % SV));
    }
  };
  // S = Q K^T and dP = dO V^T of sweep step t
  auto products = [&](float (&s)[32], float (&dp)[32], int t) {
    const int sk = t % SK, sv = t % SV;
    hopper::mbar_wait(k_full(sk), (t / SK) & 1);
    hopper::wgmma_fence();
    wgmma_abt<DK>(s, q_wg, C::kQChunk, k_s + sk * QK::kTile64,
                  QK::kChunk64);
    hopper::mbar_wait(v_full(sv), (t / SV) & 1);
    wgmma_abt<DV>(dp, do_wg, C::kDOChunk, v_s + sv * V::kTile64,
                  V::kChunk64);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    hopper::fence_operands(dp);
  };

  hopper::mbar_wait(qd_full, 0);

  // sweep 1: D = rowsum(P o dP) over every key
  float dsum[2] = {0.f, 0.f};
  for (int t = 0; t < n_kt; ++t) {
    if (t >= wg_kt) {
      skip(t);
      continue;
    }
    float s[32], dp[32];
    products(s, dp, t);
    __syncwarp();
    if (lane == 0) {
      hopper::mbar_arrive(k_empty(t % SK));
      hopper::mbar_arrive(v_empty(t % SV));
    }
    probs(s, t * kTile);
#pragma unroll
    for (int j = 0; j < 32; ++j) dsum[(j >> 1) & 1] += s[j] * dp[j];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 1);
    dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 2);
    const int r = row0 + 8 * i;
    if ((lane & 3) == 0 && r < Lq_pad) {
      const size_t at = size_t(bh) * Lq_pad + r;
      lse2_pad[at] = r < Lq ? lse2[i] : INFINITY;
      delta_pad[at] = r < Lq ? dsum[i] : 0.f;
    }
  }

  // sweep 2: dS = P (dP - D) scale, dQ += dS K
  float acc[DK / 2];
#pragma unroll
  for (int j = 0; j < DK / 2; ++j) acc[j] = 0.f;
  for (int t = 0; t < n_kt; ++t) {
    const int u = n_kt + t;
    if (t >= wg_kt) {
      skip(u);
      continue;
    }
    float s[32], dp[32];
    products(s, dp, u);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(v_empty(u % SV));
    probs(s, t * kTile);
    uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const float d0 = dsum[(j >> 1) & 1];
      split2(s[j] * (dp[j] - d0) * scale, s[j + 1] * (dp[j + 1] - d0) * scale,
             ds_hi[j / 2], ds_lo[j / 2]);
    }
    hopper::wgmma_fence();
    wgmma_rs_split<DK>(acc, ds_hi, ds_lo, k_s + (u % SK) * QK::kTile64);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(k_empty(u % SK));
  }

  __nv_bfloat16* ob = dq + size_t(bh) * Lq * DK;
#pragma unroll
  for (int j = 0; j < DK / 2; j += 2) {
    const int r = row0 + 8 * ((j >> 1) & 1);
    if (r < Lq)
      *reinterpret_cast<uint32_t*>(ob + size_t(r) * DK + acc_col(j, lane)) =
          pack2(acc[j], acc[j + 1]);
  }
}

// ---- pass 2: dK and dV, a block per (key tile, b * Hkv + kv head, head
// split), blockIdx.x = (key tile * B Hkv + b Hkv + kv head) * splits + split

template <int DK, int DV>
__global__ void __launch_bounds__(kThreadsWg, 1)
dkdv_wgmma(const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map,
           const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap do_map,
           const float* __restrict__ lse2_pad,
           const float* __restrict__ delta_pad,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           float* __restrict__ partial, int Hq, int Hkv, int BHkv, int Lq,
           int Lk, int Lq_pad, int Lk_pad, int splits, int causal,
           float scale) {
  using C = KvCfg<DK, DV>;
  using QK = typename C::QK;
  using V = typename C::V;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t k_s = base + C::kKOff, v_s = base + C::kVOff;
  auto q_st = [&](int s) { return base + C::kQOff + s * C::kStageBytes; };
  auto do_st = [&](int s) { return q_st(s) + QK::kTile64; };
  const uint32_t kv_full = base + C::kBarOff;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + S + s); };

  const int split = blockIdx.x % splits;
  const int rest = blockIdx.x / splits;
  const int bhk = rest % BHkv;
  const int k0 = (rest / BHkv) * kTile;
  const int b = bhk / Hkv, hk = bhk % Hkv, group = Hq / Hkv;
  const int heads = group / splits;
  const int h_first = hk * group + split * heads;  // this block's heads
  const int off = Lk - Lq;
  const int n_qt = (Lq + kTile - 1) / kTile;
  // causal: rows r with r + off >= k0 see this key tile
  const int qt_first = causal ? max(0, k0 - off) / kTile : 0;
  const int per_head = n_qt - qt_first;
  const int n_items = heads * per_head;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    // ---- producer: K and V once, then Q, dO and their rows' statistics
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * kWgThreads) {
      hopper::mbar_expect_tx(kv_full, QK::kTile64 + V::kTile64);
#pragma unroll
      for (int c = 0; c < QK::kChunks; ++c)
        hopper::tma_load_3d(k_s + c * QK::kChunk64, &k_map, kv_full,
                            c * QK::kChunkCols, k0, bhk);
#pragma unroll
      for (int c = 0; c < V::kChunks; ++c)
        hopper::tma_load_3d(v_s + c * V::kChunk64, &v_map, kv_full,
                            c * V::kChunkCols, k0, bhk);
      for (int i = 0; i < n_items; ++i) {
        const int s = i % S;
        const int bh = b * Hq + h_first + i / per_head;
        const int q0 = (qt_first + i % per_head) * kTile;
        hopper::mbar_wait(empty(s), ((i / S) & 1) ^ 1);
        hopper::mbar_expect_tx(full(s), C::kStageTx);
#pragma unroll
        for (int c = 0; c < QK::kChunks; ++c)
          hopper::tma_load_3d(q_st(s) + c * QK::kChunk64, &q_map, full(s),
                              c * QK::kChunkCols, q0, bh);
#pragma unroll
        for (int c = 0; c < V::kChunks; ++c)
          hopper::tma_load_3d(do_st(s) + c * V::kChunk64, &do_map, full(s),
                              c * V::kChunkCols, q0, bh);
        const uint32_t stat = base + C::kStatOff + s * C::kStatBytes;
        const size_t row = size_t(bh) * Lq_pad + q0;
        hopper::bulk_load(stat, lse2_pad + row, kTile * 4, full(s));
        hopper::bulk_load(stat + kTile * 4, delta_pad + row, kTile * 4,
                          full(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup 0 forms P^T and owns dV (DV wide),
  // warpgroup 1 forms dP^T and dS^T and owns dK (DK wide); both over keys
  // k0 ... k0 + 63 as rows
  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int key0 = k0 + warp * 16 + lane / 4;  // and key0 + 8
  const float scale_log2 = scale * kLog2e;
  float4* pbuf = reinterpret_cast<float4*>(smem + C::kPOff);

  // one warpgroup's whole walk: ROLE 0 (P^T, dV) or 1 (dS^T, dK), its
  // accumulator N wide
  auto consume = [&](auto role, auto width) {
    constexpr int ROLE = decltype(role)::value;
    constexpr int N = decltype(width)::value;
    float acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int i = 0; i < n_items; ++i) {
      const int s = i % S;
      const int q0 = (qt_first + i % per_head) * kTile;
      const float* stat = reinterpret_cast<const float*>(
          smem + C::kStatOff + s * C::kStatBytes);
      hopper::mbar_wait(full(s), (i / S) & 1);
      float x[32];
      hopper::wgmma_fence();
      if constexpr (ROLE == 0)  // S^T = K Q^T
        wgmma_abt<DK>(x, k_s, QK::kChunk64, q_st(s), QK::kChunk64);
      else                      // dP^T = V dO^T
        wgmma_abt<DV>(x, v_s, V::kChunk64, do_st(s), V::kChunk64);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(x);

      // element j: key key0 + 8 ((j >> 1) & 1), q row q0 + acc_col(j)
      uint32_t hi[16], lo[16];
      if constexpr (ROLE == 0) {
        const bool masked = causal && k0 + kTile - 1 > q0 + off;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = acc_col(j, lane);
          float p = exp2f(x[j] * scale_log2 - stat[col]);
          if (masked && key0 + 8 * ((j >> 1) & 1) > q0 + col + off) p = 0.f;
          x[j] = p;
        }
        if (i > 0) hopper::named_sync(kPEmpty, 2 * kWgThreads);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pbuf[j * kWgThreads + tid] =
              make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
        hopper::named_arrive(kPFull, 2 * kWgThreads);
#pragma unroll
        for (int j = 0; j < 32; j += 2)
          split2(x[j], x[j + 1], hi[j / 2], lo[j / 2]);
      } else {
        hopper::named_sync(kPFull, 2 * kWgThreads);
        float p[32];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 v4 = pbuf[j * kWgThreads + tid];
          p[4 * j] = v4.x;
          p[4 * j + 1] = v4.y;
          p[4 * j + 2] = v4.z;
          p[4 * j + 3] = v4.w;
        }
        if (i + 1 < n_items) hopper::named_arrive(kPEmpty, 2 * kWgThreads);
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int col = acc_col(j, lane);
          split2(p[j] * (x[j] - stat[kTile + col]) * scale,
                 p[j + 1] * (x[j + 1] - stat[kTile + col + 1]) * scale,
                 hi[j / 2], lo[j / 2]);
        }
      }
      // dV += P^T dO (role 0), dK += dS^T Q (role 1)
      hopper::wgmma_fence();
      wgmma_rs_split<N>(acc, hi, lo, ROLE == 0 ? do_st(s) : q_st(s));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    // rows key0, key0 + 8 of this warpgroup's tensor: bf16 into dK / dV,
    // or with a head split (DK = DV only) fp32 into its partial
#pragma unroll
    for (int j = 0; j < N / 2; j += 2) {
      const int key = key0 + 8 * ((j >> 1) & 1);
      if (key >= Lk) continue;
      const int col = acc_col(j, lane);
      if (splits == 1) {
        __nv_bfloat16* out = ROLE == 0 ? dv : dk;
        *reinterpret_cast<uint32_t*>(out + (size_t(bhk) * Lk + key) * N +
                                     col) = pack2(acc[j], acc[j + 1]);
      } else {
        // partial[which][split][bhk][key][col], which 0 = dK, 1 = dV
        const size_t at =
            ((size_t(1 - ROLE) * splits + split) * BHkv + bhk) * Lk_pad + key;
        *reinterpret_cast<float2*>(partial + at * N + col) =
            make_float2(acc[j], acc[j + 1]);
      }
    }
  };
  if (wg == 0)
    consume(std::integral_constant<int, 0>{},
            std::integral_constant<int, DV>{});
  else
    consume(std::integral_constant<int, 1>{},
            std::integral_constant<int, DK>{});
}

// dK and dV from the head splits' partials, summed in split order, four
// values a thread
__global__ void __launch_bounds__(256)
dkdv_reduce(const float* __restrict__ partial, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, int splits, int BHkv, int Lk,
            int Lk_pad, int D) {
  const size_t quads = size_t(BHkv) * Lk * D / 4;
  const size_t split_stride = size_t(BHkv) * Lk_pad * D;
  for (size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < quads; idx += size_t(gridDim.x) * blockDim.x) {
    const size_t e = idx * 4;
    const size_t row = e / D;  // bhk * Lk + key
    const size_t src = ((row / Lk) * Lk_pad + row % Lk) * D + e % D;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* p = partial + size_t(which) * splits * split_stride + src;
      float4 sum = *reinterpret_cast<const float4*>(p);
      for (int s = 1; s < splits; ++s) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(p + size_t(s) * split_stride);
        sum.x += v4.x;
        sum.y += v4.y;
        sum.z += v4.z;
        sum.w += v4.w;
      }
      uint2 out;
      out.x = pack2(sum.x, sum.y);
      out.y = pack2(sum.z, sum.w);
      *reinterpret_cast<uint2*>((which == 0 ? dk : dv) + e) = out;
    }
  }
}

// a map over (heads, L, W) bf16 rows, boxes of one swizzle chunk of W-wide
// rows and `rows` rows
template <int W>
bool make_map(CUtensorMap* map, const void* ptr, int L, int heads,
              int rows) {
  using S = Swz<W>;
  return hopper::make_map_bf16(map, ptr, W, L, heads, S::kChunkCols, rows,
                               S::kSwizzle);
}

template <int DK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* scratch,
                 void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                 int Lq, int Lk, int causal, float scale, int splits,
                 cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int group = Hq / Hkv;
  const int n_qt = (Lq + kDqRows - 1) / kDqRows;
  const int n_kt = (Lk + kTile - 1) / kTile;
  const int Lq_pad = (Lq + kTile - 1) / kTile * kTile;
  const int Lk_pad = n_kt * kTile;
  const long BHq = long(B) * Hq, BHkv = long(B) * Hkv;
  const long kv_blocks = long(n_kt) * BHkv * splits;
  // a head split's partials are D wide for dK and dV alike
  if (scratch == nullptr || splits < 1 || group % splits != 0 ||
      (splits > 1 && DK != DV) || n_qt > 65535 || BHq > 0x7fffffffL ||
      kv_blocks > 0x7fffffffL || BHq * Lq_pad > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  float* lse2_pad = scratch;
  float* delta_pad = scratch + BHq * Lq_pad;
  float* partial = delta_pad + BHq * Lq_pad;

  CUtensorMap q128, do128, q64, do64, k64, v64;
  if (!make_map<DK>(&q128, q, Lq, int(BHq), kDqRows) ||
      !make_map<DV>(&do128, dout, Lq, int(BHq), kDqRows) ||
      !make_map<DK>(&q64, q, Lq, int(BHq), kTile) ||
      !make_map<DV>(&do64, dout, Lq, int(BHq), kTile) ||
      !make_map<DK>(&k64, k, Lk, int(BHkv), kTile) ||
      !make_map<DV>(&v64, v, Lk, int(BHkv), kTile))
    return static_cast<int>(cudaErrorInvalidValue);

  constexpr uint32_t dq_bytes = DqCfg<DK, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      dq_wgmma<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_wgmma<DK, DV><<<dim3(unsigned(BHq), n_qt), kThreadsWg, dq_bytes,
                     stream>>>(
      q128, do128, k64, v64, lse, lse2_pad, delta_pad, static_cast<bf*>(dq),
      Hq, Hkv, Lq, Lk, Lq_pad, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr uint32_t kv_bytes = KvCfg<DK, DV>::kSmem;
  err = cudaFuncSetAttribute(dkdv_wgmma<DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_wgmma<DK, DV><<<unsigned(kv_blocks), kThreadsWg, kv_bytes, stream>>>(
      k64, v64, q64, do64, lse2_pad, delta_pad, static_cast<bf*>(dk),
      static_cast<bf*>(dv), partial, Hq, Hkv, int(BHkv), Lq, Lk, Lq_pad,
      Lk_pad, splits, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);

  const long quads = BHkv * Lk * DK / 4;
  const long wanted = (quads + 255) / 256;
  const int blocks = static_cast<int>(wanted < 4096 ? wanted : 4096);
  dkdv_reduce<<<blocks, 256, 0, stream>>>(partial, static_cast<bf*>(dk),
                                          static_cast<bf*>(dv), splits,
                                          int(BHkv), Lk, Lk_pad, DK);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lk,
           int causal, float scale, cudaStream_t stream) {
  using C = Tiles<DK, DV>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const int n_qt = (Lq + C::kBQ - 1) / C::kBQ;
  const int n_kt = (Lk + C::kBK - 1) / C::kBK;
  if (long(B) * Hq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = static_cast<int>(C::kSmem);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, DK, DV><<<dim3(n_qt, B * Hq), kThreads, bytes, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), Hq, Hkv, Lq, Lk,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(dkdv_kernel<T, DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, DK, DV><<<dim3(n_kt, B * Hkv), kThreads, bytes, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hkv, Lq, Lk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}


template <int DK, int DV>
int dispatch(const void* q, const void* k, const void* v,
             const void* dout, const float* lse, float* delta,
             float* scratch, void* dq, void* dk, void* dv, int B, int Hq,
             int Hkv, int Lq, int Lk, int causal, float scale,
             int head_splits, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    if (delta == nullptr || head_splits != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<float, DK, DV>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hkv, Lq, Lk, causal, scale, stream);
  }
  return launch_wgmma<DK, DV>(q, k, v, dout, lse, scratch, dq, dk, dv, B,
                              Hq, Hkv, Lq, Lk, causal, scale, head_splits,
                              stream);
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, float* scratch, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Lq, int Lk, int D, int Dv,
    int causal, float scale, int head_splits, int dtype,
    cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0 ||
      (causal && Lq > Lk) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(scratch) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  if (ptrs & 15) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_BWD_CASE(DK, DV)                                               \
  if (D == DK && Dv == DV)                                                   \
    return dispatch<DK, DV>(q, k, v, dout, lse, delta, scratch, dq, dk, dv, \
                            B, Hq, Hkv, Lq, Lk, causal, scale, head_splits,  \
                            dtype, stream);
  REPRO_BWD_CASE(32, 32)
  REPRO_BWD_CASE(64, 64)
  REPRO_BWD_CASE(128, 128)
  REPRO_BWD_CASE(256, 256)
  REPRO_BWD_CASE(192, 128)
#undef REPRO_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
