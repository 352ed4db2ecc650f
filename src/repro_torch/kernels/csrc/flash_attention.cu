// FlashAttention-2 style forward attention with GQA, for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas.
// q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), all contiguous, one type
// (fp32 or bf16); query head h reads kv head h / (Hq / Hkv).  Causal rows
// are the last Lq positions of the Lk-long sequence, as in the TPU
// kernel.  Online softmax in fp32; the (Lq x Lk) logits never reach
// device memory.
//
// Bound: operations (about 4*D flops per query-key pair against 2*D*2
// bytes per key row).  Design, simple and right first:
//   * one block of 256 threads per (q tile of 64 rows, q head, batch);
//   * K and V tiles of 64 keys staged through shared memory in fp32,
//     Q and K transposed (d-major, one float of padding per row) so every
//     thread's reads of a 4 x 4 register tile of logits are free of bank
//     conflicts;
//   * CUDA-core FMAs: each thread owns 4 query rows (ty + 16 i) and 4 key
//     columns (tx + 16 j) of the logit tile, and 4 rows x D/16 columns
//     (tx + 16 c) of the output accumulator, kept in registers;
//   * row max and row sum are reduced across the 16 lanes that share a
//     row with shuffles;
//   * ragged Lq and Lk are masked at the tails (no divisibility needed),
//     and under the causal mask the key tiles past the q tile's last row
//     are skipped (the TPU kernel computes and masks them).
// Shared memory: (2 * D * 65 + 64 * D + 64 * 65) floats, 215 KB at
// D = 256, so one block per SM there.  Tensor-core MMA is later work.
//
// C interface (ctypes): flash_attention_launch(q, k, v, out, B, Hq, Hkv,
// Lq, Lk, D, causal, scale, dtype, stream) with dtype 0 = float32,
// 1 = bfloat16 and D in {32, 64, 128, 256}.  Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPad = kBK + 1;  // row length of the transposed tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(2) * D * kPad + size_t(kBK) * D + size_t(kBQ) * kPad);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
             int Lq, int Lk, int causal, float scale) {
  constexpr int C = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                 // [D][kPad]: Qt[d][row]
  float* Kt = Qt + D * kPad;        // [D][kPad]: Kt[d][key]
  float* Vs = Kt + D * kPad;        // [kBK][D]
  float* Ps = Vs + kBK * D;         // [kBQ][kPad]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + ((long(b) * Hq + h) * Lq) * D;
  const T* kb = k + ((long(b) * Hkv + hk) * Lk) * D;
  const T* vb = v + ((long(b) * Hkv + hk) * Lk) * D;
  const int offset = Lk - Lq;  // q row r sits at key position r + offset

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qr = q0 + r;
    Qt[d * kPad + r] = qr < Lq ? to_f32(qb[long(qr) * D + d]) * scale : 0.f;
  }

  float acc[4][C];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Lk + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, Lq) - 1;
    n_tiles = min(n_tiles, (last_row + offset) / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's Kt, Vs and Ps are consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const int kr = k0 + r;
      const bool in = kr < Lk;
      Kt[d * kPad + r] = in ? to_f32(kb[long(kr) * D + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[long(kr) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[d * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + offset;
      float row_max = -INFINITY;
      bool valid[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < Lk && (!causal || kpos <= qpos);
        if (valid[j]) row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m_i[i], row_max);
      const float alpha =
          m_i[i] == -INFINITY ? 0.f : expf(m_i[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        row_sum += p;
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l_i[i] = l_i[i] * alpha + row_sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPad + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = out + ((long(b) * Hq + h) * Lq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Lq) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      ob[long(qr) * D + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Lq, int Lk, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, Hq, B), block(kThreads);
  flash_kernel<T, D><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Lq, Lk,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               int B, int Hq, int Hkv, int Lq, int Lk, int D, int causal,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Hq, Hkv, Lq, Lk, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Lq, Lk, causal, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Lq, Lk, causal,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Hq, Hkv, Lq, Lk, causal,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Hq, int Hkv, int Lq, int Lk,
                                      int D, int causal, float scale,
                                      int dtype, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0 ||
      (causal && Lq > Lk) || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, B, Hq, Hkv, Lq, Lk, D, causal,
                             scale, stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Lq, Lk, D,
                                     causal, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
