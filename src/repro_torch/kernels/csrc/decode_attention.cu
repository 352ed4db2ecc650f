// Flash-decoding: one-token GQA attention over a KV cache, for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention_pallas.
// q (B, Hq, D); k and v caches (B, Hkv, L, D), head-major and contiguous,
// one type (fp32 or bf16); kv_len (B,) int32 valid lengths (each >= 1).
// Query head h reads kv head h / G with G = Hq / Hkv <= 8.
//
// Bound: bytes.  Every valid cache row is read once (2 * kv_len * D
// elements per kv head) against 4 * G * D flops per row.  The TPU kernel
// walks L in sequence inside one program per (batch, kv head); on the
// H100 that would be B * Hkv blocks (4 for gemma-2b at batch 4) on 132
// SMs, so L is split across blocks instead (split-K):
//   * pass 1, grid (ceil(L / 64), Hkv, B), 128 threads: each block takes
//     64 keys of one (batch, kv head); each warp walks 16 of them, lanes
//     across D (D / 32 elements each, one coalesced row read per key),
//     and keeps the whole query group's running max, sum and output in
//     registers (online softmax in fp32); the four warps merge through
//     shared memory into one partial (m, l, o) per query head, written to
//     a fp32 scratch;
//   * pass 2, grid (Hq, B), D threads: merges the valid splits' partials
//     and normalises.  Blocks wholly past kv_len return at once.
//
// C interface (ctypes): decode_attention_launch(q, k, v, kv_len, out,
// part_o, part_ml, B, Hq, Hkv, L, D, scale, dtype, stream); dtype 0 =
// float32, 1 = bfloat16; D in {32, 64, 128, 256}; part_o holds
// B * Hkv * ceil(L / 64) * G * D floats and part_ml twice B * Hkv *
// ceil(L / 64) * G.  Returns cudaGetLastError() after the second launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 64;   // keys per block
constexpr int kWarps = 4;    // 16 keys per warp
constexpr int kMaxGroup = 8;

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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int* __restrict__ kv_len,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int Hkv, int G, int L, float scale) {
  constexpr int E = D / 32;  // elements of a row per lane
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int len = kv_len[b];
  const int key0 = split * kChunk;
  if (key0 >= len) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the query group, scaled, in registers: qv[g][e] is q[g, lane*E + e]
  const T* qb = q + (long(b) * Hkv + hk) * G * D;
  float qv[kMaxGroup][E];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qv[g][e] = g < G ? to_f32(qb[g * D + lane * E + e]) * scale : 0.f;

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][E];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const long head = (long(b) * Hkv + hk) * L;
  const int first = key0 + warp * (kChunk / kWarps);
  const int last = min(first + kChunk / kWarps, len);
  for (int key = first; key < last; ++key) {
    const T* kr = k + (head + key) * D + lane * E;
    const T* vr = v + (head + key) * D + lane * E;
    float kf[E], vf[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kf[e] = to_f32(kr[e]);
      vf[e] = to_f32(vr[e]);
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(qv[g][e], kf[e], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const float m_new = fmaxf(m[g], s);
      const float alpha = m[g] == -INFINITY ? 0.f : expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e] * alpha);
    }
  }

  // merge the warps: shared (m, l) per warp and group, then the outputs
  __shared__ float sm_m[kWarps][kMaxGroup], sm_l[kWarps][kMaxGroup];
  __shared__ float sm_o[kWarps][kMaxGroup][D];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) sm_o[warp][g][lane * E + e] = acc[g][e];
  __syncthreads();

  const long slot = (long(b) * Hkv + hk) * n_splits + split;
  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) {
    const int g = idx / D, d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = sm_m[w][g] == -INFINITY ? 0.f : expf(sm_m[w][g] - mx);
      o = fmaf(c, sm_o[w][g][d], o);
      lsum = fmaf(c, sm_l[w][g], lsum);
    }
    part_o[(slot * G + g) * D + d] = o;
    if (d == 0) {
      part_ml[(slot * G + g) * 2] = mx;
      part_ml[(slot * G + g) * 2 + 1] = lsum;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_o,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ kv_len, T* __restrict__ out,
                      int Hq, int Hkv, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = Hq / Hkv, hk = h / G, g = h - hk * G;
  const int valid = (kv_len[b] + kChunk - 1) / kChunk;
  const long base = (long(b) * Hkv + hk) * n_splits;
  float mx = -INFINITY;
  for (int s = 0; s < valid; ++s)
    mx = fmaxf(mx, part_ml[((base + s) * G + g) * 2]);
  float o = 0.f, lsum = 0.f;
  for (int s = 0; s < valid; ++s) {
    const long slot = (base + s) * G + g;
    const float c = expf(part_ml[slot * 2] - mx);
    o = fmaf(c, part_o[slot * D + d], o);
    lsum = fmaf(c, part_ml[slot * 2 + 1], lsum);
  }
  out[(long(b) * Hq + h) * D + d] = from_f32<T>(o / fmaxf(lsum, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* part_o, float* part_ml, int B, int Hq,
           int Hkv, int L, float scale, cudaStream_t stream) {
  const int n_splits = (L + kChunk - 1) / kChunk;
  const int G = Hq / Hkv;
  decode_split_kernel<T, D><<<dim3(n_splits, Hkv, B), kWarps * 32, 0,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, part_o, part_ml, Hkv, G, L, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T, D><<<dim3(Hq, B), D, 0, stream>>>(
      part_o, part_ml, kv_len, static_cast<T*>(out), Hq, Hkv, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v,
               const int* kv_len, void* out, float* part_o, float* part_ml,
               int B, int Hq, int Hkv, int L, int D, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, kv_len, out, part_o, part_ml, B, Hq,
                           Hkv, L, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_len, out, part_o, part_ml, B, Hq,
                           Hkv, L, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_len, out, part_o, part_ml, B, Hq,
                            Hkv, L, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, kv_len, out, part_o, part_ml, B, Hq,
                            Hkv, L, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* out, void* part_o,
                                       void* part_ml, int B, int Hq,
                                       int Hkv, int L, int D, float scale,
                                       int dtype, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || L <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > kMaxGroup || B > 65535 || Hkv > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* lens = static_cast<const int*>(kv_len);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, lens, out, po, pml, B, Hq, Hkv, L, D,
                             scale, stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, lens, out, po, pml, B, Hq,
                                     Hkv, L, D, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
