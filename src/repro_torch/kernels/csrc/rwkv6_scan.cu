// The RWKV6 "Finch" WKV recurrence over a whole sequence, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan_pallas
// (body _wkv_kernel).  Per (batch, head), with the (dh x dh) fp32 state S,
// bonus u and data-dependent decay w_t:
//
//   y_t[i] = sum_j r_t[j] * (S[j][i] + u[j] * k_t[j] * v_t[i])
//   S[j][i] = w_t[j] * S[j][i] + k_t[j] * v_t[i]
//
// r/k/v/w are (B, T, H, dh) and y the same; u is (H, dh) fp32; the state
// (B, H, dh, dh) is read at the start (zeros without one) and written at
// the end.
//
// Bound: bytes in fp32, operations in bf16.  Four input streams and y
// pass once through device memory (5 * B*T*H*dh values) plus the state
// in and out; the work is 5 flop per state element per step in fp32 on
// the CUDA cores (67 TFLOP/s on an H100 SXM), which at dh = 64 takes 0.8
// of the fp32 bytes' time and 1.6 of the bf16 bytes'.  But the recurrence
// is serial in T, so in practice the latency of one step times T bounds
// the kernel: at B*H = 128 heads a block per head fills at most 128 of
// the 132 SMs, with two warps each.
//
// Design: one block per (batch, head), one thread per value column i,
// holding S[:, i] (dh floats) in registers for the whole sequence.  The
// TPU kernel carries the state in VMEM across a sequential grid axis over
// T-chunks; here blocks run in no order, so the loop over T lives inside
// the block.  Steps are staged TS at a time into shared memory with
// cp.async, double-buffered, so the next TS steps load while these are
// computed.  The bonus term is a scalar per step, c_t = sum_j r_j u_j k_j,
// computed once per step for the block, so y_i = sum_j r_j S[j][i] +
// c_t v_i.  The state update rounds the product k_j v_i, the product
// w_j S, and their sum separately (__fmul_rn / __fadd_rn: nvcc would
// otherwise contract them into an FMA), as the plain PyTorch version's
// three ops do, so the final state is bit-equal to it; only y's sum runs
// in another order.
//
// C interface (ctypes): rwkv6_scan_launch(r, k, v, w, u, state_in,
// y, state_out, B, T, H, dh, dtype, stream); dtype 0 = float32,
// 1 = bfloat16 (r, k, v, w and y share it; u and the states are fp32);
// state_in may be null (zeros) and may equal state_out.  r/k/v/w must be
// 16-byte aligned; dh is 32 (the smoke configs) or 64 (rwkv6-1.6b).
// Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStageValues = 1024;  // TS * dh values of each stream staged

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
  return __float2bfloat16(x);  // round to nearest even
}

// four consecutive values from shared memory (8- or 16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const float* __restrict__ u, const float* state_in,
           T* __restrict__ y, float* state_out, int T_len, int H) {
  constexpr int TS = kStageValues / DH;          // steps per stage
  constexpr int kPerPiece = 16 / sizeof(T);      // values per 16 bytes
  constexpr int kPiecesPerRow = DH / kPerPiece;
  constexpr int kPieces = 4 * TS * kPiecesPerRow;
  __shared__ __align__(16) T stage[2][4][TS][DH];  // r, k, v, w
  __shared__ float c[TS];
  __shared__ float us[DH];

  const int i = threadIdx.x;
  const int bh = blockIdx.x;                     // b * H + h
  const int b = bh / H, h = bh - b * H;
  const T* streams[4] = {r, k, v, w};
  const long row_stride = static_cast<long>(H) * DH;   // one step
  const long base = (static_cast<long>(b) * T_len * H + h) * DH;

  auto stage_chunk = [&](int chunk, int buf) {
    const int t0 = chunk * TS;
    for (int p = i; p < kPieces; p += DH) {
      const int a = p / (TS * kPiecesPerRow);
      const int s = (p / kPiecesPerRow) % TS;
      const int q = p % kPiecesPerRow;
      if (t0 + s < T_len)
        cp_async16(&stage[buf][a][s][q * kPerPiece],
                   streams[a] + base + (t0 + s) * row_stride +
                       q * kPerPiece);
    }
    cp_async_commit();
  };

  const int n_chunks = (T_len + TS - 1) / TS;
  stage_chunk(0, 0);

  us[i] = u[h * DH + i];
  float S[DH];
#pragma unroll
  for (int j = 0; j < DH; ++j) S[j] = 0.f;
  if (state_in) {
    const float* s_in = state_in + static_cast<long>(bh) * DH * DH;
#pragma unroll
    for (int j = 0; j < DH; ++j) S[j] = s_in[j * DH + i];
  }

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < n_chunks) {
      stage_chunk(chunk + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = chunk * TS;
    const int steps = min(TS, T_len - t0);
    if (i < steps) {                // the bonus scalar of step t0 + i
      float acc = 0.f;
      for (int jj = 0; jj < DH; ++jj) {
        const int j = (jj + i) & (DH - 1);   // threads on distinct banks
        acc = fmaf(to_f32(stage[buf][0][i][j]) * us[j],
                   to_f32(stage[buf][1][i][j]), acc);
      }
      c[i] = acc;
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const T* rs = stage[buf][0][s];
      const T* ks = stage[buf][1][s];
      const T* ws = stage[buf][3][s];
      const float vi = to_f32(stage[buf][2][s][i]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < DH; j += 4) {
        float r4[4], k4[4], w4[4];
        load4(rs + j, r4);
        load4(ks + j, k4);
        load4(ws + j, w4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q] = fmaf(r4[q], S[j + q], acc[q]);
          S[j + q] = __fadd_rn(__fmul_rn(w4[q], S[j + q]),
                               __fmul_rn(k4[q], vi));
        }
      }
      const float out = (acc[0] + acc[1]) + (acc[2] + acc[3]) + c[s] * vi;
      y[base + (t0 + s) * row_stride + i] = from_f32<T>(out);
    }
    __syncthreads();                // this buffer is refilled next chunk
  }

  float* s_out = state_out + static_cast<long>(bh) * DH * DH;
#pragma unroll
  for (int j = 0; j < DH; ++j) s_out[j * DH + i] = S[j];
}

template <typename T, int DH>
void launch(const void* r, const void* k, const void* v, const void* w,
            const float* u, const float* s_in, void* y, float* s_out, int B,
            int T_len, int H, cudaStream_t stream) {
  wkv_kernel<T, DH><<<B * H, DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s_in,
      static_cast<T*>(y), s_out, T_len, H);
}

template <typename T>
int launch_dh(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* s_in, void* y, float* s_out,
              int B, int T_len, int H, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: launch<T, 32>(r, k, v, w, u, s_in, y, s_out, B, T_len, H,
                           stream); break;
    case 64: launch<T, 64>(r, k, v, w, u, s_in, y, s_out, B, T_len, H,
                           stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* state_in, void* y,
                                 void* state_out, int B, int T_len, int H,
                                 int dh, int dtype, cudaStream_t stream) {
  if (B <= 0 || T_len <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(state_in);
  float* so = static_cast<float*>(state_out);
  int err;
  if (dtype == 0)
    err = launch_dh<float>(r, k, v, w, uf, si, y, so, B, T_len, H, dh,
                           stream);
  else if (dtype == 1)
    err = launch_dh<__nv_bfloat16>(r, k, v, w, uf, si, y, so, B, T_len, H,
                                   dh, stream);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
