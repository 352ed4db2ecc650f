// Mamba's depthwise causal conv over time, its bias and SiLU, for sm_90a.
//
// Replaces src/repro/models/mamba.py::_conv1d_causal, which no Pallas
// kernel covers: with xp = [state; x] (the K - 1 = 3 inputs before x, zeros
// without a state), per channel
//
//   out[t] = silu(((xp[t] w0 + xp[t+1] w1) + xp[t+2] w2) + xp[t+3] w3 + b)
//   new_state = xp[T .. T+2]
//
// x is (B, T, D) with a unit channel stride and row / batch strides of its
// own (the x half of the input projection, rows 2 * d_inner apart); w is
// (4, D), b (D), the states (B, 3, D), out (B, T, D), all one type.
//
// Bound.  Bytes: x read once and out written once (plus the weights and
// the states): 2 * B*T*D values.  The arithmetic is a few operations per
// value, far below the card's rate, so the kernel is bound by bytes; in
// plain PyTorch the same conv is four or more full passes over (B, T, D).
//
// Design.  A thread owns 16 bytes of channels (8 bf16 or 4 fp32) of one
// batch row over a tile of kTile steps: it keeps the three inputs before
// its current step in registers, reads each row of x once with one 16-byte
// load (neighbouring threads on neighbouring channels, so a warp reads 512
// contiguous bytes a row) and writes out the same way; the three rows
// before its tile are read again by it (3 / kTile more bytes).  Every
// product, sum and the bias are rounded to the input type one by one, as
// the plain version's torch ops are (__fmul_rn / __fadd_rn, so nvcc does not
// contract them into FMAs), and SiLU is x / (1 + expf(-x)) in fp32, rounded
// once, so the output equals the plain version's.  The threads of the first
// tile write the new state, after reading its rows, so state_in may equal
// state_out.
//
// C interface (ctypes): causal_conv1d_launch(x, w, b, state_in, out,
// state_out, B, T, D, x_batch_stride, x_row_stride, dtype, stream); dtype
// 0 = float32, 1 = bfloat16; state_in may be null (zeros).  D and the
// strides must be multiples of 16 bytes' values, every pointer 16-byte
// aligned.  Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 4;       // d_conv
constexpr int kTile = 64;      // steps a thread
constexpr int kThreads = 128;  // threads a block

__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes of T as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned*>(&h) = words[e];
    const float2 f = __bfloat1622float2(h);
    out[2 * e] = f.x; out[2 * e + 1] = f.y;
  }
}

// floats to 16 bytes of T (round to nearest even)
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  unsigned words[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    words[e] = *reinterpret_cast<unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2],
                                            words[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ bias, const T* state_in,
            T* __restrict__ out, T* state_out, int T_len, int D,
            long long sb, long long st) {
  constexpr int V = 16 / sizeof(T);
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= D) return;
  const int tile = blockIdx.y, b = blockIdx.z;
  const int t0 = tile * kTile, t1 = min(t0 + kTile, T_len);
  const T* xb = x + b * sb + c0;
  const T zero_tag = T();

  float wv[kTaps][V], bv[V];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) load16(w + static_cast<long long>(i) * D
                                         + c0, wv[i]);
  load16(bias + c0, bv);

  // padded row p of xp: x's row p - 3, or the state's row p
  auto load_xp = [&](int p, float* dst) {
    if (p >= kTaps - 1) {
      load16(xb + (p - (kTaps - 1)) * st, dst);
    } else if (state_in != nullptr) {
      load16(state_in + (static_cast<long long>(b) * (kTaps - 1) + p) * D
             + c0, dst);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = 0.f;
    }
  };

  float win[kTaps - 1][V];   // xp[t .. t+2] before step t
#pragma unroll
  for (int j = 0; j < kTaps - 1; ++j) load_xp(t0 + j, win[j]);
  // the new state's rows, read before any is written
  float keep[kTaps - 1][V];
  if (tile == 0) {
#pragma unroll
    for (int j = 0; j < kTaps - 1; ++j) load_xp(T_len + j, keep[j]);
  }

  T* ob = out + static_cast<long long>(b) * T_len * D + c0;
  for (int t = t0; t < t1; ++t) {
    float cur[V], o[V];
    load16(xb + t * st, cur);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float y = rnd(__fmul_rn(win[0][e], wv[0][e]), zero_tag);
      y = rnd(__fadd_rn(y, rnd(__fmul_rn(win[1][e], wv[1][e]), zero_tag)),
              zero_tag);
      y = rnd(__fadd_rn(y, rnd(__fmul_rn(win[2][e], wv[2][e]), zero_tag)),
              zero_tag);
      y = rnd(__fadd_rn(y, rnd(__fmul_rn(cur[e], wv[3][e]), zero_tag)),
              zero_tag);
      y = rnd(__fadd_rn(y, bv[e]), zero_tag);
      o[e] = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
    }
    store16(ob + static_cast<long long>(t) * D, o);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      win[0][e] = win[1][e];
      win[1][e] = win[2][e];
      win[2][e] = cur[e];
    }
  }
  if (tile == 0) {
#pragma unroll
    for (int j = 0; j < kTaps - 1; ++j)
      store16(state_out + (static_cast<long long>(b) * (kTaps - 1) + j) * D
              + c0, keep[j]);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias,
           const void* state_in, void* out, void* state_out, int B,
           int T_len, int D, long long sb, long long st,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (D % V != 0 || sb % V != 0 || st % V != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D / V + kThreads - 1) / kThreads,
                  (T_len + kTile - 1) / kTile, B);
  conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(state_in),
      static_cast<T*>(out), static_cast<T*>(state_out), T_len, D, sb, st);
  return 0;
}

}  // namespace

extern "C" int causal_conv1d_launch(const void* x, const void* w,
                                    const void* bias, const void* state_in,
                                    void* out, void* state_out, int B,
                                    int T_len, int D, int x_batch_stride,
                                    int x_row_stride, int dtype,
                                    cudaStream_t stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || B > 65535 ||
      (T_len + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int code;
  if (dtype == 0)
    code = launch<float>(x, w, bias, state_in, out, state_out, B, T_len, D,
                         x_batch_stride, x_row_stride, stream);
  else if (dtype == 1)
    code = launch<__nv_bfloat16>(x, w, bias, state_in, out, state_out, B,
                                 T_len, D, x_batch_stride, x_row_stride,
                                 stream);
  else
    code = static_cast<int>(cudaErrorInvalidValue);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}
