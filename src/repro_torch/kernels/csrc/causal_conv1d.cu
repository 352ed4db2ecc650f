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
// the states): 2 * B*T*D values, 0.481 ms at (4, 6144, 16384) bf16 on an
// H100.  The plain version rounds every product and sum to the input type
// one by one; done in fp32 that is nine float -> bf16 -> float round trips
// an output (3.6 G conversions at that shape), and conversions issue at a
// fraction of the FMA rate, so a design rounding in fp32 spends most of
// its time on them.  SiLU's expf and IEEE division add ~20 instructions an
// output.
//
// Design.  A thread owns 16 bytes of channels (8 bf16 or 4 fp32) of one
// batch row over a tile of kTile steps: it keeps the three inputs before
// its current step in registers, reads kAhead rows of x at a time, all
// issued before any is used (a 16-byte load each, neighbouring threads on
// neighbouring channels, so a warp reads 512 contiguous bytes a row), and
// writes out the same way; the three rows before its tile are read again
// by it (3 / kTile more bytes).  bf16 runs on packed pairs: each product
// and sum is one mul.rn.bf16x2 / add.rn.bf16x2, two channels an
// instruction and one rounding each, which is the plain version's rounding
// (a product of two bf16 values is exact in fp32, and so is their sum
// unless their exponents lie more than 16 apart, when the smaller lies
// below half an ulp of the larger and both roundings return the larger);
// the explicit .rn keeps ptxas from contracting them into FMAs.  fp32
// rounds each product and sum with __fmul_rn / __fadd_rn.  SiLU is x / (1
// + expf(-x)) in fp32, rounded once, as torch's.  So the output equals the
// plain version's.  The threads of the first tile write the new state,
// after reading its rows, so state_in may equal state_out.
//
// C interface (ctypes): causal_conv1d_launch(x, w, b, state_in, out,
// state_out, B, T, D, x_batch_stride, x_row_stride, dtype, stream); dtype
// 0 = float32, 1 = bfloat16; state_in may be null (zeros).  D and the
// strides must be multiples of 16 bytes' values, every pointer 16-byte
// aligned.  Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 4;       // d_conv
constexpr int kTile = 64;      // steps a thread
constexpr int kAhead = 8;      // rows of x a thread has in flight
constexpr int kThreads = 128;  // threads a block

// 16 bytes of T as four 32-bit words
struct Row {
  uint32_t w[4];
};

__device__ __forceinline__ Row load16(const void* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  return Row{{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ void store16(void* p, const Row& v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
}

// F.silu in fp32, as torch computes it
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// one output row of 16 bytes from the window xp[t .. t+3] (p0 .. p3), the
// taps w[0..3] and the bias, all 16-byte rows of T
__device__ __forceinline__ Row conv_row(const Row (&w)[kTaps],
                                        const Row& bias, const Row& p0,
                                        const Row& p1, const Row& p2,
                                        const Row& p3, __nv_bfloat16) {
  Row o;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t y = mul2(p0.w[k], w[0].w[k]);
    y = add2(y, mul2(p1.w[k], w[1].w[k]));
    y = add2(y, mul2(p2.w[k], w[2].w[k]));
    y = add2(y, mul2(p3.w[k], w[3].w[k]));
    y = add2(y, bias.w[k]);
    const __nv_bfloat162 r = __floats2bfloat162_rn(
        silu(__uint_as_float(y << 16)),
        silu(__uint_as_float(y & 0xffff0000u)));
    o.w[k] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return o;
}
__device__ __forceinline__ Row conv_row(const Row (&w)[kTaps],
                                        const Row& bias, const Row& p0,
                                        const Row& p1, const Row& p2,
                                        const Row& p3, float) {
  auto f = [](uint32_t v) { return __uint_as_float(v); };
  Row o;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float y = __fmul_rn(f(p0.w[k]), f(w[0].w[k]));
    y = __fadd_rn(y, __fmul_rn(f(p1.w[k]), f(w[1].w[k])));
    y = __fadd_rn(y, __fmul_rn(f(p2.w[k]), f(w[2].w[k])));
    y = __fadd_rn(y, __fmul_rn(f(p3.w[k]), f(w[3].w[k])));
    o.w[k] = __float_as_uint(silu(__fadd_rn(y, f(bias.w[k]))));
  }
  return o;
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
  const T tag = T();

  Row wv[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i)
    wv[i] = load16(w + static_cast<long long>(i) * D + c0);
  const Row bv = load16(bias + c0);

  // padded row p of xp: x's row p - 3, or the state's row p
  auto load_xp = [&](int p) {
    if (p >= kTaps - 1) return load16(xb + (p - (kTaps - 1)) * st);
    if (state_in != nullptr)
      return load16(state_in + (static_cast<long long>(b) * (kTaps - 1) + p)
                    * D + c0);
    return Row{{0u, 0u, 0u, 0u}};
  };

  Row win[kTaps - 1];   // xp[t .. t+2] before step t
#pragma unroll
  for (int j = 0; j < kTaps - 1; ++j) win[j] = load_xp(t0 + j);
  // the new state's rows, read before any is written
  Row keep[kTaps - 1];
  if (tile == 0) {
#pragma unroll
    for (int j = 0; j < kTaps - 1; ++j) keep[j] = load_xp(T_len + j);
  }

  T* ob = out + static_cast<long long>(b) * T_len * D + c0;
  for (int t = t0; t < t1; t += kAhead) {
    Row rows[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (t + u < t1) rows[u] = load16(xb + (t + u) * st);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t + u < t1) {
        store16(ob + static_cast<long long>(t + u) * D,
                conv_row(wv, bv, win[0], win[1], win[2], rows[u], tag));
        win[0] = win[1];
        win[1] = win[2];
        win[2] = rows[u];
      }
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
