// The backward of Mamba's causal conv (causal_conv1d.cu), for sm_90a.
//
// Replaces jax.grad of src/repro/models/mamba.py::_conv1d_causal, which no
// Pallas kernel covers.  With xp = [state; x], u the forward's
// pre-activation (in its own rounding) and g = dout * silu'(u),
// silu'(u) = s (1 + u (1 - s)), s = sigmoid(u):
//
//   dxp[p] = sum_i w_i g[p - i]  (0 <= p - i < T), plus dstate_out[p - T]
//            for p >= T;   dx = dxp[3 ..],  dstate = dxp[0 .. 2]
//   dw_i = sum_{b,t} xp[t + i] g[t],   db = sum_{b,t} g[t]
//
// x is read through its own strides (the x half of the input projection);
// dout, dx and the states are contiguous in x's type, dw (4, D) and db (D)
// fp32 (the wrapper casts them).
//
// Bound.  Bytes: x and dout read once, dx written once: 3 * B*T*D values,
// plus the tiles' partials (5 / kTile floats a value, written and read
// once): 0.241 ms at (4, 2048, 16384) bf16 on an H100.  Issue: the
// pre-activation again on packed pairs (4 instructions a value), the
// sigmoid by the approximate exponential and reciprocal (two MUFU
// operations), silu' and g, dx's four multiply-adds and dw's four, db's
// add, and the ring's copies and addresses: ~70 instructions a value in
// the machine code, ~0.28 ms on 128 lanes an SM, near the bytes' time, so
// both are held by keeping rows in flight and the loop lean.
//
// Design.  A thread owns 4 bytes of channels (a bf16 pair, or one fp32
// channel) of one batch row over a tile of kTile steps and walks it
// backwards, from 3 steps past the tile (their g feeds the tile's last dx
// rows) to its first step, holding xp[t .. t+3] as its type's words (and
// in fp32, for dw) and g[t .. t+3] in fp32.  Its rows of x and dout stream through a ring of
// kRing slots in shared memory by cp.async, kRing - 1 steps ahead of the
// one it works on, each thread reading back only its own slots (no
// barrier); neighbouring threads take neighbouring channels, so a warp
// reads 128 contiguous bytes of a row.  The pre-activation is recomputed
// as the forward computes it (bf16 on packed pairs, mul.rn.bf16x2 /
// add.rn.bf16x2 in the same order; fp32 by __fmul_rn / __fadd_rn), so u
// has the forward's bits.  In bf16 the sigmoid of silu' is approximate
// (an ulp or two of fp32, far inside bf16's gates) and dx's sum takes
// multiply-adds; fp32 keeps the plain version's expf, division and
// rounding op by op.  dx[t] sums w_0 g[t+3] + w_1 g[t+2] + w_2 g[t+1] +
// w_3 g[t] in that order, as the plain version's shifted adds do.  dw and
// db are summed over the tile's steps in registers and written as one
// fp32 partial of the 4 weight rows and the bias per (batch row, tile); a
// second kernel sums the B * ceil(T / kTile) partials of each channel in a
// fixed order (no atomics, the same bits every launch).  The first tile's
// threads write the state's gradient.
//
// C interface (ctypes): causal_conv1d_bwd_launch(x, w, b, state_in, dout,
// dstate_out, dx, dw, db, dstate, scratch, B, T, D, x_batch_stride,
// x_row_stride, dtype, stream); dtype 0 = float32, 1 = bfloat16;
// state_in and dstate_out may be null (zeros); scratch B * ceil(T / 128) *
// 5 * D floats.  Returns cudaGetLastError() after the launches.
// causal_conv1d_bwd_occupancy(dtype, out) gives the tile kernel's
// registers, blocks an SM, threads and shared bytes on the current device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 4;       // d_conv
constexpr int kTile = 128;     // steps a thread (causal_conv1d.BWD_TILE)
constexpr int kThreads = 128;  // threads a block
constexpr int kRing = 8;       // ring slots: rows in flight a thread + 1
constexpr int kParts = kTaps + 1;

// 4 bytes from global to shared memory, asynchronously; zeros where
// `bytes` is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but this thread's kRing - 1 latest groups landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

// 2^v and 1 / v by the MUFU, approximate, subnormals flushed to 0
__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float fast_rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// sigmoid(u) = 1 / (1 + 2^(-u log2(e))) by the MUFU in bf16, the plain
// version's expf and division in fp32
__device__ __forceinline__ float sigmoid(float u, __nv_bfloat16) {
  return fast_rcp(1.f + fast_exp2(u * -1.4426950408889634f));
}
__device__ __forceinline__ float sigmoid(float u, float) {
  return 1.f / (1.f + expf(-u));
}
// s + a b: a multiply-add in bf16, rounded op by op in fp32
__device__ __forceinline__ float madd(float a, float b, float s,
                                      __nv_bfloat16) {
  return fmaf(a, b, s);
}
__device__ __forceinline__ float madd(float a, float b, float s, float) {
  return __fadd_rn(s, __fmul_rn(a, b));
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

// a word's channels in fp32, and back (bf16: the lower address in the
// low half)
__device__ __forceinline__ void unpack(uint32_t w, float* v, __nv_bfloat16) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(uint32_t w, float* v, float) {
  v[0] = __uint_as_float(w);
}
__device__ __forceinline__ uint32_t pack(const float* v, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack(const float* v, float) {
  return __float_as_uint(v[0]);
}

// the forward's pre-activation of a word from the window xp[t .. t+3]
// (p0 .. p3), the taps and the bias: causal_conv1d.cu's conv_row before
// its SiLU, bit for bit
__device__ __forceinline__ uint32_t pre(const uint32_t (&w)[kTaps],
                                        uint32_t bias, uint32_t p0,
                                        uint32_t p1, uint32_t p2,
                                        uint32_t p3, __nv_bfloat16) {
  uint32_t y = mul2(p0, w[0]);
  y = add2(y, mul2(p1, w[1]));
  y = add2(y, mul2(p2, w[2]));
  y = add2(y, mul2(p3, w[3]));
  return add2(y, bias);
}
__device__ __forceinline__ uint32_t pre(const uint32_t (&w)[kTaps],
                                        uint32_t bias, uint32_t p0,
                                        uint32_t p1, uint32_t p2,
                                        uint32_t p3, float) {
  auto f = [](uint32_t v) { return __uint_as_float(v); };
  float y = __fmul_rn(f(p0), f(w[0]));
  y = __fadd_rn(y, __fmul_rn(f(p1), f(w[1])));
  y = __fadd_rn(y, __fmul_rn(f(p2), f(w[2])));
  y = __fadd_rn(y, __fmul_rn(f(p3), f(w[3])));
  return __float_as_uint(__fadd_rn(y, f(bias)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 6)
conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, const T* __restrict__ state_in,
                const T* __restrict__ dout,
                const T* __restrict__ dstate_out, T* __restrict__ dx,
                T* __restrict__ dstate, float* __restrict__ partial,
                int T_len, int D, long long sb, long long st) {
  constexpr int V = 4 / sizeof(T);   // channels a word
  __shared__ uint32_t ring[kRing][2][kThreads];   // x's word, dout's
  const int tid = threadIdx.x;
  const int c0 = (blockIdx.x * kThreads + tid) * V;
  if (c0 >= D) return;
  const int tile = blockIdx.y, b = blockIdx.z, tiles = gridDim.y;
  const int t0 = tile * kTile, t1 = min(t0 + kTile, T_len);
  const int hi = min(t1 + kTaps - 1, T_len) - 1;
  const T* xb = x + b * sb + c0;
  const long long row0 = static_cast<long long>(b) * T_len;
  const T tag = T();
  auto word = [](const T* p) { return *reinterpret_cast<const uint32_t*>(p); };

  uint32_t wv[kTaps];
  float wf[kTaps][V];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    wv[i] = word(w + static_cast<long long>(i) * D + c0);
    unpack(wv[i], wf[i], tag);
  }
  const uint32_t bv = word(bias + c0);

  // padded row p of xp: x's row p - 3, or the state's row p, or zeros
  auto xp_src = [&](int p, int& bytes) -> const T* {
    bytes = 4;
    if (p >= kTaps - 1) return xb + (p - (kTaps - 1)) * st;
    if (state_in != nullptr)
      return state_in + (static_cast<long long>(b) * (kTaps - 1) + p) * D
          + c0;
    bytes = 0;
    return xb;
  };
  // step t's rows of xp and dout into its ring slot (none before t0); one
  // group a step, empty or not
  auto issue = [&](int t) {
    if (t >= t0) {
      int bytes;
      const T* src = xp_src(t, bytes);
      cp_async4(&ring[t & (kRing - 1)][0][tid], src, bytes);
      cp_async4(&ring[t & (kRing - 1)][1][tid], dout + (row0 + t) * D + c0,
                4);
    }
    cp_async_commit();
  };

  // dstate_out's row p - T where padded row p is one of the new state's
  auto add_dnew = [&](int p, float* acc) {
    if (dstate_out == nullptr || p < T_len) return;
    float dn[V];
    unpack(word(dstate_out + (static_cast<long long>(b) * (kTaps - 1)
                              + (p - T_len)) * D + c0), dn, tag);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], dn[e]);
  };

#pragma unroll
  for (int k = 0; k < kRing - 1; ++k) issue(hi - k);
  uint32_t xw[kTaps];        // xp[t .. t+3]; [1 ..] before step t
  float xf[kTaps][V];        // the same in fp32
  float gw[kTaps][V];        // g[t .. t+3], 0 past T
#pragma unroll
  for (int i = 1; i < kTaps; ++i) {
    int bytes;
    const T* src = xp_src(hi + i, bytes);
    xw[i] = bytes ? word(src) : 0u;
    unpack(xw[i], xf[i], tag);
  }
#pragma unroll
  for (int i = 0; i < kTaps; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) gw[i][e] = 0.f;
  float acc_w[kTaps][V], acc_b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    acc_b[e] = 0.f;
#pragma unroll
    for (int i = 0; i < kTaps; ++i) acc_w[i][e] = 0.f;
  }

  // running pointers: the rows the ring's next copies read (padded row t
  // - (kRing - 1) of xp, and of dout) and dx's row t
  const T* xnext = xb + static_cast<long long>(hi - kRing - kTaps + 2) * st;
  const T* dnext = dout + (row0 + hi - (kRing - 1)) * D + c0;
  T* dxrow = dx + (row0 + hi) * D + c0;
#pragma unroll 4
  for (int t = hi; t >= t0; --t) {
    const int p = t - (kRing - 1);   // into the slot step t + 1 used
    if (p >= t0) {
      uint32_t* slot = &ring[p & (kRing - 1)][0][tid];
      if (p >= kTaps - 1) {
        cp_async4(slot, xnext, 4);
      } else {
        int bytes;
        const T* src = xp_src(p, bytes);
        cp_async4(slot, src, bytes);
      }
      cp_async4(slot + kThreads, dnext, 4);
    }
    cp_async_commit();
    xnext -= st;
    dnext -= D;
    cp_async_wait_ring();
    const int slot = t & (kRing - 1);
    xw[0] = ring[slot][0][tid];
    unpack(xw[0], xf[0], tag);
    float go[V], u[V];
    unpack(ring[slot][1][tid], go, tag);
    unpack(pre(wv, bv, xw[0], xw[1], xw[2], xw[3], tag), u, tag);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float s = sigmoid(u[e], tag);
#pragma unroll
      for (int i = kTaps - 1; i > 0; --i) gw[i][e] = gw[i - 1][e];
      gw[0][e] = go[e] * (s * (1.f + u[e] * (1.f - s)));
    }
    if (t < t1) {
      float d[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
#pragma unroll
        for (int i = 0; i < kTaps; ++i)
          acc_w[i][e] = fmaf(xf[i][e], gw[0][e], acc_w[i][e]);
        acc_b[e] += gw[0][e];
        // dxp[t + 3] = w0 g[t+3] + w1 g[t+2] + w2 g[t+1] + w3 g[t]
        float s = __fmul_rn(wf[0][e], gw[kTaps - 1][e]);
#pragma unroll
        for (int i = 1; i < kTaps; ++i)
          s = madd(wf[i][e], gw[kTaps - 1 - i][e], s, tag);
        d[e] = s;
      }
      add_dnew(t + kTaps - 1, d);
      *reinterpret_cast<uint32_t*>(dxrow) = pack(d, tag);
    }
    dxrow -= D;
#pragma unroll
    for (int i = kTaps - 1; i > 0; --i) {
      xw[i] = xw[i - 1];
#pragma unroll
      for (int e = 0; e < V; ++e) xf[i][e] = xf[i - 1][e];
    }
  }

  if (tile == 0) {
    // dxp[j] = sum_{i <= j} w_i g[j - i], j = 0 .. 2; gw holds g[0 .. 3]
#pragma unroll
    for (int j = 0; j < kTaps - 1; ++j) {
      float d[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float s = __fmul_rn(wf[0][e], gw[j][e]);
#pragma unroll
        for (int i = 1; i <= j; ++i) s = madd(wf[i][e], gw[j - i][e], s, tag);
        d[e] = s;
      }
      add_dnew(j, d);
      *reinterpret_cast<uint32_t*>(
          dstate + (static_cast<long long>(b) * (kTaps - 1) + j) * D + c0) =
          pack(d, tag);
    }
  }
  float* part = partial
      + (static_cast<long long>(b) * tiles + tile) * kParts * D + c0;
#pragma unroll
  for (int i = 0; i < kTaps; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) part[static_cast<long long>(i) * D + e] =
        acc_w[i][e];
#pragma unroll
  for (int e = 0; e < V; ++e)
    part[static_cast<long long>(kTaps) * D + e] = acc_b[e];
}

// dw and db: each channel's partials summed in (batch row, tile) order
__global__ void __launch_bounds__(256)
conv_bwd_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                float* __restrict__ db, int parts, int D) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  if (i >= static_cast<long long>(kParts) * D) return;
  float s = 0.f;
  for (int k = 0; k < parts; ++k)
    s += partial[static_cast<long long>(k) * kParts * D + i];
  if (i < static_cast<long long>(kTaps) * D)
    dw[i] = s;
  else
    db[i - static_cast<long long>(kTaps) * D] = s;
}

// the tile kernel's registers a thread, blocks an SM, threads a block
// and static shared bytes a block on the current device, into out[0 .. 3]
template <typename T>
int occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, conv_bwd_kernel<T>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], conv_bwd_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[2] = kThreads;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

template <typename T>
int launch(const void* x, const void* w, const void* bias,
           const void* state_in, const void* dout, const void* dstate_out,
           void* dx, float* dw, float* db, void* dstate, float* scratch,
           int B, int T_len, int D, long long sb, long long st,
           cudaStream_t stream) {
  constexpr int V = 4 / sizeof(T);
  if (D % V != 0 || sb % V != 0 || st % V != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (T_len + kTile - 1) / kTile;
  const dim3 grid((D / V + kThreads - 1) / kThreads, tiles, B);
  conv_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(state_in),
      static_cast<const T*>(dout), static_cast<const T*>(dstate_out),
      static_cast<T*>(dx), static_cast<T*>(dstate), scratch, T_len, D, sb,
      st);
  const long long outs = static_cast<long long>(kParts) * D;
  conv_bwd_reduce<<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                    stream>>>(scratch, dw, db, B * tiles, D);
  return 0;
}

}  // namespace

// registers a thread, blocks an SM, threads a block and shared bytes a
// block of the tile kernel for `dtype` (0 = float32, 1 = bfloat16) on the
// current device, into out[0 .. 3]; returns a CUDA error code
extern "C" int causal_conv1d_bwd_occupancy(int dtype, int* out) {
  if (dtype == 0) return occupancy<float>(out);
  if (dtype == 1) return occupancy<__nv_bfloat16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int causal_conv1d_bwd_launch(
    const void* x, const void* w, const void* bias, const void* state_in,
    const void* dout, const void* dstate_out, void* dx, void* dw, void* db,
    void* dstate, void* scratch, int B, int T_len, int D,
    int x_batch_stride, int x_row_stride, int dtype, cudaStream_t stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  float* sc = static_cast<float*>(scratch);
  int code;
  if (dtype == 0)
    code = launch<float>(x, w, bias, state_in, dout, dstate_out, dx, dwf,
                         dbf, dstate, sc, B, T_len, D, x_batch_stride,
                         x_row_stride, stream);
  else if (dtype == 1)
    code = launch<__nv_bfloat16>(x, w, bias, state_in, dout, dstate_out, dx,
                                 dwf, dbf, dstate, sc, B, T_len, D,
                                 x_batch_stride, x_row_stride, stream);
  else
    code = static_cast<int>(cudaErrorInvalidValue);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}
