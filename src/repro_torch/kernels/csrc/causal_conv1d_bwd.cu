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
// once).  A few dozen fp32 operations a value (the pre-activation again,
// an expf, the four products of dx and of dw), below the card's rate:
// bound by bytes.
//
// Design.  A thread owns 16 bytes of channels of one batch row over a tile
// of kTile steps and walks it backwards, from 3 steps past the tile (their
// g feeds the tile's last dx rows) to its first step, holding xp[t .. t+3]
// and g[t .. t+3] in registers: each row of x and dout is read once by the
// tile, 16 bytes a thread, neighbouring threads on neighbouring channels.
// dx[t] sums w_0 g[t+3] + w_1 g[t+2] + w_2 g[t+1] + w_3 g[t] in that order,
// as the plain version's shifted adds do.  dw and db are summed over the
// tile's steps in registers and written as one fp32 partial of the 4
// weight rows and the bias per (batch row, tile); a second kernel sums the
// B * ceil(T / kTile) partials of each channel in a fixed order (no
// atomics, the same bits every launch).  The first tile's threads write
// the state's gradient.
//
// C interface (ctypes): causal_conv1d_bwd_launch(x, w, b, state_in, dout,
// dstate_out, dx, dw, db, dstate, scratch, B, T, D, x_batch_stride,
// x_row_stride, dtype, stream); dtype 0 = float32, 1 = bfloat16;
// state_in and dstate_out may be null (zeros); scratch B * ceil(T / 128) *
// 5 * D floats.  Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 4;       // d_conv
constexpr int kTile = 128;     // steps a thread (causal_conv1d.BWD_TILE)
constexpr int kThreads = 128;  // threads a block
constexpr int kParts = kTaps + 1;

__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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
conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, const T* __restrict__ state_in,
                const T* __restrict__ dout,
                const T* __restrict__ dstate_out, T* __restrict__ dx,
                T* __restrict__ dstate, float* __restrict__ partial,
                int T_len, int D, long long sb, long long st) {
  constexpr int V = 16 / sizeof(T);
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= D) return;
  const int tile = blockIdx.y, b = blockIdx.z, tiles = gridDim.y;
  const int t0 = tile * kTile, t1 = min(t0 + kTile, T_len);
  const int hi = min(t1 + kTaps - 1, T_len) - 1;
  const T* xb = x + b * sb + c0;
  const long long row0 = static_cast<long long>(b) * T_len;
  const T zero_tag = T();

  float wv[kTaps][V], bv[V];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) load16(w + static_cast<long long>(i) * D
                                         + c0, wv[i]);
  load16(bias + c0, bv);

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
  // dstate_out's row p - T where padded row p is one of the new state's
  auto add_dnew = [&](int p, float* acc) {
    if (dstate_out == nullptr || p < T_len) return;
    float dn[V];
    load16(dstate_out + (static_cast<long long>(b) * (kTaps - 1)
                         + (p - T_len)) * D + c0, dn);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], dn[e]);
  };

  float xw[kTaps][V];   // xp[t .. t+3]
  float gw[kTaps][V];   // g[t .. t+3], 0 past hi
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    load_xp(hi + i, xw[i]);
#pragma unroll
    for (int e = 0; e < V; ++e) gw[i][e] = 0.f;
  }
  float acc_w[kTaps][V], acc_b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    acc_b[e] = 0.f;
#pragma unroll
    for (int i = 0; i < kTaps; ++i) acc_w[i][e] = 0.f;
  }

  for (int t = hi; t >= t0; --t) {
    float go[V];
    load16(dout + (row0 + t) * D + c0, go);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float u = rnd(__fmul_rn(xw[0][e], wv[0][e]), zero_tag);
#pragma unroll
      for (int i = 1; i < kTaps; ++i)
        u = rnd(__fadd_rn(u, rnd(__fmul_rn(xw[i][e], wv[i][e]), zero_tag)),
                zero_tag);
      u = rnd(__fadd_rn(u, bv[e]), zero_tag);
      const float s = 1.f / (1.f + expf(-u));
#pragma unroll
      for (int i = kTaps - 1; i > 0; --i) gw[i][e] = gw[i - 1][e];
      gw[0][e] = go[e] * (s * (1.f + u * (1.f - s)));
    }
    if (t < t1) {
      float d[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc_b[e] += gw[0][e];
#pragma unroll
        for (int i = 0; i < kTaps; ++i) acc_w[i][e] += xw[i][e] * gw[0][e];
        // dxp[t + 3] = w0 g[t+3] + w1 g[t+2] + w2 g[t+1] + w3 g[t]
        float s = __fmul_rn(wv[0][e], gw[kTaps - 1][e]);
#pragma unroll
        for (int i = 1; i < kTaps; ++i)
          s = __fadd_rn(s, __fmul_rn(wv[i][e], gw[kTaps - 1 - i][e]));
        d[e] = s;
      }
      add_dnew(t + kTaps - 1, d);
      store16(dx + (row0 + t) * D + c0, d);
    }
    if (t > t0) {
#pragma unroll
      for (int i = kTaps - 1; i > 0; --i)
#pragma unroll
        for (int e = 0; e < V; ++e) xw[i][e] = xw[i - 1][e];
      load_xp(t - 1, xw[0]);
    }
  }

  if (tile == 0) {
    // dxp[j] = sum_{i <= j} w_i g[j - i], j = 0 .. 2; gw holds g[0 .. 3]
#pragma unroll
    for (int j = 0; j < kTaps - 1; ++j) {
      float d[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float s = __fmul_rn(wv[0][e], gw[j][e]);
#pragma unroll
        for (int i = 1; i <= j; ++i)
          s = __fadd_rn(s, __fmul_rn(wv[i][e], gw[j - i][e]));
        d[e] = s;
      }
      add_dnew(j, d);
      store16(dstate + (static_cast<long long>(b) * (kTaps - 1) + j) * D
              + c0, d);
    }
  }
  float* part = partial
      + (static_cast<long long>(b) * tiles + tile) * kParts * D + c0;
#pragma unroll
  for (int i = 0; i < kTaps; ++i)
#pragma unroll
    for (int e = 0; e < V; e += 4)
      store16(part + static_cast<long long>(i) * D + e, acc_w[i] + e);
#pragma unroll
  for (int e = 0; e < V; e += 4)
    store16(part + static_cast<long long>(kTaps) * D + e, acc_b + e);
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

template <typename T>
int launch(const void* x, const void* w, const void* bias,
           const void* state_in, const void* dout, const void* dstate_out,
           void* dx, float* dw, float* db, void* dstate, float* scratch,
           int B, int T_len, int D, long long sb, long long st,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
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
