// Mamba's selective scan over a whole sequence, its skip fused, for sm_90a;
// in its gated mode also dt's softplus before it and the SiLU gate after.
//
// Replaces the chunked lax.scan of src/repro/models/mamba.py::_ssm_step in
// mamba_apply (and its skip y + x * d_skip), which no Pallas kernel covers.
// Per (batch row, channel d), with the channel's N fp32 states h:
//
//   h[n] = exp(dt_t a[d][n]) * h[n] + (dt_t b_t[n]) x_t
//   y_t = sum_n h[n] c_t[n] + x_t d_skip[d]
//
// a (D, N), b and c (B, T, N), d_skip (D) and the states (B, D, N) are
// fp32; N is 8 (the smoke config) or 16 (jamba).  Two modes share the
// scan body:
//
// * fp32 (the model under autograd): dt and x (B, T, D) fp32 in, y fp32
//   out; the state every kStage steps into ckpt when it is not null.
// * gated (serving): dt's raw projection, x (the conv's output) and the
//   gate z in the model type (bf16 or fp32; z a view with row and batch
//   strides of its own, the z half of the input projection), dt_bias
//   (D) fp32.  Per channel and step dt = softplus(dt_raw + dt_bias) with
//   torch's threshold (20) and its expf / log1pf, and the output is
//   rnd(rnd(y) * rnd(z / (1 + expf(-z)))), rnd the model type's rounding:
//   the roundings of the torch ops that model.mamba applies around the
//   fp32 mode, so the two give the same bits.
//
// Bound.  Bytes at (4, 6144, 16384, 16): fp32 mode dt, x read and y
// written, 4.83 GB, 1.445 ms at 3.35 TB/s; gated bf16 dt_raw, x, z read
// and the output written, 3.22 GB, 0.961 ms.  MUFU: one exponential per
// state element a step (16 results an SM a clock): 1.54 ms; the gated
// mode adds four a channel a step (softplus's exp and log, SiLU's exp and
// reciprocal): 1.93 ms.  Issue: the exponential is the precise expf the
// plain version's torch.exp runs (8 instructions: a two-term argument
// reduction around one MUFU.EX2), then dt a, the u term's two products,
// e h, the sum and y's FMA: ~14.5 instructions a state element a step
// with b and c's loads, ~2.8 ms at the card's highest clock on 128 lanes
// an SM; the issue rate, not the bytes, is the bound this design works
// against.
//
// Design.  A block owns kChannels channels of one batch row; a channel's N
// states are split over L = 1, 2 or 4 adjacent lanes (the wrapper picks L
// by shape so that a batch-1 prefill still gives every scheduler four
// warps), each lane holding N / L states and its row of a in registers.
// Steps are staged kStage at a time through shared memory: every thread
// loads 8 / L values of the next stage's dt and x tiles (and its share of
// b and c) into registers while the block scans the current stage, then
// converts them (softplus in the gated mode, so each is taken once a
// channel a step whatever L) into the other half of a double buffer, one
// barrier a stage.  The state update rounds each product and the sum
// apart, as the plain version's torch ops do (__fmul_rn / __fadd_rn, or
// nvcc would contract them), and takes the same expf, so the states are
// the plain version's bit for bit.  Rounded as h = fma(e, h, (dt x) b)
// instead (two instructions fewer), a state moves off the plain version's
// by an ulp a step in no one direction, and over a long memory that
// reached 1.48e-5 of the rms on an H100 (the gated mode's ragged case),
// past the 1e-5 gate.  y is summed by FMAs.  A stage's exponentials do
// not depend on h, so the unrolled stage keeps MUFU and FMA busy behind
// each state's two-instruction chain.
// y's partials are reduce-scattered over a channel's lanes by xor shuffles
// once a stage (each lane ends with kStage / L steps' sums), the skip is
// added, and y lands in a shared tile that the whole block writes out one
// stage later, coalesced, after gating it with z's tile (loaded while the
// stage was scanned).  So y's sum order depends on L (the wrapper's plan,
// the same in both modes for one shape) and the states do not.
//
// C interface (ctypes): selective_scan_launch(dt, dt_bias, a, b, c, x, z,
// d_skip, state_in, y, state_out, ckpt, B, T, D, N, lanes, z_batch_stride,
// z_row_stride, gated, dtype, stream); dtype 0 = float32, 1 = bfloat16
// (the gated mode only); dt_bias and z are read in the gated mode only;
// state_in may be null (zeros) and may equal state_out; ckpt may be null.
// D must be a multiple of 128, lanes 1, 2 or 4, z's strides multiples of
// 8, every pointer 16-byte aligned.  Returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 128;  // channels a block (selective_scan.BLOCK_CHANNELS)
constexpr int kStage = 8;       // steps a stage (selective_scan.CKPT)

struct Args {
  const void* dt;        // fp32 dt, or dt's raw projection (gated)
  const float* dt_bias;  // (D), gated
  const float* a;
  const float* b;
  const float* c;
  const void* x;
  const void* z;         // gated
  const float* dskip;
  const float* state_in;
  void* y;
  float* state_out;
  float* ckpt;
  int T_len, D;
  long long z_batch, z_row;
};

// E consecutive values of T as 32-bit words, read or written at once
template <typename T, int E>
struct Words {
  static constexpr int W = E * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[W];
};

template <typename T, int E>
__device__ __forceinline__ Words<T, E> load_words(const T* p) {
  Words<T, E> r;
  constexpr int W = Words<T, E>::W;
  if constexpr (W >= 4) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[k];
      r.w[4 * k] = q.x; r.w[4 * k + 1] = q.y;
      r.w[4 * k + 2] = q.z; r.w[4 * k + 3] = q.w;
    }
  } else if constexpr (W == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    r.w[0] = q.x; r.w[1] = q.y;
  } else {
    r.w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  return r;
}

template <typename T, int E>
__device__ __forceinline__ void store_words(T* p, const Words<T, E>& r) {
  constexpr int W = Words<T, E>::W;
  if constexpr (W >= 4) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k)
      reinterpret_cast<uint4*>(p)[k] = make_uint4(
          r.w[4 * k], r.w[4 * k + 1], r.w[4 * k + 2], r.w[4 * k + 3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = r.w[0];
  }
}

template <int E>
__device__ __forceinline__ void unpack(const Words<float, E>& r, float* v) {
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = __uint_as_float(r.w[e]);
}
template <int E>
__device__ __forceinline__ void unpack(const Words<__nv_bfloat16, E>& r,
                                       float* v) {
#pragma unroll
  for (int k = 0; k < E / 2; ++k) {   // the lower address in the low half
    v[2 * k] = __uint_as_float(r.w[k] << 16);
    v[2 * k + 1] = __uint_as_float(r.w[k] & 0xffff0000u);
  }
}

template <int E>
__device__ __forceinline__ Words<float, E> pack(const float* v, float) {
  Words<float, E> r;
#pragma unroll
  for (int e = 0; e < E; ++e) r.w[e] = __float_as_uint(v[e]);
  return r;
}
template <int E>
__device__ __forceinline__ Words<__nv_bfloat16, E> pack(const float* v,
                                                        __nv_bfloat16) {
  Words<__nv_bfloat16, E> r;
#pragma unroll
  for (int k = 0; k < E / 2; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    r.w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return r;
}

// K floats between memory (shared or global) and registers, 16 (or 8)
// bytes at once
template <int K>
__device__ __forceinline__ void load_f(const float* p, float* v) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + k);
      v[k] = q.x; v[k + 1] = q.y;
    }
  }
}
template <int K>
__device__ __forceinline__ void store_f(float* p, const float* v) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1],
                                                      v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 2)
      *reinterpret_cast<float2*>(p + k) = make_float2(v[k], v[k + 1]);
  }
}

__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// F.softplus(v) with beta 1 and threshold 20, as torch computes it
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// F.silu(v) in fp32, as torch computes it: v / (1 + expf(-v))
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

// y's partials of a stage (part[i] for steps base + i) reduce-scattered
// over a channel's lanes: at each level a lane keeps half of its steps and
// adds its partner's partials of them, so each lane ends with CNT / (2W)
// steps' sums, every one (p0 + p2) + (p1 + p3) whichever lane holds it.
// Template levels keep part's indices constant (registers, no stack).
template <int W, int CNT>
__device__ __forceinline__ void scatter_sum(float* part, int lane,
                                            int& base) {
  if constexpr (W >= 1) {
    constexpr int H = CNT / 2;
    const bool upper = (lane & W) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? part[i] : part[H + i];
      const float keep = upper ? part[H + i] : part[i];
      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
    }
    if (upper) base += H;
    scatter_sum<W / 2, H>(part, lane, base);
  }
}

template <typename T, bool kGate, int N, int L>
__global__ void __launch_bounds__(kChannels * L, 4 / L)
scan_kernel(const Args p) {
  constexpr int kThreads = kChannels * L;
  constexpr int M = N / L;                          // states a lane
  constexpr int E = kStage * kChannels / kThreads;  // tile values a thread
  constexpr int kBC = kStage * 2 * N;               // b, c floats a stage
  constexpr int Q = kBC >= kThreads ? kBC / kThreads : 1;
  __shared__ __align__(16) float s_dt[2][kStage][kChannels];
  __shared__ __align__(16) float s_x[2][kStage][kChannels];
  __shared__ __align__(16) float s_bc[2][kStage][2 * N];
  __shared__ __align__(16) float s_y[2][kStage][kChannels];

  const int tid = threadIdx.x;
  const int ch = tid / L, lane = tid % L;   // the scan's channel and lane
  const int d0 = blockIdx.x * kChannels, d = d0 + ch;
  const int bi = blockIdx.y;
  const int T_len = p.T_len, D = p.D;
  const long long row0 = static_cast<long long>(bi) * T_len;
  const int stages = (T_len + kStage - 1) / kStage;
  // the tiles' role: E consecutive channels of one step of a stage
  const int trow = tid * E / kChannels, tcol = tid * E % kChannels;
  const T* dt_g = static_cast<const T*>(p.dt);
  const T* x_g = static_cast<const T*>(p.x);
  const T zero_tag = T();

  float bias[E];
  if constexpr (kGate) {
    load_f<E>(p.dt_bias + d0 + tcol, bias);   // global, E floats aligned
  }

  Words<T, E> rdt, rx;
  float rbc[Q];
  auto load_stage = [&](int s) {
    const int t = s * kStage + trow;
    if (t < T_len) {
      const long long off = (row0 + t) * D + d0 + tcol;
      rdt = load_words<T, E>(dt_g + off);
      rx = load_words<T, E>(x_g + off);
    } else {
#pragma unroll
      for (int k = 0; k < Words<T, E>::W; ++k) rdt.w[k] = rx.w[k] = 0u;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = tid * Q + q;
      const int j = i / (2 * N), k = i % (2 * N), tt = s * kStage + j;
      float v = 0.f;
      if (i < kBC && tt < T_len)
        v = k < N ? p.b[(row0 + tt) * N + k] : p.c[(row0 + tt) * N + k - N];
      rbc[q] = v;
    }
  };
  auto store_stage = [&](int buf) {
    float v[E];
    unpack(rdt, v);
    if constexpr (kGate) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = softplus(v[e] + bias[e]);
    }
    store_f<E>(&s_dt[buf][trow][tcol], v);
    unpack(rx, v);
    store_f<E>(&s_x[buf][trow][tcol], v);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = tid * Q + q;
      if (i < kBC) (&s_bc[buf][0][0])[i] = rbc[q];
    }
  };

  float av[M], h[M];
  const long long sidx = (static_cast<long long>(bi) * D + d) * N + lane * M;
  load_f<M>(p.a + static_cast<long long>(d) * N + lane * M, av);
  if (p.state_in != nullptr) {
    load_f<M>(p.state_in + sidx, h);
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) h[m] = 0.f;
  }
  const float ds = p.dskip[d];

  auto scan_stage = [&](int s) {
    const int buf = s & 1;
    const int len = min(kStage, T_len - s * kStage);
    if (p.ckpt != nullptr)
      store_f<M>(p.ckpt + ((static_cast<long long>(bi) * stages + s) * D
                           + d) * N + lane * M, h);
    float part[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      part[j] = 0.f;
      if (j < len) {
        const float dtv = s_dt[buf][j][ch], xv = s_x[buf][j][ch];
        float bv[M], cv[M];
        load_f<M>(&s_bc[buf][j][lane * M], bv);
        load_f<M>(&s_bc[buf][j][N + lane * M], cv);
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < M; ++m) {   // the plain version's roundings
          const float e = expf(__fmul_rn(dtv, av[m]));
          const float u = __fmul_rn(__fmul_rn(dtv, bv[m]), xv);
          h[m] = __fadd_rn(__fmul_rn(e, h[m]), u);
          acc = fmaf(h[m], cv[m], acc);
        }
        part[j] = acc;
      }
    }
    int base = 0;
    scatter_sum<L / 2, kStage>(part, lane, base);
#pragma unroll
    for (int i = 0; i < kStage / L; ++i) {
      const int j = base + i;
      if (j < len)   // y + x d_skip, each rounded, as the plain version
        s_y[buf][j][ch] = __fadd_rn(part[i], __fmul_rn(s_x[buf][j][ch], ds));
    }
  };

  Words<T, E> rz;
  auto load_z = [&](int s) {
    const int t = s * kStage + trow;
    if (t < T_len)
      rz = load_words<T, E>(static_cast<const T*>(p.z) + bi * p.z_batch
                            + t * p.z_row + d0 + tcol);
  };
  auto finish = [&](int s) {   // stage s's y tile out, gated with z
    const int t = s * kStage + trow;
    if (t >= T_len) return;
    float v[E];
    load_f<E>(&s_y[s & 1][trow][tcol], v);
    if constexpr (kGate) {
      float zf[E];
      unpack(rz, zf);
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = rnd(v[e], zero_tag) * rnd(silu(zf[e]), zero_tag);
    }
    store_words<T, E>(static_cast<T*>(p.y) + (row0 + t) * D + d0 + tcol,
                      pack<E>(v, zero_tag));
  };

  load_stage(0);
  store_stage(0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const bool more = s + 1 < stages;
    if (more) load_stage(s + 1);
    if constexpr (kGate) {
      if (s > 0) load_z(s - 1);
    }
    scan_stage(s);
    if (s > 0) finish(s - 1);
    if (more) store_stage((s + 1) & 1);
    __syncthreads();
  }
  if constexpr (kGate) load_z(stages - 1);
  finish(stages - 1);
  store_f<M>(p.state_out + sidx, h);
}

template <typename T, bool G, int N, int L>
void launch(const Args& args, int B, cudaStream_t stream) {
  const dim3 grid(args.D / kChannels, B);
  scan_kernel<T, G, N, L><<<grid, kChannels * L, 0, stream>>>(args);
}

template <typename T, bool G, int N>
int launch_lanes(const Args& args, int B, int lanes, cudaStream_t stream) {
  if (lanes == 1) launch<T, G, N, 1>(args, B, stream);
  else if (lanes == 2) launch<T, G, N, 2>(args, B, stream);
  else if (lanes == 4) launch<T, G, N, 4>(args, B, stream);
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T, bool G>
int launch_states(const Args& args, int B, int N, int lanes,
                  cudaStream_t stream) {
  if (N == 8) return launch_lanes<T, G, 8>(args, B, lanes, stream);
  if (N == 16) return launch_lanes<T, G, 16>(args, B, lanes, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int selective_scan_launch(
    const void* dt, const void* dt_bias, const void* a, const void* b,
    const void* c, const void* x, const void* z, const void* d_skip,
    const void* state_in, void* y, void* state_out, void* ckpt, int B,
    int T_len, int D, int N, int lanes, int z_batch_stride,
    int z_row_stride, int gated, int dtype, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || D <= 0 || D % kChannels != 0 ||
      (gated && (dt_bias == nullptr || z == nullptr || z_batch_stride % 8 ||
                 z_row_stride % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{dt, static_cast<const float*>(dt_bias),
                  static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<const float*>(c), x, z,
                  static_cast<const float*>(d_skip),
                  static_cast<const float*>(state_in), y,
                  static_cast<float*>(state_out), static_cast<float*>(ckpt),
                  T_len, D, z_batch_stride, z_row_stride};
  int code;
  if (!gated && dtype == 0)
    code = launch_states<float, false>(args, B, N, lanes, stream);
  else if (gated && dtype == 0)
    code = launch_states<float, true>(args, B, N, lanes, stream);
  else if (gated && dtype == 1)
    code = launch_states<__nv_bfloat16, true>(args, B, N, lanes, stream);
  else
    code = static_cast<int>(cudaErrorInvalidValue);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}
