// Mamba's selective scan over a whole sequence, its skip fused, for sm_90a.
//
// Replaces the chunked lax.scan of src/repro/models/mamba.py::_ssm_step in
// mamba_apply (and its skip y + x * d_skip), which no Pallas kernel covers.
// Per (batch row, channel d), with the channel's N fp32 states h:
//
//   h[n] = exp(dt_t a[d][n]) * h[n] + (dt_t b_t[n]) x_t
//   y_t = sum_n h[n] c_t[n] + x_t d_skip[d]
//
// dt, x and y are (B, T, D) fp32, a (D, N), b and c (B, T, N), d_skip (D),
// the states (B, D, N), all fp32; N is 8 (the smoke config) or 16 (jamba).
//
// Bound.  Bytes: dt and x read once and y written once, 3 * B*T*D floats
// (b, c, a and the states are small).  Operations: per state element a
// step an expf, four products, an add and y's FMA; the expf's MUFU.EX2
// issues 16 a clock an SM, so B*T*D*N exponentials take about as long as
// the bytes (1.54 ms against 1.44 ms at (4, 6144, 16384, 16) on an H100).
// The recurrence is serial in T, so the design's job is to keep every
// (batch row, channel) walking at once with the loads off its path.
//
// Design.  A block owns kThreads consecutive channels of one batch row,
// a thread one channel, its N states and its row of a in registers.  Steps
// are staged kStage at a time: each thread loads its channel's dt and x of
// the next stage into registers (a warp reads 128 contiguous bytes of each
// a step) while it computes the current one, and the block loads the next
// stage's b and c (shared by all its channels) into the other half of a
// double buffer in shared memory, one barrier a stage.  The state update
// rounds each product and the sum separately (__fmul_rn / __fadd_rn: nvcc
// would otherwise contract them into an FMA) and takes expf, as the plain
// version's torch ops do, so the states follow the plain version's
// roundings; y's sum over n runs in another order than the plain einsum.
//
// Checkpoints.  Under autograd the wrapper passes a buffer (B, ceil(T /
// kStage), D, N): at the start of every stage each thread writes its state
// before that stage's first step, the states the backward
// (selective_scan_bwd.cu) recomputes its chunks from.  Serving passes null.
//
// C interface (ctypes): selective_scan_launch(dt, a, b, c, x, d_skip,
// state_in, y, state_out, ckpt, B, T, D, N, stream); state_in may be null
// (zeros) and may equal state_out; ckpt may be null.  D must be a multiple
// of 128, every pointer 16-byte aligned.  Returns cudaGetLastError() after
// the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block (selective_scan.BLOCK_CHANNELS)
constexpr int kStage = 8;      // steps a stage (selective_scan.CKPT)

template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + n);
    out[n] = q.x; out[n + 1] = q.y; out[n + 2] = q.z; out[n + 3] = q.w;
  }
}
template <int N>
__device__ __forceinline__ void store_row(float* p, const float* v) {
#pragma unroll
  for (int n = 0; n < N; n += 4)
    *reinterpret_cast<float4*>(p + n) = make_float4(v[n], v[n + 1],
                                                    v[n + 2], v[n + 3]);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ dt, const float* __restrict__ a,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ x, const float* __restrict__ dskip,
            const float* state_in, float* __restrict__ y, float* state_out,
            float* __restrict__ ckpt, int T_len, int D) {
  constexpr int kBC = kStage * 2 * N;                 // b, c of a stage
  constexpr int kPer = (kBC + kThreads - 1) / kThreads;
  __shared__ __align__(16) float bc[2][kBC];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const int b = blockIdx.y;
  const long long row = static_cast<long long>(b) * T_len;
  const int stages = (T_len + kStage - 1) / kStage;

  float av[N], h[N];
  load_row<N>(a + static_cast<long long>(d) * N, av);
  const long long sidx = (static_cast<long long>(b) * D + d) * N;
  if (state_in != nullptr) {
    load_row<N>(state_in + sidx, h);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = 0.f;
  }
  const float ds = dskip[d];

  float dtc[kStage], xc[kStage], dtn[kStage], xn[kStage], bcr[kPer];
  auto load_stage = [&](int s, float* dtr, float* xr) {
    const int t0 = s * kStage;
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int t = t0 + j;
      const bool in = t < T_len;
      dtr[j] = in ? dt[(row + t) * D + d] : 0.f;
      xr[j] = in ? x[(row + t) * D + d] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      const int j = i / (2 * N), n2 = i % (2 * N), t = t0 + j;
      float v = 0.f;
      if (i < kBC && t < T_len)
        v = n2 < N ? bm[(row + t) * N + n2] : cm[(row + t) * N + n2 - N];
      bcr[k] = v;
    }
  };
  auto store_bc = [&](int buf) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      if (i < kBC) bc[buf][i] = bcr[k];
    }
  };

  load_stage(0, dtc, xc);
  store_bc(0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const bool more = s + 1 < stages;
    if (more) load_stage(s + 1, dtn, xn);
    if (ckpt != nullptr)
      store_row<N>(ckpt + ((static_cast<long long>(b) * stages + s) * D + d)
                   * N, h);
    const float* sb = bc[s & 1];
    const int t0 = s * kStage;
    const int len = min(kStage, T_len - t0);
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (j < len) {
        const float dtv = dtc[j], xv = xc[j];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float e = expf(__fmul_rn(dtv, av[n]));
          const float u = __fmul_rn(__fmul_rn(dtv, sb[j * 2 * N + n]), xv);
          h[n] = __fadd_rn(__fmul_rn(e, h[n]), u);
          acc = fmaf(h[n], sb[j * 2 * N + N + n], acc);
        }
        y[(row + t0 + j) * D + d] = __fadd_rn(acc, __fmul_rn(xv, ds));
      }
    }
    if (more) store_bc((s + 1) & 1);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      dtc[j] = dtn[j];
      xc[j] = xn[j];
    }
  }
  store_row<N>(state_out + sidx, h);
}

template <int N>
int launch(const float* dt, const float* a, const float* b, const float* c,
           const float* x, const float* dskip, const float* s_in, float* y,
           float* s_out, float* ckpt, int B, int T_len, int D,
           cudaStream_t stream) {
  const dim3 grid(D / kThreads, B);
  scan_kernel<N><<<grid, kThreads, 0, stream>>>(dt, a, b, c, x, dskip, s_in,
                                                y, s_out, ckpt, T_len, D);
  return 0;
}

}  // namespace

extern "C" int selective_scan_launch(const void* dt, const void* a,
                                     const void* b, const void* c,
                                     const void* x, const void* d_skip,
                                     const void* state_in, void* y,
                                     void* state_out, void* ckpt, int B,
                                     int T_len, int D, int N,
                                     cudaStream_t stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || D <= 0 || D % kThreads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(a);
  const float* f_b = static_cast<const float*>(b);
  const float* f_c = static_cast<const float*>(c);
  const float* f_x = static_cast<const float*>(x);
  const float* f_ds = static_cast<const float*>(d_skip);
  const float* f_si = static_cast<const float*>(state_in);
  float* f_y = static_cast<float*>(y);
  float* f_so = static_cast<float*>(state_out);
  float* f_ck = static_cast<float*>(ckpt);
  int code;
  if (N == 8)
    code = launch<8>(f_dt, f_a, f_b, f_c, f_x, f_ds, f_si, f_y, f_so, f_ck,
                     B, T_len, D, stream);
  else if (N == 16)
    code = launch<16>(f_dt, f_a, f_b, f_c, f_x, f_ds, f_si, f_y, f_so, f_ck,
                      B, T_len, D, stream);
  else
    code = static_cast<int>(cudaErrorInvalidValue);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}
