// The backward of Mamba's selective scan (selective_scan.cu), for sm_90a.
//
// Replaces jax.grad of the chunked lax.scan of
// src/repro/models/mamba.py::_ssm_step in mamba_apply (and its skip), which
// no Pallas kernel covers.  With P_t the state before step t, E_t =
// exp(dt_t a), h_t = E_t P_t + (dt_t b_t) x_t and G the gradient of the
// state after step t (dstate, or zeros, after the last), for t = T .. 1:
//
//   G_t = G + dy_t c_t,   L_t = G_t P_t E_t
//   ddt_t = sum_n (L_t a + G_t b_t x_t),   dx_t = sum_n G_t dt_t b_t
//           + dy_t d_skip
//   db_t = sum_d G_t dt_t x_t,   dc_t = sum_d dy_t h_t      (over channels)
//   da += L_t dt_t,   dd_skip += dy_t x_t                  (over batch, T)
//   G = G_t E_t
//
// ending with G, the initial state's gradient.  Shapes as the forward's;
// every tensor fp32.
//
// Bound.  Bytes: dt, x and dy read once, ddt and dx written once, 5 *
// B*T*D floats, plus the checkpoints (B*T*D*N / kStage floats) and the
// block partials of db and dc (written and read once).  Operations: per
// state element a step the forward's state recomputed (an expf, four
// products, an add) and the reverse step (its expf again and about ten
// multiply-adds): two expf a state element a step, twice the forward's
// MUFU floor.
//
// Design.  As the forward, a block owns kThreads channels of one batch row,
// a thread one channel.  It walks the chunks of kStage steps in reverse:
// from the chunk's checkpoint it recomputes the chunk's states in the
// forward's rounding, keeping each step's P_t in shared memory (kStage * N
// floats a thread, each thread its own slots), then runs the reverse
// recurrence over the chunk, G, da's and dd_skip's sums in registers.  A
// step's db and dc, sums over the channels, are reduce-scattered over the
// warp by xor shuffles (2N values over 32 lanes, a fixed tree), summed
// over the block's warps in order through shared memory once a chunk, and
// written as the block's partial; a second kernel sums the D / kThreads
// block partials of each (b, t, n) in order, and the B batch partials of
// da and dd_skip: no atomics, the same bits every launch.
//
// C interface (ctypes): selective_scan_bwd_launch(dt, a, b, c, x, d_skip,
// ckpt, dy, dstate, ddt, da, db, dc, dx, dd_skip, dstate0, scratch, B, T,
// D, N, stream); ckpt (B, ceil(T / 8), D, N) from the forward; dstate may
// be null (zeros); scratch (D / 128) * B * T * 2N + B * D * (N + 1) floats.
// Returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block (selective_scan.BLOCK_CHANNELS)
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 8;      // steps a chunk (selective_scan.CKPT)

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

// One level of the warp's reduce-scatter: each lane keeps the half of its
// first 2 * O values that its lane bit O selects and adds the partner
// lane's copy of that half, then the next level halves again.
template <int O, int V>
__device__ __forceinline__ void scatter_level(float (&v)[V], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) scatter_level<O / 2>(v, lane);
}

// The warp's sum of v[k] over its 32 lanes, for k = lane % V, in a fixed
// order (V = 16: the two half-warps' sums added last).
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
  static_assert(V == 16 || V == 32, "d_state must be 8 or 16");
  scatter_level<V / 2>(v, lane);
  float r = v[0];
  if constexpr (V == 16) r += __shfl_xor_sync(0xffffffffu, r, 16);
  return r;
}

template <int N>
constexpr int smem_floats() {
  return kStage * N * kThreads + kStage * 2 * N + kStage * kWarps * 2 * N;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ x, const float* __restrict__ dskip,
                const float* __restrict__ ckpt, const float* __restrict__ dy,
                const float* __restrict__ dstate, float* __restrict__ ddt,
                float* __restrict__ dx, float* __restrict__ dstate0,
                float* __restrict__ part_bc, float* __restrict__ part_a,
                float* __restrict__ part_s, int T_len, int D) {
  constexpr int V = 2 * N;                  // db, then dc, of a step
  constexpr int kBC = kStage * V;
  constexpr int kPer = (kBC + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* states = smem;                              // [kStage][N][kThreads]
  float* bc = states + kStage * N * kThreads;        // [kStage][2N]
  float* red = bc + kBC;                             // [kStage][kWarps][2N]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = blockIdx.x * kThreads + tid;
  const int b = blockIdx.y, B = gridDim.y;
  const long long row = static_cast<long long>(b) * T_len;
  const int stages = (T_len + kStage - 1) / kStage;

  float av[N], g[N], da_acc[N];
  load_row<N>(a + static_cast<long long>(d) * N, av);
  const long long sidx = (static_cast<long long>(b) * D + d) * N;
  if (dstate != nullptr) {
    load_row<N>(dstate + sidx, g);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) g[n] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) da_acc[n] = 0.f;
  const float ds = dskip[d];
  float ds_acc = 0.f;

  for (int s = stages - 1; s >= 0; --s) {
    const int t0 = s * kStage;
    const int len = min(kStage, T_len - t0);
    float dtr[kStage], xr[kStage], dyr[kStage], h[N];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const bool in = j < len;
      const long long i = (row + t0 + j) * D + d;
      dtr[j] = in ? dt[i] : 0.f;
      xr[j] = in ? x[i] : 0.f;
      dyr[j] = in ? dy[i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      const int j = i / V, n2 = i % V;
      if (i < kBC)
        bc[i] = j < len ? (n2 < N ? bm[(row + t0 + j) * N + n2]
                                  : cm[(row + t0 + j) * N + n2 - N])
                        : 0.f;
    }
    load_row<N>(ckpt + ((static_cast<long long>(b) * stages + s) * D + d)
                * N, h);
    __syncthreads();

    // the chunk's states P_t, in the forward's rounding
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (j < len) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          states[(j * N + n) * kThreads + tid] = h[n];
          const float e = expf(__fmul_rn(dtr[j], av[n]));
          const float u = __fmul_rn(__fmul_rn(dtr[j], bc[j * V + n]), xr[j]);
          h[n] = __fadd_rn(__fmul_rn(e, h[n]), u);
        }
      }
    }
    // the reverse recurrence over the chunk
#pragma unroll
    for (int j = kStage - 1; j >= 0; --j) {
      if (j < len) {
        const float dtv = dtr[j], xv = xr[j], dyv = dyr[j];
        float v[V];
        float ddt_acc = 0.f, dx_acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float p = states[(j * N + n) * kThreads + tid];
          const float bn = bc[j * V + n], cn = bc[j * V + N + n];
          const float e = expf(__fmul_rn(dtv, av[n]));
          const float dtb = __fmul_rn(dtv, bn);
          const float hn = __fadd_rn(__fmul_rn(e, p), __fmul_rn(dtb, xv));
          const float gt = fmaf(dyv, cn, g[n]);
          const float lg = gt * p * e;
          v[N + n] = dyv * hn;
          v[n] = gt * xv * dtv;
          ddt_acc = fmaf(lg, av[n], ddt_acc);
          ddt_acc = fmaf(gt * bn, xv, ddt_acc);
          dx_acc = fmaf(gt, dtb, dx_acc);
          da_acc[n] = fmaf(lg, dtv, da_acc[n]);
          g[n] = gt * e;
        }
        const long long i = (row + t0 + j) * D + d;
        ddt[i] = ddt_acc;
        dx[i] = fmaf(dyv, ds, dx_acc);
        ds_acc = fmaf(dyv, xv, ds_acc);
        const float r = reduce_scatter<V>(v, lane);
        if (lane < V) red[(j * kWarps + warp) * V + lane] = r;
      }
    }
    __syncthreads();
    // the block's partial of db and dc: its warps' sums in order
    for (int i = tid; i < len * V; i += kThreads) {
      const int j = i / V, k = i % V;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(j * kWarps + w) * V + k];
      part_bc[((static_cast<long long>(blockIdx.x) * B + b) * T_len + t0 + j)
              * V + k] = sum;
    }
  }
  store_row<N>(dstate0 + sidx, g);
  store_row<N>(part_a + sidx, da_acc);
  part_s[static_cast<long long>(b) * D + d] = ds_acc;
}

// db and dc: each (b, t, n)'s block partials summed in block order; da
// and dd_skip: each (d, n)'s and d's batch partials in batch order
__global__ void __launch_bounds__(256)
scan_bwd_reduce(const float* __restrict__ part_bc,
                const float* __restrict__ part_a,
                const float* __restrict__ part_s, float* __restrict__ db,
                float* __restrict__ dc, float* __restrict__ da,
                float* __restrict__ dds, int B, int T_len, int D, int N,
                int groups) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  const long long n_bc = static_cast<long long>(B) * T_len * 2 * N;
  if (i < n_bc) {
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += part_bc[k * n_bc + i];
    const long long bt = i / (2 * N);
    const int n2 = static_cast<int>(i % (2 * N));
    if (n2 < N)
      db[bt * N + n2] = s;
    else
      dc[bt * N + n2 - N] = s;
    return;
  }
  i -= n_bc;
  const long long n_a = static_cast<long long>(D) * N;
  if (i < n_a) {
    float s = 0.f;
    for (int k = 0; k < B; ++k) s += part_a[k * n_a + i];
    da[i] = s;
    return;
  }
  i -= n_a;
  if (i < D) {
    float s = 0.f;
    for (int k = 0; k < B; ++k) s += part_s[static_cast<long long>(k) * D + i];
    dds[i] = s;
  }
}

template <int N>
int launch(const float* dt, const float* a, const float* b, const float* c,
           const float* x, const float* dskip, const float* ckpt,
           const float* dy, const float* dstate, float* ddt, float* da,
           float* db, float* dc, float* dx, float* dds, float* ds0,
           float* scratch, int B, int T_len, int D, cudaStream_t stream) {
  const int groups = D / kThreads;
  float* part_bc = scratch;
  float* part_a = part_bc + static_cast<long long>(groups) * B * T_len * 2 * N;
  float* part_s = part_a + static_cast<long long>(B) * D * N;
  constexpr int bytes = smem_floats<N>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_kernel<N><<<dim3(groups, B), kThreads, bytes, stream>>>(
      dt, a, b, c, x, dskip, ckpt, dy, dstate, ddt, dx, ds0, part_bc, part_a,
      part_s, T_len, D);
  const long long outs = static_cast<long long>(B) * T_len * 2 * N
      + static_cast<long long>(D) * N + D;
  scan_bwd_reduce<<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                    stream>>>(part_bc, part_a, part_s, db, dc, da, dds, B,
                              T_len, D, N, groups);
  return 0;
}

}  // namespace

extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* a, const void* b, const void* c,
    const void* x, const void* d_skip, const void* ckpt, const void* dy,
    const void* dstate, void* ddt, void* da, void* db, void* dc, void* dx,
    void* dd_skip, void* dstate0, void* scratch, int B, int T_len, int D,
    int N, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || D <= 0 || D % kThreads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* in[9] = {
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(x), static_cast<const float*>(d_skip),
      static_cast<const float*>(ckpt), static_cast<const float*>(dy),
      static_cast<const float*>(dstate)};
  float* out[8] = {static_cast<float*>(ddt), static_cast<float*>(da),
                   static_cast<float*>(db), static_cast<float*>(dc),
                   static_cast<float*>(dx), static_cast<float*>(dd_skip),
                   static_cast<float*>(dstate0),
                   static_cast<float*>(scratch)};
  int code;
  if (N == 8)
    code = launch<8>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                     in[8], out[0], out[1], out[2], out[3], out[4], out[5],
                     out[6], out[7], B, T_len, D, stream);
  else if (N == 16)
    code = launch<16>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                      in[8], out[0], out[1], out[2], out[3], out[4], out[5],
                      out[6], out[7], B, T_len, D, stream);
  else
    code = static_cast<int>(cudaErrorInvalidValue);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}
