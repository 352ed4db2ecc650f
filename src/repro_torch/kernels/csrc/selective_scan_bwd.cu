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
// block partials of db and dc (written and read once): 1.12 ms at (4,
// 2048, 16384, 16) on an H100.  MUFU: one exponential a state element a
// step (E_t, taken once and kept for the reverse step), 0.51 ms there.
// Issue: the state recomputed in the forward's rounding (dt a, the
// precise expf, the u term's two products, E P and the sum: ~14
// instructions), the reverse step (~7 multiplies and multiply-adds), the
// sums of db and dc over the warp's channels and of ddt and dx over a
// channel pair's lanes (shuffles, adds and selects) and the shared-memory
// reads of each step's inputs: ~35-40 instructions a state element a step,
// ~2.3 ms on 128 lanes an SM; the issue rate, and the shared-memory and
// shuffle pipe it feeds, are what this design works against.
//
// Design.  A block owns kChannels channels of one batch row.  A thread
// owns two adjacent channels (a pair) and M of their N states each, a
// pair's states spread over P = 8 adjacent lanes (M = 2 at d_state 16, 1
// at d_state 8), so that a lane's chunk of states fits its registers and
// each step's per-channel work (dt, x, dy and the sums over n) and
// per-state work (b, c and the sums over the channels) are shared by its
// 2M state elements.  The block
// walks the chunks of kStage steps in reverse.  Each chunk's inputs (dt,
// x, dy, b and c rows and the chunk's checkpoint) are copied by cp.async
// into one half of a shared double buffer while the block works on the
// other half, one barrier a chunk; rows past T are zero-filled, which
// makes a short last chunk's extra steps carry the state and its
// gradient through unchanged (exp(0) = 1, no input), so every chunk runs
// the same unrolled code.  A lane recomputes its chunk's exponentials
// E_t and products E_t P_t from the checkpoint in the forward's rounding
// (__fmul_rn / __fadd_rn, the precise expf), keeping both in registers
// (4 * kStage * M floats): E_t is the forward's exponential bit for bit,
// so one expf a state element a step remains, and L_t = G_t (E_t P_t).
// dc's terms dy_t h_t are summed over the thread's pair and then over the
// warp's pairs by xor shuffles (a reduce-scatter, fixed order) as the
// states come; in the reverse steps db's terms likewise, and each lane's
// parts of ddt and dx are reduce-scattered over the pair's lanes.  The
// warps' sums of db and dc are added in warp order through shared memory
// one chunk later and written as the block's partial, and ddt's and dx's
// rows go out from a shared tile; a second kernel sums the D / kChannels
// block partials of each (b, t, n) in order, and the B batch partials of
// da and dd_skip: no atomics, the same bits every launch.  Lanes holding
// one sum store it alike (the same bits to the same word).
//
// C interface (ctypes): selective_scan_bwd_launch(dt, a, b, c, x, d_skip,
// ckpt, dy, dstate, ddt, da, db, dc, dx, dd_skip, dstate0, scratch, B, T,
// D, N, stream); ckpt (B, ceil(T / 8), D, N) from the forward; dstate may
// be null (zeros); scratch (D / 128) * B * T * 2N + B * D * (N + 1)
// floats; N 8 or 16.  D must be a multiple of 128, every pointer 16-byte
// aligned.  Returns cudaGetLastError() after the launches.
// selective_scan_bwd_occupancy(N, out) gives the kernel's registers,
// blocks an SM, threads and shared bytes on the current device.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 128;  // channels a block (selective_scan.BLOCK_CHANNELS)
constexpr int kStage = 8;       // steps a chunk (selective_scan.CKPT)
constexpr int P = 8;            // lanes a channel pair's states spread over

// 16 bytes from global to shared memory, asynchronously; zeros where
// `bytes` is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// K floats between memory and registers, 16 (or 8) bytes at once
template <int K>
__device__ __forceinline__ void load_f(const float* p, float* v) {
  if constexpr (K == 1) {
    v[0] = *p;
  } else if constexpr (K % 4 == 0) {
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
  if constexpr (K == 1) {
    *p = v[0];
  } else if constexpr (K % 4 == 0) {
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

// v summed over the lanes that differ in the lane masks X, X / 2, ..,
// Xmin: at a level while more than one value is left, each lane keeps the
// half of its first 2 * O values that its lane bit X selects and adds the
// partner lane's copy of that half; once one is left, the remaining
// levels add it whole.  v[0] ends as the sum of value k, k the lane's
// bits of the scattering levels, highest first; each sum's additions in
// one fixed order whichever lane holds it.
template <int X, int Xmin, int O>
__device__ __forceinline__ void xor_sum(float* v, int tid) {
  if constexpr (X >= Xmin) {
    if constexpr (O >= 1) {
      const bool upper = (tid & X) != 0;
#pragma unroll
      for (int i = 0; i < O; ++i) {
        const float send = upper ? v[i] : v[i + O];
        const float keep = upper ? v[i + O] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, X);
      }
      xor_sum<X / 2, Xmin, O / 2>(v, tid);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], X);
      xor_sum<X / 2, Xmin, 0>(v, tid);
    }
  }
}

__host__ __device__ constexpr int log2i(int v) {
  return v > 1 ? 1 + log2i(v / 2) : 0;
}

// A thread owns M states of two adjacent channels, a pair's N states
// over P adjacent lanes.
template <int N>
struct Geo {
  static constexpr int M = N / P;                    // states a channel
  static constexpr int kThreads = kChannels / 2 * P;
  static constexpr int kWarps = kThreads / 32;
  // lane bits of the sum over the warp's pairs (masks 16 .. P) and of
  // the sum over a pair's lanes (masks P / 2 .. 1) that add whole values
  static constexpr int kPairWhole = log2i(32 / P) - log2i(M);
  static constexpr int kLaneWhole = log2i(P) - 2;
};

template <int N>
struct Smem {
  float dt[2][kStage][kChannels];
  float x[2][kStage][kChannels];
  float dy[2][kStage][kChannels];
  float b[2][kStage][N];
  float c[2][kStage][N];
  float ck[2][kChannels][N];                        // the chunk's checkpoint
  float red[2][kStage][Geo<N>::kWarps][2 * N];   // warps' sums of db, dc
  float out[2][2][kStage][kChannels];               // ddt, dx
};

struct Args {
  const float *dt, *a, *b, *c, *x, *dskip, *ckpt, *dy, *dstate;
  float *ddt, *dx, *dstate0, *part_bc, *part_a, *part_s;
  int T_len, D;
};

template <int N>
__global__ void __launch_bounds__(Geo<N>::kThreads, 512 / Geo<N>::kThreads)
scan_bwd_kernel(const Args p) {
  using G = Geo<N>;
  constexpr int M = G::M, kThreads = G::kThreads, kWarps = G::kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32;
  const int pair = tid / P, q = tid % P;
  const int ch = 2 * pair;                  // the block's channels ch, ch + 1
  const int d0 = blockIdx.x * kChannels;
  const int bi = blockIdx.y, B = gridDim.y;
  const int T_len = p.T_len, D = p.D;
  const long long row0 = static_cast<long long>(bi) * T_len;
  const int stages = (T_len + kStage - 1) / kStage;

  // chunk s's inputs into buffer s & 1, rows past T as zeros
  auto load_chunk = [&](int s) {
    const int buf = s & 1, t0 = s * kStage;
    const float* ck = p.ckpt + ((static_cast<long long>(bi) * stages + s)
                                * D + d0) * N;
    constexpr int kCk = kChannels * N / 4;  // 16-byte pieces
#pragma unroll
    for (int k = 0; k < (kCk + kThreads - 1) / kThreads; ++k) {
      const int i = tid + k * kThreads;
      if (kCk % kThreads == 0 || i < kCk)
        cp_async16(&sm.ck[buf][0][0] + 4 * i, ck + 4 * i, 16);
    }
    constexpr int kRows = kStage * kChannels / 4;   // pieces of a tile
#pragma unroll
    for (int k = 0; k < (3 * kRows + kThreads - 1) / kThreads; ++k) {
      const int i = tid + k * kThreads;
      if (i < 3 * kRows) {
        const int which = i / kRows, r = i % kRows;
        const int j = r / (kChannels / 4), q4 = r % (kChannels / 4);
        const bool in = t0 + j < T_len;
        const float* src = which == 0 ? p.dt : which == 1 ? p.x : p.dy;
        float* dst = which == 0 ? &sm.dt[buf][j][4 * q4]
                   : which == 1 ? &sm.x[buf][j][4 * q4]
                                : &sm.dy[buf][j][4 * q4];
        cp_async16(dst, src + (in ? (row0 + t0 + j) * D + d0 + 4 * q4 : 0),
                   in ? 16 : 0);
      }
    }
    constexpr int kBC = kStage * N / 4;     // pieces of b (of c)
    if (tid < 2 * kBC) {
      const int q4 = tid % kBC, j = 4 * q4 / N;
      const bool in = t0 + j < T_len;
      const long long off = in ? (row0 + t0) * N + 4 * q4 : 0;
      cp_async16(tid < kBC ? &sm.b[buf][0][0] + 4 * q4
                           : &sm.c[buf][0][0] + 4 * q4,
                 (tid < kBC ? p.b : p.c) + off, in ? 16 : 0);
    }
    cp_async_commit();
  };

  // chunk s's outputs: each (step, value)'s warp sums of db and dc added
  // in warp order into the block's partial, ddt's and dx's tiles written
  auto finish = [&](int s) {
    const int t0 = s * kStage, buf = s & 1;
    if (tid < kStage * 2 * N) {
      const int j = tid / (2 * N), k = tid % (2 * N);
      if (t0 + j < T_len) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += sm.red[buf][j][w][k];
        p.part_bc[((static_cast<long long>(blockIdx.x) * B + bi) * T_len
                   + t0 + j) * 2 * N + k] = sum;
      }
    }
    constexpr int kOut = 2 * kStage * kChannels / 4;   // float4s
#pragma unroll
    for (int k = 0; k < kOut / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int which = i / (kOut / 2), j = i / (kChannels / 4) % kStage;
      const int q4 = i % (kChannels / 4);
      if (t0 + j < T_len)
        *reinterpret_cast<float4*>((which ? p.dx : p.ddt)
                                   + (row0 + t0 + j) * D + d0 + 4 * q4) =
            *reinterpret_cast<const float4*>(&sm.out[buf][which][j][4 * q4]);
    }
  };

  float av[2][M], g[2][M], da[2][M], ds[2], ds_acc[2];
  long long sidx[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = d0 + ch + c;
    load_f<M>(p.a + static_cast<long long>(d) * N + q * M, av[c]);
    sidx[c] = (static_cast<long long>(bi) * D + d) * N + q * M;
    if (p.dstate != nullptr) {
      load_f<M>(p.dstate + sidx[c], g[c]);
    } else {
#pragma unroll
      for (int m = 0; m < M; ++m) g[c][m] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) da[c][m] = 0.f;
    ds[c] = p.dskip[d];
    ds_acc[c] = 0.f;
  }
  // after the sum over the warp's pairs this lane holds state q M + k, k
  // its pair's index in the warp without the whole-adding bits; after the
  // sum over its pair's lanes, value vk = its top two lane bits: ddt (vk <
  // 2) or dx of channel ch + vk % 2
  const int wp = (tid % 32) / P;
  const int vn = q * M + (wp >> G::kPairWhole);
  const int vk = q >> G::kLaneWhole;
  const bool vc = (vk & 1) != 0, vdx = vk >= 2;
  const float ds_mine = vc ? ds[1] : ds[0];

  load_chunk(stages - 1);
  for (int s = stages - 1; s >= 0; --s) {
    cp_async_wait_all();
    __syncthreads();
    if (s > 0) load_chunk(s - 1);   // into the buffer chunk s + 1 used
    if (s + 1 < stages) finish(s + 1);
    const int buf = s & 1;

    // the chunk's exponentials E_j and products E_j P_j in the forward's
    // rounding, P_j the state before step j; dc's terms dy_j P_{j+1}
    // summed over the channels as the states come
    float EP[kStage][2][M], E[kStage][2][M], h[2][M];
#pragma unroll
    for (int c = 0; c < 2; ++c) load_f<M>(&sm.ck[buf][ch + c][q * M], h[c]);
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const float2 dt2 = *reinterpret_cast<const float2*>(&sm.dt[buf][j][ch]);
      const float2 x2 = *reinterpret_cast<const float2*>(&sm.x[buf][j][ch]);
      const float2 dy2 = *reinterpret_cast<const float2*>(&sm.dy[buf][j][ch]);
      const float dtv[2] = {dt2.x, dt2.y}, xv[2] = {x2.x, x2.y};
      const float dyv[2] = {dy2.x, dy2.y};
      float bv[M], v[M];
      load_f<M>(&sm.b[buf][j][q * M], bv);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          E[j][c][m] = expf(__fmul_rn(dtv[c], av[c][m]));
          EP[j][c][m] = __fmul_rn(E[j][c][m], h[c][m]);
          h[c][m] = __fadd_rn(EP[j][c][m],
                              __fmul_rn(__fmul_rn(dtv[c], bv[m]), xv[c]));
          v[m] = c == 0 ? dyv[0] * h[0][m] : fmaf(dyv[1], h[1][m], v[m]);
        }
      }
      xor_sum<16, P, M / 2>(v, tid);
      sm.red[buf][j][warp][N + vn] = v[0];
    }

    // the reverse recurrence over the chunk; db's terms G_t dt_t x_t
#pragma unroll
    for (int j = kStage - 1; j >= 0; --j) {
      const float2 dt2 = *reinterpret_cast<const float2*>(&sm.dt[buf][j][ch]);
      const float2 x2 = *reinterpret_cast<const float2*>(&sm.x[buf][j][ch]);
      const float2 dy2 = *reinterpret_cast<const float2*>(&sm.dy[buf][j][ch]);
      const float dtv[2] = {dt2.x, dt2.y}, xv[2] = {x2.x, x2.y};
      const float dyv[2] = {dy2.x, dy2.y};
      float bv[M], cv[M], v[M], r[4];
      load_f<M>(&sm.b[buf][j][q * M], bv);
      load_f<M>(&sm.c[buf][j][q * M], cv);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dtx = dtv[c] * xv[c];
        float la = 0.f, gb = 0.f;   // sums over n of L_t a and of G_t b
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float gt = fmaf(dyv[c], cv[m], g[c][m]);
          const float lg = gt * EP[j][c][m];
          v[m] = c == 0 ? gt * dtx : fmaf(gt, dtx, v[m]);
          la = fmaf(lg, av[c][m], la);
          gb = fmaf(gt, bv[m], gb);
          da[c][m] = fmaf(lg, dtv[c], da[c][m]);
          g[c][m] = gt * E[j][c][m];
        }
        r[c] = fmaf(gb, xv[c], la);    // ddt's part from this lane's n
        r[2 + c] = gb * dtv[c];        // dx's
        ds_acc[c] = fmaf(dyv[c], xv[c], ds_acc[c]);
      }
      xor_sum<P / 2, 1, 2>(r, tid);
      const float dy_mine = vc ? dyv[1] : dyv[0];
      sm.out[buf][vdx][j][ch + vc] = vdx ? fmaf(dy_mine, ds_mine, r[0]) : r[0];
      xor_sum<16, P, M / 2>(v, tid);
      sm.red[buf][j][warp][vn] = v[0];
    }
  }
  __syncthreads();
  finish(0);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    store_f<M>(p.dstate0 + sidx[c], g[c]);
    store_f<M>(p.part_a + sidx[c], da[c]);
    if (q == 0)
      p.part_s[static_cast<long long>(bi) * D + d0 + ch + c] = ds_acc[c];
  }
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

// the kernel's registers a thread, blocks an SM, threads a block and
// shared bytes a block on the current device, into out[0 .. 3]
template <int N>
int occupancy(int* out) {
  constexpr int bytes = static_cast<int>(sizeof(Smem<N>));
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, scan_bwd_kernel<N>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], scan_bwd_kernel<N>, Geo<N>::kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[2] = Geo<N>::kThreads;
  out[3] = bytes;
  return 0;
}

template <int N>
int launch(const Args& args, int B, cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(sizeof(Smem<N>));
  const cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_kernel<N><<<dim3(args.D / kChannels, B), Geo<N>::kThreads, bytes,
                       stream>>>(args);
  return 0;
}

}  // namespace

// registers a thread, blocks an SM, threads a block and shared bytes a
// block of the backward kernel at d_state N on the current device, into
// out[0 .. 3]; returns a CUDA error code
extern "C" int selective_scan_bwd_occupancy(int N, int* out) {
  if (N == 8) return occupancy<8>(out);
  if (N == 16) return occupancy<16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* a, const void* b, const void* c,
    const void* x, const void* d_skip, const void* ckpt, const void* dy,
    const void* dstate, void* ddt, void* da, void* db, void* dc, void* dx,
    void* dd_skip, void* dstate0, void* scratch, int B, int T_len, int D,
    int N, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || D <= 0 || D % kChannels != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = D / kChannels;
  float* part_bc = static_cast<float*>(scratch);
  float* part_a = part_bc + static_cast<long long>(groups) * B * T_len * 2 * N;
  float* part_s = part_a + static_cast<long long>(B) * D * N;
  const Args args{static_cast<const float*>(dt),
                  static_cast<const float*>(a),
                  static_cast<const float*>(b),
                  static_cast<const float*>(c),
                  static_cast<const float*>(x),
                  static_cast<const float*>(d_skip),
                  static_cast<const float*>(ckpt),
                  static_cast<const float*>(dy),
                  static_cast<const float*>(dstate),
                  static_cast<float*>(ddt), static_cast<float*>(dx),
                  static_cast<float*>(dstate0), part_bc, part_a, part_s,
                  T_len, D};
  int code;
  if (N == 8)
    code = launch<8>(args, B, stream);
  else if (N == 16)
    code = launch<16>(args, B, stream);
  else
    code = static_cast<int>(cudaErrorInvalidValue);
  if (code != 0) return code;
  const long long outs = static_cast<long long>(B) * T_len * 2 * N
      + static_cast<long long>(D) * N + D;
  scan_bwd_reduce<<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                    stream>>>(part_bc, part_a, part_s,
                              static_cast<float*>(db),
                              static_cast<float*>(dc),
                              static_cast<float*>(da),
                              static_cast<float*>(dd_skip), B, T_len, D, N,
                              groups);
  return static_cast<int>(cudaGetLastError());
}
