// The backward of the RWKV6 WKV recurrence (rwkv6_scan.cu), for sm_90a.
//
// Replaces jax.grad of the JAX package's chunked time-mix scan
// (src/repro/models/rwkv6.py, rwkv_time_mix_apply's scan of _wkv_step,
// checkpointed every cfg.rwkv.chunk steps); no Pallas kernel of the JAX
// package has a backward.  With P_t the state before step t (P_0 the
// initial state) and G the gradient of the state after the step being
// undone (the final state's gradient at first, zeros without one), for
// t = T-1 .. 0:
//
//   dr_t[j] = sum_i P_t[j][i] dy_t[i] + u[j] k_t[j] (v_t . dy_t)
//   dk_t[j] = sum_i G[j][i] v_t[i]    + u[j] r_t[j] (v_t . dy_t)
//   dv_t[i] = sum_j G[j][i] k_t[j]    + (sum_j r_t[j] u[j] k_t[j]) dy_t[i]
//   dw_t[j] = sum_i G[j][i] P_t[j][i]
//   G[j][i] = w_t[j] G[j][i] + r_t[j] dy_t[i]          (now of P_t)
//   du[j]  += r_t[j] k_t[j] (v_t . dy_t)               (over b and t)
//
// and the initial state's gradient is the last G.  Every state element
// (j, i) is a recurrence of its own in both directions; only the sums
// couple them: dr, dk and dw over the columns i, dv over the rows j.
//
// Bound.  r, k, v, w, dy and the forward's checkpoints are read once and
// dr, dk, dv, dw written once (at (4, 2048, 32, 64) fp32 about 600 MB, some
// 0.18 ms at 3.35 TB/s).  The work per state element a step: the state
// recomputed twice (three rounded instructions each: see below), four
// FMAs of the sums and two for G, about 11-12 fp32 instructions, which
// over an H100's 132 x 128 lanes at ~1.98 GHz is ~0.35-0.4 ms there.
//
// Design (a first, simple one).
// * A block owns one (batch, head) and a group of kRows = 16 rows of its
//   state, all dh columns: dr, dk and dw of its rows are summed inside the
//   block; dv sums over every row, so each row group writes a partial of
//   dv and a second kernel adds the dh / 16 partials in group order.
// * The forward kernel, under autograd, wrote the state every `every`
//   steps (its checkpoints, rwkv6_scan.cu).  The block walks those chunks
//   in reverse.  For each, pass A recomputes the chunk's states from its
//   checkpoint and keeps one every kSub = 8 steps in shared memory (the
//   sub-checkpoints, each thread its own elements); pass B walks the
//   sub-chunks in reverse, recomputes each one's kSub states into
//   registers (a thread's 2 x 2 tile a step, 32 registers), then runs the
//   reverse recurrence over them.  A state is never rebuilt backwards as
//   (S - k v) / w: that is neither stable nor the forward's arithmetic.
// * The state update rounds w * S, k * v and their sum separately
//   (__fmul_rn / __fadd_rn, no FMA), as the forward kernel and the plain
//   version do, so every recomputed state equals the forward's bit for
//   bit, whatever `every` is; G and the sums use FMAs.
// * Each step's sums leave the registers as per-thread partials in shared
//   memory (dr, dk, dw over a warp's 32 (dh 64) or 16 (dh 32) column
//   lanes; dv over the 8 row pairs of the block); after a sub-chunk the
//   block adds each set in a fixed order, adds the u terms (the bonus
//   scalar c_t and v_t . dy_t, one per step, from whole rows staged in
//   shared memory) and stores dr, dk, dw and its partial of dv (a row of
//   dr/dk/dw partials is padded by 4 floats: unpadded, the 16-byte reads
//   of a quarter-warp, 8 rows 128 bytes apart, all fell on one group of
//   banks, and that pass took 42 % of the launch).  du's
//   partial of the block's rows accumulates over t in the same order and
//   the second kernel adds the batch's partials in batch order.  No
//   atomics anywhere: repeats are bit-equal.
// * Pass A reads its rows of w and k and columns of v straight from
//   device memory (a sub-chunk's loads unrolled, so in flight together).
//   Pass B stages each sub-chunk's whole rows of r, k, w, v and dy into
//   shared memory through registers: every 16-byte load of a thread is
//   issued at once, the next sub-chunk's while the block sums the current
//   one, and the first sub-chunk's of a chunk before its pass A.
// * Two blocks an SM (112 KB of shared memory each at checkpoints 64
//   steps apart, 128 registers a thread at dh = 64), so one block's
//   barriers and load waits overlap the other's work.
//
// C interface (ctypes): rwkv6_scan_bwd_launch(r, k, v, w, u, ckpt, dy,
// dstate, dr, dk, dv, dw, du, dstate0, scratch, B, T, H, dh, every,
// stream).  All fp32; r/k/v/w/dy/dr/dk/dv/dw (B, T, H, dh), u and du
// (H, dh), ckpt (B, H, ceil(T / every), dh, dh) as the forward wrote it,
// dstate (the final state's gradient, may be null: zeros) and dstate0
// (B, H, dh, dh); scratch holds (dh / 16) * B * T * H * dh + B * H * dh
// floats (dv's row-group partials, then du's batch partials).  dh is 32
// or 64, `every` a positive multiple of kSub of at most kMaxEvery; every
// pointer 16-byte aligned.  Two launches on `stream`; returns
// cudaGetLastError() after them.

#include <cuda_runtime.h>

namespace {

constexpr int kSub = 8;          // steps a sub-chunk
constexpr int kRows = 16;        // state rows a block
constexpr int kMaxEvery = 256;   // checkpoint spacing the shared memory takes
constexpr int kMaxDevices = 64;

// The geometry of a block of kRows rows by DH columns, each thread a 2 x 2
// tile: NIL lanes over the columns, NJL over the rows in a warp.
template <int DH>
struct Geo {
  static constexpr int NIL = DH / 2;
  static constexpr int NJL = 32 / NIL;
  static constexpr int NG = kRows / 2;               // row pairs
  static constexpr int WARPS = NG / NJL;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int GROUPS = DH / kRows;          // row groups a head
  static constexpr int ELEMS = kRows * DH;
  // shared memory, in floats: the staged rows of r, k, w, v, dy; c_t and
  // v_t . dy_t; the partials of dr, dk, dw and of dv; the sub-checkpoints
  static constexpr int IN = 5 * kSub * DH;
  static constexpr int SCAL = 2 * kSub;
  // a row of partials padded by 4 floats: a quarter-warp's 16-byte reads
  // of 8 rows then fall on 8 distinct groups of banks
  static constexpr int NIL_PAD = NIL + 4;
  static constexpr int PRKW = kSub * 3 * kRows * NIL_PAD;
  static constexpr int PDV = kSub * NG * DH;
  static constexpr int FIXED = IN + SCAL + PRKW + PDV;
  static constexpr size_t bytes(int every) {
    return 4 * (FIXED + static_cast<size_t>(every / kSub) * ELEMS);
  }
  static_assert(NIL * NJL == 32 && NG % NJL == 0, "tile maps onto warps");
  static_assert(2 * (bytes(64) + 1024) <= 233472,
                "two blocks an SM at checkpoints 64 steps apart");
};

__device__ __forceinline__ float upd(float s, float w, float k, float v) {
  return __fadd_rn(__fmul_rn(w, s), __fmul_rn(k, v));
}

template <int DH>
__global__ void __launch_bounds__(Geo<DH>::THREADS, 2)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ ckpt,
               const float* __restrict__ dy,
               const float* __restrict__ dstate, float* __restrict__ dr,
               float* __restrict__ dk, float* __restrict__ dw,
               float* __restrict__ dstate0, float* __restrict__ dv_part,
               float* __restrict__ du_part, long n, int T_len, int H,
               int every) {
  using L = Geo<DH>;
  constexpr int NIL = L::NIL, NG = L::NG, THREADS = L::THREADS;
  constexpr int Q4 = DH / 4;                  // 16-byte pieces of a row
  extern __shared__ __align__(16) float smem[];
  // staged rows: [array][step][DH], arrays r, k, w, v, dy
  auto in = reinterpret_cast<float (*)[kSub][DH]>(smem);
  float* cs = smem + L::IN;                   // c_t of each staged step
  float* vd = cs + kSub;                      // v_t . dy_t
  auto prkw = reinterpret_cast<float (*)[3][kRows][L::NIL_PAD]>(
      cs + L::SCAL);
  auto pdv = reinterpret_cast<float (*)[NG][DH]>(smem + L::IN + L::SCAL +
                                                 L::PRKW);
  float* subck = smem + L::FIXED;             // [sub][4][THREADS]

  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.x / L::GROUPS;
  const int grp = blockIdx.x - bh * L::GROUPS;
  const int b = bh / H, h = bh - b * H;
  const int row0 = grp * kRows;
  const int jl = lane / NIL, il = lane - jl * NIL;
  const int g = (tid >> 5) * L::NJL + jl;     // row pair of the block
  const int jr = 2 * g, j0 = row0 + jr;       // first row: local, global
  const int i0 = 2 * il;                      // first column
  const long step_stride = static_cast<long>(H) * DH;
  const long base = (static_cast<long>(b) * T_len * H + h) * DH;
  const long state_base = static_cast<long>(bh) * DH * DH;
  const int n_ckpt = (T_len + every - 1) / every;

  // The rows of r, k, w, v and dy of a sub-chunk pass through registers
  // into shared memory: `load` issues every load of a thread at once (the
  // next sub-chunk's, while the block sums the current one), `stage`
  // stores them once the last readers are done, then adds c_t and
  // v_t . dy_t of each step (eight lanes a sum, a fixed order).
  constexpr int kLoads = (5 * kSub * Q4 + THREADS - 1) / THREADS;
  float4 pending[kLoads];
  auto load = [&](int t0, int steps) {
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int p = tid + it * THREADS;
      if (p < 5 * steps * Q4) {
        const int a = p / (steps * Q4), rest = p - a * steps * Q4;
        const int s = rest / Q4, q = rest - s * Q4;
        // a select, not an array of the five pointers: an indexed array
        // would live in local memory (a stack frame)
        const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? w
                         : a == 3 ? v : dy;
        pending[it] = __ldg(reinterpret_cast<const float4*>(
            src + base + (t0 + s) * step_stride + 4 * q));
      }
    }
  };
  auto stage = [&](int steps) {
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int p = tid + it * THREADS;
      if (p < 5 * steps * Q4) {
        const int a = p / (steps * Q4), rest = p - a * steps * Q4;
        const int s = rest / Q4, q = rest - s * Q4;
        *reinterpret_cast<float4*>(&in[a][s][4 * q]) = pending[it];
      }
    }
    __syncthreads();
    for (int p = tid; p < kSub * 16; p += THREADS) {
      const int s = p >> 4, which = (p >> 3) & 1, q = p & 7;
      float acc = 0.f;
      if (s < steps) {
#pragma unroll
        for (int jj = 0; jj < DH / 8; ++jj) {
          const int j = jj * 8 + q;
          acc = which == 0 ? fmaf(in[0][s][j] * __ldg(u + h * DH + j),
                                  in[1][s][j], acc)
                           : fmaf(in[3][s][j], in[4][s][j], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (q == 0 && s < steps) (which == 0 ? cs : vd)[s] = acc;
    }
    __syncthreads();
  };

  float G[2][2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
      G[jj][ii] = dstate ? dstate[state_base + (j0 + jj) * DH + i0 + ii]
                         : 0.f;
  }
  float du_acc = 0.f;                         // threads 0..kRows-1: a row

  for (int c = n_ckpt - 1; c >= 0; --c) {
    const int t0 = c * every, len = min(every, T_len - t0);
    const int n_sub = (len + kSub - 1) / kSub;
    const int last = (n_sub - 1) * kSub;      // pass B's first sub-chunk
    load(t0 + last, len - last);
    // pass A: the chunk's states from its checkpoint, one kept every kSub;
    // its rows of w and k and columns of v straight from device memory
    float S[2][2];
    const float* ck = ckpt + (static_cast<long>(bh) * n_ckpt + c) * DH * DH;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) S[jj][ii] = ck[(j0 + jj) * DH + i0 + ii];
    }
    for (int s = 0; s < n_sub; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        subck[(s * 4 + e) * THREADS + tid] = S[e >> 1][e & 1];
      if (s + 1 == n_sub) break;
      const long at = base + static_cast<long>(t0 + s * kSub) * step_stride;
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        const long row = at + q * step_stride;
        const float2 wv = __ldg(reinterpret_cast<const float2*>(w + row + j0));
        const float2 kv = __ldg(reinterpret_cast<const float2*>(k + row + j0));
        const float2 vv = __ldg(reinterpret_cast<const float2*>(v + row + i0));
        const float wr[2] = {wv.x, wv.y}, kr[2] = {kv.x, kv.y};
        const float vc[2] = {vv.x, vv.y};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
            S[jj][ii] = upd(S[jj][ii], wr[jj], kr[jj], vc[ii]);
        }
      }
    }

    // pass B: the sub-chunks in reverse
    for (int s = n_sub - 1; s >= 0; --s) {
      const int ts = t0 + s * kSub, steps = min(kSub, t0 + len - ts);
      stage(steps);
      float P[kSub][2][2];   // P[q]: the state before step ts + q
#pragma unroll
      for (int e = 0; e < 4; ++e)
        P[0][e >> 1][e & 1] = subck[(s * 4 + e) * THREADS + tid];
#pragma unroll
      for (int q = 1; q < kSub; ++q) {
        if (q < steps) {
          const float2 wv = *reinterpret_cast<const float2*>(
              &in[2][q - 1][j0]);
          const float2 kv = *reinterpret_cast<const float2*>(
              &in[1][q - 1][j0]);
          const float2 vv = *reinterpret_cast<const float2*>(
              &in[3][q - 1][i0]);
          const float wr[2] = {wv.x, wv.y}, kr[2] = {kv.x, kv.y};
          const float vc[2] = {vv.x, vv.y};
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
            for (int ii = 0; ii < 2; ++ii)
              P[q][jj][ii] = upd(P[q - 1][jj][ii], wr[jj], kr[jj], vc[ii]);
          }
        }
      }
#pragma unroll
      for (int q = kSub - 1; q >= 0; --q) {
        if (q < steps) {
          const float2 rv = *reinterpret_cast<const float2*>(&in[0][q][j0]);
          const float2 kv = *reinterpret_cast<const float2*>(&in[1][q][j0]);
          const float2 wv = *reinterpret_cast<const float2*>(&in[2][q][j0]);
          const float2 vv = *reinterpret_cast<const float2*>(&in[3][q][i0]);
          const float2 dv2 = *reinterpret_cast<const float2*>(
              &in[4][q][i0]);
          const float rr[2] = {rv.x, rv.y}, kr[2] = {kv.x, kv.y};
          const float wr[2] = {wv.x, wv.y}, vc[2] = {vv.x, vv.y};
          const float dyc[2] = {dv2.x, dv2.y};
          float pr[2], pk[2], pw[2], pv[2] = {0.f, 0.f};
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            pr[jj] = fmaf(P[q][jj][1], dyc[1], P[q][jj][0] * dyc[0]);
            pk[jj] = fmaf(G[jj][1], vc[1], G[jj][0] * vc[0]);
            pw[jj] = fmaf(G[jj][1], P[q][jj][1], G[jj][0] * P[q][jj][0]);
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              pv[ii] = fmaf(G[jj][ii], kr[jj], pv[ii]);
              G[jj][ii] = fmaf(wr[jj], G[jj][ii], rr[jj] * dyc[ii]);
            }
          }
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            prkw[q][0][jr + jj][il] = pr[jj];
            prkw[q][1][jr + jj][il] = pk[jj];
            prkw[q][2][jr + jj][il] = pw[jj];
          }
          *reinterpret_cast<float2*>(&pdv[q][g][i0]) =
              make_float2(pv[0], pv[1]);
        }
      }
      __syncthreads();
      if (s > 0) load(ts - kSub, kSub);   // in flight during the sums

      // the sums of this sub-chunk, each in a fixed order
      constexpr int kRkwItems = (kSub * 3 * kRows + THREADS - 1) / THREADS;
#pragma unroll
      for (int it = 0; it < kRkwItems; ++it) {
        const int p = tid + it * THREADS;
        if (p < steps * 3 * kRows) {
          const int q = p / (3 * kRows), rest = p - q * 3 * kRows;
          const int a = rest / kRows, jrow = rest - a * kRows;
          const float* part = prkw[q][a][jrow];
          float acc = 0.f;
#pragma unroll
          for (int l = 0; l < NIL; l += 4) {
            const float4 x = *reinterpret_cast<const float4*>(part + l);
            acc += x.x; acc += x.y; acc += x.z; acc += x.w;
          }
          const int j = row0 + jrow;
          if (a == 0) acc = fmaf(__ldg(u + h * DH + j) * in[1][q][j], vd[q],
                                 acc);
          if (a == 1) acc = fmaf(__ldg(u + h * DH + j) * in[0][q][j], vd[q],
                                 acc);
          float* out = a == 0 ? dr : (a == 1 ? dk : dw);
          out[base + (ts + q) * step_stride + j] = acc;
        }
      }
      constexpr int kDvItems = (kSub * DH + THREADS - 1) / THREADS;
#pragma unroll
      for (int it = 0; it < kDvItems; ++it) {
        const int p = tid + it * THREADS;
        if (p < steps * DH) {
          const int q = p / DH, i = p - q * DH;
          float acc = 0.f;
#pragma unroll
          for (int gg = 0; gg < NG; ++gg) acc += pdv[q][gg][i];
          if (grp == 0) acc = fmaf(cs[q], in[4][q][i], acc);
          dv_part[grp * n + base + (ts + q) * step_stride + i] = acc;
        }
      }
      if (tid < kRows) {
        const int j = row0 + tid;
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          if (q < steps)
            du_acc = fmaf(in[0][q][j] * in[1][q][j], vd[q], du_acc);
        }
      }
      __syncthreads();   // partials and staged rows are read
    }
  }

#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
      dstate0[state_base + (j0 + jj) * DH + i0 + ii] = G[jj][ii];
  }
  if (tid < kRows) du_part[static_cast<long>(bh) * DH + row0 + tid] = du_acc;
}

// dv = the row groups' partials added in group order; du = the batch's
// partials added in batch order
__global__ void wkv_bwd_reduce(const float* __restrict__ dv_part,
                               const float* __restrict__ du_part,
                               float* __restrict__ dv, float* __restrict__ du,
                               long n4, int groups, int B, int HD) {
  const float4* part = reinterpret_cast<const float4*>(dv_part);
  for (long p = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       p < n4; p += static_cast<long>(gridDim.x) * blockDim.x) {
    float4 acc = part[p];
    for (int gg = 1; gg < groups; ++gg) {
      const float4 x = part[gg * n4 + p];
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    reinterpret_cast<float4*>(dv)[p] = acc;
  }
  if (blockIdx.x == 0) {
    for (int p = threadIdx.x; p < HD; p += blockDim.x) {
      float acc = du_part[p];
      for (int bb = 1; bb < B; ++bb) acc += du_part[static_cast<long>(bb) *
                                                    HD + p];
      du[p] = acc;
    }
  }
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* ckpt, const float* dy,
           const float* dstate, float* dr, float* dk, float* dv, float* dw,
           float* du, float* dstate0, float* scratch, int B, int T_len,
           int H, int every, int device, cudaStream_t stream) {
  using L = Geo<DH>;
  static bool ready[kMaxDevices];   // dynamic shared memory above 48 KB
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes(kMaxEvery)));
    if (err == cudaSuccess)   // all of L1 as shared memory: two blocks an SM
      err = cudaFuncSetAttribute(
          wkv_bwd_kernel<DH>,
          cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const long n = static_cast<long>(B) * T_len * H * DH;
  float* dv_part = scratch;
  float* du_part = scratch + L::GROUPS * n;
  wkv_bwd_kernel<DH><<<B * H * L::GROUPS, L::THREADS, L::bytes(every),
                       stream>>>(r, k, v, w, u, ckpt, dy, dstate, dr, dk, dw,
                                 dstate0, dv_part, du_part, n, T_len, H,
                                 every);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_reduce<<<528, 256, 0, stream>>>(dv_part, du_part, dv, du, n / 4,
                                          L::GROUPS, B, H * DH);
  return 0;
}

}  // namespace

extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* ckpt, const void* dy, const void* dstate,
    void* dr, void* dk, void* dv, void* dw, void* du, void* dstate0,
    void* scratch, int B, int T_len, int H, int dh, int every,
    cudaStream_t stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || every <= 0 || every % kSub != 0 ||
      every > kMaxEvery || static_cast<long>(B) * H * dh * dh > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  int code;
  switch (dh) {
    case 32:
      code = launch<32>(f(r), f(k), f(v), f(w), f(u), f(ckpt), f(dy),
                        f(dstate), m(dr), m(dk), m(dv), m(dw), m(du),
                        m(dstate0), m(scratch), B, T_len, H, every, device,
                        stream);
      break;
    case 64:
      code = launch<64>(f(r), f(k), f(v), f(w), f(u), f(ckpt), f(dy),
                        f(dstate), m(dr), m(dk), m(dv), m(dw), m(du),
                        m(dstate0), m(scratch), B, T_len, H, every, device,
                        stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}
