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
// dr, dk, dv, dw written once (at (4, 2048, 32, 64) fp32 about 680 MB,
// some 0.20 ms at 3.35 TB/s); 14 flops a state element a step (the state
// once, four sums, G) at 67 fp32 TFLOP/s are 0.22 ms.  Issue floor: the
// state is recomputed twice, three rounded instructions each (pass A for
// 56 of a 64-step chunk's steps, pass B for 10 of a sub-chunk's 8: six
// forward, the four odd ones again in reverse), four FMAs of the sums
// and two for G, and the shuffle trees' adds and shuffles (61 of each a
// thread's sub-chunk at dh = 64, over its 8 elements and 8 steps): ~14.3
// instructions a state element a step, ~0.46 ms over an H100's 132 x 128
// lanes at 1.98 GHz (the trees' selects, 122 a sub-chunk, and the loads
// from shared memory not counted).
//
// Design.
// * A block owns one (batch, head) and ROWS rows of its state, all dh
//   columns; a head's row groups run as one thread-block cluster.  ROWS
//   is half a head (clusters of two: at rwkv6-1.6b's shape 256 blocks of
//   256 threads, two an SM, one wave on an H100; there clusters of four
//   16-row blocks fit only 496 of 512 at once), except at dh = 64 with
//   checkpoints more than kWideEvery steps apart, where a quarter
//   (clusters of four) keeps the sub-checkpoints in shared memory.  A
//   thread holds a 2 x 4 tile of G: two rows, four neighbouring columns,
//   so dh / 4 lanes share a row pair and a warp holds 32 / (dh / 4) row
//   pairs.
// * The forward kernel, under autograd, wrote the state every `every`
//   steps (its checkpoints, rwkv6_scan.cu).  The block walks those chunks
//   in reverse.  For each, pass A recomputes the chunk's states from its
//   checkpoint and keeps one every kSub = 8 steps in shared memory (the
//   sub-checkpoints, each thread its own elements); pass B walks the
//   sub-chunks in reverse, recomputes each one's states and keeps those
//   before its even steps in registers (32 a thread), then runs the
//   reverse recurrence, recomputing an odd step's state from the even one
//   before it (that step's w, k and v are read from shared memory twice
//   rather than held in registers: at 128 a thread, nothing may spill).
//   A state is never rebuilt backwards as (S - k v) / w: that is neither
//   stable nor the forward's arithmetic.
// * The state update rounds w * S, k * v and their sum separately
//   (__fmul_rn / __fadd_rn, no FMA), as the forward kernel and the plain
//   version do, so every recomputed state equals the forward's bit for
//   bit, whatever `every` is; G and the sums use FMAs.
// * Sums in registers and shuffles, no per-step partial arrays.  A
//   thread sums its four columns of dr, dk and dw in registers; the lanes
//   of a row pair then reduce-scatter a sub-chunk's 48 values (2 rows x 3
//   sums x 8 steps) with xor shuffles, each exchange halving what a lane
//   holds (rows at once, step bits after the sub-chunk), until a lane
//   holds the three sums of one row and one step (two steps at dh = 32).
//   dv's sum over rows: the thread's two rows in registers, the warp's
//   row pairs by a shuffle reduce-scatter every step, each 16-row group's
//   warps through one small array a sub-chunk (a barrier, then a thread
//   adds one float4 over the group's warps in order), the groups through
//   distributed shared memory: each block leaves its groups' sub-chunk
//   partials (and their share of c_t = sum_j r_t u k_t) in one of two
//   buffers and arrives on the cluster barrier, and waits on it only
//   after the next sub-chunk's reverse recurrence; then it adds its
//   columns of the groups' partials in row order (so the sum is the same
//   whatever ROWS is) and writes dv once.  Nothing of dv passes through
//   device memory.  v_t . dy_t is summed by every warp from the staged
//   rows (the same order everywhere); du's partials stay in registers
//   over t, and a second, small launch adds the batch's partials (B * H *
//   dh floats) in batch order.  No atomics anywhere: repeats are
//   bit-equal, and no sum's order depends on `every` or on T's ragged
//   tail.
// * Rows staged by the copy engine.  Each sub-chunk's rows land in a
//   two-stage ring in shared memory as TMA boxes of kSub steps (the
//   block's ROWS columns of r, k, w; whole head rows of v and dy; pass
//   A's sub-chunks only k, w and v; steps past T as zeros), issued by
//   one thread a sub-chunk ahead and counted on a `full` mbarrier per
//   stage; each warp releases a stage on its `empty` mbarrier.  The next
//   chunk's rows are prefetched into L2 when a chunk's pass B starts
//   (pass A's sub-chunks are short, so one ahead is not enough), and its
//   checkpoint rows come by a bulk copy into their own buffer once pass B
//   has read the last one.  Neither pass loads r, k, w, v or dy from
//   device memory itself.
// * At most 128 registers a thread; 105 KB of shared memory a block at
//   checkpoints 64 steps apart, so two blocks share an SM (eight 27 KB
//   blocks at dh = 32).
//
// C interface (ctypes): rwkv6_scan_bwd_launch(r, k, v, w, u, ckpt, dy,
// dstate, dr, dk, dv, dw, du, dstate0, scratch, B, T, H, dh, every,
// stream).  All fp32; r/k/v/w/dy/dr/dk/dv/dw (B, T, H, dh), u and du
// (H, dh), ckpt (B, H, ceil(T / every), dh, dh) as the forward wrote it,
// dstate (the final state's gradient, may be null: zeros) and dstate0
// (B, H, dh, dh); scratch holds B * H * dh floats (du's batch partials).
// dh is 32 or 64, `every` a positive multiple of kSub of at most
// kMaxEvery; every pointer 16-byte aligned.  Two launches on `stream`;
// returns cudaGetLastError() after them.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using hopper::smem_u32;

constexpr int kSub = 8;          // steps a sub-chunk
constexpr int kStages = 2;       // the ring's stages
constexpr int kMaxEvery = 256;   // checkpoint spacing the shared memory takes
constexpr int kWideEvery = 64;   // the most that 32-row blocks at dh 64 take
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

// The geometry of a block of ROWS state rows (32 or 16) by DH columns, a
// head's DH / ROWS blocks one cluster; each thread two rows by four
// columns: CL lanes over the columns of a row pair, RL row pairs a warp.
// dv is summed by groups of 16 rows (GPB a block), whatever ROWS is.
template <int DH, int ROWS_>
struct Geo {
  static constexpr int ROWS = ROWS_;
  static constexpr int CL = DH / 4;
  static constexpr int RL = 32 / CL;
  static constexpr int WARPS = ROWS / (2 * RL);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int GROUPS = DH / ROWS;       // blocks a head: a cluster
  static constexpr int GPB = ROWS / 16;          // 16-row groups a block
  static constexpr int WPG = WARPS / GPB;        // warps a group
  static constexpr int MIN_BLOCKS = 512 / THREADS;   // 128 registers
  static constexpr int LV = CL == 16 ? 4 : 3;    // log2(CL)
  // after the reduce-scatter a lane holds QPL steps, QSPAN apart
  static constexpr int QSPAN = 1 << (LV - 1);
  static constexpr int QPL = kSub / QSPAN;
  static constexpr int DVN = 4 / RL;             // dv columns a lane a step
  static constexpr int SLICE = DH / GROUPS;      // dv columns a block writes
  static constexpr int NDV = kSub * SLICE / THREADS;
  // a ring stage, in floats: r, k, w (the block's ROWS columns), then v
  // and dy (DH), each [kSub][width] as a TMA box lands
  static constexpr int OFF_K = kSub * ROWS, OFF_W = 2 * kSub * ROWS;
  static constexpr int OFF_V = 3 * kSub * ROWS, OFF_DY = OFF_V + kSub * DH;
  static constexpr int SLOT = kSub * (3 * ROWS + 2 * DH);
  static constexpr int RING = kStages * SLOT;
  static constexpr int CKB = ROWS * DH;         // the chunk's checkpoint
  static constexpr int WB = WARPS * kSub * DH;   // the warps' dv partials
  static constexpr int WCB = WARPS * kSub;       // the warps' c partials
  static constexpr int XG = kSub * DH + kSub;    // a group's dv and c
  static constexpr int XB = GPB * XG;            // the block's, per parity
  static constexpr int FIXED = RING + CKB + WB + WCB + 2 * XB;
  static constexpr int BARS = 2 * kStages + 2;   // full, empty, ckpt x 2
  // the sub-checkpoints 1 .. every / kSub - 1 follow, then the barriers;
  // 128 bytes more to align the ring for TMA
  static constexpr size_t bytes(int every) {
    return 128 + 8 * BARS +
           4 * (FIXED + static_cast<size_t>(every / kSub - 1) * ROWS * DH);
  }
  static_assert(2 * RL * WARPS == ROWS && CL * RL == 32, "tile");
  static_assert(GPB * kSub * DH / 4 == THREADS, "a float4 of dv a thread");
  static_assert(NDV * THREADS == kSub * SLICE, "dv slice");
  static_assert((4 * SLOT) % 128 == 0 && (4 * OFF_DY) % 128 == 0,
                "TMA boxes land 128-byte aligned");
  static_assert(bytes(ROWS == 32 ? kWideEvery : kMaxEvery) <= 232448,
                "a block's shared memory at the widest spacing it takes");
  static_assert(DH != 64 || ROWS != 32 || 2 * (bytes(64) + 1024) <= 233472,
                "two blocks an SM at rwkv6-1.6b's checkpoints");
};

__device__ __forceinline__ float upd(float s, float w, float k, float v) {
  return __fadd_rn(__fmul_rn(w, s), __fmul_rn(k, v));
}

// One exchange of a reduce-scatter between the lanes `mask` apart: of
// the pair (lo, hi) a lane keeps hi when its `mask` bit is set, else lo,
// and adds its partner's copy of the same value (commutative, so both
// partners of a pair agree).
__device__ __forceinline__ float scatter_add(float lo, float hi, int lane,
                                             int mask) {
  const bool up = lane & mask;
  return (up ? hi : lo) + __shfl_xor_sync(kAll, up ? lo : hi, mask);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// r, k, w, v and dy as tensor maps over (B, T, H * dh) (make_map_f32):
// boxes of kSub steps by the block's ROWS columns (r, k, w) or a whole
// head row (v, dy)
template <int DH, int ROWS_>
__global__ void __launch_bounds__(Geo<DH, ROWS_>::THREADS,
                                  Geo<DH, ROWS_>::MIN_BLOCKS)
wkv_bwd_kernel(const __grid_constant__ CUtensorMap map_r,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_dy,
               const float* __restrict__ u, const float* __restrict__ ckpt,
               const float* __restrict__ dstate, float* __restrict__ dr,
               float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ dstate0,
               float* __restrict__ du_part, int T_len, int H, int every) {
  using L = Geo<DH, ROWS_>;
  constexpr int ROWS = L::ROWS, CL = L::CL, HALF = CL / 2;
  constexpr int WARPS = L::WARPS, THREADS = L::THREADS, GROUPS = L::GROUPS;
  constexpr int OFF_K = L::OFF_K, OFF_W = L::OFF_W, OFF_V = L::OFF_V;
  constexpr int OFF_DY = L::OFF_DY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* ckbuf = ring + L::RING;               // [ROWS][DH]
  float* wbuf = ckbuf + L::CKB;                // [warp][q][DH]
  float* wc = wbuf + L::WB;                    // [warp][q]
  float* xbuf = wc + L::WCB;                   // [parity][group]: dv, c
  float* subck = xbuf + 2 * L::XB;             // [s - 1][ROWS][DH]
  const uint32_t full0 =
      smem_u32(subck + (every / kSub - 1) * ROWS * DH);
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t ckfull = empty0 + 8 * kStages, ckempty = ckfull + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / GROUPS;
  const int grp = static_cast<int>(hopper::cluster_rank());
  const int b = bh / H, h = bh - b * H;
  const int row0 = grp * ROWS;
  const int cl = lane % CL, rl = lane / CL;
  const int jr = 2 * (warp * L::RL + rl);      // the thread's first row
  const int i0 = 4 * cl;                       // and first column
  const int HD = H * DH;
  const long base = (static_cast<long>(b) * T_len * H + h) * DH;
  const long state_base = static_cast<long>(bh) * DH * DH;
  const int n_ckpt = (T_len + every - 1) / every;
  // after the reduce-scatter: the lane's row and first step
  const int jbit = (cl & HALF) ? 1 : 0, jl = jr + jbit;
  int qlane = 0;
#pragma unroll
  for (int lv = 0; lv < L::LV - 1; ++lv)
    if (cl & (CL >> (lv + 2))) qlane |= 1 << lv;
  // the first of the DVN columns dv's per-step reduce-scatter leaves a
  // lane
  int dvcol = i0;
#pragma unroll
  for (int m = CL, n = 2; m < 32; m <<= 1, n >>= 1)
    if (lane & m) dvcol += n;
  const float uj = __ldg(u + h * DH + row0 + jl);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, WARPS);
    }
    hopper::mbar_init(ckfull, 1);
    hopper::mbar_init(ckempty, WARPS);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  auto n_sub_of = [&](int c) {
    return (min(every, T_len - c * every) + kSub - 1) / kSub;
  };
  // lane 0 of warp 0 stages task j, the kSub steps from t0 of pass A (k,
  // w, v) or B (all five), into stage j % kStages once every warp has
  // released it; steps past T arrive as zeros
  auto issue = [&](int j, bool pass_b, int t0) {
    if (lane != 0) return;
    const int st = j % kStages;
    const uint32_t full = full0 + 8 * st;
    hopper::mbar_wait(empty0 + 8 * st, ((j / kStages) & 1) ^ 1);
    hopper::mbar_expect_tx(
        full, 4 * kSub * (pass_b ? 3 * ROWS + 2 * DH : 2 * ROWS + DH));
    const uint32_t dst = smem_u32(ring + st * L::SLOT);
    const int cols = h * DH + row0;
    if (pass_b) hopper::tma_load_3d(dst, &map_r, full, cols, t0, b);
    hopper::tma_load_3d(dst + 4 * OFF_K, &map_k, full, cols, t0, b);
    hopper::tma_load_3d(dst + 4 * OFF_W, &map_w, full, cols, t0, b);
    hopper::tma_load_3d(dst + 4 * OFF_V, &map_v, full, h * DH, t0, b);
    if (pass_b)
      hopper::tma_load_3d(dst + 4 * OFF_DY, &map_dy, full, h * DH, t0, b);
  };
  auto issue_first = [&](int j, int c) {   // chunk c's first task
    issue(j, n_sub_of(c) == 1, c * every);
  };
  // lane 0 of warp 0 stages chunk c's checkpoint rows, the n-th chunk
  // walked, once every warp has read the last one
  auto issue_ckpt = [&](int n, int c) {
    if (lane != 0) return;
    hopper::mbar_wait(ckempty, (n & 1) ^ 1);
    hopper::mbar_expect_tx(ckfull, 4 * ROWS * DH);
    hopper::bulk_load(smem_u32(ckbuf),
                      ckpt + (static_cast<long>(bh) * n_ckpt + c) * DH * DH
                          + row0 * DH,
                      4 * ROWS * DH, ckfull);
  };
  auto load_tile = [&](const float* src, float (&x)[2][4]) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float4 q4 = ld4(src + (jr + jj) * DH + i0);
      x[jj][0] = q4.x; x[jj][1] = q4.y; x[jj][2] = q4.z; x[jj][3] = q4.w;
    }
  };
  if (warp == 0) {
    issue_ckpt(0, n_ckpt - 1);
    issue_first(0, n_ckpt - 1);
  }

  float G[2][4];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const float4 g4 = dstate ? __ldg(reinterpret_cast<const float4*>(
                                   dstate + state_base + (row0 + jr + jj) * DH
                                   + i0))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    G[jj][0] = g4.x; G[jj][1] = g4.y; G[jj][2] = g4.z; G[jj][3] = g4.w;
  }
  float du_acc[L::QPL];
#pragma unroll
  for (int m = 0; m < L::QPL; ++m) du_acc[m] = 0.f;
  float dyv[L::NDV];
  // dv of the pass-B sub-chunk done last (steps from t_prev; its partials
  // in buffer `par`), which the cluster has yet to add: this block's SLICE
  // columns, the 16-row groups' partials added in row order (the
  // cluster's blocks in rank order, a block's groups in order), then
  // c_t dy_t.  Sub-chunks are walked back to back in time, so it is the
  // one after the current one.
  auto flush_dv = [&](int t_prev, int par) {
    hopper::cluster_wait();
    const int steps_prev = min(kSub, T_len - t_prev);
    const uint32_t x = smem_u32(xbuf + par * L::XB);
#pragma unroll
    for (int e = 0; e < L::NDV; ++e) {
      const int idx = tid + e * THREADS, q = idx / L::SLICE;
      const int col = grp * L::SLICE + idx % L::SLICE;
      float acc = 0.f, c = 0.f;
#pragma unroll
      for (int rk = 0; rk < GROUPS; ++rk) {
#pragma unroll
        for (int g = 0; g < L::GPB; ++g) {
          const uint32_t xg = x + 4 * g * L::XG;
          acc += hopper::ld_cluster_f32(xg + 4 * (q * DH + col), rk);
          c += hopper::ld_cluster_f32(xg + 4 * (kSub * DH + q), rk);
        }
      }
      if (q < steps_prev)
        dv[base + static_cast<long>(t_prev + q) * HD + col] =
            fmaf(c, dyv[e], acc);
    }
  };

  int j = 0;      // tasks consumed
  int nb = 0;     // pass-B sub-chunks done
  for (int c = n_ckpt - 1, cn = 0; c >= 0; --c, ++cn) {
    const int t0 = c * every, len = min(every, T_len - t0);
    const int n_sub = (len + kSub - 1) / kSub;

    // pass A: the chunk's states from its checkpoint, one kept every kSub
    if (n_sub > 1) {
      hopper::mbar_wait(ckfull, cn & 1);
      float S[2][4];
      load_tile(ckbuf, S);
      for (int s = 0; s + 1 < n_sub; ++s, ++j) {
        if (warp == 0) {
          if (s + 2 < n_sub) issue(j + 1, false, t0 + (s + 1) * kSub);
          else issue(j + 1, true, t0 + (n_sub - 1) * kSub);
        }
        const int st = j % kStages;
        hopper::mbar_wait(full0 + 8 * st, (j / kStages) & 1);
        const float* sl = ring + st * L::SLOT;
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          const float2 wv = ld2(sl + OFF_W + q * ROWS + jr);
          const float2 kv = ld2(sl + OFF_K + q * ROWS + jr);
          const float4 vv = ld4(sl + OFF_V + q * DH + i0);
          const float wr[2] = {wv.x, wv.y}, kr[2] = {kv.x, kv.y};
          const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
              S[jj][ii] = upd(S[jj][ii], wr[jj], kr[jj], vc[ii]);
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty0 + 8 * st);
        float* dst = subck + s * ROWS * DH;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          *reinterpret_cast<float4*>(dst + (jr + jj) * DH + i0) =
              make_float4(S[jj][0], S[jj][1], S[jj][2], S[jj][3]);
      }
    }

    // pass B: the sub-chunks in reverse
    for (int s = n_sub - 1; s >= 0; --s, ++j, ++nb) {
      if (warp == 0) {
        if (s > 0) issue(j + 1, true, t0 + (s - 1) * kSub);
        else if (c > 0) issue_first(j + 1, c - 1);
        // the next chunk's rows into L2 while this one runs: its pass A's
        // sub-chunks are issued only one ahead
        if (s == n_sub - 1 && c > 0 && lane == 0) {
          const int cols = h * DH + row0, pt = (c - 1) * every;
          for (int q = 0; q < every; q += kSub) {
            hopper::tma_prefetch_3d(&map_k, cols, pt + q, b);
            hopper::tma_prefetch_3d(&map_w, cols, pt + q, b);
            hopper::tma_prefetch_3d(&map_v, h * DH, pt + q, b);
          }
          hopper::tma_prefetch_3d(&map_r, cols, pt + every - kSub, b);
          hopper::tma_prefetch_3d(&map_dy, h * DH, pt + every - kSub, b);
        }
      }
      const int ts = t0 + s * kSub, steps = min(kSub, t0 + len - ts);
      const int st = j % kStages;
      hopper::mbar_wait(full0 + 8 * st, (j / kStages) & 1);
      const float* sl = ring + st * L::SLOT;
      // v_t . dy_t of every step: four lanes a step, a quarter of the
      // columns each (their float4s rotated by the step, so that a
      // quarter-warp's loads fall on distinct banks), then two exchanges;
      // lane 4q holds step q's
      float vd;
      {
        const int q = lane >> 2, part = lane & 3;
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < DH / 16; ++m) {
          const int col = 4 * (4 * ((m + q) % (DH / 16)) + part);
          const float4 a = ld4(sl + OFF_V + q * DH + col);
          const float4 y = ld4(sl + OFF_DY + q * DH + col);
          acc = fmaf(a.x, y.x, acc);
          acc = fmaf(a.y, y.y, acc);
          acc = fmaf(a.z, y.z, acc);
          acc = fmaf(a.w, y.w, acc);
        }
        acc += __shfl_xor_sync(kAll, acc, 1);
        acc += __shfl_xor_sync(kAll, acc, 2);
        vd = acc;
      }
      // the sub-chunk's states at its even steps in registers (E[e]: the
      // state before step ts + 2e); an odd step's is recomputed from the
      // even one before it in the reverse loop
      float E[kSub / 2][2][4];
      if (s > 0) {
        load_tile(subck + (s - 1) * ROWS * DH, E[0]);
      } else {
        hopper::mbar_wait(ckfull, cn & 1);
        load_tile(ckbuf, E[0]);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(ckempty);
        if (warp == 0 && c > 0) issue_ckpt(cn + 1, c - 1);
      }
      {
        float S[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) S[jj][ii] = E[0][jj][ii];
        }
#pragma unroll
        for (int q = 1; q + 1 < kSub; ++q) {
          if (q < steps) {
            const float2 wv = ld2(sl + OFF_W + (q - 1) * ROWS + jr);
            const float2 kv = ld2(sl + OFF_K + (q - 1) * ROWS + jr);
            const float4 vv = ld4(sl + OFF_V + (q - 1) * DH + i0);
            const float wr[2] = {wv.x, wv.y}, kr[2] = {kv.x, kv.y};
            const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
              for (int ii = 0; ii < 4; ++ii)
                S[jj][ii] = upd(S[jj][ii], wr[jj], kr[jj], vc[ii]);
            }
            if (q % 2 == 0) {
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
                for (int ii = 0; ii < 4; ++ii) E[q / 2][jj][ii] = S[jj][ii];
              }
            }
          }
        }
      }

      // the reverse recurrence; dr, dk, dw of each step reduced over the
      // row pair's lanes by rows at once, over steps after the sub-chunk;
      // dv over the warp's row pairs at once, each exchange halving the
      // columns a lane holds
      float acc[kSub][3], dvq[kSub][L::DVN];
#pragma unroll
      for (int q = kSub - 1; q >= 0; --q) {
        float pr[2] = {0.f, 0.f}, pk[2] = {0.f, 0.f}, pw[2] = {0.f, 0.f};
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        if (q < steps) {
          float Pq[2][4];
          if (q % 2 == 1) {
            const float2 kp = ld2(sl + OFF_K + (q - 1) * ROWS + jr);
            const float2 wp = ld2(sl + OFF_W + (q - 1) * ROWS + jr);
            const float4 vp = ld4(sl + OFF_V + (q - 1) * DH + i0);
            const float wr[2] = {wp.x, wp.y}, kr[2] = {kp.x, kp.y};
            const float vc[4] = {vp.x, vp.y, vp.z, vp.w};
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
              for (int ii = 0; ii < 4; ++ii)
                Pq[jj][ii] = upd(E[q / 2][jj][ii], wr[jj], kr[jj], vc[ii]);
            }
          } else {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
              for (int ii = 0; ii < 4; ++ii) Pq[jj][ii] = E[q / 2][jj][ii];
            }
          }
          const float2 kv = ld2(sl + OFF_K + q * ROWS + jr);
          const float2 wv = ld2(sl + OFF_W + q * ROWS + jr);
          const float4 vv = ld4(sl + OFF_V + q * DH + i0);
          const float2 rv = ld2(sl + q * ROWS + jr);
          const float4 yv = ld4(sl + OFF_DY + q * DH + i0);
          const float rr[2] = {rv.x, rv.y}, kr[2] = {kv.x, kv.y};
          const float wr[2] = {wv.x, wv.y};
          const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
          const float dc[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            pr[jj] = Pq[jj][0] * dc[0];
            pk[jj] = G[jj][0] * vc[0];
            pw[jj] = G[jj][0] * Pq[jj][0];
#pragma unroll
            for (int ii = 1; ii < 4; ++ii) {
              pr[jj] = fmaf(Pq[jj][ii], dc[ii], pr[jj]);
              pk[jj] = fmaf(G[jj][ii], vc[ii], pk[jj]);
              pw[jj] = fmaf(G[jj][ii], Pq[jj][ii], pw[jj]);
            }
          }
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            pv[ii] = fmaf(G[1][ii], kr[1], G[0][ii] * kr[0]);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
              G[jj][ii] = fmaf(wr[jj], G[jj][ii], rr[jj] * dc[ii]);
          }
        }
        acc[q][0] = scatter_add(pr[0], pr[1], lane, HALF);
        acc[q][1] = scatter_add(pk[0], pk[1], lane, HALF);
        acc[q][2] = scatter_add(pw[0], pw[1], lane, HALF);
#pragma unroll
        for (int m = CL, n = 2; m < 32; m <<= 1, n >>= 1) {
#pragma unroll
          for (int e = 0; e < n; ++e)
            pv[e] = scatter_add(pv[e], pv[e + n], lane, m);
        }
#pragma unroll
        for (int e = 0; e < L::DVN; ++e) dvq[q][e] = pv[e];
      }
      // the cluster's last arrivals are a sub-chunk old by now: dv of the
      // previous sub-chunk, and every warp of the block is past its sums
      if (nb > 0) flush_dv(ts + kSub, (nb - 1) & 1);
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        float* wq = wbuf + (warp * kSub + q) * DH + dvcol;
        if (L::DVN == 2)
          *reinterpret_cast<float2*>(wq) = make_float2(dvq[q][0], dvq[q][1]);
        else
          *wq = dvq[q][0];
      }
      // the step bits of the reduce-scatter, lowest first
#pragma unroll
      for (int lv = 0; lv < L::LV - 1; ++lv) {
#pragma unroll
        for (int q = 0; q < kSub; q += 2 << lv) {
#pragma unroll
          for (int a = 0; a < 3; ++a)
            acc[q][a] = scatter_add(acc[q][a], acc[q + (1 << lv)][a], lane,
                                    CL >> (lv + 2));
        }
      }
      // the lane's row and steps: the u terms, dr, dk, dw, du, and the
      // warp's rows' share of c_t
#pragma unroll
      for (int m = 0; m < L::QPL; ++m) {
        const int q = qlane + m * L::QSPAN;
        const float vdq = __shfl_sync(kAll, vd, 4 * q);
        const float rq = sl[q * ROWS + jl];
        const float kq = sl[OFF_K + q * ROWS + jl];
        float cj = 0.f;
        if (q < steps) {
          const long o = base + static_cast<long>(ts + q) * HD + row0 + jl;
          dr[o] = fmaf(uj * kq, vdq, acc[m * L::QSPAN][0]);
          dk[o] = fmaf(uj * rq, vdq, acc[m * L::QSPAN][1]);
          dw[o] = acc[m * L::QSPAN][2];
          du_acc[m] = fmaf(rq * kq, vdq, du_acc[m]);
          cj = rq * uj * kq;
        }
        cj += __shfl_xor_sync(kAll, cj, HALF);
#pragma unroll
        for (int mm = CL; mm < 32; mm <<= 1)
          cj += __shfl_xor_sync(kAll, cj, mm);
        if (jbit == 0 && rl == 0) wc[warp * kSub + q] = cj;
      }
      // dy of the dv this block writes, before the stage goes back
#pragma unroll
      for (int e = 0; e < L::NDV; ++e) {
        const int idx = tid + e * THREADS;
        dyv[e] = sl[OFF_DY + (idx / L::SLICE) * DH + grp * L::SLICE +
                    idx % L::SLICE];
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * st);
      __syncthreads();   // the warps' partials are in
      // each 16-row group's partial of this sub-chunk: its warps' in
      // warp order
      const int par = nb & 1;
      {
        const int g = tid / (kSub * DH / 4), rest = tid % (kSub * DH / 4);
        const int q = rest / (DH / 4), c4 = rest % (DH / 4);
        const int w0 = g * L::WPG;
        float* xg = xbuf + par * L::XB + g * L::XG;
        float4 a = ld4(wbuf + (w0 * kSub + q) * DH + 4 * c4);
#pragma unroll
        for (int ww = 1; ww < L::WPG; ++ww) {
          const float4 e = ld4(wbuf + ((w0 + ww) * kSub + q) * DH + 4 * c4);
          a.x += e.x; a.y += e.y; a.z += e.z; a.w += e.w;
        }
        *reinterpret_cast<float4*>(xg + q * DH + 4 * c4) = a;
        if (rest < kSub) {
          float cc = wc[w0 * kSub + rest];
#pragma unroll
          for (int ww = 1; ww < L::WPG; ++ww)
            cc += wc[(w0 + ww) * kSub + rest];
          xg[kSub * DH + rest] = cc;
        }
      }
      hopper::cluster_arrive();
    }
  }
  flush_dv(0, (nb - 1) & 1);
  // no block leaves while another may still read its partials
  hopper::cluster_arrive();
  hopper::cluster_wait();

#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
    *reinterpret_cast<float4*>(dstate0 + state_base + (row0 + jr + jj) * DH +
                               i0) =
        make_float4(G[jj][0], G[jj][1], G[jj][2], G[jj][3]);
  // du of the lane's row: its steps in order, then the row's lanes
  float dsum = du_acc[0];
#pragma unroll
  for (int m = 1; m < L::QPL; ++m) dsum += du_acc[m];
#pragma unroll
  for (int lv = 0; lv < L::LV - 1; ++lv)
    dsum += __shfl_xor_sync(kAll, dsum, CL >> (lv + 2));
  if (qlane == 0) du_part[static_cast<long>(bh) * DH + row0 + jl] = dsum;
}

// du = the batch's partials added in batch order
__global__ void wkv_bwd_du(const float* __restrict__ du_part,
                           float* __restrict__ du, int B, int HD) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HD) return;
  float acc = du_part[p];
  for (int bb = 1; bb < B; ++bb)
    acc += du_part[static_cast<long>(bb) * HD + p];
  du[p] = acc;
}

// The dynamic shared memory above 48 KB, once per device; and, once per
// host thread, the CUDA context bound to it: the tensor maps are encoded
// by a driver call, which needs one, and a thread that has made no runtime
// call yet (autograd's backward thread, when this is its first launch)
// has none.
template <int DH, int ROWS>
cudaError_t prepare(int device) {
  static bool ready[kMaxDevices];
  static thread_local bool bound = false;
  if (!bound) {
    const cudaError_t err = cudaFree(nullptr);
    if (err != cudaSuccess) return err;
    bound = true;
  }
  if (!ready[device]) {
    using L = Geo<DH, ROWS>;
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_kernel<DH, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes(ROWS == 32 ? kWideEvery : kMaxEvery)));
    if (err == cudaSuccess)   // all of L1 as shared memory
      err = cudaFuncSetAttribute(
          wkv_bwd_kernel<DH, ROWS>,
          cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  return cudaSuccess;
}

template <int DH, int ROWS>
cudaLaunchConfig_t config(int B, int H, int every, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  using L = Geo<DH, ROWS>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * L::GROUPS);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::bytes(every);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = L::GROUPS;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks of the kernel the card holds at once at this spacing (its
// clusters times their size); negative on failure.
template <int DH, int ROWS>
int resident(int every, int device) {
  if (prepare<DH, ROWS>(device) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config<DH, ROWS>(1, 1, every, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, wkv_bwd_kernel<DH, ROWS>,
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return clusters * Geo<DH, ROWS>::GROUPS;
}

template <int DH, int ROWS>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* ckpt, const float* dy,
           const float* dstate, float* dr, float* dk, float* dv, float* dw,
           float* du, float* dstate0, float* scratch, int B, int T_len,
           int H, int every, int device, cudaStream_t stream) {
  const cudaError_t ready = prepare<DH, ROWS>(device);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  CUtensorMap maps[5];
  const float* arrays[5] = {r, k, w, v, dy};
  for (int a = 0; a < 5; ++a)
    if (!hopper::make_map_f32(&maps[a], arrays[a], H * DH, T_len, B,
                              a < 3 ? ROWS : DH, kSub))
      return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config<DH, ROWS>(B, H, every, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wkv_bwd_kernel<DH, ROWS>, maps[0], maps[1], maps[2], maps[3],
      maps[4], u, ckpt, dstate, dr, dk, dv, dw, dstate0, scratch, T_len, H,
      every);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_du<<<(H * DH + 255) / 256, 256, 0, stream>>>(scratch, du, B,
                                                       H * DH);
  return 0;
}

// The block's rows: half a head (a cluster of two), except at dh = 64
// with checkpoints more than kWideEvery steps apart, whose sub-checkpoints
// would not fit two such blocks an SM: a quarter (a cluster of four).
// Both sum alike, so the gradients do not depend on the choice.
template <int DH>
int dispatch(int every, const float* r, const float* k, const float* v,
             const float* w, const float* u, const float* ckpt,
             const float* dy, const float* dstate, float* dr, float* dk,
             float* dv, float* dw, float* du, float* dstate0, float* scratch,
             int B, int T_len, int H, int device, cudaStream_t stream) {
  if (DH == 64 && every > kWideEvery)
    return launch<DH, 16>(r, k, v, w, u, ckpt, dy, dstate, dr, dk, dv, dw,
                          du, dstate0, scratch, B, T_len, H, every, device,
                          stream);
  return launch<DH, DH / 2>(r, k, v, w, u, ckpt, dy, dstate, dr, dk, dv, dw,
                            du, dstate0, scratch, B, T_len, H, every,
                            device, stream);
}

}  // namespace

// Blocks of the kernel at head size dh the current device holds at once
// with checkpoints `every` steps apart; negative on failure.
extern "C" int rwkv6_scan_bwd_resident(int dh, int every) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 ||
      device >= kMaxDevices || every <= 0 || every % kSub != 0 ||
      every > kMaxEvery)
    return -1;
  if (dh == 32) return resident<32, 16>(every, device);
  if (dh != 64) return -1;
  return every > kWideEvery ? resident<64, 16>(every, device)
                            : resident<64, 32>(every, device);
}

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
      code = dispatch<32>(every, f(r), f(k), f(v), f(w), f(u), f(ckpt),
                          f(dy), f(dstate), m(dr), m(dk), m(dv), m(dw),
                          m(du), m(dstate0), m(scratch), B, T_len, H, device,
                          stream);
      break;
    case 64:
      code = dispatch<64>(every, f(r), f(k), f(v), f(w), f(u), f(ckpt),
                          f(dy), f(dstate), m(dr), m(dk), m(dv), m(dw),
                          m(du), m(dstate0), m(scratch), B, T_len, H, device,
                          stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}
