// The RWKV6 "Finch" WKV recurrence over a whole sequence, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan_pallas
// (body _wkv_kernel).  Per (batch, head), with the (dh x dh) fp32 state S,
// bonus u and data-dependent decay w_t:
//
//   y_t[i] = sum_j r_t[j] * (S[j][i] + u[j] * k_t[j] * v_t[i])
//   S[j][i] = w_t[j] * S[j][i] + k_t[j] * v_t[i]
//
// r/k/v/w are (B, T, H, dh) and y the same; u is (H, dh) fp32; the state
// (B, H, dh, dh) is read at the start (zeros without one) and written at
// the end.
//
// Bound.  Four input streams and y pass once through device memory
// (5 * B*T*H*dh values) plus the state in and out.  The state update must
// round its two products and their sum separately to stay bit-equal to the
// plain version (three fp32 instructions, no FMA), and y's term is a fourth
// (an FMA), so every state element costs four instructions a step: over an
// H100's 132 x 128 fp32 lanes at ~1.98 GHz that issue floor is above the
// byte bound at dh = 64 (0.385 ms against 0.301 ms at B*T*H = 4*6144*32).
// The recurrence is serial in T, so the design's job is to spread each
// step's dh*dh independent element updates over enough lanes and keep the
// per-step work down to those four instructions.
//
// Design.  A block owns one (batch, head) and a group of COLS of its dh
// value columns; the columns of S are independent, so a head's columns
// split over dh / COLS blocks without changing any state value.  The split
// is chosen by shape (choose_split): the fewest groups that put about one
// block on each SM, so a batch of one (B*H = 32 at rwkv6-1.6b) runs 4
// groups of 16 columns in 128 blocks, and B*H = 128 whole heads in 128
// blocks.  Each thread holds a JT x IT tile of S in registers (8 x 2 in a
// whole head of 64, 4 x 2 in a split one): one load of its rows of r, k
// and w serves its IT columns.  The rows of a column are split over
// NG = dh / JT row groups, spread over the lanes and the warps of the
// block; in a whole head every lane of a warp reads the same rows, a
// broadcast from shared memory.  Each step a thread writes its IT partial
// sums of y to shared memory; one stage later (while the next stage's
// recurrence runs) the block adds the NG partials of each element
// pairwise, adds c_t * v_i and stores y in 16-byte pieces, so no shuffle
// chain sits in the recurrence and one barrier a stage orders it all.
// The bonus scalar c_t = sum_j r_j u_j k_j is computed once per step by
// eight lanes in a fixed order (lane q takes j = q, q + 8, ...; an
// xor-shuffle tree adds the eight), the same in every block and every
// launch shape.  Steps are staged TS at a time (TS * dh = 1024 values of
// each of r, k, w, and the block's columns of v) into a ring of kRing
// stages in shared memory with 16-byte cp.async, kAhead stages in flight.
// The state update rounds w * S, k * v and their sum separately
// (__fmul_rn / __fadd_rn: nvcc would otherwise contract them into an FMA),
// as the plain PyTorch version's three ops do, so the final state is
// bit-equal to it; only y's sum runs in another order.  Each block reads
// its own columns of state_in before it writes the same columns of
// state_out, so the two may be one buffer.
//
// Checkpoints.  Under autograd the wrapper passes a checkpoint buffer
// (B, H, ceil(T / every), dh, dh) fp32: at the start of every stage whose
// first step t is a multiple of `every` (a multiple of the stage's TS
// steps), each thread writes its tile of the state before step t, so
// checkpoint c is the state before step c * every (checkpoint 0 the
// initial state).  The backward kernel (rwkv6_scan_bwd.cu) recomputes
// each chunk's states from them in the same rounding, so they equal the
// forward's bit for bit.  Serving passes null: one untaken branch a stage.
//
// C interface (ctypes): rwkv6_scan_launch(r, k, v, w, u, state_in,
// y, state_out, ckpt, B, T, H, dh, dtype, every, stream); dtype 0 =
// float32, 1 = bfloat16 (r, k, v, w and y share it; u, the states and the
// checkpoints are fp32); state_in may be null (zeros) and may equal
// state_out; ckpt may be null (no checkpoints; `every` is then not read).
// r/k/v/w/y must be 16-byte aligned; dh is 32 (the smoke configs) or 64
// (rwkv6-1.6b); `every` a positive multiple of 1024 / dh.
// Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStageValues = 1024;  // TS * dh values of r, k and w a stage
constexpr int kMinCols = 8;         // 16 bytes of bf16 v and y a step
constexpr int kRing = 4;            // stages in shared memory
constexpr int kAhead = kRing - 2;   // stages in flight ahead of the one run
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive values from shared memory, aligned to their size
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      out[i] = q.x; out[i + 1] = q.y; out[i + 2] = q.z; out[i + 3] = q.w;
    }
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out[0] = q.x; out[1] = q.y;
  } else {
    out[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float* out) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + i);
      const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 h;
        *reinterpret_cast<unsigned*>(&h) = words[e];
        const float2 f = __bfloat1622float2(h);
        out[i + 2 * e] = f.x; out[i + 2 * e + 1] = f.y;
      }
    }
  } else if constexpr (N >= 2) {
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(q[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  } else {
    out[0] = __bfloat162float(*p);
  }
}

// N (1 or 2) fp32 values to shared memory, aligned to their size
template <int N>
__device__ __forceinline__ void store_vals(float* p, const float* v) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// 16 bytes of y: 4 fp32 or 8 bf16 values (round to nearest even)
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 q;
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i],
                                                           v[2 * i + 1]);
  q.x = *reinterpret_cast<unsigned*>(&h[0]);
  q.y = *reinterpret_cast<unsigned*>(&h[1]);
  q.z = *reinterpret_cast<unsigned*>(&h[2]);
  q.w = *reinterpret_cast<unsigned*>(&h[3]);
  *reinterpret_cast<uint4*>(p) = q;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The geometry of a block that owns COLS value columns of one head, each
// thread a JT x IT tile of them.
template <typename T, int DH, int COLS, int JT, int IT>
struct Tile {
  static constexpr int TS = kStageValues / DH;          // steps a stage
  static constexpr int NIL = COLS / IT;                 // lanes over columns
  static constexpr int NJL = 32 / NIL;                  // lanes over rows
  static constexpr int NG = DH / JT;                    // row groups
  static constexpr int WARPS = NG / NJL;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int VEC = 16 / sizeof(T);            // values a piece
  // shared memory: a ring of kRing stages of r, k, w (all dh columns) and
  // v (the block's columns); two stages of partial sums and bonus scalars
  static constexpr int RKW_BYTES = kRing * 3 * TS * DH * sizeof(T);
  static constexpr int V_BYTES = kRing * TS * COLS * sizeof(T);
  static constexpr int PART_BYTES = 2 * TS * NG * COLS * 4;
  static constexpr int SMEM_BYTES =
      RKW_BYTES + V_BYTES + PART_BYTES + (DH + 2 * TS) * 4;
  static_assert(NIL * NJL == 32 && NG % NJL == 0 && COLS >= VEC,
                "tile does not map onto whole warps");
};

// (one block an SM: the registers a thread may take are not capped for
// occupancy, so none of the tile, the staged operands or the partials
// spill)
template <typename T, int DH, int COLS, int JT, int IT>
__global__ void __launch_bounds__(Tile<T, DH, COLS, JT, IT>::THREADS, 1)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const float* __restrict__ u, const float* state_in,
           T* __restrict__ y, float* state_out, float* __restrict__ ckpt,
           int T_len, int H, int every) {
  using L = Tile<T, DH, COLS, JT, IT>;
  constexpr int TS = L::TS, NIL = L::NIL;
  constexpr int NJL = L::NJL, NG = L::NG, THREADS = L::THREADS;
  constexpr int VEC = L::VEC;
  constexpr int kGroups = DH / COLS;
  constexpr int kRowPieces = DH / VEC;    // 16-byte pieces of a row of r
  constexpr int kColPieces = COLS / VEC;  // of the block's columns of v, y
  extern __shared__ __align__(16) unsigned char smem[];
  auto rkw = reinterpret_cast<T (*)[3][TS][DH]>(smem);
  auto vs = reinterpret_cast<T (*)[TS][COLS]>(smem + L::RKW_BYTES);
  auto part = reinterpret_cast<float (*)[TS][NG][COLS]>(
      smem + L::RKW_BYTES + L::V_BYTES);
  float* us = reinterpret_cast<float*>(smem + L::RKW_BYTES + L::V_BYTES +
                                       L::PART_BYTES);
  auto cs = reinterpret_cast<float (*)[TS]>(us + DH);

  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.x / kGroups;                  // b * H + h
  const int c0 = (blockIdx.x - bh * kGroups) * COLS;    // first column
  const int b = bh / H, h = bh - b * H;
  const int jl = lane / NIL, il = lane - jl * NIL;
  const int g = (tid >> 5) * NJL + jl;                  // row group
  const int j0 = g * JT, i0 = il * IT;                  // i0 within COLS
  const long row_stride = static_cast<long>(H) * DH;    // one step
  const long base = (static_cast<long>(b) * T_len * H + h) * DH;
  const int n_chunks = (T_len + TS - 1) / TS;
  auto steps_of = [&](int chunk) { return min(TS, T_len - chunk * TS); };

  // one copy group a call; past the last stage an empty one, so that a
  // stage is always kAhead groups old when it is waited for
  auto stage = [&](int chunk) {
    if (chunk >= n_chunks) {
      cp_async_commit();
      return;
    }
    const int buf = chunk % kRing, t0 = chunk * TS, steps = steps_of(chunk);
    for (int p = tid; p < steps * 3 * kRowPieces; p += THREADS) {
      const int s = p / (3 * kRowPieces);
      const int a = (p / kRowPieces) % 3;
      const int q = p % kRowPieces;
      const T* src = a == 0 ? r : (a == 1 ? k : w);
      cp_async16(&rkw[buf][a][s][q * VEC],
                 src + base + (t0 + s) * row_stride + q * VEC);
    }
    for (int p = tid; p < steps * kColPieces; p += THREADS) {
      const int s = p / kColPieces, q = p % kColPieces;
      cp_async16(&vs[buf][s][q * VEC],
                 v + base + (t0 + s) * row_stride + c0 + q * VEC);
    }
    cp_async_commit();
  };

  for (int chunk = 0; chunk < kAhead; ++chunk) stage(chunk);
  for (int j = tid; j < DH; j += THREADS) us[j] = u[h * DH + j];

  float S[JT][IT];
  const int tile = (bh * DH + j0) * DH + c0 + i0;   // the launch checks it fits
#pragma unroll
  for (int jj = 0; jj < JT; ++jj) {
#pragma unroll
    for (int ii = 0; ii < IT; ++ii)
      S[jj][ii] = state_in ? state_in[tile + jj * DH + ii] : 0.f;
  }

  // Iteration `chunk` runs the recurrence of that stage and writes y of
  // the one before, so one barrier a stage orders the copies in flight,
  // the partials being summed and those being written.
  for (int chunk = 0; chunk <= n_chunks; ++chunk) {
    cp_async_wait<kAhead - 1>();
    __syncthreads();    // stage `chunk` landed; the partials of the last
                        // stage are complete; the slot of chunk - 2, which
                        // the next copy overwrites, has no reader left
    stage(chunk + kAhead);

    if (chunk < n_chunks) {
      const int buf = chunk % kRing, pb = chunk & 1;
      const int steps = steps_of(chunk);
      if (ckpt != nullptr && (chunk * TS) % every == 0) {
        // the state before this stage's first step
        const int n_ckpt = (T_len + every - 1) / every;
        float* dst = ckpt + (static_cast<long>(bh) * n_ckpt +
                             chunk * TS / every) * DH * DH +
                     j0 * DH + c0 + i0;
#pragma unroll
        for (int jj = 0; jj < JT; ++jj) {
#pragma unroll
          for (int ii = 0; ii < IT; ++ii) dst[jj * DH + ii] = S[jj][ii];
        }
      }
      // the bonus scalar of each step: eight lanes, j = q, q + 8, ...
      for (int s = tid >> 3; s < steps; s += THREADS / 8) {
        const int q = tid & 7;
        const unsigned group = 0xffu << (lane & 24);
        float acc = 0.f;
#pragma unroll
        for (int jj = 0; jj < DH / 8; ++jj) {
          const int j = jj * 8 + q;
          acc = fmaf(to_f32(rkw[buf][0][s][j]) * us[j],
                     to_f32(rkw[buf][1][s][j]), acc);
        }
        acc += __shfl_xor_sync(group, acc, 4);
        acc += __shfl_xor_sync(group, acc, 2);
        acc += __shfl_xor_sync(group, acc, 1);
        if (q == 0) cs[pb][s] = acc;
      }

      // the recurrence: this thread's JT x IT elements and their partial
      // y sums, the next step's r, k, w and v loaded during this one's
      float rr[JT], kk[JT], ww[JT], vv[IT];
      auto load_step = [&](int s, float* r_, float* k_, float* w_,
                           float* v_) {
        load_vals<JT>(&rkw[buf][0][s][j0], r_);
        load_vals<JT>(&rkw[buf][1][s][j0], k_);
        load_vals<JT>(&rkw[buf][2][s][j0], w_);
        load_vals<IT>(&vs[buf][s][i0], v_);
      };
      load_step(0, rr, kk, ww, vv);
#pragma unroll 2
      for (int s = 0; s < steps; ++s) {
        float nr[JT], nk[JT], nw[JT], nv[IT];
        load_step(s + 1 < steps ? s + 1 : s, nr, nk, nw, nv);
        float acc[2][IT];   // two chains of the rows, even and odd
#pragma unroll
        for (int ii = 0; ii < IT; ++ii) acc[0][ii] = acc[1][ii] = 0.f;
#pragma unroll
        for (int jj = 0; jj < JT; ++jj) {
#pragma unroll
          for (int ii = 0; ii < IT; ++ii) {
            acc[jj & 1][ii] = fmaf(rr[jj], S[jj][ii], acc[jj & 1][ii]);
            S[jj][ii] = __fadd_rn(__fmul_rn(ww[jj], S[jj][ii]),
                                  __fmul_rn(kk[jj], vv[ii]));
          }
        }
        float sum[IT];
#pragma unroll
        for (int ii = 0; ii < IT; ++ii) sum[ii] = acc[0][ii] + acc[1][ii];
        store_vals<IT>(&part[pb][s][g][i0], sum);
#pragma unroll
        for (int jj = 0; jj < JT; ++jj) {
          rr[jj] = nr[jj]; kk[jj] = nk[jj]; ww[jj] = nw[jj];
        }
#pragma unroll
        for (int ii = 0; ii < IT; ++ii) vv[ii] = nv[ii];
      }
    }

    // y of the stage before: the NG partials of each element added
    // pairwise, plus c_t * v_i, stored 16 bytes at a time
    if (chunk > 0) {
      const int prev = chunk - 1, buf = prev % kRing, pb = prev & 1;
      const int t0 = prev * TS, steps = steps_of(prev);
      for (int p = tid; p < steps * kColPieces; p += THREADS) {
        const int s = p / kColPieces, col = (p % kColPieces) * VEC;
        float vv[VEC], out[VEC];
        load_vals<VEC>(&vs[buf][s][col], vv);
        const float c = cs[pb][s];
#pragma unroll
        for (int e0 = 0; e0 < VEC; e0 += 4) {   // 4 values at a time
          float sums[NG / 2][4];                 // the tree's first level
#pragma unroll
          for (int gg = 0; gg < NG / 2; ++gg) {
            float odd[4];
            load_vals<4>(&part[pb][s][2 * gg][col + e0], sums[gg]);
            load_vals<4>(&part[pb][s][2 * gg + 1][col + e0], odd);
#pragma unroll
            for (int e = 0; e < 4; ++e) sums[gg][e] += odd[e];
          }
#pragma unroll
          for (int span = 1; span < NG / 2; span *= 2) {
#pragma unroll
            for (int gg = 0; gg < NG / 2; gg += 2 * span) {
#pragma unroll
              for (int e = 0; e < 4; ++e) sums[gg][e] += sums[gg + span][e];
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            out[e0 + e] = fmaf(c, vv[e0 + e], sums[0][e]);
        }
        store16(y + base + (t0 + s) * row_stride + c0 + col, out);
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < JT; ++jj) {
#pragma unroll
    for (int ii = 0; ii < IT; ++ii) state_out[tile + jj * DH + ii] = S[jj][ii];
  }
}

// How a launch splits a head: COLS value columns a block, JT rows a
// thread.
struct Split {
  int cols, jt, it;
};

// The split of B*H heads of dh: the column groups double while the blocks
// would still put at most one on each SM, down to kMinCols columns.  A
// whole head gives each thread 8 rows (by 2 columns at dh = 64); a split
// head, whose blocks hold few elements, 4 rows by 2 columns, so that its
// threads still fill a block of 4 warps or more at dh = 64.
Split choose_split(int heads, int dh, int sms) {
  int groups = 1;
  while (dh / (2 * groups) >= kMinCols &&
         2L * heads * groups <= static_cast<long>(sms))
    groups *= 2;
  if (groups == 1) return {dh, 8, dh == 64 ? 2 : 1};
  return {dh / groups, 4, 2};
}

template <typename T, int DH, int COLS, int JT, int IT>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s_in, void* y, float* s_out,
           float* ckpt, int B, int T_len, int H, int every, int device,
           cudaStream_t stream) {
  using L = Tile<T, DH, COLS, JT, IT>;
  static bool ready[kMaxDevices];   // dynamic shared memory above 48 KB
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<T, DH, COLS, JT, IT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  wkv_kernel<T, DH, COLS, JT, IT>
      <<<B * H * (DH / COLS), L::THREADS, L::SMEM_BYTES, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s_in,
      static_cast<T*>(y), s_out, ckpt, T_len, H, every);
  return 0;
}

// whether a tile maps onto whole warps at head size DH
template <int DH, int C, int J, int I>
constexpr bool tiles() {
  return C <= DH && C % I == 0 && C / I <= 32 && 32 % (C / I) == 0 &&
         (DH / J) % (32 / (C / I)) == 0;
}

template <typename T, int DH>
int launch_split(Split split, const void* r, const void* k, const void* v,
                 const void* w, const float* u, const float* s_in, void* y,
                 float* s_out, float* ckpt, int B, int T_len, int H,
                 int every, int device, cudaStream_t stream) {
#define WKV_SPLIT(C, J, I)                                                 \
  if constexpr (tiles<DH, C, J, I>() && (C == DH) == (J == 8)) {           \
    if (split.cols == C && split.jt == J && split.it == I)                 \
      return launch<T, DH, C, J, I>(r, k, v, w, u, s_in, y, s_out, ckpt,   \
                                    B, T_len, H, every, device, stream);   \
  }
  WKV_SPLIT(64, 8, 2)
  WKV_SPLIT(32, 8, 1)
  WKV_SPLIT(32, 4, 2)
  WKV_SPLIT(16, 4, 2)
  WKV_SPLIT(8, 4, 2)
#undef WKV_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_dh(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* s_in, void* y, float* s_out,
              float* ckpt, int B, int T_len, int H, int dh, int every,
              int sms, int device, cudaStream_t stream) {
  const Split split = choose_split(B * H, dh, sms);
  switch (dh) {
    case 32: return launch_split<T, 32>(split, r, k, v, w, u, s_in, y,
                                        s_out, ckpt, B, T_len, H, every,
                                        device, stream);
    case 64: return launch_split<T, 64>(split, r, k, v, w, u, s_in, y,
                                        s_out, ckpt, B, T_len, H, every,
                                        device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* state_in, void* y,
                                 void* state_out, void* ckpt, int B,
                                 int T_len, int H, int dh, int dtype,
                                 int every, cudaStream_t stream) {
  // the kernel indexes the states with 32-bit offsets
  if (B <= 0 || T_len <= 0 || H <= 0 || dh <= 0 ||
      static_cast<long>(B) * H * dh * dh > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ckpt != nullptr && (every <= 0 || every % (kStageValues / dh) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(state_in);
  float* so = static_cast<float*>(state_out);
  float* ck = static_cast<float*>(ckpt);
  int code;
  if (dtype == 0)
    code = launch_dh<float>(r, k, v, w, uf, si, y, so, ck, B, T_len, H, dh,
                            every, sms[device], device, stream);
  else if (dtype == 1)
    code = launch_dh<__nv_bfloat16>(r, k, v, w, uf, si, y, so, ck, B, T_len,
                                    H, dh, every, sms[device], device,
                                    stream);
  else
    code = static_cast<int>(cudaErrorInvalidValue);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}
