// Backward of the fused RMSNorm (rmsnorm.cu) over the rows of a (rows, d)
// matrix, for sm_90a.
//
// Replaces jax.grad of src/repro/models/common.py::norm_apply (the JAX
// package differentiates its norm as plain jnp; the Pallas kernel has no
// backward).  With r = rsqrt(mean(x32^2) + eps) and a = x32 * r, the
// forward in either of rmsnorm.cu's cast orders (a template parameter
// here too, chosen by the `order` argument):
//   * 0, the TPU kernel's (kernels/ref.py rmsnorm_plain):
//     y = cast(a * w32); g = dy32 * w32 and dw sums dy32 * a;
//   * 1, cast first (rmsnorm_cast_first_plain, the JAX package's model):
//     y = cast(cast(a) * w32), a multiply in the input's type, whose
//     autograd rounds both its products to that type: g = cast(dy32 *
//     w32) before the normalization's backward, and each row's term
//     cast(dy32 * cast(a)) before dw sums it (unrounded, dw would be
//     another sum than the one that autograd of the plain version
//     takes);
// then, in both,
//   dx = r * (g - x32 * r^2 * mean(g * x32)),   cast to x's type;
//   dw = the sum over rows above,               cast to w's type last.
//
// Bound: bytes.  x and dy are read once and dx written once (6 bytes an
// element in bf16, 12 in fp32), w once, dw once; the rest is a handful
// of flops an element.  The design is the forward's with half the
// vectors a thread: a team of W warps a row (one warp up to 2 KB of row,
// every qk-norm width; 2 warps at bf16 d = 2048; up to 16 at fp32
// d = 8192), V <= 4 vectors of 16 bytes of x, dy and w a thread held in
// registers (8, with the thread's fp32 share of dw beside them, spilled),
// 16-byte loads and stores when d is a multiple of the vector width and
// every pointer is 16-byte aligned (else element by element in the same
// slots), on a persistent grid whose teams walk rows with a grid-sized
// stride.  Each thread also keeps its slots' share of dw in fp32
// registers over all its rows.  dw is summed without atomics, so
// repeated launches give the same bits:
//   1. rows_kernel: dx per row; at the end the teams of a block add
//      their dw slots in team order into shared memory and the block
//      writes one fp32 partial row to `partial` (blocks, d);
//   2. dw_kernel: a thread per column sums the blocks' partials in block
//      order and casts.
// The grid's size is fixed per device and shape (the blocks that fit on
// the card at once, at most max_blocks), so the order is too.
//
// C interface (ctypes): rmsnorm_bwd_launch(x, w, dy, dx, dw, partial,
// rows, d, eps, max_blocks, order, dtype, stream) with order as the
// forward's (0 = the TPU kernel's, 1 = cast first), dtype 0 = float32,
// 1 = bfloat16 (x, w, dy, dx, dw share it), 1 <= d <= 8192, partial an
// fp32 buffer of max_blocks * d.  Returns cudaGetLastError() after the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVecs = 4;  // 16-byte vectors per thread and row
constexpr int kMaxD = 8192;
constexpr int kMaxDevices = 64;

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kPerVec = 4;
  __device__ __forceinline__ static float get(const uint4& u, int e) {
    return __uint_as_float((&u.x)[e]);
  }
  __device__ __forceinline__ static void set(uint4& u, int e, float f) {
    (&u.x)[e] = __float_as_uint(f);
  }
  __device__ __forceinline__ static uint32_t raw(const float* p, int i) {
    return __float_as_uint(__ldg(p + i));
  }
  __device__ __forceinline__ static void put_raw(uint4& u, int e,
                                                 uint32_t bits) {
    (&u.x)[e] = bits;
  }
  __device__ __forceinline__ static void store(float* p, int i,
                                               const uint4& u, int e) {
    p[i] = get(u, e);
  }
  __device__ __forceinline__ static float cast(float f) { return f; }
  __device__ __forceinline__ static float rounded(float f) { return f; }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  __device__ __forceinline__ static float get(const uint4& u, int e) {
    const uint32_t word = (&u.x)[e >> 1];
    return __uint_as_float((e & 1) ? (word & 0xFFFF0000u) : (word << 16));
  }
  __device__ __forceinline__ static void set(uint4& u, int e, float f) {
    put_raw(u, e, __bfloat16_as_ushort(__float2bfloat16(f)));  // nearest
  }
  __device__ __forceinline__ static uint32_t raw(const __nv_bfloat16* p,
                                                 int i) {
    return __bfloat16_as_ushort(__ldg(p + i));
  }
  __device__ __forceinline__ static void put_raw(uint4& u, int e,
                                                 uint32_t bits) {
    uint32_t& word = (&u.x)[e >> 1];
    word = (e & 1) ? ((word & 0xFFFFu) | (bits << 16))
                   : ((word & 0xFFFF0000u) | bits);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, int i,
                                               const uint4& u, int e) {
    const uint32_t word = (&u.x)[e >> 1];
    p[i] = __ushort_as_bfloat16(
        static_cast<unsigned short>((e & 1) ? (word >> 16) : word));
  }
  __device__ __forceinline__ static __nv_bfloat16 cast(float f) {
    return __float2bfloat16(f);
  }
  // f rounded to the nearest bf16 value, as fp32
  __device__ __forceinline__ static float rounded(float f) {
    return __bfloat162float(__float2bfloat16(f));
  }
};

// The column of slot (i, e) of thread `tid` in a team of TT threads:
// (i * TT + tid) * N + e with 16-byte vectors, (i * N + e) * TT + tid
// element by element (the forward's slots).
template <int N, int TT>
__device__ __forceinline__ int column(int i, int e, int tid, bool vec) {
  return vec ? (i * TT + tid) * N + e : (i * N + e) * TT + tid;
}

template <typename T, int V, int TT>
__device__ __forceinline__ void load_row(uint4 (&r)[V],
                                         const T* __restrict__ p, int d,
                                         int tid, bool vec) {
  constexpr int N = Elem<T>::kPerVec;
  if (vec) {
    const uint4* pv = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = i * TT + tid;
      r[i] = j * N < d ? __ldg(pv + j) : make_uint4(0, 0, 0, 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      r[i] = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int c = (i * N + e) * TT + tid;
        if (c < d) Elem<T>::put_raw(r[i], e, Elem<T>::raw(p, c));
      }
    }
  }
}

template <typename T, int V, int TT>
__device__ __forceinline__ void store_row(const uint4 (&r)[V],
                                          T* __restrict__ p, int d, int tid,
                                          bool vec) {
  constexpr int N = Elem<T>::kPerVec;
  if (vec) {
    uint4* pv = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = i * TT + tid;
      if (j * N < d) pv[j] = r[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int c = (i * N + e) * TT + tid;
        if (c < d) Elem<T>::store(p, c, r[i], e);
      }
  }
}

template <int W>
__host__ __device__ constexpr int threads() { return W == 1 ? 256 : 32 * W; }

// sum over the TT threads of a team (W warps): warp shuffles, then the
// team's warps in order through `buf` (W > 1: the block is one team)
template <int W>
__device__ __forceinline__ float team_sum(float v, float* buf, int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (W > 1) {
    __syncthreads();  // the previous use of buf is read
    if ((tid & 31) == 0) buf[tid >> 5] = v;
    __syncthreads();
    v = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) v += buf[k];
  }
  return v;
}

template <typename T, int W, int V, bool kCastFirst>
__global__ void __launch_bounds__(threads<W>(), 1)
rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ dy, T* __restrict__ dx,
            float* __restrict__ partial, int rows, int d, float eps,
            bool vec) {
  constexpr int N = Elem<T>::kPerVec;
  constexpr int TT = 32 * W;                  // threads of a team
  constexpr int kTeams = threads<W>() / TT;   // teams of a block
  extern __shared__ float dw_block[];         // d floats (one-warp teams)
  __shared__ float buf[W];
  const int tid = threadIdx.x % TT, team = threadIdx.x / TT;
  const int stride = gridDim.x * kTeams;
  const float inv_d = 1.f / static_cast<float>(d);

  uint4 wv[V], xv[V], gv[V];
  float acc[V][N];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[i][e] = 0.f;
  load_row<T, V, TT>(wv, w, d, tid, vec);
  for (int row = blockIdx.x * kTeams + team; row < rows; row += stride) {
    load_row<T, V, TT>(xv, x + long(row) * d, d, tid, vec);
    load_row<T, V, TT>(gv, dy + long(row) * d, d, tid, vec);
    // the gradient at a: dy * w, rounded first in cast-first order
    auto grad_a = [&](int i, int e) {
      const float g = Elem<T>::get(gv[i], e) * Elem<T>::get(wv[i], e);
      return kCastFirst ? Elem<T>::rounded(g) : g;
    };
    float sq = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float f = Elem<T>::get(xv[i], e);
        sq = fmaf(f, f, sq);
        gx = fmaf(grad_a(i, e), f, gx);
      }
    sq = team_sum<W>(sq, buf, tid);
    gx = team_sum<W>(gx, buf, tid);
    const float r = rsqrtf(sq * inv_d + eps);
    const float c = r * r * gx * inv_d;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float f = Elem<T>::get(xv[i], e);
        const float dy = Elem<T>::get(gv[i], e);
        const float ga = grad_a(i, e);
        if constexpr (kCastFirst)
          acc[i][e] += Elem<T>::rounded(dy * Elem<T>::rounded(f * r));
        else
          acc[i][e] = fmaf(dy, f * r, acc[i][e]);
        Elem<T>::set(gv[i], e, r * (ga - f * c));
      }
    store_row<T, V, TT>(gv, dx + long(row) * d, d, tid, vec);
  }

  // this block's dw: its teams' slots added in team order
  float* out = partial + long(blockIdx.x) * d;
  for (int t = 0; t < kTeams; ++t) {
    if (team == t) {
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const int col = column<N, TT>(i, e, tid, vec);
          if (col < d) {
            if (kTeams == 1)
              out[col] = acc[i][e];
            else
              dw_block[col] = t == 0 ? acc[i][e] : dw_block[col] + acc[i][e];
          }
        }
    }
    if (kTeams > 1) __syncthreads();
  }
  if (kTeams > 1)
    for (int col = threadIdx.x; col < d; col += threads<W>())
      out[col] = dw_block[col];
}

template <typename T>
__global__ void __launch_bounds__(256)
dw_kernel(const float* __restrict__ partial, T* __restrict__ dw, int blocks,
          int d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[long(b) * d + col];
  dw[col] = Elem<T>::cast(s);
}

int sm_count(int dev) {
  static int counts[kMaxDevices];
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return counts[dev];
}

template <typename T, int W, int V, bool kCastFirst>
int launch_order(const void* x, const void* w, const void* dy, void* dx,
                 void* dw, float* partial, int rows, int d, float eps,
                 int max_blocks, bool vec, int dev, cudaStream_t stream) {
  constexpr int kTeams = threads<W>() / (32 * W);
  const int smem = kTeams > 1 ? d * static_cast<int>(sizeof(float)) : 0;
  static int per_sm[kMaxDevices];
  int& fit = per_sm[dev];
  if (fit == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, rows_kernel<T, W, V, kCastFirst>, threads<W>(),
          kTeams > 1 ? kMaxD * sizeof(float) : 0) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long wanted = (static_cast<long>(rows) + kTeams - 1) / kTeams;
  long blocks = static_cast<long>(sm_count(dev)) * (fit > 0 ? fit : 1);
  if (wanted < blocks) blocks = wanted;
  if (max_blocks < blocks) blocks = max_blocks;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<T, W, V, kCastFirst>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rows_kernel<T, W, V, kCastFirst><<<static_cast<int>(blocks), threads<W>(),
                                     smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), partial, rows, d, eps,
      vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<T><<<(d + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<T*>(dw), static_cast<int>(blocks), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W, int V>
int launch(const void* x, const void* w, const void* dy, void* dx, void* dw,
           float* partial, int rows, int d, float eps, int max_blocks,
           int order, bool vec, int dev, cudaStream_t stream) {
  if (order == 1)
    return launch_order<T, W, V, true>(x, w, dy, dx, dw, partial, rows, d,
                                       eps, max_blocks, vec, dev, stream);
  return launch_order<T, W, V, false>(x, w, dy, dx, dw, partial, rows, d,
                                      eps, max_blocks, vec, dev, stream);
}

template <typename T>
int dispatch(const void* x, const void* w, const void* dy, void* dx,
             void* dw, float* partial, int rows, int d, float eps,
             int max_blocks, int order, cudaStream_t stream) {
  constexpr int N = Elem<T>::kPerVec;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const bool vec = d % N == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(dy) |
                     reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
#define REPRO_LAUNCH(W, V)                                                   \
  return launch<T, W, V>(x, w, dy, dx, dw, partial, rows, d, eps,            \
                         max_blocks, order, vec, dev, stream)
  if (d <= 32 * N) REPRO_LAUNCH(1, 1);
  if (d <= 64 * N) REPRO_LAUNCH(1, 2);
  if (d <= 128 * N) REPRO_LAUNCH(1, 4);
  if (d <= 256 * N) REPRO_LAUNCH(2, 4);
  if (d <= 512 * N) REPRO_LAUNCH(4, 4);
  // the widest team a row of kMaxD takes: 8 warps in bf16, 16 in fp32
  constexpr int kWidest = kMaxD / (32 * kMaxVecs * N);
  if (d <= 1024 * N) REPRO_LAUNCH(8, 4);
  REPRO_LAUNCH(kWidest, kMaxVecs);
#undef REPRO_LAUNCH
}

}  // namespace

extern "C" int rmsnorm_bwd_launch(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  float* partial, int rows, int d, float eps,
                                  int max_blocks, int order, int dtype,
                                  cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || max_blocks <= 0 ||
      (order != 0 && order != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(x, w, dy, dx, dw, partial, rows, d, eps,
                           max_blocks, order, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, dy, dx, dw, partial, rows, d, eps,
                                   max_blocks, order, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
