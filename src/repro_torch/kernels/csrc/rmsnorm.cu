// Fused RMSNorm over the rows of a (rows, d) matrix, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas.
// out = x * rsqrt(mean(x^2) + eps) * w, computed in fp32, in one of two
// cast orders (a template parameter, chosen by the `order` argument):
//   * 0, the TPU kernel's: the weight is multiplied in fp32 and the
//     product cast to the output type last (ops.rmsnorm);
//   * 1, cast first, the JAX package's model (models/common.py
//     norm_apply): x * rsqrt(...) is rounded to the output type, then
//     multiplied by the weight in fp32 and rounded again, which is the
//     product a bf16 multiply gives (the product of two bf16 values is
//     exact in fp32).  In fp32 the two orders are one computation.
// Only the order of the sum of squares is the kernel's own: each
// thread's slots in turn with Kahan compensation, then the warp's
// butterfly, then the row's warps in order.  (Summed plainly,
// 64 slots a thread rounded often enough to move gemma-2b's logits past
// the serving check's limit against the plain route.)
//
// Bound: bytes.  Each row is read once and written once (about 4 bytes
// per bf16 element, 8 per fp32), with a handful of flops per element,
// far below the card's compute-to-bandwidth ratio.  So the design keeps
// many bytes in flight and spends few instructions per byte:
//   * a team of W warps per row: one warp up to 4 KB of row (bf16
//     d <= 2048, fp32 d <= 1024, every qk-norm width), 2, 4 or 8 warps
//     for wider rows up to d = 8192; a thread holds V <= 8 vectors of 16
//     bytes (8 bf16 or 4 fp32) of the row in registers between the
//     reduction and the scale, so the row is read from memory once;
//   * a persistent grid (as many blocks as fit on the card at once) in
//     which each team walks rows with a grid-sized stride, loading the
//     next row before it reduces and scales the current one;
//   * each thread keeps its slots of w in registers (in w's own type,
//     exact in fp32) for all its rows;
//   * the sum of squares reduced with warp shuffles; a one-warp team
//     needs no block barrier, a wider one (a block of its own) one
//     __syncthreads per row;
//   * 16-byte loads and stores when d is a multiple of the vector width
//     and x, w and out are 16-byte aligned, else the same kernel reads and
//     writes element by element (coalesced, same slots), so a ragged
//     width or a view offset by an element needs no copy.
//
// C interface (ctypes): rmsnorm_launch(x, w, out, rows, d, eps, order,
// dtype, stream) with order 0 = the TPU kernel's, 1 = cast first, dtype
// 0 = float32, 1 = bfloat16 (x, w and out share it), 1 <= d <= 8192.  Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVecs = 8;       // 16-byte vectors per thread and row
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
  // f rounded to the nearest bf16 value, as fp32
  __device__ __forceinline__ static float rounded(float f) {
    return __bfloat162float(__float2bfloat16(f));
  }
};

// Slot (i, e) of thread `tid` in a team of TT threads is element
// (i * TT + tid) * N + e with 16-byte vectors, (i * N + e) * TT + tid
// element by element: neighbouring threads on neighbouring addresses
// either way.  Slots past d read as 0 and are not written.
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

// W warps a row; a one-warp team shares its block with 7 others.
template <int W>
__host__ __device__ constexpr int threads() { return W == 1 ? 256 : 32 * W; }

template <typename T, int W, int V, bool kCastFirst>
__global__ void __launch_bounds__(threads<W>())
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int rows, int d, float eps, bool vec) {
  constexpr int N = Elem<T>::kPerVec;
  constexpr int TT = 32 * W;                   // threads of a team
  constexpr int kTeams = threads<W>() / TT;    // teams of a block
  const int tid = threadIdx.x % TT, team = threadIdx.x / TT;
  const int stride = gridDim.x * kTeams;
  int row = blockIdx.x * kTeams + team;
  __shared__ float warp_sums[2][W];  // by row parity (W > 1 only)

  uint4 wv[V], cur[V], nxt[V];
  load_row<T, V, TT>(wv, w, d, tid, vec);
  if (row < rows) load_row<T, V, TT>(cur, x + long(row) * d, d, tid, vec);
  for (int it = 0; row < rows; row += stride, ++it) {
    const int next = row + stride;
    if (next < rows)
      load_row<T, V, TT>(nxt, x + long(next) * d, d, tid, vec);
    // the thread's slots summed with compensation (Kahan): a thread holds
    // up to 64 of the row's squares, and a plain running sum over them
    // would round far more often than the plain version's reduction
    float sq = 0.f, comp = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float f = Elem<T>::get(cur[i], e);
        const float y = fmaf(f, f, -comp);
        const float t = sq + y;
        comp = (t - sq) - y;
        sq = t;
      }
    sq -= comp;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if constexpr (W > 1) {
      // the block is one team: every thread walks the same rows
      if ((tid & 31) == 0) warp_sums[it & 1][tid >> 5] = sq;
      __syncthreads();
      sq = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) sq += warp_sums[it & 1][k];
    }
    const float rstd = rsqrtf(sq / static_cast<float>(d) + eps);
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float xhat = Elem<T>::get(cur[i], e) * rstd;
        if constexpr (kCastFirst) xhat = Elem<T>::rounded(xhat);
        Elem<T>::set(cur[i], e, xhat * Elem<T>::get(wv[i], e));
      }
    store_row<T, V, TT>(cur, out + long(row) * d, d, tid, vec);
#pragma unroll
    for (int i = 0; i < V; ++i) cur[i] = nxt[i];
  }
}

// The SMs of device `dev` (< kMaxDevices), read once.
int sm_count(int dev) {
  static int counts[kMaxDevices];
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return counts[dev];
}

template <typename T, int W, int V, bool kCastFirst>
int launch_order(const void* x, const void* w, void* out, int rows, int d,
                 float eps, bool vec, int dev, cudaStream_t stream) {
  // blocks of this instantiation that fit on one SM, read once per device
  static int per_sm[kMaxDevices];
  int& fit = per_sm[dev];
  if (fit == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, rmsnorm_kernel<T, W, V, kCastFirst>, threads<W>(), 0) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  constexpr int kTeams = threads<W>() / (32 * W);
  const long wanted = (static_cast<long>(rows) + kTeams - 1) / kTeams;
  const long resident = static_cast<long>(sm_count(dev)) * (fit > 0 ? fit : 1);
  const int blocks = static_cast<int>(wanted < resident ? wanted : resident);
  rmsnorm_kernel<T, W, V, kCastFirst><<<blocks, threads<W>(), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), rows, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W, int V>
int launch(const void* x, const void* w, void* out, int rows, int d,
           float eps, int order, bool vec, int dev, cudaStream_t stream) {
  if (order == 1)
    return launch_order<T, W, V, true>(x, w, out, rows, d, eps, vec, dev,
                                       stream);
  return launch_order<T, W, V, false>(x, w, out, rows, d, eps, vec, dev,
                                      stream);
}

// The smallest team and slot count that hold a row of d elements.
template <typename T>
int dispatch(const void* x, const void* w, void* out, int rows, int d,
             float eps, int order, cudaStream_t stream) {
  constexpr int N = Elem<T>::kPerVec;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const bool vec = d % N == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
#define REPRO_LAUNCH(W, V) \
  return launch<T, W, V>(x, w, out, rows, d, eps, order, vec, dev, stream)
  if (d <= 32 * N) REPRO_LAUNCH(1, 1);
  if (d <= 64 * N) REPRO_LAUNCH(1, 2);
  if (d <= 128 * N) REPRO_LAUNCH(1, 4);
  if (d <= 256 * N) REPRO_LAUNCH(1, 8);
  if (d <= 512 * N) REPRO_LAUNCH(2, 8);
  if (d <= 1024 * N) REPRO_LAUNCH(4, 8);
  REPRO_LAUNCH(8, kMaxVecs);
#undef REPRO_LAUNCH
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int rows, int d, float eps, int order,
                              int dtype, cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || (order != 0 && order != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(x, w, out, rows, d, eps, order, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, out, rows, d, eps, order, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
