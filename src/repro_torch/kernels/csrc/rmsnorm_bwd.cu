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
// of flops an element.  At (8192, 2048) bf16 that is 100.7 MB, 0.0301 ms
// at 3.35 TB/s.  The design keeps the memory busy and moves little else:
//
//   * Row ranges on a persistent grid.  `blocks` blocks (the wrapper's
//     plan: two an SM where two rings fit, else one) each take one
//     contiguous range of rows, rows * b / blocks up to rows * (b + 1) /
//     blocks, so a block's x and dy are each one stretch of memory.  A
//     block is 8 computing warps and one loading warp.
//   * A ring of `stages` stages in shared memory, each `rows_per_stage`
//     whole rows of x and as many of dy (about 32 KB: 4 rows at bf16
//     d = 2048, 64 at d = 128), each stage one bulk copy of x and one of
//     dy by the copy engine, counted in bytes on the stage's `full`
//     mbarrier; the computing warps free a stage on its `empty` mbarrier
//     and the loading thread refills it at once, so every stage but the
//     one being read is in flight (two rings of three an SM: some 130 KB
//     asked for, against the ~40 KB that 3.35 TB/s over 132 SMs needs
//     to cover ~1.5 us).  Where a row's bytes are no multiple of 16 or
//     x, dy or dx is not 16-byte aligned, the loading warp copies the
//     rows element by element into the same slots (rows padded with
//     zeros to a whole vector), and dx is stored element by element.
//   * Two passes over an arrived stage, reading it from shared memory:
//     (A) the row's two sums, sum x^2 and sum g x, by L lanes a row part
//     (L the row's 16-byte vectors up to 32, so every lane reads 16
//     bytes: a half warp a row at bf16 d = 128; a row in 8 / R parts
//     where a stage holds R < 8 rows, so all 8 warps work: two halves
//     at d = 2048) and xor shuffles only, each part's sums kept in the
//     stage's slot of `sums`; then one named barrier of the computing
//     warps; (B) dx and dw by columns, each thread adding a row's parts
//     in order for r and r^2 mean(g x): a thread owns VB 16-byte vectors
//     of columns (d 2048 bf16: one) over the stage's rows, or, where a
//     row has fewer vectors than the 256 threads, the threads form row
//     groups that take every groups-th row; dx goes out in 16-byte
//     stores, 4 KB contiguous a row at d = 2048.  bf16 rounds two values
//     an instruction (cvt.rn.bf16x2.f32), as round-to-nearest does one.
//     The ring's first stages are asked for before w is loaded.
//   * dweight summed in registers over the block's whole range: each
//     thread keeps its columns' fp32 share over all the rows it handles,
//     the row groups add theirs in group order through shared memory
//     once at the end, and the block writes one fp32 partial row.  So
//     the scratch is `blocks` partial rows (264 at bf16 d = 2048 on 132
//     SMs), not 1,024 of them.
//   * The cross-grid sum in a second launch spread over the card:
//     dw_reduce, a block per 32 columns, 8 slices of a block each
//     summing every 8th partial row in block order, then the slices in
//     order; launched with programmatic stream serialisation, so its
//     blocks are placed while the first launch drains and wait on
//     griddepcontrol.wait for its writes.
// No atomics: dweight's order of summation depends only on the block
// index, the row order and the plan, which is fixed per device and
// shape, so repeated launches give the same bits.
//
// C interface (ctypes): rmsnorm_bwd_launch(x, w, dy, dx, dw, partial,
// rows, d, eps, blocks, rows_per_stage, stages, order, dtype, stream)
// with order as the forward's (0 = the TPU kernel's, 1 = cast first),
// dtype 0 = float32, 1 = bfloat16 (x, w, dy, dx, dw share it),
// 1 <= d <= 8192, stages >= 2, partial an fp32 buffer of blocks * d;
// returns cudaGetLastError() after the launches.  rmsnorm_bwd_smem(d,
// dtype, rows_per_stage, stages) gives the shared memory a block of that
// plan takes (-1 if it takes none the card allows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxD = 8192;
constexpr int kMaxDevices = 64;
constexpr int kWarps = 8;                   // computing warps of a block
constexpr int kConsumers = 32 * kWarps;     // their threads
constexpr int kThreads = kConsumers + 32;   // and the loading warp
constexpr int kMaxSmem = 232448;            // 227 KB, a block's most
constexpr int kMaxTx = (1 << 20) - 1;       // an mbarrier's byte count
constexpr int kComputeBar = 1;              // named barrier of the warps
constexpr int kSlices = 8;                  // dw_reduce's row slices

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kPerVec = 4;
  __device__ __forceinline__ static float get(const uint4& u, int e) {
    return __uint_as_float((&u.x)[e]);
  }
  // elements e and e + 1 (e even) set to a and b
  __device__ __forceinline__ static void put2(uint4& u, int e, float a,
                                              float b) {
    (&u.x)[e] = __float_as_uint(a);
    (&u.x)[e + 1] = __float_as_uint(b);
  }
  __device__ __forceinline__ static void store(float* p, long i,
                                               const uint4& u, int e) {
    p[i] = get(u, e);
  }
  __device__ __forceinline__ static float cast(float f) { return f; }
  // a and b rounded to the type, as fp32
  __device__ __forceinline__ static void rounded2(float&, float&) {}
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  __device__ __forceinline__ static float get(const uint4& u, int e) {
    const uint32_t word = (&u.x)[e >> 1];
    return __uint_as_float((e & 1) ? (word & 0xFFFF0000u) : (word << 16));
  }
  // a and b to the nearest bf16 values by one cvt.rn.bf16x2.f32, as the
  // word that holds them (a low)
  __device__ __forceinline__ static uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static void put2(uint4& u, int e, float a,
                                              float b) {
    (&u.x)[e >> 1] = pack(a, b);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, long i,
                                               const uint4& u, int e) {
    const uint32_t word = (&u.x)[e >> 1];
    p[i] = __ushort_as_bfloat16(
        static_cast<unsigned short>((e & 1) ? (word >> 16) : word));
  }
  __device__ __forceinline__ static __nv_bfloat16 cast(float f) {
    return __float2bfloat16(f);
  }
  __device__ __forceinline__ static void rounded2(float& a, float& b) {
    const uint32_t word = pack(a, b);
    a = __uint_as_float(word << 16);
    b = __uint_as_float(word & 0xFFFF0000u);
  }
};

// Pass A splits a row's vectors into `parts` runs, one a warp slot, so
// that a stage of fewer rows than warps still keeps every warp busy
__host__ __device__ inline int row_parts(int rows_per_stage) {
  return rows_per_stage < kWarps ? kWarps / rows_per_stage : 1;
}

// A block's dynamic shared memory (host and device): the ring (stage s:
// rows_per_stage rows of x, then as many of dy, each `ds` elements), which
// the row groups' dw partials reuse at the end; w; each stage's rows'
// partial sums (sum x^2, sum g x) a part, as float2; the full and empty
// mbarriers.
struct Layout {
  int ds;          // a row's width in shared memory: d up to a vector
  int row_bytes;
  int groups;      // row groups of pass B
  int parts;       // a row's parts in pass A
  int w_off, sums_off, bar_off, bytes;
};

__host__ __device__ inline Layout layout(int d, int size, int rows_per_stage,
                                         int stages) {
  const int n = 16 / size;
  Layout l;
  l.ds = (d + n - 1) / n * n;
  l.row_bytes = l.ds * size;
  const int nvec = l.ds / n;
  l.groups = nvec < kConsumers ? kConsumers / nvec : 1;
  l.parts = row_parts(rows_per_stage);
  const int ring = stages * 2 * rows_per_stage * l.row_bytes;
  const int combine = l.groups > 1 ? l.groups * l.ds * 4 : 0;
  l.w_off = ring > combine ? ring : combine;
  l.sums_off = l.w_off + l.row_bytes;
  l.bar_off = l.sums_off + stages * rows_per_stage * l.parts * 8;
  l.bytes = l.bar_off + 2 * stages * 8;
  return l;
}

template <typename T>
struct Args {
  const T* x;
  const T* w;
  const T* dy;
  T* dx;
  float* partial;
  int rows, d, rows_per_stage, stages;
  float eps;
  bool vec;        // bulk copies in and 16-byte stores out
};

template <typename T, bool kCastFirst, int VB>
__global__ void __launch_bounds__(kThreads, 2)
rows_kernel(const Args<T> a) {
  constexpr int N = Elem<T>::kPerVec;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = a.rows_per_stage, S = a.stages;
  const Layout l = layout(a.d, sizeof(T), R, S);
  const int nvec = l.ds / N, parts = l.parts;
  const uint4* wv = reinterpret_cast<const uint4*>(smem + l.w_off);
  float2* sums = reinterpret_cast<float2*>(smem + l.sums_off);
  const uint32_t bars = hopper::smem_u32(smem + l.bar_off);
  const long first = static_cast<long>(blockIdx.x) * a.rows / gridDim.x;
  const long last = static_cast<long>(blockIdx.x + 1) * a.rows / gridDim.x;
  const int n = static_cast<int>(last - first);
  const int steps = (n + R - 1) / R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // stage k's rows into its slot: one bulk copy of x and one of dy (lane
  // 0), or element by element (the whole loading warp), after the
  // computing warps freed the slot's previous rows
  auto fill = [&](int k) {
    const int s = k % S, u = k / S;
    const int rk = min(R, n - k * R);
    const long row = first + static_cast<long>(k) * R;
    unsigned char* xs = smem + s * 2 * R * l.row_bytes;
    unsigned char* gs = xs + R * l.row_bytes;
    const uint32_t full = bars + 8 * s;
    if (u > 0) hopper::mbar_wait(bars + 8 * (S + s), (u - 1) & 1);
    if (a.vec) {
      const uint32_t bytes = rk * l.row_bytes;
      hopper::mbar_expect_tx(full, 2 * bytes);
      hopper::bulk_load(hopper::smem_u32(xs), a.x + row * a.d, bytes, full);
      hopper::bulk_load(hopper::smem_u32(gs), a.dy + row * a.d, bytes, full);
    } else {
      T* xt = reinterpret_cast<T*>(xs);
      T* gt = reinterpret_cast<T*>(gs);
      for (int r = 0; r < rk; ++r)
        for (int c = lane; c < l.ds; c += 32) {
          const bool in = c < a.d;
          const long i = (row + r) * a.d + c;
          xt[r * l.ds + c] = in ? a.x[i] : Elem<T>::cast(0.f);
          gt[r * l.ds + c] = in ? a.dy[i] : Elem<T>::cast(0.f);
        }
      hopper::mbar_arrive(full);
    }
  };

  // dw_reduce may be placed now: it waits for this grid's end to read
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the ring's first stages are asked for before w is loaded
  const int early = a.vec ? min(S, steps) : 0;
  if (warp == kWarps && lane == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(bars + 8 * s, a.vec ? 1 : 32);
      hopper::mbar_init(bars + 8 * (S + s), kWarps);
    }
    hopper::fence_barrier_init();
    for (int k = 0; k < early; ++k) fill(k);
  }
  T* wfill = reinterpret_cast<T*>(smem + l.w_off);
  if (warp < kWarps)
    for (int c = threadIdx.x; c < l.ds; c += kConsumers)
      wfill[c] = c < a.d ? a.w[c] : Elem<T>::cast(0.f);
  __syncthreads();

  if (warp == kWarps) {   // the loading warp
    if (a.vec && lane != 0) return;
    for (int k = early; k < steps; ++k) fill(k);
    return;
  }

  // the computing warps
  const int ct = threadIdx.x;
  const float inv_d = 1.f / static_cast<float>(a.d);
  int L = 1;                         // pass A: lanes a row part
  while (L < nvec && L < 32) L <<= 1;
  const int per_warp = 32 / L, sub = lane / L, li = lane % L;
  const int slots = kWarps * per_warp;
  const int groups = l.groups;       // pass B: row groups
  const int group = groups > 1 ? ct / nvec : 0;
  const int v0 = groups > 1 ? ct % nvec : ct;
  const bool active = group < groups;
  float acc[VB][N];
#pragma unroll
  for (int i = 0; i < VB; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[i][e] = 0.f;

  for (int k = 0; k < steps; ++k) {
    const int s = k % S, u = k / S;
    const int rk = min(R, n - k * R);
    const long row = first + static_cast<long>(k) * R;
    const unsigned char* xs = smem + s * 2 * R * l.row_bytes;
    const unsigned char* gs = xs + R * l.row_bytes;
    float2* st = sums + s * R * parts;
    hopper::mbar_wait(bars + 8 * s, u & 1);

    // (A) each row part's sums, L lanes a part, shuffles only
    for (int base = warp * per_warp; base < rk * parts; base += slots) {
      const int item = base + sub, r = item / parts, p = item % parts;
      float sq0 = 0.f, sq1 = 0.f, gx0 = 0.f, gx1 = 0.f;
      if (item < rk * parts) {
        const uint4* xr = reinterpret_cast<const uint4*>(xs + r * l.row_bytes);
        const uint4* gr = reinterpret_cast<const uint4*>(gs + r * l.row_bytes);
        const int end = (p + 1) * nvec / parts;
        for (int v = p * nvec / parts + li; v < end; v += L) {
          const uint4 xv = xr[v], gv = gr[v], wvv = wv[v];
#pragma unroll
          for (int e = 0; e < N; e += 2) {
            const float f0 = Elem<T>::get(xv, e);
            const float f1 = Elem<T>::get(xv, e + 1);
            float g0 = Elem<T>::get(gv, e) * Elem<T>::get(wvv, e);
            float g1 = Elem<T>::get(gv, e + 1) * Elem<T>::get(wvv, e + 1);
            if (kCastFirst) Elem<T>::rounded2(g0, g1);
            sq0 = fmaf(f0, f0, sq0);
            sq1 = fmaf(f1, f1, sq1);
            gx0 = fmaf(g0, f0, gx0);
            gx1 = fmaf(g1, f1, gx1);
          }
        }
      }
      float sq = sq0 + sq1, gx = gx0 + gx1;
      for (int off = L >> 1; off > 0; off >>= 1) {
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
        gx += __shfl_xor_sync(0xffffffffu, gx, off);
      }
      if (item < rk * parts && li == 0) st[item] = make_float2(sq, gx);
    }
    hopper::named_sync(kComputeBar, kConsumers);

    // (B) dx and dw by columns over the stage's rows
    if (active)
      for (int r = group; r < rk; r += groups) {
        float sq = 0.f, gx = 0.f;
        for (int p = 0; p < parts; ++p) {
          const float2 q = st[r * parts + p];
          sq += q.x;
          gx += q.y;
        }
        const float rs = rsqrtf(sq * inv_d + a.eps);
        const float c = rs * rs * gx * inv_d;
        const uint4* xr = reinterpret_cast<const uint4*>(xs + r * l.row_bytes);
        const uint4* gr = reinterpret_cast<const uint4*>(gs + r * l.row_bytes);
        T* out = a.dx + (row + r) * a.d;
#pragma unroll
        for (int i = 0; i < VB; ++i) {
          const int v = v0 + i * kConsumers;
          if (v >= nvec) break;
          const uint4 xv = xr[v], gv = gr[v], wvv = wv[v];
          uint4 ov;
#pragma unroll
          for (int e = 0; e < N; e += 2) {
            const float f0 = Elem<T>::get(xv, e);
            const float f1 = Elem<T>::get(xv, e + 1);
            const float dy0 = Elem<T>::get(gv, e);
            const float dy1 = Elem<T>::get(gv, e + 1);
            float ga0 = dy0 * Elem<T>::get(wvv, e);
            float ga1 = dy1 * Elem<T>::get(wvv, e + 1);
            if (kCastFirst) {
              Elem<T>::rounded2(ga0, ga1);
              float t0 = f0 * rs, t1 = f1 * rs;
              Elem<T>::rounded2(t0, t1);
              float p0 = dy0 * t0, p1 = dy1 * t1;
              Elem<T>::rounded2(p0, p1);
              acc[i][e] += p0;
              acc[i][e + 1] += p1;
            } else {
              acc[i][e] = fmaf(dy0, f0 * rs, acc[i][e]);
              acc[i][e + 1] = fmaf(dy1, f1 * rs, acc[i][e + 1]);
            }
            Elem<T>::put2(ov, e, rs * (ga0 - f0 * c), rs * (ga1 - f1 * c));
          }
          if (a.vec) {
            reinterpret_cast<uint4*>(out)[v] = ov;
          } else {
#pragma unroll
            for (int e = 0; e < N; ++e)
              if (v * N + e < a.d) Elem<T>::store(out, v * N + e, ov, e);
          }
        }
      }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bars + 8 * (S + s));
  }

  // this block's partial row of dw
  float* part = a.partial + static_cast<long>(blockIdx.x) * a.d;
  if (groups == 1) {
#pragma unroll
    for (int i = 0; i < VB; ++i) {
      const int v = v0 + i * kConsumers;
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (v < nvec && v * N + e < a.d) part[v * N + e] = acc[i][e];
    }
    return;
  }
  float* buf = reinterpret_cast<float*>(smem);   // the ring, all read
  hopper::named_sync(kComputeBar, kConsumers);
  if (active)
#pragma unroll
    for (int e = 0; e < N; ++e) buf[group * l.ds + v0 * N + e] = acc[0][e];
  hopper::named_sync(kComputeBar, kConsumers);
  for (int c = ct; c < a.d; c += kConsumers) {
    float t = 0.f;
    for (int g = 0; g < groups; ++g) t += buf[g * l.ds + c];
    part[c] = t;
  }
}

// dw from the grid's partial rows: a block per 32 columns, slice k of
// its 8 warps summing partial rows k, k + 8, ... in order, then the
// slices in order
template <typename T>
__global__ void __launch_bounds__(32 * kSlices)
dw_reduce(const float* __restrict__ partial, T* __restrict__ dw, int blocks,
          int d) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float sums[kSlices][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d)
#pragma unroll 4
    for (int b = slice; b < blocks; b += kSlices)
      s += partial[static_cast<long>(b) * d + col];
  sums[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) t += sums[k][lane];
    dw[col] = Elem<T>::cast(t);
  }
}

template <typename T, bool kCastFirst, int VB>
int launch(const Args<T>& a, int blocks, T* dw, int dev,
           cudaStream_t stream) {
  static bool ready[kMaxDevices];
  auto kernel = rows_kernel<T, kCastFirst, VB>;
  if (!ready[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const Layout l = layout(a.d, sizeof(T), a.rows_per_stage, a.stages);
  kernel<<<blocks, kThreads, l.bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.d + 31) / 32);
  cfg.blockDim = dim3(32 * kSlices);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dw_reduce<T>,
                           static_cast<const float*>(a.partial), dw, blocks,
                           a.d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// VB, the 16-byte vectors of a row a thread owns in pass B: the least
// power of two that covers the row with the block's 256 threads
template <typename T, bool kCastFirst>
int launch_vb(const Args<T>& a, int blocks, T* dw, int dev,
              cudaStream_t stream) {
  constexpr int N = Elem<T>::kPerVec;
  constexpr int kMaxVB = kMaxD / (N * kConsumers);   // 4 bf16, 8 fp32
  const int need = ((a.d + N - 1) / N + kConsumers - 1) / kConsumers;
  if (need <= 1) return launch<T, kCastFirst, 1>(a, blocks, dw, dev, stream);
  if (need <= 2) return launch<T, kCastFirst, 2>(a, blocks, dw, dev, stream);
  if (need <= 4) return launch<T, kCastFirst, 4>(a, blocks, dw, dev, stream);
  return launch<T, kCastFirst, kMaxVB>(a, blocks, dw, dev, stream);
}

template <typename T>
int dispatch(const void* x, const void* w, const void* dy, void* dx,
             void* dw, float* partial, int rows, int d, float eps,
             int blocks, int rows_per_stage, int stages, int order, int dev,
             cudaStream_t stream) {
  constexpr int N = Elem<T>::kPerVec;
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.dy = static_cast<const T*>(dy);
  a.dx = static_cast<T*>(dx);
  a.partial = partial;
  a.rows = rows;
  a.d = d;
  a.rows_per_stage = rows_per_stage;
  a.stages = stages;
  a.eps = eps;
  a.vec = d % N == 0 && ((reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(dy) |
                          reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  T* out = static_cast<T*>(dw);
  if (order == 1)
    return launch_vb<T, true>(a, blocks, out, dev, stream);
  return launch_vb<T, false>(a, blocks, out, dev, stream);
}

// the block's shared memory for a plan, or -1 where the plan is refused
int smem_bytes(int d, int dtype, int rows_per_stage, int stages) {
  if (d <= 0 || d > kMaxD || rows_per_stage <= 0 || stages < 2 ||
      (dtype != 0 && dtype != 1))
    return -1;
  const int size = dtype == 0 ? 4 : 2;
  const long stage = 2L * rows_per_stage * ((d * size + 15) / 16 * 16);
  if (stage * stages > kMaxSmem || stage > kMaxTx) return -1;
  const Layout l = layout(d, size, rows_per_stage, stages);
  return l.bytes <= kMaxSmem ? l.bytes : -1;
}

}  // namespace

extern "C" int rmsnorm_bwd_smem(int d, int dtype, int rows_per_stage,
                                int stages) {
  return smem_bytes(d, dtype, rows_per_stage, stages);
}

extern "C" int rmsnorm_bwd_launch(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  float* partial, int rows, int d, float eps,
                                  int blocks, int rows_per_stage, int stages,
                                  int order, int dtype, cudaStream_t stream) {
  if (rows <= 0 || blocks <= 0 || (order != 0 && order != 1) ||
      smem_bytes(d, dtype, rows_per_stage, stages) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (dtype == 0)
    return dispatch<float>(x, w, dy, dx, dw, partial, rows, d, eps, blocks,
                           rows_per_stage, stages, order, dev, stream);
  return dispatch<__nv_bfloat16>(x, w, dy, dx, dw, partial, rows, d, eps,
                                 blocks, rows_per_stage, stages, order, dev,
                                 stream);
}
