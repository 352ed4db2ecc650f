// Forward attention with GQA for sm_90a: bf16 on the tensor cores
// (wgmma, a TMA-fed K/V ring), fp32 on the CUDA cores.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas.
// q (B, Hq, Lq, D), k (B, Hkv, Lk, D), v (B, Hkv, Lk, Dv) and the output
// (B, Hq, Lq, Dv), all contiguous, one type (fp32 or bf16); query head h
// reads kv head h / (Hq / Hkv).  Causal rows are the last Lq positions of
// the Lk-long sequence, as in the TPU kernel, or, for a cached prefill at
// an offset (the reference's _sdpa_block with a per-row q_offset and
// kv_len, src/repro/models/attention.py:76), row r of batch row b sits at
// q_offset[b] + r, and keys at >= kv_len[b] are masked (causal or not):
// both int32 (B,) in device memory, read once by each block, never by
// the host; the K / V tensor maps stay over the whole cache (Lk = Lmax),
// and key tiles past min(Lk, kv_len[b]) or past a tile's last row are
// neither loaded nor computed.  Online softmax in fp32;
// the (Lq x Lk) logits never reach device memory.  The head dims are a
// template pair <D, Dv>: Dv = D for the GQA models, and (192, 128) for
// MLA (deepseek-v2-lite: a q and k head of 128 + 64 rope, a v head of
// 128), where the key is 3 swizzle chunks wide and the value 2.
//
// Bound: operations, 2 * (D + Dv) flops per query-key pair kept (causal:
// the pairs on or below the diagonal; with offsets, sum over b and r of
// min(q_offset[b] + r + 1, kv_len[b])), against (D + Dv) * 2 bytes per key
// row (with offsets, the rows below kv_len[b] of each KV head).
//
// bf16 (flash_wgmma), the FlashAttention-3 schedule without its
// intra-warpgroup overlap:
//   * one block of three warpgroups per (128 q rows, q head, batch), the
//     q tiles of causal attention heaviest first (the grid's slow axis
//     counts q tiles down), so the long rows do not trail in the last
//     wave; a kv head's K/V is re-read by its query group through L2;
//   * warpgroup 2 is the producer: one thread loads the Q tile once and
//     then K and V tiles of 64 keys into a ring of stages in shared
//     memory by TMA, each stage's arrival counted on an mbarrier in
//     bytes, its release signalled on another by every consumer warp;
//     no block-wide barrier in the key loop.  It gives its registers
//     up (setmaxnreg 24) to the two consumer warpgroups (240 each);
//   * tiles sit in shared memory as bf16 in the swizzled layout wgmma
//     reads (128-byte rows, or 64-byte at D = 32): a row of D values is
//     D / 64 column chunks of one swizzle atom width, each chunk a tile
//     of its own; a wgmma k-step of 16 moves the descriptor 32 bytes
//     inside an atom, and every (atom width / 16)-th step to the next
//     chunk;
//   * each consumer warpgroup owns 64 rows: S = Q K^T by
//     wgmma.m64n64k16 (bf16 in, fp32 out, both operands K-major from
//     shared memory), scaled by scale * log2(e) in fp32, then the online
//     softmax on the accumulator's registers (row max and sum over the
//     four lanes of a row; masks only on tiles that cross the key bound
//     (Lk, or kv_len[b]) or the diagonal; key tiles past a warpgroup's
//     last row are skipped; a tile's keys past the bound are loaded from
//     the cache as they are and get P = 0);
//   * O += P V by wgmma with A = P from registers (the S accumulator's
//     layout is the A fragment's) and B = V from shared memory, MN-major
//     (the transpose bit).  P enters as two bf16 terms, P_hi =
//     bf16(P) and P_lo = bf16(P - P_hi), into the same fp32 O; l sums
//     the fp32 P.  That is 1.5x the tensor-core work of a kernel that
//     rounds P to bf16, and the reason for it: such a kernel misses the
//     port's bf16 gate (one bf16 ulp plus 2^-10 of the row's rms of the
//     fp32 result) by 7.26x at (1, 4, 2048, 256) causal MQA on the CPU,
//     while the split P reads 0.958, as an fp32 P does on the card;
//   * epilogue: O / l in fp32, cast to bf16, staged in the warpgroup's
//     own rows of the Q tile and stored 16 bytes a thread; with an `lse`
//     buffer, each row's log-sum-exp of its scaled logits,
//     (m + log2 l) ln 2, which the backward (flash_attention_bwd.cu)
//     reads to recompute P without a second pass over the keys.
// Shared memory: Q 128 x D, then K rings of 64 x D and V rings of 64 x Dv,
// bf16: 192 KB at D = 256 (2 stages); 160, 80 and 40 KB at D = 128, 64 and
// 32 (4 stages); 208 KB at (192, 128) (4 stages: Q 48 KB, a K stage 24 KB,
// a V stage 16 KB; O is 64 fp32 registers a thread, as at D = 128).
//
// fp32 (flash_fp32) keeps the CUDA-core kernel: one block of 256 threads
// per 64-row q tile, K and V tiles of 64 keys staged through shared
// memory in fp32 (Q and K transposed, one float of padding per row), a
// 4 x 4 register tile of logits per thread, 215 KB of shared memory at
// D = 256; with an `lse` buffer it writes m + log l of each row.  The
// type code alone chooses it: an fp32 product on the tensor cores is TF32 (10 mantissa bits), which the fp32 limit of 1e-5 against
// the plain version refuses.
//
// C interface (ctypes): flash_attention_launch(q, k, v, out, lse,
// q_offset, kv_len, B, Hq, Hkv, Lq, Lk, D, Dv, causal, scale, dtype,
// stream) with dtype 0 =
// float32, 1 = bfloat16 (16-byte aligned pointers) and (D, Dv) one of
// (32, 32), (64, 64), (128, 128), (256, 256) and (192, 128);
// lse is NULL (serving) or an fp32 (B, Hq, Lq) buffer that receives the
// natural log-sum-exp of each row's scaled logits (training); q_offset and
// kv_len are each NULL or an int32 (B,) device buffer (NULL: the rows sit
// at Lk - Lq + r, and every key up to Lk is seen).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ============================ bf16: wgmma ================================

constexpr int kRows = 128;   // q rows per block
constexpr int kWgRows = 64;  // q rows per consumer warpgroup
constexpr int kBK = 64;      // keys per ring stage
constexpr int kWgThreads = 128;
constexpr int kThreadsWg = 3 * kWgThreads;
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// DK: the head dim of q and k; DV: of v and the output (DV <= DK; both
// whole swizzle chunks)
template <int DK, int DV>
struct Cfg {
  static_assert(DV <= DK, "the output is staged in the Q tile's rows");
  static constexpr int kSwizzle = DV >= 64 ? 128 : 64;  // bytes a tile row
  static constexpr int kChunkCols = kSwizzle / 2;       // bf16 a tile row
  static constexpr int kQKChunks = DK / kChunkCols;     // of a Q or K row
  static constexpr int kVChunks = DV / kChunkCols;      // of a V row
  static_assert(kQKChunks * kChunkCols == DK && kVChunks * kChunkCols == DV,
                "head dims of whole chunks");
  static constexpr int kStepsPerChunk = kChunkCols / 16;
  static constexpr int kStages = DK == 256 ? 2 : 4;
  static constexpr uint32_t kDescSwizzle = kSwizzle == 128 ? 1 : 2;
  static constexpr uint32_t kQChunk = kRows * kSwizzle;
  static constexpr uint32_t kKVChunk = kBK * kSwizzle;
  static constexpr uint32_t kQBytes = kQKChunks * kQChunk;
  static constexpr uint32_t kKBytes = kQKChunks * kKVChunk;
  static constexpr uint32_t kVBytes = kVChunks * kKVChunk;
  static constexpr uint32_t kKOff = kQBytes;
  static constexpr uint32_t kVOff = kKOff + kStages * kKBytes;
  static constexpr uint32_t kBarOff = kVOff + kStages * kVBytes;
  // barriers: Q full, then per stage K full, V full, empty; plus 1 KB to
  // align the base to the swizzle atom
  static constexpr uint32_t kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kSmem <= 227 * 1024, "fits an SM's shared memory");
};

// byte offset of 16-byte unit `unit` of row `row` inside one swizzled
// chunk: the TMA's 128-byte (Swizzle<3,4,3>) or 64-byte (Swizzle<2,4,3>)
// pattern
template <int kSwizzle>
__device__ __forceinline__ uint32_t swizzled(int row, int unit) {
  const int phase = kSwizzle == 128 ? (row & 7) : ((row >> 1) & 3);
  return row * kSwizzle + ((unit ^ phase) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreadsWg, 1)
flash_wgmma(const __grid_constant__ CUtensorMap q_map,
            const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map,
            __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
            const int* __restrict__ q_offset, const int* __restrict__ kv_len,
            int Hq, int Hkv, int Lq, int Lk, int causal, float scale_log2) {
  using C = Cfg<DK, DV>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t q_s = base, k_s = base + C::kKOff, v_s = base + C::kVOff;
  const uint32_t q_full = base + C::kBarOff;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + S + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * S + s); };

  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kRows;
  const int bh = blockIdx.x;  // b * Hq + h
  const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  // q row r sits at key position r + off; keys at >= kv_end are masked.
  // The producer and the consumers count the same tiles from these two
  // values, or the ring would wait on a stage that never lands
  const int off = q_offset != nullptr ? q_offset[bh / Hq] : Lk - Lq;
  const int kv_end =
      kv_len != nullptr ? max(0, min(Lk, kv_len[bh / Hq])) : Lk;
  int n_tiles = (kv_end + kBK - 1) / kBK;
  if (causal)
    n_tiles = max(0, min(n_tiles,
                         (min(q0 + kRows, Lq) - 1 + off) / kBK + 1));

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(empty(s), kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    // ---- producer: one thread starts every copy
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * kWgThreads) {
      hopper::mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kQKChunks; ++c)
        hopper::tma_load_3d(q_s + c * C::kQChunk, &q_map, q_full,
                            c * C::kChunkCols, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        hopper::mbar_wait(empty(s), ((t / S) & 1) ^ 1);
        hopper::mbar_expect_tx(k_full(s), C::kKBytes);
#pragma unroll
        for (int c = 0; c < C::kQKChunks; ++c)
          hopper::tma_load_3d(k_s + s * C::kKBytes + c * C::kKVChunk,
                              &k_map, k_full(s), c * C::kChunkCols, t * kBK,
                              bhk);
        hopper::mbar_expect_tx(v_full(s), C::kVBytes);
#pragma unroll
        for (int c = 0; c < C::kVChunks; ++c)
          hopper::tma_load_3d(v_s + s * C::kVBytes + c * C::kKVChunk,
                              &v_map, v_full(s), c * C::kChunkCols, t * kBK,
                              bhk);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows q0 + 64 wg ...
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32, lane = tid % 32;
    const int wg_first = q0 + wg * kWgRows;
    const int row0 = wg_first + warp * 16 + lane / 4;  // and row0 + 8
    const uint32_t q_wg = q_s + wg * kWgRows * C::kSwizzle;

    float o[DV / 2];
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) o[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    hopper::mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S;
      const uint32_t phase = (t / S) & 1;
      const int k0 = t * kBK;
      if (causal && k0 > wg_first + kWgRows - 1 + off) {
        // every key of the tile lies past this warpgroup's last row; it
        // still waits for the tile to land before releasing the stage, or
        // its arrivals would complete the stage's previous phase while the
        // other warpgroup still reads that tile
        hopper::mbar_wait(k_full(s), phase);
        hopper::mbar_wait(v_full(s), phase);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty(s));
        continue;
      }

      // S = Q K^T
      float sc[32];
      hopper::mbar_wait(k_full(s), phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const int c = kk / C::kStepsPerChunk;  // column chunk
        const uint32_t at = (kk % C::kStepsPerChunk) * 32;
        hopper::wgmma_ss_m64n64(
            sc,
            hopper::make_desc(q_wg + c * C::kQChunk + at, 16,
                              8 * C::kSwizzle, C::kDescSwizzle),
            hopper::make_desc(k_s + s * C::kKBytes + c * C::kKVChunk + at,
                              16, 8 * C::kSwizzle, C::kDescSwizzle),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sc);

      // online softmax on the accumulator's registers: element j is row
      // row0 + 8 ((j >> 1) & 1), key k0 + 8 (j >> 2) + 2 (lane & 3) + (j & 1)
      const bool masked = k0 + kBK > kv_end ||
                          (causal && k0 + kBK - 1 > wg_first + off);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = sc[j] * scale_log2;
        if (masked) {
          const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
          const int row = row0 + 8 * ((j >> 1) & 1);
          if (kpos >= kv_end || (causal && kpos > row + off)) x = -INFINITY;
        }
        sc[j] = x;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 32; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float sub[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        sub[i] = mx[i] == -INFINITY ? 0.f : mx[i];
        alpha[i] = exp2f(m[i] - sub[i]);
        m[i] = mx[i];
      }
      uint32_t p_hi[16], p_lo[16];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int i = (j >> 1) & 1;
        const float p0 = exp2f(sc[j] - sub[i]);
        const float p1 = exp2f(sc[j + 1] - sub[i]);
        rs[i] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 back = __bfloat1622float2(hi);
        p_hi[j / 2] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[j / 2] = pack_bf16(p0 - back.x, p1 - back.y);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

      // O += P_hi V + P_lo V
      hopper::mbar_wait(v_full(s), phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const uint64_t desc_v = hopper::make_desc(
            v_s + s * C::kVBytes + ks * 16 * C::kSwizzle, C::kKVChunk,
            8 * C::kSwizzle, C::kDescSwizzle);
        const uint32_t a_hi[4] = {p_hi[4 * ks], p_hi[4 * ks + 1],
                                  p_hi[4 * ks + 2], p_hi[4 * ks + 3]};
        const uint32_t a_lo[4] = {p_lo[4 * ks], p_lo[4 * ks + 1],
                                  p_lo[4 * ks + 2], p_lo[4 * ks + 3]};
        hopper::WgmmaRS<DV>::run(o, a_hi, desc_v);
        hopper::WgmmaRS<DV>::run(o, a_lo, desc_v);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    // epilogue: O / l, cast, staged in this warpgroup's rows of the Q tile
    // (its products on Q are done), then 16-byte stores
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    }
    if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i < Lq)
          lse[size_t(bh) * Lq + row0 + 8 * i] = (m[i] + log2f(l[i])) * kLn2;
    }
#pragma unroll
    for (int j = 0; j < DV / 2; j += 2) {
      const int i = (j >> 1) & 1;
      const int r = wg * kWgRows + warp * 16 + lane / 4 + 8 * i;
      const int col = 8 * (j >> 2) + 2 * (lane & 3);
      const int cc = col % C::kChunkCols;
      const uint32_t at = (col / C::kChunkCols) * C::kQChunk +
                          swizzled<C::kSwizzle>(r, cc / 8) + (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(smem + at) =
          pack_bf16(o[j] * inv[i], o[j + 1] * inv[i]);
    }
    hopper::named_sync(1 + wg, kWgThreads);
    constexpr int kUnits = DV / 8;  // 16-byte units a row
    constexpr int kChunkUnits = C::kChunkCols / 8;
    __nv_bfloat16* ob = out + size_t(bh) * Lq * DV;
    for (int idx = tid; idx < kWgRows * kUnits; idx += kWgThreads) {
      const int r = idx / kUnits, u = idx % kUnits;
      const int q = wg_first + r;
      if (q >= Lq) continue;
      const uint32_t at =
          (u / kChunkUnits) * C::kQChunk +
          swizzled<C::kSwizzle>(wg * kWgRows + r, u % kChunkUnits);
      *reinterpret_cast<uint4*>(ob + size_t(q) * DV + u * 8) =
          *reinterpret_cast<const uint4*>(smem + at);
    }
  }
}

// a map over (heads, L, cols) bf16 rows, boxes of one swizzle chunk of
// Cfg<DK, DV> and `rows` rows
template <int DK, int DV>
bool make_map(CUtensorMap* map, const void* ptr, int cols, int L, int heads,
              int rows) {
  using C = Cfg<DK, DV>;
  return hopper::make_map_bf16(map, ptr, cols, L, heads, C::kChunkCols, rows,
                               C::kSwizzle);
}

template <int DK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, const int* q_offset, const int* kv_len, int B,
                 int Hq, int Hkv, int Lq, int Lk, int causal, float scale,
                 cudaStream_t stream) {
  const int n_qt = (Lq + kRows - 1) / kRows;
  if (n_qt > 65535 || long(B) * Hq > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  if (!make_map<DK, DV>(&q_map, q, DK, Lq, B * Hq, kRows) ||
      !make_map<DK, DV>(&k_map, k, DK, Lk, B * Hkv, kBK) ||
      !make_map<DK, DV>(&v_map, v, DV, Lk, B * Hkv, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr uint32_t bytes = Cfg<DK, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, n_qt), block(kThreadsWg);
  flash_wgmma<DK, DV><<<grid, block, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, q_offset,
      kv_len, Hq, Hkv, Lq, Lk, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ======================== fp32: CUDA cores ===============================

constexpr int kBQ = 64;
constexpr int kThreads = 256;
constexpr int kPad = kBK + 1;  // row length of the transposed tiles

template <int DK, int DV>
constexpr size_t smem_bytes_fp32() {
  return sizeof(float) *
         (size_t(2) * DK * kPad + size_t(kBK) * DV + size_t(kBQ) * kPad);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fp32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           float* __restrict__ lse, const int* __restrict__ q_offset,
           const int* __restrict__ kv_len, int Hq, int Hkv, int Lq, int Lk,
           int causal, float scale) {
  constexpr int C = DV / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                 // [DK][kPad]: Qt[d][row]
  float* Kt = Qt + DK * kPad;       // [DK][kPad]: Kt[d][key]
  float* Vs = Kt + DK * kPad;       // [kBK][DV]
  float* Ps = Vs + kBK * DV;        // [kBQ][kPad]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const float* qb = q + ((long(b) * Hq + h) * Lq) * DK;
  const float* kb = k + ((long(b) * Hkv + hk) * Lk) * DK;
  const float* vb = v + ((long(b) * Hkv + hk) * Lk) * DV;
  // q row r sits at key position r + offset; keys at >= kv_end are masked
  const int offset = q_offset != nullptr ? q_offset[b] : Lk - Lq;
  const int kv_end = kv_len != nullptr ? max(0, min(Lk, kv_len[b])) : Lk;

  for (int idx = tid; idx < kBQ * DK; idx += kThreads) {
    const int r = idx / DK, d = idx - r * DK;
    const int qr = q0 + r;
    Qt[d * kPad + r] = qr < Lq ? qb[long(qr) * DK + d] * scale : 0.f;
  }

  float acc[4][C];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (kv_end + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, Lq) - 1;
    n_tiles = max(0, min(n_tiles, (last_row + offset) / kBK + 1));
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's Kt, Vs and Ps are consumed
    for (int idx = tid; idx < kBK * DK; idx += kThreads) {
      const int r = idx / DK, d = idx - r * DK;
      const int kr = k0 + r;
      Kt[d * kPad + r] = kr < kv_end ? kb[long(kr) * DK + d] : 0.f;
    }
    for (int idx = tid; idx < kBK * DV; idx += kThreads) {
      const int r = idx / DV, d = idx - r * DV;
      const int kr = k0 + r;
      Vs[r * DV + d] = kr < kv_end ? vb[long(kr) * DV + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[d * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + offset;
      float row_max = -INFINITY;
      bool valid[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < kv_end && (!causal || kpos <= qpos);
        if (valid[j]) row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m_i[i], row_max);
      const float alpha =
          m_i[i] == -INFINITY ? 0.f : expf(m_i[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        row_sum += p;
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l_i[i] = l_i[i] * alpha + row_sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPad + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vv = Vs[kk * DV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  float* ob = out + ((long(b) * Hq + h) * Lq) * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Lq) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      ob[long(qr) * DV + tx + 16 * c] = acc[i][c] * inv;
    if (lse != nullptr && tx == 0)
      lse[(long(b) * Hq + h) * Lq + qr] = m_i[i] + logf(l_i[i]);
  }
}

template <int DK, int DV>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* q_offset, const int* kv_len, int B,
                int Hq, int Hkv, int Lq, int Lk, int causal, float scale,
                cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes_fp32<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, Hq, B), block(kThreads);
  flash_fp32<DK, DV><<<grid, block, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, q_offset,
      kv_len, Hq, Hkv, Lq, Lk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, const int* q_offset, const int* kv_len, int B, int Hq,
           int Hkv, int Lq, int Lk, int causal, float scale, int dtype,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_fp32<DK, DV>(q, k, v, out, lse, q_offset, kv_len, B, Hq,
                               Hkv, Lq, Lk, causal, scale, stream);
  return launch_wgmma<DK, DV>(q, k, v, out, lse, q_offset, kv_len, B, Hq,
                              Hkv, Lq, Lk, causal, scale, stream);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      const int* q_offset, const int* kv_len,
                                      int B, int Hq, int Hkv, int Lq, int Lk,
                                      int D, int Dv, int causal, float scale,
                                      int dtype, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0 ||
      ((causal || q_offset != nullptr) && Lq > Lk) || Hq > 65535 ||
      B > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_CASE(DK, DV)                                             \
  if (D == DK && Dv == DV)                                                   \
    return launch<DK, DV>(q, k, v, out, lse, q_offset, kv_len, B, Hq, Hkv,   \
                          Lq, Lk, causal, scale, dtype, stream);
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(256, 256)
  REPRO_FLASH_CASE(192, 128)
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
