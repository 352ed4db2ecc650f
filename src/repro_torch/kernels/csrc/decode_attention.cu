// Flash-decoding: one-token GQA attention over a KV cache, for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention_pallas.
// q (B, Hq, D); a key cache (B, Hkv, L, D) and a value cache (B, Hkv, L,
// Dv), head-major and contiguous, one type (fp32 or bf16); the output
// (B, Hq, Dv).  The head dims are a template pair <D, Dv>: Dv = D for the
// GQA models, (192, 128) for MLA's expanded latent cache (group 1, its
// scale passed by the caller); kv_len (B,) int32 valid lengths, or null for
// all L.  A length above L masks nothing (min(kv_len[b], L)); a length
// below 1 gives NaN rows, as the softmax of no logits does.  Query head h
// reads kv head h / G with G = Hq / Hkv <= 8.
//
// Bound: bytes.  Every valid cache row is read once ((D + Dv) kv_len
// elements per kv head) against 2 G (D + Dv) flops per row; at gemma-2b's
// batched decode (B 4, Hkv 1, G 8, D 256, L 6176, bf16) that is 25 MB,
// 7.6 us at 3.35 TB/s.  The TPU kernel walks L in sequence inside one
// program per (batch, kv head); the H100 needs the cache split across
// its SMs, many bytes in flight on each, little work per byte, and a
// short merge of the splits.  So, in one launch:
//   * splits sized to the card: with few (batch, kv head) pairs, clusters
//     of 8 blocks, as many as the card holds at once shared out over the
//     pairs; with more pairs than that, one cluster of 4, 2 or 1 block a
//     pair, so the grid about fills the card once; each block a run of
//     about L / splits keys (at least 64 where L allows); blocks past
//     kv_len do no work;
//   * K and V through shared memory: each 32-key tile is copied by 16-byte
//     cp.async, every thread a share, counted on the stage's mbarrier,
//     into rows padded by 16 bytes, so the fragment loads below meet no
//     bank conflict; a ring of 3 stages at D = 256 bf16 (101 KB, two
//     blocks an SM) keeps up to 200 KB in flight an SM.  (Whole-tile
//     bulk copies would leave the rows unpadded, and one bulk copy per
//     row streamed at a fraction of the card's rate on the chip.)
//   * bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulation):
//     the query group padded to 16 rows is A, from registers; each warp
//     forms S = Q K^T for 8 keys of a tile (B by ldmatrix); one online
//     softmax update per tile in fp32 (exp2, the scale applied to S, the
//     tile's max over the four warps through shared memory); each warp
//     then forms O += P V for a quarter of D over the tile's 32 keys,
//     with P split into bf16 P_hi + P_lo so the product keeps fp32-grade
//     weights (P rounded to bf16 once misses the row gate; see
//     flash_attention.cu);
//   * fp32 on the CUDA cores (a tensor-core fp32 product is TF32, which
//     the fp32 limit of 1e-5 refuses): lanes across D, each warp 8 keys
//     of a tile, the logits of 4 keys x 8 heads summed over the warp by
//     one transposing butterfly, the four warps' states merged at the end;
//   * the merge in the same launch: each block leaves its partial
//     (m, l, o) in its shared memory; the blocks of a cluster merge them
//     through distributed shared memory, each block its share of D;
//     with more than one cluster per (batch, kv head) each writes its
//     merged slice, and the last block to take the slice's ticket merges
//     the clusters' slices in cluster order.  Tickets go back to 0 at
//     once, and no float atomics are used, so repeated launches are
//     bit-identical.  The caller owns the tickets (zeroed once, left at 0
//     by every launch): one buffer per stream, so launches on two streams
//     never share a ticket.
//
// C interface (ctypes):
//   decode_attention_plan(B, Hq, Hkv, L, D, Dv, dtype, int* split_keys,
//                         int* n_splits, int* tickets) -> scratch floats
//                         (int64, < 0 if the shape is refused);
//   decode_attention_launch(q, k, v, kv_len, out, scratch, tickets, B, Hq,
//                           Hkv, L, D, Dv, scale, dtype, stream);
// dtype 0 = float32, 1 = bfloat16; (D, Dv) one of (32, 32), (64, 64),
// (128, 128), (256, 256) and (192, 128); q, k, v and
// scratch 16-byte aligned; scratch holds the plan's floats and tickets
// the plan's zeroed uint32 counters, each null when its count is 0.  The
// launch returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                      // keys per ring stage
constexpr int kKeysPerWarp = kTile / kWarps;   // 8
constexpr int kGroup = 8;                      // query heads, padded
constexpr int kMaxCluster = 8;                 // blocks merged on chip
constexpr int kMinSplitKeys = 64;
constexpr int kMaxDevices = 64;
constexpr int kRingBudget = 104 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

// DK: the head dim of q and the key cache; DV: of the value cache and the
// output
template <typename T, int DK, int DV> struct Cfg {
  static constexpr int kRowK = DK * int(sizeof(T)) + 16;  // padded rows
  static constexpr int kRowV = DV * int(sizeof(T)) + 16;
  static constexpr int kKTileBytes = kTile * kRowK;
  static constexpr int kStageBytes = kTile * (kRowK + kRowV);  // K then V
  static constexpr int kFit = kRingBudget / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 6 ? 6 : kFit);
  static constexpr int kRing = kStages * kStageBytes;
  // the block's partial (m[8], l[8], o[8][DV]) and, for fp32, the four
  // warps' states it is merged from, over the idle ring
  static_assert((2 * kGroup + kGroup * DV) * 4 +
                        (sizeof(T) == 4 ? kWarps * (2 + DV) * kGroup * 4
                                        : 0) <=
                    kRing,
                "the partials fit in the ring");
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// E consecutive fp32 values at p (shared memory, aligned to 16 bytes when
// E is a multiple of 4, else to 8 when E is even)
template <int E>
__device__ __forceinline__ void load_slice(const float* p, float (&f)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 u = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = u.x; f[4 * i + 1] = u.y; f[4 * i + 2] = u.z;
      f[4 * i + 3] = u.w;
    }
  } else if constexpr (E % 2 == 0) {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 u = reinterpret_cast<const float2*>(p)[i];
      f[2 * i] = u.x; f[2 * i + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = p[i];
  }
}

// One halving exchange of transpose_reduce: lanes with bit HALF set keep
// v[HALF..2*HALF), the others v[0..HALF), each adding its partner's copy.
template <int HALF>
__device__ __forceinline__ void exchange(float (&v)[32], int lane) {
  const bool up = lane & HALF;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = up ? v[j] : v[j + HALF];
    const float keep = up ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// v[i] summed over the warp's lanes for i = lane: five halving exchanges
// (every index known at compile time, so v stays in registers)
__device__ __forceinline__ float transpose_reduce(float (&v)[32], int lane) {
  exchange<16>(v, lane);
  exchange<8>(v, lane);
  exchange<4>(v, lane);
  exchange<2>(v, lane);
  exchange<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// A block's work: keys [key0, key1) of (batch, kv head) bh, in n_tiles
// tiles; k and v point at the head's rows.
template <typename T> struct Span {
  int bh, key0, key1, n_tiles;
  const T* k;
  const T* v;
};

// Tile t of the span into stage t % kStages, called by every thread: the
// tile's rows of K and V (contiguous in the cache) in 16-byte cp.async
// chunks, the threads taking turns, into the padded rows; each thread's
// copies arrive on the stage's barrier (count kThreads) when they land.
template <typename T, int DK, int DV>
__device__ __forceinline__ void issue_tile(int t, const Span<T>& sp,
                                           unsigned char* ring,
                                           uint64_t* full) {
  using C = Cfg<T, DK, DV>;
  constexpr int kChunksK = DK * int(sizeof(T)) / 16;   // a row's chunks
  constexpr int kChunksV = DV * int(sizeof(T)) / 16;
  const int s = t % C::kStages;
  const int first = sp.key0 + t * kTile;
  const int rows = min(kTile, sp.key1 - first);
  const unsigned char* k_src =
      reinterpret_cast<const unsigned char*>(sp.k + long(first) * DK);
  const unsigned char* v_src =
      reinterpret_cast<const unsigned char*>(sp.v + long(first) * DV);
  const uint32_t dst = hopper::smem_u32(ring + s * C::kStageBytes);
  for (int i = threadIdx.x; i < rows * kChunksK; i += kThreads) {
    const uint32_t at = (i / kChunksK) * C::kRowK + (i % kChunksK) * 16;
    hopper::cp_async_16(dst + at, k_src + i * 16);
    if constexpr (DK == DV)
      hopper::cp_async_16(dst + C::kKTileBytes + at, v_src + i * 16);
  }
  if constexpr (DK != DV) {
    for (int i = threadIdx.x; i < rows * kChunksV; i += kThreads) {
      const uint32_t at = (i / kChunksV) * C::kRowV + (i % kChunksV) * 16;
      hopper::cp_async_16(dst + C::kKTileBytes + at, v_src + i * 16);
    }
  }
  hopper::cp_async_arrive(hopper::smem_u32(&full[s]));
}

// The tile loop of bf16 on the tensor cores; leaves the block's partial
// (m, l over the block's keys, o unnormalised) at bp: m[8], l[8], o[8][DV].
template <int DK, int DV>
__device__ __forceinline__ void tile_loop_mma(
    const __nv_bfloat16* __restrict__ q, const Span<__nv_bfloat16>& sp,
    int G, float scale_log2, unsigned char* ring, uint64_t* full,
    float* bp) {
  using C = Cfg<__nv_bfloat16, DK, DV>;
  constexpr int kSteps = DK / 16;        // k-steps of S = Q K^T
  constexpr int kBlocks = DV / 32;       // 8-column blocks of O a warp
  __shared__ __align__(16) uint32_t p_hi[kGroup][kTile / 2 + 4];
  __shared__ __align__(16) uint32_t p_lo[kGroup][kTile / 2 + 4];
  __shared__ float red_max[kWarps][kGroup], red_sum[kWarps][kGroup];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // A of S: row gid of the query group (rows 8-15 are zero)
  uint32_t qa[kSteps][2];
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
      q + (long(sp.bh) * G + gid) * DK);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    qa[s][0] = gid < G ? qrow[s * 8 + tig] : 0u;
    qa[s][1] = gid < G ? qrow[s * 8 + 4 + tig] : 0u;
  }
  float o[kBlocks][4];
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb)
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;   // of head gid
  const int d_warp = warp * (DV / 4);

  for (int t = 0; t < sp.n_tiles; ++t) {
    const int s = t % C::kStages;
    hopper::mbar_wait(hopper::smem_u32(&full[s]), (t / C::kStages) & 1);
    unsigned char* ks = ring + s * C::kStageBytes;
    unsigned char* vs = ks + C::kKTileBytes;
    const int valid = min(kTile, sp.key1 - (sp.key0 + t * kTile));

    // S for keys 8 warp .. 8 warp + 7: row gid, keys 2 tig and 2 tig + 1
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t k_row = hopper::smem_u32(
        ks + (warp * kKeysPerWarp + (lane & 7)) * C::kRowK + (lane >> 3) * 16);
#pragma unroll
    for (int kb = 0; kb < kSteps; kb += 2) {
      uint32_t b[4];
      hopper::ldmatrix_x4(b, k_row + kb * 32);
      hopper::mma_bf16_16816(sc, qa[kb][0], 0u, qa[kb][1], 0u, b[0], b[1]);
      hopper::mma_bf16_16816(sc, qa[kb + 1][0], 0u, qa[kb + 1][1], 0u, b[2],
                             b[3]);
    }
    const int key = warp * kKeysPerWarp + 2 * tig;
    const float s0 = key < valid ? sc[0] * scale_log2 : -INFINITY;
    const float s1 = key + 1 < valid ? sc[1] * scale_log2 : -INFINITY;
    float mx = fmaxf(s0, s1);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (tig == 0) red_max[warp][gid] = mx;
    __syncthreads();
    // every warp is past the P V of tile t - 1: its stage may be refilled
    if (t > 0 && t - 1 + C::kStages < sp.n_tiles)
      issue_tile<__nv_bfloat16, DK, DV>(t - 1 + C::kStages, sp, ring, full);

    // the tile's max (finite: it holds a valid key), then P = 2^(S - m)
    float tile_max = red_max[0][gid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      tile_max = fmaxf(tile_max, red_max[w][gid]);
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = exp2f(m_run - m_new);
    const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
    const float h0 = __bfloat162float(__float2bfloat16(p0));
    const float h1 = __bfloat162float(__float2bfloat16(p1));
    p_hi[gid][key / 2] = pack_bf16(h0, h1);
    p_lo[gid][key / 2] = pack_bf16(p0 - h0, p1 - h1);
    float psum = p0 + p1;
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    if (tig == 0) red_sum[warp][gid] = psum;
    if (valid < kTile) {
      // rows past the valid keys may hold anything; P is 0 there, and
      // 0 * V must be 0
      uint4* rows = reinterpret_cast<uint4*>(vs + valid * C::kRowV);
      for (int i = threadIdx.x; i < (kTile - valid) * C::kRowV / 16;
           i += kThreads)
        rows[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    float tile_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tile_sum += red_sum[w][gid];
    l_run = fmaf(l_run, alpha, tile_sum);
    m_run = m_new;

    // O[:, d_warp .. d_warp + DV / 4) = alpha O + (P_hi + P_lo) V
    uint32_t ah[2][2], al[2][2];
#pragma unroll
    for (int ksp = 0; ksp < 2; ++ksp) {
      ah[ksp][0] = p_hi[gid][ksp * 8 + tig];
      ah[ksp][1] = p_hi[gid][ksp * 8 + 4 + tig];
      al[ksp][0] = p_lo[gid][ksp * 8 + tig];
      al[ksp][1] = p_lo[gid][ksp * 8 + 4 + tig];
    }
    const uint32_t v_row =
        hopper::smem_u32(vs + lane * C::kRowV + d_warp * 2);
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
      o[nb][0] *= alpha;
      o[nb][1] *= alpha;
      uint32_t b[4];   // keys 0-7, 8-15 (k-step 0), 16-23, 24-31 (k-step 1)
      hopper::ldmatrix_x4_trans(b, v_row + nb * 16);
#pragma unroll
      for (int ksp = 0; ksp < 2; ++ksp) {
        hopper::mma_bf16_16816(o[nb], ah[ksp][0], 0u, ah[ksp][1], 0u,
                               b[2 * ksp], b[2 * ksp + 1]);
        hopper::mma_bf16_16816(o[nb], al[ksp][0], 0u, al[ksp][1], 0u,
                               b[2 * ksp], b[2 * ksp + 1]);
      }
    }
  }
  __syncthreads();   // the ring is idle: the partial goes over it
  if (warp == 0 && tig == 0) {
    bp[gid] = m_run;
    bp[kGroup + gid] = l_run;
  }
  float* bo = bp + 2 * kGroup + gid * DV + d_warp + 2 * tig;
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb)
    *reinterpret_cast<float2*>(bo + nb * 8) = make_float2(o[nb][0], o[nb][1]);
}

// The tile loop of fp32 on the CUDA cores; leaves the block's partial at
// bp as tile_loop_mma does.
template <int DK, int DV>
__device__ __forceinline__ void tile_loop_fp32(const float* __restrict__ q,
                                               const Span<float>& sp, int G,
                                               float scale_log2,
                                               unsigned char* ring,
                                               uint64_t* full, float* bp) {
  using C = Cfg<float, DK, DV>;
  constexpr int E = DK / 32;    // elements of a q / key row per lane
  constexpr int EV = DV / 32;   // of a value row and the output
  __shared__ __align__(16) float sp_w[kWarps][kKeysPerWarp][kGroup];
  __shared__ float salpha[kWarps][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the query group, scaled into the exp2 domain: qv[g][e] = q[g, lane*E+e]
  float qv[kGroup][E];
  const float* qb = q + long(sp.bh) * G * DK + lane * E;
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qv[g][e] = g < G ? qb[g * DK + e] * scale_log2 : 0.f;
  // lane l keeps (m, l) of head l % 8 and acc[g][e] of o[g, lane*EV + e]
  float m = -INFINITY, lsum = 0.f;
  float acc[kGroup][EV];
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[g][e] = 0.f;

  const int wk0 = warp * kKeysPerWarp;
  for (int t = 0; t < sp.n_tiles; ++t) {
    const int s = t % C::kStages;
    hopper::mbar_wait(hopper::smem_u32(&full[s]), (t / C::kStages) & 1);
    const unsigned char* ks = ring + s * C::kStageBytes;
    const unsigned char* vs = ks + C::kKTileBytes;
    const int valid = min(kTile, sp.key1 - (sp.key0 + t * kTile));
    const int wn = min(max(valid - wk0, 0), kKeysPerWarp);  // warp's keys

    float sc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float dots[32];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float kf[E];
        if (r * 4 + kk < wn) {
          load_slice<E>(reinterpret_cast<const float*>(
                            ks + (wk0 + r * 4 + kk) * C::kRowK) + lane * E,
                        kf);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d = fmaf(qv[g][e], kf[e], d);
          dots[kk * kGroup + g] = d;
        }
      }
      sc[r] = transpose_reduce(dots, lane);
      if (r * 4 + (lane >> 3) >= wn) sc[r] = -INFINITY;
    }
    // online softmax of head lane % 8 over the warp's keys of this tile
    float mx = fmaxf(sc[0], sc[1]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m, mx);
    const bool none = m_new == -INFINITY;      // no key of this warp yet
    const float alpha = none ? 1.f : exp2f(m - m_new);
    const float p0 = none ? 0.f : exp2f(sc[0] - m_new);
    const float p1 = none ? 0.f : exp2f(sc[1] - m_new);
    float psum = p0 + p1;
    psum += __shfl_xor_sync(0xffffffffu, psum, 8);
    psum += __shfl_xor_sync(0xffffffffu, psum, 16);
    lsum = fmaf(lsum, alpha, psum);
    m = m_new;
    sp_w[warp][lane >> 3][lane & 7] = p0;
    sp_w[warp][4 + (lane >> 3)][lane & 7] = p1;
    if (lane < kGroup) salpha[warp][lane] = alpha;
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float a = salpha[warp][g];
#pragma unroll
      for (int e = 0; e < EV; ++e) acc[g][e] *= a;
    }
    for (int kk = 0; kk < wn; ++kk) {
      float vf[EV];
      load_slice<EV>(
          reinterpret_cast<const float*>(vs + (wk0 + kk) * C::kRowV) +
              lane * EV,
          vf);
      const float4 pa = *reinterpret_cast<const float4*>(&sp_w[warp][kk][0]);
      const float4 pb = *reinterpret_cast<const float4*>(&sp_w[warp][kk][4]);
      const float p[kGroup] = {pa.x, pa.y, pa.z, pa.w,
                               pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[g][e] = fmaf(p[g], vf[e], acc[g][e]);
    }
    __syncthreads();   // every warp is done with stage s (and with sp_w)
    if (t + C::kStages < sp.n_tiles)
      issue_tile<float, DK, DV>(t + C::kStages, sp, ring, full);
  }

  // the four warps' states, over the idle ring after the block's partial
  float* wm = bp + 2 * kGroup + kGroup * DV;
  float* wl = wm + kWarps * kGroup;
  float* wo = wl + kWarps * kGroup;
  if (lane < kGroup) {
    wm[warp * kGroup + lane] = m;
    wl[warp * kGroup + lane] = lsum;
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int e = 0; e < EV; ++e)
      wo[(warp * kGroup + g) * DV + lane * EV + e] = acc[g][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kGroup * DV; idx += kThreads) {
    const int g = idx / DV;
    float mw = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, wm[w * kGroup + g]);
    float ov = 0.f, lw = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mm = wm[w * kGroup + g];
      const float c = mm == -INFINITY ? 0.f : exp2f(mm - mw);
      ov = fmaf(c, wo[w * kGroup * DV + idx], ov);
      lw = fmaf(c, wl[w * kGroup + g], lw);
    }
    bp[2 * kGroup + idx] = ov;
    if (idx % DV == 0) {
      bp[g] = mw;
      bp[kGroup + g] = lw;
    }
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ out, float* __restrict__ part,
              unsigned int* __restrict__ tickets, int G, int L,
              int split_keys, int n_clusters, float scale_log2) {
  using C = Cfg<T, DK, DV>;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[C::kStages];
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  T* out_rows = out + long(bh) * G * DV;
  const int len = kv_len ? min(kv_len[blockIdx.z], L) : L;
  if (len <= 0) {
    if (split == 0)
      for (int i = threadIdx.x; i < G * DV; i += kThreads)
        out_rows[i] = from_f32<T>(NAN);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int n_valid = (len + split_keys - 1) / split_keys;   // splits
  const int n_live = (n_valid + csize - 1) / csize;          // clusters
  const int cluster_id = split / csize;
  if (cluster_id >= n_live) return;   // the whole cluster has no keys

  Span<T> sp;
  sp.bh = bh;
  sp.key0 = min(split * split_keys, len);
  sp.key1 = min(sp.key0 + split_keys, len);
  sp.n_tiles = (sp.key1 - sp.key0 + kTile - 1) / kTile;
  sp.k = k + long(bh) * L * DK;
  sp.v = v + long(bh) * L * DV;
  float* bp = reinterpret_cast<float*>(ring);   // m[8], l[8], o[8][DV]

  if (sp.n_tiles > 0) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < C::kStages; ++s)
        hopper::mbar_init(hopper::smem_u32(&full[s]), kThreads);
    }
    __syncthreads();
    for (int t = 0; t < min(C::kStages, sp.n_tiles); ++t)
      issue_tile<T, DK, DV>(t, sp, ring, full);
    if constexpr (sizeof(T) == 2)
      tile_loop_mma<DK, DV>(q, sp, G, scale_log2, ring, full, bp);
    else
      tile_loop_fp32<DK, DV>(q, sp, G, scale_log2, ring, full, bp);
  } else {   // a block of a live cluster without keys: an empty partial
    for (int i = threadIdx.x; i < 2 * kGroup + kGroup * DV; i += kThreads)
      bp[i] = i < kGroup ? -INFINITY : 0.f;
  }

  // the cluster's partials merged through distributed shared memory,
  // block `rank` of csize taking columns [rank * DV / csize, ...)
  cluster.sync();
  const int slice = DV / csize;
  const int rank = static_cast<int>(cluster.block_rank());
  float* part_o = part;
  float* part_ml = part + long(gridDim.y) * gridDim.z * n_clusters * G * DV;
  const long cl = long(bh) * n_clusters + cluster_id;   // this cluster
  for (int i = threadIdx.x; i < G * slice; i += kThreads) {
    const int g = i / slice, d = rank * slice + i % slice;
    float mj[kMaxCluster], lj[kMaxCluster], oj[kMaxCluster];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < csize) {
        const float* rb = cluster.map_shared_rank(bp, j);
        mj[j] = rb[g];
        lj[j] = rb[kGroup + g];
        oj[j] = rb[2 * kGroup + g * DV + d];
        mx = fmaxf(mx, mj[j]);
      }
    }
    float ov = 0.f, lw = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < csize && mj[j] != -INFINITY) {
        const float c = exp2f(mj[j] - mx);
        ov = fmaf(c, oj[j], ov);
        lw = fmaf(c, lj[j], lw);
      }
    }
    if (n_live == 1) {
      out_rows[g * DV + d] = from_f32<T>(ov / lw);
    } else {
      part_o[(cl * G + g) * DV + d] = ov;
      if (i % slice == 0)
        *reinterpret_cast<float2*>(
            part_ml + ((cl * csize + rank) * G + g) * 2) =
            make_float2(mx, lw);
    }
  }
  cluster.sync();   // no block leaves while another reads its partial
  if (n_live == 1) return;

  // the last block to finish slice `rank` merges it over the clusters
  __threadfence();
  __syncthreads();
  unsigned int* ticket = tickets + bh * csize + rank;
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ticket, 1u) == unsigned(n_live - 1);
    if (s_last) *ticket = 0u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long cl0 = long(bh) * n_clusters;
  for (int i = threadIdx.x; i < G * slice; i += kThreads) {
    const int g = i / slice, d = rank * slice + i % slice;
    float mx = -INFINITY, ov = 0.f, lw = 0.f;
#pragma unroll 4
    for (int c = 0; c < n_live; ++c) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          part_ml + (((cl0 + c) * csize + rank) * G + g) * 2));
      const float oc = __ldcg(part_o + ((cl0 + c) * G + g) * DV + d);
      const float m_new = fmaxf(mx, ml.x);
      const float a = exp2f(mx - m_new), b = exp2f(ml.x - m_new);
      ov = fmaf(ov, a, b * oc);
      lw = fmaf(lw, a, b * ml.y);
      mx = m_new;
    }
    out_rows[g * DV + d] = from_f32<T>(ov / lw);
  }
}

int sm_count(int dev) {
  static int counts[kMaxDevices];
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return counts[dev];
}

template <typename T, int DK, int DV>
cudaLaunchConfig_t config(int blocks_x, int Hkv, int B, int csize,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_x, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<T, DK, DV>::kRing;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// What the card holds of this instantiation at once, read once per
// device (after allowing the ring's shared memory): clusters of 8 and
// single blocks.  {0, 0} on failure.
struct Room {
  int clusters8, blocks;
};

template <typename T, int DK, int DV>
Room room(int dev) {
  static Room fit[kMaxDevices];
  if (fit[dev].blocks == 0) {
    if (cudaFuncSetAttribute(decode_kernel<T, DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<T, DK, DV>::kRing) != cudaSuccess)
      return Room{0, 0};
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, decode_kernel<T, DK, DV>, kThreads,
            Cfg<T, DK, DV>::kRing) != cudaSuccess || per_sm <= 0)
      return Room{0, 0};
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        config<T, DK, DV>(kMaxCluster, 1, 1, kMaxCluster, nullptr, &attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, decode_kernel<T, DK, DV>, &cfg) !=
            cudaSuccess || n <= 0) {
      cudaGetLastError();   // a failed query is not the launch's error
      n = std::max(1, sm_count(dev) * per_sm / kMaxCluster);
    }
    fit[dev] = Room{n, sm_count(dev) * per_sm};
  }
  return fit[dev];
}

struct Plan {
  int split_keys, csize, n_clusters;   // per (batch, kv head)
  long long floats;                    // scratch
  int tickets;                         // merge counters
};

// Splits of one (batch, kv head): with few pairs, the card's resident
// clusters of 8 shared out over them; with more pairs than clusters,
// clusters of 4, 2 or 1 block so that the grid about fills the card once.
// A split is at least kMinSplitKeys keys where L allows.
Plan plan_for(int B, int Hq, int Hkv, int L, int DV, Room r) {
  const int bh = B * Hkv;
  const int longest = std::max(1, L / kMinSplitKeys);   // splits L allows
  Plan p;
  p.csize = kMaxCluster;
  p.n_clusters = std::max(1, r.clusters8 / bh);
  if (bh > r.clusters8) {
    const int want = std::max(1, r.blocks / bh);
    p.csize = want >= 4 ? 4 : (want >= 2 ? 2 : 1);
    p.n_clusters = 1;
  }
  while (p.csize * p.n_clusters > longest && p.n_clusters > 1) --p.n_clusters;
  while (p.csize * p.n_clusters > longest && p.csize > 1) p.csize /= 2;
  const int splits = p.csize * p.n_clusters;
  p.split_keys = (L + splits - 1) / splits;
  p.floats = p.n_clusters > 1 ? static_cast<long long>(bh) * p.n_clusters *
                                    (Hq / Hkv) * (DV + 2 * p.csize)
                              : 0;
  p.tickets = p.n_clusters > 1 ? bh * p.csize : 0;
  return p;
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* scratch, unsigned int* tickets, int B, int Hq,
           int Hkv, int L, float scale, int dev, cudaStream_t stream) {
  const Room r = room<T, DK, DV>(dev);
  if (r.blocks == 0) return static_cast<int>(cudaGetLastError());
  const Plan p = plan_for(B, Hq, Hkv, L, DV, r);
  if (p.n_clusters > 1 && (scratch == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config<T, DK, DV>(p.n_clusters * p.csize, Hkv, B,
                                             p.csize, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_kernel<T, DK, DV>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      static_cast<T*>(out), scratch, tickets, Hq / Hkv, L, p.split_keys,
      p.n_clusters, scale * kLog2e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the head-dim pairs (D of q and the key cache, Dv of the value cache) the
// kernel is built for: Dv = D for GQA, (192, 128) for MLA's expanded cache
#define REPRO_DECODE_PAIRS(X) \
  X(32, 32) X(64, 64) X(128, 128) X(256, 256) X(192, 128)

template <typename T>
Room room(int D, int Dv, int dev) {
#define REPRO_ROOM(DK, DV) \
  if (D == DK && Dv == DV) return room<T, DK, DV>(dev);
  REPRO_DECODE_PAIRS(REPRO_ROOM)
#undef REPRO_ROOM
  return Room{0, 0};
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v,
               const int* kv_len, void* out, float* scratch,
               unsigned int* tickets, int B, int Hq, int Hkv, int L, int D,
               int Dv, float scale, int dev, cudaStream_t stream) {
#define REPRO_LAUNCH(DK, DV)                                                 \
  if (D == DK && Dv == DV)                                                   \
    return launch<T, DK, DV>(q, k, v, kv_len, out, scratch, tickets, B, Hq,  \
                             Hkv, L, scale, dev, stream);
  REPRO_DECODE_PAIRS(REPRO_LAUNCH)
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

bool pair_ok(int D, int Dv) {
#define REPRO_PAIR(DK, DV) if (D == DK && Dv == DV) return true;
  REPRO_DECODE_PAIRS(REPRO_PAIR)
#undef REPRO_PAIR
  return false;
}

bool shape_ok(int B, int Hq, int Hkv, int L, int D, int Dv, int dtype) {
  return B > 0 && Hkv > 0 && L > 0 && Hq % Hkv == 0 && Hq / Hkv >= 1 &&
         Hq / Hkv <= kGroup && B <= 65535 && Hkv <= 65535 &&
         pair_ok(D, Dv) && (dtype == 0 || dtype == 1);
}

int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

}  // namespace

extern "C" long long decode_attention_plan(int B, int Hq, int Hkv, int L,
                                           int D, int Dv, int dtype,
                                           int* split_keys, int* n_splits,
                                           int* tickets) {
  const int dev = current_device();
  if (dev < 0 || !shape_ok(B, Hq, Hkv, L, D, Dv, dtype)) return -1;
  const Room r = dtype == 0 ? room<float>(D, Dv, dev)
                            : room<__nv_bfloat16>(D, Dv, dev);
  if (r.blocks == 0) return -1;
  const Plan p = plan_for(B, Hq, Hkv, L, Dv, r);
  if (split_keys) *split_keys = p.split_keys;
  if (n_splits) *n_splits = p.n_clusters * p.csize;
  if (tickets) *tickets = p.tickets;
  return p.floats;
}

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* out, void* scratch,
                                       void* tickets, int B, int Hq, int Hkv,
                                       int L, int D, int Dv, float scale,
                                       int dtype, cudaStream_t stream) {
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!shape_ok(B, Hq, Hkv, L, D, Dv, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) |
        reinterpret_cast<uintptr_t>(scratch)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int* lens = static_cast<const int*>(kv_len);
  float* part = static_cast<float*>(scratch);
  unsigned int* counters = static_cast<unsigned int*>(tickets);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, lens, out, part, counters, B, Hq, Hkv,
                             L, D, Dv, scale, dev, stream);
  return dispatch_d<__nv_bfloat16>(q, k, v, lens, out, part, counters, B, Hq,
                                   Hkv, L, D, Dv, scale, dev, stream);
}
