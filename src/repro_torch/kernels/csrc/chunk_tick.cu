// One chunk-diff / delta-coherence tick of the content plane over B
// simulations.
//
// Replaces the TPU kernel `chunk_tick_pallas` of the JAX package
// (src/repro/kernels/chunk_diff.py, body `_chunk_kernel`) and computes
// exactly what it computes; the plain PyTorch version beside the wrapper
// (repro_torch/kernels/chunk_diff.py, `chunk_tick_plain_`) is the reference
// it is held to, output for output.
//
// Per simulation s, for each agent a in ascending order, with d = arts[s,a]:
//   * where miss[s,a] (the MESI tick's fill indicator for the same step):
//     the chunks c with chunk_version[s,d,c] > chunk_sync[s,a,d,c] are
//     fetched; delta_bytes += (their token sizes + signal) * bytes/token,
//     full_bytes += (artifact_tokens + signal) * bytes/token, and the
//     reader's vector is synced to the authority's;
//   * where write_acts[s,a]: the chunks of the write span are bumped and
//     marked dirty, and the writer's vector is synced to the new versions.
// Chunk sizes: chunk_tokens each, the last one ragged,
// artifact_tokens - (C-1)*chunk_tokens.  fetched (B, n, C) holds each
// agent's fetched-chunk mask; counters (B, 4): delta_bytes, full_bytes,
// n_chunks_fetched, 0.  chunk_version, chunk_sync and chunk_dirty are
// updated IN PLACE, chunk_sync (the large array, B*n*m*C words) only at the
// rows (s, a, arts[s,a]) of agents that miss or write.
//
// Bound on an H100: integer compares and adds, a few per word it touches, so
// the kernel is memory-bound: its least time is the bytes it must move over
// the card's memory rate (3.35 TB/s on the SXM part).  A simulation's agents
// run in serial order, so the first design (one warp walking the agents,
// each agent's flags, then its rows, then its stores: two or three DRAM
// round trips an agent, one row access in flight a warp) sat at under half
// the bound.  This design puts every row a simulation reads in flight
// before its serial loop starts: two round trips a simulation.
//
// Design (the staged path: n and m up to 32, C a multiple of 4, the row
// buffers 16-byte aligned).  A group of W lanes runs one simulation (W the
// least power of two that holds its agents and a row's C / 4 four-word
// pieces, at most 32: 16 at the fleet's n = 16, C = 64, so two simulations
// a warp):
//   1. flags first: lane q reads agent q's miss, write flag and artifact in
//      one coalesced access; ballots give the fill set and the write set,
//      an OR across the group the artifacts addressed, and each agent's
//      artifact goes to a small shared array;
//   2. every row the tick reads is copied into the simulation's staging
//      area in shared memory with 16-byte cp.async, all issued before any
//      is waited on: the chunk_version row of each distinct addressed
//      artifact (once, so that agent a's bump is what agent a+1 compares
//      against), the chunk_sync row of each filling agent and the
//      write_chunks row of each writer, compacted in that order (the area
//      holds the most a simulation can read: min(n, m) + 2n rows);
//   3. the agents in ascending order on shared memory: lane q owns words
//      4q .. 4q+3 of every staged row, and copied exactly those words, so
//      its own cp.async.wait_group is all the synchronisation the loop
//      needs (no barrier) and the serial chain on an artifact's row stays
//      inside each lane.  A busy agent compares and bumps, stores its
//      fetched and chunk_sync words with 16-byte stores and the dirty
//      words of its bump; an idle agent stores zeros to fetched.  Token
//      and chunk counts build up in each lane's registers (integer sums,
//      exact in any order) and are summed across the group once, at the
//      end;
//   4. each lane stores back the chunk_version words it bumped.
// A row longer than 4W words is taken in tiles of 4W chunks, one after
// another; chunks are independent, only the counters join them.
// (Two other shapes read slower on an H100: a staging area for fewer rows,
// with shorter tiles where a simulation reads more, which fits more
// simulations on an SM; and persistent groups that stage the next
// simulation while the loop runs.)
// The direct path (a warp per simulation on the global buffers, the first
// design of this kernel) takes every other shape: more than 32 agents or
// artifacts (the ballots' masks), C not a multiple of 4 or a buffer not
// 16-byte aligned (the 16-byte copies and stores).
//
// C interface (ctypes): chunk_tick_launch(chunk_version, chunk_sync,
// chunk_dirty, miss, write_acts, arts, write_chunks, fetched, counters, B,
// n, m, C, chunk_tokens, artifact_tokens, signal_tokens, bytes_per_token,
// stream), all int32 and contiguous; returns cudaGetLastError().
// chunk_tick_plan(n, m, C) gives the simulations a block of the staged path
// runs for 16-byte aligned buffers (0: the direct path runs the shape).

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kDirectThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// the staged path's budget: a lane per agent, a bit per agent and per
// artifact in a 32-bit mask
constexpr int kMaxStagedAgents = 32;
constexpr int kMaxStagedArtifacts = 32;
constexpr int kMaxStagedWarps = 4;
// a staged block's shared memory, at most (more warps a block while a
// warp's staging stays within it)
constexpr int kStagedBlockBytes = 48 * 1024;

// The tick's sizes and options, passed by value.
struct Opts {
  int n, m, C, chunk_tokens, artifact_tokens, signal_tokens,
      bytes_per_token;
};

// The global buffers, the tick's options and the staged path's geometry.
struct Buffers {
  int* __restrict__ chunk_version;
  int* __restrict__ chunk_sync;
  int* __restrict__ chunk_dirty;
  const int* __restrict__ miss;
  const int* __restrict__ write_acts;
  const int* __restrict__ arts;
  const int* __restrict__ write_chunks;
  int* __restrict__ fetched;
  int* __restrict__ counters;
  int B;
  Opts o;
  int tile, cap;    // the staged path's tile of chunks and staging words
};

// --- the direct path: a warp per simulation on the global buffers

__global__ void chunk_direct_kernel(Buffers g) {
  const int64_t s =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (s >= g.B) return;  // whole warps leave together: blockDim % 32 == 0
  const Opts& o = g.o;
  const int n = o.n, m = o.m, C = o.C;
  const int last = o.artifact_tokens - (C - 1) * o.chunk_tokens;

  int delta_bytes = 0, full_bytes = 0, n_fetched = 0;
  for (int a = 0; a < n; ++a) {
    const int64_t sa = s * n + a;
    const bool ms = g.miss[sa] != 0;
    const bool w = g.write_acts[sa] != 0;
    int* f = g.fetched + sa * C;
    if (!ms && !w) {
      for (int c = lane; c < C; c += kWarp) f[c] = 0;
      continue;
    }
    const int d = g.arts[sa];
    int* cv = g.chunk_version + (s * m + d) * C;
    int* dirty = g.chunk_dirty + (s * m + d) * C;
    int* cs = g.chunk_sync + (sa * m + d) * C;
    const int* span = g.write_chunks + sa * C;
    int tokens = 0, count = 0;
    for (int c = lane; c < C; c += kWarp) {
      int v = cv[c];
      int fetch = 0;
      if (ms && v > cs[c]) {  // delta fetch at this agent's slot
        fetch = 1;
        tokens += c < C - 1 ? o.chunk_tokens : last;
        ++count;
      }
      f[c] = fetch;
      if (w && span[c] != 0) {  // chunk-granular commit
        ++v;
        cv[c] = v;
        dirty[c] = 1;
      }
      cs[c] = v;  // fill syncs to the authority, commit to the new span
    }
    if (ms) {  // warp-uniform: every lane takes part in the shuffles
      for (int off = kWarp / 2; off > 0; off /= 2) {
        tokens += __shfl_xor_sync(kFull, tokens, off);
        count += __shfl_xor_sync(kFull, count, off);
      }
      delta_bytes += (tokens + o.signal_tokens) * o.bytes_per_token;
      full_bytes += (o.artifact_tokens + o.signal_tokens) * o.bytes_per_token;
      n_fetched += count;
    }
  }
  if (lane == 0) {
    int* out = g.counters + s * 4;
    out[0] = delta_bytes;
    out[1] = full_bytes;
    out[2] = n_fetched;
    out[3] = 0;
  }
}

// --- the staged path: a group of W lanes per simulation, its rows staged
// --- in shared memory before the serial agent loop

// the place of bit i among the set bits of mask (its rank)
__device__ __forceinline__ int rank_of(unsigned mask, int i) {
  return __popc(mask & ((1u << i) - 1u));
}

__device__ __forceinline__ int4 load4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void store4(int* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One simulation as its group's lanes see it: the fill set, the write set
// and the artifacts they address, a bit an agent or an artifact.
struct Sim {
  int64_t s;
  unsigned fills, writes, addressed;
};

// Step 1 for simulation s (nothing where s >= B): lane q reads agent q's
// flags; ballots and an OR across the group give the sets; each agent's
// artifact goes to art_of.  Every lane of the warp takes part.
template <int W>
__device__ __forceinline__ Sim read_flags(const Buffers& g, int64_t s,
                                          int* art_of) {
  constexpr unsigned kGroupBits =
      W == kWarp ? kFull : (1u << (W % kWarp)) - 1u;
  const int n = g.o.n, lane = threadIdx.x % kWarp, q = lane % W;
  const bool agent = s < g.B && q < n;
  const int64_t i = s * n + q;
  const bool fill = agent && g.miss[i] != 0;
  const bool write = agent && g.write_acts[i] != 0;
  const int art = agent ? g.arts[i] : 0;
  const int shift = lane / W * W;
  Sim sim;
  sim.s = s;
  sim.fills = (__ballot_sync(kFull, fill) >> shift) & kGroupBits;
  sim.writes = (__ballot_sync(kFull, write) >> shift) & kGroupBits;
  sim.addressed = fill || write ? 1u << art : 0u;
#pragma unroll
  for (int off = W / 2; off > 0; off /= 2)
    sim.addressed |= __shfl_xor_sync(kFull, sim.addressed, off, W);
  if (agent) art_of[q] = art;
  __syncwarp();
  return sim;
}

// The staging area's rows: chunk_version by addressed artifact, then
// chunk_sync by filler, then write_chunks by writer, each set compacted by
// rank, rows of a tile each.
struct Rows {
  int *cv, *cs, *wc;
};

__device__ __forceinline__ Rows rows_of(const Sim& sim, int* area,
                                        int tile) {
  Rows r;
  r.cv = area;
  r.cs = r.cv + __popc(sim.addressed) * tile;
  r.wc = r.cs + __popc(sim.fills) * tile;
  return r;
}

// Step 2 for the tile of sim's chunks at t0: this lane's four words of
// every row the tick reads, copied with 16-byte cp.async (the caller
// commits the group).
template <int W>
__device__ __forceinline__ void stage(const Buffers& g, const Sim& sim,
                                      int* area, const int* art_of,
                                      int t0) {
  const int n = g.o.n, m = g.o.m, C = g.o.C, q = threadIdx.x % kWarp % W;
  const int c = t0 + 4 * q, w = 4 * q;
  if (sim.s >= g.B || c >= C || w >= g.tile) return;
  const Rows r = rows_of(sim, area, g.tile);
  const int64_t sn = sim.s * n;
  for (unsigned b = sim.addressed; b; b &= b - 1) {
    const int d = __ffs(b) - 1;
    hopper::cp_async_16(
        hopper::smem_u32(r.cv + rank_of(sim.addressed, d) * g.tile + w),
        g.chunk_version + (sim.s * m + d) * C + c);
  }
  for (unsigned b = sim.fills; b; b &= b - 1) {
    const int a = __ffs(b) - 1;
    hopper::cp_async_16(
        hopper::smem_u32(r.cs + rank_of(sim.fills, a) * g.tile + w),
        g.chunk_sync + ((sn + a) * m + art_of[a]) * C + c);
  }
  for (unsigned b = sim.writes; b; b &= b - 1) {
    const int a = __ffs(b) - 1;
    hopper::cp_async_16(
        hopper::smem_u32(r.wc + rank_of(sim.writes, a) * g.tile + w),
        g.write_chunks + (sn + a) * C + c);
  }
}

// Steps 3 and 4 for the staged tile of sim's chunks at t0: the agents in
// ascending order on this lane's words, then the versions it bumped back;
// adds this lane's fetched tokens and chunks to the sums.
template <int W>
__device__ __forceinline__ void run_agents(const Buffers& g, const Sim& sim,
                                           int* area, const int* art_of,
                                           int t0, unsigned& tokens,
                                           unsigned& count) {
  const Opts& o = g.o;
  const int n = o.n, m = o.m, C = o.C, q = threadIdx.x % kWarp % W;
  const int c = t0 + 4 * q, w = 4 * q;
  if (sim.s >= g.B || c >= C || w >= g.tile) return;
  const Rows r = rows_of(sim, area, g.tile);
  const int64_t sn = sim.s * n;
  const int last = o.artifact_tokens - (C - 1) * o.chunk_tokens;
  const unsigned size_w = c + 3 == C - 1 ? last : o.chunk_tokens;
  unsigned bumped = 0;                      // bit d: this lane bumped row d
  for (int a = 0; a < n; ++a) {
    int* const f_out = g.fetched + (sn + a) * C + c;
    const bool fill = (sim.fills >> a) & 1u, write = (sim.writes >> a) & 1u;
    if (!fill && !write) {
      store4(f_out, make_int4(0, 0, 0, 0));
      continue;
    }
    const int d = art_of[a];
    int* const row = r.cv + rank_of(sim.addressed, d) * g.tile + w;
    int4 v = load4(row);
    int4 f = make_int4(0, 0, 0, 0);
    if (fill) {  // delta fetch at this agent's slot
      const int4 cs = load4(r.cs + rank_of(sim.fills, a) * g.tile + w);
      f = make_int4(v.x > cs.x, v.y > cs.y, v.z > cs.z, v.w > cs.w);
      const unsigned k = f.x + f.y + f.z;
      count += k + f.w;
      tokens += k * o.chunk_tokens + f.w * size_w;
    }
    store4(f_out, f);
    if (write) {  // chunk-granular commit: bump the span, mark it dirty
      const int4 span = load4(r.wc + rank_of(sim.writes, a) * g.tile + w);
      const int4 bump = make_int4(span.x != 0, span.y != 0, span.z != 0,
                                  span.w != 0);
      if (bump.x | bump.y | bump.z | bump.w) {
        v = make_int4(v.x + bump.x, v.y + bump.y, v.z + bump.z,
                      v.w + bump.w);
        store4(row, v);
        bumped |= 1u << d;
        int* const dirty = g.chunk_dirty + (sim.s * m + d) * C + c;
        if (bump.x & bump.y & bump.z & bump.w) {
          store4(dirty, make_int4(1, 1, 1, 1));
        } else {
          if (bump.x) dirty[0] = 1;
          if (bump.y) dirty[1] = 1;
          if (bump.z) dirty[2] = 1;
          if (bump.w) dirty[3] = 1;
        }
      }
    }
    // a fill syncs to the authority, a commit to the new span
    store4(g.chunk_sync + ((sn + a) * m + d) * C + c, v);
  }
  for (unsigned b = bumped; b; b &= b - 1) {
    const int d = __ffs(b) - 1;
    store4(g.chunk_version + (sim.s * m + d) * C + c,
           load4(r.cv + rank_of(sim.addressed, d) * g.tile + w));
  }
}

template <int W>   // lanes a simulation
__global__ void __launch_bounds__(kMaxStagedWarps * kWarp)
chunk_staged_kernel(Buffers g) {
  extern __shared__ int4 smem4[];
  int* const smem = reinterpret_cast<int*>(smem4);
  constexpr int kPerWarp = kWarp / W;       // simulations a warp
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int sub = lane / W, q = lane % W;
  const int sims = blockDim.x / kWarp * kPerWarp;     // a block's
  const int slot = warp * kPerWarp + sub;
  int* const area = smem + slot * g.cap;
  int* const art_of = smem + sims * g.cap + slot * g.o.n;
  const Sim sim = read_flags<W>(
      g, static_cast<int64_t>(blockIdx.x) * sims + slot, art_of);
  unsigned tokens = 0, count = 0;
  for (int t0 = 0; t0 < g.o.C; t0 += g.tile) {
    stage<W>(g, sim, area, art_of, t0);
    cp_commit();
    cp_wait_all();                          // this lane's copies
    run_agents<W>(g, sim, area, art_of, t0, tokens, count);
  }
  // counters: the group's sums
#pragma unroll
  for (int off = W / 2; off > 0; off /= 2) {
    tokens += __shfl_xor_sync(kFull, tokens, off, W);
    count += __shfl_xor_sync(kFull, count, off, W);
  }
  if (sim.s < g.B && q == 0) {
    const unsigned fills = __popc(sim.fills);
    const unsigned bpt = g.o.bytes_per_token;
    int* const out = g.counters + sim.s * 4;
    out[0] = static_cast<int>((tokens + fills * g.o.signal_tokens) * bpt);
    out[1] = static_cast<int>(
        fills * (static_cast<unsigned>(g.o.artifact_tokens) +
                 g.o.signal_tokens) * bpt);
    out[2] = static_cast<int>(count);
    out[3] = 0;
  }
}

// The staged path's geometry for a shape: lanes a simulation, its tile of
// chunks, the words of its staging area (the most rows it can read,
// min(n, m) + 2n, of a tile each) and warps a block; lanes 0 where the
// direct path runs the shape.
struct Staging {
  int lanes, tile, cap, warps;
};

Staging staging(int n, int m, int C) {
  Staging g{0, 0, 0, 0};
  if (n <= 0 || m <= 0 || C <= 0 || n > kMaxStagedAgents ||
      m > kMaxStagedArtifacts || C % 4 != 0)
    return g;
  const int pieces = C / 4 < kWarp ? C / 4 : kWarp;   // a row's, at most 32
  int lanes = 1;
  while (lanes < n || lanes < pieces) lanes *= 2;
  g.lanes = lanes;
  g.tile = 4 * lanes < C ? 4 * lanes : C;
  g.cap = ((n < m ? n : m) + 2 * n) * g.tile;
  const int warp_bytes =
      static_cast<int>(sizeof(int)) * (kWarp / lanes) * (g.cap + n);
  g.warps = kStagedBlockBytes / warp_bytes;
  g.warps = g.warps < 1 ? 1 : g.warps > kMaxStagedWarps ? kMaxStagedWarps
                                                        : g.warps;
  return g;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int W>
cudaError_t launch_staged(int warps, const Buffers& g, cudaStream_t stream) {
  const int sims = warps * (kWarp / W);
  const size_t smem =
      sizeof(int) * static_cast<size_t>(sims) * (g.cap + g.o.n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_staged_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = static_cast<int>((static_cast<int64_t>(g.B) + sims - 1) /
                                      sims);
  chunk_staged_kernel<W><<<blocks, warps * kWarp, smem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" int chunk_tick_plan(int n, int m, int C) {
  const Staging g = staging(n, m, C);
  return g.lanes ? g.warps * (kWarp / g.lanes) : 0;
}

// Launches one tick on `stream`; returns cudaGetLastError().
extern "C" int chunk_tick_launch(void* chunk_version, void* chunk_sync,
                                 void* chunk_dirty, void* miss,
                                 void* write_acts, void* arts,
                                 void* write_chunks, void* fetched,
                                 void* counters, int B, int n, int m, int C,
                                 int chunk_tokens, int artifact_tokens,
                                 int signal_tokens, int bytes_per_token,
                                 void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Staging sg = staging(n, m, C);
  const Buffers g{static_cast<int*>(chunk_version),
                  static_cast<int*>(chunk_sync),
                  static_cast<int*>(chunk_dirty),
                  static_cast<const int*>(miss),
                  static_cast<const int*>(write_acts),
                  static_cast<const int*>(arts),
                  static_cast<const int*>(write_chunks),
                  static_cast<int*>(fetched),
                  static_cast<int*>(counters),
                  B,
                  {n, m, C, chunk_tokens, artifact_tokens, signal_tokens,
                   bytes_per_token},
                  sg.tile,
                  sg.cap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sg.lanes && aligned16(chunk_version) && aligned16(chunk_sync) &&
      aligned16(chunk_dirty) && aligned16(write_chunks) &&
      aligned16(fetched)) {
    switch (sg.lanes) {
#define CHUNK_STAGED(W) \
  case W:               \
    return static_cast<int>(launch_staged<W>(sg.warps, g, st));
      CHUNK_STAGED(1)
      CHUNK_STAGED(2)
      CHUNK_STAGED(4)
      CHUNK_STAGED(8)
      CHUNK_STAGED(16)
      CHUNK_STAGED(32)
#undef CHUNK_STAGED
    }
  }
  const int64_t threads = static_cast<int64_t>(B) * kWarp;
  const int blocks =
      static_cast<int>((threads + kDirectThreads - 1) / kDirectThreads);
  chunk_direct_kernel<<<blocks, kDirectThreads, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}
