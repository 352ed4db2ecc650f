// One serialized-agent MESI coherence tick over B simulations.
//
// Replaces the TPU kernel `mesi_tick_pallas` of the JAX package
// (src/repro/kernels/mesi_transition.py, body `_mesi_kernel`) and computes
// exactly what it computes; the plain PyTorch version beside the wrapper
// (repro_torch/kernels/mesi_transition.py, `mesi_tick_plain_`) is the
// reference it is held to, output for output.
//
// Per simulation s, for each agent a in ascending order (the authority's
// serialization order, a semantic requirement) where acts[s,a] != 0, with
// d = arts[s,a]:
//   * a fill when the entry is I or access-count expired: entry -> S,
//     last_sync <- version, reads <- 0, artifact_tokens + signal charged;
//   * on a write: every other valid holder of d is invalidated (one signal
//     each; under eager it is pushed the new version instead), the version
//     is bumped and the writer left in S;
//   * on a read: reads += 1.
// Counters (B, 8): fetch_tokens, signal_tokens, push_tokens, n_fetches,
// n_hits, n_invalidation_signals, 0, 0.  miss (B, n): 1 where the agent's
// action triggered a fill.  state, version, last_sync and reads are updated
// IN PLACE: the sweep engine reuses those buffers from step to step, and
// the Python wrapper clones first where a caller wants the functional form.
// The buffers are sim-major, (B, n, m), (B, m) and (B, n).
//
// Bound on an H100: an integer state machine with a handful of integer
// operations per word it touches, so it is memory-bound: its least time is
// the bytes it must move over the card's memory rate (3.35 TB/s on the SXM
// part).  The card moves 32-byte sectors, and a written artifact's column
// touches one word in every m, so at n = m = 16 the tick touches about half
// of each slab's sectors.
//
// Design (the staged path, n and m up to 32).  A group of lanes runs one
// simulation (the least power of two that holds n and m: 16 lanes at
// n = m = 16, so two simulations a warp; 4 at the scenarios' n = 4, m = 3,
// so eight), lane b speaking for agent b and, for the version vector, for
// artifact b:
//   1. the warp copies its simulations' n x m state slabs (one contiguous
//      range) into shared memory with cp.async, each copy a coalesced
//      128-byte piece, stored by column with a row stride of n | 1 words,
//      so that the lanes read a column on distinct banks; acts, arts,
//      writes and version come to lane registers with coalesced loads, and
//      each acting agent's read counter from its own cell;
//   2. it runs the agents in ascending order, all lanes in step: the agent's
//      action and artifact are shuffled from its lane; every lane reads its
//      own cell of that column (the writer's and its peers'); a fill or
//      commit is one lane's store; a write invalidates (or, under eager,
//      pushes to) the valid peers, one store in each peer's lane, and a
//      ballot counts them.  Each word of a slab is written only by its
//      agent's lane, so no lane waits on another, and no branch is taken
//      by a group as a whole, so the groups of a warp never diverge;
//   3. it writes back the state words its lanes marked (a dirty bit per
//      artifact in each lane's register), the versions that moved, each
//      acting agent's read counter, miss and the counters.  last_sync is
//      never read by the tick: its lanes store each new value directly,
//      as they do the read counters an eager push resets.
// (One thread per simulation over its slab in shared memory leaves one
// warp of a block to a serial, divergent agent loop; on an H100 that ran
// slower than the direct path.)
// The direct path (one thread per simulation indexing the global buffers,
// the first design of this kernel) takes the shapes whose agents or
// artifacts do not fit a warp's lanes and a lane's dirty bits
// (kMaxStagedAgents, kMaxStagedArtifacts); the shape alone chooses it.
//
// C interface (ctypes): mesi_tick_launch(state, version, sync, reads, acts,
// arts, writes, counters, miss, B, n, m, artifact_tokens, eager, access_k,
// signal_tokens, stream), all int32, contiguous and 4-byte aligned; returns
// cudaGetLastError().  mesi_tick_plan(n, m) gives the simulations a block
// of the staged path runs (0: the direct path runs the shape).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kInvalid = 0;
constexpr int kShared = 1;
constexpr int kCounters = 8;
constexpr int kThreads = 128;              // direct path
constexpr unsigned kFull = 0xffffffffu;
// the staged path's budget: a warp's lanes hold the agents, a lane's dirty
// bits the artifacts (a block's slabs then take at most 34 KB)
constexpr int kMaxStagedAgents = 32;
constexpr int kMaxStagedArtifacts = 32;
constexpr int kStagedWarps = 8;            // warps a staged block

// The tick's options, passed by value.
struct Opts {
  int n, m, artifact_tokens, eager, access_k, signal_tokens;
};

// --- the direct path: one thread per simulation on the global buffers

__global__ void mesi_direct_kernel(int* __restrict__ state,
                                   int* __restrict__ version,
                                   int* __restrict__ sync,
                                   int* __restrict__ reads,
                                   const int* __restrict__ acts,
                                   const int* __restrict__ arts,
                                   const int* __restrict__ writes,
                                   int* __restrict__ counters,
                                   int* __restrict__ miss_out, int B,
                                   Opts o) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (s >= B) return;
  const int n = o.n, m = o.m;
  const int64_t nm = static_cast<int64_t>(n) * m;
  int* st = state + s * nm;
  int* sy = sync + s * nm;
  int* rd = reads + s * nm;
  int* ver = version + s * m;
  const int* act_s = acts + s * n;
  const int* art_s = arts + s * n;
  const int* wr_s = writes + s * n;
  int* miss_s = miss_out + s * n;

  int fetch_tokens = 0, signal = 0, push = 0;
  int n_fetches = 0, n_hits = 0, n_inval = 0;
  for (int a = 0; a < n; ++a) {
    const bool act = act_s[a] != 0;
    const bool is_write = act && wr_s[a] != 0;
    const int d = art_s[a];
    const int cell = a * m + d;
    bool miss = false;
    if (act) {
      // coherence fill on miss (read-modify-write prologue)
      const bool expired = o.access_k > 0 && rd[cell] >= o.access_k;
      miss = st[cell] == kInvalid || expired;
      if (miss) {
        st[cell] = kShared;
        sy[cell] = ver[d];
        rd[cell] = 0;
        fetch_tokens += o.artifact_tokens + o.signal_tokens;
        ++n_fetches;
      } else {
        ++n_hits;
      }
    }
    miss_s[a] = miss ? 1 : 0;
    if (is_write) {
      // upgrade: invalidate (or, under eager, push to) every valid peer
      const int new_ver = ver[d] + 1;
      int peers = 0;
      for (int b = 0; b < n; ++b) {
        const int peer_cell = b * m + d;
        if (b == a || st[peer_cell] == kInvalid) continue;
        ++peers;
        if (o.eager) {
          st[peer_cell] = kShared;
          sy[peer_cell] = new_ver;
          rd[peer_cell] = 0;
        } else {
          st[peer_cell] = kInvalid;
        }
      }
      signal += o.signal_tokens * peers;
      n_inval += peers;
      if (o.eager) push += (o.artifact_tokens + o.signal_tokens) * peers;
      // commit: version++, writer -> S
      ver[d] = new_ver;
      st[cell] = kShared;
      sy[cell] = new_ver;
      rd[cell] = 0;
    } else if (act) {
      rd[cell] += 1;
    }
  }
  int* c = counters + s * kCounters;
  c[0] = fetch_tokens;
  c[1] = signal;
  c[2] = push;
  c[3] = n_fetches;
  c[4] = n_hits;
  c[5] = n_inval;
  c[6] = 0;
  c[7] = 0;
}

// --- the staged path: a warp per simulation, its state slab in shared
// --- memory by column

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Steps (sim, a, d), the place of row-major word g of a range of slabs,
// to that of word g + 32.
__device__ __forceinline__ void advance32(int& sim, int& a, int& d, int n,
                                          int m) {
  d += 32 % m;
  a += 32 / m;
  if (d >= m) {
    d -= m;
    ++a;
  }
  while (a >= n) {
    a -= n;
    ++sim;
  }
}

template <int W>   // lanes a simulation
__global__ void __launch_bounds__(kStagedWarps * 32)
mesi_staged_kernel(int* __restrict__ state, int* __restrict__ version,
                   int* __restrict__ sync, int* __restrict__ reads,
                   const int* __restrict__ acts,
                   const int* __restrict__ arts,
                   const int* __restrict__ writes,
                   int* __restrict__ counters, int* __restrict__ miss_out,
                   int B, Opts o) {
  extern __shared__ int smem[];
  const int n = o.n, m = o.m, nm = n * m, col = n | 1;   // column stride
  const int slab = m * col;                               // shared words
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int per_warp = 32 / W;          // simulations a warp
  const int sub = lane / W, q = lane % W;
  const int64_t s0 = (static_cast<int64_t>(blockIdx.x) * kStagedWarps +
                      warp) * per_warp;     // the warp's first simulation
  if (s0 >= B) return;                      // whole warps only
  const int sims = static_cast<int>(
      min(static_cast<int64_t>(per_warp), static_cast<int64_t>(B) - s0));
  const int64_t s = s0 + sub;
  const bool live = sub < sims;
  int* const slabs = smem + warp * per_warp * slab;
  int* const st = slabs + sub * slab;       // st[d * col + a]
  int* const g_sync = sync + s * nm;
  int* const g_reads = reads + s * nm;

  // 1. the warp's slabs by column (word g = (sim * n + a) * m + d of the
  //    warp's row-major range)
  {
    int sim = 0, a = lane / m, d = lane % m;
    while (a >= n) {
      a -= n;
      ++sim;
    }
    for (int g = lane; g < sims * nm; g += 32) {
      cp_async4(slabs + sim * slab + d * col + a, state + s0 * nm + g);
      advance32(sim, a, d, n, m);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const bool agent = live && q < n;
  const int act_l = agent ? acts[s * n + q] : 0;
  const int art_l = agent ? arts[s * n + q] : 0;
  const int wr_l = agent ? writes[s * n + q] : 0;
  int ver_l = live && q < m ? version[s * m + q] : 0;
  int rd_l = act_l ? g_reads[q * m + art_l] : 0;
  const int ver_in = ver_l;
  unsigned dirty = 0;                       // bit d: this lane's st[d] moved
  int miss_l = 0;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // 2. the agents in order, all lanes in step; each group of W lanes runs
  //    its own simulation, so every branch below is a lane's
  int fetch_tokens = 0, signal = 0, push = 0;
  int n_fetches = 0, n_hits = 0, n_inval = 0;
  for (int a = 0; a < n; ++a) {
    const bool act = __shfl_sync(kFull, act_l, a, W) != 0;
    const int d = __shfl_sync(kFull, art_l, a, W);
    const bool is_write = __shfl_sync(kFull, wr_l, a, W) != 0 && act;
    int* cell = st + d * col + q;           // this lane's cell of column d
    const int mine = agent ? *cell : kInvalid;
    const int st_a = __shfl_sync(kFull, mine, a, W);
    const int rd_a = __shfl_sync(kFull, rd_l, a, W);
    const int ver_d = __shfl_sync(kFull, ver_l, d, W);
    // coherence fill on miss (read-modify-write prologue)
    const bool expired = o.access_k > 0 && rd_a >= o.access_k;
    const bool miss = act && (st_a == kInvalid || expired);
    fetch_tokens += miss ? o.artifact_tokens + o.signal_tokens : 0;
    n_fetches += miss;
    n_hits += act && !miss;
    if (miss && q == a) {
      *cell = kShared;
      g_sync[a * m + d] = ver_d;
      rd_l = 0;
      dirty |= 1u << d;
      miss_l = 1;
    }
    // upgrade: invalidate (or, under eager, push to) every valid peer
    const int new_ver = ver_d + 1;
    const bool peer = is_write && agent && q != a && mine != kInvalid;
    const unsigned group = (kFull >> (32 - W)) << (sub * W);
    const int peers = __popc(__ballot_sync(kFull, peer) & group);
    if (peer) {
      if (o.eager) {
        *cell = kShared;
        g_sync[q * m + d] = new_ver;
        g_reads[q * m + d] = 0;
        if (art_l == d) rd_l = 0;
      } else {
        *cell = kInvalid;
      }
      dirty |= 1u << d;
    }
    signal += o.signal_tokens * peers;
    n_inval += peers;
    push += o.eager ? (o.artifact_tokens + o.signal_tokens) * peers : 0;
    // commit: version++, writer -> S; or a read
    if (is_write && q == d) ver_l = new_ver;
    if (is_write && q == a) {
      *cell = kShared;
      g_sync[a * m + d] = new_ver;
      rd_l = 0;
      dirty |= 1u << d;
    } else if (act && q == a) {
      rd_l += 1;
    }
  }
  __syncwarp();

  // 3. the marked state words, back at their row-major places
  {
    int sim = 0, a = lane / m, d = lane % m;
    while (a >= n) {
      a -= n;
      ++sim;
    }
    for (int base = 0; base < sims * nm; base += 32) {
      const unsigned row = __shfl_sync(
          kFull, dirty, min(sim, per_warp - 1) * W + min(a, W - 1));
      if (base + lane < sims * nm && (row >> d) & 1u)
        state[s0 * nm + base + lane] = slabs[sim * slab + d * col + a];
      advance32(sim, a, d, n, m);
    }
  }
  if (act_l) g_reads[q * m + art_l] = rd_l;
  if (live && q < m && ver_l != ver_in) version[s * m + q] = ver_l;
  if (agent) miss_out[s * n + q] = miss_l;
  if (live) {
    const int value[kCounters] = {fetch_tokens, signal, push, n_fetches,
                                  n_hits, n_inval, 0, 0};
    for (int c = q; c < kCounters; c += W) {
      int mine = 0;
#pragma unroll
      for (int k = 0; k < kCounters; ++k)
        if (c == k) mine = value[k];
      counters[s * kCounters + c] = mine;
    }
  }
}

// The lanes a staged simulation takes: the least power of two that holds
// its agents and its artifacts; 0 where they exceed the staged path's
// budget (the direct path).
int staged_width(int n, int m) {
  if (n <= 0 || m <= 0 || n > kMaxStagedAgents || m > kMaxStagedArtifacts)
    return 0;
  int width = 1;
  while (width < n || width < m) width *= 2;
  return width;
}

}  // namespace

extern "C" int mesi_tick_plan(int n, int m) {
  const int width = staged_width(n, m);
  return width ? kStagedWarps * (32 / width) : 0;
}

// Launches one tick on `stream`; returns cudaGetLastError().
extern "C" int mesi_tick_launch(void* state, void* version, void* sync,
                                void* reads, void* acts, void* arts,
                                void* writes, void* counters, void* miss,
                                int B, int n, int m, int artifact_tokens,
                                int eager, int access_k, int signal_tokens,
                                void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Opts o{n, m, artifact_tokens, eager, access_k, signal_tokens};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = staged_width(n, m);
  if (width > 0) {
    const int sims = kStagedWarps * (32 / width);   // a block's
    const int blocks = (B + sims - 1) / sims;
    const size_t smem = sizeof(int) * sims * m * (n | 1);
    int* const args_state = static_cast<int*>(state);
#define MESI_STAGED(WIDTH)                                                 \
  case WIDTH:                                                              \
    mesi_staged_kernel<WIDTH><<<blocks, kStagedWarps * 32, smem, s>>>(     \
        args_state, static_cast<int*>(version), static_cast<int*>(sync),   \
        static_cast<int*>(reads), static_cast<const int*>(acts),           \
        static_cast<const int*>(arts), static_cast<const int*>(writes),    \
        static_cast<int*>(counters), static_cast<int*>(miss), B, o);       \
    break;
    switch (width) {
      MESI_STAGED(1)
      MESI_STAGED(2)
      MESI_STAGED(4)
      MESI_STAGED(8)
      MESI_STAGED(16)
      MESI_STAGED(32)
    }
#undef MESI_STAGED
  } else {
    const int blocks = (B + kThreads - 1) / kThreads;
    mesi_direct_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<int*>(state), static_cast<int*>(version),
        static_cast<int*>(sync), static_cast<int*>(reads),
        static_cast<const int*>(acts), static_cast<const int*>(arts),
        static_cast<const int*>(writes), static_cast<int*>(counters),
        static_cast<int*>(miss), B, o);
  }
  return static_cast<int>(cudaGetLastError());
}
