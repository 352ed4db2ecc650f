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
// action triggered a fill.
//
// Design: one thread per simulation, the agent loop inside the thread, and
// direct (s, a, d) indexing where the TPU kernel used one-hot masks over the
// artifact axis (its m <= 16 limit does not apply here).  state, version,
// last_sync and reads are updated IN PLACE: the sweep engine reuses those
// buffers from step to step, and the Python wrapper clones first where a
// caller wants the functional form.
//
// Bound on an H100: an integer state machine with a handful of integer
// operations per word it touches, so it is memory-bound: its least time is
// the bytes it must move over the card's memory bandwidth (3.35 TB/s on the
// SXM part).  This first version does not approach that bound: each thread
// walks its own n*m slab, so the threads of a warp touch words n*m*4 bytes
// apart and every access is a separate transaction.  A sim-minor layout,
// fusing this tick with the chunk tick and keeping a whole episode on chip
// are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kInvalid = 0;
constexpr int kShared = 1;
constexpr int kCounters = 8;
constexpr int kThreads = 128;

__global__ void mesi_tick_kernel(int* __restrict__ state,
                                 int* __restrict__ version,
                                 int* __restrict__ sync,
                                 int* __restrict__ reads,
                                 const int* __restrict__ acts,
                                 const int* __restrict__ arts,
                                 const int* __restrict__ writes,
                                 int* __restrict__ counters,
                                 int* __restrict__ miss_out, int B, int n,
                                 int m, int artifact_tokens, int eager,
                                 int access_k, int signal_tokens) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (s >= B) return;
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
      const bool expired = access_k > 0 && rd[cell] >= access_k;
      miss = st[cell] == kInvalid || expired;
      if (miss) {
        st[cell] = kShared;
        sy[cell] = ver[d];
        rd[cell] = 0;
        fetch_tokens += artifact_tokens + signal_tokens;
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
        if (eager) {
          st[peer_cell] = kShared;
          sy[peer_cell] = new_ver;
          rd[peer_cell] = 0;
        } else {
          st[peer_cell] = kInvalid;
        }
      }
      signal += signal_tokens * peers;
      n_inval += peers;
      if (eager) push += (artifact_tokens + signal_tokens) * peers;
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

}  // namespace

// Launches one tick on `stream`; returns cudaGetLastError().
extern "C" int mesi_tick_launch(void* state, void* version, void* sync,
                                void* reads, void* acts, void* arts,
                                void* writes, void* counters, void* miss,
                                int B, int n, int m, int artifact_tokens,
                                int eager, int access_k, int signal_tokens,
                                void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    mesi_tick_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(state), static_cast<int*>(version),
        static_cast<int*>(sync), static_cast<int*>(reads),
        static_cast<const int*>(acts), static_cast<const int*>(arts),
        static_cast<const int*>(writes), static_cast<int*>(counters),
        static_cast<int*>(miss), B, n, m, artifact_tokens, eager, access_k,
        signal_tokens);
  }
  return static_cast<int>(cudaGetLastError());
}
