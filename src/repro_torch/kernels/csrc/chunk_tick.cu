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
// n_chunks_fetched, 0.
//
// Design: one warp per simulation, agents in serial order inside the warp,
// lanes over the chunk axis (lane l owns chunks l, l+32, ...).  A lane only
// ever touches its own chunks, so the serial dependence between agents of
// one simulation stays inside each lane and needs no synchronisation; the
// per-agent token and chunk counts are summed across the warp with
// shuffles.  chunk_version, chunk_sync and chunk_dirty are updated IN PLACE,
// and chunk_sync (the large array, B*n*m*C words) only at the rows
// (s, a, arts[s,a]) of agents that miss or write.
//
// Bound on an H100: integer compares and adds, a few per word it touches, so
// the kernel is memory-bound and its least time is the bytes it must move
// over the card's memory bandwidth (3.35 TB/s on the SXM part).  Neighbouring
// lanes touch neighbouring words, so each row access is coalesced; the
// serial agent loop leaves each warp one row access deep at a time, which is
// what keeps this first version from the bound.  Fusing this tick with the
// MESI tick and keeping an episode on chip are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kCounters = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void chunk_tick_kernel(int* __restrict__ chunk_version,
                                  int* __restrict__ chunk_sync,
                                  int* __restrict__ chunk_dirty,
                                  const int* __restrict__ miss,
                                  const int* __restrict__ write_acts,
                                  const int* __restrict__ arts,
                                  const int* __restrict__ write_chunks,
                                  int* __restrict__ fetched,
                                  int* __restrict__ counters, int B, int n,
                                  int m, int C, int chunk_tokens,
                                  int artifact_tokens, int signal_tokens,
                                  int bytes_per_token) {
  const int64_t s =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (s >= B) return;  // whole warps leave together: blockDim % 32 == 0
  const int last = artifact_tokens - (C - 1) * chunk_tokens;

  int delta_bytes = 0, full_bytes = 0, n_fetched = 0;
  for (int a = 0; a < n; ++a) {
    const int64_t sa = s * n + a;
    const bool ms = miss[sa] != 0;
    const bool w = write_acts[sa] != 0;
    int* f = fetched + sa * C;
    if (!ms && !w) {
      for (int c = lane; c < C; c += kWarp) f[c] = 0;
      continue;
    }
    const int d = arts[sa];
    int* cv = chunk_version + (s * m + d) * C;
    int* dirty = chunk_dirty + (s * m + d) * C;
    int* cs = chunk_sync + (sa * m + d) * C;
    const int* span = write_chunks + sa * C;
    int tokens = 0, count = 0;
    for (int c = lane; c < C; c += kWarp) {
      int v = cv[c];
      int fetch = 0;
      if (ms && v > cs[c]) {  // delta fetch at this agent's slot
        fetch = 1;
        tokens += c < C - 1 ? chunk_tokens : last;
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
        tokens += __shfl_xor_sync(kFullMask, tokens, off);
        count += __shfl_xor_sync(kFullMask, count, off);
      }
      delta_bytes += (tokens + signal_tokens) * bytes_per_token;
      full_bytes += (artifact_tokens + signal_tokens) * bytes_per_token;
      n_fetched += count;
    }
  }
  if (lane == 0) {
    int* out = counters + s * kCounters;
    out[0] = delta_bytes;
    out[1] = full_bytes;
    out[2] = n_fetched;
    out[3] = 0;
  }
}

}  // namespace

// Launches one tick on `stream`; returns cudaGetLastError().
extern "C" int chunk_tick_launch(void* chunk_version, void* chunk_sync,
                                 void* chunk_dirty, void* miss,
                                 void* write_acts, void* arts,
                                 void* write_chunks, void* fetched,
                                 void* counters, int B, int n, int m, int C,
                                 int chunk_tokens, int artifact_tokens,
                                 int signal_tokens, int bytes_per_token,
                                 void* stream) {
  if (B > 0) {
    const int64_t threads = static_cast<int64_t>(B) * kWarp;
    const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
    chunk_tick_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(chunk_version), static_cast<int*>(chunk_sync),
        static_cast<int*>(chunk_dirty), static_cast<const int*>(miss),
        static_cast<const int*>(write_acts), static_cast<const int*>(arts),
        static_cast<const int*>(write_chunks), static_cast<int*>(fetched),
        static_cast<int*>(counters), B, n, m, C, chunk_tokens,
        artifact_tokens, signal_tokens, bytes_per_token);
  }
  return static_cast<int>(cudaGetLastError());
}
