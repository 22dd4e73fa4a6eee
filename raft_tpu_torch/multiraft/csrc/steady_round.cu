// Grid wrapper around steady_body.cuh for sm_90a: one thread per group,
// 256 threads a block, the ragged last block masked by g < G.  Launches on
// the caller's stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so a refused launch reaches the caller.
#include <cuda_runtime.h>
#include <stdint.h>

#include "steady_body.cuh"

namespace {

constexpr int kThreads = 256;

template <int P>
__global__ void __launch_bounds__(kThreads) steady_round_kernel(
    const int32_t* __restrict__ state, const int32_t* __restrict__ term,
    const int32_t* __restrict__ ee, const int32_t* __restrict__ hb,
    const int32_t* __restrict__ li, const int32_t* __restrict__ lt,
    const int32_t* __restrict__ matched, const int32_t* __restrict__ commit,
    const uint8_t* __restrict__ voter, const uint8_t* __restrict__ member,
    const uint8_t* __restrict__ crashed, const int32_t* __restrict__ ts,
    const int32_t* __restrict__ app, int32_t* __restrict__ ee_out,
    int32_t* __restrict__ hb_out, int32_t* __restrict__ li_out,
    int32_t* __restrict__ lt_out, int32_t* __restrict__ matched_out,
    int32_t* __restrict__ commit_out, int64_t G, int rounds,
    int election_tick, int heartbeat_tick) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  raft_steady::steady_group<P>(
      g, G, state, term, ee, hb, li, lt, matched, commit, voter, member,
      crashed, ts, app, ee_out, hb_out, li_out, lt_out, matched_out,
      commit_out, rounds, election_tick, heartbeat_tick);
}

}  // namespace

extern "C" int steady_round_launch(
    const void* state, const void* term, const void* ee, const void* hb,
    const void* li, const void* lt, const void* matched, const void* commit,
    const void* voter, const void* member, const void* crashed,
    const void* ts, const void* app, void* ee_out, void* hb_out,
    void* li_out, void* lt_out, void* matched_out, void* commit_out,
    long long G, int P, int rounds, int election_tick, int heartbeat_tick,
    void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((G + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define RAFT_STEADY_LAUNCH(NP)                                              \
  case NP:                                                                  \
    steady_round_kernel<NP><<<blocks, kThreads, 0, s>>>(                    \
        (const int32_t*)state, (const int32_t*)term, (const int32_t*)ee,    \
        (const int32_t*)hb, (const int32_t*)li, (const int32_t*)lt,         \
        (const int32_t*)matched, (const int32_t*)commit,                    \
        (const uint8_t*)voter, (const uint8_t*)member,                      \
        (const uint8_t*)crashed, (const int32_t*)ts, (const int32_t*)app,   \
        (int32_t*)ee_out, (int32_t*)hb_out, (int32_t*)li_out,               \
        (int32_t*)lt_out, (int32_t*)matched_out, (int32_t*)commit_out,      \
        (int64_t)G, rounds, election_tick, heartbeat_tick);                 \
    break;
  switch (P) {
    RAFT_STEADY_FOR_EACH_P(RAFT_STEADY_LAUNCH)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RAFT_STEADY_LAUNCH
  return (int)cudaGetLastError();
}
