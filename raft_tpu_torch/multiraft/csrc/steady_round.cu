// Grid wrapper around steady_body.cuh for sm_90a: one thread per group,
// 256 threads a block, the ragged last block masked by g < G.  Launches on
// the caller's stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so a refused launch reaches the caller.
// with_health picks the WITH_HEALTH instance, which reads tsc and writes
// tsc_out (both null otherwise).
#include <cuda_runtime.h>
#include <stdint.h>

#include "steady_body.cuh"

namespace {

constexpr int kThreads = 256;

template <int P, bool WITH_HEALTH>
__global__ void __launch_bounds__(kThreads) steady_round_kernel(
    const int32_t* __restrict__ state, const int32_t* __restrict__ term,
    const int32_t* __restrict__ ee, const int32_t* __restrict__ hb,
    const int32_t* __restrict__ li, const int32_t* __restrict__ lt,
    const int32_t* __restrict__ matched, const int32_t* __restrict__ commit,
    const uint8_t* __restrict__ voter, const uint8_t* __restrict__ member,
    const uint8_t* __restrict__ crashed, const int32_t* __restrict__ ts,
    const int32_t* __restrict__ app, const int32_t* __restrict__ tsc,
    int32_t* __restrict__ ee_out, int32_t* __restrict__ hb_out,
    int32_t* __restrict__ li_out, int32_t* __restrict__ lt_out,
    int32_t* __restrict__ matched_out, int32_t* __restrict__ commit_out,
    int32_t* __restrict__ tsc_out, int64_t G, int rounds, int election_tick,
    int heartbeat_tick) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  raft_steady::steady_group<P, WITH_HEALTH>(
      g, G, state, term, ee, hb, li, lt, matched, commit, voter, member,
      crashed, ts, app, tsc, ee_out, hb_out, li_out, lt_out, matched_out,
      commit_out, tsc_out, rounds, election_tick, heartbeat_tick);
}

}  // namespace

extern "C" int steady_round_launch(
    const void* state, const void* term, const void* ee, const void* hb,
    const void* li, const void* lt, const void* matched, const void* commit,
    const void* voter, const void* member, const void* crashed,
    const void* ts, const void* app, void* ee_out, void* hb_out,
    void* li_out, void* lt_out, void* matched_out, void* commit_out,
    const void* tsc, void* tsc_out, long long G, int P, int rounds,
    int election_tick, int heartbeat_tick, int with_health, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (with_health && (tsc == nullptr || tsc_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((G + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define RAFT_STEADY_LAUNCH(NP, HEALTH)                                      \
  case NP * 2 + (HEALTH ? 1 : 0):                                           \
    steady_round_kernel<NP, HEALTH><<<blocks, kThreads, 0, s>>>(            \
        RAFT_STEADY_ARGS);                                                  \
    break;
#define RAFT_STEADY_P(NP) RAFT_FOR_EACH_HEALTH(RAFT_STEADY_LAUNCH, NP)
#define RAFT_STEADY_ARGS                                                    \
  (const int32_t*)state, (const int32_t*)term, (const int32_t*)ee,          \
      (const int32_t*)hb, (const int32_t*)li, (const int32_t*)lt,           \
      (const int32_t*)matched, (const int32_t*)commit,                      \
      (const uint8_t*)voter, (const uint8_t*)member,                        \
      (const uint8_t*)crashed, (const int32_t*)ts, (const int32_t*)app,     \
      (const int32_t*)tsc, (int32_t*)ee_out, (int32_t*)hb_out,              \
      (int32_t*)li_out, (int32_t*)lt_out, (int32_t*)matched_out,            \
      (int32_t*)commit_out, (int32_t*)tsc_out, (int64_t)G, rounds,          \
      election_tick, heartbeat_tick
  switch (P * 2 + (with_health ? 1 : 0)) {
    RAFT_PEER_LIST(RAFT_STEADY_P)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RAFT_STEADY_ARGS
#undef RAFT_STEADY_P
#undef RAFT_STEADY_LAUNCH
  return (int)cudaGetLastError();
}
