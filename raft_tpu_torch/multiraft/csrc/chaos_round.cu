// Grid wrapper around chaos_body.cuh for sm_90a: one thread per group,
// 256 threads a block, the ragged last block masked by g < G; the global
// thread index is the group id that keys the loss draw.  Launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch reaches the caller.  with_health
// picks the WITH_HEALTH instance, which reads tsc and writes tsc_out (both
// null otherwise).
#include <cuda_runtime.h>
#include <stdint.h>

#include "chaos_body.cuh"

namespace {

constexpr int kThreads = 256;

template <int P, bool WITH_HEALTH>
__global__ void __launch_bounds__(kThreads)
    chaos_round_kernel(raft_chaos::ChaosPlanes t, int64_t G, int32_t round_base,
                       int rounds, int election_tick, int heartbeat_tick) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  raft_chaos::chaos_group<P, WITH_HEALTH>(g, G, t, round_base, rounds,
                                          election_tick, heartbeat_tick);
}

}  // namespace

extern "C" int chaos_round_launch(
    const void* state, const void* leader_id, const void* hb, const void* ee,
    const void* li, const void* lt, const void* commit, const void* matched,
    const void* voter, const void* member, const void* crashed,
    const void* agree, const void* loss_rate, const void* ts,
    const void* lead_term, const void* app, void* state_out,
    void* leader_id_out, void* hb_out, void* ee_out, void* li_out,
    void* lt_out, void* commit_out, void* matched_out, void* agree_out,
    const void* tsc, void* tsc_out, long long G, int P, int round_base,
    int rounds, int election_tick, int heartbeat_tick, int with_health,
    void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (with_health && (tsc == nullptr || tsc_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const raft_chaos::ChaosPlanes t = {
      (const int32_t*)state,    (const int32_t*)leader_id,
      (const int32_t*)hb,       (const int32_t*)ee,
      (const int32_t*)li,       (const int32_t*)lt,
      (const int32_t*)commit,   (const int32_t*)matched,
      (const uint8_t*)voter,    (const uint8_t*)member,
      (const uint8_t*)crashed,  (const int32_t*)agree,
      (const int32_t*)loss_rate, (const int32_t*)ts,
      (const int32_t*)lead_term, (const int32_t*)app,
      (int32_t*)state_out,      (int32_t*)leader_id_out,
      (int32_t*)hb_out,         (int32_t*)ee_out,
      (int32_t*)li_out,         (int32_t*)lt_out,
      (int32_t*)commit_out,     (int32_t*)matched_out,
      (int32_t*)agree_out,      (const int32_t*)tsc,
      (int32_t*)tsc_out};
  const unsigned blocks = (unsigned)((G + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define RAFT_CHAOS_LAUNCH(NP, HEALTH)                                     \
  case NP * 2 + (HEALTH ? 1 : 0):                                         \
    chaos_round_kernel<NP, HEALTH><<<blocks, kThreads, 0, s>>>(           \
        t, (int64_t)G, (int32_t)round_base, rounds, election_tick,        \
        heartbeat_tick);                                                  \
    break;
#define RAFT_CHAOS_P(NP) RAFT_FOR_EACH_HEALTH(RAFT_CHAOS_LAUNCH, NP)
  switch (P * 2 + (with_health ? 1 : 0)) {
    RAFT_PEER_LIST(RAFT_CHAOS_P)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RAFT_CHAOS_P
#undef RAFT_CHAOS_LAUNCH
  return (int)cudaGetLastError();
}
