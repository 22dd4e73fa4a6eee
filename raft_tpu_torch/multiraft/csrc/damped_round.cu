// Grid wrapper around damped_body.cuh for sm_90a: one thread per group,
// 256 threads a block, the ragged last block masked by g < G; the global
// thread index is the group id that keys the loss draw.  Launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch reaches the caller.  with_health
// picks the WITH_HEALTH instances, which read tsc and write tsc_out (both
// null otherwise).
#include <cuda_runtime.h>
#include <stdint.h>

#include "damped_body.cuh"

namespace {

constexpr int kThreads = 256;

template <int P, bool WITH_CQ, bool WITH_LOSS, bool WITH_HEALTH>
__global__ void __launch_bounds__(kThreads)
    damped_round_kernel(raft_damped::DampedPlanes t, int64_t G,
                        int32_t round_base, int rounds, int election_tick,
                        int heartbeat_tick) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  raft_damped::damped_group<P, WITH_CQ, WITH_LOSS, WITH_HEALTH>(
      g, G, t, round_base, rounds, election_tick, heartbeat_tick);
}

}  // namespace

extern "C" int damped_round_launch(
    const void* state, const void* leader_id, const void* hb, const void* ee,
    const void* li, const void* lt, const void* commit, const void* matched,
    const void* ra, const void* voter, const void* member,
    const void* crashed, const void* agree, const void* loss_rate,
    const void* ts, const void* lead_term, const void* app, void* state_out,
    void* leader_id_out, void* hb_out, void* ee_out, void* li_out,
    void* lt_out, void* commit_out, void* matched_out, void* ra_out,
    void* agree_out, const void* tsc, void* tsc_out, long long G, int P,
    int round_base, int rounds, int election_tick, int heartbeat_tick,
    int with_cq, int with_loss, int with_health,
    void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  const raft_damped::DampedPlanes t = {
      (const int32_t*)state,     (const int32_t*)leader_id,
      (const int32_t*)hb,        (const int32_t*)ee,
      (const int32_t*)li,        (const int32_t*)lt,
      (const int32_t*)commit,    (const int32_t*)matched,
      (const uint8_t*)ra,        (const uint8_t*)voter,
      (const uint8_t*)member,    (const uint8_t*)crashed,
      (const int32_t*)agree,     (const int32_t*)loss_rate,
      (const int32_t*)ts,        (const int32_t*)lead_term,
      (const int32_t*)app,       (int32_t*)state_out,
      (int32_t*)leader_id_out,   (int32_t*)hb_out,
      (int32_t*)ee_out,          (int32_t*)li_out,
      (int32_t*)lt_out,          (int32_t*)commit_out,
      (int32_t*)matched_out,     (uint8_t*)ra_out,
      (int32_t*)agree_out,       (const int32_t*)tsc,
      (int32_t*)tsc_out};
  const int flags =
      (with_cq ? 1 : 0) + (with_loss ? 2 : 0) + (with_health ? 4 : 0);
  if (with_loss && loss_rate == nullptr) return (int)cudaErrorInvalidValue;
  if (with_health && (tsc == nullptr || tsc_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((G + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define RAFT_DAMPED_LAUNCH(NP, CQ, LOSS, HEALTH)                          \
  case NP * 8 + (CQ ? 1 : 0) + (LOSS ? 2 : 0) + (HEALTH ? 4 : 0):         \
    damped_round_kernel<NP, CQ, LOSS, HEALTH><<<blocks, kThreads, 0, s>>>( \
        t, (int64_t)G, (int32_t)round_base, rounds, election_tick,        \
        heartbeat_tick);                                                  \
    break;
#define RAFT_DAMPED_P(NP) RAFT_DAMPED_FOR_EACH_FLAG(RAFT_DAMPED_LAUNCH, NP)
  switch (P * 8 + flags) {
    RAFT_PEER_LIST(RAFT_DAMPED_P)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RAFT_DAMPED_P
#undef RAFT_DAMPED_LAUNCH
  return (int)cudaGetLastError();
}
