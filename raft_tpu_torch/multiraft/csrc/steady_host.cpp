// Host build of steady_body.cuh: the same per-group body as the CUDA
// kernel, looped over the groups on the CPU.  Compiled with g++ by the
// tests so the kernel's arithmetic can be held against the plain PyTorch
// version on a machine without a card; nothing on the card path uses it.
#include <stdint.h>

#include "steady_body.cuh"

extern "C" int steady_round_host(
    const void* state, const void* term, const void* ee, const void* hb,
    const void* li, const void* lt, const void* matched, const void* commit,
    const void* voter, const void* member, const void* crashed,
    const void* ts, const void* app, void* ee_out, void* hb_out,
    void* li_out, void* lt_out, void* matched_out, void* commit_out,
    const void* tsc, void* tsc_out, long long G, int P, int rounds,
    int election_tick, int heartbeat_tick, int with_health) {
  if (with_health && (tsc == nullptr || tsc_out == nullptr)) return 1;
#define RAFT_STEADY_HOST_ARGS                                               \
  (const int32_t*)state, (const int32_t*)term, (const int32_t*)ee,          \
      (const int32_t*)hb, (const int32_t*)li, (const int32_t*)lt,           \
      (const int32_t*)matched, (const int32_t*)commit,                      \
      (const uint8_t*)voter, (const uint8_t*)member,                        \
      (const uint8_t*)crashed, (const int32_t*)ts, (const int32_t*)app,     \
      (const int32_t*)tsc, (int32_t*)ee_out, (int32_t*)hb_out,              \
      (int32_t*)li_out, (int32_t*)lt_out, (int32_t*)matched_out,            \
      (int32_t*)commit_out, (int32_t*)tsc_out, rounds, election_tick,       \
      heartbeat_tick
#define RAFT_STEADY_HOST(NP, HEALTH)                                        \
  case NP * 2 + (HEALTH ? 1 : 0):                                           \
    for (int64_t g = 0; g < (int64_t)G; ++g) {                              \
      raft_steady::steady_group<NP, HEALTH>(g, (int64_t)G,                  \
                                            RAFT_STEADY_HOST_ARGS);         \
    }                                                                       \
    return 0;
#define RAFT_STEADY_P(NP) RAFT_FOR_EACH_HEALTH(RAFT_STEADY_HOST, NP)
  switch (P * 2 + (with_health ? 1 : 0)) {
    RAFT_PEER_LIST(RAFT_STEADY_P)
    default:
#ifdef RAFT_STEADY_WARP_FROM
      if (P >= RAFT_STEADY_WARP_FROM) {
        return steady_warp_host(state, term, ee, hb, li, lt, matched, commit,
                                voter, member, crashed, ts, app, ee_out,
                                hb_out, li_out, lt_out, matched_out,
                                commit_out, tsc, tsc_out, G, P, rounds,
                                election_tick, heartbeat_tick, with_health);
      }
#endif
      return 1;
  }
#undef RAFT_STEADY_P
#undef RAFT_STEADY_HOST
#undef RAFT_STEADY_HOST_ARGS
}
