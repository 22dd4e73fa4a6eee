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
    long long G, int P, int rounds, int election_tick, int heartbeat_tick) {
#define RAFT_STEADY_HOST(NP)                                                \
  case NP:                                                                  \
    for (int64_t g = 0; g < (int64_t)G; ++g) {                              \
      raft_steady::steady_group<NP>(                                        \
          g, (int64_t)G, (const int32_t*)state, (const int32_t*)term,       \
          (const int32_t*)ee, (const int32_t*)hb, (const int32_t*)li,       \
          (const int32_t*)lt, (const int32_t*)matched,                      \
          (const int32_t*)commit, (const uint8_t*)voter,                    \
          (const uint8_t*)member, (const uint8_t*)crashed,                  \
          (const int32_t*)ts, (const int32_t*)app, (int32_t*)ee_out,        \
          (int32_t*)hb_out, (int32_t*)li_out, (int32_t*)lt_out,             \
          (int32_t*)matched_out, (int32_t*)commit_out, rounds,              \
          election_tick, heartbeat_tick);                                   \
    }                                                                       \
    return 0;
  switch (P) {
    RAFT_STEADY_FOR_EACH_P(RAFT_STEADY_HOST)
    default:
      return 1;
  }
#undef RAFT_STEADY_HOST
}
