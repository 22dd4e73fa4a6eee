// Host build of steady_predicate.cuh: the same per-group body as the CUDA
// kernel, looped over the groups on the CPU, the flag reduced block by
// block as the grid reduces it.  Compiled with g++ by the tests so the
// kernel's arithmetic can be held against the plain PyTorch composition
// (fused_step.steady_mask) on a machine without a card; nothing on the
// card path uses it.  Takes steady_predicate_launch's arguments but the
// stream.
#include <stdint.h>

#include "steady_predicate.cuh"

extern "C" int steady_predicate_host(
    const void* state, const void* term, const void* election_elapsed,
    const void* randomized_timeout, const void* voter, const void* outgoing,
    const void* crashed, const void* recent_active, const void* transferee,
    const void* reconfig_pending, const void* read_pending, void* mask_out,
    void* flag, long long G, int P, int horizon, int election_tick,
    int heartbeat_tick, int flags) {
  using raft_predicate::kThreads;
  const raft_predicate::Planes in = {
      (const int32_t*)state,      (const int32_t*)term,
      (const int32_t*)election_elapsed, (const int32_t*)randomized_timeout,
      (const uint8_t*)voter,      (const uint8_t*)outgoing,
      (const uint8_t*)crashed,    (const uint8_t*)recent_active,
      (const int32_t*)transferee, (const uint8_t*)reconfig_pending,
      (const uint8_t*)read_pending};
  if (raft_predicate::refused(in, mask_out, flag, P, election_tick,
                              heartbeat_tick, flags)) {
    return 1;
  }
  if (flag != nullptr) *(int32_t*)flag = 0x01010101;
  for (int64_t b = 0; b < (int64_t)G; b += kThreads) {
    bool block_ok = true;
    for (int64_t g = b; g < b + kThreads && g < (int64_t)G; ++g) {
      const bool ok = raft_predicate::steady_group(
          in, g, (int64_t)G, P, horizon, election_tick, heartbeat_tick,
          flags);
      if (mask_out != nullptr) ((uint8_t*)mask_out)[g] = ok ? 1 : 0;
      block_ok = block_ok && ok;
    }
    if (!block_ok && flag != nullptr) *(int32_t*)flag = 0;
  }
  return 0;
}
