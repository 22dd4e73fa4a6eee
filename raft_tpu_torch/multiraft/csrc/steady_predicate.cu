// Grid wrapper around steady_predicate.cuh for sm_90a: one thread per
// group (neighbouring threads read neighbouring words of each plane row),
// kThreads threads a block.  Each block ANDs its groups' invariant with
// __syncthreads_and, and a block where some group fails clears the
// whole-batch flag with one atomicAnd; the per-group mask is written only
// when mask_out is given.  The launcher sets the flag (when given) and
// launches on the caller's stream, so a predicate is at most two device
// operations; it allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch reaches the caller.
//
// The flag is one int32 word set to 0x01010101 (true in every byte) and
// cleared to 0, so its first byte reads as a bool.
#include <cuda_runtime.h>
#include <stdint.h>

#include "steady_predicate.cuh"

namespace {

using raft_predicate::kThreads;

__global__ void __launch_bounds__(kThreads) steady_predicate_kernel(
    raft_predicate::Planes in, uint8_t* __restrict__ mask_out,
    int* __restrict__ flag, int64_t G, int P, int32_t horizon,
    int32_t election_tick, int32_t heartbeat_tick, int flags) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool ok = true;
  if (g < G) {
    ok = raft_predicate::steady_group(in, g, G, P, horizon, election_tick,
                                      heartbeat_tick, flags);
    if (mask_out != nullptr) mask_out[g] = ok ? 1 : 0;
  }
  // `flag` is the same for every thread of the grid, so the whole block
  // reaches the barrier or none of it does.
  if (flag != nullptr) {
    const int block_ok = __syncthreads_and(ok ? 1 : 0);
    if (!block_ok && threadIdx.x == 0) atomicAnd(flag, 0);
  }
}

}  // namespace

extern "C" int steady_predicate_launch(
    const void* state, const void* term, const void* election_elapsed,
    const void* randomized_timeout, const void* voter, const void* outgoing,
    const void* crashed, const void* recent_active, const void* transferee,
    const void* reconfig_pending, const void* read_pending, void* mask_out,
    void* flag, long long G, int P, int horizon, int election_tick,
    int heartbeat_tick, int flags, void* stream) {
  const raft_predicate::Planes in = {
      (const int32_t*)state,      (const int32_t*)term,
      (const int32_t*)election_elapsed, (const int32_t*)randomized_timeout,
      (const uint8_t*)voter,      (const uint8_t*)outgoing,
      (const uint8_t*)crashed,    (const uint8_t*)recent_active,
      (const int32_t*)transferee, (const uint8_t*)reconfig_pending,
      (const uint8_t*)read_pending};
  if (raft_predicate::refused(in, mask_out, flag, P, election_tick,
                              heartbeat_tick, flags)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (flag != nullptr) {
    const cudaError_t err = cudaMemsetAsync(flag, 1, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (G <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((G + kThreads - 1) / kThreads);
  steady_predicate_kernel<<<blocks, kThreads, 0, s>>>(
      in, (uint8_t*)mask_out, (int*)flag, (int64_t)G, P, horizon,
      election_tick, heartbeat_tick, flags);
  return (int)cudaGetLastError();
}
