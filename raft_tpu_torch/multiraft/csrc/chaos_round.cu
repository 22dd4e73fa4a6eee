// Grid wrapper around chaos_body.cuh for sm_90a: one thread per group,
// ChaosShape<P>::kThreads threads a block, the ragged last block masked by
// g < G; the global thread index plus group_base (the block's first id on
// a rank of a mesh run, else 0) is the group id that keys the loss draw.
// Each thread keeps its group's [P, P] agree block in registers or in its
// own column of the block's dynamic shared memory (ChaosShape), and the
// shape's minimum of resident blocks caps the registers so that 16 warps
// an SM fit at P <= 5.  Launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so a
// refused launch reaches the caller.  with_health picks the WITH_HEALTH
// instance, which reads tsc and writes tsc_out (both null otherwise).
// chaos_round_occupancy reports an instance's registers, local (spill)
// bytes, shared memory, threads a block and resident blocks an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chaos_body.cuh"

namespace {

// Where each group's [P, P] agree block lives, threads a block, and the
// minimum of resident blocks an SM that __launch_bounds__ asks for (which
// caps the registers at 65,536 / (threads * blocks)), by peer count, as
// the card measured them (PERF.md, section 6): the block in registers
// (ArrayBlock) up to P = 13, which ran faster than the shared-memory
// column at P = 5, 7, 8, 9, 11, 12 and 13; past it in the thread's column
// of the block's dynamic shared memory (StridedBlock, P * P * 4 bytes a
// thread, conflict-free), which ran faster at P = 14 and 15, in a block of
// 32 threads, so that the columns fit the 48 KB a block gets without
// opting in.  128 threads and 4 blocks (16 warps) at P <= 5; 3 blocks at
// P = 6 and 7; past P = 7 no cap.
template <int P>
struct ChaosShape {
  static constexpr bool kShared = P > 13;
  static constexpr int kThreads = kShared ? 32 : 128;
  static constexpr int kMinBlocks = P <= 5 ? 4 : (P <= 7 ? 3 : 1);
  static constexpr int kSharedBytes = kShared ? P * P * 4 * kThreads : 0;
};

template <int P, bool WITH_HEALTH>
__global__ void __launch_bounds__(ChaosShape<P>::kThreads,
                                  ChaosShape<P>::kMinBlocks)
    chaos_round_kernel(raft_chaos::ChaosPlanes t, int64_t G, int32_t round_base,
                       int rounds, int election_tick, int heartbeat_tick,
                       int64_t group_base) {
  constexpr int T = ChaosShape<P>::kThreads;
  const int64_t g = (int64_t)blockIdx.x * T + threadIdx.x;
  if (g >= G) return;
  if constexpr (ChaosShape<P>::kShared) {
    extern __shared__ int32_t chaos_agree_smem[];
    raft_fused::StridedBlock<P, T> blk{chaos_agree_smem + threadIdx.x};
    raft_chaos::chaos_group<P, WITH_HEALTH>(g, G, t, round_base, rounds,
                                            election_tick, heartbeat_tick,
                                            group_base, blk);
  } else {
    raft_fused::ArrayBlock<P> blk;
    raft_chaos::chaos_group<P, WITH_HEALTH>(g, G, t, round_base, rounds,
                                            election_tick, heartbeat_tick,
                                            group_base, blk);
  }
}

template <int P, bool WITH_HEALTH>
cudaError_t launch(const raft_chaos::ChaosPlanes& t, int64_t G,
                   int32_t round_base, int rounds, int election_tick,
                   int heartbeat_tick, int64_t group_base, cudaStream_t s) {
  using Shape = ChaosShape<P>;
  const unsigned blocks = (unsigned)((G + Shape::kThreads - 1) / Shape::kThreads);
  chaos_round_kernel<P, WITH_HEALTH>
      <<<blocks, Shape::kThreads, Shape::kSharedBytes, s>>>(
          t, G, round_base, rounds, election_tick, heartbeat_tick, group_base);
  return cudaGetLastError();
}

// out[0..4]: registers a thread, local memory bytes a thread (spills),
// shared memory bytes a block, threads a block, resident blocks an SM.
template <int P, bool WITH_HEALTH>
cudaError_t occupancy(int* out) {
  using Shape = ChaosShape<P>;
  const auto kernel = chaos_round_kernel<P, WITH_HEALTH>;
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return rc;
  int resident = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, kernel, Shape::kThreads, Shape::kSharedBytes);
  if (rc != cudaSuccess) return rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes + Shape::kSharedBytes;
  out[3] = Shape::kThreads;
  out[4] = resident;
  return cudaSuccess;
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
    long long group_base, void* stream) {
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
  cudaStream_t s = (cudaStream_t)stream;
#define RAFT_CHAOS_LAUNCH(NP, HEALTH)                                     \
  case NP * 2 + (HEALTH ? 1 : 0):                                         \
    return (int)launch<NP, HEALTH>(t, (int64_t)G, (int32_t)round_base,    \
                                   rounds, election_tick, heartbeat_tick, \
                                   (int64_t)group_base, s);
#define RAFT_CHAOS_P(NP) RAFT_FOR_EACH_HEALTH(RAFT_CHAOS_LAUNCH, NP)
  switch (P * 2 + (with_health ? 1 : 0)) {
    RAFT_PEER_LIST(RAFT_CHAOS_P)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RAFT_CHAOS_P
#undef RAFT_CHAOS_LAUNCH
}

extern "C" int chaos_round_occupancy(int P, int with_health, int* out) {
#define RAFT_CHAOS_OCCUPANCY(NP, HEALTH) \
  case NP * 2 + (HEALTH ? 1 : 0):        \
    return (int)occupancy<NP, HEALTH>(out);
#define RAFT_CHAOS_P(NP) RAFT_FOR_EACH_HEALTH(RAFT_CHAOS_OCCUPANCY, NP)
  switch (P * 2 + (with_health ? 1 : 0)) {
    RAFT_PEER_LIST(RAFT_CHAOS_P)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RAFT_CHAOS_P
#undef RAFT_CHAOS_OCCUPANCY
}
