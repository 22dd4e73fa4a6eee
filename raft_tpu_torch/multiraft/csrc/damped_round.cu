// Grid wrapper around damped_body.cuh for sm_90a: one thread per group,
// DampedShape<P>::kThreads threads a block, the ragged last block masked
// by g < G; the global thread index plus group_base (the block's first id
// on a rank of a mesh run, else 0) is the group id that keys the loss
// draw.  Each thread keeps its group's [P, P] agree block in registers
// (P <= 8) or in its own column of the block's dynamic shared memory
// (P > 8), and the shape's minimum of resident blocks caps the registers
// so that 16 warps an SM fit at P <= 5.  Launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// so a refused launch reaches the caller.  with_health picks the
// WITH_HEALTH instances, which read tsc and write tsc_out (both null
// otherwise).  damped_round_occupancy reports an instance's registers,
// local (spill) bytes, shared memory, threads a block and resident blocks
// an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "damped_body.cuh"

namespace {

// Where each group's [P, P] agree block lives, threads a block, and the
// minimum of resident blocks an SM that __launch_bounds__ asks for (which
// caps the registers at 65,536 / (threads * blocks)), by peer count, as
// the card measured them (PERF.md, section 6): up to P = 8 the block sits in
// registers (ArrayBlock), which ran faster than the shared-memory column
// at P = 3, 5 and 7; past it in the thread's column of the block's dynamic
// shared memory (StridedBlock, P * P * 4 bytes a thread, conflict-free),
// which ran P = 15 in half the time.  128 threads and 4 blocks (16 warps)
// at P <= 5; 3 blocks at P = 6 and 7; at P = 8 no cap, so 255 registers
// hold it without a spill; past P = 13 a block of 32 keeps the shared
// memory under the 48 KB a block gets without opting in.
template <int P>
struct DampedShape {
  static constexpr bool kShared = P > 8;
  static constexpr int kThreads = P <= 8 ? 128 : (P <= 13 ? 64 : 32);
  static constexpr int kMinBlocks = P <= 5 ? 4 : (P <= 7 ? 3 : 1);
  static constexpr int kSharedBytes = kShared ? P * P * 4 * kThreads : 0;
};

template <int P, bool WITH_CQ, bool WITH_LOSS, bool WITH_HEALTH>
__global__ void __launch_bounds__(DampedShape<P>::kThreads,
                                  DampedShape<P>::kMinBlocks)
    damped_round_kernel(raft_damped::DampedPlanes t, int64_t G,
                        int32_t round_base, int rounds, int election_tick,
                        int heartbeat_tick, int64_t group_base) {
  constexpr int T = DampedShape<P>::kThreads;
  const int64_t g = (int64_t)blockIdx.x * T + threadIdx.x;
  if (g >= G) return;
  if constexpr (DampedShape<P>::kShared) {
    extern __shared__ int32_t damped_agree_smem[];
    raft_fused::StridedBlock<P, T> blk{damped_agree_smem + threadIdx.x};
    raft_damped::damped_group<P, WITH_CQ, WITH_LOSS, WITH_HEALTH>(
        g, G, t, round_base, rounds, election_tick, heartbeat_tick,
        group_base, blk);
  } else {
    raft_fused::ArrayBlock<P> blk;
    raft_damped::damped_group<P, WITH_CQ, WITH_LOSS, WITH_HEALTH>(
        g, G, t, round_base, rounds, election_tick, heartbeat_tick,
        group_base, blk);
  }
}

template <int P, bool WITH_CQ, bool WITH_LOSS, bool WITH_HEALTH>
cudaError_t launch(const raft_damped::DampedPlanes& t, int64_t G,
                   int32_t round_base, int rounds, int election_tick,
                   int heartbeat_tick, int64_t group_base, cudaStream_t s) {
  using Shape = DampedShape<P>;
  const unsigned blocks = (unsigned)((G + Shape::kThreads - 1) / Shape::kThreads);
  damped_round_kernel<P, WITH_CQ, WITH_LOSS, WITH_HEALTH>
      <<<blocks, Shape::kThreads, Shape::kSharedBytes, s>>>(
          t, G, round_base, rounds, election_tick, heartbeat_tick, group_base);
  return cudaGetLastError();
}

// out[0..4]: registers a thread, local memory bytes a thread (spills),
// shared memory bytes a block, threads a block, resident blocks an SM.
template <int P, bool WITH_CQ, bool WITH_LOSS, bool WITH_HEALTH>
cudaError_t occupancy(int* out) {
  using Shape = DampedShape<P>;
  const auto kernel = damped_round_kernel<P, WITH_CQ, WITH_LOSS, WITH_HEALTH>;
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
    int with_cq, int with_loss, int with_health, long long group_base,
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
  cudaStream_t s = (cudaStream_t)stream;
#define RAFT_DAMPED_LAUNCH(NP, CQ, LOSS, HEALTH)                          \
  case NP * 8 + (CQ ? 1 : 0) + (LOSS ? 2 : 0) + (HEALTH ? 4 : 0):         \
    return (int)launch<NP, CQ, LOSS, HEALTH>(                             \
        t, (int64_t)G, (int32_t)round_base, rounds, election_tick,        \
        heartbeat_tick, (int64_t)group_base, s);
#define RAFT_DAMPED_P(NP) RAFT_DAMPED_FOR_EACH_FLAG(RAFT_DAMPED_LAUNCH, NP)
  switch (P * 8 + flags) {
    RAFT_PEER_LIST(RAFT_DAMPED_P)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RAFT_DAMPED_P
#undef RAFT_DAMPED_LAUNCH
}

extern "C" int damped_round_occupancy(int P, int with_cq, int with_loss,
                                      int with_health, int* out) {
  const int flags =
      (with_cq ? 1 : 0) + (with_loss ? 2 : 0) + (with_health ? 4 : 0);
#define RAFT_DAMPED_OCCUPANCY(NP, CQ, LOSS, HEALTH)               \
  case NP * 8 + (CQ ? 1 : 0) + (LOSS ? 2 : 0) + (HEALTH ? 4 : 0): \
    return (int)occupancy<NP, CQ, LOSS, HEALTH>(out);
#define RAFT_DAMPED_P(NP) RAFT_DAMPED_FOR_EACH_FLAG(RAFT_DAMPED_OCCUPANCY, NP)
  switch (P * 8 + flags) {
    RAFT_PEER_LIST(RAFT_DAMPED_P)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RAFT_DAMPED_P
#undef RAFT_DAMPED_OCCUPANCY
}
