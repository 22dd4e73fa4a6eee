// Grid wrapper around steady_warp_body.cuh for sm_90a: the steady kernel's
// instance for wide groups, one warp a group, or half a warp up to P =
// kHalfWarpPeers (steady_kernel.py runs it from _build.STEADY_WARP_PEERS
// up; it takes any P >= 1).  A block of 256 threads, or fewer where the tile
// would not fit, takes W = block_groups(P) consecutive groups (16 with
// half-warp groups, 8 with whole-warp ones while the tile fits): its
// threads copy the groups' [P, W] window of every plane into the
// shared-memory tile, each group's lanes run its rounds, and the threads
// copy the six output fields back.  J = ceil(P / lanes) slots a lane: J =
// 1..4 are template instances holding the slots in registers, past P =
// 128 one runtime-J instance works on the tile in place, with the tile in
// dynamic shared memory past 48 KB (the most a block may opt into, 227
// KB, holds one group at P = 8,015).  Launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue where a P is too wide for one group's tile.
//
// Replaces raft_tpu/multiraft/pallas_step.py:_steady_kernel (built by
// steady_round, :549) past the switch.  Its bound on an H100 and what the
// design does about it: steady_warp_body.cuh's header.
#include <cuda_runtime.h>
#include <stdint.h>

#include "steady_warp_body.cuh"

namespace {

using namespace raft_steady_warp;

constexpr int kThreads = kWarps * kLanes;

template <int J, bool WITH_HEALTH, int LANES>
__global__ void __launch_bounds__(kThreads) steady_warp_kernel(
    Inputs in, Outputs out, int64_t G, int P, int groups, int rounds,
    int election_tick, int heartbeat_tick) {
  extern __shared__ __align__(16) unsigned char steady_tile[];
  // The register instances (P <= 128) always take a full block's groups:
  // a constant, so the tile's index arithmetic is shifts, not divisions.
  const int W = J > 0 ? kThreads / LANES : groups;
  const Tile tile(steady_tile, P, W);
  const int64_t g0 = (int64_t)blockIdx.x * W;
  load_tile(tile, in, g0, G, W, threadIdx.x, blockDim.x);
  __syncthreads();
  const int w = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  // The group's lanes: the whole warp, or its half.
  const unsigned mask =
      LANES == kLanes ? 0xFFFFFFFFu : 0xFFFFu << (threadIdx.x & 16);
  const int64_t g = g0 + w;
  if (g < G) {  // the same for all the group's lanes
    const int32_t tsc = WITH_HEALTH ? in.tsc[g] : 0;
    int32_t tsc_new;
    if constexpr (J > 0) {
      RegColumn<J, LANES> col;
      col.load(tile, w, lane);
      WarpLanes<RegColumn<J, LANES>> lanes{col, mask};
      tsc_new = steady_warp_rounds<WITH_HEALTH>(lanes, in.ts[g], in.app[g], tsc,
                                                rounds, election_tick,
                                                heartbeat_tick);
      col.store(tile, w, lane);
    } else {
      TileColumn col(tile, w, lane);
      WarpLanes<TileColumn> lanes{col, mask};
      tsc_new = steady_warp_rounds<WITH_HEALTH>(lanes, in.ts[g], in.app[g], tsc,
                                                rounds, election_tick,
                                                heartbeat_tick);
    }
    if (WITH_HEALTH && lane == 0) out.tsc[g] = tsc_new;
  }
  __syncthreads();
  store_tile(tile, out, g0, G, W, threadIdx.x, blockDim.x);
}

template <int J, bool WITH_HEALTH, int LANES>
cudaError_t launch(const Inputs& in, const Outputs& out, int64_t G, int P,
                   int rounds, int election_tick, int heartbeat_tick,
                   cudaStream_t s) {
  const auto kernel = steady_warp_kernel<J, WITH_HEALTH, LANES>;
  const int groups = block_groups(P);
  if (groups == 0) return cudaErrorInvalidValue;
  const int64_t smem = tile_bytes(P, groups);
  if (J == 0) {
    // Once an instance: the runtime-J tile may pass the default 48 KB.
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (opt_in != cudaSuccess) return opt_in;
  }
  const unsigned blocks = (unsigned)((G + groups - 1) / groups);
  steady_warp_kernel<J, WITH_HEALTH, LANES>
      <<<blocks, groups * LANES, (size_t)smem, s>>>(
          in, out, G, P, groups, rounds, election_tick, heartbeat_tick);
  return cudaGetLastError();
}

// out[0..4]: registers a thread, local memory bytes a thread (spills),
// shared memory bytes a block, threads a block, resident blocks an SM.
template <int J, bool WITH_HEALTH, int LANES>
cudaError_t occupancy(int P, int* out) {
  const auto kernel = steady_warp_kernel<J, WITH_HEALTH, LANES>;
  const int groups = block_groups(P);
  if (groups == 0) return cudaErrorInvalidValue;
  const int smem = (int)tile_bytes(P, groups);
  if (J == 0) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (rc != cudaSuccess) return rc;
  }
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return rc;
  int resident = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                     groups * LANES, smem);
  if (rc != cudaSuccess) return rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes + smem;
  out[3] = groups * LANES;
  out[4] = resident;
  return cudaSuccess;
}

// The instance of P: half-warp groups (one slot a lane) up to
// kHalfWarpPeers, else J = 1..kMaxRegJ, or 0 (runtime J) past them.
#define RAFT_WARP_DISPATCH(CALL, P, HEALTH)                              \
  if (group_lanes(P) < kLanes) {                                         \
    return HEALTH ? CALL(1, true, kLanes / 2) : CALL(1, false, kLanes / 2); \
  }                                                                      \
  switch (lane_slots(P) > kMaxRegJ ? 0 : lane_slots(P)) {                \
    case 1:                                                              \
      return HEALTH ? CALL(1, true, kLanes) : CALL(1, false, kLanes);    \
    case 2:                                                              \
      return HEALTH ? CALL(2, true, kLanes) : CALL(2, false, kLanes);    \
    case 3:                                                              \
      return HEALTH ? CALL(3, true, kLanes) : CALL(3, false, kLanes);    \
    case 4:                                                              \
      return HEALTH ? CALL(4, true, kLanes) : CALL(4, false, kLanes);    \
    default:                                                             \
      return HEALTH ? CALL(0, true, kLanes) : CALL(0, false, kLanes);    \
  }

}  // namespace

// The same arguments as steady_round.cu's steady_round_launch, for any P.
extern "C" int steady_round_launch(
    const void* state, const void* term, const void* ee, const void* hb,
    const void* li, const void* lt, const void* matched, const void* commit,
    const void* voter, const void* member, const void* crashed,
    const void* ts, const void* app, void* ee_out, void* hb_out,
    void* li_out, void* lt_out, void* matched_out, void* commit_out,
    const void* tsc, void* tsc_out, long long G, int P, int rounds,
    int election_tick, int heartbeat_tick, int with_health, void* stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  if (G <= 0) return (int)cudaSuccess;
  if (with_health && (tsc == nullptr || tsc_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Inputs in = {
      (const int32_t*)state,   (const int32_t*)term,    (const int32_t*)ee,
      (const int32_t*)hb,      (const int32_t*)li,      (const int32_t*)lt,
      (const int32_t*)matched, (const int32_t*)commit,  (const uint8_t*)voter,
      (const uint8_t*)member,  (const uint8_t*)crashed, (const int32_t*)ts,
      (const int32_t*)app,     (const int32_t*)tsc};
  const Outputs out = {(int32_t*)ee_out,      (int32_t*)hb_out,
                       (int32_t*)li_out,      (int32_t*)lt_out,
                       (int32_t*)matched_out, (int32_t*)commit_out,
                       (int32_t*)tsc_out};
  cudaStream_t s = (cudaStream_t)stream;
#define RAFT_WARP_LAUNCH(J, HEALTH, LANES)                              \
  (int)launch<J, HEALTH, LANES>(in, out, (int64_t)G, P, rounds,         \
                                election_tick, heartbeat_tick, s)
  RAFT_WARP_DISPATCH(RAFT_WARP_LAUNCH, P, with_health)
#undef RAFT_WARP_LAUNCH
}

// Groups a block at P, 0 where one group's tile does not fit.
extern "C" int steady_warp_block_groups(int P) { return block_groups(P); }

// P's instance's registers, local bytes, shared bytes a block, threads a
// block and resident blocks an SM into out[0..4].
extern "C" int steady_round_occupancy(int P, int with_health, int* out) {
  if (P < 1) return (int)cudaErrorInvalidValue;
#define RAFT_WARP_OCCUPANCY(J, HEALTH, LANES) \
  (int)occupancy<J, HEALTH, LANES>(P, out)
  RAFT_WARP_DISPATCH(RAFT_WARP_OCCUPANCY, P, with_health)
#undef RAFT_WARP_OCCUPANCY
}
