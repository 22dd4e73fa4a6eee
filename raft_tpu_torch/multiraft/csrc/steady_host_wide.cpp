// The wide instances of the steady host build, a library of its own beside
// the narrow one: P = 8 through 12 from the same wrapper and body as
// steady_host.cpp, and from P = RAFT_STEADY_WARP_FROM (the switch,
// _build.STEADY_WARP_PEERS, which passes it as a -D flag) the warp body of
// steady_warp_body.cuh, as on the card.
//
// The host has no warps: steady_warp_host runs the body's per-lane code
// for a group's emulated lanes (16 up to kHalfWarpPeers, else 32) one after
// another, each collective (any, wrapping sum, min, max) a serial loop
// over them (HostLanes), on the same tile layout, with the same selection
// and closed forms as the card, and the same choice of lane storage
// (registers up to J = 4, the tile in place past it).  It refuses a P
// whose one-group tile would not fit a block's shared memory on the card.
#define RAFT_PEER_LIST(CASE) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
#ifndef RAFT_STEADY_WARP_FROM
#error "build with -DRAFT_STEADY_WARP_FROM=P, the first P of the warp body"
#endif

#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "steady_warp_body.cuh"

namespace {

using namespace raft_steady_warp;

// `rounds` rounds of the group whose one-group tile is `tile`, its LANES
// lanes' slots in registers (J > 0) or in the tile (J = 0); returns tsc'.
template <int J, int LANES = kLanes>
int32_t warp_host_group(const Tile& tile, bool with_health, int32_t ts,
                        int32_t app, int32_t tsc, int rounds,
                        int election_tick, int heartbeat_tick) {
  auto run = [&](auto& lanes) {
    return with_health
               ? steady_warp_rounds<true>(lanes, ts, app, tsc, rounds,
                                          election_tick, heartbeat_tick)
               : steady_warp_rounds<false>(lanes, ts, app, tsc, rounds,
                                           election_tick, heartbeat_tick);
  };
  if constexpr (J > 0) {
    RegColumn<J, LANES> cols[LANES];
    for (int l = 0; l < LANES; ++l) cols[l].load(tile, 0, l);
    HostLanes<RegColumn<J, LANES>, LANES> lanes{cols};
    const int32_t out = run(lanes);
    for (int l = 0; l < LANES; ++l) cols[l].store(tile, 0, l);
    return out;
  } else {
    std::vector<TileColumn> cols;
    for (int l = 0; l < kLanes; ++l) cols.emplace_back(tile, 0, l);
    HostLanes<TileColumn> lanes{cols.data()};
    return run(lanes);
  }
}

}  // namespace

// The warp body at any P >= 1, the arguments of steady_round_host.
extern "C" int steady_warp_host(
    const void* state, const void* term, const void* ee, const void* hb,
    const void* li, const void* lt, const void* matched, const void* commit,
    const void* voter, const void* member, const void* crashed,
    const void* ts, const void* app, void* ee_out, void* hb_out,
    void* li_out, void* lt_out, void* matched_out, void* commit_out,
    const void* tsc, void* tsc_out, long long G, int P, int rounds,
    int election_tick, int heartbeat_tick, int with_health) {
  if (P < 1 || block_groups(P) == 0) return 1;
  if (with_health && (tsc == nullptr || tsc_out == nullptr)) return 1;
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
  std::vector<unsigned char> buf((size_t)tile_bytes(P, 1));
  const Tile tile(buf.data(), P, 1);
  const int J = lane_slots(P);
  for (int64_t g = 0; g < (int64_t)G; ++g) {
    load_tile(tile, in, g, G, 1, 0, 1);
    const int32_t tsc0 = with_health ? in.tsc[g] : 0;
    const auto args = [&](auto run) {
      return run(tile, with_health != 0, in.ts[g], in.app[g], tsc0, rounds,
                 election_tick, heartbeat_tick);
    };
    int32_t tsc_new;
    if (group_lanes(P) < kLanes) {
      tsc_new = args(warp_host_group<1, kLanes / 2>);
    } else {
      switch (J > kMaxRegJ ? 0 : J) {
        case 1: tsc_new = args(warp_host_group<1>); break;
        case 2: tsc_new = args(warp_host_group<2>); break;
        case 3: tsc_new = args(warp_host_group<3>); break;
        case 4: tsc_new = args(warp_host_group<4>); break;
        default: tsc_new = args(warp_host_group<0>); break;
      }
    }
    if (with_health) out.tsc[g] = tsc_new;
    store_tile(tile, out, g, G, 1, 0, 1);
  }
  return 0;
}

// Groups a block at P on the card, 0 where one group's tile does not fit
// (steady_round_warp.cu's steady_warp_block_groups).
extern "C" int steady_warp_block_groups(int P) { return block_groups(P); }

#include "steady_host.cpp"
