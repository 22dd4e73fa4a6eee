// Per-group body of the dispatcher's steady invariant: the arithmetic of
// fused_step.steady_mask without a link plane (kernels.cq_boundary_safe's
// lossless arm with check quorum), written once for the CUDA grid wrapper
// (steady_predicate.cu) and the host shim the CPU tests build with g++
// (steady_predicate_host.cpp).
//
// Layout: [P, G] planes are peer-major (group g's column is plane[p * G +
// g]), recent_active [P, P, G] is owner-major (owner p's slot of peer j is
// [(p * P + j) * G + g]).  Inputs: state, term, election_elapsed,
// randomized_timeout (int32 [P, G]); voter, outgoing, crashed (bool [P,
// G], one byte each, nonzero = true); recent_active (bool [P, P, G], null
// without check quorum); transferee (int32 [P, G], null without the
// plane); reconfig_pending and read_pending (bool [G], each null when not
// given).
//
// P is a run-time argument: one pass over the group's P peers, kPeerBatch
// at a time, keeps counts and extremes, and only with check quorum a second
// pass reads the alive leader's recent_active row.  A group with more than
// one alive leader fails the invariant whatever the rows hold, so one row is
// enough.
#pragma once

#include <stdint.h>

#include "fused_common.cuh"

namespace raft_predicate {

using raft_fused::imax;
using raft_fused::imin;
using raft_fused::kRoleLeader;
using raft_fused::wadd;

// Bits of `flags`: the SimConfig fields the invariant reads.
constexpr int kBlackbox = 1;
constexpr int kCheckQuorum = 2;
constexpr int kPreVote = 4;

// Groups a block; the host shim ANDs its groups in blocks of the same
// size, so both builds reduce the flag the same way.
constexpr int kThreads = 256;
// Peers a thread loads at once: the loads of a batch are independent, so
// they are in flight together, and a group of up to kPeerBatch peers costs
// one round trip to memory (two with check quorum, whose leader's row
// depends on the first).
constexpr int kPeerBatch = 4;

struct Planes {
  const int32_t* state;
  const int32_t* term;
  const int32_t* election_elapsed;
  const int32_t* randomized_timeout;
  const uint8_t* voter;
  const uint8_t* outgoing;
  const uint8_t* crashed;
  const uint8_t* recent_active;
  const int32_t* transferee;
  const uint8_t* reconfig_pending;
  const uint8_t* read_pending;
};

// `count` of `n` members is a quorum (kernels.majority_of: n // 2 + 1);
// a half with no members passes.
RAFT_HD bool quorum(int32_t count, int32_t n) {
  return n == 0 || count >= n / 2 + 1;
}

// Every group fails whatever the state: a black-box config, or a damped one
// with election_tick <= heartbeat_tick.  No plane is read then.
RAFT_HD bool rejects_all(int32_t election_tick, int32_t heartbeat_tick,
                         int flags) {
  const bool damped = (flags & (kCheckQuorum | kPreVote)) != 0;
  return (flags & kBlackbox) != 0 ||
         (damped && election_tick <= heartbeat_tick);
}

// The arguments a launcher refuses: no output, P < 1, or a check-quorum
// config that reads recent_active without the plane.
RAFT_HD bool refused(const Planes& in, const void* mask_out, const void* flag,
                     int P, int32_t election_tick, int32_t heartbeat_tick,
                     int flags) {
  return P < 1 || (mask_out == nullptr && flag == nullptr) ||
         ((flags & kCheckQuorum) != 0 && in.recent_active == nullptr &&
          !rejects_all(election_tick, heartbeat_tick, flags));
}

RAFT_HD bool steady_group(const Planes& in, int64_t g, int64_t G, int P,
                          int32_t horizon, int32_t election_tick,
                          int32_t heartbeat_tick, int flags) {
  if (rejects_all(election_tick, heartbeat_tick, flags)) return false;
  const bool check_quorum = (flags & kCheckQuorum) != 0;
  const bool damped = check_quorum || (flags & kPreVote) != 0;
  if (in.reconfig_pending != nullptr && in.reconfig_pending[g] != 0) {
    return false;
  }
  if (in.read_pending != nullptr && in.read_pending[g] != 0) return false;
  // With heartbeat_tick == 1 on a plain config an alive follower is
  // re-synced every round, so only its first tick counts.
  const bool resync = heartbeat_tick == 1 && !damped;
  bool may_fire = false, joint = false, transfer = false, stale = false;
  bool any_alive = false;
  int32_t n_leaders = 0, leader = 0;
  // torch.where(is_leader, term, 0).amax(0), and the alive peers' extremes.
  int32_t lead_term = INT32_MIN, term_lo = INT32_MAX, term_hi = INT32_MIN;
  int32_t voters = 0, alive_voters = 0, outgoing = 0, alive_outgoing = 0;
  for (int p0 = 0; p0 < P; p0 += kPeerBatch) {
    int32_t state[kPeerBatch] = {}, term[kPeerBatch] = {}, ee[kPeerBatch] = {},
            rt[kPeerBatch] = {}, transferee[kPeerBatch] = {};
    uint8_t voter[kPeerBatch] = {}, out[kPeerBatch] = {},
            crashed[kPeerBatch] = {};
#pragma unroll
    for (int d = 0; d < kPeerBatch; ++d) {
      if (p0 + d < P) {
        const int64_t i = (int64_t)(p0 + d) * G + g;
        state[d] = in.state[i];
        term[d] = in.term[i];
        ee[d] = in.election_elapsed[i];
        rt[d] = in.randomized_timeout[i];
        voter[d] = in.voter[i];
        out[d] = in.outgoing[i];
        crashed[d] = in.crashed[i];
        if (in.transferee != nullptr) transferee[d] = in.transferee[i];
      }
    }
#pragma unroll
    for (int d = 0; d < kPeerBatch; ++d) {
      if (p0 + d >= P) continue;
      const bool alive = crashed[d] == 0;
      const bool role_leader = state[d] == kRoleLeader;
      const bool is_voter = voter[d] != 0;
      const bool is_out = out[d] != 0;
      // 1. no election timer can fire within the horizon
      const int32_t elapsed = wadd(ee[d], resync && alive ? 1 : horizon);
      may_fire = may_fire || (!role_leader && is_voter && elapsed >= rt[d]);
      // 2. exactly one alive leader; 3. alive peers at its term
      const bool is_leader = role_leader && alive;
      if (is_leader) {
        ++n_leaders;
        leader = p0 + d;
      }
      lead_term = imax(lead_term, is_leader ? term[d] : 0);
      if (alive) {
        any_alive = true;
        term_lo = imin(term_lo, term[d]);
        term_hi = imax(term_hi, term[d]);
      }
      // 4. not joint; 4a. no leader transfer pending
      joint = joint || is_out;
      transfer = transfer || transferee[d] > 0;
      // 6. the counts and the stale leaders' boundaries
      voters += is_voter ? 1 : 0;
      alive_voters += is_voter && alive ? 1 : 0;
      outgoing += is_out ? 1 : 0;
      alive_outgoing += is_out && alive ? 1 : 0;
      stale = stale || (role_leader && !alive &&
                        !(wadd(ee[d], horizon) < election_tick));
    }
  }
  const bool terms_ok =
      !any_alive || (term_lo == lead_term && term_hi == lead_term);
  const bool ok = !may_fire && n_leaders == 1 && terms_ok && !joint &&
                  !transfer;
  if (!ok || !check_quorum) return ok;
  // 6. every check-quorum boundary inside the horizon passes: the alive
  // voters form a quorum of each half, no crashed role-leader reaches its
  // boundary, and the alive leader's row (itself included) holds an active
  // quorum of each half.
  if (stale || !quorum(alive_voters, voters) ||
      !quorum(alive_outgoing, outgoing)) {
    return false;
  }
  int32_t active_voters = 0, active_outgoing = 0;
  for (int j0 = 0; j0 < P; j0 += kPeerBatch) {
    uint8_t row[kPeerBatch] = {}, voter[kPeerBatch] = {}, out[kPeerBatch] = {};
#pragma unroll
    for (int d = 0; d < kPeerBatch; ++d) {
      if (j0 + d < P) {
        const int64_t i = (int64_t)(j0 + d) * G + g;
        row[d] = in.recent_active[((int64_t)leader * P + j0 + d) * G + g];
        voter[d] = in.voter[i];
        out[d] = in.outgoing[i];
      }
    }
#pragma unroll
    for (int d = 0; d < kPeerBatch; ++d) {
      const bool active = j0 + d < P && (j0 + d == leader || row[d] != 0);
      active_voters += active && voter[d] != 0 ? 1 : 0;
      active_outgoing += active && out[d] != 0 ? 1 : 0;
    }
  }
  return quorum(active_voters, voters) && quorum(active_outgoing, outgoing);
}

}  // namespace raft_predicate
