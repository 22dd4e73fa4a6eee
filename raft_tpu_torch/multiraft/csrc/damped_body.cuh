// Per-group body of k fused check-quorum/pre-vote steady rounds: the
// arithmetic of raft_tpu/multiraft/pallas_step.py:_steady_damped_kernel,
// every variant, written once for both the CUDA grid wrapper
// (damped_round.cu) and the host shim the CPU tests build with g++
// (damped_host.cpp).  The plain PyTorch version is
// damped_kernel.damped_rounds_reference; this body computes the same
// function on any planes, so sums over several (or no) leaders follow its
// int32 sums.
//
// Layout: every [P, G] plane is peer-major (group g's column is
// plane[p * G + g]) and every [P, P, G] plane pair-major
// (plane[(a * P + b) * G + g]).  One call handles one group: it loads the
// group's P-column of every plane into unrolled per-peer arrays and its
// per-peer flags into bit masks (registers on the card), copies its
// [P, P] agree block into `blk`, runs `rounds` rounds and stores the
// outputs.  The block's storage is the Block template parameter
// (fused_common.cuh, shared with chaos_body.cuh): ArrayBlock, a plain
// array (the g++ build, and the CUDA build up to P = 8, where it sits in
// registers), or StridedBlock, the thread's column of a shared-memory
// block (the CUDA build past P = 8; damped_round.cu).
// WITH_CQ adds the check-quorum row clear at the leader's
// election-timeout boundary; WITH_LOSS the per-link loss draw, keyed on
// (round_base + r, src, dst, gid) with gid the group's global index
// (group_base + g), as in chaos_body.cuh; WITH_HEALTH tracks
// ticks_since_commit from tsc into tsc_out (fused_common.cuh's
// CommitTracker).  The acting leaders (alive peers in the leader role),
// their id and term, the voter count and the append count are fixed for
// the whole horizon.
//
// Two facts of that horizon keep the work to what the outputs need:
// - Every agreement event puts all acting leaders in its set whenever the
//   set is not empty (adopt_event adds them; wave 6's set holds them as
//   soon as any member syncs).  Each leader's row then becomes the same
//   row, so the leaders' summed row, which the reference reads back
//   (lead_row(agree)), is n_lead times that row.  The body carries the
//   sum in registers from the load on and only writes the block in the
//   rounds; the block is read once, to store it.
// - Only the links with an acting leader at one end reach the delivery
//   masks.  With loss the body draws only those (fused_common.cuh's
//   LeaderLinks, shared with chaos_body.cuh): with one acting leader L
//   (every group of a fused block), the links of L's row and column, with
//   their 2P rates loaded once; with several, each leader's row and column
//   in turn, the rates read from the plane; with none, nothing.  A draw is
//   a pure function of (round, src, dst, gid, rate), so these are the
//   reference's bits.
#pragma once

#include <stdint.h>

#include "fused_common.cuh"

namespace raft_damped {

using raft_fused::adopt_event;
using raft_fused::bit;
using raft_fused::block_event;
using raft_fused::flag;
using raft_fused::imax;
using raft_fused::imin;
using raft_fused::kRoleFollower;
using raft_fused::kRoleLeader;
using raft_fused::opaque;
using raft_fused::quorum_of;
using raft_fused::wadd;

// Operand and output pointers of one call.  [P, G] planes: state,
// leader_id, hb, ee, li, lt, commit and the acting leader's matched row
// (int32), its recent_active row ra, voter, member and crashed (one byte
// each, nonzero = true); [P, P, G]: agree and, with loss, loss_rate
// (int32; null without loss); [G]: the acting leader's term_start, its
// term and the append count (int32); with health, ticks_since_commit in
// and out ([G] int32; null otherwise).  ra_out is one byte a peer.
struct DampedPlanes {
  const int32_t* state;
  const int32_t* leader_id;
  const int32_t* hb;
  const int32_t* ee;
  const int32_t* li;
  const int32_t* lt;
  const int32_t* commit;
  const int32_t* matched;
  const uint8_t* ra;
  const uint8_t* voter;
  const uint8_t* member;
  const uint8_t* crashed;
  const int32_t* agree;
  const int32_t* loss_rate;
  const int32_t* ts;
  const int32_t* lead_term;
  const int32_t* app;
  int32_t* state_out;
  int32_t* leader_id_out;
  int32_t* hb_out;
  int32_t* ee_out;
  int32_t* li_out;
  int32_t* lt_out;
  int32_t* commit_out;
  int32_t* matched_out;
  uint8_t* ra_out;
  int32_t* agree_out;
  const int32_t* tsc;
  int32_t* tsc_out;
};

template <int P, bool WITH_CQ, bool WITH_LOSS, bool WITH_HEALTH, class Block>
RAFT_HD void damped_group(int64_t g, int64_t G, const DampedPlanes& t,
                          int32_t round_base, int rounds, int election_tick,
                          int heartbeat_tick, int64_t group_base, Block& blk) {
  int32_t state[P], leader[P], hb[P], ee[P], li[P], lt[P], commit[P], mrow[P];
  uint32_t ra = 0, voter = 0, member = 0, alive = 0, role = 0;
  int32_t count = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = (int64_t)p * G + g;
    state[p] = t.state[i];
    leader[p] = t.leader_id[i];
    hb[p] = t.hb[i];
    ee[p] = t.ee[i];
    li[p] = t.li[i];
    lt[p] = t.lt[i];
    commit[p] = t.commit[i];
    mrow[p] = t.matched[i];
    ra |= flag(t.ra[i] != 0, p);
    voter |= flag(t.voter[i] != 0, p);
    member |= flag(t.member[i] != 0, p);
    alive |= flag(t.crashed[i] == 0, p);
    role |= flag(state[p] == kRoleLeader, p);
    if (t.voter[i] != 0) count += 1;
  }
  // The acting leaders: alive peers in the leader role.
  const uint32_t lead = role & alive;
  const bool has_leader = lead != 0;
  int32_t lead_id_val = 0;
  uint32_t n_lead = 0;
  int lone = 0;  // the acting leader's slot when n_lead == 1
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (bit(lead, p)) {
      lead_id_val = wadd(lead_id_val, p + 1);
      n_lead += 1;
      lone = p;
    }
  }
  // The block, and the leaders' summed row of it (the reference's lead_row(agree)).
  int32_t lead_row[P];
#pragma unroll
  for (int q = 0; q < P; ++q) lead_row[q] = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int32_t v = t.agree[((int64_t)p * P + q) * G + g];
      blk.set(p, q, v);
      if (bit(lead, p)) lead_row[q] = wadd(lead_row[q], v);
    }
  }
  // With loss, the draws on the acting leaders' links (fused_common.cuh).
  const raft_fused::LeaderLinks<P, WITH_LOSS> links(t.loss_rate, g, G, n_lead,
                                                    lone);
  const int32_t qpos = count / 2;
  const int32_t ts = t.ts[g];
  const int32_t ts_prev = wadd(ts, -1);  // a never-acked member's probe prev
  const int32_t lead_term = t.lead_term[g];
  const int32_t n_app = has_leader ? t.app[g] : 0;
  const bool sent_b = has_leader && n_app > 0;
  const uint32_t gid = (uint32_t)(group_base + g);
  const uint32_t up = alive & ~lead;  // alive peers other than the leaders
  raft_fused::CommitTracker<P, WITH_HEALTH> tsc(t.tsc, g, commit);

  for (int r = 0; r < rounds; ++r) {
    // --- delivery: forward (leader -> v) and reverse (v -> leader).  The
    // link plane is all-up among alive peers (the steady predicate), so
    // only the loss sample gates, and only on the leaders' links.
    uint32_t fwd = up, rev = up;
    if constexpr (WITH_LOSS) {
      const uint32_t key =
          raft_fused::loss_round_key(gid, (uint32_t)round_base + (uint32_t)r);
      uint32_t dfl, dtl;  // leader -> p dropped, p -> leader dropped
      links.draw(t.loss_rate, g, G, key, lead, dfl, dtl);
      fwd &= ~dfl;
      rev &= ~dtl;
    }

    // --- tick, with the leader's election-timeout boundary: with check
    // quorum it clears the acting leader's row to its own bit.
    bool beat = false, lead_bnd = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ee[p] = wadd(ee[p], 1);
      const bool boundary = bit(role, p) && ee[p] >= election_tick;
      if (boundary) ee[p] = 0;
      lead_bnd = lead_bnd || (boundary && bit(lead, p));
      if (bit(role, p)) hb[p] = wadd(hb[p], 1);
      const bool want_beat = bit(role, p) && hb[p] >= heartbeat_tick;
      if (want_beat) hb[p] = 0;
      beat = beat || (want_beat && bit(lead, p));
    }
    if (WITH_CQ && lead_bnd) ra = lead;

    // --- round-start snapshots of the leader's cursors
    int32_t c_l = 0, li_l = 0, lt_l = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(lead, p)) {
        c_l = wadd(c_l, commit[p]);
        li_l = wadd(li_l, li[p]);
        lt_l = wadd(lt_l, lt[p]);
      }
    }

    // --- wave 1: heartbeat delivery; wave 2a: the responses resume
    // probes and set recent_active bits; wave 3: catch-up appends under
    // the damped probe rule (a probe that does not match starts a retry
    // chain, which lands after stage A).
    const uint32_t h_acc = beat ? fwd & member : 0u;
    const uint32_t resumed = h_acc & rev;
    ra |= resumed;
    uint32_t adopt = 0, retry3 = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(h_acc, p)) {
        state[p] = kRoleFollower;
        leader[p] = lead_id_val;
        ee[p] = 0;
        commit[p] = imax(commit[p], imin(mrow[p], c_l));
      }
      const bool cu = bit(resumed, p) && mrow[p] < li_l;
      const bool probe = lead_row[p] >= (mrow[p] == 0 ? ts_prev : li_l);
      adopt |= flag(cu && probe, p);
      retry3 |= flag(cu && !probe, p);
      if (cu && probe) {
        commit[p] = imax(commit[p], c_l);
        li[p] = li_l;
        lt[p] = lt_l;
      }
    }
    adopt_event<P>(blk, adopt, lead, li_l, lead_row, n_lead);

    // --- wave 4: the probe-matched acks, then the stage-A commit
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(adopt, p)) mrow[p] = imax(mrow[p], li_l);
    }
    ra |= adopt;
    const int32_t mci = quorum_of<P>(mrow, voter, qpos);
    const bool ok_a = has_leader && count > 0 && mci >= ts;
    const int32_t c_new = ok_a ? imax(c_l, mci) : c_l;
    const bool adv = c_new > c_l;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(lead, p)) commit[p] = c_new;
      // the wave-3 retry resends land after stage A
      if (bit(retry3, p)) {
        commit[p] = imax(commit[p], c_l);
        li[p] = li_l;
        lt[p] = lt_l;
      }
    }
    adopt_event<P>(blk, retry3, lead, li_l, lead_row, n_lead);

    // --- wave 5: the commit-advance re-broadcast, damped probe rule
    uint32_t adopt5 = 0, retry5 = 0;
    if (adv) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bool rb5 = bit(fwd & member, p) && (mrow[p] > 0 || bit(resumed, p));
        const bool probe = lead_row[p] >= (mrow[p] == 0 ? ts_prev : li_l);
        const bool a5 = rb5 && probe;
        const bool r5 = rb5 && !probe && bit(rev, p);
        if (rb5) {
          state[p] = kRoleFollower;
          leader[p] = lead_id_val;
          ee[p] = 0;
        }
        if (a5 || r5) {
          li[p] = li_l;
          lt[p] = lt_l;
        }
        adopt5 |= flag(a5, p);
        retry5 |= flag(r5, p);
      }
    }
    const uint32_t ack5 = (adopt5 & rev) | retry3 | retry5;
    adopt_event<P>(blk, adopt5, lead, li_l, lead_row, n_lead);
    adopt_event<P>(blk, retry5, lead, li_l, lead_row, n_lead);

    // --- wave 6: the deferred acks, the stage-B commit and its
    // propagation to sendable members
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(ack5, p)) mrow[p] = imax(mrow[p], li_l);
    }
    ra |= ack5;
    const int32_t mci2 = quorum_of<P>(mrow, voter, qpos);
    const bool ok_b = has_leader && count > 0 && mci2 >= ts;
    const int32_t c_new2 = ok_b ? imax(c_new, mci2) : c_new;
    const int32_t lead_last = wadd(li_l, n_app);
    uint32_t sync_b = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(lead, p)) commit[p] = c_new2;
      const bool sendable = mrow[p] > 0 || bit(resumed, p);
      const bool elig = bit(fwd & member, p) && sendable &&
                        (lead_row[p] >= li_l || bit(rev, p)) && c_new2 > c_l;
      if (elig) commit[p] = imax(commit[p], c_new2);
      ra |= flag(elig && bit(rev, p), p);

      // --- the round's append workload at the acting leader
      if (bit(lead, p)) {
        li[p] = wadd(li[p], n_app);
        if (sent_b) lt[p] = lead_term;
      }
      const bool send_w = sent_b && bit(fwd & member, p) && sendable;
      const bool probe = lead_row[p] >= (mrow[p] == 0 ? ts_prev : li_l);
      const bool sync = send_w && (probe || bit(rev, p));
      if (send_w) {
        state[p] = kRoleFollower;
        leader[p] = lead_id_val;
        ee[p] = 0;
      }
      if (sync) {
        li[p] = lead_last;
        lt[p] = lead_term;
      }
      const bool ack_w = sync && bit(rev, p);
      if (ack_w || (bit(lead, p) && sent_b)) mrow[p] = imax(mrow[p], lead_last);
      ra |= flag(ack_w, p);
      sync_b |= flag(sync, p);
    }
    block_event<P>(blk, sync_b | (sent_b ? lead : 0u), lead_last, lead_row,
                   n_lead);
    const int32_t mci3 = quorum_of<P>(mrow, voter, qpos);
    const bool ok_c = sent_b && count > 0 && mci3 >= ts;
    const int32_t lead_commit = ok_c ? imax(c_new2, mci3) : c_new2;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(lead, p)) commit[p] = lead_commit;
      if (bit(sync_b, p)) commit[p] = imax(commit[p], lead_commit);
    }
    tsc.round(commit);
  }

  const int64_t gs = opaque(g), Gs = opaque(G);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = (int64_t)p * Gs + gs;
    t.state_out[i] = state[p];
    t.leader_id_out[i] = leader[p];
    t.hb_out[i] = hb[p];
    t.ee_out[i] = ee[p];
    t.li_out[i] = li[p];
    t.lt_out[i] = lt[p];
    t.commit_out[i] = commit[p];
    t.matched_out[i] = mrow[p];
    t.ra_out[i] = bit(ra, p) ? 1 : 0;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      t.agree_out[((int64_t)p * P + q) * Gs + gs] = blk.get(p, q);
    }
  }
  tsc.store(t.tsc_out, gs);
}

}  // namespace raft_damped

// Expands CASE(P, WITH_CQ, WITH_LOSS, WITH_HEALTH) for every instantiated
// combination.
#define RAFT_DAMPED_FOR_EACH_FLAG(CASE, NP)                          \
  CASE(NP, false, false, false) CASE(NP, true, false, false)         \
  CASE(NP, false, true, false) CASE(NP, true, true, false)           \
  CASE(NP, false, false, true) CASE(NP, true, false, true)           \
  CASE(NP, false, true, true) CASE(NP, true, true, true)
