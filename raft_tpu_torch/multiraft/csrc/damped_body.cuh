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
// group's P-column of every plane, the acting leader's recent_active row
// and its [P, P] agree block (and loss_rate block when WITH_LOSS) into
// fully unrolled arrays, runs `rounds` rounds on registers, and stores the
// outputs.  WITH_CQ adds the check-quorum row clear at the leader's
// election-timeout boundary; WITH_LOSS the per-link loss draw, keyed on
// (round_base + r, src, dst, gid) with gid the group's global index
// (group_base + g), as in chaos_body.cuh; WITH_HEALTH tracks
// ticks_since_commit from tsc into tsc_out (fused_common.cuh's
// CommitTracker).  The acting leader, its id and term, the voter count and
// the append count are fixed for the whole horizon.
#pragma once

#include <stdint.h>

#include "fused_common.cuh"

namespace raft_damped {

using raft_fused::imax;
using raft_fused::imin;
using raft_fused::kRoleFollower;
using raft_fused::kRoleLeader;
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

// A wholesale adoption from the leader by the members flagged in
// `adopted`, the leader joining the set when anyone adopted: the pairwise
// agreement event off the leader's current row.
template <int P>
RAFT_HD void adopt_event(int32_t (&agree)[P][P], const bool (&adopted)[P],
                         const bool (&is_lead)[P], int32_t value) {
  bool any = false;
#pragma unroll
  for (int p = 0; p < P; ++p) any = any || adopted[p];
  bool in_set[P];
#pragma unroll
  for (int p = 0; p < P; ++p) in_set[p] = adopted[p] || (is_lead[p] && any);
  int32_t lead_row[P];
  raft_fused::flagged_row<P>(agree, is_lead, lead_row);
  raft_fused::agree_event<P>(agree, in_set, value, lead_row);
}

template <int P, bool WITH_CQ, bool WITH_LOSS, bool WITH_HEALTH>
RAFT_HD void damped_group(int64_t g, int64_t G, const DampedPlanes& t,
                          int32_t round_base, int rounds, int election_tick,
                          int heartbeat_tick, int64_t group_base) {
  constexpr int PL = WITH_LOSS ? P : 1;
  int32_t state[P], leader[P], hb[P], ee[P], li[P], lt[P], commit[P], mrow[P];
  bool ra[P], voter[P], member[P], alive[P], role_leader[P], is_lead[P];
  int32_t agree[P][P], loss[PL][PL];
  bool has_leader = false;
  int32_t lead_id_val = 0, count = 0;
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
    ra[p] = t.ra[i] != 0;
    voter[p] = t.voter[i] != 0;
    member[p] = t.member[i] != 0;
    alive[p] = t.crashed[i] == 0;
    role_leader[p] = state[p] == kRoleLeader;
    is_lead[p] = role_leader[p] && alive[p];
    has_leader = has_leader || is_lead[p];
    if (is_lead[p]) lead_id_val = wadd(lead_id_val, p + 1);
    if (voter[p]) count += 1;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int64_t j = ((int64_t)p * P + q) * G + g;
      agree[p][q] = t.agree[j];
      if (WITH_LOSS) loss[p % PL][q % PL] = t.loss_rate[j];
    }
  }
  const int32_t qpos = count / 2;
  const int32_t ts = t.ts[g];
  const int32_t ts_prev = wadd(ts, -1);  // a never-acked member's probe prev
  const int32_t lead_term = t.lead_term[g];
  const int32_t n_app = has_leader ? t.app[g] : 0;
  const bool sent_b = has_leader && n_app > 0;
  const uint32_t gid = (uint32_t)(group_base + g);
  raft_fused::CommitTracker<P, WITH_HEALTH> tsc(t.tsc, g, commit);

  for (int r = 0; r < rounds; ++r) {
    // --- delivery: forward (leader -> v) and reverse (v -> leader).  The
    // link plane is all-up among alive peers (the steady predicate), so
    // only the loss sample gates.
    bool fwd[P], rev[P];
    if (WITH_LOSS) {
      const uint32_t key =
          raft_fused::loss_round_key(gid, (uint32_t)round_base + (uint32_t)r);
      bool dfl[P], dtl[P];
#pragma unroll
      for (int p = 0; p < P; ++p) dfl[p] = dtl[p] = false;
#pragma unroll
      for (int s = 0; s < P; ++s) {
#pragma unroll
        for (int d = 0; d < P; ++d) {
          const bool drop =
              raft_fused::loss_drop<P>(key, s, d, loss[s % PL][d % PL]);
          if (drop && is_lead[s]) dfl[d] = true;
          if (drop && is_lead[d]) dtl[s] = true;
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        fwd[p] = !dfl[p] && alive[p] && !is_lead[p];
        rev[p] = !dtl[p] && alive[p] && !is_lead[p];
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) fwd[p] = rev[p] = alive[p] && !is_lead[p];
    }

    // --- tick, with the leader's election-timeout boundary: with check
    // quorum it clears the acting leader's row to its own bit.
    bool beat = false, lead_bnd = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ee[p] = wadd(ee[p], 1);
      const bool boundary = role_leader[p] && ee[p] >= election_tick;
      if (boundary) ee[p] = 0;
      lead_bnd = lead_bnd || (boundary && is_lead[p]);
      if (role_leader[p]) hb[p] = wadd(hb[p], 1);
      const bool want_beat = role_leader[p] && hb[p] >= heartbeat_tick;
      if (want_beat) hb[p] = 0;
      beat = beat || (want_beat && is_lead[p]);
    }
    if (WITH_CQ && lead_bnd) {
#pragma unroll
      for (int p = 0; p < P; ++p) ra[p] = is_lead[p];
    }

    // --- round-start snapshots of the leader's cursors
    int32_t c_l = 0, li_l = 0, lt_l = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (is_lead[p]) {
        c_l = wadd(c_l, commit[p]);
        li_l = wadd(li_l, li[p]);
        lt_l = wadd(lt_l, lt[p]);
      }
    }

    // --- wave 1: heartbeat delivery; wave 2a: the responses resume
    // probes and set recent_active bits; wave 3: catch-up appends under
    // the damped probe rule (a probe that does not match starts a retry
    // chain, which lands after stage A).
    bool resumed[P], adopt[P], retry3[P];
    int32_t lead_row[P];
    raft_fused::flagged_row<P>(agree, is_lead, lead_row);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool h_acc = fwd[p] && beat && member[p];
      if (h_acc) {
        state[p] = kRoleFollower;
        leader[p] = lead_id_val;
        ee[p] = 0;
        commit[p] = imax(commit[p], imin(mrow[p], c_l));
      }
      resumed[p] = h_acc && rev[p];
      ra[p] = ra[p] || resumed[p];
      const bool cu = resumed[p] && mrow[p] < li_l;
      const bool probe = lead_row[p] >= (mrow[p] == 0 ? ts_prev : li_l);
      adopt[p] = cu && probe;
      retry3[p] = cu && !probe;
      if (adopt[p]) {
        commit[p] = imax(commit[p], c_l);
        li[p] = li_l;
        lt[p] = lt_l;
      }
    }
    adopt_event<P>(agree, adopt, is_lead, li_l);

    // --- wave 4: the probe-matched acks, then the stage-A commit
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (adopt[p]) {
        mrow[p] = imax(mrow[p], li_l);
        ra[p] = true;
      }
    }
    const int32_t mci = raft_fused::quorum_index<P>(mrow, voter, qpos);
    const bool ok_a = has_leader && count > 0 && mci >= ts;
    const int32_t c_new = ok_a ? imax(c_l, mci) : c_l;
    const bool adv = c_new > c_l;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (is_lead[p]) commit[p] = c_new;
      // the wave-3 retry resends land after stage A
      if (retry3[p]) {
        commit[p] = imax(commit[p], c_l);
        li[p] = li_l;
        lt[p] = lt_l;
      }
    }
    adopt_event<P>(agree, retry3, is_lead, li_l);

    // --- wave 5: the commit-advance re-broadcast, damped probe rule
    bool retry5[P], ack5[P];
    raft_fused::flagged_row<P>(agree, is_lead, lead_row);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool rb5 = fwd[p] && member[p] && adv && (mrow[p] > 0 || resumed[p]);
      const bool probe = lead_row[p] >= (mrow[p] == 0 ? ts_prev : li_l);
      adopt[p] = rb5 && probe;
      retry5[p] = rb5 && !probe && rev[p];
      if (rb5) {
        state[p] = kRoleFollower;
        leader[p] = lead_id_val;
        ee[p] = 0;
      }
      if (adopt[p] || retry5[p]) {
        li[p] = li_l;
        lt[p] = lt_l;
      }
      ack5[p] = (adopt[p] && rev[p]) || retry3[p] || retry5[p];
    }
    adopt_event<P>(agree, adopt, is_lead, li_l);
    adopt_event<P>(agree, retry5, is_lead, li_l);

    // --- wave 6: the deferred acks, the stage-B commit and its
    // propagation to sendable members
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (ack5[p]) {
        mrow[p] = imax(mrow[p], li_l);
        ra[p] = true;
      }
    }
    const int32_t mci2 = raft_fused::quorum_index<P>(mrow, voter, qpos);
    const bool ok_b = has_leader && count > 0 && mci2 >= ts;
    const int32_t c_new2 = ok_b ? imax(c_new, mci2) : c_new;
    raft_fused::flagged_row<P>(agree, is_lead, lead_row);
    bool sync_b[P], in_set[P];
    const int32_t lead_last = wadd(li_l, n_app);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (is_lead[p]) commit[p] = c_new2;
      const bool sendable = mrow[p] > 0 || resumed[p];
      const bool elig = fwd[p] && member[p] && sendable &&
                        (lead_row[p] >= li_l || rev[p]) && c_new2 > c_l;
      if (elig) commit[p] = imax(commit[p], c_new2);
      if (elig && rev[p]) ra[p] = true;

      // --- the round's append workload at the acting leader
      if (is_lead[p]) {
        li[p] = wadd(li[p], n_app);
        if (sent_b) lt[p] = lead_term;
      }
      const bool send_w = sent_b && fwd[p] && member[p] && sendable;
      const bool probe = lead_row[p] >= (mrow[p] == 0 ? ts_prev : li_l);
      sync_b[p] = send_w && (probe || rev[p]);
      if (send_w) {
        state[p] = kRoleFollower;
        leader[p] = lead_id_val;
        ee[p] = 0;
      }
      if (sync_b[p]) {
        li[p] = lead_last;
        lt[p] = lead_term;
      }
      const bool ack_w = sync_b[p] && rev[p];
      if (ack_w || (is_lead[p] && sent_b)) mrow[p] = imax(mrow[p], lead_last);
      if (ack_w) ra[p] = true;
      in_set[p] = sync_b[p] || (is_lead[p] && sent_b);
    }
    raft_fused::agree_event<P>(agree, in_set, lead_last, lead_row);
    const int32_t mci3 = raft_fused::quorum_index<P>(mrow, voter, qpos);
    const bool ok_c = sent_b && count > 0 && mci3 >= ts;
    const int32_t lead_commit = ok_c ? imax(c_new2, mci3) : c_new2;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (is_lead[p]) commit[p] = lead_commit;
      if (sync_b[p]) commit[p] = imax(commit[p], lead_commit);
    }
    tsc.round(commit);
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = (int64_t)p * G + g;
    t.state_out[i] = state[p];
    t.leader_id_out[i] = leader[p];
    t.hb_out[i] = hb[p];
    t.ee_out[i] = ee[p];
    t.li_out[i] = li[p];
    t.lt_out[i] = lt[p];
    t.commit_out[i] = commit[p];
    t.matched_out[i] = mrow[p];
    t.ra_out[i] = ra[p] ? 1 : 0;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      t.agree_out[((int64_t)p * P + q) * G + g] = agree[p][q];
    }
  }
  tsc.store(t.tsc_out, g);
}

}  // namespace raft_damped

// Expands CASE(P, WITH_CQ, WITH_LOSS, WITH_HEALTH) for every instantiated
// combination.
#define RAFT_DAMPED_FOR_EACH_FLAG(CASE, NP)                          \
  CASE(NP, false, false, false) CASE(NP, true, false, false)         \
  CASE(NP, false, true, false) CASE(NP, true, true, false)           \
  CASE(NP, false, false, true) CASE(NP, true, false, true)           \
  CASE(NP, false, true, true) CASE(NP, true, true, true)
