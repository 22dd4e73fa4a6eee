// Per-group body of k fused loss-gated steady rounds: the arithmetic of
// raft_tpu/multiraft/pallas_step.py:_steady_chaos_kernel, both
// variants, written once for both the CUDA grid wrapper
// (chaos_round.cu) and the host shim the CPU tests build with g++
// (chaos_host.cpp).  The plain PyTorch version is
// chaos_kernel.chaos_rounds_reference; this body computes the same
// function on any planes, so sums over several (or no) leaders follow
// its int32 sums.
//
// Layout: every [P, G] plane is peer-major (group g's column is
// plane[p * G + g]) and every [P, P, G] plane pair-major
// (plane[(a * P + b) * G + g]).  One call handles one group: it loads the
// group's P-column of every plane and its [P, P] agree and loss_rate
// blocks into fully unrolled arrays, runs `rounds` rounds on registers,
// and stores the outputs.  The acting leader, its id and term, the voter
// count and the append count are fixed for the whole horizon: the rounds
// never change who leads.
//
// The loss draw keys on (round_base + r, src, dst, gid) with gid the
// group's global index (group_base + g: a shard of a mesh run keys its
// groups by their ids in the whole batch), in native uint32, bit for bit
// the reference's link_loss_draw.  WITH_HEALTH (the with_health variant) tracks
// ticks_since_commit from tsc into tsc_out (fused_common.cuh's
// CommitTracker).
#pragma once

#include <stdint.h>

#include "fused_common.cuh"

namespace raft_chaos {

using raft_fused::imax;
using raft_fused::imin;
using raft_fused::kRoleFollower;
using raft_fused::kRoleLeader;
using raft_fused::wadd;

// Operand and output pointers of one call.  [P, G] planes: state,
// leader_id, hb, ee, li, lt, commit and the acting leader's matched row
// (int32), voter, member and crashed (one byte each, nonzero = true);
// [P, P, G]: agree and loss_rate (int32); [G]: the acting leader's
// term_start, its term and the append count (int32); with health,
// ticks_since_commit in and out ([G] int32; null otherwise).
struct ChaosPlanes {
  const int32_t* state;
  const int32_t* leader_id;
  const int32_t* hb;
  const int32_t* ee;
  const int32_t* li;
  const int32_t* lt;
  const int32_t* commit;
  const int32_t* matched;
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
  int32_t* agree_out;
  const int32_t* tsc;
  int32_t* tsc_out;
};

template <int P, bool WITH_HEALTH>
RAFT_HD void chaos_group(int64_t g, int64_t G, const ChaosPlanes& t,
                         int32_t round_base, int rounds, int election_tick,
                         int heartbeat_tick, int64_t group_base) {
  int32_t state[P], leader[P], hb[P], ee[P], li[P], lt[P], commit[P], mrow[P];
  bool voter[P], member[P], alive[P], role_leader[P], is_lead[P];
  int32_t agree[P][P], loss[P][P];
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
      loss[p][q] = t.loss_rate[j];
    }
  }
  const int32_t qpos = count / 2;
  const int32_t ts = t.ts[g];
  const int32_t lead_term = t.lead_term[g];
  const int32_t n_app = has_leader ? t.app[g] : 0;
  const bool sent_b = has_leader && n_app > 0;
  const uint32_t gid = (uint32_t)(group_base + g);
  raft_fused::CommitTracker<P, WITH_HEALTH> tsc(t.tsc, g, commit);

  for (int r = 0; r < rounds; ++r) {
    // --- per-link loss: forward (leader -> v) and reverse (v -> leader)
    // delivery for this round.  The link plane is all-up among alive
    // peers (the steady predicate), so only the loss sample gates.
    const uint32_t key =
        raft_fused::loss_round_key(gid, (uint32_t)round_base + (uint32_t)r);
    bool dfl[P], dtl[P];
#pragma unroll
    for (int p = 0; p < P; ++p) dfl[p] = dtl[p] = false;
#pragma unroll
    for (int s = 0; s < P; ++s) {
#pragma unroll
      for (int d = 0; d < P; ++d) {
        const bool drop = raft_fused::loss_drop<P>(key, s, d, loss[s][d]);
        if (drop && is_lead[s]) dfl[d] = true;
        if (drop && is_lead[d]) dtl[s] = true;
      }
    }
    bool fwd[P], rev[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      fwd[p] = !dfl[p] && alive[p] && !is_lead[p];
      rev[p] = !dtl[p] && alive[p] && !is_lead[p];
    }

    // --- tick (as the plain steady kernel)
    bool beat = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ee[p] = wadd(ee[p], 1);
      if (role_leader[p] && ee[p] >= election_tick) ee[p] = 0;
      if (role_leader[p]) hb[p] = wadd(hb[p], 1);
      const bool want_beat = role_leader[p] && hb[p] >= heartbeat_tick;
      if (want_beat) hb[p] = 0;
      beat = beat || (want_beat && is_lead[p]);
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

    // --- wave 1: heartbeat delivery and the reverse-link response;
    // pass 1: heartbeat-triggered catch-up appends for lagging members.
    bool resumed[P], in_set[P];
    bool sent1 = false;
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
      const bool cu = resumed[p] && mrow[p] < li_l;
      if (cu) {
        commit[p] = imax(commit[p], c_l);
        mrow[p] = imax(mrow[p], li_l);
        li[p] = li_l;
        lt[p] = lt_l;
      }
      in_set[p] = cu;
      sent1 = sent1 || cu;
    }
    int32_t lead_row[P];
    raft_fused::flagged_row<P>(agree, is_lead, lead_row);
#pragma unroll
    for (int p = 0; p < P; ++p) in_set[p] = in_set[p] || (is_lead[p] && sent1);
    raft_fused::agree_event<P>(agree, in_set, li_l, lead_row);

    // --- stage-A quorum commit at the leader off the fresh acks
    const int32_t mci = raft_fused::quorum_index<P>(mrow, voter, qpos);
    const bool ok_a = has_leader && count > 0 && mci >= ts;
    const int32_t c_new = ok_a ? imax(c_l, mci) : c_l;
    const bool adv = c_new > c_l;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (is_lead[p]) commit[p] = c_new;
    }

    // --- pass 2: a commit advance re-broadcasts to sendable members
    raft_fused::flagged_row<P>(agree, is_lead, lead_row);
    bool any2 = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool sendable = mrow[p] > 0 || resumed[p];
      const bool msg2 = fwd[p] && member[p] && adv && sendable;
      const bool adopt2 = msg2 && (lead_row[p] >= li_l || rev[p]);
      if (msg2) {
        state[p] = kRoleFollower;
        leader[p] = lead_id_val;
        ee[p] = 0;
      }
      if (adopt2) {
        li[p] = li_l;
        lt[p] = lt_l;
        if (rev[p]) mrow[p] = imax(mrow[p], li_l);
      }
      in_set[p] = adopt2;
      any2 = any2 || adopt2;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) in_set[p] = in_set[p] || (is_lead[p] && any2);
    raft_fused::agree_event<P>(agree, in_set, li_l, lead_row);

    // --- stage-B commit and the post-advance commit propagation
    const int32_t mci2 = raft_fused::quorum_index<P>(mrow, voter, qpos);
    const bool ok_b = has_leader && count > 0 && mci2 >= ts;
    const int32_t c_new2 = ok_b ? imax(c_new, mci2) : c_new;
    raft_fused::flagged_row<P>(agree, is_lead, lead_row);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (is_lead[p]) commit[p] = c_new2;
      const bool elig = fwd[p] && member[p] && (mrow[p] > 0 || resumed[p]) &&
                        (lead_row[p] >= li_l || rev[p]) && c_new2 > c_l;
      if (elig) commit[p] = imax(commit[p], c_new2);
    }

    // --- the round's append workload at the leader
    const int32_t lead_last = wadd(li_l, n_app);
    bool sync_b[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (is_lead[p]) {
        li[p] = wadd(li[p], n_app);
        if (sent_b) lt[p] = lead_term;
      }
      const bool pr_ok = mrow[p] > 0 || resumed[p];
      const bool sync_msg = sent_b && fwd[p] && member[p] && !is_lead[p] && pr_ok;
      sync_b[p] = sync_msg && (lead_row[p] >= li_l || rev[p]);
      if (sync_msg) {
        state[p] = kRoleFollower;
        leader[p] = lead_id_val;
        ee[p] = 0;
      }
      if (sync_b[p]) {
        li[p] = lead_last;
        lt[p] = lead_term;
      }
      if ((sync_b[p] && rev[p]) || (is_lead[p] && sent_b)) {
        mrow[p] = imax(mrow[p], lead_last);
      }
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
#pragma unroll
    for (int q = 0; q < P; ++q) {
      t.agree_out[((int64_t)p * P + q) * G + g] = agree[p][q];
    }
  }
  tsc.store(t.tsc_out, g);
}

}  // namespace raft_chaos
