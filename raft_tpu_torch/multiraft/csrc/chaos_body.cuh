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
// group's P-column of every plane into unrolled per-peer arrays and its
// per-peer flags into bit masks (registers on the card), copies its
// [P, P] agree block into `blk`, runs `rounds` rounds and stores the
// outputs.  The block's storage is the Block template parameter
// (fused_common.cuh): ArrayBlock, a plain array (the g++ build, and the
// CUDA build where the card ran it faster, in registers), or StridedBlock,
// the thread's column of a shared-memory block (chaos_round.cu's
// ChaosShape picks it by P).  The acting leaders (alive peers in the
// leader role), their id and term, the voter count and the append count
// are fixed for the whole horizon: the rounds never change who leads.
//
// The loss draw keys on (round_base + r, src, dst, gid) with gid the
// group's global index (group_base + g: a shard of a mesh run keys its
// groups by their ids in the whole batch), in native uint32, bit for bit
// the reference's link_loss_draw.  WITH_HEALTH (the with_health variant)
// tracks ticks_since_commit from tsc into tsc_out (fused_common.cuh's
// CommitTracker).
//
// Three facts of that horizon keep the work to what the outputs need:
// - Every non-empty agreement event holds all acting leaders.  Event 1's
//   set is the catch-up set plus the leaders once anyone caught up, event
//   2's the pass-2 adopters plus the leaders once anyone adopted, and
//   event 3's the synced members plus the leaders when the round appends
//   (sent_b); a member syncs only when sent_b holds, and sent_b implies an
//   acting leader, so that set too is empty or holds them all.  After an
//   event with set S and value v every leader's row is the same row,
//   R[b] = (b in S ? v : the leaders' old summed row at b), so their new
//   sum is n_lead * R[b] in wrapping int32.  The body carries that sum in
//   registers from the load on (the reference reads it back from the
//   block before each event and before the stage-B and workload checks),
//   skips an empty event, and only writes the block in the rounds; the
//   block is read once, to store it.
// - Only the links with an acting leader at one end reach the delivery
//   masks: fwd and rev exclude the leaders, and the reference's dfl[v]
//   and dtl[v] are ORs over the leaders s of drop(s, v) and drop(v, s).
//   So the body draws only those (fused_common.cuh's LeaderLinks): with
//   one acting leader L (every group of a fused block), the 2(P - 1) links
//   of L's row and column, their rates loaded once before the rounds and
//   held; with several, each leader's row and column in turn, the rates
//   read from the plane; with none, nothing.  A draw is a pure function of
//   (round, src, dst, gid, rate), so these are the reference's bits, and
//   the loss_rate block is never held.
// - Every per-peer flag (voter, member, alive, the leader role, the acting
//   leaders, each round's delivery masks and wave sets) is a uint32 bit
//   mask, bit p for peer p, so a set operation on all peers is one
//   instruction and a flag holds no register of its own.
#pragma once

#include <stdint.h>

#include "fused_common.cuh"

namespace raft_chaos {

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

template <int P, bool WITH_HEALTH, class Block>
RAFT_HD void chaos_group(int64_t g, int64_t G, const ChaosPlanes& t,
                         int32_t round_base, int rounds, int election_tick,
                         int heartbeat_tick, int64_t group_base, Block& blk) {
  int32_t state[P], leader[P], hb[P], ee[P], li[P], lt[P], commit[P], mrow[P];
  uint32_t voter = 0, member = 0, alive = 0, role = 0;
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
  // The block, and the leaders' summed row of it (the reference's
  // lead_row(agree)).
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
  const raft_fused::LeaderLinks<P, true> links(t.loss_rate, g, G, n_lead, lone);
  const int32_t qpos = count / 2;
  const int32_t ts = t.ts[g];
  const int32_t lead_term = t.lead_term[g];
  const int32_t n_app = has_leader ? t.app[g] : 0;
  const bool sent_b = has_leader && n_app > 0;
  const uint32_t gid = (uint32_t)(group_base + g);
  const uint32_t up = alive & ~lead;  // alive peers other than the leaders
  raft_fused::CommitTracker<P, WITH_HEALTH> tsc(t.tsc, g, commit);

  for (int r = 0; r < rounds; ++r) {
    // --- per-link loss: forward (leader -> v) and reverse (v -> leader)
    // delivery for this round.  The link plane is all-up among alive
    // peers (the steady predicate), so only the loss sample gates, and
    // only on the leaders' links.
    const uint32_t key =
        raft_fused::loss_round_key(gid, (uint32_t)round_base + (uint32_t)r);
    uint32_t dfl, dtl;  // leader -> p dropped, p -> leader dropped
    links.draw(t.loss_rate, g, G, key, lead, dfl, dtl);
    const uint32_t fwd = up & ~dfl, rev = up & ~dtl;

    // --- tick (as the plain steady kernel)
    bool beat = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ee[p] = wadd(ee[p], 1);
      if (bit(role, p) && ee[p] >= election_tick) ee[p] = 0;
      if (bit(role, p)) hb[p] = wadd(hb[p], 1);
      const bool want_beat = bit(role, p) && hb[p] >= heartbeat_tick;
      if (want_beat) hb[p] = 0;
      beat = beat || (want_beat && bit(lead, p));
    }

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

    // --- wave 1: heartbeat delivery and the reverse-link response;
    // pass 1: heartbeat-triggered catch-up appends for lagging members.
    const uint32_t h_acc = beat ? fwd & member : 0u;
    const uint32_t resumed = h_acc & rev;
    uint32_t cu = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(h_acc, p)) {
        state[p] = kRoleFollower;
        leader[p] = lead_id_val;
        ee[p] = 0;
        commit[p] = imax(commit[p], imin(mrow[p], c_l));
      }
      const bool c = bit(resumed, p) && mrow[p] < li_l;
      if (c) {
        commit[p] = imax(commit[p], c_l);
        mrow[p] = imax(mrow[p], li_l);
        li[p] = li_l;
        lt[p] = lt_l;
      }
      cu |= flag(c, p);
    }
    adopt_event<P>(blk, cu, lead, li_l, lead_row, n_lead);

    // --- stage-A quorum commit at the leader off the fresh acks
    const int32_t mci = quorum_of<P>(mrow, voter, qpos);
    const bool ok_a = has_leader && count > 0 && mci >= ts;
    const int32_t c_new = ok_a ? imax(c_l, mci) : c_l;
    const bool adv = c_new > c_l;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(lead, p)) commit[p] = c_new;
    }

    // --- pass 2: a commit advance re-broadcasts to sendable members
    uint32_t adopt2 = 0;
    if (adv) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bool sendable = mrow[p] > 0 || bit(resumed, p);
        const bool msg2 = bit(fwd & member, p) && sendable;
        const bool a2 = msg2 && (lead_row[p] >= li_l || bit(rev, p));
        if (msg2) {
          state[p] = kRoleFollower;
          leader[p] = lead_id_val;
          ee[p] = 0;
        }
        if (a2) {
          li[p] = li_l;
          lt[p] = lt_l;
          if (bit(rev, p)) mrow[p] = imax(mrow[p], li_l);
        }
        adopt2 |= flag(a2, p);
      }
    }
    adopt_event<P>(blk, adopt2, lead, li_l, lead_row, n_lead);

    // --- stage-B commit and the post-advance commit propagation, then
    // the round's append workload at the leader
    const int32_t mci2 = quorum_of<P>(mrow, voter, qpos);
    const bool ok_b = has_leader && count > 0 && mci2 >= ts;
    const int32_t c_new2 = ok_b ? imax(c_new, mci2) : c_new;
    const int32_t lead_last = wadd(li_l, n_app);
    uint32_t sync_b = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (bit(lead, p)) commit[p] = c_new2;
      const bool sendable = mrow[p] > 0 || bit(resumed, p);
      const bool ahead = lead_row[p] >= li_l || bit(rev, p);
      const bool elig = bit(fwd & member, p) && sendable && ahead && c_new2 > c_l;
      if (elig) commit[p] = imax(commit[p], c_new2);

      if (bit(lead, p)) {
        li[p] = wadd(li[p], n_app);
        if (sent_b) lt[p] = lead_term;
      }
      const bool sync_msg = sent_b && bit(fwd & member, p) && sendable;
      const bool sync = sync_msg && ahead;
      if (sync_msg) {
        state[p] = kRoleFollower;
        leader[p] = lead_id_val;
        ee[p] = 0;
      }
      if (sync) {
        li[p] = lead_last;
        lt[p] = lead_term;
      }
      if ((sync && bit(rev, p)) || (bit(lead, p) && sent_b)) {
        mrow[p] = imax(mrow[p], lead_last);
      }
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
#pragma unroll
    for (int q = 0; q < P; ++q) {
      t.agree_out[((int64_t)p * P + q) * Gs + gs] = blk.get(p, q);
    }
  }
  tsc.store(t.tsc_out, gs);
}

}  // namespace raft_chaos
