// Helpers shared by the fused kernel bodies (steady_body.cuh,
// chaos_body.cuh, damped_body.cuh): the __host__ __device__ marker,
// wrapping int32 arithmetic, the majority index by odd-even
// transposition, the per-link loss draw and the with_health variants'
// commit tracker; and the pieces of the chaos and damped bodies' shared
// design: per-peer bit masks, the [P, P] agree block's two storages, the
// pairwise agreement event on the leaders' carried row and the draws on
// the leaders' links.  Written once so the kernels that use them cannot
// drift apart; each function works on one group's values held in fully
// unrolled arrays, P a template parameter.
//
// Counterparts in raft_tpu/multiraft/pallas_step.py: _quorum_tile (:278),
// _kernel_loss_draw (:243) and _agree_event (:259).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define RAFT_HD __host__ __device__ __forceinline__
#else
#define RAFT_HD inline
#endif

namespace raft_fused {

constexpr int32_t kRoleFollower = 0;
constexpr int32_t kRoleLeader = 2;
constexpr uint32_t kLossScale = 10000;  // loss rates are per ten thousand

// int32 addition that wraps modulo 2**32, like PyTorch's int32 arithmetic
// (done in uint32, then reinterpreted).
RAFT_HD int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

RAFT_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
RAFT_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

// Majority index of one group's matched row over its voter slots: the
// descending odd-even transposition network over the P slots, then the
// value at position qpos (the voter count // 2).  Non-voters count as 0.
template <int P>
RAFT_HD int32_t quorum_index(const int32_t (&matched)[P],
                             const bool (&voter)[P], int32_t qpos) {
  int32_t rows[P];
#pragma unroll
  for (int p = 0; p < P; ++p) rows[p] = voter[p] ? matched[p] : 0;
#pragma unroll
  for (int pass = 0; pass < P; ++pass) {
#pragma unroll
    for (int i = pass % 2; i < P - 1; i += 2) {
      const int32_t hi = imax(rows[i], rows[i + 1]);
      const int32_t lo = imin(rows[i], rows[i + 1]);
      rows[i] = hi;
      rows[i + 1] = lo;
    }
  }
  int32_t mci = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (qpos == p) mci = rows[p];
  }
  return mci;
}

// 32-bit murmur3 finalizer, in native uint32 (wraps as the reference's
// uint32 arithmetic does).
RAFT_HD uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The per-round key of group `gid`: mix32(gid * 0x9E3779B1 + round).
RAFT_HD uint32_t loss_round_key(uint32_t gid, uint32_t round) {
  return mix32(gid * 0x9E3779B1u + round);
}

// True where the directed link src -> dst drops every message this round:
// the (round, src, dst, group) counter PRNG of kernels.link_loss_draw.
template <int P>
RAFT_HD bool loss_drop(uint32_t round_key, int src, int dst, int32_t rate) {
  const uint32_t lane = (uint32_t)(src * P + dst + 1);
  const uint32_t x = mix32(round_key ^ (lane * 0x85EBCA6Bu));
  return (int32_t)(x % kLossScale) < rate;
}

// ticks_since_commit, the one health plane a steady round moves (the
// with_health variants; pallas_step.py:150-152, :224-231, :239-240 and
// their chaos and damped twins).  Before round 1 the previous max commit
// is the max over all P rows, crashed rows included; after each round's
// last commit write, tsc = (the max grew) ? 0 : tsc + 1.  The
// WITH_HEALTH = false tracker holds nothing and compiles away, so the
// with_health=False kernels stay the code they were.
template <int P, bool WITH_HEALTH>
struct CommitTracker {
  RAFT_HD CommitTracker(const int32_t*, int64_t, const int32_t (&)[P]) {}
  RAFT_HD void round(const int32_t (&)[P]) {}
  RAFT_HD void store(int32_t*, int64_t) const {}
};

template <int P>
RAFT_HD int32_t max_of(const int32_t (&v)[P]) {
  int32_t m = v[0];
#pragma unroll
  for (int p = 1; p < P; ++p) m = imax(m, v[p]);
  return m;
}

template <int P>
struct CommitTracker<P, true> {
  int32_t tsc;
  int32_t maxc_prev;
  RAFT_HD CommitTracker(const int32_t* tsc_in, int64_t g,
                        const int32_t (&commit)[P])
      : tsc(tsc_in[g]), maxc_prev(max_of<P>(commit)) {}
  RAFT_HD void round(const int32_t (&commit)[P]) {
    const int32_t maxc = max_of<P>(commit);
    tsc = maxc > maxc_prev ? 0 : wadd(tsc, 1);
    maxc_prev = maxc;
  }
  RAFT_HD void store(int32_t* tsc_out, int64_t g) const { tsc_out[g] = tsc; }
};

// --- the chaos and damped bodies' shared design --------------------------

// Bit p of a per-peer mask: the chaos and damped bodies keep every per-peer
// flag (voter, member, alive, the leader role, acting leader, and each
// round's delivery and wave sets) as one uint32 a group, bit p for peer p,
// so a set operation on all peers is one instruction and a flag costs no
// register of its own.
RAFT_HD bool bit(uint32_t mask, int p) { return ((mask >> p) & 1u) != 0; }

RAFT_HD uint32_t flag(bool on, int p) { return (uint32_t)on << p; }

// v, hidden from the CUDA compiler's optimiser: an address computed from
// it is computed where it is used.  The bodies' stores and their rare
// several-leader draws index the planes through it, so that the 64-bit
// offsets of the loads are not kept live in registers through every round.
// Without it ptxas spills 24 B at P = 8 and up to 2.4 KB at P = 15 in the
// damped kernel (the card's readings are in PERF.md, section 6).
RAFT_HD int64_t opaque(int64_t v) {
#if defined(__CUDA_ARCH__)
  asm volatile("" : "+l"(v));
#endif
  return v;
}

// One group's [P, P] agree block as a plain array: registers on the card,
// since the bodies index it only with compile-time constants.
template <int P>
struct ArrayBlock {
  int32_t v[P][P];
  RAFT_HD void set(int a, int b, int32_t x) { v[a][b] = x; }
  RAFT_HD int32_t get(int a, int b) const { return v[a][b]; }
};

// One group's [P, P] agree block as a column of a block of S such columns,
// pair (a, b) at base[(a * P + b) * S]: with `base` a thread's word of a
// shared-memory block of S threads, a warp's accesses to one pair fall on
// 32 consecutive words, one a bank.  Every index the bodies pass is a
// compile-time constant, so each access is one instruction at a fixed
// offset.
template <int P, int S>
struct StridedBlock {
  int32_t* base;
  RAFT_HD void set(int a, int b, int32_t x) { base[(a * P + b) * S] = x; }
  RAFT_HD int32_t get(int a, int b) const { return base[(a * P + b) * S]; }
};

// One wholesale-adoption agreement event (the reference's _agree_event) on
// `blk`: pairs inside the set `in` agree to `value`; a pair with one side
// inside inherits the sender's row at the other side; the rest keep their
// value.  The sender's row is `lead_row`, the sum of the n_lead acting
// leaders' rows, which the event then brings up to date: after it every
// member of the set, so every acting leader, holds the same row, and their
// sum is n_lead times it (wrapping, as the reference's int32 sum does).
// Needs every acting leader in the set when any peer is; an empty set
// changes nothing.
template <int P, class Block>
RAFT_HD void block_event(Block& blk, uint32_t in, int32_t value,
                         int32_t (&lead_row)[P], uint32_t n_lead) {
  if (in == 0) return;
  // The row every member of the set, so every acting leader, now holds.
  int32_t row[P];
#pragma unroll
  for (int b = 0; b < P; ++b) row[b] = bit(in, b) ? value : lead_row[b];
#pragma unroll
  for (int a = 0; a < P; ++a) {
#pragma unroll
    for (int b = 0; b < P; ++b) {
      if (bit(in, a)) {
        blk.set(a, b, row[b]);
      } else if (bit(in, b)) {
        blk.set(a, b, lead_row[a]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < P; ++b) lead_row[b] = (int32_t)(n_lead * (uint32_t)row[b]);
}

// A wholesale adoption from the leader by the members in `adopted`, the
// acting leaders `lead` joining the set when anyone adopted.
template <int P, class Block>
RAFT_HD void adopt_event(Block& blk, uint32_t adopted, uint32_t lead,
                         int32_t value, int32_t (&lead_row)[P],
                         uint32_t n_lead) {
  block_event<P>(blk, adopted != 0 ? adopted | lead : 0u, value, lead_row,
                 n_lead);
}

// The voters' majority index of `mrow` (quorum_index above), the voters a
// bit mask.
template <int P>
RAFT_HD int32_t quorum_of(const int32_t (&mrow)[P], uint32_t voter,
                          int32_t qpos) {
  bool v[P];
#pragma unroll
  for (int p = 0; p < P; ++p) v[p] = bit(voter, p);
  return quorum_index<P>(mrow, v, qpos);
}

// The per-link loss draws that reach a steady round's delivery masks:
// those of the links with an acting leader at one end (the forward link
// leader -> v and the reverse link v -> leader).  With one acting leader
// `lone` (every group of a fused block) the rates of its 2(P - 1) links,
// the o-th other peer being o + (o >= lone), are loaded once, at
// construction, and held (in registers on the card); with several, each
// leader's row and column are read from the plane in turn, through
// opaque() offsets; with none nothing is drawn.  A draw is a pure function
// of (round, src, dst, gid, rate), so these are the reference's bits.
// ON = false (the damped body without loss) holds and draws nothing.
template <int P, bool ON>
struct LeaderLinks {
  RAFT_HD LeaderLinks(const int32_t*, int64_t, int64_t, uint32_t, int) {}
};

template <int P>
struct LeaderLinks<P, true> {
  static constexpr int PO = P > 1 ? P - 1 : 1;  // at least one slot
  int32_t rate_out[PO], rate_in[PO];
  uint32_t n_lead;
  int lone;

  RAFT_HD LeaderLinks(const int32_t* loss_rate, int64_t g, int64_t G,
                      uint32_t n, int slot)
      : n_lead(n), lone(slot) {
    if (n_lead == 1) {
#pragma unroll
      for (int o = 0; o < P - 1; ++o) {
        const int p = o + (o >= lone ? 1 : 0);
        rate_out[o] = loss_rate[((int64_t)lone * P + p) * G + g];
        rate_in[o] = loss_rate[((int64_t)p * P + lone) * G + g];
      }
    }
  }

  // This round's drops, round key `key`: bit p of `dfl` where a leader's
  // link to p drops, of `dtl` where p's link to a leader drops.  A leader's
  // own bits are set or not as the reference's OR gives them; the delivery
  // masks clear them anyway.
  RAFT_HD void draw(const int32_t* loss_rate, int64_t g, int64_t G,
                    uint32_t key, uint32_t lead, uint32_t& dfl,
                    uint32_t& dtl) const {
    dfl = 0;
    dtl = 0;
    if (n_lead == 1) {
#pragma unroll
      for (int o = 0; o < P - 1; ++o) {
        const int p = o + (o >= lone ? 1 : 0);
        dfl |= flag(loss_drop<P>(key, lone, p, rate_out[o]), p);
        dtl |= flag(loss_drop<P>(key, p, lone, rate_in[o]), p);
      }
    } else {
#pragma unroll 1
      for (int s = 0; s < P; ++s) {
        if (!bit(lead, s)) continue;
        const int64_t gs = opaque(g), Gs = opaque(G);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int32_t r_out = loss_rate[((int64_t)s * P + p) * Gs + gs];
          const int32_t r_in = loss_rate[((int64_t)p * P + s) * Gs + gs];
          dfl |= flag(loss_drop<P>(key, s, p, r_out), p);
          dtl |= flag(loss_drop<P>(key, p, s, r_in), p);
        }
      }
    }
  }
};

}  // namespace raft_fused

// Expands CASE(P) for the narrow instances, P = 1 through 7 (*_round.cu,
// *_host.cpp).
#define RAFT_FOR_EACH_P(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)

// Expands CASE(P) for the wide instances, P = 8 through 15, of the chaos
// and damped host builds (*_host_wide.cpp, one library beside the narrow
// one; the steady host build's wide list stops at its switch).  The CUDA
// builds take one wide P a library (*_round_wide.cu): the chaos and damped
// bodies' instances are slow to compile there, so each P builds in
// parallel, and only for the peer counts a caller uses.
#define RAFT_FOR_EACH_WIDE_P(CASE) \
  CASE(8) CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15)

// The instance list a translation unit builds: the narrow one unless the
// file defines RAFT_PEER_LIST before its first include.
#ifndef RAFT_PEER_LIST
#define RAFT_PEER_LIST RAFT_FOR_EACH_P
#endif

// Expands CASE(NP, WITH_HEALTH) for both variants of peer count NP.
#define RAFT_FOR_EACH_HEALTH(CASE, NP) CASE(NP, false) CASE(NP, true)
