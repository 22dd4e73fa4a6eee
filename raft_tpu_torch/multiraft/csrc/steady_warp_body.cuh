// The steady kernel's body for wide groups: one group across a warp's
// lanes (half a warp's up to kHalfWarpPeers), for P from the switch
// (_build.STEADY_WARP_PEERS) up.  The
// same arithmetic as raft_tpu/multiraft/pallas_step.py:_steady_kernel
// (both variants) and as steady_body.cuh, which serves the narrower groups
// one thread a group; written once for the CUDA wrapper
// (steady_round_warp.cu) and the host shim the CPU tests build with g++
// (steady_host_wide.cpp).
//
// Lane l holds peers l, l + 32, ..., J = ceil(P / 32) slots a lane.  For
// J <= kMaxRegJ (P <= 128) J is a template parameter and a lane's slots
// live in registers (RegColumn); past that one runtime-J instance works on
// the block's shared-memory tile in place (TileColumn).  Up to P =
// kHalfWarpPeers a group takes half a warp (16 lanes, one slot each), so a
// warp runs two groups; each collective then names its half's lanes.
//
// Loads and stores go through a shared-memory tile: a block takes W
// consecutive groups (8 whole-warp or 16 half-warp groups in 256 threads),
// and its threads copy each [P, G] plane's [P, W] window into the tile and
// back row by row, W neighbouring words a row, so the card reads and
// writes whole sectors (a warp reading one
// group's column straight from the plane would touch 32 sectors for 4
// useful bytes each).  The tile keeps, per (peer, group), the seven int32
// fields a round reads or writes and one byte of flags; its rows are W | 1
// words apart, an odd stride, so a warp's accesses to one column fall on
// 32 distinct banks.
//
// Per round the warp's reductions are collectives (the Lanes policy:
// __any_sync, __reduce_add_sync, __reduce_min/max_sync on the card; a
// serial loop over the group's emulated lanes in the host shim, which runs
// the same per-lane code lane by lane), and most of the reference's per-round
// reductions are closed forms over values that the steady invariant holds
// still for the whole call:
//   - the acting leaders (is_leader), the members that sync (alive members
//     that are not leaders) and so the set of slots a sent round writes are
//     fixed for the call;
//   - a leader's last index after round r's append is li0 + (r + 1) *
//     n_app, so the sum of the leaders' last indexes (lead_last) grows by
//     n_lead * n_app a round, and the sum of their last terms (lead_lt) is
//     the sum of their terms, constant;
//   - after a sent round every leader's commit is lead_commit, so the next
//     round's sum of the leaders' commits is n_lead * lead_commit;
//   - with_health: a sent round's max commit over all rows is the max of
//     lead_commit and the rows it does not write (fixed for the call), and
//     a round that sends nothing changes no commit.
// All of it wraps modulo 2**32 as the reference's int32 sums do (uint32
// arithmetic is a ring, so the closed forms equal the round-by-round sums).
//
// The majority index is a selection, not the reference's odd-even network:
// the value at position qpos of the voters' masked matched values sorted
// descending (non-voters count as 0), which is unique, so any exact
// selection equals the network on every input, ties and negative values
// included.  It is needed only in a sent round.  With one acting leader
// (every group of a fused block, by the predicate) a sent round's masked
// values are a multiset fixed for the call (the slots the round does not
// write, and the non-voters among those it does) plus m copies of
// lead_last (the voters it writes: the syncing members and the leader, whose
// last index is lead_last); two order statistics of the fixed part,
// selected once a call, give the answer of every round in closed form
// (merged_select); on an H100 a selection each sent round instead ran
// 16-29 % longer on settled planes, 1.5-1.9x with a follower down (PERF.md,
// section 6).  With several acting leaders each sent round selects afresh;
// with none no round sends.  The selection (select_desc) is a
// radix search on the values biased by 0x80000000 (signed order as
// unsigned order): the common prefix of the least and largest value, then
// one count (a warp sum) a remaining bit.
//
// What bounds it on an H100: the integer ALU.  With the closed forms a
// settled round is the per-peer updates (tick, append, sync, commit) and
// one vote, about 15 operations a peer (steady_kernel.steady_wide_body_work
// counts them off this source); the bytes, each plane read and written
// once, take about half that time at P = 65.  So the design keeps every
// per-peer value in registers for all the rounds and issues nothing per
// round that the steady invariant fixes.  What the card spends beyond that
// count (a lane's slots past P, the per-group work every lane repeats) is
// in PERF.md, section 7.
#pragma once

#include <stdint.h>

#include "fused_common.cuh"

namespace raft_steady_warp {

using raft_fused::imax;
using raft_fused::imin;
using raft_fused::kRoleLeader;
using raft_fused::wadd;

constexpr int kLanes = 32;
// The largest J whose per-lane slots live in registers.
constexpr int kMaxRegJ = 4;
// Warps a block when the tile fits.
constexpr int kWarps = 8;
// The widest group that takes half a warp (0: every group a whole warp).
constexpr int kHalfWarpPeers = 16;
// The shared memory a block may opt into on sm_90 (227 KB).
constexpr int kSmemLimit = 232448;

// The int32 fields of a tile slot, in tile order; the first six after
// kTerm are the kernel's outputs, in the order it writes them.
enum Field { kTerm, kEe, kHb, kLi, kLt, kMatched, kCommit, kFields };
constexpr int kSlotBytes = kFields * 4 + 1;  // and one byte of flags

// Flag bits of a slot.
constexpr uint32_t kValid = 1;       // a peer (not a lane's slot past P)
constexpr uint32_t kRoleLead = 2;    // in the leader role (timers tick so)
constexpr uint32_t kLeader = 4;      // an acting leader: alive, leader role
constexpr uint32_t kVoter = 8;
constexpr uint32_t kAliveMember = 16;

RAFT_HD int tile_stride(int warps) { return warps | 1; }

RAFT_HD int64_t tile_bytes(int P, int warps) {
  return (int64_t)P * tile_stride(warps) * kSlotBytes;
}

// Lanes a group at peer count P: half a warp up to kHalfWarpPeers.
RAFT_HD int group_lanes(int P) { return P <= kHalfWarpPeers ? kLanes / 2 : kLanes; }

// Groups a block at peer count P: kWarps warps' worth while their tile
// fits, else the most that fit; 0 where not even one group's tile fits.
RAFT_HD int block_groups(int P) {
  for (int w = kWarps * kLanes / group_lanes(P); w > 0; --w) {
    if (tile_bytes(P, w) <= kSmemLimit) return w;
  }
  return 0;
}

// Slots a lane at peer count P.
RAFT_HD int lane_slots(int P) { return (P + group_lanes(P) - 1) / group_lanes(P); }

// One block's tile over `warps` consecutive groups: int32 fields
// [kFields][P][stride], then flag bytes [P][stride].
struct Tile {
  int32_t* ints;
  uint8_t* flags;
  int P, stride;

  RAFT_HD Tile(void* base, int n_peers, int warps)
      : ints((int32_t*)base),
        flags((uint8_t*)base + (int64_t)kFields * n_peers *
                                   tile_stride(warps) * 4),
        P(n_peers), stride(tile_stride(warps)) {}
  RAFT_HD int32_t& at(int f, int p, int w) const {
    return ints[((int64_t)f * P + p) * stride + w];
  }
  RAFT_HD uint8_t& flag(int p, int w) const { return flags[p * stride + w]; }
};

struct Inputs {
  const int32_t *state, *term, *ee, *hb, *li, *lt, *matched, *commit;
  const uint8_t *voter, *member, *crashed;
  const int32_t *ts, *app, *tsc;
};

struct Outputs {
  int32_t *ee, *hb, *li, *lt, *matched, *commit, *tsc;
};

// Copies the [P, warps] window of groups g0.. into the tile: element i of
// the window (peer i / warps, group g0 + i % warps) for i = first, first +
// step, ... (a block's threads on the card, one loop on the host).
RAFT_HD void load_tile(const Tile& t, const Inputs& in, int64_t g0, int64_t G,
                       int warps, int first, int step) {
  for (int i = first; i < t.P * warps; i += step) {
    const int p = i / warps, w = i % warps;
    const int64_t g = g0 + w;
    if (g >= G) continue;
    const int64_t k = (int64_t)p * G + g;
    t.at(kTerm, p, w) = in.term[k];
    t.at(kEe, p, w) = in.ee[k];
    t.at(kHb, p, w) = in.hb[k];
    t.at(kLi, p, w) = in.li[k];
    t.at(kLt, p, w) = in.lt[k];
    t.at(kMatched, p, w) = in.matched[k];
    t.at(kCommit, p, w) = in.commit[k];
    // Timers tick by ROLE (a crashed leader keeps ticking); replication
    // uses the ALIVE leader.
    const bool role = in.state[k] == kRoleLeader, alive = in.crashed[k] == 0;
    t.flag(p, w) = (uint8_t)(kValid | (role ? kRoleLead : 0u) |
                             (role && alive ? kLeader : 0u) |
                             (in.voter[k] != 0 ? kVoter : 0u) |
                             (alive && in.member[k] != 0 ? kAliveMember : 0u));
  }
}

// The six output fields of the window back to their planes.
RAFT_HD void store_tile(const Tile& t, const Outputs& out, int64_t g0,
                        int64_t G, int warps, int first, int step) {
  for (int i = first; i < t.P * warps; i += step) {
    const int p = i / warps, w = i % warps;
    const int64_t g = g0 + w;
    if (g >= G) continue;
    const int64_t k = (int64_t)p * G + g;
    out.ee[k] = t.at(kEe, p, w);
    out.hb[k] = t.at(kHb, p, w);
    out.li[k] = t.at(kLi, p, w);
    out.lt[k] = t.at(kLt, p, w);
    out.matched[k] = t.at(kMatched, p, w);
    out.commit[k] = t.at(kCommit, p, w);
  }
}

// One lane's J slots in registers (every index a compile-time constant
// once the slot loops unroll), slot j peer lane + LANES j.  A slot past P
// has flags 0: it holds no role, is never written back, and the selections
// skip it.
template <int J, int LANES = kLanes>
struct RegColumn {
  int32_t v[kFields][J];
  uint32_t fl[J];

  RAFT_HD int slots() const { return J; }
  RAFT_HD int32_t& at(int f, int j) { return v[f][j]; }
  RAFT_HD uint32_t flags(int j) const { return fl[j]; }

  RAFT_HD void load(const Tile& t, int w, int lane) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int p = lane + LANES * j;
      const bool ok = p < t.P;
#pragma unroll
      for (int f = 0; f < kFields; ++f) v[f][j] = ok ? t.at(f, p, w) : 0;
      fl[j] = ok ? t.flag(p, w) : 0u;
    }
  }

  RAFT_HD void store(const Tile& t, int w, int lane) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int p = lane + LANES * j;
      if (p < t.P) {
#pragma unroll
        for (int f = kEe; f < kFields; ++f) t.at(f, p, w) = v[f][j];
      }
    }
  }
};

// One lane's slots in place in the tile (the runtime-J instance): slot j is
// peer lane + 32 j, and a lane has only the slots below P.
struct TileColumn {
  Tile t;
  int w, lane, n;

  RAFT_HD TileColumn(const Tile& tile, int warp, int l)
      : t(tile), w(warp), lane(l), n((tile.P - l + kLanes - 1) / kLanes) {}
  RAFT_HD int slots() const { return n; }
  RAFT_HD int32_t& at(int f, int j) const { return t.at(f, lane + kLanes * j, w); }
  RAFT_HD uint32_t flags(int j) const { return t.flag(lane + kLanes * j, w); }
  RAFT_HD void load(const Tile&, int, int) {}
  RAFT_HD void store(const Tile&, int, int) {}
};

RAFT_HD int clz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __clz((int)x);
#else
  return x == 0 ? 32 : __builtin_clz(x);
#endif
}

RAFT_HD uint32_t biased(int32_t x) { return (uint32_t)x ^ 0x80000000u; }
RAFT_HD int32_t unbiased(uint32_t u) { return (int32_t)(u ^ 0x80000000u); }

// The value at position `pos` (0 = the largest) of the multiset of the
// values `value(c, j, x)` gives for the slots where it returns true,
// sorted descending; needs 0 <= pos < the multiset's size.  A radix search
// over the biased values: t keeps the largest value with more than `pos`
// values at or above it, bit by bit below the common prefix of the least
// and the largest value.
template <class Lanes, class Value>
RAFT_HD int32_t select_desc(Lanes& L, uint32_t pos, Value value) {
  using Col = typename Lanes::Column;
  const uint32_t lo = L.min_u([&](Col& c) {
    uint32_t m = 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < c.slots(); ++j) {
      int32_t x;
      if (value(c, j, x)) m = biased(x) < m ? biased(x) : m;
    }
    return m;
  });
  const uint32_t hi = L.max_u([&](Col& c) {
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < c.slots(); ++j) {
      int32_t x;
      if (value(c, j, x)) m = biased(x) > m ? biased(x) : m;
    }
    return m;
  });
  if (lo == hi) return unbiased(lo);
  const int top = 31 - clz32(lo ^ hi);
  uint32_t t = top == 31 ? 0u : hi & ~((2u << top) - 1u);
#pragma unroll 1
  for (int b = top; b >= 0; --b) {
    const uint32_t cand = t | (1u << b);
    const uint32_t above = L.sum([&](Col& c) {
      uint32_t n = 0;
#pragma unroll
      for (int j = 0; j < c.slots(); ++j) {
        int32_t x;
        if (value(c, j, x) && biased(x) >= cand) ++n;
      }
      return n;
    });
    if (above > pos) t = cand;
  }
  return unbiased(t);
}

// Position qpos of a sent round's masked matched values with one acting
// leader: the fixed part (its values at positions qpos - m and qpos, `hiv`
// and `lov`, lov INT32_MIN where the part has no position qpos) merged with
// m copies of v = lead_last.  If lov > v, lov; else v while the copies
// still cover position qpos (qpos < m, or the fixed value at qpos - m is
// at least v); else that fixed value.
RAFT_HD int32_t merged_select(uint32_t qpos, uint32_t m, int32_t hiv,
                              int32_t lov, int32_t v) {
  return imax(lov, qpos < m ? v : imin(hiv, v));
}

// `rounds` steady rounds of the group whose slots `L` holds; term_start,
// app and the with_health variant's ticks_since_commit are the group's
// [G] values.  Returns tsc' (tsc unchanged without health).
template <bool WITH_HEALTH, class Lanes>
RAFT_HD int32_t steady_warp_rounds(Lanes& L, int32_t term_start, int32_t app,
                                   int32_t tsc, int rounds, int election_tick,
                                   int heartbeat_tick) {
  using Col = typename Lanes::Column;
  // The number of slots whose flags satisfy `pred`.
  auto count = [&](auto pred) {
    return L.sum([&](Col& c) {
      uint32_t n = 0;
#pragma unroll
      for (int j = 0; j < c.slots(); ++j) n += pred(c.flags(j)) ? 1u : 0u;
      return n;
    });
  };
  // A sent round writes the acting leaders' and the alive members' slots.
  auto written = [](uint32_t fl) { return (fl & (kLeader | kAliveMember)) != 0; };
  // The wrapping sum of field f over the acting leaders.
  auto lead_sum = [&](int f) {
    return L.sum([&](Col& c) {
      uint32_t s = 0;
#pragma unroll
      for (int j = 0; j < c.slots(); ++j) {
        if (c.flags(j) & kLeader) s += (uint32_t)c.at(f, j);
      }
      return s;
    });
  };
  const uint32_t n_lead = count([](uint32_t fl) { return (fl & kLeader) != 0; });
  const bool has_leader = n_lead > 0;
  const uint32_t qpos = count([](uint32_t fl) { return (fl & kVoter) != 0; }) / 2;
  const int32_t n_app = has_leader ? app : 0;
  const uint32_t lead_lt = lead_sum(kTerm);
  uint32_t lead_last = lead_sum(kLi);
  uint32_t lead_commit_sum = lead_sum(kCommit);

  // One acting leader: the order statistics of the fixed part, whose size
  // is the peers less the m voters a sent round writes.
  const uint32_t m = count([&](uint32_t fl) { return (fl & kVoter) && written(fl); });
  int32_t hiv = 0, lov = INT32_MIN;
  if (n_lead == 1) {
    auto fixed = [&](Col& c, int j, int32_t& x) {
      const uint32_t fl = c.flags(j);
      if (!(fl & kValid) || ((fl & kVoter) && written(fl))) return false;
      x = (fl & kVoter) ? c.at(kMatched, j) : 0;
      return true;
    };
    const uint32_t n_fixed = count([](uint32_t fl) { return (fl & kValid) != 0; }) - m;
    if (qpos >= m) hiv = select_desc(L, qpos - m, fixed);
    if (qpos < n_fixed) lov = select_desc(L, qpos, fixed);
  }
  // with_health: the max commit over all rows, and over the rows a sent
  // round leaves alone.
  int32_t maxc_prev = 0, max_fixed = INT32_MIN;
  if (WITH_HEALTH) {
    maxc_prev = L.max_i([&](Col& c) {
      int32_t x = INT32_MIN;
#pragma unroll
      for (int j = 0; j < c.slots(); ++j) {
        if (c.flags(j) & kValid) x = imax(x, c.at(kCommit, j));
      }
      return x;
    });
    max_fixed = L.max_i([&](Col& c) {
      int32_t x = INT32_MIN;
#pragma unroll
      for (int j = 0; j < c.slots(); ++j) {
        const uint32_t fl = c.flags(j);
        if ((fl & kValid) && !written(fl)) x = imax(x, c.at(kCommit, j));
      }
      return x;
    });
  }

#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    // --- tick (no campaigns by the steady invariant)
    const bool lead_beat = L.any([&](Col& c) {
      bool beat = false;
#pragma unroll
      for (int j = 0; j < c.slots(); ++j) {
        const uint32_t fl = c.flags(j);
        const bool role = (fl & kRoleLead) != 0;
        int32_t ee = wadd(c.at(kEe, j), 1);
        if (role && ee >= election_tick) ee = 0;
        c.at(kEe, j) = ee;
        if (role) {
          int32_t hb = wadd(c.at(kHb, j), 1);
          if (hb >= heartbeat_tick) {
            hb = 0;
            beat = beat || (fl & kLeader) != 0;
          }
          c.at(kHb, j) = hb;
        }
      }
      return beat;
    });
    // --- appends at the acting leaders; lead_last is the sum of their last
    // indexes after the append
    lead_last += n_lead * (uint32_t)n_app;
    const bool sent = has_leader && (lead_beat || n_app > 0);
    // --- in-round sync of alive members; the acting matched row follows
    L.each([&](Col& c) {
#pragma unroll
      for (int j = 0; j < c.slots(); ++j) {
        const uint32_t fl = c.flags(j);
        if (fl & kLeader) {
          c.at(kLi, j) = wadd(c.at(kLi, j), n_app);
          c.at(kLt, j) = c.at(kTerm, j);
          if (sent) c.at(kMatched, j) = c.at(kLi, j);
        } else if (sent && (fl & kAliveMember)) {
          c.at(kEe, j) = 0;
          c.at(kLi, j) = (int32_t)lead_last;
          c.at(kLt, j) = (int32_t)lead_lt;
          c.at(kMatched, j) = (int32_t)lead_last;
        }
      }
    });
    int32_t lead_commit = (int32_t)lead_commit_sum;
    if (sent) {
      // --- majority index over the voters
      int32_t mci;
      if (n_lead == 1) {
        mci = merged_select(qpos, m, hiv, lov, (int32_t)lead_last);
      } else {
        mci = select_desc(L, qpos, [&](Col& c, int j, int32_t& x) {
          const uint32_t fl = c.flags(j);
          if (!(fl & kValid)) return false;
          x = (fl & kVoter) ? c.at(kMatched, j) : 0;
          return true;
        });
      }
      // --- commit, gated on the leader's own term
      if (mci >= term_start) lead_commit = imax(lead_commit, mci);
      L.each([&](Col& c) {
#pragma unroll
        for (int j = 0; j < c.slots(); ++j) {
          if (written(c.flags(j))) c.at(kCommit, j) = lead_commit;
        }
      });
      lead_commit_sum = n_lead * (uint32_t)lead_commit;
    }
    if (WITH_HEALTH) {
      const int32_t maxc = sent ? imax(max_fixed, lead_commit) : maxc_prev;
      tsc = maxc > maxc_prev ? 0 : wadd(tsc, 1);
      maxc_prev = maxc;
    }
  }
  return tsc;
}

// The host shim's lanes: a group's LANES columns run one after another,
// each collective a loop over them.
template <class Col, int LANES = kLanes>
struct HostLanes {
  using Column = Col;
  Col* cols;

  template <class F>
  void each(F f) {
    for (int l = 0; l < LANES; ++l) f(cols[l]);
  }
  template <class F>
  bool any(F f) {
    bool out = false;
    for (int l = 0; l < LANES; ++l) out = f(cols[l]) || out;
    return out;
  }
  template <class F>
  uint32_t sum(F f) {
    uint32_t out = 0;
    for (int l = 0; l < LANES; ++l) out += f(cols[l]);
    return out;
  }
  template <class F>
  uint32_t min_u(F f) {
    uint32_t out = 0xFFFFFFFFu;
    for (int l = 0; l < LANES; ++l) {
      const uint32_t x = f(cols[l]);
      out = x < out ? x : out;
    }
    return out;
  }
  template <class F>
  uint32_t max_u(F f) {
    uint32_t out = 0;
    for (int l = 0; l < LANES; ++l) {
      const uint32_t x = f(cols[l]);
      out = x > out ? x : out;
    }
    return out;
  }
  template <class F>
  int32_t max_i(F f) {
    int32_t out = INT32_MIN;
    for (int l = 0; l < LANES; ++l) out = imax(out, f(cols[l]));
    return out;
  }
};

#if defined(__CUDACC__)
// The card's lanes: this thread's column, each collective one warp
// instruction over the group's lanes, `mask` (the whole warp, or the half
// a half-warp group takes).  Only device code calls them; the host pass of
// nvcc sees bodies that do nothing.
template <class Col>
struct WarpLanes {
  using Column = Col;
  Col& col;
  unsigned mask;

  template <class F>
  RAFT_HD void each(F f) { f(col); }
  template <class F>
  RAFT_HD bool any(F f) {
#if defined(__CUDA_ARCH__)
    return __any_sync(mask, f(col)) != 0;
#else
    return f(col);
#endif
  }
  template <class F>
  RAFT_HD uint32_t sum(F f) {
#if defined(__CUDA_ARCH__)
    return __reduce_add_sync(mask, (unsigned)f(col));
#else
    return f(col);
#endif
  }
  template <class F>
  RAFT_HD uint32_t min_u(F f) {
#if defined(__CUDA_ARCH__)
    return __reduce_min_sync(mask, (unsigned)f(col));
#else
    return f(col);
#endif
  }
  template <class F>
  RAFT_HD uint32_t max_u(F f) {
#if defined(__CUDA_ARCH__)
    return __reduce_max_sync(mask, (unsigned)f(col));
#else
    return f(col);
#endif
  }
  template <class F>
  RAFT_HD int32_t max_i(F f) {
#if defined(__CUDA_ARCH__)
    return __reduce_max_sync(mask, (int)f(col));
#else
    return f(col);
#endif
  }
};
#endif

}  // namespace raft_steady_warp
