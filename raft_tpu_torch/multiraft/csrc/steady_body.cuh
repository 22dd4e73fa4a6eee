// Per-group body of k fused steady protocol rounds: the arithmetic of
// raft_tpu/multiraft/pallas_step.py:_steady_kernel (with_health=False),
// written once for both the CUDA grid wrapper (steady_round.cu) and the
// host shim the CPU tests build with g++ (steady_host.cpp).
//
// Layout: every [P, G] plane is peer-major, so group g's column is
// plane[p * G + g].  One call handles one group: it loads the group's
// P-column of every plane into fully unrolled int[P] arrays, runs `rounds`
// rounds on registers, and stores the six output columns.  In the grid
// wrapper neighbouring threads take neighbouring groups, so each plane row
// is read and written in coalesced runs.
//
// Inputs: state, term, ee, hb, li, lt, acting matched row, commit (int32
// [P, G]); voter, member, crashed (bool [P, G], one byte each, nonzero =
// true); term_start of the acting leader and the append count (int32 [G]).
// Outputs: ee, hb, li, lt, matched row, commit (int32 [P, G]).
//
// Integer sums and increments wrap modulo 2**32 like PyTorch's int32
// arithmetic (done in uint32, then reinterpreted).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define RAFT_HD __host__ __device__ __forceinline__
#else
#define RAFT_HD inline
#endif

namespace raft_steady {

constexpr int32_t kRoleLeader = 2;

RAFT_HD int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

RAFT_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
RAFT_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

template <int P>
RAFT_HD void steady_group(
    int64_t g, int64_t G,
    const int32_t* __restrict__ state_in, const int32_t* __restrict__ term_in,
    const int32_t* __restrict__ ee_in, const int32_t* __restrict__ hb_in,
    const int32_t* __restrict__ li_in, const int32_t* __restrict__ lt_in,
    const int32_t* __restrict__ matched_in,
    const int32_t* __restrict__ commit_in,
    const uint8_t* __restrict__ voter_in, const uint8_t* __restrict__ member_in,
    const uint8_t* __restrict__ crashed_in,
    const int32_t* __restrict__ ts_in, const int32_t* __restrict__ app_in,
    int32_t* __restrict__ ee_out, int32_t* __restrict__ hb_out,
    int32_t* __restrict__ li_out, int32_t* __restrict__ lt_out,
    int32_t* __restrict__ matched_out, int32_t* __restrict__ commit_out,
    int rounds, int election_tick, int heartbeat_tick) {
  int32_t term[P], ee[P], hb[P], li[P], lt[P], matched[P], commit[P];
  bool role_leader[P], is_leader[P], voter[P], alive_member[P];
  bool has_leader = false;
  int32_t count = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = (int64_t)p * G + g;
    term[p] = term_in[i];
    ee[p] = ee_in[i];
    hb[p] = hb_in[i];
    li[p] = li_in[i];
    lt[p] = lt_in[i];
    matched[p] = matched_in[i];
    commit[p] = commit_in[i];
    voter[p] = voter_in[i] != 0;
    const bool alive = crashed_in[i] == 0;
    // Timers tick by ROLE (a crashed leader keeps ticking); replication
    // uses the ALIVE leader.
    role_leader[p] = state_in[i] == kRoleLeader;
    is_leader[p] = role_leader[p] && alive;
    alive_member[p] = alive && member_in[i] != 0;
    has_leader = has_leader || is_leader[p];
    count += voter[p] ? 1 : 0;
  }
  const int32_t qpos = count / 2;
  const int32_t term_start = ts_in[g];
  const int32_t n_app = has_leader ? app_in[g] : 0;

  for (int r = 0; r < rounds; ++r) {
    // --- tick (no campaigns by the steady invariant)
    bool lead_beat = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ee[p] = wadd(ee[p], 1);
      if (role_leader[p] && ee[p] >= election_tick) ee[p] = 0;
      if (role_leader[p]) hb[p] = wadd(hb[p], 1);
      const bool want_beat = role_leader[p] && hb[p] >= heartbeat_tick;
      if (want_beat) hb[p] = 0;
      lead_beat = lead_beat || (want_beat && is_leader[p]);
    }
    // --- appends at the (unique alive) leader
    int32_t lead_last = 0, lead_lt = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (is_leader[p]) {
        li[p] = wadd(li[p], n_app);
        lt[p] = term[p];
        lead_last = wadd(lead_last, li[p]);
        lead_lt = wadd(lead_lt, lt[p]);
      }
    }
    const bool sent = has_leader && (lead_beat || n_app > 0);
    // --- in-round sync of alive members; the acting matched row follows
    int32_t rows[P];
    bool sync[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      sync[p] = sent && alive_member[p] && !is_leader[p];
      if (sync[p]) {
        ee[p] = 0;
        li[p] = lead_last;
        lt[p] = lead_lt;
      }
      if (sync[p] || (is_leader[p] && sent)) matched[p] = li[p];
      rows[p] = voter[p] ? matched[p] : 0;
    }
    // --- majority index: descending odd-even transposition network
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
    // --- commit, gated on the leader's own term
    int32_t lead_commit = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (is_leader[p]) lead_commit = wadd(lead_commit, commit[p]);
    }
    if (has_leader && sent && mci >= term_start) {
      lead_commit = imax(lead_commit, mci);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if ((is_leader[p] || sync[p]) && sent) commit[p] = lead_commit;
    }
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = (int64_t)p * G + g;
    ee_out[i] = ee[p];
    hb_out[i] = hb[p];
    li_out[i] = li[p];
    lt_out[i] = lt[p];
    matched_out[i] = matched[p];
    commit_out[i] = commit[p];
  }
}

}  // namespace raft_steady

// Expands CASE(P) for every instantiated peer count, 1 through 7; the
// Python wrapper rejects any other P before calling in.
#define RAFT_STEADY_FOR_EACH_P(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)
