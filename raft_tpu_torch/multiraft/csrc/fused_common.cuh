// Helpers shared by the fused kernel bodies (steady_body.cuh,
// chaos_body.cuh, damped_body.cuh): the __host__ __device__ marker,
// wrapping int32 arithmetic, the majority index by odd-even
// transposition, the per-link loss draw, the pairwise agreement event and
// the with_health variants' commit tracker.  Written once so the kernels
// that use them cannot drift apart; each function works on one group's
// values held in fully unrolled arrays, P a template parameter.
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
// descending odd-even transposition network, then the value at position
// qpos (the voter count // 2).  Non-voters count as 0.
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

// The sum of row a of a [P, P] block over the rows whose flag is set: the
// sender's agreement row when exactly one flag is set (the reference
// reduces with a sum, so several flags add their rows).
template <int P>
RAFT_HD void flagged_row(const int32_t (&agree)[P][P], const bool (&flag)[P],
                         int32_t (&row)[P]) {
#pragma unroll
  for (int b = 0; b < P; ++b) {
    int32_t acc = 0;
#pragma unroll
    for (int a = 0; a < P; ++a) {
      if (flag[a]) acc = wadd(acc, agree[a][b]);
    }
    row[b] = acc;
  }
}

// One wholesale-adoption agreement event: pairs inside in_set agree to
// `value`; a pair with one side inside inherits the sender's row
// `lead_row` at the other side; the rest keep their value.
template <int P>
RAFT_HD void agree_event(int32_t (&agree)[P][P], const bool (&in_set)[P],
                         int32_t value, const int32_t (&lead_row)[P]) {
#pragma unroll
  for (int a = 0; a < P; ++a) {
#pragma unroll
    for (int b = 0; b < P; ++b) {
      if (in_set[a] && in_set[b]) {
        agree[a][b] = value;
      } else if (in_set[a]) {
        agree[a][b] = lead_row[b];
      } else if (in_set[b]) {
        agree[a][b] = lead_row[a];
      }
    }
  }
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

}  // namespace raft_fused

// Expands CASE(P) for every instantiated peer count, 1 through 7; the
// Python wrappers reject any other P before calling in.
#define RAFT_FOR_EACH_P(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)

// Expands CASE(NP, WITH_HEALTH) for both variants of peer count NP.
#define RAFT_FOR_EACH_HEALTH(CASE, NP) CASE(NP, false) CASE(NP, true)
