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

// A peer count known at compile time: loops bounded by it unroll fully and
// the per-peer arrays sized by it live in registers.  The steady kernel's
// runtime-P instance passes a plain int in its place (steady_body.cuh).
template <int N>
struct Fixed {
  RAFT_HD constexpr operator int() const { return N; }
};

// Majority index of one group's matched row over its voter slots: the
// descending odd-even transposition network over the first np slots, then
// the value at position qpos (the voter count // 2).  Non-voters count as
// 0.  CAP is the arrays' size, np the peer count (Fixed<CAP> or an int no
// larger than CAP).
template <int CAP, class NP>
RAFT_HD int32_t quorum_index(const int32_t (&matched)[CAP],
                             const bool (&voter)[CAP], int32_t qpos, NP np) {
  const int n = np;
  int32_t rows[CAP];
#pragma unroll
  for (int p = 0; p < n; ++p) rows[p] = voter[p] ? matched[p] : 0;
#pragma unroll
  for (int pass = 0; pass < n; ++pass) {
#pragma unroll
    for (int i = pass % 2; i < n - 1; i += 2) {
      const int32_t hi = imax(rows[i], rows[i + 1]);
      const int32_t lo = imin(rows[i], rows[i + 1]);
      rows[i] = hi;
      rows[i + 1] = lo;
    }
  }
  int32_t mci = 0;
#pragma unroll
  for (int p = 0; p < n; ++p) {
    if (qpos == p) mci = rows[p];
  }
  return mci;
}

template <int P>
RAFT_HD int32_t quorum_index(const int32_t (&matched)[P],
                             const bool (&voter)[P], int32_t qpos) {
  return quorum_index<P>(matched, voter, qpos, Fixed<P>());
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
// with_health=False kernels stay the code they were.  CAP and NP as in
// quorum_index.
template <int CAP, bool WITH_HEALTH, class NP = Fixed<CAP>>
struct CommitTracker {
  RAFT_HD CommitTracker(const int32_t*, int64_t, const int32_t (&)[CAP],
                        NP = NP()) {}
  RAFT_HD void round(const int32_t (&)[CAP]) {}
  RAFT_HD void store(int32_t*, int64_t) const {}
};

template <int CAP, class NP>
RAFT_HD int32_t max_of(const int32_t (&v)[CAP], NP np) {
  const int n = np;
  int32_t m = v[0];
#pragma unroll
  for (int p = 1; p < n; ++p) m = imax(m, v[p]);
  return m;
}

template <int CAP, class NP>
struct CommitTracker<CAP, true, NP> {
  int32_t tsc;
  int32_t maxc_prev;
  NP np;
  RAFT_HD CommitTracker(const int32_t* tsc_in, int64_t g,
                        const int32_t (&commit)[CAP], NP n = NP())
      : tsc(tsc_in[g]), maxc_prev(max_of<CAP>(commit, n)), np(n) {}
  RAFT_HD void round(const int32_t (&commit)[CAP]) {
    const int32_t maxc = max_of<CAP>(commit, np);
    tsc = maxc > maxc_prev ? 0 : wadd(tsc, 1);
    maxc_prev = maxc;
  }
  RAFT_HD void store(int32_t* tsc_out, int64_t g) const { tsc_out[g] = tsc; }
};

}  // namespace raft_fused

// Expands CASE(P) for the narrow instances, P = 1 through 7 (*_round.cu,
// *_host.cpp).
#define RAFT_FOR_EACH_P(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)

// Expands CASE(P) for the wide instances, P = 8 through 15, of the host
// builds (*_host_wide.cpp, one library beside the narrow one).  The CUDA
// builds take one wide P a library (*_round_wide.cu): the [P, P] blocks of
// the chaos and damped bodies spill to local memory there, and their
// instances are slow to compile.
#define RAFT_FOR_EACH_WIDE_P(CASE) \
  CASE(8) CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15)

// The instance list a translation unit builds: the narrow one unless the
// file defines RAFT_PEER_LIST before its first include.
#ifndef RAFT_PEER_LIST
#define RAFT_PEER_LIST RAFT_FOR_EACH_P
#endif

// Expands CASE(NP, WITH_HEALTH) for both variants of peer count NP.
#define RAFT_FOR_EACH_HEALTH(CASE, NP) CASE(NP, false) CASE(NP, true)
