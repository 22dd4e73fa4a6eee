// Host build of damped_body.cuh: the same per-group body as the CUDA
// kernel, looped over the groups on the CPU (the loop index plus
// group_base is the group id, as the grid's global thread index plus
// group_base is; damped_round_host is damped_round_host_at at base 0).
// Compiled with g++ by the tests so the kernel's arithmetic can be held
// against the plain PyTorch version on a machine without a card; nothing
// on the card path uses it.  damped_round_host_at keeps each group's agree
// block in a plain array (ArrayBlock); damped_round_host_strided_at runs
// the same body over the CUDA build's shared-memory layout (StridedBlock),
// kViewStride groups' blocks interleaved in one buffer.
#include <stdint.h>

#include "damped_body.cuh"

namespace {

constexpr int kViewStride = 3;

template <int P, bool CQ, bool LOSS, bool HEALTH>
void host_groups(const raft_damped::DampedPlanes& t, int64_t G,
                 int32_t round_base, int rounds, int election_tick,
                 int heartbeat_tick, int64_t group_base, bool strided) {
  int32_t view[P * P * kViewStride];
  for (int64_t g = 0; g < G; ++g) {
    if (strided) {
      raft_fused::StridedBlock<P, kViewStride> blk{view + g % kViewStride};
      raft_damped::damped_group<P, CQ, LOSS, HEALTH>(
          g, G, t, round_base, rounds, election_tick, heartbeat_tick,
          group_base, blk);
    } else {
      raft_fused::ArrayBlock<P> blk;
      raft_damped::damped_group<P, CQ, LOSS, HEALTH>(
          g, G, t, round_base, rounds, election_tick, heartbeat_tick,
          group_base, blk);
    }
  }
}

int host_rounds(
    const void* state, const void* leader_id, const void* hb, const void* ee,
    const void* li, const void* lt, const void* commit, const void* matched,
    const void* ra, const void* voter, const void* member,
    const void* crashed, const void* agree, const void* loss_rate,
    const void* ts, const void* lead_term, const void* app, void* state_out,
    void* leader_id_out, void* hb_out, void* ee_out, void* li_out,
    void* lt_out, void* commit_out, void* matched_out, void* ra_out,
    void* agree_out, const void* tsc, void* tsc_out, long long G, int P,
    int round_base, int rounds, int election_tick, int heartbeat_tick,
    int with_cq, int with_loss, int with_health, long long group_base,
    bool strided) {
  const raft_damped::DampedPlanes t = {
      (const int32_t*)state,     (const int32_t*)leader_id,
      (const int32_t*)hb,        (const int32_t*)ee,
      (const int32_t*)li,        (const int32_t*)lt,
      (const int32_t*)commit,    (const int32_t*)matched,
      (const uint8_t*)ra,        (const uint8_t*)voter,
      (const uint8_t*)member,    (const uint8_t*)crashed,
      (const int32_t*)agree,     (const int32_t*)loss_rate,
      (const int32_t*)ts,        (const int32_t*)lead_term,
      (const int32_t*)app,       (int32_t*)state_out,
      (int32_t*)leader_id_out,   (int32_t*)hb_out,
      (int32_t*)ee_out,          (int32_t*)li_out,
      (int32_t*)lt_out,          (int32_t*)commit_out,
      (int32_t*)matched_out,     (uint8_t*)ra_out,
      (int32_t*)agree_out,       (const int32_t*)tsc,
      (int32_t*)tsc_out};
  const int flags =
      (with_cq ? 1 : 0) + (with_loss ? 2 : 0) + (with_health ? 4 : 0);
  if (with_loss && loss_rate == nullptr) return 1;
  if (with_health && (tsc == nullptr || tsc_out == nullptr)) return 1;
#define RAFT_DAMPED_HOST(NP, CQ, LOSS, HEALTH)                        \
  case NP * 8 + (CQ ? 1 : 0) + (LOSS ? 2 : 0) + (HEALTH ? 4 : 0):     \
    host_groups<NP, CQ, LOSS, HEALTH>(                                \
        t, (int64_t)G, (int32_t)round_base, rounds, election_tick,    \
        heartbeat_tick, (int64_t)group_base, strided);                \
    return 0;
#define RAFT_DAMPED_P(NP) RAFT_DAMPED_FOR_EACH_FLAG(RAFT_DAMPED_HOST, NP)
  switch (P * 8 + flags) {
    RAFT_PEER_LIST(RAFT_DAMPED_P)
    default:
      return 1;
  }
#undef RAFT_DAMPED_P
#undef RAFT_DAMPED_HOST
}

}  // namespace

extern "C" int damped_round_host_at(
    const void* state, const void* leader_id, const void* hb, const void* ee,
    const void* li, const void* lt, const void* commit, const void* matched,
    const void* ra, const void* voter, const void* member,
    const void* crashed, const void* agree, const void* loss_rate,
    const void* ts, const void* lead_term, const void* app, void* state_out,
    void* leader_id_out, void* hb_out, void* ee_out, void* li_out,
    void* lt_out, void* commit_out, void* matched_out, void* ra_out,
    void* agree_out, const void* tsc, void* tsc_out, long long G, int P,
    int round_base, int rounds, int election_tick, int heartbeat_tick,
    int with_cq, int with_loss, int with_health, long long group_base) {
  return host_rounds(
      state, leader_id, hb, ee, li, lt, commit, matched, ra, voter, member,
      crashed, agree, loss_rate, ts, lead_term, app, state_out, leader_id_out,
      hb_out, ee_out, li_out, lt_out, commit_out, matched_out, ra_out,
      agree_out, tsc, tsc_out, G, P, round_base, rounds, election_tick,
      heartbeat_tick, with_cq, with_loss, with_health, group_base, false);
}

extern "C" int damped_round_host_strided_at(
    const void* state, const void* leader_id, const void* hb, const void* ee,
    const void* li, const void* lt, const void* commit, const void* matched,
    const void* ra, const void* voter, const void* member,
    const void* crashed, const void* agree, const void* loss_rate,
    const void* ts, const void* lead_term, const void* app, void* state_out,
    void* leader_id_out, void* hb_out, void* ee_out, void* li_out,
    void* lt_out, void* commit_out, void* matched_out, void* ra_out,
    void* agree_out, const void* tsc, void* tsc_out, long long G, int P,
    int round_base, int rounds, int election_tick, int heartbeat_tick,
    int with_cq, int with_loss, int with_health, long long group_base) {
  return host_rounds(
      state, leader_id, hb, ee, li, lt, commit, matched, ra, voter, member,
      crashed, agree, loss_rate, ts, lead_term, app, state_out, leader_id_out,
      hb_out, ee_out, li_out, lt_out, commit_out, matched_out, ra_out,
      agree_out, tsc, tsc_out, G, P, round_base, rounds, election_tick,
      heartbeat_tick, with_cq, with_loss, with_health, group_base, true);
}

extern "C" int damped_round_host(
    const void* state, const void* leader_id, const void* hb, const void* ee,
    const void* li, const void* lt, const void* commit, const void* matched,
    const void* ra, const void* voter, const void* member,
    const void* crashed, const void* agree, const void* loss_rate,
    const void* ts, const void* lead_term, const void* app, void* state_out,
    void* leader_id_out, void* hb_out, void* ee_out, void* li_out,
    void* lt_out, void* commit_out, void* matched_out, void* ra_out,
    void* agree_out, const void* tsc, void* tsc_out, long long G, int P,
    int round_base, int rounds, int election_tick, int heartbeat_tick,
    int with_cq, int with_loss, int with_health) {
  return damped_round_host_at(
      state, leader_id, hb, ee, li, lt, commit, matched, ra, voter, member,
      crashed, agree, loss_rate, ts, lead_term, app, state_out, leader_id_out,
      hb_out, ee_out, li_out, lt_out, commit_out, matched_out, ra_out,
      agree_out, tsc, tsc_out, G, P, round_base, rounds, election_tick,
      heartbeat_tick, with_cq, with_loss, with_health, 0);
}
