// Native multi-group Raft engine: the scalar CPU execution path of the
// batched MultiRaft protocol (same round semantics as
// raft_tpu_torch/multiraft/sim.py; reference semantics: raft.rs
// tick/campaign/step + quorum/majority.rs committed_index).  The port's own
// copy of the JAX package's engine, unchanged in its logic.
//
// The native CPU anchor behind `python -m raft_tpu_torch.bench`'s
// vs_baseline: a tight array-of-struct loop with no interpreter overhead,
// advancing G groups x P peers one protocol round per step.  Exposed via a
// C ABI for ctypes (raft_tpu_torch/multiraft/native.py), built at -O3 into
// the repository's build/ by raft_tpu_torch/multiraft/_build.py.

#include <cstdint>
#include <climits>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr int32_t ROLE_FOLLOWER = 0;
constexpr int32_t ROLE_CANDIDATE = 1;
constexpr int32_t ROLE_LEADER = 2;

// 32-bit murmur3-finalizer mix; MUST match the port's kernels.timeout_draw so all three
// backends (C++, Python scalar, XLA) draw identical election timeouts.
inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

inline int32_t timeout_draw(uint32_t node_key, uint32_t term, int32_t lo,
                            int32_t hi) {
  uint32_t x = node_key * 0x9E3779B1u + term;
  return lo + static_cast<int32_t>(mix32(x) % static_cast<uint32_t>(hi - lo));
}

struct Peer {
  int32_t term = 0;
  int32_t state = ROLE_FOLLOWER;
  int32_t vote = 0;       // 0 = none, else peer id 1..P
  int32_t leader_id = 0;  // 0 = none
  int32_t election_elapsed = 0;
  int32_t heartbeat_elapsed = 0;
  int32_t randomized_timeout = 0;
  int32_t last_index = 0;
  int32_t last_term = 0;
  int32_t commit = 0;
};

struct Group {
  std::vector<Peer> peers;
  // Per-OWNER tracker rows: every peer that has ever led keeps its own
  // frozen Progress.matched view + its noop index, exactly like the scalar
  // per-peer ProgressTracker (a stale leader resuming command must use ITS
  // view, not the latest regime's).
  std::vector<std::vector<int32_t>> matched;  // [P_owner][P_target]
  std::vector<int32_t> term_start_index;      // [P_owner]
  // Pairwise log-agreement lengths (logs diverge via crashed peers' stale
  // suffixes; every log is a wholesale-adopted regime log, so agreement is
  // prefix-shaped): the vote-traffic commit fast-forward's term check is
  // "m.commit <= agree[receiver][sender]".
  std::vector<std::vector<int32_t>> agree;  // [P][P]
};

struct Engine {
  int32_t G, P, election_tick, heartbeat_tick;
  std::vector<Group> groups;
  // Config masks [G*P] (joint + learner support; reference: joint.rs,
  // tracker.rs:40-49).  Defaults: every peer a voter, no joint/learners.
  std::vector<uint8_t> voter, outgoing, learner;

  uint32_t node_key(int g, int p) const {
    return static_cast<uint32_t>(g) * 65536u + static_cast<uint32_t>(p + 1);
  }

  bool vot(int g, int p) const { return voter[size_t(g) * P + p] != 0; }
  bool outg(int g, int p) const { return outgoing[size_t(g) * P + p] != 0; }
  bool lrn(int g, int p) const { return learner[size_t(g) * P + p] != 0; }
  bool promotable(int g, int p) const { return vot(g, p) || outg(g, p); }
  bool member(int g, int p) const { return promotable(g, p) || lrn(g, p); }

  Engine(int32_t g, int32_t p, int32_t et, int32_t ht)
      : G(g), P(p), election_tick(et), heartbeat_tick(ht) {
    voter.assign(size_t(G) * P, 1);
    outgoing.assign(size_t(G) * P, 0);
    learner.assign(size_t(G) * P, 0);
    groups.resize(G);
    for (int gi = 0; gi < G; ++gi) {
      auto& grp = groups[gi];
      grp.peers.resize(P);
      grp.matched.assign(P, std::vector<int32_t>(P, 0));
      grp.term_start_index.assign(P, 0);
      grp.agree.assign(P, std::vector<int32_t>(P, 0));
      for (int pi = 0; pi < P; ++pi) {
        grp.peers[pi].randomized_timeout =
            timeout_draw(node_key(gi, pi), 0, election_tick, 2 * election_tick);
      }
    }
  }

  // One protocol round for one group; `crashed` has P entries, `append_n`
  // is the workload proposed at the acting leader.  Phases mirror
  // sim.py::step exactly (tick -> campaign -> election -> replication).
  void step_group(int gi, const uint8_t* crashed, int32_t append_n) {
    auto& grp = groups[gi];
    auto& ps = grp.peers;
    const int32_t lo = election_tick, hi = 2 * election_tick;

    // Phase A+B: tick everyone; timeouts start campaigns
    // (reference: raft.rs:1024-1079, 1101-1117).
    int n_req = 0;
    int32_t t_star = 0;
    bool req[16] = {false};
    bool want_beat[16] = {false};
    for (int p = 0; p < P; ++p) {
      Peer& pr = ps[p];
      bool is_leader = pr.state == ROLE_LEADER;
      pr.election_elapsed += 1;
      if (is_leader) {
        pr.heartbeat_elapsed += 1;
        if (pr.election_elapsed >= election_tick) pr.election_elapsed = 0;
        if (pr.heartbeat_elapsed >= heartbeat_tick) {
          pr.heartbeat_elapsed = 0;
          want_beat[p] = true;
        }
      } else if (promotable(gi, p) &&
                 pr.election_elapsed >= pr.randomized_timeout) {
        // campaign: become candidate (only voters are promotable)
        pr.election_elapsed = 0;
        pr.term += 1;
        pr.state = ROLE_CANDIDATE;
        pr.vote = p + 1;
        pr.leader_id = 0;
        pr.randomized_timeout =
            timeout_draw(node_key(gi, p), pr.term, lo, hi);
        if (!crashed[p]) {
          req[p] = true;
          ++n_req;
          t_star = std::max(t_star, pr.term);
        } else {
          // A campaigner that is the sole voter of both config halves wins
          // LOCALLY (campaign -> self-vote -> quorum of 1 -> become_leader
          // + noop + self-commit, raft.rs:1217-1263) — isolation cannot
          // stop it.  Alive solo campaigners go through the normal
          // election path below.
          int n_i = 0, n_o = 0;
          for (int q = 0; q < P; ++q) {
            n_i += vot(gi, q) ? 1 : 0;
            n_o += outg(gi, q) ? 1 : 0;
          }
          bool solo = (n_i == 0 || (n_i == 1 && vot(gi, p))) &&
                      (n_o == 0 || (n_o == 1 && outg(gi, p)));
          if (solo) {
            pr.state = ROLE_LEADER;
            pr.leader_id = p + 1;
            pr.last_index += 1;  // noop
            pr.last_term = pr.term;
            grp.term_start_index[p] = pr.last_index;
            for (int q = 0; q < P; ++q) grp.matched[p][q] = 0;
            grp.matched[p][p] = pr.last_index;
            pr.commit = pr.last_index;
            pr.heartbeat_elapsed = 0;
          }
        }
      }
    }

    // Phase C: election resolution among alive requesters at t_star.
    bool winner_elected = false;
    if (n_req > 0) {
      // Deposed-leader heartbeat interleaving: a live leader's queued
      // heartbeats reach voters only if its pump position precedes the
      // first campaigner's, and always reach learners (no vote requests
      // bump them first).  Heartbeat commit is clamped to
      // min(matched, committed) (reference: raft.rs:829-839).
      {
        int pl = -1;
        int32_t plt = -1;
        for (int p = 0; p < P; ++p)
          if (!crashed[p] && ps[p].state == ROLE_LEADER && ps[p].term > plt) {
            pl = p;
            plt = ps[p].term;
          }
        if (pl >= 0 && t_star > plt && want_beat[pl]) {
          int first_req = P;
          for (int p = 0; p < P; ++p)
            if (req[p]) { first_req = p; break; }
          bool hb_first = pl < first_req;
          for (int p = 0; p < P; ++p) {
            if (p == pl || crashed[p] || ps[p].term > plt) continue;
            bool is_learner = lrn(gi, p);
            if (!(is_learner || (hb_first && promotable(gi, p)))) continue;
            int32_t hb_val =
                std::min(grp.matched[pl][p], ps[pl].commit);
            if (hb_val > ps[p].commit) ps[p].commit = hb_val;
            if (is_learner) {
              ps[p].election_elapsed = 0;
              ps[p].leader_id = pl + 1;
              // lower-term learners become followers at the deposed
              // leader's term and stay there (voters get re-bumped by the
              // vote requests; learners receive none).
              if (ps[p].term < plt) {
                ps[p].term = plt;
                ps[p].vote = 0;
                ps[p].randomized_timeout = timeout_draw(
                    node_key(gi, p), ps[p].term, election_tick,
                    2 * election_tick);
              }
            }
          }
        }
      }
      // Candidates contending at t_star are requesters whose PRE-BUMP
      // term is t_star; lower-term requesters are deposed by the bump and
      // their stale requests are ignored (m.term < receiver term).
      bool cand_pre[16];
      for (int c = 0; c < P; ++c)
        cand_pre[c] = req[c] && ps[c].term == t_star;

      // term bump for alive voters below t_star (request receipt;
      // campaign() sends requests only to voters).
      for (int p = 0; p < P; ++p) {
        Peer& pr = ps[p];
        if (!crashed[p] && promotable(gi, p) && pr.term < t_star) {
          pr.term = t_star;
          pr.state = ROLE_FOLLOWER;
          pr.vote = 0;
          pr.leader_id = 0;
          pr.election_elapsed = 0;
          pr.heartbeat_elapsed = 0;
          pr.randomized_timeout = timeout_draw(node_key(gi, p), pr.term, lo, hi);
        }
      }
      // votes: each responder grants the lowest-index eligible candidate;
      // tallies are per joint half (win both / lose either, empty wins).
      int grant_of[16];
      for (int v = 0; v < P; ++v) grant_of[v] = -1;
      for (int v = 0; v < P; ++v) {
        Peer& pv = ps[v];
        if (crashed[v] || !promotable(gi, v) || pv.term != t_star) continue;
        if (pv.vote != 0) {
          if (cand_pre[v]) grant_of[v] = v;
          continue;
        }
        for (int c = 0; c < P; ++c) {
          if (!cand_pre[c] || c == v) continue;
          bool up_to_date =
              (ps[c].last_term > pv.last_term) ||
              (ps[c].last_term == pv.last_term &&
               ps[c].last_index >= pv.last_index);
          if (up_to_date) {
            pv.vote = c + 1;
            // granting a real vote resets the election timer
            // (reference: raft.rs:1445-1449)
            pv.election_elapsed = 0;
            grant_of[v] = c;
            break;
          }
        }
      }

      // Commit fast-forward via vote traffic (maybe_commit_by_vote,
      // reference: raft.rs:2126-2164; requests carry commit info
      // raft.rs:1249-1254, reject responses raft.rs:1455-1458).  Logs are
      // prefix-consistent, so the term check reduces to a bounds check.
      // Wave 1 (requests, candidate-index order): rejecting non-leader
      // responders fast-forward from the request's campaign-time commit;
      // the reject response snapshots the responder's commit at that
      // moment.  Wave 2 (responses, voter-index order): candidates apply
      // rejection snapshots until their grant quorum lands.
      {
        int32_t req_commit[16];
        for (int c = 0; c < P; ++c) req_commit[c] = ps[c].commit;
        int32_t snap[16][16];  // snap[c][v]: responder v's commit in c's
                               // reject response (-1 = no rejection)
        for (int c = 0; c < P; ++c)
          for (int v = 0; v < P; ++v) snap[c][v] = -1;
        for (int c = 0; c < P; ++c) {
          if (!cand_pre[c]) continue;
          for (int v = 0; v < P; ++v) {
            if (v == c) continue;
            Peer& pv = ps[v];
            if (crashed[v] || !promotable(gi, v) || pv.term != t_star)
              continue;
            if (grant_of[v] == c) continue;  // granted: no commit info
            snap[c][v] = pv.commit;
            if (pv.state != ROLE_LEADER && req_commit[c] > pv.commit &&
                req_commit[c] <= grp.agree[v][c])
              pv.commit = req_commit[c];
          }
        }
        for (int c = 0; c < P; ++c) {
          if (!cand_pre[c]) continue;
          int cnt_i = vot(gi, c) ? 1 : 0;
          int cnt_o = outg(gi, c) ? 1 : 0;
          int n_i = 0, n_o = 0;
          for (int v = 0; v < P; ++v) {
            if (vot(gi, v)) ++n_i;
            if (outg(gi, v)) ++n_o;
          }
          int q_i = n_i / 2 + 1, q_o = n_o / 2 + 1;
          int rec_i = cnt_i, rec_o = cnt_o;  // responses recorded (+self)
          for (int v = 0; v < P; ++v) {
            bool won_before = ((cnt_i >= q_i) || n_i == 0) &&
                              ((cnt_o >= q_o) || n_o == 0);
            // A loser's later responses are stepped by step_follower and
            // ignored (poll -> Lost -> become_follower); the triggering
            // response itself still applies, so the cutoff is a STRICT
            // prefix (poll runs before maybe_commit_by_vote).
            bool lost_before =
                (n_i > 0 && cnt_i + (n_i - rec_i) < q_i) ||
                (n_o > 0 && cnt_o + (n_o - rec_o) < q_o);
            if (snap[c][v] >= 0 && !won_before && !lost_before &&
                snap[c][v] <= grp.agree[c][v] &&
                snap[c][v] > ps[c].commit)
              ps[c].commit = snap[c][v];
            bool responded =
                v != c && (grant_of[v] == c || snap[c][v] >= 0);
            if (responded) {
              if (vot(gi, v)) ++rec_i;
              if (outg(gi, v)) ++rec_o;
            }
            if (grant_of[v] == c && v != c) {
              // v == c is the self-vote, already in the initial counts
              if (vot(gi, v)) ++cnt_i;
              if (outg(gi, v)) ++cnt_o;
            }
          }
        }
      }
      auto half = [&](int c, bool use_out, bool& won_h, bool& lost_h) {
        int n = 0, resp = 0, votes = 0;
        for (int v = 0; v < P; ++v) {
          bool in_half = use_out ? outg(gi, v) : vot(gi, v);
          if (!in_half) continue;
          ++n;
          if (!crashed[v] && ps[v].term == t_star) ++resp;
          if (grant_of[v] == c) ++votes;
        }
        int q = n / 2 + 1;
        int missing = n - resp;
        won_h = (votes >= q) || (n == 0);
        lost_h = (votes + missing < q) && (n > 0);
      };
      int winner = -1;
      bool lost_of[16] = {false};
      for (int c = 0; c < P; ++c) {
        if (!cand_pre[c]) continue;
        bool wi, li_, wo, lo_;
        half(c, false, wi, li_);
        half(c, true, wo, lo_);
        if (wi && wo) winner = c;
        lost_of[c] = li_ || lo_;
      }
      for (int c = 0; c < P; ++c) {
        if (!cand_pre[c] || c == winner) continue;
        bool lost = lost_of[c];
        if (lost || (winner >= 0 && !crashed[c])) {
          ps[c].state = ROLE_FOLLOWER;
          ps[c].randomized_timeout =
              timeout_draw(node_key(gi, c), ps[c].term, lo, hi);
          ps[c].election_elapsed = 0;
        }
      }
      if (winner >= 0) {
        winner_elected = true;
        Peer& w = ps[winner];
        w.state = ROLE_LEADER;
        w.leader_id = winner + 1;
        w.randomized_timeout =
            timeout_draw(node_key(gi, winner), w.term, lo, hi);
        w.election_elapsed = 0;
        w.heartbeat_elapsed = 0;
        // noop entry (reference: raft.rs:1190-1194); become_leader resets
        // the winner's OWN tracker row only.
        w.last_index += 1;
        w.last_term = t_star;
        grp.term_start_index[winner] = w.last_index;
        std::fill(grp.matched[winner].begin(), grp.matched[winner].end(), 0);
      }
    }

    // Phase D: replication round under the acting leader.
    int lidx = -1;
    int32_t lead_term = -1;
    for (int p = 0; p < P; ++p) {
      if (!crashed[p] && ps[p].state == ROLE_LEADER && ps[p].term > lead_term) {
        lidx = p;
        lead_term = ps[p].term;
      }
    }
    if (lidx < 0) return;
    Peer& lead = ps[lidx];

    bool sent = want_beat[lidx] || append_n > 0 || winner_elected;
    if (append_n > 0) {
      lead.last_index += append_n;
      lead.last_term = lead.term;
    }
    if (!sent) return;

    // sync alive MEMBERS with term <= leader's; acks land in the acting
    // leader's OWN tracker row.
    auto& row = grp.matched[lidx];
    row[lidx] = lead.last_index;
    bool in_s[16] = {false};
    in_s[lidx] = true;
    for (int p = 0; p < P; ++p) {
      if (p == lidx || crashed[p] || !member(gi, p)) continue;
      Peer& f = ps[p];
      if (f.term > lead_term) continue;
      in_s[p] = true;
      bool bumped = f.term < lead_term;
      f.term = lead_term;
      f.state = ROLE_FOLLOWER;
      if (bumped) {
        f.vote = 0;
        f.randomized_timeout = timeout_draw(node_key(gi, p), f.term, lo, hi);
      }
      f.leader_id = lidx + 1;
      f.election_elapsed = 0;
      f.last_index = lead.last_index;
      f.last_term = lead.last_term;
      row[p] = f.last_index;
    }

    // log-agreement update: the sync set now holds exactly the leader's
    // log.
    {
      int32_t lead_row[16];
      for (int b = 0; b < P; ++b) lead_row[b] = grp.agree[lidx][b];
      for (int a = 0; a < P; ++a)
        for (int b = 0; b < P; ++b) {
          if (a == b) continue;
          if (in_s[a] && in_s[b])
            grp.agree[a][b] = lead.last_index;
          else if (in_s[a])
            grp.agree[a][b] = lead_row[b];
          else if (in_s[b])
            grp.agree[a][b] = lead_row[a];
        }
    }

    // joint quorum commit = min over both majorities, gated on the
    // owner's current-term entries (reference: majority.rs:70-124,
    // joint.rs:47-51, raft_log.rs:487-499).
    auto quorum_of = [&](bool use_out) -> int64_t {
      int32_t vals[16];
      int n = 0;
      for (int v = 0; v < P; ++v) {
        bool in_half = use_out ? outg(gi, v) : vot(gi, v);
        if (in_half) vals[n++] = row[v];
      }
      if (n == 0) return INT64_MAX;
      std::sort(vals, vals + n, std::greater<int32_t>());
      return vals[n / 2];
    };
    int64_t mci = std::min(quorum_of(false), quorum_of(true));
    if (mci < INT64_MAX && mci >= grp.term_start_index[lidx] &&
        mci > lead.commit)
      lead.commit = static_cast<int32_t>(mci);
    for (int p = 0; p < P; ++p) {
      if (p == lidx || crashed[p]) continue;
      if (ps[p].term == lead_term && ps[p].state == ROLE_FOLLOWER &&
          ps[p].leader_id == lidx + 1 && lead.commit > ps[p].commit) {
        ps[p].commit = lead.commit;  // commit_to never decreases
      }
    }
  }

  void step(const uint8_t* crashed, const int32_t* append_n) {
    for (int g = 0; g < G; ++g) {
      step_group(g, crashed + static_cast<size_t>(g) * P, append_n[g]);
    }
  }
};

}  // namespace

extern "C" {

void* mr_create(int32_t n_groups, int32_t n_peers, int32_t election_tick,
                int32_t heartbeat_tick) {
  if (n_peers > 16) return nullptr;
  return new Engine(n_groups, n_peers, election_tick, heartbeat_tick);
}

void mr_destroy(void* h) { delete static_cast<Engine*>(h); }

// Install config masks ([G*P] uint8 each; null keeps the current value).
void mr_set_config(void* h, const uint8_t* voter, const uint8_t* outgoing,
                   const uint8_t* learner) {
  auto* e = static_cast<Engine*>(h);
  size_t n = static_cast<size_t>(e->G) * e->P;
  if (voter) e->voter.assign(voter, voter + n);
  if (outgoing) e->outgoing.assign(outgoing, outgoing + n);
  if (learner) e->learner.assign(learner, learner + n);
}

void mr_step(void* h, const uint8_t* crashed, const int32_t* append_n) {
  static_cast<Engine*>(h)->step(crashed, append_n);
}

void mr_run(void* h, const uint8_t* crashed, const int32_t* append_n,
            int32_t rounds) {
  auto* e = static_cast<Engine*>(h);
  for (int32_t i = 0; i < rounds; ++i) e->step(crashed, append_n);
}

// Read out [G, P] planes for parity checks / status.
void mr_read_state(void* h, int32_t* term, int32_t* state, int32_t* commit,
                   int32_t* last_index, int32_t* last_term) {
  auto* e = static_cast<Engine*>(h);
  size_t i = 0;
  for (auto& g : e->groups) {
    for (auto& p : g.peers) {
      term[i] = p.term;
      state[i] = p.state;
      commit[i] = p.commit;
      last_index[i] = p.last_index;
      last_term[i] = p.last_term;
      ++i;
    }
  }
}

// Debug: dump the remaining per-peer fields [G, P] each.
void mr_read_state2(void* h, int32_t* vote, int32_t* ee, int32_t* hb,
                    int32_t* rt, int32_t* leader_id) {
  auto* e = static_cast<Engine*>(h);
  size_t i = 0;
  for (auto& g : e->groups)
    for (auto& p : g.peers) {
      vote[i] = p.vote;
      ee[i] = p.election_elapsed;
      hb[i] = p.heartbeat_elapsed;
      rt[i] = p.randomized_timeout;
      leader_id[i] = p.leader_id;
      ++i;
    }
}

// Batched linearizable ReadIndex barrier (Safe mode) — mirrors
// sim.read_index: per group, the index a read at the acting leader would
// return at this round boundary, or -1 (no leader / no current-term commit /
// ack quorum blocked by a higher-term member in peer-id order).
void mr_read_index(void* h, const uint8_t* crashed, int32_t* out) {
  auto* e = static_cast<Engine*>(h);
  for (int gi = 0; gi < e->G; ++gi) {
    auto& grp = e->groups[gi];
    auto& ps = grp.peers;
    const uint8_t* cr = crashed + size_t(gi) * e->P;
    int lead = -1;
    int32_t lead_term = -1;
    for (int p = 0; p < e->P; ++p)
      if (!cr[p] && ps[p].state == ROLE_LEADER && ps[p].term > lead_term) {
        lead = p;
        lead_term = ps[p].term;
      }
    out[gi] = -1;
    if (lead < 0) continue;
    if (ps[lead].commit < grp.term_start_index[lead]) continue;
    int n_i = 0, n_o = 0;
    for (int p = 0; p < e->P; ++p) {
      n_i += e->vot(gi, p) ? 1 : 0;
      n_o += e->outg(gi, p) ? 1 : 0;
    }
    bool singleton = (n_i == 1 && n_o == 0);
    // Members at a higher term silently IGNORE the lower-term ctx
    // heartbeat (no check_quorum/pre_vote here): neither ack nor depose.
    int a_i = 0, a_o = 0;
    bool any_other = false;  // the quorum check only runs on RECEIVING a
                             // heartbeat response (raft.rs:1805-1818)
    for (int p = 0; p < e->P; ++p) {
      bool acks = (p == lead) ||
                  (!cr[p] && e->member(gi, p) && ps[p].term <= lead_term);
      if (!acks) continue;
      if (p != lead) any_other = true;
      a_i += e->vot(gi, p) ? 1 : 0;
      a_o += e->outg(gi, p) ? 1 : 0;
    }
    bool q = (n_i == 0 || a_i >= n_i / 2 + 1) &&
             (n_o == 0 || a_o >= n_o / 2 + 1);
    if (singleton || (q && any_other)) out[gi] = ps[lead].commit;
  }
}

// Debug: dump agree planes [G, P, P].
void mr_read_agree(void* h, int32_t* out) {
  auto* e = static_cast<Engine*>(h);
  size_t i = 0;
  for (auto& g : e->groups)
    for (int a = 0; a < e->P; ++a)
      for (int b = 0; b < e->P; ++b) out[i++] = g.agree[a][b];
}

}  // extern "C"
