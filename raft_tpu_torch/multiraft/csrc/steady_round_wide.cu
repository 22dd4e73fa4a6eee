// The wide instances of the steady CUDA kernel, one library a peer count:
// built with -DRAFT_WIDE_P=P, P = 8..15 gives P's two instances (with_health
// off and on) from the same wrapper and body as steady_round.cu, and P = 16
// the one instance for any P from 16 to raft_steady::kSteadyCap, whose peer
// count is a runtime value and whose per-peer arrays live in local memory.
// One translation unit a P, so the wide instances build in parallel, and
// only for the peer counts a caller uses.
#if !defined(RAFT_WIDE_P) || RAFT_WIDE_P < 8 || RAFT_WIDE_P > 16
#error "build with -DRAFT_WIDE_P=P, P in 8..16"
#endif
#if RAFT_WIDE_P == 16
#define RAFT_STEADY_RUNTIME_P
#define RAFT_WIDE_LIST(CASE)
#else
#define RAFT_WIDE_LIST(CASE) CASE(RAFT_WIDE_P)
#endif
#define RAFT_PEER_LIST RAFT_WIDE_LIST
#include "steady_round.cu"
