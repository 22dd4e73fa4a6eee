// The wide instances of the steady CUDA kernel below the switch, one
// library a peer count: built with -DRAFT_WIDE_P=P, P = 8..12 gives P's two
// instances (with_health off and on) from the same wrapper and body as
// steady_round.cu.  One translation unit a P, so the wide instances build
// in parallel, and only for the peer counts a caller uses.  From the switch
// (_build.STEADY_WARP_PEERS) the steady kernel runs steady_round_warp.cu,
// half a warp or a warp a group.
#if !defined(RAFT_WIDE_P) || RAFT_WIDE_P < 8 || RAFT_WIDE_P > 12
#error "build with -DRAFT_WIDE_P=P, P in 8..12"
#endif
#define RAFT_WIDE_LIST(CASE) CASE(RAFT_WIDE_P)
#define RAFT_PEER_LIST RAFT_WIDE_LIST
#include "steady_round.cu"
