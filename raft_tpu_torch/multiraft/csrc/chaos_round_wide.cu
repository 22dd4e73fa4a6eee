// The wide instances of the chaos CUDA kernel, one library a peer count:
// built with -DRAFT_WIDE_P=P, P = 8..15, from the same wrapper and body as
// chaos_round.cu (its ChaosShape gives each P its block storage and launch
// shape).  An instance takes seconds to compile, so each P is a
// translation unit of its own: the wide instances build in parallel, and
// only for the peer counts a caller uses.
#if !defined(RAFT_WIDE_P) || RAFT_WIDE_P < 8 || RAFT_WIDE_P > 15
#error "build with -DRAFT_WIDE_P=P, P in 8..15"
#endif
#define RAFT_WIDE_LIST(CASE) CASE(RAFT_WIDE_P)
#define RAFT_PEER_LIST RAFT_WIDE_LIST
#include "chaos_round.cu"
