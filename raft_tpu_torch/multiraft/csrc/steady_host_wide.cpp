// The wide instances of the steady host build: P = 8 through 15 from the
// same wrapper and body as steady_host.cpp (RAFT_FOR_EACH_WIDE_P), and the
// one instance for any P from 16 to raft_steady::kSteadyCap, whose peer
// count is a runtime value and whose per-peer arrays live in local memory.
// A library of its own, so it builds beside the narrow one.
#define RAFT_PEER_LIST RAFT_FOR_EACH_WIDE_P
#define RAFT_STEADY_RUNTIME_P
#include "steady_host.cpp"
