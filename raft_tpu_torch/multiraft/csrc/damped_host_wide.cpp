// The wide instances of the damped host build: P = 8 through 15 from the
// same wrapper and body as damped_host.cpp (RAFT_FOR_EACH_WIDE_P).  A
// library of its own, so it builds beside the narrow one.
#define RAFT_PEER_LIST RAFT_FOR_EACH_WIDE_P
#include "damped_host.cpp"
