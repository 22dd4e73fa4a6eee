"""ctypes bindings for the native C++ multi-group Raft engine
(csrc/multiraft_engine.cpp), counterpart of `raft_tpu/multiraft/native.py`:
the scalar CPU runtime and the CPU anchor behind `raft_tpu_torch.bench`'s
vs_baseline.

The shared library is built with g++ at -O3 on first use into the
repository's build/ directory (`_build.load_native_engine`: named by a hash
of the sources and flags, written under a temporary name and renamed into
place).  A failed build raises; nothing is written next to the source.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build.load_native_engine()
        lib.mr_create.restype = ctypes.c_void_p
        lib.mr_create.argtypes = [ctypes.c_int32] * 4
        lib.mr_destroy.argtypes = [ctypes.c_void_p]
        lib.mr_step.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mr_set_config.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_uint8)
        ] * 3
        lib.mr_run.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.mr_read_state.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_int32)
        ] * 5
        lib.mr_read_index.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return lib


class NativeMultiRaft:
    """G groups × P peers advancing one protocol round per step() — the C++
    twin of ClusterSim/ScalarCluster (same round semantics, same timeout
    PRNG).  Arrays are group-major: crashed bool[G, P], append_n int[G]."""

    def __init__(self, n_groups: int, n_peers: int, election_tick: int = 10,
                 heartbeat_tick: int = 1):
        assert n_peers <= 16
        self.lib = load_library()
        self.G, self.P = n_groups, n_peers
        self.handle = self.lib.mr_create(
            n_groups, n_peers, election_tick, heartbeat_tick
        )
        if not self.handle:
            raise RuntimeError("mr_create failed")

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.mr_destroy(self.handle)
            self.handle = None

    def set_config(self, voter=None, outgoing=None, learner=None) -> None:
        """Install [G, P] config masks (joint + learner support)."""

        def ptr(a):
            if a is None:
                return None
            a = np.ascontiguousarray(a, dtype=np.uint8)
            self._cfg_refs.append(a)  # keep alive
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

        self._cfg_refs = []
        self.lib.mr_set_config(
            self.handle, ptr(voter), ptr(outgoing), ptr(learner)
        )

    def _bufs(self, crashed, append_n):
        if crashed is None:
            crashed = np.zeros((self.G, self.P), dtype=np.uint8)
        else:
            crashed = np.ascontiguousarray(crashed, dtype=np.uint8)
        if append_n is None:
            append_n = np.zeros((self.G,), dtype=np.int32)
        else:
            append_n = np.ascontiguousarray(append_n, dtype=np.int32)
        return (
            crashed,
            append_n,
            crashed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            append_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    def step(self, crashed=None, append_n=None) -> None:
        c, a, cp, ap = self._bufs(crashed, append_n)
        self.lib.mr_step(self.handle, cp, ap)

    def run(self, rounds: int, crashed=None, append_n=None) -> None:
        c, a, cp, ap = self._bufs(crashed, append_n)
        self.lib.mr_run(self.handle, cp, ap, rounds)

    def read_index(self, crashed=None) -> np.ndarray:
        """Linearizable ReadIndex barrier per group: the index a Safe-mode
        read at the acting leader would return now, or -1 when it cannot
        complete (no leader / no current-term commit / ack quorum blocked).
        Mirrors sim.read_index exactly."""
        if crashed is None:
            crashed = np.zeros((self.G, self.P), dtype=np.uint8)
        else:
            crashed = np.ascontiguousarray(crashed, dtype=np.uint8)
        out = np.zeros((self.G,), dtype=np.int32)
        self.lib.mr_read_index(
            self.handle,
            crashed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def snapshot(self) -> dict:
        shape = (self.G, self.P)
        out = {
            k: np.zeros(shape, dtype=np.int32)
            for k in ("term", "state", "commit", "last_index", "last_term")
        }
        ptrs = [
            out[k].ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            for k in ("term", "state", "commit", "last_index", "last_term")
        ]
        self.lib.mr_read_state(self.handle, *ptrs)
        return out
