"""Build and load the port's hand-written kernels.

The CUDA sources under `csrc/` have a plain C interface and are built with
`nvcc` into a shared library that `ctypes` loads (no PyTorch headers, so a
build takes seconds).  The same kernel body also builds with g++ into a host
library, which the CPU tests use to check the kernel's arithmetic without a
card.  Both land in the repository's `build/` directory, named by a hash of
their sources and flags, so an edit to a source rebuilds and an unchanged
tree reuses the library.  Builds are written to a temporary name and renamed
into place, so concurrent processes never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
# The host builds only check the kernels' arithmetic on small planes: -O0
# builds the wide damped body in seconds where -O2 takes over half a minute.
GXX_FLAGS = ["-std=c++17", "-O0", "-shared", "-fPIC", "-Wno-unknown-pragmas"]
# The native CPU anchor (csrc/multiraft_engine.cpp) is the baseline the
# bench's vs_baseline divides by, so it builds optimised, as the reference
# engine does.
NATIVE_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]
# Peer counts above this are built from the *_wide sources (P = 8..15, and
# the steady kernel's runtime-P instance up to its cap).
NARROW_PEERS = 7

# One lock per library, so two libraries can build at the same time.
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# The last build's compiler output (nvcc -Xptxas -v reports registers and
# spills per kernel) and wall seconds, by library name.
build_log: Dict[str, Tuple[str, float]] = {}

# Each launcher takes its operand and output pointers, then the
# ticks_since_commit pointers tsc and tsc_out (null without health), G, and
# its int parameters ending in with_health.
# 13 operands, 6 outputs; P, rounds, election_tick, heartbeat_tick.
_STEADY_ARGS = [ctypes.c_void_p] * 21 + [ctypes.c_longlong] + [ctypes.c_int] * 5
# 16 operands, 9 outputs; P, round_base, rounds, election_tick,
# heartbeat_tick.
_CHAOS_ARGS = [ctypes.c_void_p] * 27 + [ctypes.c_longlong] + [ctypes.c_int] * 6
# 17 operands, 10 outputs; P, round_base, rounds, election_tick,
# heartbeat_tick, with_cq and with_loss.
_DAMPED_ARGS = [ctypes.c_void_p] * 29 + [ctypes.c_longlong] + [ctypes.c_int] * 8
# The chaos and damped launchers, and their hosts' `*_round_host_at`, take
# the global id of the first group (group_base, the loss draw's group key)
# after with_health.
_BASE = [ctypes.c_longlong]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from csrc/ at first use and need the CUDA toolkit"
    )


def _digest(sources: List[Path], flags: List[str]) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*")):  # headers included
        if path.suffix in (".cu", ".cuh", ".cpp", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(str(s) for s in sources).encode())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _build(name: str, cmd: List[str], sources: List[Path], flags: List[str]) -> Path:
    out = BUILD_DIR / f"lib{name}-{_digest(sources, flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            cmd + flags + ["-I", str(CSRC), "-o", tmp] + [str(s) for s in sources],
            capture_output=True,
            text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({cmd[0]} exit {res.returncode}):\n"
                f"{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log[name] = (res.stdout + res.stderr, time.perf_counter() - t0)
    return out


def _load(name: str, build_fn) -> ctypes.CDLL:
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_fn()))
            _loaded[name] = lib
        return lib


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: cannot build the host shim")
    return found


def _library(name: str, source: str, cuda: bool, fn: str, argtypes,
             defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once) and load csrc/`source` as library `name`: with nvcc for
    sm_90a when `cuda`, else with g++, with the `-D` flags `defines`;
    declare its C function `fn`."""

    def build():
        compiler, flags = ([_nvcc()], NVCC_FLAGS) if cuda else ([_gxx()], GXX_FLAGS)
        return _build(name, compiler, [CSRC / source], flags + list(defines))

    lib = _load(name, build)
    func = getattr(lib, fn)
    func.argtypes = argtypes
    func.restype = ctypes.c_int
    return lib


def _cuda_kernel(kind: str, P: int, argtypes) -> ctypes.CDLL:
    """The CUDA library of kernel `kind` (steady, chaos, damped) that holds
    P's instances, its `{kind}_round_launch` declared: for P <= NARROW_PEERS
    csrc/{kind}_round.cu; past it one library a P, csrc/{kind}_round_wide.cu
    built with -DRAFT_WIDE_P=P (for the steady kernel every P > 15 shares
    the runtime-P instance, RAFT_WIDE_P=16)."""
    fn = f"{kind}_round_launch"
    if P <= NARROW_PEERS:
        return _library(f"{kind}_round", f"{kind}_round.cu", True, fn, argtypes)
    wide = min(P, 16)
    return _library(f"{kind}_round_p{wide}", f"{kind}_round_wide.cu", True, fn,
                    argtypes, (f"-DRAFT_WIDE_P={wide}",))


def _host_kernel(kind: str, P: int, argtypes, base: bool = False) -> ctypes.CDLL:
    """The g++ build of kernel `kind`'s body holding P's instances:
    csrc/{kind}_host.cpp for P <= NARROW_PEERS, else csrc/{kind}_host_wide.cpp
    (every wide P in one library); its `{kind}_round_host` declared, and
    with `base` also `{kind}_round_host_at`, which takes group_base last."""
    name = f"{kind}_host" if P <= NARROW_PEERS else f"{kind}_host_wide"
    lib = _library(name, name + ".cpp", False, f"{kind}_round_host", argtypes)
    if base:
        func = getattr(lib, f"{kind}_round_host_at")
        func.argtypes = argtypes + _BASE
        func.restype = ctypes.c_int
    return lib


def load_steady_cuda(P: int = 1) -> ctypes.CDLL:
    """The CUDA steady-round library holding P's instances; its
    `steady_round_launch` takes the 21 tensor pointers, G, P, rounds,
    election_tick, heartbeat_tick, with_health and the CUDA stream."""
    return _cuda_kernel("steady", P, _STEADY_ARGS + [ctypes.c_void_p])


def load_steady_host(P: int = 1) -> ctypes.CDLL:
    """The host build of the same kernel body (g++), for the CPU tests."""
    return _host_kernel("steady", P, _STEADY_ARGS)


def load_chaos_cuda(P: int = 1) -> ctypes.CDLL:
    """The CUDA chaos-round library holding P's instances; its
    `chaos_round_launch` takes the 27 tensor pointers, G, P, round_base,
    rounds, election_tick, heartbeat_tick, with_health, group_base and the
    CUDA stream."""
    return _cuda_kernel("chaos", P, _CHAOS_ARGS + _BASE + [ctypes.c_void_p])


def load_chaos_host(P: int = 1) -> ctypes.CDLL:
    """The host build of the chaos kernel body (g++), for the CPU tests:
    `chaos_round_host` takes the launcher's arguments up to with_health,
    `chaos_round_host_at` group_base after them."""
    return _host_kernel("chaos", P, _CHAOS_ARGS, base=True)


def load_damped_cuda(P: int = 1) -> ctypes.CDLL:
    """The CUDA damped-round library holding P's instances; its
    `damped_round_launch` takes the 29 tensor pointers (the loss_rate
    pointer null without loss), G, P, round_base, rounds, election_tick,
    heartbeat_tick, with_cq, with_loss, with_health, group_base and the
    CUDA stream."""
    return _cuda_kernel("damped", P, _DAMPED_ARGS + _BASE + [ctypes.c_void_p])


def load_damped_host(P: int = 1) -> ctypes.CDLL:
    """The host build of the damped kernel body (g++), for the CPU tests:
    `damped_round_host` takes the launcher's arguments up to with_health,
    `damped_round_host_at` group_base after them."""
    return _host_kernel("damped", P, _DAMPED_ARGS, base=True)


def load_graph_cuda() -> ctypes.CDLL:
    """The CUDA-graph helper library (csrc/graph_cond.cu): its
    `graph_if_node` takes the capturing stream, the device bool that picks
    the branch and the branch's cudaGraph_t; `graph_node_count` a
    cudaGraph_t and a pointer to the count."""
    lib = _library("graph_cond", "graph_cond.cu", True, "graph_if_node",
                   [ctypes.c_void_p] * 3)
    lib.graph_node_count.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_ulonglong)]
    lib.graph_node_count.restype = ctypes.c_int
    return lib


def load_native_engine() -> ctypes.CDLL:
    """The native multi-group Raft engine (csrc/multiraft_engine.cpp) built
    with g++ at -O3 into build/; a failed build raises RuntimeError.  The
    caller declares its C functions (multiraft/native.py)."""

    def build():
        return _build("multiraft_engine", [_gxx()],
                      [CSRC / "multiraft_engine.cpp"], NATIVE_FLAGS)

    return _load("multiraft_engine", build)
