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
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas"]

# One lock per library, so two libraries can build at the same time.
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# The last build's compiler output (nvcc -Xptxas -v reports registers and
# spills per kernel) and wall seconds, by library name.
build_log: Dict[str, Tuple[str, float]] = {}

_STEADY_ARGS = [ctypes.c_void_p] * 19 + [ctypes.c_longlong] + [ctypes.c_int] * 4
# 16 operand and 9 output pointers, G, then P, round_base, rounds,
# election_tick and heartbeat_tick.
_CHAOS_ARGS = [ctypes.c_void_p] * 25 + [ctypes.c_longlong] + [ctypes.c_int] * 5


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


def load_steady_cuda() -> ctypes.CDLL:
    """The CUDA steady-round library (built with nvcc for sm_90a at first
    use); its `steady_round_launch` takes the 19 tensor pointers, G, P,
    rounds, election_tick, heartbeat_tick and the CUDA stream."""

    def build():
        return _build(
            "steady_round", [_nvcc()], [CSRC / "steady_round.cu"], NVCC_FLAGS
        )

    lib = _load("steady_round", build)
    lib.steady_round_launch.argtypes = _STEADY_ARGS + [ctypes.c_void_p]
    lib.steady_round_launch.restype = ctypes.c_int
    return lib


def load_steady_host() -> ctypes.CDLL:
    """The host build of the same kernel body (g++), for the CPU tests."""

    def build():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: cannot build the host shim")
        return _build(
            "steady_host", [gxx], [CSRC / "steady_host.cpp"], GXX_FLAGS
        )

    lib = _load("steady_host", build)
    lib.steady_round_host.argtypes = _STEADY_ARGS
    lib.steady_round_host.restype = ctypes.c_int
    return lib


def load_chaos_cuda() -> ctypes.CDLL:
    """The CUDA chaos-round library (built with nvcc for sm_90a at first
    use); its `chaos_round_launch` takes the 25 tensor pointers, G, P,
    round_base, rounds, election_tick, heartbeat_tick and the CUDA
    stream."""

    def build():
        return _build(
            "chaos_round", [_nvcc()], [CSRC / "chaos_round.cu"], NVCC_FLAGS
        )

    lib = _load("chaos_round", build)
    lib.chaos_round_launch.argtypes = _CHAOS_ARGS + [ctypes.c_void_p]
    lib.chaos_round_launch.restype = ctypes.c_int
    return lib


def load_chaos_host() -> ctypes.CDLL:
    """The host build of the chaos kernel body (g++), for the CPU tests."""

    def build():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: cannot build the host shim")
        return _build("chaos_host", [gxx], [CSRC / "chaos_host.cpp"], GXX_FLAGS)

    lib = _load("chaos_host", build)
    lib.chaos_round_host.argtypes = _CHAOS_ARGS
    lib.chaos_round_host.restype = ctypes.c_int
    return lib
