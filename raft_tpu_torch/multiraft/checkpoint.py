"""Checkpoint and resume for the batched MultiRaft device state.

Counterpart of `raft_tpu/multiraft/checkpoint.py` (all of it): a
whole-batch snapshot, one `.npz` a family, each plane downloaded once.
Every round is deterministic, so a resumed run is bit-identical to an
uninterrupted one.  The four families and their field sets come from the
plane registry (`planes.checkpoint_fields`):

  state     every SimState plane (the flag-gated ones, recent_active and
            transferee, skipped when absent and restored as None),
            `__version__`;
  reconfig  reconfig.ReconfigState, the in-flight conf-op carry,
            `__reconfig_version__`;
  read      workload.ReadCarry and the run's read stats and latency
            histogram, `__read_version__`;
  blackbox  sim.BlackboxState, `__blackbox_version__`.

The files are the reference's, key for key and dtype for dtype: int32 and
bool planes, the black box's meta words as uint32 (sim.blackbox_to_numpy)
and its round_idx as a 0-d int32 array.  So a file written by `raft_tpu`
loads here and the reverse.  Each write goes to a temporary file in the
target's directory, is fsynced and renamed into place.  A loader raises
ValueError on a missing version marker (the wrong kind of file), an
unsupported version or a missing plane (a corrupt or truncated file).  The
loaders put the planes on `cuda` unless `device` says otherwise.

`hard_states` is the durable per-peer view {term, vote, commit}[P, G].
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import numpy as np
import torch

from . import planes
from .platform import DeviceLike, resolve_device
from .sim import (
    BlackboxState,
    SimState,
    blackbox_from_numpy,
    blackbox_to_numpy,
    state_from_numpy,
)

_FORMAT_VERSION = 1
_RECONFIG_FORMAT_VERSION = 1
_READ_FORMAT_VERSION = 1
_BLACKBOX_FORMAT_VERSION = 1

# The persisted read-protocol planes, in registry save order: the
# outstanding-read carry plus the run's accumulators.
_READ_FIELDS = planes.checkpoint_fields("read")
_BLACKBOX_FIELDS = planes.checkpoint_fields("blackbox")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _write(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Atomically write `arrays` as an .npz at `path`: a temporary file in
    the same directory, flushed and fsynced, then renamed into place."""
    dir_ = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=dir_, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _read(path: str, marker: str, version: int, what: str, fields) -> Dict[str, np.ndarray]:
    """The `fields` of a sidecar checkpoint, after its version check."""
    with np.load(path) as data:
        if marker not in data:
            raise ValueError(
                f"{path!r} is not a {what} checkpoint (missing version "
                "marker — did you pass a SimState checkpoint?)"
            )
        got = int(data[marker])
        if got != version:
            raise ValueError(f"unsupported {what} checkpoint version {got}")
        out = {}
        for name in fields:
            if name not in data:
                raise ValueError(
                    f"{what} checkpoint {path!r} is missing plane {name!r} "
                    "(corrupt or truncated file)"
                )
            out[name] = data[name]
    return out


def _tensor(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    # A copy: np.load's arrays may be read-only views.
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def save_state(state: SimState, path: str) -> None:
    """Atomically write every present SimState plane to `path` (.npz), in
    the registry's "state" order; absent optional planes are skipped."""
    arrays = {
        name: _numpy(value)
        for name in planes.checkpoint_fields("state")
        if (value := getattr(state, name)) is not None
    }
    arrays["__version__"] = np.asarray(_FORMAT_VERSION)
    _write(path, arrays)


def load_state(path: str, device: DeviceLike = None) -> SimState:
    """Load a state written by save_state (by either package) onto
    `device` (`cuda` unless it says otherwise)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        version = int(data["__version__"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        # Only flag-gated registry rows are optional planes.
        optional = set(planes.optional_sim_fields())
        arrays = {}
        for name in planes.checkpoint_fields("state"):
            if name not in data:
                if name in optional:
                    continue
                raise ValueError(
                    f"checkpoint {path!r} is missing required plane "
                    f"{name!r} (corrupt or truncated file)"
                )
            arrays[name] = data[name]
    return state_from_numpy(arrays, dev)


def save_reconfig_state(rstate, path: str) -> None:
    """Atomically write a reconfig.ReconfigState (the in-flight conf-op
    carry) beside a SimState checkpoint, so a membership-churn run resumes
    mid-plan bit-identically (the schedule recompiles from the plan)."""
    arrays = {
        name: _numpy(getattr(rstate, name))
        for name in planes.checkpoint_fields("reconfig")
    }
    arrays["__reconfig_version__"] = np.asarray(_RECONFIG_FORMAT_VERSION)
    _write(path, arrays)


def load_reconfig_state(path: str, device: DeviceLike = None):
    """Load a reconfig carry written by save_reconfig_state onto
    `device`."""
    from .reconfig import ReconfigState

    dev = resolve_device(device)
    arrays = _read(path, "__reconfig_version__", _RECONFIG_FORMAT_VERSION,
                   "reconfig", planes.checkpoint_fields("reconfig"))
    return ReconfigState(**{n: _tensor(a, dev) for n, a in arrays.items()})


def save_read_state(rcar, read_stats, lat_hist, path: str) -> None:
    """Atomically write the client-read protocol carry: workload.ReadCarry's
    outstanding-read planes, the [workload.N_READ_STATS] stats vector and
    the [workload.N_LAT_BUCKETS] latency histogram."""
    arrays = {
        "pending_mode": _numpy(rcar.pending_mode),
        "pending_since": _numpy(rcar.pending_since),
        "read_stats": _numpy(read_stats),
        "lat_hist": _numpy(lat_hist),
        "__read_version__": np.asarray(_READ_FORMAT_VERSION),
    }
    _write(path, arrays)


def load_read_state(path: str, device: DeviceLike = None):
    """Load a read-protocol carry written by save_read_state onto
    `device`: (workload.ReadCarry, read_stats, lat_hist)."""
    from .workload import ReadCarry

    dev = resolve_device(device)
    arrays = _read(path, "__read_version__", _READ_FORMAT_VERSION,
                   "read-state", _READ_FIELDS)
    t = {n: _tensor(a, dev) for n, a in arrays.items()}
    return (
        ReadCarry(pending_mode=t["pending_mode"], pending_since=t["pending_since"]),
        t["read_stats"],
        t["lat_hist"],
    )


def save_blackbox_state(blackbox: BlackboxState, path: str) -> None:
    """Atomically write the black-box flight recorder beside a SimState
    checkpoint: the ring windows, the first-trip plane and the round
    counter, meta as uint32 and round_idx as a 0-d int32 array."""
    host = blackbox_to_numpy(blackbox)
    host["round_idx"] = np.asarray(host["round_idx"], dtype=np.int32)
    arrays = {name: host[name] for name in _BLACKBOX_FIELDS}
    arrays["__blackbox_version__"] = np.asarray(_BLACKBOX_FORMAT_VERSION)
    _write(path, arrays)


def load_blackbox_state(path: str, device: DeviceLike = None) -> BlackboxState:
    """Load a black-box recorder written by save_blackbox_state onto
    `device`."""
    arrays = _read(path, "__blackbox_version__", _BLACKBOX_FORMAT_VERSION,
                   "black-box", _BLACKBOX_FIELDS)
    return blackbox_from_numpy(arrays, resolve_device(device))


def hard_states(state: SimState) -> Dict[str, np.ndarray]:
    """The durable per-peer raft state {term, vote, commit}, shaped [P,
    G] (reference: proto/proto/eraftpb.proto:94-98)."""
    return {
        "term": _numpy(state.term),
        "vote": _numpy(state.vote),
        "commit": _numpy(state.commit),
    }
