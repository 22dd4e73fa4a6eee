"""The port's checkpoints (raft_tpu_torch/multiraft/checkpoint.py) on the
CPU:

  * a run interrupted by save_state / load_state resumes bit-exactly, and
    hard_states is the {term, vote, commit} view;
  * every registry row of every family (state, blackbox, read, reconfig)
    round-trips with its dtype, perturbed one row at a time, as
    tests/test_planes_registry.py does for the reference; a missing plane,
    an unknown version and the wrong kind of file each raise ValueError;
  * the files cross between the packages: a file written by raft_tpu loads
    into the port and one written by the port into raft_tpu, every array
    equal in value and dtype, and both packages write the same keys, dtypes
    and values for the same planes;
  * the damped compiled scan with a checkpoint mid-run
    (tests/test_checkpoint.py's test_run_compiled_damped_packed_carry_and_
    checkpoint): run_compiled(12), save, load, run_compiled(12) equals
    24 rounds of run_round."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raft_tpu.multiraft import checkpoint as jckpt
from raft_tpu.multiraft import reconfig as jrc
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft import workload as jwl
from raft_tpu_torch.multiraft import checkpoint, planes, reconfig, workload
from raft_tpu_torch.multiraft import sim as tsim

G, PEERS = 4, 3
_ALL_FLAGS = dict(check_quorum=True, pre_vote=True, transfer=True)
_FAMILIES = ("state", "blackbox", "read", "reconfig")
_CASES = [(fam, name) for fam in _FAMILIES for name in planes.checkpoint_fields(fam)]


def _distinct(t: torch.Tensor, salt: int) -> torch.Tensor:
    """A salt-dependent pattern of t's shape and dtype, distinct from zeros
    and from every other salt."""
    n = t.numel()
    if t.dtype == torch.bool:
        return torch.from_numpy(((np.arange(n) + salt) % 3 == 0).reshape(tuple(t.shape)))
    vals = (np.arange(n, dtype=np.int64) * 7 + 11 * salt + 3) % 89
    return torch.from_numpy(vals.reshape(tuple(t.shape)).astype(np.int32))


class _ReadTriple:
    """save_read_state's (ReadCarry, read_stats, lat_hist) as one object
    with the read family's fields."""

    def __init__(self, g=G):
        rcar = workload.init_read_carry(g, "cpu")
        self.pending_mode = rcar.pending_mode
        self.pending_since = rcar.pending_since
        self.read_stats = torch.zeros((workload.N_READ_STATS,), dtype=torch.int32)
        self.lat_hist = torch.zeros((workload.N_LAT_BUCKETS,), dtype=torch.int32)

    def _replace(self, **kw):
        out = _ReadTriple.__new__(_ReadTriple)
        out.__dict__.update(self.__dict__, **kw)
        return out


def _carrier(family):
    if family == "state":
        return tsim.init_state(tsim.SimConfig(G, PEERS, **_ALL_FLAGS), device="cpu")
    if family == "blackbox":
        return tsim.init_blackbox(tsim.SimConfig(G, PEERS, blackbox=True), "cpu")
    if family == "read":
        return _ReadTriple()
    return reconfig.init_reconfig_state(
        tsim.init_state(tsim.SimConfig(G, PEERS), device="cpu")
    )


def _save(family, carrier, path):
    if family == "state":
        checkpoint.save_state(carrier, path)
    elif family == "blackbox":
        checkpoint.save_blackbox_state(carrier, path)
    elif family == "read":
        checkpoint.save_read_state(
            workload.ReadCarry(carrier.pending_mode, carrier.pending_since),
            carrier.read_stats, carrier.lat_hist, path,
        )
    else:
        checkpoint.save_reconfig_state(carrier, path)


def _load(family, path):
    if family == "read":
        (pm, ps), stats, hist = checkpoint.load_read_state(path, "cpu")
        return _ReadTriple()._replace(pending_mode=pm, pending_since=ps,
                                      read_stats=stats, lat_hist=hist)
    return {
        "state": checkpoint.load_state,
        "blackbox": checkpoint.load_blackbox_state,
        "reconfig": checkpoint.load_reconfig_state,
    }[family](path, "cpu")


def _value(carrier, name):
    v = getattr(carrier, name)
    return v if isinstance(v, torch.Tensor) or v is None else np.asarray(v)


def _assert_fields_equal(want, got, fields):
    for f in fields:
        a, b = _value(want, f), _value(got, f)
        assert (a is None) == (b is None), f
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f"{f}: {a.dtype} != {b.dtype}"
            assert torch.equal(a, b), f
        elif a is not None:
            assert int(a) == int(b), f


# --- resume and hard state ---------------------------------------------------


def test_checkpoint_resume_bit_exact(tmp_path):
    cfg = tsim.SimConfig(n_groups=16, n_peers=3)
    app = torch.ones(16, dtype=torch.int32)
    a = tsim.ClusterSim(cfg, device="cpu")
    a.run(60, None, app)
    b = tsim.ClusterSim(cfg, device="cpu")
    b.run(25, None, app)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(b.state, path)
    c = tsim.ClusterSim(cfg, device="cpu")
    c.state = checkpoint.load_state(path, "cpu")
    c.run(35, None, app)
    _assert_fields_equal(a.state, c.state, tsim.SimState._fields)


def test_hard_states_shape():
    cfg = tsim.SimConfig(n_groups=8, n_peers=3)
    s = tsim.ClusterSim(cfg, device="cpu")
    s.run(30, None, torch.ones(8, dtype=torch.int32))
    hs = checkpoint.hard_states(s.state)
    assert set(hs) == {"term", "vote", "commit"}
    for v in hs.values():
        assert v.shape == (3, 8) and v.dtype == np.int32
    assert (hs["term"] >= 1).all() and (hs["commit"].max(axis=0) >= 1).all()


# --- per-row round trips and corruption ---------------------------------------


@pytest.mark.parametrize("family,field", _CASES, ids=[f"{f}-{n}" for f, n in _CASES])
def test_checkpoint_round_trips_every_registry_row(tmp_path, family, field):
    carrier = _carrier(family)
    salt = planes.checkpoint_fields(family).index(field) + 1
    old = getattr(carrier, field)
    new = _distinct(old, salt) if isinstance(old, torch.Tensor) else 37 + salt
    carrier = carrier._replace(**{field: new})
    path = str(tmp_path / f"{family}.npz")
    _save(family, carrier, path)
    _assert_fields_equal(carrier, _load(family, path), planes.checkpoint_fields(family))


@pytest.mark.parametrize("family", _FAMILIES)
def test_checkpoint_corruption_is_loud(tmp_path, family):
    path = str(tmp_path / f"{family}.npz")
    _save(family, _carrier(family), path)
    victim = "commit" if family == "state" else planes.checkpoint_fields(family)[-1]
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != victim}
    trunc = str(tmp_path / "trunc.npz")
    np.savez(trunc, **arrays)
    with pytest.raises(ValueError, match="missing"):
        _load(family, trunc)
    marker = {"state": "__version__", "blackbox": "__blackbox_version__",
              "read": "__read_version__", "reconfig": "__reconfig_version__"}[family]
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays[marker] = np.asarray(999)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="999"):
        _load(family, bad)
    if family != "state":
        other = str(tmp_path / "state.npz")
        checkpoint.save_state(tsim.init_state(tsim.SimConfig(2, 3), device="cpu"), other)
        with pytest.raises(ValueError, match="missing version marker"):
            _load(family, other)


def test_flag_off_optional_planes_skip_and_restore_as_none(tmp_path):
    st = tsim.init_state(tsim.SimConfig(G, PEERS), device="cpu")
    path = str(tmp_path / "plain.npz")
    checkpoint.save_state(st, path)
    with np.load(path) as data:
        assert not set(planes.optional_sim_fields()) & set(data.files)
    back = checkpoint.load_state(path, "cpu")
    for f in planes.optional_sim_fields():
        assert getattr(back, f) is None
    _assert_fields_equal(st, back, tsim.SimState._fields)


# --- crossing between the packages -------------------------------------------


def _pairs(seed):
    """(JAX carrier, port carrier) of each family, the same random planes."""
    rng = np.random.RandomState(seed)
    cfg = tsim.SimConfig(G, PEERS, blackbox=True, **_ALL_FLAGS)
    jcfg = jsim.SimConfig(**cfg._asdict())
    jst0, jbb0 = jsim.init_state(jcfg), jsim.init_blackbox(jcfg)

    def rand(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return rng.rand(*a.shape) < 0.5
        if a.dtype == np.uint32:
            return rng.randint(0, 1 << 15, a.shape).astype(np.uint32)
        return rng.randint(-5, 1000, a.shape).astype(a.dtype)

    st = {f: rand(getattr(jst0, f)) for f in jsim.SimState._fields}
    bb = {f: rand(getattr(jbb0, f)) for f in jsim.BlackboxState._fields}
    rst = {f: rand(np.zeros((PEERS, G), bool) if f.startswith("prev") else np.zeros(G, np.int32))
           for f in jrc.ReconfigState._fields}
    rd = {"pending_mode": rand(np.zeros(G, np.int32)), "pending_since": rand(np.zeros(G, np.int32)),
          "read_stats": rand(np.zeros(workload.N_READ_STATS, np.int32)),
          "lat_hist": rand(np.zeros(workload.N_LAT_BUCKETS, np.int32))}
    j = {
        "state": jsim.SimState(**{k: jnp.asarray(v) for k, v in st.items()}),
        "blackbox": jsim.BlackboxState(**{k: jnp.asarray(v) for k, v in bb.items()}),
        "reconfig": jrc.ReconfigState(**{k: jnp.asarray(v) for k, v in rst.items()}),
        "read": (jwl.ReadCarry(jnp.asarray(rd["pending_mode"]), jnp.asarray(rd["pending_since"])),
                 jnp.asarray(rd["read_stats"]), jnp.asarray(rd["lat_hist"])),
    }
    t = {
        "state": tsim.state_from_numpy(st, "cpu"),
        "blackbox": tsim.blackbox_from_numpy(bb, "cpu"),
        "reconfig": reconfig.ReconfigState(**{k: torch.from_numpy(v) for k, v in rst.items()}),
        "read": (workload.ReadCarry(torch.from_numpy(rd["pending_mode"]),
                                    torch.from_numpy(rd["pending_since"])),
                 torch.from_numpy(rd["read_stats"]), torch.from_numpy(rd["lat_hist"])),
    }
    return j, t


_SAVERS = {
    "state": ("save_state", "load_state"),
    "blackbox": ("save_blackbox_state", "load_blackbox_state"),
    "reconfig": ("save_reconfig_state", "load_reconfig_state"),
    "read": ("save_read_state", "load_read_state"),
}


def _write(mod, family, obj, path):
    save = getattr(mod, _SAVERS[family][0])
    save(*obj, path) if family == "read" else save(obj, path)


def _files_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _as_numpy(family, loaded):
    """A loaded family as {field: numpy}, meta as the uint32 words."""
    if family == "read":
        (pm, ps), stats, hist = loaded
        vals = dict(pending_mode=pm, pending_since=ps, read_stats=stats, lat_hist=hist)
    elif family == "blackbox" and isinstance(loaded.meta, torch.Tensor):
        return tsim.blackbox_to_numpy(loaded)
    else:
        vals = {f: getattr(loaded, f) for f in type(loaded)._fields}
    return {k: (None if v is None else
                v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in vals.items()}


@pytest.mark.parametrize("family", _FAMILIES)
def test_checkpoints_cross_between_the_packages(tmp_path, family):
    j, t = _pairs(seed=_FAMILIES.index(family) + 1)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    _write(jckpt, family, j[family], jpath)
    _write(checkpoint, family, t[family], tpath)
    _files_equal(jpath, tpath)
    load = _SAVERS[family][1]
    into_port = getattr(checkpoint, load)(jpath, "cpu")
    into_jax = getattr(jckpt, load)(tpath)
    want = _as_numpy(family, getattr(jckpt, load)(jpath))
    for got in (_as_numpy(family, into_port), _as_numpy(family, into_jax)):
        assert want.keys() == got.keys()
        for k, w in want.items():
            g = got[k]
            if w is None:
                assert g is None, k
                continue
            w, g = np.asarray(w), np.asarray(g)
            assert w.dtype == g.dtype or k == "round_idx", (k, w.dtype, g.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


# --- the damped compiled scan with a checkpoint -------------------------------


def test_run_compiled_damped_packed_carry_and_checkpoint(tmp_path):
    cfg = tsim.SimConfig(n_groups=33, n_peers=3, check_quorum=True, pre_vote=True,
                         blackbox=True)
    app = torch.ones(33, dtype=torch.int32)
    a = tsim.ClusterSim(cfg, device="cpu")
    for _ in range(24):
        a.run_round(None, app)
    b = tsim.ClusterSim(cfg, device="cpu")
    b.run_compiled(12, append_n=app)
    spath, bpath = str(tmp_path / "damped-mid.npz"), str(tmp_path / "bb-mid.npz")
    checkpoint.save_state(b.state, spath)
    checkpoint.save_blackbox_state(b._blackbox, bpath)
    c = tsim.ClusterSim(cfg, device="cpu")
    c.state = checkpoint.load_state(spath, "cpu")
    c._blackbox = checkpoint.load_blackbox_state(bpath, "cpu")
    assert c.state.recent_active is not None and c.state.recent_active.dtype == torch.bool
    c.run_compiled(12, append_n=app)
    _assert_fields_equal(a.state, c.state, tsim.SimState._fields)
    _assert_fields_equal(a._blackbox, c._blackbox, tsim.BlackboxState._fields)
