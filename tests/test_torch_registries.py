"""The port's plane and schedule registries (raft_tpu_torch/multiraft/
planes.py and schedules.py) are the reference's, row for row, and mirror
the port's own NamedTuples: the owners' field tuples, the checkpoint
families and the compiled schedules' field order."""

import pytest

from raft_tpu.multiraft import planes as jplanes
from raft_tpu.multiraft import schedules as jschedules
from raft_tpu_torch.multiraft import chaos, planes, reconfig, schedules, sim, workload


@pytest.mark.parametrize(
    "i", range(len(jplanes.REGISTRY)),
    ids=[f"{r.owner}.{r.name}" for r in jplanes.REGISTRY],
)
def test_plane_rows_equal_reference(i):
    assert tuple(planes.REGISTRY[i]) == tuple(jplanes.REGISTRY[i])


@pytest.mark.parametrize(
    "i", range(len(jschedules.SCHEDULES)),
    ids=[f"{r.family}.{r.name}" for r in jschedules.SCHEDULES],
)
def test_schedule_rows_equal_reference(i):
    assert tuple(schedules.SCHEDULES[i]) == tuple(jschedules.SCHEDULES[i])


def test_registry_tables_and_derivations_equal_reference():
    assert len(planes.REGISTRY) == len(jplanes.REGISTRY)
    assert len(schedules.SCHEDULES) == len(jschedules.SCHEDULES)
    assert [tuple(f) for f in schedules.FAMILIES] == [tuple(f) for f in jschedules.FAMILIES]
    assert [tuple(v) for v in schedules.RUNNER_VARIANTS] == [
        tuple(v) for v in jschedules.RUNNER_VARIANTS
    ]
    assert schedules.PHASES == jschedules.PHASES
    assert schedules.PHASE_TOLERANCE_PCT == jschedules.PHASE_TOLERANCE_PCT
    assert schedules.gating_flags() == jschedules.gating_flags()
    assert schedules.packing_families() == jschedules.packing_families()
    for fam in ("state", "blackbox", "read", "reconfig"):
        assert planes.checkpoint_fields(fam) == jplanes.checkpoint_fields(fam)
    for name in ("sim_state_fields", "optional_sim_fields", "packed_carry_fields",
                 "steady_defuse_flags", "gating_flags"):
        assert getattr(planes, name)() == getattr(jplanes, name)(), name
    for name in ("COUNTER_PLANES", "HEALTH_PLANES", "PACKED_PLANES", "DAMPING_PLANES",
                 "TRANSFER_PLANES", "BLACKBOX_PLANES", "READ_PLANES", "BUDGET_PER_GROUP",
                 "WRAP_SHIFT", "DECLARED_BOUNDED"):
        assert getattr(planes, name) == getattr(jplanes, name), name


def test_plane_rows_mirror_the_ports_field_tuples():
    """Each owner's rows, in order, are the port's NamedTuple fields."""
    assert sim.SimState._fields == planes.sim_state_fields()
    assert planes.optional_sim_fields() == ("recent_active", "transferee")
    assert sim.BlackboxState._fields == tuple(
        r.name for r in planes.rows(owner="BlackboxState")
    )
    assert reconfig.ReconfigState._fields == tuple(
        r.name for r in planes.rows(owner="ReconfigState")
    )
    # The read family holds the ReadCarry planes, then the run's read stats
    # and latency histogram, as the reference's does.
    carry_rows = tuple(r.name for r in planes.rows(family="read-carry"))
    assert carry_rows == workload.ReadCarry._fields + ("read_stats", "lat_hist")
    assert planes.checkpoint_fields("read") == carry_rows
    assert planes.checkpoint_fields("state") == sim.SimState._fields
    assert planes.packed_carry_fields() == ("recent_active",)
    for f in planes.gating_flags():
        assert f in sim.SimConfig._fields


def test_schedule_rows_mirror_the_ports_compiled_tuples():
    """array_fields(f) is the port's compiled tuple's field order, less
    the trailing static n_peers."""
    for fam, typ in (("chaos", chaos.CompiledChaos),
                     ("reconfig", reconfig.CompiledReconfig),
                     ("client", workload.CompiledClient)):
        assert schedules.array_fields(fam) + ("n_peers",) == typ._fields, fam
    assert schedules.array_fields("blackbox") == sim.BlackboxState._fields
    assert schedules.array_fields("actions") == ("transfer", "kick")
    for f in schedules.gating_flags():
        assert f in sim.SimConfig._fields
    for p in schedules.packing_families():
        assert p in planes.PACKED_PLANES
    with pytest.raises(KeyError):
        schedules.array_fields("nope")
    assert schedules.row("chaos", "append").shape == "[NPH, G]"
    assert schedules.family("client").compiled == "workload.CompiledClient"
