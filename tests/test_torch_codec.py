"""The port's wire codec (raft_tpu_torch/scalar/codec.py) against
raft_tpu's: on every message shape of tests/test_codec.py and its fuzz,
the port's bytes equal the reference's, and each package decodes the
other's bytes to its own message.  Exact (bytes are compared)."""

import random

import pytest

from raft_tpu import codec as rcodec
from raft_tpu import eraftpb as reraftpb
from raft_tpu_torch.scalar import codec as tcodec
from raft_tpu_torch.scalar import eraftpb as teraftpb

PKGS = (reraftpb, teraftpb)


def build(pb, kind, seed=0):
    """The message shape `kind` of tests/test_codec.py, built from package
    `pb`'s own eraftpb types; for "fuzz", the `seed`-th random message of
    its fuzz."""
    if kind == "append":
        return pb.Message(
            msg_type=pb.MessageType.MsgAppend, to=2, from_=1, term=5, log_term=4,
            index=10, commit=9,
            entries=[pb.Entry(term=5, index=11, data=b"hello", context=b"ctx")],
        )
    if kind == "snapshot":
        return pb.Message(
            msg_type=pb.MessageType.MsgSnapshot, to=4, from_=1, term=3,
            snapshot=build(pb, "bare_snapshot"),
        )
    if kind == "bare_snapshot":
        return pb.Snapshot(
            data=b"state",
            metadata=pb.SnapshotMetadata(
                conf_state=pb.ConfState(voters=[1, 2, 3], learners=[4],
                                        voters_outgoing=[1, 2], learners_next=[2],
                                        auto_leave=True),
                index=7, term=3,
            ),
        )
    if kind == "big_snapshot":
        return pb.Snapshot(
            data=b"x" * 1000,
            metadata=pb.SnapshotMetadata(conf_state=pb.ConfState(voters=[1]),
                                         index=1, term=1),
        )
    if kind == "hard_state":
        return pb.HardState(term=10, vote=3, commit=99)
    if kind == "conf_change":
        return pb.ConfChange(change_type=pb.ConfChangeType.AddLearnerNode,
                             node_id=7, context=b"c", id=3)
    if kind == "conf_change_v2":
        return pb.ConfChangeV2(
            transition=pb.ConfChangeTransition.Explicit,
            changes=[pb.ConfChangeSingle(pb.ConfChangeType.AddNode, 1),
                     pb.ConfChangeSingle(pb.ConfChangeType.RemoveNode, 2)],
            context=b"ctx",
        )
    if kind == "empty_conf_change_v2":
        return pb.ConfChangeV2()
    assert kind == "fuzz"
    rng = random.Random(99 * 1000 + seed)
    return pb.Message(
        msg_type=pb.MessageType(rng.randint(0, 18)),
        to=rng.randint(0, 2**32),
        from_=rng.randint(0, 2**32),
        term=rng.randint(0, 2**40),
        log_term=rng.randint(0, 2**40),
        index=rng.randint(0, 2**40),
        commit=rng.randint(0, 2**40),
        commit_term=rng.randint(0, 2**40),
        request_snapshot=rng.randint(0, 10),
        reject=rng.random() < 0.5,
        reject_hint=rng.randint(0, 100),
        context=bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 32))),
        priority=rng.randint(0, 10),
        entries=[
            pb.Entry(
                entry_type=pb.EntryType(rng.randint(0, 2)),
                term=rng.randint(0, 100),
                index=rng.randint(0, 100),
                data=bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 64))),
            )
            for _ in range(rng.randint(0, 5))
        ],
    )


# (kind, encoder name, decoder name, module holding them: codec or eraftpb)
SHAPES = (
    ("append", "encode_message", "decode_message", "codec"),
    ("snapshot", "encode_message", "decode_message", "codec"),
    ("bare_snapshot", "encode_snapshot", "decode_snapshot", "codec"),
    ("big_snapshot", "encode_snapshot", "decode_snapshot", "codec"),
    ("hard_state", "encode_hard_state", "decode_hard_state", "codec"),
    ("conf_change", "encode_conf_change", "decode_conf_change", "eraftpb"),
    ("conf_change_v2", "encode_conf_change_v2", "decode_conf_change_v2", "eraftpb"),
    ("empty_conf_change_v2", "encode_conf_change_v2", "decode_conf_change_v2",
     "eraftpb"),
)


def modules(where):
    return (rcodec, tcodec) if where == "codec" else PKGS


def check_crossing(kind, enc, dec, where, seed=0):
    ref_mod, port_mod = modules(where)
    ref_obj, port_obj = build(reraftpb, kind, seed), build(teraftpb, kind, seed)
    ref_bytes = getattr(ref_mod, enc)(ref_obj)
    port_bytes = getattr(port_mod, enc)(port_obj)
    assert port_bytes == ref_bytes
    # Each package decodes the other's bytes to its own message ...
    assert getattr(port_mod, dec)(ref_bytes) == port_obj
    assert getattr(ref_mod, dec)(port_bytes) == ref_obj
    # ... and re-encodes it to the same bytes.
    assert getattr(port_mod, enc)(getattr(port_mod, dec)(ref_bytes)) == ref_bytes


@pytest.mark.parametrize("kind,enc,dec,where", SHAPES, ids=[s[0] for s in SHAPES])
def test_shapes_cross_the_packages(kind, enc, dec, where):
    check_crossing(kind, enc, dec, where)


def test_empty_conf_change_v2_is_empty_bytes():
    """The auto-leave property: an empty ConfChangeV2 encodes to b""."""
    assert teraftpb.encode_conf_change_v2(teraftpb.ConfChangeV2()) == b""
    assert teraftpb.decode_conf_change_v2(b"") == teraftpb.ConfChangeV2()


@pytest.mark.parametrize("block", range(4))
def test_message_fuzz_crosses_the_packages(block):
    for seed in range(block * 50, (block + 1) * 50):
        check_crossing("fuzz", "encode_message", "decode_message", "codec", seed)
