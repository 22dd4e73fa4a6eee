"""Small shared helpers (reference: src/util.rs)."""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence

from .eraftpb import Entry

if TYPE_CHECKING:
    import logging

# A constant representing "no byte limit" (reference: util.rs:19).
NO_LIMIT = (1 << 64) - 1

# Per-entry protobuf-overhead estimate used for size accounting
# (reference: util.rs:161-179 computes the real proto size; we model it as
# payload bytes + a small fixed header, which preserves the *behavior* the
# limits exist for: bounding message/ready byte sizes).
ENTRY_OVERHEAD = 12


def majority(total: int) -> int:
    """Quorum size for a set of `total` voters (reference: util.rs:118-120)."""
    return total // 2 + 1


def entry_approximate_size(e: Entry) -> int:
    """Byte-size estimate of an entry (reference: util.rs:161-179)."""
    return len(e.data) + len(e.context) + ENTRY_OVERHEAD


def limit_size(entries: List[Entry], max_size: int | None) -> None:
    """Truncate `entries` in place so their total approximate size does not
    exceed `max_size`, but always retain at least one entry
    (reference: util.rs:52-75).

    `None` or NO_LIMIT disables the limit.
    """
    if max_size is None or max_size == NO_LIMIT or len(entries) <= 1:
        return
    size = 0
    limit = len(entries)
    for i, e in enumerate(entries):
        size += entry_approximate_size(e)
        if size > max_size and i > 0:
            limit = i
            break
    del entries[limit:]


def is_continuous_ents(ents_a: Sequence[Entry], ents_b: Sequence[Entry]) -> bool:
    """Whether `ents_b` directly follows `ents_a` in log order
    (reference: util.rs:79-85)."""
    if ents_a and ents_b:
        return ents_a[-1].index + 1 == ents_b[0].index
    return True


_U32 = (1 << 32) - 1


def mix32(x: int) -> int:
    """32-bit murmur3-finalizer mix — the counter-based PRNG both backends
    use for randomized election timeouts, so the scalar oracle and the
    batched TPU kernel (which runs without x64) draw IDENTICAL timeouts for
    the same (node, epoch) key.

    Replaces the reference's `rand::thread_rng().gen_range`
    (reference: raft.rs:2744-2756); determinism here is what makes
    scalar-vs-TPU parity testable (SURVEY.md §7 hard-part 4).
    """
    x &= _U32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _U32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _U32
    x ^= x >> 16
    return x


def deterministic_timeout(node_key: int, term: int, lo: int, hi: int) -> int:
    """Randomized election timeout in [lo, hi) keyed by (node_key, term).

    `node_key` identifies the node globally: for a standalone Raft it is the
    node id; for batched groups it is `group_seed * 2**16 + id` so every
    (group, peer) draws an independent stream (see Config.timeout_seed).

    Keying by *term* (not by a reset-call counter) is deliberate: any value
    in [lo, hi) is a legal Raft timeout, same-term redraws are idempotent,
    and campaigning always bumps the term, so successive elections still get
    fresh draws — while the scalar core and the batched device kernel agree
    without having to mirror every reset() call site.
    """
    assert hi > lo
    return lo + mix32((node_key * 0x9E3779B1 + term) & _U32) % (hi - lo)


def default_logger(name: str = "raft_tpu_torch") -> "logging.Logger":
    """Structured logger for the library (the reference's `default_logger`,
    lib.rs:576-600, adapted to stdlib logging: one stream handler, env-
    filtered via RAFT_TPU_LOG, attached once)."""
    import logging
    import os

    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"
            )
        )
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("RAFT_TPU_LOG", "WARNING").upper())
    return logger
