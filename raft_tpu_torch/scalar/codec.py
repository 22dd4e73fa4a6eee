"""Binary wire codec for the eraftpb types (reference: the proto crate is
"the only serialized ABI", SURVEY.md §2 #21; this is its transport-facing
equivalent for DCN/gRPC-style message exchange).

Format: a compact tag-free little-endian layout with varint-free fixed
headers — deliberately simple and deterministic (the same bytes in, the same
message out, byte-identical re-encoding).  Layout per type:

  Entry    = u8 entry_type | u64 term | u64 index | u32 len data | u32 len ctx | bytes
  ConfState= 4 x (u16 count + count*u64) | u8 auto_leave
  SnapMeta = ConfState | u64 index | u64 term
  Snapshot = u32 len data | bytes | SnapMeta
  Message  = u8 msg_type | u64 to | u64 from | u64 term | u64 log_term
           | u64 index | u64 commit | u64 commit_term | u64 request_snapshot
           | u8 reject | u64 reject_hint | u64 priority
           | u16 n_entries | entries... | u8 has_snapshot | [Snapshot]
           | u32 len ctx | bytes
  HardState = 3 x u64
"""

from __future__ import annotations

import struct
from typing import List

from .eraftpb import (
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
    Snapshot,
    SnapshotMetadata,
)

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")


class _Writer:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v: int):
        self.parts.append(bytes([v & 0xFF]))

    def u16(self, v: int):
        self.parts.append(_U16.pack(v))

    def u32(self, v: int):
        self.parts.append(_U32.pack(v))

    def u64(self, v: int):
        self.parts.append(_U64.pack(v))

    def blob(self, b: bytes):
        self.u32(len(b))
        self.parts.append(bytes(b))

    def done(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        v = _U16.unpack_from(self.buf, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        v = _U32.unpack_from(self.buf, self.pos)[0]
        self.pos += 4
        return v

    def u64(self) -> int:
        v = _U64.unpack_from(self.buf, self.pos)[0]
        self.pos += 8
        return v

    def blob(self) -> bytes:
        n = self.u32()
        v = self.buf[self.pos : self.pos + n]
        if len(v) != n:
            raise ValueError("truncated blob")
        self.pos += n
        return v


def _write_entry(w: _Writer, e: Entry) -> None:
    w.u8(int(e.entry_type))
    w.u64(e.term)
    w.u64(e.index)
    w.blob(e.data)
    w.blob(e.context)


def _read_entry(r: _Reader) -> Entry:
    return Entry(
        entry_type=EntryType(r.u8()),
        term=r.u64(),
        index=r.u64(),
        data=r.blob(),
        context=r.blob(),
    )


def _write_id_list(w: _Writer, ids) -> None:
    w.u16(len(ids))
    for id in ids:
        w.u64(id)


def _read_id_list(r: _Reader) -> List[int]:
    return [r.u64() for _ in range(r.u16())]


def _write_conf_state(w: _Writer, cs: ConfState) -> None:
    _write_id_list(w, cs.voters)
    _write_id_list(w, cs.learners)
    _write_id_list(w, cs.voters_outgoing)
    _write_id_list(w, cs.learners_next)
    w.u8(1 if cs.auto_leave else 0)


def _read_conf_state(r: _Reader) -> ConfState:
    return ConfState(
        voters=_read_id_list(r),
        learners=_read_id_list(r),
        voters_outgoing=_read_id_list(r),
        learners_next=_read_id_list(r),
        auto_leave=bool(r.u8()),
    )


def encode_snapshot(s: Snapshot) -> bytes:
    w = _Writer()
    _write_snapshot(w, s)
    return w.done()


def _write_snapshot(w: _Writer, s: Snapshot) -> None:
    w.blob(s.data)
    _write_conf_state(w, s.metadata.conf_state)
    w.u64(s.metadata.index)
    w.u64(s.metadata.term)


def _read_snapshot(r: _Reader) -> Snapshot:
    data = r.blob()
    cs = _read_conf_state(r)
    return Snapshot(
        data=data,
        metadata=SnapshotMetadata(conf_state=cs, index=r.u64(), term=r.u64()),
    )


def decode_snapshot(buf: bytes) -> Snapshot:
    return _read_snapshot(_Reader(buf))


def encode_message(m: Message) -> bytes:
    w = _Writer()
    w.u8(int(m.msg_type))
    w.u64(m.to)
    w.u64(m.from_)
    w.u64(m.term)
    w.u64(m.log_term)
    w.u64(m.index)
    w.u64(m.commit)
    w.u64(m.commit_term)
    w.u64(m.request_snapshot)
    w.u8(1 if m.reject else 0)
    w.u64(m.reject_hint)
    w.u64(m.priority)
    w.u16(len(m.entries))
    for e in m.entries:
        _write_entry(w, e)
    if m.snapshot is not None and not m.snapshot.is_empty():
        w.u8(1)
        _write_snapshot(w, m.snapshot)
    else:
        w.u8(0)
    w.blob(m.context)
    return w.done()


def decode_message(buf: bytes) -> Message:
    r = _Reader(buf)
    m = Message(
        msg_type=MessageType(r.u8()),
        to=r.u64(),
        from_=r.u64(),
        term=r.u64(),
        log_term=r.u64(),
        index=r.u64(),
    )
    m.commit = r.u64()
    m.commit_term = r.u64()
    m.request_snapshot = r.u64()
    m.reject = bool(r.u8())
    m.reject_hint = r.u64()
    m.priority = r.u64()
    m.entries = [_read_entry(r) for _ in range(r.u16())]
    if r.u8():
        m.snapshot = _read_snapshot(r)
    m.context = r.blob()
    if r.pos != len(buf):
        raise ValueError(f"trailing bytes: {len(buf) - r.pos}")
    return m


def encode_hard_state(hs: HardState) -> bytes:
    return _U64.pack(hs.term) + _U64.pack(hs.vote) + _U64.pack(hs.commit)


def decode_hard_state(buf: bytes) -> HardState:
    t, v, c = struct.unpack("<QQQ", buf)
    return HardState(term=t, vote=v, commit=c)
