"""Wire format: paxos packet types + compact binary codec.

Reference analog: ``src/edu/umass/cs/gigapaxos/paxospackets/`` — ~15 packet
classes with a JSON baseline plus a hand-rolled byte fast path for the hot
types (RequestPacket, AcceptPacket, AcceptReplyPacket, Batched*).

TPU-native redesign: the hot packets are *natively batched,
struct-of-arrays*.  An ``AcceptBatch`` frame is literally parallel numpy
arrays (group row-keys, slots, ballots, request ids) followed by a blob
section for payload bytes — so decoding a frame yields arrays that feed the
columnar kernels with no per-item Python loop.  This replaces the
reference's ``PaxosPacketBatcher``-produced ``BatchedAccept``/
``BatchedAcceptReply``/``BatchedCommit`` types AND their byteification in
one design.

Group identity on the wire is a ``u64`` stable hash of the group name
(``group_key``); each node maps keys to its local device row via
``paxos.grouptable``.  Name→key establishment happens at group creation,
which detects (astronomically unlikely) 64-bit collisions and rejects the
create — the analog of the reference's paxosID string interning via
``IntegerMap``.

Frame layout (after the transport's length prefix)::

    u8 type | u32 sender | u32 n_items | fixed SoA arrays | blob section

Blob section: ``u32 total | n× (u32 off)`` then concatenated bytes — blobs
are optional per type.
"""

from __future__ import annotations

import functools
import hashlib
import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=1 << 18)
def group_key(name: str) -> int:
    """Stable 64-bit key for a group name (blake2b-8).  Memoized: the
    control plane re-derives a name's key at every FSM stage (~80 calls
    per create under churn), and the hash dominates its profile; LRU
    keeps hot long-lived names when churn floods the cache."""
    return int.from_bytes(
        hashlib.blake2b(name.encode(), digest_size=8).digest(), "little")


class PacketType(IntEnum):
    """Analog of ``PaxosPacketType`` (+ a few transport-level types)."""

    REQUEST = 1           # client -> entry replica
    RESPONSE = 2          # entry replica -> client
    PROPOSAL = 3          # non-coordinator replica -> coordinator
    ACCEPT_BATCH = 4      # coordinator -> all replicas        (hot)
    ACCEPT_REPLY_BATCH = 5  # replica -> coordinator           (hot)
    COMMIT_BATCH = 6      # coordinator -> all replicas        (hot)
    PREPARE = 7           # would-be coordinator -> replicas
    PREPARE_REPLY = 8     # replica -> would-be coordinator
    FAILURE_DETECT = 9    # ping/pong liveness
    CREATE_GROUP = 10     # admin/control (paxos-only mode)
    CREATE_GROUP_ACK = 11
    DELETE_GROUP = 12
    SYNC_REQUEST = 13     # ask for missing decisions
    SYNC_REPLY = 14
    CHECKPOINT_REQUEST = 15  # ask a peer for its latest app checkpoint
    CHECKPOINT_REPLY = 16
    CONTROL = 17          # JSON control-plane envelope (reconfiguration)
    CHUNK = 18            # large-frame chunking (LargeCheckpointer analog)
    PREPARE_BATCH = 19    # mass failover: n phase-1s in one frame
    PREPARE_REPLY_BATCH = 20
    FRAG = 21             # per-peer super-frame (wire aggregation)
    WIRE_HELLO = 22       # wire-format version announcement


_HDR = struct.Struct("<BII")  # type, sender (u32, matches the transport's
# 32-bit id handshake space), n_items


def _pack_blobs(blobs: Sequence[bytes]) -> bytes:
    offs = np.zeros(len(blobs) + 1, dtype=np.uint32)
    total = 0
    for i, b in enumerate(blobs):
        total += len(b)
        offs[i + 1] = total
    return offs.tobytes() + b"".join(blobs)


def _unpack_blobs(buf: memoryview, n: int) -> Tuple[List[bytes], int]:
    offs = np.frombuffer(buf[: 4 * (n + 1)], dtype=np.uint32)
    base = 4 * (n + 1)
    out = [bytes(buf[base + offs[i]: base + offs[i + 1]]) for i in range(n)]
    return out, base + int(offs[n]) if n else base


# --------------------------------------------------------------------------
# Struct-of-arrays hot packets
# --------------------------------------------------------------------------


@dataclass
class AcceptBatch:
    """Coordinator → replicas: n accepts (+ request payload blobs).

    Ref: ``paxospackets/AcceptPacket`` + ``BatchedAccept``; payloads ride
    along exactly like the reference piggybacks the RequestPacket body in
    its AcceptPacket.
    """

    sender: int
    gkey: np.ndarray      # u64[n]
    slot: np.ndarray      # i32[n]
    bal: np.ndarray       # i32[n] packed ballot
    req_lo: np.ndarray    # i32[n]
    req_hi: np.ndarray    # i32[n]
    payloads: List[bytes] = field(default_factory=list)

    TYPE = PacketType.ACCEPT_BATCH

    def encode(self) -> bytes:
        n = len(self.gkey)
        soa = (np.ascontiguousarray(self.gkey, np.uint64).tobytes() +
               np.ascontiguousarray(self.slot, np.int32).tobytes() +
               np.ascontiguousarray(self.bal, np.int32).tobytes() +
               np.ascontiguousarray(self.req_lo, np.int32).tobytes() +
               np.ascontiguousarray(self.req_hi, np.int32).tobytes())
        return _HDR.pack(self.TYPE, self.sender, n) + soa + _pack_blobs(
            self.payloads or [b""] * n)

    @classmethod
    def decode(cls, sender: int, n: int, body: memoryview) -> "AcceptBatch":
        o = 0
        gkey = np.frombuffer(body[o:o + 8 * n], np.uint64); o += 8 * n
        slot = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        bal = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        rlo = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        rhi = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        blobs, _ = _unpack_blobs(body[o:], n)
        return cls(sender, gkey, slot, bal, rlo, rhi, blobs)


@dataclass
class AcceptReplyBatch:
    """Replica → coordinator: n accept replies.

    Ref: ``paxospackets/AcceptReplyPacket`` + ``BatchedAcceptReply``.
    ``bal`` is the accepted ballot on acks, the acceptor's promised ballot
    on nacks (preemption signal).
    """

    sender: int
    gkey: np.ndarray   # u64[n]
    slot: np.ndarray   # i32[n]
    bal: np.ndarray    # i32[n]
    acked: np.ndarray  # u8[n]

    TYPE = PacketType.ACCEPT_REPLY_BATCH

    def encode(self) -> bytes:
        n = len(self.gkey)
        return (_HDR.pack(self.TYPE, self.sender, n) +
                np.ascontiguousarray(self.gkey, np.uint64).tobytes() +
                np.ascontiguousarray(self.slot, np.int32).tobytes() +
                np.ascontiguousarray(self.bal, np.int32).tobytes() +
                np.ascontiguousarray(self.acked, np.uint8).tobytes())

    @classmethod
    def decode(cls, sender, n, body) -> "AcceptReplyBatch":
        o = 0
        gkey = np.frombuffer(body[o:o + 8 * n], np.uint64); o += 8 * n
        slot = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        bal = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        acked = np.frombuffer(body[o:o + n], np.uint8)
        return cls(sender, gkey, slot, bal, acked)


@dataclass
class CommitBatch:
    """Coordinator → replicas: n decisions (ids only; payloads already at
    replicas from the accept; missing ones are fetched via SYNC).

    Ref: ``PValuePacket`` decisions + ``BatchedCommit``.
    """

    sender: int
    gkey: np.ndarray   # u64[n]
    slot: np.ndarray   # i32[n]
    bal: np.ndarray    # i32[n]
    req_lo: np.ndarray  # i32[n]
    req_hi: np.ndarray  # i32[n]

    TYPE = PacketType.COMMIT_BATCH

    def encode(self) -> bytes:
        n = len(self.gkey)
        return (_HDR.pack(self.TYPE, self.sender, n) +
                np.ascontiguousarray(self.gkey, np.uint64).tobytes() +
                np.ascontiguousarray(self.slot, np.int32).tobytes() +
                np.ascontiguousarray(self.bal, np.int32).tobytes() +
                np.ascontiguousarray(self.req_lo, np.int32).tobytes() +
                np.ascontiguousarray(self.req_hi, np.int32).tobytes())

    @classmethod
    def decode(cls, sender, n, body) -> "CommitBatch":
        o = 0
        gkey = np.frombuffer(body[o:o + 8 * n], np.uint64); o += 8 * n
        slot = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        bal = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        rlo = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        rhi = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        return cls(sender, gkey, slot, bal, rlo, rhi)


@dataclass
class PrepareBatch:
    """Would-be coordinator → replicas: n phase-1s in ONE frame.

    Ref: the reference has no batched prepare — a coordinator death
    walks every led group and emits one PreparePacket each (SURVEY §3.5
    notes the columnar rebuild should make mass failover "a batched
    gather over [G, W]").  At 100K+ groups per dead coordinator,
    per-group frames are minutes of host loops; this is the wire form
    that lets the whole takeover ride the same SoA path as accepts.
    """

    sender: int
    gkey: np.ndarray   # u64[n]
    bal: np.ndarray    # i32[n] packed ballot (one per group: each row's
    #                    ballot number advances independently)

    TYPE = PacketType.PREPARE_BATCH

    def encode(self) -> bytes:
        n = len(self.gkey)
        return (_HDR.pack(self.TYPE, self.sender, n) +
                np.ascontiguousarray(self.gkey, np.uint64).tobytes() +
                np.ascontiguousarray(self.bal, np.int32).tobytes())

    @classmethod
    def decode(cls, sender, n, body) -> "PrepareBatch":
        o = 0
        gkey = np.frombuffer(body[o:o + 8 * n], np.uint64); o += 8 * n
        bal = np.frombuffer(body[o:o + 4 * n], np.int32)
        return cls(sender, gkey, bal)


@dataclass
class PrepareReplyBatch:
    """Replica → would-be coordinator: n phase-1 replies in ONE frame.

    The accepted windows are RAGGED (most groups in a mass takeover are
    idle → zero live pvalues), so they ride as a counts array plus
    flattened SoA columns — the idle-fleet common case costs 0 bytes of
    window per group.
    """

    sender: int
    gkey: np.ndarray     # u64[n]
    bal: np.ndarray      # i32[n]: the prepare's bal (ack) or promised
    acked: np.ndarray    # u8[n]
    cursor: np.ndarray   # i32[n] exec cursor
    counts: np.ndarray   # i32[n] live window entries per row
    slots: np.ndarray    # i32[sum(counts)] flattened
    wbals: np.ndarray    # i32[sum]
    req_lo: np.ndarray   # i32[sum]
    req_hi: np.ndarray   # i32[sum]
    payloads: List[bytes] = field(default_factory=list)  # len sum

    TYPE = PacketType.PREPARE_REPLY_BATCH
    _S = struct.Struct("<I")  # total window entries

    def encode(self) -> bytes:
        n = len(self.gkey)
        m = len(self.slots)
        return (_HDR.pack(self.TYPE, self.sender, n) +
                self._S.pack(m) +
                np.ascontiguousarray(self.gkey, np.uint64).tobytes() +
                np.ascontiguousarray(self.bal, np.int32).tobytes() +
                np.ascontiguousarray(self.acked, np.uint8).tobytes() +
                np.ascontiguousarray(self.cursor, np.int32).tobytes() +
                np.ascontiguousarray(self.counts, np.int32).tobytes() +
                np.ascontiguousarray(self.slots, np.int32).tobytes() +
                np.ascontiguousarray(self.wbals, np.int32).tobytes() +
                np.ascontiguousarray(self.req_lo, np.int32).tobytes() +
                np.ascontiguousarray(self.req_hi, np.int32).tobytes() +
                _pack_blobs(self.payloads or [b""] * m))

    @classmethod
    def decode(cls, sender, n, body) -> "PrepareReplyBatch":
        (m,) = cls._S.unpack_from(body, 0)
        o = cls._S.size
        gkey = np.frombuffer(body[o:o + 8 * n], np.uint64); o += 8 * n
        bal = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        acked = np.frombuffer(body[o:o + n], np.uint8); o += n
        cursor = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        counts = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        slots = np.frombuffer(body[o:o + 4 * m], np.int32); o += 4 * m
        wbals = np.frombuffer(body[o:o + 4 * m], np.int32); o += 4 * m
        rlo = np.frombuffer(body[o:o + 4 * m], np.int32); o += 4 * m
        rhi = np.frombuffer(body[o:o + 4 * m], np.int32); o += 4 * m
        blobs, _ = _unpack_blobs(body[o:], m)
        return cls(sender, gkey, bal, acked, cursor, counts, slots,
                   wbals, rlo, rhi, blobs)


# --------------------------------------------------------------------------
# Scalar control-path packets (cold): simple struct encoding
# --------------------------------------------------------------------------


@dataclass
class Request:
    """Client → entry replica (ref: ``RequestPacket``).  ``req_id`` is
    globally unique: (client_id << 32 | seqno) by convention — which is
    also why it doubles as the request's cluster TRACE ID: the hot
    batch packets (AcceptBatch/CommitBatch/PrepareReplyBatch windows)
    already carry req ids end to end, so the trace context propagates
    through every SoA and shard-split path with zero new wire bytes.

    ``flags`` bits ride the wire in Request/Proposal AND as byte 0 of
    each accept payload blob, so downstream acceptors see them too.
    Old nodes ignore unknown bits (the byte always existed) — adding
    FLAG_SAMPLED is wire-compatible both directions."""

    sender: int
    gkey: int
    req_id: int
    flags: int          # bit 0: stop request (group end-of-epoch)
    payload: bytes

    TYPE = PacketType.REQUEST
    _S = struct.Struct("<QQB")
    FLAG_STOP = 1
    # client-forced trace sampling (bits 1/2 are the node-internal
    # NOOP/MISSING markers — see manager.FLAG_NOOP/FLAG_MISSING)
    FLAG_SAMPLED = 8

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.gkey, self.req_id, self.flags) +
                self.payload)

    @classmethod
    def decode(cls, sender, n, body) -> "Request":
        gkey, req_id, flags = cls._S.unpack_from(body, 0)
        return cls(sender, gkey, req_id, flags,
                   bytes(body[cls._S.size:]))


@dataclass
class Response:
    """Entry replica → client (executed result)."""

    sender: int
    gkey: int
    req_id: int
    # 0 ok; 1 not-coordinator/retry; 2 no-such-group; 3 epoch-stopped
    # (decided after the group's stop slot — re-resolve and retry);
    # 4 deterministic app exception (decided + advanced; retrying the
    # same request returns this same cached error)
    status: int
    payload: bytes

    TYPE = PacketType.RESPONSE
    _S = struct.Struct("<QQB")

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.gkey, self.req_id, self.status) +
                self.payload)

    @classmethod
    def decode(cls, sender, n, body) -> "Response":
        gkey, req_id, status = cls._S.unpack_from(body, 0)
        return cls(sender, gkey, req_id, status, bytes(body[cls._S.size:]))


@dataclass
class Proposal:
    """Replica → coordinator: forward a client request (ref:
    ``ProposalPacket``).  ``entry`` remembers which replica owes the client
    a response."""

    sender: int
    gkey: int
    req_id: int
    entry: int
    flags: int
    payload: bytes

    TYPE = PacketType.PROPOSAL
    _S = struct.Struct("<QQIB")

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.gkey, self.req_id, self.entry,
                             self.flags) + self.payload)

    @classmethod
    def decode(cls, sender, n, body) -> "Proposal":
        gkey, req_id, entry, flags = cls._S.unpack_from(body, 0)
        return cls(sender, gkey, req_id, entry, flags,
                   bytes(body[cls._S.size:]))


@dataclass
class Prepare:
    """Phase-1 (ref: ``PreparePacket``)."""

    sender: int
    gkey: int
    bal: int

    TYPE = PacketType.PREPARE
    _S = struct.Struct("<Qi")

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.gkey, self.bal))

    @classmethod
    def decode(cls, sender, n, body) -> "Prepare":
        gkey, bal = cls._S.unpack_from(body, 0)
        return cls(sender, gkey, bal)


@dataclass
class PrepareReply:
    """Phase-1 reply carrying the accepted window ≥ exec_cursor, with
    payloads so the new coordinator can re-propose (ref:
    ``PrepareReplyPacket``)."""

    sender: int
    gkey: int
    bal: int          # the prepare's ballot (ack) or promised (nack)
    acked: bool
    cursor: int
    slots: np.ndarray     # i32[m]
    bals: np.ndarray      # i32[m]
    req_lo: np.ndarray    # i32[m]
    req_hi: np.ndarray    # i32[m]
    payloads: List[bytes] = field(default_factory=list)

    TYPE = PacketType.PREPARE_REPLY
    _S = struct.Struct("<QiBi")

    def encode(self) -> bytes:
        m = len(self.slots)
        return (_HDR.pack(self.TYPE, self.sender, m) +
                self._S.pack(self.gkey, self.bal, int(self.acked),
                             self.cursor) +
                np.ascontiguousarray(self.slots, np.int32).tobytes() +
                np.ascontiguousarray(self.bals, np.int32).tobytes() +
                np.ascontiguousarray(self.req_lo, np.int32).tobytes() +
                np.ascontiguousarray(self.req_hi, np.int32).tobytes() +
                _pack_blobs(self.payloads or [b""] * m))

    @classmethod
    def decode(cls, sender, n, body) -> "PrepareReply":
        gkey, bal, acked, cursor = cls._S.unpack_from(body, 0)
        o = cls._S.size
        slots = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        bals = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        rlo = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        rhi = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        blobs, _ = _unpack_blobs(body[o:], n)
        return cls(sender, gkey, bal, bool(acked), cursor, slots, bals,
                   rlo, rhi, blobs)


@dataclass
class FailureDetect:
    """Liveness ping/pong (ref: ``FailureDetectionPacket``)."""

    sender: int
    is_pong: int
    ts_ns: int

    TYPE = PacketType.FAILURE_DETECT
    _S = struct.Struct("<BQ")

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.is_pong, self.ts_ns))

    @classmethod
    def decode(cls, sender, n, body) -> "FailureDetect":
        is_pong, ts = cls._S.unpack_from(body, 0)
        return cls(sender, is_pong, ts)


@dataclass
class CreateGroup:
    """Admin create (paxos-only mode; the reconfiguration layer wraps this;
    ref: ``PaxosManager.createPaxosInstance``)."""

    sender: int
    name: str
    members: Tuple[int, ...]
    version: int
    initial_state: bytes = b""

    TYPE = PacketType.CREATE_GROUP

    def encode(self) -> bytes:
        nb = self.name.encode()
        mem = np.asarray(self.members, np.int32).tobytes()
        return (_HDR.pack(self.TYPE, self.sender, len(self.members)) +
                struct.pack("<iH", self.version, len(nb)) + nb +
                mem + self.initial_state)

    @classmethod
    def decode(cls, sender, n, body) -> "CreateGroup":
        version, ln = struct.unpack_from("<iH", body, 0)
        o = 6
        name = bytes(body[o:o + ln]).decode(); o += ln
        members = tuple(np.frombuffer(body[o:o + 4 * n], np.int32).tolist())
        o += 4 * n
        return cls(sender, name, members, version, bytes(body[o:]))


@dataclass
class CreateGroupAck:
    sender: int
    gkey: int
    ok: int

    TYPE = PacketType.CREATE_GROUP_ACK
    _S = struct.Struct("<QB")

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.gkey, self.ok))

    @classmethod
    def decode(cls, sender, n, body) -> "CreateGroupAck":
        gkey, ok = cls._S.unpack_from(body, 0)
        return cls(sender, gkey, ok)


@dataclass
class DeleteGroup:
    sender: int
    gkey: int
    version: int

    TYPE = PacketType.DELETE_GROUP
    _S = struct.Struct("<Qi")

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.gkey, self.version))

    @classmethod
    def decode(cls, sender, n, body) -> "DeleteGroup":
        gkey, version = cls._S.unpack_from(body, 0)
        return cls(sender, gkey, version)


@dataclass
class SyncRequest:
    """Ask a peer for decisions in [from_slot, to_slot) of a group (gap
    fill; ref: ``SyncDecisionsPacket``)."""

    sender: int
    gkey: int
    from_slot: int
    to_slot: int

    TYPE = PacketType.SYNC_REQUEST
    _S = struct.Struct("<Qii")

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.gkey, self.from_slot, self.to_slot))

    @classmethod
    def decode(cls, sender, n, body) -> "SyncRequest":
        gkey, f, t = cls._S.unpack_from(body, 0)
        return cls(sender, gkey, f, t)


@dataclass
class SyncReply:
    """Decisions + payloads for a gap (ref: decisions resent on sync)."""

    sender: int
    gkey: int
    slots: np.ndarray
    req_lo: np.ndarray
    req_hi: np.ndarray
    payloads: List[bytes] = field(default_factory=list)

    TYPE = PacketType.SYNC_REPLY
    _S = struct.Struct("<Q")

    def encode(self) -> bytes:
        m = len(self.slots)
        return (_HDR.pack(self.TYPE, self.sender, m) +
                self._S.pack(self.gkey) +
                np.ascontiguousarray(self.slots, np.int32).tobytes() +
                np.ascontiguousarray(self.req_lo, np.int32).tobytes() +
                np.ascontiguousarray(self.req_hi, np.int32).tobytes() +
                _pack_blobs(self.payloads or [b""] * m))

    @classmethod
    def decode(cls, sender, n, body) -> "SyncReply":
        (gkey,) = cls._S.unpack_from(body, 0)
        o = cls._S.size
        slots = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        rlo = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        rhi = np.frombuffer(body[o:o + 4 * n], np.int32); o += 4 * n
        blobs, _ = _unpack_blobs(body[o:], n)
        return cls(sender, gkey, slots, rlo, rhi, blobs)


@dataclass
class CheckpointRequest:
    sender: int
    gkey: int

    TYPE = PacketType.CHECKPOINT_REQUEST
    _S = struct.Struct("<Q")

    def encode(self) -> bytes:
        return _HDR.pack(self.TYPE, self.sender, 1) + self._S.pack(self.gkey)

    @classmethod
    def decode(cls, sender, n, body) -> "CheckpointRequest":
        (gkey,) = cls._S.unpack_from(body, 0)
        return cls(sender, gkey)


@dataclass
class CheckpointReply:
    sender: int
    gkey: int
    slot: int          # checkpoint is the app state AFTER executing `slot`
    state: bytes

    TYPE = PacketType.CHECKPOINT_REPLY
    _S = struct.Struct("<Qi")

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.gkey, self.slot) + self.state)

    @classmethod
    def decode(cls, sender, n, body) -> "CheckpointReply":
        gkey, slot = cls._S.unpack_from(body, 0)
        return cls(sender, gkey, slot, bytes(body[cls._S.size:]))


@dataclass
class Control:
    """JSON control-plane envelope (cold path; reconfiguration layer).

    Ref: ``reconfiguration/reconfigurationpackets/*`` — the reference keeps
    its whole control plane on JSON; only the paxos hot path is byteified.
    ``body["rc"]`` names the reconfiguration packet type (``create``,
    ``start_epoch``, ...); the rest of ``body`` is that packet's fields.
    """

    sender: int
    body: dict

    TYPE = PacketType.CONTROL

    def encode(self) -> bytes:
        import json as _json
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                _json.dumps(self.body, separators=(",", ":")).encode())

    @classmethod
    def decode(cls, sender, n, body) -> "Control":
        import json as _json
        return cls(sender, _json.loads(bytes(body).decode()))


@dataclass
class Chunk:
    """One slice of an oversized frame (ref: ``paxosutil/
    LargeCheckpointer`` — the reference streams big checkpoints out of
    band over a file channel; here any frame above the chunking
    threshold is sliced into CHUNK frames and reassembled at the
    receiver, so a multi-hundred-MB checkpoint never has to fit the
    single-frame ceiling and never stalls the link for other traffic).

    ``xfer_id`` is unique per (sender, transfer); ``seq``/``nchunks``
    place the slice.  The reassembled payload is a complete wire frame
    (any type) that re-enters the receiver's demux.
    """

    sender: int
    xfer_id: int
    seq: int
    nchunks: int
    data: bytes

    TYPE = PacketType.CHUNK
    _S = struct.Struct("<QII")

    def encode(self) -> bytes:
        return (_HDR.pack(self.TYPE, self.sender, 1) +
                self._S.pack(self.xfer_id, self.seq, self.nchunks) +
                self.data)

    @classmethod
    def decode(cls, sender, n, body) -> "Chunk":
        xfer_id, seq, nchunks = cls._S.unpack_from(body, 0)
        return cls(sender, xfer_id, seq, nchunks,
                   bytes(body[cls._S.size:]))


# frames above CHUNK_THRESHOLD are sliced into CHUNK_BYTES slices; both
# are far below the transport's MAX_FRAME so chunked transfers interleave
# with live traffic instead of head-of-line blocking a connection
CHUNK_BYTES = 4 * 1024 * 1024
CHUNK_THRESHOLD = 8 * 1024 * 1024


def chunk_frame(sender: int, xfer_id: int, frame: bytes) -> List["Chunk"]:
    """Slice an encoded frame into Chunk packets."""
    n = (len(frame) + CHUNK_BYTES - 1) // CHUNK_BYTES
    return [Chunk(sender, xfer_id, i, n,
                  frame[i * CHUNK_BYTES:(i + 1) * CHUNK_BYTES])
            for i in range(n)]


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

_DECODERS = {
    PacketType.REQUEST: Request,
    PacketType.RESPONSE: Response,
    PacketType.PROPOSAL: Proposal,
    PacketType.ACCEPT_BATCH: AcceptBatch,
    PacketType.ACCEPT_REPLY_BATCH: AcceptReplyBatch,
    PacketType.COMMIT_BATCH: CommitBatch,
    PacketType.PREPARE: Prepare,
    PacketType.PREPARE_REPLY: PrepareReply,
    PacketType.FAILURE_DETECT: FailureDetect,
    PacketType.CREATE_GROUP: CreateGroup,
    PacketType.CREATE_GROUP_ACK: CreateGroupAck,
    PacketType.DELETE_GROUP: DeleteGroup,
    PacketType.SYNC_REQUEST: SyncRequest,
    PacketType.SYNC_REPLY: SyncReply,
    PacketType.CHECKPOINT_REQUEST: CheckpointRequest,
    PacketType.CHECKPOINT_REPLY: CheckpointReply,
    PacketType.CONTROL: Control,
    PacketType.CHUNK: Chunk,
    PacketType.PREPARE_BATCH: PrepareBatch,
    PacketType.PREPARE_REPLY_BATCH: PrepareReplyBatch,
}


def decode(frame: bytes):
    """Decode one frame (without the transport length prefix)."""
    ptype, sender, n = _HDR.unpack_from(frame, 0)
    cls = _DECODERS[PacketType(ptype)]
    return cls.decode(sender, n, memoryview(frame)[_HDR.size:])


# --------------------------------------------------------------------------
# engine-lane shard split (PC.ENGINE_SHARDS)
# --------------------------------------------------------------------------


def _take(obj_payloads: List[bytes], idx: np.ndarray) -> List[bytes]:
    if not obj_payloads:
        return []
    return [obj_payloads[i] for i in idx.tolist()]


def shard_split(obj, shards: int) -> Dict[int, object]:
    """Split a batched SoA packet into per-shard sub-packets by
    ``gkey % shards`` — the vectorized decode-split stage of the
    row-sharded engine lanes.  Lane-pure packets (the common steady
    state: a coordinator's AcceptBatch serves many groups, but peers
    batch per destination, mixing shards) return ``{shard: obj}``
    without copying.  Non-batch packets are the caller's problem
    (single ``gkey`` routes by modulo directly)."""
    gkeys = np.asarray(obj.gkey)
    if not len(gkeys):
        return {0: obj}
    sh = (gkeys % np.uint64(shards)).astype(np.int64)
    lo = int(sh.min())
    if lo == int(sh.max()):
        return {lo: obj}
    t = type(obj)
    out: Dict[int, object] = {}
    for k in np.unique(sh).tolist():
        idx = np.flatnonzero(sh == k)
        if t is AcceptBatch:
            out[k] = AcceptBatch(
                obj.sender, gkeys[idx], obj.slot[idx], obj.bal[idx],
                obj.req_lo[idx], obj.req_hi[idx],
                _take(obj.payloads, idx))
        elif t is AcceptReplyBatch:
            out[k] = AcceptReplyBatch(
                obj.sender, gkeys[idx], obj.slot[idx], obj.bal[idx],
                obj.acked[idx])
        elif t is CommitBatch:
            out[k] = CommitBatch(
                obj.sender, gkeys[idx], obj.slot[idx], obj.bal[idx],
                obj.req_lo[idx], obj.req_hi[idx])
        elif t is PrepareBatch:
            out[k] = PrepareBatch(obj.sender, gkeys[idx], obj.bal[idx])
        elif t is PrepareReplyBatch:
            # ragged window columns: gather each kept lane's slice of
            # the flattened arrays (vectorized via repeat/arange)
            counts = np.asarray(obj.counts)
            offs = np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int64)
            kc = counts[idx]
            total = int(kc.sum())
            if total:
                starts = offs[idx]
                # flat indices of the kept lanes' window entries
                wsel = np.repeat(starts, kc) + (
                    np.arange(total)
                    - np.repeat(np.concatenate(
                        [[0], np.cumsum(kc)[:-1]]).astype(np.int64),
                        kc))
            else:
                wsel = np.zeros(0, np.int64)
            out[k] = PrepareReplyBatch(
                obj.sender, gkeys[idx], obj.bal[idx], obj.acked[idx],
                obj.cursor[idx], kc,
                np.asarray(obj.slots)[wsel],
                np.asarray(obj.wbals)[wsel],
                np.asarray(obj.req_lo)[wsel],
                np.asarray(obj.req_hi)[wsel],
                _take(obj.payloads, wsel))
        else:
            raise TypeError(f"shard_split: unsupported {t.__name__}")
    return out


# --------------------------------------------------------------------------
# wire-plane aggregation: FRAG super-frames + version hello
# --------------------------------------------------------------------------
#
# HT-Paxos-style per-peer aggregation (arXiv:1407.1237): the emit stage
# coalesces every frame bound for one peer in a wave into ONE wire frame
# — a FRAG container whose member headers are delta-encoded against the
# previous member (same type/sender/n_items collapse to a flags byte)
# and whose hot SoA bodies column-compress when their id columns follow
# the steady-state pattern (constant gkey/ballot, consecutive slots,
# fixed-size payload blobs).  Reconstruction is LOSSLESS: ``Frag.split``
# returns the exact canonical member frames byte-for-byte, so chaos
# verdicts, blackbox captures, and decode all operate on unchanged
# frames downstream.

WIRE_VERSION = 1

# Version-gated frame types: a peer may only be sent one of these after
# its WIRE_HELLO announced at least the listed wire version.  This table
# IS the negotiation contract — senders consult it (transport coalescing
# checks ``peer_wire[dst] >= WIRE_GATED["FRAG"]``) and the wiresym
# analysis rule cross-checks it against ``decls.wire.version_gated`` so
# a new gated frame type cannot ship without a negotiation entry.
WIRE_GATED = {
    "FRAG": 1,
}

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I32 = struct.Struct("<i")

# member-header delta flags (vs the previous member in the container)
_M_TYPE = 1     # type differs -> u8 follows
_M_SENDER = 2   # sender differs -> u32 follows
_M_NITEMS = 4   # n_items differs -> uvarint follows
_M_PACKED = 8   # body is column-packed (typed SoA compressor)
_M_XOR = 16     # body is XOR-sparse vs the previous member's raw body

# packed-column flags (first body byte when _M_PACKED): const columns
# ship one scalar, delta columns ship the base of ``c0 + arange(n)``
_C_GKEY = 1     # gkey constant -> u64
_C_SLOT = 2     # slot == slot0 + i -> i32
_C_BAL = 4      # ballot constant -> i32
_C_RLO = 8      # req_lo == rlo0 + i -> i32
_C_RHI = 16     # req_hi == rhi0 + i -> i32
_C_ACK = 32     # acked constant -> u8
_C_BLOB = 64    # payload blobs all equal length -> uvarint L + raw
_C_BLOBX = 128  # fixed-size blobs, XOR-sparse between consecutive rows


def _uvarint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_uvarint(mv, o: int) -> Tuple[int, int]:
    x = 0
    shift = 0
    while True:
        b = mv[o]
        o += 1
        x |= (b & 0x7F) << shift
        if not (b & 0x80):
            return x, o
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflow")


def _xor_sparse(prev, cur) -> Optional[bytes]:
    """Body-vs-previous-body sparse delta: coalesced same-type frames
    (e.g. a wave of per-request proposals from one client) differ in a
    handful of bytes — ship only those.  u16 count + u16 positions +
    u8 values; None when not strictly smaller than the raw body."""
    d = np.frombuffer(prev, np.uint8) ^ np.frombuffer(cur, np.uint8)
    nz = np.flatnonzero(d)
    if len(cur) > 0xFFFF or 2 + 3 * nz.size >= len(cur):
        return None
    return (_U16.pack(nz.size) + nz.astype("<u2").tobytes()
            + d[nz].tobytes())


def _xor_apply(prev, data) -> bytes:
    cnt = _U16.unpack_from(data, 0)[0]
    if len(data) != 2 + 3 * cnt:
        raise ValueError("bad xor member")
    pos = np.frombuffer(data, "<u2", cnt, 2).astype(np.int64)
    out = np.frombuffer(prev, np.uint8).copy()
    if cnt and int(pos.max()) >= out.size:
        raise ValueError("bad xor member")
    out[pos] ^= np.frombuffer(data, np.uint8, cnt, 2 + 2 * cnt)
    return out.tobytes()


def _pack_gsb(n: int, body: memoryview) -> Tuple[int, bytearray]:
    """Compress the leading gkey/slot/bal columns shared by the hot
    SoA packets (gkey const, slot consecutive, ballot const)."""
    g = np.frombuffer(body[:8 * n], np.uint64)
    s = np.frombuffer(body[8 * n:12 * n], np.int32)
    b = np.frombuffer(body[12 * n:16 * n], np.int32)
    cf = 0
    out = bytearray()
    if (g == g[0]).all():
        cf |= _C_GKEY
        out += _U64.pack(int(g[0]))
    else:
        out += bytes(body[:8 * n])
    if (np.diff(s.astype(np.int64)) == 1).all():
        cf |= _C_SLOT
        out += _I32.pack(int(s[0]))
    else:
        out += bytes(body[8 * n:12 * n])
    if (b == b[0]).all():
        cf |= _C_BAL
        out += _I32.pack(int(b[0]))
    else:
        out += bytes(body[12 * n:16 * n])
    return cf, out


def _pack_lohi(n: int, body: memoryview, o: int,
               out: bytearray) -> int:
    """req_lo/req_hi columns: both are consecutive runs in the
    steady state (one request range per window entry)."""
    cf = 0
    lo = np.frombuffer(body[o:o + 4 * n], np.int32)
    hi = np.frombuffer(body[o + 4 * n:o + 8 * n], np.int32)
    if (np.diff(lo.astype(np.int64)) == 1).all():
        cf |= _C_RLO
        out += _I32.pack(int(lo[0]))
    else:
        out += bytes(body[o:o + 4 * n])
    if (np.diff(hi.astype(np.int64)) == 1).all():
        cf |= _C_RHI
        out += _I32.pack(int(hi[0]))
    else:
        out += bytes(body[o + 4 * n:o + 8 * n])
    return cf


def _read_gsb(cf: int, n: int, mv, o: int) -> Tuple[bytes, int]:
    if cf & _C_GKEY:
        g = np.full(n, _U64.unpack_from(mv, o)[0], np.uint64).tobytes()
        o += 8
    else:
        g = bytes(mv[o:o + 8 * n])
        o += 8 * n
    if cf & _C_SLOT:
        s0 = _I32.unpack_from(mv, o)[0]
        o += 4
        s = (np.int64(s0) + np.arange(n, dtype=np.int64)).astype(
            np.int32).tobytes()
    else:
        s = bytes(mv[o:o + 4 * n])
        o += 4 * n
    if cf & _C_BAL:
        b = np.full(n, _I32.unpack_from(mv, o)[0], np.int32).tobytes()
        o += 4
    else:
        b = bytes(mv[o:o + 4 * n])
        o += 4 * n
    return g + s + b, o


def _read_lohi(cf: int, n: int, mv, o: int) -> Tuple[bytes, int]:
    ar = np.arange(n, dtype=np.int64)
    if cf & _C_RLO:
        lo = (np.int64(_I32.unpack_from(mv, o)[0]) + ar).astype(
            np.int32).tobytes()
        o += 4
    else:
        lo = bytes(mv[o:o + 4 * n])
        o += 4 * n
    if cf & _C_RHI:
        hi = (np.int64(_I32.unpack_from(mv, o)[0]) + ar).astype(
            np.int32).tobytes()
        o += 4
    else:
        hi = bytes(mv[o:o + 4 * n])
        o += 4 * n
    return lo + hi, o


def _pack_accept(n: int, body: memoryview) -> Optional[bytes]:
    if n < 2 or len(body) < 24 * n + 4 * (n + 1):
        return None
    cf, out = _pack_gsb(n, body)
    cf |= _pack_lohi(n, body, 16 * n, out)
    offs = np.frombuffer(body[24 * n:24 * n + 4 * (n + 1)], np.uint32)
    sizes = np.diff(offs.astype(np.int64))
    if int(sizes.min()) == int(sizes.max()):
        size = int(sizes[0])
        blob = body[24 * n + 4 * (n + 1):]
        packed = _pack_blob_rows(n, size, blob) if size else None
        if packed is not None:
            cf |= _C_BLOBX
            out += packed
        else:
            cf |= _C_BLOB
            out += _uvarint(size)
            out += bytes(blob)
    else:
        out += bytes(body[24 * n:])
    return bytes((cf,)) + bytes(out)


def _pack_blob_rows(n: int, size: int,
                    blob: memoryview) -> Optional[bytes]:
    """Fixed-size blob rows as first-row + XOR-sparse row deltas:
    consecutive window entries carry near-identical payload records
    (same client, sequential request ids), so each row differs from
    its neighbour in 1-3 bytes.  uvarint L, row 0 raw, u8 per-row
    nonzero counts, then column indexes (u8 when L <= 255 else u16)
    and values.  None when not smaller than the raw blob bytes."""
    if size > 0xFFFF or len(blob) != n * size:
        return None
    m = np.frombuffer(blob, np.uint8).reshape(n, size)
    d = m[1:] ^ m[:-1]
    rows, cols = np.nonzero(d)
    counts = np.bincount(rows, minlength=n - 1)
    if counts.size and int(counts.max()) > 255:
        return None
    cw = 1 if size <= 255 else 2
    if size + (n - 1) + rows.size * (cw + 1) >= n * size:
        return None
    return (_uvarint(size) + m[0].tobytes()
            + counts.astype(np.uint8).tobytes()
            + cols.astype(np.uint8 if cw == 1 else "<u2").tobytes()
            + d[rows, cols].tobytes())


def _unpack_blob_rows(n: int, mv, o: int) -> Tuple[int, bytes, int]:
    """-> (row size, raw blob bytes, next offset)."""
    size, o = _read_uvarint(mv, o)
    cw = 1 if size <= 255 else 2
    first = np.frombuffer(bytes(mv[o:o + size]), np.uint8)
    o += size
    counts = np.frombuffer(bytes(mv[o:o + n - 1]), np.uint8)
    o += n - 1
    nnz = int(counts.sum())
    cols = np.frombuffer(bytes(mv[o:o + nnz * cw]),
                         np.uint8 if cw == 1 else "<u2").astype(np.int64)
    o += nnz * cw
    vals = np.frombuffer(bytes(mv[o:o + nnz]), np.uint8)
    o += nnz
    if first.size != size or counts.size != n - 1 or \
            cols.size != nnz or vals.size != nnz or \
            (nnz and int(cols.max()) >= size):
        raise ValueError("truncated blob rows")
    m = np.zeros((n, size), np.uint8)
    m[0] = first
    r = np.repeat(np.arange(1, n, dtype=np.int64),
                  counts.astype(np.int64))
    m[r, cols] = vals
    return size, np.bitwise_xor.accumulate(m, axis=0).tobytes(), o


def _unpack_accept(n: int, mv) -> bytes:
    cf = mv[0]
    gsb, o = _read_gsb(cf, n, mv, 1)
    lohi, o = _read_lohi(cf, n, mv, o)
    if cf & _C_BLOBX:
        size, blob, o = _unpack_blob_rows(n, mv, o)
        offs = (np.arange(n + 1, dtype=np.uint64)
                * np.uint64(size)).astype(np.uint32)
        return gsb + lohi + offs.tobytes() + blob
    if cf & _C_BLOB:
        size, o = _read_uvarint(mv, o)
        offs = (np.arange(n + 1, dtype=np.uint64)
                * np.uint64(size)).astype(np.uint32)
        return gsb + lohi + offs.tobytes() + bytes(mv[o:o + n * size])
    return gsb + lohi + bytes(mv[o:])


def _pack_commit(n: int, body: memoryview) -> Optional[bytes]:
    if n < 2 or len(body) != 24 * n:
        return None
    cf, out = _pack_gsb(n, body)
    cf |= _pack_lohi(n, body, 16 * n, out)
    return bytes((cf,)) + bytes(out)


def _unpack_commit(n: int, mv) -> bytes:
    cf = mv[0]
    gsb, o = _read_gsb(cf, n, mv, 1)
    lohi, _o = _read_lohi(cf, n, mv, o)
    return gsb + lohi


def _pack_reply(n: int, body: memoryview) -> Optional[bytes]:
    if n < 2 or len(body) != 17 * n:
        return None
    cf, out = _pack_gsb(n, body)
    a = np.frombuffer(body[16 * n:17 * n], np.uint8)
    if (a == a[0]).all():
        cf |= _C_ACK
        out.append(int(a[0]))
    else:
        out += bytes(body[16 * n:])
    return bytes((cf,)) + bytes(out)


def _unpack_reply(n: int, mv) -> bytes:
    cf = mv[0]
    gsb, o = _read_gsb(cf, n, mv, 1)
    if cf & _C_ACK:
        return gsb + np.full(n, mv[o], np.uint8).tobytes()
    return gsb + bytes(mv[o:o + n])


_FRAG_PACKERS = {
    int(PacketType.ACCEPT_BATCH): _pack_accept,
    int(PacketType.ACCEPT_REPLY_BATCH): _pack_reply,
    int(PacketType.COMMIT_BATCH): _pack_commit,
}
_FRAG_UNPACKERS = {
    int(PacketType.ACCEPT_BATCH): _unpack_accept,
    int(PacketType.ACCEPT_REPLY_BATCH): _unpack_reply,
    int(PacketType.COMMIT_BATCH): _unpack_commit,
}


class Frag:
    """Per-peer super-frame container (wire layout in README "Wire
    format").  ``encode`` returns a scatter-gather parts list so the
    transport can hand it to ``writelines`` without a join; ``split``
    reconstructs the exact canonical member frames."""

    TYPE = PacketType.FRAG

    @classmethod
    def encode(cls, sender: int,
               frames: Sequence[bytes]) -> Tuple[list, int]:
        parts: list = [b""]
        total = _HDR.size + 1
        ptype = 0
        psender = sender
        pn = 1
        prev_body = None
        for f in frames:
            t, s, n = _HDR.unpack_from(f, 0)
            body = memoryview(f)[_HDR.size:]
            flags = 0
            meta = bytearray(1)
            if t != ptype:
                flags |= _M_TYPE
                meta.append(t)
            if s != psender:
                flags |= _M_SENDER
                meta += _U32.pack(s)
            if n != pn:
                flags |= _M_NITEMS
                meta += _uvarint(n)
            payload = body
            pk = _FRAG_PACKERS.get(t)
            if pk is not None:
                packed = pk(n, body)
                if packed is not None and len(packed) < len(body):
                    flags |= _M_PACKED
                    payload = packed
            if not (flags & _M_PACKED) and prev_body is not None \
                    and t == ptype and len(body) == len(prev_body):
                xs = _xor_sparse(prev_body, body)
                if xs is not None:
                    flags |= _M_XOR
                    payload = xs
            meta[0] = flags
            meta += _uvarint(len(payload))
            parts.append(bytes(meta))
            parts.append(payload)
            total += len(meta) + len(payload)
            ptype, psender, pn = t, s, n
            prev_body = body
        parts[0] = (_HDR.pack(cls.TYPE, sender, len(frames))
                    + bytes((WIRE_VERSION,)))
        return parts, total

    @classmethod
    def split(cls, frame) -> List[bytes]:
        mv = memoryview(frame)
        _t, s, k = _HDR.unpack_from(mv, 0)
        if mv[_HDR.size] > WIRE_VERSION:
            raise ValueError("frag from a newer wire version")
        o = _HDR.size + 1
        end = len(mv)
        ptype = 0
        psender = s
        pn = 1
        prev_raw = None
        out: List[bytes] = []
        for _ in range(k):
            flags = mv[o]
            o += 1
            if flags & _M_TYPE:
                ptype = mv[o]
                o += 1
            if flags & _M_SENDER:
                psender = _U32.unpack_from(mv, o)[0]
                o += 4
            if flags & _M_NITEMS:
                pn, o = _read_uvarint(mv, o)
            blen, o = _read_uvarint(mv, o)
            if o + blen > end:
                raise ValueError("truncated frag member")
            body = mv[o:o + blen]
            o += blen
            if flags & _M_PACKED:
                raw = _FRAG_UNPACKERS[ptype](pn, body)
            elif flags & _M_XOR:
                if prev_raw is None:
                    raise ValueError("xor member without predecessor")
                raw = _xor_apply(prev_raw, body)
            else:
                raw = bytes(body)
            out.append(_HDR.pack(ptype, psender, pn) + raw)
            prev_raw = raw
        return out


_PACK_MIN_BYTES = 96


def packable(frame) -> bool:
    """True when a LONE frame is still worth wrapping in a 1-member
    FRAG: its type has a column packer, it carries >= 2 items, and it
    is big enough that the SoA collapse pays for the container
    overhead.  The transport's emit coalescer uses this so single-
    frame waves (e.g. a peer's reply batch) still column-compress."""
    return (len(frame) >= _PACK_MIN_BYTES
            and frame[0] in _FRAG_PACKERS
            and _U32.unpack_from(frame, 5)[0] >= 2)


def wire_hello(sender: int) -> bytes:
    """Version-announcement frame: first frame on every outbound
    connection of a coalescing node (README "Wire format")."""
    return (_HDR.pack(PacketType.WIRE_HELLO, sender, 1)
            + bytes((WIRE_VERSION,)))


def parse_wire_hello(frame: bytes) -> Tuple[int, int]:
    """-> (sender, wire_version); raises on a non-hello frame."""
    t, s, _n = _HDR.unpack_from(frame, 0)
    if t != PacketType.WIRE_HELLO or len(frame) < _HDR.size + 1:
        raise ValueError("not a wire hello")
    return s, frame[_HDR.size]
