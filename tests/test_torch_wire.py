"""The port's wire and on-disk formats against the JAX package's: every
packet type, the FRAG super-frame and the wire hello encode to identical
bytes and decode each other's; the native hot path (frame scan, request
parse, response and WAL encode, ballot coalescing, the key->row map)
gives identical results; and a node's on-disk state (WAL segments of
both frame versions, checkpoints, the group and pause tables) written by
either package's ``PaxosLogger`` recovers in the other's with identical
records.  Seeded inputs, exact equality throughout."""

import dataclasses
import os

import numpy as np
import pytest

from gigapaxos_tpu import native as jn
from gigapaxos_tpu.paxos import logger as jl
from gigapaxos_tpu.paxos import packets as jp
from gigapaxos_tpu_torch import native as tn
from gigapaxos_tpu_torch.paxos import logger as tl
from gigapaxos_tpu_torch.paxos import packets as tp

U32 = 1 << 32
# ragged packets: these array fields (and the payloads) hold one item
# per window entry, the rest one per group
_RAGGED = {"PrepareReplyBatch": {"slots", "wbals", "req_lo", "req_hi",
                                 "payloads"}}
_U64 = {"gkey", "req_id", "ts_ns", "xfer_id"}
_U8 = {"flags", "status", "is_pong", "ok", "acked"}
_U32 = {"sender", "entry", "seq", "nchunks"}


def _value(cls_name, name, typ, rng, n, m):
    """A seeded value for field ``name`` of annotation ``typ``."""
    length = m if name in _RAGGED.get(cls_name, ()) or (
        cls_name in ("PrepareReply", "SyncReply")) else n
    if typ == "np.ndarray":
        if name == "gkey":
            return rng.integers(0, 1 << 63, length, dtype=np.uint64) * 2 + 1
        if name == "acked":
            return rng.integers(0, 2, length, dtype=np.uint8)
        if name == "counts":
            return None  # filled in by the caller
        return rng.integers(-(1 << 31), 1 << 31, length, dtype=np.int32)
    if typ == "List[bytes]":
        return [rng.bytes(int(k)) for k in rng.integers(0, 24, length)]
    if typ == "bytes":
        return rng.bytes(int(rng.integers(0, 64)))
    if typ == "str":
        return f"grp-{int(rng.integers(0, 1 << 20))}"
    if typ == "Tuple[int, ...]":
        return tuple(int(x) for x in rng.integers(0, 4096, n))
    if typ == "dict":
        return {"rc": "create", "name": "svc", "v": int(rng.integers(9))}
    if typ == "bool":
        return bool(rng.integers(0, 2))
    assert typ == "int", (cls_name, name, typ)
    if name in _U64:
        return int(rng.integers(0, 1 << 63, dtype=np.uint64)) * 2 + 1
    if name in _U8:
        return int(rng.integers(0, 256))
    if name in _U32:
        return int(rng.integers(0, U32, dtype=np.uint64))
    return int(rng.integers(-(1 << 31), 1 << 31))


def _packet(mod, cls_name, seed):
    """The same seeded packet built from ``mod``'s class ``cls_name``."""
    rng = np.random.default_rng(seed)
    cls = getattr(mod, cls_name)
    n = int(rng.integers(1, 9))
    counts = rng.integers(0, 4, n).astype(np.int32)
    m = int(counts.sum()) if cls_name == "PrepareReplyBatch" \
        else int(rng.integers(0, 6))
    kw = {f.name: _value(cls_name, f.name, f.type, rng, n, m)
          for f in dataclasses.fields(cls)}
    if "counts" in kw:
        kw["counts"] = counts
    return cls(**kw)


def _frames(mod, seed):
    """Encoded frames of the hot packet types, as a worker batch emits
    them toward one peer (runs of equal bodies let FRAG XOR them)."""
    out = []
    for k, name in enumerate(("AcceptBatch", "AcceptReplyBatch",
                              "CommitBatch", "AcceptBatch", "Request")):
        f = _packet(mod, name, seed * 16 + k).encode()
        out += [f, f] if k == 1 else [f]
    return out


_TYPES = sorted(c.__name__ for c in jp._DECODERS.values())


def test_packet_type_tables_identical():
    assert {t.name: int(t) for t in tp.PacketType} == \
        {t.name: int(t) for t in jp.PacketType}
    assert _TYPES == sorted(c.__name__ for c in tp._DECODERS.values())
    assert tp.WIRE_VERSION == jp.WIRE_VERSION
    for name in ("svc", "g0", "grp-123456", "ü-name"):
        assert tp.group_key(name) == jp.group_key(name)


@pytest.mark.parametrize("cls_name", _TYPES)
def test_packet_encode_decode_same_bytes(cls_name):
    for seed in range(3):
        pj = _packet(jp, cls_name, seed)
        pt = _packet(tp, cls_name, seed)
        fj, ft = pj.encode(), pt.encode()
        assert fj == ft
        # each package decodes the other's bytes back to the same frame
        assert tp.decode(fj).encode() == fj
        assert jp.decode(ft).encode() == ft


def test_frag_and_hello_same_bytes():
    for seed in range(4):
        fj, ft = _frames(jp, seed), _frames(tp, seed)
        assert fj == ft
        pj, nj = jp.Frag.encode(7, fj)
        pt, nt = tp.Frag.encode(7, ft)
        blob = b"".join(bytes(p) for p in pj)
        assert (blob, nj) == (b"".join(bytes(p) for p in pt), nt)
        assert tp.Frag.split(blob) == jp.Frag.split(blob) == fj
        assert [tp.packable(f) for f in fj] == [jp.packable(f) for f in fj]
    assert tp.wire_hello(5) == jp.wire_hello(5)
    assert tp.parse_wire_hello(jp.wire_hello(5)) == (5, jp.WIRE_VERSION)


def test_native_both_built():
    """Both packages run their C++ hot path here (the comparisons below
    would otherwise hold the two Python fallbacks against each other)."""
    assert tn.have_native() and jn.have_native()


def _stream(rng, k):
    frames = [_packet(jp, "Request", int(s)).encode()
              for s in rng.integers(0, 1 << 30, k)]
    buf = b"".join(len(f).to_bytes(4, "little") + f for f in frames)
    return buf + buf[:int(rng.integers(1, 9))]  # a torn tail frame


def test_native_scan_and_parse_requests():
    rng = np.random.default_rng(3)
    for k in (1, 5, 64):
        buf = _stream(rng, k)
        sj, st = jn.scan_frames(buf), tn.scan_frames(buf)
        np.testing.assert_array_equal(sj[0], st[0])
        np.testing.assert_array_equal(sj[1], st[1])
        assert sj[2] == st[2] and len(sj[0]) == k
        pj = jn.parse_requests(buf, sj[0], sj[1])
        pt = tn.parse_requests(buf, st[0], st[1])
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_native_encode_responses_and_wal():
    rng = np.random.default_rng(4)
    for n in (1, 7, 100):
        gkey = rng.integers(0, 1 << 63, n, dtype=np.uint64)
        req = rng.integers(0, 1 << 63, n, dtype=np.uint64)
        status = rng.integers(0, 5, n, dtype=np.uint8)
        pays = [rng.bytes(int(k)) for k in rng.integers(0, 40, n)]
        assert tn.encode_responses(9, gkey, req, status, pays) == \
            jn.encode_responses(9, gkey, req, status, pays)
        rtype = rng.integers(1, 3, n, dtype=np.uint8)
        slot = rng.integers(-1, 1 << 20, n, dtype=np.int32)
        bal = rng.integers(-1, 1 << 30, n, dtype=np.int32)
        for crc in (False, True):
            for p in (pays, []):
                assert tn.encode_wal(rtype, gkey, slot, bal, req, p,
                                     crc=crc) == \
                    jn.encode_wal(rtype, gkey, slot, bal, req, p, crc=crc)


def test_native_coalesce_max():
    rng = np.random.default_rng(5)
    for n in (1, 50, 2000):
        row = rng.integers(-2, 16, n).astype(np.int32)
        slot = rng.integers(0, 8, n).astype(np.int32)
        bal = rng.integers(0, 6, n).astype(np.int32)
        np.testing.assert_array_equal(tn.coalesce_max(row, slot, bal),
                                      jn.coalesce_max(row, slot, bal))


def test_native_key_row_map():
    rng = np.random.default_rng(6)
    mj, mt = jn.KeyRowMap(16), tn.KeyRowMap(16)
    keys = rng.integers(0, 1 << 63, 3000, dtype=np.uint64)
    for step in range(6000):
        k = int(keys[rng.integers(0, len(keys))])
        op = rng.integers(0, 3)
        if op == 0:
            v = int(rng.integers(0, 1 << 20))
            assert mt.put(k, v) == mj.put(k, v)
        elif op == 1:
            assert mt.get(k) == mj.get(k)
        else:
            assert mt.delete(k) == mj.delete(k)
        if step % 1000 == 0:
            assert len(mt) == len(mj)
    probe = keys[rng.integers(0, len(keys), 500)]
    np.testing.assert_array_equal(mt.get_batch(probe), mj.get_batch(probe))
    assert len(mt) == len(mj)


# -- on-disk state -------------------------------------------------------


_PKG = {"jax": jl, "port": tl}
_NATIVE = {"jax": jn, "port": tn}


def _write_state(pkg, path, wal_crc, seed):
    """One node's durable state, seeded: WAL batches through both append
    paths (LogEntry records and a natively pre-encoded buffer), the
    group table, checkpoints and a pause record."""
    lm, nat = _PKG[pkg], _NATIVE[pkg]
    rng = np.random.default_rng(seed)
    lg = lm.PaxosLogger(path, sync=False, wal_crc=wal_crc)
    for _ in range(3):
        batch = [lm.LogEntry(int(rng.integers(1, 3)),
                             int(rng.integers(0, 1 << 63, dtype=np.uint64)),
                             int(rng.integers(0, 1 << 20)),
                             int(rng.integers(0, 1 << 30)),
                             int(rng.integers(0, 1 << 63, dtype=np.uint64)),
                             rng.bytes(int(rng.integers(0, 30))))
                 for _ in range(int(rng.integers(1, 12)))]
        lg.log_batch(batch).result(timeout=10)
    n = 9
    buf = nat.encode_wal(
        rng.integers(1, 3, n, dtype=np.uint8),
        rng.integers(0, 1 << 63, n, dtype=np.uint64),
        rng.integers(0, 1 << 20, n, dtype=np.int32),
        rng.integers(0, 1 << 30, n, dtype=np.int32),
        rng.integers(0, 1 << 63, n, dtype=np.uint64),
        [rng.bytes(int(k)) for k in rng.integers(0, 30, n)], crc=wal_crc)
    lg.log_raw_inline(buf, fsync=False, n_entries=n)
    groups = [(int(rng.integers(0, 1 << 63, dtype=np.uint64)), f"g{i}",
               int(rng.integers(0, 4)), (0, 1, 2)) for i in range(5)]
    lg.put_groups(groups)
    lg.checkpoint_many([lm.CheckpointRec(g, nm, v, mem,
                                         int(rng.integers(-1, 400)),
                                         rng.bytes(20))
                        for g, nm, v, mem in groups])
    lg.pause_many([(groups[0][0], b"hot-row-blob")])
    lg.close()


def _read_state(pkg, path, wal_crc):
    lm = _PKG[pkg]
    lg = lm.PaxosLogger(path, sync=False, wal_crc=wal_crc)
    try:
        return {
            "wal": [dataclasses.astuple(e) for e in lg.read_wal()],
            "ckpt": sorted(dataclasses.astuple(c)
                           for c in lg.all_checkpoints()),
            "groups": sorted(lg.all_groups()),
            "paused": [(k, lg.peek_pause(k)) for k in lg.paused_keys()],
        }
    finally:
        lg.close()


def _wal_bytes(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.startswith("wal")}


@pytest.mark.parametrize("wal_crc", [True, False], ids=["v2", "v1"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_on_disk_state_recovers_across_packages(tmp_path, writer, reader,
                                                wal_crc):
    mine = str(tmp_path / "writer")
    twin = str(tmp_path / "twin")
    _write_state(writer, mine, wal_crc, seed=11)
    _write_state(reader, twin, wal_crc, seed=11)
    # the same inputs make the same WAL segment files, byte for byte
    assert _wal_bytes(mine) == _wal_bytes(twin)
    got = _read_state(reader, mine, wal_crc)
    want = _read_state(writer, mine, wal_crc)
    assert got == want
    assert len(got["wal"]) == len(want["wal"]) > 9
    assert len(got["ckpt"]) == 5 and got["paused"][0][1] == b"hot-row-blob"
