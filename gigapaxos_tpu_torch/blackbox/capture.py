"""``.gpbb`` flight-recorder capture files: writer + reader.

One capture is a node's black-box ring snapshotted at a trigger
(slow trace, invariant violation, churn spike, SIGTERM/crash, or an
explicit ``GET /blackbox/dump``).  The format is deliberately dumb —
length-prefixed records so a torn tail is detectable, binary frames so
replay re-feeds the exact bytes the wire delivered, JSON everywhere
else so a human can pick a capture apart with ``struct`` and
``json.loads`` alone:

    magic  ``GPBB1\\0``
    record ``u32le body_len | u8 kind | body`` repeated
    kinds  ``F`` ingress frame batch (binary, below)
           ``W`` engine-wave summary          (JSON)
           ``L`` WAL append offset            (JSON)
           ``T`` effective engine tick        (JSON)
           ``I`` transport ingress counters   (JSON)
           ``M`` manifest — ALWAYS the last record (JSON)

``F`` body: ``<dqi`` ts/wave/lane, ``u32`` frame count, then per frame
``u32le len | bytes``.  The frames of one ``F`` record are exactly one
worker decode batch — replay preserves live batch boundaries by
re-feeding one ``F`` record per :meth:`PaxosNode._decode_batch` call.

The manifest carries the node's identity, the engine knobs replay must
reproduce (backend, shards, capacity, window, wave fusion), the group
table (name/gkey/row/members/version), and the per-group ground truth
at dump time: app digest + count and the device-truth exec cursor /
next slot gathered under the engine locks.  Replay's verdict is a
bit-for-bit comparison against these.

A file that fails any structural check (bad magic, record running past
EOF, missing manifest) raises :class:`CaptureError` with a message
saying exactly what was wrong and where.
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional, Tuple

MAGIC = b"GPBB1\0"
# record header: body length (kind byte excluded) | kind
_REC_HDR = struct.Struct("<IB")
# F body prefix: ts f64 | wave i64 | lane i32, then u32 frame count
_F_HDR = struct.Struct("<dqi")
_U32 = struct.Struct("<I")

KIND_FRAMES = ord("F")
KIND_WAVE = ord("W")
KIND_WAL = ord("L")
KIND_TICK = ord("T")
KIND_INGRESS = ord("I")
KIND_MANIFEST = ord("M")

_JSON_KINDS = {KIND_WAVE: "W", KIND_WAL: "L", KIND_TICK: "T",
               KIND_INGRESS: "I"}


class CaptureError(Exception):
    """A ``.gpbb`` file failed a structural check (bad magic, torn
    record, missing manifest) — the message says what and where."""


def _encode_frames(rec: dict) -> bytes:
    frames = rec["frames"]
    parts = [_F_HDR.pack(rec["ts"], rec["wave"], rec["lane"]),
             _U32.pack(len(frames))]
    for f in frames:
        parts.append(_U32.pack(len(f)))
        parts.append(bytes(f))
    return b"".join(parts)


def _decode_frames(body: bytes, pos: int) -> dict:
    """``pos`` is the record's file offset — for error messages only."""
    try:
        ts, wave, lane = _F_HDR.unpack_from(body, 0)
        (count,) = _U32.unpack_from(body, _F_HDR.size)
        off = _F_HDR.size + _U32.size
        frames: List[bytes] = []
        for _ in range(count):
            (ln,) = _U32.unpack_from(body, off)
            off += _U32.size
            if off + ln > len(body):
                raise struct.error("frame overruns record")
            frames.append(body[off:off + ln])
            off += ln
    except struct.error as e:
        raise CaptureError(
            f"torn F record at byte {pos}: {e}") from None
    return {"t": "F", "ts": ts, "wave": wave, "lane": lane,
            "frames": frames}


def write_capture(path: str, records: List[dict], manifest: dict) -> None:
    """Write ``records`` (the dict shapes :meth:`read_capture` returns)
    plus the trailing manifest.  Atomic: temp file + rename, so a crash
    mid-dump leaves no half-written ``.gpbb`` behind."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        for rec in records:
            if rec["t"] == "F":
                body = _encode_frames(rec)
                f.write(_REC_HDR.pack(len(body), KIND_FRAMES) + body)
            else:
                kind = {v: k for k, v in _JSON_KINDS.items()}[rec["t"]]
                body = json.dumps(rec, separators=(",", ":")).encode()
                f.write(_REC_HDR.pack(len(body), kind) + body)
        body = json.dumps(manifest, separators=(",", ":"),
                          default=str).encode()
        f.write(_REC_HDR.pack(len(body), KIND_MANIFEST) + body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_capture(path: str) -> Tuple[List[dict], dict]:
    """Parse a ``.gpbb`` file -> ``(records, manifest)``.

    Records come back in capture order as dicts (``t`` in F/W/L/T/I; F
    carries ``frames`` as a list of bytes).  Raises
    :class:`CaptureError` on bad magic, a record running past EOF
    (torn tail), undecodable JSON, or a missing manifest."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise CaptureError(
            f"{path}: bad magic {data[:len(MAGIC)]!r} — not a .gpbb "
            "capture")
    records: List[dict] = []
    manifest: Optional[dict] = None
    pos = len(MAGIC)
    while pos < len(data):
        if pos + _REC_HDR.size > len(data):
            raise CaptureError(
                f"{path}: torn record header at byte {pos} "
                f"({len(data) - pos} trailing bytes)")
        ln, kind = _REC_HDR.unpack_from(data, pos)
        pos += _REC_HDR.size
        if pos + ln > len(data):
            raise CaptureError(
                f"{path}: record (kind {chr(kind)!r}) at byte "
                f"{pos - _REC_HDR.size} claims {ln} bytes but only "
                f"{len(data) - pos} remain — torn capture")
        body = data[pos:pos + ln]
        pos += ln
        if manifest is not None:
            raise CaptureError(
                f"{path}: record after the manifest at byte "
                f"{pos - ln - _REC_HDR.size} — manifest must be last")
        if kind == KIND_FRAMES:
            records.append(_decode_frames(body, pos - ln))
        elif kind in _JSON_KINDS:
            try:
                records.append(json.loads(body))
            except ValueError as e:
                raise CaptureError(
                    f"{path}: bad {chr(kind)!r} JSON at byte "
                    f"{pos - ln}: {e}") from None
        elif kind == KIND_MANIFEST:
            try:
                manifest = json.loads(body)
            except ValueError as e:
                raise CaptureError(
                    f"{path}: bad manifest JSON: {e}") from None
        else:
            raise CaptureError(
                f"{path}: unknown record kind {kind} at byte "
                f"{pos - ln - _REC_HDR.size}")
    if manifest is None:
        raise CaptureError(
            f"{path}: no manifest record — capture was torn before "
            "the dump finished")
    return records, manifest
