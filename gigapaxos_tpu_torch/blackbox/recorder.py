"""Always-on black-box capture ring (the flight recorder's live half).

One :class:`BlackboxRecorder` per node (``PaxosNode.blackbox``; None
when ``PC.BLACKBOX_MB`` is 0, so every hook costs exactly one
attribute check when the plane is off — the PR 7 hot-path contract).
Four lean hooks feed it:

- ``note_frames``  — the worker's decode boundary: the raw frame bytes
  of one decode batch, by reference (the transport already materialized
  each frame as its own ``bytes``; the ring shares those objects —
  zero copies).  Self-routed packet objects are captured at their
  consumption point as re-encoded frames, so the F-record stream is a
  *complete* deterministic input for offline replay.
- ``note_wave``    — per engine wave: wave id, lane, item count, and
  the pre/post order-sensitive lane-state digests replay verifies.
- ``note_wal``     — per WAL append: segment, post-append offset,
  entry count (informational cross-check in the replay report).
- ``note_tick``    — per effective engine tick: clock, last processed
  wave, lane (ticks are replay input — see ``note_tick``).
- ``note_ingress`` — transport scan-loop counters (frames/bytes per
  read chunk).

The ring is bounded by bytes (``PC.BLACKBOX_MB``) and age
(``PC.BLACKBOX_S``); eviction is oldest-first.  Triggers (slow trace,
invariant violation, churn spike, SIGTERM/fatal exception, HTTP
``/blackbox/dump``) snapshot the ring plus a ground-truth manifest to
``blackbox-<node>-<ts>.gpbb`` via :mod:`gigapaxos_tpu_torch.blackbox.capture`.
``trigger()`` dumps on a background thread: the manifest gathers
device truth under the engine locks, and a lane thread triggering
mid-wave already holds its own — dumping inline would invert the lock
order.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from gigapaxos_tpu_torch.blackbox.capture import write_capture
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.blackbox")

# per-record bookkeeping overhead charged against the byte budget on
# top of F-record frame bytes (tuple + timestamps; keeps W/L/I records
# from making the ring unbounded when frames are tiny)
_REC_OVERHEAD = 64


class BlackboxRecorder:
    """Bounded capture ring + trigger-dump for ONE node."""

    # process-wide registry of live recorders: dump_all() (SIGTERM,
    # fatal exception, invariant violation) snapshots every node in an
    # in-process emulation with one call
    _live: set = set()
    _live_lock = threading.Lock()

    def __init__(self, node_id: int, out_dir: str, max_bytes: int,
                 max_age_s: float = 0.0, dump_on_slow: bool = False,
                 manifest_fn: Optional[Callable[[str], dict]] = None,
                 cooldown_s: float = 10.0):
        self.node_id = node_id
        self.out_dir = out_dir
        self.max_bytes = int(max_bytes)
        self.max_age_s = float(max_age_s)
        self.dump_on_slow = bool(dump_on_slow)
        # node callback appending ground truth (knobs, group table,
        # device cursors, app digests) to the dump manifest; called
        # WITHOUT self._lock held (it takes engine locks)
        self.manifest_fn = manifest_fn
        # auto_trigger=False turns trigger() into a no-op — replay
        # arms a recorder on its offline node and must never dump
        self.auto_trigger = True
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._ring: deque = deque()
        self._bytes = 0
        self.n_records = 0
        self.n_evicted = 0
        self.n_dumps = 0
        self._last_trigger = 0.0
        # churn-spike detection window over the node's cumulative
        # ballot-change counter: (count at window start, window ts)
        self._churn_mark = (0, 0.0)
        self.churn_window_s = 5.0
        self.churn_spike = 64
        self.last_dump: Optional[str] = None
        with BlackboxRecorder._live_lock:
            BlackboxRecorder._live.add(self)

    # -- lean capture hooks (PR 7 hot-path discipline) -----------------

    def _append(self, rec: tuple) -> None:
        now = rec[1]
        horizon = now - self.max_age_s if self.max_age_s > 0 else 0.0
        with self._lock:
            self._ring.append(rec)
            self._bytes += rec[2]
            self.n_records += 1
            while self._ring and (self._bytes > self.max_bytes
                                  or self._ring[0][1] < horizon):
                old = self._ring.popleft()
                self._bytes -= old[2]
                self.n_evicted += 1

    def note_frames(self, ts: float, wave: int, lane: int,
                    frames: list) -> None:
        """One decode batch of raw ingress frames (by reference).
        ``ts`` is the wave's pinned engine clock (PaxosNode._now), not
        wall time at the hook: replay re-pins it so the batch's
        time-driven decisions reproduce."""
        nb = 0
        for f in frames:
            nb += len(f)
        self._append(("F", ts, nb + _REC_OVERHEAD, wave, lane,
                      tuple(frames)))

    def note_wave(self, wave: int, lane: int, items: int, pre: int,
                  post: int, chaos) -> None:
        """One engine wave: pre/post lane-state digests + chaos fault
        counters (None when the chaos plane is off)."""
        self._append(("W", time.time(), _REC_OVERHEAD, wave, lane,
                      items, pre, post, chaos))

    def note_wal(self, wave: int, seg: int, off: int, n: int) -> None:
        """One WAL append: segment, post-append byte offset, entries."""
        self._append(("L", time.time(), _REC_OVERHEAD, wave, seg, off,
                      n))

    def note_tick(self, ts: float, wave: int, lane: int) -> None:
        """One EFFECTIVE tick (past the rate gate): its unpinned clock
        and the last wave processed on that lane thread.  Ticks drive
        failure detection, elections, and redrives outside the wave
        stream — replay re-runs each one at this stream position with
        this clock."""
        self._append(("T", ts, _REC_OVERHEAD, wave, lane))

    def note_ingress(self, nframes: int, nbytes: int) -> None:
        """Transport scan-loop: frames/bytes of one read chunk."""
        self._append(("I", time.time(), _REC_OVERHEAD, nframes, nbytes))

    # -- churn trigger (cold: election/preemption path only) -----------

    def note_churn(self, total: int) -> None:
        """Feed the node's cumulative ballot-change counter; a jump of
        ``churn_spike`` within ``churn_window_s`` trips a dump (the
        arXiv:2006.01885 leader-churn pathology signature)."""
        now = time.time()
        fire = False
        with self._lock:
            n0, t0 = self._churn_mark
            if now - t0 > self.churn_window_s or total < n0:
                self._churn_mark = (total, now)
            elif total - n0 >= self.churn_spike:
                self._churn_mark = (total, now)
                fire = True
        if fire:
            self.trigger("churn_spike")

    # -- dump --------------------------------------------------------------

    def trigger(self, reason: str) -> bool:
        """Rate-limited asynchronous dump (the in-band trigger form:
        slow trace, churn spike).  Returns whether a dump was started.
        Runs on a fresh daemon thread because the caller may hold its
        lane's engine lock and the manifest gather takes them all."""
        if not self.auto_trigger:
            return False
        now = time.time()
        with self._lock:
            if now - self._last_trigger < self.cooldown_s:
                return False
            self._last_trigger = now
        threading.Thread(
            target=self._dump_quiet, args=(reason,), daemon=True,
            name=f"gp-bbdump-{self.node_id}").start()
        return True

    def _dump_quiet(self, reason: str) -> Optional[str]:
        try:
            return self.dump(reason)
        except Exception:
            log.exception("blackbox dump (%s) failed", reason)
            return None

    def dump(self, reason: str) -> str:
        """Snapshot the ring + manifest to a ``.gpbb`` file NOW (on the
        calling thread) and return its path."""
        with self._lock:
            recs = list(self._ring)
            n_ev = self.n_evicted
            self.n_dumps += 1
        manifest = {
            "format": "gpbb1",
            "node": self.node_id,
            "ts": time.time(),
            "reason": reason,
            "n_records": len(recs),
            "n_evicted": n_ev,
        }
        if self.manifest_fn is not None:
            try:
                manifest.update(self.manifest_fn(reason))
            except Exception:
                log.exception("blackbox manifest gather failed; "
                              "dumping frames-only capture")
                manifest["manifest_error"] = True
        path = os.path.join(
            self.out_dir,
            f"blackbox-{self.node_id}-{int(manifest['ts'] * 1000)}"
            ".gpbb")
        write_capture(path, self.export(recs), manifest)
        with self._lock:
            self.last_dump = path
        log.info("blackbox: dumped %d records (%s) -> %s", len(recs),
                 reason, path)
        return path

    def export(self, recs: Optional[list] = None) -> List[dict]:
        """Ring records as the dict shapes ``capture.read_capture``
        returns (and ``write_capture`` consumes)."""
        if recs is None:
            with self._lock:
                recs = list(self._ring)
        out = []
        for r in recs:
            k = r[0]
            if k == "F":
                out.append({"t": "F", "ts": r[1], "wave": r[3],
                            "lane": r[4], "frames": list(r[5])})
            elif k == "W":
                out.append({"t": "W", "ts": r[1], "wave": r[3],
                            "lane": r[4], "items": r[5], "pre": r[6],
                            "post": r[7], "chaos": r[8]})
            elif k == "L":
                out.append({"t": "L", "ts": r[1], "wave": r[3],
                            "seg": r[4], "off": r[5], "n": r[6]})
            elif k == "T":
                out.append({"t": "T", "ts": r[1], "wave": r[3],
                            "lane": r[4]})
            else:
                out.append({"t": "I", "ts": r[1], "frames": r[3],
                            "bytes": r[4]})
        return out

    def snapshot(self) -> dict:
        """Cheap JSON-able state for ``GET /blackbox``."""
        with self._lock:
            return {
                "enabled": True,
                "node": self.node_id,
                "records": len(self._ring),
                "bytes": self._bytes,
                "budget_bytes": self.max_bytes,
                "age_horizon_s": self.max_age_s,
                "total_records": self.n_records,
                "evicted": self.n_evicted,
                "dumps": self.n_dumps,
                "dump_on_slow": self.dump_on_slow,
                "last_dump": self.last_dump,
            }

    def close(self) -> None:
        """Deregister from the live set (node stop)."""
        with BlackboxRecorder._live_lock:
            BlackboxRecorder._live.discard(self)

    # -- process-wide ------------------------------------------------------

    @classmethod
    def dump_all(cls, reason: str) -> List[str]:
        """Dump every live recorder (SIGTERM / fatal exception /
        invariant violation — the coherent-incident form).  Never
        raises; returns the paths that were written."""
        with cls._live_lock:
            recs = sorted(cls._live, key=lambda r: r.node_id)
        paths = []
        for r in recs:
            p = r._dump_quiet(reason)
            if p is not None:
                paths.append(p)
        return paths

    @classmethod
    def reset(cls) -> None:
        """Test hook (conftest family-reset for ``BLACKBOX_*``): forget
        every live recorder so a leaked node can't receive later
        ``dump_all`` triggers."""
        with cls._live_lock:
            cls._live.clear()


_crash_hook_installed = False


def install_crash_hook() -> None:
    """Dump every live ring when an uncaught exception reaches the top
    of the main thread or any worker thread — the crash half of the
    SIGTERM/crash trigger pair.  Idempotent; chains the prior hooks."""
    global _crash_hook_installed
    if _crash_hook_installed:
        return
    _crash_hook_installed = True
    prev_sys = sys.excepthook
    prev_threading = threading.excepthook

    def _sys_hook(tp, val, tb):
        BlackboxRecorder.dump_all("fatal_exception")
        prev_sys(tp, val, tb)

    def _threading_hook(hook_args):
        BlackboxRecorder.dump_all("fatal_exception")
        prev_threading(hook_args)

    sys.excepthook = _sys_hook
    threading.excepthook = _threading_hook
