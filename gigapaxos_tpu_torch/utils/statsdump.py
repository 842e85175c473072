"""Periodic stats dumper (ref: the reference's periodic DelayProfiler/
NIOInstrumenter log lines from ``ReconfigurableNode``).

The port's own copy of ``gigapaxos_tpu/utils/statsdump.py`` (pure
Python, unchanged but for its imports).

One daemon thread per process: every ``interval_s`` it logs the node's
one-line stats render and — when a ``jsonl_path`` is given — appends the
full structured metrics snapshot as one JSON line, so a post-mortem has
machine-readable history without a scraper having been attached.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional, Tuple

from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.stats")


class StatsDumper(threading.Thread):
    """Calls ``source() -> (line, metrics_dict | None)`` every
    ``interval_s``; logs the line, appends the dict to ``jsonl_path``
    (append-only JSONL, one snapshot per line) when both are present.

    Slow-request log (PC.SLOW_TRACE_S): every tick the dumper drains
    the instrument plane's top-K slow-trace table and emits each NEW
    entry once — as a log line (trace id in hex, ready for
    ``/cluster/traces/<id>``) and under ``slow_traces_new`` in the
    JSONL record — so a post-mortem has the worst traces' ids even if
    nobody was scraping."""

    def __init__(self, source: Callable[[], Tuple[str, Optional[dict]]],
                 interval_s: float, jsonl_path: Optional[str] = None,
                 name: str = "gp-stats", slow_fn: Optional[Callable] = None):
        super().__init__(daemon=True, name=name)
        self._source = source
        self.interval_s = float(interval_s)
        self.jsonl_path = jsonl_path
        if slow_fn is None:
            from gigapaxos_tpu_torch.utils.instrument import \
                RequestInstrumenter
            slow_fn = RequestInstrumenter.slow_traces
        self._slow_fn = slow_fn
        self._slow_seen = 0  # highest slow-log seq already emitted
        # NOT named _stop: threading.Thread has an internal _stop()
        # method that join() calls — shadowing it breaks join()
        self._halt = threading.Event()

    def _new_slow(self) -> list:
        try:
            fresh = [s for s in self._slow_fn()
                     if s.get("seq", 0) > self._slow_seen]
        except Exception:
            return []
        for s in fresh:
            self._slow_seen = max(self._slow_seen, s.get("seq", 0))
            log.warning("slow trace %#x: %.1f ms end-to-end",
                        s.get("trace_id", 0),
                        1e3 * s.get("total_s", 0.0))
        return fresh

    def run(self) -> None:
        while not self._halt.wait(self.interval_s):
            try:
                line, m = self._source()
                log.info("%s", line)
                slow = self._new_slow()
                if self.jsonl_path and m is not None:
                    rec = {"ts": round(time.time(), 3)}
                    rec.update(m)
                    if slow:
                        rec["slow_traces_new"] = slow
                    with open(self.jsonl_path, "a") as f:
                        f.write(json.dumps(rec, default=str) + "\n")
            except Exception:  # a stats bug must never kill the node
                log.exception("stats dump failed")

    def stop(self, join_s: float = 2.0) -> None:
        self._halt.set()
        if self.is_alive():
            self.join(join_s)
