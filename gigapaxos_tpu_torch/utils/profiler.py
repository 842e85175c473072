"""Global latency/throughput instrumentation: EWMAs + histograms.

The port's own copy of ``gigapaxos_tpu/utils/profiler.py`` (pure Python,
unchanged), so that ``gigapaxos_tpu_torch`` imports nothing of the JAX
package.

Reference analog: ``src/edu/umass/cs/utils/DelayProfiler.java`` — global
moving-average stats updated inline at every hot-path stage and dumped
periodically as one line.  Same API shape: ``updateDelay(tag, t0)`` computes
``now - t0``; ``updateValue`` tracks an arbitrary moving average;
``updateRate`` counts events/sec; ``get_stats()`` renders one line.

Beyond the reference (the metrics plane): every ``update_delay`` tag also
feeds a log-bucketed (HDR-style) :class:`_Hist`, so p50/p90/p99/p999 are
live on every node, not only in the offline bench — "The Performance of
Paxos in the Cloud" (PAPERS.md) shows tail latency, not the mean, is what
separates deployments under load, and an EWMA cannot show a tail.
``snapshot()`` returns the whole profiler as one nested dict (the
machine-readable face; ``get_stats()`` is a thin formatter over the same
state), and histogram snapshots are mergeable across processes/nodes via
:func:`merge_hist_snapshots`.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional


class _EWMA:
    __slots__ = ("value", "alpha", "count")

    def __init__(self, alpha: float = 0.1):
        self.value = 0.0
        self.alpha = alpha
        self.count = 0

    def update(self, sample: float) -> None:
        if self.count == 0:
            self.value = sample
        else:
            self.value += self.alpha * (sample - self.value)
        self.count += 1


class _Rate:
    """Sliding-window event rate + cumulative count.

    The first cut divided the lifetime count by time-since-construction,
    so ``per_sec`` decayed toward the lifetime average and a live dump
    could show a "rate" for traffic that stopped minutes ago.  Now the
    rate is measured over a ring of ``nslots`` sub-windows covering the
    last ``window_s`` seconds (stale slots are zeroed lazily on access);
    ``count`` stays cumulative for the counters view.
    """

    __slots__ = ("count", "t0", "window_s", "_dt", "_slots", "_head")

    def __init__(self, window_s: float = 10.0, nslots: int = 10):
        self.count = 0
        self.t0 = time.monotonic()
        self.window_s = float(window_s)
        self._dt = self.window_s / nslots
        self._slots = [0] * nslots
        self._head = int(self.t0 / self._dt)

    def _advance(self, now: float) -> None:
        h = int(now / self._dt)
        gap = h - self._head
        if gap > 0:
            ns = len(self._slots)
            for k in range(1, min(gap, ns) + 1):
                self._slots[(self._head + k) % ns] = 0
            self._head = h

    def update(self, n: int = 1) -> None:
        self._advance(time.monotonic())
        self._slots[self._head % len(self._slots)] += n
        self.count += n

    @property
    def per_sec(self) -> float:
        now = time.monotonic()
        self._advance(now)
        # before one full window has elapsed, divide by the lived time
        # so a fresh burst isn't diluted by slots that never existed
        window = min(now - self.t0, self.window_s)
        return sum(self._slots) / max(window, self._dt)


class _Hist:
    """Log-bucketed latency histogram (HDR-style, seconds).

    Buckets are geometric with ``SUB`` sub-buckets per power of two
    (relative width 2^(1/SUB) ≈ 19% at SUB=4), spanning 1 µs to ~268 s —
    record is O(1) (one log2 + a list increment), memory is one small
    int list per tag, and snapshots merge by bucket-wise addition.
    Percentile extraction returns the geometric midpoint of the target
    bucket (≤ ~9% relative error at SUB=4), clamped to the observed
    min/max so tight distributions don't over-round.
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    BASE = 1e-6  # bucket-0 upper bound: 1 microsecond
    SUB = 4      # sub-buckets per octave
    NB = 28 * 4 + 1  # ladder tops out ≈ 2^28 us ≈ 268 s

    def __init__(self):
        self.counts = [0] * self.NB
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def record(self, s: float) -> None:
        if s <= self.BASE:
            i = 0
        else:
            i = 1 + int(self.SUB * math.log2(s / self.BASE))
            if i >= self.NB:
                i = self.NB - 1
        self.counts[i] += 1
        self.count += 1
        self.sum += s
        if s < self.min:
            self.min = s
        if s > self.max:
            self.max = s

    @classmethod
    def le(cls, i: int) -> float:
        """Upper bound (seconds) of bucket ``i``."""
        return cls.BASE * 2.0 ** (i / cls.SUB)

    def percentile(self, q: float) -> Optional[float]:
        if not self.count:
            return None
        return _percentile_from_counts(
            [(self.le(i), c) for i, c in enumerate(self.counts) if c],
            self.count, q, self.min, self.max)

    def snapshot(self, buckets: bool = True) -> dict:
        out = {
            "count": self.count,
            "sum_s": self.sum,
            "min_s": self.min if self.count else None,
            "max_s": self.max if self.count else None,
            "p50_s": self.percentile(50),
            "p90_s": self.percentile(90),
            "p99_s": self.percentile(99),
            "p999_s": self.percentile(99.9),
        }
        if buckets:
            out["buckets"] = [[self.le(i), c]
                              for i, c in enumerate(self.counts) if c]
        return out


def _percentile_from_counts(buckets: List, count: int, q: float,
                            lo_clamp: float, hi_clamp: float
                            ) -> Optional[float]:
    """Percentile over non-cumulative ``[(le_seconds, count), ...]``
    (sorted ascending by ``le``)."""
    if not count:
        return None
    rank = max(1, math.ceil(q / 100.0 * count))
    seen = 0
    width = 2.0 ** (-1.0 / _Hist.SUB)
    for le, c in buckets:
        seen += c
        if seen >= rank:
            rep = le * math.sqrt(width)  # geometric bucket midpoint
            return min(max(rep, lo_clamp), hi_clamp)
    le = buckets[-1][0]
    return min(max(le * math.sqrt(width), lo_clamp), hi_clamp)


def hist_percentile(snap: dict, q: float) -> Optional[float]:
    """Percentile from a histogram *snapshot* (with ``buckets``) — works
    on merged snapshots too."""
    bks = snap.get("buckets")
    if not bks or not snap.get("count"):
        return None
    return _percentile_from_counts(
        bks, snap["count"], q,
        snap.get("min_s") or 0.0, snap.get("max_s") or math.inf)


def merge_hist_snapshots(a: dict, b: dict) -> dict:
    """Merge two histogram snapshots (bucket-wise addition) — the
    cross-node/cross-process aggregation path.  Both must carry
    ``buckets``; percentiles are recomputed over the merged counts."""
    acc: Dict[float, int] = {}
    for snap in (a, b):
        for le, c in snap.get("buckets", []):
            acc[le] = acc.get(le, 0) + c
    buckets = sorted(acc.items())
    count = (a.get("count") or 0) + (b.get("count") or 0)
    mins = [s["min_s"] for s in (a, b) if s.get("min_s") is not None]
    maxs = [s["max_s"] for s in (a, b) if s.get("max_s") is not None]
    lo = min(mins) if mins else None
    hi = max(maxs) if maxs else None
    out = {
        "count": count,
        "sum_s": (a.get("sum_s") or 0.0) + (b.get("sum_s") or 0.0),
        "min_s": lo,
        "max_s": hi,
        "buckets": [[le, c] for le, c in buckets],
    }
    for name, q in (("p50_s", 50), ("p90_s", 90), ("p99_s", 99),
                    ("p999_s", 99.9)):
        out[name] = hist_percentile(out, q)
    return out


class DelayProfiler:
    """Process-global profiler; all methods are thread-safe and cheap."""

    _lock = threading.Lock()
    _delays: Dict[str, _EWMA] = {}
    _values: Dict[str, _EWMA] = {}
    _rates: Dict[str, _Rate] = {}
    _totals: Dict[str, list] = {}  # tag -> [seconds, calls, items, cpu]
    _hists: Dict[str, _Hist] = {}
    enabled: bool = True

    @classmethod
    def update_total(cls, tag: str, t0: float, n: int = 1,
                     cpu_t0: Optional[float] = None) -> None:
        """Accumulate wall seconds + item count under ``tag`` — the
        where-does-the-core-go view (EWMAs show per-batch shape, totals
        show the budget split).  Pass ``cpu_t0`` (from
        ``time.thread_time()``) to also accumulate true CPU seconds —
        on a saturated 1-core host, wall inside a stage is mostly GIL
        wait and lies about the budget."""
        if not cls.enabled:
            return
        dt = time.monotonic() - t0
        dcpu = (time.thread_time() - cpu_t0) if cpu_t0 is not None else 0.0
        with cls._lock:
            t = cls._totals.setdefault(tag, [0.0, 0, 0, 0.0])
            t[0] += dt
            t[1] += 1
            t[2] += n
            t[3] += dcpu

    @classmethod
    def add_total(cls, tag: str, seconds: float, n: int = 1,
                  cpu_seconds: float = 0.0) -> None:
        """Accumulate an already-measured span under ``tag`` (the
        overlap counters — device-busy vs host-busy vs blocked — are
        computed from timestamps captured elsewhere, so there is no
        live ``t0`` to hand update_total)."""
        if not cls.enabled:
            return
        with cls._lock:
            t = cls._totals.setdefault(tag, [0.0, 0, 0, 0.0])
            t[0] += seconds
            t[1] += 1
            t[2] += n
            t[3] += cpu_seconds

    @classmethod
    def totals(cls) -> Dict[str, tuple]:
        with cls._lock:
            return {k: tuple(v) for k, v in cls._totals.items()}

    @classmethod
    def update_delay(cls, tag: str, t0: float, n: int = 1) -> None:
        """Record ``(now - t0)/n`` seconds under ``tag`` (EWMA + the
        log-bucketed histogram behind the tag's percentiles)."""
        if not cls.enabled:
            return
        sample = (time.monotonic() - t0) / max(n, 1)
        with cls._lock:
            cls._delays.setdefault(tag, _EWMA()).update(sample)
            cls._hists.setdefault(tag, _Hist()).record(sample)

    @classmethod
    def update_value(cls, tag: str, sample: float) -> None:
        if not cls.enabled:
            return
        with cls._lock:
            cls._values.setdefault(tag, _EWMA()).update(sample)

    @classmethod
    def update_rate(cls, tag: str, n: int = 1) -> None:
        if not cls.enabled:
            return
        with cls._lock:
            cls._rates.setdefault(tag, _Rate()).update(n)

    @classmethod
    def get(cls, tag: str) -> float:
        with cls._lock:
            if tag in cls._delays:
                return cls._delays[tag].value
            if tag in cls._values:
                return cls._values[tag].value
            if tag in cls._rates:
                return cls._rates[tag].per_sec
            return 0.0

    @classmethod
    def percentile(cls, tag: str, q: float) -> Optional[float]:
        """Live percentile (seconds) of an ``update_delay`` tag."""
        with cls._lock:
            h = cls._hists.get(tag)
            return h.percentile(q) if h else None

    @classmethod
    def snapshot(cls, buckets: bool = True) -> dict:
        """The whole profiler as one nested JSON-serializable dict:
        ``{delays, values, rates, totals, histograms}`` — the
        structured face that replaces scraping :meth:`get_stats`.
        ``buckets=False`` omits raw histogram buckets (percentiles
        stay) for compact artifacts."""
        with cls._lock:
            return {
                "delays": {t: {"ewma_s": e.value, "count": e.count}
                           for t, e in cls._delays.items()},
                "values": {t: {"ewma": e.value, "count": e.count}
                           for t, e in cls._values.items()},
                "rates": {t: {"per_sec": r.per_sec, "count": r.count,
                              "window_s": r.window_s}
                          for t, r in cls._rates.items()},
                "totals": {t: {"wall_s": v[0], "calls": v[1],
                               "items": v[2], "cpu_s": v[3]}
                           for t, v in cls._totals.items()},
                "histograms": {t: h.snapshot(buckets=buckets)
                               for t, h in cls._hists.items()},
            }

    @classmethod
    def get_stats(cls) -> str:
        """One-line render (the reference's periodic dump format) —
        a thin formatter over the same state :meth:`snapshot` returns."""
        with cls._lock:
            parts = []
            for tag, e in sorted(cls._delays.items()):
                parts.append(f"{tag}={e.value*1e3:.3f}ms[{e.count}]")
            for tag, e in sorted(cls._values.items()):
                parts.append(f"{tag}={e.value:.3f}[{e.count}]")
            for tag, r in sorted(cls._rates.items()):
                parts.append(f"{tag}={r.per_sec:.1f}/s[{r.count}]")
            for tag, t in sorted(cls._totals.items()):
                parts.append(
                    f"{tag}={t[0]:.2f}s/{t[3]:.2f}cpu[{t[1]}c/{t[2]}i]")
            return " ".join(parts)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._delays.clear()
            cls._values.clear()
            cls._rates.clear()
            cls._totals.clear()
            cls._hists.clear()
