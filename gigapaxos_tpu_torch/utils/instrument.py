"""Per-request cross-stage tracing + pipeline-stage spans + the
cluster tracing plane.

The port's own copy of ``gigapaxos_tpu/utils/instrument.py`` (pure
Python, unchanged), so that ``gigapaxos_tpu_torch`` imports nothing of
the JAX package.

Reference analog: ``gigapaxos/paxosutil/RequestInstrumenter.java`` — at
FINE log level the reference records per-request send/receive timestamps
across nodes so a single request's path can be reconstructed.  Here:
a process-global ring of (req_id, stage, node, t) events, enabled by
``PC.TRACE_REQUESTS`` (or ``RequestInstrumenter.enabled = True``), with
near-zero cost when disabled (one class-attribute check at each hook).

Stages recorded by the node runtime: ``recv`` (entry intake), ``fwd``
(entry forwards the proposal toward the coordinator), ``prop`` (slot
granted at the coordinator), ``acc.tx`` (accept fan-out leaves the
coordinator), ``acc`` (accept fsync-durable at an acceptor), ``dec``
(quorum crossed at the coordinator), ``com.tx`` (commit fan-out leaves
the coordinator), ``exec`` (app executed / response queued at a
replica).  The ``*.tx`` send stamps pair with the matching arrival
stamps on other nodes, so :meth:`cluster_breakdown` can attribute the
network hop between each pair of nodes.

Trace context (the cluster plane): a request's trace id IS its req_id
(req ids are globally unique — ``client_id << 32 | seqno`` — so the hot
batch packets already carry the trace id end to end with zero new wire
bytes).  The *sampled* decision is DETERMINISTIC in the trace id
(golden-ratio hash vs ``PC.TRACE_SAMPLE``), so every node in the
cluster reaches the same verdict without propagating a flag; a client
can additionally force a trace with the wire flag bit
``packets.Request.FLAG_SAMPLED``, which rides the flags byte through
Request/Proposal and the accept payload blobs (old nodes ignore the
unknown bit — the wire format is unchanged).  When sampling is off the
hot path pays one class-attribute check per hook, nothing else.

Spans (the metrics-plane extension): the 3-stage worker (``decode`` |
``engine`` | ``emit``), the WAL (``wal``), and the columnar backend's
submit/collect waves (``eng.submit`` / ``eng.collect``) stamp begin/end
pairs carrying a *wave id* — one per worker batch, propagated
thread-locally through the pipeline stages — plus per-kind attributes
(frame/lane counts, chunk count, the submit->collect overlap).  Trace
events record the wave they happened in, so :meth:`request_spans` /
:meth:`request_breakdown` decompose one request into queue wait, device
time, WAL fsync, and emit without rerunning the bench — and
:meth:`cluster_breakdown` generalizes that to the whole deployment by
merging per-node ring exports (``export_trace`` over ``/traces/<id>``).

Hygiene: ring eviction is age-based as well as size-based
(``max_age_s``): spans from long-dead waves no longer linger in the
aggregate view, and spans that were begun but never ended (a stage
crashed mid-span) age into an explicit ``orphaned`` counter instead of
silently skewing the begun/ended pairing forever.  A bounded top-K
slow-request log (``slow_threshold_s`` / ``slow_k``) keeps the worst
sampled traces for the stats dumper.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

# golden-ratio multiplicative hash: the deterministic sampling verdict
# every node computes identically from the trace id alone
_GOLD = 0x9E3779B97F4A7C15
_M64 = (1 << 64) - 1
_SBITS = 24  # sampling-threshold resolution (1/2^24 granularity)


class TraceContext(NamedTuple):
    """Compact trace context minted at the client/entry node.

    ``trace_id`` is the request id (globally unique already);
    ``parent_span`` is the wave id active at mint time (0 = none);
    ``sampled`` is the cluster-deterministic sampling verdict."""

    trace_id: int
    parent_span: int
    sampled: bool


class RequestInstrumenter:
    """Global trace + span rings; thread-safe, bounded (size AND age)."""

    enabled: bool = False
    # fraction of requests recorded while enabled (PC.TRACE_SAMPLE;
    # 1.0 = everything, the PC.TRACE_REQUESTS legacy behavior).  The
    # verdict is a pure function of the req_id, so all nodes agree.
    sample_rate: float = 1.0
    _sample_thresh: int = 1 << _SBITS
    # age-based eviction horizon for ring entries/spans (0 disables)
    max_age_s: float = 300.0
    # slow-request log: keep the top slow_k sampled traces whose total
    # exceeded slow_threshold_s (0 disables)
    slow_threshold_s: float = 0.0
    slow_k: int = 32

    _lock = threading.Lock()
    _ring: "deque" = deque(maxlen=200_000)   # (req, stage, node, t, wave)
    _spans: "deque" = deque(maxlen=50_000)   # completed span dicts
    _open: Dict[int, dict] = {}              # id(span) -> span, not ended
    _tls = threading.local()
    _wave_seq = itertools.count(1)
    n_span_begun: int = 0
    n_span_ended: int = 0
    n_span_orphaned: int = 0
    _slow: List[tuple] = []                  # min-heap (total, seq, id, ts)
    _slow_seq = itertools.count(1)
    _last_evict: float = 0.0

    # -- configuration -----------------------------------------------------

    @classmethod
    def configure(cls, sample_rate: Optional[float] = None,
                  max_age_s: Optional[float] = None,
                  slow_threshold_s: Optional[float] = None,
                  slow_k: Optional[int] = None) -> None:
        """Set the trace-plane knobs (node boot mirrors PC.* here)."""
        if sample_rate is not None:
            cls.sample_rate = max(0.0, min(1.0, float(sample_rate)))
            cls._sample_thresh = int(cls.sample_rate * (1 << _SBITS))
        if max_age_s is not None:
            cls.max_age_s = float(max_age_s)
        if slow_threshold_s is not None:
            cls.slow_threshold_s = float(slow_threshold_s)
        if slow_k is not None:
            cls.slow_k = max(1, int(slow_k))

    @classmethod
    def sampled(cls, req_id: int, force: bool = False) -> bool:
        """Cluster-deterministic sampling verdict for one trace id.
        ``force`` honors the wire FLAG_SAMPLED bit (client-forced)."""
        if not cls.enabled:
            return False
        if force or cls._sample_thresh >= (1 << _SBITS):
            return True
        h = ((int(req_id) * _GOLD) & _M64) >> (64 - _SBITS)
        return h < cls._sample_thresh

    @classmethod
    def sampled_mask(cls, req_ids) -> "object":
        """Vectorized sampling verdict over a u64 req-id array — the
        hot batch handlers prefilter with this so a 0.1% sample rate
        costs one numpy pass per batch, not a Python call per request
        (flag-forced traces ride the separate FLAG_SAMPLED checks)."""
        import numpy as np
        n = len(req_ids)
        if not cls.enabled:
            return np.zeros(n, bool)
        if cls._sample_thresh >= (1 << _SBITS):
            return np.ones(n, bool)
        with np.errstate(over="ignore"):
            h = (np.asarray(req_ids, np.uint64) * np.uint64(_GOLD)) \
                >> np.uint64(64 - _SBITS)
        return h < np.uint64(cls._sample_thresh)

    @classmethod
    def mint(cls, req_id: int, force: bool = False) -> TraceContext:
        """Mint the trace context at the client/entry node."""
        return TraceContext(int(req_id), cls.current_wave(),
                            cls.sampled(req_id, force))

    # -- wave plumbing -----------------------------------------------------

    @classmethod
    def next_wave(cls) -> int:
        """Fresh process-global wave id (one per worker batch)."""
        return next(cls._wave_seq)

    @classmethod
    def set_wave(cls, wave: int) -> None:
        """Bind the calling thread to ``wave``: trace events and spans
        recorded on this thread attach to it until rebound (the worker
        hands the id across its pipeline stages along with the batch)."""
        cls._tls.wave = wave

    @classmethod
    def current_wave(cls) -> int:
        return getattr(cls._tls, "wave", 0)

    # -- per-request trace events ------------------------------------------

    @classmethod
    def record(cls, req_id: int, stage: str, node: int,
               force: bool = False) -> None:
        if not cls.enabled:
            return
        if not cls.sampled(req_id, force):
            return
        now = time.monotonic()
        with cls._lock:
            cls._ring.append((req_id, stage, node, now,
                              getattr(cls._tls, "wave", 0)))
        cls._maybe_evict(now)

    @classmethod
    def trace(cls, req_id: int) -> List[Tuple[str, int, float]]:
        """(stage, node, t) events of one request, time-ordered."""
        with cls._lock:
            evs = [(s, n, t) for r, s, n, t, _w in cls._ring if r == req_id]
        return sorted(evs, key=lambda e: e[2])

    @classmethod
    def spans(cls, req_id: int) -> Dict[str, float]:
        """Stage-to-stage latencies (seconds) for one request."""
        evs = cls.trace(req_id)
        out: Dict[str, float] = {}
        for (s1, _n1, t1), (s2, _n2, t2) in zip(evs, evs[1:]):
            out[f"{s1}->{s2}"] = t2 - t1
        if evs:
            out["total"] = evs[-1][2] - evs[0][2]
        return out

    @classmethod
    def format(cls, req_id: int) -> str:
        evs = cls.trace(req_id)
        if not evs:
            return f"req {req_id:#x}: no trace"
        t0 = evs[0][2]
        return f"req {req_id:#x}: " + " ".join(
            f"{s}@n{n}+{(t - t0) * 1e3:.2f}ms" for s, n, t in evs)

    # -- pipeline-stage spans ----------------------------------------------

    @classmethod
    def span_begin(cls, kind: str, node: int = -1,
                   wave: Optional[int] = None, **attrs) -> Optional[dict]:
        """Open a span of ``kind`` on the current (or given) wave.
        Returns the span handle to pass to :meth:`span_end`, or None
        when tracing is disabled (span_end accepts None)."""
        if not cls.enabled:
            return None
        sp = {"kind": kind, "node": node,
              "wave": cls.current_wave() if wave is None else wave,
              "t0": time.monotonic(), "t1": None}
        if attrs:
            sp.update(attrs)
        with cls._lock:
            cls.n_span_begun += 1
            cls._open[id(sp)] = sp
        return sp

    @classmethod
    def span_end(cls, sp: Optional[dict], **attrs) -> None:
        if sp is None:
            return
        now = time.monotonic()
        sp["t1"] = now
        if attrs:
            sp.update(attrs)
        with cls._lock:
            if cls._open.pop(id(sp), None) is not None:
                cls.n_span_ended += 1
                cls._spans.append(sp)
            elif sp.pop("_orphaned", False):
                # the end arrived after all, just later than the age
                # horizon (a long compile/recovery stall): move the
                # span back from orphaned to ended and keep the record
                # — a permanent false "lost end" would never clear,
                # and the slow request being diagnosed would lose its
                # span breakdown
                cls.n_span_orphaned -= 1
                cls.n_span_ended += 1
                cls._spans.append(sp)
            # else: the rings were clear()ed between begin and end —
            # count nothing (begun was reset too)
        cls._maybe_evict(now)

    # -- age-based eviction (satellite: size-only eviction let spans
    # from long-dead waves linger and skewed the pairing counts) -------

    @classmethod
    def _maybe_evict(cls, now: float) -> None:
        if cls.max_age_s <= 0:
            return
        if now - cls._last_evict < max(1.0, cls.max_age_s / 4):
            return
        cls.evict(now)

    @classmethod
    def evict(cls, now: Optional[float] = None) -> int:
        """Drop ring entries and completed spans older than
        ``max_age_s``; spans still open past the horizon move to the
        ``orphaned`` counter (their ends were lost — a stage crashed or
        leaked its handle).  Returns how many items were evicted."""
        if now is None:
            now = time.monotonic()
        # under the lock: concurrent stage threads racing past the
        # _maybe_evict throttle would otherwise both stamp + sweep
        with cls._lock:
            cls._last_evict = now
        if cls.max_age_s <= 0:
            return 0
        cutoff = now - cls.max_age_s
        evicted = 0
        with cls._lock:
            # both rings are appended in monotonic time order
            while cls._ring and cls._ring[0][3] < cutoff:
                cls._ring.popleft()
                evicted += 1
            while cls._spans and cls._spans[0]["t1"] < cutoff:
                cls._spans.popleft()
                evicted += 1
            for k in [k for k, sp in cls._open.items()
                      if sp["t0"] < cutoff]:
                sp = cls._open.pop(k)
                # marked so a LATE span_end can undo the orphan verdict
                sp["_orphaned"] = True
                cls.n_span_orphaned += 1
                evicted += 1
        return evicted

    # -- span queries -------------------------------------------------------

    @classmethod
    def wave_spans(cls, wave: int) -> List[dict]:
        """Completed spans of one wave, time-ordered."""
        with cls._lock:
            out = [dict(s) for s in cls._spans if s["wave"] == wave]
        return sorted(out, key=lambda s: s["t0"])

    @classmethod
    def request_spans(cls, req_id: int) -> List[dict]:
        """Pipeline-stage spans of every wave the request touched
        (request frame decode, its engine+WAL batch, commit waves,
        emit) — the per-request join of trace events and spans."""
        with cls._lock:
            waves = {w for r, _s, _n, _t, w in cls._ring
                     if r == req_id and w}
            out = [dict(s) for s in cls._spans if s["wave"] in waves]
        return sorted(out, key=lambda s: s["t0"])

    @classmethod
    def request_breakdown(cls, req_id: int) -> Dict[str, float]:
        """kind -> total seconds across the request's waves: decompose
        a slow request into decode / engine / wal / emit /
        eng.submit / eng.collect without rerunning the bench."""
        out: Dict[str, float] = {}
        for s in cls.request_spans(req_id):
            out[s["kind"]] = out.get(s["kind"], 0.0) + (s["t1"] - s["t0"])
        return out

    # -- cluster trace stitching -------------------------------------------

    @classmethod
    def export_trace(cls, trace_id: int) -> dict:
        """This process's share of one trace — the ``/traces/<id>``
        payload a peer (or the gateway) merges: the trace's ring events
        plus the completed spans of every wave it touched here.

        The rings are SNAPSHOT under the lock (one C-level deque copy)
        and scanned outside it: a trace scrape against a full 200k
        ring must not hold the hot-path lock for the whole linear
        scan — that would stall every lane's record()/span hooks while
        the observer observes."""
        with cls._lock:
            ring = list(cls._ring)
            span_snap = list(cls._spans)
        evs = [(s, n, t, w) for r, s, n, t, w in ring if r == trace_id]
        waves = {w for _s, _n, _t, w in evs if w}
        spans = [dict(s) for s in span_snap if s["wave"] in waves]
        return {"trace_id": int(trace_id),
                "events": [list(e) for e in sorted(evs,
                                                   key=lambda e: e[2])],
                "spans": spans}

    # (send stamp, arrival stamp): the cross-node pairs a network hop
    # is measured between.  The hop includes the receiver's queue wait
    # up to its stamp point — the per-node span breakdown separates it.
    _HOP_PAIRS = (("fwd", "prop"), ("acc.tx", "acc"), ("acc", "dec"),
                  ("com.tx", "exec"))

    @classmethod
    def cluster_breakdown(cls, trace_id: int,
                          exports: Optional[List[dict]] = None) -> dict:
        """Stitch one request's cluster-wide story from per-node ring
        exports (default: this process's rings — which, in an
        in-process multi-node emulation, already hold every node).

        Returns ``{trace_id, total_s, path, nodes, hops}``: ``path`` is
        the merged time-ordered event list (relative ms), ``nodes``
        maps node -> span-kind seconds (queue/decode/engine/wal/emit
        split per node), ``hops`` lists the network hops between the
        recorded send/arrival stamp pairs."""
        if exports is None:
            exports = [cls.export_trace(trace_id)]
        evs: set = set()
        spans: List[dict] = []
        seen_spans: set = set()
        for ex in exports or []:
            if not ex:
                continue
            for e in ex.get("events", []):
                evs.add((str(e[0]), int(e[1]), float(e[2]), int(e[3])))
            # resolve node-less spans (the WAL logger stamps node=-1)
            # through their wave WITHIN this export: wave ids are
            # per-process counters, so the wave->node join is only
            # valid inside one export — two separate node processes
            # both reach wave 42 (the in-process emulation shares one
            # counter, a real deployment does not)
            wave_node: Dict[int, int] = {}
            for e in ex.get("events", []):
                if e[3]:
                    wave_node.setdefault(int(e[3]), int(e[1]))
            for sp in ex.get("spans", []):
                if int(sp.get("node", -1)) >= 0 and sp.get("wave"):
                    wave_node.setdefault(int(sp["wave"]),
                                         int(sp["node"]))
            for sp in ex.get("spans", []):
                node = int(sp.get("node", -1))
                if node < 0:
                    node = wave_node.get(int(sp.get("wave") or 0), -1)
                key = (sp.get("kind"), node, sp.get("wave"),
                       sp.get("t0"))
                if key in seen_spans:
                    continue
                seen_spans.add(key)
                sp = dict(sp)
                sp["node"] = node
                spans.append(sp)
        ordered = sorted(evs, key=lambda e: (e[2], e[1], e[0]))
        if not ordered:
            return {"trace_id": int(trace_id), "total_s": None,
                    "path": [], "nodes": {}, "hops": []}
        t0 = ordered[0][2]
        path = [{"stage": s, "node": n, "t_ms": round((t - t0) * 1e3, 3)}
                for s, n, t, _w in ordered]
        # per-node pipeline-stage breakdown: each span belongs to ONE
        # node (a wave is a node-local worker batch; node resolution
        # for node-less spans already happened per export above)
        nodes: Dict[int, Dict[str, float]] = {}
        for sp in spans:
            if sp.get("t1") is None:
                continue
            d = nodes.setdefault(int(sp.get("node", -1)), {})
            k = sp["kind"]
            d[k] = d.get(k, 0.0) + (sp["t1"] - sp["t0"])
        # network hops: pair each arrival stamp with the latest earlier
        # send stamp from another node
        hops = []
        by_stage: Dict[str, list] = {}
        for s, n, t, _w in ordered:
            by_stage.setdefault(s, []).append((t, n))
        for src_stage, dst_stage in cls._HOP_PAIRS:
            srcs = by_stage.get(src_stage, [])
            if not srcs:
                continue
            for t_dst, n_dst in by_stage.get(dst_stage, []):
                best = None
                for t_src, n_src in srcs:
                    if n_src != n_dst and t_src <= t_dst and (
                            best is None or t_src > best[0]):
                        best = (t_src, n_src)
                if best is not None:
                    hops.append({
                        "stage": f"{src_stage}->{dst_stage}",
                        "from": best[1], "to": n_dst,
                        "s": t_dst - best[0]})
        return {"trace_id": int(trace_id),
                "total_s": ordered[-1][2] - t0,
                "path": path, "nodes": nodes, "hops": hops}

    # -- slow-request log ---------------------------------------------------

    @classmethod
    def note_done(cls, trace_id: int, total_s: float,
                  force: bool = False) -> None:
        """A sampled request finished end-to-end in ``total_s``; keep
        it in the top-K slow log when past the threshold."""
        if not cls.enabled or cls.slow_threshold_s <= 0:
            return
        if total_s < cls.slow_threshold_s:
            return
        if not cls.sampled(trace_id, force):
            return
        with cls._lock:
            heapq.heappush(cls._slow, (float(total_s),
                                       next(cls._slow_seq),
                                       int(trace_id), time.time()))
            while len(cls._slow) > cls.slow_k:
                heapq.heappop(cls._slow)

    @classmethod
    def slow_traces(cls) -> List[dict]:
        """Top-K slow sampled traces, slowest first (each with the
        monotone ``seq`` the stats dumper uses to emit only new ones)."""
        with cls._lock:
            items = sorted(cls._slow, reverse=True)
        return [{"trace_id": tid, "total_s": total, "seq": seq, "ts": ts}
                for total, seq, tid, ts in items]

    # -- aggregates ---------------------------------------------------------

    @classmethod
    def span_stats(cls) -> dict:
        """Aggregate span view for the metrics snapshot: per-kind count
        and total seconds, plus begin/end pairing counters.  ``open``
        counts spans currently in flight; ``orphaned`` counts spans
        whose end stamp never arrived within ``max_age_s`` (a lost end
        — without the split, pairing skew was indistinguishable from
        live load)."""
        cls._maybe_evict(time.monotonic())
        with cls._lock:
            agg: Dict[str, list] = {}
            for s in cls._spans:
                a = agg.setdefault(s["kind"], [0, 0.0])
                a[0] += 1
                a[1] += s["t1"] - s["t0"]
            return {
                "begun": cls.n_span_begun,
                "ended": cls.n_span_ended,
                "orphaned": cls.n_span_orphaned,
                "open": len(cls._open),
                "kinds": {k: {"count": c, "total_s": t}
                          for k, (c, t) in sorted(agg.items())},
            }

    @classmethod
    def clear(cls) -> None:
        """Drop recorded data (keeps the configured knobs)."""
        with cls._lock:
            cls._ring.clear()
            cls._spans.clear()
            cls._open.clear()
            cls._slow.clear()
            cls.n_span_begun = 0
            cls.n_span_ended = 0
            cls.n_span_orphaned = 0

    @classmethod
    def reset(cls) -> None:
        """clear() + restore default knobs (test harness hook)."""
        cls.clear()
        cls.enabled = False
        cls.configure(sample_rate=1.0, max_age_s=300.0,
                      slow_threshold_s=0.0, slow_k=32)
