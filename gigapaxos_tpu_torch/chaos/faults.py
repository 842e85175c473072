"""Deterministic fault plane for the transport's peer links.

Reference analog: ``gigapaxos/testing/TESTPaxosConfig`` message-drop
emulation, grown into the cloud-variance pathologies of
"The Performance of Paxos in the Cloud" (arXiv:1404.6719): latency
variance, stragglers, asymmetric links, partitions.  The plane shapes
**peer** links only (consensus traffic between node ids in the
transport's ``addr_map``); client connections are untouched so a
scenario's ack bookkeeping measures the cluster, not the harness.

Design:

- **Process-global singleton** (class attributes, like
  ``RequestInstrumenter``): one plane shapes every transport in the
  process, which is exactly what the in-process multi-node emulation
  wants — ``ChaosPlane.partition([{0, 1}, {2}])`` splits the cluster
  no matter how many ``Transport`` objects exist.  Real multi-process
  deployments control each node's plane via its ``/chaos`` route.
- **Deterministic**: every verdict comes from a per-(src, dst)-pair
  ``random.Random`` seeded by ``(CHAOS_SEED, src, dst)`` via a stable
  mix (no salted ``hash()``), consumed in that pair's send order.  The
  k-th frame on a pair meets the same fate in every run with the same
  seed — a failing run replays exactly.  :meth:`schedule_fingerprint`
  digests the would-be decision stream without consuming it, so two
  runs can PROVE their schedules were identical.
- **Zero hot-path overhead when disabled**: the transport's send path
  checks one class attribute (``ChaosPlane.enabled``) and moves on —
  the same short-circuit discipline as the tracing plane.

Faults per link rule (wildcards supported: a rule for ``(src, None)``
matches every destination, ``(None, None)`` every pair; most specific
wins):

- ``delay_s`` + ``jitter_s`` — one-way latency, uniform jitter on top
  (WAN emulation; frames are released by the event loop after the
  delay, so a delayed frame is genuinely late, not just slow to write)
- ``drop_p`` — probabilistic loss, counted under the transport's
  distinct ``chaos`` drop cause (never pollutes ``congestion`` /
  ``write_error`` accounting)
- ``reorder_p`` — holds a frame one extra beat
  (``delay + jitter + 2ms``) so later frames overtake it, the netem
  reorder idiom
- partitions — directed ``(src, dst)`` edges via :meth:`block`, or
  symmetric set splits via :meth:`partition`; :meth:`heal` clears them
"""

from __future__ import annotations

import json
import threading
from random import Random
from typing import Dict, List, Optional, Set, Tuple
from urllib.parse import parse_qs

from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.chaos")

_GOLD = 0x9E3779B97F4A7C15
_M64 = (1 << 64) - 1


def _pair_seed(seed: int, src: int, dst: int) -> int:
    """Stable per-pair seed (``hash()`` is process-salted; this is not)."""
    x = (int(seed) * _GOLD) & _M64
    x ^= ((int(src) + 1) * 0x85EBCA6B) & _M64
    x = (x * _GOLD) & _M64
    x ^= ((int(dst) + 1) * 0xC2B2AE35) & _M64
    return (x * _GOLD) & _M64


class LinkRule:
    """Fault parameters for one (possibly wildcard) directed link."""

    __slots__ = ("delay_s", "jitter_s", "drop_p", "reorder_p")

    def __init__(self, delay_s: float = 0.0, jitter_s: float = 0.0,
                 drop_p: float = 0.0, reorder_p: float = 0.0):
        self.delay_s = max(0.0, float(delay_s))
        self.jitter_s = max(0.0, float(jitter_s))
        self.drop_p = min(1.0, max(0.0, float(drop_p)))
        self.reorder_p = min(1.0, max(0.0, float(reorder_p)))

    def asdict(self) -> dict:
        return {"delay_ms": round(self.delay_s * 1e3, 3),
                "jitter_ms": round(self.jitter_s * 1e3, 3),
                "drop": self.drop_p, "reorder": self.reorder_p}


def parse_partition_spec(spec: str) -> List[Set[int]]:
    """``"0,1|2"`` -> ``[{0, 1}, {2}]`` (empty/blank -> no partition)."""
    sets: List[Set[int]] = []
    for part in (spec or "").split("|"):
        ids = {int(x) for x in part.replace(" ", "").split(",") if x}
        if ids:
            sets.append(ids)
    return sets


class ChaosPlane:
    """Process-global fault plane (see module docstring)."""

    # THE hot-path gate: transports check this one class attribute and
    # short-circuit when False (the tracing-plane discipline)
    enabled: bool = False

    seed: int = 0
    _lock = threading.Lock()
    # (src|None, dst|None) -> LinkRule; None = wildcard
    _rules: Dict[Tuple[Optional[int], Optional[int]], LinkRule] = {}
    _blocked: Set[Tuple[int, int]] = set()      # directed partition edges
    _rngs: Dict[Tuple[int, int], Random] = {}   # lazily minted per pair
    # injected-fault counters (the /chaos observability face)
    n_dropped: int = 0     # probabilistic drops
    n_blocked: int = 0     # partition drops
    n_delayed: int = 0
    n_reordered: int = 0
    _per_pair: Dict[Tuple[int, int], List[int]] = {}  # [drop, blk, dly, ro]

    # -- configuration -----------------------------------------------------

    @classmethod
    def configure(cls, seed: Optional[int] = None,
                  enabled: Optional[bool] = None) -> None:
        with cls._lock:
            if seed is not None:
                cls.seed = int(seed)
                cls._rngs.clear()  # new seed -> fresh decision streams
            if enabled is not None:
                cls.enabled = bool(enabled)

    @classmethod
    def set_link(cls, src: Optional[int], dst: Optional[int],
                 delay_s: float = 0.0, jitter_s: float = 0.0,
                 drop_p: float = 0.0, reorder_p: float = 0.0) -> None:
        """Install a fault rule for the directed link ``src -> dst``
        (``None`` = wildcard on that side).  A rule with every
        parameter zero removes the entry.  Enables the plane."""
        key = (None if src is None else int(src),
               None if dst is None else int(dst))
        rule = LinkRule(delay_s, jitter_s, drop_p, reorder_p)
        with cls._lock:
            if rule.delay_s or rule.jitter_s or rule.drop_p \
                    or rule.reorder_p:
                cls._rules[key] = rule
                # installing a real fault arms the plane; clearing a
                # rule (all params zero) must NOT — an idle plane stays
                # one short-circuited attribute check
                cls.enabled = True
            else:
                cls._rules.pop(key, None)

    @classmethod
    def block(cls, src: int, dst: int) -> None:
        """Block the directed edge ``src -> dst`` (asymmetric link
        failure: src's frames to dst vanish; dst -> src still flows)."""
        with cls._lock:
            cls._blocked.add((int(src), int(dst)))
            cls.enabled = True

    @classmethod
    def unblock(cls, src: int, dst: int) -> None:
        with cls._lock:
            cls._blocked.discard((int(src), int(dst)))

    @classmethod
    def partition(cls, sets: List[Set[int]]) -> None:
        """Full partition: block both directions of every edge that
        crosses two of the given node sets."""
        with cls._lock:
            for i, a in enumerate(sets):
                for b in sets[i + 1:]:
                    for s in a:
                        for d in b:
                            cls._blocked.add((int(s), int(d)))
                            cls._blocked.add((int(d), int(s)))
            cls.enabled = True

    @classmethod
    def heal(cls) -> None:
        """Clear every partition edge (link rules stay)."""
        with cls._lock:
            cls._blocked.clear()

    @classmethod
    def clear(cls) -> None:
        """Remove all rules, partitions, and counters; disable."""
        with cls._lock:
            cls._rules.clear()
            cls._blocked.clear()
            cls._rngs.clear()
            cls._per_pair.clear()
            cls.n_dropped = cls.n_blocked = 0
            cls.n_delayed = cls.n_reordered = 0
            cls.enabled = False

    @classmethod
    def reset(cls) -> None:
        """clear() + default seed (the test-harness hygiene hook)."""
        cls.clear()
        with cls._lock:
            cls.seed = 0

    @classmethod
    def configure_from_pc(cls) -> None:
        """Mirror the ``PC.CHAOS_*`` knobs into the plane at node boot
        (only-enable, like the tracing knobs: defaults-off keys leave a
        programmatically configured plane alone)."""
        from gigapaxos_tpu_torch.paxos.paxosconfig import PC
        from gigapaxos_tpu_torch.utils.config import Config
        seed = int(Config.get(PC.CHAOS_SEED))
        delay = float(Config.get(PC.CHAOS_DELAY_MS)) / 1e3
        jitter = float(Config.get(PC.CHAOS_JITTER_MS)) / 1e3
        drop = float(Config.get(PC.CHAOS_DROP))
        reorder = float(Config.get(PC.CHAOS_REORDER))
        part = str(Config.get(PC.CHAOS_PARTITION))
        if seed:
            cls.configure(seed=seed)
        if delay or jitter or drop or reorder:
            cls.set_link(None, None, delay_s=delay, jitter_s=jitter,
                         drop_p=drop, reorder_p=reorder)
        sets = parse_partition_spec(part)
        if sets:
            cls.partition(sets)

    # -- the transport-facing verdict --------------------------------------

    @classmethod
    def _rule_for(cls, src: int, dst: int) -> Optional[LinkRule]:
        """Most-specific rule wins: (src,dst) > (src,*) > (*,dst) > (*,*).
        Caller holds the lock."""
        r = cls._rules
        return (r.get((src, dst)) or r.get((src, None))
                or r.get((None, dst)) or r.get((None, None)))

    @classmethod
    def _decide(cls, rule: Optional[LinkRule],
                rng: Random) -> Tuple[bool, float, bool]:
        """(drop, delay_s, reordered) for one frame under ``rule``.
        Pure in (rule, rng state) — shared by the live path and the
        fingerprint so they can never diverge."""
        if rule is None:
            return False, 0.0, False
        if rule.drop_p and rng.random() < rule.drop_p:
            return True, 0.0, False
        delay = rule.delay_s
        if rule.jitter_s:
            delay += rule.jitter_s * rng.random()
        if rule.reorder_p and rng.random() < rule.reorder_p:
            # hold one extra beat so frames sent after this one overtake
            # it (the netem reorder idiom)
            return False, delay + rule.delay_s + rule.jitter_s + 2e-3, \
                True
        return False, delay, False

    @classmethod
    def on_send(cls, src: int, dst: int,
                nframes: int) -> Tuple[bool, float]:
        """Verdict for one outbound payload on the peer link
        ``src -> dst``: ``(drop, delay_s)``.  Called by the transport
        only while :attr:`enabled`."""
        pair = (int(src), int(dst))
        with cls._lock:
            if pair in cls._blocked:
                cls.n_blocked += nframes
                cls._per_pair.setdefault(pair, [0, 0, 0, 0])[1] += \
                    nframes
                return True, 0.0
            rule = cls._rule_for(*pair)
            if rule is None:
                # unfaulted pair: no counter entry either — per_pair in
                # the snapshot lists only links the plane actually hit
                return False, 0.0
            rng = cls._rngs.get(pair)
            if rng is None:
                rng = cls._rngs[pair] = Random(
                    _pair_seed(cls.seed, *pair))
            drop, delay, reordered = cls._decide(rule, rng)
            if drop or delay > 0.0:
                pp = cls._per_pair.setdefault(pair, [0, 0, 0, 0])
                if drop:
                    cls.n_dropped += nframes
                    pp[0] += nframes
                else:
                    cls.n_delayed += nframes
                    pp[2] += nframes
                    if reordered:
                        cls.n_reordered += nframes
                        pp[3] += nframes
            return drop, delay

    @classmethod
    def is_blocked(cls, src: int, dst: int) -> bool:
        """Partition check only (the paced checkpoint-transfer path:
        a partition must starve it, but per-frame jitter on a paced
        bulk transfer would only distort its own flow control)."""
        with cls._lock:
            return (int(src), int(dst)) in cls._blocked

    # -- replay proof -------------------------------------------------------

    @classmethod
    def schedule_fingerprint(cls, pairs: List[Tuple[int, int]],
                             k: int = 256) -> str:
        """Digest of the first ``k`` would-be decisions per pair under
        the CURRENT rules and seed, computed from fresh PRNGs (live
        streams are not consumed).  Two runs with the same seed and
        rules produce the same fingerprint — the scenario rows carry it
        so "replays exactly" is checkable, not folklore."""
        # fold the seed and the partition edges in too: a partition-only
        # schedule (no probabilistic rules) still fingerprints its
        # topology rather than degenerating to a constant
        acc = _pair_seed(cls.seed, 0, 0)
        with cls._lock:
            for s, d in sorted(cls._blocked):
                acc = ((acc * _GOLD) ^ _pair_seed(1, s, d)) & _M64
            for pair in sorted(set((int(s), int(d)) for s, d in pairs)):
                rule = cls._rule_for(*pair)
                rng = Random(_pair_seed(cls.seed, *pair))
                for _ in range(k):
                    drop, delay, _ro = cls._decide(rule, rng)
                    word = (int(drop) << 62) ^ int(delay * 1e9)
                    acc = ((acc * _GOLD) ^ word) & _M64
        return f"{acc:016x}"

    # -- observability ------------------------------------------------------

    @classmethod
    def snapshot(cls) -> dict:
        """The ``/chaos`` JSON view: config + injected-fault counters."""
        with cls._lock:
            def k(s):
                return "*" if s is None else s
            return {
                "enabled": cls.enabled,
                "seed": cls.seed,
                "rules": {f"{k(s)}->{k(d)}": r.asdict()
                          for (s, d), r in sorted(
                              cls._rules.items(),
                              key=lambda it: (str(it[0][0]),
                                              str(it[0][1])))},
                "blocked": sorted(f"{s}->{d}" for s, d in cls._blocked),
                "injected": {
                    "dropped": cls.n_dropped,
                    "blocked": cls.n_blocked,
                    "delayed": cls.n_delayed,
                    "reordered": cls.n_reordered,
                    "per_pair": {f"{s}->{d}": {
                        "dropped": v[0], "blocked": v[1],
                        "delayed": v[2], "reordered": v[3]}
                        for (s, d), v in sorted(cls._per_pair.items())},
                },
            }

    # -- the /chaos HTTP control routes ------------------------------------

    @classmethod
    def http_route(cls, path: str):
        """GET routes for the statshttp listener / gateway (the runtime
        control face; the listener is GET-only by design, so control is
        query-string verbs — a diagnostic plane, not a public API):

        - ``/chaos``                        -> state snapshot
        - ``/chaos/set?src=0&dst=1&delay_ms=5&jitter_ms=2&drop=0.01&``
          ``reorder=0.05``                  (omit src/dst = wildcard)
        - ``/chaos/partition?sets=0,1|2``   -> full partition
        - ``/chaos/block?src=0&dst=1``      -> asymmetric edge
        - ``/chaos/heal``                   -> clear partitions
        - ``/chaos/clear``                  -> remove everything, disable
        - ``/chaos/seed?v=123``             -> reseed (fresh streams)

        Returns ``(status, content_type, body)`` or None (no match).
        """
        path, _, query = path.partition("?")
        if path != "/chaos" and not path.startswith("/chaos/"):
            return None
        q = {k: v[-1] for k, v in parse_qs(query).items()}
        verb = path[len("/chaos"):].strip("/")
        try:
            if verb == "":
                pass  # snapshot only
            elif verb == "set":
                cls.set_link(
                    int(q["src"]) if "src" in q else None,
                    int(q["dst"]) if "dst" in q else None,
                    delay_s=float(q.get("delay_ms", 0)) / 1e3,
                    jitter_s=float(q.get("jitter_ms", 0)) / 1e3,
                    drop_p=float(q.get("drop", 0)),
                    reorder_p=float(q.get("reorder", 0)))
            elif verb == "partition":
                sets = parse_partition_spec(q.get("sets", ""))
                if not sets:
                    raise ValueError("sets=0,1|2 required")
                cls.partition(sets)
            elif verb == "block":
                cls.block(int(q["src"]), int(q["dst"]))
            elif verb == "unblock":
                cls.unblock(int(q["src"]), int(q["dst"]))
            elif verb == "heal":
                cls.heal()
            elif verb == "clear":
                cls.clear()
            elif verb == "seed":
                cls.configure(seed=int(q["v"]))
            else:
                return ("404 Not Found", "application/json",
                        b'{"err":"no such chaos verb"}')
        except (KeyError, ValueError) as exc:
            return ("400 Bad Request", "application/json",
                    json.dumps({"err": str(exc)}).encode())
        return ("200 OK", "application/json",
                json.dumps(cls.snapshot()).encode())


class StorageRule:
    """Fault parameters for one (possibly wildcard) (node, segment)."""

    __slots__ = ("fsync_eio_p", "fsync_persist", "enospc_p",
                 "fsync_delay_s", "fsync_jitter_s", "torn_p")

    def __init__(self, fsync_eio_p: float = 0.0,
                 fsync_persist: bool = False, enospc_p: float = 0.0,
                 fsync_delay_s: float = 0.0, fsync_jitter_s: float = 0.0,
                 torn_p: float = 0.0):
        self.fsync_eio_p = min(1.0, max(0.0, float(fsync_eio_p)))
        self.fsync_persist = bool(fsync_persist)
        self.enospc_p = min(1.0, max(0.0, float(enospc_p)))
        self.fsync_delay_s = max(0.0, float(fsync_delay_s))
        self.fsync_jitter_s = max(0.0, float(fsync_jitter_s))
        self.torn_p = min(1.0, max(0.0, float(torn_p)))

    def asdict(self) -> dict:
        return {"fsync_eio": self.fsync_eio_p,
                "fsync_persist": self.fsync_persist,
                "enospc": self.enospc_p,
                "fsync_delay_ms": round(self.fsync_delay_s * 1e3, 3),
                "fsync_jitter_ms": round(self.fsync_jitter_s * 1e3, 3),
                "torn": self.torn_p}


class StorageChaos:
    """The disk sibling of :class:`ChaosPlane`: deterministic fault
    injection on the WAL/checkpoint IO path, keyed per
    ``(node, segment)`` with the same seeded golden-ratio discipline
    (per-pair PRNG streams consumed in that lane's IO order, pure
    :meth:`_decide` shared with :meth:`schedule_fingerprint`).

    Verdicts the :class:`~gigapaxos_tpu_torch.paxos.logger.PaxosLogger` shim
    consults (only while :attr:`enabled` — disabled costs the fsync
    path one class-attribute check):

    - :meth:`on_fsync` — EIO (transient, or latched persistent so the
      rotated-to generation fails too: the degraded-mode driver) and
      slow-fsync latency
    - :meth:`on_append` — ENOSPC, and short/torn appends (only a
      prefix of the buffer lands, the crash shape recovery's torn-tail
      check absorbs)

    Post-crash bit-flip corruption at a chosen record is the offline
    half of the plane: ``paxos.logger.corrupt_wal_record`` flips bytes
    in a segment file while the node is down (scenarios call it
    between kill and restart).
    """

    enabled: bool = False

    seed: int = 0
    _lock = threading.Lock()
    # (node|None, seg|None) -> StorageRule; None = wildcard
    _rules: Dict[Tuple[Optional[int], Optional[int]], StorageRule] = {}
    _rngs: Dict[Tuple[int, int], Random] = {}   # lazily minted per pair
    # persistent-EIO latch: once an fsync fails on a pair under a
    # fsync_persist rule, every later fsync there fails too — across
    # handle rotation (the fd is new, the device is still broken)
    _poisoned: Set[Tuple[int, int]] = set()
    n_fsync_eio: int = 0
    n_enospc: int = 0
    n_slow: int = 0
    n_torn: int = 0
    _per_pair: Dict[Tuple[int, int], List[int]] = {}  # [eio,nospc,slow,torn]

    # -- configuration -----------------------------------------------------

    @classmethod
    def configure(cls, seed: Optional[int] = None,
                  enabled: Optional[bool] = None) -> None:
        with cls._lock:
            if seed is not None:
                cls.seed = int(seed)
                cls._rngs.clear()  # new seed -> fresh decision streams
            if enabled is not None:
                cls.enabled = bool(enabled)

    @classmethod
    def set_rule(cls, node: Optional[int], seg: Optional[int],
                 fsync_eio_p: float = 0.0, fsync_persist: bool = False,
                 enospc_p: float = 0.0, fsync_delay_s: float = 0.0,
                 fsync_jitter_s: float = 0.0,
                 torn_p: float = 0.0) -> None:
        """Install a fault rule for ``(node, seg)`` (``None`` =
        wildcard on that side).  A rule with every probability and
        delay zero removes the entry.  Enables the plane."""
        key = (None if node is None else int(node),
               None if seg is None else int(seg))
        rule = StorageRule(fsync_eio_p, fsync_persist, enospc_p,
                           fsync_delay_s, fsync_jitter_s, torn_p)
        with cls._lock:
            if rule.fsync_eio_p or rule.enospc_p or rule.fsync_delay_s \
                    or rule.fsync_jitter_s or rule.torn_p:
                cls._rules[key] = rule
                cls.enabled = True
            else:
                cls._rules.pop(key, None)

    @classmethod
    def clear(cls) -> None:
        """Remove all rules, latches, and counters; disable."""
        with cls._lock:
            cls._rules.clear()
            cls._rngs.clear()
            cls._poisoned.clear()
            cls._per_pair.clear()
            cls.n_fsync_eio = cls.n_enospc = 0
            cls.n_slow = cls.n_torn = 0
            cls.enabled = False

    @classmethod
    def reset(cls) -> None:
        """clear() + default seed (the test-harness hygiene hook)."""
        cls.clear()
        with cls._lock:
            cls.seed = 0

    @classmethod
    def configure_from_pc(cls) -> None:
        """Mirror the ``PC.STORAGE_CHAOS_*`` knobs into the plane at
        node boot (only-enable, like ``ChaosPlane``)."""
        from gigapaxos_tpu_torch.paxos.paxosconfig import PC
        from gigapaxos_tpu_torch.utils.config import Config
        seed = int(Config.get(PC.STORAGE_CHAOS_SEED))
        eio = float(Config.get(PC.STORAGE_CHAOS_FSYNC_EIO))
        persist = bool(Config.get(PC.STORAGE_CHAOS_FSYNC_PERSIST))
        enospc = float(Config.get(PC.STORAGE_CHAOS_ENOSPC))
        delay = float(Config.get(PC.STORAGE_CHAOS_FSYNC_DELAY_MS)) / 1e3
        jitter = float(
            Config.get(PC.STORAGE_CHAOS_FSYNC_JITTER_MS)) / 1e3
        torn = float(Config.get(PC.STORAGE_CHAOS_TORN))
        if seed:
            cls.configure(seed=seed)
        if eio or enospc or delay or jitter or torn:
            cls.set_rule(None, None, fsync_eio_p=eio,
                         fsync_persist=persist, enospc_p=enospc,
                         fsync_delay_s=delay, fsync_jitter_s=jitter,
                         torn_p=torn)

    # -- the logger-facing verdicts ----------------------------------------

    @classmethod
    def _rule_for(cls, node: int, seg: int) -> Optional[StorageRule]:
        """Most-specific wins: (n,s) > (n,*) > (*,s) > (*,*).
        Caller holds the lock."""
        r = cls._rules
        return (r.get((node, seg)) or r.get((node, None))
                or r.get((None, seg)) or r.get((None, None)))

    @classmethod
    def _decide(cls, rule: Optional[StorageRule],
                rng: Random) -> Tuple[bool, bool, float, float]:
        """(fsync_eio, enospc, fsync_delay_s, torn_frac) for one IO op
        under ``rule``; ``torn_frac`` is 0.0 (not torn) or the fraction
        of the buffer that lands.  Pure in (rule, rng state) — shared
        by the live path and the fingerprint."""
        if rule is None:
            return False, False, 0.0, 0.0
        eio = bool(rule.fsync_eio_p) and rng.random() < rule.fsync_eio_p
        enospc = bool(rule.enospc_p) and rng.random() < rule.enospc_p
        delay = rule.fsync_delay_s
        if rule.fsync_jitter_s:
            delay += rule.fsync_jitter_s * rng.random()
        torn = 0.0
        if rule.torn_p and rng.random() < rule.torn_p:
            torn = rng.random()
        return eio, enospc, delay, torn

    @classmethod
    def _pair_state(cls, pair: Tuple[int, int]):
        """(rule, rng) for a pair, minting the rng lazily.
        Caller holds the lock."""
        rule = cls._rule_for(*pair)
        if rule is None:
            return None, None
        rng = cls._rngs.get(pair)
        if rng is None:
            rng = cls._rngs[pair] = Random(_pair_seed(cls.seed, *pair))
        return rule, rng

    @classmethod
    def on_fsync(cls, node: int, seg: int) -> Tuple[bool, float]:
        """Verdict for one fsync on ``(node, seg)``:
        ``(fail_with_eio, delay_s)``."""
        pair = (int(node), int(seg))
        with cls._lock:
            if pair in cls._poisoned:
                cls.n_fsync_eio += 1
                cls._per_pair.setdefault(pair, [0, 0, 0, 0])[0] += 1
                return True, 0.0
            rule, rng = cls._pair_state(pair)
            if rule is None:
                return False, 0.0
            eio, _enospc, delay, _torn = cls._decide(rule, rng)
            if eio:
                cls.n_fsync_eio += 1
                cls._per_pair.setdefault(pair, [0, 0, 0, 0])[0] += 1
                if rule.fsync_persist:
                    cls._poisoned.add(pair)
                return True, 0.0
            if delay > 0.0:
                cls.n_slow += 1
                cls._per_pair.setdefault(pair, [0, 0, 0, 0])[2] += 1
            return False, delay

    @classmethod
    def is_poisoned(cls, node: int, seg: int) -> bool:
        """Latch-only query (no PRNG draw): has a persistent-EIO rule
        latched this pair's device dead?  The logger's ROTATION path
        asks this instead of :meth:`on_fsync` — a transient EIO models
        a one-shot error reported against the old fd's dirty pages, so
        a fresh handle succeeds and rotation saves the batch; only a
        latched (whole-device) failure makes rotation fail too and tips
        the node into degraded mode.  Keeping the query draw-free also
        keeps each pair's decision stream (and with it
        :meth:`schedule_fingerprint`) independent of rotation timing."""
        pair = (int(node), int(seg))
        with cls._lock:
            if pair not in cls._poisoned:
                return False
            cls.n_fsync_eio += 1
            cls._per_pair.setdefault(pair, [0, 0, 0, 0])[0] += 1
            return True

    @classmethod
    def on_append(cls, node: int, seg: int,
                  nbytes: int) -> Tuple[bool, int]:
        """Verdict for one append of ``nbytes`` on ``(node, seg)``:
        ``(fail_with_enospc, bytes_that_land)``.  A torn verdict keeps
        only a proper prefix (never the full buffer, never on a
        1-byte write)."""
        pair = (int(node), int(seg))
        with cls._lock:
            rule, rng = cls._pair_state(pair)
            if rule is None:
                return False, nbytes
            _eio, enospc, _delay, torn = cls._decide(rule, rng)
            if enospc:
                cls.n_enospc += 1
                cls._per_pair.setdefault(pair, [0, 0, 0, 0])[1] += 1
                return True, nbytes
            if torn > 0.0 and nbytes > 1:
                cls.n_torn += 1
                cls._per_pair.setdefault(pair, [0, 0, 0, 0])[3] += 1
                return False, max(1, min(nbytes - 1,
                                         int(nbytes * torn)))
            return False, nbytes

    # -- replay proof -------------------------------------------------------

    @classmethod
    def schedule_fingerprint(cls, pairs: List[Tuple[int, int]],
                             k: int = 256) -> str:
        """Digest of the first ``k`` would-be decisions per
        ``(node, seg)`` pair under the CURRENT rules and seed, from
        fresh PRNGs (live streams are not consumed).  The persistent-
        EIO latch set is folded in too: it evolves deterministically
        from the decision stream, so identical replays latch
        identically."""
        acc = _pair_seed(cls.seed, 0, 0)
        with cls._lock:
            for n, s in sorted(cls._poisoned):
                acc = ((acc * _GOLD) ^ _pair_seed(2, n, s)) & _M64
            for pair in sorted(set((int(n), int(s)) for n, s in pairs)):
                rule = cls._rule_for(*pair)
                rng = Random(_pair_seed(cls.seed, *pair))
                for _ in range(k):
                    eio, enospc, delay, torn = cls._decide(rule, rng)
                    word = ((int(eio) << 63) ^ (int(enospc) << 62)
                            ^ (int(torn > 0.0) << 61)
                            ^ int(delay * 1e9))
                    acc = ((acc * _GOLD) ^ word) & _M64
        return f"{acc:016x}"

    # -- observability ------------------------------------------------------

    @classmethod
    def snapshot(cls) -> dict:
        """The ``/storage`` JSON view: config + injected counters."""
        with cls._lock:
            def k(s):
                return "*" if s is None else s
            return {
                "enabled": cls.enabled,
                "seed": cls.seed,
                "rules": {f"{k(n)}/{k(s)}": r.asdict()
                          for (n, s), r in sorted(
                              cls._rules.items(),
                              key=lambda it: (str(it[0][0]),
                                              str(it[0][1])))},
                "poisoned": sorted(f"{n}/{s}"
                                   for n, s in cls._poisoned),
                "injected": {
                    "fsync_eio": cls.n_fsync_eio,
                    "enospc": cls.n_enospc,
                    "slow_fsync": cls.n_slow,
                    "torn": cls.n_torn,
                    "per_pair": {f"{n}/{s}": {
                        "fsync_eio": v[0], "enospc": v[1],
                        "slow_fsync": v[2], "torn": v[3]}
                        for (n, s), v in sorted(cls._per_pair.items())},
                },
            }

    # -- the /storage HTTP control routes ----------------------------------

    @classmethod
    def http_route(cls, path: str):
        """GET routes for the statshttp listener (query-string verbs,
        like ``/chaos``):

        - ``/storage``                      -> state snapshot
        - ``/storage/set?node=0&seg=1&fsync_eio=0.5&persist=1&``
          ``enospc=0.1&fsync_delay_ms=5&fsync_jitter_ms=2&torn=0.01``
          (omit node/seg = wildcard)
        - ``/storage/clear``                -> remove everything, disable
        - ``/storage/seed?v=123``           -> reseed (fresh streams)

        Returns ``(status, content_type, body)`` or None (no match).
        """
        path, _, query = path.partition("?")
        if path != "/storage" and not path.startswith("/storage/"):
            return None
        q = {k: v[-1] for k, v in parse_qs(query).items()}
        verb = path[len("/storage"):].strip("/")
        try:
            if verb == "":
                pass  # snapshot only
            elif verb == "set":
                cls.set_rule(
                    int(q["node"]) if "node" in q else None,
                    int(q["seg"]) if "seg" in q else None,
                    fsync_eio_p=float(q.get("fsync_eio", 0)),
                    fsync_persist=bool(int(q.get("persist", 0))),
                    enospc_p=float(q.get("enospc", 0)),
                    fsync_delay_s=float(q.get("fsync_delay_ms", 0))
                    / 1e3,
                    fsync_jitter_s=float(q.get("fsync_jitter_ms", 0))
                    / 1e3,
                    torn_p=float(q.get("torn", 0)))
            elif verb == "clear":
                cls.clear()
            elif verb == "seed":
                cls.configure(seed=int(q["v"]))
            else:
                return ("404 Not Found", "application/json",
                        b'{"err":"no such storage verb"}')
        except (KeyError, ValueError) as exc:
            return ("400 Bad Request", "application/json",
                    json.dumps({"err": str(exc)}).encode())
        return ("200 OK", "application/json",
                json.dumps(cls.snapshot()).encode())
