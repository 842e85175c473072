"""Process entry point: boot a node's roles from a node config.

The port's own copy of ``gigapaxos_tpu/reconfiguration/node.py`` (pure
Python): every role's ``PaxosNode`` resolves its backend through the
port's ``PC.BACKEND`` and ``PC.COLUMNAR_DEVICE``, so a node runs on the
card by default.  The roles' modules load when a node is built, so
``NodeConfig`` (the console client's and the gateway's import) comes
without torch.

Reference analog: ``reconfiguration/ReconfigurableNode.java`` — reads the
node map (``active.NAME=host:port`` / ``reconfigurator.NAME=host:port``)
and boots an :class:`ActiveReplica` and/or :class:`Reconfigurator` for this
node's roles (SURVEY.md §3.2).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

from gigapaxos_tpu_torch.paxos.interfaces import Replicable

if TYPE_CHECKING:
    from gigapaxos_tpu_torch.reconfiguration.activereplica import \
        ActiveReplica
    from gigapaxos_tpu_torch.reconfiguration.reconfigurator import \
        Reconfigurator


@dataclass
class NodeConfig:
    """The cluster map (ref: ``ReconfigurableNodeConfig`` +
    ``gigapaxos.properties`` node entries).  Active and reconfigurator ids
    must be disjoint."""

    actives: Dict[int, Tuple[str, int]]
    reconfigurators: Dict[int, Tuple[str, int]]
    # None -> the RC config enum's layered default (rcconfig.RC)
    actives_per_name: Optional[int] = None
    rc_group_size: Optional[int] = None

    def __post_init__(self):
        from gigapaxos_tpu_torch.reconfiguration.rcconfig import RC
        from gigapaxos_tpu_torch.utils.config import Config
        if self.actives_per_name is None:
            self.actives_per_name = int(Config.get(RC.ACTIVES_PER_NAME))
        if self.rc_group_size is None:
            self.rc_group_size = int(Config.get(RC.RC_GROUP_SIZE))
        overlap = set(self.actives) & set(self.reconfigurators)
        if overlap:
            raise ValueError(f"ids in both roles: {overlap}")

    @property
    def addr_map(self) -> Dict[int, Tuple[str, int]]:
        m = dict(self.actives)
        m.update(self.reconfigurators)
        return m

    @classmethod
    def from_properties(cls, path: str, **kw) -> "NodeConfig":
        """Parse ``active.<id>=host:port`` / ``reconfigurator.<id>=host:port``
        lines (ref: ``PaxosConfig`` ACTIVE.*/RECONFIGURATOR.* parsing)."""
        actives: Dict[int, Tuple[str, int]] = {}
        rcs: Dict[int, Tuple[str, int]] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                k, v = k.strip(), v.strip()
                if ":" not in v:
                    continue
                host, port = v.rsplit(":", 1)
                if k.startswith("active."):
                    actives[int(k.split(".", 1)[1])] = (host, int(port))
                elif k.startswith("reconfigurator."):
                    rcs[int(k.split(".", 1)[1])] = (host, int(port))
        return cls(actives, rcs, **kw)


class ReconfigurableNode:
    """Boots this node's roles and owns their lifecycles."""

    def __init__(self, node_id: int, config: NodeConfig,
                 app_factory: Callable[[], Replicable], logdir: str,
                 demand_policy=None,
                 demand_report_every: Optional[int] = None,
                 **node_kw):
        # the roles (and with them the node runtime and torch) load here,
        # not at import: the console client and the HTTP gateway import
        # NodeConfig from this module and start without torch
        from gigapaxos_tpu_torch.reconfiguration.activereplica import \
            ActiveReplica
        from gigapaxos_tpu_torch.reconfiguration.reconfigurator import \
            Reconfigurator
        self.id = node_id
        self.config = config
        self.logdir = logdir
        self.active: Optional[ActiveReplica] = None
        self.reconfigurator: Optional[Reconfigurator] = None
        self._stats_dumper = None
        amap = config.addr_map
        if node_id in config.actives:
            self.active = ActiveReplica(
                node_id, amap, tuple(config.reconfigurators),
                app_factory(), os.path.join(logdir, f"ar{node_id}"),
                demand_report_every=demand_report_every, **node_kw)
        if node_id in config.reconfigurators:
            self.reconfigurator = Reconfigurator(
                node_id, amap, tuple(config.reconfigurators),
                tuple(config.actives),
                os.path.join(logdir, f"rc{node_id}"),
                actives_per_name=config.actives_per_name,
                rc_group_size=config.rc_group_size,
                demand_policy=demand_policy, **node_kw)
        if self.active is None and self.reconfigurator is None:
            raise ValueError(f"node {node_id} has no role in the config")

    def start(self) -> None:
        if self.active:
            self.active.start()
        if self.reconfigurator:
            self.reconfigurator.start()
        # periodic stats dump (ref: ReconfigurableNode's periodic
        # DelayProfiler/NIOInstrumenter log lines): PC.STATS_DUMP_S > 0
        # logs the one-line render every interval; PC.STATS_JSON also
        # appends full metrics() snapshots as JSONL under the logdir
        from gigapaxos_tpu_torch.paxos.paxosconfig import PC
        from gigapaxos_tpu_torch.utils.config import Config
        every = float(Config.get(PC.STATS_DUMP_S))
        if every > 0:
            import os as _os

            from gigapaxos_tpu_torch.utils.statsdump import StatsDumper
            jsonl = _os.path.join(self.logdir,
                                  f"stats{self.id}.jsonl") \
                if bool(Config.get(PC.STATS_JSON)) else None
            self._stats_dumper = StatsDumper(
                lambda: (self.stats(),
                         self.metrics() if jsonl else None),
                every, jsonl, name=f"gp-stats-{self.id}")
            self._stats_dumper.start()

    def stop(self) -> None:
        if self._stats_dumper is not None:
            self._stats_dumper.stop()
            self._stats_dumper = None
        if self.active:
            self.active.stop()
        if self.reconfigurator:
            self.reconfigurator.stop()

    def metrics(self) -> dict:
        """Structured metrics for every role this node holds (each
        role's dict is its PaxosNode's ``metrics()``)."""
        out: dict = {"node": self.id, "roles": {}}
        if self.active:
            out["roles"]["active"] = self.active.node.metrics()
        if self.reconfigurator:
            out["roles"]["reconfigurator"] = \
                self.reconfigurator.node.metrics()
        return out

    def stats(self) -> str:
        """One-line render across roles (thin formatter over
        :meth:`metrics`)."""
        parts = []
        if self.active:
            parts.append(f"ar[{self.active.node.stats()}]")
        if self.reconfigurator:
            parts.append(f"rc[{self.reconfigurator.node.stats()}]")
        return f"node {self.id}: " + " ".join(parts)
