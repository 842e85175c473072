"""Reconfiguration control plane (L4).

The port's own copy of ``gigapaxos_tpu/reconfiguration/__init__.py``,
with the same names, each loaded from its submodule on first use.

Reference analog: ``src/edu/umass/cs/reconfiguration/`` — the substrate
that creates/deletes/moves replica groups online.  The control plane
*itself* runs on the same paxos engine (its own "RC groups" among the
reconfigurator nodes), exactly like the reference's layered re-entrancy
(SURVEY.md §3.4).
"""

import importlib

# name -> submodule; loaded on first use (PEP 562), so that importing a
# torch-free submodule (the console client's appclient, node.NodeConfig)
# does not pull in the node runtime through this package
_EXPORTS = {
    "ActiveReplica": "activereplica",
    "ReconfigurableAppClient": "appclient",
    "ConsistentHashing": "consistenthash",
    "AbstractReplicaCoordinator": "coordinator",
    "PaxosReplicaCoordinator": "coordinator",
    "AbstractDemandProfile": "demand",
    "LoadBalancingDemandProfile": "demand",
    "LocalityDemandProfile": "demand",
    "ReconfigurableNode": "node",
    "RCRecord": "rcdb",
    "ReconfiguratorDB": "rcdb",
    "Reconfigurator": "reconfigurator",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


__all__ = [
    "ActiveReplica", "ReconfigurableAppClient", "ConsistentHashing",
    "AbstractReplicaCoordinator", "PaxosReplicaCoordinator",
    "AbstractDemandProfile", "LoadBalancingDemandProfile",
    "LocalityDemandProfile",
    "ReconfigurableNode", "RCRecord", "ReconfiguratorDB", "Reconfigurator",
]
