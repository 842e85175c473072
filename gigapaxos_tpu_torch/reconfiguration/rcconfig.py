"""Reconfiguration-layer config keys.

The port's own copy of ``gigapaxos_tpu/reconfiguration/rcconfig.py`` (pure
Python, unchanged but for its imports).

Reference analog: ``reconfiguration/ReconfigurationConfig.java`` — the
``RC`` enum beside the paxos ``PC`` enum, in the same layered
enum-keyed ``Config`` system (code default < properties file < env <
programmatic set; see ``utils/config.py``).  Round-2 verdict row 39:
these knobs were constructor kwargs only; now the enum is the source of
defaults and kwargs remain as per-instance overrides.
"""

from __future__ import annotations

from gigapaxos_tpu_torch.utils.config import ConfigKey


class RC(ConfigKey):
    """Reconfiguration knobs; member value = typed code default."""

    # replicas per service name (ref: DEFAULT_ACTIVE_REPLICAS)
    ACTIVES_PER_NAME = 3
    # members per reconfigurator paxos group
    RC_GROUP_SIZE = 3
    # epoch-FSM re-drive period for records stuck in WAIT_* states
    RETRY_S = 1.0
    # active replicas report demand after this many requests per name
    DEMAND_REPORT_EVERY = 100
    # client-side: batched name ops per wire batch (appclient helpers)
    CLIENT_BATCH = 2048
