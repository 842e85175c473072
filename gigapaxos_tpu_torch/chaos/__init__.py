"""Chaos plane of the port: fault injection, scenarios, invariants.

The port's own copy of ``gigapaxos_tpu/chaos/``:

- :mod:`faults` — the fault plane: :class:`~gigapaxos_tpu_torch.chaos.
  faults.ChaosPlane` on the transport's peer links and
  :class:`~gigapaxos_tpu_torch.chaos.faults.StorageChaos` on the WAL,
  which the logger, the transport and the node runtime hook at their top
  level.  Disabled (the default) each costs one attribute check.
- :mod:`scenarios` — the staged timelines (partitions, crashes, rolling
  restarts, an ``ENGINE_SHARDS`` storm, zipf-hot load, the storage
  storm) against an in-process cluster on the port's columnar engine.
- :mod:`invariants` — no acked request lost, one order per group,
  digests and exec cursors converged, ballot churn settled, storage
  healthy, read through the nodes' ``/groups`` and ``/stats``.

CLI::

    python -m gigapaxos_tpu_torch.chaos --scenarios partition_heal --seed 1
"""

from gigapaxos_tpu_torch.chaos.faults import ChaosPlane  # noqa: F401
