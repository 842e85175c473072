"""Chaos plane of the port: the fault plane only.

The port's own copy of ``gigapaxos_tpu/chaos/faults.py``
(:class:`~gigapaxos_tpu_torch.chaos.faults.ChaosPlane` on the
transport's peer links, :class:`~gigapaxos_tpu_torch.chaos.faults.
StorageChaos` on the WAL), which the logger, the transport and the node
runtime hook at their top level.  Disabled (the default) each costs one
attribute check.  The scenario runner, the invariant checker and the CLI
of the JAX package's ``chaos/`` are not ported yet (ROADMAP module 13).
"""

from gigapaxos_tpu_torch.chaos.faults import ChaosPlane  # noqa: F401
