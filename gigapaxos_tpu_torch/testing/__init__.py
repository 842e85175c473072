"""Single-process multi-node emulation of the port.

The port's own copy of ``gigapaxos_tpu/testing/``'s harness and
windowed load generator: N ``PaxosNode``s in one process over REAL
loopback sockets (ref ``gigapaxos/testing/TESTPaxosMain.java``).
"""

from gigapaxos_tpu_torch.testing.harness import PaxosEmulation

__all__ = ["PaxosEmulation"]
