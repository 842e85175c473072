"""gigapaxos_tpu_torch — the PyTorch/CUDA port of ``gigapaxos_tpu``.

The node runtime (``paxos.manager.PaxosNode`` with its transport, WAL,
group table and client) over the columnar consensus data plane (all
groups' acceptor and coordinator state as ``[G]`` / ``[G, W, k]`` int32
device tensors, driven through the ``AcceptorBackend`` SPI engine), on
an NVIDIA H100.  The JAX package beside it is the reference: every state
plane and every live-lane output of this package is held bit-for-bit
against it, and the wire and on-disk formats are the same bytes.

The package imports ``torch`` and never ``jax``, and nothing of
``gigapaxos_tpu``: what it needs from that package's pure-Python modules
it keeps as its own copy.  Its entry points (``ops.make_state``,
``ops.storm.make_fleet``, ``paxos.backend.ColumnarBackend``,
``paxos.manager.PaxosNode``) run on ``device="cuda"`` unless the caller
asks for the CPU.

Layout (mirrors ``gigapaxos_tpu``):

- ``ops``     — state layout, the torch-op kernel bodies, the
                hand-written Hopper accept kernel (``ops/csrc/accept.cu``)
                and its nvcc build step, the decide-storm step
- ``paxos``   — the node runtime, client, wire packets, WAL, group
                table, the ``AcceptorBackend`` SPI and its engines
- ``net``     — the asyncio TCP transport
- ``native``  — the host hot path in C++ (frame scan, request parse,
                response and WAL encode, key->row map), built by g++
- ``chaos``   — the fault plane the transport and WAL hook
- ``testing`` — the in-process multi-node emulation and load generator
- ``utils``   — config, logging, the delay profiler, the request
                instrumenter and the build ledger
"""

__version__ = "0.1.0"
