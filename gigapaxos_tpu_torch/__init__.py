"""gigapaxos_tpu_torch — the PyTorch/CUDA port of ``gigapaxos_tpu``.

The columnar consensus data plane (all groups' acceptor and coordinator
state as ``[G]`` / ``[G, W, k]`` int32 device tensors) and the
``AcceptorBackend`` SPI engine that drives it, on an NVIDIA H100.  The
JAX package beside it is the reference: every state plane and every
live-lane output of this package is held bit-for-bit against it.

The package imports ``torch`` and never ``jax``, and nothing of
``gigapaxos_tpu``: what it needs from that package's pure-Python modules
it keeps as its own copy.  Its entry points (``ops.make_state``,
``ops.storm.make_fleet``, ``paxos.backend.ColumnarBackend``) run on
``device="cuda"`` unless the caller asks for the CPU.

Layout (mirrors ``gigapaxos_tpu``):

- ``ops``   — state layout, the torch-op kernel bodies, the hand-written
              Hopper accept kernel (``ops/csrc/accept.cu``) and its
              nvcc build step, the decide-storm step
- ``paxos`` — the ``AcceptorBackend`` SPI, ``ScalarBackend`` and the
              columnar engine ``ColumnarBackend``
- ``utils`` — the delay profiler and request instrumenter
"""

__version__ = "0.1.0"
