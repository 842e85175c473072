"""L2: the node runtime and the ``AcceptorBackend`` SPI, on torch.

Reference analog: ``gigapaxos_tpu.paxos``.  ``manager.PaxosNode`` (the
node runtime), ``client`` (``PaxosClient``/``PaxosClientAsync``),
``packets`` (the wire format, byte for byte), ``logger`` (WAL and
checkpoints, byte-compatible), ``grouptable``, ``interfaces`` (the
``Replicable`` apps), ``paxosconfig`` (the ``PC`` knobs) and ``backend``
(the SPI, ``ScalarBackend`` and the CUDA ``ColumnarBackend``).
"""
