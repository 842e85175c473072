"""L2: the ``AcceptorBackend`` SPI and its engines, on torch.

Reference analog: ``gigapaxos_tpu.paxos.backend`` (the node runtime
around it is a later slice of the port).
"""
