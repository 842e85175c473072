"""L1 transport: asyncio TCP with framing, demux, backpressure, TLS.

Reference analog: ``src/edu/umass/cs/nio/`` (NIOTransport,
MessageNIOTransport, MessageExtractor, AbstractPacketDemultiplexer,
JSONMessenger, SSLDataProcessingWorker, NIOInstrumenter).
"""

from gigapaxos_tpu_torch.net.transport import Transport, Demultiplexer

__all__ = ["Transport", "Demultiplexer"]
