"""L0 utilities of the port: the delay profiler and the request
instrumenter (copies of ``gigapaxos_tpu.utils``' pure-Python modules)."""

from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

__all__ = ["DelayProfiler"]
