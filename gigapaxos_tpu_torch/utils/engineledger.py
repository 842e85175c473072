"""Build/load ledger: the device axis of the flight deck.

Port of ``gigapaxos_tpu/utils/engineledger.py``.  The reference counts
XLA compiles and persistent-cache hits through ``jax.monitoring``; the
port compiles no program at run time.  What it builds are its native
libraries — one ``nvcc`` run per CUDA source (``ops/_build.py``) and one
``g++`` run for the host hot path (``native/__init__.py``) — each into
a build directory named by a hash of its sources.  Those two builders
report here:

- :meth:`EngineLedger.note_build` — one library built (a "compile"),
  with its wall seconds; counted as a build-cache miss;
- :meth:`EngineLedger.note_load` — one library loaded; a load that
  needed no build is a build-cache hit.

torch does not trace, so nothing ever re-traces: ``retraces`` stays 0
and the reference's retrace alarm (warm-up bracket, blackbox triggers)
has no counterpart.  :meth:`snapshot` keeps the reference's keys, so
``metrics()["engine"]["ledger"]`` and ``engine_info()`` keep their
shape; :func:`cache_metrics` is the counterpart of
``utils/jaxcache.py:cache_metrics`` and reports the build directories.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIRS = (os.path.join(_PKG, "ops", "_build"),
              os.path.join(_PKG, "native", "_build"))


class EngineLedger:
    """Process-global build/load ledger (class-attribute singleton,
    like :class:`DelayProfiler`)."""

    _lock = threading.Lock()
    # library name -> {"compiles", "retraces", "compile_s", "last_ts",
    # "loads"}
    _kernels: Dict[str, dict] = {}
    # every build is seen directly by the builder that ran it
    monitoring = True
    cache_hits = 0
    cache_misses = 0
    compile_s = 0.0                  # aggregate build seconds

    @classmethod
    def _row(cls, name: str) -> dict:
        k = cls._kernels.get(name)
        if k is None:
            k = {"compiles": 0, "retraces": 0, "compile_s": 0.0,
                 "last_ts": 0.0, "loads": 0}
            cls._kernels[name] = k
        return k

    @classmethod
    def note_build(cls, name: str, seconds: float) -> None:
        """Library ``name`` was built now, in ``seconds`` of wall."""
        with cls._lock:
            k = cls._row(name)
            k["compiles"] += 1
            k["compile_s"] += seconds
            k["last_ts"] = time.time()
            cls.compile_s += seconds
            cls.cache_misses += 1

    @classmethod
    def note_load(cls, name: str, built: bool) -> None:
        """Library ``name`` was loaded; ``built`` says whether the load
        had to build it first (else it was found built on disk)."""
        with cls._lock:
            cls._row(name)["loads"] += 1
            if not built:
                cls.cache_hits += 1

    # -- views ---------------------------------------------------------

    @classmethod
    def snapshot(cls) -> dict:
        """JSON-able ledger state for ``metrics()`` / ``engine_info()``
        (the reference's keys)."""
        with cls._lock:
            kernels = {n: dict(k) for n, k in cls._kernels.items()}
            return {
                "kernels": len(kernels),
                "compiles": sum(k["compiles"] for k in kernels.values()),
                "retraces": 0,
                "compile_s": cls.compile_s,
                "cache_hits": cls.cache_hits,
                "cache_misses": cls.cache_misses,
                "monitoring": cls.monitoring,
                # a library is loaded: the engine can serve
                "warmed": any(k["loads"] for k in kernels.values()),
            }

    @classmethod
    def kernels(cls) -> Dict[str, dict]:
        """Per-library ledger rows for ``engine_kernels()``."""
        with cls._lock:
            return {n: dict(k) for n, k in cls._kernels.items()}


def cache_metrics() -> dict:
    """Build-cache telemetry for ``metrics()`` / ``engine_info()``: the
    build directories, loads that found their library built (hits) and
    builds (misses)."""
    return {
        "active": True,
        "dir": list(BUILD_DIRS),
        "hits": EngineLedger.cache_hits,
        "misses": EngineLedger.cache_misses,
    }


def kernel_launches() -> Dict[str, int]:
    """This process's launches of each hand-written kernel, by library
    and kernel (``cuda:accept``, ``cuda:commit``, ``cuda:propose``,
    ``cuda:accept_reply``, ``cuda:acceptor_wave``,
    ``cuda:coordinator_wave``); 0 off the card, where the wrappers run
    their plain versions."""
    from gigapaxos_tpu_torch.ops import (accept_cuda, accept_reply_cuda,
                                         commit_cuda, propose_cuda,
                                         wave_cuda)
    return {f"cuda:{k.name}": k.launches
            for k in (accept_cuda.accept, commit_cuda.commit,
                      propose_cuda.propose, accept_reply_cuda.accept_reply)
            + wave_cuda.KERNELS}

