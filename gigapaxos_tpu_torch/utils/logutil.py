"""Structured logging setup.

Reference analog: ``java.util.logging`` usage throughout gigapaxos
(per-class loggers whose levels gate hot-path string building).  Here:
stdlib ``logging`` with a single concise formatter; hot paths must guard
with ``log.isEnabledFor`` exactly as the reference guards with
``log.isLoggable(Level.FINE)``.
"""

from __future__ import annotations

import logging
import os

_FMT = "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("GP_LOG_LEVEL", "WARNING").upper()
        logging.basicConfig(level=getattr(logging, level, logging.WARNING),
                            format=_FMT, datefmt=_DATEFMT)
        _configured = True
    return logging.getLogger(name)
