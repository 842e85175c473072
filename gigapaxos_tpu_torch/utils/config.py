"""Enum-keyed layered configuration.

Reference analog: ``src/edu/umass/cs/utils/Config.java`` — each subsystem
defines an enum whose members carry typed default values; values are
overridable by a properties file and by system properties.  Here the layering
is: code default < properties file (``GP_CONFIG`` env var or
``Config.load(path)``) < environment variables (``GP_<ENUM>_<KEY>``) <
programmatic ``Config.set``.

Usage::

    class PC(ConfigKey):
        BATCH_SIZE = 1024
        CHECKPOINT_INTERVAL = 400

    Config.get(PC.BATCH_SIZE)        # -> 1024 (or override)
    Config.set(PC.BATCH_SIZE, 2048)  # programmatic override (tests)

Properties-file format (same spirit as gigapaxos.properties)::

    PC.BATCH_SIZE=2048
    active.node0=127.0.0.1:2000
"""

from __future__ import annotations

import enum
import os
import threading
from typing import Any, Dict, Optional


class ConfigKey(enum.Enum):
    """Base class for config enums: member value = typed default.

    Members are keyed by NAME and never aliased: a plain Enum folds
    members whose values compare equal into one (``False == 0``), which
    silently fused unrelated knobs whose defaults coincide — setting
    one set them all.  ``_value_`` is a unique ordinal; the declared
    default lives beside it."""

    def __new__(cls, default: Any):
        obj = object.__new__(cls)
        obj._value_ = len(cls.__members__)  # unique → no alias folding
        obj._default_value = default
        return obj

    @property
    def default(self) -> Any:
        return self._default_value


def _coerce(raw: str, default: Any) -> Any:
    """Coerce a string override to the type of the code default."""
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


class Config:
    """Process-global layered config registry (thread-safe)."""

    _lock = threading.RLock()
    # overrides keyed by "ENUMCLASS.MEMBER"
    _file_props: Dict[str, str] = {}
    _prog: Dict[str, Any] = {}
    # raw non-enum properties (e.g. node maps "active.node0=host:port")
    _raw: Dict[str, str] = {}
    _loaded_path: Optional[str] = None

    @staticmethod
    def _key(k: ConfigKey) -> str:
        return f"{type(k).__name__}.{k.name}"

    @classmethod
    def load(cls, path: str) -> None:
        """Load a properties file (``key=value`` lines, ``#`` comments)."""
        with cls._lock:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    if "=" not in line:
                        continue
                    k, _, v = line.partition("=")
                    k, v = k.strip(), v.strip()
                    cls._file_props[k] = v
                    cls._raw[k] = v
            cls._loaded_path = path

    @classmethod
    def maybe_load_env(cls) -> None:
        """Load the properties file named by $GP_CONFIG, once."""
        path = os.environ.get("GP_CONFIG")
        if path and cls._loaded_path != path and os.path.exists(path):
            cls.load(path)

    @classmethod
    def get(cls, key: ConfigKey) -> Any:
        with cls._lock:
            name = cls._key(key)
            if name in cls._prog:
                return cls._prog[name]
            env = os.environ.get("GP_" + name.replace(".", "_").upper())
            if env is not None:
                return _coerce(env, key.default)
            if name in cls._file_props:
                return _coerce(cls._file_props[name], key.default)
            return key.default

    @classmethod
    def set(cls, key: ConfigKey, value: Any) -> None:
        with cls._lock:
            cls._prog[cls._key(key)] = value

    @classmethod
    def unset(cls, key: ConfigKey) -> None:
        with cls._lock:
            cls._prog.pop(cls._key(key), None)

    @classmethod
    def raw_properties(cls, prefix: str = "") -> Dict[str, str]:
        """All raw file properties with the given prefix (node maps etc.)."""
        with cls._lock:
            return {
                k: v for k, v in cls._raw.items() if k.startswith(prefix)
            }

    @classmethod
    def clear(cls) -> None:
        """Reset all overrides (test hygiene)."""
        with cls._lock:
            cls._file_props.clear()
            cls._prog.clear()
            cls._raw.clear()
            cls._loaded_path = None
