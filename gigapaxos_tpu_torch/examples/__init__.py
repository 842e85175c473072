"""Example applications (ref: ``gigapaxos/examples/`` + the upstream
chat/calculator tutorials).

The port's own copy of ``gigapaxos_tpu/examples/__init__.py`` (pure
Python, unchanged but for its imports).

Each example implements the :class:`~gigapaxos_tpu_torch.paxos.interfaces.
Replicable` boundary — ``execute``/``checkpoint``/``restore`` — and is
runnable against a real cluster via::

    python -m gigapaxos_tpu_torch.server --config conf/gigapaxos.properties \
        --id 0 --app gigapaxos_tpu_torch.examples.chatapp:ChatApp

Built-in minimal apps (``NoopApp``, ``CounterApp``, ``KVApp``) live in
``gigapaxos_tpu_torch.paxos.interfaces``.
"""

from gigapaxos_tpu_torch.examples.chatapp import ChatApp

__all__ = ["ChatApp"]
