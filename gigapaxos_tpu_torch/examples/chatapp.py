"""Chat-room example app (ref: the upstream gigapaxos chat tutorial).

The port's own copy of ``gigapaxos_tpu/examples/chatapp.py`` (pure Python,
unchanged but for its imports).

Each service name is one room; the replicated state is the room's message
log.  Because every replica executes decisions in slot order, all replicas
see the same log — that is the whole demo.

Ops (JSON payloads)::

    {"op": "post", "who": "alice", "msg": "hi"}   -> {"ok": true, "seq": N}
    {"op": "read", "n": 10}                       -> {"ok": true,
                                                      "msgs": [...]}
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List

from gigapaxos_tpu_torch.paxos.interfaces import Replicable


class ChatApp(Replicable):
    MAX_LOG = 10_000  # per room; oldest messages fall off

    def __init__(self):
        self._lock = threading.Lock()
        self.rooms: Dict[str, List[dict]] = {}
        self.seqs: Dict[str, int] = {}

    def execute(self, name, req_id, payload, is_stop=False) -> bytes:
        try:
            cmd = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            return b'{"err":"bad request"}'
        if not isinstance(cmd, dict):
            return b'{"err":"bad request"}'
        with self._lock:
            room = self.rooms.setdefault(name, [])
            if cmd.get("op") == "post":
                seq = self.seqs.get(name, 0) + 1
                self.seqs[name] = seq
                room.append({"seq": seq, "who": str(cmd.get("who", "?")),
                             "msg": str(cmd.get("msg", ""))})
                del room[:-self.MAX_LOG]
                return json.dumps({"ok": True, "seq": seq}).encode()
            if cmd.get("op") == "read":
                try:
                    n = max(0, int(cmd.get("n", 10)))
                except (TypeError, ValueError):
                    return b'{"err":"bad n"}'
                return json.dumps({"ok": True,
                                   "msgs": room[-n:] if n else []}
                                  ).encode()
            return b'{"err":"bad op"}'

    def checkpoint(self, name) -> bytes:
        with self._lock:
            return json.dumps({"log": self.rooms.get(name, []),
                               "seq": self.seqs.get(name, 0)}).encode()

    def restore(self, name, state) -> bool:
        with self._lock:
            if not state:
                self.rooms.pop(name, None)
                self.seqs.pop(name, None)
            else:
                st = json.loads(state.decode())
                self.rooms[name] = st["log"]
                self.seqs[name] = st["seq"]
            return True
