"""Client command-line tool.

The port's own copy of ``gigapaxos_tpu/client_cli.py`` (pure Python,
unchanged but for its imports).

Reference analog: ``bin/gpClient.sh`` (console client wrapping
``ReconfigurableAppClientAsync``) — name lifecycle ops plus app requests
against a running cluster.

Usage::

    python -m gigapaxos_tpu_torch.client_cli \
        --config conf/gigapaxos.properties \
        create chatroom
    ... send chatroom '{"op":"put","k":"x","v":"1"}'
    ... actives chatroom
    ... move chatroom 0 1 2
    ... delete chatroom
    ... repl          # interactive: one command per line, same grammar
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

from gigapaxos_tpu_torch.reconfiguration.appclient import \
    ReconfigurableAppClient
from gigapaxos_tpu_torch.reconfiguration.node import NodeConfig


async def _run_one(cli: ReconfigurableAppClient, cmd: str,
                   args: list) -> str:
    if cmd == "create":
        init = args[1].encode() if len(args) > 1 else b""
        ok = await cli.create(args[0], init)
        return "created" if ok else "create failed"
    if cmd == "delete":
        ok = await cli.delete(args[0])
        return "deleted" if ok else "no such name"
    if cmd == "actives":
        return " ".join(map(str, await cli.get_actives(args[0])))
    if cmd == "move":
        ok = await cli.move(args[0], [int(a) for a in args[1:]])
        return "moved" if ok else "move failed"
    if cmd == "send":
        out = await cli.send_request(args[0], args[1].encode())
        return out.decode(errors="replace")
    raise ValueError(f"unknown command {cmd!r} "
                     "(create|delete|actives|move|send)")


async def _amain(args) -> int:
    config = NodeConfig.from_properties(args.config)
    cli = ReconfigurableAppClient(args.client_id, config,
                                  timeout=args.timeout)
    try:
        if args.cmd == "repl":
            loop = asyncio.get_running_loop()
            while True:
                try:
                    line = await loop.run_in_executor(
                        None, lambda: input("gp> "))
                except (EOFError, KeyboardInterrupt):
                    break
                parts = line.strip().split()
                if not parts or parts[0] in ("quit", "exit"):
                    if parts:
                        break
                    continue
                try:
                    print(await _run_one(cli, parts[0], parts[1:]))
                except (ValueError, KeyError, TimeoutError,
                        IndexError) as e:
                    print(f"error: {e}")
            return 0
        try:
            print(await _run_one(cli, args.cmd, args.args))
            return 0
        except (ValueError, IndexError) as e:
            print(f"usage error: {e}", file=sys.stderr)
            return 2
        except (KeyError, TimeoutError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    finally:
        await cli.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gigapaxos_tpu_torch.client_cli",
        description="gigapaxos-tpu console client")
    p.add_argument("--config", required=True)
    p.add_argument("--client-id", type=int,
                   default=(os.getpid() & 0xFFFF) | (1 << 20))
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument("cmd", choices=["create", "delete", "actives", "move",
                                   "send", "repl"])
    p.add_argument("args", nargs="*")
    args = p.parse_args(argv)
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
