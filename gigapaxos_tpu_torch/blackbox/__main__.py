"""Flight-recorder CLI.

::

    python -m gigapaxos_tpu_torch.blackbox replay <capture.gpbb...> \\
        [--json-out BLACKBOX_rNN.json] [--workdir DIR] [--keep] \\
        [--mesh off|auto|N]
    python -m gigapaxos_tpu_torch.blackbox record-demo --out ref.gpbb \\
        [--requests N] [--groups N] [--shards S] [--mesh off|auto|N]

``replay`` re-drives each capture through a fresh offline engine and
prints the per-capture verification report (exit 0 = every capture
MATCH, 2 = any DIVERGED).  ``--json-out`` additionally writes the
machine-readable artifact ``render_perf.py`` turns into the README's
replay-verification row.

``record-demo`` produces a small deterministic capture from an
offline single-node drive (the committed ``tests/data/reference.gpbb``
guarding the format against drift is made this way).
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_replay(args) -> int:
    from gigapaxos_tpu_torch.blackbox.capture import CaptureError
    from gigapaxos_tpu_torch.blackbox.replay import (render_report,
                                                     replay_capture)

    reports = []
    worst = 0
    for path in args.capture:
        try:
            rep = replay_capture(path, workdir=args.workdir,
                                 keep=args.keep, mesh=args.mesh)
        except (CaptureError, OSError) as e:
            print(f"capture  {path}\n  ERROR    {e}", file=sys.stderr)
            reports.append({"file": path, "verdict": "ERROR",
                            "error": str(e)})
            worst = max(worst, 2)
            continue
        print(render_report(rep))
        reports.append(rep)
        if rep["verdict"] != "MATCH":
            worst = max(worst, 2)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"captures": reports}, f, indent=1, default=str)
            f.write("\n")
    return worst


def record_demo(out: str, n_requests: int = 48, n_groups: int = 4,
                shards: int = 1, mesh="off") -> str:
    """Drive an offline single-replica node deterministically and dump
    its ring to ``out``.  Same feeding discipline as the live worker:
    one decode batch per wave, self-requeued packets carried forward
    into the next batch (where the live capture would have recorded
    them)."""
    import os
    import queue as queue_mod
    import shutil
    import tempfile

    from gigapaxos_tpu_torch.blackbox.recorder import BlackboxRecorder
    from gigapaxos_tpu_torch.paxos import packets as pkt
    from gigapaxos_tpu_torch.paxos.interfaces import CounterApp
    from gigapaxos_tpu_torch.paxos.manager import PaxosNode
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.utils.config import Config
    from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter

    tmp = tempfile.mkdtemp(prefix="gpbb-demo-")
    pinned = [(PC.BLACKBOX_MB, 8), (PC.BLACKBOX_S, 0.0),
              (PC.ENGINE_SHARDS, int(shards)), (PC.SYNC_WAL, False),
              (PC.FUSE_WAVES, "off"), (PC.ENGINE_MESH, mesh)]
    for key, val in pinned:
        Config.set(key, val)
    node = None
    try:
        node = PaxosNode(0, {0: ("127.0.0.1", 1)}, CounterApp(),
                         os.path.join(tmp, "px"), backend="columnar",
                         capacity=256, window=16)
        node._recover()
        names = [f"demo{i}" for i in range(n_groups)]
        for name in names:
            node.create_group(name, (0,))

        def feed(items: list) -> None:
            import time as time_mod
            pend = list(items)
            while pend:
                RequestInstrumenter.set_wave(
                    RequestInstrumenter.next_wave())
                # pin the engine clock the way the live worker does:
                # the F record's ts must BE the wave's clock
                node._wtls.now = time_mod.time()
                decoded = node._decode_batch(pend)
                if node.shards > 1:
                    lanes = node._split_decoded(decoded)
                    for k in range(node.shards):
                        if lanes[k]:
                            node._wtls.wal_seg = k
                            with node._engine_locks[k]:
                                node._process(lanes[k])
                    node._wtls.wal_seg = 0
                else:
                    with node._engine_lock:
                        node._process(decoded)
                pend = []
                try:
                    while True:
                        pend.append(node._inq.get_nowait())
                except queue_mod.Empty:
                    pass

        client = 7  # not in addr_map: replies route nowhere, offline
        batch: list = []
        for i in range(n_requests):
            name = names[i % n_groups]
            batch.append(pkt.Request(
                client, pkt.group_key(name), (client << 32) | i, 0,
                b"demo-%d" % i).encode())
            if len(batch) == 6:
                feed(batch)
                batch = []
        if batch:
            feed(batch)
        path = node.blackbox.dump("reference")
        shutil.copyfile(path, out)
        return out
    finally:
        if node is not None:
            if node.blackbox is not None:
                node.blackbox.close()
            node.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        for key, _val in pinned:
            Config.unset(key)


def _cmd_record_demo(args) -> int:
    out = record_demo(args.out, n_requests=args.requests,
                      n_groups=args.groups, shards=args.shards,
                      mesh=args.mesh)
    print(f"wrote {out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gigapaxos_tpu_torch.blackbox",
        description="flight-recorder capture replay + tooling")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("replay", help="re-drive captures offline and "
                        "verify digests against their manifests")
    pr.add_argument("capture", nargs="+", help=".gpbb capture file(s)")
    pr.add_argument("--json-out", default=None,
                    help="write the replay-verification artifact "
                    "(render_perf.py input)")
    pr.add_argument("--workdir", default=None,
                    help="replay scratch dir (default: temp, removed)")
    pr.add_argument("--keep", action="store_true",
                    help="keep the scratch dir")
    pr.add_argument("--mesh", default=None,
                    help="override the engine device-mesh for the "
                    "replay (off/auto/N) — per-wave digests are mesh-"
                    "independent, so a capture must MATCH either way")
    pr.set_defaults(fn=_cmd_replay)

    pd = sub.add_parser("record-demo", help="produce a small "
                        "deterministic capture from an offline drive")
    pd.add_argument("--out", required=True)
    pd.add_argument("--requests", type=int, default=48)
    pd.add_argument("--groups", type=int, default=4)
    pd.add_argument("--shards", type=int, default=1)
    pd.add_argument("--mesh", default="off",
                    help="engine device-mesh while recording "
                    "(off/auto/N; default off)")
    pd.set_defaults(fn=_cmd_record_demo)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
