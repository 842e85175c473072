"""Scenario CLI: ``python -m gigapaxos_tpu_torch.chaos``.

The port's own copy of ``gigapaxos_tpu/chaos/__main__.py``: the same
flags and default drill, on the port's columnar engine on
``PC.COLUMNAR_DEVICE`` (the card unless ``GP_PC_COLUMNAR_DEVICE=cpu``).
Without a card, or with ``--backend native`` (not ported), it raises
before any scenario starts.

Runs the named chaos scenarios against an in-process cluster, prints
one JSON line per scenario, and (with ``--out``) writes the rows as a
``CHAOS_*.json`` artifact — the robustness counterpart of the
``BENCH_*.json`` perf artifacts (``render_perf.py`` renders both).

Examples::

    # the full drill, deterministic under seed 1
    python -m gigapaxos_tpu_torch.chaos --seed 1 --out chaos_drill.json

    # one scenario, replaying a failing seed
    python -m gigapaxos_tpu_torch.chaos --scenarios leader_crash --seed 42
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from gigapaxos_tpu_torch.chaos.scenarios import SCENARIOS, run_scenario

# the full drill (the default): every full-size scenario; 'all' adds
# the smoke-gate mini variants (mini_partition_heal, mini_disk_fault)
DEFAULT = ["partition_heal", "leader_crash", "rolling_restart",
           "shard_storm", "zipf_hot", "disk_storm"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gigapaxos_tpu_torch.chaos")
    p.add_argument("--scenarios", default=",".join(DEFAULT),
                   help="comma-separated scenario names, or 'all' = "
                        "every known scenario "
                        f"(known: {', '.join(sorted(SCENARIOS))}; "
                        "default: the full drill, which skips the "
                        "smoke-gate mini variant)")
    p.add_argument("--seed", type=int, default=1,
                   help="chaos PRNG seed — the same seed replays the "
                        "same fault schedule (row carries the "
                        "schedule fingerprint to prove it)")
    p.add_argument("--out", default=None,
                   help="write rows as a CHAOS_*.json artifact")
    p.add_argument("--backend", default=None,
                   help="override each scenario's engine (columnar, the "
                        "default, or scalar; native is not ported and "
                        "raises); shard_storm requires columnar and "
                        "ignores this")
    p.add_argument("--list", action="store_true",
                   help="list scenarios and exit")
    args = p.parse_args(argv)

    if args.list:
        for name, spec in sorted(SCENARIOS.items()):
            print(f"{name}: {spec['n_nodes']} nodes, "
                  f"{spec['n_groups']} groups, {spec['backend']}")
        return 0

    names = sorted(SCENARIOS) if args.scenarios == "all" \
        else [s.strip() for s in args.scenarios.split(",") if s.strip()]
    unknown = [s for s in names if s not in SCENARIOS]
    if unknown:
        p.error(f"unknown scenario(s): {unknown}")
    # an engine the port lacks, or no card, fails the drill before any
    # scenario boots (a scenario's own boot failure only fails its row)
    from gigapaxos_tpu_torch.testing.harness import require_engine
    for be in sorted({"columnar" if n == "shard_storm"
                      else args.backend or SCENARIOS[n]["backend"]
                      for n in names}):
        require_engine(be)

    rows = []
    rc = 0
    for name in names:
        be = None if name == "shard_storm" else args.backend
        try:
            row = run_scenario(name, seed=args.seed, backend=be)
        except Exception as exc:  # noqa: BLE001 — one scenario's boot
            # failure must not discard the completed rows or the --out
            # artifact; an error row keeps the failure visible
            import traceback
            traceback.print_exc()
            row = {"scenario": name, "seed": args.seed, "ok": False,
                   "error": f"{type(exc).__name__}: {exc}"}
        rows.append(row)
        print(json.dumps(row))
        if not row.get("ok"):
            rc = 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"recorded_at": time.strftime("%Y-%m-%d %H:%M"),
                       "seed": args.seed, "rows": rows}, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
