"""A traced run of one cell, as ``run.py --trace 1`` makes it, and the
per-span table of its profiled window (``yardstick/spans.py``):

    python3 portbench/stage_table.py --workload c4_fleet_b8192 --seed 11 --seconds 20 \\
        --out stages.jsonl

The run's result line goes to standard output as from ``run.py``; one JSON
line, {"workload", "seed", "units", "window_ms", "rows"}, is appended to
``--out``, where each row is [span, host ms, launches, blocking calls,
device idle ms], per unit and counted inside that span.  In a sharded cell
the table is rank 0's.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness, run
    from portbench.yardstick import spans

    kept = []
    from_profile = harness.trace_mod.from_profile

    def keep(prof, units):
        tr = from_profile(prof, units)
        kept.append(tr)
        return tr

    harness.trace_mod.from_profile = keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or not kept:
        return rc or 1
    tr = kept[-1]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write(json.dumps({"workload": args.workload, "seed": args.seed, "units": tr.units,
                            "window_ms": 1e3 * tr.window_s,
                            "rows": spans.stage_table(tr)}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
