"""Readings for setting a cell's limits: the numbers that decide
``correct``, on many seeds, for the program as the configuration states it
and for its lower-precision controls, in one process (the program is built
once per setting).

    python3 portbench/readings.py --workload c4_sweep_b32768 --seconds 3 \\
        --seeds 11 12 13 --control sdf_bf16 --out chiprun_out/readings.jsonl

Each run is a whole harness run at the cell's own sizes with a short
window; one JSON line per (setting, seed) goes to ``--out`` and to
standard output.  ``--dump K`` also saves, beside ``--out``, the K sampled
scenarios of each run whose last step lies farthest from the reference:
their inputs, the state the step started from, the program's and the
reference's outputs (``torch.load`` the ``.pt`` file), for a second witness
on the CPU.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the program's own lower-precision paths, the controls of the comparison
CONTROLS = {"none": None, "sdf_bf16": {"sdf_fused_dtype": "bf16"},
            "qp_bf16": {"qp_data_bf16": True}, "encoder_tf32": {"encoder_tf32": True}}


def dump(cell, k: int, path: Path) -> None:
    """The ``k`` sampled scenarios farthest from the reference in the last
    step (by the trajectory gap).  In the perception cell ``inputs['p']``
    holds the reference's latents and ``z_prog`` the program's."""
    import torch

    worst = torch.argsort(cell.last_gaps["traj"], descending=True)[:k]
    X_in, U_in, X_out, U_out, ok = cell.last
    Xs, Us, oks = cell.last_ref
    extra = {"z_prog": cell.check_z[worst]} if hasattr(cell, "check_z") else {}
    torch.save({**extra, "rows": torch.as_tensor(cell.idx)[worst], "seed": cell.seed,
                "inputs": {n: torch.as_tensor(v)[worst] for n, v in cell.last_inp.items()},
                "X_in": X_in[worst], "U_in": U_in[worst], "X_out": X_out[worst],
                "U_out": U_out[worst], "ok": ok[worst], "X_ref": Xs[worst], "U_ref": Us[worst],
                "ok_ref": oks[worst], "u0_gap": cell.last_gaps["u0"][worst],
                "traj_gap": cell.last_gaps["traj"][worst]}, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", nargs="+", default=["none"], choices=sorted(CONTROLS))
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--dump", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    args.out.parent.mkdir(parents=True, exist_ok=True)
    cache = {}
    with args.out.open("a") as f:
        for control in args.control:
            for seed in args.seeds:
                res, _, numbers = harness.run(args.workload, seed, args.seconds, False,
                                              device="cuda", root=ROOT,
                                              overrides=CONTROLS[control], cache=cache)
                line = json.dumps({"workload": args.workload, "control": control, "seed": seed,
                                   "numbers": numbers, "correct": res["correct"],
                                   "metrics": res["metrics"]})
                print(line, flush=True)
                f.write(line + "\n")
                f.flush()
                if args.dump:
                    dump(cache["cell"], args.dump,
                         args.out.with_name(f"{args.out.stem}_{control}_{seed}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
