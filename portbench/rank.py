"""The extra ranks of a sharded cell.  The run's own process is rank 0; it
starts ranks 1 .. n-1 with ``start`` before it imports torch, so that the
four processes' imports and set-up run side by side.  Each is this script
with the run's arguments, and ``PORTBENCH_RANK`` / ``PORTBENCH_PORT`` /
``LOCAL_RANK`` in its environment.  A rank prints no result; it exits
non-zero if its part of the run fails, or with code 3 if the JAX stack or
the JAX package got loaded into it (rank 0 then prints no result either).

Nothing here imports torch at module level."""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RANK_ENV, PORT_ENV = "PORTBENCH_RANK", "PORTBENCH_PORT"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(root: Path, n: int, args: dict) -> tuple:
    """Start ranks 1 .. n-1 of a run whose arguments are ``args`` (workload,
    seed, seconds, traced, device; optionally sizes, fault and overrides as
    JSON strings).  Returns (the rendezvous port, the processes)."""
    port = free_port()
    cmd = [sys.executable, str(Path(root) / "portbench" / "rank.py"),
           "--workload", args["workload"], "--seed", str(args["seed"]),
           "--seconds", str(args["seconds"]), "--trace", str(int(args["traced"])),
           "--device", args["device"]]
    for key in ("sizes", "fault", "overrides"):
        if args.get(key):
            cmd += [f"--{key}", args[key]]
    procs = []
    for r in range(1, n):
        env = dict(os.environ, **{RANK_ENV: str(r), PORT_ENV: str(port), "LOCAL_RANK": str(r)})
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(root)))
    return port, procs


def stop(procs) -> None:
    """End the ranks after a failure, and wait for each."""
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=None, help="traffic parameters to override (JSON)")
    ap.add_argument("--fault", default=None, help="a fault of portbench/tests/faults.py")
    ap.add_argument("--overrides", default=None, help="the program's solver settings (JSON)")
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))

    from portbench import harness

    wrap = None
    if args.fault:
        from portbench.tests import faults

        wrap = getattr(faults, args.fault)
    harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device=args.device,
                root=ROOT, sizes=json.loads(args.sizes) if args.sizes else None, wrap=wrap,
                fault=args.fault, overrides=json.loads(args.overrides) if args.overrides else None,
                log=lambda msg: None)
    found = harness.jax_modules()
    if found:
        print(f"portbench: rank {os.environ.get(RANK_ENV)} loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
