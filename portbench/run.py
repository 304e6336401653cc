"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are in ``BENCHMARK.json``; see
``portbench/harness.py``.  The run needs as many CUDA cards as the cell
asks for and exits with code 2, printing no result, where they are not
there.  It exits with code 3, printing no result, if the JAX stack or the
JAX package got loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches inside the checkout, at fixed paths; no library of the run loads flax
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / "_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "portbench" / "_cache" / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    # a sharded cell's other ranks start first, so that their imports and
    # set-up run beside this process's
    from portbench import rank

    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in b["workloads"]}.get(args.workload)
    if wl is None:
        print(f"portbench: no workload named {args.workload!r}", file=sys.stderr)
        return 2
    conf_file = {c["name"]: c["file"] for c in b["configs"]}[wl["config"]]
    n_ranks = int(json.loads((ROOT / conf_file).read_text()).get("scale_out", {}).get("ranks", 1))
    ranks = None
    if n_ranks > 1:
        ranks = rank.start(ROOT, n_ranks, dict(workload=args.workload, seed=args.seed,
                                               seconds=args.seconds, traced=args.trace,
                                               device="cuda"))
    try:
        import torch

        from portbench import harness

        chips = int(wl["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {n}",
                  file=sys.stderr)
            if ranks:
                rank.stop(ranks[1])
            return 2
        result, lines, _ = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                       device="cuda", root=ROOT, t_start=T_START, ranks=ranks)
    except BaseException:
        if ranks:
            rank.stop(ranks[1])
        raise
    found = harness.jax_modules()
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
