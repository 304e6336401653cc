"""BASELINE config 5 as the system under test: config 4's scenarios sharded
over one process per card on ``torch.distributed`` (NCCL between cards,
gloo on the CPU), through the program's ``parallel`` module:
``initialize_multihost``, ``shard_batch``'s block layout (rank r holds rows
[r B / n, (r + 1) B / n)), ``make_batched_step`` (the step on the rank's
block, BatchStats all-reduced every step) and ``gather_batch``.

The run's own process is rank 0.  Ranks 1 .. n-1 are processes of
``portbench/rank.py`` with the same arguments: ``run.py`` starts them before
it imports torch, and a run that finds none started (the tests' runs)
starts them at set-up.  Rank 0 waits for each at the end.  Every rank runs
the same units: rank 0 times the warm-up and broadcasts the count that
fills the window.  The comparison gathers the
check step's inputs, states and outputs to rank 0, which runs the reference
on a sample of all the scenarios and holds the all-reduced BatchStats to
the gathered statuses.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

from portbench import rank as ranks
from portbench.systems import rti_step

JOIN_S = 300.0  # how long rank 0 waits for the other ranks to end


class Cell(rti_step.Cell):
    # workload, seconds, traced, sizes, fault, and the ranks run.py started: set by the harness
    run_args: dict = {}

    def setup(self):
        from sdf_nmpc_tpu_torch import parallel

        self.marks = {"entered": time.perf_counter()}
        self.n = int(self.conf["scale_out"]["ranks"])
        self.rank = int(os.environ.get(ranks.RANK_ENV, "0"))
        self.is_root = self.rank == 0
        self.children = []
        if self.is_root:
            started = self.run_args.get("ranks")
            port, self.children = started if started else self._spawn()
        else:
            port = int(os.environ[ranks.PORT_ENV])
        kind = self.device.type
        self.mesh = parallel.initialize_multihost(f"127.0.0.1:{port}", self.n, self.rank,
                                                  device=kind)
        self.device = self.mesh.device
        self.marks["ranks joined"] = time.perf_counter()
        self.block = slice(self.rank * self.B // self.n, (self.rank + 1) * self.B // self.n)
        if self.B % self.n:
            raise ValueError(f"{self.B} scenarios do not split over {self.n} ranks")
        super().setup()

    def _spawn(self):
        a = self.run_args
        return ranks.start(self.root, self.n, dict(
            workload=a["workload"], seed=self.seed, seconds=a["seconds"], traced=a["traced"],
            device=self.device.type, sizes=a.get("sizes"), fault=a.get("fault"),
            overrides=json.dumps(self.overrides) if self.overrides else None))

    # -- the program on this rank's block --
    def build(self):
        from sdf_nmpc_tpu_torch.parallel import make_batched_step

        prog = self.prog
        self.batched = {b: make_batched_step(prog.ocp, prog.cfg, self.mesh, budget=b)
                        for b in ("cold", "steady")}

        def step(state, x, budget="steady"):
            res, self.stats = self.batched[budget](state, x)
            return res

        self.sharded_step = step
        self.steady = self.wrap(step) if self.wraps("step") else step

    def inputs_on_device(self):
        return self.scen.on_device(self.device, self.block)

    def cold_step(self, state, x):
        return self.sharded_step(state, x, "cold")

    def sample(self, res):
        from sdf_nmpc_tpu_torch.parallel import gather_batch

        X, U, status = gather_batch((res.state.X, res.state.U, res.status), self.mesh)
        if not self.is_root:
            return None
        rows = torch.as_tensor(self.idx, device=self.device)
        return X[rows].cpu(), U[rows].cpu(), (status[rows] == 0).cpu()

    def unit(self) -> float:
        t0 = time.perf_counter()
        self.res = self.steady(self.res.state, self.x)
        issued = time.perf_counter() - t0
        self.n_bad += self.stats.n_failed.to(torch.int64)
        self.advance()
        return issued

    # -- one window for every rank --
    def fixed_units(self, seconds):
        """Rank 0 times two more chained units and broadcasts how many fill
        ``seconds``."""
        import torch.distributed as dist

        from portbench.driver import sync

        count = torch.zeros(1, dtype=torch.int64, device=self.device)
        sync(self.device)
        t0 = time.perf_counter()
        for _ in range(2):
            self.unit()
        sync(self.device)
        if self.is_root:
            count[0] = max(1, round(seconds / ((time.perf_counter() - t0) / 2)))
        dist.broadcast(count, src=0)
        return int(count.item())

    def _gather_max(self, *vals):
        import torch.distributed as dist

        t = torch.tensor([float(v) for v in vals], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()

    def reduce_window(self, wall_s, peak):
        wall, pk = self._gather_max(wall_s, peak)
        return wall, int(pk)

    def reduce_busy(self, busy_s):
        import torch.distributed as dist

        t = torch.tensor([busy_s], dtype=torch.float64, device=self.device)
        dist.all_reduce(t)
        return float(t.item()) / self.n

    # -- the comparison --
    def check_step(self):
        from sdf_nmpc_tpu_torch.parallel import gather_batch, shutdown

        X_in, U_in = self.res.state.X, self.res.state.U
        inp = {k: getattr(self.x, k) for k in self.x._fields}
        res = self.steady(self.res.state, self.x)
        stats = self.stats
        g = gather_batch((X_in, U_in, res.state.X, res.state.U, res.status,
                          tuple(inp.values())), self.mesh)
        if self.is_root:
            idx = torch.as_tensor(self.idx, device=self.device)
            Xi, Ui, Xo, Uo, status, inps = g
            self.last_inp = {k: v[idx].double().cpu().numpy() for k, v in zip(inp, inps)}
            self.last = (Xi[idx].cpu(), Ui[idx].cpu(), Xo[idx].cpu(), Uo[idx].cpu(),
                         (status[idx] == 0).cpu())
            n_ok = int((status == 0).sum())
            self.stats_gap = (abs(int(stats.n_ok) - n_ok)
                              + abs(int(stats.n_failed) - (status.numel() - n_ok)))
        del g, res
        self.res = self.x = None
        shutdown()

    def numbers(self, ref_device) -> dict:
        out = super().numbers(ref_device)
        out["stats_gap"] = self.stats_gap
        return out

    def finish(self):
        deadline = time.monotonic() + JOIN_S
        bad = []
        for p in self.children:
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            if rc != 0:
                bad.append(rc)
        self.children = []
        if bad:
            raise RuntimeError(f"ranks ended with codes {bad}")

    def abort(self):
        ranks.stop(self.children)
        self.children = []
