"""Nothing the benchmark runs imports the JAX stack or the JAX package
(top-level module names compared whole: ``sdf_nmpc_tpu_torch`` is not
``sdf_nmpc_tpu``), and the references import nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
PROGRAM = "sdf_nmpc_tpu_torch"


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


def sources():
    return sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def test_whole_name_comparison():
    assert harness.JAX_NAMES == ("jax", "jaxlib", "flax", "optax", "sdf_nmpc_tpu")
    tops = lambda names: sorted({n.split(".")[0] for n in names} & set(harness.JAX_NAMES))
    assert tops(["sdf_nmpc_tpu_torch", "sdf_nmpc_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert tops(["sdf_nmpc_tpu.ops", "jax.numpy", "optax"]) == ["jax", "optax", "sdf_nmpc_tpu"]


def test_no_source_imports_jax():
    assert sources()
    bad = {str(p.relative_to(ROOT)): sorted(imported_tops(p) & set(harness.JAX_NAMES))
           for p in sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_references_import_nothing_of_the_program():
    refs = sorted((PB / "reference").glob("*.py"))
    assert refs
    for p in refs:
        tops = imported_tops(p)
        assert PROGRAM not in tops and not (tops & set(harness.JAX_NAMES)), p


def test_a_run_loads_no_jax(tmp_path):
    """A whole small run on the CPU, in a fresh interpreter, then the
    process's modules."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
from portbench import harness
res, lines, _ = harness.run("c4_fleet_b8192", 2**31 + 5, 0.5, True, device="cpu",
                            sizes={{"scenarios": 8, "check_rows": 8, "profile_units": 1,
                                   "warm_units": 1}}, log=lambda m: None)
print(json.dumps({{"loaded": harness.jax_modules(), "correct": res["correct"]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"loaded": [], "correct": True}


@pytest.mark.parametrize("loads", [False, True])
def test_a_rank_that_loads_jax_exits_non_zero(tmp_path, loads):
    """An extra rank of a sharded cell looks at its own modules once its part
    of the run is done, and exits with code 3, naming what it found, where
    the JAX stack got loaded (here planted as a module named ``flax``)."""
    code = f"""
import sys, types
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness, rank

def run(*args, **kw):
    if {loads!r}:
        sys.modules["flax"] = types.ModuleType("flax")

harness.run = run
sys.exit(rank.main(["--workload", "c5_sweep_4x25600", "--seed", "1", "--seconds", "1",
                    "--device", "cpu"]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == (3 if loads else 0), out.stderr[-3000:]
    assert ("loaded ['flax']" in out.stderr) == loads


def test_rank_0_prints_nothing_when_a_rank_fails():
    """Rank 0's cell raises at its end where another rank exited non-zero
    (as one that loaded JAX does), so ``run.py`` prints no result."""
    from portbench.systems.sharded_rti import Cell

    cell = Cell.__new__(Cell)
    cell.children = [subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])]
    with pytest.raises(RuntimeError, match=r"codes \[3\]"):
        cell.finish()
