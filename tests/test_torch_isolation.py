"""The port stands alone: no import of JAX or of the JAX package, no silent
CPU fallback, and a smoke script that fails without a card."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "sdf_nmpc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sdf_nmpc_tpu")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


_BLOCKED_STEP = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None  # any import of it raises ImportError
import numpy as np, torch
from sdf_nmpc_tpu_torch.config import default_config
from sdf_nmpc_tpu_torch.nn import NeuralDF
from sdf_nmpc_tpu_torch.ocp import build_ocp
from sdf_nmpc_tpu_torch.solver import SolveInputs, init_state, make_rti_step
cfg = default_config().replace(nn=dict(size_latent=8))
net = NeuralDF(size_latent=8, layer_sizes=(16,) * 4, embed="oct", w0=2.0,
               generator=torch.Generator().manual_seed(0))
ocp = build_ocp(cfg, sdf=net, device="cpu")
B, N = 2, ocp.N
x0 = torch.zeros(B, 10, dtype=torch.float32); x0[:, 3] = 1.0
p = torch.zeros(B, N + 1, ocp.layout.np_total); p[..., ocp.layout.flag] = 1.0
p[..., list(ocp.layout.W_R_Co)] = torch.eye(3).reshape(9); p[..., list(ocp.layout.q_d)[0]] = 1.0
W = torch.ones(B, N, ocp.ny)
inp = SolveInputs(x0=x0, yref=torch.zeros(B, N, ocp.ny), W=W, yrefN=torch.zeros(B, ocp.nyN),
                  WN=torch.ones(B, ocp.nyN), p=p)
res = make_rti_step(ocp, cfg, with_evals=False)(init_state(ocp, x0), inp)
assert res.u0.shape == (B, 4) and bool(torch.isfinite(res.u0).all())
print("status", res.status.tolist())
"""


def test_port_runs_a_cpu_step_with_jax_blocked():
    """A fresh interpreter in which every JAX module is unimportable imports
    the port and runs one f32 RTI step on the CPU."""
    code = _BLOCKED_STEP.format(forbidden=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "status" in out.stdout


def test_entry_points_without_a_card_raise(monkeypatch):
    """No silent CPU fallback: without a CUDA device, the default device
    (cuda) raises; device='cpu' works."""
    from sdf_nmpc_tpu_torch import resolve_device
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_sdf
    from sdf_nmpc_tpu_torch.ocp import build_ocp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = default_config().replace(nn=dict(size_latent=8))
    net = NeuralDF(size_latent=8, layer_sizes=(16,) * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ocp(cfg, sdf=net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_prod_sdf()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    build_ocp(cfg, sdf=net, device="cpu")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                                       "PATH": "/usr/bin:/bin"})


def _result_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return [o for o in out if isinstance(o, dict) and "ok" in o]


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where CUDA is
    not available, both in the repo and alone in an empty directory."""
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", lone)
    for cwd in (REPO, lone):
        out = _run_smoke(cwd)
        assert out.returncode != 0, out.stdout
        assert not _result_lines(out.stdout), out.stdout
