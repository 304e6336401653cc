"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here is marked ``gpu`` and skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
host that has only PyTorch (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import copy

import numpy as np
import pytest
import torch

from _torch_port import cuda_device, t32  # noqa: F401  (fixture)

RNG = np.random.default_rng(29)


def _count(name):
    from sdf_nmpc_tpu_torch.ops import _lib

    return _lib.launch_counts[name]


@pytest.mark.gpu
def test_lin_y_sens_kernel_matches_plain(cuda_device):
    """4099 random points (not a block multiple): x+ 1e-5, A and B 1e-4, the
    y sweep 2e-4 / 1e-4 (tests/test_ops.py).  The kernel runs the algebraic
    cos/sin-of-atan2 form, the plain version true atan2."""
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.models import make_model
    from sdf_nmpc_tpu_torch.ops.lin_kernels import lin_y_sens, lin_y_sens_plain
    from sdf_nmpc_tpu_torch.params import ParamLayout

    cfg = default_config()
    model, lay = make_model(cfg), ParamLayout.from_cfg(cfg)
    M = 4099
    x = RNG.normal(size=(M, 10))
    x[:, 3:7] += np.array([1.5, 0, 0, 0])
    u = RNG.uniform(-0.9, 0.9, size=(M, 4))
    u[:, 0] = RNG.uniform(0.1, 0.9, size=M)
    p = np.zeros((M, lay.np_total))
    qd = RNG.normal(size=(M, 4))
    p[:, list(lay.q_d)] = qd / np.linalg.norm(qd, axis=1, keepdims=True)
    args = [t32(a).to(cuda_device) for a in
            (x, u, RNG.uniform(0.01, 0.1, size=M), p, RNG.normal(size=(M, 11)))]
    n0 = _count("lin_y_sens")
    got = lin_y_sens(model, lay, *args)
    assert _count("lin_y_sens") == n0 + 1
    want = lin_y_sens_plain(model, *args)
    tols = [(1e-5, 1e-5), (1e-4, 0), (1e-4, 0), (2e-4, 1e-4), (2e-4, 1e-4), (2e-4, 1e-4)]
    for g, w, (atol, rtol) in zip(got, want, tols):
        torch.testing.assert_close(g, w, atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_sdf_fused_kernel_matches_plain_trained_net(cuda_device):
    """The trained 4x256 net (w0=20), 1037 points (not a tile multiple):
    value 2e-4, gradient 2e-3 (tests/test_ops.py)."""
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_latents, load_prod_sdf
    from sdf_nmpc_tpu_torch.ops.sdf_fused import (
        pack_neural_df_params,
        sdf_value_grad,
        sdf_value_grad_plain,
    )

    packed = pack_neural_df_params(load_prod_sdf(device=cuda_device))
    lat = load_prod_latents()
    P = 1037
    pos = t32(RNG.normal(size=(P, 3)) * 1.5).to(cuda_device)
    latent = t32(lat[RNG.integers(0, lat.shape[0], P)]).to(cuda_device)
    n0 = _count("sdf_fused")
    df, gr = sdf_value_grad(packed, pos, latent)
    assert _count("sdf_fused") == n0 + 1
    df_p, gr_p = sdf_value_grad_plain(packed, pos, latent)
    torch.testing.assert_close(df, df_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(gr, gr_p, atol=2e-3, rtol=0)


def _fixed_condense_rng():
    """A generator in the state this file's shared RNG reaches at the
    condense test when the whole file runs in order: the two tests before
    it draw their points first (test_lin_y_sens_kernel_matches_plain's 4099,
    then 1037 positions and latent indices into the 64 trained latents)."""
    rng = np.random.default_rng(29)
    M, P = 4099, 1037
    rng.normal(size=(M, 10))
    rng.uniform(-0.9, 0.9, size=(M, 4))
    rng.uniform(0.1, 0.9, size=M)
    rng.normal(size=(M, 4))
    rng.uniform(0.01, 0.1, size=M)
    rng.normal(size=(M, 11))
    rng.normal(size=(P, 3))
    rng.integers(0, 64, P)
    return rng


def _condense_data(rng, B, N, nx, nu, ny, nh):
    shapes = [(B, N, nx, nu), (B, N, nx), (B, nx), (B, N, ny, nx),
              (B, N, ny, nu), (B, N, ny), (B, N, nh, nx), (B, N, nh, nu), (B, N, nh)]
    A = np.eye(nx) + 0.05 * rng.normal(size=(B, N, nx, nx))
    return [A] + [rng.normal(size=s) for s in shapes]


@pytest.mark.gpu
def test_condense_kernel_matches_plain(cuda_device):
    """Production dims (N=20, nx=10, nu=4, ny=11, nh=3), 300 scenarios of
    random data: 1e-5 absolute and relative (tests/test_qp_kernels.py).  A
    is I + 0.05 noise, the shape of a discretised dynamics Jacobian: with
    the JAX test's 0.4 noise over 20 stages E grows ~100-fold and rounding
    scales with it, which no fixed tolerance holds.  The data comes from a
    generator of its own in the state that gives the draw this test always
    had in file order (_fixed_condense_rng), whatever ``-k`` selects; the
    same draws are still taken from the shared RNG and dropped, so that the
    tests after it keep their data.  (A fresh seed's draw read 1.24e-5 at
    one of 66,000 entries, ROADMAP.md section 3.)"""
    from sdf_nmpc_tpu_torch.ops.condense_kernel import condense, condense_plain

    dims = (300, 20, 10, 4, 11, 3)  # B, N, nx, nu, ny, nh
    _condense_data(RNG, *dims)
    args = [t32(a).to(cuda_device) for a in _condense_data(_fixed_condense_rng(), *dims)]
    n0 = _count("condense")
    got = condense(*args)
    assert _count("condense") == n0 + 1
    for g, w in zip(got, condense_plain(*args)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _random_qp(B, nz, nc, tied=False, rng=RNG):
    """A seeded random QP batch built as in tests/test_qp_kernels.py; with
    ``tied``, each odd constraint row repeats the even row before it (same
    row of C, same c0, same bounds), so the raw eta of the two rows tie
    exactly and the stiff-row ranking must break the tie to the lower index."""
    A = rng.normal(size=(B, nz, nz))
    g = rng.normal(size=(B, nz)) * 2
    C, c0 = rng.normal(size=(B, nc, nz)), rng.normal(size=(B, nc))
    if tied:
        C[:, 1::2], c0[:, 1::2] = C[:, 0:nc - 1:2], c0[:, 0:nc - 1:2]
    return dict(H=np.einsum("bij,bkj->bik", A, A) + 10 * np.eye(nz), g=g, C=C, c0=c0,
                lh=np.full((B, nc), -0.1),
                uh=np.full((B, nc), 0.1), z1=np.full((B, nc), 1e3), z2=np.full((B, nc), 1e4),
                lb=np.full((B, nz), -0.7), ub=np.full((B, nz), 0.7))


def _launches(qg, k_stiff):
    """Each ip_phase launch of the fused solve of qg (12 iterations, the last
    4 stiff; all 12 warm with k_stiff 0), from the plain version's state:
    [(k_s, kernel out, plain out, plain out in f64 from the same input)]."""
    from sdf_nmpc_tpu_torch.ops import ip_kernel as ipk

    consts = ipk.ip_consts(torch.float32)
    data, state = ipk.ip_init(*qg, 0.1, 1e-6, consts)  # solve_qp's mu0 and box margin
    phases, _ = ipk.ip_schedule(12, 8 if k_stiff else 12, k_stiff, qg.c0.shape[-1])
    out = []
    for k_s, n_iters, it0, tail in phases:
        rest = (k_s, n_iters, it0, consts, tail)
        want = ipk.ip_phase_plain(data, state, *rest)
        ref = ipk.ip_phase_plain(tuple(t.double() for t in data),
                                 tuple(t.double() for t in state), *rest)
        out.append((k_s, ipk.ip_phase(data, state, *rest), want, ref))
        state = want
    return out


def _as_accurate(label, got, want, ref):
    """A launch's output against the plain version's and its f64 reading,
    scenario by scenario (the largest deviation over the row): at most 1% of
    the scenarios (none of 64) lie beyond 1e-4 of the plain version where the
    plain f32 version lies within 1e-4 of f64; and the kernel's distance to
    f64 has a median at most twice the plain version's plus 1e-7, a largest
    at most 4 times plus 1e-4 (chip_smoke.py's QP_RULE factors).  Random
    QPs hold scenarios where the f32 phase lies far from f64 whatever the
    summation order, in the kernel as in the plain version."""
    def dev(a, b):
        return (a.double() - b.double()).abs().amax(-1).cpu()

    d, d64, dk64 = dev(got, want), dev(want, ref), dev(got, ref)
    off = int(((d > 1e-4) & (d64 <= 1e-4)).sum())
    print(f"{label}: kernel vs plain max {float(d.max()):.2e} ({off} of {d.shape[0]} beyond 1e-4 "
          f"where the plain is within 1e-4 of f64); vs f64, kernel median "
          f"{float(dk64.median()):.2e} max {float(dk64.max()):.2e}, plain f32 median "
          f"{float(d64.median()):.2e} max {float(d64.max()):.2e}")
    assert off <= 0.01 * d.shape[0], label
    assert float(dk64.median()) <= 2 * float(d64.median()) + 1e-7, label
    assert float(dk64.max()) <= 4 * float(d64.max()) + 1e-4, label


@pytest.mark.gpu
@pytest.mark.parametrize("B, nz, nc, k_stiff", [
    (64, 80, 63, 8),     # the main path's QP size
    (64, 80, 63, 0),     # a warm phase alone
    (64, 44, 37, 8),     # not a multiple of the 8-column panel
    (32, 160, 130, 8),   # more rows than the 128 threads of a block
    (1100, 80, 63, 8),   # more than one wave of resident blocks
    (1100, 80, 68, 48),  # the recursive-feasibility QP at its wide stiff split
])
def test_ip_phase_kernel_matches_plain(cuda_device, B, nz, nc, k_stiff):
    """Seeded random QP batches (tests/test_qp_kernels.py): the fused solve
    (8 warm + 4 stiff iterations; 12 warm with k_stiff 0) launches the
    kernel once per phase, and each launch's dz, from the plain version's
    input state, is held by ``_as_accurate`` against the plain version and
    f64: at 44 x 37, and on some scenarios of other draws, the plain f32
    phase itself lies up to ~1e-1 from f64, and a solve's best-iterate
    choice can flip between two near-tied merits, so no flat bound on every
    scenario's dz holds every draw.  At the main size, on the batch it
    always drew, the solve's dz also lies within 1e-4 of the plain
    version's, and an unaligned k_stiff takes the composed path (kernels 5
    and 6, no ip_phase launch) and gives dz within 1e-4 too."""
    from sdf_nmpc_tpu_torch.solver.qp import QpData, solve_qp

    # the main size draws from the module's generator, as it always did;
    # the other cases from their own, so the tests after them keep their data
    main = (B, nz, k_stiff) == (64, 80, 8)
    rng = RNG if main else np.random.default_rng([B, nz, nc, k_stiff])
    qg = QpData(**{k: t32(v).to(cuda_device) for k, v in _random_qp(B, nz, nc, rng=rng).items()})
    n0 = _count("ip_phase")
    got = solve_qp(qg, iters=12, stiff_iters=4, k_stiff=k_stiff)
    assert _count("ip_phase") == n0 + (2 if k_stiff else 1)
    if main:
        want = solve_qp(QpData(*[t.cpu() for t in qg]), iters=12, stiff_iters=4, k_stiff=8)
        torch.testing.assert_close(got.dz.cpu(), want.dz, atol=1e-4, rtol=0)
    for k_s, g, w, r in _launches(qg, k_stiff):
        _as_accurate(f"ip_phase ({B}, {nz}, {nc}) launch k_s={k_s} dz", g[0], w[0], r[0])
    if not main:
        return
    n0, n5, n6 = _count("ip_phase"), _count("factor_solve"), _count("solve")
    got = solve_qp(qg, iters=12, stiff_iters=4, k_stiff=6)
    assert _count("ip_phase") == n0
    assert _count("factor_solve") == n5 + 12 and _count("solve") == n6 + 12
    want = solve_qp(QpData(*[t.cpu() for t in qg]), iters=12, stiff_iters=4, k_stiff=6)
    torch.testing.assert_close(got.dz.cpu(), want.dz, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_ip_phase_kernel_tied_stiff_rows(cuda_device):
    """Duplicated constraint rows with equal bounds tie exactly in the raw
    eta; the kernel must rank them as the plain version's stable descending
    sort does (ties to the lower index).  Which of two tied rows is stiff
    (uncapped, exact in the Woodbury set) and which mild shows in their
    slacks, not in dz: the stiff launch's dz, sl and su, from the plain
    version's input state, are held as in test_ip_phase_kernel_matches_plain."""
    from sdf_nmpc_tpu_torch.solver.qp import QpData

    q = _random_qp(64, 80, 63, tied=True, rng=np.random.default_rng(31))
    qg = QpData(**{k: t32(v).to(cuda_device) for k, v in q.items()})
    n0 = _count("ip_phase")
    launches = _launches(qg, 8)
    assert [k for k, *_ in launches] == [0, 8] and _count("ip_phase") == n0 + 2
    _, got, want, ref = launches[1]
    for name, i in (("dz", 0), ("sl", 1), ("su", 2)):
        _as_accurate(f"ip_phase tied rows, stiff launch {name}", got[i], want[i], ref[i])


def _spd_system(n, k, r, B=300):
    """A seeded SPD batch with stiff rows as the interior point builds them:
    A = G G' + 10 I, Cs rows, ds_inv = 1 / eta_s with eta_s in [1e2, 1e6]."""
    G = RNG.normal(size=(B, n, n))
    return dict(A=np.einsum("bij,bkj->bik", G, G) + 10 * np.eye(n),
                RHS=RNG.normal(size=(B, r, n)), Cs=RNG.normal(size=(B, k, n)),
                dsi=1.0 / 10.0 ** RNG.uniform(2, 6, size=(B, k)), R2=RNG.normal(size=(B, r, n)))


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 7])
def test_factor_solve_and_solve_kernels_match_plain(cuda_device, r):
    """Kernels 5 and 6 at n=80 on 300 seeded SPD systems, r=1 and r=7 rows:
    X within 1e-4 and L within 1e-5 of their largest entries
    (tests/test_torch_qp_kernels.py); L is zero above the diagonal."""
    from sdf_nmpc_tpu_torch.ops.qp_kernels import factor_solve, factor_solve_plain, solve, solve_plain

    s = {k: t32(v).to(cuda_device) for k, v in _spd_system(80, 8, r).items()}
    n5, n6 = _count("factor_solve"), _count("solve")
    X, L = factor_solve(s["A"], s["RHS"])
    X2 = solve(L, s["R2"])
    assert (_count("factor_solve"), _count("solve")) == (n5 + 1, n6 + 1)
    Xp, Lp = factor_solve_plain(s["A"], s["RHS"])
    assert _rel(X, Xp) < 1e-4 and _rel(L, Lp) < 1e-5
    assert _rel(X2, solve_plain(Lp, s["R2"])) < 1e-4
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.gpu
def test_stiff_factor_solve_and_resolve_kernels_match_plain(cuda_device):
    """Kernels 7 and 8 at n=80, k=8, r=1 on 300 seeded systems: X and the
    re-solve within 2e-3 of their largest entries (eta_s up to 1e6), Xs
    1e-4, L 1e-5, Lt 1e-4 (tests/test_torch_qp_kernels.py)."""
    from sdf_nmpc_tpu_torch.ops.qp_kernels import (
        stiff_factor_solve,
        stiff_factor_solve_plain,
        stiff_resolve,
        stiff_resolve_plain,
    )

    s = {k: t32(v).to(cuda_device) for k, v in _spd_system(80, 8, 1).items()}
    n7, n8 = _count("stiff_factor_solve"), _count("stiff_resolve")
    X, (L, Xs, Lt) = stiff_factor_solve(s["A"], s["RHS"], s["Cs"], s["dsi"])
    X2 = stiff_resolve(L, Xs, Lt, s["Cs"], s["R2"])
    assert (_count("stiff_factor_solve"), _count("stiff_resolve")) == (n7 + 1, n8 + 1)
    Xp, (Lp, Xsp, Ltp) = stiff_factor_solve_plain(s["A"], s["RHS"], s["Cs"], s["dsi"])
    assert _rel(X, Xp) < 2e-3 and _rel(Xs, Xsp) < 1e-4
    assert _rel(L, Lp) < 1e-5 and _rel(Lt, Ltp) < 1e-4
    assert _rel(X2, stiff_resolve_plain(Lp, Xsp, Ltp, s["Cs"], s["R2"])) < 2e-3


def _family(model):
    """(model spec, parameter layout) of a quad family; wrench with the
    torque limit 2.0 of the accuracy workload."""
    from sdf_nmpc_tpu_torch.models import make_model
    from sdf_nmpc_tpu_torch.params import ParamLayout
    from sdf_nmpc_tpu_torch.utils.accuracy import family_config
    from sdf_nmpc_tpu_torch.config import default_config

    cfg = family_config(default_config(), model)
    return make_model(cfg), ParamLayout.from_cfg(cfg)


def _points(M, nx, rng=RNG):
    """M random (x, u, dt): tilts within ~25 degrees (att_tau divides by
    cos(pitch)), body rates ~0.5, inputs inside the box."""
    x = rng.normal(size=(M, nx)) * 0.5
    x[:, 3:7] = np.array([1.0, 0, 0, 0]) + rng.normal(size=(M, 4)) * 0.2
    u = rng.uniform(-0.9, 0.9, size=(M, 4))
    u[:, 0] = rng.uniform(0.1, 0.9, size=M)
    return x, u, rng.uniform(0.01, 0.1, size=M)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["rates", "wrench", "props"])
def test_erk4_sens_kernel_matches_plain(cuda_device, model):
    """Kernel 9 on 4099 random points (not a block multiple): x+, A and B
    each within 1e-4 (1 + its largest magnitude) of the plain version (props'
    B reaches ~14: the wp^2 terms)."""
    from sdf_nmpc_tpu_torch.ops.lin_kernels import erk4_sens, erk4_sens_plain

    spec, _ = _family(model)
    args = [t32(a).to(cuda_device) for a in _points(4099, spec.nx)]
    n0, n1 = _count("erk4_sens"), _count("lin_y_sens")
    got = erk4_sens(spec, *args)
    assert (_count("erk4_sens"), _count("lin_y_sens")) == (n0 + 1, n1)
    f64 = erk4_sens_plain(spec, *[a.double() for a in args])
    for name, g, w, r in zip(("x+", "A", "B"), got, erk4_sens_plain(spec, *args), f64):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        print(f"{model} {name}: kernel - plain f32 {max_abs(g, w):.3e}, kernel - f64 "
              f"{max_abs(g, r):.3e}, plain f32 - f64 {max_abs(w, r):.3e}")
        assert max_abs(g, w) <= 1e-4 * (1 + float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["acc", "att_tau"])
def test_lin_y_sens_kernel_matches_plain_families(cuda_device, model):
    """Kernel 1's acc and att_tau instantiations on 4099 random points, each
    output (x+, A, B, res, Jyx, Jyu) held against the plain version in f64
    on the same f32 inputs: the kernel's distance to it within chip_smoke's
    absolute LIN_TOL, or within twice the plain f32 version's own distance
    to it where that is larger.  A faulty derivative rule (atan2_, asin_clip_
    of csrc/dual.cuh) lands orders of magnitude beyond either.  att_tau's A
    carries the lag's 1 / TAU and reaches ~8 here.  On an H100 the kernel
    and the plain f32 version lay 1.63e-4 apart on it, on either side of
    f64: kernel 9.68e-5 and plain f32 7.61e-5 from it (x+ 2.3e-6 / 1.2e-6,
    Jyx 9.4e-6 / 9.4e-6); acc's outputs within 3.6e-7 of f64, both."""
    from sdf_nmpc_tpu_torch.ops.lin_kernels import lin_y_sens, lin_y_sens_plain

    spec, lay = _family(model)
    M = 4099
    x, u, dt = _points(M, 10)
    p = np.zeros((M, lay.np_total))
    qd = RNG.normal(size=(M, 4))
    p[:, list(lay.q_d)] = qd / np.linalg.norm(qd, axis=1, keepdims=True)
    args = [t32(a).to(cuda_device) for a in (x, u, dt, p, RNG.normal(size=(M, 11)))]
    n0, n1 = _count("lin_y_sens"), _count("erk4_sens")
    got = lin_y_sens(spec, lay, *args)
    assert (_count("lin_y_sens"), _count("erk4_sens")) == (n0 + 1, n1)
    plain = lin_y_sens_plain(spec, *args)
    f64 = lin_y_sens_plain(spec, *[a.double() for a in args])
    names, tols = ("x+", "A", "B", "res", "Jyx", "Jyu"), (1e-4, 1e-4, 1e-4, 2e-4, 1e-4, 1e-4)
    for name, g, w, r, tol in zip(names, got, plain, f64, tols):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape == r.shape
        e_k, e_p = max_abs(g, r), max_abs(w, r)
        print(f"{model} {name}: kernel - f64 {e_k:.3e}, plain f32 - f64 {e_p:.3e}, "
              f"kernel - plain f32 {max_abs(g, w):.3e}, max |f64| {float(r.abs().max()):.3g}")
        assert e_k <= max(tol, 2 * e_p), name


@pytest.mark.gpu
@pytest.mark.parametrize("embed, act", [("oct", "sin"), ("none", "relu"), ("pos", "softplus")])
def test_sdf_fused_kernel_small_random_net(cuda_device, embed, act):
    """The f32 route (sdf_fused.cu) on a seeded 4x32 net (latent 16,
    res='full') per activation, 45 points (two 16-point tiles and a partial
    one), against the exact plain version: value 2e-4, gradient 2e-3
    (tests/test_ops.py); the value of a padded column (softplus(0) = log 2)
    must not leak through the zero weight rows."""
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.ops.sdf_fused import (
        pack_neural_df_params,
        sdf_value_grad,
        sdf_value_grad_plain,
    )

    torch.manual_seed(7)
    net = NeuralDF(size_latent=16, layer_sizes=(32, 32, 32, 32), embed=embed, act=act, w0=2.0,
                   res="full").to(cuda_device)
    packed = pack_neural_df_params(net)
    rng = np.random.default_rng(59)
    pos, latent = (t32(a).to(cuda_device) for a in (rng.normal(size=(45, 3)),
                                                     rng.normal(size=(45, 16)) * 0.3))
    n0 = _count("sdf_fused")
    got = sdf_value_grad(packed, pos, latent, mode="f32")
    assert _count("sdf_fused") == n0 + 1
    for g, w, tol in zip(got, sdf_value_grad_plain(packed, pos, latent), (2e-4, 2e-3)):
        torch.testing.assert_close(g, w, atol=tol, rtol=0)


@pytest.mark.gpu
def test_sdf_fused_geometry(cuda_device):
    """The f32 kernel's launch: 256 threads (8 warps, 16 points), 111,104 B
    of shared memory (activations 256 x 68 words, 2 ring stages of a 16 x
    256 weight chunk and 16 x 68 input words), two blocks per SM."""
    from sdf_nmpc_tpu_torch.ops.sdf_fused import sdf_fused_geometry

    geo = sdf_fused_geometry()
    print(f"f32: {geo}")
    assert geo == {"threads": 256, "smem_bytes": 4 * (256 * 68 + 2 * (16 * 256 + 16 * 68)),
                   "blocks_per_sm": 2}


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.gpu
def test_sdf_fused_x3_kernel_matches_plain_trained_net(cuda_device):
    """Kernel 2's f32x3 route (3xTF32 on the tensor cores) on the trained
    4x256 net (w0=20), 1037 points (not a multiple of the 32-point tile),
    against its own plain version (the same split and grouping in f32
    matmuls): value 2e-4, gradient 2e-3 (tests/test_ops.py); the f32 route
    is not launched."""
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_latents, load_prod_sdf
    from sdf_nmpc_tpu_torch.ops.sdf_fused import (
        pack_neural_df_params,
        sdf_value_grad,
        sdf_value_grad_x3_plain,
    )

    rng = np.random.default_rng(41)
    packed = pack_neural_df_params(load_prod_sdf(device=cuda_device))
    lat = load_prod_latents()
    P = 1037
    pos = t32(rng.normal(size=(P, 3)) * 1.5).to(cuda_device)
    latent = t32(lat[rng.integers(0, lat.shape[0], P)]).to(cuda_device)
    n0, n1 = _count("sdf_fused_x3"), _count("sdf_fused")
    df, gr = sdf_value_grad(packed, pos, latent, mode="f32x3")
    assert (_count("sdf_fused_x3"), _count("sdf_fused")) == (n0 + 1, n1)
    df_p, gr_p = sdf_value_grad_x3_plain(packed, pos, latent)
    print(f"sdf_fused_x3 trained net: value {max_abs(df, df_p):.2e}, grad {max_abs(gr, gr_p):.2e}")
    torch.testing.assert_close(df, df_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(gr, gr_p, atol=2e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("embed, act", [("oct", "sin"), ("none", "relu"), ("pos", "softplus")])
def test_sdf_fused_x3_kernel_small_random_net(cuda_device, embed, act):
    """The f32x3 route on a seeded 4x32 net (latent 16, res='full') per
    activation, 45 points, against its plain version at the same
    tolerances; the value of a padded column (softplus(0) = log 2) must not
    leak through the zero weight rows."""
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.ops.sdf_fused import (
        pack_neural_df_params,
        sdf_value_grad,
        sdf_value_grad_x3_plain,
    )

    torch.manual_seed(7)
    net = NeuralDF(size_latent=16, layer_sizes=(32, 32, 32, 32), embed=embed, act=act, w0=2.0,
                   res="full").to(cuda_device)
    packed = pack_neural_df_params(net)
    rng = np.random.default_rng(43)
    pos, latent = (t32(a).to(cuda_device) for a in (rng.normal(size=(45, 3)),
                                                     rng.normal(size=(45, 16)) * 0.3))
    n0 = _count("sdf_fused_x3")
    got = sdf_value_grad(packed, pos, latent, mode="f32x3")
    assert _count("sdf_fused_x3") == n0 + 1
    for g, w, tol in zip(got, sdf_value_grad_x3_plain(packed, pos, latent), (2e-4, 2e-3)):
        torch.testing.assert_close(g, w, atol=tol, rtol=0)


def _backward_error(M, X, RHS):
    """Per scenario, max |M x - b| / (max |M| max |x| + max |b|) over the
    rows of X, in f64 (chip_smoke.py's backward_error)."""
    M, X, RHS = M.double(), X.double(), RHS.double()
    res = (M @ X.transpose(1, 2) - RHS.transpose(1, 2)).abs().flatten(1).amax(-1)
    size = M.abs().flatten(1).amax(-1) * X.abs().flatten(1).amax(-1)
    return res / (size + RHS.abs().flatten(1).amax(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [44, 80, 128])
@pytest.mark.parametrize("r", [1, 2, 9])
def test_factor_solve_and_solve_kernel_shapes(cuda_device, n, r):
    """Kernel 5 (blocked Cholesky and warp-level solves) and kernel 6 (the
    same solves against its factor) at n not a multiple of the 8-column
    panel (44), the main size (80) and above the 128 threads of a block
    (128), with 1, 2 and 9 right-hand sides (more than the 4 warps): X
    within 1e-4 and L within 1e-5 of their largest entries of the plain
    version, L zero above the diagonal, and the backward error of each X
    at most 10 times the plain version's plus 1e-6 (chip_smoke.py's rule for
    kernels 5-8)."""
    from sdf_nmpc_tpu_torch.ops.qp_kernels import (
        factor_solve,
        factor_solve_plain,
        solve,
        solve_plain,
    )

    rng = np.random.default_rng([n, r])
    G = rng.normal(size=(200, n, n))
    A = t32(np.einsum("bij,bkj->bik", G, G) + 10 * np.eye(n)).to(cuda_device)
    RHS, R2 = (t32(rng.normal(size=(200, r, n))).to(cuda_device) for _ in range(2))
    n5, n6 = _count("factor_solve"), _count("solve")
    X, L = factor_solve(A, RHS)
    X2 = solve(L, R2)
    assert (_count("factor_solve"), _count("solve")) == (n5 + 1, n6 + 1)
    Xp, Lp = factor_solve_plain(A, RHS)
    X2p = solve_plain(Lp, R2)
    assert _rel(X, Xp) < 1e-4 and _rel(L, Lp) < 1e-5 and _rel(X2, X2p) < 1e-4
    assert bool((torch.triu(L, 1) == 0).all())
    for label, x, xp, b in (("factor_solve", X, Xp, RHS), ("solve", X2, X2p, R2)):
        bk, bp = (float(_backward_error(A, v, b).max()) for v in (x, xp))
        print(f"{label} n={n} r={r}: backward error kernel {bk:.2e}, plain {bp:.2e}")
        assert bk <= 10 * bp + 1e-6, label


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 3])
def test_stiff_kernels_at_the_wide_split(cuda_device, r):
    """Kernels 7 and 8 at the recursive-feasibility QP's size: n = 80 and
    k = 48 stiff rows (its wide stiff split), held as at k = 8 and 16
    (test_stiff_factor_solve_and_resolve_kernel_shapes)."""
    test_stiff_factor_solve_and_resolve_kernel_shapes(cuda_device, 80, r, 48)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [44, 80, 128])
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("k", [8, 16])
def test_stiff_factor_solve_and_resolve_kernel_shapes(cuda_device, n, r, k):
    """Kernel 7 (blocked Cholesky, the r + k rows in warp-level solves, T and
    the Woodbury correction in one warp) and kernel 8 (warp-level solves and
    corrections) at n not a multiple of the 8-column panel (44), the main
    size (80) and above the 128 threads of a block (128), with 1 and 3
    right-hand sides and k = 8 and 16 stiff rows: X and the re-solve within
    2e-3 of their largest entries of the plain version, Xs 1e-4, L 1e-5, Lt
    1e-4 (test_stiff_factor_solve_and_resolve_kernels_match_plain); L and Lt
    zero above the diagonal; the backward error of each X against
    A + Cs' diag(1/ds_inv) Cs, and against the same matrix with T's jitter
    in ds_inv (the system both versions solve exactly, chip_smoke.py's
    system_matrix), at most 10 times the plain version's plus 1e-6; the
    launch geometry of both kernels."""
    from sdf_nmpc_tpu_torch.ops.qp_kernels import (
        stiff_factor_solve,
        stiff_factor_solve_geometry,
        stiff_factor_solve_plain,
        stiff_resolve,
        stiff_resolve_geometry,
        stiff_resolve_plain,
    )

    rng = np.random.default_rng([n, r, k, 7])
    G = rng.normal(size=(200, n, n))
    A = t32(np.einsum("bij,bkj->bik", G, G) + 10 * np.eye(n)).to(cuda_device)
    RHS, R2 = (t32(rng.normal(size=(200, r, n))).to(cuda_device) for _ in range(2))
    Cs = t32(rng.normal(size=(200, k, n))).to(cuda_device)
    dsi = t32(1.0 / 10.0 ** rng.uniform(2, 6, size=(200, k))).to(cuda_device)
    n7, n8 = _count("stiff_factor_solve"), _count("stiff_resolve")
    X, (L, Xs, Lt) = stiff_factor_solve(A, RHS, Cs, dsi)
    X2 = stiff_resolve(L, Xs, Lt, Cs, R2)
    assert (_count("stiff_factor_solve"), _count("stiff_resolve")) == (n7 + 1, n8 + 1)
    Xp, (Lp, Xsp, Ltp) = stiff_factor_solve_plain(A, RHS, Cs, dsi)
    X2p = stiff_resolve_plain(Lp, Xsp, Ltp, Cs, R2)
    assert _rel(X, Xp) < 2e-3 and _rel(Xs, Xsp) < 1e-4
    assert _rel(L, Lp) < 1e-5 and _rel(Lt, Ltp) < 1e-4 and _rel(X2, X2p) < 2e-3
    assert bool((torch.triu(L, 1) == 0).all()) and bool((torch.triu(Lt, 1) == 0).all())
    A64, C64, d64 = A.double(), Cs.double(), dsi.double()
    T_ii = (C64 * torch.linalg.solve(A64, C64.transpose(1, 2)).transpose(1, 2)).sum(-1) + d64
    jittered = d64 + 10 * torch.finfo(torch.float32).eps * (T_ii.abs() + 1e-30)
    for label, s in (("ds_inv", d64), ("ds_inv with T's jitter", jittered)):
        M = A64 + C64.transpose(1, 2) @ (C64 / s[..., None])
        for name, x, xp, b in (("stiff_factor_solve", X, Xp, RHS), ("stiff_resolve", X2, X2p, R2)):
            bk, bp = (float(_backward_error(M, v, b).max()) for v in (x, xp))
            print(f"{name} n={n} r={r} k={k}, {label}: backward error kernel {bk:.2e}, "
                  f"plain {bp:.2e}")
            assert bk <= 10 * bp + 1e-6, (name, label)
    ld = n | 1
    geo7, geo8 = stiff_factor_solve_geometry(n, r, k), stiff_resolve_geometry(n, r, k)
    assert geo7["threads"] == geo8["threads"] == 128
    assert geo7["smem_bytes"] == 4 * (ld * (n + r + k) + max(4 * 72, k * (k + 2 * r)))
    assert geo8["smem_bytes"] == 4 * (ld * (n + r + 2 * k) + k * (k + 8))
    assert geo7["blocks_per_sm"] >= 1 and geo8["blocks_per_sm"] >= 1
    print(f"n={n} r={r} k={k}: kernel 7 {geo7}, kernel 8 {geo8}")


def _condense_args(B, N, nx, nu, ny, nh, rng, device):
    """test_condense_kernel_matches_plain's data at any shape."""
    shapes = [(B, N, nx, nu), (B, N, nx), (B, nx), (B, N, ny, nx),
              (B, N, ny, nu), (B, N, ny), (B, N, nh, nx), (B, N, nh, nu), (B, N, nh)]
    A = np.eye(nx) + 0.05 * rng.normal(size=(B, N, nx, nx))
    return [t32(a).to(device) for a in [A] + [rng.normal(size=s) for s in shapes]]


@pytest.mark.gpu
@pytest.mark.parametrize("nx", [10, 13])
@pytest.mark.parametrize("ny", [11, 16])
@pytest.mark.parametrize("nh", [1, 3])
@pytest.mark.parametrize("N", [5, 20])
def test_condense_kernel_shapes(cuda_device, nx, ny, nh, N):
    """Kernel 3 (one block per scenario, one thread per four columns of E) at the
    families' widths, 1 and 3 constraint rows, a short and the main horizon,
    301 scenarios: every output within 1e-5 absolute and relative of the
    plain version, or, where the plain f32 version itself strays that far,
    as close to the plain version in f64 as the plain f32 version is, within
    twice its distance (as test_lin_y_sens_kernel_matches_plain_families).
    Over 20 stages E grows to magnitudes of ~10 on this data, and the
    kernel's and cuBLAS's f32 sums part by a few 1e-5 on one entry in ~1e5.
    Also E_k's columns beyond k nu exactly zero, and the launch geometry
    (ceil(nz / 4) + 1 threads in whole warps, two stage buffers)."""
    from sdf_nmpc_tpu_torch.ops.condense_kernel import condense, condense_geometry, condense_plain

    nu, B = 4, 301
    args = _condense_args(B, N, nx, nu, ny, nh, np.random.default_rng([nx, ny, nh, N]),
                          cuda_device)
    n0 = _count("condense")
    got = condense(*args)
    assert _count("condense") == n0 + 1
    want, ref = condense_plain(*args), condense_plain(*[a.double() for a in args])
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        excess = float(((g.double() - w.double()).abs() - 1e-5 * w.double().abs()).max())
        e_k, e_p = max_abs(g, r), max_abs(w, r)
        print(f"output {i}: excess over 1e-5 rel {excess:.2e}, kernel - f64 {e_k:.2e}, "
              f"plain f32 - f64 {e_p:.2e}")
        assert excess <= 1e-5 or e_k <= 2 * e_p, i
    for k in range(N):
        assert bool((got[1][:, k, :, k * nu:] == 0).all())
    r4 = lambda n: (n + 3) // 4 * 4
    words = (nx + ny + nh) * r4(nx) + sum(map(r4, (nx * nu, ny * nu, nh * nu, nx, ny, nh)))
    geo = condense_geometry(N, nx, nu, ny, nh)
    assert geo["threads"] == ((N * nu + 3) // 4 + 32) // 32 * 32
    assert geo["smem_bytes"] == 8 * words
    assert geo["blocks_per_sm"] >= 4
    print(f"N={N} nx={nx} ny={ny} nh={nh}: {geo}")


@pytest.mark.gpu
def test_lin_y_sens_geometry(cuda_device):
    """Kernel 1's launch for each model: 112 threads (16 points of 7 sweeps
    of two directions each), the 16 points' inputs and outputs in shared
    memory."""
    from sdf_nmpc_tpu_torch.ops.lin_kernels import lin_y_sens_geometry

    for model in ("att", "acc", "att_tau"):
        spec, _ = _family(model)
        geo = lin_y_sens_geometry(spec)
        assert geo["threads"] == 112 and geo["smem_bytes"] == 16 * 4 * (30 + 315), model
        assert geo["blocks_per_sm"] >= 4, model
        print(f"{model}: {geo}")


@pytest.mark.gpu
def test_erk4_sens_geometry(cuda_device):
    """Kernel 9's launch for each model: 16 points of (nx + 5) / 2 threads
    (rates, att, acc and att_tau 112, wrench and props 144: two tangent
    directions each), the 16 points' inputs and outputs in shared memory."""
    from sdf_nmpc_tpu_torch.ops.lin_kernels import erk4_sens_geometry

    for model in ("rates", "wrench", "props", "att", "acc", "att_tau"):
        spec, _ = _family(model)
        nx = spec.nx
        geo = erk4_sens_geometry(spec)
        print(f"{model}: {geo}")
        assert geo["threads"] == 16 * ((nx + 5) // 2), model
        assert geo["smem_bytes"] == 16 * 4 * (nx + 5 + nx * (1 + nx + 4)), model
        assert geo["blocks_per_sm"] >= 4, model


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["rates", "wrench", "props"])
@pytest.mark.parametrize("M", [1, 15, 33])
def test_erk4_sens_kernel_ragged_blocks(cuda_device, model, M):
    """Kernel 9 on M points that leave a partial 16-point block (1, 15, 33):
    x+, A and B within 1e-4 (1 + their largest magnitude) of the plain
    version, and each point equal bit for bit to the same point among 64
    (a block's points do not mix)."""
    from sdf_nmpc_tpu_torch.ops.lin_kernels import erk4_sens, erk4_sens_plain

    spec, _ = _family(model)
    args = [t32(a).to(cuda_device) for a in _points(64, spec.nx)]
    full = erk4_sens(spec, *args)
    part = [a[:M].contiguous() for a in args]
    got = erk4_sens(spec, *part)
    for g, f, w in zip(got, full, erk4_sens_plain(spec, *part)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert torch.equal(g, f[:M])
        assert max_abs(g, w) <= 1e-4 * (1 + float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["att", "acc", "att_tau"])
@pytest.mark.parametrize("M", [1, 15, 33, 163840])
def test_erk4_sens_sdf_cost_instances_match_plain(cuda_device, model, M):
    """Kernel 9's att, acc and att_tau instances (the step's linearization
    under sdf_cost) on M points: a partial 16-point block (1, 15, 33) and
    the main path's B=8192 x N=20 points.  x+, A and B each held against
    the plain version in f64 on the same f32 inputs, as kernel 1's families
    are (test_lin_y_sens_kernel_matches_plain_families): the kernel's
    distance to it within 1e-4 (1 + its largest magnitude), or within twice
    the plain f32 version's own distance where that is larger (att_tau's
    lag divides by cos(pitch), and among 163,840 seeded points a few lie
    near a vertical body axis, where A reaches ~700).  One launch of kernel
    9 and none of kernel 1; a partial block's points equal bit for bit to
    the same points among 64."""
    from sdf_nmpc_tpu_torch.ops.lin_kernels import erk4_sens, erk4_sens_plain

    spec, _ = _family(model)
    rng = np.random.default_rng([M, len(model), 9])
    args = [t32(a).to(cuda_device) for a in _points(max(M, 64), spec.nx, rng)]
    part = [a[:M].contiguous() for a in args]
    n0, n1 = _count("erk4_sens"), _count("lin_y_sens")
    got = erk4_sens(spec, *part)
    assert (_count("erk4_sens"), _count("lin_y_sens")) == (n0 + 1, n1)
    full = erk4_sens(spec, *args) if M < 64 else got
    f64 = erk4_sens_plain(spec, *[a.double() for a in part])
    for name, g, f, w, r in zip(("x+", "A", "B"), got, full, erk4_sens_plain(spec, *part), f64):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all()) and torch.equal(g, f[:M]), name
        e_k, e_p = max_abs(g, r), max_abs(w, r)
        print(f"{model} M={M} {name}: kernel - f64 {e_k:.3e}, plain f32 - f64 {e_p:.3e}, "
              f"kernel - plain f32 {max_abs(g, w):.3e}, max |f64| {float(r.abs().max()):.3g}")
        assert e_k <= max(1e-4 * (1 + float(r.abs().max())), 2 * e_p), name


@pytest.mark.gpu
def test_recfeas_accuracy_on_card(cuda_device):
    """The recursive-feasibility workload on the card (kernel 4 at the wide
    stiff split k_s = 48): its 8 cold scenarios against the independent
    oracle's recfeas_u0 under the JAX package's CI gate (mean <= 2.5e-4,
    max <= 2.5e-3), every status OK."""
    from sdf_nmpc_tpu_torch.utils import accuracy

    rep = accuracy.check_accuracy(device=cuda_device, variant="recfeas")
    print(rep)
    assert rep["n_scen"] == 8 and rep["n_ok"] == 8
    assert accuracy.ci_gate_ok(rep["u0_mean_err"], rep["u0_max_err"]), rep


@pytest.mark.gpu
def test_nan_in_one_scenario_stays_there(cuda_device, monkeypatch):
    """One fused att step (cold budget) on the 32 accuracy scenarios twice
    over, once clean and once with a NaN in one scenario's A_5 (kernel 1's
    output, before kernel 3 condenses it): that scenario reports STATUS_NAN
    and keeps its iterate, and every other scenario's result equals the
    clean run's bit for bit.  Kernel 3 takes the products of E's zero
    columns from the stage of the NaN on (0 * NaN = NaN, as the JAX
    kernel), so the NaN reaches every column from stage 5 on; only that
    scenario may change."""
    from sdf_nmpc_tpu_torch.ops import lin_kernels
    from sdf_nmpc_tpu_torch.solver import STATUS_NAN, STATUS_OK, init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy

    cfg, ocp, layout, lat = accuracy.build_setup(device=cuda_device)
    scen = accuracy.build_scenarios(cfg, ocp, layout, lat)
    inputs = accuracy.scenario_inputs(ocp, scen, torch.float32, cuda_device, reps=2)
    step = make_rti_step(ocp, cfg, budget="cold", with_evals=False)
    state = init_state(ocp, inputs.x0)
    clean = step(state, inputs)
    bad, k = 7, 5
    lin = lin_kernels.lin_y_sens

    def poisoned(*a):
        out = lin(*a)
        out[1][bad * ocp.N + k, 2, 3] = float("nan")
        return out

    monkeypatch.setattr(lin_kernels, "lin_y_sens", poisoned)
    n0 = _count("condense")
    res = step(state, inputs)
    assert _count("condense") == n0 + 1
    others = torch.arange(res.status.shape[0], device=cuda_device) != bad
    assert int(res.status[bad]) == STATUS_NAN
    assert bool((clean.status[others] == STATUS_OK).all())
    assert torch.equal(res.state.X[bad], state.X[bad]) and torch.equal(res.state.U[bad],
                                                                       state.U[bad])
    for name in ("status", "u0", "kkt_residual"):
        assert torch.equal(getattr(res, name)[others], getattr(clean, name)[others]), name
    for name in ("X", "U"):
        assert torch.equal(getattr(res.state, name)[others], getattr(clean.state, name)[others])


def _rule_holds(got, want, rule):
    """chip_smoke.py's share / median / max rule of per-point deviations."""
    thr, share_max, med_max, mx_max = rule
    d = (got.double() - want.double()).abs().reshape(got.shape[0], -1).amax(-1)
    share, med, mx = float((d > thr).double().mean()), float(d.median()), float(d.max())
    print(f"share above {thr:g} {share:.2%}, median {med:.1e}, max {mx:.1e}")
    return share <= share_max and med <= med_max and mx <= mx_max


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "mixed"])
def test_sdf_fused_bf16_kernel_matches_plain_trained_net(cuda_device, mode):
    """Kernel 2's bf16 and mixed routes (sdf_fused_bf16.cu) on the trained
    4x256 net, 2,077 points (not a multiple of the 16- or 32-point tile), against
    their own plain versions, value and gradient per point under
    chip_smoke.py's SDF_BF16_RULE (share beyond 1e-3 at most 2% / 10%, the
    median at most 1e-6, the max at most 2e-2 / 5e-2); mixed's value rows
    are exact f32, within 2e-4 (tests/test_ops.py).  No other kernel-2 route
    is launched."""
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_latents, load_prod_sdf
    from sdf_nmpc_tpu_torch.ops.sdf_fused import PLAIN, pack_neural_df_params, sdf_value_grad

    rules = ((1e-3, 0.02, 1e-6, 2e-2), (1e-3, 0.10, 1e-6, 5e-2))
    rng = np.random.default_rng(47)
    packed = pack_neural_df_params(load_prod_sdf(device=cuda_device))
    lat = load_prod_latents()
    P = 2077
    pos = t32(rng.normal(size=(P, 3)) * 1.5).to(cuda_device)
    latent = t32(lat[rng.integers(0, lat.shape[0], P)]).to(cuda_device)
    names = ("sdf_fused", "sdf_fused_x3", "sdf_fused_bf16", "sdf_fused_mixed")
    before = {n: _count(n) for n in names}
    got = sdf_value_grad(packed, pos, latent, mode=mode)
    assert {n: _count(n) - before[n] for n in names} == {
        n: int(n == f"sdf_fused_{mode}") for n in names}
    want = PLAIN[mode](packed, pos, latent)
    for g, w, rule in zip(got, want, rules):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rule_holds(g, w, rule)
    if mode == "mixed":
        torch.testing.assert_close(got[0], want[0], atol=2e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "mixed"])
@pytest.mark.parametrize("embed, act", [("oct", "sin"), ("none", "relu"), ("pos", "softplus")])
def test_sdf_fused_bf16_kernel_small_random_net(cuda_device, mode, embed, act):
    """The bf16 and mixed routes on a seeded 4x32 net (latent 16) per
    activation, 45 points, against their plain versions: the median of each
    output within 1e-6 and its max within 1e-2 (a one-ulp f32 difference
    can flip a bf16 rounding; chip_smoke.py's SDF_BF16_RULE); the value of a
    padded column (softplus(0) = log 2) must not leak through the zero
    weight rows."""
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.ops.sdf_fused import PLAIN, pack_neural_df_params, sdf_value_grad

    torch.manual_seed(7)
    net = NeuralDF(size_latent=16, layer_sizes=(32, 32, 32, 32), embed=embed, act=act, w0=2.0,
                   res="full").to(cuda_device)
    packed = pack_neural_df_params(net)
    rng = np.random.default_rng(53)
    pos, latent = (t32(a).to(cuda_device) for a in (rng.normal(size=(45, 3)),
                                                     rng.normal(size=(45, 16)) * 0.3))
    n0 = _count(f"sdf_fused_{mode}")
    got = sdf_value_grad(packed, pos, latent, mode=mode)
    assert _count(f"sdf_fused_{mode}") == n0 + 1
    for g, w in zip(got, PLAIN[mode](packed, pos, latent)):
        d = (g - w).abs()
        assert float(d.median()) <= 1e-6 and float(d.max()) <= 1e-2, (d.median(), d.max())


@pytest.mark.gpu
def test_sdf_fused_bf16_geometry(cuda_device):
    """The bf16 and mixed kernels' launch for the trained net (83 embedding,
    128 latent columns): bf16 256 threads (8 warps, 16 points) and 100,384 B
    of shared memory, two blocks per SM; mixed 768 threads (8 primal and 16
    tangent warps, 32 points) and 207,904 B, one block per SM."""
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_sdf
    from sdf_nmpc_tpu_torch.ops.sdf_fused import pack_neural_df_params, sdf_fused_bf16_geometry

    packed = pack_neural_df_params(load_prod_sdf(device=cuda_device))
    for mode, want in (("bf16", {"threads": 256, "smem_bytes": 100384, "blocks_per_sm": 2}),
                       ("mixed", {"threads": 768, "smem_bytes": 207904, "blocks_per_sm": 1})):
        geo = sdf_fused_bf16_geometry(mode, packed)
        print(f"{mode}: {geo}")
        assert geo == want, mode


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "mixed"])
@pytest.mark.parametrize("P", [1, 33, 97])
def test_sdf_fused_bf16_kernel_ragged_tiles(cuda_device, monkeypatch, mode, P):
    """The bf16 and mixed routes on the trained 4x256 net at P points that
    leave a partial last tile (1; 33; 97, one past a multiple of both
    tiles, 16 and 32 points; its rows come from device memory, not the bulk
    copies): finite outputs of the right shape, each point equal bit for bit
    to the same point evaluated among 160 others (a tile's points do not
    mix; the embedding rows are the same for both, since torch's pos @ dirs
    rounds by the batch size), and within SDF_BF16_RULE's max (2e-2 / 5e-2)
    of the plain version."""
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_latents, load_prod_sdf
    from sdf_nmpc_tpu_torch.ops import sdf_fused

    rng = np.random.default_rng(61)
    packed = sdf_fused.pack_neural_df_params(load_prod_sdf(device=cuda_device))
    lat = load_prod_latents()
    pos = t32(rng.normal(size=(160, 3)) * 1.5).to(cuda_device)
    latent = t32(lat[rng.integers(0, lat.shape[0], 160)]).to(cuda_device)
    emb, demb = sdf_fused.embed_with_tangents(packed["embed_fn"], pos)
    monkeypatch.setattr(sdf_fused, "embed_with_tangents",
                        lambda fn, x: (emb[: x.shape[0]], demb[: x.shape[0]]))
    full = sdf_fused.sdf_value_grad(packed, pos, latent, mode=mode)
    got = sdf_fused.sdf_value_grad(packed, pos[:P].contiguous(), latent[:P].contiguous(),
                                   mode=mode)
    monkeypatch.undo()
    want = sdf_fused.PLAIN[mode](packed, pos[:P], latent[:P])
    for g, f, w, mx in zip(got, full, want, (2e-2, 5e-2)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert torch.equal(g, f[:P])
        assert float((g - w).abs().max()) <= mx


@pytest.mark.gpu
def test_config1_step_launches_kernels_1_5_6(cuda_device):
    """BASELINE config 1 (enable_sdf off) on the card: one cold step on the
    32 accuracy scenarios launches kernel 1 once and kernels 5 and 6 once
    per IP iteration (20), no other kernel; every status OK and the u0
    error against the oracle's nosdf_u0 within the CI gate (mean 2.5e-4,
    max 2.5e-3)."""
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.utils import accuracy

    before = dict(_lib.launch_counts)
    rep = accuracy.check_accuracy(device=cuda_device, variant="nosdf")
    launched = {k: v - before[k] for k, v in _lib.launch_counts.items() if v != before[k]}
    print(rep, launched)
    assert launched == {"lin_y_sens": 1, "factor_solve": 20, "solve": 20}
    assert rep["n_ok"] == rep["n_scen"] == 32
    assert accuracy.ci_gate_ok(rep["u0_mean_err"], rep["u0_max_err"])


@pytest.mark.gpu
def test_trained_encoder_on_card_matches_f64(cuda_device):
    """The trained encoder in f32 on the card against the f64 CPU encoder on
    the 8 config-3 images rendered on the card: max |d| within 1e-4 of
    (1 + max |latent|)."""
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.utils import accuracy

    cfg = default_config()
    imgs = accuracy.config3_images(cfg, torch.float32, cuda_device)
    assert imgs.is_cuda and imgs.shape == (8, 270, 480)
    enc = accuracy.config3_encoder(cfg, torch.float32, cuda_device)
    enc64 = accuracy.config3_encoder(cfg, torch.float64, torch.device("cpu"))
    with torch.no_grad():
        got = enc(imgs[:, None]).double().cpu()
        want = enc64(imgs.double().cpu()[:, None])
    err = float((got - want).abs().max())
    print(f"card latents vs f64: {err:.3e}")
    assert err <= 1e-4 * (1 + float(want.abs().max()))


@pytest.mark.gpu
def test_config3_contract_on_card(cuda_device):
    """BASELINE config 3 on the card (render -> trained encoder -> one cold
    step, default settings): u0 max <= 1e-3 against the f64 oracle
    config3_u0.npz, all 8 statuses OK, kernels 1-4 launched and no other."""
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.utils import accuracy

    before = dict(_lib.launch_counts)
    rep = accuracy.check_config3_accuracy(device=cuda_device)
    launched = {k: v - before[k] for k, v in _lib.launch_counts.items() if v != before[k]}
    print(rep, launched)
    assert launched == {"lin_y_sens": 1, "sdf_fused_x3": 1, "condense": 1, "ip_phase": 2}
    assert rep["n_ok"] == rep["n_scen"] == 8
    assert rep["u0_max_err"] <= accuracy.CONTRACT_MAX


@pytest.mark.gpu
def test_image_fed_mission_tick_on_card(cuda_device):
    """One MissionServer tick fed a raw uint16 depth frame through the
    FrameRing: the preprocessed image, the latent and the controller's
    parameter tensors live on the card, the flag is active, the command is
    finite, and the tick launched kernels 1-4."""
    from sdf_nmpc_tpu_torch.controller import Nmpc
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.perception import VaeRuntime
    from sdf_nmpc_tpu_torch.ref_gen import Waypoint
    from sdf_nmpc_tpu_torch.runtime import FrameRing, MissionServer
    from sdf_nmpc_tpu_torch.utils import accuracy

    cfg, ocp, _, _ = accuracy.build_setup(device=cuda_device)
    cam = cfg.replace(sensor=dict(mm_resolution=1.0))  # uint16 millimetres
    vae = VaeRuntime(cfg.replace(sensor=dict(is_normalized=True, is_depth=False)),
                     accuracy.config3_encoder(cfg, torch.float32, cuda_device),
                     device=cuda_device)
    nmpc = Nmpc(cfg, ocp=ocp)
    server = MissionServer(cfg, nmpc, vae)
    ring = FrameRing(cam)
    raw = (RNG.uniform(800, 5000, size=(270, 480))).astype(np.uint16)
    ring.push(raw, timestamp=0.0)
    frame, ts, stale = ring.latest(now=0.0)
    x = np.zeros(10)
    x[3] = 1.0
    server.feed_state(x, 0.0)
    server.set_flag(True)
    server.goto([Waypoint([3.5, 0.0, 0.0])])
    before = dict(_lib.launch_counts)
    server.feed_image(frame, x[:3], np.eye(3), ts)
    tick = server.tick(0.0)
    launched = {k: v - before[k] for k, v in _lib.launch_counts.items() if v != before[k]}
    assert not stale and vae.img.is_cuda and vae.latent.is_cuda and ocp.device.type == "cuda"
    assert tick.flag_active and tick.fail_count == 0 and np.isfinite(tick.cmd).all()
    assert launched == {"lin_y_sens": 1, "sdf_fused_x3": 1, "condense": 1, "ip_phase": 2}


@pytest.mark.gpu
def test_condense_kernel_nonfinite_as_plain(cuda_device):
    """Kernel 3 on non-finite inputs: NaN in one scenario's A_3, +Inf in
    another's Jyx_1 and NaN in a third's Jhx_4 (att's widths, N = 20, 64
    scenarios): the outputs are NaN and +-Inf exactly where the plain
    version's are (E's zero columns take the products from that stage on,
    0 * NaN = NaN, as the JAX kernel's), the finite entries as in
    test_condense_kernel_shapes, and the finite scenarios bit-equal to the
    same launch without the non-finite entries."""
    from sdf_nmpc_tpu_torch.ops.condense_kernel import condense, condense_plain

    args = _condense_args(64, 20, 10, 4, 11, 3, np.random.default_rng(5), cuda_device)
    clean = condense(*args)
    args[0][0, 3, 1, 7] = float("nan")
    args[4][1, 1, 0, 2] = float("inf")
    args[7][2, 4, 2, 0] = float("nan")
    n0 = _count("condense")
    got = condense(*args)
    assert _count("condense") == n0 + 1
    want = condense_plain(*args)
    for i, (g, w, c) in enumerate(zip(got, want, clean)):
        assert torch.equal(torch.isnan(g), torch.isnan(w)), i
        assert torch.equal(torch.isinf(g), torch.isinf(w)), i
        fin = torch.isfinite(w)
        excess = float(((g[fin].double() - w[fin].double()).abs()
                        - 1e-5 * w[fin].double().abs()).max())
        assert excess <= 1e-5, (i, excess)
        assert torch.equal(g[3:], c[3:]), i
    assert bool(torch.isnan(got[1][0, 5:]).all())  # all of E two stages after A_3


@pytest.mark.gpu
def test_riccati_step_at_n60_matches_the_cpu_plain_step(cuda_device):
    """att at N = 60 (T = 4.5 s) with the trained NeuralDF, default
    settings (qp_backend auto: Riccati), one cold step at B = 64 on the
    card (kernels 1 and 2, once each; no kernel 3-8) against the f32 plain
    step on the CPU on the same inputs: every status OK and finite, u0
    under the JAX package's CI gate (mean <= 2.5e-4, max <= 2.5e-3), the
    kernels' last bits being all that differs."""
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.solver import SolveInputs, init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy

    cfg, ocp, layout, lat = accuracy.build_setup(device=cuda_device, N=60)
    scen = accuracy.build_scenarios(cfg, ocp, layout, lat)
    inputs = accuracy.scenario_inputs(ocp, scen, torch.float32, cuda_device, reps=2)
    _lib.reset_launch_counts()
    res = make_rti_step(ocp, cfg, with_evals=False)(init_state(ocp, inputs.x0), inputs)
    counts = dict(_lib.launch_counts)
    assert counts["lin_y_sens"] == counts["sdf_fused_x3"] == 1
    assert sum(counts.values()) == 2, counts
    cpu_ocp = build_ocp(cfg, sdf=copy.deepcopy(ocp.sdf).cpu(), sdf_max_df=1.0, device="cpu")
    cpu_in = SolveInputs(*[t.cpu() for t in inputs])
    want = make_rti_step(cpu_ocp, cfg, with_evals=False)(init_state(cpu_ocp, cpu_in.x0), cpu_in)
    assert bool((res.status == 0).all()) and bool((want.status == 0).all())
    assert torch.isfinite(res.state.X).all()
    err = (res.u0.cpu().double() - want.u0.double()).abs().amax(-1)
    print(f"u0 card vs CPU plain: mean {float(err.mean()):.3e} max {float(err.max()):.3e}")
    assert accuracy.ci_gate_ok(float(err.mean()), float(err.max()))


@pytest.mark.gpu
def test_closed_loop_ticks_on_card_match_the_cpu(cuda_device):
    """tests/test_sim.py's sphere scene in f32, 10 closed-loop ticks at B =
    2 on the card (kernels 1, 3 and 4 every tick; the oracle row launches no
    kernel 2) against the same rollout on the CPU's plain versions: every
    status OK, xs within 1e-3 (f32 kernels' last bits through 10 chained
    ticks)."""
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.ref_gen import Ref
    from sdf_nmpc_tpu_torch.sim import Scene, make_closed_loop, make_scene_sdf_fn, scene_sdf
    from sdf_nmpc_tpu_torch.solver import SolveInputs

    cfg = default_config().replace(nn=dict(size_latent=8), solver=dict(qp_iters=10))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        scene = Scene.make(spheres=[([1.2, 0.05, 0.0], 0.35)], device=dev)
        ocp = build_ocp(cfg, sdf=make_scene_sdf_fn(scene), sdf_max_df=1.0, device=dev)
        N, B = ocp.N, 2
        p = np.zeros((B, N + 1, ocp.layout.np_total))
        ocp.layout.set_flag(p, 1.0)
        ocp.layout.set_camera(p, np.zeros(3), np.eye(3))
        ocp.layout.set_q_d(p, [1, 0, 0, 0])
        ref = Ref(cfg).use_constrained_weights(False)
        ref.p = np.array([2.0, 0.0, 0.0])
        yr, W = ocp.pack_ref(ref)
        x0 = np.zeros((B, 10))
        x0[:, 3] = 1.0
        x0[1, 1] = 0.1
        T = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        inputs = SolveInputs(x0=T(x0), yref=T(np.tile(yr, (B, N, 1))), W=T(np.tile(W, (B, N, 1))),
                             yrefN=T(np.tile(yr[:ocp.nyN], (B, 1))),
                             WN=T(np.tile(W[:ocp.nyN], (B, 1))), p=T(p))
        _lib.reset_launch_counts()
        res = make_closed_loop(ocp, cfg, n_ticks=10,
                               scene_sdf_fn=lambda q, s=scene: scene_sdf(s, q))(inputs.x0, inputs)
        if dev.type == "cuda":
            counts = dict(_lib.launch_counts)
            assert counts["lin_y_sens"] == counts["condense"] == 10, counts
            assert counts["ip_phase"] == 20 and counts["sdf_fused_x3"] == 0, counts
        assert bool((res.statuses == 0).all())
        out.append(res.xs.cpu())
    print(f"xs card vs CPU: {float((out[0] - out[1]).abs().max()):.3e}")
    torch.testing.assert_close(out[0], out[1], atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_df_computer_on_card_matches_cpu_plain(cuda_device):
    """The signed DfComputer on the card (f32) against its CPU f64 plain
    path on 4 rendered 270 x 480 scenes x 500 points.  Rule: a point's label
    may differ only where a decision of the check lies within 1e-5 m, 2e-4
    px or 1e-5 rad of its boundary; where the labels and the nearest voxel
    agree, the value within 1e-7 (the clamp's -0.3 in f32) and the gradient
    within 1e-6; another nearest voxel (a voxel label's f32 flip) on at most
    1% of the points."""
    from sdf_nmpc_tpu_torch.data import ColChecker, DfComputer, PosSampler
    from sdf_nmpc_tpu_torch.data.df_computer import sdf_from_search
    from sdf_nmpc_tpu_torch.sim.scenes import Scene, render_range_image
    from sdf_nmpc_tpu_torch.training.df import DfTrainConfig, sample_points

    hfov, vfov, dmax = 0.7592, 0.4903, 5.0
    rng = np.random.default_rng(3)
    scenes = Scene.stack([Scene.make(
        spheres=[(rng.uniform([1.0, -2.5, -1.0], [5.5, 2.5, 1.0]), rng.uniform(0.2, 0.8))
                 for _ in range(8)], boxes=[([-9, -9, -9], [9, 9, -1.2])], device=cuda_device)
        for _ in range(4)])
    imgs = render_range_image(scenes, torch.zeros(3, device=cuda_device),
                              torch.eye(3, device=cuda_device), 270, 480, hfov, vfov, dmax)
    counts = DfTrainConfig(points_per_img=500).point_counts()
    pts = sample_points(torch.Generator(device=cuda_device).manual_seed(0),
                        PosSampler(dmax, hfov, vfov, margin=40, device=cuda_device), imgs,
                        counts, 0.75)
    p2i = torch.arange(4, device=cuda_device).repeat_interleave(500)
    card = DfComputer(True, dmax, hfov, vfov, 1.0, batch_size=700, device=cuda_device)
    occ, md, am = card.search(imgs, pts, p2i)
    cpu = torch.device("cpu")
    imgs64, pts64, p2i64 = imgs.double().cpu(), pts.double().cpu(), p2i.cpu()
    ref = DfComputer(True, dmax, hfov, vfov, 1.0, device=cpu, dtype=torch.float64)
    occ64, md64, am64 = ref.search(imgs64, pts64, p2i64)
    m = ColChecker(dmax, hfov, vfov, 0.0, outside="extrapolate", device=cpu,
                   dtype=torch.float64).label_margins(imgs64, pts64, p2i64)
    near = (m["metres"] <= 1e-5) | (m["pixels"] <= 2e-4) | (m["radians"] <= 1e-5)
    flip = occ.cpu() != occ64
    assert not (flip & ~near).any()
    same = ~flip & (am.cpu() == am64)
    assert int((~flip & ~same).sum()) <= 0.01 * len(pts)
    sdf, grad = sdf_from_search(occ, md, am, card.grid, card.min_df, card.max_df)
    sdf64, grad64 = sdf_from_search(occ64, md64, am64, ref.grid, ref.min_df, ref.max_df)
    assert float((sdf.cpu().double() - sdf64)[same].abs().max()) <= 1e-7
    assert float((grad.cpu().double() - grad64)[same].abs().max()) <= 1e-6
    assert 0 < int(occ64.sum()) < len(pts)


@pytest.mark.gpu
def test_loss_sdf_backward_on_card_matches_f64(cuda_device):
    """One loss_sdf forward and double backward of a 4 x 64 sine NeuralDF
    (w0 20, latent 16) on 2,000 points on the card against f64 on the CPU:
    the four parts within 1e-4 relative, each parameter's gradient within
    2e-3 of its f64 tensor's largest entry."""
    from sdf_nmpc_tpu_torch.data.losses import loss_sdf
    from sdf_nmpc_tpu_torch.nn import NeuralDF

    net = NeuralDF(size_latent=16, layer_sizes=(64,) * 4, embed="oct", w0=20.0,
                   generator=torch.Generator().manual_seed(4))
    x = np.concatenate([RNG.uniform([0, -2, -1], [4, 2, 1], (2000, 3)),
                        RNG.normal(size=(2000, 16))], 1)
    g = RNG.normal(size=(2000, 3))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    g[:100] = 0.0
    y = RNG.uniform(-0.3, 1.0, 2000)
    out = {}
    for key, dev, dt in (("card", cuda_device, torch.float32),
                         ("f64", torch.device("cpu"), torch.float64)):
        m = copy.deepcopy(net).to(device=dev, dtype=dt)
        T = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        parts = loss_sdf(m, T(x), T(g), T(y))
        sum(w * p for w, p in zip((50.0, 1.0, 1 / 60, 5.0), parts)).backward()
        out[key] = (torch.stack(parts).detach().double().cpu(),
                    {n: p.grad.double().cpu() for n, p in m.named_parameters()})
    (p32, g32), (p64, g64) = out["card"], out["f64"]
    assert float(((p32 - p64).abs() / p64.abs()).max()) <= 1e-4
    for name, want in g64.items():
        assert float((g32[name] - want).abs().max()) <= 2e-3 * float(want.abs().max()), name
