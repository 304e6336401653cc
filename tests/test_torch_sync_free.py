"""The sync-free step's values on the CPU: the parameter getters' slices
and kept index gathers, the kept constants (``utils/device_consts.py``)
and ``quat_invert``'s negation equal the per-call forms they replace bit
for bit, and a steady config-4 step equals the same step run with those
per-call forms patched back in.  The test marked ``gpu`` holds the same
step on the card.  No JAX import."""

import sys

import numpy as np
import pytest
import torch
from _torch_port import cuda_device, one_torch_thread  # noqa: F401  (fixtures)
from torch.func import jacfwd, vmap

from sdf_nmpc_tpu_torch import math as m
from sdf_nmpc_tpu_torch.nn.embeddings import PositionEmbedding
from sdf_nmpc_tpu_torch.ops.sdf_fused import embed_with_tangents
from sdf_nmpc_tpu_torch.params import ParamLayout
from sdf_nmpc_tpu_torch.utils import device_consts
from sdf_nmpc_tpu_torch.utils.device_consts import kept, kept_counts

L = 5
LAYOUTS = {
    "contiguous": ParamLayout(flag=0, W_p_Co=(1, 2, 3), W_R_Co=tuple(range(4, 13)),
                              q_d=(13, 14, 15, 16), latent_start=17, size_latent=L),
    "permuted": ParamLayout(flag=0, W_p_Co=(3, 1, 2), W_R_Co=(12, 4, 10, 6, 5, 9, 8, 11, 7),
                            q_d=(16, 13, 15, 14), latent_start=17, size_latent=L),
}
GETTERS = ("W_p_Co", "W_R_Co", "q_d")
PROJ = ("none", "cube", "octohedron", "dodecahedron", "icosahedron")
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def per_call_get(layout, name, p):
    """The getters as they were: a list index, copied to p's device."""
    out = p[..., list(getattr(layout, name))]
    return out.reshape(p.shape[:-1] + (3, 3)) if name == "W_R_Co" else out


def per_call_const(a, like, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=like.dtype if dtype is None else dtype,
                           device=like.device)


def per_call_quat_invert(q):
    sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    return q * sign / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _p(layout, dtype=torch.float64, shape=(3, 4)):
    g = torch.Generator().manual_seed(7)
    return torch.randn(shape + (layout.np_total,), generator=g, dtype=dtype)


@pytest.mark.parametrize("mode", ["batch", "vmap", "jacfwd", "vmap_jacfwd"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", GETTERS)
def test_getter_equals_the_list_index(name, layout, mode):
    """Each getter equals ``p[..., list(idx)]`` bit for bit: on batch axes,
    under vmap, under jacfwd (its Jacobian) and under vmap of jacfwd."""
    lay = LAYOUTS[layout]
    new = getattr(lay, f"get_{name}")
    old = lambda p: per_call_get(lay, name, p)
    p = _p(lay)
    wrap = {"batch": lambda f: f, "vmap": vmap, "jacfwd": jacfwd,
            "vmap_jacfwd": lambda f: vmap(jacfwd(f))}[mode]
    if mode == "jacfwd":
        p = p[0, 0]
    a, b = wrap(new)(p), wrap(old)(p)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_getters_build_no_index_after_the_first_call(layout):
    """A contiguous run is a view of p; a permuted one gathers with an index
    tensor built on the first call alone."""
    lay = LAYOUTS[layout]
    p = _p(lay, torch.float32)
    for name in GETTERS:
        getattr(lay, f"get_{name}")(p)
    built = kept_counts["built"]
    views = [getattr(lay, f"get_{name}")(p) for name in GETTERS]
    assert kept_counts["built"] == built
    shares = [v.untyped_storage().data_ptr() == p.untyped_storage().data_ptr() for v in views]
    assert shares == [layout == "contiguous"] * 3


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quat_invert_equals_the_sign_product(dtype):
    """The negated vector part equals the product by (1, -1, -1, -1), in
    value and in forward-mode tangent, zeros and signs included."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(64, 4, generator=g, dtype=DTYPES[dtype])
    q[:8, 1:] = 0.0
    q[8:16, 2] = -0.0
    assert torch.equal(m.quat_invert(q), per_call_quat_invert(q))
    assert torch.equal(m.quat_invert(q).signbit(), per_call_quat_invert(q).signbit())
    assert torch.equal(vmap(jacfwd(m.quat_invert))(q), vmap(jacfwd(per_call_quat_invert))(q))


def _per_call_embedding(pe, x):
    dirs = torch.as_tensor(pe.dirs, dtype=x.dtype, device=x.device)
    freqs = torch.as_tensor(pe.freq_bands, dtype=x.dtype, device=x.device)
    xb = ((x @ dirs)[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * np.pi], dim=-1))], dim=-1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("proj", PROJ)
def test_embedding_equals_the_per_call_constants(proj, dtype):
    """``PositionEmbedding`` and ``embed_with_tangents`` on kept constants
    equal the per-call ``as_tensor`` forms bit for bit."""
    pe = PositionEmbedding(6, proj)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(33, 3, generator=g, dtype=DTYPES[dtype])
    assert torch.equal(pe(x), _per_call_embedding(pe, x))
    emb, demb = embed_with_tangents(pe, x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules["sdf_nmpc_tpu_torch.ops.sdf_fused"], "kept", per_call_const)
        emb0, demb0 = embed_with_tangents(pe, x)
    assert torch.equal(emb, emb0) and torch.equal(demb, demb0)


def test_kept_tensors_per_dtype_and_value():
    """One tensor per (value, dtype, device): f32 and f64 apart, the second
    call the same object, an array edited in place a new constant, and a
    tensor first built under inference mode usable by autograd."""
    a = np.array([0.25, -1.5, 3.0])
    x32, x64 = torch.zeros(3), torch.zeros(3, dtype=torch.float64)
    before = dict(kept_counts)
    t32, t64 = kept(a, x32), kept(a, x64)
    assert t32.dtype == torch.float32 and t64.dtype == torch.float64
    assert kept(a, x32) is t32 and kept(a.copy(), x64) is t64
    assert kept_counts["reused"] - before["reused"] == 2
    built = kept_counts["built"] - before["built"]
    assert built <= 2  # another test may have kept the same value already
    a[0] = 7.0
    assert kept(a, x32)[0] == 7.0 and t32[0] == 0.25
    with torch.inference_mode():
        c = kept(np.array([11.0, 13.0]), x32)
    assert not c.is_inference()
    y = torch.ones(2, requires_grad=True)
    (y * c).sum().backward()
    assert torch.equal(y.grad, c)


def _small(dtype):
    """(steady step, state after a cold step, inputs): config 4 at B = 4
    with a seeded 4 x 16 network on the CPU, in ``dtype``."""
    from sdf_nmpc_tpu_torch.entry import bench_inputs, build
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step

    over = {"solver": {"dtype": {torch.float32: "float32", torch.float64: "float64"}[dtype]}}
    cfg, ocp, cold, _, _ = build(over, latent=16, layer_sizes=(16,) * 4, batch=4, device="cpu")
    inputs = bench_inputs(ocp, cfg, 4, seed=0, device="cpu", dtype=dtype)
    steady = make_rti_step(ocp, cfg, budget="steady", with_evals=False)
    return steady, cold(init_state(ocp, inputs.x0, dtype), inputs).state, inputs


@pytest.fixture(scope="module", params=sorted(DTYPES))
def small(request):
    return _small(DTYPES[request.param])


def _per_call_forms(mp):
    """Patch the getters, every module's ``kept`` and ``quat_invert`` back
    to the per-call forms."""
    for name in GETTERS:
        mp.setattr(ParamLayout, f"get_{name}",
                   lambda self, p, name=name: per_call_get(self, name, p))
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("sdf_nmpc_tpu_torch")
                and getattr(mod, "kept", None) is kept):
            mp.setattr(mod, "kept", per_call_const)
    mp.setattr(m, "quat_invert", per_call_quat_invert)


def test_steady_step_equals_the_per_call_forms(small):
    """One steady config-4 step gives the same X, U, u0 and status bit for
    bit as the same step with the per-call getters and constants."""
    steady, state, inputs = small
    res = steady(state, inputs)
    before = dict(kept_counts)
    with pytest.MonkeyPatch.context() as mp:
        _per_call_forms(mp)
        ref = steady(state, inputs)
    assert kept_counts == before  # nothing of the step read the helper
    for name in ("u0", "status"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name
    for name in ("X", "U"):
        assert torch.equal(getattr(res.state, name), getattr(ref.state, name)), name


def test_steady_step_builds_no_constant(small):
    """After the cold step, a steady step reads kept constants alone."""
    steady, state, inputs = small
    steady(state, inputs)
    device_consts.reset_kept_counts()
    steady(state, inputs)
    assert kept_counts["built"] == 0 and kept_counts["reused"] > 0


@pytest.mark.gpu
def test_steady_step_equals_the_per_call_forms_on_the_card(cuda_device):
    """On the card (B = 8192, the trained network, kernels 1-4): the
    steady step equals, bit for bit, the same step with the per-call forms,
    whose getters hand the library calls contiguous copies where the new
    ones hand strided views."""
    from sdf_nmpc_tpu_torch.entry import build
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    cfg, ocp, cold, state, inputs = build(batch=8192, device=cuda_device)
    steady = make_rti_step(ocp, cfg, budget="steady", with_evals=False)
    state = steady(cold(state, inputs).state, inputs).state
    res, again = steady(state, inputs), steady(state, inputs)
    with pytest.MonkeyPatch.context() as mp:
        _per_call_forms(mp)
        ref = steady(state, inputs)
    torch.cuda.synchronize()
    pairs = {"u0": (res.u0, ref.u0, again.u0), "status": (res.status, ref.status, again.status),
             "X": (res.state.X, ref.state.X, again.state.X),
             "U": (res.state.U, ref.state.U, again.state.U)}
    for name, (a, b, c) in pairs.items():
        assert torch.equal(a, c), f"{name}: the step is not deterministic on this card"
        assert torch.equal(a, b), f"{name}: max |diff| {(a - b).abs().max().item()}"
