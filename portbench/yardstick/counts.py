"""Operations and bytes of one RTI step's parts, from the configuration's
sizes alone (never from the program's kernel arguments), so that a roofline
reads the same work whatever implements it.

Frozen copies of ``chip_smoke.py``'s ``sdf_cost``, ``condense_cost`` and
``ip_ops_per_iter`` arithmetic; the interior point's iteration counts and
stiff rows come from the configuration's budget.  Every float is 4 bytes
(the program's f32), the Gram product's accumulation 8.
"""

from __future__ import annotations

from . import peaks

F32 = 4


def sizes(conf: dict) -> dict:
    o, s = conf["ocp"], conf["sdf"]
    nemb = 3 + 2 * int(s["nb_freqs"]) * 8  # the octahedron's 8 directions, sin and cos
    return dict(N=o["N"], nx=o["nx"], nu=o["nu"], ny=o["ny"], nyN=o["nyN"], nh=o["nh"],
                nhN=o["nhN"], nz=o["nz"], nc=o["nc"], nemb=nemb, L=s["size_latent"],
                layers=tuple(s["layer_sizes"]), k_stiff=conf["qp"]["k_stiff"])


def sdf_rows(conf: dict, B: int):
    """(operations, bytes) of kernel 2 over a step's B N stage points: a
    primal row and three position-tangent rows each; a tangent row's
    latent columns are zero, so its layers 1 and 3 take only the nemb
    embedding inputs."""
    z = sizes(conf)
    s1, s2, s3, s4 = z["layers"]
    P = B * z["N"]

    def macs(n_in):
        return n_in * s1 + s1 * s2 + (s2 + n_in) * s3 + s3 * s4 + s4

    ops = 2 * P * (macs(z["nemb"] + z["L"]) + 3 * macs(z["nemb"]))
    weights = F32 * ((z["nemb"] + z["L"]) * s1 + s1 + s1 * s2 + s2
                     + (s2 + z["nemb"] + z["L"]) * s3 + s3 + s3 * s4 + s4 + s4 + 1)
    read = P * (z["nemb"] + 3 * z["nemb"] + z["L"]) * F32 + weights
    return ops, read + P * 4 * F32


def sdf_bound_s(conf: dict, B: int) -> float:
    """Kernel 2's least time on its f32x3 route: three TF32 passes."""
    ops, bytes_ = sdf_rows(conf, B)
    return peaks.bound_s(3 * ops, bytes_, peaks.TF32)


def condense(conf: dict, B: int):
    """(operations, bytes) of kernel 3: E_k is zero beyond its first k nu
    columns, so stage k's products take k nu columns."""
    z = sizes(conf)
    N, nx, nu, ny, nh, nz = z["N"], z["nx"], z["nu"], z["ny"], z["nh"], z["nz"]
    cols = nu * N * (N - 1) // 2
    ops = B * 2 * nx * (nx + ny + nh) * (cols + N)
    read = B * F32 * (N * (nx * nx + nx * nu + nx + ny * nx + ny * nu + ny + nh * nx
                           + nh * nu + nh) + nx)
    written = B * F32 * (N * (nx + nx * nz + ny * nz + ny + nh * nz + nh) + nx + nx * nz)
    return ops, read + written


def gram(conf: dict, B: int):
    """(operations, bytes) of H = M' diag(w) M and g = M' r over the
    R = N ny + nyN + (N+1) nx rows, accumulated in f64."""
    z = sizes(conf)
    R = z["N"] * z["ny"] + z["nyN"] + (z["N"] + 1) * z["nx"]
    ops = B * 2 * R * z["nz"] * (z["nz"] + 1)
    return ops, B * F32 * (R * z["nz"] + 2 * R + z["nz"] * z["nz"] + z["nz"])


def ip_ops_per_iter(nz: int, nc: int, ks: int) -> int:
    """Operations of one interior-point iteration for one scenario."""
    tri = nz * (nz + 1) // 2
    newton = nc * nz + tri * (2 * nc + 1)  # eta C once, then H + C' (eta C), lower triangle
    chol = nz ** 3 // 3
    solves = (ks + 2) * 2 * nz * nz  # predictor (ks + 1 rhs) and corrector
    matvec = 2 * nz * nz + 12 * nc * nz  # H dz and the C / C' products
    # T = Cs Xs' (lower triangle) and the Woodbury correction of both solves
    wood = ks * (ks + 1) // 2 * 2 * nz + 2 * 4 * ks * nz if ks else 0
    return newton + chol + solves + matvec + wood + 100 * (nz + nc)


def qp_phases(conf: dict, budget: str = "steady"):
    """[(stiff rows, iterations), ...] of the budget: the warm phase, then
    the stiff phase."""
    b = conf["qp"]["budgets"][budget]
    n_stiff = int(b["stiff_iters"])
    ks = min(int(conf["qp"]["k_stiff"]), int(conf["ocp"]["nc"]))
    return [(0, int(b["iters"]) - n_stiff), (ks, n_stiff)]


def qp(conf: dict, B: int, budget: str = "steady"):
    """[(operations, bytes), ...] of kernel 4's launches in a step: each
    reads the QP's data once and reads and writes the interior point's
    state."""
    z = sizes(conf)
    nz, nc = z["nz"], z["nc"]
    data = B * F32 * (nz * nz + nc * nz + 3 * nz + 5 * nc)
    state = B * F32 * (5 * nz + 6 * nc + 2)
    return [(B * n * ip_ops_per_iter(nz, nc, ks), data + 2 * state)
            for ks, n in qp_phases(conf, budget) if n > 0]


def qp_bound_s(conf: dict, B: int, budget: str = "steady") -> float:
    return sum(peaks.bound_s(o, b, peaks.FP32) for o, b in qp(conf, B, budget))


def step_peak_s(conf: dict, B: int, budget: str = "steady") -> float:
    """The step's counted operations, each part's over the peak of the unit
    it runs on: the SDF rows three TF32 passes, condensing and the QP FP32,
    the Gram product FP64 on the tensor cores.  Linearization (kernel 1)
    and the glue are not counted."""
    t = 3 * sdf_rows(conf, B)[0] / peaks.TF32
    t += condense(conf, B)[0] / peaks.FP32
    t += gram(conf, B)[0] / peaks.FP64_TENSOR
    t += sum(o for o, _ in qp(conf, B, budget)) / peaks.FP32
    return t


def encoder_ops(conf: dict, B: int) -> int:
    """Operations of the ResNet-VAE encoder's convolutions and mean head
    over B frames, from the frame's shape and the layers' channels and
    strides (2 per multiply-add)."""
    pc = conf["perception"]
    H, W = pc["shape"][-2:]
    out = lambda n, k, s, p: (n + 2 * p - k) // s + 1
    ops = 0

    def conv(h, w, cin, cout, k, s, p):
        nonlocal ops
        ho, wo = out(h, k, s, p), out(w, k, s, p)
        ops += 2 * cin * cout * k * k * ho * wo
        return ho, wo

    h, w = conv(H, W, pc["shape"][0], 64, 7, 2, 3)
    h, w = out(h, 3, 2, 1), out(w, 3, 2, 1)  # max pool
    c = 64
    for s in (2, 2, 2, 1):
        co = c * s
        h1, w1 = conv(h, w, c, co, 3, s, 1)
        conv(h1, w1, co, co, 3, 1, 1)
        if s != 1:
            conv(h, w, c, co, 1, s, 0)
        h, w, c = h1, w1, co
    ops += 2 * c * 4 * pc["size_latent"]
    return B * ops
