#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py          # from the repo root; one card, nvcc

Two paths of BASELINE config 4 (att quad, N=20, the trained 4x256 NeuralDF
of weights/, FoV rows, the condensed QP with nz=80, nc=63), BASELINE
config 1 (no SDF, nc=0; phase 15), config 4 with the formulation extras
(the SDF cost row; recursive feasibility and stability, nc=68; phase 17)
BASELINE config 3 (a depth image through the trained encoder to the
latent of config 4's step, and the image-fed mission tick; phase 18),
config 4 at long horizons on the stage-wise QP (N = 60; phase 19), the
closed loop (phase 20) and the solver routes (phase 21),
run through
``sdf_nmpc_tpu_torch``'s public entry points: the fused path (kernels 1-4,
the default solver settings) and the composed QP path with
``solver.dual_warm_start`` (kernels 1-3 and 5-8), the latter also through
the ``Nmpc`` controller at B=1 and ``make_batched_step``.  Then the same OCP
on the other five quad families with the default settings: rates, wrench
and props through kernel 9 (their residual rows by ``torch.func``), acc
and att_tau through kernel 1, each with kernels 2-4.  Phases, in order; any
failure raises and exits non-zero before the result line:

1. card: ``nvidia-smi`` name and power limit;
2. build: the kernels from ``sdf_nmpc_tpu_torch/csrc`` (nvcc, ctypes), with
   the build time and ptxas' register/spill report;
3. kernel checks, fused path: kernels 1-4 against their plain PyTorch
   versions on the inputs one cold step gives them for B=1024 scenarios
   (the accuracy scenarios tiled and jittered from a seed), kernel 2 by
   its four routes (sdf_fused_dtype f32: sdf_fused.cu against the exact
   plain version; f32x3, the default: sdf_fused_x3.cu on the tensor cores
   against the 3xTF32 plain version; bf16 and mixed: sdf_fused_bf16.cu on
   the bf16 tensor cores against their plain versions, per point under
   SDF_BF16_RULE beside the plain version's distance to f64), and the
   interior point also on a seeded random QP batch, per launch and as the
   whole fused solve;
4. kernel checks, composed path: kernels 5-8 against their plain versions
   on every launch of one dual-warm-started cold step at B=1024, and of a
   step with ``qp_stiff_k: 6`` and ``ir_steps: 1`` (kernel 5 with 7 rows,
   refinement re-solves); then the whole composed solve with the kernels
   against the same solve with the plain versions;
5. accuracy: the 32 cold scenarios and the warm / steady replays against
   the goldens, with the default settings, with sdf_fused_dtype f32 (so
   both f32 kernel-2 routes' u0 errors stand in one run) and with
   dual_warm_start; then att's cold, warm and steady u0 errors under
   sdf_fused_dtype bf16 and mixed, not gated at 1e-3 (the JAX package's
   own readings, TPU history, beside them): finite, every status OK, the
   cold max at most 2 times that of the same step with the route's plain
   version swapped in;
6. fused main path: B=8192, one cold step then 20 chained steady steps
   ended by one synchronize, launch counts set to 0 just before and read
   just after; solves/s, ms per step, the time at which the host had
   issued the 20 steps (the last step call returned, before the
   synchronize), peak memory, the per-step spread; then the same with
   sdf_fused_dtype f32 (kernel 2's IEEE route), bf16 and mixed, each with
   its busy share;
7. where the time goes on it (torch.profiler busy share) and per-kernel
   numbers for kernels 1-4 on the inputs a steady step gives them, kernel 2
   by its four routes (the f32x3 route's bound at the TF32 tensor-core
   peak, three passes; bf16's at the bf16 tensor-core peak; mixed's the
   longer of its primal rows at the FP32 peak and its tangent rows at the
   bf16 peak; each route's launch geometry and registers); for
   kernels 1 and 3 their launch
   geometry (threads, shared bytes, resident blocks per SM) and ptxas
   registers beside their ms; for kernel 4 also each launch's time (warm
   phase, stiff phase) and its launch geometry;
8. composed main path: the same at B=8192 with dual_warm_start (one cold
   step then 20 chained steady steps), its busy share, and per-kernel
   numbers for kernels 5-8, the library calls beside kernels 5 and 6, the
   launch geometry of kernels 5, 7 and 8;
9. the ``Nmpc`` controller at B=1: about 30 ticks on waypoints, each fed
   the predicted next state: the cold -> warm -> steady promotion, no
   failure, clipped finite commands, per-tick latency; then one more
   tick's launches of kernels 5-8, each timed at B=1 (CUDA events);
10. ``make_batched_step`` once at B=8192: BatchStats against a reduction of
   the results;
11. kernel checks, per family: kernel 9 (rates, wrench, props) or kernel 1
   (acc, att_tau), kernel 2 (both routes) and kernel 3 against their plain
   versions on
   the inputs one cold step gives them at B=1024, the family's scenarios
   tiled and jittered as in phase 3, each reading beside the plain f32
   version's distance to f64;
12. accuracy, per family: its 8 cold scenarios against the independent
   oracle (tests/golden/oracle_u0.npz), and the warm / steady replays of
   warm_ref_<model>.npz, with the named ticks of accuracy.SHORT_TICKS;
   props also with sdf_fused_dtype f32, so that its short tick stands
   under both kernel-2 routes;
13. main path, per family: as phase 6 at B=8192, its busy share, and
   kernel 9's (or 1's) and kernel 3's time, bound and plain time on a
   steady step's inputs (each with its launch geometry and ptxas
   registers), beside the time of the torch.func residual rows (kernel 9
   only);
14. the ``Nmpc`` controller at B=1 on props, default settings, 15 ticks:
   promotion, no failure, clipped finite ``get_cmd_props``, kernel 9
   launched and kernel 1 not;
15. BASELINE config 1, the obstacle-free waypoint NMPC (flags.enable_sdf
   off: no constraint rows, the plain condensing recursion, the nc = 0 QP
   on the composed path): kernels 1, 5 and 6 against their plain versions
   on every launch of one cold step at B=1024 (phase 4's rules) and the
   whole composed solve; the 32 cold scenarios against the independent
   oracle's nosdf_u0 under the CI gate; the B=8192 main path as phase 6
   (kernels 1, 5 and 6 launched, no other) and its busy share; ``Nmpc`` at
   B=1 without a network, 15 ticks;
16. the SDF row's other inputs, one cold step at B=1024 each: an
   omnidirectional sensor (no hfov row; kernels 1-4 held against their
   plain versions) and the autodiff row (a seeded res='state' network;
   kernels 1, 3 and 4 held, kernel 2 not launched), the first 8 scenarios
   of each against the port's f64 step on the CPU under the CI gate;
17. the formulation extras (``--formulation`` runs phases 1, 2 and this
   one alone): the SDF stage cost row (``flags.sdf_cost``), whose wider
   residual takes kernel 9 in place of kernel 1, kernel 9's att, acc and
   att_tau instances against their plain version on one cold step at
   B=1024 each (geometry and ptxas registers; acc's and att_tau's times at
   the main path's 163,840 points, the step's inputs tiled), att's step
   with kernels 3 and 4 held and its first 8 scenarios against the port's
   f64 CPU step under the CI gate; recursive feasibility with stability
   (the synthetic braking polynomial, r_tilde 1.0): one cold step at
   B=1024 with kernels 1-4 held on every launch, kernel 4 at k_s = 48, its
   8 cold scenarios against the oracle's recfeas_u0 under the CI gate, one
   dual-warm-started cold step with kernels 5-8 held and timed, kernels 7
   and 8 at k = 48; both paths at B=8192 as phase 6 (the largest power of
   two that fits the card's memory, the cut printed), each with its busy
   share and per-kernel numbers on a steady step's inputs (under sdf_cost
   also the torch.func residual and stage rows through the network); the
   ``Nmpc`` controller at B=1 built with ``bdist_coeffs`` and ``r_tilde``,
   15 ticks;
18. perception, BASELINE config 3 (``--perception`` runs phases 1, 2 and
   this one alone): the trained ResNet-VAE encoder (weights/, strict
   270 x 480 gate) on the 8 config-3 scenes rendered on the card, its f32
   latents against the f64 CPU encoder on the same images under
   LATENT_RULE, once, under the cuDNN settings the port's encoder runs
   (default algorithms, TF32 off); the config-3 contract
   (render -> encode -> one cold step at B=8, default settings) against
   tests/golden/config3_u0.npz, max <= 1e-3 and 8/8 status OK, kernels
   1-4 held against their plain versions on every launch, each launch's
   device time read from the profiler's kernel events of that run (CUDA
   events around these small launches read the host's issue; kept as
   ``issue_ms``); the
   image-fed ``MissionServer`` at B=1 (the trained NeuralDF, default
   settings): each tick scene 0 rendered from the camera's pose, sent as a
   raw uint16 depth frame through the ``FrameRing``, read, encoded and
   solved toward a waypoint past the blocking sphere, 31 ticks, the
   median and p99 of the last 30 of the whole tick (host wall), the encode
   (CUDA events) and ``Nmpc.get_t()``, then kernels 1-4 held and timed on
   one more tick's launches; the encoder's images/s at B = 1, 8, 64, 256
   (20 chained encodes ended by one synchronize) and peak memory, the
   render's ms for the 8 scenes;
19. long horizons on the stage-wise (Riccati) QP backend
   (``--long-horizon``): qp_backend riccati at N = 20 on the 32 cold
   starts against the golden (max <= 1e-3, 32/32 OK, the JAX package's
   own contract), its warm and steady replays beside it; att at N = 60
   (T = 4.5 s) and B = 8192, default settings ('auto' takes Riccati
   beyond N = 20): one cold step with kernels 1 and 2 held on every
   launch and the first 8 scenarios against the port's f64 CPU step
   under the CI gate, then 20 chained steady steps (kernels 1 and 2 once
   a step, none of kernels 3-8) and their busy share; props at N = 60,
   one cold step at B = 1024 through kernel 9, held the same way;
   ``Nmpc`` at B = 1 and N = 60, 31 ticks; qp_backend condensed forced at
   N = 40 beside Riccati at N = 40, B = 8192, CROSS_STEADY chained steps
   each (no busy share: one profiled Riccati step takes the profiler
   tens of seconds to read back);
20. the closed loop (``--closed-loop``): tests/test_sim.py's sphere scene
   (latent 8, qp_iters 10, the scene oracle as the SDF row: kernels 1, 3
   and 4) in f32, ``make_closed_loop`` at B = 1 over 120 ticks held by
   that file's outcome rules (every status OK, min clearance > 0,
   tracking error < 0.35, lateral excursion > 0.15), the flag off
   colliding, a Monte Carlo of 1024 starts over 60 ticks (success 1.0,
   collision 0; the loop's kernels held on one tick's launches);
   perception in the loop on config 3's 8 scenes with the trained
   NeuralDF and encoder, 6 chunks of 10 ticks, each chunk rendered at
   270 x 480 from the current pose and encoded (statuses OK, finite;
   ``summarize``, each scene's clearance and a chunk's render, encode and
   solve ms printed);
21. the solver routes (``--solver-routes``): one cold att step at B =
   1024 on the 32 accuracy scenarios repeated under ``chol_impl: xla``,
   ``chol_impl: custom``, ``lin_impl: xla``, ``qp_data_bf16`` and
   ``qp_compute_dtype: float64``: u0 against the golden (the CI gate; not
   gated under qp_data_bf16), the launches each route implies;
22. the training side (``--training``): the GT data engine on 100 seeded
   scenes rendered at 270 x 480 on the card, one DfTrainConfig batch (50
   images x 2,500 points) labelled by ColChecker and the signed DfComputer
   (timed, peak memory), 2,000 seeded points of it against the f64 CPU
   search (a label may differ only within F32_MARGIN of a decision's
   boundary); train_vae at the reference's sizes (latent 128, batch norm,
   dropout 0.1, batch 16, the augmenter and erosion labels) over 32 of the
   images, 2 epochs then a resume, ms per step, images/s and peak memory,
   one step against f64 on the CPU (batch 2, dropout off; TRAIN_*_TOL,
   VAE_GRAD_RTOL);
   train_df at the reference's sizes (4 x 256, latent 128, dropout 0.1,
   batch 50 x 2,500) against that encoder over the 100 images, 2 epochs
   then a resume, ms per step by part (encode, sampling, GT, forward /
   double backward, update), one step of 5,000 points against f64 on the
   CPU; the trained network packed for kernel 2 (f32x3 and f32 routes held)
   and one cold config-4 att step at B=1024 on the trained encoder's
   latents, kernels 1-4 held on every launch (kernel 4's iterates as
   recfeas's, phase 17, with ILL_SHARE_SIGMAS), statuses finite and OK.

The last lines are the ``kernels`` JSON (all nine kernels, kernel 2 as one
row per route, each with its per-launch times ``launch_ms``; the rows of
kernels 1, 3 and 9 carry each model's numbers under ``per_model``, and at
top level att's (for kernel 9 att's under sdf_cost); the rows of kernels
1-9 that the formulation extras, config 3, the long horizons, the
closed loop and the training side's served network run carry those readings
under ``per_path``; kernel 4's row ``launch_k_s`` and
``geometry``, kernel 2's rows (f32, f32x3, bf16, mixed) and the
rows of kernels 1, 3, 5, 7, 8 and 9 their ``geometry``; the ``launches`` of
kernel 2's f32, bf16 and mixed rows come from the runs of phase 6 that
took those routes),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.

Options that run a part alone, to compare source trees on one card (they
print no result line):

    python3 chip_smoke.py --ip-builds DIR [DIR ...]
    python3 chip_smoke.py --sdf-builds DIR [DIR ...]
    python3 chip_smoke.py --qp-builds DIR [DIR ...]
    python3 chip_smoke.py --condense-builds DIR [DIR ...]
    python3 chip_smoke.py --lin-builds DIR [DIR ...]
    python3 chip_smoke.py --erk4-builds DIR [DIR ...]
        kernel 4 (kernel 2's f32, f32x3, bf16 and mixed kernels, kernels 5-8,
        kernel 3, kernel 1, kernel 9) built from each DIR's ip_phase.cu
        (sdf_fused.cu, sdf_fused_x3.cu and sdf_fused_bf16.cu, one after the
        other; qp_solve.cu, condense.cu, lin_y_sens.cu, erk4_sens.cu) and the
        headers beside it against the package's build, on the launches of one
        steady step of the fused main path (kernel 2's kernels each under its
        route; for kernels 5-8 the composed path; kernel 3 on att's and
        props', kernel 1 on att's, acc's and att_tau's, kernel 9 on rates',
        wrench's and props'): each launch's time, the builds interleaved round
        by round, each build's outputs against the package's and every other
        build's, bit for bit and by the largest difference (per output and
        launch), for kernel 2 against the f64 plain version and for kernel 9
        against its plain version under ERK4_TOL;
    python3 chip_smoke.py --composed
        phases 1, 2, 8 (without the kernel numbers) and 9: the composed main
        path and the ``Nmpc`` controller; copied into another tree, the same
        phases of that tree's package.
    python3 chip_smoke.py --formulation
        phases 1, 2 and 17: the formulation extras.
    python3 chip_smoke.py --perception
        phases 1, 2 and 18: perception, BASELINE config 3.
    python3 chip_smoke.py --long-horizon | --closed-loop | --solver-routes | --training
        phases 1, 2 and 19 (20, 21, 22) alone.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
CHECK_B = 1024  # scenarios of the kernel checks (phase 3)
MAIN_B = 8192  # scenarios of the main path (phase 5), as bench.py
N_STEADY = 20  # chained steady steps of the main path
PROFILE_STEPS = 3  # profiled steady steps (phase 6)
PER_STEP = {"lin_y_sens": 1, "erk4_sens": 0, "sdf_fused": 0, "sdf_fused_x3": 1,
            "sdf_fused_bf16": 0, "sdf_fused_mixed": 0, "condense": 1, "ip_phase": 2}
ERK4_FAMILIES = ("rates", "wrench", "props")  # kernel 9
LIN_FAMILIES = ("acc", "att_tau")  # kernel 1, as att
SDF_COST_FAMILIES = ("att", "acc", "att_tau")  # kernel 9 in place of kernel 1 under sdf_cost
NMPC_TICKS_PROPS = 15
# composed path with dual_warm_start: one launch of kernel 5 and 6 per warm
# IP iteration, of kernel 7 and 8 per stiff one; (warm, stiff) iterations
# of the cold (20 / 8 stiff) and steady (15 / 4 stiff) budgets
COMPOSED_ITERS = {"cold": (12, 8), "steady": (11, 4)}
DWS = {"dual_warm_start": True}
SDF_F32 = {"sdf_fused_dtype": "f32"}  # kernel 2's IEEE route (the default is f32x3)
# kernel 2's bf16 routes: launch count -> the solver overrides that take it
BF16_ROUTES = {"sdf_fused_bf16": {"sdf_fused_dtype": "bf16"},
               "sdf_fused_mixed": {"sdf_fused_dtype": "mixed"}}
# the JAX package's own u0 max on its cold accuracy workload under each bf16
# mode: TPU history, printed beside the card's readings (not a target)
TPU_HISTORY = {"bf16": ("1.54e-2", "docs/performance.md:144-152"),
               "mixed": ("1.05e-2", "docs/performance.md:346-360")}
# BASELINE config 1 (enable_sdf off, nc = 0): kernels 5 and 6 once per IP
# iteration each (no stiff rows), cold 20 and steady 15 iterations
NOSDF_ITERS = {"cold": 20, "steady": 15}
# an omnidirectional sensor: no hfov row (a spherical sensor, 30-degree vfov)
OMNI = {"sensor": {"hfov": float(np.pi), "vfov": float(np.pi / 6), "is_spherical": True}}
OTHER_SCEN = 8  # scenarios of the omni and autodiff-row phases held against the f64 CPU step
UNALIGNED = {"dual_warm_start": True, "qp_stiff_k": 6, "ir_steps": 1}
ENCODER_B = (1, 8, 64, 256)  # encoder throughput batch sizes (phase 18)
ENCODER_CHAINED = 20  # chained encodes per batch size
MISSION_TICKS = 31  # image-fed MissionServer ticks (phase 18)
LATENT_RULE = 1e-4  # card latents vs the f64 CPU encoder: max |d| <= LATENT_RULE (1 + max |z|)
ENCODER_GFLOP = 4.34  # multiply-adds x 2 of the encoder per 270 x 480 image
RIC = {"qp_backend": "riccati"}
LONG_N = 60  # the JAX package's long horizon (tests/test_qp_riccati.py:79-100), T = 4.5 s
CROSS_N = 40  # the condensed / Riccati crossover the JAX package quotes (sqp.py:101-107)
NMPC_TICKS_LONG = 31  # Nmpc ticks at N = LONG_N (phase 19)
CROSS_STEADY = 5  # chained steady steps of each N = CROSS_N path (phase 19)
# the sphere scene of tests/test_sim.py: one sphere straight on the path to
# the goal (2, 0, 0), its oracle as the SDF row, latent 8, qp_iters 10
SPHERE = ([1.2, 0.05, 0.0], 0.35)
LOOP_TICKS = 120  # closed-loop ticks (tests/test_sim.py)
MC_B, MC_TICKS = 1024, 60  # the batched Monte Carlo of phase 20
PERC_CHUNKS, PERC_TICKS = 6, 10  # perception in the loop: chunks x ticks per chunk
# phase 21: route -> (its solver overrides, the kernels it launches, held to the CI gate)
ROUTE_CHECKS = {
    "chol_impl xla": ({"chol_impl": "xla"}, ("lin_y_sens", "sdf_fused_x3", "condense"), True),
    "chol_impl custom": ({"chol_impl": "custom"}, ("lin_y_sens", "sdf_fused_x3", "condense"),
                         True),
    "lin_impl xla": ({"lin_impl": "xla"}, ("sdf_fused_x3", "ip_phase"), True),
    "qp_data_bf16": ({"qp_data_bf16": True}, ("lin_y_sens", "sdf_fused_x3", "condense",
                                              "ip_phase"), False),
    "qp_compute_dtype float64": ({"qp_compute_dtype": "float64"},
                                 ("lin_y_sens", "sdf_fused_x3", "condense", "factor_solve",
                                  "solve", "stiff_factor_solve", "stiff_resolve"), True),
}
FUSED_KERNELS = {  # name -> (source in the repo, the TPU kernel it replaces)
    "lin_y_sens": ("sdf_nmpc_tpu_torch/csrc/lin_y_sens.cu",
                   "sdf_nmpc_tpu/ops/lin_kernels.py:173"),
    "sdf_fused": ("sdf_nmpc_tpu_torch/csrc/sdf_fused.cu", "sdf_nmpc_tpu/ops/sdf_fused.py:154"),
    "sdf_fused_x3": ("sdf_nmpc_tpu_torch/csrc/sdf_fused_x3.cu",
                     "sdf_nmpc_tpu/ops/sdf_fused.py:154"),
    "sdf_fused_bf16": ("sdf_nmpc_tpu_torch/csrc/sdf_fused_bf16.cu",
                       "sdf_nmpc_tpu/ops/sdf_fused.py:154"),
    "sdf_fused_mixed": ("sdf_nmpc_tpu_torch/csrc/sdf_fused_bf16.cu",
                        "sdf_nmpc_tpu/ops/sdf_fused.py:154"),
    "condense": ("sdf_nmpc_tpu_torch/csrc/condense.cu",
                 "sdf_nmpc_tpu/ops/condense_kernel.py:38"),
    "ip_phase": ("sdf_nmpc_tpu_torch/csrc/ip_phase.cu", "sdf_nmpc_tpu/ops/ip_kernel.py:78"),
}
QP_SRC = "sdf_nmpc_tpu_torch/csrc/qp_solve.cu"
COMPOSED_KERNELS = {
    "factor_solve": (QP_SRC, "sdf_nmpc_tpu/ops/qp_kernels.py:200"),
    "solve": (QP_SRC, "sdf_nmpc_tpu/ops/qp_kernels.py:242"),
    "stiff_factor_solve": (QP_SRC, "sdf_nmpc_tpu/ops/qp_kernels.py:311"),
    "stiff_resolve": (QP_SRC, "sdf_nmpc_tpu/ops/qp_kernels.py:338"),
}
KERNELS = {**FUSED_KERNELS, **COMPOSED_KERNELS,
           "erk4_sens": ("sdf_nmpc_tpu_torch/csrc/erk4_sens.cu",
                         "sdf_nmpc_tpu/ops/lin_kernels.py:49")}
# Stated tolerances of kernel against plain version, per output:
#  lin: A, B at 1e-4 and the y sweep at 2e-4 (tests/test_ops.py); the kernel
#       runs the algebraic cos/sin-of-atan2 form, the plain version atan2.
#  sdf: value 2e-4, gradient 2e-3 (tests/test_ops.py); sin(20 z) amplifies
#       the sum-order rounding of each layer.  Both routes, each against its
#       own plain version: f32 (sdf_fused) against the exact one, f32x3
#       (sdf_fused_x3, 3xTF32) against sdf_value_grad_x3_plain.
#  condense: 1e-5 (tests/test_qp_kernels.py), plus 1e-5 relative, since E and
#       G reach magnitudes near 10 where one f32 rounding is ~1e-6.
#  ip: every launch on the dz, best_dz, best merit and tail sum it leaves,
#       and the whole fused solve (both launches, the best-iterate choice,
#       the tail average) on the dz it selects and its KKT residual.  Per
#       scenario the largest deviation from the plain version is taken, and
#       a rule bounds the share of scenarios beyond a threshold, the median
#       and the max.  A flat bound cannot hold every scenario: with the
#       ratio cap at 1e8 some warm phases are ill-conditioned, near-ties
#       among the top-k stiff rows flip with one ulp, and near-tied merits
#       pick another iterate; there the plain f32 version itself lies up to
#       ~5e-3 from the same computation in f64.  A fault of the kernel
#       shows in many scenarios, which the share and the median catch.
#       dz and tail sum: at most 1% beyond 1e-4 (tests/test_qp_kernels.py).
#       best_dz and the selected dz: 3%, since the plain f32 best iterate
#       is beyond 1e-4 of f64 on up to 2.5% of scenarios.  The best merit
#       over 1 + the sum of its terms' magnitudes, and the KKT residual over
#       1 + its largest term (both are sums that cancel): at most 3% beyond
#       1e-3, the median below 1e-4 and none beyond 1e-2 (merit) or 2e-2
#       (KKT).  The plain f32 version's own distance to f64, printed beside
#       each reading, reaches beyond 1e-3 on 1.7% (merit) and 17% (KKT) of
#       the scenarios of one workload, with a max of 6.6e-3 and 1.8e-2.
#  Each rule: (threshold, largest share beyond it, largest median, largest max).
LIN_TOL = (1e-4, 1e-4, 1e-4, 2e-4, 1e-4, 1e-4)
#  erk4 (kernel 9): per output (x+, A, B), max |kernel - plain| at most 1e-4
#       (1 + max |plain|): props' B reaches ~14 through its wp^2 terms.
ERK4_TOL = 1e-4
SDF_TOL = (2e-4, 2e-3)
#  sdf, bf16 routes (sdf_fused_bf16: bf16 and mixed, each against its own
#       plain version), per point, value and gradient apart: the rule's
#       share of points beyond 1e-3, median and max.  A one-ulp difference
#       of an f32 sum (the tensor core's order) can round a next-layer input
#       to the neighbouring bf16 value (2^-8 relative), which sin(w0 z)
#       carries to the output, so no flat bound holds every point; a fault
#       (a fragment or a chunk out of place) moves the median.  The plain
#       version's own distance to the f64 exact version is printed beside:
#       on 163,840 random points, median 1.1e-3 (value) and 4.3e-3
#       (gradient), max 9.5e-3 and 2.1e-2, where the kernel lay a median of
#       6e-8 and a max of 3.4e-3 and 6.8e-3 from the plain version.
SDF_BF16_RULE = ((1e-3, 0.02, 1e-6, 2e-2), (1e-3, 0.10, 1e-6, 5e-2))
COND_ATOL = COND_RTOL = 1e-5
IP_RULE = (1e-4, 0.01, 1e-5, 1e-2)
BEST_RULE = (1e-4, 0.03, 1e-5, 1e-2)
MERIT_RULE = (1e-3, 0.03, 1e-4, 1e-2)
KKT_RULE = (1e-3, 0.03, 1e-4, 2e-2)
# state field -> (index in the phase state, relative?, rule)
IP_FIELDS = {"dz": (0, False, IP_RULE), "best_dz": (10, False, BEST_RULE),
             "best_m": (11, True, MERIT_RULE), "dz_tail_sum": (12, False, IP_RULE)}
#  ip, formulation extras (phase 17): the iterates (dz, best_dz, the tail
#       sum) as accurate as the plain version against f64 (held_as_plain),
#       as phase 16 holds them: at recursive feasibility's stiff phase (k_s
#       48, the hard terminal rows) the plain f32 dz itself lay up to 1.3
#       from f64 and beyond 1e-4 on 18% of 1024 scenarios (an H100, the
#       cold step's inputs; the kernel 1.5 and 17%); the best merit by
#       MERIT_RULE against the plain version, since the plain f32 merit lay
#       within 1.5e-5 of f64 there, which leaves held_as_plain's 4x bound
#       below MERIT_RULE's own median.
ILL_FIELDS = ("dz", "best_dz", "dz_tail_sum")
#  kernels 5-8: every output of every launch of the composed path, per
#       scenario the largest deviation over the largest magnitude of the
#       output.  The late IP iterations factor Newton matrices with
#       condition numbers up to ~1e8, whose f32 solutions lie far from f64
#       in some scenarios whatever the summation order: the plain f32
#       version and the kernel alike, and not by the same amount.  So each
#       launch is held to being as accurate as the plain version: against
#       the plain version run in f64 on the same inputs, the kernel's median
#       deviation at most 2 times the plain f32 version's plus 1e-7, its
#       largest at most 4 times plus 1e-7, and its share beyond 1e-4 at most
#       2 points above.  And a bound that conditioning does not loosen: the
#       backward error of every solution, max |M x - b| / (max |M| max |x| +
#       max |b|) per scenario in f64, at most 10 times the plain version's
#       largest plus 1e-6.  M is the matrix the launch factors (kernels 5
#       and 7) or the one its factor stands for (kernels 6 and 8: L L' from
#       the L it is given), plus, with stiff rows, Cs' diag(1/s) Cs, s being
#       ds_inv (of the kernel-7 launch that made L) with T's jitter added
#       (see system_matrix).  The kernel's deviation from the plain f32
#       version is printed beside.
QP_RULE = (1e-4, 0.02, 2.0, 4.0, 1e-7)  # (threshold, share, median x, max x, floor)
#  the whole composed solve: the selected dz under BEST_RULE and the KKT
#       residual under KKT_RULE, as the fused solve.
# The card is held to the JAX package's CI gate on the dual-warm-start
# replays, cold, steady and warm ticks, but for one warm tick (scenario 11,
# tick 1) that the JAX package's own f32 step leaves at 1.392e-2
# (tests/test_torch_accuracy.py); that tick is held to its limit in
# accuracy.SHORT_TICKS, the largest f32 reading on it.  So is props'
# scenario 14, tick 1 with the default settings.
# FP32 (non-tensor-core) peak and memory rate per part, at its full power
# limit (NVIDIA data sheets); the SXM part is the default.
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12), "SXM": (67e12, 3.35e12)}
# dense TF32 tensor-core peak per part (the data sheets' figures with
# sparsity, halved): the bound of kernel 2's f32x3 route
TF32_PEAKS = {"PCIe": 378e12, "NVL": 417.5e12, "SXM": 495e12}
# dense bf16 tensor-core peak per part, likewise: the bound of kernel 2's
# bf16 route and of the mixed route's tangent rows
BF16_PEAKS = {"PCIe": 756.5e12, "NVL": 835.5e12, "SXM": 989.5e12}
# the torch ops whose output elements count as arithmetic operations in
# ops_per_point (a sum: its input elements less its output elements)
ARITH_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "pow", "rsqrt", "sqrt", "sin", "cos",
             "atan2", "asin", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "sum"}


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------- helpers


class Capture:
    """Records the arguments of every kernel-wrapper call while active (the
    wrappers still run); used to hold each kernel against its plain version
    on exactly the inputs the main path gives it."""

    def __enter__(self):
        from sdf_nmpc_tpu_torch.ops import (
            condense_kernel,
            ip_kernel,
            lin_kernels,
            qp_kernels,
            sdf_fused,
        )
        from sdf_nmpc_tpu_torch.solver import sqp

        self.targets = {"lin_y_sens": (lin_kernels, "lin_y_sens"),
                        "erk4_sens": (lin_kernels, "erk4_sens"),
                        "sdf": (sdf_fused, "sdf_value_grad"),
                        "condense": (condense_kernel, "condense"),
                        "ip_phase": (ip_kernel, "ip_phase"),
                        "solve_qp": (sqp, "solve_qp"),
                        **{name: (qp_kernels, name) for name in COMPOSED_KERNELS}}
        self.calls = {k: [] for k in self.targets}  # name -> [(args, kwargs)]
        self.outs = {k: [] for k in self.targets}  # name -> [what each call returned]
        self.saved = {}
        for name, (mod, attr) in self.targets.items():
            orig = getattr(mod, attr)
            self.saved[name] = orig

            def rec(*args, _name=name, _orig=orig, **kw):
                self.calls[_name].append((args, kw))
                out = _orig(*args, **kw)
                self.outs[_name].append(out)
                return out

            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.saved[name])
        return False

    def args(self, name):
        return [a for a, _ in self.calls[name]]


class PlainPhases:
    """While active, the fused solve runs the plain IP phase on CUDA tensors
    (the reference of the whole-solve check)."""

    def __enter__(self):
        from sdf_nmpc_tpu_torch.ops import ip_kernel

        self.saved = ip_kernel.ip_phase
        ip_kernel.ip_phase = ip_kernel.ip_phase_plain
        return self

    def __exit__(self, *exc):
        from sdf_nmpc_tpu_torch.ops import ip_kernel

        ip_kernel.ip_phase = self.saved
        return False


class PlainComposed:
    """While active, the composed solve runs the plain versions of kernels
    5-8 on CUDA tensors (the reference of the whole-solve checks) and takes
    the f32 floors and caps whatever its dtype, so that a f64 solve is the
    same computation in more precision, as in check_ip."""

    def __enter__(self):
        from sdf_nmpc_tpu_torch.ops import qp_kernels
        from sdf_nmpc_tpu_torch.solver import qp

        self.saved = {name: getattr(qp_kernels, name) for name in COMPOSED_KERNELS}
        self.consts = qp.ip_consts
        for name in COMPOSED_KERNELS:
            setattr(qp_kernels, name, getattr(qp_kernels, f"{name}_plain"))
        qp.ip_consts = lambda dtype, cap=None: self.consts(torch.float32, cap)
        return self

    def __exit__(self, *exc):
        from sdf_nmpc_tpu_torch.ops import qp_kernels
        from sdf_nmpc_tpu_torch.solver import qp

        for name, fn in self.saved.items():
            setattr(qp_kernels, name, fn)
        qp.ip_consts = self.consts
        return False


class PlainSdf:
    """While active, kernel 2's wrapper runs the plain version of the route
    it is asked for on CUDA tensors (the reference of the bf16 routes'
    accuracy gate: the same step with the plain version swapped in)."""

    def __enter__(self):
        from sdf_nmpc_tpu_torch.ops import sdf_fused

        self.saved = sdf_fused.sdf_value_grad
        sdf_fused.sdf_value_grad = lambda packed, pos, latent, mode="f32": sdf_fused.PLAIN[
            mode](packed, pos, latent)
        return self

    def __exit__(self, *exc):
        from sdf_nmpc_tpu_torch.ops import sdf_fused

        sdf_fused.sdf_value_grad = self.saved
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() on the card: CUDA events around reps runs, after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernel_ms(prof, names) -> dict:
    """name -> the device ms of each launch of the port's kernel ``name``
    in a profiled run, in launch order: the profiler's kernel events, read
    by name as phase_profile reads them."""
    from torch.autograd import DeviceType

    out = {name: [] for name in names}
    for e in sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        for name in names:
            if f"{name}_kernel" in e.name:
                out[name].append(e.time_range.elapsed_us() / 1e3)
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def card_peaks(name: str):
    for key, v in PEAKS.items():
        if key in name:
            return key, v
    return "SXM", PEAKS["SXM"]



def bound(ops, bytes_: float, peaks) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak.  ``ops`` and the peak
    (peaks[0]) may be tuples, one per kind of operation that runs on its own
    unit: then the operations take the longest of their times."""
    flops, bw = peaks
    ops, flops = np.atleast_1d(ops), np.atleast_1d(flops)
    t_ops, t_bytes = float((ops / flops).max()) * 1e3, bytes_ / bw * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def deviation(got, want, scale=None):
    """Per scenario, the largest |got - want|, over scale (B,) if given; 0
    where either is not finite (the finite patterns are compared apart)."""
    g, w = got.double(), want.double()
    d = (g - w).abs()
    d = torch.where(torch.isfinite(g) & torch.isfinite(w), d, torch.zeros_like(d))
    d = d.reshape(d.shape[0], -1).amax(-1)
    return d if scale is None else d / scale


def held(label: str, got, want, ref64, scale, rule) -> bool:
    """Prints the share / median / max reading of got against want (and of
    want against its f64 counterpart ref64), both over scale (None:
    absolute), and says whether rule holds."""
    thr, share_max, med_max, mx_max = rule
    d, d64 = deviation(got, want, scale), deviation(want, ref64, scale)
    share, med, mx = float((d > thr).double().mean()), float(d.median()), float(d.max())
    kind = "abs" if scale is None else "rel"
    log(f"  {label} {kind}: median {med:.1e}, max {mx:.1e}, {share:.2%} of {d.shape[0]} above "
        f"{thr:g}; plain f32 vs f64: median {float(d64.median()):.1e}, max "
        f"{float(d64.max()):.1e}, {float((d64 > thr).double().mean()):.2%} above {thr:g}")
    return share <= share_max and med <= med_max and mx <= mx_max


def merit_scale(data, dz):
    """Per scenario, 1 + the sum of the magnitudes of the best merit's terms
    at dz (0.5 dz'H dz, g'dz, the slack penalties): the size its f32
    rounding grows with, since the sum cancels."""
    H, C, g, c0, lh, uh, z1, z2 = (t.double() for t in data[:8])
    dz = dz.double()
    a = dz.abs()
    quad = 0.5 * (a[:, :, None] * H.abs() * a[:, None, :]).sum((1, 2))
    w = c0 + (C @ dz[..., None])[..., 0]
    v = (lh - w).clamp(min=0.0) + (w - uh).clamp(min=0.0)
    return 1.0 + quad + (g * dz).abs().sum(-1) + (z1 * v + 0.5 * z2 * v * v).sum(-1)


def kkt_scale(qp, res):
    """Per scenario, 1 + the largest magnitude of the terms of the projected
    stationarity H dz + g - C'(lam_l - lam_u) whose difference the KKT
    residual is."""
    H, g, C, z1, z2 = (t.double() for t in (qp.H, qp.g, qp.C, qp.z1, qp.z2))
    d = res.duals
    lam = (torch.minimum(d.lam_l.double(), z1 + z2 * d.sl.double()).abs()
           + torch.minimum(d.lam_u.double(), z1 + z2 * d.su.double()).abs())
    terms = ((H.abs() @ res.dz.double().abs()[..., None])[..., 0] + g.abs()
             + (C.abs().transpose(1, 2) @ lam[..., None])[..., 0])
    return 1.0 + terms.amax(-1)


def same_finite(name: str, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
            raise AssertionError(f"{name}: output {i} is not finite where the plain version's "
                                 "is, or the reverse")


# ------------------------------------------------- per-kernel comparisons


def check_lin(args) -> float:
    from sdf_nmpc_tpu_torch.ops import lin_kernels

    got = lin_kernels.lin_y_sens(*args)
    want = lin_kernels.lin_y_sens_plain(args[0], *args[2:])
    ref64 = lin_kernels.lin_y_sens_plain(args[0], *[a.double() for a in args[2:]])
    errs = [max_abs(g, w) for g, w in zip(got, want)]
    d64 = [max_abs(w, r) for w, r in zip(want, ref64)]
    log(f"  lin_y_sens  {args[0].name}: max err per output {['%.2e' % e for e in errs]} tol "
        f"{LIN_TOL}; plain f32 vs f64 {['%.2e' % e for e in d64]}")
    bad = [i for i, (e, t) in enumerate(zip(errs, LIN_TOL)) if not e <= t]
    if bad:
        raise AssertionError(f"lin_y_sens disagrees with its plain version on outputs {bad}")
    return max(errs)


def check_erk4(args) -> float:
    """Kernel 9 against its plain version, per output within ERK4_TOL (1 +
    max |plain|), beside the plain f32 version's distance to f64."""
    from sdf_nmpc_tpu_torch.ops import lin_kernels

    model = args[0]
    got = lin_kernels.erk4_sens(*args)
    want = lin_kernels.erk4_sens_plain(*args)
    ref64 = lin_kernels.erk4_sens_plain(model, *[a.double() for a in args[1:]])
    errs, rows = [], []
    for name, g, w, r in zip(("x+", "A", "B"), got, want, ref64):
        e, lim = max_abs(g, w), ERK4_TOL * (1 + float(w.abs().max()))
        errs.append((e, lim))
        rows.append(f"{name} {e:.2e} (tol {lim:.2e}; plain f32 vs f64 {max_abs(w, r):.2e})")
    log(f"  erk4_sens   {model.name}: max err {', '.join(rows)}")
    if not all(e <= lim for e, lim in errs):
        raise AssertionError(f"erk4_sens ({model.name}) disagrees with its plain version")
    return max(e for e, _ in errs)


# launch count -> mode
SDF_ROUTES = {"sdf_fused": "f32", "sdf_fused_x3": "f32x3", "sdf_fused_bf16": "bf16",
              "sdf_fused_mixed": "mixed"}


def sdf_plain(name):
    from sdf_nmpc_tpu_torch.ops import sdf_fused

    return sdf_fused.PLAIN[SDF_ROUTES[name]]


def check_sdf(args, name) -> float:
    """Kernel 2's route ``name`` against its own plain version on args: the
    f32 routes under SDF_TOL, the bf16 routes per point under SDF_BF16_RULE
    beside the plain version's distance to the f64 exact version."""
    from sdf_nmpc_tpu_torch.ops import sdf_fused

    got = sdf_fused.sdf_value_grad(*args, mode=SDF_ROUTES[name])
    want = sdf_plain(name)(*args)
    errs = [max_abs(g, w) for g, w in zip(got, want)]
    if name in BF16_ROUTES:
        packed, pos, latent = args
        p64 = {k: v.double() if torch.is_tensor(v) else v for k, v in packed.items()
               if not k.startswith("_")}
        ref64 = sdf_fused.sdf_value_grad_plain(p64, pos.double(), latent.double())
        ok = [held(f"{name:12s} {out}", g, w, r, None, rule)
              for out, g, w, r, rule in zip(("value", "gradient"), got, want, ref64,
                                            SDF_BF16_RULE)]
        if not all(ok):
            raise AssertionError(f"sdf_value_grad ({name}) disagrees with its plain version")
        return max(errs)
    log(f"  {name:12s} value err {errs[0]:.2e} (tol {SDF_TOL[0]}), "
        f"grad err {errs[1]:.2e} (tol {SDF_TOL[1]})")
    if not (errs[0] <= SDF_TOL[0] and errs[1] <= SDF_TOL[1]):
        raise AssertionError(f"sdf_value_grad ({name}) disagrees with its plain version")
    return max(errs)


def check_sdf_routes(cap) -> dict:
    """The four routes of kernel 2 on every captured sdf_value_grad input."""
    return {name: max(check_sdf(a, name) for a in cap.args("sdf")) for name in SDF_ROUTES}


def check_condense(args) -> float:
    from sdf_nmpc_tpu_torch.ops import condense_kernel

    got = condense_kernel.condense(*args)
    want = condense_kernel.condense_plain(*args)
    errs, excess = [], []
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs()
        errs.append(float(d.max()))
        excess.append(float((d - COND_RTOL * w.double().abs()).max()))
    log(f"  condense    max err per output {['%.2e' % e for e in errs]} "
        f"(tol {COND_ATOL} + {COND_RTOL} |plain|)")
    if not max(excess) <= COND_ATOL:
        raise AssertionError("condense disagrees with its plain version")
    return max(errs)


def held_as_plain(label: str, got, want, ref64, scale, share_sigmas=0.0) -> bool:
    """Prints the readings of got (kernel), want (plain f32) and both
    against ref64 (plain f64), per scenario over scale (None: absolute), and
    says whether the kernel is as accurate as the plain version against f64
    under QP_RULE (see as_accurate)."""
    thr, kind = QP_RULE[0], "abs" if scale is None else "rel"
    if scale is None:
        scale = torch.ones(got.shape[0], dtype=torch.float64, device=got.device)
    (kp, k64, p64), ok = as_accurate(got, want, ref64, scale, share_sigmas)
    fmt = lambda rd: f"median {rd[1]:.1e}, max {rd[2]:.1e}, {rd[0]:.2%} above {thr:g}"
    log(f"  {label} {kind}: kernel vs f64 {fmt(k64)}; plain f32 vs f64 {fmt(p64)}; kernel vs "
        f"plain {fmt(kp)}")
    return ok


def check_ip(args, label: str, as_plain=False, share_sigmas=0.0) -> float:
    """Kernel 4 on one launch against its plain version: dz, best_dz, the
    best merit and the tail sum under IP_FIELDS' rules, or with
    ``as_plain`` (phase 16) each as accurate as the plain version against
    f64 (held_as_plain); ``as_plain`` a tuple of field names: those so
    held, the others by their rules (phase 17, ILL_FIELDS)."""
    from sdf_nmpc_tpu_torch.ops import ip_kernel

    data, state, k_s, n_iters, it0, consts = args[:6]
    n_tail = args[6] if len(args) > 6 else 0
    rest = (k_s, n_iters, it0, consts, n_tail)
    got = ip_kernel.ip_phase(data, state, *rest)
    want = ip_kernel.ip_phase_plain(data, state, *rest)
    ref64 = ip_kernel.ip_phase_plain(tuple(t.double() for t in data),
                                     tuple(t.double() for t in state), *rest)
    same_finite(f"ip_phase {label}", got, want)
    failed = []
    for name, (i, relative, rule) in IP_FIELDS.items():
        scale = merit_scale(data, want[10]) if relative else None  # at the plain best_dz
        what = f"ip_phase    {label} (k_s={k_s}, {n_iters} iters) {name}"
        plain_rule = name in as_plain if isinstance(as_plain, tuple) else as_plain
        if not (held_as_plain(what, got[i], want[i], ref64[i], scale, share_sigmas)
                if plain_rule else
                held(what, got[i], want[i], ref64[i], scale, rule)):
            failed.append(name)
    if failed:
        raise AssertionError(f"ip_phase {label} disagrees with its plain version on {failed}")
    return max_abs(got[0], want[0])


def check_fused_solve(call, label: str, as_plain=False, share_sigmas=0.0) -> float:
    """The whole fused solve, both kernel launches then the best-iterate
    choice, the tail average and the KKT residual, against the same solve
    with the plain phases, on one captured QP; ``as_plain`` as check_ip."""
    from sdf_nmpc_tpu_torch.solver import QpData, solve_qp

    (qp,), kw = call
    got = solve_qp(qp, **kw)
    with PlainPhases():
        want = solve_qp(qp, **kw)
    with PlainComposed():  # f64 takes the composed path, here in its plain version
        ref64 = solve_qp(QpData(*[t.double() for t in qp]), **kw)
    same_finite(f"fused solve {label}", got[:3], want[:3])
    if as_plain:
        ok_dz = held_as_plain(f"fused solve {label} selected dz", got.dz, want.dz, ref64.dz,
                              None, share_sigmas)
        ok_kkt = held_as_plain(f"fused solve {label} kkt", got.kkt_residual, want.kkt_residual,
                               ref64.kkt_residual, kkt_scale(qp, want), share_sigmas)
    else:
        ok_dz = held(f"fused solve {label} selected dz", got.dz, want.dz, ref64.dz, None,
                     BEST_RULE)
        ok_kkt = held(f"fused solve {label} kkt", got.kkt_residual, want.kkt_residual,
                      ref64.kkt_residual, kkt_scale(qp, want), KKT_RULE)
    if not (ok_dz and ok_kkt):
        raise AssertionError(f"fused solve {label} disagrees with the plain phases")
    return max_abs(got.dz, want.dz)


def check_all(cap: Capture, label: str, as_plain=False, sdf_route=None,
              share_sigmas=0.0) -> dict:
    """Kernels 1, 3 and 4 (each launch and the whole fused solve; see
    check_ip for ``as_plain``, as_accurate for ``share_sigmas``) and, where
    the step called it, kernel 2 by its four routes (or by ``sdf_route``
    alone), against their plain versions on the captured inputs."""
    sdf = ({} if not cap.args("sdf") else check_sdf_routes(cap) if sdf_route is None else
           {sdf_route: max(check_sdf(a, sdf_route) for a in cap.args("sdf"))})
    errs = {
        "lin_y_sens": max(check_lin(a) for a in cap.args("lin_y_sens")),
        **sdf,
        "condense": max(check_condense(a) for a in cap.args("condense")),
    }
    errs["ip_phase"] = max([check_ip(a, f"{label} launch {i}", as_plain, share_sigmas)
                            for i, a in enumerate(cap.args("ip_phase"))]
                           + [check_fused_solve(c, label, as_plain, share_sigmas)
                              for c in cap.calls["solve_qp"]])
    torch.cuda.synchronize()
    return errs


def _flat(out):
    """A kernel's outputs as a flat list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


QP_OUTPUTS = {"factor_solve": ("X", "L"), "solve": ("X",),
              "stiff_factor_solve": ("X", "L", "Xs", "Lt"), "stiff_resolve": ("X",)}


def backward_error(M, X, RHS):
    """Per scenario, max |M x - b| / (max |M| max |x| + max |b|) over the
    rows of X (B, r, n), in f64."""
    M, X, RHS = M.double(), X.double(), RHS.double()
    res = (M @ X.transpose(1, 2) - RHS.transpose(1, 2)).abs().flatten(1).amax(-1)
    size = M.abs().flatten(1).amax(-1) * X.abs().flatten(1).amax(-1)
    return res / (size + RHS.abs().flatten(1).amax(-1))


def system_matrix(name, args, ds_inv=None):
    """In f64, the matrix whose systems a launch of kernel 5-8 solves: the
    one kernel 5 or 7 factors, or the one the factor given to kernel 6 or 8
    stands for (``ds_inv``: that of the kernel-7 launch that made it).  With
    stiff rows it is A + Cs' diag(1/s) Cs, where s is ds_inv plus T's f32
    jitter 10 eps (|T_ii| + 1e-30), T = Cs A^-1 Cs' + diag(ds_inv): the
    Woodbury identity with the jittered T inverts exactly that matrix."""
    if name in ("factor_solve", "stiff_factor_solve"):
        A = args[0].double()
    else:
        L = args[0].double().tril()
        A = L @ L.transpose(1, 2)
    if name == "stiff_factor_solve":
        Cs, ds_inv = args[2], args[3]
    elif name == "stiff_resolve":
        Cs = args[3]
    else:
        return A
    Cs, ds_inv = Cs.double(), ds_inv.double()
    T_ii = (Cs * torch.linalg.solve(A, Cs.transpose(1, 2)).transpose(1, 2)).sum(-1) + ds_inv
    s = ds_inv + 10 * torch.finfo(torch.float32).eps * (T_ii.abs() + 1e-30)
    return A + Cs.transpose(1, 2) @ (Cs / s[..., None])


def paired_ds_inv(cap):
    """For each captured stiff_resolve launch, the ds_inv of the
    stiff_factor_solve launch whose factor L it was given."""
    by_L = {id(_flat(out)[1]): args[3]
            for args, out in zip(cap.args("stiff_factor_solve"), cap.outs["stiff_factor_solve"])}
    return [by_L[id(args[0])] for args in cap.args("stiff_resolve")]


def reading(x, thr):
    """(share beyond thr, median, max) of per-scenario deviations x."""
    return float((x > thr).double().mean()), float(x.median()), float(x.max())


def as_accurate(got, want, ref64, scale, share_sigmas=0.0):
    """Readings of got (kernel) and want (plain f32) against ref64 (plain
    f64) and of got against want, per scenario over scale, and whether the
    kernel is as accurate as the plain version under QP_RULE; with
    ``share_sigmas`` the share may also exceed the plain version's by that
    many binomial sigmas, sqrt(2 p (1 - p) / B) (see ILL_SHARE_SIGMAS)."""
    thr, share_add, med_x, max_x, floor = QP_RULE
    k64, p64 = reading(deviation(got, ref64, scale), thr), reading(deviation(want, ref64, scale), thr)
    share_add = max(share_add, share_sigmas * float(np.sqrt(2 * p64[0] * (1 - p64[0])
                                                            / got.shape[0])))
    ok = (k64[0] <= p64[0] + share_add and k64[1] <= med_x * p64[1] + floor
          and k64[2] <= max_x * p64[2] + floor)
    return (reading(deviation(got, want, scale), thr), k64, p64), ok


def check_qp_kernel(name, calls, label, ds_inv=None) -> float:
    """Every launch of kernel 5-8 in ``calls`` against its plain version and
    the plain version in f64 on the same inputs, under QP_RULE, plus the
    backward error of its solutions (``ds_inv``: per stiff_resolve launch,
    see system_matrix).  One line per output: the worst readings over the
    launches."""
    from sdf_nmpc_tpu_torch.ops import qp_kernels

    kern = getattr(qp_kernels, name)
    plain = getattr(qp_kernels, f"{name}_plain")
    thr = QP_RULE[0]
    worst = {out: [[0.0] * 3 for _ in range(3)] for out in QP_OUTPUTS[name]}
    failed = set()
    bwd = [0.0, 0.0]  # largest backward error: kernel, plain
    err = 0.0
    for i, args in enumerate(calls):
        got, want = _flat(kern(*args)), _flat(plain(*args))
        ref64 = _flat(plain(*[a.double() for a in args]))
        same_finite(f"{name} {label} launch {i}", got, want)
        for out, g, w, r in zip(QP_OUTPUTS[name], got, want, ref64):
            scale = r.abs().flatten(1).amax(-1) + 1e-30
            readings, ok = as_accurate(g, w, r, scale)
            if not ok:
                failed.add(f"{out} (launch {i})")
            for j, rd in enumerate(readings):
                worst[out][j] = [max(a, b) for a, b in zip(worst[out][j], rd)]
        M = system_matrix(name, args, ds_inv[i] if ds_inv is not None else None)
        rhs = args[4] if name == "stiff_resolve" else args[1]
        bwd[0] = max(bwd[0], float(backward_error(M, got[0], rhs).max()))
        bwd[1] = max(bwd[1], float(backward_error(M, want[0], rhs).max()))
        err = max(err, max_abs(got[0], want[0]))
    fmt = lambda rd: f"median {rd[1]:.1e}, max {rd[2]:.1e}, {rd[0]:.2%} above {thr:g}"
    for out, (kp, k64, p64) in worst.items():
        log(f"  {name:18s} {label} {out:2s} rel, worst of {len(calls)} launches: kernel vs f64 "
            f"{fmt(k64)}; plain f32 vs f64 {fmt(p64)}; kernel vs plain {fmt(kp)}")
    log(f"  {name:18s} {label} backward error, largest: kernel {bwd[0]:.1e}, plain "
        f"{bwd[1]:.1e}")
    if not bwd[0] <= 10 * bwd[1] + 1e-6:
        failed.add("backward error")
    if failed:
        raise AssertionError(f"{name} {label} is less accurate than its plain version: "
                             f"{sorted(failed)}")
    return err


def check_composed_solve(call, label: str, as_plain=False) -> float:
    """The whole composed solve, kernels 5-8 with the torch glue around
    them, against the same solve with the plain versions, on one captured
    QP (warm duals included).  ``as_plain`` (config 1's box-only QP, nc =
    0): the selected dz is held to being as accurate as the plain version
    against f64 under QP_RULE (absolute), where BEST_RULE holds it to the
    plain version: without constraint rows the f32 interior point wanders
    about the box-constrained optimum (solver/qp.py's tail-average
    comment), the plain f32 solve itself lying beyond 1e-4 of f64 on 3.7%
    of the scenarios of one B=1024 cold step, the kernels' solve on as
    many, at other scenarios.  ``as_plain`` a tuple of names ("dz",
    "kkt"): those so held (phase 17: at recursive feasibility's k = 48 the
    plain f32 KKT residual itself lay beyond 1e-3 of f64 on 57% of 1024
    scenarios, on an H100), the others by their rules."""
    from sdf_nmpc_tpu_torch.solver import QpData, QpDuals, solve_qp

    (qp,), kw = call
    got = solve_qp(qp, **kw)
    with PlainComposed():
        want = solve_qp(qp, **kw)
        kw64 = dict(kw)
        if kw.get("warm_duals") is not None:
            kw64["warm_duals"] = QpDuals(*[t.double() for t in kw["warm_duals"]])
        ref64 = solve_qp(QpData(*[t.double() for t in qp]), **kw64)
    same_finite(f"composed solve {label}", got[:3], want[:3])
    plain_dz = "dz" in as_plain if isinstance(as_plain, tuple) else as_plain
    if plain_dz:
        ok_dz = held_as_plain(f"composed solve {label} selected dz", got.dz, want.dz, ref64.dz,
                              None)
    else:
        ok_dz = held(f"composed solve {label} selected dz", got.dz, want.dz, ref64.dz, None,
                     BEST_RULE)
    if isinstance(as_plain, tuple) and "kkt" in as_plain:
        ok_kkt = held_as_plain(f"composed solve {label} kkt", got.kkt_residual,
                               want.kkt_residual, ref64.kkt_residual, kkt_scale(qp, want))
    else:
        ok_kkt = held(f"composed solve {label} kkt", got.kkt_residual, want.kkt_residual,
                      ref64.kkt_residual, kkt_scale(qp, want), KKT_RULE)
    if not (ok_dz and ok_kkt):
        raise AssertionError(f"composed solve {label} disagrees with the plain versions")
    return max_abs(got.dz, want.dz)


def check_composed(cap: Capture, label: str, as_plain=False) -> dict:
    errs = {name: check_qp_kernel(name, cap.args(name), label,
                                  paired_ds_inv(cap) if name == "stiff_resolve" else None)
            for name in COMPOSED_KERNELS if cap.args(name)}
    errs["solve_qp"] = max(check_composed_solve(c, label, as_plain)
                           for c in cap.calls["solve_qp"])
    torch.cuda.synchronize()
    return errs


# --------------------------------------------------------------- workloads


def tiled_inputs(ocp, cfg, layout, lat, B, seed, device):
    """B scenarios: the 32 accuracy scenarios tiled, with seeded jitter on
    the start state and the latents (phase 3)."""
    from sdf_nmpc_tpu_torch.solver import SolveInputs
    from sdf_nmpc_tpu_torch.utils import accuracy

    scen = accuracy.build_scenarios(cfg, ocp, layout, lat)
    idx = np.arange(B) % len(scen)
    rng = np.random.default_rng(seed)
    x0 = np.stack([scen[i][0] for i in idx])
    x0[:, :3] += rng.normal(size=(B, 3)) * 0.05
    x0[:, 7:10] += rng.normal(size=(B, 3)) * 0.05
    p = np.stack([scen[i][1] for i in idx])
    p[..., layout.latent_start:] += rng.normal(size=(B, 1, layout.size_latent)) * 0.02
    yr = np.stack([scen[i][2] for i in idx])
    W = np.stack([scen[i][3] for i in idx])
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    N = ocp.N
    return SolveInputs(x0=T(x0), yref=T(np.repeat(yr[:, None], N, 1)),
                       W=T(np.repeat(W[:, None], N, 1)), yrefN=T(yr[:, :ocp.nyN]),
                       WN=T(W[:, :ocp.nyN]), p=T(p))


def bench_inputs(ocp, cfg, layout, B, seed, device):
    """bench.py's workload: random starts near the origin, the trained
    latents in turn, goal (2, 0, 0) with the constrained weights."""
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_latents
    from sdf_nmpc_tpu_torch.ref_gen import Ref
    from sdf_nmpc_tpu_torch.solver import SolveInputs

    lat = load_prod_latents()
    rng = np.random.default_rng(seed)
    N = ocp.N
    x0 = np.zeros((B, ocp.nx))
    x0[:, 3] = 1.0
    x0[:, :3] = rng.normal(size=(B, 3)) * 0.3
    p = np.zeros((B, N + 1, layout.np_total))
    layout.set_flag(p, 1.0)
    layout.set_camera(p, np.zeros(3), np.eye(3))
    layout.set_q_d(p, [1, 0, 0, 0])
    p[..., layout.latent_start:] = lat[np.arange(B) % lat.shape[0]][:, None, :]
    ref = Ref(cfg).use_constrained_weights(True)
    ref.p = np.array([2.0, 0.0, 0.0])
    yr, W = ocp.pack_ref(ref)
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return SolveInputs(x0=T(x0), yref=T(np.tile(yr, (B, N, 1))), W=T(np.tile(W, (B, N, 1))),
                       yrefN=T(np.tile(yr[:ocp.nyN], (B, 1))),
                       WN=T(np.tile(W[:ocp.nyN], (B, 1))), p=T(p))


def random_qp(B, nz, nc, seed, device):
    """A seeded soft-constrained QP batch built as in tests/test_qp_kernels.py."""
    from sdf_nmpc_tpu_torch.solver import QpData

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, nz, nz))
    H = np.einsum("bij,bkj->bik", A, A) + 10 * np.eye(nz)
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return QpData(H=T(H), g=T(rng.normal(size=(B, nz)) * 2), C=T(rng.normal(size=(B, nc, nz))),
                  c0=T(rng.normal(size=(B, nc))), lh=T(np.full((B, nc), -0.1)),
                  uh=T(np.full((B, nc), 0.1)), z1=T(np.full((B, nc), 1e3)),
                  z2=T(np.full((B, nc), 1e4)), lb=T(np.full((B, nz), -0.7)),
                  ub=T(np.full((B, nz), 0.7)))


# ------------------------------------------------------- bytes and operations


def ops_per_point(fn, *args) -> float:
    """Arithmetic operations per point of fn on (M, k) inputs: the output
    elements of each elementwise torch op it runs (ARITH_OPS; a sum counts
    its input elements less its output elements), over M."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            name = func.overloadpacket.__name__
            if name in ARITH_OPS:
                self.n += a[0].numel() - out.numel() if name == "sum" else out.numel()
            return out

    with Count() as c:
        fn(*args)
    return c.n / args[0].shape[0]


_PRIMAL_OPS = {}


def primal_ops(model, nx, with_y) -> float:
    """Operations per point of one primal RK4 step of the model's f_lanes
    (plus its y_lanes), counted on 64 CPU points."""
    from sdf_nmpc_tpu_torch.solver.integrator import erk4

    key = (model.name, with_y)
    if key not in _PRIMAL_OPS:
        X, U = torch.ones(64, nx), torch.full((64, 4), 0.5)
        dt, qd = torch.full((64, 1), 0.1), torch.ones(64, 4)
        ops = ops_per_point(lambda x, u, d: erk4(model.f_lanes, x, u, d), X, U, dt)
        _PRIMAL_OPS[key] = ops + (ops_per_point(model.y_lanes, X, U, qd) if with_y else 0.0)
    return _PRIMAL_OPS[key]


def lin_ops(model, nx, nu, with_y):
    """The least operations of the linearization per point: the primal, and
    at least as many again for each of the nx + nu tangent sweeps (every op
    has a tangent rule of one op or more)."""
    return primal_ops(model, nx, with_y) * (1 + nx + nu)


def lin_cost(args):
    model, layout, X, U, dt, P, yref = args
    M, nx = X.shape
    nu, ny = U.shape[1], yref.shape[1]
    read = nbytes(X, U, dt, yref) + M * len(layout.q_d) * 4
    written = M * (nx + nx * nx + nx * nu + ny + ny * nx + ny * nu) * 4
    return lin_ops(model, nx, nu, True) * M, read + written


def erk4_cost(args):
    model, X, U, dt = args
    M, nx = X.shape
    nu = U.shape[1]
    written = M * (nx + nx * nx + nx * nu) * 4
    return lin_ops(model, nx, nu, False) * M, nbytes(X, U, dt) + written


def sdf_cost(args, split=False):
    """Multiply-adds of the primal row and the three tangent rows; a tangent
    row's latent columns are zero (the latent does not move with position),
    so its layers 1 and 3 take only the nemb embedding inputs.  ``split``:
    the operations as (primal, tangent), for the mixed route, whose primal
    rows run on the CUDA cores and its tangent rows on the tensor cores."""
    packed, pos, latent = args
    P = pos.shape[0]
    nemb, L, (s1, s2, s3, s4) = packed["nemb"], packed["L"], packed["sizes"]

    def row_macs(n_in):
        return n_in * s1 + s1 * s2 + (s2 + n_in) * s3 + s3 * s4 + s4

    ops = (2 * P * row_macs(nemb + L), 2 * P * 3 * row_macs(nemb))
    weights = sum(packed[f"{k}{i}"].numel() * 4 for k in "Wb" for i in range(1, 6))
    read = P * (nemb + 3 * nemb + L) * 4 + weights  # embedding rows, tangents, latents
    return ops if split else sum(ops), read + P * 4 * 4


def condense_cost(args):
    """E_k is zero beyond its first k*nu columns, so stage k's products
    A_k E_k, Jyx_k E_k and Jhx_k E_k take k*nu columns."""
    A, Bm, d, e0, Jyx, Jyu, res, Jhx, Jhu, h = args
    B, N, nx = d.shape
    nu, ny, nh = Bm.shape[-1], Jyx.shape[2], Jhx.shape[2]
    nz = N * nu
    written = B * (N * (nx + nx * nz + ny * nz + ny + nh * nz + nh) + nx + nx * nz) * 4
    cols = nu * N * (N - 1) // 2  # sum over the stages of k * nu
    ops = B * 2 * nx * (nx + ny + nh) * (cols + N)  # + N: the e_k products
    return ops, nbytes(*args) + written


def ip_ops_per_iter(nz, nc, ks):
    """Operations of one interior-point iteration for one scenario."""
    tri = nz * (nz + 1) // 2
    newton = nc * nz + tri * (2 * nc + 1)  # eta C once, then H + C' (eta C), lower triangle
    chol = nz ** 3 // 3
    solves = (ks + 2) * 2 * nz * nz  # predictor (ks + 1 rhs) and corrector
    matvec = 2 * nz * nz + 12 * nc * nz  # H dz and the C / C' products
    # T = Cs Xs' (lower triangle) and the Woodbury correction of both solves
    wood = ks * (ks + 1) // 2 * 2 * nz + 2 * 4 * ks * nz if ks else 0
    return newton + chol + solves + matvec + wood + 100 * (nz + nc)


def ip_cost(args):
    data, state, k_s, n_iters = args[:4]
    B, nz = data[2].shape
    nc = data[3].shape[1]
    return B * n_iters * ip_ops_per_iter(nz, nc, k_s), nbytes(*data) + 2 * nbytes(*state)


def qp_cost(name, args):
    """(operations, bytes) of one launch of kernel 5-8: each input read once
    (a symmetric or triangular matrix by its lower triangle), each output
    written once (a factor in full, zeros above the diagonal included).
    Cholesky n^3 / 3, a two-sweep solve 2 n^2 per row, T's lower triangle
    2 n per entry, its factor k^3 / 3, a Woodbury correction 4 k n + 2 k^2
    per row."""
    B, n = args[0].shape[0], args[0].shape[-1]
    tri = n * (n + 1) // 2
    if name == "factor_solve":
        r = args[1].shape[1]
        return B * (n ** 3 / 3 + 2 * n * n * r), 4 * B * (tri + 2 * r * n + n * n)
    if name == "solve":
        r = args[1].shape[1]
        return B * 2 * n * n * r, 4 * B * (tri + 2 * r * n)
    if name == "stiff_factor_solve":
        r, k = args[1].shape[1], args[2].shape[1]
        ops = n ** 3 / 3 + 2 * n * n * (r + k) + k * (k + 1) * n + k ** 3 / 3
        ops += r * (4 * k * n + 2 * k * k)
        return B * ops, 4 * B * (tri + 2 * r * n + 2 * k * n + k + n * n + k * k)
    k, r = args[1].shape[1], args[4].shape[1]  # stiff_resolve (L, Xs, Lt, Cs, RHS)
    ops = 2 * n * n * r + r * (4 * k * n + 2 * k * k)
    return B * ops, 4 * B * (tri + 2 * k * n + k * (k + 1) // 2 + 2 * r * n)


def library_call(name):
    """One PyTorch call (kernel 6) or two (kernel 5: factor, then solve)
    that compute the same function, else None."""
    if name == "factor_solve":
        def run(M, RHS):
            L = torch.linalg.cholesky(M)
            return torch.cholesky_solve(RHS.transpose(1, 2), L), L
        return run
    if name == "solve":
        return lambda L, RHS: torch.cholesky_solve(RHS.transpose(1, 2), L)
    return None


# ------------------------------------------------------------------ phases


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return card


def phase_build():
    from sdf_nmpc_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.library()
    info = _lib.build_info
    log(f"build: {time.perf_counter() - t0:.1f} s ({info['path']})")
    for line in info["log"].splitlines():
        if line.startswith("==") or any(w in line for w in ("Function", "registers", "spill",
                                                             "error")):
            log("  " + line.strip())


def phase_kernel_checks(dev):
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step, solve_qp
    from sdf_nmpc_tpu_torch.utils import accuracy

    cfg, ocp, layout, lat = accuracy.build_setup(device=dev)
    inputs = tiled_inputs(ocp, cfg, layout, lat, CHECK_B, SEED, dev)
    log(f"kernel checks: one cold step, B={CHECK_B} jittered accuracy scenarios")
    with Capture() as cap:
        make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
            init_state(ocp, inputs.x0), inputs)
    check_all(cap, "accuracy scenarios")
    # tests/test_qp_kernels.py's schedule (8 warm + 4 stiff) and its default
    # ratio cap (0.1 / eps).  The main path's 1e8 cap is held on the main
    # path's own QPs above and in phase 7; on these random QPs most of the
    # 63 rows are near-active, and under that cap the plain f32 phase itself
    # strays from f64 by far more than 1e-4 on many scenarios, which leaves
    # nothing for the kernel to be held to.
    log(f"kernel checks: seeded random QP batch, B={CHECK_B}, nz=80, nc=63, 8 + 4 iterations")
    qp, kw = random_qp(CHECK_B, 80, 63, SEED, dev), dict(iters=12, stiff_iters=4, k_stiff=8)
    with Capture() as cap:
        solve_qp(qp, **kw)
    for i, a in enumerate(cap.args("ip_phase")):
        check_ip(a, f"random QP launch {i}")
    check_fused_solve(((qp,), kw), "random QP")


def phase_composed_checks(dev):
    """Kernels 5-8 on every launch of one dual-warm-started cold step at
    B=CHECK_B, and of one with k_stiff 6 and a refinement sweep (kernel 5
    with 7 rows, three re-solves per iteration); the whole composed solve
    of each against the plain versions."""
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy

    (cw, cs) = COMPOSED_ITERS["cold"]
    expect = {"dual warm start": {"factor_solve": cw, "solve": cw, "stiff_factor_solve": cs,
                                  "stiff_resolve": cs},
              "k_stiff 6, ir_steps 1": {"factor_solve": cw + cs, "solve": 3 * (cw + cs),
                                        "stiff_factor_solve": 0, "stiff_resolve": 0}}
    for over, label in ((DWS, "dual warm start"), (UNALIGNED, "k_stiff 6, ir_steps 1")):
        cfg, ocp, layout, lat = accuracy.build_setup(device=dev, solver_over=over)
        inputs = tiled_inputs(ocp, cfg, layout, lat, CHECK_B, SEED, dev)
        log(f"kernel checks, composed path ({label}): one cold step, B={CHECK_B} jittered "
            "accuracy scenarios from the seeded duals")
        with Capture() as cap:
            make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
                init_state(ocp, inputs.x0, dual_warm_start=True), inputs)
        got = {name: len(cap.args(name)) for name in COMPOSED_KERNELS}
        if got != expect[label] or cap.args("ip_phase"):
            raise AssertionError(f"{label}: launches {got}, expected {expect[label]} and no "
                                 "ip_phase")
        check_composed(cap, label)


def phase_accuracy(dev):
    """The goldens with the default settings (fused path, kernel 2 in
    3xTF32), with kernel 2's IEEE f32 route, and with dual_warm_start
    (composed path)."""
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    report = {}
    for over, label in ((None, "default"), (SDF_F32, "sdf f32"), (DWS, "dual warm start")):
        cold = acc.check_accuracy(device=dev, solver_over=over)
        warm = acc.check_warm_accuracy(device=dev, budget="warm", solver_over=over)
        steady = acc.check_warm_accuracy(device=dev, budget="steady", solver_over=over)
        # with dual_warm_start, the one warm tick the JAX package's f32 step
        # leaves beyond the CI gate is held on its own (see accuracy.py)
        short, limit = acc.short_tick("att", dual_warm_start=over is DWS)
        g = acc.replay_gates(warm, steady, exempt=short)
        rows = (("cold", cold["u0_mean_err"], cold["u0_max_err"], cold["n_ok"], cold["n_scen"]),
                ("warm" if short is None else f"warm but scenario/tick {short}", g["warm_mean"],
                 g["warm_max"], warm["n_ok"], warm["n_solves"]),
                ("steady", g["steady_mean"], g["steady_max"], steady["n_ok"],
                 steady["n_solves"]))
        for name, mean, mx, n_ok, n in rows:
            log(f"accuracy {label} {name}: u0 mean {mean:.3e} max {mx:.3e}, {n_ok}/{n} status "
                f"OK, CI gate {'pass' if acc.ci_gate_ok(mean, mx) else 'FAIL'}, "
                f"strict <= {acc.CONTRACT_MAX}: {'pass' if mx <= acc.CONTRACT_MAX else 'miss'}")
        short_ok = short is None or g["exempt_err"] <= limit
        if short is not None:
            log(f"accuracy {label} warm scenario/tick {short}: u0 err {g['exempt_err']:.4e}, "
                f"limit {limit:g}: {'pass' if short_ok else 'FAIL'}")
        report[label] = {"accuracy_ok": all(r[2] <= acc.CONTRACT_MAX for r in rows),
                         "u0_max_err": cold["u0_max_err"], "u0_mean_err": cold["u0_mean_err"],
                         "u0_warm_max_err": g["warm_max"], "u0_steady_max_err": g["steady_max"]}
        for name, mean, mx, n_ok, n in rows:
            if n_ok != n or not acc.ci_gate_ok(mean, mx):
                raise AssertionError(f"accuracy {label} {name}: gate failed")
        if not short_ok:
            raise AssertionError(f"accuracy {label}: warm scenario/tick {short} beyond its limit")
    log(json.dumps(report))


def phase_accuracy_bf16(dev) -> dict:
    """att's goldens under kernel 2's bf16 and mixed routes.  Not held to the
    CI gate or the 1e-3 contract: the JAX package's own readings of these
    modes (TPU history, printed beside) are 10-15 times the contract.  Held
    to finite results, every status OK, and the cold max at most 2 times the
    same step's with the route's plain version swapped in for the kernel."""
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    report = {}
    for over in BF16_ROUTES.values():
        mode = over["sdf_fused_dtype"]
        cold = acc.check_accuracy(device=dev, solver_over=over)
        warm = acc.check_warm_accuracy(device=dev, budget="warm", solver_over=over)
        steady = acc.check_warm_accuracy(device=dev, budget="steady", solver_over=over)
        with PlainSdf():
            plain = acc.check_accuracy(device=dev, solver_over=over)
        g = acc.replay_gates(warm, steady)
        rows = (("cold", cold["u0_mean_err"], cold["u0_max_err"], cold["n_ok"], cold["n_scen"]),
                ("warm", g["warm_mean"], g["warm_max"], warm["n_ok"], warm["n_solves"]),
                ("steady", g["steady_mean"], g["steady_max"], steady["n_ok"],
                 steady["n_solves"]))
        history, where = TPU_HISTORY[mode]
        for name, mean, mx, n_ok, n in rows:
            log(f"accuracy sdf {mode} {name}: u0 mean {mean:.3e} max {mx:.3e}, {n_ok}/{n} status "
                f"OK (not gated at {acc.CONTRACT_MAX}; TPU history, the JAX package's cold u0 max "
                f"under {mode}: {history}, {where})")
        log(f"accuracy sdf {mode} cold with the plain {mode} version swapped in: u0 mean "
            f"{plain['u0_mean_err']:.3e} max {plain['u0_max_err']:.3e}, {plain['n_ok']}/"
            f"{plain['n_scen']} status OK; the kernel's cold max may be at most 2 times it")
        report[f"sdf {mode}"] = {"u0_max_err": cold["u0_max_err"],
                                 "u0_mean_err": cold["u0_mean_err"],
                                 "u0_warm_max_err": g["warm_max"],
                                 "u0_steady_max_err": g["steady_max"],
                                 "plain_u0_max_err": plain["u0_max_err"]}
        for name, mean, mx, n_ok, n in rows:
            if n_ok != n or not np.isfinite([mean, mx]).all():
                raise AssertionError(f"accuracy sdf {mode} {name}: {n_ok}/{n} status OK, "
                                     f"mean {mean}, max {mx}")
        if not cold["u0_max_err"] <= 2 * plain["u0_max_err"]:
            raise AssertionError(f"accuracy sdf {mode}: the kernel's cold max "
                                 f"{cold['u0_max_err']:.3e} is beyond 2 times its plain "
                                 f"version's {plain['u0_max_err']:.3e}")
    log(json.dumps(report))
    return report


def phase_main_path(dev, card, over=None, per_step=None, label="fused path", model=None,
                    variant="sdf", B=MAIN_B, N=None, n_steady=N_STEADY, synced=True):
    """B scenarios (MAIN_B), one cold step then n_steady chained steady
    steps ended by one synchronize, launch counts set to 0 just before and
    read just after.  ``over``: solver overrides; ``per_step(steps)``: the
    launch count each kernel must reach; ``model``: a quad family other
    than att; ``variant``: accuracy.build_setup's ('nosdf' for BASELINE
    config 1, 'recfeas' and 'sdf_cost' for the formulation extras);
    ``N``: another horizon (phase 19); ``n_steady`` chained steps, and
    ``synced``: the same steps again one at a time (phase 19 keeps its
    host-paced paths' time down without the latter)."""
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy

    cfg, ocp, layout, _ = accuracy.build_setup(device=dev, solver_over=over, model=model,
                                               variant=variant, N=N)
    inputs = bench_inputs(ocp, cfg, layout, B, SEED, dev)
    cold = make_rti_step(ocp, cfg, budget="cold", with_evals=False)
    steady = make_rti_step(ocp, cfg, budget="steady", with_evals=False)
    dws = bool(cfg.solver.get("dual_warm_start", False))
    state0 = init_state(ocp, inputs.x0, dual_warm_start=dws)
    steady(cold(state0, inputs).state, inputs)  # warm-up: first-call set-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    res = cold(state0, inputs)
    n_ok_cold = int((res.status == 0).sum())
    torch.cuda.synchronize()
    # as bench.py: n_steady chained steps ended by one synchronize, so the
    # host queues each step while the card still runs the one before
    t0 = time.perf_counter()
    for _ in range(n_steady):
        res = steady(res.state, inputs)
    issued = time.perf_counter() - t0  # the last step call has returned: host issue time
    torch.cuda.synchronize()
    span = time.perf_counter() - t0
    counts = dict(_lib.launch_counts)
    t_step = span / n_steady
    peak = torch.cuda.max_memory_allocated()

    steps = n_steady + 1
    log(f"{label}: B={B}, 1 cold + {n_steady} steady steps; launches "
        f"{ {k: v for k, v in counts.items() if v} }, per step "
        f"{ {k: round(v / steps, 3) for k, v in counts.items() if v} }")
    for name, want in per_step(steps).items():
        if counts[name] != want:
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, expected {want}")
    if n_ok_cold != B:
        raise AssertionError(f"{label}: cold step: only {n_ok_cold}/{B} scenarios OK")
    n_ok = int((res.status == 0).sum())
    if n_ok != B:
        raise AssertionError(f"{label}: last steady step: only {n_ok}/{B} scenarios OK")
    X, U = res.state.X, res.state.U
    if X.shape != (B, ocp.N + 1, ocp.nx) or U.shape != (B, ocp.N, ocp.nu):
        raise AssertionError(f"unexpected state shapes {tuple(X.shape)}, {tuple(U.shape)}")
    if not (torch.isfinite(X).all() and torch.isfinite(U).all()):
        raise AssertionError("non-finite trajectories")
    if dws and res.state.qp_duals is None:
        raise AssertionError(f"{label}: the state carries no duals")
    log(f"{label}: {n_steady} chained steady steps in {span * 1e3:.3f} ms: "
        f"{t_step * 1e3:.3f} ms/step, {B * n_steady / span:.1f} solves/s; the host "
        f"issued them in {issued * 1e3:.3f} ms ({issued / n_steady * 1e3:.3f} ms/step, "
        f"{issued / span:.1%} of the span); peak memory {peak / 2**30:.3f} GiB; card {card}")

    if not synced:
        return counts, t_step, steady, res.state, inputs
    # secondary: the same steps one at a time, each ended by a synchronize
    times = []
    state = res.state
    for _ in range(n_steady):
        t1 = time.perf_counter()
        state = steady(state, inputs).state
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    ms = np.asarray(times) * 1e3
    log(f"{label}, each step synchronized: median {np.median(ms):.3f} ms (min "
        f"{ms.min():.3f}, max {ms.max():.3f}, mean {ms.mean():.3f} over {n_steady})")
    return counts, t_step, steady, res.state, inputs


def fused_per_step(steps):
    return {name: per * steps for name, per in PER_STEP.items()}


def route_per_step(name):
    """The fused path with kernel 2 by the route whose launch count is
    ``name`` (sdf_fused: the IEEE f32 route; sdf_fused_bf16, sdf_fused_mixed)."""
    return lambda steps: {**fused_per_step(steps), "sdf_fused_x3": 0, name: steps}


def nosdf_per_step(steps):
    """BASELINE config 1: kernel 1 once a step, kernels 5 and 6 once per IP
    iteration each (NOSDF_ITERS), no other kernel."""
    n = NOSDF_ITERS["cold"] + (steps - 1) * NOSDF_ITERS["steady"]
    return {**{name: 0 for name in KERNELS}, "lin_y_sens": steps, "factor_solve": n, "solve": n}


def family_per_step(model):
    """The fused path's launches, kernel 9 in place of kernel 1 for the
    families without a component-form residual; no composed-path launch."""
    def per_step(steps):
        counts = fused_per_step(steps)
        if model in ERK4_FAMILIES:
            counts["lin_y_sens"], counts["erk4_sens"] = 0, steps
        return {**counts, **{name: 0 for name in COMPOSED_KERNELS}}
    return per_step


def composed_per_step(steps):
    """Kernels 1-3 once a step; kernels 5-8 as COMPOSED_ITERS, no kernel 4."""
    (cw, cs), (sw, ss) = COMPOSED_ITERS["cold"], COMPOSED_ITERS["steady"]
    n = steps - 1  # steady steps after the cold one
    return {"lin_y_sens": steps, "erk4_sens": 0, "sdf_fused": 0, "sdf_fused_x3": steps,
            "sdf_fused_bf16": 0, "sdf_fused_mixed": 0, "condense": steps, "ip_phase": 0,
            "factor_solve": cw + n * sw, "solve": cw + n * sw,
            "stiff_factor_solve": cs + n * ss, "stiff_resolve": cs + n * ss}


def phase_kernel_numbers(counts, t_step, steady, state, inputs, card):
    """Kernels 1-4 on the inputs one steady step of the fused path gives
    them at B=MAIN_B, kernel 2 by all four routes on its inputs (``counts``:
    the launches of the main-path runs, each kernel-2 route's from the run
    that took it)."""
    from sdf_nmpc_tpu_torch.ops import condense_kernel, ip_kernel, lin_kernels, sdf_fused

    with Capture() as cap:
        steady(state, inputs)
    calls = {name: cap.args(name) for name in FUSED_KERNELS if name not in SDF_ROUTES}
    calls.update({name: cap.args("sdf") for name in SDF_ROUTES})
    log(f"kernel numbers, fused path: inputs of one steady step at B={MAIN_B}")
    errs = check_all(cap, "main path")
    part, peaks = card_peaks(card.split(",")[0])
    sdf_route = lambda name: lambda *a: sdf_fused.sdf_value_grad(*a, mode=SDF_ROUTES[name])
    runs = {  # name -> (kernel, plain version, cost, library call): no library call
        "lin_y_sens": (lin_kernels.lin_y_sens,
                       lambda a: lin_kernels.lin_y_sens_plain(a[0], *a[2:]), lin_cost, None),
        **{name: (sdf_route(name), lambda a, _p=sdf_plain(name): _p(*a),
                  lambda a, _n=name: sdf_cost(a, split=_n == "sdf_fused_mixed"), None)
           for name in SDF_ROUTES},
        "condense": (condense_kernel.condense, lambda a: condense_kernel.condense_plain(*a),
                     condense_cost, None),
        "ip_phase": (ip_kernel.ip_phase, lambda a: ip_kernel.ip_phase_plain(*a), ip_cost, None),
    }
    # the f32x3 route does three TF32 passes on the tensor cores, the bf16
    # route one bf16 pass; the mixed route its primal rows on the CUDA cores
    # and its tangent rows in one bf16 pass
    rates = {"sdf_fused_x3": (3.0, TF32_PEAKS[part]), "sdf_fused_bf16": (1.0, BF16_PEAKS[part]),
             "sdf_fused_mixed": ((1.0, peaks[0]), (1.0, BF16_PEAKS[part]))}
    rows = kernel_rows(runs, calls, counts, errs, peaks, part, rates)
    for row in rows:  # kernels 1 and 3: launch geometry and ptxas registers beside the ms
        if row["name"] in ("lin_y_sens", "condense"):
            geo = lin_geometry_row if row["name"] == "lin_y_sens" else condense_geometry_row
            row["geometry"] = geo(calls[row["name"]][0], card)
            log(f"  {row['name']} {row['ms']:.4f} ms/step")
    for row in rows:  # kernel 2's routes: launch geometry and ptxas registers
        if row["name"] in SDF_ROUTES:
            name = row["name"]
            row["geometry"] = (sdf_fused.sdf_fused_geometry() if name == "sdf_fused" else
                               sdf_fused.sdf_fused_x3_geometry() if name == "sdf_fused_x3" else
                               sdf_fused.sdf_fused_bf16_geometry(SDF_ROUTES[name],
                                                                 calls[name][0][0]))
            regs = next(iter(ptxas_report(f"{name}_kernel").values()), {})
            row["geometry"].update(regs)
            log(f"  {name}: {row['geometry']['threads']} threads and "
                f"{row['geometry']['smem_bytes']} B of shared memory per block, "
                f"{row['geometry']['blocks_per_sm']} blocks per SM; ptxas "
                f"{regs.get('registers', 'n/a')} registers, {regs.get('spill_stores', 'n/a')} B "
                f"spill stores; card {card}")
    ip_row = next(r for r in rows if r["name"] == "ip_phase")
    # kernel 4: per launch (the warm phase, then the stiff one) k_s and the
    # launch geometry beside launch_ms
    ip_row["launch_k_s"] = [a[2] for a in calls["ip_phase"]]
    ip_row["geometry"] = []
    for a, ms in zip(calls["ip_phase"], ip_row["launch_ms"]):
        geo = ip_kernel.ip_phase_geometry(a[0][0].shape[-1], a[0][1].shape[1], a[2])
        ip_row["geometry"].append(geo)
        log(f"  ip_phase launch k_s={a[2]}, {a[3]} iterations: {ms:.4f} ms; {geo['threads']} "
            f"threads and {geo['smem_bytes']} B of shared memory per block, "
            f"{geo['blocks_per_sm']} blocks per SM")
    log(f"  ip_phase {ip_row['ms']:.4f} ms/step (its first design took 97.26 ms on an H100 "
        f"80GB HBM3 at 700 W, PERF.md section 6); card {card}")
    k_sum = sum(r["ms"] for r in rows if r["name"] not in SDF_ROUTES or
                r["name"] == "sdf_fused_x3")
    log(f"kernels 1-4 (kernel 2 by its default route): {k_sum:.3f} ms of the "
        f"{t_step * 1e3:.3f} ms chained steady step ({k_sum / (t_step * 1e3):.1%}); card {card}")
    return rows


def ptxas_report(kernel: str) -> dict:
    """Registers and stack of each instance of ``kernel`` (its __global__
    name) in the build's ptxas report: {instance: {"registers", "stack",
    "spill_stores", "spill_loads"}} (_lib keeps the report beside the
    library it built)."""
    from sdf_nmpc_tpu_torch.ops import _lib

    out, cur = {}, None
    for line in _lib.build_info["log"].splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return {instance_name(kernel, k): v for k, v in out.items()}


def instance_name(kernel: str, mangled: str) -> str:
    """A readable name of a template instance of kernel 3, 1 or 9 from its
    mangled name: "nx10", "nx13", "nx<=16" (condense), "att", "acc",
    "att_tau" (lin_y_sens), "rates", "wrench", "props" (erk4_sens)."""
    m = re.search(r"ILi(\d+)ELb([01])E", mangled)
    if m:
        return f"nx{m.group(1)}" if m.group(2) == "1" else f"nx<={m.group(1)}"
    for key, name in (("6AttTau", "att_tau"), ("3Acc", "acc"), ("3Att", "att"),
                      ("5Rates", "rates"), ("6Wrench", "wrench"), ("5Props", "props")):
        if key in mangled:
            return name
    return mangled


def geometry_row(name: str, geo: dict, instance: str, card: str) -> dict:
    """Kernel 3's, 1's or 9's launch geometry with the ptxas registers of
    the instance that ran, printed."""
    regs = ptxas_report(f"{name}_kernel").get(instance, {})
    log(f"  {name} ({instance}): {geo['threads']} threads and {geo['smem_bytes']} B of shared "
        f"memory per block, {geo['blocks_per_sm']} blocks per SM; ptxas "
        f"{regs.get('registers', 'n/a')} registers, {regs.get('stack', 'n/a')} B stack, "
        f"{regs.get('spill_stores', 'n/a')} B spill stores; card {card}")
    return {**geo, "instance": instance, **regs}


def condense_geometry_row(args, card) -> dict:
    from sdf_nmpc_tpu_torch.ops import condense_kernel

    A, Bm, _, _, Jyx, _, _, Jhx = args[:8]
    N, nx, nu, ny, nh = A.shape[1], A.shape[2], Bm.shape[-1], Jyx.shape[2], Jhx.shape[2]
    instance = f"nx{nx}" if nx in (10, 13) else "nx<=16"  # csrc/condense.cu's pick()
    return geometry_row("condense", condense_kernel.condense_geometry(N, nx, nu, ny, nh),
                        instance, card)


# the model of each instance id of csrc/lin_y_sens.cu and csrc/erk4_sens.cu
LIN_IDS = ("att", "acc", "att_tau")
ERK4_IDS = ("rates", "wrench", "props", "att", "acc", "att_tau")


def lin_geometry_row(args, card) -> dict:
    from sdf_nmpc_tpu_torch.ops import lin_kernels

    instance = LIN_IDS[dict(args[0].kernel_ids)["lin_y_sens"]]
    return geometry_row("lin_y_sens", lin_kernels.lin_y_sens_geometry(args[0]), instance, card)


def erk4_geometry_row(args, card) -> dict:
    from sdf_nmpc_tpu_torch.ops import lin_kernels

    instance = ERK4_IDS[dict(args[0].kernel_ids)["erk4_sens"]]
    return geometry_row("erk4_sens", lin_kernels.erk4_sens_geometry(args[0]), instance, card)


def kernel_rows(runs, calls, counts, errs, peaks, part, rates=None, device=None):
    """One ``kernels`` row per kernel: its time over the launches of one
    steady step (CUDA events), the plain version's and the library call's
    on the same inputs, and the bound of that work.  ``rates``: name ->
    (passes, peak operations/s) for a kernel whose operations run at another
    peak than FP32's, ``passes`` times over; or a tuple of such pairs, one
    per element of the tuple of operations its cost gives (see bound).
    ``device``: name -> the profiled device ms of each launch in calls
    (profiled_kernel_ms), for small batches, whose launches the host's
    issue outlasts: the kernel's times are taken from it, and the CUDA
    events' reading around the wrapper is kept as ``issue_ms``."""
    rows = []
    for name, (kern, plain, cost, library) in runs.items():
        ms = plain_ms = lib_ms = issue_ms = 0.0
        ops_total, bytes_total = 0.0, 0.0
        launch_ms = []
        if device is not None and len(device[name]) != len(calls[name]):
            raise AssertionError(f"{name}: the profiler saw {len(device[name])} of "
                                 f"{len(calls[name])} launches")
        for i, a in enumerate(calls[name]):
            if device is None:
                launch_ms.append(cuda_ms(lambda: kern(*a), reps=5))
            else:
                launch_ms.append(device[name][i])
                issue_ms += cuda_ms(lambda: kern(*a), reps=5)
            ms += launch_ms[-1]
            plain_ms += cuda_ms(lambda: plain(a), reps=2)
            if library is not None:
                lib_ms += cuda_ms(lambda: library(*a), reps=3)
            ops, by = cost(a)
            ops_total = ops_total + np.asarray(ops, dtype=np.float64)
            bytes_total += by
        rate = (rates or {}).get(name, (1.0, peaks[0]))
        rate = rate if isinstance(rate[0], tuple) else (rate,)
        ops_total = ops_total * np.asarray([passes for passes, _ in rate])
        bound_ms, bound_by = bound(ops_total, bytes_total, ([peak for _, peak in rate],
                                                           peaks[1]))
        ops_total = float(np.sum(ops_total))
        src, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": counts[name], "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms if library is not None else None,
                     "launch_ms": launch_ms})
        lib = f", library {lib_ms:.4f} ms" if library is not None else ""
        issue = ""
        if device is not None:
            rows[-1].update(timed_by="torch.profiler kernel events of the path's run",
                            issue_ms=issue_ms)
            issue = f" device time (CUDA events around the wrapper {issue_ms:.4f} ms)"
        log(f"  {name:18s} {ms:9.4f} ms/step{issue} ({len(calls[name])} launches), plain "
            f"{plain_ms:9.3f} ms{lib}, bound {bound_ms:.4f} ms by {bound_by} ({ops_total:.3e} "
            f"ops, {bytes_total / 1e9:.4f} GB; {part} peaks), {ms and bound_ms / ms:.1%} of bound")
    return rows


def phase_composed_numbers(counts, t_step, steady, state, inputs, card):
    """Kernels 5-8 on the inputs one dual-warm-started steady step at
    B=MAIN_B gives them: agreement, times, bounds, library calls."""
    from sdf_nmpc_tpu_torch.ops import qp_kernels

    with Capture() as cap:
        steady(state, inputs)
    calls = {name: cap.args(name) for name in COMPOSED_KERNELS}
    log(f"kernel numbers, composed path: inputs of one steady step at B={MAIN_B}")
    errs = check_composed(cap, "main path")
    part, peaks = card_peaks(card.split(",")[0])
    runs = {name: (getattr(qp_kernels, name),
                   lambda a, _p=getattr(qp_kernels, f"{name}_plain"): _p(*a),
                   lambda a, _n=name: qp_cost(_n, a), library_call(name))
            for name in COMPOSED_KERNELS}
    rows = kernel_rows(runs, calls, counts, errs, peaks, part)
    sizes = {"factor_solve": lambda a: (a[0].shape[-1], a[1].shape[1]),
             "stiff_factor_solve": lambda a: (a[0].shape[-1], a[1].shape[1], a[2].shape[1]),
             "stiff_resolve": lambda a: (a[0].shape[-1], a[4].shape[1], a[3].shape[1])}
    for row in rows:
        if row["name"] in sizes:
            size = sizes[row["name"]](calls[row["name"]][0])
            geo = row["geometry"] = getattr(qp_kernels, f"{row['name']}_geometry")(*size)
            log(f"  {row['name']} (n, r{', k' if len(size) == 3 else ''} = {size}): "
                f"{geo['threads']} threads and {geo['smem_bytes']} B of shared memory per "
                f"block, {geo['blocks_per_sm']} blocks per SM")
    k_sum = sum(r["ms"] for r in rows)
    log(f"kernels 5-8: {k_sum:.3f} ms of the {t_step * 1e3:.3f} ms chained steady step "
        f"({k_sum / (t_step * 1e3):.1%}); card {card}")
    return rows


def phase_profile(steady, state, inputs, t_step, card, label="fused path", steps=PROFILE_STEPS):
    """Where the time goes: the device's busy share of chained steady steps,
    and the part of it outside the port's kernels (PyTorch ops).  The
    kernels' own times come from CUDA events (phases 7 and 8).  ``steps``
    profiled steps (phase 19 takes 1: its steps issue ~66,000 launches each,
    and reading their events back takes the profiler tens of seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = steady(state, inputs).state
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    busy = other = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3 / steps
            busy += ms
            if not any(f"{k}_kernel" in e.name for k in KERNELS):
                other += ms
    if not busy > 0:
        raise AssertionError("the profiler saw no device time")
    log(f"where the time goes, {label} ({steps} profiled chained steady steps, "
        f"B={MAIN_B}): device busy {busy:.3f} ms per step, {busy / wall:.1%} of the profiled "
        f"{wall:.3f} ms and {busy / (t_step * 1e3):.1%} of the unprofiled {t_step * 1e3:.3f} "
        f"ms, idle {t_step * 1e3 - busy:.3f} ms; PyTorch ops (all but the port's kernels) "
        f"{other:.3f} ms per step; card {card}")


def phase_nmpc(dev, card, ticks=31, model=None, over=DWS, variant="sdf", N=None):
    """The Nmpc controller at B=1 (att with dual_warm_start, or ``model``
    with ``over``), the trained SDF and a latent (``variant`` 'nosdf':
    BASELINE config 1, no network; 'recfeas': built from the network,
    ``bdist_coeffs`` and ``r_tilde``), RefGen waypoints, each tick fed the
    predicted next state; every node's diagnostics finite.  ``N``: another
    horizon (beyond 20 the Riccati backend: kernels 1 and 2 only)."""
    from sdf_nmpc_tpu_torch.controller import Nmpc
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_latents
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.ref_gen import RefGen, Waypoint
    from sdf_nmpc_tpu_torch.utils import accuracy

    from sdf_nmpc_tpu_torch.solver import resolve_qp_backend

    cfg, ocp, _, _ = accuracy.build_setup(device=dev, solver_over=over, model=model,
                                          variant=variant, N=N)
    riccati = resolve_qp_backend(cfg, ocp.N) == "riccati"
    if variant == "nosdf" and ocp.sdf is not None:
        raise AssertionError("config 1's OCP carries a network")
    if variant == "recfeas":  # the controller builds the OCP from its arguments
        nmpc = Nmpc(cfg, sdf=ocp.sdf, sdf_max_df=1.0,
                    bdist_coeffs=accuracy.synthetic_bdist_coeffs(cfg), r_tilde=1.0, device=dev)
        if nmpc.ocp.nhN != ocp.nhN or nmpc.ocp.eval_names != ocp.eval_names:
            raise AssertionError("Nmpc built another recursive-feasibility OCP")
    else:
        nmpc = Nmpc(cfg, ocp=ocp)
    gen = RefGen(cfg)
    latent = load_prod_latents()[0]
    x = np.zeros(ocp.nx)
    x[3] = 1.0
    budgets, times, fails = [], [], []
    _lib.reset_launch_counts()
    for _ in range(ticks):
        nmpc.set_sdf_flag(True)
        nmpc.set_latent(latent, x[:3], np.eye(3))
        nmpc.set_x0(x)
        gen.set_x0(x)
        nmpc.set_refs(gen.gen_ref_list_wps([Waypoint([2.0, 0.5, 0.3]), Waypoint([4.0, 0.0, 0.3])]))
        budgets.append(nmpc.budget)
        fails.append(nmpc.solve())
        times.append(nmpc.get_t())
        cmds = ([(nmpc.get_cmd_props(), nmpc.cmd_props_min, nmpc.cmd_props_max)]
                if model == "props" else
                [(nmpc.get_cmd_TRPYr(), nmpc.cmd_TRPYr_min, nmpc.cmd_TRPYr_max),
                 (nmpc.get_cmd_acc(), nmpc.cmd_acc_min, nmpc.cmd_acc_max)])
        for cmd, lo, hi in cmds:
            if not (np.isfinite(cmd).all() and (cmd >= lo).all() and (cmd <= hi).all()):
                raise AssertionError(f"Nmpc: command {cmd} not finite or outside [{lo}, {hi}]")
        evals = np.asarray([nmpc.eval(k) for k in range(ocp.N + 1)])
        if evals.shape[-1] != max(len(ocp.eval_names), 1) or not np.isfinite(evals).all():
            raise AssertionError(f"Nmpc: diagnostics {ocp.eval_names} of shape {evals.shape} "
                                 "not finite")
        x = nmpc.get_matrices()[0][1]  # the plant follows the prediction
    counts = dict(_lib.launch_counts)
    ms = np.asarray(times[1:]) * 1e3
    dws = bool(cfg.solver.get("dual_warm_start", False))
    what = {"nosdf": ", config 1 (no SDF)", "recfeas": ", recursive feasibility + stability"}
    label = (f"Nmpc, {model or 'att'}{what.get(variant, '')}, B=1, "
             f"{'dual warm start' if dws else 'default settings'}"
             f"{f', N={ocp.N} (riccati)' if riccati else ''}")
    if dws:  # one more tick's launches of kernels 5-8, each timed by CUDA events
        from sdf_nmpc_tpu_torch.ops import qp_kernels

        with Capture() as cap:
            nmpc.solve()
        for name in COMPOSED_KERNELS:
            per = [cuda_ms(lambda: getattr(qp_kernels, name)(*a), reps=20) for a in cap.args(name)]
            log(f"{label}: {name} at B=1, {len(per)} launches in one tick: median "
                f"{np.median(per) * 1e3:.2f} us per launch (min {min(per) * 1e3:.2f}, max "
                f"{max(per) * 1e3:.2f}); card {card}")
    log(f"{label}, {ticks} ticks: budgets {budgets[:6]}... "
        f"({budgets.count('cold')} cold, {budgets.count('warm')} warm, "
        f"{budgets.count('steady')} steady); fail counts {sorted(set(fails))}; last u "
        f"{np.round(nmpc.get_u(), 4).tolist()}; launches {counts}")
    log(f"{label}, per-tick latency over ticks 2-{ticks}: median {np.median(ms):.3f} ms, p99 "
        f"{np.percentile(ms, 99):.3f} ms (min {ms.min():.3f}, max {ms.max():.3f}); first tick "
        f"{times[0] * 1e3:.3f} ms; card {card}")
    if budgets[:5] != ["cold", "warm", "warm", "warm", "steady"] or set(budgets[5:]) != {"steady"}:
        raise AssertionError(f"Nmpc: budget promotion {budgets}")
    if any(fails):
        raise AssertionError(f"Nmpc: fail counts {fails}")
    lin = "erk4_sens" if model in ERK4_FAMILIES else "lin_y_sens"
    if variant == "nosdf":  # kernels 5 and 6 on the nc = 0 QP, no kernel 2 or 3
        used = [lin, "factor_solve", "solve"]
    elif riccati:  # the stage-wise QP: no condensing, no QP kernel
        used = [lin, "sdf_fused_x3"]
    else:
        used = [lin, "sdf_fused_x3", "condense",
                *(list(COMPOSED_KERNELS) if dws else ["ip_phase"])]
    launched_only(label, counts, used)
    return {"median_ms": float(np.median(ms)), "p99_ms": float(np.percentile(ms, 99)),
            "launches": {k: v for k, v in counts.items() if v}}


def phase_batched(dev, card):
    """make_batched_step once at B=MAIN_B (dual warm start, cold budget)."""
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.parallel import make_batched_step
    from sdf_nmpc_tpu_torch.solver import init_state
    from sdf_nmpc_tpu_torch.utils import accuracy

    cfg, ocp, layout, _ = accuracy.build_setup(device=dev, solver_over=DWS)
    inputs = bench_inputs(ocp, cfg, layout, MAIN_B, SEED, dev)
    step = make_batched_step(ocp, cfg)
    state = init_state(ocp, inputs.x0, dual_warm_start=True)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    res, stats = step(state, inputs)
    torch.cuda.synchronize()
    span = time.perf_counter() - t0
    counts = dict(_lib.launch_counts)
    ok = res.status == 0
    want = (int(ok.sum()), int((~ok).sum()), float(res.kkt_residual.max()),
            float(res.kkt_residual.mean()))
    got = (int(stats.n_ok), int(stats.n_failed), float(stats.max_kkt), float(stats.mean_kkt))
    log(f"make_batched_step, B={MAIN_B}, dual warm start, cold: {span * 1e3:.3f} ms; BatchStats "
        f"n_ok {got[0]}, n_failed {got[1]}, max_kkt {got[2]:.4e}, mean_kkt {got[3]:.4e}; "
        f"launches {({k: v for k, v in counts.items() if v})}; card {card}")
    if got != want:
        raise AssertionError(f"BatchStats {got} differ from the reduction of the results {want}")
    if got[0] != MAIN_B or counts["ip_phase"] or not counts["stiff_factor_solve"]:
        raise AssertionError("make_batched_step: scenarios failed or the composed path was not run")


def phase_family_checks(dev, model):
    """Kernel 9 (or 1), kernel 2 and kernel 3 against their plain versions
    on the inputs one cold step of the family gives them at B=CHECK_B."""
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy

    cfg, ocp, layout, lat = accuracy.build_setup(device=dev, model=model)
    inputs = tiled_inputs(ocp, cfg, layout, lat, CHECK_B, SEED, dev)
    log(f"kernel checks, {model} (nx={ocp.nx}, ny={ocp.ny}): one cold step, B={CHECK_B} "
        "jittered accuracy scenarios")
    with Capture() as cap:
        make_rti_step(ocp, cfg, budget="cold", with_evals=False)(init_state(ocp, inputs.x0),
                                                                 inputs)
    lin, other = (("erk4_sens", "lin_y_sens") if model in ERK4_FAMILIES
                  else ("lin_y_sens", "erk4_sens"))
    if len(cap.args(lin)) != 1 or cap.args(other):
        raise AssertionError(f"{model}: {lin} called {len(cap.args(lin))} times, {other} "
                             f"{len(cap.args(other))} times; expected 1 and 0")
    for a in cap.args(lin):
        (check_erk4 if lin == "erk4_sens" else check_lin)(a)
    check_sdf_routes(cap)
    for a in cap.args("condense"):
        check_condense(a)
    torch.cuda.synchronize()


def phase_family_accuracy(dev, model, over=None, label=None) -> dict:
    """The family's cold scenarios against the oracle and its warm / steady
    replays, under the CI gate; a named tick of accuracy.SHORT_TICKS under
    its own limit.  ``over``: solver overrides (props runs with the defaults
    and with kernel 2's IEEE route, SDF_F32), ``label`` their name."""
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    cold = acc.check_accuracy(device=dev, solver_over=over, model=model)
    warm = acc.check_warm_accuracy(device=dev, budget="warm", solver_over=over, model=model)
    steady = acc.check_warm_accuracy(device=dev, budget="steady", solver_over=over, model=model)
    short, limit = acc.short_tick(model)
    label = label or model
    g = acc.replay_gates(warm, steady, exempt=short)
    rows = (("cold vs oracle", cold["u0_mean_err"], cold["u0_max_err"], cold["n_ok"],
             cold["n_scen"]),
            ("warm" if short is None else f"warm but scenario/tick {short}", g["warm_mean"],
             g["warm_max"], warm["n_ok"], warm["n_solves"]),
            ("steady", g["steady_mean"], g["steady_max"], steady["n_ok"], steady["n_solves"]))
    for name, mean, mx, n_ok, n in rows:
        log(f"accuracy {label} {name}: u0 mean {mean:.3e} max {mx:.3e}, {n_ok}/{n} status OK, "
            f"CI gate {'pass' if acc.ci_gate_ok(mean, mx) else 'FAIL'}, strict <= "
            f"{acc.CONTRACT_MAX}: {'pass' if mx <= acc.CONTRACT_MAX else 'miss'}")
    short_ok = short is None or g["exempt_err"] <= limit
    if short is not None:
        log(f"accuracy {label} warm scenario/tick {short}: u0 err {g['exempt_err']:.4e}, limit "
            f"{limit:g}: {'pass' if short_ok else 'FAIL'}")
    for name, mean, mx, n_ok, n in rows:
        if n_ok != n or not acc.ci_gate_ok(mean, mx):
            raise AssertionError(f"accuracy {label} {name}: gate failed")
    if not short_ok:
        raise AssertionError(f"accuracy {label}: warm scenario/tick {short} beyond its limit")
    return {"accuracy_ok": all(r[2] <= acc.CONTRACT_MAX for r in rows),
            "u0_max_err": cold["u0_max_err"], "u0_warm_max_err": g["warm_max"],
            "u0_steady_max_err": g["steady_max"]}


def phase_family_numbers(model, counts, t_step, steady, state, inputs, card):
    """Kernel 9's (or 1's) row and kernel 3's on the inputs one steady step
    of the family gives them at B=MAIN_B (held against their plain versions
    there too), each with its launch geometry, and, for kernel 9, the time
    of the torch.func residual rows the step adds around it."""
    from torch.func import jacfwd, vmap

    from sdf_nmpc_tpu_torch.ops import condense_kernel, lin_kernels

    with Capture() as cap:
        steady(state, inputs)
    part, peaks = card_peaks(card.split(",")[0])
    if model in ERK4_FAMILIES:
        name = "erk4_sens"
        runs = {name: (lin_kernels.erk4_sens, lambda a: lin_kernels.erk4_sens_plain(*a),
                       erk4_cost, None)}
    else:
        name = "lin_y_sens"
        runs = {name: (lin_kernels.lin_y_sens,
                       lambda a: lin_kernels.lin_y_sens_plain(a[0], *a[2:]), lin_cost, None)}
    runs["condense"] = (condense_kernel.condense, lambda a: condense_kernel.condense_plain(*a),
                        condense_cost, None)
    calls = {name: cap.args(name), "condense": cap.args("condense")}
    log(f"kernel numbers, {model}: inputs of one steady step at B={MAIN_B}")
    check = check_erk4 if name == "erk4_sens" else check_lin
    errs = {name: max(check(a) for a in calls[name]),
            "condense": max(check_condense(a) for a in calls["condense"])}
    row, cond_row = kernel_rows(runs, calls, counts, errs, peaks, part)
    cond_row["geometry"] = condense_geometry_row(calls["condense"][0], card)
    log(f"  condense {cond_row['ms']:.4f} ms/step")
    if name == "lin_y_sens":
        row["geometry"] = lin_geometry_row(calls[name][0], card)
        log(f"  lin_y_sens {row['ms']:.4f} ms/step")
    if name == "erk4_sens":
        row["geometry"] = erk4_geometry_row(calls[name][0], card)
        spec, X, U, _ = calls[name][0]
        ocp_y = spec.y
        P = inputs.p[:, :-1].reshape(X.shape[0], -1)

        def y_node(x, u, p):
            y_fn = lambda xv, uv: ocp_y(xv, uv, p)
            return (y_fn(x, u),) + tuple(jacfwd(y_fn, argnums=(0, 1))(x, u))

        glue = cuda_ms(lambda: vmap(y_node)(X, U, P), reps=3)
        row["residual_rows_ms"] = glue
        log(f"  {model}: residual rows and their Jacobians by torch.func (vmap of jacfwd of y, "
            f"M={X.shape[0]}): {glue:.3f} ms per step")
    log(f"{model}: {name} {row['ms']:.4f} ms and condense {cond_row['ms']:.4f} ms of the "
        f"{t_step * 1e3:.3f} ms chained steady step; card {card}")
    return row, cond_row


def kernel_row_per_model(rows: dict, top: str) -> dict:
    """One ``kernels`` row of a kernel run by several models: ``top``'s
    numbers at top level, every model's under ``per_model``."""
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "residual_rows_ms", "stage_rows_ms", "geometry", "points", "launches_from", "B")
    row = {k: v for k, v in rows[top].items() if k != "residual_rows_ms"}
    row["per_model"] = {m: {k: r[k] for k in keys if k in r} for m, r in rows.items()}
    return row


def phase_families(dev, card):
    """Phases 11-13 for each family; returns {kernel: {model: row}} and the
    accuracy report."""
    per_kernel = {"lin_y_sens": {}, "erk4_sens": {}, "condense": {}}
    report = {}
    for model in ERK4_FAMILIES + LIN_FAMILIES:
        phase_family_checks(dev, model)
        report[model] = phase_family_accuracy(dev, model)
        if model == "props":  # its short tick under both kernel-2 routes
            label = f"{model}, sdf f32"
            report[label] = phase_family_accuracy(dev, model, over=SDF_F32, label=label)
        counts, t_step, steady, state, inputs = phase_main_path(
            dev, card, per_step=family_per_step(model), label=f"{model} fused path",
            model=model)
        phase_profile(steady, state, inputs, t_step, card, label=f"{model} fused path")
        row, cond_row = phase_family_numbers(model, counts, t_step, steady, state, inputs, card)
        per_kernel[row["name"]][model] = row
        per_kernel["condense"][model] = cond_row
        del steady, state, inputs
    log(json.dumps({"family_accuracy": report}))
    return per_kernel


def phase_config1(dev, card) -> dict:
    """BASELINE config 1, the obstacle-free waypoint NMPC (enable_sdf off:
    no constraint rows, the plain condensing recursion, the nc = 0 QP on the
    composed path): kernels 1, 5 and 6 against their plain versions on every
    launch of one cold step at B=CHECK_B (phase 4's rules) and the whole
    composed solve; the 32 cold scenarios against the oracle's nosdf_u0
    under the CI gate; the B=MAIN_B main path (kernels 1, 5 and 6 launched,
    no other) and its busy share; the Nmpc controller at B=1 without a
    network, NMPC_TICKS_PROPS ticks."""
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    cfg, ocp, layout, lat = acc.build_setup(device=dev, variant="nosdf")
    inputs = tiled_inputs(ocp, cfg, layout, lat, CHECK_B, SEED, dev)
    log(f"config 1 (no SDF, nh = {ocp.nh}): kernel checks on one cold step, B={CHECK_B} "
        "jittered accuracy scenarios")
    with Capture() as cap:
        make_rti_step(ocp, cfg, budget="cold", with_evals=False)(init_state(ocp, inputs.x0),
                                                                 inputs)
    got = {name: len(cap.args(name)) for name in ("lin_y_sens", "erk4_sens", "sdf", "condense",
                                                  "ip_phase", *COMPOSED_KERNELS)}
    n = NOSDF_ITERS["cold"]
    want = {**{name: 0 for name in got}, "lin_y_sens": 1, "factor_solve": n, "solve": n}
    if got != want:
        raise AssertionError(f"config 1: calls {got}, expected {want}")
    if cap.calls["solve_qp"][0][0][0].C.shape[1] != 0:
        raise AssertionError("config 1: the QP has constraint rows")
    for a in cap.args("lin_y_sens"):
        check_lin(a)
    check_composed(cap, "config 1", as_plain=True)
    cold = acc.check_accuracy(device=dev, variant="nosdf")
    ok = cold["n_ok"] == cold["n_scen"] and acc.ci_gate_ok(cold["u0_mean_err"],
                                                            cold["u0_max_err"])
    log(f"accuracy config 1 cold vs oracle nosdf_u0: u0 mean {cold['u0_mean_err']:.3e} max "
        f"{cold['u0_max_err']:.3e}, {cold['n_ok']}/{cold['n_scen']} status OK, CI gate "
        f"{'pass' if ok else 'FAIL'}, strict <= {acc.CONTRACT_MAX}: "
        f"{'pass' if cold['u0_max_err'] <= acc.CONTRACT_MAX else 'miss'}")
    if not ok:
        raise AssertionError("accuracy config 1: gate failed")
    counts, t_step, steady, state, inputs = phase_main_path(
        dev, card, per_step=nosdf_per_step, label="config 1 (no SDF)", variant="nosdf")
    phase_profile(steady, state, inputs, t_step, card, label="config 1 (no SDF)")
    del steady, state, inputs
    phase_nmpc(dev, card, ticks=NMPC_TICKS_PROPS, over=None, variant="nosdf")
    return {"u0_max_err": cold["u0_max_err"], "u0_mean_err": cold["u0_mean_err"],
            "launches": {k: v for k, v in counts.items() if v}}


def phase_other_rows(dev, card) -> dict:
    """The SDF row's other inputs at B=CHECK_B, one cold step each: an
    omnidirectional sensor (OMNI: no hfov row, nh = 2; the trained network,
    kernels 1-4 held against their plain versions on the step's inputs) and
    the autodiff SDF row (a seeded NeuralDF with res='state', the trained
    network's other settings: kernels 1, 3 and 4 held, no kernel 2).
    Kernel 4 and the fused solve are held to being as accurate as their
    plain versions against f64 (check_ip's ``as_plain``): on the omni
    sensor's stiff phase one ill-conditioned scenario left the plain f32
    phase 0.15 from f64 and the kernel 0.034 from the plain version, beyond
    IP_RULE's flat 1e-2.  The first OTHER_SCEN scenarios of each against
    the port's f64 step on the CPU on the same inputs, under the CI gate."""
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_latents, load_prod_sdf
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.params import ParamLayout
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    prod = load_prod_sdf(require_latent=acc.LATENT, require_layers=acc.LAYERS, device=dev)
    lat = np.asarray(load_prod_latents()[:acc.N_SCEN], np.float64)
    base = default_config().replace(nn=dict(size_latent=acc.LATENT))
    seeded = NeuralDF(size_latent=acc.LATENT, layer_sizes=acc.LAYERS, embed=prod.embed,
                      act=prod.act, w0=prod.w0, nb_freqs=prod.nb_freqs, res="state",
                      generator=torch.Generator().manual_seed(SEED)).to(dev)
    report = {}
    for label, cfg, net, sdf_kernel in (("omni sensor", base.replace(**OMNI), prod, True),
                                        ("autodiff row (res='state')", base, seeded, False)):
        ocp = build_ocp(cfg, sdf=net, device=dev)
        inputs = tiled_inputs(ocp, cfg, ParamLayout.from_cfg(cfg), lat, CHECK_B, SEED, dev)
        log(f"{label} (nh = {ocp.nh}, nhN = {ocp.nhN}): one cold step, B={CHECK_B} jittered "
            "accuracy scenarios")
        _lib.reset_launch_counts()
        with Capture() as cap:
            res = make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
                init_state(ocp, inputs.x0), inputs)
        used = ["lin_y_sens", "condense", "ip_phase"] + (["sdf_fused_x3"] if sdf_kernel else [])
        launched_only(label, dict(_lib.launch_counts), used)
        if bool(cap.args("sdf")) != sdf_kernel:
            raise AssertionError(f"{label}: kernel 2 called {len(cap.args('sdf'))} times")
        n_ok = int((res.status == 0).sum())
        if n_ok != CHECK_B or not torch.isfinite(res.u0).all():
            raise AssertionError(f"{label}: {n_ok}/{CHECK_B} scenarios OK")
        check_all(cap, label, as_plain=True)
        report[label] = against_f64_step(label, ocp, cfg, inputs, res, card)
    return report


def recfeas_per_step(steps):
    """Recursive feasibility on the fused path: kernels 1-4 as the main
    path's, kernel 4's stiff phase at k_s = 48; no other kernel."""
    return {**{name: 0 for name in KERNELS}, **fused_per_step(steps)}


def sdf_cost_per_step(steps):
    """sdf_cost on the fused QP path: kernel 9 (not kernel 1) once a step,
    no kernel 2 (the SDF reaches the residual, differentiated by
    torch.func), kernel 3 once and kernel 4 twice a step; no other kernel."""
    return {**{name: 0 for name in KERNELS}, "erk4_sens": steps, "condense": steps,
            "ip_phase": 2 * steps}


def launched_only(label, counts, used):
    """Every kernel of ``used`` launched, none other."""
    missing = [k for k in used if not counts[k]]
    extra = [k for k in KERNELS if k not in used and counts[k]]
    log(f"{label}: launches {({k: v for k, v in counts.items() if v})}")
    if missing or extra:
        raise AssertionError(f"{label}: kernels not launched {missing}, or launched {extra}")


def against_f64_step(label, ocp, cfg, inputs, res, card) -> dict:
    """The first OTHER_SCEN scenarios of a card step's u0 against the
    port's f64 step on the CPU on the same inputs, under the CI gate."""
    import copy

    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.solver import SolveInputs, init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    cfg64 = cfg.replace(solver=dict(dtype="float64"))
    ocp64 = build_ocp(cfg64, sdf=copy.deepcopy(ocp.sdf).double().cpu(), device="cpu")
    few = SolveInputs(*[t[:OTHER_SCEN].double().cpu() for t in inputs])
    ref = make_rti_step(ocp64, cfg64, budget="cold", with_evals=False)(
        init_state(ocp64, few.x0, torch.float64), few)
    err = (res.u0[:OTHER_SCEN].double().cpu() - ref.u0).abs().amax(-1).numpy()
    ok = bool((ref.status == 0).all()) and acc.ci_gate_ok(err.mean(), err.max())
    log(f"{label}: the first {OTHER_SCEN} scenarios against the f64 CPU step: u0 mean "
        f"{err.mean():.3e} max {err.max():.3e}, CI gate {'pass' if ok else 'FAIL'}, strict <= "
        f"{acc.CONTRACT_MAX}: {'pass' if err.max() <= acc.CONTRACT_MAX else 'miss'}; card {card}")
    if not ok:
        raise AssertionError(f"{label}: gate against the f64 step failed")
    return {"u0_max_err": float(err.max()), "u0_mean_err": float(err.mean()),
            "accuracy_ok": bool(err.max() <= acc.CONTRACT_MAX)}


def ip_launch_rows(row, calls, card, label):
    """Kernel 4's row: per launch its k_s and launch geometry beside its time."""
    from sdf_nmpc_tpu_torch.ops import ip_kernel

    row["launch_k_s"] = [a[2] for a in calls]
    row["geometry"] = []
    for a, ms in zip(calls, row["launch_ms"]):
        geo = ip_kernel.ip_phase_geometry(a[0][0].shape[-1], a[0][1].shape[1], a[2])
        row["geometry"].append(geo)
        log(f"  {label}: ip_phase launch (nz, nc, k_s) = ({a[0][0].shape[-1]}, "
            f"{a[0][1].shape[1]}, {a[2]}), {a[3]} iterations: {ms:.4f} ms; {geo['threads']} "
            f"threads and {geo['smem_bytes']} B of shared memory per block, "
            f"{geo['blocks_per_sm']} blocks per SM; card {card}")
    return row


def erk4_sdf_cost_check(dev, card, model):
    """Kernel 9's instance of ``model`` on one cold sdf_cost step at
    B=CHECK_B: launches (kernels 9, 3 and 4 only), every scenario OK, kernel
    9 against its plain version under ERK4_TOL, its launch geometry and
    ptxas registers.  Returns (cfg, ocp, inputs, result, capture, error,
    geometry)."""
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    cfg, ocp, layout, lat = acc.build_setup(device=dev, model=None if model == "att" else model,
                                            variant="sdf_cost")
    inputs = tiled_inputs(ocp, cfg, layout, lat, CHECK_B, SEED, dev)
    label = f"sdf_cost, {model}"
    log(f"{label} (ny = {ocp.ny} against the model's {ocp.model.ny}, nh = {ocp.nh}, nhN = "
        f"{ocp.nhN}): one cold step, B={CHECK_B} jittered accuracy scenarios")
    _lib.reset_launch_counts()
    with Capture() as cap:
        res = make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
            init_state(ocp, inputs.x0), inputs)
    launched_only(label, dict(_lib.launch_counts), ["erk4_sens", "condense", "ip_phase"])
    if len(cap.args("erk4_sens")) != 1 or cap.args("sdf"):
        raise AssertionError(f"{label}: kernel 9 called {len(cap.args('erk4_sens'))} times, "
                             f"kernel 2 {len(cap.args('sdf'))} times; expected 1 and 0")
    n_ok = int((res.status == 0).sum())
    if n_ok != CHECK_B or not torch.isfinite(res.u0).all():
        raise AssertionError(f"{label}: {n_ok}/{CHECK_B} scenarios OK")
    args = cap.args("erk4_sens")[0]
    return cfg, ocp, inputs, res, cap, check_erk4(args), erk4_geometry_row(args, card)


def torch_func_ms(dev, X, U, P, card, label) -> dict:
    """Under sdf_cost the step differentiates the residual (14 forward
    tangents through the network) and the stage constraint rows (reverse
    mode, 3 rows) by torch.func around kernel 9: the time of each on the
    steady step's M points (CUDA events)."""
    import copy

    from torch.func import jacfwd, jacrev, vmap

    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    _, ocp, _, _ = acc.build_setup(device=dev, variant="sdf_cost")
    net = copy.deepcopy(ocp.sdf).float().requires_grad_(False)

    def y_node(x, u, p):
        y_fn = lambda xv, uv: ocp.y(xv, uv, p, net)
        return (y_fn(x, u),) + tuple(jacfwd(y_fn, argnums=(0, 1))(x, u))

    h_rows = vmap(jacrev(lambda x, u, p: ocp.h_stage(x, u, p, net), argnums=(0, 1)))
    out = {"residual_rows_ms": cuda_ms(lambda: vmap(y_node)(X, U, P), reps=3),
           "stage_rows_ms": cuda_ms(lambda: h_rows(X, U, P), reps=3)}
    log(f"  {label}: by torch.func through the network, M={X.shape[0]}: the residual rows "
        f"and their Jacobians (vmap of jacfwd of y) {out['residual_rows_ms']:.3f} ms, the "
        f"{ocp.nh} stage rows' (vmap of jacrev) {out['stage_rows_ms']:.3f} ms per step; "
        f"card {card}")
    return out


def fused_runs() -> dict:
    """kernel_rows' (kernel, plain version, cost, library call) of kernels
    1-4 on the fused path (kernel 2 by its default f32x3 route)."""
    from sdf_nmpc_tpu_torch.ops import condense_kernel, ip_kernel, lin_kernels, sdf_fused

    return {
        "lin_y_sens": (lin_kernels.lin_y_sens,
                       lambda a: lin_kernels.lin_y_sens_plain(a[0], *a[2:]), lin_cost, None),
        "sdf_fused_x3": (lambda *a: sdf_fused.sdf_value_grad(*a, mode="f32x3"),
                         lambda a, _p=sdf_plain("sdf_fused_x3"): _p(*a), sdf_cost, None),
        "condense": (condense_kernel.condense, lambda a: condense_kernel.condense_plain(*a),
                     condense_cost, None),
        "ip_phase": (ip_kernel.ip_phase, lambda a: ip_kernel.ip_phase_plain(*a), ip_cost, None),
    }


def phase_formulation(dev, card) -> dict:
    """The formulation extras (phase 17): sdf_cost through kernel 9's att,
    acc and att_tau instances; recursive feasibility and stability through
    kernel 4 at the wide stiff split (k_s = 48) and kernels 7-8 at k = 48.
    Returns the rows and readings for the kernels line and the report."""
    from sdf_nmpc_tpu_torch.ops import _lib, lin_kernels, qp_kernels
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.solver.sqp import _budget_knobs
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    part, peaks = card_peaks(card.split(",")[0])
    report, out = {}, {"erk4_sens": {}, "per_path": {}}
    erk4_run = (lin_kernels.erk4_sens, lambda a: lin_kernels.erk4_sens_plain(*a), erk4_cost,
                None)

    # -- sdf_cost: kernel 9's three instances, and att's step held
    for model in SDF_COST_FAMILIES:
        cfg, ocp, inputs, res, cap, err, geo = erk4_sdf_cost_check(dev, card, model)
        if model == "att":  # kernels 3 and 4 held, the step against the f64 CPU step
            for a in cap.args("condense"):
                check_condense(a)
            for i, a in enumerate(cap.args("ip_phase")):
                check_ip(a, f"sdf_cost launch {i}", as_plain=ILL_FIELDS)
            for c in cap.calls["solve_qp"]:
                check_fused_solve(c, "sdf_cost", as_plain=True)
            report["sdf_cost"] = against_f64_step("sdf_cost, att", ocp, cfg, inputs, res, card)
            continue
        # acc and att_tau: kernel 9's numbers at the main path's point count,
        # the check step's inputs tiled
        spec, X, U, dt = cap.args("erk4_sens")[0]
        reps = MAIN_B // CHECK_B
        big = (spec, X.repeat(reps, 1), U.repeat(reps, 1), dt.repeat(reps))
        log(f"kernel numbers, sdf_cost, {model}: kernel 9 on the check step's inputs tiled to "
            f"{big[1].shape[0]} points")
        row = kernel_rows({"erk4_sens": erk4_run}, {"erk4_sens": [big]},
                          {"erk4_sens": len(cap.args("erk4_sens"))},
                          {"erk4_sens": max(err, check_erk4(big))}, peaks, part)[0]
        row.update(geometry=geo, points=int(big[1].shape[0]),
                   launches_from=f"one cold sdf_cost step at B={CHECK_B}")
        out["erk4_sens"][model] = row
        del cap, res, inputs

    # -- recursive feasibility + stability, fused path
    cfg, ocp, layout, lat = acc.build_setup(device=dev, variant="recfeas")
    nc = ocp.N * ocp.nh + ocp.nhN
    inputs = tiled_inputs(ocp, cfg, layout, lat, CHECK_B, SEED, dev)
    log(f"recfeas (nh = {ocp.nh}, nhN = {ocp.nhN}: nc = {nc}; budgets "
        f"{ {b: _budget_knobs(cfg, b)[:3] for b in ('cold', 'warm', 'steady')} } as (iterations, "
        f"k_stiff, stiff iterations)): one cold step, B={CHECK_B} jittered accuracy scenarios")
    _lib.reset_launch_counts()
    with Capture() as cap:
        res = make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
            init_state(ocp, inputs.x0), inputs)
    launched_only("recfeas", dict(_lib.launch_counts),
                  ["lin_y_sens", "sdf_fused_x3", "condense", "ip_phase"])
    k_s = [a[2] for a in cap.args("ip_phase")]
    if k_s != [0, 48] or nc != 68:
        raise AssertionError(f"recfeas: kernel 4 launched at k_s {k_s}, nc {nc}; expected "
                             "[0, 48] and 68")
    # the hard terminal rows (penalty 1e3 / 1e4) leave ill-conditioned
    # phases: kernel 4's iterates and the solve are held as phase 16 holds
    # them (ILL_FIELDS)
    check_all(cap, "recfeas", as_plain=ILL_FIELDS)
    cold = acc.check_accuracy(device=dev, variant="recfeas")
    ok = cold["n_ok"] == cold["n_scen"] and acc.ci_gate_ok(cold["u0_mean_err"],
                                                            cold["u0_max_err"])
    log(f"accuracy recfeas cold vs oracle recfeas_u0: u0 mean {cold['u0_mean_err']:.3e} max "
        f"{cold['u0_max_err']:.3e}, {cold['n_ok']}/{cold['n_scen']} status OK, CI gate "
        f"{'pass' if ok else 'FAIL'}, strict <= {acc.CONTRACT_MAX}: "
        f"{'pass' if cold['u0_max_err'] <= acc.CONTRACT_MAX else 'miss'}; card {card}")
    if not ok:
        raise AssertionError("accuracy recfeas: gate failed")
    report["recfeas"] = {"u0_max_err": cold["u0_max_err"], "u0_mean_err": cold["u0_mean_err"],
                         "accuracy_ok": bool(cold["u0_max_err"] <= acc.CONTRACT_MAX)}
    del cap, res, inputs

    # -- recursive feasibility on the composed path: kernels 7-8 at k = 48
    cfg, ocp, layout, lat = acc.build_setup(device=dev, variant="recfeas", solver_over=DWS)
    inputs = tiled_inputs(ocp, cfg, layout, lat, CHECK_B, SEED, dev)
    iters, k, stiff, _ = _budget_knobs(cfg, "cold")
    want = {"factor_solve": iters - stiff, "solve": iters - stiff, "stiff_factor_solve": stiff,
            "stiff_resolve": stiff}
    log(f"recfeas, composed path (dual warm start): one cold step, B={CHECK_B}, {iters} "
        f"iterations, the last {stiff} at k = {k}")
    with Capture() as cap:
        make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
            init_state(ocp, inputs.x0, dual_warm_start=True), inputs)
    got = {name: len(cap.args(name)) for name in COMPOSED_KERNELS}
    ks = {a[2].shape[1] for a in cap.args("stiff_factor_solve")}
    if got != want or cap.args("ip_phase") or ks != {48}:
        raise AssertionError(f"recfeas composed: launches {got} at k {ks}, expected {want} at "
                             "k 48 and no ip_phase")
    errs = check_composed(cap, "recfeas composed", as_plain=("dz", "kkt"))
    runs = {name: (getattr(qp_kernels, name),
                   lambda a, _p=getattr(qp_kernels, f"{name}_plain"): _p(*a),
                   lambda a, _n=name: qp_cost(_n, a), library_call(name))
            for name in COMPOSED_KERNELS}
    log(f"kernel numbers, recfeas composed path: the launches of that cold step, B={CHECK_B}")
    rows = kernel_rows(runs, {name: cap.args(name) for name in COMPOSED_KERNELS}, got, errs,
                       peaks, part)
    for row in rows:
        if row["name"].startswith("stiff"):
            a = cap.args(row["name"])[0]
            size = ((a[0].shape[-1], a[1].shape[1], a[2].shape[1])
                    if row["name"] == "stiff_factor_solve"
                    else (a[0].shape[-1], a[4].shape[1], a[3].shape[1]))
            row["geometry"] = getattr(qp_kernels, f"{row['name']}_geometry")(*size)
            log(f"  {row['name']} (n, r, k = {size}): {row['geometry']}")
        out["per_path"].setdefault(row["name"], {})[f"recfeas composed, cold, B={CHECK_B}"] = row
    del cap, inputs

    # -- the two paths at full width
    lin_run, x3, cond_run, ip_run = fused_runs().values()
    for variant, per_step, path_runs in (
            ("recfeas", recfeas_per_step, {"lin_y_sens": lin_run, "sdf_fused_x3": x3,
                                           "condense": cond_run, "ip_phase": ip_run}),
            ("sdf_cost", sdf_cost_per_step, {"erk4_sens": erk4_run, "condense": cond_run,
                                             "ip_phase": ip_run})):
        label, B = f"{variant} path", MAIN_B
        while True:  # the largest power of two that fits the card's memory
            try:
                counts, t_step, steady, state, inputs = phase_main_path(
                    dev, card, per_step=per_step, label=label, variant=variant, B=B)
                break
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
                log(f"{label}: B={B} does not fit in the card's memory; cut to B={B // 2}")
                B //= 2
        phase_profile(steady, state, inputs, t_step, card, label=label)
        with Capture() as cap:
            steady(state, inputs)
        calls = {name: cap.args("sdf" if name == "sdf_fused_x3" else name) for name in path_runs}
        log(f"kernel numbers, {label}: inputs of one steady step at B={B}")
        # kernel 4 here by the whole fused solve (both launches, the best
        # iterate, the tail average; as phase 16 holds it): at B=8192 one
        # scenario's warm-phase iterate of the recursive-feasibility QP lay
        # 2.6e-2 from f64, the plain version's worst 6.0e-3 (an H100), beyond
        # every per-launch rule's max while their shares and medians agreed;
        # each launch is held at B=1024 above and by the card tests
        errs = {"condense": max(check_condense(a) for a in calls["condense"]),
                "ip_phase": max(check_fused_solve(c, label, as_plain=True)
                                for c in cap.calls["solve_qp"])}
        if variant == "recfeas":
            errs["lin_y_sens"] = max(check_lin(a) for a in calls["lin_y_sens"])
            errs["sdf_fused_x3"] = check_sdf_routes(cap)["sdf_fused_x3"]
        else:
            errs["erk4_sens"] = max(check_erk4(a) for a in calls["erk4_sens"])
        rates = {"sdf_fused_x3": (3.0, TF32_PEAKS[part])}
        rows = kernel_rows(path_runs, calls, counts, errs, peaks, part, rates)
        for row in rows:
            row.update(B=B, t_step_ms=t_step * 1e3)
            if row["name"] == "ip_phase":
                ip_launch_rows(row, calls["ip_phase"], card, label)
            if row["name"] == "erk4_sens":
                row["geometry"] = erk4_geometry_row(calls["erk4_sens"][0], card)
                _, X, U, _ = calls["erk4_sens"][0]
                P = inputs.p[:, :-1].reshape(X.shape[0], -1)
                row.update(torch_func_ms(dev, X, U, P, card, label))
                out["erk4_sens"]["att"] = row
            out["per_path"].setdefault(row["name"], {})[f"{variant}, steady, B={B}"] = row
        report[f"{variant} main path"] = {"B": B, "ms_per_step": t_step * 1e3,
                                         "solves_per_s": B / t_step}
        del steady, state, inputs, cap
    phase_nmpc(dev, card, ticks=NMPC_TICKS_PROPS, over=None, variant="recfeas")
    log(json.dumps({"formulation": report}))
    out["report"] = report
    return out


def encoder_on_card(dev, card, cfg) -> tuple:
    """Phase 18a: the trained encoder (strict resolution gate) on the 8
    config-3 scenes rendered on the card, its f32 latents against the f64
    CPU encoder on the same images under LATENT_RULE, once, with cuDNN as
    the port's encoder path leaves it (benchmark off, TF32 off, algorithms
    not pinned).  Returns (f32 encoder, images, report)."""
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    t0 = time.perf_counter()
    enc = acc.config3_encoder(cfg, torch.float32, dev)
    load_s = time.perf_counter() - t0
    n_par = sum(p.numel() for p in enc.parameters())
    render_ms = cuda_ms(lambda: acc.config3_images(cfg, torch.float32, dev), reps=3)
    imgs = acc.config3_images(cfg, torch.float32, dev)
    log(f"perception: trained encoder ({n_par} parameters, batch norm "
        f"{any(isinstance(m, torch.nn.BatchNorm2d) for m in enc.modules())}) loaded in "
        f"{load_s:.2f} s; {imgs.shape[0]} config-3 scenes rendered on the card at "
        f"{tuple(imgs.shape[1:])} (48 sphere-tracing steps) in {render_ms:.3f} ms; card {card}")
    enc64 = acc.config3_encoder(cfg, torch.float64, torch.device("cpu"))
    with torch.no_grad():
        ref = enc64(imgs.double().cpu()[:, None])
        z = enc(imgs[:, None])
    torch.cuda.synchronize()
    limit = LATENT_RULE * (1 + float(ref.abs().max()))
    err = float((z.double().cpu() - ref).abs().max())
    setting = (f"cudnn benchmark {torch.backends.cudnn.benchmark}, deterministic "
               f"{torch.backends.cudnn.deterministic}, allow_tf32 "
               f"{torch.backends.cudnn.allow_tf32}")
    log(f"perception: card f32 latents vs the f64 CPU encoder on the same images: max |d| "
        f"{err:.3e} (limit {limit:.3e} = {LATENT_RULE} (1 + max |z| {float(ref.abs().max()):.3f})); "
        f"{setting}; card {card}")
    if not err <= limit:
        raise AssertionError("perception: card latents beyond the rule")
    return enc, imgs, {"latent_max_err": err, "latent_limit": limit, "cudnn": setting,
                       "render_ms_8": render_ms}


def config3_contract(dev, card, part, peaks) -> tuple:
    """Phase 18b: check_config3_accuracy on the card (default settings,
    kernel 2's f32x3 route) against tests/golden/config3_u0.npz, kernels
    1-4 held against their plain versions on every launch of that cold step
    and timed (the profiler's kernel events of that step).  Returns (rows,
    report)."""
    from torch.profiler import ProfilerActivity, profile

    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    used = ["lin_y_sens", "sdf_fused_x3", "condense", "ip_phase"]
    _lib.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            Capture() as cap:
        out = acc.check_config3_accuracy(device=dev)
    counts = dict(_lib.launch_counts)
    launched_only("config 3", counts, used)
    ok = out["n_ok"] == out["n_scen"] == acc.CONFIG3_SCEN and (
        out["u0_max_err"] <= acc.CONTRACT_MAX)
    log(f"config 3 contract (render -> encode -> one cold step, B={out['n_scen']}) vs the f64 "
        f"oracle: u0 max {out['u0_max_err']:.4e} mean {out['u0_mean_err']:.4e}, "
        f"{out['n_ok']}/{out['n_scen']} status OK, <= {acc.CONTRACT_MAX}: "
        f"{'pass' if ok else 'FAIL'}; card {card}")
    if not ok:
        raise AssertionError("config 3: the contract failed")
    errs = check_all(cap, "config 3", sdf_route="sdf_fused_x3")
    calls = {name: cap.args("sdf" if name == "sdf_fused_x3" else name) for name in used}
    log(f"kernel numbers, config 3: the launches of that cold step, B={out['n_scen']}")
    rows = kernel_rows({k: fused_runs()[k] for k in used}, calls, counts, errs, peaks, part,
                       {"sdf_fused_x3": (3.0, TF32_PEAKS[part])},
                       device=profiled_kernel_ms(prof, used))
    return rows, out


def ring_frame(img, cfg):
    """A raw uint16 depth frame (sensor units) of a dmax-normalized range
    image: what a depth camera would send for it."""
    from sdf_nmpc_tpu_torch.perception.preprocessing import depth2range_map

    H, W = img.shape
    rm = depth2range_map(H, W, float(cfg.sensor.hfov), float(cfg.sensor.vfov))
    units = float(cfg.sensor.dmax) * 1000.0 / float(cfg.sensor.mm_resolution)
    return np.rint(img.cpu().numpy() / rm * units).astype(np.uint16)


def mission_tick(dev, card, enc, part, peaks) -> tuple:
    """Phase 18c: the image-fed MissionServer at B=1 around the port's Nmpc
    (default settings, fused path, the trained NeuralDF): each tick scene 0
    is rendered from the camera's pose, sent as a raw uint16 depth frame
    through the FrameRing (ClipDistance + Depth2Range in native code), and
    the tick reads the ring, encodes the frame (feed_image) and solves
    toward a waypoint past the blocking sphere.  Returns (rows of kernels
    1-4 timed on one more tick's launches, report)."""
    from torch.profiler import ProfilerActivity, profile

    from sdf_nmpc_tpu_torch.config import sensor_extrinsics
    from sdf_nmpc_tpu_torch.controller import Nmpc
    from sdf_nmpc_tpu_torch.math import quat2rot
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.perception import VaeRuntime
    from sdf_nmpc_tpu_torch.ref_gen import Waypoint
    from sdf_nmpc_tpu_torch.runtime import FrameRing, MissionServer
    from sdf_nmpc_tpu_torch.sim import render_range_image
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    cfg, ocp, _, _ = acc.build_setup(device=dev)
    nmpc = Nmpc(cfg, ocp=ocp)
    # the ring hands over dmax-normalized range images: the runtime's own
    # pipeline then only reshapes them
    vae = VaeRuntime(cfg.replace(sensor=dict(is_normalized=True, is_depth=False)), enc,
                     device=dev)
    enc_ms = []
    encode = vae.encode

    def timed_encode():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = encode()
        end.record()
        end.synchronize()
        enc_ms.append(start.elapsed_time(end))
        return out

    vae.encode = timed_encode
    server = MissionServer(cfg, nmpc, vae)
    # a depth camera sending uint16 millimetres (raw * mm_resolution / 1000 = metres)
    cam = cfg.replace(sensor=dict(mm_resolution=1.0))
    ring = FrameRing(cam)
    scene = acc._config3_scenes(1, dev)
    scene = type(scene)(*[a[0] for a in scene])
    B_p_C, B_R_C = (np.asarray(a, dtype=float) for a in sensor_extrinsics(cfg))
    H, W = (int(v) for v in cfg.sensor.shape_imgs[-2:])
    x = np.zeros(ocp.nx)
    x[3] = 1.0
    x[:3] = -B_p_C  # the camera at the origin, where the config-3 images are rendered
    t, dt = 0.0, float(cfg.mpc.control_loop_time) * 1e-3
    server.feed_state(x, t)
    server.set_flag(True)
    server.goto([Waypoint([3.5, 0.0, 0.0])])
    tick_ms, solve_ms, budgets, ring_err = [], [], [], 0.0

    def one_tick():
        nonlocal x, t, ring_err
        W_R_B = quat2rot(torch.as_tensor(x[3:7])).numpy()
        img = render_range_image(scene, torch.as_tensor(W_R_B @ B_p_C + x[:3], device=dev),
                                 torch.as_tensor(W_R_B @ B_R_C, dtype=torch.float32, device=dev),
                                 H, W, float(cfg.sensor.hfov), float(cfg.sensor.vfov),
                                 float(cfg.sensor.dmax))
        ring.push(ring_frame(img, cam), timestamp=t)  # the sensor's thread, outside the tick
        budgets.append(nmpc.budget)
        t0 = time.perf_counter()
        frame, ts, stale = ring.latest(timeout=float(cfg.mission.timeout_img), now=t)
        server.feed_state(x, t)
        server.feed_image(frame, x[:3], W_R_B, ts)
        tick = server.tick(t)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        solve_ms.append(nmpc.get_t() * 1e3)
        ring_err = max(ring_err, float(np.abs(frame - img.cpu().numpy()).max()))
        lo, hi = nmpc.cmd_TRPYr_min, nmpc.cmd_TRPYr_max
        if stale or not tick.flag_active or tick.fail_count or not (
                np.isfinite(tick.cmd).all() and (tick.cmd >= lo).all() and (tick.cmd <= hi).all()):
            raise AssertionError(f"mission tick at t={t:.3f}: stale {stale}, {tick}")
        x = nmpc.get_matrices()[0][1]  # the plant follows the prediction
        t += dt
        return tick

    _lib.reset_launch_counts()
    for _ in range(MISSION_TICKS):
        tick = one_tick()
    counts = dict(_lib.launch_counts)
    label = "MissionServer, image-fed, att, B=1, default settings"
    launched_only(label, counts, ["lin_y_sens", "sdf_fused_x3", "condense", "ip_phase"])
    if budgets[:5] != ["cold", "warm", "warm", "warm", "steady"] or set(budgets[5:]) != {"steady"}:
        raise AssertionError(f"{label}: budget promotion {budgets}")
    med = lambda a: (float(np.median(a[1:])), float(np.percentile(a[1:], 99)))
    rep = {"tick_ms": med(tick_ms), "encode_ms": med(enc_ms), "solve_ms": med(solve_ms),
           "first_tick_ms": tick_ms[0], "ring_max_err": ring_err,
           "distance_to_goal": float(np.linalg.norm(x[:3] - [3.5, 0.0, 0.0]))}
    log(f"{label}, {MISSION_TICKS} ticks (waypoint 3.5 m ahead past the blocking sphere, "
        f"frames through the FrameRing, max |ring frame - rendered| {ring_err:.2e}): mode "
        f"{tick.mode.value}, flag active, no failure, last cmd "
        f"{np.round(tick.cmd, 4).tolist()}, {rep['distance_to_goal']:.3f} m from the goal; "
        f"launches {({k: v for k, v in counts.items() if v})}")
    for name, (m, p99) in (("whole tick (host wall)", rep["tick_ms"]),
                           ("encode (CUDA events)", rep["encode_ms"]),
                           ("Nmpc.get_t()", rep["solve_ms"])):
        log(f"{label}: {name} over ticks 2-{MISSION_TICKS}: median {m:.3f} ms, p99 {p99:.3f} "
            f"ms; card {card}")
    # one more tick, profiled: kernels 1-4 timed on its launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            Capture() as cap:
        _lib.reset_launch_counts()
        one_tick()
        counts = dict(_lib.launch_counts)
    used = ["lin_y_sens", "sdf_fused_x3", "condense", "ip_phase"]
    calls = {name: cap.args("sdf" if name == "sdf_fused_x3" else name) for name in used}
    errs = check_all(cap, "mission tick", sdf_route="sdf_fused_x3")
    log(f"kernel numbers, {label}: the launches of one tick")
    rows = kernel_rows({k: fused_runs()[k] for k in used}, calls, counts, errs, peaks, part,
                       {"sdf_fused_x3": (3.0, TF32_PEAKS[part])},
                       device=profiled_kernel_ms(prof, used))
    return rows, rep


def encoder_throughput(dev, card, enc, imgs, peaks) -> dict:
    """Phase 18d: images/s of the encoder at ENCODER_B, each over
    ENCODER_CHAINED chained encodes after a warm-up, ended by one
    synchronize; peak memory per batch size; beside the bound of its
    ENCODER_GFLOP per image at the card's FP32 peak."""
    out = {}
    for B in ENCODER_B:
        x = imgs[torch.arange(B, device=dev) % imgs.shape[0]][:, None].contiguous()
        with torch.no_grad():
            enc(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            start.record()
            for _ in range(ENCODER_CHAINED):
                enc(x)
            end.record()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / ENCODER_CHAINED * 1e3
        ms = start.elapsed_time(end) / ENCODER_CHAINED
        bound_ms = B * ENCODER_GFLOP * 1e9 / peaks[0] * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[B] = {"ms": ms, "images_per_s": B / ms * 1e3, "bound_ms": bound_ms,
                  "peak_gib": peak}
        log(f"encoder throughput, B={B}: {ms:.4f} ms per encode (CUDA events; host wall "
            f"{wall:.4f}), {B / ms * 1e3:.1f} images/s, bound {bound_ms:.4f} ms at the FP32 "
            f"peak ({ms and bound_ms / ms:.1%}), peak memory {peak:.3f} GiB; card {card}")
    return out


def phase_perception(dev, card) -> dict:
    """Phase 18, BASELINE config 3 (``--perception`` runs phases 1, 2 and
    this one alone): the trained encoder on the card against the f64 CPU
    encoder, the config-3 contract with kernels 1-4 held and timed, the
    image-fed MissionServer tick at B=1, the encoder's throughput.  Returns
    the kernels' per-path rows and the report."""
    from sdf_nmpc_tpu_torch.config import default_config

    part, peaks = card_peaks(card.split(",")[0])
    cfg = default_config()
    enc, imgs, report = encoder_on_card(dev, card, cfg)
    rows, report["config3"] = config3_contract(dev, card, part, peaks)
    n = report["config3"]["n_scen"]
    per_path = {row["name"]: {f"config3, cold, B={n}": row} for row in rows}
    rows, report["mission"] = mission_tick(dev, card, enc, part, peaks)
    for row in rows:
        per_path[row["name"]]["config3, MissionServer tick, B=1"] = row
    report["encoder"] = encoder_throughput(dev, card, enc, imgs, peaks)
    log(json.dumps({"perception": report}))
    return {"per_path": per_path, "report": report}


def riccati_per_step(steps):
    """The Riccati backend (phase 19): kernels 1 and 2 once a step, no
    condensing and no QP kernel."""
    return {**{name: 0 for name in KERNELS}, "lin_y_sens": steps, "sdf_fused_x3": steps}


def cold_step_held(dev, card, label, cfg, ocp, inputs, used, checks):
    """One cold step on the card with the launch counts set to 0 just
    before: only ``used`` launched, every scenario OK and finite, each
    captured launch of the kernels in ``checks`` (name -> check function)
    held against its plain version; the first OTHER_SCEN scenarios against
    the port's f64 CPU step under the CI gate.  Returns (the step's
    result, the capture, the errors, the f64 reading)."""
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step

    B = inputs.x0.shape[0]
    _lib.reset_launch_counts()
    with Capture() as cap:
        res = make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
            init_state(ocp, inputs.x0), inputs)
    counts = dict(_lib.launch_counts)
    launched_only(label, counts, used)
    n_ok = int((res.status == 0).sum())
    if n_ok != B or not (torch.isfinite(res.state.X).all() and torch.isfinite(res.u0).all()):
        raise AssertionError(f"{label}: {n_ok}/{B} scenarios OK, or non-finite outputs")
    errs = {name: max(check(a) for a in cap.args("sdf" if name.startswith("sdf") else name))
            for name, check in checks.items()}
    return res, cap, counts, errs, against_f64_step(label, ocp, cfg, inputs, res, card)


def phase_long_horizon(dev, card) -> dict:
    """Phase 19, long horizons on the Riccati backend (``--long-horizon``
    runs phases 1, 2 and this one alone): (a) qp_backend riccati at N = 20
    on the 32 cold starts against the golden (max <= 1e-3, 32/32 OK, the
    JAX package's own contract), the warm and steady replays beside it; (b)
    att at N = LONG_N, B = MAIN_B, default settings ('auto' resolves to
    Riccati): one cold step with kernels 1 and 2 held on every launch and
    its first OTHER_SCEN scenarios against the f64 CPU step, then the main
    path as phase 6 and the kernels' numbers on a steady step; (c) props at
    N = LONG_N, one cold step at B = CHECK_B through kernel 9, held the
    same way; (d) Nmpc at B = 1 and N = LONG_N; (e) qp_backend condensed
    forced at N = CROSS_N beside Riccati at N = CROSS_N, B = MAIN_B."""
    from sdf_nmpc_tpu_torch.ops import _lib, lin_kernels
    from sdf_nmpc_tpu_torch.solver import resolve_qp_backend
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    part, peaks = card_peaks(card.split(",")[0])
    report, per_path = {}, {}
    lin_run, x3, _, _ = fused_runs().values()
    x3_rate = {"sdf_fused_x3": (3.0, TF32_PEAKS[part])}
    t0 = time.perf_counter()

    def took(what):
        log(f"phase 19 ({what}) done at {time.perf_counter() - t0:.1f} s")

    # (a) the contract at N = 20
    _lib.reset_launch_counts()
    cold = acc.check_accuracy(device=dev, solver_over=RIC)
    launched_only("riccati N=20, accuracy cold", dict(_lib.launch_counts),
                  ["lin_y_sens", "sdf_fused_x3"])
    warm = acc.check_warm_accuracy(device=dev, budget="warm", solver_over=RIC)
    steady = acc.check_warm_accuracy(device=dev, budget="steady", solver_over=RIC)
    g = acc.replay_gates(warm, steady)
    ok = cold["n_ok"] == cold["n_scen"] and cold["u0_max_err"] <= acc.CONTRACT_MAX
    log(f"accuracy riccati N=20 cold: u0 mean {cold['u0_mean_err']:.3e} max "
        f"{cold['u0_max_err']:.3e}, {cold['n_ok']}/{cold['n_scen']} status OK, contract max <= "
        f"{acc.CONTRACT_MAX}: {'pass' if ok else 'FAIL'}; card {card}")
    for name, mean, mx, n_ok, n in (("warm", g["warm_mean"], g["warm_max"], warm["n_ok"],
                                     warm["n_solves"]),
                                    ("steady", g["steady_mean"], g["steady_max"],
                                     steady["n_ok"], steady["n_solves"])):
        log(f"accuracy riccati N=20 {name} (not gated): u0 mean {mean:.3e} max {mx:.3e}, "
            f"{n_ok}/{n} status OK, CI gate {'pass' if acc.ci_gate_ok(mean, mx) else 'miss'}")
    report["riccati N=20"] = {"u0_max_err": cold["u0_max_err"], "u0_mean_err":
                              cold["u0_mean_err"], "u0_warm_max_err": g["warm_max"],
                              "u0_steady_max_err": g["steady_max"]}
    if not ok:
        raise AssertionError("accuracy riccati N=20: the contract failed")
    took("a")

    # (b) att at N = LONG_N: the cold step held, then the main path
    cfg, ocp, layout, _ = acc.build_setup(device=dev, N=LONG_N)
    if resolve_qp_backend(cfg, ocp.N) != "riccati":
        raise AssertionError(f"N={ocp.N}: qp_backend auto did not resolve to riccati")
    label = f"att riccati N={LONG_N}"
    inputs = bench_inputs(ocp, cfg, layout, MAIN_B, SEED, dev)
    log(f"{label} (T = {cfg.mpc.T:g} s, auto -> riccati): one cold step, B={MAIN_B}")
    *_, errs, report[f"{label}, cold vs f64"] = cold_step_held(
        dev, card, label, cfg, ocp, inputs, ["lin_y_sens", "sdf_fused_x3"],
        {"lin_y_sens": check_lin, "sdf_fused_x3": lambda a: check_sdf(a, "sdf_fused_x3")})
    del inputs
    counts, t_step, steady_fn, state, inputs = phase_main_path(
        dev, card, per_step=riccati_per_step, label=label, N=LONG_N, synced=False)
    phase_profile(steady_fn, state, inputs, t_step, card, label=label, steps=1)
    with Capture() as cap:
        steady_fn(state, inputs)
    log(f"kernel numbers, {label}: inputs of one steady step at B={MAIN_B}")
    calls = {"lin_y_sens": cap.args("lin_y_sens"), "sdf_fused_x3": cap.args("sdf")}
    for row in kernel_rows({"lin_y_sens": lin_run, "sdf_fused_x3": x3}, calls, counts, errs,
                           peaks, part, x3_rate):
        row.update(B=MAIN_B, N=LONG_N, t_step_ms=t_step * 1e3,
                   points=int(calls["lin_y_sens"][0][2].shape[0]))
        per_path.setdefault(row["name"], {})[f"{label}, steady, B={MAIN_B}"] = row
    report[f"{label} main path"] = {"ms_per_step": t_step * 1e3,
                                    "solves_per_s": MAIN_B / t_step}
    del cap, steady_fn, state, inputs
    took("b")

    # (c) props at N = LONG_N through kernel 9
    cfg, ocp, layout, lat = acc.build_setup(device=dev, model="props", N=LONG_N)
    label = f"props riccati N={LONG_N}"
    inputs = tiled_inputs(ocp, cfg, layout, lat, CHECK_B, SEED, dev)
    log(f"{label}: one cold step, B={CHECK_B} jittered accuracy scenarios")
    _, cap, counts, errs, report[f"{label}, cold vs f64"] = cold_step_held(
        dev, card, label, cfg, ocp, inputs, ["erk4_sens", "sdf_fused_x3"],
        {"erk4_sens": check_erk4, "sdf_fused_x3": lambda a: check_sdf(a, "sdf_fused_x3")})
    erk4_run = (lin_kernels.erk4_sens, lambda a: lin_kernels.erk4_sens_plain(*a), erk4_cost,
                None)
    for row in kernel_rows({"erk4_sens": erk4_run, "sdf_fused_x3": x3},
                           {"erk4_sens": cap.args("erk4_sens"), "sdf_fused_x3": cap.args("sdf")},
                           counts, errs, peaks, part, x3_rate):
        row.update(B=CHECK_B, N=LONG_N)
        per_path.setdefault(row["name"], {})[f"{label}, cold, B={CHECK_B}"] = row
    del cap, inputs
    took("c")

    # (d) the controller at B = 1
    report[f"Nmpc N={LONG_N}"] = phase_nmpc(dev, card, ticks=NMPC_TICKS_LONG, over=None,
                                            N=LONG_N)
    took("d")

    # (e) the crossover at N = CROSS_N
    for name, over, per_step in (("condensed (forced)", {"qp_backend": "condensed"},
                                  fused_per_step), ("riccati (auto)", None, riccati_per_step)):
        label = f"att N={CROSS_N}, {name}"
        try:
            counts, t_step, steady_fn, state, inputs = phase_main_path(
                dev, card, over=over, per_step=per_step, label=label, N=CROSS_N,
                n_steady=CROSS_STEADY, synced=False)
        except (ValueError, NotImplementedError) as e:  # a kernel refusing the shapes
            log(f"{label}: refused: {e}")
            report[label] = {"refused": str(e)}
            continue
        report[label] = {"ms_per_step": t_step * 1e3, "solves_per_s": MAIN_B / t_step}
        del steady_fn, state, inputs
    took("e")
    log(json.dumps({"long_horizon": report}))
    return {"per_path": per_path, "report": report}


def sphere_setup(dev, dtype=torch.float32):
    """tests/test_sim.py's avoid setup on ``dev``: (cfg, ocp, scene, the
    world-frame clearance p -> sdf), the scene oracle as the SDF row."""
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.sim import Scene, make_scene_sdf_fn, scene_sdf

    cfg = default_config().replace(nn=dict(size_latent=8),
                                   solver=dict(qp_iters=10, dtype=str(dtype).split(".")[-1]))
    scene = Scene.make(spheres=[SPHERE], device=dev).to(dtype)
    ocp = build_ocp(cfg, sdf=make_scene_sdf_fn(scene, max_df=1.0), sdf_max_df=1.0, device=dev)
    return cfg, ocp, scene, lambda p: scene_sdf(scene, p)


def sphere_inputs(cfg, ocp, x0s, flag, dtype=torch.float32):
    """tests/test_sdf_nmpc.py's build_inputs per start (x0s (B, nx)): the
    camera at the origin, goal (2, 0, 0) with the unconstrained weights."""
    from sdf_nmpc_tpu_torch.ref_gen import Ref
    from sdf_nmpc_tpu_torch.solver import SolveInputs

    B, N = x0s.shape[0], ocp.N
    p = np.zeros((B, N + 1, ocp.layout.np_total))
    ocp.layout.set_flag(p, flag)
    ocp.layout.set_camera(p, np.zeros(3), np.eye(3))
    ocp.layout.set_q_d(p, [1, 0, 0, 0])
    ref = Ref(cfg).use_constrained_weights(False)
    ref.p = np.array([2.0, 0.0, 0.0])
    yr, W = ocp.pack_ref(ref)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=ocp.device)
    return SolveInputs(x0=T(x0s), yref=T(np.tile(yr, (B, N, 1))), W=T(np.tile(W, (B, N, 1))),
                       yrefN=T(np.tile(yr[:ocp.nyN], (B, 1))),
                       WN=T(np.tile(W[:ocp.nyN], (B, 1))), p=T(p))


def hover(B):
    x = np.zeros((B, 10))
    x[:, 3] = 1.0
    return x


def timed_rollout(rollout, *args):
    """(result, ms per tick's wall time over the whole rollout, launches)."""
    from sdf_nmpc_tpu_torch.ops import _lib

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = rollout(*args)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3 / res.us.shape[1], dict(_lib.launch_counts)


def phase_closed_loop(dev, card) -> dict:
    """Phase 20, the closed loop (``--closed-loop`` runs phases 1, 2 and
    this one alone): tests/test_sim.py's sphere scene in f32 on the card,
    make_closed_loop at B = 1 over LOOP_TICKS ticks held by that file's
    outcome rules (every status OK, min clearance > 0, tracking error <
    0.35, lateral excursion > 0.15), the flag off colliding, a Monte Carlo
    of MC_B starts over MC_TICKS ticks (success 1.0, collision 0); then
    perception in the loop at full width: config 3's 8 scenes, each chunk
    rendered at 270 x 480 from the current pose and encoded by the trained
    encoder, with the trained NeuralDF, PERC_CHUNKS x PERC_TICKS ticks."""
    from sdf_nmpc_tpu_torch.math import quat2rot
    from sdf_nmpc_tpu_torch.sim import (
        make_closed_loop,
        make_closed_loop_perception,
        render_range_image,
        scene_sdf,
        summarize,
    )
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    report, per_path = {}, {}
    loop_kernels = ["lin_y_sens", "condense", "ip_phase"]  # the oracle row: no kernel 2
    cfg, ocp, scene, world = sphere_setup(dev)
    rollout = make_closed_loop(ocp, cfg, n_ticks=LOOP_TICKS, scene_sdf_fn=world)
    for flag in (1.0, 0.0):
        label = f"closed loop, sphere scene, flag {flag:g}, B=1, {LOOP_TICKS} ticks"
        res, ms, counts = timed_rollout(rollout, torch.as_tensor(hover(1), device=dev),
                                        sphere_inputs(cfg, ocp, hover(1), flag))
        launched_only(label, counts, loop_kernels)
        r = {"min_clearance": float(res.min_clearance[0]),
             "tracking_error": float(res.tracking_error[0]),
             "lateral_max": float(res.xs[0, :, 1].abs().max()),
             "n_fail": int((res.statuses != 0).sum()), "ms_per_tick": ms}
        log(f"{label}: {r}; card {card}")
        report[label] = r
        ok = (r["n_fail"] == 0 and r["min_clearance"] > 0 and r["tracking_error"] < 0.35
              and r["lateral_max"] > 0.15) if flag else r["min_clearance"] < 0
        if not (ok and torch.isfinite(res.xs).all()):
            raise AssertionError(f"{label}: the outcome rules of tests/test_sim.py failed")

    x0s = hover(MC_B)
    x0s[:, 1] += np.random.default_rng(SEED).uniform(-0.3, 0.3, MC_B)
    inputs = sphere_inputs(cfg, ocp, x0s, 1.0)
    label = f"closed loop Monte Carlo, B={MC_B}, {MC_TICKS} ticks"
    with Capture() as cap:  # the loop's kernels held on one tick's launches
        make_rti_step(ocp, cfg, with_evals=False)(init_state(ocp, inputs.x0), inputs)
    check_all(cap, "closed loop tick")
    res, ms, counts = timed_rollout(make_closed_loop(ocp, cfg, n_ticks=MC_TICKS,
                                                     scene_sdf_fn=world), inputs.x0, inputs)
    launched_only(label, counts, loop_kernels)
    stats = summarize(res)
    log(f"{label}: {stats}, {ms:.3f} ms per tick; card {card}")
    report[label] = {**stats, "ms_per_tick": ms}
    for name in loop_kernels:
        per_path.setdefault(name, {})[label] = {"launches": counts[name], "ms_per_tick": ms}
    if stats["success_rate"] != 1.0 or stats["collision_rate"] != 0.0:
        raise AssertionError(f"{label}: success {stats['success_rate']}, collision "
                             f"{stats['collision_rate']}")
    del res, inputs, cap

    # perception in the loop: render -> encode -> solve -> plant
    cfg, ocp, layout, _ = acc.build_setup(device=dev)
    n = acc.CONFIG3_SCEN
    enc = acc.config3_encoder(cfg, torch.float32, dev)
    scenes = acc._config3_scenes(n, dev)
    inputs, _ = acc.config3_inputs(cfg, ocp, layout, n, torch.float32, dev)
    H, W = (int(v) for v in cfg.sensor.shape_imgs[-2:])
    split = {"render": 0.0, "encode": 0.0}

    def observe(x, sc):
        """The camera at the body, its attitude; the trained encoder's latent."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R = quat2rot(x[:, 3:7] / torch.linalg.vector_norm(x[:, 3:7], dim=-1, keepdim=True))
        imgs = torch.stack([render_range_image(
            type(sc)(*[a[b] for a in sc]), x[b, :3], R[b], H, W, float(cfg.sensor.hfov),
            float(cfg.sensor.vfov), float(cfg.sensor.dmax)) for b in range(x.shape[0])])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            latent = enc(imgs[:, None])
        torch.cuda.synchronize()
        split["render"] += t1 - t0
        split["encode"] += time.perf_counter() - t1
        return x[:, :3], R, latent

    label = f"perception in the loop, config 3's {n} scenes, {PERC_CHUNKS} x {PERC_TICKS} ticks"
    res, ms, counts = timed_rollout(make_closed_loop_perception(
        ocp, cfg, n_chunks=PERC_CHUNKS, ticks_per_chunk=PERC_TICKS, observe_fn=observe,
        scene_sdf_fn=lambda p, sc: scene_sdf(sc, p)), inputs.x0, inputs, scenes)
    launched_only(label, counts, loop_kernels + ["sdf_fused_x3"])
    stats = summarize(res)
    chunk = ms * PERC_TICKS
    render, encode = (split[k] * 1e3 / PERC_CHUNKS for k in ("render", "encode"))
    clear = [round(float(c), 4) for c in res.min_clearance]
    log(f"{label}: {stats}; min clearance per scene {clear}; per chunk {chunk:.3f} ms: render "
        f"{render:.3f}, encode {encode:.3f}, solve {chunk - render - encode:.3f} ms; card {card}")
    report[label] = {**stats, "min_clearance": clear, "ms_per_chunk": chunk,
                     "render_ms": render, "encode_ms": encode,
                     "solve_ms": chunk - render - encode}
    for name in loop_kernels + ["sdf_fused_x3"]:
        per_path.setdefault(name, {})[label] = {"launches": counts[name], "ms_per_tick": ms}
    if int((res.statuses != 0).sum()) or not torch.isfinite(res.xs).all():
        raise AssertionError(f"{label}: statuses {res.statuses.unique().tolist()}, or "
                             "non-finite states")
    log(json.dumps({"closed_loop": report}))
    return {"per_path": per_path, "report": report}


def phase_solver_routes(dev, card) -> dict:
    """Phase 21, the solver routes (``--solver-routes`` runs phases 1, 2
    and this one alone): one cold att step at B = CHECK_B on the 32
    accuracy scenarios repeated under each of ROUTE_CHECKS, its u0 against
    the golden and its launches, each route launching what its JAX route
    implies; the exact routes held to the CI gate, qp_data_bf16 (the JAX
    package read 7.7e-3, docs/performance.md:705-721) finite and OK."""
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    report = {}
    ref = np.load(acc.REF_NPZ)["u0"]
    reps = CHECK_B // acc.N_SCEN
    for label, (over, used, gated) in ROUTE_CHECKS.items():
        cfg, ocp, layout, lat = acc.build_setup(device=dev, solver_over=over)
        inputs = acc.scenario_inputs(ocp, acc.build_scenarios(cfg, ocp, layout, lat),
                                     torch.float32, dev, reps=reps)
        _lib.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
            init_state(ocp, inputs.x0), inputs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched_only(f"route {label}", dict(_lib.launch_counts), list(used))
        err = np.abs(res.u0.double().cpu().numpy() - np.repeat(ref, reps, 0)).max(1)
        n_ok = int((res.status == 0).sum())
        ok = n_ok == CHECK_B and np.isfinite(err).all()
        gate = acc.ci_gate_ok(err.mean(), err.max())
        log(f"route {label}: one cold step, B={CHECK_B}, {ms:.1f} ms; u0 vs golden mean "
            f"{err.mean():.3e} max {err.max():.3e}, {n_ok}/{CHECK_B} status OK, CI gate "
            f"{'pass' if gate else 'miss'}{'' if gated else ' (not gated)'}, strict <= "
            f"{acc.CONTRACT_MAX}: {'pass' if err.max() <= acc.CONTRACT_MAX else 'miss'}; card "
            f"{card}")
        report[label] = {"u0_max_err": float(err.max()), "u0_mean_err": float(err.mean()),
                         "ms": ms, "launches": {k: v for k, v in _lib.launch_counts.items() if v}}
        if not ok or (gated and not gate):
            raise AssertionError(f"route {label}: {n_ok}/{CHECK_B} OK, u0 max {err.max()}")
    log(json.dumps({"solver_routes": report}))
    return {"report": report}


# ------------------------------------------------------------ phase 22


TRAIN_SCENES = 100  # rendered 270 x 480 scenes of phase 22
TRAIN_SPHERES = 8  # random spheres per scene, beside a floor
GT_IMGS, GT_PER_IMG = 50, 2500  # one DfTrainConfig batch: 125,000 points
GT_CHECK = 2000  # seeded points held against the f64 CPU search
# an f32 label may differ from the f64 one only where a decision of the
# check lies within these of its boundary (f32 rounding of ranges up to
# dmax = 5 m is ~6e-7 m, of a pixel coordinate ~3e-5 px, of an angle ~1e-7)
F32_MARGIN = {"metres": 1e-5, "pixels": 2e-4, "radians": 1e-5}
# where the f32 and f64 searches find the same voxel: the value is one
# voxel distance (the clamp's -0.3 is 1.2e-8 apart in f32), the gradient
# its unit offset normalized in f32
GT_VALUE_TOL, GT_GRAD_TOL = 1e-7, 1e-6
VAE_IMGS, VAE_EPOCHS = 32, 2  # 22b: 2 epochs of 2 steps at batch 16
DF_EPOCHS = 2  # 22c: 2 epochs of 2 steps (100 images, batch 50)
CHECK_POINTS = 5000  # 22c's card-vs-f64 step
# card f32 against CPU f64 on one training forward and backward: loss parts
# relatively, each parameter's gradient by its relative L2 error, the
# running statistics against 1 + |value|.  The VAE's gradient bound: cuDNN's
# f32 sums put them 1.2e-3 to 4.3e-3 from f64 on an H100 (the CPU's f32
# 2.5-6x nearer, printed beside; 6e-3 on the CPU at 30 x 50), batch norm
# over 2 images amplifying; a wrong gradient reads O(1).  The NeuralDF's
# read 1.8e-6.
TRAIN_LOSS_RTOL, TRAIN_STATS_TOL = 1e-4, 1e-4
VAE_GRAD_RTOL, DF_GRAD_RTOL = 2e-2, 1e-4
SERVE_B = 1024  # 22d's cold step
# 22d: the few-steps-old network leaves kernel 4's stiff-phase iterates
# ill-determined in f32: kernel and plain version each lie beyond 1e-4 of
# f64 on 13-34% of the 1024 scenarios and beyond 1e-4 of each other on as
# many, so whether the kernel's share exceeds the plain version's by
# QP_RULE's 2% is a coin toss (-0.3% to +2.5% over repeated runs on an H100,
# whose trained nets differ by cuDNN's nondeterministic sums).  Held there
# with 3 binomial sigmas of two independent shares allowed on top.
ILL_SHARE_SIGMAS = 3.0


def training_scenes(n, dev):
    """n seeded scenes: TRAIN_SPHERES spheres in the frustum ahead and a
    floor 1.2 m below the camera."""
    from sdf_nmpc_tpu_torch.sim.scenes import Scene

    rng = np.random.default_rng(SEED + 22)
    return Scene.stack([Scene.make(
        spheres=[(rng.uniform([1.0, -2.5, -1.0], [5.5, 2.5, 1.0]), rng.uniform(0.2, 0.8))
                 for _ in range(TRAIN_SPHERES)],
        boxes=[([-9.0, -9.0, -9.0], [9.0, 9.0, -1.2])], device=dev) for _ in range(n)])


class PartTimer:
    """CUDA events around each named part of a training step; ``ms(name)``
    the mean over the steps after the first (its cuDNN and allocator warm-up)."""

    def __init__(self):
        self.events = {}

    def __call__(self, name):
        import contextlib

        @contextlib.contextmanager
        def part():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.events.setdefault(name, []).append((start, end))

        return part()

    def ms(self, name):
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) for s, e in self.events.get(name, [])]
        return float(np.mean(times[1:] if len(times) > 1 else times)) if times else 0.0

    def steps(self, name):
        return len(self.events.get(name, []))


def peak_gib(fn):
    """(fn(), the peak device memory of the call in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def gt_engine(dev, card, cfg) -> dict:
    """Phase 22a: the 100 scenes rendered on the card, one DfTrainConfig
    batch (50 images x 2,500 points) labelled by ColChecker and signed
    DfComputer (timed, peak memory), a seeded 2,000 of its points held
    against the f64 CPU search under F32_MARGIN."""
    from sdf_nmpc_tpu_torch.data import ColChecker, DfComputer, PosSampler
    from sdf_nmpc_tpu_torch.data.collision import check_image_points_impl
    from sdf_nmpc_tpu_torch.data.df_computer import sdf_from_search
    from sdf_nmpc_tpu_torch.sim import render_range_image
    from sdf_nmpc_tpu_torch.training.df import DfTrainConfig, sample_points

    H, W = (int(v) for v in cfg.sensor.shape_imgs[-2:])
    hfov, vfov, dmax = float(cfg.sensor.hfov), float(cfg.sensor.vfov), float(cfg.sensor.dmax)
    scenes = training_scenes(TRAIN_SCENES, dev)
    render = lambda: render_range_image(scenes, torch.zeros(3, device=dev),
                                        torch.eye(3, device=dev), H, W, hfov, vfov, dmax)
    render_ms = cuda_ms(render, reps=1)
    imgs = render()
    tcfg = DfTrainConfig(batch_size=GT_IMGS, points_per_img=GT_PER_IMG)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sampler = PosSampler(dmax, hfov, vfov, margin=40, device=dev)
    batch = imgs[:GT_IMGS]
    pts = sample_points(gen, sampler, batch, tcfg.point_counts(), tcfg.close_ball_size)
    cc = ColChecker(dmax, hfov, vfov, 0.0, outside="extrapolate", device=dev)
    dfc = DfComputer(True, dmax, hfov, vfov, tcfg.max_df, device=dev)
    p2i = torch.arange(GT_IMGS, device=dev).repeat_interleave(GT_PER_IMG)
    col_ms = cuda_ms(lambda: cc.check_image_points(batch, pts), reps=3)
    sdf_ms = cuda_ms(lambda: dfc.get_df(batch, pts), reps=2)
    (occ, md, am), peak = peak_gib(lambda: dfc.search(batch, pts, p2i))
    sdf, grad = sdf_from_search(occ, md, am, dfc.grid, dfc.min_df, dfc.max_df)
    log(f"22a GT engine: {TRAIN_SCENES} scenes rendered at {H} x {W} in {render_ms:.1f} ms; one "
        f"batch of {GT_IMGS} images x {GT_PER_IMG} points ({pts.shape[0]} points, K = "
        f"{dfc.grid.shape[0]} offsets, chunks of {dfc.batch_size}): ColChecker {col_ms:.3f} ms, "
        f"signed DfComputer {sdf_ms:.1f} ms, peak {peak:.2f} GiB; {int(occ.sum())} occupied, "
        f"{int((sdf == tcfg.max_df).sum())} saturated at max_df; card {card}")

    # the f64 CPU search on a seeded subset
    sel = torch.as_tensor(np.sort(np.random.default_rng(SEED).choice(
        pts.shape[0], GT_CHECK, replace=False)), device=dev)
    cpu = torch.device("cpu")
    imgs64, pts64, p2i64 = batch.double().cpu(), pts[sel].double().cpu(), p2i[sel].cpu()
    dfc64 = DfComputer(True, dmax, hfov, vfov, tcfg.max_df, device=cpu, dtype=torch.float64)
    t0 = time.perf_counter()
    occ64, md64, am64 = dfc64.search(imgs64, pts64, p2i64)
    cpu_s = time.perf_counter() - t0
    sdf64, grad64 = sdf_from_search(occ64, md64, am64, dfc64.grid, dfc64.min_df, dfc64.max_df)
    geo = dict(dfc64.colcheck.geometry)

    def near_boundary(points, idx):
        m = ColChecker(dmax, hfov, vfov, 0.0, outside="extrapolate", device=cpu,
                       dtype=torch.float64).label_margins(imgs64, points, idx)
        return (m["metres"] <= F32_MARGIN["metres"]) | (m["pixels"] <= F32_MARGIN["pixels"]) | (
            m["radians"] <= F32_MARGIN["radians"])

    occ32, am32 = occ[sel].cpu(), am[sel].cpu()
    flip = occ32 != occ64
    bad_flip = int((flip & ~near_boundary(pts64, p2i64)).sum())
    same = ~flip & (am32 == am64)
    moved = torch.nonzero(~flip & (am32 != am64)).flatten()
    unexplained = 0
    grid64, grid32 = dfc64.grid, dfc.grid
    for i in moved.tolist():  # a voxel's label flipped: each flip within the margin
        vox64 = pts64[i] + grid64
        lab64 = check_image_points_impl(imgs64, vox64, p2i64[i], **geo)
        lab32 = check_image_points_impl(batch, pts[sel[i]] + grid32, p2i[sel[i]],
                                        **dict(dfc.colcheck.geometry)).cpu()
        differ = lab64 != lab32
        if not differ.any() or not bool(near_boundary(vox64[differ], p2i64[i]).all()):
            unexplained += 1
    dv = float((sdf[sel].cpu().double() - sdf64)[same].abs().max())
    dg = float((grad[sel].cpu().double() - grad64)[same].abs().max())
    report = {"points": int(pts.shape[0]), "render_ms_100": render_ms, "colcheck_ms": col_ms,
              "sdf_ms": sdf_ms, "peak_gib": peak, "checked": GT_CHECK,
              "label_flips": int(flip.sum()), "voxel_flips": int(moved.numel()),
              "value_err": dv, "grad_err": dg, "cpu_f64_s": cpu_s}
    log(f"22a GT engine vs the f64 CPU search on {GT_CHECK} seeded points ({cpu_s:.1f} s): "
        f"rule: a label may differ only where a decision lies within {F32_MARGIN} of its "
        f"boundary; {int(flip.sum())} point labels differ ({bad_flip} beyond the rule), "
        f"{moved.numel()} points find another voxel ({unexplained} without a voxel label "
        f"flip within the rule); on the other {int(same.sum())}: value max |d| {dv:.2e} (tol "
        f"{GT_VALUE_TOL}), gradient {dg:.2e} (tol {GT_GRAD_TOL}); card {card}")
    if bad_flip or unexplained or not (dv <= GT_VALUE_TOL and dg <= GT_GRAD_TOL):
        raise AssertionError("22a: the card's GT labels disagree with the f64 search")
    return imgs, report


def held_train_step(label, card, out, grad_rtol) -> dict:
    """One training forward and backward on the card against f64 on the
    CPU (``out``: 'card', 'f32' (the CPU in f32) and 'f64', each (loss
    parts, gradients by name, running statistics by name)): loss parts
    within TRAIN_LOSS_RTOL, each gradient's relative L2 error within
    ``grad_rtol`` (the CPU f32 one's printed beside), running statistics
    within TRAIN_STATS_TOL (1 + |v|)."""
    (l32, g32, s32), (_, gf, _), (l64, g64, s64) = out["card"], out["f32"], out["f64"]
    lerr = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30) for a, b in zip(l32, l64))
    rel = lambda g, name: float((g[name].double().cpu() - g64[name]).norm()) / max(
        float(g64[name].norm()), 1e-30)
    worst = max(((rel(g32, n), rel(gf, n), n) for n in g64))
    serr = max([float(((s32[n].double().cpu() - v).abs() / (1 + v.abs())).max())
                for n, v in s64.items()] or [0.0])
    log(f"{label}: card f32 vs CPU f64, one forward and backward: loss parts rel {lerr:.2e} "
        f"(tol {TRAIN_LOSS_RTOL}); gradients' relative L2 error per tensor, worst {worst[2]}: "
        f"card {worst[0]:.2e} (tol {grad_rtol}), CPU f32 {worst[1]:.2e}; "
        + (f"running statistics {serr:.2e} of 1 + |v| (tol {TRAIN_STATS_TOL}); " if s64 else "")
        + f"card {card}")
    if not (lerr <= TRAIN_LOSS_RTOL and worst[0] <= grad_rtol and serr <= TRAIN_STATS_TOL):
        raise AssertionError(f"{label}: the card's training step disagrees with f64")
    return {"loss_rel_err": lerr, "grad_worst": worst[2], "grad_l2_rel_err": worst[0],
            "grad_l2_rel_err_cpu_f32": worst[1], "stats_err": serr if s64 else None}


def train_vae_on_card(dev, card, imgs, workdir) -> tuple:
    """Phase 22b: train_vae at the reference's sizes (latent 128, 270 x 480,
    batch norm, dropout 0.1, batch 16) with the VAE augmenter and the
    erosion label map, over VAE_IMGS rendered images in memory: VAE_EPOCHS
    epochs, then a resume from epoch 0's checkpoint; then one step held
    against f64 on the CPU (batch 2, dropout and augmentation off).
    Returns (the trained Vae, report)."""
    import copy

    from sdf_nmpc_tpu_torch.data.augment import ImageAugmenter
    from sdf_nmpc_tpu_torch.data.h5 import ImageDataset
    from sdf_nmpc_tpu_torch.nn import Dropout
    from sdf_nmpc_tpu_torch.perception.preprocessing import disk_kernel, erode
    from sdf_nmpc_tpu_torch.training import VaeTrainConfig, train_vae
    from sdf_nmpc_tpu_torch.training.vae import vae_losses

    H, W = imgs.shape[-2:]
    data = imgs[:VAE_IMGS, None]
    kernel = disk_kernel(10)
    ds = ImageDataset(data, range(VAE_IMGS), lambda x: x,
                      ImageAugmenter((1, H, W), noise=True, flip=True, translate=True, rotate=True,
                                     erase=True, outlier_rm=True),
                      lambda img: erode(img, kernel, ignore_zeros=True), seed=SEED, device=dev)
    meta = {"shape_imgs": [1, H, W]}
    vcfg = VaeTrainConfig(nb_epochs=VAE_EPOCHS)
    timer = PartTimer()
    (vae, hist), peak = peak_gib(lambda: train_vae(ds, None, meta, workdir, cfg=vcfg,
                                                   log_fn=log, device=dev, timer=timer))
    step_ms = timer.ms("step")
    n_steps = timer.steps("step")
    (_, hist2) = train_vae(ds, None, meta, workdir, cfg=vcfg, restart_from_epoch=1,
                           log_fn=log, device=dev)
    if not (hist2[0]["epoch"] == 1 and hist2[0]["lr"] == float(vcfg.lr_at_epoch(1))
            and all(np.isfinite(h["train"]).all() for h in hist + hist2)):
        raise AssertionError("22b: train_vae's resume or losses are off")
    log(f"22b VAE: train_vae at latent {vcfg.size_latent}, {H} x {W}, batch norm, dropout "
        f"{vcfg.dropout_rate}, batch {vcfg.batch_size}, augmenter and erosion labels on, "
        f"{VAE_IMGS} images: {n_steps} steps in {VAE_EPOCHS} epochs, {step_ms:.1f} ms per step "
        f"after the first ({vcfg.batch_size / step_ms * 1e3:.1f} images/s), peak {peak:.2f} GiB; "
        f"losses by epoch {[h['train'] for h in hist]}, resumed at epoch {hist2[0]['epoch']} "
        f"(lr {hist2[0]['lr']:.3e}) {hist2[0]['train']}; card {card}")

    # one step, card f32 against CPU f64: same parameters, images and eps
    x = imgs[VAE_IMGS:VAE_IMGS + 2, None]
    eps = torch.randn((2, vcfg.size_latent), generator=torch.Generator().manual_seed(SEED),
                      dtype=torch.float64)
    out = {}
    for key, device, dtype in (("card", dev, torch.float32), ("f32", torch.device("cpu"),
                                                               torch.float32),
                               ("f64", torch.device("cpu"), torch.float64)):
        m = copy.deepcopy(vae).to(device=device, dtype=dtype)
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.rate = 0.0
        m.train()
        xi = x.to(device=device, dtype=dtype)
        _, l_reg, l_kld = vae_losses(m, xi, xi, vcfg, eps=eps.to(device=device, dtype=dtype))
        (l_reg + l_kld).backward()
        out[key] = ((l_reg.detach(), l_kld.detach()),
                    {n: p.grad for n, p in m.named_parameters()},
                    {n: b for n, b in m.named_buffers() if "running" in n})
    check = held_train_step("22b VAE step", card, out, VAE_GRAD_RTOL)
    return vae, {"step_ms": step_ms, "images_per_s": vcfg.batch_size / step_ms * 1e3,
                 "steps": n_steps, "peak_gib": peak, "history": hist, "resumed": hist2,
                 "check": check}


def train_df_on_card(dev, card, cfg, imgs, encoder, workdir) -> tuple:
    """Phase 22c: train_df at the reference's sizes (4 x 256, latent 128,
    res full, embed oct, sin w0 20, dropout 0.1, batch 50 x 2,500 points,
    weights (50, 0, 1/60, 5)) against 22b's frozen encoder over the 100
    images: DF_EPOCHS epochs, then a resume; each step timed by part; then
    one step on CHECK_POINTS points, dropout off, against f64 on the CPU.
    Returns (the trained NeuralDF, report)."""
    import copy

    from sdf_nmpc_tpu_torch.data import DfComputer, PosSampler
    from sdf_nmpc_tpu_torch.data.augment import ImageAugmenter
    from sdf_nmpc_tpu_torch.data.h5 import ImageDataset
    from sdf_nmpc_tpu_torch.training import DfTrainConfig, train_df
    from sdf_nmpc_tpu_torch.training.df import df_loss, encode_latents, sample_points

    H, W = imgs.shape[-2:]
    hfov, vfov = float(cfg.sensor.hfov), float(cfg.sensor.vfov)
    ds = ImageDataset(imgs[:, None], range(imgs.shape[0]), lambda x: x,
                      ImageAugmenter((1, H, W), noise=True, flip=True, translate=True,
                                     erase=True), seed=SEED, device=dev)
    meta = {"hfov": hfov, "vfov": vfov, "is_depth": False, "is_spherical": False,
            "shape_imgs": [1, H, W]}
    dcfg = DfTrainConfig(nb_epochs=DF_EPOCHS)
    nn_kw = {"layer_sizes": (256, 256, 256, 256)}
    timer = PartTimer()
    (net, hist), peak = peak_gib(lambda: train_df(ds, None, meta, encoder, workdir, cfg=dcfg,
                                                  nn_kwargs=nn_kw, log_fn=log, device=dev,
                                                  timer=timer))
    parts = {k: timer.ms(k) for k in ("encode", "sampling", "gt", "loss", "update")}
    _, hist2 = train_df(ds, None, meta, encoder, workdir, cfg=dcfg, nn_kwargs=nn_kw,
                        restart_from_epoch=1, log_fn=log, device=dev)
    if not (hist2[0]["epoch"] == 1 and hist2[0]["lr"] == float(dcfg.lr_at_epoch(1))
            and all(np.isfinite(h["train"]).all() for h in hist + hist2)):
        raise AssertionError("22c: train_df's resume or losses are off")
    log(f"22c NeuralDF: train_df at 4 x 256, latent 128, res full, embed oct, sin w0 20, "
        f"dropout 0.1, batch {dcfg.batch_size} x {dcfg.points_per_img} points, weights "
        f"{tuple(round(w, 4) for w in dcfg.loss_weights)}, {imgs.shape[0]} images: "
        f"{timer.steps('loss')} steps, ms per step after the first by part {parts} (sum "
        f"{sum(parts.values()):.1f}), peak {peak:.2f} GiB; losses by epoch "
        f"{[h['train'] for h in hist]}, resumed at epoch {hist2[0]['epoch']} "
        f"{hist2[0]['train']}; card {card}")

    # one step on CHECK_POINTS points of two images, dropout off, against f64
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    two = imgs[:2]
    sampler = PosSampler(dcfg.dmax, hfov, vfov, margin=40, device=dev)
    states = sample_points(gen, sampler, two, dcfg.point_counts(), dcfg.close_ball_size)
    latents = encode_latents(encoder, two[:, None], dcfg.points_per_img, gen)
    gt, ggt = DfComputer(True, dcfg.dmax, hfov, vfov, 1.0, device=dev).get_df(two, states)
    out = {}
    for key, device, dtype in (("card", dev, torch.float32), ("f32", torch.device("cpu"),
                                                               torch.float32),
                               ("f64", torch.device("cpu"), torch.float64)):
        m = copy.deepcopy(net).to(device=device, dtype=dtype).train()
        m.dropout_rate = 0.0
        args = [t[:CHECK_POINTS].to(device=device, dtype=dtype) for t in (states, latents, gt, ggt)]
        total, lparts = df_loss(m, *args, dcfg.loss_weights)
        total.backward()
        out[key] = (lparts.detach(), {n: p.grad for n, p in m.named_parameters()}, {})
    check = held_train_step("22c NeuralDF step", card, out, DF_GRAD_RTOL)
    return net, {"ms_by_part": parts, "steps": timer.steps("loss"), "peak_gib": peak,
                 "history": hist, "resumed": hist2, "check": check}


def train_to_serve(dev, card, net, encoder, imgs, part, peaks) -> tuple:
    """Phase 22d: 22c's network packed for kernel 2 and held by its f32x3
    and f32 routes against their plain versions on one cold step's inputs;
    that cold config-4 att step at SERVE_B on 22b's encoder latents of the
    first 32 images, kernels 1-4 held on every launch (kernel 4's iterates
    as accurate as the plain version against f64, ILL_FIELDS); statuses
    finite and OK (no u0 gate: the network is a few steps old).  Returns
    (rows, report)."""
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.ops import _lib
    from sdf_nmpc_tpu_torch.params import ParamLayout
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step

    cfg = default_config().replace(nn=dict(size_latent=net.size_latent))
    ocp = build_ocp(cfg, sdf=net, sdf_max_df=1.0, device=dev)
    layout = ParamLayout.from_cfg(cfg)
    with torch.no_grad():
        lat = encoder(imgs[:32, None]).double().cpu().numpy()
    inputs = tiled_inputs(ocp, cfg, layout, lat, SERVE_B, SEED, dev)
    used = ["lin_y_sens", "sdf_fused_x3", "condense", "ip_phase"]
    _lib.reset_launch_counts()
    with Capture() as cap:
        res = make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
            init_state(ocp, inputs.x0), inputs)
    counts = dict(_lib.launch_counts)
    launched_only("22d train -> serve", counts, used)
    n_ok = int((res.status == 0).sum())
    finite = bool(torch.isfinite(res.state.X).all() and torch.isfinite(res.u0).all())
    log(f"22d train -> serve: the trained network packed for kernel 2 (res full, 4 x 256); one "
        f"cold att step at B={SERVE_B} on 22b's latents: {n_ok}/{SERVE_B} status OK, outputs "
        f"{'finite' if finite else 'NOT finite'}, |u0| max {float(res.u0.abs().max()):.3f}; "
        f"card {card}")
    if n_ok != SERVE_B or not finite:
        raise AssertionError("22d: the trained network's step is not finite and OK")
    # the few-steps-old network's rows leave the IP iterates ill-conditioned:
    # those fields held as accurate as the plain version against f64, as
    # recfeas's (ILL_FIELDS), the share by ILL_SHARE_SIGMAS
    errs = check_all(cap, "train -> serve", as_plain=ILL_FIELDS, sdf_route="sdf_fused_x3",
                     share_sigmas=ILL_SHARE_SIGMAS)
    errs["sdf_fused"] = max(check_sdf(a, "sdf_fused") for a in cap.args("sdf"))
    calls = {name: cap.args("sdf" if name == "sdf_fused_x3" else name) for name in used}
    log(f"kernel numbers, train -> serve: the launches of that cold step, B={SERVE_B}")
    rows = kernel_rows({k: fused_runs()[k] for k in used}, calls, counts, errs, peaks, part,
                       {"sdf_fused_x3": (3.0, TF32_PEAKS[part])})
    return rows, {"n_ok": n_ok, "errs": errs}


def phase_training(dev, card) -> dict:
    """Phase 22, the training side (``--training`` runs phases 1, 2 and
    this one alone): 22a the GT data engine at 125,000 points, 22b the VAE
    and 22c the NeuralDF trained at the reference's sizes with resume, 22d
    the trained network served through kernels 1-4.  Returns the kernels'
    per-path rows and the report."""
    import tempfile

    from sdf_nmpc_tpu_torch.config import default_config

    t0 = time.perf_counter()
    part, peaks = card_peaks(card.split(",")[0])
    cfg = default_config()
    report = {}
    imgs, report["gt"] = gt_engine(dev, card, cfg)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_training_") as tmp:
        vae, report["vae"] = train_vae_on_card(dev, card, imgs, f"{tmp}/vae")
        encoder = vae.encoder.eval()
        net, report["df"] = train_df_on_card(dev, card, cfg, imgs, encoder, f"{tmp}/sdf")
    rows, report["serve"] = train_to_serve(dev, card, net, encoder, imgs, part, peaks)
    per_path = {row["name"]: {f"training: train -> serve, cold, B={SERVE_B}": row}
                for row in rows}
    report["wall_s"] = time.perf_counter() - t0
    log(f"phase 22 (training side): {report['wall_s']:.1f} s wall; card {card}")
    log(json.dumps({"training": report}, default=float))
    return {"per_path": per_path, "report": report}


# source -> (its C functions, the kernels timed, the models whose steady
# step gives the launches) for --ip-builds, --sdf-builds (kernel 2's three
# sources), --qp-builds, --condense-builds, --lin-builds and --erk4-builds; a
# function a tree lacks is not bound
VARIANTS = {"ip_phase.cu": (("ip_phase_launch", "ip_phase_geometry"), ("ip_phase",), ("att",)),
            "sdf_fused.cu": (("sdf_fused_launch", "sdf_fused_geometry"), ("sdf_fused",),
                             ("att",)),
            "sdf_fused_x3.cu": (("sdf_fused_x3_launch", "sdf_fused_x3_geometry"),
                                ("sdf_fused_x3",), ("att",)),
            "sdf_fused_bf16.cu": (("sdf_fused_bf16_launch", "sdf_fused_bf16_geometry"),
                                  tuple(BF16_ROUTES), ("att",)),
            "qp_solve.cu": (("factor_solve_launch", "solve_launch", "stiff_factor_solve_launch",
                             "stiff_resolve_launch"), tuple(COMPOSED_KERNELS), ("att",)),
            "condense.cu": (("condense_launch", "condense_geometry"), ("condense",),
                            ("att", "props")),
            "lin_y_sens.cu": (("lin_y_sens_launch", "lin_y_sens_geometry"), ("lin_y_sens",),
                              ("att",) + LIN_FAMILIES),
            "erk4_sens.cu": (("erk4_sens_launch", "erk4_sens_geometry"), ("erk4_sens",),
                             ERK4_FAMILIES)}


def build_variant(src_dir: str, source: str, out_dir) -> str:
    """nvcc (the package's flags) of src_dir/source into a library."""
    from sdf_nmpc_tpu_torch.ops import _lib

    out_dir.mkdir(parents=True, exist_ok=True)
    obj, lib = out_dir / "variant.o", out_dir / "libvariant.so"
    nvcc = _lib._nvcc()
    for cmd in ([nvcc, *_lib.ARCH, *_lib.NVCC_FLAGS, "-c", os.path.join(src_dir, source),
                 "-o", str(obj)],
                [nvcc, *_lib.ARCH, "-shared", "-o", str(lib), str(obj)]):
        run = subprocess.run(cmd, capture_output=True, text=True)
        for line in (run.stdout + run.stderr).splitlines():
            if "registers" in line or "spill" in line or "error" in line or "Function" in line:
                log(f"  {src_dir}: {line.strip()}")
        if run.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src_dir}")
    return str(lib)


def build_over(kernel):
    """The solver overrides of the main path whose steady step gives
    ``kernel``'s launches to --*-builds: the composed path for kernels 5-8,
    kernel 2's route for its f32, bf16 and mixed kernels, else the defaults."""
    if kernel in COMPOSED_KERNELS:
        return DWS
    return {"sdf_fused": SDF_F32, **BF16_ROUTES}.get(kernel)


def phase_builds(dev, card, source, dirs, rounds=3):
    """The kernels of ``source`` (kernel 4, one of kernel 2's three sources,
    kernels 5-8, kernel 3, kernel 1 or kernel 9) built from other source
    trees against the package's build, on their launches of one steady step
    of the main path that runs them (B=MAIN_B; build_over: the composed path
    for kernels 5-8, kernel 2's kernels each under its route; kernel 3 on
    att's and props' fused paths, kernel 1 on att's, acc's and att_tau's,
    kernel 9 on rates', wrench's and props'): each launch's time, the builds
    interleaved round by round, whether each build's outputs equal the
    package's bit for bit and their largest difference per output and
    launch, for kernel 2 how far its value and gradient lie from the f64
    plain version, and for kernel 9 how far each output lies from the plain
    version (held to ERK4_TOL).  A tree must keep the package's C interface
    and host-side layout."""
    import ctypes

    from sdf_nmpc_tpu_torch.ops import (
        _lib,
        condense_kernel,
        ip_kernel,
        lin_kernels,
        qp_kernels,
        sdf_fused,
    )
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step
    from sdf_nmpc_tpu_torch.utils import accuracy

    functions, kernels, models = VARIANTS[source]

    def vs_f64(out, a):
        packed, pos, latent = a
        p64 = {k: v.double() if torch.is_tensor(v) else v for k, v in packed.items()
               if not k.startswith("_")}
        ref = sdf_fused.sdf_value_grad_plain(p64, pos.double(), latent.double())
        d = [(o.double() - r).abs() for o, r in zip(out, ref)]
        return [float(d[0].max()), float(d[0].mean()), float(d[1].max()), float(d[1].mean())]

    runs = {"ip_phase": ("ip_phase", lambda a: ip_kernel.ip_phase(*a)),
            **{name: ("sdf", lambda a, _m=mode: sdf_fused.sdf_value_grad(*a, mode=_m))
               for name, mode in SDF_ROUTES.items()},
            **{name: (name, lambda a, _n=name: getattr(qp_kernels, _n)(*a))
               for name in COMPOSED_KERNELS},
            "condense": ("condense", lambda a: condense_kernel.condense(*a)),
            "lin_y_sens": ("lin_y_sens", lambda a: lin_kernels.lin_y_sens(*a)),
            "erk4_sens": ("erk4_sens", lambda a: lin_kernels.erk4_sens(*a))}
    calls = {kernel: [] for kernel in kernels}
    for model in models:
        for over in {str(build_over(k)): build_over(k) for k in kernels}.values():
            cfg, ocp, layout, _ = accuracy.build_setup(
                device=dev, solver_over=over, model=None if model == "att" else model)
            inputs = bench_inputs(ocp, cfg, layout, MAIN_B, SEED, dev)
            state = make_rti_step(ocp, cfg, budget="cold", with_evals=False)(
                init_state(ocp, inputs.x0, dual_warm_start=over is DWS), inputs).state
            with Capture() as cap:
                make_rti_step(ocp, cfg, budget="steady", with_evals=False)(state, inputs)
            for kernel in kernels:
                if build_over(kernel) == over:
                    calls[kernel] += cap.args(runs[kernel][0])
            del inputs, state, cap
    log(f"{source} builds: the launches of one steady step of {', '.join(models)} at "
        f"B={MAIN_B}: " + ", ".join(f"{k} under {build_over(k) or 'the defaults'}"
                                    for k in kernels))
    libs = {"package": _lib.library()}
    for i, d in enumerate(dirs):
        # one directory per source and tree: dlopen of a path already loaded
        # would return the library loaded first
        out = _lib.BUILD / f"variant-{os.getpid()}-{source.split('.')[0]}-{i}"
        lib = ctypes.CDLL(build_variant(d, source, out))
        for name in functions:
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = _lib._SIGNATURES[name], ctypes.c_int
        libs[d] = lib
    saved = _lib.library
    times = {name: {k: [[] for _ in calls[k]] for k in kernels} for name in libs}
    report = {}
    if source == "sdf_fused_x3.cu":  # the IEEE route on the same inputs, for reference
        a = calls["sdf_fused_x3"][0]
        errs = vs_f64(sdf_fused.sdf_value_grad(*a, mode="f32"), a)
        report["sdf_fused (f32 route)"] = {"f64_err": [errs]}
        log(f"sdf_fused (f32 route): against f64, value max/mean {errs[0]:.3e}/{errs[1]:.3e}, "
            f"gradient {errs[2]:.3e}/{errs[3]:.3e}")
    try:
        for r in range(rounds):
            for name, lib in libs.items():
                _lib.library = lambda _l=lib: _l
                for kernel in kernels:
                    run = runs[kernel][1]
                    for j, a in enumerate(calls[kernel]):
                        times[name][kernel][j].append(cuda_ms(lambda: run(a), reps=5))
        want, every = {}, {}  # the package's outputs; every build's
        for name, lib in libs.items():
            _lib.library = lambda _l=lib: _l
            report[name] = {}
            for kernel in kernels:
                run = runs[kernel][1]
                outs = [_flat(run(a)) for a in calls[kernel]]
                every[name, kernel] = outs
                if name == "package":
                    want[kernel] = outs
                pairs = [(g, w) for o, wo in zip(outs, want[kernel]) for g, w in zip(o, wo)]
                diff = max(max_abs(g, w) for g, w in pairs)
                same = all(torch.equal(g, w) for g, w in pairs)
                # per output (QP_OUTPUTS' names for kernels 5-8): equal on every launch?
                names = QP_OUTPUTS.get(kernel, tuple(range(len(outs[0]))))
                per_out = {str(o): all(torch.equal(out[i], wo[i])
                                       for out, wo in zip(outs, want[kernel]))
                           for i, o in enumerate(names)}
                diff_by = [[max_abs(g, w) for g, w in zip(o, wo)]
                           for o, wo in zip(outs, want[kernel])]  # per launch, per output
                rep = report[name][kernel] = {"launch_ms": times[name][kernel],
                                              "bitwise_equal": same, "max_abs_diff": diff,
                                              "bitwise_equal_by_output": per_out,
                                              "max_abs_diff_by_launch": diff_by}
                if kernel == "erk4_sens":  # each output against the plain version
                    rep["plain_err"] = []
                    for o, a in zip(outs, calls[kernel]):
                        want_p = lin_kernels.erk4_sens_plain(*a)
                        errs = [(max_abs(g, w), ERK4_TOL * (1 + float(w.abs().max())))
                                for g, w in zip(o, want_p)]
                        rep["plain_err"].append(errs)
                        log(f"erk4_sens build {name}: {a[0].name}: against the plain version, "
                            + ", ".join(f"{n} {e:.2e} (tol {t:.2e})"
                                        for n, (e, t) in zip(("x+", "A", "B"), errs)))
                        if not all(e <= t for e, t in errs):
                            raise AssertionError(f"erk4_sens build {name} ({a[0].name}) "
                                                 "disagrees with its plain version")
                if kernel in SDF_ROUTES:  # value and gradient against the f64 plain version
                    errs = [vs_f64(o, a) for o, a in zip(outs, calls[kernel])]
                    rep["f64_err"] = errs
                    log(f"{kernel} build {name}: against f64, value max/mean "
                        f"{errs[0][0]:.3e}/{errs[0][1]:.3e}, gradient "
                        f"{errs[0][2]:.3e}/{errs[0][3]:.3e}")
                if kernel == "ip_phase":
                    rep.update(launch_k_s=[a[2] for a in calls[kernel]],
                               geometry=[ip_kernel.ip_phase_geometry(
                                   a[0][0].shape[-1], a[0][1].shape[1], a[2])
                                   for a in calls[kernel]])
                geo_fn = {"sdf_fused_mixed": "sdf_fused_bf16"}.get(kernel, kernel) + "_geometry"
                # the bf16 kernels' geometry takes the input widths since this
                # tree's build: another tree's is not called with them
                if kernel in SDF_ROUTES and hasattr(lib, geo_fn) and (
                        kernel not in BF16_ROUTES or name == "package"):
                    rep["geometry"] = (
                        sdf_fused.sdf_fused_bf16_geometry(SDF_ROUTES[kernel],
                                                          calls[kernel][0][0])
                        if kernel in BF16_ROUTES else _lib.geometry(geo_fn))
                    log(f"{kernel} build {name}: geometry {rep['geometry']}")
                if (kernel in ("condense", "lin_y_sens", "erk4_sens")
                        and hasattr(lib, f"{kernel}_geometry")):
                    geo = {"condense": lambda a: condense_kernel.condense_geometry(
                               a[0].shape[1], a[0].shape[2], a[1].shape[-1], a[4].shape[2],
                               a[7].shape[2]),
                           "lin_y_sens": lambda a: lin_kernels.lin_y_sens_geometry(a[0]),
                           "erk4_sens": lambda a: lin_kernels.erk4_sens_geometry(a[0])}[kernel]
                    rep["geometry"] = [geo(a) for a in calls[kernel]]
                    log(f"{kernel} build {name}: geometry per launch {rep['geometry']}")
                per_round = [sum(ms[r] for ms in times[name][kernel]) for r in range(rounds)]
                for j, ms in enumerate(times[name][kernel]):
                    at = models[j] if len(calls[kernel]) == len(models) else j
                    log(f"{kernel} build {name}: launch {at}: "
                        f"{', '.join(f'{t:.4f}' for t in ms)} ms over {rounds} rounds")
                log(f"{kernel} build {name}: {len(calls[kernel])} launches, "
                    f"{', '.join(f'{t:.4f}' for t in per_round)} ms per step over {rounds} "
                    f"rounds; outputs {'equal to' if same else 'differ from'} the package's "
                    f"build bit for bit (max diff {diff:.3e}; by output {per_out}; per launch "
                    f"and output {[['%.2e' % d for d in row] for row in diff_by]}); card {card}")
        for (name, kernel), outs in every.items():  # which other builds give the same bits
            same = [other for (other, k), o in every.items() if k == kernel and other != name
                    and all(torch.equal(g, w) for x, y in zip(outs, o) for g, w in zip(x, y))]
            report[name][kernel]["bitwise_equal_to"] = same
            log(f"{kernel} build {name}: outputs equal bit for bit to the builds {same}")
    finally:
        _lib.library = saved
    log(json.dumps({f"{source.split('.')[0]}_builds": report}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the port's main paths on one CUDA card.")
    ap.add_argument("--ip-builds", nargs="+", metavar="DIR",
                    help="time kernel 4 built from each DIR against the package's build, then "
                         "stop")
    ap.add_argument("--sdf-builds", nargs="+", metavar="DIR",
                    help="time kernel 2's f32, f32x3, bf16 and mixed kernels built from each "
                         "DIR's sdf_fused.cu, sdf_fused_x3.cu and sdf_fused_bf16.cu against the "
                         "package's build, then stop")
    ap.add_argument("--qp-builds", nargs="+", metavar="DIR",
                    help="time kernels 5-8 built from each DIR's qp_solve.cu against the "
                         "package's build, then stop")
    ap.add_argument("--condense-builds", nargs="+", metavar="DIR",
                    help="time kernel 3 built from each DIR's condense.cu against the "
                         "package's build, then stop")
    ap.add_argument("--lin-builds", nargs="+", metavar="DIR",
                    help="time kernel 1 built from each DIR's lin_y_sens.cu against the "
                         "package's build, then stop")
    ap.add_argument("--erk4-builds", nargs="+", metavar="DIR",
                    help="time kernel 9 built from each DIR's erk4_sens.cu against the "
                         "package's build, then stop")
    ap.add_argument("--composed", action="store_true",
                    help="run only the composed main path and Nmpc, then stop")
    ap.add_argument("--formulation", action="store_true",
                    help="run only the formulation extras (phase 17), then stop")
    ap.add_argument("--perception", action="store_true",
                    help="run only perception, BASELINE config 3 (phase 18), then stop")
    ap.add_argument("--long-horizon", action="store_true",
                    help="run only the long horizons on the Riccati backend (phase 19), then "
                         "stop")
    ap.add_argument("--closed-loop", action="store_true",
                    help="run only the closed loop (phase 20), then stop")
    ap.add_argument("--solver-routes", action="store_true",
                    help="run only the solver routes (phase 21), then stop")
    ap.add_argument("--training", action="store_true",
                    help="run only the training side (phase 22), then stop")
    args = ap.parse_args(argv)
    card = phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_build()
    sdf_sources = ("sdf_fused.cu", "sdf_fused_x3.cu", "sdf_fused_bf16.cu")
    for sources, dirs in ((("ip_phase.cu",), args.ip_builds), (sdf_sources, args.sdf_builds),
                          (("qp_solve.cu",), args.qp_builds),
                          (("condense.cu",), args.condense_builds),
                          (("lin_y_sens.cu",), args.lin_builds),
                          (("erk4_sens.cu",), args.erk4_builds)):
        if dirs:
            for source in sources:
                phase_builds(dev, card, source, dirs)
            return 0
    if args.formulation:
        phase_formulation(dev, card)
        return 0
    if args.perception:
        phase_perception(dev, card)
        return 0
    for flag, phase in ((args.long_horizon, phase_long_horizon),
                        (args.closed_loop, phase_closed_loop),
                        (args.solver_routes, phase_solver_routes),
                        (args.training, phase_training)):
        if flag:
            phase(dev, card)
            return 0
    if args.composed:
        _, t_step, steady, state, inputs = phase_main_path(
            dev, card, over=DWS, per_step=composed_per_step, label="composed path")
        phase_profile(steady, state, inputs, t_step, card, label="composed path")
        del steady, state, inputs
        phase_nmpc(dev, card)
        return 0
    phase_kernel_checks(dev)
    phase_composed_checks(dev)
    phase_accuracy(dev)
    phase_accuracy_bf16(dev)
    counts, t_step, steady, state, inputs = phase_main_path(dev, card, per_step=fused_per_step)
    phase_profile(steady, state, inputs, t_step, card)
    for name, over in {"sdf_fused": SDF_F32, **BF16_ROUTES}.items():  # kernel 2's other routes
        label = f"fused path, sdf {SDF_ROUTES[name]}"
        run = phase_main_path(dev, card, over=over, per_step=route_per_step(name), label=label)
        phase_profile(*run[2:], run[1], card, label=label)
        counts[name] = run[0][name]
        del run
    rows = phase_kernel_numbers(counts, t_step, steady, state, inputs, card)
    counts, t_step, steady, state, inputs = phase_main_path(
        dev, card, over=DWS, per_step=composed_per_step, label="composed path")
    phase_profile(steady, state, inputs, t_step, card, label="composed path")
    rows += phase_composed_numbers(counts, t_step, steady, state, inputs, card)
    del steady, state, inputs
    phase_nmpc(dev, card)
    phase_batched(dev, card)
    per_kernel = phase_families(dev, card)
    phase_nmpc(dev, card, ticks=NMPC_TICKS_PROPS, model="props", over=None)
    config1 = phase_config1(dev, card)
    other = phase_other_rows(dev, card)
    log(json.dumps({"config_1": config1, "other_rows": other}))
    extras = phase_formulation(dev, card)
    perception = phase_perception(dev, card)
    long_horizon = phase_long_horizon(dev, card)
    closed_loop = phase_closed_loop(dev, card)
    phase_solver_routes(dev, card)
    training = phase_training(dev, card)
    for i, row in enumerate(rows):  # kernels 1 and 3: att's numbers, every model's beside
        if row["name"] in ("lin_y_sens", "condense"):
            rows[i] = kernel_row_per_model({"att": row, **per_kernel[row["name"]]}, "att")
    # kernel 9: att's (under sdf_cost) at top level, all six families beside
    rows.append(kernel_row_per_model({**extras["erk4_sens"], **per_kernel["erk4_sens"]}, "att"))
    for row in rows:  # the formulation extras' and config 3's readings of kernels 1-8
        for per_path in (extras["per_path"], perception["per_path"], long_horizon["per_path"],
                         closed_loop["per_path"], training["per_path"]):
            if row["name"] in per_path:
                row.setdefault("per_path", {}).update(per_path[row["name"]])
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
