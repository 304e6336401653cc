"""Build and load the port's CUDA kernels: one shared library, plain C ABI.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (no fast math) into an
object file, all sources at once in parallel, and links them into
``_build/libsdf_nmpc_kernels-<hash>.so``, where the hash covers the sources
and the flags.  The library is loaded with ``ctypes``; nothing here includes
PyTorch's headers.  The build happens at first use, never at import.

``launch_counts`` holds one plain integer per kernel.  Each wrapper runs its
checks, allocations and launch inside ``with launch(key):``, which opens the
profiler span ``nmpc.kernel.<key>`` and adds one to the count when the block
ends without raising, and nowhere else.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.timing import span

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("lin_y_sens.cu", "erk4_sens.cu", "sdf_fused.cu", "sdf_fused_x3.cu",
           "sdf_fused_bf16.cu", "condense.cu", "ip_phase.cu", "qp_solve.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts = {"lin_y_sens": 0, "erk4_sens": 0, "sdf_fused": 0, "sdf_fused_x3": 0,
                 "sdf_fused_bf16": 0, "sdf_fused_mixed": 0, "condense": 0, "ip_phase": 0,
                 "factor_solve": 0, "solve": 0,
                 "stiff_factor_solve": 0, "stiff_resolve": 0}

# what the build of the loaded library printed (ptxas register / spill
# report), kept beside it as <library>.log
build_info = {"log": "", "path": None}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # (..., M, model id, host pointer to the ModelConsts floats, their count, stream)
    "lin_y_sens_launch": [_P] * 11 + [_I, _I, _P, _I, _P],
    "lin_y_sens_geometry": [_I] + [_P] * 3,
    "erk4_sens_launch": [_P] * 6 + [_I, _I, _P, _I, _P],
    "erk4_sens_geometry": [_I] + [_P] * 3,
    "sdf_fused_launch": [_P] * 15 + [_I] * 5 + [_F, _P],
    "sdf_fused_geometry": [_P] * 3,
    "sdf_fused_x3_launch": [_P] * 9 + [_I] * 6 + [_F, _P],
    "sdf_fused_x3_geometry": [_P] * 3,
    # (emb, demb, lat, Wb, Wf, bias, w5, w5r, b5, df, grad, P, nemb, L, nxe, nxl,
    #  mixed, act, w0, stream)
    "sdf_fused_bf16_launch": [_P] * 11 + [_I] * 7 + [_F, _P],
    # (mixed, nemb, L, threads, smem, blocks per SM)
    "sdf_fused_bf16_geometry": [_I] * 3 + [_P] * 3,
    "condense_launch": [_P] * 18 + [_I] * 6 + [_P],
    "condense_geometry": [_I] * 5 + [_P] * 3,
    "ip_phase_launch": [_P] * 12 + [_I] * 7 + [_F] * 5 + [_P],
    "ip_phase_geometry": [_I] * 3 + [_P] * 3,
    "factor_solve_launch": [_P] * 4 + [_I] * 3 + [_P],
    "factor_solve_geometry": [_I] * 2 + [_P] * 3,
    "solve_launch": [_P] * 3 + [_I] * 3 + [_P],
    "stiff_factor_solve_launch": [_P] * 8 + [_I] * 4 + [_P],
    "stiff_factor_solve_geometry": [_I] * 3 + [_P] * 3,
    "stiff_resolve_launch": [_P] * 6 + [_I] * 4 + [_P],
    "stiff_resolve_geometry": [_I] * 3 + [_P] * 3,
}


@contextlib.contextmanager
def launch(key: str):
    """The span ``nmpc.kernel.<key>`` around a wrapper's launch; one more in
    ``launch_counts[key]`` once the block has run without raising."""
    with span(f"nmpc.kernel.{key}"):
        yield
    launch_counts[key] += 1


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if the sources changed) and return the library path."""
    lib = BUILD / f"libsdf_nmpc_kernels-{_digest()}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        build_info.update(log=log.read_text() if log.exists() else "", path=str(lib))
        return lib
    nvcc = _nvcc()
    work = BUILD / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = work / (Path(src).stem + ".o")
        cmd = [nvcc, *ARCH, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp_lib = work / lib.name
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    build_info.update(log="\n".join(logs), path=str(lib))
    (work / log.name).write_text(build_info["log"])
    os.replace(work / log.name, log)
    os.replace(tmp_lib, lib)  # atomic: concurrent builders never see half a file
    shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def geometry(name: str, *sizes) -> dict:
    """What the C function ``name`` reports of a kernel's launch at ``sizes``
    on the current card: threads per block, dynamic shared bytes per block,
    resident blocks per SM."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = getattr(library(), name)(*sizes, *[ctypes.byref(v) for v in vals])
    check(err, name)
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm"), (v.value for v in vals)))


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda_f32(name: str, *tensors):
    """Every tensor a kernel reads must be CUDA, float32 and contiguous."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: argument {i} is not on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: argument {i} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")


def require_shape(name: str, t: torch.Tensor, shape: tuple):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
