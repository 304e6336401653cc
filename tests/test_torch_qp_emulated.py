"""Kernels 5-8 of ``sdf_nmpc_tpu_torch/csrc/qp_solve.cu`` run on the CPU in an
emulation of the CUDA execution model, against the plain versions of
``ops/qp_kernels.py`` at the card tests' tolerances (tests/test_torch_gpu.py).

The CUDA source is compiled by g++ (``-std=c++20 -O1 -pthread
-ffp-contract=off``) against a stub ``cuda_runtime.h`` that this file writes
into a temporary directory:

- each CUDA thread is a ``std::thread``, the blocks run one after the other;
- ``__syncthreads`` and ``__syncwarp`` are ``std::barrier``s of the block and
  of the warp, and a thread that returns drops out of both, as an exited CUDA
  thread stops counting at a barrier;
- shuffles and the vote go through a per-warp exchange buffer between two warp
  barriers, so a lane that skips one deadlocks the test instead of passing;
- shared memory is poisoned with NaN before each block, so a read of a word
  the block did not write shows in the result;
- the cp.async copies of ``async_copy.cuh`` are plain copies (an emulated
  ``async_copy.cuh`` beside the rewritten source is found before the real one).

The launches (``kernel<<<grid, block, smem, stream>>>(...)``) are rewritten
into calls of the emulated launcher, and the package's own wrappers
(``_factor_solve_cuda`` and its siblings) call the emulated library through
ctypes on CPU tensors.  The same harness builds other sources (another tree's
``qp_solve.cu``, or ``ip_phase.cu`` with a ``cudaLaunchKernel`` defined after
it) to compare two builds' outputs bit for bit.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

CSRC = Path(__file__).resolve().parents[1] / "sdf_nmpc_tpu_torch" / "csrc"
CXX_FLAGS = ("-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-fPIC", "-shared")

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

using std::isfinite;
using std::isnan;
using std::max;
using std::min;

namespace emu {
inline thread_local dim3 thread_idx, block_idx;
inline float* shared = nullptr;
inline std::barrier<>* block_barrier = nullptr;
inline std::barrier<>** warp_barriers = nullptr;
inline unsigned long long* exchange = nullptr;  // 32 slots per warp

template <class T>
T swap_lanes(T v, int src) {
  const int w = int(thread_idx.x) >> 5, lane = int(thread_idx.x) & 31;
  unsigned long long* slots = exchange + 32 * w;
  std::memcpy(&slots[lane], &v, sizeof(T));
  warp_barriers[w]->arrive_and_wait();
  T out;
  std::memcpy(&out, &slots[src & 31], sizeof(T));
  warp_barriers[w]->arrive_and_wait();
  return out;
}

// Runs kernel(args...) over the grid, one block at a time.
template <class... P, class... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem_bytes,
                   cudaStream_t, A... args) {
  const unsigned nt = block.x, nw = (nt + 31) / 32;
  std::vector<float> mem(smem_bytes / sizeof(float) + 1);
  std::vector<unsigned long long> slots(32 * nw);
  for (unsigned b = 0; b < grid.x; ++b) {
    std::fill(mem.begin(), mem.end(), std::numeric_limits<float>::quiet_NaN());
    std::barrier<> bar(nt);
    std::vector<std::unique_ptr<std::barrier<>>> owned;
    std::vector<std::barrier<>*> wb;
    for (unsigned w = 0; w < nw; ++w) {
      owned.emplace_back(new std::barrier<>(std::min(32u, nt - 32 * w)));
      wb.push_back(owned.back().get());
    }
    shared = mem.data();
    block_barrier = &bar;
    warp_barriers = wb.data();
    exchange = slots.data();
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < nt; ++t)
      threads.emplace_back([&, t, b] {
        thread_idx = dim3(t);
        block_idx = dim3(b);
        kernel(args...);
        bar.arrive_and_drop();
        wb[t >> 5]->arrive_and_drop();
      });
    for (auto& th : threads) th.join();
  }
  return cudaSuccess;
}
}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::warp_barriers[threadIdx.x >> 5]->arrive_and_wait();
}
template <class T>
T __shfl_sync(unsigned, T v, int src, int = 32) { return emu::swap_lanes(v, src); }
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask, int = 32) {
  return emu::swap_lanes(v, (int(threadIdx.x) & 31) ^ mask);
}
inline int __all_sync(unsigned, int pred) {
  int all = 1;
  for (int l = 0; l < 32; ++l) all &= emu::swap_lanes(pred ? 1 : 0, l);
  return all;
}

template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
// By threads and shared memory only (H100: 2048 threads, 228 KB, 1 KB reserved per block).
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int threads, size_t smem) {
  *n = int(std::min<size_t>({size_t(2048 / threads), 32, 233472 / (smem + 1024)}));
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t);
"""

# async_copy.cuh: the copies done at once (the source's wait is then a no-op)
ASYNC_COPY_H = """
#pragma once
namespace acp {
inline void copy4(float* dst, const float* src) { *dst = *src; }
inline void wait_all() {}
}  // namespace acp
"""

MATH_CONSTANTS_H = """
#pragma once
#include <limits>
#define CUDART_INF_F std::numeric_limits<float>::infinity()
"""


def emulated_source(text: str) -> str:
    """A CUDA source rewritten for the emulation: dynamic shared memory from
    the emulated block, triple-chevron launches through emu::launch."""
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu::shared);", text)
    return re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\(", r"emu::launch(\1, \2, ", text)


def build_emulated(source: Path, out_dir: Path, extra: str = "") -> Path:
    """g++ build of ``source`` (its headers from its own directory) into a
    shared library in ``out_dir``; ``extra``: C++ appended after the source."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out_dir / "math_constants.h").write_text(MATH_CONSTANTS_H)
    (out_dir / "async_copy.cuh").write_text(ASYNC_COPY_H)  # found before the source's own
    src = out_dir / (source.stem + "_emu.cc")
    src.write_text(emulated_source(source.read_text()) + extra)
    lib = out_dir / ("lib" + source.stem + "_emu.so")
    cmd = ["g++", *CXX_FLAGS, f"-I{out_dir}", f"-I{source.parent}", "-o", str(lib), str(src)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"g++ failed for {source}:\n{run.stderr[-4000:]}")
    return lib


def load_emulated(lib_path: Path) -> ctypes.CDLL:
    """The library with the argument types of the package's loader."""
    from sdf_nmpc_tpu_torch.ops import _lib

    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _lib._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def use_emulated(monkeypatch, lib):
    """The package's CUDA wrappers call ``lib`` on CPU tensors."""
    from sdf_nmpc_tpu_torch.ops import _lib

    monkeypatch.setattr(_lib, "library", lambda: lib)
    monkeypatch.setattr(_lib, "require_cuda_f32", lambda name, *ts: None)
    monkeypatch.setattr(_lib, "stream_ptr", lambda: None)


@pytest.fixture(scope="module")
def emulated_qp(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation of qp_solve.cu")
    return load_emulated(build_emulated(CSRC / "qp_solve.cu", tmp_path_factory.mktemp("qp")))


def _system(n, k, r, seed, B=4):
    """As tests/test_torch_gpu.py::_spd_system: A = G G' + 10 I, Cs rows,
    ds_inv = 1 / eta_s with eta_s in [1e2, 1e6], f32."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    s = dict(A=np.einsum("bij,bkj->bik", G, G) + 10 * np.eye(n), RHS=rng.normal(size=(B, r, n)),
             Cs=rng.normal(size=(B, k, n)), dsi=1.0 / 10.0 ** rng.uniform(2, 6, size=(B, k)),
             R2=rng.normal(size=(B, r, n)))
    return {key: torch.as_tensor(v, dtype=torch.float32) for key, v in s.items()}


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


SHAPES = [(17, 1), (17, 3), (80, 1), (80, 3)]


@pytest.mark.parametrize("n, r", SHAPES)
def test_factor_solve_and_solve_emulated(emulated_qp, monkeypatch, n, r):
    """Kernels 5 and 6: X within 1e-4 and L within 1e-5 of their largest
    entries of the plain version, L zero above the diagonal."""
    from sdf_nmpc_tpu_torch.ops import qp_kernels as qk

    use_emulated(monkeypatch, emulated_qp)
    s = _system(n, 8, r, seed=[n, r, 5])
    X, L = qk._factor_solve_cuda(s["A"], s["RHS"])
    X2 = qk._solve_cuda(L, s["R2"])
    Xp, Lp = qk.factor_solve_plain(s["A"], s["RHS"])
    assert _rel(X, Xp) < 1e-4 and _rel(L, Lp) < 1e-5
    assert _rel(X2, qk.solve_plain(Lp, s["R2"])) < 1e-4
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.parametrize("n, r", SHAPES)
def test_stiff_factor_solve_and_resolve_emulated(emulated_qp, monkeypatch, n, r):
    """Kernels 7 and 8 at k=8: X and the re-solve within 2e-3 of their
    largest entries (eta_s up to 1e6), Xs 1e-4, L 1e-5, Lt 1e-4; L and Lt
    zero above the diagonal; the launch geometry of both."""
    from sdf_nmpc_tpu_torch.ops import qp_kernels as qk

    use_emulated(monkeypatch, emulated_qp)
    k = 8
    s = _system(n, k, r, seed=[n, r, 7])
    X, (L, Xs, Lt) = qk._stiff_factor_solve_cuda(s["A"], s["RHS"], s["Cs"], s["dsi"])
    X2 = qk._stiff_resolve_cuda(L, Xs, Lt, s["Cs"], s["R2"])
    Xp, (Lp, Xsp, Ltp) = qk.stiff_factor_solve_plain(s["A"], s["RHS"], s["Cs"], s["dsi"])
    assert _rel(X, Xp) < 2e-3 and _rel(Xs, Xsp) < 1e-4
    assert _rel(L, Lp) < 1e-5 and _rel(Lt, Ltp) < 1e-4
    assert _rel(X2, qk.stiff_resolve_plain(Lp, Xsp, Ltp, s["Cs"], s["R2"])) < 2e-3
    assert bool((torch.triu(L, 1) == 0).all()) and bool((torch.triu(Lt, 1) == 0).all())
    ld = n | 1
    geo7, geo8 = qk.stiff_factor_solve_geometry(n, r, k), qk.stiff_resolve_geometry(n, r, k)
    assert geo7["threads"] == geo8["threads"] == 128
    assert geo7["smem_bytes"] == 4 * (ld * (n + r + k) + max(4 * 72, k * (k + 2 * r)))
    assert geo8["smem_bytes"] == 4 * (ld * (n + r + 2 * k) + k * (k + 8))
