"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the same seeded numpy inputs go to both sides."""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while a module's tests run, the count
    restored after it.  The suite runs in several worker processes at once
    (pytest-xdist), and an OpenMP pool of every core in each of them
    oversubscribes the machine: each small op's fork-join waits for threads
    the other workers hold.  A module takes it by importing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The CUDA device for tests marked ``gpu``; decided here, at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host: pytest -m gpu)")
    return torch.device("cuda")


def jax_net(size_latent=16, layer_sizes=(32, 32, 32, 32), embed="oct", act="sin",
            w0=2.0, seed=1):
    """(flax module, variables) of a NeuralDF from the JAX package."""
    from sdf_nmpc_tpu.nn import init_neural_df

    return init_neural_df(size_latent=size_latent, layer_sizes=layer_sizes, embed=embed,
                          act=act, w0=w0, seed=seed)


def port_net(module, variables, dtype=torch.float64, device="cpu"):
    """The port's NeuralDF carrying the JAX module's parameters."""
    import jax

    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.nn.weights import params_from_jax

    net = NeuralDF(size_latent=module.size_latent, layer_sizes=module.layer_sizes,
                   embed=module.embed, act=module.act, w0=module.w0,
                   nb_freqs=module.nb_freqs, res=module.res)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables)))
    return net.to(dtype=dtype, device=device)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


# ------------------------------------------------------------------------
# A g++ emulation of the CUDA execution model, to run the port's CUDA
# sources on the CPU (tests/test_torch_qp_emulated.py,
# tests/test_torch_lin_condense_emulated.py).  The CUDA source is compiled by
# g++ (``CXX_FLAGS``) against a stub ``cuda_runtime.h`` written into a
# temporary directory:
#
# - each CUDA thread is a ``std::thread``, the blocks run one after the other;
# - ``__syncthreads`` and ``__syncwarp`` are ``std::barrier``s of the block and
#   of the warp, and a thread that returns drops out of both, as an exited
#   CUDA thread stops counting at a barrier;
# - shuffles and the vote go through a per-warp exchange buffer between two
#   warp barriers, so a lane that skips one deadlocks the test instead of
#   passing;
# - shared memory is poisoned with NaN before each block (a word whose halves
#   are NaN as bf16 too), so a read of a word the block did not write shows in
#   the result;
# - the cp.async copies of ``async_copy.cuh`` are plain copies (an emulated
#   ``async_copy.cuh`` beside the rewritten source is found before the real
#   one).
#
# The launches (``kernel<<<grid, block, smem, stream>>>(...)``) are rewritten
# into calls of the emulated launcher; ``use_emulated`` makes the package's
# own wrappers call the emulated library through ctypes on CPU tensors.

CSRC = Path(__file__).resolve().parents[1] / "sdf_nmpc_tpu_torch" / "csrc"
CXX_FLAGS = ("-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-fno-strict-aliasing",
             "-fPIC", "-shared")

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
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

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
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
inline thread_local dim3 thread_idx, block_idx, block_dim;
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

// The word shared memory is filled with before each block: a NaN as a float,
// and both of its halves NaN as bf16.
inline float poison() {
  const unsigned bits = 0x7FC07FC0u;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// Runs kernel(args...) over the grid, one block at a time.
template <class... P, class... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem_bytes,
                   cudaStream_t, A... args) {
  const unsigned nt = block.x, nw = (nt + 31) / 32;
  std::vector<float> mem(smem_bytes / sizeof(float) + 1);
  std::vector<unsigned long long> slots(32 * nw);
  for (unsigned b = 0; b < grid.x; ++b) {
    std::fill(mem.begin(), mem.end(), poison());
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
        block_dim = block;
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
#define blockDim emu::block_dim

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }
namespace emu {
inline std::atomic<int> sync_or{0};
}
// The block's vote between barriers: set, read, then reset by thread 0
// before anyone can set it again.
inline int __syncthreads_or(int pred) {
  if (pred) emu::sync_or.store(1);
  emu::block_barrier->arrive_and_wait();
  const int out = emu::sync_or.load();
  emu::block_barrier->arrive_and_wait();
  if (threadIdx.x == 0) emu::sync_or.store(0);
  emu::block_barrier->arrive_and_wait();
  return out;
}
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

template <class T>
T __ldg(const T* p) { return *p; }

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

# async_copy.cuh: the copies done at once (the source's wait is then a no-op);
# a bulk copy is done at once too (aborting, as the card faults, off 16-byte
# alignment or size) and then completes its bytes on the mbarrier.  An
# mbarrier keeps, under one lock, its pending and expected arrivals, its
# transaction bytes and its phase: a phase completes when both the arrivals
# and the bytes are in.
ASYNC_COPY_H = """
#pragma once
#include "cuda_runtime.h"
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
namespace acp {
inline void copy4(float* dst, const float* src) { *dst = *src; }
inline void copy16(float* dst, const float* src) { std::memcpy(dst, src, 16); }
inline void copy4(float* dst, const float* src, bool valid) { *dst = valid ? *src : 0.f; }
inline void commit() {}
template <int N>
inline void wait() {}
inline void wait_all() {}

inline std::mutex mbar_lock;
struct Mbar {
  int32_t pending : 15, expected : 15, phase : 2;
  int32_t tx;
};
static_assert(sizeof(Mbar) == 8, "an mbarrier is 8 bytes");
inline void mbar_done(Mbar* m) {  // under the lock
  if (m->pending == 0 && m->tx == 0) {
    m->phase ^= 1;
    m->pending = m->expected;
  }
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> g(mbar_lock);
  Mbar* m = reinterpret_cast<Mbar*>(bar);
  m->pending = m->expected = int32_t(count);
  m->phase = 0;
  m->tx = 0;
}
inline void fence_mbar_init() {}
inline void mbar_arrive(uint64_t* bar, int bytes) {
  std::lock_guard<std::mutex> g(mbar_lock);
  Mbar* m = reinterpret_cast<Mbar*>(bar);
  m->tx += bytes;
  m->pending -= 1;
  mbar_done(m);
}
inline void mbar_complete(uint64_t* bar, int bytes) {
  std::lock_guard<std::mutex> g(mbar_lock);
  Mbar* m = reinterpret_cast<Mbar*>(bar);
  m->tx -= bytes;
  mbar_done(m);
}
inline void mbar_expect_tx(uint64_t* bar, unsigned bytes) { mbar_arrive(bar, int(bytes)); }
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  for (;;) {
    {
      std::lock_guard<std::mutex> g(mbar_lock);
      if (unsigned(reinterpret_cast<Mbar*>(bar)->phase & 1) != parity) return;
    }
    std::this_thread::yield();
  }
}
inline void bulk_check(const void* dst, const void* src, unsigned bytes) {
  // the card faults on a bulk copy off 16-byte alignment or size
  if ((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src) | bytes) % 16) std::abort();
}
inline void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  bulk_check(dst, src, bytes);
  std::memcpy(dst, src, bytes);
  mbar_complete(bar, int(bytes));
}
}  // namespace acp
"""

MATH_CONSTANTS_H = """
#pragma once
#include <limits>
#define CUDART_INF_F std::numeric_limits<float>::infinity()
"""


# bf16.cuh for sdf_fused_bf16.cu: rounding to bf16 to nearest even on the
# bits; ldmatrix.x4 and the m16n8k16 product gather the warp's addresses or
# fragments through a per-warp buffer between two warp barriers (as a shuffle
# does), the product forms each lane's four outputs from the exact bf16
# products summed in double.
BF16_CUH = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include "common.cuh"

struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { uint32_t x, y; };

namespace bf16 {
inline uint32_t bits(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}
inline float from_bits(uint32_t b) {
  const uint32_t u = b << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t pack(float lo, float hi) { return bits(lo) | (bits(hi) << 16); }
inline uint16_t bits16(float x) { return uint16_t(bits(x)); }
inline float rn(float x) { return from_bits(bits(x)); }
// ldmatrix.x4: lane l gives the address of row l % 16, columns 8 (l / 16) ..
// + 7; register i of lane l is matrix i's row l / 4, elements 2 (l % 4) and
// 2 (l % 4) + 1, from the address lane 8 i + l / 4 gave (gathered between two
// warp barriers, as a shuffle)
inline const void* ldsm_rows[64][32];  // per warp and lane
inline void ldsm_x4(uint32_t (&a)[4], const void* row) {
  const int w = int(threadIdx.x) >> 5, lane = int(threadIdx.x) & 31;
  if (reinterpret_cast<size_t>(row) % 16) std::abort();  // the card faults there
  ldsm_rows[w][lane] = row;
  emu::warp_barriers[w]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const uint16_t* r = static_cast<const uint16_t*>(ldsm_rows[w][8 * i + (lane >> 2)]);
    a[i] = uint32_t(r[2 * (lane & 3)]) | (uint32_t(r[2 * (lane & 3) + 1]) << 16);
  }
  emu::warp_barriers[w]->arrive_and_wait();
}
inline uint32_t fragments[64][32][6];  // per warp and lane: a[4], b[2]
inline void mma_zero(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int w = int(threadIdx.x) >> 5, lane = int(threadIdx.x) & 31;
  std::memcpy(fragments[w][lane], a, 16);
  std::memcpy(fragments[w][lane] + 4, b, 8);
  emu::warp_barriers[w]->arrive_and_wait();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    const uint32_t* r = fragments[w][l];
    const int rows[4] = {g, g + 8, g, g + 8}, cols[4] = {2 * t, 2 * t, 2 * t + 8, 2 * t + 8};
    for (int i = 0; i < 4; ++i) {
      A[rows[i]][cols[i]] = from_bits(r[i] & 0xFFFFu);
      A[rows[i]][cols[i] + 1] = from_bits(r[i] >> 16);
    }
    for (int i = 0; i < 2; ++i) {
      B[2 * t + 8 * i][g] = from_bits(r[4 + i] & 0xFFFFu);
      B[2 * t + 8 * i + 1][g] = from_bits(r[4 + i] >> 16);
    }
  }
  emu::warp_barriers[w]->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    double s = 0;
    for (int k = 0; k < 16; ++k) s += double(A[g + 8 * (i >> 1)][k]) * B[k][2 * t + (i & 1)];
    d[i] = float(s);
  }
}
}  // namespace bf16
"""

def emulated_source(text: str) -> str:
    """A CUDA source rewritten for the emulation: dynamic shared memory from
    the emulated block, triple-chevron launches through emu::launch."""
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu::shared);", text)
    return re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\(", r"emu::launch(\1, \2, ", text)


def build_emulated(source: Path, out_dir: Path, extra: str = "", headers=None) -> Path:
    """g++ build of ``source`` (its headers from its own directory) into a
    shared library in ``out_dir``; ``extra``: C++ appended after the source;
    ``headers``: {name: text} of more emulated headers, found before the
    source's own."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out_dir / "math_constants.h").write_text(MATH_CONSTANTS_H)
    (out_dir / "async_copy.cuh").write_text(ASYNC_COPY_H)  # found before the source's own
    for name, text in (headers or {}).items():
        (out_dir / name).write_text(text)
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
