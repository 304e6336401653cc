"""ctypes bindings of the native frame ring (``csrc/frame_ring.cpp`` at the
repo root, shared with the JAX package and unchanged).

Counterpart of sdf_nmpc_tpu/runtime/native.py.  The library is built at
first use with ``g++ -O3 -shared -fPIC -std=c++17`` into the package's
``_build/`` directory, named by a hash of the source, and loaded with
ctypes; nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "csrc" / "frame_ring.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def build() -> Path:
    """Compile the frame ring (if its source changed) and return the library."""
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD / f"libframe_ring-{tag}.so"
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)], check=True)
        os.replace(tmp, out)  # atomic: concurrent builds leave one whole library
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        D, I, P = ctypes.c_double, ctypes.c_int, ctypes.c_void_p
        lib.frame_ring_create.restype = P
        lib.frame_ring_create.argtypes = [I, I, I, D, D, D, D, I]
        lib.frame_ring_destroy.argtypes = [P]
        lib.frame_ring_push_u16.argtypes = [P, ctypes.POINTER(ctypes.c_uint16), D]
        lib.frame_ring_push_f32.argtypes = [P, ctypes.POINTER(ctypes.c_float), D, D]
        lib.frame_ring_latest.restype = D
        lib.frame_ring_latest.argtypes = [P, ctypes.POINTER(ctypes.c_float), D, D,
                                          ctypes.POINTER(I)]
        lib.frame_ring_count.restype = ctypes.c_uint64
        lib.frame_ring_count.argtypes = [P]
        lib.frame_ring_drops.restype = ctypes.c_uint64
        lib.frame_ring_drops.argtypes = [P]
        _lib = lib
    return _lib


class FrameRing:
    """Single-producer single-consumer latest-wins frame buffer with the
    preprocessing fused in native code.

    Producer: ``push(raw, ts)`` converts a raw uint16 depth frame (sensor
    units) or a float32 frame in metres to the dmax-normalized float32 range
    image (ClipDistance + Depth2Range).  Consumer (the control loop):
    ``latest(timeout)`` returns the newest frame and whether it is stale
    (the reference's timeout_img watchdog)."""

    def __init__(self, cfg, capacity: int = 4):
        self._lib = _load()
        _, H, W = cfg.sensor.shape_imgs
        self.height, self.width = H, W
        self._handle = self._lib.frame_ring_create(
            H, W, capacity, float(cfg.sensor.dmax), float(cfg.sensor.mm_resolution),
            float(cfg.sensor.hfov), float(cfg.sensor.vfov), int(bool(cfg.sensor.is_depth)))
        self._dmax = float(cfg.sensor.dmax)
        self._out = np.empty((H, W), np.float32)

    def push(self, raw, timestamp: float | None = None):
        ts = time.monotonic() if timestamp is None else float(timestamp)
        raw = np.ascontiguousarray(raw)
        if raw.shape != (self.height, self.width):
            raise ValueError(f"frame of shape {raw.shape}, the ring holds "
                             f"{(self.height, self.width)}")
        if raw.dtype == np.uint16:
            self._lib.frame_ring_push_u16(
                self._handle, raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), ts)
        elif raw.dtype == np.float32:
            self._lib.frame_ring_push_f32(
                self._handle, raw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ts,
                self._dmax)
        else:
            raise TypeError(f"unsupported frame dtype {raw.dtype}")

    def latest(self, timeout: float = 1.0, now: float | None = None):
        """(frame float32 in [0, 1], timestamp, stale); frame None if empty."""
        now = time.monotonic() if now is None else float(now)
        stale = ctypes.c_int(0)
        ts = self._lib.frame_ring_latest(
            self._handle, self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), now,
            float(timeout), ctypes.byref(stale))
        if ts < 0:
            return None, ts, True
        return self._out.copy(), ts, bool(stale.value)

    @property
    def count(self) -> int:
        return int(self._lib.frame_ring_count(self._handle))

    @property
    def drops(self) -> int:
        return int(self._lib.frame_ring_drops(self._handle))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.frame_ring_destroy(self._handle)
            self._handle = None
