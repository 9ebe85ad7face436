"""The SBVH builder in C++, bound with ctypes (counterpart of
slr_tpu/native/__init__.py).

`sbvh.cc` is a byte-for-byte copy of the reference's builder: binned SAH
with the spatial splits of Stich et al. 2009. At first use it is compiled by
the host's `g++` with the reference's flags (`-O2 -shared -fPIC
-std=c++17`), so both packages build the same trees bit for bit, into
`slr_tpu_torch/_build/libslr_native-<hash>.so`; the hash covers the source
and the flags. Nothing is built at import time, and there is no fallback:
a failed compile raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "sbvh.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _build_lib() -> str:
    with open(_SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + "\0".join(CXX_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"libslr_native-{key.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {_SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build_lib())
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.slr_sbvh_build.restype = ctypes.c_int
        lib.slr_sbvh_build.argtypes = [
            f32p, f32p, f32p, ctypes.c_int,              # p0, p1, p2, n
            ctypes.c_int, ctypes.c_float, ctypes.c_int,  # spatial, alpha, max_refs
            f32p, f32p, i32p, i32p, i32p,                # node arrays, prim_order
            i32p, f32p,                                  # stats, sah_cost
            ctypes.c_void_p,                             # prim_cost (nullable)
        ]
        _lib = lib
        return _lib


class SBVHResult:
    def __init__(self, node_min, node_max, node_left, node_right, prim_order,
                 n_nodes, n_refs, depth, sah_cost, budget_hit):
        self.node_min = node_min
        self.node_max = node_max
        self.node_left = node_left
        self.node_right = node_right
        self.prim_order = prim_order
        self.n_nodes = n_nodes
        self.n_refs = n_refs
        self.depth = depth
        self.sah_cost = sah_cost
        self.budget_hit = budget_hit


def sbvh_build(
    p0: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    spatial: bool = True,
    alpha: float = 1e-5,
    budget: float = 2.0,
    prim_cost: np.ndarray | None = None,
) -> SBVHResult | None:
    """Binned-SAH / spatial-split SBVH over triangles, built on the host.
    Returns None for n < 2 (callers then use the median-split builder)."""
    n = len(p0)
    if n < 2:
        return None
    lib = get_lib()
    p0 = np.ascontiguousarray(p0, np.float32)
    p1 = np.ascontiguousarray(p1, np.float32)
    p2 = np.ascontiguousarray(p2, np.float32)
    max_refs = max(int(n * budget), n + 16)
    node_min = np.empty((max_refs, 3), np.float32)
    node_max = np.empty((max_refs, 3), np.float32)
    node_left = np.empty((max_refs,), np.int32)
    node_right = np.empty((max_refs,), np.int32)
    prim_order = np.empty((max_refs,), np.int32)
    stats = np.zeros((3,), np.int32)
    sah = np.zeros((1,), np.float32)
    pc = (None if prim_cost is None
          else np.ascontiguousarray(prim_cost, np.float32))
    rc = lib.slr_sbvh_build(
        p0, p1, p2, n, int(spatial), float(alpha), max_refs,
        node_min, node_max, node_left, node_right, prim_order, stats, sah,
        None if pc is None else pc.ctypes.data,
    )
    if rc == 2:
        return None
    nn, nr, depth = int(stats[0]), int(stats[1]), int(stats[2])
    return SBVHResult(
        node_min[:nn].copy(), node_max[:nn].copy(),
        node_left[:nn].copy(), node_right[:nn].copy(),
        prim_order[:nr].copy(), nn, nr, depth, float(sah[0]), rc == 1,
    )
