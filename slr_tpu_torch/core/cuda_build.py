"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
by `nvcc` for Hopper (`sm_90a`) into
`slr_tpu_torch/_build/lib<name>-<hash>.so` and loaded with ctypes. The hash
covers the source and the nvcc flags, so a change to either builds a new
library. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# -fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch versions compute them, so a kernel and its plain version agree to
# the bit wherever they take the same steps.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_library(name: str) -> str:
    """Compile csrc/<name>.cu unless a library built from this source with
    these flags exists; return the library path. Records the seconds and ptxas report in BUILD_LOG."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + "\0".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stderr}
    return out


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Load lib<name>.so, building it first if needed. `signatures` maps
    each C entry point to its argument types; every entry returns int (a
    cudaError_t)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name))
            lib.slr_error_string.argtypes = [ctypes.c_int]
            lib.slr_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if code != 0:
        msg = lib.slr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
