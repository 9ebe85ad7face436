"""The reference package's SBVH library, loaded once and safely before a port
test builds reference tables.

slr_tpu/native compiles `libslr_native.so` in place (`g++ -o`) the first
time it is needed, and the library is not tracked by git, so a fresh
checkout starts without it. When several test processes build it at once,
one of them can load a half-written file (`OSError: ... file too short`);
the reference then marks the library failed for good and its `build_bvh`
falls back to LBVH without a word, so the reference tables a port test
compares against are not the SBVH tables the port builds.

`load_reference_sbvh()` loads the library under an exclusive file lock,
clearing the reference's failure flag and retrying until the file loads,
and fails naming the library if it never does. Every port test file that
builds reference tables with SBVH on calls it before its first build. It
touches the reference module's state only inside the test process.
"""
import fcntl
import os
import tempfile
import time

import numpy as np
import pytest

LOCK_NAME = "slr_tpu_native_build.lock"


def load_reference_sbvh(timeout: float = 60.0, pause: float = 0.5):
    """The reference's loaded native library (building it if needed)."""
    from slr_tpu import native

    if native._lib is not None:
        return native._lib
    deadline = time.monotonic() + timeout
    err = None
    with open(os.path.join(tempfile.gettempdir(), LOCK_NAME), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                native._lib_failed = False
                try:
                    lib = native.get_lib()
                except OSError as e:        # a half-written library
                    lib, err = None, e
                if lib is not None:
                    return lib
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"the reference's SBVH library {native._LIB_PATH} "
                        f"did not load within {timeout} s (last error: "
                        f"{err})")
                time.sleep(pause)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def test_reloads_after_a_failed_build():
    """A failed earlier build (the sticky flag the race leaves) no longer
    sends the reference's builder to LBVH: the helper reloads the library
    and the reference's Cornell tables are SBVH again, with more triangle
    references than triangles (spatial splits put a triangle in several
    chunks)."""
    from slr_tpu import native
    from slr_tpu.scene.presets import cornell_box_spheres

    native._lib, native._lib_failed = None, True
    assert native.get_lib() is None          # what the race leaves behind
    assert load_reference_sbvh() is not None
    assert not native._lib_failed
    scene = cornell_box_spheres(sphere_res=8)
    pt = scene.pallas_tris
    n_refs = int((np.asarray(pt.remap) >= 0).sum())
    assert scene.bvh is not None
    assert n_refs > scene.geometry.num_tris


def test_fails_loudly_naming_the_library(monkeypatch):
    """A library that never loads raises, naming its path, within the
    bound."""
    from slr_tpu import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="libslr_native.so"):
        load_reference_sbvh(timeout=0.2, pause=0.05)
