"""The slice as a whole: chip_smoke's shading scene (every lobe, texture and
image kind, the environment light, alpha cutouts, a normal map, an .assbin
model), written small by `write_shading_scene` (32x32 textures, a 32x64
sky), loaded by both packages in RGB and spectral mode and compared leaf by
leaf; rendered by both, spectral, at 32x24, spp 2, depth 6; and run through
`python -m slr_tpu_torch --cpu` in RGB.

Tolerance: integer leaves, the SBVH and the chunk tables exactly; other
float leaves within rtol 1e-5, atol 1e-6 (the PNG de-gamma's f32 pow and
the environment map's sums and prefix sums round by framework). The render
on at least 99.5% of pixels within rtol 1e-3 and image means within 1e-3
relative: a path whose decision flips on rounding differs from there on (as
tests/test_torch_wavefront.py states); measured 100% of pixels, means
within 2e-7."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import write_shading_scene
from slr_tpu_torch.render import pt as tpt
from slr_tpu_torch.render.wavefront import render_wavefront
from slr_tpu_torch.scene.api import load_scene
from slr_tpu_torch.scene.bridge import from_reference
from test_torch_reference_build import load_reference_sbvh

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_sbvh():
    """Reference tables are built with the SBVH library loaded (see
    test_torch_reference_build.py)."""
    load_reference_sbvh()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    return write_shading_scene(str(tmp_path_factory.mktemp("shading")),
                               tex=32, sky=(32, 64), seed=0)


@pytest.fixture(scope="module")
def loaded(scene_file):
    from slr_tpu.scene.api import load_scene as ref_load_scene

    out = {}
    for spectral in (False, True):
        ref, r_cfg, r_set = ref_load_scene(scene_file, spectral=spectral)
        port, cfg, settings = load_scene(scene_file, spectral=spectral,
                                         device="cpu")
        assert (cfg, settings) == (r_cfg, r_set)
        out[spectral] = (ref, port)
    return out


def _leaves(obj, path=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for name in obj._fields:
            yield from _leaves(getattr(obj, name), f"{path}.{name}")
    else:
        yield path, obj


@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_scene_matches_reference(loaded, spectral):
    ref, port = loaded[spectral]
    carried = from_reference(ref)
    carried.plucker = None
    got, want = dict(_leaves(port)), dict(_leaves(carried))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if not isinstance(w, torch.Tensor):           # static metadata
            assert g == w, path
            continue
        g, w = g.numpy(), w.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if g.dtype.kind in "iub" or path.startswith((".pallas_tris", ".bvh")):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=path)
    assert len(want) > 80
    # Every feature of the slice is in the scene.
    assert port.lobe_kinds_present == (1, 2, 3, 5, 6, 7, 8, 10)
    assert port.has_alpha and port.has_env and port.has_normal_map
    assert port.stex.images.shape[0] == 4 and port.stex.has_checker
    assert port.stex.has_voronoi and port.ftex.has_voronoi
    assert port.ftex.has_image and port.ftex.has_one_minus
    assert port.geometry.num_tris == 19868


def test_render_matches_reference(loaded):
    """Spectral, 32x24, spp 2, depth 6 (the reference's compile of this
    scene takes ~3 minutes of the test, its render seconds)."""
    from slr_tpu.render.wavefront import render_wavefront as ref_render

    ref_scene, _ = loaded[True]
    want, ref_it = ref_render(ref_scene, 32, 24, spp=2, seed=1, max_depth=6,
                              return_iters=True)
    want = np.asarray(want)
    tpt.reset_alpha_recasts()
    got, it = render_wavefront(from_reference(ref_scene), 32, 24, spp=2,
                               seed=1, max_depth=6, return_iters=True,
                               device="cpu")
    got = got.numpy()
    assert it == ref_it and tpt.ALPHA_RECASTS["casts"] > 0
    assert np.isfinite(got).all()
    close = (np.abs(got - want) <= 1e-3 * np.abs(want) + 1e-6).all(-1)
    assert close.mean() >= 0.995
    assert abs(got.mean() / want.mean() - 1.0) < 1e-3


def test_cli_renders_the_scene(scene_file, tmp_path):
    """RGB, with --check: no film texel may be negative or non-finite (the
    spectral film's sRGB conversion makes negative channels on noisy
    pixels, in the reference as here)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "slr_tpu_torch", scene_file, "--cpu",
         "--width", "16", "--height", "12", "--spp", "2",
         "--max-depth", "4", "--out", str(tmp_path), "--check"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(tmp_path)) == ["000.png", "001.png",
                                            "checkpoint.npz"]
