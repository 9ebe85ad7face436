"""The debug / AOV renderer: slr_tpu_torch's render_aovs against slr_tpu's
on the same scenes carried across, the port's AOVs of the parity scene
against the reference renderer's AOV goldens, and the CLI's debug branch.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slr_tpu_torch.render.debug import render_aovs
from slr_tpu_torch.render.film import save_bmp
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
SCENE = os.path.join(ROOT, "tests", "parity_scenes", "Cornell_Box_Parity.txt")
GOLD = os.path.join(ROOT, "tests", "goldens")
GRASS = dict(n_side=8, blade_segments=3, animated_fraction=0.25)


def _ref_scene(name):
    if name == "parity":
        from slr_tpu.scene.api import load_scene as ref_load_scene

        return ref_load_scene(SCENE, spectral=True)[0]
    from slr_tpu.scene.presets import grass_field

    return grass_field(**GRASS)


@pytest.mark.parametrize("name, size", [("parity", (64, 48)),
                                        ("grass", (48, 36))])
def test_aovs_match_reference(name, size):
    """Same hits (masks and materials equal); normals, tangents, distance
    and uv within 1e-5 on at least 99.5% of the hit pixels (the reference
    casts through its Plücker intersector and two-level structure, the
    port through its chunk kernels: a pixel on a shared edge may take the
    neighbouring triangle). uv is held to 1e-4: on a blade seen almost
    edge-on the barycentrics amplify the rounding of the ray's transform
    into the instance (measured on the grass field: 3 of 434 hit pixels
    beyond 1e-5, at most 4.8e-5; normals within 2e-7, distance within
    2.3e-6)."""
    from slr_tpu.render.debug import render_aovs as ref_render_aovs

    ref_scene = _ref_scene(name)
    w, h = size
    want = ref_render_aovs(ref_scene, w, h)
    got = render_aovs(from_reference(ref_scene), w, h, device="cpu")
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(got.mat_id.numpy(), np.asarray(want.mat_id))
    if name == "grass":
        assert ref_scene.instances is not None
    for field in ("g_normal", "s_normal", "s_tangent", "distance", "uv"):
        a = getattr(got, field).numpy()
        b = np.asarray(getattr(want, field))
        tol = 1e-4 if field == "uv" else 1e-5
        close = np.abs(a - b) <= tol * np.maximum(np.abs(b), 1.0)
        if close.ndim == 3:
            close = close.all(-1)
        assert close[hit].mean() >= 0.995, (field, close[hit].mean())
        assert (a[~hit] == 0).all()


def _load_bmp(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.float32)[:, :, :3]


@pytest.fixture(scope="module")
def parity_aovs():
    scene, _, _ = load_scene(SCENE, spectral=True, device="cpu")
    return render_aovs(scene, 256, 192, device="cpu")


@pytest.mark.parametrize("name, field", [("gnormal", "g_normal"),
                                         ("snormal", "s_normal"),
                                         ("tangent", "s_tangent")])
def test_parity_aov_goldens(parity_aovs, name, field):
    """The gate of tests/test_parity.py:160-183 on the port's own load of
    the parity scene at 256x192: against the reference renderer's AOVs,
    encoded 0.5 n + 0.5 into 8 bits, the mean difference below 2.5 and
    more than 0.96 of the pixels within 8 (its edge pixels differ: the
    reference jitters its one sample per pixel)."""
    gold = _load_bmp(os.path.join(GOLD, f"ref_parity_aov_{name}.bmp"))
    ours = getattr(parity_aovs, field).numpy()
    enc = np.clip((0.5 * ours + 0.5) * 255.0, 0.0, 255.0)
    d = np.abs(enc - gold)
    assert d.mean() < 2.5, d.mean()
    assert (d.max(axis=-1) <= 8.0).mean() > 0.96


def test_cli_writes_the_encoded_aovs(tmp_path):
    """`python -m slr_tpu_torch <scene> --renderer debug --cpu --format bmp`
    writes gnormal, snormal, stangent and distance, byte for byte the
    encoded render_aovs output."""
    out = tmp_path / "cli"
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-m", "slr_tpu_torch", SCENE,
                    "--renderer", "debug", "--cpu", "--format", "bmp",
                    "--width", "64", "--height", "48", "--out", str(out)],
                   check=True, cwd=ROOT, env=env, capture_output=True,
                   timeout=300)
    scene, _, _ = load_scene(SCENE, device="cpu")
    aov = render_aovs(scene, 64, 48, device="cpu")
    dist = aov.distance.numpy()
    want = {"gnormal": aov.g_normal.numpy() * 0.5 + 0.5,
            "snormal": aov.s_normal.numpy() * 0.5 + 0.5,
            "stangent": aov.s_tangent.numpy() * 0.5 + 0.5,
            "distance": np.repeat((dist / dist.max())[..., None], 3, -1)}
    assert sorted(os.listdir(out)) == sorted(f"{k}.bmp" for k in want)
    for name, img in want.items():
        save_bmp(str(tmp_path / f"{name}.bmp"), img)
        assert (out / f"{name}.bmp").read_bytes() == \
            (tmp_path / f"{name}.bmp").read_bytes(), name
