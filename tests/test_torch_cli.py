"""The command line, `python -m slr_tpu_torch`, on the CPU: its exports,
checkpoint and resume, and its film against slr_tpu's CLI on the same scene
file and pass schedule (the criterion of
test_torch_wavefront.py::test_depth100_matches_reference)."""
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from slr_tpu_torch.__main__ import main
from test_torch_reference_build import load_reference_sbvh

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_sbvh():
    """Reference tables are built with the SBVH library loaded (see
    test_torch_reference_build.py)."""
    load_reference_sbvh()


SCENE = os.path.join(os.path.dirname(__file__), "parity_scenes",
                     "Cornell_Box_Parity.txt")
ARGS = [SCENE, "--cpu", "--width", "32", "--height", "24", "--spp", "4",
        "--spectral", "--format", "bmp"]


def _film(state) -> np.ndarray:
    return (np.asarray(state["accum"]) + np.asarray(state["comp"])) \
        / int(state["done"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's CLI and the reference's on the same arguments, each into
    its own directory."""
    import jax

    from slr_tpu import __main__ as ref_main

    port_dir = tmp_path_factory.mktemp("port")
    ref_dir = tmp_path_factory.mktemp("ref")
    result = main(ARGS + ["--out", str(port_dir), "-v"])
    # The reference's CLI reads sys.argv and points JAX's compile cache at
    # the user's home; keep the test process's configuration.
    with mock.patch.object(sys, "argv", ["slr_tpu"] + ARGS
                           + ["--out", str(ref_dir)]), \
            mock.patch.object(jax.config, "update"):
        ref_main.main()
    return port_dir, ref_dir, result


def test_exports_match_reference(runs):
    port_dir, ref_dir, result = runs
    images = ["000.bmp", "001.bmp", "002.bmp"]
    assert sorted(os.listdir(port_dir)) == images + ["checkpoint.npz"]
    assert sorted(n for n in os.listdir(ref_dir) if n.endswith(".bmp")) == \
        images
    assert result["spp"] == 4 and [p[0] for p in result["passes"]] == [1, 1, 2]
    assert all(p[2] > 0 for p in result["passes"])
    assert result["lanes"] == 32 * 24


def test_film_matches_reference(runs):
    from slr_tpu.utils.checkpoint import load_checkpoint as ref_load

    port_dir, ref_dir, _ = runs
    with np.load(port_dir / "checkpoint.npz") as z:
        film = _film(z)
    ref = _film(ref_load(str(ref_dir / "checkpoint")))
    assert film.shape == ref.shape == (24, 32, 3)
    assert np.isfinite(film).all()
    close = np.abs(film - ref) <= 1e-3 * np.abs(ref) + 1e-6
    assert close.all(axis=-1).mean() >= 0.98
    assert abs(film.mean() / ref.mean() - 1.0) < 0.01


def test_resume_continues_bit_for_bit(runs, tmp_path):
    port_dir, _, _ = runs
    out = ["--out", str(tmp_path)]
    main([a if a != "4" else "2" for a in ARGS] + out)
    assert sorted(os.listdir(tmp_path)) == ["000.bmp", "001.bmp",
                                            "checkpoint.npz"]
    result = main(ARGS + out + ["--resume"])
    assert [p[0] for p in result["passes"]] == [2]
    with np.load(port_dir / "checkpoint.npz") as a, \
            np.load(tmp_path / "checkpoint.npz") as b:
        for k in ("accum", "comp", "done"):
            np.testing.assert_array_equal(a[k], b[k])
    assert (port_dir / "002.bmp").read_bytes() == \
        (tmp_path / "002.bmp").read_bytes()


def test_check_raises_on_a_non_finite_film(tmp_path):
    def bad_render(scene, width, height, **kw):
        img = torch.zeros((height, width, 3))
        img[0, 0, 1] = float("nan")
        return img, 1

    with mock.patch("slr_tpu_torch.render.wavefront.render_wavefront",
                    bad_render):
        with pytest.raises(RuntimeError, match="--check"):
            main([SCENE, "--cpu", "--width", "8", "--height", "6", "--spp",
                  "1", "--check", "--out", str(tmp_path)])


def test_verbose_profile_and_png(tmp_path, capsys):
    main([SCENE, "--cpu", "--width", "8", "--height", "6", "--spp", "1",
          "--max-depth", "3", "-v", "--profile", str(tmp_path / "trace"),
          "--out", str(tmp_path / "out")])
    assert "iterations" in capsys.readouterr().out
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert (tmp_path / "out" / "000.png").read_bytes()[:4] == b"\x89PNG"


def test_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main([SCENE, "--spp", "1", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("extra, item", [
    pytest.param(["--renderer", "bpt"], "A14", id="extra1-A14"),
    pytest.param(["--renderer", "sppm"], "A15", id="extra2-A15"),
    pytest.param(["--renderer", "amcmcppm"], "A15", id="extra3-A15"),
    pytest.param(["--scene-shard"], "A16", id="extra4-A16")])
def test_unported_renderers_raise(tmp_path, extra, item):
    with pytest.raises(NotImplementedError, match=item):
        main([SCENE, "--cpu", "--out", str(tmp_path)] + extra)


def test_kahan_film_matches_reference():
    """kahan_add and CompensatedFilm against slr_tpu's on seeded passes
    whose sum spans many orders of magnitude: bit for bit."""
    from slr_tpu.render import film as jfilm

    from slr_tpu_torch.render.film import CompensatedFilm, kahan_add

    rs = np.random.RandomState(4)
    passes = [(rs.rand(3, 4, 3) * 10.0 ** rs.randint(-6, 6)).astype(
        np.float32) for _ in range(40)]
    film = CompensatedFilm(3, 4, 3, device="cpu")
    ref = jfilm.CompensatedFilm(3, 4, 3)
    total = comp = np.zeros((3, 4, 3), np.float32)
    for p in passes:
        film.add(torch.as_tensor(p))
        ref.add(p)
        total, comp = kahan_add(total, comp, p)
    np.testing.assert_array_equal(film.value.numpy(), np.asarray(ref.value))
    np.testing.assert_array_equal(total + comp, np.asarray(ref.value))
    plain = np.zeros((3, 4, 3), np.float32)
    for p in passes:
        plain += p
    exact = np.sum(np.asarray(passes, np.float64), axis=0)
    assert np.abs(total + comp - exact).max() <= np.abs(plain - exact).max()
