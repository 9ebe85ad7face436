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
    pytest.param(["--scene-shard", "--renderer", "bpt"], "pt",
                 id="extra4-A16")])
def test_unported_renderers_raise(tmp_path, extra, item):
    """Every renderer is ported; scene sharding renders pt only, and asked
    for another renderer it raises before writing anything."""
    with pytest.raises(ValueError, match=item):
        main([SCENE, "--cpu", "--out", str(tmp_path)] + extra)
    assert not os.listdir(tmp_path)


SMALL = [SCENE, "--cpu", "--width", "16", "--height", "12", "--format",
         "bmp"]


def _checkpoints_equal(a, b) -> None:
    with np.load(a / "checkpoint.npz") as x, np.load(b / "checkpoint.npz") \
            as y:
        for k in ("accum", "comp", "done"):
            np.testing.assert_array_equal(x[k], y[k])


def test_bpt_exports_checkpoint_and_resume(tmp_path):
    """--renderer bpt: the power-of-two exports and checkpoints of the path
    tracer, and --resume carries on bit for bit."""
    whole, half = tmp_path / "whole", tmp_path / "half"
    bpt = SMALL + ["--renderer", "bpt"]
    result = main(bpt + ["--spp", "4", "--out", str(whole)])
    assert sorted(os.listdir(whole)) == ["000.bmp", "001.bmp", "002.bmp",
                                         "checkpoint.npz"]
    assert [p[0] for p in result["passes"]] == [1, 1, 2]
    # One bpt_batch call per sample (one batch of lanes), and the deep
    # re-runs of the lanes clipped at the base cap.
    assert sum(p[2] for p in result["passes"]) == 4 + result["deep_passes"]
    with np.load(whole / "checkpoint.npz") as z:
        film = (z["accum"] + z["comp"]) / int(z["done"])
    assert film.shape == (12, 16, 3) and np.isfinite(film).all()
    assert film.mean() > 0.01
    main(bpt + ["--spp", "2", "--out", str(half)])
    again = main(bpt + ["--spp", "4", "--out", str(half), "--resume"])
    assert [p[0] for p in again["passes"]] == [2]
    _checkpoints_equal(whole, half)
    assert (whole / "002.bmp").read_bytes() == (half / "002.bmp").read_bytes()


def test_scene_method_bpt_renders_bpt(tmp_path):
    """A scene file whose renderer is BPT renders BPT without --renderer:
    the same film as --renderer bpt on the PT scene file."""
    with open(SCENE) as f:
        text = f.read()
    assert '"method": "PT"' in text
    scene = tmp_path / "bpt_scene.txt"
    scene.write_text(text.replace('"method": "PT"', '"method": "BPT"'))
    by_file, by_flag = tmp_path / "file", tmp_path / "flag"
    args = SMALL[1:] + ["--spp", "1"]
    main([str(scene)] + args + ["--out", str(by_file)])
    main([SCENE, "--renderer", "bpt"] + args + ["--out", str(by_flag)])
    _checkpoints_equal(by_file, by_flag)


@pytest.mark.parametrize("method", ["sppm", "amcmcppm"])
def test_photon_mapping_renderers(tmp_path, method):
    """--renderer sppm / amcmcppm: --spp waves of photon paths (twice as
    many with the chains), bounces capped at --max-depth, written to
    ppm.<format>; the chains' bookkeeping within its bounds. The wave is
    the reference CLI's 32,768 photon paths, cut to 2,048 here: the plain
    traversal of 65,536 rays a bounce takes minutes on one CPU thread."""
    from slr_tpu_torch import __main__ as cli

    assert cli.PPM_PHOTON_PATHS == 1 << 15
    paths = 2048
    with mock.patch.object(cli, "PPM_PHOTON_PATHS", paths):
        res = main(SMALL + ["--renderer", method, "--spp", "2",
                            "--max-depth", "4", "--check", "--out",
                            str(tmp_path)])
    assert os.listdir(tmp_path) == ["ppm.bmp"]
    img = res["image"]
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01 and (img >= 0).all()
    mcmc = method == "amcmcppm"
    assert res["waves"] == 2
    assert res["photon_paths"] == 2 * paths * (2 if mcmc else 1)
    if mcmc:
        assert res["n_uniform"] == 2 * paths
        assert 0 <= res["n_visible"] <= res["n_uniform"]
        # float32, clipped to [1e-4, 1]: its floor is float32(1e-4).
        assert np.float32(1e-4) <= res["mutation_size"] <= 1.0
    else:
        assert res["n_uniform"] == 0 and res["mutation_size"] == 1.0


def test_photon_mapping_refuses_spectral(tmp_path):
    """Photon mapping is RGB only, in the reference too."""
    with pytest.raises(ValueError, match="RGB only"):
        main(SMALL + ["--spectral", "--renderer", "sppm", "--spp", "1",
                      "--out", str(tmp_path)])


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


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(n, argv_of_rank, timeout=300):
    """Run the CLI as torchrun would: n processes with RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT; returns their outputs."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=root)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "slr_tpu_torch"] + argv_of_rank(r),
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return outs


@pytest.mark.parametrize("extra", [[], ["--scene-shard"],
                                   ["--renderer", "bpt"]],
                         ids=["pt", "scene-shard", "bpt"])
def test_two_gloo_ranks_write_one_set_of_exports(tmp_path, extra):
    """`python -m slr_tpu_torch` on two CPU ranks (gloo), each given its
    own --out and --profile: rank 0 writes the exports, the checkpoint and
    the trace and reports the passes' rate, rank 1 nothing, and they are
    world 1's (pt: the ranks' films summed in another order; --scene-shard
    and bpt, which rank 0 renders alone: bit for bit)."""
    args = SMALL + ["--spp", "2"] + extra
    outs = _ranks(2, lambda r: args + [
        "--out", str(tmp_path / f"r{r}"), "-v",
        "--profile", str(tmp_path / f"trace{r}")])
    one = tmp_path / "one"
    main(args + ["--out", str(one)])
    names = ["000.bmp", "001.bmp", "checkpoint.npz"]
    assert sorted(os.listdir(tmp_path / "r0")) == sorted(os.listdir(one)) \
        == names
    assert not (tmp_path / "r1").exists()
    assert "samples" in outs[0] and "samples" not in outs[1]
    # The passes' rate and the first pass's trace: rank 0 only.
    assert "ksamples/s" in outs[0] and "ksamples/s" not in outs[1]
    assert os.path.getsize(tmp_path / "trace0" / "trace.json") > 0
    assert not (tmp_path / "trace1").exists()
    with np.load(tmp_path / "r0" / "checkpoint.npz") as x, \
            np.load(one / "checkpoint.npz") as y:
        assert int(x["done"]) == int(y["done"]) == 2
        if extra:
            np.testing.assert_array_equal(x["accum"], y["accum"])
        else:
            np.testing.assert_allclose(x["accum"], y["accum"], rtol=2e-4,
                                       atol=1e-5)
    for name in names[:2]:
        a = np.frombuffer((tmp_path / "r0" / name).read_bytes(), np.uint8)
        b = np.frombuffer((one / name).read_bytes(), np.uint8)
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b).max() <= (0 if extra else 1)
