"""The scene-file front end: the port's copies of the DSL lexer and parser,
its scene API and `load_scene`, against slr_tpu's on the same scene text.

`load_scene` of both in-repo scene files is compared leaf by leaf with the
reference's scene carried across (`from_reference`): integer leaves, the
SBVH and the chunk tables exactly; other floats with the rule of
test_torch_scene.py (rtol 1e-6, atol 1e-7: only the camera matrix goes
through each framework's own f32 cos/sin)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from slr_tpu_torch.scene.api import (
    ApiContext,
    load_scene,
    make_global_env,
    read_scene,
)
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.dsl.lexer import tokenize
from slr_tpu_torch.scene.dsl.parser import DSLError, TupleVal, execute
from slr_tpu_torch.scene.graph import SceneDesc, flatten
from test_torch_reference_build import load_reference_sbvh

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_sbvh():
    """Reference tables are built with the SBVH library loaded (see
    test_torch_reference_build.py)."""
    load_reference_sbvh()


SCENES = os.path.join(os.path.dirname(__file__), "parity_scenes")
FILES = ["Cornell_Box_Parity.txt", "Glass_Corridor.txt"]


def run_src(src: str):
    scene = SceneDesc()
    ctx = ApiContext(scene)
    env = make_global_env(ctx)
    execute(src, env, ctx)
    return env, ctx


# -- lexer --------------------------------------------------------------------

@pytest.mark.parametrize("name", FILES)
def test_token_stream_matches_reference(name):
    from slr_tpu.scene.dsl.lexer import tokenize as ref_tokenize

    with open(os.path.join(SCENES, name)) as f:
        src = f.read()
    got = [tuple(t) for t in tokenize(src)]
    want = [tuple(t) for t in ref_tokenize(src)]
    assert got == want and len(got) > 500


# -- the language (the cases of tests/test_dsl.py) ------------------------------

def test_arithmetic_and_vars():
    env, _ = run_src("x = 1 + 2 * 3; y = (1 + 2) * 3; z = x - y;")
    assert (env.lookup("x"), env.lookup("y"), env.lookup("z")) == (7, 9, -2)


def test_comparison_logic():
    env, _ = run_src("a = 1 < 2 && 3 >= 3; b = !a || 1 == 2;")
    assert env.lookup("a") is True and env.lookup("b") is False


def test_if_else_for():
    env, _ = run_src(
        "total = 0; for (i = 0; i < 5; ++i) { if (i % 2 == 0) total += i; }")
    assert env.lookup("total") == 6


def test_function_def_and_call():
    env, _ = run_src(
        "function sq(x) { return x * x; } function add(a, b = 10) "
        "{ return a + b; } r1 = sq(5); r2 = add(3); r3 = add(3, 4);")
    assert (env.lookup("r1"), env.lookup("r2"), env.lookup("r3")) == \
        (25, 13, 7)


def test_tuples():
    env, _ = run_src(
        't = (1, 2, "k": 3); n = numElements(t); e0 = t[0]; e1 = t[1];')
    assert (env.lookup("n"), env.lookup("e0"), env.lookup("e1")) == (3, 1, 2)
    assert env.lookup("t").named()["k"] == 3


def test_single_element_tuple_and_empty():
    env, _ = run_src("t1 = (5,); t0 = (,); p = (5);")
    assert isinstance(env.lookup("t1"), TupleVal)
    assert len(env.lookup("t1")) == 1 and len(env.lookup("t0")) == 0
    assert env.lookup("p") == 5


def test_transforms_compose():
    env, _ = run_src("m = translate(1, 2, 3) * scale(2); r = rotateY(0.3);")
    m = env.lookup("m")
    assert isinstance(m, np.ndarray) and m.dtype == np.float32
    np.testing.assert_allclose(m[:3, 3], [1, 2, 3])
    np.testing.assert_allclose(np.diag(m)[:3], [2, 2, 2])
    from slr_tpu.core import math3d as jm

    np.testing.assert_allclose(env.lookup("r"), np.asarray(jm.mat_rotate_y(0.3)),
                               rtol=1e-6, atol=1e-7)


def test_spectrum_overloads():
    env, _ = run_src(
        's1 = Spectrum(0.75, 0.25, 0.5); s2 = Spectrum("Reflectance", 1.0); '
        's3 = Spectrum("ID": "D65") * 4; s4 = Spectrum("ID": "Aluminium", 1);')

    def deg(v):
        return v / 12.92 if v <= 0.04045 else ((v + 0.055) / 1.055) ** 2.4

    s1 = env.lookup("s1")
    assert s1.kind == "rgb"
    np.testing.assert_allclose(s1.rgb, (deg(0.75), deg(0.25), deg(0.5)),
                               rtol=1e-6)
    s2 = env.lookup("s2")
    assert s2.kind == "mono" and s2.value == 1.0
    s3 = env.lookup("s3")
    assert s3.kind == "library" and s3.library_id == "D65" and s3.scale == 4
    assert env.lookup("s4").library_comp == 1


def test_spectrum_color_spaces():
    from slr_tpu_torch.spectrum.spectral import _sRGB_E_to_XYZ

    env, _ = run_src(
        's_lin = Spectrum("Reflectance", "Rec709", 0.5, 0.5, 0.5); '
        's_xyz = Spectrum("Reflectance", "XYZ", 0.3, 0.4, 0.3);')
    np.testing.assert_allclose(env.lookup("s_lin").rgb, (0.5, 0.5, 0.5))
    xyz = np.asarray(_sRGB_E_to_XYZ, np.float64) @ np.asarray(
        env.lookup("s_xyz").rgb)
    np.testing.assert_allclose(xyz, (0.3, 0.4, 0.3), atol=1e-6)


def test_string_comparison_switchlike():
    env, _ = run_src('name = "abc"; eq = name == "abc";')
    assert env.lookup("eq") is True


def test_errors_are_dsl_errors():
    with pytest.raises(DSLError):
        run_src("x = translate(1, 2);")


# -- load_scene against the reference -------------------------------------------

def _leaves(obj, path=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for name in obj._fields:
            yield from _leaves(getattr(obj, name), f"{path}.{name}")
    else:
        yield path, obj


def _compare(port, carried) -> int:
    n = 0
    got = dict(_leaves(port))
    want = dict(_leaves(carried))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        n += 1
        if not isinstance(w, torch.Tensor):       # static metadata
            assert g == w, path
            continue
        g, w = g.numpy(), w.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        exact = (g.dtype.kind in "iub" or path.startswith((".pallas_tris",
                                                           ".bvh")))
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=path)
    return n


@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
@pytest.mark.parametrize("name", FILES)
def test_load_scene_matches_reference(name, spectral):
    from slr_tpu.scene.api import load_scene as ref_load_scene

    path = os.path.join(SCENES, name)
    rsc, r_cfg, r_set = ref_load_scene(path, spectral=spectral)
    port, cfg, settings = load_scene(path, spectral=spectral, device="cpu")
    assert (cfg, settings) == (r_cfg, r_set)
    carried = from_reference(rsc)
    carried.plucker = None
    assert _compare(port, carried) > 70
    assert port.bvh is not None and port.stex.spectral == spectral
    if name.startswith("Cornell"):
        assert port.geometry.num_tris == 1932 and port.lights.num == 2
        assert port.lobe_kinds_present == (1, 3, 4)


def test_load_scene_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_scene(os.path.join(SCENES, FILES[1]))


def test_morton_tables_on_request():
    port, _, _ = load_scene(os.path.join(SCENES, FILES[0]), use_bvh=False,
                            device="cpu")
    assert port.bvh is None and int(port.pallas_tris.n_valid.sum()) == 1932


# -- the shading kinds (ROADMAP Q3), once refused, against the reference ------

_QUAD = """
m = createMesh(
  (((0, 0, 0), (0, 0, 1), (1, 0, 0), (0, 0)),
   ((1, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0)),
   ((1, 1, 0), (0, 0, 1), (1, 0, 0), (1, 1))),
  ((mat, ((0, 1, 2),)),));
addChild(root, m);
"""


def _ref_flatten(src: str, spectral: bool = False, base_dir: str = "."):
    from slr_tpu.scene.api import ApiContext as RCtx
    from slr_tpu.scene.api import make_global_env as ref_env
    from slr_tpu.scene.dsl.parser import execute as ref_execute
    from slr_tpu.scene.graph import SceneDesc as RDesc
    from slr_tpu.scene.graph import flatten as ref_flatten

    rscene = RDesc()
    rctx = RCtx(rscene, base_dir=base_dir)
    ref_execute(src, ref_env(rctx), rctx)
    carried = from_reference(ref_flatten(rscene, spectral=spectral))
    carried.plucker = None
    return carried


@pytest.mark.parametrize("mat", [
    'createSurfaceMaterial("microfacet metal", (SpectrumTexture(Spectrum('
    '"ID": "Aluminium", 0)), SpectrumTexture(Spectrum("ID": "Aluminium", 1)),'
    ' FloatTexture(0.2)))',
    'createSurfaceMaterial("matte", (SpectrumTexture(Spectrum(0.5)), '
    'FloatTexture(0.3)))',
    'createSurfaceMaterial("Ward", (SpectrumTexture(Spectrum(0.5)), '
    'FloatTexture(0.1), FloatTexture(0.2)))',
    'createSurfaceMaterial("matte", (SpectrumTexture("checker board", '
    '(Spectrum(1, 1, 1), Spectrum(0, 0, 0))),))',
], ids=["microfacet", "oren-nayar", "ward", "checker"])
def test_unported_kinds_raise_naming_q3(mat):
    """The four kinds this test once saw refused (ROADMAP Q3) flatten now,
    leaf for leaf as the reference flattens them."""
    src = f"mat = {mat};" + _QUAD
    _, ctx = run_src(src)
    assert _compare(flatten(ctx.scene), _ref_flatten(src)) > 70


def test_image_files_raise_naming_q3(tmp_path, caplog):
    """A missing image file gets the reference's procedural sky and its
    warning (it once raised, ROADMAP Q3): as a texture and as the
    environment, which then leads the light table with its share."""
    from slr_tpu.scene.api import _placeholder_sky as ref_sky

    env, _ = run_src('img = Image2D("sky.png");')
    np.testing.assert_array_equal(env.lookup("img"), ref_sky())
    scene = tmp_path / "env.txt"
    scene.write_text('setEnvironment("sky.exr", 2.0);' + _QUAD.replace(
        "mat, ", 'createSurfaceMaterial("matte", '
        '(SpectrumTexture(Spectrum(0.5)),)), '))
    with caplog.at_level("WARNING", logger="slr_tpu_torch"):
        desc, _ = read_scene(str(scene))
    assert any("unavailable" in r.getMessage() for r in caplog.records)
    np.testing.assert_array_equal(desc.env_image, ref_sky())
    assert desc.env_scale == 2.0
    port, _, _ = load_scene(str(scene), device="cpu")
    assert port.has_env and float(port.lights.env_prob) == 1.0
    assert tuple(port.env.dist.shape) == ref_sky().shape[:2]


def test_missing_models_get_placeholders():
    """load3DModel of an absent asset: the reference's placeholder shapes
    (a UV sphere, a Cornell shell, a cube), as slr_tpu builds them."""
    from slr_tpu.scene.api import ApiContext as RCtx
    from slr_tpu.scene.api import make_global_env as ref_env
    from slr_tpu.scene.dsl.parser import execute as ref_execute
    from slr_tpu.scene.graph import SceneDesc as RDesc
    from slr_tpu.scene.graph import flatten as ref_flatten

    src = ('a = load3DModel("models/sphere.assbin"); '
           'b = load3DModel("models/Cornell_box.assbin"); '
           'c = load3DModel("models/box.assbin"); setTransform(c, '
           'translate(0, 1, 0) * scale(0.3)); addChild(root, a); '
           'addChild(root, b); addChild(root, c);')
    _, ctx = run_src(src)
    port = flatten(ctx.scene, use_bvh=False)
    rscene = RDesc()
    rctx = RCtx(rscene)
    ref_execute(src, ref_env(rctx), rctx)
    carried = from_reference(ref_flatten(rscene, use_bvh=False))
    carried.plucker = None
    assert _compare(port, carried) > 70
    assert port.geometry.num_tris == 3968 + 10 + 12   # sphere, shell, cube
