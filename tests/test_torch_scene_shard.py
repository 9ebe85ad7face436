"""Scene sharding by range on gloo worlds of 2 and 3 CPU processes:
slr_tpu_torch's padding and sharding helpers, occluded_scene_sharded and
render_pt_scene_sharded against slr_tpu's on meshes of as many virtual
devices; each rank's table bytes; the instanced branch; alpha recasts on a
grazing ray.

The textured scene (an image texture, a normal map, an alpha cutout and an
area light) is built by each package's own SceneBuilder. Its render reads
every shading row through the sharded row gather and every texel through
the sharded atlas (`ShardedAtlas`), which the traced scene carries as its
image atlas."""
import numpy as np
import pytest
import torch

from slr_tpu_torch.parallel import scene_shard as ss
from slr_tpu_torch.parallel.mesh import make_mesh, render_wavefront_sharded
from slr_tpu_torch.render import pt as tpt
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.build import SceneBuilder as TBuilder
from slr_tpu_torch.scene.presets import grass_field
from test_torch_reference_build import load_reference_sbvh
from torch_dist_worker import run_ranks
from torch_shard_scenes import random_rays, textured_scene

torch.set_num_threads(1)

WORLDS = (2, 3)
O, D = random_rays(512, 0.8)
TEX = dict(width=16, height=12, spp=2)
TEX_KW = dict(seed=3, max_depth=3)


@pytest.fixture(scope="module")
def scenes():
    """name -> (reference scene or None, the port's CPU scene)."""
    load_reference_sbvh()
    from slr_tpu.scene.build import SceneBuilder as JBuilder
    from slr_tpu.scene.presets import cornell_box_spheres

    cornell = cornell_box_spheres(sphere_res=8)
    return dict(cornell=(cornell, from_reference(cornell)),
                textured=(textured_scene(JBuilder), textured_scene(TBuilder)),
                grass=(None, grass_field(n_side=4, animated_fraction=0.5,
                                         device="cpu")))


def _tex_args():
    return (TEX["width"], TEX["height"], TEX["spp"]), TEX_KW


@pytest.fixture(scope="module")
def worlds(scenes, tmp_path_factory):
    """world size -> each rank's [occluded, textured render, Cornell shard,
    textured shard, instanced render]."""
    a, k = _tex_args()
    jobs = [("occluded", (scenes["cornell"][1], O, D, 1e-4, 2.0), {}),
            ("render_pt_scene_sharded", (scenes["textured"][1],) + a, k),
            ("shard", (scenes["cornell"][1],), {}),
            ("shard", (scenes["textured"][1],), {}),
            ("render_pt_scene_sharded", (scenes["grass"][1], 12, 8, 2),
             dict(seed=1, max_depth=5))]
    return {n: run_ranks(n, jobs, str(tmp_path_factory.mktemp(f"w{n}")))
            for n in WORLDS}


@pytest.mark.parametrize("n", [2, 3, 5])
def test_sharding_helpers_match_reference(scenes, n):
    """The padded chunk tables, tri rows and image atlas, integers bit for
    bit, floats exactly."""
    import jax.numpy as jnp
    from slr_tpu.parallel import scene_shard as ref

    r, p = scenes["textured"]
    for rs, ps in ((scenes["cornell"][0].pallas_tris,
                    scenes["cornell"][1].pallas_tris),
                   (r.pallas_tris, p.pallas_tris)):
        want = ref.shard_chunk_tables(rs, n)
        got = ss.shard_chunk_tables(ps, n)
        assert got.n_chunks % n == 0
        for name in ("tris", "boxes", "remap", "entry_chunk", "entry_inst",
                     "inst_trs"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
    rows_w, per_w = ref.shard_tri_rows(r.geometry.tri_table, n)
    rows_g, per_g = ss.shard_tri_rows(p.geometry.tri_table, n)
    assert per_g == per_w
    np.testing.assert_array_equal(rows_g.numpy(), np.asarray(rows_w))
    img_w, pi_w = ref.shard_image_atlas(jnp.asarray(r.stex.images), n)
    img_g, pi_g = ss.shard_image_atlas(p.stex.images, n)
    assert pi_g == pi_w
    np.testing.assert_array_equal(img_g.numpy(), np.asarray(img_w))


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_occlusion_matches_reference(scenes, worlds, n):
    import jax.numpy as jnp
    from slr_tpu.parallel.mesh import make_mesh as ref_mesh
    from slr_tpu.parallel.scene_shard import occluded_scene_sharded as ref

    want = np.asarray(ref(scenes["cornell"][0], ref_mesh(n), jnp.asarray(O),
                          jnp.asarray(D), 1e-4, 2.0))
    got = worlds[n][0][0]
    np.testing.assert_array_equal(got, want)
    one = tpt.scene_occluded(scenes["cornell"][1], torch.as_tensor(O),
                             torch.as_tensor(D), 1e-4, 2.0).numpy()
    np.testing.assert_array_equal(got, one)
    assert 0.05 < got.mean() < 0.95


@pytest.mark.parametrize("n", WORLDS)
def test_textured_render_matches_reference(scenes, worlds, n):
    """Image texture, normal map and alpha cutout through the sharded rows
    and atlas, against the reference's sharded render on as many devices
    and the port's unsharded `render`."""
    from slr_tpu.parallel.mesh import make_mesh as ref_mesh
    from slr_tpu.parallel.scene_shard import render_pt_scene_sharded as ref

    r, p = scenes["textured"]
    assert r.has_alpha and r.has_normal_map and p.stex.images.shape[0] >= 3
    a, k = _tex_args()
    want = np.asarray(ref(r, ref_mesh(n), *a, **k))
    got = worlds[n][0][1]
    assert got.shape == want.shape == (TEX["height"], TEX["width"], 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    one = tpt.render(p, *a, device="cpu", **k).numpy()
    np.testing.assert_array_equal(got, one)
    for rank in range(1, n):
        np.testing.assert_array_equal(worlds[n][rank][1], got)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("which", [2, 3], ids=["cornell", "textured"])
def test_rank_holds_its_share_of_the_tables(worlds, n, which):
    """Chunk tables (with their kernel rows and slot vertices), shading
    rows and atlas: each rank holds at most 1/N of the whole plus one chunk
    (one row, one image)."""
    for rank in range(n):
        s = worlds[n][rank][which]
        assert s["bytes"]["pallas_tris"] <= (s["whole"]["pallas_tris"] / n
                                             + s["chunk"])
        assert s["bytes"]["tri_rows"] <= s["whole"]["tri_rows"] / n + 160
        assert s["bytes"]["atlas"] <= s["whole"]["atlas"] / n + s["image"]
    if which == 3:
        assert s["bytes"]["atlas"] > 0


@pytest.mark.parametrize("n", WORLDS)
def test_instanced_scene_renders_replicated(scenes, worlds, n):
    """An instanced scene does not shard by range: the sharded wavefront
    renders it (the reference passes it that function's arguments in the
    wrong order, scene_shard.py:312, and fails)."""
    got = worlds[n][0][4]
    want = render_wavefront_sharded(scenes["grass"][1], 12, 8, 2,
                                    make_mesh("cpu"), seed=1,
                                    max_depth=5).numpy()
    assert got.shape == (8, 12, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    with pytest.raises(ValueError, match="instanced"):
        ss.shard_scene(scenes["grass"][1], make_mesh("cpu"))


def test_grazing_alpha_ray_advances():
    """A ray grazing a cut-out card (test_torch_env_alpha.py's case): the
    sharded recast steps from the cast's own t, so one recast ends the
    loop; the reference's rule (the Möller-Trumbore t) would find the same
    triangle again, forever."""
    b = TBuilder()
    mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
    quad = (np.float32([[0, 0, 1]] * 4), np.float32([[1, 0, 0]] * 4),
            np.float32([[0, 0], [1, 0], [1, 1], [0, 1]]),
            np.int32([[0, 1, 2], [0, 2, 3]]))
    b.add_mesh(np.float32([[-0.9, 0.35, 1.15], [0.1, 0.35, 1.15],
                           [0.1, 1.55, 1.15], [-0.9, 1.55, 1.15]]), *quad,
               mat, alpha_ftex=b.add_ftex_const(0.0))
    b.add_mesh(np.float32([[-3, -3, -2], [3, -3, -2], [3, 3, -2],
                           [-3, 3, -2]]), *quad, mat)
    scene = b.build(use_bvh=False)
    o = torch.tensor([[-2.0649166107177734, -0.34723100066185,
                       1.1500002145767212]])
    d = torch.tensor([[0.8896901607513428, 0.45656484365463257,
                       -1.0005462058870762e-07]])
    sh = ss.shard_scene(scene, make_mesh("cpu"))
    first = sh._cast_closest(o, d, 1e-4, float("inf"), None)
    assert int(first.tri) == 0 and float(first.t_cast - first.t) > 0.1
    casts = []
    cast = sh._cast_closest

    def counted(*args):
        casts.append(1)
        assert len(casts) < 10, "the recast loop makes no progress"
        return cast(*args)

    sh._cast_closest = counted
    tpt.reset_alpha_recasts()
    hit = sh.intersect(sh.scene, o, d)
    assert not bool(hit.mask.any()) and len(casts) == 2
    assert tpt.ALPHA_RECASTS == {"casts": 1, "rays": 1}


def test_texel_fetch_is_data():
    """The atlas says how its texels are fetched: a tensor is indexed, a
    `ShardedAtlas` gathers; no module state is installed."""
    from slr_tpu_torch.scene import textures

    assert not any("OVERRIDE" in name for name in vars(textures))
    imgs = torch.rand((3, 4, 5, 4))
    hw = torch.tensor([[4, 5], [2, 3], [4, 4]], dtype=torch.int32)
    iid = torch.tensor([0, 1, 2, 2, 7, -1])
    u = torch.tensor([0.1, 0.5, 0.9, 1.3, 0.2, -0.4])
    v = torch.tensor([0.7, 0.2, 0.5, 0.0, 0.99, 0.3])
    want = textures._image_fetch(imgs, hw, iid, u, v)
    atlas = ss.ShardedAtlas(make_mesh("cpu"), imgs, 3, 3)
    assert atlas.shape == imgs.shape
    np.testing.assert_array_equal(
        textures._image_fetch(atlas, hw, iid, u, v).numpy(), want.numpy())
