"""Scenes and ray sets the port's scene-sharding tests share (no tests
here). `textured_scene` is tests/test_parallel.py's
TestSceneShardedTextured scene, built by whichever package's SceneBuilder is
given: an image-textured wall, a normal-mapped floor, a half cut-out card
and a small area light."""
import numpy as np


def textured_scene(builder_cls):
    b = builder_cls()
    img = np.zeros((8, 8, 3), np.float32)
    img[::2, ::2] = (0.9, 0.4, 0.2)
    img[1::2, 1::2] = (0.2, 0.6, 0.9)
    wall_mat = b.add_matte(b.add_stex_image(b.add_image(img)))
    pos = np.array([[-2, -2, -2], [2, -2, -2], [2, 2, -2], [-2, 2, -2]],
                   np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (4, 1)).astype(np.float32)
    tan = np.tile([1.0, 0.0, 0.0], (4, 1)).astype(np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    b.add_mesh(pos, nrm, tan, uv, tris, wall_mat)
    nimg = np.full((4, 4, 3), 0.5, np.float32)
    nimg[..., 2] = 0.9
    nid = b.add_ntex_image(b.add_image(nimg))
    fpos = np.array([[-2, -1.5, 0], [2, -1.5, 0], [2, -1.5, -2],
                     [-2, -1.5, -2]], np.float32)
    fnrm = np.tile([0.0, 1.0, 0.0], (4, 1)).astype(np.float32)
    floor_mat = b.add_matte(b.add_stex_const((0.7, 0.7, 0.7)))
    b.add_mesh(fpos, fnrm, tan, uv, tris, floor_mat, normal_ntex=nid)
    aimg = np.zeros((4, 4, 4), np.float32)
    aimg[:, 2:, 3] = 1.0
    aid = b.add_ftex_image(b.add_image(aimg), channel="alpha")
    apos = np.array([[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                    np.float32)
    cut_mat = b.add_matte(b.add_stex_const((0.3, 0.8, 0.3)))
    b.add_mesh(apos, nrm, tan, uv, tris, cut_mat, alpha_ftex=aid)
    emit = b.add_emitter(b.add_matte(b.add_stex_const((0.9,) * 3)),
                         b.add_stex_const((25.0, 25.0, 25.0)))
    lpos = np.array([[-0.4, 1.8, 2.5], [0.4, 1.8, 2.5],
                     [0.4, 1.9, 2.4], [-0.4, 1.9, 2.4]], np.float32)
    lnrm = np.tile([0.0, -1.0, 0.0], (4, 1)).astype(np.float32)
    b.add_mesh(lpos, lnrm, tan, uv, tris, emit)
    b.set_camera_perspective(
        np.array([[1, 0, 0, 0], [0, 1, 0, 0.2], [0, 0, 1, 3.5],
                  [0, 0, 0, 1]], np.float32), 1.0, 0.9)
    return b.build(use_bvh=True)


def random_rays(n: int, lo: float, seed: int = 3):
    """(o, d) float32 numpy: origins uniform in [-lo, lo]^3, directions
    normalized Gaussians (tests/test_parallel.py's ray sets)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-lo, lo, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def hits_agree(got, want) -> None:
    """tests/test_pallas.py's closest-hit criteria: equal masks, the same
    triangle or t within 1e-4 on > 99.5% of hit rays, t to rtol 2e-4."""
    g = {k: np.asarray(v) for k, v in got.items()}
    w = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(g["mask"], w["mask"])
    m = w["mask"]
    same = g["tri"][m] == w["tri"][m]
    close = np.abs(g["t"][m] - w["t"][m]) <= 1e-4 * np.maximum(w["t"][m], 1)
    assert (same | close).mean() > 0.995
    np.testing.assert_allclose(np.where(m, g["t"], 0.0),
                               np.where(m, w["t"], 0.0), rtol=2e-4,
                               atol=2e-5)
