"""Built-in test scenes (counterpart of slr_tpu/scene/presets.py).

`cornell_box_spheres` mirrors TestScenes/Cornell_Box_Spheres.txt: walls, an
area light, one metal and one glass sphere tessellated to triangles.
`grass_field` is the RTC3-class instanced scene: one grass-blade BLAS
instanced over a ground plane, a share of the blades swaying across the
shutter. `glass_corridor` puts glass panes between the camera and a light
on the far wall (deep specular paths); `env_sphere_scene` is a diffuse
sphere under an environment light (IBL_Test-style).
"""
from __future__ import annotations

import numpy as np

from ..core import math3d as m3
from ..core.device import resolve_device
from .build import SceneBuilder
from .types import FlatScene


def _quad(p00, p10, p11, p01, n, t):
    """4 vertices + 2 triangles with constant normal/tangent."""
    pos = np.array([p00, p10, p11, p01], np.float32)
    nrm = np.tile(np.asarray(n, np.float32), (4, 1))
    tan = np.tile(np.asarray(t, np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, nrm, tan, uv, tris


def uv_sphere(center, radius, n_theta: int = 32, n_phi: int = 64):
    """Tessellated UV sphere with exact normals/tangents."""
    cz = np.asarray(center, np.float32)
    thetas = np.linspace(0.0, np.pi, n_theta + 1)
    phis = np.linspace(0.0, 2 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    normals = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    pos = cz + radius * normals
    tangent = np.stack([-np.sin(pp), np.zeros_like(pp), np.cos(pp)],
                       axis=-1).reshape(-1, 3)
    bad = np.abs(normals[:, 1]) > 0.999   # poles: any orthogonal tangent
    tangent[bad] = (1.0, 0.0, 0.0)
    uv = np.stack([pp / (2 * np.pi), tt / np.pi], axis=-1).reshape(-1, 2)
    idx = np.arange((n_theta + 1) * (n_phi + 1)).reshape(n_theta + 1, n_phi + 1)
    tris = []
    for i in range(n_theta):
        for j in range(n_phi):
            a, b, c, d = idx[i, j], idx[i + 1, j], idx[i + 1, j + 1], idx[i, j + 1]
            # Winding so cross(e01, e02) matches the outward normals.
            if i > 0:
                tris.append([a, d, b])
            if i < n_theta - 1:
                tris.append([b, d, c])
    return (pos.astype(np.float32), normals.astype(np.float32),
            tangent.astype(np.float32), uv.astype(np.float32),
            np.asarray(tris, np.int32))


def cornell_box_spheres(light_scale: float = 30.0, sphere_res: int = 24,
                        metal: bool = True, glass: bool = True,
                        use_bvh: bool = True, spectral: bool = False,
                        device=None) -> FlatScene:
    """TestScenes/Cornell_Box_Spheres.txt as a FlatScene on `device`
    (default: the CUDA device).

    In spectral mode the materials match the scene file: a D65 emitter,
    measured aluminium eta/k and Air/BK7 glass. In RGB mode the emitter is
    an RGB white of `light_scale` and the IOR curves are RGB-averaged
    constants. Chunk tables are SBVH treelets (`use_bvh=True`, the
    reference's default) or Morton slices (`use_bvh=False`)."""
    dev = resolve_device(device)
    b = SceneBuilder(spectral=spectral)

    red = b.add_matte(b.add_stex_const((0.75, 0.25, 0.25)))
    blue = b.add_matte(b.add_stex_const((0.25, 0.25, 0.75)))
    white = b.add_matte(b.add_stex_const((0.75, 0.75, 0.75)))
    light_scatter = b.add_matte(b.add_stex_const((0.9, 0.9, 0.9)))
    if spectral:
        emit = b.add_stex_d65(scale=0.13 * light_scale)
    else:
        emit = b.add_stex_const((light_scale, light_scale, light_scale))
    light_mat = b.add_emitter(light_scatter, emit)

    quads = [
        (_quad((-1.5, 0, 2.55), (-1.5, 0, -2.55), (-1.5, 2.5, -2.55),
               (-1.5, 2.5, 2.55), (1, 0, 0), (0, 0, -1)), red),
        (_quad((1.5, 0, -2.55), (1.5, 0, 2.55), (1.5, 2.5, 2.55),
               (1.5, 2.5, -2.55), (-1, 0, 0), (0, 0, 1)), blue),
        (_quad((-1.5, 0, 2.55), (1.5, 0, 2.55), (1.5, 0, -2.55),
               (-1.5, 0, -2.55), (0, 1, 0), (1, 0, 0)), white),
        (_quad((-1.5, 0, -2.55), (1.5, 0, -2.55), (1.5, 2.5, -2.55),
               (-1.5, 2.5, -2.55), (0, 0, 1), (1, 0, 0)), white),
        (_quad((-1.5, 2.5, -2.55), (1.5, 2.5, -2.55), (1.5, 2.5, 2.55),
               (-1.5, 2.5, 2.55), (0, -1, 0), (1, 0, 0)), white),
        (_quad((-0.5, 2.499, -0.5), (0.5, 2.499, -0.5), (0.5, 2.499, 0.5),
               (-0.5, 2.499, 0.5), (0, -1, 0), (1, 0, 0)), light_mat),
    ]
    for (pos, nrm, tan, uv, tris), mat in quads:
        b.add_mesh(pos, nrm, tan, uv, tris, mat)

    if metal:
        if spectral:
            eta = b.add_stex_ior("Aluminium", 0)
            k = b.add_stex_ior("Aluminium", 1)
        else:
            eta = b.add_stex_const((1.345, 0.965, 0.617))
            k = b.add_stex_const((7.47, 6.40, 5.30))
        coeff = b.add_stex_const((1.0, 1.0, 1.0))
        metal_mat = b.add_metal(coeff, eta, k)
        b.add_mesh(*uv_sphere((-0.7, 0.5, -1.05), 0.5, sphere_res,
                              sphere_res * 2), metal_mat)

    if glass:
        coeff = b.add_stex_const((0.999, 0.999, 0.999))
        if spectral:
            eta_ext = b.add_stex_ior("Air", 0)
            eta_int = b.add_stex_ior("Glass_BK7", 0)
        else:
            eta_ext = b.add_stex_const((1.00036, 1.00021, 1.00071))
            eta_int = b.add_stex_const((1.51, 1.516, 1.526))
        glass_mat = b.add_glass(coeff, eta_ext, eta_int)
        b.add_mesh(*uv_sphere((0.7, 0.5, 0.0), 0.5, sphere_res,
                              sphere_res * 2), glass_mat)

    _finish_cornell_camera(b)
    return b.build(use_bvh=use_bvh).to(dev)


def _finish_cornell_camera(b: SceneBuilder) -> None:
    to_world = (m3.mat_translate([0.0, 1.689714, 6.70284]).numpy()
                @ m3.mat_rotate_y(np.pi).numpy()
                @ m3.mat_rotate_x(0.0563936).numpy())
    b.set_camera_perspective(to_world, aspect=4.0 / 3.0, fovy=0.4807705238,
                             lens_radius=0.025, img_dist=1.0, obj_dist=6.3)


def glass_corridor(n_panes: int = 3, use_bvh: bool = True,
                   device=None) -> FlatScene:
    """A Cornell-style box with `n_panes` full-section glass slabs between
    the camera and the far wall, where the light hangs: every camera ray
    crosses 2 x n_panes specular interfaces before it sees anything
    diffuse."""
    dev = resolve_device(device)
    b = SceneBuilder()
    white = b.add_matte(b.add_stex_const((0.75, 0.75, 0.75)))
    red = b.add_matte(b.add_stex_const((0.75, 0.25, 0.25)))
    light_mat = b.add_emitter(b.add_matte(b.add_stex_const((0.9, 0.9, 0.9))),
                              b.add_stex_const((30.0, 30.0, 30.0)))
    quads = [
        (_quad((-1.5, 0, 2.55), (-1.5, 0, -2.55), (-1.5, 2.5, -2.55),
               (-1.5, 2.5, 2.55), (1, 0, 0), (0, 0, -1)), red),
        (_quad((1.5, 0, -2.55), (1.5, 0, 2.55), (1.5, 2.5, 2.55),
               (1.5, 2.5, -2.55), (-1, 0, 0), (0, 0, 1)), red),
        (_quad((-1.5, 0, 2.55), (1.5, 0, 2.55), (1.5, 0, -2.55),
               (-1.5, 0, -2.55), (0, 1, 0), (1, 0, 0)), white),
        (_quad((-1.5, 0, -2.55), (1.5, 0, -2.55), (1.5, 2.5, -2.55),
               (-1.5, 2.5, -2.55), (0, 0, 1), (1, 0, 0)), white),
        (_quad((-1.5, 2.5, -2.55), (1.5, 2.5, -2.55), (1.5, 2.5, 2.55),
               (-1.5, 2.5, 2.55), (0, -1, 0), (1, 0, 0)), white),
        # The light on the back wall: camera rays cross every pane to it.
        (_quad((-0.6, 0.6, -2.54), (0.6, 0.6, -2.54), (0.6, 1.8, -2.54),
               (-0.6, 1.8, -2.54), (0, 0, 1), (1, 0, 0)), light_mat),
    ]
    for (pos, nrm, tan, uv, tris), mat in quads:
        b.add_mesh(pos, nrm, tan, uv, tris, mat)
    glass_mat = b.add_glass(b.add_stex_const((0.999, 0.999, 0.999)),
                            b.add_stex_const((1.00036, 1.00021, 1.00071)),
                            b.add_stex_const((1.51, 1.516, 1.526)))
    for z0 in np.linspace(1.2, -0.8, n_panes):
        for zq, nz in ((float(z0), 1.0), (float(z0) - 0.06, -1.0)):
            pos, nrm, tan, uv, tris = _quad(
                (-1.5, 0, zq), (1.5, 0, zq), (1.5, 2.5, zq), (-1.5, 2.5, zq),
                (0, 0, nz), (1, 0, 0))
            if nz < 0:     # flip the winding to match the geometric normal
                tris = tris[:, ::-1]
            b.add_mesh(pos, nrm, tan, uv, tris, glass_mat)
    _finish_cornell_camera(b)
    return b.build(use_bvh=use_bvh).to(dev)


def env_sphere_scene(env_image: np.ndarray | None = None,
                     env_scale: float = 1.0, reflectance: float = 0.6,
                     use_bvh: bool = False, device=None) -> FlatScene:
    """A diffuse sphere under an environment light: under a constant
    environment L_env it reflects rho x L_env (a convex body, no
    self-occlusion)."""
    dev = resolve_device(device)
    b = SceneBuilder()
    mat = b.add_matte(b.add_stex_const((reflectance,) * 3))
    b.add_mesh(*uv_sphere((0.0, 0.0, 0.0), 1.0, 16, 32), mat)
    if env_image is None:
        env_image = np.ones((16, 32, 3), np.float32)
    b.set_environment(b.add_stex_image(b.add_image(env_image)), env_scale)
    b.set_camera_perspective(m3.mat_translate([0.0, 0.0, -4.0]).numpy(),
                             aspect=1.0, fovy=0.6, lens_radius=0.0,
                             img_dist=1.0, obj_dist=4.0)
    return b.build(use_bvh=use_bvh).to(dev)


def _grass_blade(n_seg: int = 5, height: float = 0.35, width: float = 0.02):
    """A tapered, slightly curved grass blade as a triangle strip (two
    triangles per segment; the matte BSDF shades both sides)."""
    pos, nrm, tan, uv, tris = [], [], [], [], []
    for s in range(n_seg + 1):
        h = s / n_seg
        w = width * (1.0 - 0.85 * h)
        bend = 0.12 * h * h
        y = height * h
        for x in (-w, w):
            pos.append((x, y, bend))
            nrm.append((0.0, 0.0, 1.0))
            tan.append((1.0, 0.0, 0.0))
            uv.append((0.5 + x / width * 0.5, h))
    for s in range(n_seg):
        a = 2 * s
        tris.append((a, a + 1, a + 2))
        tris.append((a + 1, a + 3, a + 2))
    return (np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
            np.asarray(tan, np.float32), np.asarray(uv, np.float32),
            np.asarray(tris, np.int32))


def grass_field(n_side: int = 64, blade_segments: int = 5, seed: int = 7,
                animated_fraction: float = 0.0, use_bvh: bool = True,
                device=None, two_level: bool = False) -> FlatScene:
    """RTC3-class instanced scene as a FlatScene on `device` (default: the
    CUDA device): n_side^2 instances of one grass-blade BLAS (2 *
    blade_segments triangles) over a ground quad under an area 'sun', the
    structure of TestScenes/RTC3.txt. `animated_fraction` gives that share
    of the blades a small sway between the shutter's ends (motion blur);
    the others are flattened into static geometry at build. Placements come
    from numpy's RandomState(seed), draw for draw as the reference makes
    them, so both packages place the same blades. The static chunks are
    SBVH treelets, as the reference builds them, or Morton slices
    (`use_bvh=False`). `two_level` adds the TLAS / BLAS node arena to its
    instances, for the two-level oracle."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    b = SceneBuilder()
    ground = b.add_matte(b.add_stex_const((0.25, 0.35, 0.12)))
    blade_mat = b.add_matte(b.add_stex_const((0.2, 0.55, 0.1)))
    half = n_side * 0.05
    g = np.float32([[-half, 0, -half], [half, 0, -half],
                    [half, 0, half], [-half, 0, half]])
    nrm = np.tile(np.float32([0, 1, 0]), (4, 1))
    tan = np.tile(np.float32([1, 0, 0]), (4, 1))
    b.add_mesh(g, nrm, tan, np.zeros((4, 2), np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int32), ground)
    # The sun: a bright quad high above.
    em = b.add_stex_const((40.0, 38.0, 30.0))
    sun = b.add_emitter(b.add_matte(b.add_stex_const((0.5,) * 3)), em)
    s = np.float32([[-2, 8, -2], [2, 8, -2], [2, 8, 2], [-2, 8, 2]])
    b.add_mesh(s, np.tile(np.float32([0, -1, 0]), (4, 1)), tan,
               np.zeros((4, 2), np.float32),
               np.array([[0, 2, 1], [0, 3, 2]], np.int32), sun)

    bid = b.begin_blas()
    b.add_mesh(*_grass_blade(blade_segments), blade_mat)
    b.end_blas()
    step = 2.0 * half / n_side
    for i in range(n_side):
        for j in range(n_side):
            x = -half + (i + 0.5 + rs.uniform(-0.3, 0.3)) * step
            z = -half + (j + 0.5 + rs.uniform(-0.3, 0.3)) * step
            ang = rs.uniform(0, 2 * np.pi)
            ca, sa = np.cos(ang), np.sin(ang)
            m = np.float32([
                [ca, 0, sa, x],
                [0, 1, 0, 0],
                [-sa, 0, ca, z],
                [0, 0, 0, 1],
            ])
            if rs.uniform() < animated_fraction:
                sway = rs.uniform(-0.15, 0.15)
                ca2, sa2 = np.cos(sway), np.sin(sway)
                rz = np.float32([
                    [ca2, -sa2, 0, 0], [sa2, ca2, 0, 0],
                    [0, 0, 1, 0], [0, 0, 0, 1],
                ])
                b.add_instance(bid, m, (m @ rz).astype(np.float32))
            else:
                b.add_instance(bid, m)
    # +z is forward in camera space; rotate_y(pi) looks toward -z world, as
    # in the Cornell preset, with a slight downward tilt onto the field.
    cam = (m3.mat_translate([0.0, 0.55 * half + 0.3, 1.35 * half + 0.6]).numpy()
           @ m3.mat_rotate_y(np.pi).numpy()
           @ m3.mat_rotate_x(0.35).numpy()).astype(np.float32)
    b.set_camera_perspective(cam, 4.0 / 3.0, 0.9)
    return b.build(use_bvh=use_bvh, two_level=two_level).to(dev)
