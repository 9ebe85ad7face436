#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`slr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, and no phase's failure is
caught:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles the hand-written kernels of slr_tpu_torch/csrc with nvcc
   and prints each kernel's registers, spills, shared memory and resident
   blocks per SM at the two launch shapes of the main paths.
3. scene and kernels: the Cornell box is built twice, on SBVH treelet
   chunk tables (the default, as the reference builds them) and on Morton
   slices; `[scene]` prints the SBVH build's seconds, chunks, triangle
   references and the chunks whose (chopped) box does not hold all their
   triangles. Each kernel against its plain PyTorch version on the card, on
   both tables, with the same ray sets at the main path's 49,152 lanes
   (camera, in-box and shadow rays, with an active mask, in the main path's
   sorted lane order); times both with CUDA events and computes each
   kernel's bound from this run's inputs. The kernels also count the slot
   tests they executed (`ran`) beside the ones their rays needed (`tests`).
4. main path: the spectral Cornell box at 1024x768, spp 2, depth 100
   through `render_wavefront`; both launch counters must equal the
   iteration count (no alpha: one closest-hit and one any-hit cast each).
5. profile: a 256x192 render at depth 16 under torch.profiler (launches per
   iteration, the device's busy share, the kernels' share of it).
6. cross-check: the same scene at 48x36 on the card and on the CPU (plain
   versions), compared per pixel.
7. grass kernels: on the instanced, animated grass field (4,096 blades of
   26 triangles, a quarter of them swaying across the shutter) the
   instance transform on its own and both traversal kernels against their
   plain versions, on camera, bounce and shadow rays with random shutter
   fractions; the kernels also count the (ray, instanced entry)
   transforms, which enter the bound.
8. grass main path: the grass field at 512x384, spp 2, depth 100; both
   traversal counters must equal the iteration count, the kernels' own
   count of the instance transforms they ran in that render must be above
   zero for each, and some primary hits must lie on instanced blades. Then
   its profile, and a smaller grass field at 48x36 on the card against
   the CPU. The grass field runs on its SBVH tables; `[scene]` compares
   them with its Morton build.
9. cli: `python -m slr_tpu_torch`'s `main` in-process on
   tests/parity_scenes/Cornell_Box_Parity.txt, spectral, at the file's
   256x192 and depth 100 with 32 spp: the scene file through the DSL and
   the SBVH build, seven progressive passes, bmp exports and checkpoints.
   Both launch counters must equal the passes' summed iterations; the last
   export, block-averaged 4x4 to 64x48, is held against
   tests/goldens/ref_parity_1024spp.bmp with tests/test_parity.py's four
   thresholds. Then the scene at 48x36 on the card against the CPU, and
   the module entry point once as a program (64x48, 1 spp).
10. shading scene: `write_shading_scene` writes a scene file with its
    assets (an EXR sky, PNG image, normal map and alpha cutout, an .assbin
    box) that uses every shading feature; `[shading kernels]` holds
    closest_hit_kernel to its plain version on its camera rays, its alpha
    recast set (per-ray tmin, sparse active mask) and its shadow rays (area
    light and environment); `[shading]` renders it through the CLI's main,
    spectral, 1024x768, depth 100, 1 spp: closest-hit launches must be 2 x
    the iterations + the alpha recasts and any-hit launches 0; then its
    profile at depth 2 and 48x36 card against CPU at 1 spp.
11. env: a diffuse sphere under a constant environment at 256x256, spp 16,
    depth 16 (the analytic rho check, background equal to the sky, both
    kernels launched once per iteration), then the equirectangular camera
    at 256x128 (more than 90% of values above 0).
12. pt: the spectral Cornell box through the fixed-depth path tracer
    (render/pt.py `render`) at 1024x768, spp 1, depth 16, in batches of
    65,536 lanes: closest-hit launches must be batches x spp x (1 + depth)
    + alpha recasts, any-hit launches batches x spp x depth; the active
    rays are counted on the device. Its profile at 256x192, then 48x36
    card against CPU, and the coherence sort on and off on one batch of
    camera rays.
13. pt kernels: both kernels against their plain versions on the second
    bounce's closest-hit and shadow rays of one sorted 65,536-lane batch,
    captured through `_trace_core`'s `cast_fns` hook.
14. pt golden: the grass field of tests/goldens/grass_field_n8.npz through
    `render` at the golden's settings (>= 98% of pixels within its
    tolerance, means within 1%).
15. grad: gradients on the card: the reflectance gradient against its
    finite difference, the emitter-scale identity, and the per-pixel
    gradient image through `render_fused` at 256x192 (forward mode)
    against its finite difference and the linearity in the scale, with
    seconds forward and backward and the peak memory.
16. debug: the debug renderer through the CLI on the parity scene at its
    256x192, in-process (one closest-hit launch) and as `python -m
    slr_tpu_torch --renderer debug`; the AOV exports against the reference
    renderer's with tests/test_parity.py's AOV gate.
17. motion box (ROADMAP C1): a bar that turns 170 degrees over the
    shutter; both kernels against their plain versions on rays that graze
    its arc outside the sampled box.
18. bpt: bench.py's BPT figure on the port: the spectral parity scene at
    256x192 through `render_bpt`, spp 8, the default adaptive caps (8 base,
    16 deep), after a 1-spp warm-up: seconds, ksamples/s, the lanes clipped
    at the base cap, the deep passes, the peak memory; both launch
    counters must equal what the passes imply (per `bpt_batch` call, caps
    - 1 closest-hit casts per subpath and one any-hit cast per eye level).
    Then one base pass profiled (device ops, syncs, busy share).
19. bpt check: 48x36, flat caps 4 + 4, on the card against the CPU.
20. bpt cornell: the spectral Cornell box at 512x384, spp 1, 3 batches
    of 65,536 lanes, with the same figures and launch gate; `[bpt
    kernels]`: both kernels against their plain versions on its light
    subpath's second bounce (closest hit) and on one whole connection cast
    (any hit: 8 x 65,536 shadow rays, each with its own tmax), captured
    through `bpt_batch`'s `cast_fns` hook.
21. bpt cli: the CLI's `--renderer bpt` in-process on the parity scene,
    spectral, 256x192, 32 spp; its last export against
    tests/goldens/ref_parity_bpt_256spp.bmp with tests/test_parity.py's BPT
    thresholds, and the launch gate.
22. ppm: SPPM (`render_ppm`) on the Cornell box with tests/test_ppm.py:52's
    settings at 128x96 against the port's `render` (means within rel 0.45,
    pixel correlation > 0.7), no any-hit launch; one wave profiled; 32x24
    card against CPU.
23. ppm cli: the CLI's `--renderer sppm` and `--renderer amcmcppm` on the
    parity scene (RGB, 256x192, 8 waves of 32,768 photon paths, bounces
    capped at 100): finite and non-negative, the mean within rel 0.45 of
    the `[cli]` phase's image, the chains' bookkeeping within its bounds.
24. dist 1: `render_wavefront_sharded` at world 1 under torchrun with
    NCCL (a worker process) on the spectral Cornell box at 1024x768, spp 1,
    depth 100, against `render_wavefront` in the same process: both launch
    counters equal the iterations; the card-against-card gate (>= 98% of
    pixels within rtol 1e-3, means within 1%; the share equal bit for bit
    printed); ksamples/s of both.
25. dist 2: two worker processes on the one card, gloo: `dryrun(2)`, the
    sharded wavefront against [dist 1]'s image, `render_sharded` at
    256x192, depth 16, against `render`, and `render_bpt_sharded` on the
    parity scene at 256x192, spp 1, flat caps 8 + 8, against `render_bpt`
    at the same caps; each with the card-against-card gate and its launch
    gate. The two ranks share the card's SMs: no scaling figure.
26. scene shard: two gloo ranks on the shading scene (asserted free of
    instances, which would take the replicated branch): the sharded closest
    hit and any hit on its camera and shadow rays against the unsharded
    casts (tests/test_pallas.py's criteria; any hit equal), each kernel
    against its plain version on rank 0's local tables, each rank's table
    bytes (chunk tables, shading rows, atlas: <= 1/2 of the whole + one
    chunk, row or image), and `render_pt_scene_sharded` at 256x192, spp 1,
    depth 16, against `render`, with its launch gate and its collectives
    counted and timed.
27. scene shard cli: `torchrun --nproc_per_node 1 -m slr_tpu_torch` on the
    shading scene with `--scene-shard` at 1024x768, spectral, 1 spp, NCCL:
    seconds, peak memory, launches (`render`'s count, shadows on closest
    hit), collectives per bounce; the image finite, its mean within 5% of
    [scene shard]'s 256x192 `render`.
28. oracles: `intersect_plucker` and `intersect_bvh` on Cornell camera
    rays, `any_hit_brute` on its shadow rays and `intersect_instances`
    (with the static prefix's `intersect_bvh`) on grass camera rays against
    closest_hit_kernel and any_hit_kernel (tests/test_pallas.py's
    criteria).
29. prints {"kernels": [...]} (launches summed over every path, per path
    in `launches_by_path`), then, as the last line, the device line.
Worker ranks run this file as `chip_smoke.py --worker NAME ...`.
"""
import dataclasses
import json
import logging
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

import slr_tpu_torch.__main__ as cli_module
from slr_tpu_torch.__main__ import main as cli_main
from slr_tpu_torch.accel import traverse as tv
from slr_tpu_torch.accel.intersect import RAY_EPSILON, sample_triangle_point
from slr_tpu_torch.camera.perspective import sample_camera_rays
from slr_tpu_torch.core import cuda_build
from slr_tpu_torch.core.sampling import sample_continuous_2d
from slr_tpu_torch.render import bpt as tbpt
from slr_tpu_torch.render import ppm as tppm
from slr_tpu_torch.render import pt as tpt
from slr_tpu_torch.render.film import develop
from slr_tpu_torch.render.pt import _ray_sort_key, resolve_sp, scene_intersect
from slr_tpu_torch.render.wavefront import (
    DEFAULT_LANE_CAP,
    _camera_ray,
    render_wavefront,
)
from slr_tpu_torch.scene.api import load_scene
from slr_tpu_torch.scene.build import SceneBuilder
from slr_tpu_torch.scene.presets import (
    cornell_box_spheres,
    env_sphere_scene,
    grass_field,
    uv_sphere,
)
from slr_tpu_torch.spectrum.rgb import luminance

# The wavefront's main path and the grass field at spp 2 (cut for time from
# 4).
WIDTH, HEIGHT, SPP, DEPTH, SEED = 1024, 768, 2, 100, 1
# The card-against-CPU checks at 48x36: the wavefront's at 2 spp and the
# fixed-depth tracer's at 1 (cut for time: the CPU's plain versions took
# ~110 s of the script at 4 and 2).
CHECK_W, CHECK_H, CHECK_SPP, PT_CHECK_SPP = 48, 36, 2, 1   # cut from 64x48
LANES = DEFAULT_LANE_CAP
TIMING_RUNS = 25
# The plain versions take 4-2,600 ms a call: their medians are of 3 runs
# (cut for time from 25, and 5 on the grass field).
PLAIN_RUNS = 3
# The Cornell box's profile at depth 16 (cut for time from 100: the
# profiler reads each device op back on the host).
PROFILE_DEPTH = 16
DEV = "cuda"
# The instanced configuration: the RTC3-class grass field.
GRASS = dict(n_side=64, blade_segments=13, animated_fraction=0.25)
GRASS_W, GRASS_H = 512, 384
GRASS_CHECK = dict(n_side=16, blade_segments=5, animated_fraction=0.25)
# The scene-file path: the parity scene at its own 256x192, as the CLI runs
# it, against the reference renderer's 1024-spp golden image.
ROOT = os.path.dirname(os.path.abspath(__file__))
PARITY = os.path.join(ROOT, "tests", "parity_scenes", "Cornell_Box_Parity.txt")
GOLDEN = os.path.join(ROOT, "tests", "goldens", "ref_parity_1024spp.bmp")
CLI_SPP = 32    # cut for time
# The shading scene (every lobe, texture and image kind, the environment,
# alpha cutouts, a normal map, an .assbin model) through the CLI, spectral,
# at 1024x768 and depth 100; spp cut to 1 for time.
SHADE_W, SHADE_H, SHADE_SPP = 1024, 768, 1
# Its profile at depth 2 and its check at 1 spp (cut for time from 4 and
# 2).
SHADE_PROFILE_DEPTH = 2
# The environment light alone: a diffuse sphere under a constant sky.
ENV_SIZE, ENV_SPP, ENV_DEPTH, ENV_RHO = 256, 16, 16, 0.6
EQUI_W, EQUI_H = 256, 128

# The fixed-depth path tracer (render/pt.py `render`): the spectral Cornell
# box at its full 1024x768, spp 1 (cut for time), depth 16 (the fixed-depth
# default), in batches of 65,536 lanes; the grass golden at
# tests/test_instancing.py's settings; gradients at 256x192 through
# `render_fused`.
PT_SPP, PT_DEPTH, PT_BATCH = 1, 16, 65536
GRASS_GOLDEN = os.path.join(ROOT, "tests", "goldens", "grass_field_n8.npz")
GRAD_W, GRAD_H, GRAD_DEPTH = 256, 192, 3
AOV_GOLDENS = {"gnormal": "gnormal", "snormal": "snormal",
               "stangent": "tangent"}
# The C1 check: a bar that turns 170 degrees about +y over the shutter.
BAR_L, BAR_W, BAR_TURN, BAR_RAYS = 1.0, 0.02, 170.0, 64

# The bidirectional path tracer: bench.py's BPT figure (the parity scene at
# 256x192, spp 8, the default adaptive caps 8 -> 16), the spectral Cornell
# box (spp 1, batches of 65,536 lanes), the card
# against the CPU at 48x36 with flat caps 4 + 4, and the CLI at 32 spp
# against the reference renderer's 256-spp BPT golden.
BPT_W, BPT_H, BPT_SPP, BPT_CORNELL_SPP, BPT_CLI_SPP = 256, 192, 8, 1, 32
# [bpt cornell] at 512x384, 3 batches (cut for time from 1024x768, 12
# batches).
BPT_CORNELL_W, BPT_CORNELL_H = 512, 384
BPT_BASE, BPT_DEEP, BPT_LANES = 8, 16, 65536
BPT_GOLDEN = os.path.join(ROOT, "tests", "goldens",
                          "ref_parity_bpt_256spp.bmp")
# Photon mapping: tests/test_ppm.py:52's settings at 128x96 against the
# port's `render`, the card against the CPU at 32x24, and the CLI's sppm and
# amcmcppm on the parity scene (RGB, its defaults, 8 waves).
PPM_W, PPM_H = 128, 96
PPM_KW = dict(n_iterations=8, n_photon_paths=8192, max_bounces=5, seed=3,
              k_per_cell=32, r0=0.08)
PPM_CLI_WAVES = 8

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per ray-triangle test, as the kernels compute them: three
# 6-term side products (11 each), n.d (5), d0 - n.o (6), then the divide
# (closest hit) or the two range terms and their product (any hit).
OPS_PER_TEST = {"closest_hit": 33 + 5 + 6 + 1, "any_hit": 33 + 5 + 6 + 5}
# fp32 operations of one instance transform (`xform_ray`), each sinf, rsqrtf
# and divide counted as one: the slerp weights (1 divide, 1 - f, two sinf
# with two multiplies each: 8), the quaternion (12), its norm (4 multiplies,
# 3 adds, max, rsqrtf: 9) and scaling (4), T (9), 1/S (3 lerps and 3
# divides: 12), two inverse rotations (33 each), o - T (3), the two 1/S
# scalings (6) and the moment (9).
OPS_PER_XFORM = 8 + 12 + 9 + 4 + 9 + 12 + 2 * 33 + 3 + 6 + 9
SOURCE = "slr_tpu_torch/csrc/traverse.cu"
REPLACES = {"closest_hit": "slr_tpu/accel/pallas_intersect.py:1127",
            "any_hit": "slr_tpu/accel/pallas_intersect.py:1205",
            "xform_rays": "slr_tpu/accel/pallas_intersect.py:748",
            "worklist": "none (jnp in slr_tpu/accel/pallas_intersect.py's "
                        "wrappers)"}


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# The shading scene: a scene file that uses every shading feature
# ---------------------------------------------------------------------------

_BOX_WALLS = """
function wall(p0, p1, p2, p3, n, t, groupMat) {
    return createMesh((
        (p0, n, t, (0, 0)), (p1, n, t, (1, 0)),
        (p2, n, t, (1, 1)), (p3, n, t, (0, 1))),
        (groupMat,));
}
function tris2(mat) { return (mat, ((0, 1, 2), (0, 2, 3))); }
"""

_SHADING_SCENE = """// The Cornell box of tests/parity_scenes/Cornell_Box_Parity.txt without
// its ceiling, lit by its D65 area light and an EXR sky, holding every
// shading feature: checker, image, Voronoi and ColorChecker spectra;
// Oren-Nayar, Ward, Ashikhmin, microfacet metal and glass, mixed, summed
// and inverse materials; a normal map, alpha cutouts and an .assbin model.
setRenderer("method": "PT", ("samples": 4,));
setRenderSettings("width": 1024, "height": 768);
setEnvironment("sky.exr", 1.0);
%(walls)s
box = createNode();

// floor: a checker board, normal-mapped
floorTex = SpectrumTexture("checker board", (Spectrum(0.8, 0.8, 0.75),
    Spectrum(0.2, 0.25, 0.3),
    "mapping": Texture2DMapping("texcoord 2D", (0, 0, 6, 6))));
floorNrm = NormalTexture(Image2D("floor_normal.png", "NormalTexture"),
                         Texture2DMapping("texcoord 2D", (0, 0, 3, 3)));
addChild(box, wall((-1.5, 0, 2.55), (1.5, 0, 2.55), (1.5, 0, -2.55),
    (-1.5, 0, -2.55), (0, 1, 0), (1, 0, 0),
    (createSurfaceMaterial("matte", (floorTex,)), floorNrm,
     ((0, 1, 2), (0, 2, 3)))));

// back wall: an sRGB PNG image
backTex = SpectrumTexture(Image2D("back_wall.png"));
addChild(box, wall((-1.5, 0, -2.55), (1.5, 0, -2.55), (1.5, 2.5, -2.55),
    (-1.5, 2.5, -2.55), (0, 0, 1), (1, 0, 0),
    tris2(createSurfaceMaterial("matte", (backTex,)))));

// left wall: Voronoi cells
vorTex = SpectrumTexture("voronoi", (0.25, 0.9));
addChild(box, wall((-1.5, 0, 2.55), (-1.5, 0, -2.55), (-1.5, 2.5, -2.55),
    (-1.5, 2.5, 2.55), (1, 0, 0), (0, 0, -1),
    tris2(createSurfaceMaterial("matte", (vorTex,)))));

// right wall: Oren-Nayar, sigma a FloatTexture
addChild(box, wall((1.5, 0, -2.55), (1.5, 0, 2.55), (1.5, 2.5, 2.55),
    (1.5, 2.5, -2.55), (-1, 0, 0), (0, 0, 1),
    tris2(createSurfaceMaterial("matte",
        (SpectrumTexture(Spectrum(0.25, 0.25, 0.75)), FloatTexture(0.6))))));

// the parity scene's area light
lightMat = createSurfaceMaterial("emitter", (
    createSurfaceMaterial("matte", (SpectrumTexture(Spectrum(0.9, 0.9, 0.9)),)),
    createEmitterSurfaceProperty("diffuse",
        (SpectrumTexture(Spectrum("ID": "D65") * 4),))));
addChild(box, wall((-0.5, 2.499, -0.5), (0.5, 2.499, -0.5),
    (0.5, 2.499, 0.5), (-0.5, 2.499, 0.5), (0, -1, 0), (1, 0, 0),
    tris2(lightMat)));

// five spheres (the procedural 32x64 sphere model)
wardMat = createSurfaceMaterial("Ward", (SpectrumTexture(Spectrum(0.7, 0.5, 0.3)),
    FloatTexture(0.05), FloatTexture(0.3)));
ashMat = createSurfaceMaterial("Ashikhmin", (
    SpectrumTexture(Spectrum(0.2, 0.4, 0.6)),
    SpectrumTexture(Spectrum(0.5, 0.5, 0.5)), FloatTexture(200), FloatTexture(20)));
alEta = SpectrumTexture(Spectrum("ID": "Aluminium", 0));
alK = SpectrumTexture(Spectrum("ID": "Aluminium", 1));
roughMetal = createSurfaceMaterial("microfacet metal", (alEta, alK, FloatTexture(0.15)));
roughGlass = createSurfaceMaterial("microfacet glass", (
    SpectrumTexture(Spectrum("ID": "Air", 0)),
    SpectrumTexture(Spectrum("ID": "Glass_BK7", 0)), FloatTexture(0.1)));
mixMat = createSurfaceMaterial("mix", (
    createSurfaceMaterial("matte", (SpectrumTexture(Spectrum(0.8, 0.3, 0.2)),)),
    createSurfaceMaterial("metal", (SpectrumTexture(Spectrum("Reflectance", 1.0)),
                                    alEta, alK)),
    FloatTexture("voronoi", (0.12, 1.0))));
function sphereAt(mat, x, z) {
    function proc(name, attrs) { return mat; }
    s = load3DModel("sphere", proc);
    setTransform(s, translate(x, 0.32, z) * scale(0.32));
    return s;
}
addChild(box, sphereAt(wardMat, -0.95, -1.7));
addChild(box, sphereAt(ashMat, -0.15, -2.0));
addChild(box, sphereAt(roughMetal, 0.7, -1.7));
addChild(box, sphereAt(roughGlass, 0.45, -0.4));
addChild(box, sphereAt(mixMat, -0.75, -0.6));

// a two-sided leaf card, stacked three deep, cut out by an alpha PNG
leafMat = createSurfaceMaterial("sum", (
    createSurfaceMaterial("matte", (SpectrumTexture(Spectrum(0.3, 0.6, 0.2)),)),
    createSurfaceMaterial("inverse", (createSurfaceMaterial("matte",
        (SpectrumTexture(Spectrum(0.2, 0.4, 0.1)),)),))));
leafAlpha = FloatTexture(Image2D("leaf_alpha.png", "AlphaTexture"));
for (i = 0; i < 3; ++i) {
    zc = 0.9 + 0.25 * i;
    addChild(box, wall((-0.9, 0.35, zc), (0.1, 0.35, zc), (0.1, 1.55, zc),
        (-0.9, 1.55, zc), (0, 0, 1), (1, 0, 0),
        (leafMat, leafAlpha, ((0, 1, 2), (0, 2, 3)))));
}

// a box model from an .assbin dump
function boxProc(name, attrs) {
    return createSurfaceMaterial("matte",
        (SpectrumTexture(Spectrum("ID": "ColorChecker", 14)),));
}
model = load3DModel("box.assbin", boxProc);
setTransform(model, translate(0.95, 0.25, 0.5) * rotateY(0.5) * scale(0.25));
addChild(box, model);

addChild(root, box);
cameraNode = createNode();
addChild(cameraNode, createPerspectiveCamera("aspect": 4.0 / 3.0,
    "fovY": 0.4807705238, "radius": 0.025, "imgDist": 1.0, "objDist": 6.3));
setTransform(cameraNode, translate(0.0, 1.689714, 6.70284) *
    rotateY(3.1415926536) * rotateX(0.0563936));
addChild(root, cameraNode);
"""


def _unit_box_model():
    """A [-1, 1]^3 cube with flat face normals, as an assimp scene."""
    from slr_tpu_torch.utils.assbin import AssbinMesh, AssbinNode, AssbinScene

    pos, nrm, tan, uv, faces = [], [], [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            t = np.zeros(3, np.float32)
            t[(axis + 1) % 3] = 1.0
            b = np.cross(n, t)
            base = len(pos)
            for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                pos.append(n + su * t + sv * b)
                nrm.append(n)
                tan.append(t)
                uv.append(((su + 1) / 2, (sv + 1) / 2))
            faces += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    mesh = AssbinMesh(positions=np.float32(pos), normals=np.float32(nrm),
                      tangents=np.float32(tan), texcoords=np.float32(uv),
                      faces=np.int32(faces), material_index=0)
    return AssbinScene(root=AssbinNode("box", np.eye(4, dtype=np.float32),
                                       mesh_indices=[0]),
                       meshes=[mesh], material_names=["box"])


def write_shading_scene(out_dir, tex=512, sky=(512, 1024), seed=0) -> str:
    """Writes `shading.txt` and its assets into `out_dir`; returns the scene
    file's path. The assets are made from `seed` with numpy and written by
    the port's own writers: the sky (`sky` = (height, width), the
    procedural placeholder sky's formula) as EXR, three `tex` x `tex` PNGs
    (the back wall's image, the floor's normal map, the leaves' alpha with
    exact zeros outside each leaf) and a cube as `.assbin`."""
    from slr_tpu_torch.render.film import save_png
    from slr_tpu_torch.scene.api import _placeholder_sky
    from slr_tpu_torch.utils.assbin import write_assbin
    from slr_tpu_torch.utils.exr import write_exr

    os.makedirs(out_dir, exist_ok=True)
    rs = np.random.RandomState(seed)
    write_exr(os.path.join(out_dir, "sky.exr"), _placeholder_sky(*sky))
    # Texel centres in [0, 1)^2, then a few seeded waves per image.
    v, u = (np.mgrid[0:tex, 0:tex].astype(np.float32) + 0.5) / tex
    phase = rs.uniform(0, 2 * np.pi, (3, 4)).astype(np.float32)
    freq = rs.randint(1, 6, (3, 4)).astype(np.float32)
    back = np.stack([0.5 + 0.25 * np.sin(2 * np.pi * (freq[c, 0] * u
                                                       + freq[c, 1] * v)
                                         + phase[c, 0])
                     + 0.2 * np.cos(2 * np.pi * freq[c, 2] * u * v
                                    + phase[c, 1])
                     for c in range(3)], axis=-1)
    save_png(os.path.join(out_dir, "back_wall.png"), np.clip(back, 0, 0.99))
    # Bumps: the normal of the height field sin(k u) sin(k v).
    k = 2 * np.pi * float(freq[0, 3] + 2)
    nx = -0.3 * np.cos(k * u) * np.sin(k * v)
    ny = -0.3 * np.sin(k * u) * np.cos(k * v)
    n = np.stack([nx, ny, np.ones_like(nx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    save_png(os.path.join(out_dir, "floor_normal.png"), (n + 1.0) * 0.5)
    # Leaves: seeded ellipses on a 3 x 3 grid, alpha 1 inside, 0 outside.
    alpha = np.zeros((tex, tex), np.float32)
    for i in range(3):
        for j in range(3):
            cu, cv = (i + 0.5) / 3, (j + 0.5) / 3
            ru, rv = rs.uniform(0.08, 0.15), rs.uniform(0.1, 0.16)
            inside = ((u - cu) / ru) ** 2 + ((v - cv) / rv) ** 2 < 1.0
            alpha[inside] = 1.0
    leaf = np.stack([0.3 + 0.4 * u, 0.6 + 0.3 * v, 0.2 * np.ones_like(u),
                     alpha], axis=-1)
    save_png(os.path.join(out_dir, "leaf_alpha.png"), leaf)
    write_assbin(os.path.join(out_dir, "box.assbin"), _unit_box_model())
    path = os.path.join(out_dir, "shading.txt")
    with open(path, "w") as f:
        f.write(_SHADING_SCENE % {"walls": _BOX_WALLS})
    return path


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on an NVIDIA GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card


def kernel_label(ptxas_line: str) -> str:
    """The kernel a ptxas 'Compiling entry function' line names, with the
    traversal kernels' template arguments spelled out."""
    m = re.search(r"(closest_hit_kernel|any_hit_kernel|xform_rays_kernel)"
                  r"(?:ILb([01])ELb([01])E)?", ptxas_line)
    if m is None:
        return ""
    if m.group(2) is None:
        return m.group(1)
    return (f"{m.group(1)}<instanced={m.group(2)}, counting={m.group(3)}>")


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_build.build_library("traverse")
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    for name, rec in cuda_build.BUILD_LOG.items():
        log(f"[build] {name}: nvcc {rec['seconds']:.2f} s")
        kernel = ""
        for ln in rec["ptxas"].splitlines():
            if "Compiling entry function" in ln:
                kernel = kernel_label(ln)
            elif kernel and ("Used" in ln or "spill" in ln):
                log(f"[build]   {kernel}: "
                    + ln.replace("ptxas info    :", "").strip())
        if re.search(r"[1-9]\d* bytes spill", rec["ptxas"]):
            raise AssertionError("a kernel spills registers")
    # What the launches of the two main paths get: static tables in blocks
    # of 256 lanes (Cornell), instanced tables in blocks of 128 (grass).
    for rb, instanced in ((tv.RB, False), (128, True)):
        for kname, variants in tv.traverse_info(rb).items():
            for counting in (False, True):
                v = variants[(instanced, counting)]
                log(f"[build] {kname}<instanced={int(instanced)}, counting="
                    f"{int(counting)}> at {rb} lanes: {v['registers']} "
                    f"registers, {v['local_bytes']} B stack frame, "
                    f"{v['static_smem']} + {v['dynamic_smem']} B shared "
                    f"memory, {v['blocks_per_sm']} resident blocks per SM")
                if v["blocks_per_sm"] < 1:
                    raise AssertionError(f"{kname} does not fit on an SM")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cuda_tensor(a):
    return torch.as_tensor(np.asarray(a, np.float32), device=DEV)


def camera_rays(scene, n, rs, width=WIDTH, height=HEIGHT):
    pix = rs.choice(width * height, n, replace=False)
    px = _cuda_tensor(pix % width + rs.rand(n))
    py = _cuda_tensor(pix // width + rs.rand(n))
    cam = sample_camera_rays(scene.camera, px, py, width, height,
                             _cuda_tensor(rs.rand(n)), _cuda_tensor(rs.rand(n)))
    return cam.o, cam.d


def box_points(n, rs):
    lo = np.float32([-1.45, 0.05, -2.5])
    hi = np.float32([1.45, 2.45, 2.5])
    return lo + (hi - lo) * rs.rand(n, 3).astype(np.float32)


def box_rays(n, rs):
    """Bounce-like rays: origins inside the box, uniform directions."""
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _cuda_tensor(box_points(n, rs)), _cuda_tensor(d)


def shadow_rays(n, rs):
    """NEE-like rays: from points in the box to points on the area light,
    tmax just short of the light as the renderer sets it."""
    o = box_points(n, rs)
    tgt = np.stack([rs.uniform(-0.5, 0.5, n), np.full(n, 2.499),
                    rs.uniform(-0.5, 0.5, n)], axis=1).astype(np.float32)
    delta = tgt - o
    dist = np.linalg.norm(delta, axis=1)
    return (_cuda_tensor(o), _cuda_tensor(delta / dist[:, None]),
            _cuda_tensor(dist * (1.0 - 1e-3)))


def traversals(launches: dict) -> dict:
    """The traversal kernels' launches of a `tv.LAUNCHES` count (which also
    counts the worklist builds: `worklist_gate`)."""
    return {k: launches[k] for k in ("closest_hit", "any_hit", "xform_rays")}


def worklist_gate(tag, launches, casts) -> None:
    """Every cast of a render builds its worklists in one launch of the
    worklist kernel, and no table of the port's scenes is too large for its
    in-block sort."""
    if launches["worklist"] != casts or launches["worklist_tensor_sort"]:
        raise AssertionError(f"{tag} worklist launches {launches}: expected "
                             f"{casts}, none sorted by the tensor code")


def median_ms(fn, runs=TIMING_RUNS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(name, args, pt, outputs, tests, xforms) -> tuple[float, str]:
    """Least time for the same work: each input read once and each output
    written once over the memory rate, or this run's ray-triangle tests and
    instance transforms over the fp32 rate, whichever is larger. Of the 16
    ray rows the kernels read 12: d, m, o, tmin, tmax and the shutter
    fraction."""
    rays, wl, wtn, cnt = args
    ins = (wl, wtn, cnt, pt.boxes, pt.entry_chunk, pt.entry_inst,
           pt.inst_trs, pt.tri24)
    nbytes = (rays.numel() * rays.element_size() * 12 // tv.ROWS
              + sum(t.numel() * t.element_size()
                    for t in ins + tuple(outputs)))
    ops = (int(tests.sum()) * OPS_PER_TEST[name]
           + int(xforms.sum()) * OPS_PER_XFORM)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def entries_per_block(pt, wl, cnt) -> tuple[float, float]:
    """Mean worklist entries per block, static and instanced apart."""
    nb = cnt.shape[0]
    e = wl.reshape(nb, -1).to(torch.int64)
    listed = torch.arange(e.shape[1], device=e.device)[None, :] < cnt[:, None]
    inst = (pt.entry_inst[e] >= 0) & listed
    return (float((listed & ~inst).sum()) / nb, float(inst.sum()) / nb)


def ran_text(ran, tests) -> str:
    """The slot tests a kernel executed beside the ones its rays needed,
    and the (ray, entry) pairs only the margin of its box test listed."""
    n_ran, n_kept = (int(x) for x in ran.sum(0))
    return (f"ran {n_ran} ({n_ran / max(int(tests.sum()), 1):.3f} of "
            f"needed), pairs listed by the margin alone {n_kept}")


def slot_triangles(pt, idx):
    """Kernel slots -> triangle ids (-1 for a miss)."""
    return torch.where(idx >= 0, pt.remap.long()[idx.clamp(min=0).long()],
                       -1)


def check_closest(label, pt, o, d, tmax, active, f=None, tmin=RAY_EPSILON):
    """The tests/test_pallas.py criteria: equal hit masks; the same
    (triangle, instance) or t within 1e-4 on more than 99.5% of the rays
    hit. On SBVH tables a triangle can sit in two chunks, and the kernel,
    which culls per ray, may find it through the other chunk: another slot,
    the same triangle and t. `tmin` may be per ray (alpha recasts)."""
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, tmin, tmax, active,
                                            f=f)
    tests = torch.zeros(rays.shape[0], dtype=torch.int32, device=DEV)
    xforms = torch.zeros_like(tests)
    ran = torch.zeros((rays.shape[0], 2), dtype=torch.int32, device=DEV)
    t_k, i_k, inst_k = tv.closest_hit(rays, wl, wtn, cnt, pt, tests=tests,
                                      xforms=xforms, ran=ran)
    t_p, i_p, inst_p = tv.closest_hit_plain(rays, wl, cnt, pt)
    torch.cuda.synchronize()
    # tests/test_pallas.py criteria: equal hit masks; the same (slot,
    # instance) or t within 1e-4 on more than 99.5% of the rays hit.
    h_k, h_p = i_k >= 0, i_p >= 0
    n_mask = int((h_k != h_p).sum())
    both = h_k & h_p
    tri_k, tri_p = slot_triangles(pt, i_k), slot_triangles(pt, i_p)
    same = ((tri_k == tri_p) & (inst_k == inst_p)) | (
        (t_k - t_p).abs() <= 1e-4 * torch.clamp(t_p.abs(), min=1.0))
    share = float(same[both].float().mean()) if bool(both.any()) else 1.0
    err = float((t_k - t_p)[h_k == h_p].abs().max())
    n_t = int((t_k != t_p).sum())
    n_idx = int((i_k != i_p).sum())
    n_tri = int((tri_k != tri_p).sum())
    n_inst = int((inst_k != inst_p).sum())
    ms = median_ms(lambda: tv.closest_hit(rays, wl, wtn, cnt, pt))
    plain = median_ms(lambda: tv.closest_hit_plain(rays, wl, cnt, pt),
                      PLAIN_RUNS)
    bms, by = bound_ms("closest_hit", (rays, wl, wtn, cnt), pt,
                       (t_k, i_k, inst_k), tests, xforms)
    e_st, e_in = entries_per_block(pt, wl, cnt)
    log(f"[kernel] closest_hit {label}: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bms:.4f} ms ({by}), tests {int(tests.sum())}, "
        f"{ran_text(ran, tests)}, transforms "
        f"{int(xforms.sum())}, entries/block {e_st:.2f} static + {e_in:.2f} "
        f"instanced (most {int(cnt.max())}), hit rays {int(h_p.sum())} "
        f"({int((inst_p >= 0).sum())} on instances), mask mismatches "
        f"{n_mask}, same-or-close {share:.6f}, max |dt| {err:.3g}, rays "
        f"whose t differs in any bit {n_t}, slots differ {n_idx}, triangles "
        f"differ {n_tri}, inst differ {n_inst}")
    bad = n_mask or share <= 0.995
    if f is None:
        bad = bad or not bool((inst_k == -1).all())
    elif not bool((inst_p >= 0).any()) or not int(xforms.sum()):
        raise AssertionError(f"no {label} ray reached an instanced entry")
    if bad:
        raise AssertionError(f"closest_hit disagrees with its plain version "
                             f"on {label} rays")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                max_abs_err=err)


def check_any(label, pt, o, d, tmax, active, f=None):
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, RAY_EPSILON, tmax,
                                            active, f=f)
    tests = torch.zeros(rays.shape[0], dtype=torch.int32, device=DEV)
    xforms = torch.zeros_like(tests)
    ran = torch.zeros((rays.shape[0], 2), dtype=torch.int32, device=DEV)
    occ_k = tv.any_hit(rays, wl, wtn, cnt, pt, tests=tests, xforms=xforms,
                       ran=ran)
    occ_p = tv.any_hit_plain(rays, wl, cnt, pt)
    torch.cuda.synchronize()
    err = float((occ_k - occ_p).abs().max())
    n_diff = int((occ_k != occ_p).sum())
    ms = median_ms(lambda: tv.any_hit(rays, wl, wtn, cnt, pt))
    plain = median_ms(lambda: tv.any_hit_plain(rays, wl, cnt, pt),
                      PLAIN_RUNS)
    bms, by = bound_ms("any_hit", (rays, wl, wtn, cnt), pt, (occ_k,), tests,
                       xforms)
    e_st, e_in = entries_per_block(pt, wl, cnt)
    log(f"[kernel] any_hit {label}: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bms:.4f} ms ({by}), tests {int(tests.sum())}, "
        f"{ran_text(ran, tests)}, transforms "
        f"{int(xforms.sum())}, entries/block {e_st:.2f} static + {e_in:.2f} "
        f"instanced (most {int(cnt.max())}), occluded {int(occ_p.sum())}, "
        f"mismatches {n_diff} of {occ_p.numel()}")
    # Static tables: bit for bit. Instanced tables: the masks agree on more
    # than 99.5% of the rays (tests/test_pallas.py).
    if (err != 0.0) if f is None else (n_diff > 0.005 * occ_p.numel()):
        raise AssertionError(f"any_hit disagrees with its plain version on "
                             f"{label} rays")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                max_abs_err=err)


def check_worklist(label, pt, o, d, tmin, tmax, active, f=None) -> dict:
    """The worklist kernel against its plain version on the same rays: the
    packed rays, worklists, counts, near distances and clamped tmax equal
    (NaN where the other has NaN). Bound: its inputs read once (rays,
    per-ray bounds, the entry boxes) and its outputs written once over the
    memory rate; the slab tests (~25 fp32 operations a ray and entry) are
    far under it."""
    got = tv.prepare_cast(pt, o, d, tmin, tmax, active, f=f)
    want = tv.prepare_cast_plain(pt, o, d, tmin, tmax, active,
                                 tv._auto_rb(pt), f)
    torch.cuda.synchronize()
    differ = {}
    for name, a, b in zip(("rays", "wl", "cnt", "wtn", "tmax_a"), got, want):
        bad = a != b
        if a.is_floating_point():
            bad &= ~(torch.isnan(a) & torch.isnan(b))
        differ[name] = int(bad.sum())
    ms = median_ms(lambda: tv.prepare_cast(pt, o, d, tmin, tmax, active,
                                           f=f))
    plain = median_ms(lambda: tv.prepare_cast_plain(
        pt, o, d, tmin, tmax, active, tv._auto_rb(pt), f), PLAIN_RUNS)
    ins = [o, d, pt.cast_boxes] + [x for x in (tmin, tmax, active, f)
                                   if isinstance(x, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in ins + list(got))
    bms = nbytes / PEAK_BYTES * 1e3
    nb = got[2].shape[0]
    log(f"[kernel] worklist {label}: {o.shape[0]} rays, {nb} blocks of "
        f"{tv._auto_rb(pt)}, {pt.n_entries} entries: {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms (bytes), listed entries "
        f"{int(got[2].sum())}, values that differ {differ}")
    if any(differ.values()):
        raise AssertionError(f"the worklist kernel disagrees with its plain "
                             f"version on {label} rays")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by="bytes",
                max_abs_err=0.0)


def check_xform(pt, o, d, f, rs):
    """The instance transform on its own, at the main path's shape: 49,152
    packed rays in blocks of the grass table's width, one seeded instance
    row per block. Tolerance: 1e-5 relative to max(1, |plain|) per value
    (sinf / rsqrtf against torch.sin / torch.rsqrt)."""
    rb = tv._auto_rb(pt)
    zeros = torch.zeros(o.shape[0], device=DEV)
    rays, nb = tv._pack_rays(o, d, zeros, zeros, rb, f)
    rows = pt.inst_trs[torch.as_tensor(
        rs.randint(0, pt.inst_trs.shape[0], nb), device=DEV)].contiguous()
    out_k = tv.xform_rays(rays, rows)
    out_p = tv.xform_rays_plain(rays, rows)
    torch.cuda.synchronize()
    diff = (out_k - out_p).abs()
    err = float(diff.max())
    n_bits = int((out_k != out_p).sum())
    bad = int((diff > 1e-5 * torch.clamp(out_p.abs(), min=1.0)).sum())
    ms = median_ms(lambda: tv.xform_rays(rays, rows))
    plain = median_ms(lambda: tv.xform_rays_plain(rays, rows), PLAIN_RUNS)
    # Read: ray rows 0-8 (d, m, o) and 12 (f) of the 16, and the instance
    # rows; written: the 9 local rows.
    nbytes = (rays.numel() * rays.element_size() * 10 // tv.ROWS
              + sum(t.numel() * t.element_size() for t in (rows, out_k)))
    t_bytes = nbytes / PEAK_BYTES
    t_ops = rays.shape[0] * rb * OPS_PER_XFORM / PEAK_FP32
    log(f"[kernel] xform_rays: {nb} blocks of {rb}: {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {max(t_bytes, t_ops) * 1e3:.5f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}), max |err| "
        f"{err:.3g}, values that differ in any bit {n_bits} of "
        f"{out_p.numel()}, beyond tolerance {bad}")
    if bad or not bool(torch.isfinite(out_k).all()):
        raise AssertionError("xform_rays disagrees with its plain version")
    return dict(ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err)


def main_path_order(scene, active, *rays):
    """Lanes in the order the main path casts them: sorted by its coherence
    key (octant + Morton code of the contact point), inactive lanes last."""
    order = torch.argsort(_ray_sort_key(scene, rays[0], rays[1], active),
                          stable=True)
    return [x[order] for x in rays + (active,)]


def cornell_ray_sets(scene) -> dict:
    """The Cornell phase's four casts, as (kernel, o, d, tmax, active): the
    main path's lane count, seeded, in the main path's sorted order."""
    rs = np.random.RandomState(0)
    active = torch.as_tensor(rs.rand(LANES) < 0.8, device=DEV)
    everyone = torch.ones(LANES, dtype=torch.bool, device=DEV)
    o_c, d_c, _ = main_path_order(scene, everyone,
                                  *camera_rays(scene, LANES, rs))
    o_b, d_b, act_b = main_path_order(scene, active, *box_rays(LANES, rs))
    o_s, d_s, tmax_s, act_s = main_path_order(scene, active,
                                              *shadow_rays(LANES, rs))
    return {"closest camera": ("closest_hit", o_c, d_c, float("inf"), None),
            "closest in-box": ("closest_hit", o_b, d_b, float("inf"), act_b),
            "any shadow": ("any_hit", o_s, d_s, tmax_s, act_s),
            "any in-box": ("any_hit", o_b, d_b, 0.7, None)}


def phase_kernels(scene, morton) -> dict:
    """Both kernels on the Cornell box's SBVH tables (the main path's) and
    on its Morton tables, with the same four ray sets."""
    sets = cornell_ray_sets(scene)
    out = {}
    for tag, sc in (("SBVH", scene), ("Morton", morton)):
        pt = sc.pallas_tris
        log(f"[kernel] {tag} tables: {pt.n_chunks} chunks of {pt.chunk}, "
            f"{sc.geometry.num_tris} triangles, {LANES} rays, "
            f"{-(-LANES // tv._auto_rb(pt))} blocks of {tv._auto_rb(pt)}")
        closest = [check_closest(f"{tag} camera", pt,
                                 *sets["closest camera"][1:]),
                   check_closest(f"{tag} in-box", pt,
                                 *sets["closest in-box"][1:])]
        anyhit = [check_any(f"{tag} shadow", pt, *sets["any shadow"][1:]),
                  check_any(f"{tag} in-box", pt, *sets["any in-box"][1:])]
        # The main path's casts are mostly bounce and shadow rays: the
        # in-box closest-hit and the shadow any-hit sets give the times.
        res = {"closest_hit": dict(closest[1]), "any_hit": dict(anyhit[0])}
        # The worklist build: bounce rays (the table's ray set) and shadow
        # rays (per-ray tmax).
        res["worklist"] = check_worklist(f"{tag} in-box", pt,
                                         *sets["closest in-box"][1:3],
                                         RAY_EPSILON,
                                         *sets["closest in-box"][3:])
        check_worklist(f"{tag} shadow", pt, *sets["any shadow"][1:3],
                       RAY_EPSILON, *sets["any shadow"][3:])
        res["closest_hit"]["max_abs_err"] = max(c["max_abs_err"]
                                                for c in closest)
        res["any_hit"]["max_abs_err"] = max(a["max_abs_err"] for a in anyhit)
        out[tag] = res
    return out


class BuildLog(logging.Handler):
    """Collects the port's build log lines (`[build] sbvh ... seconds=`)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def take(self) -> list:
        lines, self.lines = self.lines, []
        return lines


def table_stats(scene) -> dict:
    """Static chunks of a scene's tables: chunks, triangle references (a
    triangle cut by SBVH spatial splits sits in several chunks) and the
    chunks whose box does not hold every vertex of their triangles (SBVH
    node boxes are chopped at the splits)."""
    pt = scene.pallas_tris
    static = pt.entry_inst < 0
    ch = pt.entry_chunk[static].long()
    slots = pt.remap.view(pt.n_chunks, pt.chunk)[ch].long()
    valid = slots >= 0
    tri = scene.geometry.tri_vidx.long()[slots.clamp(min=0)]
    v = scene.geometry.positions[tri]                       # (NS, C, 3, 3)
    box = pt.boxes[static]
    inside = ((v >= box[:, None, None, 0:3]) & (v <= box[:, None, None, 3:6])
              ).flatten(2).all(-1) | ~valid
    return dict(chunks=int(ch.numel()), refs=int(valid.sum()),
                tris=scene.n_static, chopped=int((~inside.all(1)).sum()))


def phase_scene(name, make, ray_set) -> tuple:
    """Builds a configuration with `make(use_bvh)` on SBVH tables (the
    default) and on Morton tables; prints the SBVH build's seconds, both
    tables' static chunks and the worklist entries per block, on each, of
    the kernel phase's ray set `ray_set(scene)` -> (o, d, tmax, active,
    f). Returns (SBVH scene, Morton scene)."""
    build_log = BuildLog()
    logger = logging.getLogger("slr_tpu_torch")
    logger.addHandler(build_log)
    logger.setLevel(logging.INFO)
    t0 = time.perf_counter()
    scene = make(True)
    t_sbvh = time.perf_counter() - t0
    lines = [ln for ln in build_log.take() if "sbvh" in ln]
    t0 = time.perf_counter()
    morton = make(False)
    t_morton = time.perf_counter() - t0
    logger.removeHandler(build_log)
    log(f"[scene] {name}: built on {scene.device} in {t_sbvh:.2f} s with "
        f"SBVH tables, {t_morton:.2f} s with Morton tables; "
        f"{scene.geometry.num_tris} triangles, lobe kinds "
        f"{scene.lobe_kinds_present}")
    for ln in lines:
        log(f"[scene] {name}: {ln}")
    o, d, tmax, active, f = ray_set(scene)
    for tag, sc in (("SBVH", scene), ("Morton", morton)):
        st = table_stats(sc)
        pt = sc.pallas_tris
        rays, wl, cnt, _, _ = tv.prepare_cast(pt, o, d, RAY_EPSILON, tmax,
                                              active, f=f)
        e_st, e_in = entries_per_block(pt, wl, cnt)
        log(f"[scene] {name} {tag}: {st['chunks']} static chunks, "
            f"{st['refs']} references of {st['tris']} triangles "
            f"({st['refs'] / st['tris']:.3f} each), boxes that do not hold "
            f"all their triangles {st['chopped']}, {pt.n_entries} entries; "
            f"worklist entries per block {e_st:.2f} static + {e_in:.2f} "
            f"instanced (most {int(cnt.max())})")
    return scene, morton


def field_points(n, rs, half):
    """Points just above the grass field, among the blades."""
    return np.stack([rs.uniform(-half, half, n), rs.uniform(0.01, 0.4, n),
                     rs.uniform(-half, half, n)], axis=1).astype(np.float32)


def grass_ray_sets(scene, rs) -> dict:
    """The grass phase's four casts, as (kernel, o, d, tmax, active, f):
    camera rays, bounce rays from points among the blades and shadow rays
    toward the sun quad, each with a seeded shutter fraction, in the main
    path's sorted order."""
    half = GRASS["n_side"] * 0.05
    active = torch.as_tensor(rs.rand(LANES) < 0.8, device=DEV)
    everyone = torch.ones(LANES, dtype=torch.bool, device=DEV)

    def shutter():
        return _cuda_tensor(rs.rand(LANES))

    o_c, d_c, f_c, _ = main_path_order(
        scene, everyone, *camera_rays(scene, LANES, rs, GRASS_W, GRASS_H),
        shutter())
    dirs = rs.normal(size=(LANES, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o_b, d_b, f_b, act_b = main_path_order(
        scene, active, _cuda_tensor(field_points(LANES, rs, half)),
        _cuda_tensor(dirs), shutter())
    src = field_points(LANES, rs, half)
    tgt = np.stack([rs.uniform(-2, 2, LANES), np.full(LANES, 8.0),
                    rs.uniform(-2, 2, LANES)], axis=1).astype(np.float32)
    dist = np.linalg.norm(tgt - src, axis=1)
    o_s, d_s, tmax_s, f_s, act_s = main_path_order(
        scene, active, _cuda_tensor(src),
        _cuda_tensor((tgt - src) / dist[:, None]),
        _cuda_tensor(dist * (1.0 - 1e-3)), shutter())
    return {"closest camera": ("closest_hit", o_c, d_c, float("inf"), None,
                               f_c),
            "closest bounce": ("closest_hit", o_b, d_b, float("inf"), act_b,
                               f_b),
            "any shadow": ("any_hit", o_s, d_s, tmax_s, act_s, f_s),
            "any bounce": ("any_hit", o_b, d_b, 0.3, None, f_b)}


def phase_grass_kernels(scene) -> dict:
    """Phase 7: the instanced table."""
    pt = scene.pallas_tris
    rs = np.random.RandomState(1)
    sets = grass_ray_sets(scene, rs)
    n_inst = int((pt.entry_inst >= 0).sum())
    log(f"[grass] tables: {pt.n_chunks} chunks of {pt.chunk}, "
        f"{pt.n_entries - n_inst} static + {n_inst} instanced entries, "
        f"{scene.instances.num} instances, {scene.geometry.num_tris} "
        f"triangles ({scene.n_static} static), {LANES} rays, "
        f"{-(-LANES // tv._auto_rb(pt))} blocks of {tv._auto_rb(pt)}")
    _, o_c, d_c, _, _, f_c = sets["closest camera"]
    _, o_b, d_b, _, act_b, f_b = sets["closest bounce"]
    out = {"xform_rays": check_xform(pt, o_c, d_c, f_c, rs)}
    closest = [check_closest("grass camera", pt, *sets["closest camera"][1:]),
               check_closest("grass bounce", pt, *sets["closest bounce"][1:])]
    anyhit = [check_any("grass shadow", pt, *sets["any shadow"][1:]),
              check_any("grass bounce", pt, *sets["any bounce"][1:])]
    out["closest_hit"] = dict(closest[1])
    out["any_hit"] = dict(anyhit[0])
    out["closest_hit"]["max_abs_err"] = max(c["max_abs_err"] for c in closest)
    out["any_hit"]["max_abs_err"] = max(x["max_abs_err"] for x in anyhit)
    # The worklist build's cost per cast, at the main path's lane count.
    out["worklist"] = check_worklist("grass bounce", pt, o_b, d_b,
                                     RAY_EPSILON, float("inf"), act_b, f_b)
    wl_ms = out["worklist"]["ms"]
    log(f"[grass] prepare_cast (ranges, packing, per-block worklists over "
        f"{pt.n_entries} entry boxes): {wl_ms:.3f} ms per cast")
    out["prepare_cast_ms"] = wl_ms
    return out


# ---------------------------------------------------------------------------
# Phases 4-6: the main path, its profile, and the card against the CPU
# ---------------------------------------------------------------------------

def ascii_view(img, cols=48) -> str:
    lum = luminance(develop(img, device=img.device)).cpu().numpy()
    h, w = lum.shape
    step = max(w // cols, 1)
    rows = []
    for y in range(0, h, 2 * step):
        rows.append("".join(" .:-=+*#%@"[min(int(lum[y, x] * 10), 9)]
                            for x in range(0, w, step)))
    return "\n".join(rows)


def phase_main_path(scene) -> dict:
    render_wavefront(scene, 128, 96, spp=1, seed=SEED, max_depth=DEPTH)
    torch.cuda.synchronize()
    tv.reset_launches()
    t0 = time.perf_counter()
    img, iters = render_wavefront(scene, WIDTH, HEIGHT, spp=SPP, seed=SEED,
                                  max_depth=DEPTH, return_iters=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tv.LAUNCHES)
    lanes = min(WIDTH * HEIGHT, LANES)
    ksps = WIDTH * HEIGHT * SPP / secs / 1e3
    mrays = 2 * lanes * iters / secs / 1e6
    mean = float(img.mean())
    neg = float((img < 0).float().mean())
    log(f"[main] {WIDTH}x{HEIGHT} spp {SPP} depth {DEPTH} spectral Cornell: "
        f"{secs:.3f} s, {ksps:.1f} ksamples/s, {mrays:.2f} Mrays/s, "
        f"{iters} iterations, {lanes} lanes, launches {launches}, "
        f"image mean {mean:.5f}, negative values {neg:.5f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(ascii_view(img))
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError("main path image is not finite or has the "
                             "wrong shape")
    # Spectral strata -> sRGB gives negative channels on noisy pixels (the
    # reference does the same); the developed image must still be sane.
    if not (mean > 0.0 and neg < 0.05):
        raise AssertionError(f"implausible image: mean {mean}, negative "
                             f"share {neg}")
    if traversals(launches) != {"closest_hit": iters, "any_hit": iters,
                                "xform_rays": 0}:
        raise AssertionError(f"launch counts {launches} != {iters} "
                             f"iterations for each traversal kernel (and no "
                             f"launch of the transform on its own)")
    worklist_gate("main", launches, 2 * iters)
    return dict(seconds=secs, ksamples_per_s=ksps, mrays_per_s=mrays,
                iterations=iters, lanes=lanes, mean=mean, launches=launches)


def profile_run(fn, tag, what, steps_label, steps) -> dict:
    """`fn()` once unprofiled (its wall time), once under torch.profiler:
    device ops and host syncs per step, the device's busy share of the
    unprofiled wall time, the two kernels' share of device time and the
    largest device items. `steps` is a count, or a function of what `fn`
    returns (a render's iterations)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if callable(steps):
        steps = steps(out)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    if not dev or busy <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    syncs = sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
                for e in prof.events())
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.self_device_time_total)
    log(f"[{tag}] {what}: {wall:.3f} s unprofiled, {steps} {steps_label} "
        f"({wall / steps * 1e3:.2f} ms each); {len(dev) / steps:.0f} device "
        f"ops and {syncs / steps:.1f} host syncs per step; device busy "
        f"{busy:.3f} s = {busy / wall:.3f} of the unprofiled wall time")
    shares = {}
    for kname in ("closest_hit_kernel", "any_hit_kernel"):
        n, us = next((v for k, v in by_name.items() if kname in k), (0, 0.0))
        shares[kname] = us / 1e6 / busy
        log(f"[{tag}] {kname}: {n} launches, {us / max(n, 1) / 1e3:.4f} ms "
            f"each, {us / 1e6 / busy:.3f} of device time")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:6]:
        log(f"[{tag}]   {us / 1e3:9.3f} ms in {n:6d} launches: {name[:90]}")
    return dict(wall=wall, busy_share=busy / wall, ops_per_step=len(dev)
                / steps, syncs_per_step=syncs / steps, kernel_share=shares)


def phase_profile(scene, tag="profile", depth=DEPTH) -> None:
    """Where the main path's time goes: one 256x192 (= 49,152 lanes) spp 1
    render under torch.profiler. Reports launches per iteration, the
    device's busy share and the traversal kernels' share of device time.
    The profiler's events take ~65 us each to read back on the host, so a
    scene of many launches per iteration is profiled at a smaller depth
    (fewer iterations, each with every lane busy)."""
    profile_run(lambda: render_wavefront(
        scene, 256, 192, spp=1, seed=SEED, max_depth=depth,
        return_iters=True), tag, f"256x192 spp 1 depth {depth}",
        "iterations", lambda out: out[1])


def phase_cross_check(scene, main_mean: float | None, tag="check",
                      spp=CHECK_SPP) -> None:
    kw = dict(spp=spp, seed=SEED, max_depth=DEPTH, return_iters=True)
    t0 = time.perf_counter()
    gpu, it_gpu = render_wavefront(scene, CHECK_W, CHECK_H, **kw)
    gpu = gpu.cpu().numpy()
    t1 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    cpu, it_cpu = render_wavefront(scene.to("cpu"), CHECK_W, CHECK_H,
                                   device="cpu", **kw)
    cpu = cpu.numpy()
    t2 = time.perf_counter()
    # The criterion of tests/test_torch_wavefront.py: a path whose decision
    # flips on rounding (libm differs between card and host, and the
    # film's atomics reorder sums) differs from there on; >= 98% of pixels
    # within rtol 1e-3 and the image means within 1%.
    close = (np.abs(gpu - cpu) <= 1e-3 * np.abs(cpu) + 1e-6).all(-1).mean()
    rel = abs(gpu.mean() / cpu.mean() - 1.0)
    n_far = int((~(np.abs(gpu - cpu) <= 1e-3 * np.abs(cpu) + 1e-6)
                   .all(-1)).sum())
    log(f"[{tag}] {CHECK_W}x{CHECK_H} spp {spp} depth {DEPTH}: card "
        f"{t1 - t0:.2f} s ({it_gpu} iterations), CPU {t2 - t1:.2f} s "
        f"({it_cpu} iterations); pixels within rtol 1e-3 {close:.6f} "
        f"({n_far} beyond), means {gpu.mean():.6f} / {cpu.mean():.6f} (rel "
        f"{rel:.2e})"
        + ("" if main_mean is None else f"; full-size mean {main_mean:.6f}"))
    if close < 0.98 or rel >= 0.01 or abs(it_gpu - it_cpu) > 2:
        raise AssertionError("the card's render disagrees with the CPU's")
    if main_mean is None:
        return
    # Both sizes estimate the same image plane, but caustic paths through
    # the glass sphere make the 4-spp mean of a small image noisy: a loose
    # plausibility bound.
    if not abs(main_mean / cpu.mean() - 1.0) < 0.35:
        raise AssertionError("the full-size image mean is implausible next "
                             "to the small render's")


def phase_grass_main_path(scene) -> dict:
    """Phase 8: the instanced configuration through `render_wavefront`."""
    kw = dict(seed=SEED, max_depth=DEPTH)
    render_wavefront(scene, 256, 192, spp=1, **kw)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tv.reset_launches()
    # The casts' kernels count, on the device, the tests and the instance
    # transforms their rays need: the transform launches no kernel of its
    # own on this path, so this is what shows that it ran.
    tv.track_work(DEV)
    t0 = time.perf_counter()
    img, iters = render_wavefront(scene, GRASS_W, GRASS_H, spp=SPP,
                                  return_iters=True, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tv.LAUNCHES)
    work = dict(zip(("closest_hit_tests", "closest_hit_transforms",
                     "any_hit_tests", "any_hit_transforms"),
                    tv.WORK.tolist()))
    tv.track_work(None)
    peak = torch.cuda.max_memory_allocated() / 2**30
    lanes = min(GRASS_W * GRASS_H, LANES)
    ksps = GRASS_W * GRASS_H * SPP / secs / 1e3
    mrays = 2 * lanes * iters / secs / 1e6
    lit = float((img.sum(-1) > 0).float().mean())
    # Primary visibility: one ray through each pixel centre at a seeded
    # shutter fraction (outside the counted window).
    n_pix = GRASS_W * GRASS_H
    pix = torch.arange(n_pix, device=DEV)
    half_ = torch.full((n_pix,), 0.5, device=DEV)
    cam = sample_camera_rays(scene.camera, (pix % GRASS_W) + half_,
                             (pix // GRASS_W) + half_, GRASS_W, GRASS_H,
                             half_, half_)
    f = _cuda_tensor(np.random.RandomState(2).rand(n_pix))
    shares = []
    for s0 in range(0, n_pix, LANES):
        hit = scene_intersect(scene, cam.o[s0:s0 + LANES],
                              cam.d[s0:s0 + LANES], f=f[s0:s0 + LANES])
        shares.append((hit.inst >= 0).float())
    on_inst = float(torch.cat(shares).mean())
    log(f"[grass main] {GRASS_W}x{GRASS_H} spp {SPP} depth {DEPTH} grass "
        f"field: {secs:.3f} s, {ksps:.1f} ksamples/s, {mrays:.2f} Mrays/s, "
        f"{iters} iterations ({secs / iters * 1e3:.2f} ms each), {lanes} "
        f"lanes, launches {launches}, work the kernels counted {work}, "
        f"image mean {float(img.mean()):.5f}, "
        f"non-black pixels {lit:.4f}, primary hits on instanced blades "
        f"{on_inst:.4f} of pixels, peak memory {peak:.2f} GiB")
    log(ascii_view(img))
    if tuple(img.shape) != (GRASS_H, GRASS_W, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError("grass image is not finite or has the wrong "
                             "shape")
    if not lit > 0.10:
        raise AssertionError(f"only {lit} of the grass pixels are non-black")
    if traversals(launches) != {"closest_hit": iters, "any_hit": iters,
                                "xform_rays": 0}:
        raise AssertionError(f"launch counts {launches}: expected {iters} "
                             f"for each traversal kernel (and no launch of "
                             f"the transform on its own)")
    worklist_gate("grass main", launches, 2 * iters)
    if not (work["closest_hit_transforms"] > 0
            and work["any_hit_transforms"] > 0):
        raise AssertionError(f"a traversal kernel ran no instance transform "
                             f"in the grass render: {work}")
    if not on_inst > 0.0:
        raise AssertionError("no primary hit lies on an instanced blade")
    return dict(seconds=secs, iterations=iters, launches=launches,
                peak_gib=peak, work=work)


# ---------------------------------------------------------------------------
# Phase 9: the scene-file path through the CLI
# ---------------------------------------------------------------------------

def read_bmp(path) -> np.ndarray:
    """(H, W, 3) RGB float32 of an uncompressed 24-bit BMP (the reference's
    and the CLI's format: BGR rows, bottom-up, padded to 4 bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    off = struct.unpack_from("<I", data, 10)[0]
    w, h, _, bpp = struct.unpack_from("<iiHH", data, 18)
    if bpp != 24:
        raise ValueError(f"{path}: {bpp}-bit BMP")
    stride = (3 * w + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, stride * abs(h), off).reshape(
        abs(h), stride)[:, :3 * w].reshape(abs(h), w, 3)[:, :, ::-1]
    return (rows[::-1] if h > 0 else rows).astype(np.float32)


def block_mean(img, f=4) -> np.ndarray:
    h, w, c = img.shape
    return img.reshape(h // f, f, w // f, f, c).mean(axis=(1, 3))


def parity_gates(ours, gold, tag="cli", quadrant_limit=9.0) -> None:
    """tests/test_parity.py's four thresholds on 64x48 block means (0-255
    scale), each measured value printed beside its limit (the quadrants'
    limit is 9 for the path tracer, 10 for BPT)."""
    d = np.abs(ours - gold)
    gates = [("channel means, largest difference",
              float(np.abs(ours.mean((0, 1)) - gold.mean((0, 1))).max()),
              6.0),
             ("block MAD", float(d.mean()), 18.0),
             ("block MAD 95th percentile", float(np.percentile(d, 95)), 55.0)]
    for ys in (slice(0, 24), slice(24, 48)):
        for xs in (slice(0, 32), slice(32, 64)):
            gates.append((f"quadrant rows {ys.start}-{ys.stop} columns "
                          f"{xs.start}-{xs.stop} means, largest difference",
                          float(np.abs(ours[ys, xs].mean((0, 1))
                                       - gold[ys, xs].mean((0, 1))).max()),
                          quadrant_limit))
    for name, value, limit in gates:
        log(f"[{tag}] golden gate: {name} {value:.4f} < {limit}: "
            f"{'pass' if value < limit else 'FAIL'}")
    failed = [g for g in gates if not g[1] < g[2]]
    if failed:
        raise AssertionError(f"the {tag} render fails the golden gates: "
                             f"{failed}")


def phase_cli(tmp) -> dict:
    """The CLI's main in-process on the parity scene at its own size."""
    out = os.path.join(tmp, "cli")
    build_log = BuildLog()
    logger = logging.getLogger("slr_tpu_torch")
    logger.addHandler(build_log)
    logger.setLevel(logging.INFO)
    torch.cuda.synchronize()
    tv.reset_launches()
    tv.track_work(DEV)
    res = cli_main([PARITY, "--spectral", "--spp", str(CLI_SPP), "--format",
                    "bmp", "--out", out])
    torch.cuda.synchronize()
    launches = dict(tv.LAUNCHES)
    work = dict(zip(("closest_hit_tests", "closest_hit_transforms",
                     "any_hit_tests", "any_hit_transforms"),
                    tv.WORK.tolist()))
    tv.track_work(None)
    logger.removeHandler(build_log)
    sbvh = [ln for ln in build_log.lines if "sbvh" in ln]
    w, h, lanes = res["width"], res["height"], res["lanes"]
    iters = sum(p[2] for p in res["passes"])
    secs = sum(p[1] for p in res["passes"])
    ksps = w * h * res["spp"] / secs / 1e3
    mrays = 2 * lanes * iters / secs / 1e6
    log(f"[cli] {os.path.relpath(PARITY, ROOT)}: scene load "
        f"{res['load_seconds']:.3f} s (DSL, flatten, SBVH and chunk tables; "
        f"{'; '.join(sbvh)})")
    for spp, sec, it in res["passes"]:
        log(f"[cli]   pass of {spp} spp: {sec:.3f} s, {it} iterations")
    log(f"[cli] {w}x{h} spp {res['spp']} depth 100 spectral: {secs:.3f} s "
        f"in {len(res['passes'])} passes, {ksps:.1f} ksamples/s, actual "
        f"{mrays:.2f} Mrays/s (2 x {lanes} lanes x {iters} iterations), "
        f"launches {launches}, work the kernels counted {work}")
    names = sorted(os.listdir(out))
    want = [f"{k:03d}.bmp" for k in range(len(res["passes"]))] + \
        ["checkpoint.npz"]
    if names != sorted(want) or res["spp"] != CLI_SPP:
        raise AssertionError(f"CLI exports {names}, expected {want}")
    if traversals(launches) != {"closest_hit": iters, "any_hit": iters,
                                "xform_rays": 0}:
        raise AssertionError(f"launch counts {launches} != {iters} summed "
                             f"iterations for each traversal kernel")
    ours = read_bmp(os.path.join(out, want[-2]))
    if ours.shape != (h, w, 3):
        raise AssertionError(f"export of shape {ours.shape}")
    log(ascii_view(torch.as_tensor(ours / 255.0, device=DEV)))
    parity_gates(block_mean(ours), block_mean(read_bmp(GOLDEN)))
    with np.load(os.path.join(out, "checkpoint.npz")) as z:
        film_mean = float((z["accum"] + z["comp"]).mean() / int(z["done"]))
    return dict(seconds=secs, iterations=iters, launches=launches,
                work=work, ksamples_per_s=ksps, mrays_per_s=mrays,
                load_seconds=res["load_seconds"], film_mean=film_mean)


def phase_cli_module(tmp) -> None:
    """`python -m slr_tpu_torch` as a program, once, at 64x48 and 1 spp."""
    out = os.path.join(tmp, "module")
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "slr_tpu_torch", PARITY, "--spectral",
         "--width", "64", "--height", "48", "--spp", "1", "--out", out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    for ln in proc.stdout.splitlines():
        log(f"[cli module]   {ln}")
    if proc.returncode != 0 or not os.path.exists(
            os.path.join(out, "000.png")):
        raise AssertionError(f"python -m slr_tpu_torch failed "
                             f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    log(f"[cli module] python -m slr_tpu_torch: exit 0 in {secs:.2f} s, "
        f"wrote {sorted(os.listdir(out))}")


# ---------------------------------------------------------------------------
# Phases 10-13: the shading scene, its kernels, the environment light
# ---------------------------------------------------------------------------

def phase_shading_scene(tmp) -> tuple:
    """Writes the shading scene at full size and loads it (spectral)."""
    t0 = time.perf_counter()
    path = write_shading_scene(os.path.join(tmp, "shading"))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene, _, _ = load_scene(path, spectral=True)
    t_load = time.perf_counter() - t0
    st = table_stats(scene)
    hw = scene.stex.image_hw.tolist()
    log(f"[shading scene] written in {t_write:.2f} s, loaded in "
        f"{t_load:.2f} s: {scene.geometry.num_tris} triangles, "
        f"{st['chunks']} SBVH chunks ({st['refs']} references), "
        f"{scene.materials.num} materials, lobe kinds "
        f"{scene.lobe_kinds_present}, {len(hw)} images {hw}, environment "
        f"importance map {tuple(scene.env.dist.shape)}, lights "
        f"{scene.lights.num} (env share {float(scene.lights.env_prob):.4f}), "
        f"alpha {scene.has_alpha}, normal map {scene.has_normal_map}")
    if not (scene.has_alpha and scene.has_env and scene.has_normal_map
            and len(scene.lobe_kinds_present) == 8 and len(hw) == 4):
        raise AssertionError("the shading scene lacks a feature")
    return path, scene


def phase_shading(path, tmp) -> dict:
    """The CLI's main in-process on the shading scene: spectral, 1024x768,
    depth 100. In an alpha scene shadow rays go through closest hit too, so
    closest-hit launches are 2 x iterations + the alpha recasts and any-hit
    launches 0."""
    out = os.path.join(tmp, "shading_out")
    torch.cuda.synchronize()
    tv.reset_launches()
    tpt.reset_alpha_recasts()
    tv.track_work(DEV)
    res = cli_main([path, "--spectral", "--spp", str(SHADE_SPP), "--width",
                    str(SHADE_W), "--height", str(SHADE_H), "--max-depth",
                    str(DEPTH), "--format", "bmp", "--out", out])
    torch.cuda.synchronize()
    launches = dict(tv.LAUNCHES)
    recasts = dict(tpt.ALPHA_RECASTS)
    work = dict(zip(("closest_hit_tests", "closest_hit_transforms",
                     "any_hit_tests", "any_hit_transforms"),
                    tv.WORK.tolist()))
    tv.track_work(None)
    lanes = res["lanes"]
    iters = sum(p[2] for p in res["passes"])
    secs = sum(p[1] for p in res["passes"])
    ksps = SHADE_W * SHADE_H * res["spp"] / secs / 1e3
    mrays = 2 * lanes * iters / secs / 1e6
    log(f"[shading] scene load {res['load_seconds']:.3f} s")
    for spp, sec, it in res["passes"]:
        log(f"[shading]   pass of {spp} spp: {sec:.3f} s, {it} iterations")
    log(f"[shading] {SHADE_W}x{SHADE_H} spp {res['spp']} depth {DEPTH} "
        f"spectral: {secs:.3f} s in {len(res['passes'])} passes, {iters} "
        f"iterations ({secs / iters * 1e3:.2f} ms each), {ksps:.1f} "
        f"ksamples/s, {mrays:.2f} Mrays/s (2 x {lanes} lanes x iterations), "
        f"launches {launches}, alpha recasts {recasts['casts']} casts "
        f"({recasts['casts'] / iters:.3f} per iteration) carrying "
        f"{recasts['rays']} rays, work the kernels counted {work}")
    names = sorted(os.listdir(out))
    last = os.path.join(out, f"{len(res['passes']) - 1:03d}.bmp")
    if not os.path.exists(last) or res["spp"] != SHADE_SPP:
        raise AssertionError(f"shading exports {names}")
    img = read_bmp(last)
    log(ascii_view(torch.as_tensor(img / 255.0, device=DEV)))
    want = {"closest_hit": 2 * iters + recasts["casts"], "any_hit": 0,
            "xform_rays": 0}
    if traversals(launches) != want:
        raise AssertionError(f"launch counts {launches}, expected {want} "
                             f"(2 x {iters} iterations + {recasts['casts']} "
                             f"alpha recasts, no any hit)")
    if not recasts["casts"] > 0:
        raise AssertionError("no alpha recast in the shading render")
    if img.shape != (SHADE_H, SHADE_W, 3) or not img.mean() > 5.0:
        raise AssertionError(f"implausible shading export: shape "
                             f"{img.shape}, mean {img.mean()}")
    return dict(seconds=secs, iterations=iters, launches=launches,
                recasts=recasts, work=work, ksamples_per_s=ksps,
                mrays_per_s=mrays, load_seconds=res["load_seconds"])


def shading_ray_sets(scene) -> dict:
    """The shading phase's three closest-hit sets at the main path's lane
    count, in its sorted order: camera rays; the recast set (the camera
    rays whose first hit is an alpha-zero texel, re-cast from just beyond
    it, only those rays active); shadow rays from the camera rays' hits,
    half to points on the area light, half to directions drawn from the
    environment's importance map (tmax 4 x the world radius)."""
    rs = np.random.RandomState(3)
    everyone = torch.ones(LANES, dtype=torch.bool, device=DEV)
    o_c, d_c, _ = main_path_order(scene, everyone,
                                  *camera_rays(scene, LANES, rs,
                                               SHADE_W, SHADE_H))
    hit = scene_intersect(scene, o_c, d_c)
    cut = tpt._alpha_zero(scene, hit)
    tmin_r = torch.where(cut, hit.t + RAY_EPSILON, RAY_EPSILON)
    sp = resolve_sp(scene, hit, o_c, d_c)
    u = [_cuda_tensor(rs.rand(LANES)) for _ in range(3)]
    n_l = scene.lights.tri_idx.shape[0]
    tri = scene.lights.tri_idx.long()[(u[0] * n_l).long().clamp(max=n_l - 1)]
    lp = sample_triangle_point(scene.geometry, tri, u[1], u[2])
    ex, ey, _ = sample_continuous_2d(scene.env.dist, u[1], u[2])
    e_dir = tpt._env_direction(ex * 2 * np.pi, ey * np.pi)
    to_env = torch.as_tensor(rs.rand(LANES) < 0.5, device=DEV)
    delta = lp.p - sp.p
    dist = torch.sqrt((delta * delta).sum(-1).clamp(min=1e-12))
    d_s = torch.where(to_env[:, None], e_dir, delta / dist[:, None])
    tmax_s = torch.where(to_env, 4.0 * scene.world_radius,
                         dist * (1.0 - 1e-3))
    o_s, d_s, tmax_s, act_s = main_path_order(scene, hit.mask, sp.p, d_s,
                                              tmax_s)
    return {"camera": (o_c, d_c, float("inf"), None, None, RAY_EPSILON),
            "recast": (o_c, d_c, float("inf"), cut, None, tmin_r),
            "shadow": (o_s, d_s, tmax_s, act_s, None, RAY_EPSILON)}


def phase_shading_kernels(scene) -> dict:
    """closest_hit_kernel against its plain version on the shading scene's
    three sets; then the cost of one whole recast (ranges, worklists, the
    kernel and the hit resolution) at the recast set."""
    pt = scene.pallas_tris
    sets = shading_ray_sets(scene)
    n_cut = int(sets["recast"][3].sum())
    log(f"[shading kernels] {pt.n_chunks} chunks of {pt.chunk}, {LANES} "
        f"rays, {n_cut} of the camera rays stop on an alpha-zero texel")
    if not n_cut:
        raise AssertionError("no camera ray stops on an alpha-zero texel")
    out = {name: check_closest(f"shading {name}", pt, *args)
           for name, args in sets.items()}
    o, d, tmax, cut, _, tmin_r = sets["recast"]
    recast_ms = median_ms(lambda: scene_intersect(scene, o, d, tmin_r, tmax,
                                                  active=cut), 10)
    log(f"[shading kernels] one recast cast of {n_cut} active rays "
        f"(prepare_cast + closest_hit_kernel + hit resolution): "
        f"{recast_ms:.3f} ms")
    out["recast_cast_ms"] = recast_ms
    return out


def equirect_scene():
    """A diffuse sphere 3 units ahead under a constant sky, seen by the
    equirectangular camera from the origin."""
    b = SceneBuilder()
    mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
    b.add_mesh(*uv_sphere((0, 0, -3), 1.0, 8, 16), mat)
    b.set_environment(b.add_stex_image(b.add_image(
        np.ones((8, 16, 3), np.float32))), 1.0)
    b.set_camera_equirect(np.eye(4, dtype=np.float32))
    return b.build(use_bvh=False).to(DEV)


def phase_env() -> dict:
    """env_sphere_scene under a constant environment (L = 1) through the
    perspective camera: a pixel's value is the mean over its samples of the
    camera weight times the radiance, so background pixels must equal their
    mean camera weight and sphere pixels average rho = 0.6 times it within
    5% (L_out = rho L for a convex Lambert body). Both traversal kernels run
    (no alpha). Then the equirectangular camera."""
    scene = env_sphere_scene(reflectance=ENV_RHO)
    w = h = ENV_SIZE
    torch.cuda.synchronize()
    tv.reset_launches()
    t0 = time.perf_counter()
    img, iters = render_wavefront(scene, w, h, spp=ENV_SPP, seed=SEED,
                                  max_depth=ENV_DEPTH, return_iters=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tv.LAUNCHES)
    n_pix = w * h
    pid = torch.arange(n_pix, device=DEV)
    wsum = torch.zeros(n_pix, device=DEV)
    nhit = torch.zeros(n_pix, device=DEV)
    for sid in range(ENV_SPP):
        rays = _camera_ray(scene, pid, torch.full_like(pid, sid), SEED, w, h)
        wsum += rays.weight
        for s0 in range(0, n_pix, LANES):
            nhit[s0:s0 + LANES] += scene_intersect(
                scene, rays.o[s0:s0 + LANES],
                rays.d[s0:s0 + LANES]).mask.float()
    wbar = (wsum / ENV_SPP).reshape(h, w)
    lum = img.mean(-1)
    bg = (nhit == 0).reshape(h, w)
    on = (nhit == ENV_SPP).reshape(h, w)
    bg_err = float(((lum - wbar).abs() / wbar)[bg].max())
    rho = float((lum[on] / wbar[on]).mean())
    log(f"[env] {w}x{h} spp {ENV_SPP} depth {ENV_DEPTH} sphere under a "
        f"constant sky: {secs:.3f} s, {iters} iterations, launches "
        f"{launches}; background pixels {int(bg.sum())}, largest relative "
        f"difference from the environment {bg_err:.3g}; sphere pixels "
        f"{int(on.sum())}, mean radiance / camera weight {rho:.5f} "
        f"(rho {ENV_RHO})")
    if traversals(launches) != {"closest_hit": iters, "any_hit": iters,
                                "xform_rays": 0}:
        raise AssertionError(f"env launch counts {launches} != {iters} "
                             f"iterations for each traversal kernel")
    if not (bg.any() and on.any()) or bg_err > 1e-5:
        raise AssertionError("env background pixels differ from the sky")
    if abs(rho / ENV_RHO - 1.0) >= 0.05:
        raise AssertionError(f"sphere radiance {rho} is not rho {ENV_RHO}")
    env_launches = launches
    # The equirectangular camera: sky nearly everywhere.
    eq = equirect_scene()
    tv.reset_launches()
    img, it_eq = render_wavefront(eq, EQUI_W, EQUI_H, spp=4, seed=SEED,
                                  max_depth=ENV_DEPTH, return_iters=True)
    torch.cuda.synchronize()
    lit = float((img > 0).float().mean())
    log(f"[env] equirectangular camera {EQUI_W}x{EQUI_H} spp 4: {it_eq} "
        f"iterations, launches {dict(tv.LAUNCHES)}, values above 0 {lit:.4f}")
    if not (lit > 0.9 and bool(torch.isfinite(img).all())):
        raise AssertionError(f"equirect render: only {lit} above 0")
    return dict(seconds=secs, iterations=iters, launches={
        k: env_launches[k] + tv.LAUNCHES[k] for k in env_launches},
        rho=rho, background_err=bg_err)


# ---------------------------------------------------------------------------
# Phases 12-17: the fixed-depth path tracer, gradients, the debug renderer
# ---------------------------------------------------------------------------

def _agreement(a, b, rtol=1e-3, atol=1e-6) -> tuple[float, float, int]:
    """Share of pixels (lanes) with every channel within rtol / atol, the
    relative difference of the means, and the count beyond."""
    close = (np.abs(a - b) <= rtol * np.abs(b) + atol).all(-1)
    return (float(close.mean()), abs(float(a.mean()) / float(b.mean()) - 1.0),
            int((~close).sum()))


def phase_pt(scene) -> dict:
    """The spectral Cornell box through `render` at 1024x768, spp 1, depth
    16: every lane runs all 16 bounces (one closest-hit and one shadow cast
    each) after its camera cast, in batches of 65,536 lanes."""
    tpt.render(scene, 128, 96, spp=1, seed=SEED, max_depth=PT_DEPTH)
    torch.cuda.synchronize()
    n_pix = WIDTH * HEIGHT
    batches = -(-n_pix // PT_BATCH)
    torch.cuda.reset_peak_memory_stats()
    tv.reset_launches()
    tpt.reset_alpha_recasts()
    tpt.track_rays(DEV)
    t0 = time.perf_counter()
    img = tpt.render(scene, WIDTH, HEIGHT, spp=PT_SPP, seed=SEED,
                     max_depth=PT_DEPTH, ray_batch=PT_BATCH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tv.LAUNCHES)
    closest_rays, shadow_rays, idle = tpt.RAYS.tolist()
    tpt.track_rays(None)
    recasts = tpt.ALPHA_RECASTS["casts"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    ksps = n_pix * PT_SPP / secs / 1e3
    mrays = (closest_rays + shadow_rays) / secs / 1e6
    lane_casts = (launches["closest_hit"] + launches["any_hit"]) * PT_BATCH
    bounces = batches * PT_SPP * PT_DEPTH
    mean = float(img.mean())
    neg = float((img < 0).float().mean())
    log(f"[pt] {WIDTH}x{HEIGHT} spp {PT_SPP} depth {PT_DEPTH} spectral "
        f"Cornell through render: {secs:.3f} s, {ksps:.1f} ksamples/s, "
        f"{mrays:.2f} Mrays/s of the rays cast ({closest_rays} closest-hit "
        f"and {shadow_rays} shadow rays of active lanes; "
        f"{lane_casts / secs / 1e6:.2f} M lanes/s over {lane_casts} lane "
        f"casts), {batches} batches of {PT_BATCH} lanes, launches "
        f"{launches}, alpha recasts {recasts}, bounces that began with no "
        f"active lane {idle} of {bounces}, image mean {mean:.5f}, negative "
        f"values {neg:.5f}, peak memory {peak:.2f} GiB")
    log(ascii_view(img))
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError("pt image is not finite or has the wrong shape")
    if not (mean > 0.0 and neg < 0.05):
        raise AssertionError(f"implausible pt image: mean {mean}, negative "
                             f"share {neg}")
    want = {"closest_hit": batches * PT_SPP * (1 + PT_DEPTH) + recasts,
            "any_hit": batches * PT_SPP * PT_DEPTH, "xform_rays": 0}
    if traversals(launches) != want:
        raise AssertionError(f"pt launch counts {launches} != {want}")
    return dict(seconds=secs, ksamples_per_s=ksps, mrays_per_s=mrays,
                launches=launches, rays=[closest_rays, shadow_rays],
                idle_bounces=idle, bounces=bounces, peak_gib=peak,
                mean=mean)


def phase_pt_profile(scene) -> None:
    """Where `render`'s time goes: one 256x192 (49,152 lanes, one batch)
    spp 1 depth 16 render under torch.profiler: device ops and host syncs
    per bounce, the device's busy share, the kernels' share of it."""
    profile_run(lambda: tpt.render(scene, 256, 192, spp=1, seed=SEED,
                                   max_depth=PT_DEPTH),
                "pt profile", f"256x192 spp 1 depth {PT_DEPTH}",
                "cast steps", 1 + PT_DEPTH)


def phase_pt_check(scene) -> None:
    """`render` at 48x36 on the card against the CPU (plain versions), with
    phase_cross_check's statistic; then the coherence sort on the card: one
    batch of camera rays traced with and without it."""
    kw = dict(spp=PT_CHECK_SPP, seed=SEED, max_depth=PT_DEPTH)
    t0 = time.perf_counter()
    gpu = tpt.render(scene, CHECK_W, CHECK_H, **kw).cpu().numpy()
    t1 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = tpt.render(scene.to("cpu"), CHECK_W, CHECK_H, device="cpu",
                     **kw).numpy()
    t2 = time.perf_counter()
    close, rel, n_far = _agreement(gpu, cpu)
    log(f"[pt check] {CHECK_W}x{CHECK_H} spp {PT_CHECK_SPP} depth {PT_DEPTH}: "
        f"card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; pixels within rtol 1e-3 "
        f"{close:.6f} ({n_far} beyond), means {gpu.mean():.6f} / "
        f"{cpu.mean():.6f} (rel {rel:.2e})")
    if close < 0.98 or rel >= 0.01:
        raise AssertionError("the card's render disagrees with the CPU's")
    pid = torch.arange(PT_BATCH, device=DEV)
    sid = torch.zeros_like(pid)
    rays = tpt._camera_ray(scene, pid, sid, SEED, WIDTH, HEIGHT)
    args = (scene, rays.o, rays.d, pid, sid, SEED)
    a = tpt.trace_radiance(*args, max_depth=6, sort_rays=False).cpu().numpy()
    b = tpt.trace_radiance(*args, max_depth=6, sort_rays=True).cpu().numpy()
    close, rel, n_far = _agreement(a, b, rtol=1e-4, atol=1e-5)
    n_bits = int((a != b).any(-1).sum())
    log(f"[pt check] sort_rays, {PT_BATCH} camera rays, depth 6: lanes "
        f"within rtol 1e-4, atol 1e-5 {close:.6f} ({n_far} beyond, {n_bits} "
        f"differ in any bit), means rel {rel:.2e}")
    # A lane can differ only where a hit ties at equal t in two entries,
    # whose order the sort changes: at most 0.1% of the lanes.
    if close < 0.999 or rel >= 1e-4:
        raise AssertionError("sort_rays changes the card's trace")


def phase_pt_kernels(scene) -> dict:
    """Both kernels against their plain versions on the second bounce of
    `_trace_core` at 65,536 lanes (the first batch's camera rays), sorted as
    `render` sorts them: its closest-hit and its shadow cast, captured
    through the `cast_fns` hook."""
    seen = {"closest": [], "shadow": []}

    def isect(*args, **kw):
        seen["closest"].append((args, kw))
        return tpt.scene_intersect_alpha(*args, **kw)

    def occl(*args, **kw):
        seen["shadow"].append((args, kw))
        return tpt.scene_occluded(*args, **kw)

    pid = torch.arange(PT_BATCH, device=DEV)
    sid = torch.zeros_like(pid)
    rays = tpt._camera_ray(scene, pid, sid, SEED, WIDTH, HEIGHT)
    tpt._trace_core(scene, rays.o, rays.d, pid, sid, SEED, 2,
                    sort_rays=True, cast_fns=(isect, occl))
    (_, o, d), kw = seen["closest"][2]
    (_, o_s, d_s, _, tmax_s), kw_s = seen["shadow"][1]
    pt = scene.pallas_tris
    act, act_s = kw["active"], kw_s["active"]
    log(f"[pt kernels] second bounce of {PT_BATCH} lanes: "
        f"{int(act.sum())} closest-hit and {int(act_s.sum())} shadow rays "
        f"active, {-(-PT_BATCH // tv._auto_rb(pt))} blocks of "
        f"{tv._auto_rb(pt)}")
    return {"closest_hit": check_closest("pt bounce 2", pt, o, d,
                                         float("inf"), act),
            "any_hit": check_any("pt shadow 2", pt, o_s, d_s, tmax_s, act_s)}


def phase_pt_golden() -> dict:
    """The port-built grass field (instances, motion blur) through `render`
    at tests/test_instancing.py's golden settings, against its golden."""
    scene = grass_field(n_side=8, blade_segments=3, animated_fraction=0.25)
    torch.cuda.synchronize()
    tv.reset_launches()
    t0 = time.perf_counter()
    img = tpt.render(scene, 48, 36, spp=32, max_depth=5, seed=11)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tv.LAUNCHES)
    gold = np.load(GRASS_GOLDEN)["img"]
    close, rel, n_far = _agreement(img.cpu().numpy(), gold, atol=1e-4)
    log(f"[pt golden] grass field n8, 48x36 spp 32 depth 5 seed 11: "
        f"{secs:.3f} s, launches {launches}; pixels within rtol 1e-3, atol "
        f"1e-4 of tests/goldens/grass_field_n8.npz {close:.6f} ({n_far} "
        f"beyond), means rel {rel:.2e}")
    want = {"closest_hit": 32 * 6, "any_hit": 32 * 5, "xform_rays": 0}
    if traversals(launches) != want:
        raise AssertionError(f"golden launch counts {launches} != {want}")
    if close < 0.98 or rel >= 0.01:
        raise AssertionError("the grass render disagrees with its golden")
    return dict(seconds=secs, launches=launches, close=close)


def _with_row(scene, row, v):
    """stex.value[row, :] = v in a copy of the scene, differentiable in v."""
    val = scene.stex.value
    sel = (torch.arange(val.shape[0], device=val.device) == row)[:, None]
    return dataclasses.replace(scene, stex=dataclasses.replace(
        scene.stex, value=torch.where(sel, v, val)))


def _fan(seed, n, spread):
    """tests/test_grad.py's ray fans from (0, 1.2, 1) in the box."""
    rs = np.random.RandomState(seed)
    o = np.array([[0.0, 1.2, 1.0]] * n)
    if spread:
        o = o + rs.randn(n, 3) * spread
    d = rs.randn(n, 3)
    d = torch.nn.functional.normalize(_cuda_tensor(d), dim=-1)
    return _cuda_tensor(o), d


def phase_grad() -> dict:
    """Gradients on the card (tests/test_grad.py's Cornell box without the
    metal and glass spheres): the scalar finite-difference check, the
    emitter-scale identity, and the per-pixel gradient image w.r.t. the
    emitter scale through render_fused at 256x192, spp 1, depth 3."""
    scene = cornell_box_spheres(sphere_res=6, use_bvh=False, metal=False,
                                glass=False)
    tv.reset_launches()

    def mean_radiance(sc, o, d, depth):
        n = o.shape[0]
        pid = torch.arange(n, device=DEV)
        return tpt.trace_radiance(sc, o, d, pid, torch.zeros_like(pid), 0,
                                  max_depth=depth).mean()

    o, d = _fan(0, 256, 0.05)

    def f(v):
        return mean_radiance(_with_row(scene, 2, v), o, d, 4)

    v = torch.tensor(0.75, device=DEV, requires_grad=True)
    (g,) = torch.autograd.grad(f(v), v)
    with torch.no_grad():
        fd_s = float((f(torch.tensor(0.76, device=DEV))
                      - f(torch.tensor(0.74, device=DEV))) / 0.02)
    g = float(g)
    fd_rel = abs(g / fd_s - 1.0)
    log(f"[grad] d mean radiance / d white-wall reflectance: autograd "
        f"{g:.6f}, central difference {fd_s:.6f} (rel {fd_rel:.4f}, gate "
        f"0.08)")
    if not (g > 0 and fd_rel <= 0.08):
        raise AssertionError("the reflectance gradient disagrees with its "
                             "finite difference")
    o, d = _fan(1, 128, 0.0)
    s = torch.tensor(30.0, device=DEV, requires_grad=True)
    val = mean_radiance(_with_row(scene, 4, s), o, d, 3)
    (gs,) = torch.autograd.grad(val, s)
    gs, val = float(gs), float(val.detach())
    rel = abs(gs * 30.0 / val - 1.0)
    log(f"[grad] emitter scale: grad {gs:.7f}, f / s {val / 30.0:.7f} (rel "
        f"{rel:.2e}, gate 1e-4)")
    if rel > 1e-4:
        raise AssertionError("the emitter gradient is not f / s")

    def image(v):
        return tpt.render_fused(_with_row(scene, 4, v), GRAD_W, GRAD_H,
                                spp=1, max_depth=GRAD_DEPTH)

    v0 = torch.tensor(30.0, device=DEV)
    image(v0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        img = image(v0)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    v = v0.clone().requires_grad_(True)
    t0 = time.perf_counter()
    out = image(v)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    (g_sum,) = torch.autograd.grad(out.sum(), v)
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0 - t_fwd
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del out
    t_jvp = []
    for _ in range(2):          # the first call includes one-time set-up
        t0 = time.perf_counter()
        with fwAD.dual_level():
            _, dimg = fwAD.unpack_dual(image(fwAD.make_dual(
                v0, torch.tensor(1.0, device=DEV))))
        torch.cuda.synchronize()
        t_jvp.append(time.perf_counter() - t0)
    with torch.no_grad():
        fd = (image(v0 + 0.5) - image(v0 - 0.5)) / 1.0
    dimg, fd, img = (x.cpu().numpy() for x in (dimg, fd, img))
    atol = 1e-5 * float(np.abs(fd).max())
    far_fd = int((np.abs(dimg - fd) > 2e-3 * np.abs(fd) + atol).sum())
    far_lin = int((np.abs(dimg - img / 30.0)
                   > 2e-3 * np.abs(img / 30.0) + atol).sum())
    sum_rel = abs(float(g_sum) / float(dimg.sum()) - 1.0)
    launches = dict(tv.LAUNCHES)
    log(f"[grad] d image / d emitter scale at {GRAD_W}x{GRAD_H} spp 1 depth "
        f"{GRAD_DEPTH} through render_fused: forward without a graph "
        f"{t_plain:.3f} s; forward with the graph {t_fwd:.3f} s, backward "
        f"{t_bwd:.3f} s, peak memory above the scene "
        f"{peak:.3f} GiB; forward mode (the per-pixel map) {t_jvp[0]:.3f} "
        f"s, again {t_jvp[1]:.3f} s; "
        f"values beyond rtol 2e-3 of the FD {far_fd}, of image / scale "
        f"{far_lin} (of {dimg.size}); reverse-mode gradient of the image sum "
        f"against the map's sum rel {sum_rel:.2e}; launches {launches}")
    if far_fd or far_lin or not np.isfinite(dimg).all() \
            or not np.abs(dimg).max() > 1e-4 or sum_rel > 1e-3:
        raise AssertionError("the gradient image disagrees with its finite "
                             "difference")
    return dict(fd_rel=fd_rel, emitter_rel=rel,
                forward_s=t_plain, forward_graph_s=t_fwd, backward_s=t_bwd,
                jvp_s=t_jvp[1], peak_gib=peak, launches=launches)


def aov_gates(out, tag) -> None:
    """tests/test_parity.py:160-183 on the CLI's AOV exports (0.5 n + 0.5 in
    8 bits) against the reference renderer's: mean difference below 2.5,
    more than 0.96 of the pixels within 8."""
    for name, gold_name in AOV_GOLDENS.items():
        ours = read_bmp(os.path.join(out, f"{name}.bmp"))
        gold = read_bmp(os.path.join(ROOT, "tests", "goldens",
                                     f"ref_parity_aov_{gold_name}.bmp"))
        d = np.abs(ours - gold)
        within = float((d.max(axis=-1) <= 8.0).mean())
        log(f"[{tag}] {name}: mean difference {d.mean():.4f} < 2.5, pixels "
            f"within 8 {within:.4f} > 0.96")
        if not (d.mean() < 2.5 and within > 0.96):
            raise AssertionError(f"the {name} AOV fails its golden gate")


def phase_debug(tmp) -> dict:
    """The debug renderer through the CLI on the parity scene at its 256x192:
    its `main` in-process (launches counted), then `python -m
    slr_tpu_torch` as a program; both sets of exports gated."""
    out = os.path.join(tmp, "debug")
    torch.cuda.synchronize()
    tv.reset_launches()
    res = cli_main([PARITY, "--renderer", "debug", "--format", "bmp",
                    "--out", out])
    launches = dict(tv.LAUNCHES)
    log(f"[debug] main in-process: {res['width']}x{res['height']}, scene "
        f"load {res['load_seconds']:.3f} s, AOVs {res['seconds']:.3f} s, "
        f"launches {launches}")
    if traversals(launches) != {"closest_hit": 1, "any_hit": 0,
                                "xform_rays": 0}:
        raise AssertionError(f"debug launch counts {launches}")
    aov_gates(out, "debug")
    out2 = os.path.join(tmp, "debug_module")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "slr_tpu_torch", PARITY, "--renderer",
         "debug", "--format", "bmp", "--out", out2],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m slr_tpu_torch --renderer debug "
                             f"failed:\n{proc.stderr[-4000:]}")
    log(f"[debug] python -m slr_tpu_torch --renderer debug: exit 0 in "
        f"{secs:.2f} s, wrote {sorted(os.listdir(out2))}")
    aov_gates(out2, "debug module")
    return dict(seconds=res["seconds"], module_seconds=secs,
                launches=launches)


def turning_bar(builder_cls):
    """A static ground quad and one bar (2 BAR_L x 2 BAR_W in the xz plane,
    at y = 0.5) that turns BAR_TURN degrees about +y over the shutter: the
    top of its arc (at 90 degrees) lies between two of the 17 shutter
    fractions its box is sampled at, outside the box."""
    def turn(deg):
        a = np.radians(deg)
        m = np.eye(4, dtype=np.float32)
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = (np.cos(a), np.sin(a),
                                              -np.sin(a), np.cos(a))
        m[1, 3] = 0.5
        return m

    b = builder_cls()
    mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
    up = np.tile(np.float32([0, 1, 0]), (4, 1))
    tx = np.tile(np.float32([1, 0, 0]), (4, 1))
    uv = np.zeros((4, 2), np.float32)
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    b.add_mesh(np.float32([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]]),
               up, tx, uv, quad, mat)
    bid = b.begin_blas()
    b.add_mesh(np.float32([[-BAR_L, 0, -BAR_W], [BAR_L, 0, -BAR_W],
                           [BAR_L, 0, BAR_W], [-BAR_L, 0, BAR_W]]),
               up, tx, uv, quad[:, ::-1].copy(), mat)
    b.end_blas()
    b.add_instance(bid, turn(0.0), turn(BAR_TURN))
    b.set_camera_perspective(np.eye(4, dtype=np.float32), 1.0, 0.5)
    return b.build(use_bvh=False)


def turning_bar_rays():
    """(o, d, f) numpy: one block of rays straight down, BAR_RAYS onto the
    bar at seeded shutter fractions (so the block visits its entry) and
    BAR_RAYS at the arc's top at its shutter fraction, 2e-4 to 1.4e-3
    inside the bar's tip, beyond the sampled box."""
    n = BAR_RAYS
    rs = np.random.RandomState(0)
    f_box = rs.rand(n).astype(np.float32)
    s = rs.uniform(-0.9, 0.9, n)
    a = np.radians(f_box * BAR_TURN)
    on_bar = np.stack([s * np.cos(a), np.full(n, 0.5), -s * np.sin(a)], 1)
    tip = np.stack([np.zeros(n), np.full(n, 0.5),
                    -(BAR_L - np.linspace(2e-4, 1.4e-3, n))], 1)
    o = (np.concatenate([on_bar, tip]) + [0.0, 2.0, 0.0]).astype(np.float32)
    d = np.tile(np.float32([0, -1, 0]), (2 * n, 1))
    f = np.concatenate([f_box, np.full(n, 90.0 / BAR_TURN)]).astype(
        np.float32)
    return o, d, f


def phase_motion_box() -> dict:
    """ROADMAP C1 on the card: both kernels against their plain versions on
    the turning bar's rays, the grazing ones included (their cast boxes are
    widened by `motion_slack`)."""
    scene = turning_bar(SceneBuilder).to(DEV)
    pt = scene.pallas_tris
    o, d, f = (_cuda_tensor(x) for x in turning_bar_rays())
    n = BAR_RAYS
    closest = check_closest("turning bar", pt, o, d, float("inf"), None, f)
    tmax = torch.full((2 * n,), 2.4, device=DEV)
    anyhit = check_any("turning bar", pt, o, d, tmax, None, f)
    hit = tv.intersect_pallas(scene.geometry, pt, o, d, f=f,
                              instances=scene.instances)
    occ = tv.anyhit_pallas(scene.geometry, pt, o, d, tmax=tmax, f=f)
    graze_hit = int((hit.inst[n:] == 0).sum())
    graze_occ = int(occ[n:].sum())
    slack = float(tv.motion_slack(pt.boxes, pt.entry_inst,
                                  pt.inst_trs).max())
    log(f"[motion box] the bar's box widened by {slack:.5f}; "
        f"of {n} rays at the arc's top, beyond the sampled box: closest hit "
        f"on the bar {graze_hit}, occluded {graze_occ}")
    if graze_hit != n or graze_occ != n:
        raise AssertionError("the kernels miss the turning bar's arc")
    return dict(closest_hit=closest, any_hit=anyhit)


# ---------------------------------------------------------------------------
# Phases 18-24: the bidirectional path tracer and photon mapping
# ---------------------------------------------------------------------------

def bpt_launches_wanted(base_calls, deep_calls, recasts=0) -> dict:
    """What the BPT passes launch: per `bpt_batch` call, one closest-hit
    cast per subpath bounce (caps - 1 on each side) and one any-hit cast
    per eye level (the cap), plus the alpha recasts."""
    return {"closest_hit": base_calls * 2 * (BPT_BASE - 1)
            + deep_calls * 2 * (BPT_DEEP - 1) + recasts,
            "any_hit": base_calls * BPT_BASE + deep_calls * BPT_DEEP,
            "xform_rays": 0}


def run_bpt(tag, scene, width, height, spp, ray_batch=None) -> dict:
    """`render_bpt` at the default adaptive caps after a warm-up (128x96,
    1 spp):
    seconds, ksamples/s, the clipped lanes, the deep passes and the launch
    gate."""
    tbpt.render_bpt(scene, 128, 96, spp=1, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tv.reset_launches()
    tpt.reset_alpha_recasts()
    tbpt.reset_tiers()
    t0 = time.perf_counter()
    img = tbpt.render_bpt(scene, width, height, spp=spp, seed=SEED,
                          ray_batch=ray_batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tv.LAUNCHES)
    tiers = dict(tbpt.TIERS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch = ray_batch or min(width * height, 65536)
    base_calls = spp * -(-width * height // batch)
    want = bpt_launches_wanted(base_calls, tiers["deep_passes"],
                               tpt.ALPHA_RECASTS["casts"])
    ksps = width * height * spp / secs / 1e3
    clipped = tiers["clipped"] / max(tiers["base_lanes"], 1)
    mean = float(img.mean())
    log(f"[{tag}] {width}x{height} spp {spp}, caps {BPT_BASE} -> "
        f"{BPT_DEEP}: {secs:.3f} s, {ksps:.2f} ksamples/s; lanes clipped at "
        f"the base cap {tiers['clipped']} of {tiers['base_lanes']} "
        f"({clipped:.5f}), deep passes {tiers['deep_passes']} over "
        f"{tiers['deep_lanes']} lanes; launches {launches} (wanted {want}), "
        f"image mean {mean:.5f}, peak memory {peak:.2f} GiB")
    log(ascii_view(img))
    if tuple(img.shape) != (height, width, 3) or not bool(
            torch.isfinite(img).all()) or not mean > 0.0:
        raise AssertionError(f"{tag} image is not finite, black or of the "
                             f"wrong shape")
    if traversals(launches) != want:
        raise AssertionError(f"{tag} launch counts {launches} != {want}")
    return dict(seconds=secs, ksamples_per_s=ksps, clipped_share=clipped,
                tiers=tiers, launches=launches, peak_gib=peak, mean=mean)


def phase_bpt(parity) -> dict:
    """bench.py's BPT configuration on the port: the spectral parity scene
    at 256x192, spp 8, the default adaptive caps; then one base pass of it
    profiled (flat caps 8 + 8, one sample)."""
    res = run_bpt("bpt", parity, BPT_W, BPT_H, BPT_SPP)
    prof = profile_run(
        lambda: tbpt.render_bpt(parity, BPT_W, BPT_H, spp=1, seed=SEED,
                                max_light_verts=BPT_BASE,
                                max_eye_verts=BPT_BASE),
        "bpt profile", f"{BPT_W}x{BPT_H} spp 1, flat caps {BPT_BASE}",
        f"cast steps ({BPT_BASE - 1} + {BPT_BASE - 1} bounces, {BPT_BASE} "
        f"connection levels)", 2 * (BPT_BASE - 1) + BPT_BASE)
    # One deep pass alone: the smallest batch of the ladder at full caps.
    n = 1024
    pix = torch.arange(n, device=DEV)
    film = torch.zeros((BPT_W * BPT_H, 16), device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tbpt.bpt_batch(parity, pix, torch.zeros_like(pix), SEED, BPT_W, BPT_H,
                   film, BPT_DEEP, BPT_DEEP,
                   lane_mask=torch.ones(n, dtype=torch.bool, device=DEV))
    torch.cuda.synchronize()
    deep_s = time.perf_counter() - t0
    steps = 2 * (BPT_DEEP - 1) + BPT_DEEP
    base_s = prof["wall"]
    log(f"[bpt profile] one deep pass of {n} lanes at caps {BPT_DEEP}: "
        f"{deep_s:.3f} s ({deep_s / steps * 1e3:.2f} ms per cast step); "
        f"the {res['tiers']['deep_passes']} deep passes of the render are "
        f"~{res['tiers']['deep_passes'] * deep_s / res['seconds']:.3f} of "
        f"its wall time, its {BPT_SPP} base passes "
        f"~{BPT_SPP * base_s / res['seconds']:.3f}")
    res["profile"] = dict(prof, deep_pass_s=deep_s)
    return res


def phase_bpt_cornell() -> tuple:
    """The spectral Cornell box at 512x384, spp 1, in 3 batches of 65,536
    lanes."""
    scene = cornell_box_spheres(spectral=True)
    return scene, run_bpt("bpt cornell", scene, BPT_CORNELL_W, BPT_CORNELL_H,
                          BPT_CORNELL_SPP, ray_batch=BPT_LANES)


def phase_bpt_kernels(scene) -> dict:
    """Both kernels against their plain versions on the BPT's own ray
    sets, captured through `bpt_batch`'s `cast_fns` hook on the first
    65,536-lane batch of the Cornell box at base caps: the light subpath's
    second bounce (closest hit), and the whole connection cast of eye level
    t = 2 (any hit: n_l x 65,536 shadow rays, each with its own tmax)."""
    seen = {"closest": [], "shadow": []}

    def isect(*args, **kw):
        seen["closest"].append((args, kw))
        return tpt.scene_intersect_alpha(*args, **kw)

    def occl(*args, **kw):
        seen["shadow"].append((args, kw))
        return tpt.scene_occluded(*args, **kw)

    n = BPT_LANES
    film = torch.zeros((WIDTH * HEIGHT, 16), device=DEV)
    tbpt.bpt_batch(scene, torch.arange(n, device=DEV),
                   torch.zeros(n, dtype=torch.int64, device=DEV), SEED,
                   WIDTH, HEIGHT, film, BPT_BASE, BPT_BASE,
                   pid_contiguous=True, cast_fns=(isect, occl))
    (_, o, d), kw = seen["closest"][1]
    (_, o_s, d_s, _, tmax_s), kw_s = seen["shadow"][1]
    pt = scene.pallas_tris
    act, act_s = kw["active"], kw_s["active"]
    log(f"[bpt kernels] light bounce 2 of {n} lanes: {int(act.sum())} "
        f"closest-hit rays active; connection cast t = 2: "
        f"{o_s.shape[0]} shadow rays ({o_s.shape[0] // n} light vertices x "
        f"{n}), {int(act_s.sum())} active")
    if o_s.shape[0] != BPT_BASE * n:
        raise AssertionError("the connection cast is not n_l x lanes")
    return {"closest_hit": check_closest("bpt light bounce 2", pt, o, d,
                                         float("inf"), act),
            "any_hit": check_any("bpt connection t=2", pt, o_s, d_s, tmax_s,
                                 act_s)}


def phase_bpt_check(parity) -> None:
    """`render_bpt` at 48x36, flat caps 4 + 4, on the card and on the CPU
    (plain versions): >= 98% of pixels within rtol 1e-3, means within 1%.
    The film's index_add_ adds atomically on the card, so its last bits
    may differ from the CPU's sequential sums."""
    kw = dict(spp=1, seed=SEED, max_light_verts=4, max_eye_verts=4)
    t0 = time.perf_counter()
    gpu = tbpt.render_bpt(parity, CHECK_W, CHECK_H, **kw).cpu().numpy()
    t1 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = tbpt.render_bpt(parity.to("cpu"), CHECK_W, CHECK_H, device="cpu",
                          **kw).numpy()
    t2 = time.perf_counter()
    close, rel, n_far = _agreement(gpu, cpu)
    log(f"[bpt check] {CHECK_W}x{CHECK_H} spp 1 caps 4 + 4: card "
        f"{t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; pixels within rtol 1e-3 "
        f"{close:.6f} ({n_far} beyond), means {gpu.mean():.6f} / "
        f"{cpu.mean():.6f} (rel {rel:.2e})")
    if close < 0.98 or rel >= 0.01:
        raise AssertionError("the card's BPT render disagrees with the CPU's")


def phase_bpt_cli(tmp) -> dict:
    """The CLI's `--renderer bpt` in-process on the parity scene, spectral,
    at its 256x192 and 32 spp; the last export, block-averaged to 64x48,
    against the reference renderer's 256-spp BPT golden with
    tests/test_parity.py's BPT thresholds."""
    out = os.path.join(tmp, "bpt_cli")
    torch.cuda.synchronize()
    tv.reset_launches()
    tpt.reset_alpha_recasts()
    res = cli_main([PARITY, "--spectral", "--renderer", "bpt", "--spp",
                    str(BPT_CLI_SPP), "--format", "bmp", "--out", out])
    torch.cuda.synchronize()
    launches = dict(tv.LAUNCHES)
    w, h = res["width"], res["height"]
    secs = sum(p[1] for p in res["passes"])
    calls = sum(p[2] for p in res["passes"])
    deep = res["deep_passes"]
    want = bpt_launches_wanted(calls - deep, deep, tpt.ALPHA_RECASTS["casts"])
    ksps = w * h * res["spp"] / secs / 1e3
    for spp, sec, c in res["passes"]:
        log(f"[bpt cli]   pass of {spp} spp: {sec:.3f} s, {c} bpt_batch "
            f"calls")
    log(f"[bpt cli] {w}x{h} spp {res['spp']} spectral: {secs:.3f} s in "
        f"{len(res['passes'])} passes, {ksps:.2f} ksamples/s, tiers "
        f"{res['tiers']}, launches {launches} (wanted {want})")
    names = sorted(os.listdir(out))
    want_files = sorted([f"{k:03d}.bmp" for k in range(len(res["passes"]))]
                        + ["checkpoint.npz"])
    if names != want_files or res["spp"] != BPT_CLI_SPP:
        raise AssertionError(f"BPT CLI exports {names}")
    if traversals(launches) != want:
        raise AssertionError(f"BPT CLI launch counts {launches} != {want}")
    ours = read_bmp(os.path.join(out, want_files[-2]))
    log(ascii_view(torch.as_tensor(ours / 255.0, device=DEV)))
    parity_gates(block_mean(ours), block_mean(read_bmp(BPT_GOLDEN)),
                 "bpt cli", quadrant_limit=10.0)
    return dict(seconds=secs, ksamples_per_s=ksps, launches=launches,
                tiers=res["tiers"])


def phase_ppm() -> dict:
    """SPPM on the Cornell box (tests/test_ppm.py:52's settings) at
    128x96 against the port's fixed-depth `render` at the test's gates
    (means within rel 0.45, pixel correlation > 0.7); one wave profiled;
    then 32x24 on the card against the CPU."""
    scene = cornell_box_spheres(sphere_res=6)
    tppm.render_ppm(scene, 32, 24, n_iterations=1, n_photon_paths=1024,
                    max_bounces=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tv.reset_launches()
    t0 = time.perf_counter()
    img = tppm.render_ppm(scene, PPM_W, PPM_H, **PPM_KW)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tv.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pt_img = tpt.render(scene, PPM_W, PPM_H, spp=32, max_depth=5,
                        seed=3).cpu().numpy()
    ppm_img = img.cpu().numpy()
    rel = abs(ppm_img.mean() / pt_img.mean() - 1.0)
    corr = float(np.corrcoef(pt_img.mean(-1).ravel(),
                             ppm_img.mean(-1).ravel())[0, 1])
    waves = PPM_KW["n_iterations"]
    paths = waves * PPM_KW["n_photon_paths"]
    log(f"[ppm] {PPM_W}x{PPM_H}, {waves} waves x "
        f"{PPM_KW['n_photon_paths']} photon paths, {PPM_KW['max_bounces']} "
        f"bounces, K {PPM_KW['k_per_cell']}: {secs:.3f} s, "
        f"{paths / secs:.0f} photon paths/s, launches {launches}, peak "
        f"memory {peak:.3f} GiB; mean {ppm_img.mean():.5f} against PT "
        f"{pt_img.mean():.5f} (rel {rel:.4f} < 0.45), pixel correlation "
        f"{corr:.4f} > 0.7")
    log(ascii_view(img))
    # Per wave: the hitpoint cast and its 4 specular bounces, then up to
    # max_bounces photon casts (a wave stops once no path is alive).
    lo = waves * (5 + 1)
    hi = waves * (5 + PPM_KW["max_bounces"])
    if not np.isfinite(ppm_img).all() or not (ppm_img >= 0).all():
        raise AssertionError("the PPM image is not finite and non-negative")
    if rel >= 0.45 or corr <= 0.7:
        raise AssertionError("SPPM disagrees with PT")
    if not (lo <= launches["closest_hit"] <= hi and launches["any_hit"] == 0
            and launches["xform_rays"] == 0):
        raise AssertionError(f"PPM launch counts {launches}")
    prof = profile_run(
        lambda: tppm.render_ppm(scene, PPM_W, PPM_H, **dict(
            PPM_KW, n_iterations=1)),
        "ppm profile", f"{PPM_W}x{PPM_H}, one wave",
        "casts (5 hitpoint, <= 5 photon)", 10)

    kw = dict(PPM_KW, n_photon_paths=2048)
    t0 = time.perf_counter()
    gpu = tppm.render_ppm(scene, 32, 24, **kw).cpu().numpy()
    t1 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = tppm.render_ppm(scene.to("cpu"), 32, 24, device="cpu",
                          **kw).numpy()
    t2 = time.perf_counter()
    close, crel, n_far = _agreement(gpu, cpu)
    log(f"[ppm check] 32x24, {kw['n_iterations']} waves x 2048 photon "
        f"paths: card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; pixels within "
        f"rtol 1e-3 {close:.6f} ({n_far} beyond), means {gpu.mean():.6f} / "
        f"{cpu.mean():.6f} (rel {crel:.2e})")
    if close < 0.98:
        raise AssertionError("the card's PPM render disagrees with the CPU's")
    return dict(seconds=secs, photon_paths_per_s=paths / secs,
                launches=launches, peak_gib=peak, rel_to_pt=rel, corr=corr,
                profile=prof)


def phase_ppm_cli(tmp, pt_mean) -> dict:
    """The CLI's `--renderer sppm` and `--renderer amcmcppm` in-process on
    the parity scene at its 256x192, RGB, with the CLI's defaults (32,768
    photon paths a wave, bounces capped at --max-depth 100) and 8 waves:
    finite, non-negative, the mean within rel 0.45 of the [cli] phase's
    path-traced image, and the chains' bookkeeping within its bounds."""
    launches = dict.fromkeys(tv.LAUNCHES, 0)
    out = {}
    for method in ("sppm", "amcmcppm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tv.reset_launches()
        res = cli_main([PARITY, "--renderer", method, "--spp",
                        str(PPM_CLI_WAVES), "--format", "bmp", "--out",
                        os.path.join(tmp, method)])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = dict(tv.LAUNCHES)
        for k in launches:
            launches[k] += got[k]
        img = res["image"]
        rel = abs(float(img.mean()) / pt_mean - 1.0)
        pps = res["photon_paths"] / res["seconds"]
        log(f"[ppm cli] {method}: {res['width']}x{res['height']}, "
            f"{res['waves']} waves, {res['photon_paths']} photon paths in "
            f"{res['seconds']:.3f} s ({pps:.0f} photon paths/s), launches "
            f"{got}, peak memory {peak:.3f} GiB; mean {img.mean():.5f} "
            f"against the PT CLI's {pt_mean:.5f} (rel {rel:.4f} < 0.45); "
            f"n_uniform {res['n_uniform']:.0f}, n_visible "
            f"{res['n_visible']:.0f}, mutation size "
            f"{res['mutation_size']:.5f}")
        if not np.isfinite(img).all() or not (img >= 0).all():
            raise AssertionError(f"{method} image is not finite and "
                                 f"non-negative")
        if rel >= 0.45:
            raise AssertionError(f"{method} mean disagrees with PT")
        if got["any_hit"] != 0 or got["closest_hit"] <= 0:
            raise AssertionError(f"{method} launch counts {got}")
        # The mutation size is float32, clipped to [1e-4, 1]: at its floor
        # it is float32(1e-4) = 9.99999975e-05.
        if method == "amcmcppm" and not (
                res["n_uniform"]
                == PPM_CLI_WAVES * cli_module.PPM_PHOTON_PATHS
                and 0 <= res["n_visible"] <= res["n_uniform"]
                and np.float32(1e-4) <= res["mutation_size"] <= 1.0):
            raise AssertionError("amcmcppm chain bookkeeping out of bounds")
        out[method] = dict(seconds=res["seconds"], photon_paths_per_s=pps,
                           peak_gib=peak, launches=got)
    return dict(launches=launches, **out)


# ---------------------------------------------------------------------------
# Rendering across ranks (torch.distributed) and the intersector oracles
# ---------------------------------------------------------------------------

# [dist 1] / [dist 2]: the sharded wavefront on the spectral Cornell box at
# 1024x768, spp 1, depth 100; the pixel-sharded fixed-depth tracer at
# 256x192, depth 16; the sharded BPT on the parity scene at 256x192, spp 1,
# flat caps 8 + 8. [scene shard]: the shading scene's casts and a 256x192
# render (spp 1, depth 16) on two ranks; [scene shard cli]: the CLI's
# --scene-shard on it at 1024x768 under torchrun. [oracles]: 16,384 rays a
# set.
DIST_W, DIST_H, DIST_SPP = 1024, 768, 1
DIST_PT_W, DIST_PT_H, DIST_PT_DEPTH = 256, 192, 16
DIST_BPT_CAPS = 8
SHARD_W, SHARD_H, SHARD_DEPTH = 256, 192, 16
ORACLE_RAYS = 16384
SELF = os.path.abspath(__file__)


def _report(out_dir, **record) -> None:
    """The JSON line a worker rank hands the parent, in a file of its own
    (the ranks' standard outputs interleave)."""
    path = os.path.join(out_dir, f"{record['phase']}.rank{record['rank']}"
                        ".jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _records(out_dir, phase) -> list:
    out = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith(phase + ".rank") and name.endswith(".jsonl"):
            with open(os.path.join(out_dir, name)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


def _torchrun(tag, n, args, timeout) -> str:
    """`torchrun --standalone --nproc_per_node n ARGS` from the repo root;
    fails the phase if any rank fails. Returns the output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}"] + args
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    for line in proc.stdout.splitlines():
        log(f"[{tag}] | {line}")
    if proc.returncode != 0:
        log(out[-6000:])
        raise AssertionError(f"{tag}: torchrun exited {proc.returncode}")
    log(f"[{tag}] {n} rank(s) in {secs:.1f} s (process start included)")
    return proc.stdout


def card_gate(tag, got, want) -> dict:
    """Card against card: >= 98% of pixels with every channel within rtol
    1e-3 (atol 1e-6), the means within 1%; the share of pixels equal bit
    for bit is printed, never promised (closest-hit ties can resolve
    another way when a ray's block-mates change)."""
    got = np.asarray(got)
    want = np.asarray(want)
    close, rel, n_far = _agreement(got, want)
    same = float((got == want).all(-1).mean())
    log(f"[{tag}] pixels within rtol 1e-3 {close:.6f} ({n_far} beyond), "
        f"equal bit for bit {same:.6f}, means {got.mean():.6f} / "
        f"{want.mean():.6f} (rel {rel:.2e})")
    if got.shape != want.shape or close < 0.98 or rel >= 0.01 \
            or not np.isfinite(got).all():
        raise AssertionError(f"{tag}: the sharded image disagrees")
    return dict(close=close, rel=rel, bit_equal=same)


def _timed(fn):
    torch.cuda.synchronize()
    tv.reset_launches()
    tpt.reset_alpha_recasts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(tv.LAUNCHES)


def _gate_launches(tag, launches, want) -> None:
    if traversals(launches) != want:
        raise AssertionError(f"{tag} launch counts {launches} != {want}")


def worker_dist1(out_dir) -> None:
    """World 1 under torchrun, NCCL: `render_wavefront_sharded` against
    `render_wavefront` in the same process."""
    from slr_tpu_torch.parallel.distributed import init_distributed, shutdown
    from slr_tpu_torch.parallel.mesh import make_mesh, render_wavefront_sharded

    assert init_distributed()
    mesh = make_mesh()
    if (mesh.size, mesh.backend) != (1, "nccl"):
        raise AssertionError(f"world {mesh.size} on {mesh.backend}")
    scene = cornell_box_spheres(spectral=True)
    render_wavefront_sharded(scene, 64, 48, 1, mesh, seed=SEED)
    render_wavefront(scene, 64, 48, 1, seed=SEED)
    kw = dict(seed=SEED, max_depth=DEPTH, return_iters=True)
    (img, it), secs, launches = _timed(lambda: render_wavefront_sharded(
        scene, DIST_W, DIST_H, DIST_SPP, mesh, **kw))
    (ref, it_ref), secs_ref, launches_ref = _timed(lambda: render_wavefront(
        scene, DIST_W, DIST_H, DIST_SPP, **kw))
    for name, l, i in (("sharded", launches, it), ("single", launches_ref,
                                                   it_ref)):
        _gate_launches(f"dist 1 {name}", l, {"closest_hit": i,
                                             "any_hit": i, "xform_rays": 0})
    img, ref = img.cpu().numpy(), ref.cpu().numpy()
    gate = card_gate("dist 1", img, ref)
    np.save(os.path.join(out_dir, "dist1.npy"), img)
    ks = DIST_W * DIST_H * DIST_SPP / 1e3
    log(f"[dist 1] {DIST_W}x{DIST_H} spp {DIST_SPP} depth {DEPTH}: sharded "
        f"{secs:.3f} s ({ks / secs:.1f} ksamples/s, {it} iterations), "
        f"render_wavefront {secs_ref:.3f} s ({ks / secs_ref:.1f} "
        f"ksamples/s, {it_ref} iterations)")
    _report(out_dir, phase="dist1", rank=0, launches=launches, iterations=it,
            seconds=secs, seconds_single=secs_ref, **gate)
    shutdown()


def worker_dist2(out_dir) -> None:
    """World 2 on one card, gloo: the dryrun, then the sharded wavefront
    against [dist 1]'s image, the pixel-sharded fixed-depth tracer against
    `render`, and the sharded BPT against `render_bpt` at the same flat
    caps; the references run on rank 0 while rank 1 waits."""
    from slr_tpu_torch.parallel.distributed import init_distributed, shutdown
    from slr_tpu_torch.parallel.mesh import (
        dryrun,
        make_mesh,
        render_bpt_sharded,
        render_sharded,
        render_wavefront_sharded,
    )
    from slr_tpu_torch.spectrum.spectral import strata_to_rgb

    assert init_distributed(backend="gloo")
    mesh = make_mesh()
    if (mesh.size, mesh.backend) != (2, "gloo"):
        raise AssertionError(f"world {mesh.size} on {mesh.backend}")
    rank0 = mesh.rank == 0
    dryrun(2)
    scene = cornell_box_spheres(spectral=True)
    rec = dict(phase="dist2", rank=mesh.rank)

    (img, it), secs, launches = _timed(lambda: render_wavefront_sharded(
        scene, DIST_W, DIST_H, DIST_SPP, mesh, seed=SEED, max_depth=DEPTH,
        return_iters=True))
    _gate_launches("dist 2 wavefront", launches,
                   {"closest_hit": it, "any_hit": it, "xform_rays": 0})
    rec["wavefront"] = dict(launches=launches, iterations=it, seconds=secs)
    if rank0:
        rec["wavefront"].update(card_gate(
            "dist 2 wavefront", img.cpu().numpy(),
            np.load(os.path.join(out_dir, "dist1.npy"))))

    film, secs, launches = _timed(lambda: render_sharded(
        scene, DIST_PT_W, DIST_PT_H, 1, mesh, seed=SEED,
        max_depth=DIST_PT_DEPTH))
    batches = -(-(DIST_PT_W * DIST_PT_H // mesh.size) // 65536)
    _gate_launches("dist 2 render_sharded", launches, {
        "closest_hit": batches * (1 + DIST_PT_DEPTH),
        "any_hit": batches * DIST_PT_DEPTH, "xform_rays": 0})
    rec["pt"] = dict(launches=launches, seconds=secs)
    if rank0:
        want = tpt.render(scene, DIST_PT_W, DIST_PT_H, 1, seed=SEED,
                          max_depth=DIST_PT_DEPTH)
        rec["pt"].update(card_gate("dist 2 render_sharded",
                                   strata_to_rgb(film).cpu().numpy(),
                                   want.cpu().numpy()))
    mesh.barrier()

    parity, _, _ = load_scene(PARITY, spectral=True)
    caps = dict(max_light_verts=DIST_BPT_CAPS, max_eye_verts=DIST_BPT_CAPS)
    film, secs, launches = _timed(lambda: render_bpt_sharded(
        parity, BPT_W, BPT_H, 1, mesh, seed=SEED, **caps))
    _gate_launches("dist 2 render_bpt_sharded", launches, {
        "closest_hit": 2 * (DIST_BPT_CAPS - 1), "any_hit": DIST_BPT_CAPS,
        "xform_rays": 0})
    rec["bpt"] = dict(launches=launches, seconds=secs)
    if rank0:
        want = tbpt.render_bpt(parity, BPT_W, BPT_H, 1, seed=SEED, **caps)
        rec["bpt"].update(card_gate("dist 2 render_bpt_sharded",
                                    strata_to_rgb(film).cpu().numpy(),
                                    want.cpu().numpy()))
    mesh.barrier()
    _report(out_dir, **rec)
    shutdown()


def _broadcast0(mesh, x):
    """Rank 0's tensor on every rank, bit for bit (int32 views summed with
    zeros)."""
    from slr_tpu_torch.parallel.scene_shard import _as_bits, _from_bits

    bits = _as_bits(x.float()) if mesh.rank == 0 else torch.zeros(
        x.shape, dtype=torch.int32, device=DEV)
    return _from_bits(mesh.all_reduce(bits))


def _reduce_local(mesh, pt, r, name, out):
    """A local cast's result over the ranks: the closest hit's (t, rank)
    reduction to (t, triangle), or the OR of the occlusion."""
    if name == "any_hit":
        return (mesh.all_reduce(out[0].reshape(-1)[:r]) > 0,)
    t, idx = out[0].reshape(-1)[:r], out[1].reshape(-1)[:r].long()
    tri = torch.where(idx >= 0, pt.remap.long()[idx.clamp(min=0)], -1)
    key = torch.where(idx >= 0, t, float("inf"))
    t_min = mesh.all_reduce(key, "min")
    winner = key <= t_min
    wr = mesh.all_reduce(torch.where(winner, mesh.rank, 1 << 30), "min")
    mine = winner & (wr == mesh.rank) & (idx >= 0)
    return t_min, mesh.all_reduce(torch.where(mine, tri + 1, 0)) - 1


def check_local_tables(sh, mesh, name, label, o, d, tmax, active) -> dict:
    """A kernel against its plain version on every rank's local tables,
    each reduced over the ranks as the sharded casts reduce (a rank's
    chunks hold chopped SBVH boxes whose triangles' other parts lie in
    another rank's chunks: on one rank's tables the kernel, which culls per
    ray, and the plain version, which tests every ray of a listed block,
    rightly differ there, and agree once reduced). Closest hit:
    tests/test_pallas.py's criteria; any hit: equal. Timed on rank 0."""
    pt = sh.pt
    r = o.shape[0]
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, RAY_EPSILON, tmax,
                                            active)
    tests = torch.zeros(rays.shape[0], dtype=torch.int32, device=DEV)
    xforms = torch.zeros_like(tests)
    kern = getattr(tv, name)
    plain = getattr(tv, name + "_plain")
    out_k = kern(rays, wl, wtn, cnt, pt, tests=tests, xforms=xforms)
    out_p = plain(rays, wl, cnt, pt)
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    local = int((out_k[0] != out_p[0]).sum())
    red_k = _reduce_local(mesh, pt, r, name, out_k)
    red_p = _reduce_local(mesh, pt, r, name, out_p)
    if name == "any_hit":
        n_bad = int((red_k[0] != red_p[0]).sum())
        err = float((red_k[0].float() - red_p[0].float()).abs().max())
        text = f"occluded {int(red_p[0].sum())}, mismatches {n_bad} of {r}"
    else:
        (t_k, tri_k), (t_p, tri_p) = red_k, red_p
        h_k, h_p = tri_k >= 0, tri_p >= 0
        n_bad = int((h_k != h_p).sum())
        same = (tri_k == tri_p) | ((t_k - t_p).abs()
                                   <= 1e-4 * torch.clamp(t_p, min=1.0))
        share = float(same[h_p].float().mean())
        n_bad += int(share <= 0.995)
        err = float((t_k - t_p)[h_p & h_k].abs().max())
        text = (f"hits {int(h_p.sum())}, mask mismatches "
                f"{int((h_k != h_p).sum())}, same-or-close {share:.6f}, "
                f"max |dt| {err:.3g}")
    out = dict(max_abs_err=err)
    if mesh.rank == 0:
        ms = median_ms(lambda: kern(rays, wl, wtn, cnt, pt))
        plain_ms = median_ms(lambda: plain(rays, wl, cnt, pt), PLAIN_RUNS)
        bms, by = bound_ms(name, (rays, wl, wtn, cnt), pt, out_k, tests,
                           xforms)
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        log(f"[scene shard kernels] {name} {label} on rank 0's tables "
            f"({pt.n_chunks} chunks): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), tests {int(tests.sum())}; rays "
            f"whose result differs on this rank's tables alone {local}; "
            f"reduced over "
            f"the ranks: {text}")
    if n_bad:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"the local tables ({label})")
    return out


def worker_scene_shard(path, out_dir) -> None:
    """World 2, gloo, on the shading scene: the sharded casts against the
    unsharded ones, each kernel against its plain version on rank 0's
    local tables, each rank's table bytes, and `render_pt_scene_sharded`
    against `render` (rank 0 holds the whole scene for the references)."""
    from slr_tpu_torch.parallel import mesh as pmesh
    from slr_tpu_torch.parallel import scene_shard as ss
    from slr_tpu_torch.parallel.distributed import init_distributed, shutdown

    assert init_distributed(backend="gloo")
    mesh = pmesh.make_mesh()
    rank0 = mesh.rank == 0
    host, _, _ = load_scene(path, spectral=True, device="cpu")
    if host.instances is not None:
        raise AssertionError("the shading scene has instances: the "
                             "scene-sharded path would render it replicated")
    torch.cuda.reset_peak_memory_stats()
    sh = ss.shard_scene(host, mesh)
    torch.cuda.synchronize()
    rec = dict(phase="scene_shard", rank=mesh.rank, bytes=sh.bytes,
               whole=sh.whole_bytes, chunk=sh.chunk_bytes,
               image=sh.image_bytes,
               shard_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    limits = dict(pallas_tris=sh.chunk_bytes, tri_rows=4 * 40,
                  atlas=sh.image_bytes)
    for k, extra in limits.items():
        if not sh.bytes[k] <= sh.whole_bytes[k] / mesh.size + extra:
            raise AssertionError(f"rank {mesh.rank} holds {sh.bytes[k]} B of "
                                 f"{k}, more than 1/{mesh.size} of "
                                 f"{sh.whole_bytes[k]} + {extra}")
    log(f"[scene shard] rank {mesh.rank}: table bytes {sh.bytes} of "
        f"{sh.whole_bytes} (chunk {sh.chunk_bytes} B, image "
        f"{sh.image_bytes} B)")

    full = host.to(DEV) if rank0 else None
    sets = shading_ray_sets(full) if rank0 else None
    names = ("camera", "shadow")
    rays = {}
    for name in names:
        o, d, tmax, act = (sets[name][:4] if rank0
                           else (torch.zeros((LANES, 3), device=DEV),) * 2
                           + (torch.zeros(LANES, device=DEV),
                              torch.zeros(LANES, device=DEV)))
        if not isinstance(tmax, torch.Tensor):
            tmax = torch.full((LANES,), float(tmax), device=DEV)
        act = (torch.ones(LANES, device=DEV) if act is None
               else act.float())
        o, d, tmax, act = (_broadcast0(mesh, x) for x in (o, d, tmax, act))
        rays[name] = (o, d, tmax, act > 0)

    o, d, tmax, act = rays["camera"]
    pmesh.reset_collectives()
    hit, _, l_c = _timed(lambda: ss.intersect_scene_sharded(sh, mesh, o, d))
    per_cast = pmesh.COLLECTIVES["calls"]
    o_s, d_s, tmax_s, act_s = rays["shadow"]
    occ, _, l_a = _timed(lambda: ss.occluded_scene_sharded(
        sh, mesh, o_s, d_s, RAY_EPSILON, tmax_s, act_s))
    casts = {k: l_c[k] + l_a[k] for k in l_c}
    if rank0:
        want = scene_intersect(full, o, d)
        h = {k: getattr(hit, k) for k in ("t", "tri", "mask")}
        w = {k: getattr(want, k) for k in ("t", "tri", "mask")}
        n_mask = int((h["mask"] != w["mask"]).sum())
        m = w["mask"]
        same = ((h["tri"] == w["tri"]) | ((h["t"] - w["t"]).abs()
                <= 1e-4 * torch.clamp(w["t"], min=1.0)))[m]
        share = float(same.float().mean())
        occ_want = tv.anyhit_pallas(full.geometry, full.pallas_tris, o_s, d_s,
                                    RAY_EPSILON, tmax_s, active=act_s)
        n_occ = int((occ != occ_want).sum())
        log(f"[scene shard] closest hit on {LANES} camera rays: "
            f"{per_cast} collectives a cast, mask mismatches {n_mask}, "
            f"same-or-close {share:.6f}, hits {int(m.sum())}; any hit on "
            f"{int(act_s.sum())} shadow rays: mismatches {n_occ}, occluded "
            f"{int(occ_want.sum())}")
        if n_mask or share <= 0.995 or n_occ:
            raise AssertionError("the sharded casts disagree with the "
                                 "unsharded ones")
    rec["kernels"] = {
        "closest_hit": check_local_tables(sh, mesh, "closest_hit",
                                          "camera", o, d, float("inf"),
                                          None),
        "any_hit": check_local_tables(sh, mesh, "any_hit", "shadow", o_s,
                                      d_s, tmax_s, act_s)}
    mesh.barrier()

    # The render: its collectives timed (a device sync around each).
    pmesh.reset_collectives()
    pmesh.track_collectives(True)
    kw = dict(seed=SEED, max_depth=SHARD_DEPTH)
    img, secs, launches = _timed(lambda: ss.render_pt_scene_sharded(
        sh, mesh, SHARD_W, SHARD_H, 1, **kw))
    pmesh.track_collectives(False)
    coll = dict(pmesh.COLLECTIVES)
    recasts = tpt.ALPHA_RECASTS["casts"]
    batches = -(-SHARD_W * SHARD_H // 65536)
    steps = batches * (1 + SHARD_DEPTH)
    _gate_launches("scene shard render", launches, {
        "closest_hit": batches * (1 + 2 * SHARD_DEPTH) + recasts,
        "any_hit": 0, "xform_rays": 0})
    rec["render"] = dict(launches=launches, seconds=secs, recasts=recasts,
                         collectives=coll["calls"],
                         collective_seconds=coll["seconds"],
                         collective_bytes=coll["bytes"])
    rec["casts"] = casts
    log(f"[scene shard] rank {mesh.rank}: {SHARD_W}x{SHARD_H} spp 1 depth "
        f"{SHARD_DEPTH}: {secs:.3f} s, launches {launches}, alpha recasts "
        f"{recasts}; {coll['calls']} collectives ({coll['calls'] / steps:.1f}"
        f" a bounce), {coll['seconds']:.3f} s in them "
        f"({coll['seconds'] / max(coll['calls'], 1) * 1e3:.3f} ms each), "
        f"{coll['bytes'] / 2 ** 20:.1f} MiB")
    if rank0:
        want, secs_ref, _ = _timed(lambda: tpt.render(full, SHARD_W, SHARD_H,
                                                      1, **kw))
        log(f"[scene shard] unsharded `render` of the same frame: "
            f"{secs_ref:.3f} s")
        rec["render"].update(card_gate("scene shard render",
                                       img.cpu().numpy(), want.cpu().numpy()),
                             seconds_unsharded=secs_ref)
        with open(os.path.join(out_dir, "scene_shard.json"), "w") as f:
            json.dump(dict(mean=float(want.mean())), f)
    mesh.barrier()
    _report(out_dir, **rec)
    shutdown()


def phase_dist(tmp) -> dict:
    """[dist 1] and [dist 2]: worker processes under torchrun."""
    _torchrun("dist 1", 1, [SELF, "--worker", "dist1", tmp], 300)
    d1, = _records(tmp, "dist1")
    _torchrun("dist 2", 2, [SELF, "--worker", "dist2", tmp], 600)
    recs = _records(tmp, "dist2")
    if sorted(r["rank"] for r in recs) != [0, 1]:
        raise AssertionError(f"dist 2 reports {recs}")
    ks = DIST_W * DIST_H * DIST_SPP / 1e3
    for r in recs:
        w = r["wavefront"]
        log(f"[dist 2] rank {r['rank']}: wavefront {w['seconds']:.3f} s "
            f"({ks / w['seconds']:.1f} ksamples/s over the two ranks' "
            f"shared card), {w['iterations']} iterations; render_sharded "
            f"{r['pt']['seconds']:.3f} s; render_bpt_sharded "
            f"{r['bpt']['seconds']:.3f} s")
    launches = {k: d1["launches"][k] + sum(
        r[p]["launches"][k] for r in recs for p in ("wavefront", "pt",
                                                      "bpt"))
        for k in d1["launches"]}
    log(f"[dist] launches on the sharded paths {launches}")
    return dict(launches=launches, dist1=d1, dist2=recs)


def phase_scene_shard(tmp, path) -> dict:
    _torchrun("scene shard", 2, [SELF, "--worker", "scene_shard", path, tmp],
              900)
    recs = _records(tmp, "scene_shard")
    if sorted(r["rank"] for r in recs) != [0, 1]:
        raise AssertionError(f"scene shard reports {recs}")
    launches = {k: sum(r["render"]["launches"][k] + r["casts"][k]
                       for r in recs) for k in recs[0]["casts"]}
    r0 = next(r for r in recs if r["rank"] == 0)
    log(f"[scene shard] launches {launches}")
    return dict(launches=launches, ranks=recs, kernels=r0["kernels"],
                render=r0["render"])


def phase_scene_shard_cli(tmp, path) -> dict:
    """`torchrun --nproc_per_node 1 -m slr_tpu_torch <shading scene>
    --scene-shard` at 1024x768, spectral, 1 spp, NCCL: the fixed-depth
    tracer at depth 16 over the sharded tables, shadow rays through closest
    hit (an alpha scene). Gates: the launches, a finite image (negative
    linear sRGB only on noisy spectral pixels), the mean within 5% of
    [scene shard]'s 256x192 `render`."""
    out = os.path.join(tmp, "scene_shard_cli")
    stdout = _torchrun("scene shard cli", 1, [
        "-m", "slr_tpu_torch", path, "--scene-shard", "--spectral", "--spp",
        "1", "--width", str(SHADE_W), "--height", str(SHADE_H), "--max-depth",
        str(SHARD_DEPTH), "--format",
        "bmp", "--out", out, "-v"], 900)
    m = re.search(r"kernel launches (\{[^}]*\}), alpha recasts (\d+), "
                  r"collectives (\d+) \((\d+) B\), peak ([0-9.]+|nan) GiB",
                  stdout)
    s = re.search(r"1 spp in ([0-9.]+) s of passes:.*?(\d+) render batches "
                  r"of depth", stdout, re.S)
    if not m or not s:
        raise AssertionError("scene shard cli: no verbose report")
    launches = json.loads(m.group(1).replace("'", '"'))
    recasts, coll, coll_b = (int(m.group(k)) for k in (2, 3, 4))
    peak, secs, batches = float(m.group(5)), float(s.group(1)), int(
        s.group(2))
    steps = batches * (1 + SHARD_DEPTH)
    _gate_launches("scene shard cli", launches, {
        "closest_hit": steps + batches * SHARD_DEPTH + recasts,
        "any_hit": 0, "xform_rays": 0})
    with np.load(os.path.join(out, "checkpoint.npz")) as ck:
        film = (ck["accum"] + ck["comp"]) / int(ck["done"])
    with open(os.path.join(tmp, "scene_shard.json")) as f:
        small = json.load(f)["mean"]
    gap = abs(float(film.mean()) / small - 1.0)
    neg = float((film < 0).mean())
    img = read_bmp(os.path.join(out, "000.bmp"))
    log(f"[scene shard cli] {SHADE_W}x{SHADE_H} spp 1 depth {SHARD_DEPTH}: "
        f"{secs:.3f} s ({SHADE_W * SHADE_H / secs / 1e3:.1f} ksamples/s), "
        f"{batches} batches, launches {launches}, alpha recasts {recasts}, "
        f"{coll} collectives ({coll / steps:.1f} a bounce step, "
        f"{coll_b / 2 ** 20:.1f} MiB), peak {peak:.3f} GiB; image mean "
        f"{film.mean():.6f} against the 256x192 render's {small:.6f} (gap "
        f"{gap:.4f}), negative values {neg:.5f}")
    if not np.isfinite(film).all() or gap >= 0.05 or neg >= 0.05 \
            or img.shape != (SHADE_H, SHADE_W, 3) or not img.mean() > 5.0:
        raise AssertionError("scene shard cli: implausible image")
    return dict(launches=launches, seconds=secs, peak_gib=peak,
                collectives=coll, recasts=recasts, mean_gap=gap)


def _hit_criteria(tag, got, want) -> float:
    m = want.mask
    n_mask = int((got.mask != m).sum())
    same = (got.tri == want.tri) | ((got.t - want.t).abs()
                                    <= 1e-4 * torch.clamp(want.t, min=1.0))
    if got.inst is not None and want.inst is not None:
        same = same & ((got.inst == want.inst) | ((got.t - want.t).abs()
                       <= 1e-4 * torch.clamp(want.t, min=1.0)))
    share = float(same[m].float().mean())
    log(f"[oracles] {tag}: hits {int(m.sum())}, mask mismatches {n_mask}, "
        f"same-or-close {share:.6f}")
    if n_mask or share <= 0.995:
        raise AssertionError(f"{tag}: the kernel disagrees with the oracle")
    return share


def phase_oracles() -> dict:
    """The kernels' casts against the port's oracles on the card:
    `intersect_plucker` and `intersect_bvh` on the Cornell box's camera
    rays, `any_hit_brute` on its shadow rays, and the two-level
    `intersect_instances` (with the static prefix's BVH traversal) on the
    grass field's camera rays at random shutter fractions;
    tests/test_pallas.py's criteria, any hit equal."""
    from slr_tpu_torch.accel.intersect import any_hit_brute
    from slr_tpu_torch.accel.lbvh import intersect_bvh
    from slr_tpu_torch.accel.plucker import build_plucker, intersect_plucker
    from slr_tpu_torch.accel.twolevel import intersect_scene_oracle

    rs = np.random.RandomState(5)
    scene = cornell_box_spheres(spectral=True)
    n = ORACLE_RAYS
    o, d = camera_rays(scene, n, rs)
    o_s, d_s, tmax_s = shadow_rays(n, rs)
    grass = grass_field(**GRASS, two_level=True)
    pid = torch.as_tensor(rs.choice(GRASS_W * GRASS_H, n, replace=False),
                          device=DEV)
    g_rays = _camera_ray(grass, pid, torch.zeros_like(pid), SEED, GRASS_W,
                         GRASS_H)
    f = _cuda_tensor(rs.rand(n))
    torch.cuda.synchronize()
    tv.reset_launches()
    k_c = scene_intersect(scene, o, d)
    k_a = tv.anyhit_pallas(scene.geometry, scene.pallas_tris, o_s, d_s,
                           RAY_EPSILON, tmax_s)
    k_g = scene_intersect(grass, g_rays.o, g_rays.d, f=f)
    torch.cuda.synchronize()
    launches = dict(tv.LAUNCHES)
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    plk = timed("plucker", lambda: intersect_plucker(
        scene.geometry, build_plucker(scene.geometry), o, d))
    bvh = timed("bvh", lambda: intersect_bvh(scene.geometry, scene.bvh, o,
                                             d))
    brute = timed("any_hit_brute", lambda: any_hit_brute(
        scene.geometry, o_s, d_s, RAY_EPSILON, tmax_s))
    two = timed("two_level", lambda: intersect_scene_oracle(
        grass, g_rays.o, g_rays.d, f=f))
    out = dict(launches=launches, seconds=times)
    out["plucker"] = _hit_criteria("Cornell camera: closest_hit_kernel vs "
                                   "intersect_plucker", k_c, plk)
    out["bvh"] = _hit_criteria("Cornell camera: closest_hit_kernel vs "
                               "intersect_bvh", k_c, bvh)
    n_occ = int((k_a != brute).sum())
    log(f"[oracles] Cornell shadow: any_hit_kernel vs any_hit_brute: "
        f"mismatches {n_occ} of {n}, occluded {int(brute.sum())}")
    if n_occ:
        raise AssertionError("any_hit_kernel disagrees with any_hit_brute")
    out["two_level"] = _hit_criteria(
        "grass camera: closest_hit_kernel vs intersect_instances + "
        "intersect_bvh", k_g, two)
    if not int((k_g.inst >= 0).sum()) > 0:
        raise AssertionError("no grass ray hit an instance")
    log(f"[oracles] {n} rays a set; oracle seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; kernel casts launched {launches}")
    return out


def worker(argv) -> None:
    """`python3 chip_smoke.py --worker NAME ARGS`: one rank of a phase run
    under torchrun."""
    torch.backends.cuda.matmul.allow_tf32 = False
    name, args = argv[0], argv[1:]
    {"dist1": worker_dist1, "dist2": worker_dist2,
     "scene_shard": worker_scene_shard}[name](*args)


_LAP = [time.perf_counter()]


def lap(label: str) -> None:
    """Logs the seconds since the last lap."""
    now = time.perf_counter()
    log(f"[time] {label}: {now - _LAP[0]:.1f} s")
    _LAP[0] = now


def main() -> None:
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    lap("device and build")
    scene, morton = phase_scene(
        "spectral Cornell box",
        lambda bvh: cornell_box_spheres(spectral=True, use_bvh=bvh),
        lambda sc: cornell_ray_sets(sc)["closest in-box"][1:] + (None,))
    timings = phase_kernels(scene, morton)
    del morton
    lap("Cornell tables and kernels")
    main_path = phase_main_path(scene)
    phase_profile(scene, depth=PROFILE_DEPTH)
    phase_cross_check(scene, main_path["mean"])
    lap("Cornell main path, profile, check")

    grass, morton = phase_scene(
        "grass field", lambda bvh: grass_field(**GRASS, use_bvh=bvh),
        lambda sc: grass_ray_sets(sc, np.random.RandomState(1))[
            "closest bounce"][1:])
    del morton
    g_timings = phase_grass_kernels(grass)
    lap("grass tables and kernels")
    g_main = phase_grass_main_path(grass)
    wl_share = (2 * g_timings["prepare_cast_ms"] * g_main["iterations"] / 1e3
                / g_main["seconds"])
    log(f"[grass main] worklist builds: 2 x "
        f"{g_timings['prepare_cast_ms']:.3f} ms = {wl_share:.3f} of the "
        f"render's wall time")
    phase_profile(grass, "grass profile")
    phase_cross_check(grass_field(**GRASS_CHECK), None, "grass check")
    del grass
    lap("grass main path, profile, check")

    with tempfile.TemporaryDirectory() as tmp:
        cli = phase_cli(tmp)
        parity, _, _ = load_scene(PARITY, spectral=True)
        phase_cross_check(parity, None, "cli check")
        phase_cli_module(tmp)
        del parity
        lap("cli")

        shade_path, shade = phase_shading_scene(tmp)
        s_kernels = phase_shading_kernels(shade)
        lap("shading scene and kernels")
        shading = phase_shading(shade_path, tmp)
        lap("shading")
        phase_profile(shade, "shading profile", depth=SHADE_PROFILE_DEPTH)
        lap("shading profile")
        phase_cross_check(shade, None, "shading check", spp=1)
        del shade
        lap("shading check")
    env = phase_env()
    lap("env")

    pt_scene = cornell_box_spheres(spectral=True)
    pt_path = phase_pt(pt_scene)
    phase_pt_profile(pt_scene)
    phase_pt_check(pt_scene)
    lap("pt and its checks")
    pt_kernels = phase_pt_kernels(pt_scene)
    del pt_scene
    pt_golden = phase_pt_golden()
    lap("pt kernels and golden")
    grad = phase_grad()
    lap("grad")
    with tempfile.TemporaryDirectory() as tmp:
        debug = phase_debug(tmp)
    motion = phase_motion_box()
    lap("debug and motion box")

    parity, _, _ = load_scene(PARITY, spectral=True)
    bpt = phase_bpt(parity)
    phase_bpt_check(parity)
    del parity
    lap("bpt and its check")
    bpt_scene, bpt_cornell = phase_bpt_cornell()
    bpt_kernels = phase_bpt_kernels(bpt_scene)
    del bpt_scene
    lap("bpt cornell and kernels")
    with tempfile.TemporaryDirectory() as tmp:
        bpt_cli = phase_bpt_cli(tmp)
        lap("bpt cli")
        ppm = phase_ppm()
        lap("ppm")
        ppm_cli = phase_ppm_cli(tmp, cli["film_mean"])
        lap("ppm cli")
    with tempfile.TemporaryDirectory() as tmp:
        dist = phase_dist(tmp)
        lap("dist 1 and dist 2")
        shade_path = write_shading_scene(os.path.join(tmp, "shading"))
        scene_shard = phase_scene_shard(tmp, shade_path)
        lap("scene shard")
        scene_shard_cli = phase_scene_shard_cli(tmp, shade_path)
        lap("scene shard cli")
    oracles = phase_oracles()
    lap("oracles")

    paths = {"cornell": main_path, "grass": g_main, "cli": cli,
             "shading": shading, "env": env, "pt": pt_path,
             "pt_golden": pt_golden, "grad": grad, "debug": debug,
             "bpt": bpt, "bpt_cornell": bpt_cornell, "bpt_cli": bpt_cli,
             "ppm": ppm, "ppm_cli": ppm_cli, "dist": dist,
             "scene_shard": scene_shard, "scene_shard_cli": scene_shard_cli,
             "oracles": oracles}
    kernels = []
    for name in ("closest_hit", "any_hit"):
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=REPLACES[name],
            launches=sum(p["launches"][name] for p in paths.values()),
            launches_by_path={k: p["launches"][name]
                              for k, p in paths.items()},
            library_ms=None, **timings["SBVH"][name],
            morton=dict(timings["Morton"][name]),
            grass=dict(launches=g_main["launches"][name],
                       tests=g_main["work"][name + "_tests"],
                       transforms=g_main["work"][name + "_transforms"],
                       **g_timings[name]),
            cli=dict(launches=cli["launches"][name],
                     tests=cli["work"][name + "_tests"]),
            shading=dict(launches=shading["launches"][name],
                         tests=shading["work"][name + "_tests"])))
    kernels[0]["shading"].update(
        alpha_recasts=shading["recasts"],
        recast_cast_ms=s_kernels["recast_cast_ms"],
        **{f"{k} set": s_kernels[k] for k in ("camera", "recast", "shadow")})
    for k in kernels:
        k["pt"] = dict(launches=pt_path["launches"][k["name"]],
                       **pt_kernels[k["name"]])
        k["motion_box"] = motion[k["name"]]
        k["bpt"] = dict(launches=bpt["launches"][k["name"]],
                        **bpt_kernels[k["name"]])
        k["scene_shard"] = dict(launches=scene_shard["launches"][k["name"]],
                                **scene_shard["kernels"][k["name"]])
    # The instance transform: on the main paths it runs as a device function
    # of the two kernels above, whose counted transforms show it; launched
    # on its own (never by a cast) it is held against its plain version.
    kernels.append(dict(
        name="xform_rays", route="cuda", source=SOURCE,
        replaces=REPLACES["xform_rays"],
        launches=sum(p["launches"]["xform_rays"] for p in paths.values()),
        runs_inside=["closest_hit", "any_hit"],
        transforms_in_grass_render=(
            g_main["work"]["closest_hit_transforms"]
            + g_main["work"]["any_hit_transforms"]),
        library_ms=None, **g_timings["xform_rays"]))
    # The worklist build: one launch a cast on every path.
    by_path = {k: p["launches"].get("worklist") for k, p in paths.items()}
    kernels.append(dict(
        name="worklist", route="cuda", source=SOURCE,
        replaces=REPLACES["worklist"],
        launches=sum(v for v in by_path.values() if v is not None),
        launches_by_path=by_path, library_ms=None, **timings["SBVH"][
            "worklist"], morton=dict(timings["Morton"]["worklist"]),
        grass=dict(launches=g_main["launches"]["worklist"],
                   **g_timings["worklist"])))
    if not all(k["launches_by_path"][p] > 0 for k in kernels[:2]
               for p in ("cornell", "grass", "cli", "env", "pt", "pt_golden",
                         "grad", "dist", "scene_shard")) \
            or not all(kernels[0]["launches_by_path"][p] > 0
                       for p in ("shading", "debug", "bpt", "bpt_cornell",
                                 "bpt_cli", "ppm", "ppm_cli",
                                 "scene_shard_cli", "oracles")) \
            or not all(kernels[1]["launches_by_path"][p] > 0
                       for p in ("bpt", "bpt_cornell", "bpt_cli")):
        raise AssertionError("a kernel of the main paths was never launched")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2:])
    else:
        main()
