"""AOV / debug renderer (counterpart of slr_tpu/render/debug.py): one camera
ray through each pixel centre, and the first hit's geometric normal,
shading normal, shading tangent, distance, material and uv. Used to check
geometry and shading frames apart from light transport.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.perspective import sample_camera_rays
from ..core.device import resolve_device
from ..scene.types import FlatScene
from .pt import resolve_sp, scene_intersect

Tensor = torch.Tensor


class AOVs(NamedTuple):
    g_normal: Tensor    # (H, W, 3)
    s_normal: Tensor    # (H, W, 3)
    s_tangent: Tensor   # (H, W, 3)
    distance: Tensor    # (H, W)
    hit: Tensor         # (H, W) bool
    mat_id: Tensor      # (H, W) int64, -1 on a miss
    uv: Tensor          # (H, W, 2)


def render_aovs(scene: FlatScene, width: int, height: int,
                time_f: float = 0.5, device=None) -> AOVs:
    """The first-hit channels of a (width, height) image on `device`
    (default: the CUDA device), zero (mat_id -1) where the ray misses.
    Scenes with instances are cast at the one shutter fraction `time_f`
    (mid-shutter by default), so that the pass is deterministic."""
    scene = scene.to(resolve_device(device))
    dev = scene.device
    n_pix = width * height
    pixel_id = torch.arange(n_pix, device=dev)
    px = (pixel_id % width).to(torch.float32) + 0.5
    py = (pixel_id // width).to(torch.float32) + 0.5
    half = torch.full((n_pix,), 0.5, device=dev)
    rays = sample_camera_rays(scene.camera, px, py, width, height, half, half)
    f = (torch.full((n_pix,), time_f, device=dev)
         if scene.instances is not None else None)
    hit = scene_intersect(scene, rays.o, rays.d, f=f)
    # resolve_sp takes a hit on an instance's shading frame to world space
    # at the same shutter fraction.
    sp = resolve_sp(scene, hit, rays.o, rays.d, f=f)
    mask = hit.mask

    def img(x: Tensor) -> Tensor:
        return torch.where(mask[:, None], x, 0.0).reshape(height, width, -1)

    return AOVs(
        g_normal=img(sp.gn), s_normal=img(sp.sn), s_tangent=img(sp.tangent),
        distance=torch.where(mask, hit.t, 0.0).reshape(height, width),
        hit=mask.reshape(height, width),
        mat_id=torch.where(mask, sp.mat_id, -1).reshape(height, width),
        uv=img(sp.uv))
