"""Thin-lens perspective and equirectangular camera ray generation
(counterpart of slr_tpu/camera/perspective.py). Camera space is
right-handed, looking down +z.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.math3d import normalize, transform_point, transform_vector
from ..core.sampling import concentric_sample_disk
from ..scene.types import Camera

Tensor = torch.Tensor


class CameraRays(NamedTuple):
    o: Tensor       # (R, 3) world-space origins
    d: Tensor       # (R, 3) world-space directions
    weight: Tensor  # (R,) We0*We1*cos / (areaPDF * dirPDF)


def camera_derived(cam: Camera):
    op_height = 2.0 * cam.obj_dist * torch.tan(cam.fovy * 0.5)
    op_width = op_height * cam.aspect
    img_area = op_width * op_height * (cam.img_dist / cam.obj_dist) ** 2
    return op_width, op_height, img_area


def sample_camera_rays_equirect(cam: Camera, px: Tensor, py: Tensor,
                                width: int, height: int) -> CameraRays:
    """Latitude-longitude rays from the camera's origin: phi = phi_angle u,
    theta = theta_angle v, direction (-sin phi sin theta, cos theta,
    cos phi sin theta). Its direction pdf is the mapping's true density
    1 / (phi_angle theta_angle sin theta), as the reference package uses
    (the original renderer's sin^2 differs)."""
    phi = cam.phi_angle * (px / width)
    theta = cam.theta_angle * (py / height)
    st = torch.sin(theta)
    dir_local = torch.stack([-torch.sin(phi) * st, torch.cos(theta),
                             torch.cos(phi) * st], dim=-1)
    dir_pdf = 1.0 / (cam.phi_angle * cam.theta_angle
                     * torch.clamp(st.abs(), min=1e-6))
    o = torch.broadcast_to(cam.to_world[:3, 3], dir_local.shape)
    d = transform_vector(cam.to_world, dir_local)
    return CameraRays(o=o, d=d, weight=dir_local[..., 2].abs() / dir_pdf)


def sample_camera_rays(cam: Camera, px: Tensor, py: Tensor, width: int,
                       height: int, u_lens0: Tensor,
                       u_lens1: Tensor) -> CameraRays:
    """Primary rays through continuous pixel positions px/py (R,)."""
    op_width, op_height, img_area = camera_derived(cam)
    lx, ly = concentric_sample_disk(u_lens0, u_lens1)
    org_local = torch.stack(
        [cam.lens_radius * lx, cam.lens_radius * ly, torch.zeros_like(lx)],
        dim=-1)
    sx = px / width
    sy = py / height
    p_focus = torch.stack(
        [op_width * (0.5 - sx), op_height * (0.5 - sy),
         torch.broadcast_to(cam.obj_dist, sx.shape)], dim=-1)
    dir_local = normalize(p_focus - org_local)
    dir_pdf = (cam.img_dist * cam.img_dist) / (dir_local[..., 2] ** 3 * img_area)

    o = transform_point(cam.to_world, org_local)
    d = transform_vector(cam.to_world, dir_local)

    lens = 1.0 / (math.pi * torch.clamp(cam.lens_radius, min=1e-12) ** 2)
    lens_area_pdf = torch.where(cam.lens_radius > 0.0, lens, 1.0)
    sensitivity = torch.where(cam.lens_radius > 0.0, lens, 1.0)
    weight = sensitivity * dir_local[..., 2].abs() / (lens_area_pdf * dir_pdf)
    return CameraRays(o=o, d=d, weight=weight)
