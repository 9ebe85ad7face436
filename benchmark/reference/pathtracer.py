"""The reference path tracer: one path per (pixel, sample) item, written
for the benchmark from SLR's semantics, in float64, with brute-force casts
against every triangle.

The estimator is SLR's spectral path tracer: 16 wavelengths a path, one
of them the hero, which a refraction through dispersive glass keeps alone;
at every non-specular hit one light sample (a uniformly chosen emitting
triangle, a uniform point on it) weighted by the power heuristic against
the BSDF's sample, which in turn is weighted against light sampling where
it hits an emitter; Russian roulette on the path's importance after every
bounce; camera rays through a thin lens. Every random number is a pure
function of (seed, pixel, sample, bounce, decision), so that an item's
value does not depend on what else is traced with it; the program keys its
streams the same way, which is what lets the two be compared item by item.

`lowp` rounds the paths' state to bfloat16 after every bounce: the
lower-precision control of the comparison.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import spectra
from .scene import GLASS, MATTE, METAL, Scene

Tensor = torch.Tensor
F64 = torch.float64
RAY_EPSILON = 1e-4        # a cast's least distance, against self-hits
SHADOW_SHORTEN = 1e-3     # a shadow ray stops this share short of its light

# The decisions a path draws a random number for.
(TIME, PIXEL_X, PIXEL_Y, WAVELENGTH, WL_SELECT, LENS_U, LENS_V, IDF_U,
 IDF_V, BSDF_COMPONENT, BSDF_U, BSDF_V, RR, LIGHT_SELECT, LIGHT_POS_U,
 LIGHT_POS_V) = range(16)


# ---------------------------------------------------------------------------
# Random numbers
# ---------------------------------------------------------------------------

def _fmix32(h: np.ndarray) -> np.ndarray:
    """MurmurHash3's 32-bit finaliser, with the constants of the
    low-bias 'lowbias32' variant."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x846CA68B)
    return h ^ (h >> np.uint32(16))


class Streams:
    """Uniform numbers in [0, 1) with 24 bits, keyed by (seed, pixel,
    sample, bounce, decision) through three rounds of the hash."""

    def __init__(self, seed: int, pixel: Tensor, sample: Tensor):
        with np.errstate(over="ignore"):
            u32 = np.uint32
            pix = pixel.cpu().numpy().astype(np.uint64).astype(u32)
            smp = sample.cpu().numpy().astype(np.uint64).astype(u32)
            h = _fmix32(pix * u32(0x9E3779B9) + u32(seed & 0xFFFFFFFF))
            self.h = _fmix32(h + smp * u32(0x85EBCA6B))
        self.device = pixel.device

    def __call__(self, bounce: int, decision: int,
                 rows: Tensor | None = None) -> Tensor:
        h = self.h if rows is None else self.h[rows.cpu().numpy()]
        with np.errstate(over="ignore"):
            u32 = np.uint32
            h = _fmix32(h + u32(bounce) * u32(0xC2B2AE35)
                        + u32(decision) * u32(0x27D4EB2F))
        u = (h >> np.uint32(8)).astype(np.float64) / 16777216.0
        return torch.as_tensor(u, dtype=F64, device=self.device)


# ---------------------------------------------------------------------------
# Vectors, casts and surfaces
# ---------------------------------------------------------------------------

def dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def unit(a: Tensor) -> Tensor:
    return a / torch.linalg.norm(a, dim=-1, keepdim=True)


def _moller_trumbore(o, d, p):
    """Ray (R, 1, 3) against triangles (1, B, 3, 3): (t, b1, b2), with t
    infinite where the ray misses; both faces count."""
    e1 = p[..., 1, :] - p[..., 0, :]
    e2 = p[..., 2, :] - p[..., 0, :]
    pv = torch.linalg.cross(d.expand(-1, e2.shape[1], -1),
                            e2.expand(d.shape[0], -1, -1))
    det = dot(e1, pv)
    inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    tv = o - p[..., 0, :]
    b1 = dot(tv, pv) * inv
    qv = torch.linalg.cross(tv, e1.expand(tv.shape[0], -1, -1))
    b2 = dot(d, qv) * inv
    t = dot(e2, qv) * inv
    ok = (det != 0) & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1)
    return torch.where(ok, t, torch.full_like(t, math.inf)), b1, b2


def closest_hit(tris: Tensor, o: Tensor, d: Tensor, tmin=RAY_EPSILON,
                tmax=math.inf, block: int = 128):
    """Each ray's nearest triangle of `tris` (T, 3, 3) with t in [tmin,
    tmax], over all of them: (t, triangle or -1, b1, b2)."""
    r = o.shape[0]
    tmin = torch.as_tensor(tmin, dtype=F64, device=o.device).expand(r)
    best = torch.as_tensor(tmax, dtype=F64, device=o.device).expand(r)
    best = torch.where(best.isinf(), best, torch.nextafter(
        best, torch.full_like(best, math.inf)))
    tri = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    bb1 = torch.zeros((r,), dtype=F64, device=o.device)
    bb2 = torch.zeros_like(bb1)
    o, d = o.to(F64), d.to(F64)
    for s in range(0, tris.shape[0], block):
        t, b1, b2 = _moller_trumbore(o[:, None], d[:, None],
                                     tris[s:s + block][None])
        t = torch.where(t >= tmin[:, None], t, math.inf)
        tnear, j = t.min(1)
        closer = tnear < best
        best = torch.where(closer, tnear, best)
        tri = torch.where(closer, s + j, tri)
        bb1 = torch.where(closer, b1.gather(1, j[:, None])[:, 0], bb1)
        bb2 = torch.where(closer, b2.gather(1, j[:, None])[:, 0], bb2)
    return torch.where(tri >= 0, best, math.inf), tri, bb1, bb2


def occluded(tris: Tensor, o: Tensor, d: Tensor, tmax: Tensor,
             tmin=RAY_EPSILON, block: int = 128) -> Tensor:
    """Whether a triangle of `tris` lies on each ray with t in [tmin,
    tmax]."""
    o, d = o.to(F64), d.to(F64)
    tmin = torch.as_tensor(tmin, dtype=F64, device=o.device).expand(
        o.shape[0])[:, None]
    tmax = tmax.to(F64)[:, None]
    out = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    for s in range(0, tris.shape[0], block):
        t, _, _ = _moller_trumbore(o[:, None], d[:, None],
                                   tris[s:s + block][None])
        out |= ((t >= tmin) & (t <= tmax)).any(1)
    return out


class Surface:
    """A point on triangles `tri` at barycentrics (b1, b2): its geometric
    normal, its shading frame from the interpolated vertex normal and
    tangent (the tangent made orthogonal to the normal unless it is within
    0.01 of it already, as SLR's triangle does), its material and the
    density of a uniform point on its triangle."""

    def __init__(self, scene: Scene, tri: Tensor, b1: Tensor, b2: Tensor,
                 p: Tensor | None = None):
        b = torch.stack([1.0 - b1 - b2, b1, b2], -1)[..., None]
        v = scene.p[tri]
        self.p = (b * v).sum(1) if p is None else p
        g = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        area2 = torch.linalg.norm(g, dim=-1)
        self.gn = g / area2[:, None]
        self.area_pdf = 2.0 / area2
        self.sn = unit((b * scene.n[tri]).sum(1))
        tan = unit((b * scene.t[tri]).sum(1))
        c = dot(self.sn, tan)[:, None]
        self.tx = torch.where(c.abs() >= 0.01, unit(tan - c * self.sn), tan)
        self.ty = torch.linalg.cross(self.sn, self.tx)
        self.mat = scene.mat[tri]

    def local(self, v: Tensor) -> Tensor:
        return torch.stack([dot(v, self.tx), dot(v, self.ty),
                            dot(v, self.sn)], -1)

    def world(self, v: Tensor) -> Tensor:
        return (v[:, 0:1] * self.tx + v[:, 1:2] * self.ty
                + v[:, 2:3] * self.sn)


def _spectra_at(scene: Scene, lam: Tensor, slots, override) -> list:
    """Each listed slot's spectrum at `lam`; `override` maps slots to
    replacements (a fit's leaves)."""
    return [(override.get(s) or scene.spectra[s]).at(lam) for s in slots]


# ---------------------------------------------------------------------------
# Sampling and scattering
# ---------------------------------------------------------------------------

def concentric_disk(u0: Tensor, u1: Tensor) -> tuple[Tensor, Tensor]:
    """Shirley and Chiu's square-to-disk map, in SLR's form, whose lower
    quarter turns the other way round (an equal-area map all the same)."""
    sx, sy = 2.0 * u0 - 1.0, 2.0 * u1 - 1.0
    one = torch.ones_like(sx)
    sxs = torch.where(sx == 0, one, sx)
    sys_ = torch.where(sy == 0, one, sy)
    right, upper = sx > sy, sx >= -sy
    r = torch.where(upper, torch.where(right, sx, sy),
                    torch.where(right, -sy, -sx))
    theta = torch.where(upper, torch.where(right, sy / sxs, 2.0 - sx / sys_),
                        torch.where(right, 6.0 + sx / sys_, 4.0 + sy / sxs))
    r = torch.where((sx == 0) & (sy == 0), torch.zeros_like(r), r)
    theta = theta * (math.pi / 4.0)
    return r * torch.cos(theta), r * torch.sin(theta)


def power_heuristic(a: Tensor, b: Tensor) -> Tensor:
    a2, b2 = a * a, b * b
    s = a2 + b2
    return torch.where(s > 0, a2 / torch.where(s > 0, s, torch.ones_like(s)),
                       torch.zeros_like(s))


def fresnel_conductor(eta: Tensor, k: Tensor, cos: Tensor) -> Tensor:
    """Unpolarised reflectance of a conductor of index eta + ik."""
    c = cos.abs()[:, None]
    c2 = c * c
    e2k2 = eta * eta + k * k
    r_par = (e2k2 * c2 - 2 * eta * c + 1) / (e2k2 * c2 + 2 * eta * c + 1)
    r_perp = (e2k2 - 2 * eta * c + c2) / (e2k2 + 2 * eta * c + c2)
    return 0.5 * (r_par + r_perp)


def fresnel_dielectric(eta_out: Tensor, eta_in: Tensor,
                       cos: Tensor) -> Tensor:
    """Unpolarised reflectance between two dielectrics; `cos` > 0 is light
    arriving from the outside. Total internal reflection reflects all."""
    c = torch.clamp(cos, -1.0, 1.0)[:, None]
    n1 = torch.where(c > 0, eta_out, eta_in)
    n2 = torch.where(c > 0, eta_in, eta_out)
    sin_t = n1 / n2 * torch.sqrt(torch.clamp(1 - c * c, min=0.0))
    cos_t = torch.sqrt(torch.clamp(1 - sin_t * sin_t, min=0.0))
    ci = c.abs()
    r_par = (n2 * ci - n1 * cos_t) / (n2 * ci + n1 * cos_t)
    r_perp = (n1 * ci - n2 * cos_t) / (n1 * ci + n2 * cos_t)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(sin_t >= 1, torch.ones_like(f), f)


def _hero(v: Tensor, hero: Tensor) -> Tensor:
    return v.gather(1, hero[:, None])[:, 0]


def sample_bsdf(kind, s, wo, gl, hero, wl_fixed, uc, u0, u1):
    """One scattering direction at each hit, in the shading frame:
    (wi, f, pdf, specular, dispersive). f is the BSDF times the shading
    normal's correction |wi.z| / |wi.gN|; `s` the material's spectra."""
    n = wo.shape[0]
    zero = torch.zeros((n,), dtype=wo.dtype, device=wo.device)
    front = dot(wo, gl) > 0
    mirror = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    cos_o = wo[:, 2]

    # matte: a cosine-weighted direction on wo's side of the surface
    dx, dy = concentric_disk(u0, u1)
    dz = torch.sqrt(torch.clamp(1 - dx * dx - dy * dy, min=0.0))
    wi_m = torch.stack([dx, dy, torch.where(front, dz, -dz)], -1)
    both = (wo[:, 2] * wi_m[:, 2] > 0) & (dot(wo, gl) * dot(wi_m, gl) > 0)
    f_m = torch.where(both[:, None], s[0] / math.pi, torch.zeros_like(s[0]))
    pdf_m = dz / math.pi

    # metal: the mirror direction, weighted by the conductor's Fresnel
    cos_oa = torch.clamp(cos_o.abs(), min=1e-12)[:, None]
    f_c = s[0] * fresnel_conductor(s[1], s[2], cos_o) / cos_oa

    # glass: reflect or refract, chosen by the hero wavelength's share of
    # the reflectance; a refraction keeps the hero wavelength alone
    fr = fresnel_dielectric(s[1], s[2], cos_o)
    p_refl = spectra.importance(fr, hero)
    refl = torch.clamp(uc, max=1.0 - 1e-7) < p_refl
    n_out, n_in = _hero(s[1], hero), _hero(s[2], hero)
    outside = cos_o > 0
    ratio = torch.where(outside, n_out / n_in, n_in / n_out)
    sin2 = ratio * ratio * (1 - cos_o * cos_o)
    tir = sin2 >= 1
    cos_t = torch.sqrt(torch.clamp(1 - sin2, min=0.0))
    cos_t = torch.where(outside, -cos_t, cos_t)
    wi_t = torch.stack([-ratio * wo[:, 0], -ratio * wo[:, 1], cos_t], -1)
    t_val = (_hero(s[0], hero) * (1 - _hero(fr, hero)) * ratio * ratio
             / torch.clamp(cos_t.abs(), min=1e-12))
    onehot = torch.arange(spectra.N_WL, device=wo.device) == hero[:, None]
    f_t = torch.where(onehot & ~tir[:, None], t_val[:, None],
                      torch.zeros_like(s[0]))
    f_r = s[0] * fr / cos_oa
    wi_g = torch.where(refl[:, None], mirror, wi_t)
    f_g = torch.where(refl[:, None], f_r, f_t)
    pdf_g = torch.where(refl, torch.where(cos_o == 0, zero, p_refl),
                        torch.where(tir, zero, 1 - p_refl))

    is_m, is_g = (kind == MATTE), (kind == GLASS)
    wi = torch.where(is_m[:, None], wi_m, torch.where(is_g[:, None], wi_g,
                                                      mirror))
    f = torch.where(is_m[:, None], f_m, torch.where(is_g[:, None], f_g, f_c))
    pdf = torch.where(is_m, pdf_m, torch.where(is_g, pdf_g,
                                               torch.ones_like(zero)))
    # a material whose importance is nought scatters nothing
    weight = torch.where(is_m, spectra.importance(s[0], hero),
                         torch.where(is_g, spectra.importance(s[0], hero),
                                     spectra.importance(s[0] * fresnel_conductor(
                                         s[1], s[2], cos_o), hero)))
    pdf = torch.where(weight > 0, pdf, zero)
    corr = wi[:, 2].abs() / torch.clamp(dot(wi, gl).abs(), min=1e-6)
    dispersive = is_g & ~refl & ~wl_fixed
    return wi, f * corr[:, None], pdf, ~is_m, dispersive


def matte_eval(s0, wo, wi, gl):
    """A matte surface's BSDF (with the shading normal's correction) and
    its sampling density for the direction wi."""
    same = wo[:, 2] * wi[:, 2] > 0
    both = same & (dot(wo, gl) * dot(wi, gl) > 0)
    corr = wi[:, 2].abs() / torch.clamp(dot(wi, gl).abs(), min=1e-6)
    f = torch.where(both[:, None], s0 / math.pi * corr[:, None],
                    torch.zeros_like(s0))
    pdf = torch.where(same, wi[:, 2].abs() / math.pi,
                      torch.zeros_like(corr))
    return f, pdf


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------

def camera_rays(scene: Scene, pixel: Tensor, rnd: Streams, width: int,
                height: int):
    """Rays through a jittered point of each pixel and a point on the
    lens, and the camera's weight (importance x cos / densities), which
    for SLR's thin lens is cos^4 of the ray's angle to the axis times the
    area of the in-focus plane's window over the focus distance squared."""
    cam = scene.camera
    dev = pixel.device
    px = (pixel % width).to(F64) + rnd(0, PIXEL_X)
    py = torch.div(pixel, width, rounding_mode="floor").to(F64) \
        + rnd(0, PIXEL_Y)
    win_h = 2.0 * cam.obj_dist * math.tan(cam.fov_y / 2.0)
    win_w = win_h * cam.aspect
    lx, ly = concentric_disk(rnd(0, LENS_U), rnd(0, LENS_V))
    lens = torch.stack([lx, ly, torch.zeros_like(lx)], -1) * cam.lens_radius
    focus = torch.stack([win_w * (0.5 - px / width),
                         win_h * (0.5 - py / height),
                         torch.full_like(px, cam.obj_dist)], -1)
    d_cam = unit(focus - lens)
    m = torch.as_tensor(cam.to_world, dtype=F64, device=dev)
    o = lens @ m[:3, :3].T + m[:3, 3]
    d = unit(d_cam @ m[:3, :3].T)
    weight = d_cam[:, 2] ** 4 * win_w * win_h / cam.obj_dist ** 2
    return o, d, weight


def _bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def trace(scene: Scene, pixel: Tensor, sample: Tensor, seed: int,
          width: int, height: int, max_depth: int, override=None,
          lowp: bool = False) -> Tensor:
    """Each item's camera-weighted radiance developed to linear sRGB,
    (R, 3). `override` maps spectrum slots to replacements, through which
    gradients flow; directions and densities carry none."""
    override = override or {}
    dev = scene.device
    rnd = Streams(seed, pixel, sample)
    n = pixel.shape[0]
    lam = spectra.wavelengths(rnd(0, WAVELENGTH))
    hero = torch.clamp((rnd(0, WL_SELECT) * spectra.N_WL).long(),
                       max=spectra.N_WL - 1)
    o, d, w_cam = camera_rays(scene, pixel, rnd, width, height)
    kinds, emits = scene.kind(), scene.emits()
    n_lights = scene.lights.shape[0]
    slots = range(len(scene.spectra))

    ones = torch.ones((n, spectra.N_WL), dtype=F64, device=dev)
    beta, total = ones, torch.zeros_like(ones)
    init_y = spectra.importance(ones, hero)
    wl_fixed = torch.zeros((n,), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)        # the items still traced

    def emission(surf, lam_r, rows_r, w_out):
        """Le / pi of each surface's emitter towards -w_out (0 if none or
        from behind)."""
        le = torch.zeros((surf.mat.shape[0], spectra.N_WL), dtype=F64,
                         device=dev)
        for i, mtl in enumerate(scene.materials):
            if mtl.emit >= 0:
                sel = surf.mat == i
                e = _spectra_at(scene, lam_r, [mtl.emit], override)[0]
                le = torch.where(sel[:, None], e / math.pi, le)
        front = dot(-w_out, surf.sn) > 0
        return torch.where((front & emits[surf.mat])[:, None], le,
                           torch.zeros_like(le))

    def cast(o_r, d_r):
        t, tri, b1, b2 = closest_hit(scene.p, o_r, d_r)
        hit = tri >= 0
        safe = torch.clamp(tri, min=0)
        surf = Surface(scene, safe, b1, b2,
                       o_r + d_r * torch.where(hit, t, 0.0)[:, None])
        return hit, surf

    hit, surf = cast(o, d)
    total = total + torch.where(hit[:, None],
                                beta * emission(surf, lam, rows, d), 0.0)
    keep = hit
    rows, beta, d, surf = rows[keep], beta[keep], d[keep], _take(surf, keep)
    for bounce in range(1, max_depth + 1):
        if rows.numel() == 0:
            break
        lam_r, hero_r = lam[rows], hero[rows]
        s_all = _spectra_at(scene, lam_r, slots, override)
        mtl = [scene.materials[int(i)] for i in range(len(scene.materials))]
        kind = kinds[surf.mat]
        # slots a material lacks hold harmless values, so that no kind's
        # arithmetic, done for every row, divides by nought
        s = [torch.full_like(beta, v) for v in (0.5, 1.0, 1.5)]
        for i, m in enumerate(mtl):
            sel = (surf.mat == i)[:, None]
            for j, slot in enumerate(m.slots):
                s[j] = torch.where(sel, s_all[slot], s[j])
        wo = surf.local(-d)
        gl = surf.local(surf.gn)

        # one light sample at non-specular hits
        u_sel = rnd(bounce, LIGHT_SELECT, rows)
        li = scene.lights[torch.clamp((u_sel * n_lights).long(),
                                      max=n_lights - 1)]
        sq = torch.sqrt(rnd(bounce, LIGHT_POS_U, rows))
        lb1 = rnd(bounce, LIGHT_POS_V, rows) * sq
        lb2 = sq - lb1                       # 1 - b0 - b1 with b0 = 1 - sq
        light = Surface(scene, li, lb1, lb2)
        to_l = light.p - surf.p
        dist2 = torch.clamp(dot(to_l, to_l), min=1e-12)
        dist = torch.sqrt(dist2)
        wl_w = to_l / dist[:, None]
        matte = kind == MATTE
        vis = ~occluded(scene.p, surf.p, wl_w, dist * (1 - SHADOW_SHORTEN))
        wi_l = surf.local(wl_w)
        f_l, pdf_l = matte_eval(s[0], wo, wi_l, gl)
        cos_l = dot(-wl_w, light.gn).abs()
        light_pdf = light.area_pdf / n_lights
        mis = power_heuristic(light_pdf, pdf_l * cos_l / dist2)
        g = dot(wi_l, gl).abs() * cos_l / dist2
        le_l = emission(light, lam_r, rows, wl_w)
        nee = beta * le_l * f_l * (g * mis / light_pdf)[:, None]
        total = total.index_add(0, rows, torch.where(
            (matte & vis)[:, None], nee, torch.zeros_like(nee)))

        # the BSDF's sample, and what it hits
        wi, f, pdf, specular, disp = sample_bsdf(
            kind, s, wo, gl, hero_r, wl_fixed[rows],
            rnd(bounce, BSDF_COMPONENT, rows), rnd(bounce, BSDF_U, rows),
            rnd(bounce, BSDF_V, rows))
        wi, pdf = wi.detach(), pdf.detach()
        dir_pdf = torch.where(disp, pdf / spectra.N_WL, pdf)
        beta_new = beta * f * (dot(wi, gl).abs()
                               / torch.clamp(dir_pdf, min=1e-30))[:, None]
        ok = (dir_pdf > 0) & (f != 0).any(1)
        wl_fixed = wl_fixed.index_put((rows,), wl_fixed[rows] | disp)
        d_new = surf.world(wi)
        hit, nxt = cast(surf.p, d_new)
        to_n = nxt.p - surf.p
        light_pdf_n = (nxt.area_pdf / n_lights * dot(to_n, to_n).clamp(
            min=1e-12) / torch.clamp(dot(d_new, nxt.gn).abs(), min=1e-12))
        mis_n = torch.where(specular, torch.ones_like(dir_pdf),
                            power_heuristic(dir_pdf, light_pdf_n))
        arrive = ok & hit
        le_n = emission(nxt, lam_r, rows, d_new)
        total = total.index_add(0, rows, torch.where(
            arrive[:, None], beta_new * le_n * mis_n[:, None],
            torch.zeros_like(le_n)))

        # Russian roulette on the path's importance
        cont = torch.clamp(spectra.importance(beta_new, hero_r)
                           / init_y[rows], max=1.0).detach()
        live = rnd(bounce, RR, rows) < cont
        beta = torch.where(live[:, None],
                           beta_new / torch.clamp(cont, min=1e-30)[:, None],
                           beta_new)
        keep = arrive & live
        rows, beta, d, surf = (rows[keep], beta[keep], d_new[keep],
                               _take(nxt, keep))
        if lowp:
            beta, d, total = _bf16(beta), _bf16(d), _bf16(total)
            surf.p = _bf16(surf.p)
    return spectra.develop(w_cam[:, None] * total, lam)


def _take(surf: Surface, keep: Tensor) -> Surface:
    out = Surface.__new__(Surface)
    for k, v in vars(surf).items():
        setattr(out, k, v[keep])
    return out


# ---------------------------------------------------------------------------
# Whole images and a fit's leaves
# ---------------------------------------------------------------------------

GRID_NM = np.linspace(spectra.WL_LO, spectra.WL_HI, 471)   # 1 nm


def render_image(scene: Scene, width: int, height: int, spp: int,
                 seed: int, max_depth: int, sample_offset: int = 0,
                 override=None, lowp: bool = False) -> Tensor:
    """(H, W, 3) linear sRGB: the mean of samples sample_offset ... +
    spp - 1 of every pixel."""
    pixel = torch.arange(width * height, device=scene.device)
    acc = 0.0
    for i in range(spp):
        acc = acc + trace(scene, pixel, torch.full_like(pixel,
                                                        sample_offset + i),
                          seed, width, height, max_depth, override, lowp)
    return (acc / spp).reshape(height, width, 3)


def leaves(scene: Scene, curve_slots, scale_slots) -> list:
    """A fit's initial leaves: the spectra of `curve_slots` sampled every
    nanometre, then the scales of the tabulated spectra `scale_slots`."""
    lam = torch.as_tensor(GRID_NM, dtype=F64, device=scene.device)
    return ([scene.spectra[s].at(lam[None])[0] for s in curve_slots]
            + [torch.as_tensor(float(scene.spectra[s].scale), dtype=F64,
                               device=scene.device) for s in scale_slots])


def override(scene: Scene, curve_slots, scale_slots, values) -> dict:
    """The spectra a fit's leaves stand for: linear between the 1 nm
    samples, and the tabulated spectra times their scale leaves."""
    out = {s: spectra.Curve(GRID_NM, v) for s, v in zip(curve_slots, values)}
    for s, v in zip(scale_slots, values[len(curve_slots):]):
        base = scene.spectra[s]
        out[s] = spectra.Curve(base.wls, base.values, v)
    return out
