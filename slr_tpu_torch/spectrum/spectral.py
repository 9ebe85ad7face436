"""Spectral pipeline: hero-wavelength sampling, tabulated spectra, the
16-strata sensor reduction and the host-side Meng-Simon tabulation used at
scene build (counterpart of slr_tpu/spectrum/spectral.py).

The tables in `data/*.npz` are copies of the reference package's. Scene
build pre-tabulates every constant spectrum into a per-nm curve; image,
checker and voronoi spectra go through the device-side Meng-Simon evaluator
`upsample_eval` at render time, which gathers the basis spectra plainly.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

WL_LO = 360.0
WL_HI = 830.0
NUM_SPECTRAL_SAMPLES = 16
NUM_STRATA = 16
GRID_W = 12
GRID_H = 14
MAX_FAN = 6

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@functools.cache
def _raw(name: str):
    return np.load(os.path.join(_DATA_DIR, name))


@functools.cache
def upsampling_tables():
    """Meng-Simon grid tables (numpy)."""
    d = _raw("upsampling.npz")
    return {
        "inside": d["grid_inside"].astype(np.int32),
        "num_points": d["grid_num_points"].astype(np.int32),
        "idx": d["grid_idx"].astype(np.int32),
        "dp_uv": np.asarray(d["dp_uv"]),
        "dp_spectra": np.asarray(d["dp_spectra"]),
        "eer": float(d["equal_energy_reflectance"]),
    }


@functools.cache
def cie_tables():
    d = _raw("cie.npz")
    return {k: np.asarray(d[k])
            for k in ("xbar", "ybar", "zbar", "d65", "colorchecker")}


@functools.cache
def strata_cmfs() -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Per-stratum integrated CMFs: trapezoid-integrate the 1nm CMF tables
    into NUM_STRATA bins over [360, 830]; the integral is the ybar sum."""
    d = _raw("cie.npz")
    n = d["xbar"].shape[0]
    wl = np.linspace(WL_LO, WL_HI, n)
    bins = np.linspace(WL_LO, WL_HI, NUM_STRATA + 1)
    out = []
    for key in ("xbar", "ybar", "zbar"):
        f = d[key].astype(np.float64)
        acc = np.zeros(NUM_STRATA)
        for i in range(n - 1):
            a, b = wl[i], wl[i + 1]
            fa, fb = f[i], f[i + 1]
            ia = min(int((a - WL_LO) / (WL_HI - WL_LO) * NUM_STRATA),
                     NUM_STRATA - 1)
            ib = min(int((b - WL_LO) / (WL_HI - WL_LO) * NUM_STRATA),
                     NUM_STRATA - 1)
            if ia == ib:
                acc[ia] += 0.5 * (fa + fb) * (b - a)
            else:
                mid = bins[ia + 1]
                t = (mid - a) / (b - a)
                fm = fa * (1 - t) + fb * t
                acc[ia] += 0.5 * (fa + fm) * (mid - a)
                acc[ib] += 0.5 * (fm + fb) * (b - mid)
        out.append(acc.astype(np.float32))
    integral = float(out[1].sum())
    return out[0], out[1], out[2], integral


class WavelengthSamples(NamedTuple):
    lambdas: Tensor  # (R, N) wavelengths in nm
    hero: Tensor     # (R,) int64 selected hero index
    pdf: Tensor      # (R,) selection pdf = N / range


def sample_wavelengths(offset: Tensor, u_select: Tensor) -> WavelengthSamples:
    """Stratified hero-wavelength set."""
    n = NUM_SPECTRAL_SAMPLES
    i = torch.arange(n, dtype=torch.float32, device=offset.device)
    # One rounding of 360 + 29.375 x (exact in float64), as the reference
    # computes it inside its compiled renderers (a fused multiply-add).
    x = (i[None, :] + offset[..., None]).to(torch.float64)
    lambdas = (WL_LO + (WL_HI - WL_LO) / n * x).to(torch.float32)
    hero = torch.clamp((u_select * n).to(torch.int64), max=n - 1)
    pdf = torch.full_like(offset, n / (WL_HI - WL_LO))
    return WavelengthSamples(lambdas=lambdas, hero=hero, pdf=pdf)


_sRGB_E_to_XYZ = np.array(
    [[0.4969, 0.3391, 0.1640], [0.2562, 0.6782, 0.0656],
     [0.0233, 0.1130, 0.8637]], np.float32)
_sRGB_to_XYZ = np.array(
    [[0.4124564, 0.3575761, 0.1804375],
     [0.2126729, 0.7151522, 0.0721750],
     [0.0193339, 0.1191920, 0.9503041]], np.float32)


def xy_to_uv(xy: Tensor) -> Tensor:
    """CIE xy chromaticity -> Meng-Simon grid coordinates (u, v)."""
    u = (16.730260708356887 * xy[..., 0] + 7.7801960340706 * xy[..., 1]
         - 2.170152247475828)
    v = (-7.530081094743006 * xy[..., 0] + 16.192422314095225 * xy[..., 1]
         + 1.1125529268825947)
    return torch.stack([u, v], dim=-1)


def srgb_to_uvs(rgb: Tensor, illuminant: bool = False) -> Tensor:
    """rgb (..., 3) -> (u, v, scale); reflectances use the equal-energy
    sRGB matrix."""
    m = _upsampling_t(rgb.device)["illuminant" if illuminant else "reflectance"]
    xyz = torch.einsum("ij,...j->...i", m, rgb)
    b = xyz.sum(-1)
    safe_b = torch.where(b == 0, 1.0, b)
    xy = torch.stack([torch.where(b == 0, 1.0 / 3, xyz[..., 0] / safe_b),
                      torch.where(b == 0, 1.0 / 3, xyz[..., 1] / safe_b)],
                     dim=-1)
    return torch.cat([xy_to_uv(xy), b[..., None]], dim=-1)


_UPSAMPLING_T: dict = {}


def _upsampling_t(device) -> dict:
    """The Meng-Simon tables and the sRGB -> XYZ matrices as tensors on
    `device` (cached per device)."""
    key = str(device)
    if key not in _UPSAMPLING_T:
        t = upsampling_tables()
        tabs = {k: torch.as_tensor(t[k], device=device)
                for k in ("inside", "num_points", "idx", "dp_uv", "dp_spectra")}
        tabs["illuminant"] = torch.as_tensor(_sRGB_to_XYZ, device=device)
        tabs["reflectance"] = torch.as_tensor(_sRGB_E_to_XYZ, device=device)
        _UPSAMPLING_T[key] = tabs
    return _UPSAMPLING_T[key]


def upsample_eval(u: Tensor, v: Tensor, scale, lambdas: Tensor) -> Tensor:
    """Evaluate the Meng-Simon upsampled spectrum at `lambdas`.

    u/v/scale: (...,) grid coordinates and brightness; lambdas (..., N) nm.
    Returns (..., N): bilinear weights inside the grid, a triangle fan at
    its boundary, then the weighted basis spectra, each interpolated
    linearly at every wavelength by a plain gather."""
    t = _upsampling_t(lambdas.device)
    lead = u.shape
    n = lambdas.shape[-1]
    u = u.reshape(-1)
    v = v.reshape(-1)
    r = u.shape[0]
    scale_f = torch.broadcast_to(torch.as_tensor(scale, dtype=torch.float32,
                                                 device=u.device),
                                 lead).reshape(r)
    lam = lambdas.reshape(r, n)

    in_grid = (u >= 0) & (u < GRID_W) & (v >= 0) & (v < GRID_H)
    uc = torch.clamp(u, 0.0, GRID_W - 1e-4)
    vc = torch.clamp(v, 0.0, GRID_H - 1e-4)
    ui = uc.to(torch.int64)
    vi = vc.to(torch.int64)
    cell = ui + GRID_W * vi
    inside = t["inside"][cell] == 1
    num_points = t["num_points"][cell].to(torch.int64)
    idx6 = t["idx"][cell].to(torch.int64)                        # (R, 6)
    p_n = t["dp_uv"].shape[0]
    uv6 = t["dp_uv"][torch.clamp(idx6, 0, p_n - 1)]              # (R, 6, 2)

    # Inside: bilinear over the quad's 4 corners (slots 0..3).
    s = uc - ui
    tt = vc - vi
    w_in = torch.stack([(1 - s) * (1 - tt), s * (1 - tt), (1 - s) * tt,
                        s * tt, torch.zeros_like(s), torch.zeros_like(s)],
                       dim=-1)

    # Boundary: the triangle fan around slot 0. The reference walks the
    # fan's triangles i = 1..5 in turn and stops at the first that holds
    # (u, v); until then triangle i's first edge and its first barycentric
    # are triangle i - 1's second ones, so all five are formed at once and
    # the first that holds wins.
    p0 = uv6[:, 0]
    ex = (uc - p0[:, 0])[:, None]
    ey = (vc - p0[:, 1])[:, None]
    fan = torch.arange(1, MAX_FAN, device=u.device)                 # (5,)
    sel_slot = fan % torch.clamp(num_points - 1, min=1)[:, None] + 1  # (R, 5)
    e1 = torch.gather(uv6, 1, sel_slot[..., None].expand(r, MAX_FAN - 1, 2)) \
        - p0[:, None]
    vv = ex * e1[..., 1] - e1[..., 0] * ey
    e0 = uv6[:, 1] - p0
    e_prev = torch.cat([e0[:, None], e1[:, :-1]], dim=1)
    uu = torch.cat([(e0[:, 0] * ey[:, 0] - ex[:, 0] * e0[:, 1])[:, None],
                    -vv[:, :-1]], dim=1)
    area = e_prev[..., 0] * e1[..., 1] - e1[..., 0] * e_prev[..., 1]
    safe_area = torch.where(area == 0, 1.0, area)
    bu = uu / safe_area
    bv = vv / safe_area
    bw = 1.0 - bu - bv
    hit = ((fan < num_points[:, None]) & (bu >= -1e-6) & (bv >= -1e-6)
           & (bw >= -1e-6) & (area != 0))
    found = hit.any(1)
    k = torch.argmax(hit.to(torch.int8), dim=1)[:, None]           # first hit

    def at_k(x: Tensor) -> Tensor:
        return torch.gather(x, 1, k)

    slots = torch.arange(MAX_FAN, device=u.device)[None, :]
    w_fan = (at_k(bu) * (slots == at_k(sel_slot))
             + at_k(bv) * (slots == k + 1) + at_k(bw) * (slots == 0))
    w_fan = torch.where(found[:, None], w_fan, 0.0)

    slot_w = torch.where(inside[:, None], w_in, w_fan)
    ok = in_grid & (inside | found)
    slot_w = torch.where(ok[:, None] & (idx6 >= 0), slot_w, 0.0) \
        * scale_f[:, None]

    # Each slot's basis spectrum, interpolated at every wavelength.
    spectra = t["dp_spectra"]
    c = spectra.shape[1]
    sbinf = torch.clamp((lam - WL_LO) / (WL_HI - WL_LO), 0.0, 1.0) * (c - 1)
    sbin = torch.clamp(sbinf.to(torch.int64), max=c - 1)
    sbin_next = torch.clamp(sbin + 1, max=c - 1)
    frac = sbinf - sbin
    row = torch.clamp(idx6, 0, p_n - 1)[:, :, None] * c          # (R, 6, 1)
    flat = spectra.reshape(-1)
    basis = (flat[row + sbin[:, None, :]] * (1.0 - frac[:, None, :])
             + flat[row + sbin_next[:, None, :]] * frac[:, None, :])
    val = (slot_w[:, :, None] * basis).sum(1)
    return val.reshape(*lead, n)


def upsample_tabulate_host(u: float, v: float, scale: float,
                           lam_grid: np.ndarray) -> np.ndarray:
    """Host-side (numpy) evaluation of one Meng-Simon upsampled spectrum on
    a dense wavelength grid, used at scene build to pre-tabulate constant
    spectra into per-nm curves (the basis spectra are piecewise linear with
    5 nm knots, so a per-nm resample is exact)."""
    t = upsampling_tables()
    if not (0 <= u < GRID_W and 0 <= v < GRID_H):
        return np.zeros_like(lam_grid, dtype=np.float32)
    ui, vi = int(u), int(v)
    cell = ui + GRID_W * vi
    inside = int(t["inside"][cell]) == 1
    num_points = int(t["num_points"][cell])
    idx = t["idx"][cell]
    spectra = t["dp_spectra"]

    if inside:
        s, tt = u - ui, v - vi
        pts = [
            (idx[0], (1 - s) * (1 - tt)),
            (idx[1], s * (1 - tt)),
            (idx[2], (1 - s) * tt),
            (idx[3], s * tt),
        ]
    else:
        dp_uv = t["dp_uv"]
        p0 = dp_uv[idx[0]]
        ex, ey = u - p0[0], v - p0[1]
        e_prev = dp_uv[idx[1]] - p0
        uu = e_prev[0] * ey - ex * e_prev[1]
        pts = None
        for i in range(1, max(num_points, 1)):
            sel_slot = i % max(num_points - 1, 1) + 1
            sel = idx[sel_slot]
            e1 = dp_uv[sel] - p0
            vv = ex * e1[1] - e1[0] * ey
            area = e_prev[0] * e1[1] - e1[0] * e_prev[1]
            if area != 0:
                bu, bv = uu / area, vv / area
                bw = 1.0 - bu - bv
                if bu >= -1e-6 and bv >= -1e-6 and bw >= -1e-6:
                    pts = [(sel, bu), (idx[min(i, MAX_FAN - 1)], bv),
                           (idx[0], bw)]
                    break
            uu = -vv
            e_prev = e1
        if pts is None:
            return np.zeros_like(lam_grid, dtype=np.float32)

    basis = sum(w * spectra[p] for p, w in pts)
    c = spectra.shape[1]
    x = np.clip((lam_grid - WL_LO) / (WL_HI - WL_LO), 0.0, 1.0) * (c - 1)
    xi = np.minimum(x.astype(np.int32), c - 1)
    xn = np.minimum(xi + 1, c - 1)
    frac = x - xi
    return (basis[xi] * (1 - frac) + basis[xn] * frac).astype(
        np.float32) * np.float32(scale)


def rgb_to_spectrum(rgb: Tensor, lambdas: Tensor,
                    illuminant: bool = False) -> Tensor:
    """RGB -> spectrum at `lambdas`; reflectances are normalized by the
    equal-energy reflectance, so rgb (1, 1, 1) is a flat spectrum of 1."""
    uvs = srgb_to_uvs(rgb, illuminant=illuminant)
    scale = uvs[..., 2] / (1.0 if illuminant else upsampling_tables()["eer"])
    return upsample_eval(uvs[..., 0], uvs[..., 1], scale, lambdas)


# ---------------------------------------------------------------------------
# Regular / irregular tabulated spectra (D65, IORs, ColorChecker)
# ---------------------------------------------------------------------------

def eval_regular_spectrum(values, wl_lo: float, wl_hi: float,
                          lambdas: Tensor) -> Tensor:
    """Linear interpolation of a regularly sampled SPD; zero outside."""
    values = torch.as_tensor(values, dtype=torch.float32,
                             device=lambdas.device)
    n = values.shape[-1]
    x = (lambdas - wl_lo) / (wl_hi - wl_lo) * (n - 1)
    xi = torch.clamp(x.to(torch.int64), 0, n - 2)
    frac = torch.clamp(x - xi, 0.0, 1.0)
    v = values[xi] * (1 - frac) + values[xi + 1] * frac
    return torch.where((lambdas >= wl_lo) & (lambdas <= wl_hi), v, 0.0)


def eval_irregular_spectrum(wls: Tensor, values: Tensor,
                            lambdas: Tensor) -> Tensor:
    """Piecewise-linear interpolation over irregular sample positions."""
    idx = torch.clamp(torch.searchsorted(wls, lambdas.contiguous()) - 1, 0,
                      wls.shape[0] - 2)
    lo = wls[idx]
    hi = wls[idx + 1]
    frac = torch.clamp((lambdas - lo) / torch.clamp(hi - lo, min=1e-6),
                       0.0, 1.0)
    v = values[idx] * (1 - frac) + values[idx + 1] * frac
    return torch.where((lambdas >= wls[0]) & (lambdas <= wls[-1]), v, 0.0)


@functools.cache
def ior_spectrum(name: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lambdas, etas, ks) arrays for a named measured IOR."""
    d = _raw("iors.npz")
    return d[f"{name}_lambdas"], d[f"{name}_etas"], d[f"{name}_ks"]


def d65_spectrum(lambdas: Tensor) -> Tensor:
    return eval_regular_spectrum(cie_tables()["d65"], 300.0, 830.0, lambdas)


def colorchecker_spectrum(patch: int, lambdas: Tensor) -> Tensor:
    return eval_regular_spectrum(cie_tables()["colorchecker"][patch], 380.0,
                                 730.0, lambdas)


# ---------------------------------------------------------------------------
# Sensor: stratum binning + XYZ/sRGB development
# ---------------------------------------------------------------------------

def bin_to_strata(lambdas: Tensor, values: Tensor) -> Tensor:
    """Scatter the N hero samples into 16 wavelength strata, scaled by
    strata/range. Returns (R, 16). Samples outside the range drop, as a
    one-hot of an out-of-range index is all zeros."""
    rec_bin_width = NUM_STRATA / (WL_HI - WL_LO)
    sbin = torch.clamp(
        ((lambdas - WL_LO) / (WL_HI - WL_LO) * NUM_STRATA).to(torch.int64),
        max=NUM_STRATA - 1)
    onehot = (sbin[..., None] == torch.arange(
        NUM_STRATA, device=sbin.device)).to(values.dtype)   # (R, N, 16)
    return torch.einsum("rn,rns->rs", values * rec_bin_width, onehot)


def strata_to_rgb(strata: Tensor) -> Tensor:
    """strata -> XYZ via integrated CMFs / integralCMF -> linear sRGB."""
    xb, yb, zb, integral = strata_cmfs()
    cmf = torch.as_tensor(np.stack([xb, yb, zb], axis=1),
                          device=strata.device)              # (16, 3)
    xyz = (strata @ cmf) / integral
    m = torch.tensor(
        [[3.2404542, -1.5371385, -0.4985314],
         [-0.9692660, 1.8760108, 0.0415560],
         [0.0556434, -0.2040259, 1.0572252]], dtype=torch.float32,
        device=strata.device)
    return xyz @ m.T
