"""Spectra for the reference: hero-wavelength sets, the scene's spectra
evaluated at them, and the 16-strata sensor that develops them to linear
sRGB. Written for the benchmark from SLR's spectral semantics; the tables
in `data/` (CIE 1931 colour-matching functions and D65 at 1 nm, measured
refractive indices, the Meng-Simon upsampling grid) are data, not code.

Everything is float64 unless a caller passes another dtype.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

Tensor = torch.Tensor

WL_LO, WL_HI = 360.0, 830.0
N_WL = 16          # wavelengths per path, one in each stratum
N_STRATA = 16      # sensor strata over [WL_LO, WL_HI]
HERO_SHARE = 0.9   # the hero wavelength's share of a path's importance

# Linear sRGB (Rec. 709 primaries) to CIE XYZ: with the equal-energy white
# for reflectances, with D65 for illuminants; and XYZ to linear sRGB.
SRGB_E_TO_XYZ = np.array([[0.4969, 0.3391, 0.1640],
                          [0.2562, 0.6782, 0.0656],
                          [0.0233, 0.1130, 0.8637]])
SRGB_TO_XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                        [0.2126729, 0.7151522, 0.0721750],
                        [0.0193339, 0.1191920, 0.9503041]])
XYZ_TO_SRGB = np.array([[3.2404542, -1.5371385, -0.4985314],
                        [-0.9692660, 1.8760108, 0.0415560],
                        [0.0556434, -0.2040259, 1.0572252]])

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@functools.cache
def table(name: str) -> dict:
    with np.load(os.path.join(_DATA, name + ".npz")) as d:
        return {k: np.asarray(d[k], np.float64) for k in d.files}


def wavelengths(u_offset: Tensor) -> Tensor:
    """(R,) offsets in [0, 1) -> (R, 16) wavelengths, the k-th at offset
    u within the k-th of 16 equal strata of [360, 830] nm."""
    k = torch.arange(N_WL, dtype=u_offset.dtype, device=u_offset.device)
    return WL_LO + (WL_HI - WL_LO) / N_WL * (k + u_offset[:, None])


def importance(v: Tensor, hero: Tensor) -> Tensor:
    """A path's importance: 0.9 of it the hero wavelength's value, the
    rest shared by the other 15."""
    rest = (1.0 - HERO_SHARE) / (N_WL - 1)
    at_hero = torch.gather(v, 1, hero[:, None])[:, 0]
    return rest * (v.sum(1) - at_hero) + HERO_SHARE * at_hero


# ---------------------------------------------------------------------------
# The scene's spectra
# ---------------------------------------------------------------------------

class Curve:
    """A tabulated spectrum, linear between its samples and zero outside
    them, times `scale`. `values` and `scale` may be tensors that carry
    gradients."""

    def __init__(self, wls, values, scale=1.0):
        self.wls = np.asarray(wls, np.float64)
        self.values = values
        self.scale = scale

    def at(self, lam: Tensor) -> Tensor:
        wls = torch.as_tensor(self.wls, dtype=lam.dtype, device=lam.device)
        vals = torch.as_tensor(self.values, dtype=lam.dtype, device=lam.device)
        i = torch.clamp(torch.searchsorted(wls, lam.contiguous(), right=True)
                        - 1, 0, wls.shape[0] - 2)
        w = (lam - wls[i]) / (wls[i + 1] - wls[i])
        v = vals[i] + w * (vals[i + 1] - vals[i])
        inside = (lam >= wls[0]) & (lam <= wls[-1])
        return torch.where(inside, v, torch.zeros_like(v)) * self.scale


class Upsampled:
    """An RGB colour as a smooth spectrum: Meng, Simon, Hanika and
    Dachsbacher 2015, "Physically meaningful rendering using tristimulus
    colours". The colour's chromaticity, mapped into the grid of
    precomputed spectra, is interpolated bilinearly between the spectra at
    its cell's corners; its brightness scales the result, a reflectance's
    normalised so that white (1, 1, 1) is 1 at every wavelength."""

    UV_FROM_XY = np.array([[16.730260708356887, 7.7801960340706,
                            -2.170152247475828],
                           [-7.530081094743006, 16.192422314095225,
                            1.1125529268825947]])

    def __init__(self, rgb, illuminant: bool):
        t = table("upsampling")
        xyz = (SRGB_TO_XYZ if illuminant else SRGB_E_TO_XYZ) @ np.asarray(
            rgb, np.float64)
        bright = float(xyz.sum())
        xy = xyz[:2] / bright if bright != 0 else np.full(2, 1.0 / 3.0)
        u, v = self.UV_FROM_XY @ np.append(xy, 1.0)
        w, h = int(t["grid_width"]), int(t["grid_height"])
        if not (0 <= u < w and 0 <= v < h):
            raise ValueError(f"colour {rgb} lies outside the spectral grid")
        cell = int(u) + w * int(v)
        if t["grid_inside"][cell] != 1:
            raise NotImplementedError(
                f"colour {rgb} lies in a boundary cell of the grid")
        fu, fv = u - int(u), v - int(v)
        corners = t["grid_idx"][cell, :4].astype(np.int64)
        weights = [(1 - fu) * (1 - fv), fu * (1 - fv), (1 - fu) * fv, fu * fv]
        basis = sum(wt * t["dp_spectra"][c] for wt, c in zip(weights, corners))
        scale = bright if illuminant else bright / float(
            t["equal_energy_reflectance"])
        self.curve = Curve(np.linspace(WL_LO, WL_HI, basis.shape[0]),
                           basis * scale)

    def at(self, lam: Tensor) -> Tensor:
        return self.curve.at(lam)


def library_curve(name: str, component: int) -> Curve:
    """A named spectrum of the scene language: "D65", or a measured
    refractive index (`component` 0 its real part, 1 its extinction)."""
    if name == "D65":
        d = table("cie")
        return Curve(np.linspace(d["d65_wl_lo"], d["d65_wl_hi"],
                                 d["d65"].shape[0]), d["d65"])
    d = table("iors")
    part = "etas" if component == 0 else "ks"
    return Curve(d[name + "_lambdas"], d[f"{name}_{part}"])


def spectrum_of(desc) -> Curve | Upsampled:
    """A scene-file spectrum (`scenefile.graph.SpectrumDesc`) as a
    function of wavelength. Constant colours are upsampled; RGB constants
    arrive linear (the scene reader de-gammas sRGB)."""
    illuminant = desc.spectrum_type == "Illuminant"
    if desc.kind == "mono":
        return Upsampled((desc.value * desc.scale,) * 3, illuminant)
    if desc.kind == "rgb":
        return Upsampled(tuple(np.asarray(desc.rgb) * desc.scale), illuminant)
    if desc.kind == "library":
        c = library_curve(desc.library_id, desc.library_comp)
        c.scale = desc.scale
        return c
    if desc.kind == "regular":
        return Curve(np.linspace(desc.min_wl, desc.max_wl, len(desc.values)),
                     np.asarray(desc.values), desc.scale)
    if desc.kind == "irregular":
        return Curve(desc.wls, np.asarray(desc.values), desc.scale)
    raise NotImplementedError(f"spectrum kind {desc.kind}")


# ---------------------------------------------------------------------------
# The sensor
# ---------------------------------------------------------------------------

@functools.cache
def stratum_cmfs() -> np.ndarray:
    """(16, 3): each stratum's integral of the CIE x, y, z functions, the
    1 nm tables taken as linear between their samples."""
    d = table("cie")
    wl = np.linspace(d["cmf_wl_lo"], d["cmf_wl_hi"], d["xbar"].shape[0])
    edges = np.linspace(WL_LO, WL_HI, N_STRATA + 1)
    out = np.zeros((N_STRATA, 3))
    for s in range(N_STRATA):
        a, b = edges[s], edges[s + 1]
        x = np.concatenate([[a], wl[(wl > a) & (wl < b)], [b]])
        for c, key in enumerate(("xbar", "ybar", "zbar")):
            y = np.interp(x, wl, d[key])
            out[s, c] = (0.5 * (y[1:] + y[:-1]) * np.diff(x)).sum()
    return out


def develop(values: Tensor, lam: Tensor) -> Tensor:
    """(R, 16) radiance samples at (R, 16) wavelengths -> (R, 3) linear
    sRGB: each sample counts for its stratum's share of the colour-matching
    functions, normalised by the integral of y."""
    cmf = torch.as_tensor(stratum_cmfs(), dtype=values.dtype,
                          device=values.device)
    stratum = torch.clamp(((lam - WL_LO) / (WL_HI - WL_LO) * N_STRATA)
                          .floor().long(), 0, N_STRATA - 1)
    xyz = (values[..., None] * cmf[stratum]).sum(1) / cmf[:, 1].sum()
    m = torch.as_tensor(XYZ_TO_SRGB, dtype=values.dtype, device=values.device)
    return xyz @ m.T
