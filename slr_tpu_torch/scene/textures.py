"""Texture evaluation over hit batches (counterpart of
slr_tpu/scene/textures.py).

Every texture kind present in a scene is evaluated for the whole batch and
the per-hit kind selects the result. Image lookups are nearest-neighbour
with wrap addressing into the padded (NI, Hmax, Wmax, 4) atlas; the
checker picks by ((int)2u + (int)2v) % 2; Voronoi is Worley cell noise
with an FNV-1 cell hash and linear-congruential feature points, computed
bit for bit in int64 masked to 32 bits.
"""
from __future__ import annotations

import torch

from .types import FloatTextures, FTexKind, NTexKind, SpectrumTextures, STexKind

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF


def _wrap01(x: Tensor) -> Tensor:
    """x mod 1 into [0, 1), negative-safe, as the reference's fmod wrap."""
    f = torch.fmod(x, 1.0)
    f = torch.where((f != 0) & (f < 0), f + 1.0, f)
    return torch.where(f < 0, f + 1.0, f)


def texel_coords(image_hw: Tensor, image_id: Tensor, u: Tensor, v: Tensor,
                 ni_total: int):
    """(clamped image id, texel row, texel column) of a nearest-neighbour
    fetch."""
    iid = torch.clamp(image_id.to(torch.int64), 0, ni_total - 1)
    hw = image_hw.to(torch.int64)[iid]
    h = hw[..., 0]
    w = hw[..., 1]
    px = torch.minimum((_wrap01(u) * w.to(torch.float32)).to(torch.int64),
                       w - 1)
    py = torch.minimum((_wrap01(v) * h.to(torch.float32)).to(torch.int64),
                       h - 1)
    return iid, py, px


def _image_fetch(images, image_hw: Tensor, image_id: Tensor,
                 u: Tensor, v: Tensor) -> Tensor:
    """Nearest-neighbour RGBA texels (R, 4) from the atlas. The atlas says
    how its texels are fetched: a tensor (NI, Hmax, Wmax, 4) is indexed
    here; any other atlas (a range-sharded one, parallel/scene_shard.py
    `ShardedAtlas`) has a `shape` and a `fetch(image_hw, image_id, u, v)`
    method, which is called instead."""
    if not isinstance(images, Tensor):
        return images.fetch(image_hw, image_id, u, v)
    if images.shape[0] == 0:
        return torch.zeros(u.shape + (4,), dtype=torch.float32,
                           device=u.device)
    iid, py, px = texel_coords(image_hw, image_id, u, v, images.shape[0])
    return images[iid, py, px]


# ---------------------------------------------------------------------------
# Voronoi (Worley) cell noise
# ---------------------------------------------------------------------------

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619


def _fnv1_hash_3i(ix: Tensor, iy: Tensor, iz: Tensor) -> Tensor:
    """FNV-1 over the 12 little-endian bytes of three int32 coordinates;
    uint32 values held in int64."""
    h = torch.full(ix.shape, _FNV_OFFSET, dtype=torch.int64, device=ix.device)
    for comp in (ix, iy, iz):
        c = comp.to(torch.int64) & _M32
        for shift in (0, 8, 16, 24):
            h = ((_FNV_PRIME * h) & _M32) ^ ((c >> shift) & 0xFF)
    return h


def _lcg_next(state: Tensor) -> tuple[Tensor, Tensor]:
    """next = 1664525 * state + 1013904223 (mod 2^32); float = next / 2^32,
    the uint32 rounded to float32 to nearest."""
    state = (state * 1664525 + 1013904223) & _M32
    return state, state.to(torch.float32) * (1.0 / 4294967296.0)


# The 2x2x2 neighbourhood in the reference's search order (dz, dy, dx),
# as a tensor per device (a host-to-device copy on every call would stall
# the stream).
_CELLS = [(dx, dy, dz) for dz in range(2) for dy in range(2) for dx in range(2)]
_CELLS_T: dict = {}
_FEATURES = 9


def _cells(device) -> Tensor:
    key = str(device)
    if key not in _CELLS_T:
        _CELLS_T[key] = torch.tensor(_CELLS, device=device)
    return _CELLS_T[key]


def voronoi_cell_feature(p: Tensor, scale: Tensor) -> tuple[Tensor, Tensor]:
    """Worley closest-feature search over the 2x2x2 neighbourhood.
    p (R, 3), scale (R,). Returns (closest cell hash + feature index,
    closest distance) in units of the cell size. All 8 cells and their 9
    candidate features are evaluated at once; the winner is the first
    minimum in the reference's order (cell, then feature), as its
    strict-less scan picks it."""
    evalp = p / scale[..., None]
    icoord = torch.floor(evalp).to(torch.int32).to(torch.int64)
    frac = evalp - icoord.to(torch.float32)
    base = icoord - 1 + torch.round(frac).to(torch.int64)
    cell = base[..., None, :] + _cells(p.device)
    h = _fnv1_hash_3i(cell[..., 0], cell[..., 1], cell[..., 2])   # (R, 8)
    state, f0 = _lcg_next(h)
    nfp = 1 + torch.clamp((8.0 * f0).to(torch.int64), max=8)
    draws = []
    for _ in range(3 * _FEATURES):
        state, f = _lcg_next(state)
        draws.append(f)
    # Stacked on a leading axis (contiguous copies), then viewed as
    # (R, 8, 9 features, 3 coordinates).
    fp = (cell.to(torch.float32)[..., None, :]
          + torch.stack(draws).movedim(0, -1).unflatten(-1, (_FEATURES, 3)))
    diff = evalp[..., None, None, :] - fp                         # (R, 8, 9, 3)
    dist = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                      + diff[..., 2] * diff[..., 2])
    feature = torch.arange(_FEATURES, device=p.device)
    dist = torch.where(feature < nfp[..., None], dist, float("inf"))
    best = torch.argmin(dist.flatten(-2), dim=-1)                 # first min
    best_dist = torch.gather(dist.flatten(-2), -1, best[..., None])[..., 0]
    best_h = torch.gather(h, -1, (best // _FEATURES)[..., None])[..., 0]
    return (best_h + best % _FEATURES) & _M32, best_dist


def _voronoi_rgb(p: Tensor, scale: Tensor, brightness: Tensor) -> Tensor:
    state, _ = voronoi_cell_feature(p, scale)
    state, r = _lcg_next(state)
    state, g = _lcg_next(state)
    _, b = _lcg_next(state)
    return torch.stack([r, g, b], dim=-1) * brightness[..., None]


def _point3(tc: Tensor, wpos: Tensor | None) -> Tensor:
    """The Voronoi evaluation point: the world position, else (u, v, 0)."""
    if wpos is not None:
        return wpos
    return torch.cat([tc, torch.zeros_like(tc[..., :1])], dim=-1)


def _checker_sel(tc: Tensor) -> Tensor:
    return torch.remainder((tc[..., 0] * 2).to(torch.int32)
                           + (tc[..., 1] * 2).to(torch.int32), 2)


# ---------------------------------------------------------------------------
# Spectrum textures
# ---------------------------------------------------------------------------

def eval_spectrum_texture(stex: SpectrumTextures, tex_id: Tensor,
                          uv: Tensor, wpos: Tensor | None = None) -> Tensor:
    """RGB mode: (R, S) per hit; tex_id -1 returns zero."""
    tid = torch.clamp(tex_id.to(torch.int64), 0, stex.kind.shape[0] - 1)
    kind = stex.kind[tid]
    tc = uv * stex.map_scale[tid] + stex.map_offset[tid]
    value = stex.value[tid]
    out = value                                            # CONST
    if stex.has_checker:
        checker = torch.where((_checker_sel(tc) == 0)[..., None], value,
                              stex.value2[tid])
        out = torch.where((kind == STexKind.CHECKER)[..., None], checker, out)
    if stex.images.shape[0] > 0:
        rgba = _image_fetch(stex.images, stex.image_hw, stex.image_id[tid],
                            tc[..., 0], tc[..., 1])
        out = torch.where((kind == STexKind.IMAGE)[..., None],
                          rgba[..., :3] * value, out)      # value: the scale
    if stex.has_voronoi and out.shape[-1] == 3:
        vor = _voronoi_rgb(_point3(tc, wpos), value[..., 0],
                           stex.value2[tid][..., 0])
        out = torch.where((kind == STexKind.VORONOI)[..., None], vor, out)
    return torch.where((tex_id >= 0)[..., None], out, 0.0)


def eval_spectrum_texture_spectral(stex: SpectrumTextures, tex_id: Tensor,
                                   uv: Tensor, lambdas: Tensor,
                                   wpos: Tensor | None = None) -> Tensor:
    """Spectral mode: per-wavelength samples (R, N). CONST and CHECKER rows
    hold Meng-Simon (u, v, scale) triples; CURVE rows interpolate their
    per-nm table (scale value[0]); IMAGE converts its texel's RGB and
    scales it by value[2]; VORONOI upsamples its cell colour."""
    from ..spectrum.spectral import WL_HI, WL_LO, rgb_to_spectrum, upsample_eval

    tid = torch.clamp(tex_id.to(torch.int64), 0, stex.kind.shape[0] - 1)
    kind = stex.kind[tid]
    tc = uv * stex.map_scale[tid] + stex.map_offset[tid]
    value = stex.value[tid]

    def upsample_uvs(uvs: Tensor) -> Tensor:
        return upsample_eval(uvs[..., 0], uvs[..., 1], uvs[..., 2], lambdas)

    if stex.has_const:
        out = upsample_uvs(value)                          # CONST
    else:
        out = torch.zeros(tid.shape + (lambdas.shape[-1],),
                          dtype=torch.float32, device=lambdas.device)
    if stex.has_checker:
        uvs = torch.where((_checker_sel(tc) == 0)[..., None], value,
                          stex.value2[tid])
        out = torch.where((kind == STexKind.CHECKER)[..., None],
                          upsample_uvs(uvs), out)
    k_n, g = stex.curves_v.shape
    if stex.has_curve and k_n > 0:
        cid = torch.clamp(stex.curve_id[tid].to(torch.int64), 0, k_n - 1)
        x = (lambdas - WL_LO) / (WL_HI - WL_LO) * (g - 1)
        xi = torch.clamp(x.to(torch.int64), 0, g - 2)
        frac = torch.clamp(x - xi, 0.0, 1.0)
        flat = stex.curves_v.reshape(-1)
        at = cid[..., None] * g + xi                       # (R, N)
        curve = flat[at] * (1.0 - frac) + flat[at + 1] * frac
        out = torch.where((kind == STexKind.CURVE)[..., None],
                          curve * value[..., 0:1], out)
    if stex.images.shape[0] > 0:
        rgba = _image_fetch(stex.images, stex.image_hw, stex.image_id[tid],
                            tc[..., 0], tc[..., 1])
        img = rgb_to_spectrum(rgba[..., :3], lambdas) * value[..., 2:3]
        out = torch.where((kind == STexKind.IMAGE)[..., None], img, out)
    if stex.has_voronoi:
        vor = rgb_to_spectrum(_voronoi_rgb(_point3(tc, wpos), value[..., 0],
                                           stex.value2[tid][..., 0]), lambdas)
        out = torch.where((kind == STexKind.VORONOI)[..., None], vor, out)
    return torch.where((tex_id >= 0)[..., None], out, 0.0)


def eval_stex(stex: SpectrumTextures, tex_id: Tensor, uv: Tensor,
              lambdas: Tensor | None = None,
              wpos: Tensor | None = None) -> Tensor:
    """Mode dispatch: RGB (S=3) or spectral (per-wavelength) evaluation."""
    if stex.spectral:
        if lambdas is None:
            raise ValueError("a spectral scene needs wavelength samples")
        return eval_spectrum_texture_spectral(stex, tex_id, uv, lambdas, wpos)
    return eval_spectrum_texture(stex, tex_id, uv, wpos)


# ---------------------------------------------------------------------------
# Float textures
# ---------------------------------------------------------------------------

def _eval_ftex_base(ftex: FloatTextures, tid: Tensor, uv: Tensor,
                    images: Tensor | None, image_hw: Tensor | None,
                    wpos: Tensor | None) -> Tensor:
    """The non-recursive float kinds at table rows `tid`."""
    kind = ftex.kind[tid]
    value = ftex.value[tid]
    value2 = ftex.value2[tid]
    tc = uv * ftex.map_scale[tid] + ftex.map_offset[tid]
    out = torch.where((kind == FTexKind.CHECKER)
                      & (_checker_sel(tc) != 0), value2, value)
    if ftex.has_image and images is not None and images.shape[0] > 0:
        rgba = _image_fetch(images, image_hw, ftex.image_id[tid], tc[..., 0],
                            tc[..., 1])
        lum = (0.2126 * rgba[..., 0] + 0.7152 * rgba[..., 1]
               + 0.0722 * rgba[..., 2])
        chan = torch.where(value2 >= 3.0, rgba[..., 3], lum)
        out = torch.where(kind == FTexKind.IMAGE, chan * value, out)
    if ftex.has_voronoi:
        seed, _ = voronoi_cell_feature(_point3(tc, wpos), value2)
        _, f = _lcg_next(seed)
        out = torch.where(kind == FTexKind.VORONOI, f * value, out)
    return out


def eval_float_texture(ftex: FloatTextures, tex_id: Tensor, uv: Tensor,
                       images: Tensor | None = None,
                       image_hw: Tensor | None = None,
                       wpos: Tensor | None = None) -> Tensor:
    """Float textures; tex_id (R,), -1 returns 0. Returns (R,). ONE_MINUS
    rows hold their source texture's id in image_id."""
    n = ftex.kind.shape[0]
    tid = torch.clamp(tex_id.to(torch.int64), 0, n - 1)
    out = _eval_ftex_base(ftex, tid, uv, images, image_hw, wpos)
    if ftex.has_one_minus:
        src = torch.clamp(ftex.image_id[tid].to(torch.int64), 0, n - 1)
        inv = 1.0 - _eval_ftex_base(ftex, src, uv, images, image_hw, wpos)
        out = torch.where(ftex.kind[tid] == FTexKind.ONE_MINUS, inv, out)
    return torch.where(tex_id >= 0, out, 0.0)


def eval_float_texture_default1(ftex: FloatTextures, tex_id: Tensor,
                                uv: Tensor, images: Tensor | None = None,
                                image_hw: Tensor | None = None,
                                wpos: Tensor | None = None) -> Tensor:
    """Like eval_float_texture but -1 means 1.0 (lobe weight default)."""
    v = eval_float_texture(ftex, tex_id, uv, images, image_hw, wpos)
    return torch.where(tex_id >= 0, v, 1.0)


# ---------------------------------------------------------------------------
# Normal maps
# ---------------------------------------------------------------------------

def _step(w: Tensor, hw: Tensor) -> Tensor:
    """One axis of the checker normal: +1 at the cell edge, -1 at its
    middle line, 0 elsewhere."""
    edge = (w < hw * 0.5) | (w > 1.0 - hw * 0.5)
    mid = (w > 0.5 - hw * 0.5) & (w < 0.5 + hw * 0.5)
    return torch.where(edge, 1.0, torch.where(mid, -1.0, 0.0))


def eval_normal_texture(ntex, images: Tensor, image_hw: Tensor,
                        tex_id: Tensor, uv: Tensor) -> Tensor:
    """Tangent-space normals (R, 3); tex_id -1 gives (0, 0, 1). Image maps
    decode rgb * 2 - 1; the checker makes step edges."""
    tid = torch.clamp(tex_id.to(torch.int64), 0, ntex.kind.shape[0] - 1)
    kind = ntex.kind[tid]
    tc = uv * ntex.map_scale[tid] + ntex.map_offset[tid]
    up = torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32,
                     device=uv.device)
    up[..., 2] = 1.0
    out = up
    if images.shape[0] > 0:
        rgba = _image_fetch(images, image_hw, ntex.image_id[tid], tc[..., 0],
                            tc[..., 1])
        n_img = rgba[..., :3] * 2.0 - 1.0
        n_img = n_img / torch.clamp(
            torch.sqrt((n_img * n_img).sum(-1, keepdim=True)), min=1e-6)
        out = torch.where((kind == NTexKind.IMAGE)[..., None], n_img, out)
    hw = ntex.step_width[tid] * 0.5
    wu = torch.fmod(tc[..., 0].abs(), 1.0)
    wv = torch.fmod(tc[..., 1].abs(), 1.0)
    ucomp = _step(wu, hw)
    vcomp = _step(wv, hw)
    ucomp = torch.where(wv > 0.5, -ucomp, ucomp)
    vcomp = torch.where(wu > 0.5, -vcomp, vcomp)
    rev = ntex.reverse[tid] > 0.5
    ucomp = torch.where(rev, -ucomp, ucomp)
    vcomp = torch.where(rev, -vcomp, vcomp)
    n_chk = torch.stack([ucomp, vcomp, torch.ones_like(ucomp)], dim=-1)
    n_chk = n_chk / torch.sqrt((n_chk * n_chk).sum(-1, keepdim=True))
    out = torch.where((kind == NTexKind.CHECKER)[..., None], n_chk, out)
    return torch.where((tex_id >= 0)[..., None], out, up)


def perturb_frame(sp, nlocal: Tensor):
    """Rebuild the shading frame from a tangent-space normal (bump
    mapping)."""
    from ..core.math3d import frame_from_local, normalize

    ex = torch.zeros_like(nlocal)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(nlocal)
    ey[..., 1] = 1.0
    t_local = ex - nlocal[..., 0:1] * nlocal
    b_local = ey - nlocal[..., 1:2] * nlocal
    fx, fy, fz = sp.tangent, sp.bitangent, sp.sn
    return sp._replace(tangent=normalize(frame_from_local(fx, fy, fz, t_local)),
                       bitangent=normalize(frame_from_local(fx, fy, fz,
                                                            b_local)),
                       sn=normalize(frame_from_local(fx, fy, fz, nlocal)))
