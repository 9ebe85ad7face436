"""Progressive photon mapping with adaptive-MCMC photon paths (counterpart
of slr_tpu/render/ppm.py): SPPM, and AMCMC-PPM with `use_mcmc`.

Each pass traces one eye ray per pixel through delta interactions to its
first non-delta surface (the hitpoint), traces a wave of photon paths, each
a pure function of one row of a primary-sample-space matrix, and gathers
the photons around each hitpoint from a uniform hash grid: photons sorted
by cell code (a stable sort, so that which photons of an overfull cell
count is fixed), and each hitpoint scans up to `k_per_cell` photons of
each of its 8 neighbour cells. Per-pixel statistics follow the SPPM rule
(alpha = 0.7): N' = N + a M, r2' = r2 N'/(N + M), tau' = (tau + sum fs phi)
r2'/r2. With `use_mcmc` a second wave of chains mutates its primary
samples with Hachisuka's power-law kernel, a visible uniform candidate
replaces its chain (replica exchange), and the mutation size follows the
measured uniform visibility rate.

Photon mapping is RGB here whatever the scene (s = 3), as in the
reference. A photon wave stops bouncing once no path is alive: later
bounces could deposit nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..accel.intersect import sample_triangle_point
from ..bsdf.bsdf import (
    bsdf_evaluate,
    bsdf_has_nondelta,
    bsdf_sample,
    emitted_radiance,
    gather_lobes,
)
from ..camera.perspective import sample_camera_rays
from ..core import rng
from ..core.device import resolve_device
from ..core.math3d import dot, frame_from_local, frame_to_local
from ..core.rng import Decision
from ..core.sampling import cosine_sample_hemisphere
from ..scene.types import FlatScene
from .pt import _select_light, resolve_sp, scene_intersect_alpha

Tensor = torch.Tensor

SPPM_ALPHA = 0.7          # progressive shrink rate (Hachisuka 2008)
MUTATE_S1 = 1.0 / 1024.0  # power-law mutation kernel bounds
MUTATE_S2 = 1.0 / 16.0
# Candidate rows evaluated at once in the gather: hitpoints x neighbour
# slots is cut into column blocks of at most this many rows.
GATHER_ROWS = 1 << 20


class HitPoints(NamedTuple):
    """Per-pixel measurement points."""

    p: Tensor          # (H, 3) world position
    tangent: Tensor    # (H, 3)
    bitangent: Tensor  # (H, 3)
    sn: Tensor         # (H, 3)
    gn: Tensor         # (H, 3)
    uv: Tensor         # (H, 2)
    mat_id: Tensor     # (H,) int64
    wo: Tensor         # (H, 3) world direction toward the camera
    alpha: Tensor      # (H, S) eye-path throughput
    direct: Tensor     # (H, S) emitter radiance seen directly
    valid: Tensor      # (H,) bool: landed on a non-delta surface


class PPMState(NamedTuple):
    """Progressive per-pixel statistics and the MCMC chains' state."""

    r2: Tensor             # (H,) gather radius^2
    n: Tensor              # (H,) accumulated photon count (fractional)
    tau: Tensor            # (H, S) accumulated unnormalized flux
    direct: Tensor         # (H, S) accumulated direct radiance
    n_emitted: Tensor      # () photon paths emitted
    chain_u: Tensor        # (C, D) primary sample of each chain
    chain_alive: Tensor    # (C,) bool: the chain holds a visible path
    mutation_size: Tensor  # () adaptive mutation size
    n_visible: Tensor      # () uniform candidates that were visible
    n_uniform: Tensor      # () uniform candidates tried


class Photons(NamedTuple):
    p: Tensor      # (P, 3) deposit position
    wi: Tensor     # (P, 3) world direction the photon arrived from
    power: Tensor  # (P, S) flux, divided by its pdfs
    valid: Tensor  # (P,) bool


def _pss_dims(max_bounces: int) -> int:
    # light select, position u, v, direction u, v + (comp, u, v, rr) per
    # bounce
    return 5 + 4 * max_bounces


def _trace_hitpoints(scene: FlatScene, width: int, height: int, seed,
                     iteration: int, spectral_s: int, max_specular: int = 4,
                     f_iter: Tensor | None = None) -> HitPoints:
    """One eye ray per pixel, followed through delta interactions to the
    first non-delta surface."""
    dev = scene.device
    n_pix = width * height
    pixel_id = torch.arange(n_pix, device=dev)
    sample_id = rng.u32(iteration)

    def u(bounce, decision):
        return rng.uniform(seed, pixel_id, sample_id, bounce, decision)

    jx, jy = u(0, Decision.PIXEL_X), u(0, Decision.PIXEL_Y)
    lu, lv = u(0, Decision.LENS_U), u(0, Decision.LENS_V)
    px = (pixel_id % width).to(torch.float32) + jx
    py = (pixel_id // width).to(torch.float32) + jy
    rays = sample_camera_rays(scene.camera, px, py, width, height, lu, lv)

    o, d = rays.o, rays.d
    alpha = torch.ones((n_pix, spectral_s), device=dev) * rays.weight[:, None]
    direct = torch.zeros((n_pix, spectral_s), device=dev)
    settled = torch.zeros((n_pix,), dtype=torch.bool, device=dev)
    f_px = None if f_iter is None else torch.broadcast_to(f_iter, (n_pix,))
    hit = scene_intersect_alpha(scene, o, d, f=f_px)
    sp = resolve_sp(scene, hit, o, d, f=f_px)
    le = emitted_radiance(scene, sp.mat_id, sp.uv, dot(-d, sp.sn), None)
    direct = direct + torch.where(hit.mask[:, None], alpha * le, 0.0)
    alive = hit.mask
    wo_world = -d
    zero_hero = torch.zeros((n_pix,), dtype=torch.int64, device=dev)
    no_sel = torch.zeros((n_pix,), dtype=torch.bool, device=dev)

    for b in range(max_specular):
        lobes = gather_lobes(scene, sp.mat_id, sp.uv, sp.p, None)
        nondelta = bsdf_has_nondelta(lobes)
        # Lanes on a non-delta surface settle here; pure-delta lanes extend.
        settle_now = alive & nondelta & ~settled
        settled = settled | settle_now
        extend = alive & ~settled

        fx, fy, fz = sp.tangent, sp.bitangent, sp.sn
        wo = frame_to_local(fx, fy, fz, wo_world)
        gn_sn = frame_to_local(fx, fy, fz, sp.gn)
        smp = bsdf_sample(lobes, wo, gn_sn, zero_hero, no_sel,
                          u(b + 1, Decision.BSDF_COMPONENT),
                          u(b + 1, Decision.BSDF_U),
                          u(b + 1, Decision.BSDF_V))
        cos_i = dot(smp.wi, gn_sn).abs()
        w = smp.fs * (cos_i / torch.clamp(smp.pdf, min=1e-30))[:, None]
        new_d = frame_from_local(fx, fy, fz, smp.wi)
        ok = extend & (smp.pdf > 0)

        new_hit = scene_intersect_alpha(scene, sp.p, new_d, f=f_px, active=ok)
        new_sp = resolve_sp(scene, new_hit, sp.p, new_d, f=f_px)
        le2 = emitted_radiance(scene, new_sp.mat_id, new_sp.uv,
                               dot(-new_d, new_sp.sn), None)
        step = ok & new_hit.mask
        direct = direct + torch.where(step[:, None], alpha * w * le2, 0.0)
        alpha = torch.where(step[:, None], alpha * w, alpha)
        wo_world = torch.where(step[:, None], -new_d, wo_world)
        sp = type(sp)(*(torch.where(
            step.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
            for new, old in zip(new_sp, sp)))
        alive = torch.where(extend, step, alive)

    return HitPoints(p=sp.p, tangent=sp.tangent, bitangent=sp.bitangent,
                     sn=sp.sn, gn=sp.gn, uv=sp.uv, mat_id=sp.mat_id,
                     wo=wo_world, alpha=alpha, direct=direct, valid=settled)


def _trace_photons_pss(scene: FlatScene, u: Tensor, spectral_s: int,
                       max_bounces: int,
                       f_iter: Tensor | None = None) -> Photons:
    """One photon path per row of the primary-sample matrix `u` (P, D),
    depositing at every non-delta surface hit; deterministic in `u`, as MCMC
    in primary sample space needs. Deposits are stacked bounce-major
    ((bounces * P,), row b * P + path), up to the last bounce with a live
    path."""
    p_cnt = u.shape[0]
    dev = u.device
    tri, light_prob, _ = _select_light(scene, u[:, 0])
    lp = sample_triangle_point(scene.geometry, tri, u[:, 1], u[:, 2])
    # The diffuse EDF: Le = emittance / pi, a cosine-sampled direction.
    le = emitted_radiance(scene, lp.mat_id, lp.uv,
                          torch.ones((p_cnt,), device=dev), None)
    wi_local = cosine_sample_hemisphere(u[:, 3], u[:, 4])
    dir_pdf = torch.clamp(wi_local[..., 2], min=1e-8) / math.pi
    d = frame_from_local(lp.tangent, lp.bitangent, lp.sn, wi_local)
    pos_pdf = light_prob * lp.area_pdf
    power = le * (wi_local[..., 2]
                  / torch.clamp(pos_pdf * dir_pdf, min=1e-30))[:, None]
    o = lp.p
    alive = pos_pdf > 0

    deposits = []
    f_p = None if f_iter is None else torch.broadcast_to(f_iter, (p_cnt,))
    zero_hero = torch.zeros((p_cnt,), dtype=torch.int64, device=dev)
    no_sel = torch.zeros((p_cnt,), dtype=torch.bool, device=dev)
    for b in range(max_bounces):
        if b > 0 and not bool(alive.any()):
            break
        hit = scene_intersect_alpha(scene, o, d, f=f_p, active=alive)
        sp = resolve_sp(scene, hit, o, d, f=f_p)
        ok = alive & hit.mask
        lobes = gather_lobes(scene, sp.mat_id, sp.uv, sp.p, None)
        deposit = ok & bsdf_has_nondelta(lobes)
        deposits.append(Photons(
            p=sp.p, wi=-d, power=torch.where(deposit[:, None], power, 0.0),
            valid=deposit))

        base = 5 + 4 * b
        fx, fy, fz = sp.tangent, sp.bitangent, sp.sn
        wo = frame_to_local(fx, fy, fz, -d)
        gn_sn = frame_to_local(fx, fy, fz, sp.gn)
        smp = bsdf_sample(lobes, wo, gn_sn, zero_hero, no_sel, u[:, base],
                          u[:, base + 1], u[:, base + 2])
        cos_i = dot(smp.wi, gn_sn).abs()
        # Adjoint transport along light paths: the shading-normal
        # correction moves from wi (the sampler's) to wo. The sampled fs
        # keeps delta lobes (caustics) alive.
        corr_wi = smp.wi[..., 2].abs() / torch.clamp(
            dot(smp.wi, gn_sn).abs(), min=1e-6)
        corr_wo = wo[..., 2].abs() / torch.clamp(dot(wo, gn_sn).abs(),
                                                 min=1e-6)
        fs_adj = smp.fs * (corr_wo / torch.clamp(corr_wi, min=1e-6))[:, None]
        w = fs_adj * (cos_i / torch.clamp(smp.pdf, min=1e-30))[:, None]
        # Russian roulette on the mean throughput ratio.
        cont = torch.clamp(w.mean(-1), max=1.0)
        survive = u[:, base + 3] < cont
        power = power * w / torch.clamp(cont, min=1e-30)[:, None]
        alive = ok & (smp.pdf > 0) & survive
        o = sp.p
        d = frame_from_local(fx, fy, fz, smp.wi)

    return Photons(*(torch.cat(xs) for xs in zip(*deposits)))


def _cell_code(p: Tensor, origin: Tensor, inv_cell: Tensor,
               res: int) -> Tensor:
    """Hash-grid cell id (flattened 3D index, clamped to the grid)."""
    c = torch.clamp(((p - origin) * inv_cell).to(torch.int32), 0, res - 1)
    c = c.to(torch.int64)
    return (c[..., 0] * res + c[..., 1]) * res + c[..., 2]


def _gather(scene: FlatScene, hp: HitPoints, ph: Photons, r2: Tensor,
            cell, res: int, k_per_cell: int, spectral_s: int):
    """Photon gathering: photons sorted by cell (stable); each hitpoint
    scans up to k_per_cell photons of each of its 8 neighbour cells (cells
    are at least 2r wide, so the ball of radius r meets at most 8).
    Returns (flux (H, S), m_count (H,), visible (P,) bool: the photon was
    gathered by some hitpoint)."""
    origin, inv_cell = cell
    h_cnt = hp.p.shape[0]
    dev = hp.p.device

    codes = _cell_code(ph.p, origin, inv_cell, res)
    codes = torch.where(ph.valid, codes, res * res * res)   # invalid: last
    order = torch.argsort(codes, stable=True)
    codes_s = codes[order]
    ph_p, ph_wi, ph_power, ph_valid = (x[order] for x in
                                       (ph.p, ph.wi, ph.power, ph.valid))

    # Neighbour cells: floor((p - r) / cell) .. +1 on each axis.
    lo = torch.clamp(((hp.p - torch.sqrt(r2)[:, None] - origin) * inv_cell)
                     .to(torch.int32), 0, res - 1).to(torch.int64)
    fx, fy, fz = hp.tangent, hp.bitangent, hp.sn
    wo_l = frame_to_local(fx, fy, fz, hp.wo)
    gn_l = frame_to_local(fx, fy, fz, hp.gn)
    lobes = gather_lobes(scene, hp.mat_id, hp.uv, hp.p, None)

    offs = torch.tensor([(dx, dy, dz) for dx in range(2) for dy in range(2)
                         for dz in range(2)], dtype=torch.int64, device=dev)
    cells = torch.clamp(lo[:, None, :] + offs[None], max=res - 1)  # (H, 8, 3)
    cc = (cells[..., 0] * res + cells[..., 1]) * res + cells[..., 2]
    # At the grid's border clamped neighbours can alias one cell; visit its
    # first occurrence only, so that no photon counts twice.
    first = torch.ones_like(cc, dtype=torch.bool)
    for k in range(1, 8):
        first[:, k] = ~(cc[:, k:k + 1] == cc[:, :k]).any(1)
    cc = torch.where(first, cc, -1)          # -1 matches no photon code
    start = torch.searchsorted(codes_s, cc)  # (H, 8)
    n_ph = codes_s.shape[0]
    cand = torch.clamp(start[..., None]
                       + torch.arange(k_per_cell, device=dev),
                       max=n_ph - 1).reshape(h_cnt, 8 * k_per_cell)
    cc_rep = cc.repeat_interleave(k_per_cell, dim=-1)        # (H, 8K)

    # The candidate columns in blocks of at most GATHER_ROWS rows.
    n_col = 8 * k_per_cell
    step = max(1, min(n_col, GATHER_ROWS // max(h_cnt, 1)))
    flux = torch.zeros((h_cnt, spectral_s), device=dev)
    m_count = torch.zeros((h_cnt,), dtype=torch.int64, device=dev)
    visible = torch.zeros((ph.p.shape[0],), dtype=torch.int32, device=dev)
    hero0 = torch.zeros((h_cnt,), dtype=torch.int64, device=dev)
    for c0 in range(0, n_col, step):
        c1 = min(c0 + step, n_col)
        nc = c1 - c0
        idx = cand[:, c0:c1].T.reshape(-1)                    # column-major
        code = cc_rep[:, c0:c1].T.reshape(-1)

        def rep(x):
            return x.repeat((nc,) + (1,) * (x.dim() - 1))

        in_cell = codes_s[idx] == code
        dpp_ = ph_p[idx] - rep(hp.p)
        d2 = dot(dpp_, dpp_)
        near = in_cell & (d2 < rep(r2)) & rep(hp.valid) & ph_valid[idx]
        wi_l = frame_to_local(rep(fx), rep(fy), rep(fz), ph_wi[idx])
        lob = dataclasses.replace(lobes, **{
            f.name: rep(getattr(lobes, f.name))
            for f in dataclasses.fields(lobes) if f.name != "kinds"})
        fs = bsdf_evaluate(lob, rep(wo_l), wi_l, rep(gn_l), rep(hero0))
        contrib = torch.where(near[:, None], fs * ph_power[idx], 0.0)
        flux = flux + contrib.reshape(nc, h_cnt, spectral_s).sum(0)
        m_count = m_count + near.reshape(nc, h_cnt).sum(0)
        visible.scatter_reduce_(0, order[idx], near.to(torch.int32), "amax")
    return flux, m_count.to(torch.float32), visible > 0


def _mutate_pss(u: Tensor, size: Tensor, xi: Tensor,
                sign_u: Tensor) -> Tensor:
    """Hachisuka's power-law primary-sample mutation:
    du = +- s2 exp(-log(s2 / s1) xi), scaled by the adaptive mutation
    size; the result wraps around [0, 1)."""
    du = size * MUTATE_S2 * torch.exp(-math.log(MUTATE_S2 / MUTATE_S1) * xi)
    v = u + torch.where(sign_u < 0.5, du, -du)
    return v - torch.floor(v)


def _pss_matrix(seed_add: int, stride: int, decision, seed, iteration: int,
                n_paths: int, d_dim: int, dev) -> Tensor:
    """(P, D) uniforms: column c is rng.uniform(seed + seed_add, path,
    iteration + c * stride, c, decision), the sums taken mod 2^32."""
    pid = torch.arange(n_paths, device=dev)[None, :]
    cols = torch.arange(d_dim, device=dev)[:, None]
    sample = rng.u32(rng.u32(iteration) + rng.mul32(cols, stride))
    return rng.uniform(rng.u32(seed + seed_add), pid, sample, cols,
                       decision).T.contiguous()


def ppm_iteration(scene: FlatScene, state: PPMState, width: int,
                  height: int, iteration: int, seed, n_photon_paths: int,
                  max_bounces: int, grid_res: int, k_per_cell: int,
                  use_mcmc: bool) -> PPMState:
    """One progressive pass: hitpoints, a photon wave (uniform, and the
    chains with `use_mcmc`), the gather, and the per-pixel update."""
    s = 3   # photon mapping is RGB
    dev = scene.device
    seed = rng.u32(seed)
    # One shutter time per pass: hitpoints and photons of a wave see the
    # same scene; the passes integrate the shutter.
    f_iter = (rng.uniform(seed, 0, torch.full((), iteration, device=dev),
                          0, Decision.TIME)
              if scene.instances is not None else None)
    hp = _trace_hitpoints(scene, width, height, seed, iteration, s,
                          f_iter=f_iter)

    # --- photon primary samples -----------------------------------------
    d_dim = _pss_dims(max_bounces)
    args = (seed, iteration, n_photon_paths, d_dim, dev)
    u_uniform = _pss_matrix(7, 131071, Decision.BSDF_U, *args)
    if use_mcmc:
        xi = _pss_matrix(11, 999983, Decision.BSDF_V, *args)
        sg = _pss_matrix(13, 57331, Decision.RR, *args)
        u_chain = _mutate_pss(state.chain_u, state.mutation_size, xi, sg)
        u_all = torch.cat([u_uniform, u_chain])
    else:
        u_all = u_uniform
    ph = _trace_photons_pss(scene, u_all, s, max_bounces, f_iter=f_iter)

    # --- hash grid over the current radii ---------------------------------
    r_max = torch.sqrt(torch.where(hp.valid, state.r2, 0.0).max())
    world_lo = hp.p.amin(0) - r_max
    world_hi = hp.p.amax(0) + r_max
    cell_sz = torch.maximum(2.0 * r_max, (world_hi - world_lo).max()
                            / grid_res)
    inv_cell = 1.0 / torch.clamp(cell_sz, min=1e-12)
    cell = (world_lo, torch.broadcast_to(inv_cell, (3,)))
    flux, m, visible = _gather(scene, hp, ph, state.r2, cell, grid_res,
                               k_per_cell, s)
    n_paths_total = u_all.shape[0]

    # --- SPPM statistics --------------------------------------------------
    new_n = state.n + SPPM_ALPHA * m
    shrink = torch.where(m > 0, new_n / torch.clamp(state.n + m, min=1e-12),
                         1.0)
    new_r2 = state.r2 * shrink
    new_tau = (state.tau + hp.alpha * flux) * shrink[:, None]
    new_direct = state.direct + hp.direct
    n_emitted = state.n_emitted + float(n_paths_total)

    # --- MCMC bookkeeping ---------------------------------------------------
    if use_mcmc:
        # Photon -> path visibility (deposits are bounce-major copies of the
        # path axis).
        vis_per_path = visible.reshape(-1, n_paths_total).any(0)
        uni_vis = vis_per_path[:n_photon_paths]
        chain_vis = vis_per_path[n_photon_paths:]
        # Replica exchange: a visible uniform candidate replaces the chain.
        new_chain_u = torch.where(uni_vis[:, None], u_uniform,
                                  torch.where(chain_vis[:, None], u_chain,
                                              state.chain_u))
        new_alive = uni_vis | chain_vis | state.chain_alive
        n_vis = state.n_visible + uni_vis.sum()
        n_uni = state.n_uniform + n_photon_paths
        # The mutation size moves toward the uniform visibility ratio.
        ratio = n_vis / torch.clamp(n_uni, min=1.0)
        accept = chain_vis.to(torch.float32).mean()
        new_size = torch.clamp(
            state.mutation_size + (accept - ratio) / (float(iteration) + 1.0),
            1e-4, 1.0)
    else:
        new_chain_u = state.chain_u
        new_alive = state.chain_alive
        n_vis = state.n_visible
        n_uni = state.n_uniform
        new_size = state.mutation_size

    return PPMState(r2=new_r2, n=new_n, tau=new_tau, direct=new_direct,
                    n_emitted=n_emitted, chain_u=new_chain_u,
                    chain_alive=new_alive, mutation_size=new_size,
                    n_visible=n_vis, n_uniform=n_uni)


def init_state(scene: FlatScene, width: int, height: int, r0: float,
               n_chains: int, max_bounces: int) -> PPMState:
    dev = scene.device
    n_pix = width * height
    d_dim = _pss_dims(max_bounces)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return PPMState(
        r2=torch.full((n_pix,), r0 * r0, dtype=torch.float32, device=dev),
        n=zeros(n_pix), tau=zeros(n_pix, 3), direct=zeros(n_pix, 3),
        n_emitted=zeros(),
        chain_u=torch.full((n_chains, d_dim), 0.5, device=dev),
        chain_alive=torch.zeros((n_chains,), dtype=torch.bool, device=dev),
        mutation_size=torch.ones((), device=dev), n_visible=zeros(),
        n_uniform=zeros())


def develop_ppm(state: PPMState, width: int, height: int,
                n_iterations: int) -> Tensor:
    """Radiance: L = tau / (N_emitted pi r^2) + direct / iterations."""
    indirect = state.tau / torch.clamp(
        state.n_emitted * math.pi * state.r2[:, None], min=1e-12)
    direct = state.direct / max(n_iterations, 1)
    return (indirect + direct).reshape(height, width, 3)


def render_ppm(scene: FlatScene, width: int, height: int,
               n_iterations: int = 8, n_photon_paths: int = 4096,
               max_bounces: int = 4, seed: int = 0, r0: float | None = None,
               grid_res: int = 64, k_per_cell: int = 8,
               use_mcmc: bool = False, device=None,
               return_state: bool = False):
    """Full progressive render -> (H, W, 3) linear radiance on `device`
    (default: the CUDA device); with `return_state`, (image, final
    PPMState). `use_mcmc` adds the adaptive-MCMC chain wave (twice the
    photon paths per pass)."""
    scene = scene.to(resolve_device(device))
    if r0 is None:
        # About 2.5 pixel footprints at the world's scale.
        r0 = float(scene.world_radius) * 2.5 / max(width, height)
    state = init_state(scene, width, height, r0, n_photon_paths, max_bounces)
    for i in range(n_iterations):
        state = ppm_iteration(scene, state, width, height, i, seed,
                              n_photon_paths, max_bounces, grid_res,
                              k_per_cell, use_mcmc)
    img = develop_ppm(state, width, height, n_iterations)
    return (img, state) if return_state else img
