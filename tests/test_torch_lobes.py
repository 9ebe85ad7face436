"""The lobe kinds of the rest of the shading (FLIPPED_LAMBERT, OREN_NAYAR,
MICROFACET_REFLECTION, MICROFACET_SCATTERING, WARD, ASHIKHMIN) against
slr_tpu.bsdf: each kind's own eval, pdf, weight and sample on seeded random
(wo, wi, u), in RGB (S=3) and spectral (S=16, a hero wavelength) mode; then
the aggregate bsdf_evaluate, bsdf_pdf and bsdf_sample on a material of each
kind and on a batch whose rows mix kinds across four lobes.

Tolerance: evaluations at given directions within rtol 1e-5, atol 1e-6 on
every value; booleans exactly. Samples go through sin, cos, atan2, acos and
tan, whose XLA and libm results differ by an ulp (GGX's visible normal m
to ~1e-7); the pdf and fs at m amplify that by the distribution's slope
(up to ~1e-4 relative at alpha 0.05), near grazing angles sqrt(1 - x^2)
does (a sampled direction's component to ~5e-5): of the sampled values
99% lie within rtol 1e-4, atol 1e-6 and all within rtol 1e-3, atol 1e-4. The same values at the same m or direction
agree to 2e-7. Samples where either side's pdf is 0 carry no contribution
and are compared only through that zero."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr_tpu.bsdf import bsdf as jb
from slr_tpu.bsdf import lobes as jlobes
from slr_tpu.bsdf.lobes import LobeBatch as JLobes
from slr_tpu.scene.types import LobeKind
from slr_tpu_torch.bsdf import bsdf as tb
from slr_tpu_torch.bsdf import lobes as tlobes
from slr_tpu_torch.bsdf.lobes import LobeBatch as TLobes

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 512
KINDS = (LobeKind.FLIPPED_LAMBERT, LobeKind.OREN_NAYAR,
         LobeKind.MICROFACET_REFLECTION, LobeKind.MICROFACET_SCATTERING,
         LobeKind.WARD, LobeKind.ASHIKHMIN)


def _unit(rs, n, z_sign=None):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    if z_sign is not None:
        v[:, 2] = np.abs(v[:, 2]) * z_sign
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _params(kind, rs, shape, s):
    """(s0, s1, s2, f0, f1) of a lobe of `kind`, shape + (S,) / shape."""
    def u(lo, hi, sh):
        return rs.uniform(lo, hi, sh).astype(np.float32)

    sp, fl = shape + (s,), shape
    s0, s1, s2 = u(0.05, 0.95, sp), u(0.05, 0.95, sp), u(0.05, 0.95, sp)
    f0, f1 = u(0.0, 1.0, fl), u(0.0, 1.0, fl)
    if kind == LobeKind.MICROFACET_REFLECTION:       # conductor eta, k
        s1, s2, f0 = u(0.5, 2.0, sp), u(3.0, 8.0, sp), u(0.05, 0.6, fl)
    elif kind == LobeKind.MICROFACET_SCATTERING:     # eta_ext, eta_int
        s1, s2, f0 = u(1.0, 1.001, sp), u(1.45, 1.6, sp), u(0.05, 0.6, fl)
    elif kind == LobeKind.WARD:                      # alpha_x, alpha_y
        f0, f1 = u(0.02, 0.5, fl), u(0.02, 0.5, fl)
    elif kind == LobeKind.ASHIKHMIN:                 # Rs, Rd, nu, nv
        f0, f1 = u(1.0, 1000.0, fl), u(1.0, 1000.0, fl)
    return s0, s1, s2, f0, f1


def _batches(kind_a, params, kinds):
    s0, s1, s2, f0, f1 = params
    jl = JLobes(kind=jnp.asarray(kind_a), s0=jnp.asarray(s0),
                s1=jnp.asarray(s1), s2=jnp.asarray(s2), f0=jnp.asarray(f0),
                f1=jnp.asarray(f1), kinds=kinds)
    tl = TLobes(kind=torch.as_tensor(kind_a).long(), s0=torch.as_tensor(s0),
                s1=torch.as_tensor(s1), s2=torch.as_tensor(s2),
                f0=torch.as_tensor(f0), f1=torch.as_tensor(f1), kinds=kinds)
    return jl, tl


def _inputs(kind, s, seed, lobes=1):
    rs = np.random.RandomState(seed)
    kind_a = np.full((N, lobes), int(kind), np.int32)
    jl, tl = _batches(kind_a, _params(kind, rs, (N, lobes), s),
                      (int(kind),))
    gn = _unit(rs, N, z_sign=1.0) * 0.3 + np.float32([0, 0, 1])
    host = dict(wo=_unit(rs, N), wi=_unit(rs, N),
                gn=gn / np.linalg.norm(gn, axis=1, keepdims=True),
                hero=rs.randint(0, s, N), wl_sel=rs.rand(N) < 0.3,
                u=rs.uniform(0, 1, (4, N)).astype(np.float32))
    return jl, tl, host


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(x)


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), RTOL, ATOL,
                               err_msg=name)


def _close_sampled(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, 1e-3, 1e-4, err_msg=name)
    tight = np.abs(got - want) <= ATOL + 1e-4 * np.abs(want)
    assert tight.mean() >= 0.99, (name, tight.mean())


def _squeeze(lb, cls, arr):
    """The (N, 1) batch as an (N,) one for the per-kind functions."""
    return cls(kind=arr(lb.kind)[:, 0], s0=arr(lb.s0)[:, 0],
               s1=arr(lb.s1)[:, 0], s2=arr(lb.s2)[:, 0], f0=arr(lb.f0)[:, 0],
               f1=arr(lb.f1)[:, 0], kinds=lb.kinds)


_EVAL = {LobeKind.FLIPPED_LAMBERT: "flipped_lambert",
         LobeKind.OREN_NAYAR: "oren_nayar",
         LobeKind.MICROFACET_REFLECTION: "microfacet_reflection",
         LobeKind.MICROFACET_SCATTERING: "microfacet_scattering",
         LobeKind.WARD: "ward", LobeKind.ASHIKHMIN: "ashikhmin"}


@pytest.mark.parametrize("s", [3, 16], ids=["rgb", "spectral"])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.name)
def test_lobe_functions(kind, s):
    """The kind's own eval, pdf, weight and sample (no aggregate)."""
    jl2, tl2, h = _inputs(kind, s, seed=int(kind) * 7 + s)
    jl = _squeeze(jl2, JLobes, lambda a: a)
    tl = _squeeze(tl2, TLobes, lambda a: a)
    name = _EVAL[kind]
    wo_j, wi_j, wo_t, wi_t = _j(h["wo"]), _j(h["wi"]), _t(h["wo"]), _t(h["wi"])
    hero_j, hero_t = _j(h["hero"]), _t(h["hero"])
    _close(getattr(tlobes, name + "_eval")(tl, wo_t, wi_t),
           getattr(jlobes, name + "_eval")(jl, wo_j, wi_j), "eval")
    if kind == LobeKind.MICROFACET_SCATTERING:
        _close(tlobes.microfacet_scattering_eval(tl, wo_t, wi_t, adjoint=True),
               jlobes.microfacet_scattering_eval(jl, wo_j, wi_j, adjoint=True),
               "eval adjoint")
    pdf_args = (hero_t,) if kind in (LobeKind.MICROFACET_SCATTERING,
                                     LobeKind.ASHIKHMIN) else ()
    if kind != LobeKind.OREN_NAYAR:           # Oren-Nayar uses Lambert's pdf
        _close(getattr(tlobes, name + "_pdf")(tl, wo_t, wi_t, *pdf_args),
               getattr(jlobes, name + "_pdf")(
                   jl, wo_j, wi_j, *(hero_j,) * len(pdf_args)), "pdf")
    if kind in (LobeKind.MICROFACET_REFLECTION,
                LobeKind.MICROFACET_SCATTERING):
        _close(tlobes.microfacet_reflection_weight(tl, wo_t, hero_t),
               jlobes.microfacet_reflection_weight(jl, wo_j, hero_j), "weight")
    if kind == LobeKind.ASHIKHMIN:
        for got, want in zip(tlobes.ashikhmin_weights(tl, wo_t, hero_t),
                             jlobes._ashikhmin_weights(jl, wo_j, hero_j)):
            _close(got, want, "weights")

    u = h["u"]
    front_j, front_t = _j(h["wo"][:, 2] > 0), _t(h["wo"][:, 2] > 0)
    args = {
        LobeKind.FLIPPED_LAMBERT: lambda w, f, hr, uc, a, b: (w, f, a, b),
        LobeKind.OREN_NAYAR: lambda w, f, hr, uc, a, b: (w, f, a, b),
        LobeKind.MICROFACET_REFLECTION: lambda w, f, hr, uc, a, b: (w, a, b),
        LobeKind.MICROFACET_SCATTERING:
            lambda w, f, hr, uc, a, b: (w, hr, uc, a, b),
        LobeKind.WARD: lambda w, f, hr, uc, a, b: (w, a, b),
        LobeKind.ASHIKHMIN: lambda w, f, hr, uc, a, b: (w, f, hr, uc, a, b),
    }[kind]
    ref = getattr(jlobes, name + "_sample")(
        jl, *args(wo_j, front_j, hero_j, _j(u[0]), _j(u[1]), _j(u[2])))
    out = getattr(tlobes, name + "_sample")(
        tl, *args(wo_t, front_t, hero_t, _t(u[0]), _t(u[1]), _t(u[2])))
    for field in ("is_delta", "is_transmission"):
        np.testing.assert_array_equal(getattr(out, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    live = (np.asarray(ref.pdf) > 0) & (out.pdf.numpy() > 0)
    assert live.mean() > 0.3
    np.testing.assert_array_equal(np.asarray(ref.pdf) > 0,
                                  out.pdf.numpy() > 0)
    for field in ("wi", "pdf", "fs"):
        _close_sampled(getattr(out, field).numpy()[live],
                       np.asarray(getattr(ref, field))[live], field)


def _aggregate_checks(jl, tl, h):
    args_j = (_j(h["wo"]), _j(h["wi"]), _j(h["gn"]), _j(h["hero"]))
    args_t = (_t(h["wo"]), _t(h["wi"]), _t(h["gn"]), _t(h["hero"]))
    _close(tb.bsdf_evaluate(tl, *args_t), jb.bsdf_evaluate(jl, *args_j),
           "evaluate")
    _close(tb.bsdf_evaluate(tl, *args_t, adjoint=True),
           jb.bsdf_evaluate(jl, *args_j, adjoint=True), "evaluate adjoint")
    _close(tb.bsdf_pdf(tl, *args_t), jb.bsdf_pdf(jl, *args_j), "pdf")
    _close(tb.lobe_weights(tl, args_t[0], args_t[3]),
           jb.lobe_weights(jl, args_j[0], args_j[3]), "weights")
    np.testing.assert_array_equal(tb.bsdf_has_nondelta(tl).numpy(),
                                  np.asarray(jb.bsdf_has_nondelta(jl)))
    u = h["u"]
    for adjoint in (False, True):
        ref = jb.bsdf_sample(jl, _j(h["wo"]), _j(h["gn"]), _j(h["hero"]),
                             _j(h["wl_sel"]), _j(u[0]), _j(u[1]), _j(u[2]),
                             adjoint=adjoint)
        out = tb.bsdf_sample(tl, _t(h["wo"]), _t(h["gn"]), _t(h["hero"]),
                             _t(h["wl_sel"]), _t(u[0]), _t(u[1]), _t(u[2]),
                             adjoint=adjoint)
        for field in ("is_delta", "dispersive"):
            np.testing.assert_array_equal(getattr(out, field).numpy(),
                                          np.asarray(getattr(ref, field)))
        live = (np.asarray(ref.pdf) > 0) | (out.pdf.numpy() > 0)
        assert live.mean() > 0.3
        for field in ("wi", "fs", "pdf", "rev_pdf", "rev_fs"):
            _close_sampled(getattr(out, field).numpy()[live],
                   np.asarray(getattr(ref, field))[live],
                   f"sample {field} adjoint={adjoint}")


@pytest.mark.parametrize("s", [3, 16], ids=["rgb", "spectral"])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.name)
def test_material_of_each_kind(kind, s):
    """bsdf_evaluate (radiance and adjoint), bsdf_pdf, the lobe weights and
    bsdf_sample on a one-lobe material of the kind."""
    jl, tl, h = _inputs(kind, s, seed=int(kind) * 11 + s + 1)
    _aggregate_checks(jl, tl, h)


@pytest.mark.parametrize("s", [3, 16], ids=["rgb", "spectral"])
def test_rows_mixing_every_kind(s):
    """Four lobes a row, each of a random kind of all nine, with mixed
    materials' weights folded into s0: the dispatch selects per lobe."""
    rs = np.random.RandomState(100 + s)
    every = (LobeKind.LAMBERT, LobeKind.SPECULAR_REFLECTION,
             LobeKind.SPECULAR_SCATTERING) + KINDS
    kind_a = np.asarray(every, np.int32)[rs.randint(0, len(every), (N, 4))]
    kind_a[:, 3] = np.where(rs.rand(N) < 0.3, 0, kind_a[:, 3])  # NONE slots
    params = [np.zeros((N, 4, s), np.float32)] * 3 + \
        [np.zeros((N, 4), np.float32)] * 2
    for k in every:
        mask = kind_a == int(k)
        params = [np.where(mask[..., None] if p.ndim == 3 else mask, q, p)
                  for p, q in zip(params, _params(k, rs, (N, 4), s))]
    params[0] = params[0] * rs.uniform(0.2, 1.0, (N, 4, 1)).astype(np.float32)
    kinds = tuple(sorted(int(k) for k in every))
    jl, tl = _batches(kind_a, params, kinds)
    _, _, h = _inputs(LobeKind.LAMBERT, s, seed=200 + s)
    _aggregate_checks(jl, tl, h)
