"""BSDF lobes of the first slice (LAMBERT, SPECULAR_REFLECTION,
SPECULAR_SCATTERING) against slr_tpu.bsdf: evaluate, pdf and sample on
random (wo, wi, u), in spectral (S=16) and RGB (S=3) mode. The other kinds
are held in test_torch_lobes.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr_tpu.bsdf import bsdf as jb
from slr_tpu.bsdf.lobes import LobeBatch as JLobes
from slr_tpu.scene.types import LobeKind
from slr_tpu_torch.bsdf import bsdf as tb
from slr_tpu_torch.bsdf.lobes import LobeBatch as TLobes

torch.set_num_threads(1)

# Same f32 formulas in both packages; reductions over the spectral axis
# (importance) and the transcendental functions may round differently by a
# few ulp, which the 1/cos and Fresnel divisions amplify slightly.
RTOL, ATOL = 2e-5, 1e-6
N = 256
KINDS = (LobeKind.LAMBERT, LobeKind.SPECULAR_REFLECTION,
         LobeKind.SPECULAR_SCATTERING)


def _unit(rs, n, z_sign=None):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    if z_sign is not None:
        v[:, 2] = np.abs(v[:, 2]) * z_sign
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _inputs(kind, s, seed):
    rs = np.random.RandomState(seed)
    s0 = rs.uniform(0.05, 1.0, (N, 1, s)).astype(np.float32)
    if kind == LobeKind.SPECULAR_REFLECTION:        # conductor eta, k
        s1 = rs.uniform(0.5, 2.0, (N, 1, s)).astype(np.float32)
        s2 = rs.uniform(3.0, 8.0, (N, 1, s)).astype(np.float32)
    else:                                          # dielectric eta_ext, eta_int
        s1 = rs.uniform(1.0, 1.001, (N, 1, s)).astype(np.float32)
        s2 = rs.uniform(1.45, 1.6, (N, 1, s)).astype(np.float32)
    f = np.zeros((N, 1), np.float32)
    wo = _unit(rs, N)
    wi = _unit(rs, N)
    gn = _unit(rs, N, z_sign=1.0) * 0.3 + np.float32([0, 0, 1])
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    hero = rs.randint(0, s, N)
    wl_sel = rs.rand(N) < 0.3
    u = rs.uniform(0, 1, (3, N)).astype(np.float32)
    kind_a = np.full((N, 1), int(kind), np.int32)
    jl = JLobes(kind=jnp.asarray(kind_a), s0=jnp.asarray(s0),
                s1=jnp.asarray(s1), s2=jnp.asarray(s2), f0=jnp.asarray(f),
                f1=jnp.asarray(f), kinds=(int(kind),))
    tl = TLobes(kind=torch.as_tensor(kind_a).long(), s0=torch.as_tensor(s0),
                s1=torch.as_tensor(s1), s2=torch.as_tensor(s2),
                f0=torch.as_tensor(f), f1=torch.as_tensor(f),
                kinds=(int(kind),))
    host = dict(wo=wo, wi=wi, gn=gn, hero=hero, wl_sel=wl_sel, u=u)
    return jl, tl, host


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("s", [16, 3])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.name)
def test_evaluate_and_pdf(kind, s):
    jl, tl, h = _inputs(kind, s, seed=int(kind) * 10 + s)
    args_j = (_j(h["wo"]), _j(h["wi"]), _j(h["gn"]), _j(h["hero"]))
    args_t = (_t(h["wo"]), _t(h["wi"]), _t(h["gn"]), _t(h["hero"]))
    np.testing.assert_allclose(tb.bsdf_evaluate(tl, *args_t).numpy(),
                               np.asarray(jb.bsdf_evaluate(jl, *args_j)),
                               RTOL, ATOL)
    np.testing.assert_allclose(tb.bsdf_pdf(tl, *args_t).numpy(),
                               np.asarray(jb.bsdf_pdf(jl, *args_j)), RTOL, ATOL)
    np.testing.assert_array_equal(tb.bsdf_has_nondelta(tl).numpy(),
                                  np.asarray(jb.bsdf_has_nondelta(jl)))
    np.testing.assert_allclose(
        tb.lobe_weights(tl, _t(h["wo"]), _t(h["hero"])).numpy(),
        np.asarray(jb.lobe_weights(jl, _j(h["wo"]), _j(h["hero"]))), RTOL, ATOL)


@pytest.mark.parametrize("s", [16, 3])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.name)
def test_sample(kind, s):
    jl, tl, h = _inputs(kind, s, seed=int(kind) * 10 + s + 1)
    u = h["u"]
    ref = jb.bsdf_sample(jl, _j(h["wo"]), _j(h["gn"]), _j(h["hero"]),
                         _j(h["wl_sel"]), _j(u[0]), _j(u[1]), _j(u[2]))
    out = tb.bsdf_sample(tl, _t(h["wo"]), _t(h["gn"]), _t(h["hero"]),
                         _t(h["wl_sel"]), _t(u[0]), _t(u[1]), _t(u[2]))
    np.testing.assert_array_equal(out.is_delta.numpy(), np.asarray(ref.is_delta))
    np.testing.assert_array_equal(out.dispersive.numpy(),
                                  np.asarray(ref.dispersive))
    for name in ("wi", "fs", "pdf", "rev_pdf", "rev_fs"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), RTOL, ATOL,
                                   err_msg=name)


def test_unported_kinds_raise_by_name():
    """Every lobe kind is ported now: a batch whose kind set names a kind
    that none of its lobes has (WARD here) evaluates as the reference does,
    the absent kind's branch selecting nothing."""
    jl, tl, h = _inputs(LobeKind.LAMBERT, 3, seed=0)
    kinds = (int(LobeKind.LAMBERT), int(LobeKind.WARD))
    tl.kinds = kinds
    jl = jl.replace(kinds=kinds)
    np.testing.assert_allclose(
        tb.bsdf_pdf(tl, _t(h["wo"]), _t(h["wi"]), _t(h["gn"]),
                    _t(h["hero"])).numpy(),
        np.asarray(jb.bsdf_pdf(jl, _j(h["wo"]), _j(h["wi"]), _j(h["gn"]),
                               _j(h["hero"]))), RTOL, ATOL)
