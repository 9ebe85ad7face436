"""slr_tpu_torch.spectrum against slr_tpu.spectrum: hero-wavelength sampling,
tabulated spectra, stratum binning and strata -> RGB development."""
import jax.numpy as jnp
import numpy as np
import torch

from slr_tpu.spectrum import rgb as jrgb
from slr_tpu.spectrum import spectral as jsp
from slr_tpu_torch.spectrum import rgb as trgb
from slr_tpu_torch.spectrum import spectral as tsp

torch.set_num_threads(1)

# Same f32 operations in both packages; the strata -> RGB matrix products
# may sum in another order, a few ulp.
RTOL, ATOL = 2e-6, 1e-6


def _u(n, seed):
    return np.random.RandomState(seed).uniform(0, 1, n).astype(np.float32)


def _wavelengths(n=512):
    off, sel = _u(n, 1), _u(n, 2)
    off[:2] = (0.0, 0.9999999)
    ref = jsp.sample_wavelengths(jnp.asarray(off), jnp.asarray(sel))
    out = tsp.sample_wavelengths(torch.as_tensor(off), torch.as_tensor(sel))
    return ref, out


def test_sample_wavelengths():
    ref, out = _wavelengths()
    np.testing.assert_allclose(out.lambdas.numpy(), np.asarray(ref.lambdas),
                               RTOL, ATOL)
    np.testing.assert_array_equal(out.hero.numpy(), np.asarray(ref.hero))
    np.testing.assert_allclose(out.pdf.numpy(), np.asarray(ref.pdf), RTOL)


def test_eval_regular_spectrum_and_d65():
    lam = np.random.RandomState(3).uniform(250, 900, (64, 16)).astype(np.float32)
    vals = np.random.RandomState(4).uniform(0, 2, 53).astype(np.float32)
    np.testing.assert_allclose(
        tsp.eval_regular_spectrum(vals, 300.0, 830.0,
                                  torch.as_tensor(lam)).numpy(),
        np.asarray(jsp.eval_regular_spectrum(jnp.asarray(vals), 300.0, 830.0,
                                             jnp.asarray(lam))), RTOL, ATOL)
    np.testing.assert_allclose(
        tsp.d65_spectrum(torch.as_tensor(lam)).numpy(),
        np.asarray(jsp.d65_spectrum(jnp.asarray(lam))), RTOL, 1e-4)


def test_ior_curves_and_tables_copied():
    for name in ("Aluminium", "Air", "Glass_BK7"):
        for a, b in zip(tsp.ior_spectrum(name), jsp.ior_spectrum(name)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tsp.strata_cmfs(), jsp.strata_cmfs()):
        np.testing.assert_array_equal(a, b)
    t, j = tsp.upsampling_tables(), jsp.upsampling_tables()
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])


def test_upsample_tabulate_host():
    from slr_tpu.scene.build import SceneBuilder as JBuilder
    from slr_tpu_torch.scene.build import SceneBuilder as TBuilder

    grid = np.linspace(360.0, 830.0, 471)
    rgbs = np.random.RandomState(8).uniform(0.02, 1.0, (24, 3)).astype(np.float32)
    for rgb in [*rgbs, np.float32([0.75, 0.25, 0.25]), np.float32([1, 1, 1])]:
        uvs = JBuilder._rgb_to_uvs(rgb, False)
        np.testing.assert_array_equal(TBuilder._rgb_to_uvs(rgb, False), uvs)
        u, v, s = (float(x) for x in uvs)
        np.testing.assert_array_equal(tsp.upsample_tabulate_host(u, v, s, grid),
                                      jsp.upsample_tabulate_host(u, v, s, grid))


def test_bin_to_strata_and_strata_to_rgb():
    ref, out = _wavelengths()
    vals = np.random.RandomState(5).uniform(0, 3, (512, 16)).astype(np.float32)
    jb = jsp.bin_to_strata(ref.lambdas, jnp.asarray(vals))
    tb = tsp.bin_to_strata(out.lambdas, torch.as_tensor(vals))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), RTOL, ATOL)
    np.testing.assert_allclose(tsp.strata_to_rgb(tb).numpy(),
                               np.asarray(jsp.strata_to_rgb(jb)), 1e-5, 1e-5)


def test_rgb_helpers():
    v = np.random.RandomState(6).uniform(0, 2, (256, 3)).astype(np.float32)
    hero = np.random.RandomState(7).randint(0, 3, 256)
    np.testing.assert_allclose(
        trgb.importance(torch.as_tensor(v), torch.as_tensor(hero)).numpy(),
        np.asarray(jrgb.importance(jnp.asarray(v), jnp.asarray(hero))),
        RTOL, ATOL)
    for name in ("luminance", "srgb_gamma", "srgb_degamma", "tonemap_sensor"):
        arg = v if name != "tonemap_sensor" else v[:, 0]
        np.testing.assert_allclose(
            getattr(trgb, name)(torch.as_tensor(arg)).numpy(),
            np.asarray(getattr(jrgb, name)(jnp.asarray(arg))), 1e-5, 1e-6,
            err_msg=name)
