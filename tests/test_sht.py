"""SHT validation: anafast against a brute-force scipy spherical-harmonic
sum, plus analytic single-mode maps."""

import numpy as np
import pytest
from scipy.special import sph_harm_y

from baryonforge_tpu.ops import healpix as hpx
from baryonforge_tpu.utils import sht

RNG = np.random.default_rng(9)


def _brute_cl(nside, hmap, lmax):
    npix = hmap.size
    theta, phi = (np.asarray(x) for x in
                  hpx.pix2ang(nside, np.arange(npix)))
    omega = 4 * np.pi / npix
    cl = np.zeros(lmax + 1)
    for l in range(lmax + 1):
        tot = 0.0
        for m in range(-l, l + 1):
            ylm = sph_harm_y(l, m, theta, phi)
            alm = omega * np.sum(hmap * np.conj(ylm))
            tot += np.abs(alm) ** 2
        cl[l] = tot / (2 * l + 1)
    return cl


def test_anafast_matches_brute_force():
    nside, lmax = 8, 12
    hmap = RNG.standard_normal(12 * nside * nside)
    ours = sht.anafast(hmap, lmax=lmax)
    ref = _brute_cl(nside, hmap, lmax)
    np.testing.assert_allclose(ours[: lmax + 1], ref, rtol=1e-8, atol=1e-12)


def test_single_mode_map():
    """A map = Re Y_40 has power only at l=4 (up to pixelization)."""
    nside, lmax = 16, 10
    npix = 12 * nside * nside
    theta, phi = (np.asarray(x) for x in
                  hpx.pix2ang(nside, np.arange(npix)))
    hmap = np.real(sph_harm_y(4, 0, theta, phi))
    cl = sht.anafast(hmap, lmax=lmax)
    # a_40 = 1 up to pixelization (HEALPix centers are not an exact
    # quadrature: ~5% at nside=16) => C_4 ~ 1/(2l+1) = 1/9
    assert cl[4] == pytest.approx(1.0 / 9.0, rel=0.1)
    others = np.delete(cl, 4)
    assert others.max() < 5e-3 * cl[4]


def test_constant_map_is_monopole():
    nside = 8
    cl = sht.anafast(np.full(12 * nside * nside, 2.5), lmax=6)
    assert cl[0] == pytest.approx(4 * np.pi * 2.5 ** 2, rel=1e-10)
    # pixel centers are not an exact quadrature: tiny even-l leakage
    assert np.abs(cl[1:]).max() < 1e-5 * cl[0]


def test_ring_modes_f32_map_at_highest_precision():
    """The per-ring m-transform of an f32 map asks for HIGHEST matmul
    precision (a TF32 product keeps a 10-bit mantissa on GPUs) and agrees
    with the f64 transform to f32 rounding."""
    import jax
    import jax.numpy as jnp
    nside, lmax = 8, 23
    m64 = RNG.standard_normal(12 * nside * nside)
    m32 = jnp.asarray(m64, dtype=jnp.float32)
    jaxpr = str(jax.make_jaxpr(
        lambda m: sht._ring_modes(nside, m, lmax))(m32))
    assert jaxpr.count("dot_general") >= 2
    assert "precision=None" not in jaxpr
    assert jaxpr.count("Precision.HIGHEST") >= 2
    fr32, fi32 = sht._ring_modes(nside, m32, lmax)
    fr64, fi64 = sht._ring_modes(nside, jnp.asarray(m64), lmax)
    assert fr32.dtype == jnp.float32
    scale = float(np.abs(np.asarray(fr64)).max())
    np.testing.assert_allclose(np.asarray(fr32), np.asarray(fr64),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(fi32), np.asarray(fi64),
                               atol=1e-5 * scale, rtol=0)
