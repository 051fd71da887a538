"""RING-convention pinning for ops/healpix.

healpy is not installable in this environment (vendored healpy goldens
would be the ideal; the strongest available substitutes are below):

 1. literal NSIDE=1 and NSIDE=2 pixel-center tables written out from the
    geometric HEALPix definition (rings of 4/8/... pixels at
    z = 1 - i^2/(3 N^2) in the caps, z = 4/3 - 2i/(3N) in the belt,
    first-ring centers at phi = pi/4 with RING ordering north->south,
    west->east) — NOT computed through the code under test;
 2. exact 90-degree azimuthal symmetry: rotating phi by pi/2 maps RING
    pixel (i, j) -> (i, j + nr/4 mod nr), an identity any correct RING
    implementation satisfies and any indexing-offset bug breaks;
 3. interp-weight equivariance under the same rotation.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from baryonforge_tpu.ops import healpix as hpx


# --- 1. literal tables (hand-derived; see module docstring) -------------
# NSIDE=1: ring 1 (4 px) z=2/3 phi=(2j+1)pi/4; ring 2 (4 px) z=0
# phi=j*pi/2 (belt ring with i-N=1 odd -> unshifted); ring 3 mirrors ring 1.
Z1 = [2 / 3] * 4 + [0.0] * 4 + [-2 / 3] * 4
PHI1 = ([np.pi / 4, 3 * np.pi / 4, 5 * np.pi / 4, 7 * np.pi / 4]
        + [0.0, np.pi / 2, np.pi, 3 * np.pi / 2]
        + [np.pi / 4, 3 * np.pi / 4, 5 * np.pi / 4, 7 * np.pi / 4])

# NSIDE=2 north cap + first belt ring:
# ring 1: 4 px, z = 1 - 1/12 = 11/12, phi = (2j+1) pi/4
# ring 2: 8 px, z = 1 - 4/12 = 2/3,  phi = (2j+1) pi/8
# ring 3 (belt, i=N=2, i-N=0 even -> shifted): 8 px, z = 4/3 - 4/6 = 2/3
#   ... careful: i=2 < N? N=2 so ring 2 is the cap edge. Belt rings are
#   i = 2..6 with z = 4/3 - i/3: i=3 -> 1/3 (shifted? (3-2)%2=1 -> no
#   shift), phi = j pi/4.
Z2_HEAD = [11 / 12] * 4 + [2 / 3] * 8 + [1 / 3] * 8
PHI2_HEAD = ([np.pi / 4, 3 * np.pi / 4, 5 * np.pi / 4, 7 * np.pi / 4]
             + [(2 * j + 1) * np.pi / 8 for j in range(8)]
             + [j * np.pi / 4 for j in range(8)])


def test_nside1_pixel_centers():
    theta, phi = hpx.pix2ang(1, np.arange(12))
    np.testing.assert_allclose(np.cos(np.asarray(theta)), Z1, atol=1e-14)
    np.testing.assert_allclose(np.asarray(phi), PHI1, atol=1e-14)


def test_nside2_pixel_centers_head():
    theta, phi = hpx.pix2ang(2, np.arange(20))
    np.testing.assert_allclose(np.cos(np.asarray(theta)), Z2_HEAD,
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(phi), PHI2_HEAD, atol=1e-14)


def test_ring2_is_cap_boundary_nside2():
    # total pixel count bookkeeping: ncap = 2 N (N-1) = 4 at NSIDE=2
    theta, _ = hpx.pix2ang(2, np.array([3, 4]))
    assert float(np.cos(theta[0])) > 0.9           # last cap-1 pixel
    np.testing.assert_allclose(np.cos(np.asarray(theta[1])), 2 / 3,
                               atol=1e-14)


@pytest.mark.parametrize("nside", [8, 256, 4096])
def test_quarter_turn_symmetry_ang2pix(nside):
    """phi -> phi + pi/2 maps pixel (ring, j) -> (ring, j + nr/4)."""
    rng = np.random.default_rng(4)
    n = 4096
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    p = np.asarray(hpx.ang2pix(nside, jnp.asarray(theta),
                               jnp.asarray(phi)))
    p_rot = np.asarray(hpx.ang2pix(
        nside, jnp.asarray(theta),
        jnp.asarray(np.mod(phi + np.pi / 2, 2 * np.pi))))
    # decompose p into (ring start, nr, j) via the ring structure
    i = np.asarray(_ring_of(nside, p))
    sp, nr = _ring_start_len(nside, i)
    j = p - sp
    expect = sp + (j + nr // 4) % nr
    np.testing.assert_array_equal(p_rot, expect)


@pytest.mark.parametrize("nside", [8, 256, 4096])
def test_quarter_turn_equivariance_interp_weights(nside):
    rng = np.random.default_rng(5)
    n = 1024
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    pix, wgt = hpx.get_interp_weights(nside, jnp.asarray(theta),
                                      jnp.asarray(phi))
    pix_r, wgt_r = hpx.get_interp_weights(
        nside, jnp.asarray(theta),
        jnp.asarray(np.mod(phi + np.pi / 2, 2 * np.pi)))
    pix, wgt = np.asarray(pix), np.asarray(wgt)
    pix_r, wgt_r = np.asarray(pix_r), np.asarray(wgt_r)
    i = np.asarray(_ring_of(nside, pix))
    sp, nr = _ring_start_len(nside, i)
    expect = sp + ((pix - sp) + nr // 4) % nr
    # same weights, rotated neighbour ids
    np.testing.assert_allclose(wgt_r, wgt, atol=1e-12)
    np.testing.assert_array_equal(pix_r, expect)


def _ring_of(nside, p):
    """Ring index of RING pixels, independent integer derivation."""
    p = np.asarray(p, dtype=np.int64)
    N = nside
    ncap = 2 * N * (N - 1)
    npx = 12 * N * N
    i_n = ((1 + np.sqrt(1.0 + 2.0 * p)) / 2.0).astype(np.int64)
    i_n -= (2 * i_n * (i_n - 1) > p)
    i_n += (2 * i_n * (i_n + 1) <= p)
    ps = npx - 1 - p
    i_s = ((1 + np.sqrt(1.0 + 2.0 * ps)) / 2.0).astype(np.int64)
    i_s -= (2 * i_s * (i_s - 1) > ps)
    i_s += (2 * i_s * (i_s + 1) <= ps)
    i_e = N + (p - ncap) // (4 * N)
    return np.where(p < ncap, i_n,
                    np.where(p >= npx - ncap, 4 * N - i_s, i_e))


def _ring_start_len(nside, i):
    N = nside
    ncap = 2 * N * (N - 1)
    npx = 12 * N * N
    i_s = 4 * N - i
    nr = np.where(i < N, 4 * i, np.where(i > 3 * N, 4 * i_s, 4 * N))
    sp = np.where(i < N, 2 * i * (i - 1),
                  np.where(i > 3 * N, npx - 2 * i_s * (i_s + 1),
                           ncap + (i - N) * 4 * N))
    return sp, nr
