"""Spherical-harmonic analysis of RING-ordered HEALPix maps.

A JAX replacement for the ``healpy.anafast`` step of the reference's
Delta-Cl validation workflows (reference examples
09_Reproduce_Schneider_deltaCls.ipynb; the reference package itself
delegates all SHT to healpy). Exploits the RING layout the way libsharp
does: each iso-latitude ring has uniformly spaced phi centers, so the
m-transform per ring is a DFT (here a cos/sin matmul in real arithmetic),
and the colatitude transform is an
associated-Legendre recurrence over l at fixed m.

a_lm = sum_rings  P_lm(z_r) * [Omega_p * sum_{j in ring} map_j e^{-i m phi_j}]

Memory is bounded at every lmax: the m-transform streams rings in fixed
chunks (``ring_batch``), and the Legendre transform scans upward in l
carrying only the last two (n_ring, L) recurrence rows and contracting
each row against the ring modes immediately — the (n_ring, L, L) tensor
of the naive formulation is never materialized. lmax = 3*nside at
NSIDE=1024 runs in < 1 GB of buffers.
"""

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["ring_alm_real", "anafast"]

_HIGHEST = jax.lax.Precision.HIGHEST


def _ring_geometry(nside):
    """Host-side per-ring (start, count, z, shifted phi0)."""
    N = nside
    i = np.arange(1, 4 * N)
    i_s = 4 * N - i
    nr = np.where(i < N, 4 * i, np.where(i > 3 * N, 4 * i_s, 4 * N))
    ncap = 2 * N * (N - 1)
    npx = 12 * N * N
    sp = np.where(i < N, 2 * i * (i - 1),
                  np.where(i > 3 * N, npx - 2 * i_s * (i_s + 1),
                           ncap + (i - N) * 4 * N))
    z = np.where(i < N, 1.0 - i ** 2 / (3.0 * N ** 2),
                 np.where(i > 3 * N, -1.0 + i_s ** 2 / (3.0 * N ** 2),
                          4.0 / 3.0 - 2.0 * i / (3.0 * N)))
    shifted = np.where((i < N) | (i > 3 * N), 1.0,
                       np.where((i - N) % 2 == 0, 1.0, 0.0))
    phi0 = 0.5 * shifted * (2.0 * np.pi / nr)
    return sp, nr, z, phi0


def _ring_modes(nside, hmap, lmax, ring_batch=8):
    """Per-ring m-modes F_m = sum_j map_j e^{-i m phi_j}.

    Returns (Fr, Fi), each (n_ring, L). Rings are processed in chunks of
    ``ring_batch`` so the (batch, L, nmax) phase tensor stays bounded.
    """
    sp, nr, z, phi0 = _ring_geometry(nside)
    L = lmax + 1
    n_ring = nr.size
    nmax = int(nr.max())

    idx = sp[:, None] + np.minimum(np.arange(nmax)[None, :],
                                   (nr - 1)[:, None])
    mask = np.arange(nmax)[None, :] < nr[:, None]
    ring_vals = jnp.where(jnp.asarray(mask), hmap[jnp.asarray(idx)], 0.0)

    m = jnp.arange(L, dtype=hmap.dtype)
    j = jnp.arange(nmax, dtype=hmap.dtype)
    dphi = jnp.asarray(2.0 * np.pi / nr, dtype=hmap.dtype)
    phi0_d = jnp.asarray(phi0, dtype=hmap.dtype)

    def per_ring(args):
        vals, dp, p0 = args
        ang = m[:, None] * (j[None, :] * dp)            # (L, nmax)
        # HIGHEST: an f32 map must not get a TF32 (10-bit) product
        cr = jnp.matmul(jnp.cos(ang), vals, precision=_HIGHEST)
        ci = -jnp.matmul(jnp.sin(ang), vals, precision=_HIGHEST)
        c0, s0 = jnp.cos(m * p0), jnp.sin(m * p0)       # shift by phi0
        return cr * c0 + ci * s0, ci * c0 - cr * s0

    # pad the ring axis to a multiple of ring_batch, then stream
    pad = (-n_ring) % ring_batch
    if pad:
        ring_vals = jnp.concatenate(
            [ring_vals, jnp.zeros((pad, nmax), ring_vals.dtype)])
        dphi = jnp.concatenate([dphi, jnp.ones(pad, dphi.dtype)])
        phi0_d = jnp.concatenate([phi0_d, jnp.zeros(pad, phi0_d.dtype)])
    Fr, Fi = jax.lax.map(jax.vmap(per_ring),
                         (ring_vals.reshape(-1, ring_batch, nmax),
                          dphi.reshape(-1, ring_batch),
                          phi0_d.reshape(-1, ring_batch)))
    return (Fr.reshape(-1, L)[:n_ring], Fi.reshape(-1, L)[:n_ring])


def _alm_from_modes(z, Fr, Fi, lmax):
    """Contract ring modes with normalized associated Legendre functions.

    Scans upward in l carrying (lambda_{l-1,m}, lambda_{l-2,m}) as
    (n_ring, L) rows; each step emits one l-row of (Re a_lm, Im a_lm).
    lambda_lm = sqrt((2l+1)/(4pi) (l-m)!/(l+m)!) P_lm(z) via the standard
    stable three-term recurrence, seeded on the diagonal
    lambda_mm = sqrt(prod_{k<=m}(2k+1)/(2k) / (4pi)) * sin(theta)^m
    (healpix convention; Condon-Shortley signs cancel in |a_lm|^2).
    """
    z = jnp.asarray(z)
    L = lmax + 1
    dt = z.dtype
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))          # (n_ring,)

    k = jnp.arange(1, L, dtype=dt)
    # amp_m = sqrt(prod_{k<=m}(2k+1)/(2k)/(4pi)), m = 0..lmax
    logfac = jnp.concatenate([jnp.zeros(1, dt),
                              jnp.cumsum(jnp.log((2 * k + 1) / (2 * k)))])
    # lam_mm (n_ring, m): exp(0.5 logfac_m + m log s) / sqrt(4pi);
    # log(0) -> -inf gives exact 0 at s=0 (no healpix ring reaches a pole
    # but padded rows might)
    mf = jnp.arange(L, dtype=dt)
    with np.errstate(divide="ignore"):
        log_s = jnp.log(jnp.maximum(s, jnp.finfo(dt).tiny))
    lam_mm = jnp.exp(0.5 * logfac[None, :] + mf[None, :] * log_s[:, None]
                     - 0.5 * jnp.log(4 * jnp.pi))
    lam_mm = jnp.where(s[:, None] > 0, lam_mm,
                       jnp.where(mf[None, :] == 0,
                                 1.0 / jnp.sqrt(4 * jnp.pi), 0.0))

    # recurrence coefficients per (l, m):
    #   lambda_{l,m} = a_{l,m} z lambda_{l-1,m} - b_{l,m} lambda_{l-2,m}
    l = jnp.arange(L, dtype=dt)[:, None]
    mm = mf[None, :]
    a = jnp.sqrt(((2 * l + 1) * (2 * l - 1))
                 / jnp.maximum((l - mm) * (l + mm), 1.0))
    b = jnp.sqrt(jnp.maximum(
        (2 * l + 1) * (l - 1 - mm) * (l - 1 + mm), 0.0)
        / jnp.maximum((2 * l - 3) * (l - mm) * (l + mm), 1.0))

    li_all = jnp.arange(L)

    def step(carry, li):
        prev, prev2 = carry                              # (n_ring, L)
        cur = a[li] * (z[:, None] * prev) - b[li] * prev2
        cur = jnp.where(li == li_all[None, :], lam_mm,
                        jnp.where(li < li_all[None, :], 0.0, cur))
        row_r = jnp.sum(Fr * cur, axis=0)                # (L,) over rings
        row_i = jnp.sum(Fi * cur, axis=0)
        return (cur, prev), (row_r, row_i)

    zeros = jnp.zeros_like(lam_mm)
    # unroll: each step is only ~n_ring*L fma, so per-step dispatch
    # overhead dominates an un-unrolled scan on CPU
    _, (alm_r, alm_i) = jax.lax.scan(step, (zeros, zeros), li_all,
                                     unroll=8)
    # rows are indexed by l; transpose to the (m, l) layout
    return alm_r.T, alm_i.T


def ring_alm_real(nside, hmap, lmax, ring_batch=8):
    """(Re, Im) of a_lm for m >= 0, shapes (L, L) indexed [m, l]."""
    sp, nr, z, phi0 = _ring_geometry(nside)
    npix = 12 * nside * nside
    omega = 4.0 * jnp.pi / npix
    hmap = jnp.asarray(hmap, dtype=jnp.float64)
    Fr, Fi = _ring_modes(nside, hmap, lmax, ring_batch=ring_batch)
    alm_r, alm_i = _alm_from_modes(jnp.asarray(z, hmap.dtype), Fr, Fi,
                                   lmax)
    return alm_r * omega, alm_i * omega


def anafast(hmap, lmax=None, nside=None, ring_batch=8):
    """Angular power spectrum C_l of a RING map (healpy.anafast analog).

    C_l = 1/(2l+1) [ |a_l0|^2 + 2 sum_{m>0} |a_lm|^2 ].
    """
    hmap = np.asarray(hmap)
    if nside is None:
        nside = int(np.sqrt(hmap.size / 12))
    assert 12 * nside * nside == hmap.size, "not a healpix map"
    if lmax is None:
        lmax = 3 * nside - 1
    alm_r, alm_i = ring_alm_real(nside, hmap, lmax, ring_batch=ring_batch)
    p = alm_r ** 2 + alm_i ** 2                         # (m, l)
    m = jnp.arange(lmax + 1)[:, None]
    l = jnp.arange(lmax + 1)[None, :]
    w = jnp.where(m == 0, 1.0, 2.0) * (m <= l)
    cl = jnp.sum(p * w, axis=0) / (2.0 * l[0] + 1.0)
    return np.asarray(cl)
