"""Native HEALPix (RING scheme) geometry in JAX.

Integer math is int32 throughout (valid for NSIDE <= 8192).

The reference delegates all sphere pixelization to healpy (C++):
``ang2vec/pix2vec/query_disc/get_interp_weights`` (Runners/HealpixRunner.py).
healpy is CPU-only and shape-dynamic, so we re-implement the RING-scheme
geometry as pure, vectorized jnp functions following the standard HEALPix
equations (Gorski et al. 2005):

  * pix2ang / pix2vec / ang2pix (ring ordering)
  * bilinear interpolation neighbours+weights (healpy get_interp_weights)
  * static-shape disc queries: a padded (ring x phi) candidate window
    masked by true angular distance — the shape-static replacement for
    ``hp.query_disc`` demanded by XLA (SURVEY.md hard part #4).

All functions take ``nside`` as a static python int.
"""

from functools import partial
import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["npix", "nside2pixarea", "pix2ang", "pix2vec", "ang2pix",
           "ang2vec", "vec2ang", "get_interp_weights", "ring_info",
           "ring_above", "disc_pad_sizes", "disc_pixels", "disc_candidates",
           "interp_values"]


def npix(nside):
    return 12 * nside * nside


def nside2pixarea(nside):
    return 4.0 * np.pi / npix(nside)


# ---------------------------------------------------------------------------
# Ring bookkeeping. Rings are numbered i = 1 .. 4 nside - 1 (north to south).
# ---------------------------------------------------------------------------
def ring_info(nside, i, dtype=jnp.float64):
    """Per-ring data (vectorized over ring index i).

    Returns (start_pixel, n_in_ring, z_ring, shifted) where ``shifted`` is
    1.0 if pixel centers sit at phi = (j + 0.5) * dphi and 0.0 otherwise.
    Float outputs are computed in ``dtype`` (f32 for the hot path).
    """
    i = jnp.asarray(i)
    N = nside
    ncap = 2 * N * (N - 1)
    north = i < N
    south = i > 3 * N
    i_s = 4 * N - i                      # ring index counted from south pole

    nr = jnp.where(north, 4 * i, jnp.where(south, 4 * i_s, 4 * N))
    sp = jnp.where(north, 2 * i * (i - 1),
                   jnp.where(south, npix(nside) - 2 * i_s * (i_s + 1),
                             ncap + (i - N) * 4 * N))
    i_f = i.astype(dtype)
    i_sf = i_s.astype(dtype)
    z = jnp.where(north, 1.0 - i_f ** 2 / (3.0 * N ** 2),
                  jnp.where(south, -1.0 + i_sf ** 2 / (3.0 * N ** 2),
                            4.0 / 3.0 - 2.0 * i_f / (3.0 * N))).astype(dtype)
    shifted = jnp.where(north | south, 1.0,
                        jnp.where((i - N) % 2 == 0, 1.0, 0.0)).astype(dtype)
    return sp, nr, z, shifted


def ring_above(nside, z):
    """Index of the ring strictly north of colatitude z (0 if none).

    Mirrors healpix_base ring_above: result in [0, 4 nside - 1]."""
    N = nside
    az = jnp.abs(z)
    polar = az > 2.0 / 3.0
    irn = jnp.floor(N * jnp.sqrt(3.0 * (1.0 - az))).astype(jnp.int32)
    ring_pol = jnp.where(z > 0, irn, 4 * N - irn - 1)
    ring_eq = jnp.floor(N * (2.0 - 1.5 * z)).astype(jnp.int32)
    return jnp.where(polar, ring_pol, ring_eq)


def ring_above_theta(nside, theta):
    """``ring_above`` taking colatitude directly — pole-conditioned.

    ``N sqrt(3 (1 - |z|))`` = ``sqrt(6) N sin(theta/2)`` (north) /
    ``sqrt(6) N cos(theta/2)`` (south) exactly; the half-angle form avoids
    the catastrophic ``1 - cos(theta)`` cancellation that breaks float32
    near the poles for NSIDE >= ~2048 (cap ring spacing in z drops below
    f32 eps)."""
    N = nside
    z = jnp.cos(theta)
    polar = jnp.abs(z) > 2.0 / 3.0
    rt6N = jnp.sqrt(jnp.asarray(6.0, theta.dtype)) * N
    irn = jnp.floor(rt6N * jnp.sin(0.5 * theta)).astype(jnp.int32)
    irs = jnp.floor(rt6N * jnp.cos(0.5 * theta)).astype(jnp.int32)
    ring_pol = jnp.where(z > 0, irn, 4 * N - irs - 1)
    ring_eq = jnp.floor(N * (2.0 - 1.5 * z)).astype(jnp.int32)
    return jnp.where(polar, ring_pol, ring_eq)


def ring_theta(nside, i, dtype=jnp.float64):
    """Colatitude of ring ``i``, pole-conditioned.

    Cap rings evaluate ``2 arcsin(i / (sqrt(6) N))`` (exactly
    ``arccos(1 - i^2/(3 N^2))``) so float32 keeps full relative precision
    at the poles instead of the ~sqrt(eps) noise of arccos near +-1."""
    N = nside
    north = i < N
    south = i > 3 * N
    i_f = i.astype(dtype)
    i_sf = (4 * N - i).astype(dtype)
    rt6N = jnp.sqrt(jnp.asarray(6.0, dtype)) * N
    th_n = 2.0 * jnp.arcsin(jnp.clip(i_f / rt6N, 0.0, 1.0))
    th_s = jnp.pi - 2.0 * jnp.arcsin(jnp.clip(i_sf / rt6N, 0.0, 1.0))
    z_e = 4.0 / 3.0 - 2.0 * i_f / (3.0 * N)
    th_e = jnp.arccos(jnp.clip(z_e, -1.0, 1.0))
    return jnp.where(north, th_n,
                     jnp.where(south, th_s, th_e)).astype(dtype)


# ---------------------------------------------------------------------------
# pix <-> ang / vec
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnums=(0, 2))
def pix2ang(nside, p, dtype=jnp.float64):
    """Ring-scheme pixel center -> (theta, phi). Vectorized over p.
    Float math in ``dtype``; note f32 pixel centers carry ~1e-7 rad noise
    (fine for gather/paint; use f64 for exact regrid weights)."""
    p = jnp.asarray(p, dtype=jnp.int32)
    N = nside
    ncap = 2 * N * (N - 1)
    npx = npix(nside)

    # north cap
    i_n = ((1 + jnp.sqrt(1.0 + 2.0 * p)) / 2.0).astype(jnp.int32)
    # guard rounding: ensure 2 i (i-1) <= p < 2 i (i+1)
    i_n = jnp.where(2 * i_n * (i_n - 1) > p, i_n - 1, i_n)
    i_n = jnp.where(2 * i_n * (i_n + 1) <= p, i_n + 1, i_n)
    j_n = p - 2 * i_n * (i_n - 1)
    rt6N = jnp.sqrt(jnp.asarray(6.0, dtype)) * N
    th_n = 2.0 * jnp.arcsin(jnp.clip(i_n.astype(dtype) / rt6N, 0.0, 1.0))
    phi_n = (jnp.pi / (2.0 * i_n.astype(dtype))) * (j_n + 0.5)

    # equatorial belt
    pe = p - ncap
    i_e = N + pe // (4 * N)
    j_e = pe % (4 * N)
    z_e = 4.0 / 3.0 - 2.0 * i_e.astype(dtype) / (3.0 * N)
    s_e = jnp.where((i_e - N) % 2 == 0, dtype(1.0), dtype(0.0))
    phi_e = (jnp.pi / (2.0 * N)) * (j_e + 0.5 * s_e)

    # south cap
    ps = npx - 1 - p
    i_ss = ((1 + jnp.sqrt(1.0 + 2.0 * ps)) / 2.0).astype(jnp.int32)
    i_ss = jnp.where(2 * i_ss * (i_ss - 1) > ps, i_ss - 1, i_ss)
    i_ss = jnp.where(2 * i_ss * (i_ss + 1) <= ps, i_ss + 1, i_ss)
    j_ss = ps - 2 * i_ss * (i_ss - 1)
    j_s = 4 * i_ss - 1 - j_ss
    th_s = jnp.pi - 2.0 * jnp.arcsin(
        jnp.clip(i_ss.astype(dtype) / rt6N, 0.0, 1.0))
    phi_s = (jnp.pi / (2.0 * i_ss.astype(dtype))) * (j_s + 0.5)

    north = p < ncap
    south = p >= npx - ncap
    th_e = jnp.arccos(jnp.clip(z_e, -1.0, 1.0))
    theta = jnp.where(north, th_n,
                      jnp.where(south, th_s, th_e)).astype(dtype)
    phi = jnp.where(north, phi_n,
                    jnp.where(south, phi_s, phi_e)).astype(dtype)
    return theta, phi


@partial(jax.jit, static_argnums=(0, 2))
def pix2vec(nside, p, dtype=jnp.float64):
    """Pixel center unit vectors, shape (..., 3)."""
    theta, phi = pix2ang(nside, p, dtype)
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi),
                      jnp.cos(theta)], axis=-1)


@partial(jax.jit, static_argnums=(0,))
def ang2pix(nside, theta, phi):
    """(theta, phi) -> ring-scheme pixel. Standard z-based algorithm."""
    N = nside
    ncap = 2 * N * (N - 1)
    z = jnp.cos(theta)
    za = jnp.abs(z)
    tt = jnp.mod(phi, 2.0 * jnp.pi) / (0.5 * jnp.pi)    # in [0, 4)

    # --- equatorial region
    temp1 = N * (0.5 + tt)
    temp2 = N * z * 0.75
    jp = jnp.floor(temp1 - temp2).astype(jnp.int32)
    jm = jnp.floor(temp1 + temp2).astype(jnp.int32)
    ir = N + 1 + jp - jm                # ring counted from z = 2/3, 1..2N+1
    kshift = 1 - (ir & 1)
    ip = (jp + jm - N + kshift + 1) // 2
    ip = jnp.mod(ip, 4 * N)
    pix_eq = ncap + (ir - 1) * 4 * N + ip

    # --- polar caps (half-angle form: pole-conditioned in float32)
    tp = tt - jnp.floor(tt)
    rt6N = jnp.sqrt(jnp.asarray(6.0, z.dtype)) * N
    tmp = jnp.where(z > 0, rt6N * jnp.sin(0.5 * theta),
                    rt6N * jnp.cos(0.5 * theta))
    jp_c = jnp.floor(tp * tmp).astype(jnp.int32)
    jm_c = jnp.floor((1.0 - tp) * tmp).astype(jnp.int32)
    ir_c = jp_c + jm_c + 1
    ip_c = jnp.floor(tt * ir_c).astype(jnp.int32)
    ip_c = jnp.mod(ip_c, 4 * ir_c)
    pix_n = 2 * ir_c * (ir_c - 1) + ip_c
    pix_s = npix(nside) - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = jnp.where(z > 0, pix_n, pix_s)

    return jnp.where(za <= 2.0 / 3.0, pix_eq, pix_cap)


def ang2vec(theta, phi):
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi),
                      jnp.cos(theta)], axis=-1)


def vec2ang(vec):
    """Unit (or general) vectors (..., 3) -> (theta, phi in [0, 2pi))."""
    norm = jnp.sqrt(jnp.sum(vec ** 2, axis=-1))
    theta = jnp.arccos(jnp.clip(vec[..., 2] / norm, -1.0, 1.0))
    phi = jnp.arctan2(vec[..., 1], vec[..., 0])
    phi = jnp.where(phi < 0, phi + 2.0 * jnp.pi, phi)
    return theta, phi


def lonlat2thetaphi(ra_deg, dec_deg):
    theta = jnp.radians(90.0 - jnp.asarray(dec_deg))
    phi = jnp.radians(jnp.asarray(ra_deg))
    return theta, phi


# ---------------------------------------------------------------------------
# Bilinear interpolation (healpy get_interp_weights semantics)
# ---------------------------------------------------------------------------
def _ring_phi_neighbors(nside, ring, phi, dtype=jnp.float64):
    """Two pixels bracketing ``phi`` in ``ring`` and the phi weight."""
    sp, nr, z, shifted = ring_info(nside, ring, dtype)
    dphi = 2.0 * jnp.pi / nr
    tmp = phi / dphi - 0.5 * shifted
    i1 = jnp.floor(tmp).astype(jnp.int32)
    w = (phi - (i1 + 0.5 * shifted) * dphi) / dphi
    i2 = i1 + 1
    i1 = jnp.mod(i1, nr)
    i2 = jnp.mod(i2, nr)
    theta_ring = ring_theta(nside, ring, dtype)
    return sp + i1, sp + i2, w, theta_ring


@partial(jax.jit, static_argnums=(0, 3))
def get_interp_weights(nside, theta, phi, dtype=jnp.float64):
    """4 neighbour pixels + bilinear weights for each (theta, phi).

    Returns (pix, wgt) with shape (..., 4), matching healpy's
    ``get_interp_weights`` (transposed layout). ``dtype`` controls the
    float math (weights carry ~1e-4 noise in f32 at NSIDE~1k).
    """
    N = nside
    theta = jnp.asarray(theta, dtype=dtype)
    phi = jnp.mod(jnp.asarray(phi), 2.0 * jnp.pi).astype(dtype)
    ir1 = ring_above_theta(N, theta)
    ir2 = ir1 + 1

    # ring data — clamp to valid rings; the pole branches overwrite later
    r1 = jnp.clip(ir1, 1, 4 * N - 1)
    r2 = jnp.clip(ir2, 1, 4 * N - 1)
    p0, p1, w_phi1, theta1 = _ring_phi_neighbors(N, r1, phi, dtype)
    p2, p3, w_phi2, theta2 = _ring_phi_neighbors(N, r2, phi, dtype)

    wgt0 = 1.0 - w_phi1
    wgt1 = w_phi1
    wgt2 = 1.0 - w_phi2
    wgt3 = w_phi2

    at_north = ir1 == 0
    at_south = ir2 == 4 * N

    # generic case
    wtheta = (theta - theta1) / jnp.where(at_north | at_south, 1.0,
                                          theta2 - theta1)
    g0 = wgt0 * (1.0 - wtheta)
    g1 = wgt1 * (1.0 - wtheta)
    g2 = wgt2 * wtheta
    g3 = wgt3 * wtheta

    # north polar cap: point above ring 1
    wt_n = theta / theta2
    fac_n = (1.0 - wt_n) * 0.25
    n0 = fac_n
    n1 = fac_n
    n2 = wgt2 * wt_n + fac_n
    n3 = wgt3 * wt_n + fac_n
    pn0 = jnp.mod(p2 + 2, 4)
    pn1 = jnp.mod(p3 + 2, 4)

    # south polar cap: point below ring 4N-1
    wt_s = (theta - theta1) / (jnp.pi - theta1)
    fac_s = wt_s * 0.25
    s0 = wgt0 * (1.0 - wt_s) + fac_s
    s1 = wgt1 * (1.0 - wt_s) + fac_s
    s2 = fac_s
    s3 = fac_s
    npx = npix(N)
    ps2 = jnp.mod(p0 + 2, 4) + npx - 4
    ps3 = jnp.mod(p1 + 2, 4) + npx - 4

    pix = jnp.stack([
        jnp.where(at_north, pn0, p0),
        jnp.where(at_north, pn1, p1),
        jnp.where(at_south, ps2, p2),
        jnp.where(at_south, ps3, p3),
    ], axis=-1)
    wgt = jnp.stack([
        jnp.where(at_north, n0, jnp.where(at_south, s0, g0)),
        jnp.where(at_north, n1, jnp.where(at_south, s1, g1)),
        jnp.where(at_north, n2, jnp.where(at_south, s2, g2)),
        jnp.where(at_north, n3, jnp.where(at_south, s3, g3)),
    ], axis=-1)
    return pix, wgt


def interp_values(nside, hmap, theta, phi):
    """Bilinear interpolation of a ring-ordered map at (theta, phi)."""
    pix, wgt = get_interp_weights(nside, theta, phi)
    return jnp.sum(hmap[pix] * wgt, axis=-1)


# ---------------------------------------------------------------------------
# Static-shape disc queries (hp.query_disc replacement)
# ---------------------------------------------------------------------------
def disc_pad_sizes(nside, radius_max, sin_min=0.0):
    """Host-side: padded (K_ring, K_phi) window sizes for discs of angular
    radius <= radius_max (radians). Conservative but static.

    ``sin_min`` restricts the worst-case search to rings with
    sin(theta) >= sin_min: a disc whose colatitude band stays inside that
    region never touches the excluded polar rings, so its phi window can
    be much tighter. Near-polar rings force K_phi ~2-3x larger than the
    equatorial need, and >95% of (isotropic) halos never go there —
    bucketing by the disc's minimum sin(theta) recovers that factor.
    """
    N = nside
    # ring spacing: equatorial dz = 2/(3N) => dtheta >= ~0.64/N everywhere;
    # use the exact minimum ring-to-ring colatitude step.
    i = np.arange(1, 4 * N)
    z = np.where(i < N, 1.0 - i ** 2 / (3.0 * N ** 2),
                 np.where(i > 3 * N, -1.0 + (4 * N - i) ** 2 / (3.0 * N ** 2),
                          4.0 / 3.0 - 2.0 * i / (3.0 * N)))
    theta = np.arccos(np.clip(z, -1, 1))
    dtheta_min = np.min(np.diff(theta))
    K_ring = int(np.ceil(2.0 * radius_max / dtheta_min)) + 3

    # phi extent: exact worst-case half-width of a disc/ring intersection
    # over all disc centers is arcsin(sin a / sin theta_ring); if
    # sin theta_ring <= sin a the whole ring can be inside.
    nr = np.where(i < N, 4 * i, np.where(i > 3 * N, 4 * (4 * N - i), 4 * N))
    dphi = 2.0 * np.pi / nr
    sin_t = np.maximum(np.sin(theta), 1e-12)
    sin_a = np.sin(min(radius_max, np.pi / 2))
    whole = sin_t <= sin_a
    half_w = np.where(whole, np.pi, np.arcsin(np.minimum(sin_a / sin_t, 1.0)))
    need = np.minimum(np.ceil(2.0 * half_w / dphi) + 3, nr)
    band = sin_t >= sin_min
    if not band.any():
        band = np.ones_like(band)
    K_phi = int(np.max(need[band]))
    return K_ring, K_phi


@partial(jax.jit, static_argnums=(0, 4, 5, 6))
def disc_candidates(nside, theta0, phi0, radius, K_ring, K_phi,
                    dtype=jnp.float64):
    """Padded disc query returning pixel ids AND their geometry.

    Returns (pix, cos_t, sin_t, dphi_pix, sinhd, mask), (K_ring*K_phi,):
      cos_t/sin_t  : pixel-center cos/sin colatitude
      dphi_pix     : pixel phi minus phi0
      sinhd        : sin(d/2) of the angular distance d to (theta0, phi0)
                     via the haversine formula — well-conditioned in f32
                     for small separations, unlike 1 - cos(d) whose
                     cancellation puts ~10% noise on 1-pixel separations
      mask         : true disc members
    Scalar halo inputs only (vmap over halos).
    """
    N = nside
    theta0 = jnp.asarray(theta0, dtype=dtype)
    phi0 = jnp.asarray(phi0, dtype=dtype)
    radius = jnp.asarray(radius, dtype=dtype)
    ring_top = jnp.clip(
        ring_above_theta(N, jnp.maximum(theta0 - radius, 0.0)),
        0, 4 * N - 1)
    rings = ring_top + 1 + jnp.arange(K_ring, dtype=jnp.int32)
    ring_ok = (rings >= 1) & (rings <= 4 * N - 1)
    rings_c = jnp.clip(rings, 1, 4 * N - 1)

    sp, nr, _, shifted = ring_info(N, rings_c, dtype)
    theta_r = ring_theta(N, rings_c, dtype)
    dphi = 2.0 * jnp.pi / nr
    jc = jnp.round(phi0 / dphi - 0.5 * shifted).astype(jnp.int32)
    dp = jnp.arange(K_phi, dtype=jnp.int32) - (K_phi - 1) // 2
    jj = jc[:, None] + dp[None, :]                     # (K_ring, K_phi)
    # avoid duplicate pixels when the window wraps a small ring
    no_dup = (dp[None, :] >= -((nr[:, None] - 1) // 2)) \
        & (dp[None, :] <= nr[:, None] // 2)
    jw = jnp.mod(jj, nr[:, None])
    pix = sp[:, None] + jw                             # (K_ring, K_phi)

    cos_t = jnp.broadcast_to(jnp.cos(theta_r)[:, None],
                             (K_ring, K_phi))
    sin_t = jnp.broadcast_to(jnp.sin(theta_r)[:, None],
                             (K_ring, K_phi))
    phi_pix = (jw + 0.5 * shifted[:, None]) * dphi[:, None]
    dphi_pix = phi_pix - phi0
    # haversine: sin^2(d/2) = sin^2(dtheta/2) + sin t sin t0 sin^2(dphi/2)
    sdt = jnp.sin(0.5 * (theta_r[:, None] - theta0))
    sdp = jnp.sin(0.5 * dphi_pix)
    hav = sdt ** 2 + sin_t * jnp.sin(theta0) * sdp ** 2
    sinhd = jnp.sqrt(jnp.clip(hav, 0.0, 1.0))
    member = sinhd <= jnp.sin(0.5 * radius)
    mask = member & no_dup & ring_ok[:, None]
    return (pix.reshape(-1), cos_t.reshape(-1), sin_t.reshape(-1),
            dphi_pix.reshape(-1), sinhd.reshape(-1), mask.reshape(-1))


@partial(jax.jit, static_argnums=(0, 4, 5, 6))
def disc_pixels(nside, theta0, phi0, radius, K_ring, K_phi,
                dtype=jnp.float64):
    """All ring-scheme pixels whose centers lie within ``radius`` of
    (theta0, phi0) — returned as a padded static array.

    Returns (pix, mask): (K_ring*K_phi,) int pixel ids (clipped valid) and
    a boolean mask of true members. Scalar inputs only (vmap over halos).
    """
    pix, _, _, _, _, mask = disc_candidates(nside, theta0, phi0, radius,
                                            K_ring, K_phi, dtype)
    return pix, mask
