"""FFTLog: fast Hankel / spherical-Bessel transforms on log-uniform grids.

A JAX replacement for the FFTLog machinery the reference delegates to CCL
(``ccl.halos.profiles.HaloProfile._fftlog_wrap``; see reference Base.py:126-130
for how profiles tune ``plaw_fourier`` and paddings). Used for:

  * ``Profile.fourier``  : rho(k) = 4 pi int r^2 rho(r) j0(kr) dr
  * xi_mm from P(k)      : xi(r) = 1/(2 pi^2) int k^2 P(k) j0(kr) dk
  * pixel-window convolution round trips (utils/Pixel.py analog)

Implementation follows Hamilton (2000): decompose a(x) ~ sum_m c_m x^{q+i w_m}
on a periodic log grid and use the analytic Mellin pair
int_0^inf x^s J_mu(k x) dx = k^-(s+1) 2^s Gamma((mu+1+s)/2)/Gamma((mu+1-s)/2).

Everything is jit-friendly: static shapes, no data-dependent control flow.

The pipeline is written in explicit (re, im) float64 *pair* arithmetic
(complex64 would lose the precision the displacement tables need), and
the DFTs are f64 matmuls against precomputed cos/sin matrices. The grids
here are short (N <= ~2k), so the O(N^2) matmul is cheap; whether a
complex128 FFT is faster on the GPU is not yet measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial

__all__ = ["loggamma", "fht", "sph_fourier_3d", "sph_inverse_3d",
           "proj_fourier_2d", "proj_inverse_2d", "xi_from_pk",
           "convolve_profile"]


# ---------------------------------------------------------------------------
# Complex log-gamma (Lanczos approximation, g=7, n=9) — JAX lacks complex
# gammaln. Accuracy ~1e-13 relative over the domain used here.
# ---------------------------------------------------------------------------
_LANCZOS_G = 7.0
_LANCZOS_COEF = np.array([
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
])


# --- complex pair arithmetic: every value is a (re, im) tuple of f64 ------
def _cmul(a, b):
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(a, b):
    ar, ai = a
    br, bi = b
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _clog(a):
    ar, ai = a
    return 0.5 * jnp.log(ar * ar + ai * ai), jnp.arctan2(ai, ar)


def _cexp(a):
    ar, ai = a
    e = jnp.exp(ar)
    return e * jnp.cos(ai), e * jnp.sin(ai)


def _csin(a):
    ar, ai = a
    return jnp.sin(ar) * jnp.cosh(ai), jnp.cos(ar) * jnp.sinh(ai)


def _log_sin_pi(zr, zi):
    """log(sin(pi (zr + i zi))), overflow-safe for large |zi|.

    The naive sin formula needs cosh/sinh(pi zi), which overflows for
    |zi| >~ 230 in IEEE f64. For |zi| > 1 use the asymptotic-exact form
      log sin(pi z) = pi|zi| - ln 2 + i sgn(zi)(pi/2 - pi zr)
                      + log(1 - e^{2 i pi zr - 2 pi |zi|})
    whose correction term is tiny and cancellation-free.
    """
    zia = jnp.abs(zi)
    big = zia > 1.0
    # stable branch
    e = jnp.exp(-2.0 * jnp.pi * zia)
    l1r, l1i = _clog((1.0 - e * jnp.cos(2.0 * jnp.pi * zr),
                      -e * jnp.sin(2.0 * jnp.pi * zr)))
    sr_b = jnp.pi * zia - np.log(2.0) + l1r
    si_b = (0.5 * jnp.pi - jnp.pi * zr) + l1i
    # direct branch (argument clamped so the unselected lane can't overflow)
    zi_c = jnp.clip(zi, -2.0, 2.0)
    dr, di = _clog(_csin((jnp.pi * zr, jnp.pi * zi_c)))
    return (jnp.where(big, sr_b, dr),
            jnp.where(big, jnp.sign(zi) * si_b, di))


def _loggamma_pair(zr, zi):
    """Principal-branch log Gamma of zr + i zi via Lanczos + reflection.

    Pure real f64 arithmetic. Not valid exactly at non-positive
    integers (poles), which never occur for FFTLog kernel arguments.
    """
    reflect = zr < 0.5
    sr = jnp.where(reflect, 1.0 - zr, zr)
    si = jnp.where(reflect, -zi, zi)
    # Lanczos on z - 1
    wr, wi = sr - 1.0, si
    xr = jnp.full(jnp.shape(wr), _LANCZOS_COEF[0], dtype=jnp.float64)
    xi = jnp.zeros_like(xr)
    for i in range(1, 9):
        dr, di = _cdiv((jnp.float64(_LANCZOS_COEF[i]), 0.0), (wr + i, wi))
        xr, xi = xr + dr, xi + di
    tr, ti = wr + _LANCZOS_G + 0.5, wi
    ltr, lti = _clog((tr, ti))
    lxr, lxi = _clog((xr, xi))
    lgr = 0.5 * np.log(2.0 * np.pi) + (wr + 0.5) * ltr - ti * lti - tr + lxr
    lgi = (wr + 0.5) * lti + ti * ltr - ti + lxi
    # reflection: log Gamma(z) = log pi - log sin(pi z) - log Gamma(1 - z)
    lsr, lsi = _log_sin_pi(zr, zi)
    rr = np.log(np.pi) - lsr - lgr
    ri = -lsi - lgi
    return (jnp.where(reflect, rr, lgr), jnp.where(reflect, ri, lgi))


def loggamma(z):
    """Principal-branch log Gamma for complex z (vectorized, jit-safe)."""
    z = jnp.asarray(z, dtype=jnp.complex128)
    re, im = _loggamma_pair(jnp.real(z), jnp.imag(z))
    return re + 1j * im


# ---------------------------------------------------------------------------
# Matmul DFT (complex-pair FFT replacement; N is small and static)
# ---------------------------------------------------------------------------
def _dft_mats(N):
    """cos/sin DFT matrices W[j, m] = cos/sin(2 pi j m / N), exact phases."""
    j = jnp.arange(N, dtype=jnp.int64)
    jm = (j[:, None] * j[None, :]) % N          # exact integer phase index
    phase = (2.0 * jnp.pi / N) * jm.astype(jnp.float64)
    return jnp.cos(phase), jnp.sin(phase)


def _dft_pair(re, im, Wc, Ws):
    """out_m = sum_j z_j exp(-2 pi i j m / N) — matches jnp.fft.fft."""
    if im is None:
        return re @ Wc, -(re @ Ws)
    return re @ Wc + im @ Ws, im @ Wc - re @ Ws


# ---------------------------------------------------------------------------
# Core discrete Hankel transform on a log grid
# ---------------------------------------------------------------------------
def _u_coefficients(N, dln, mu, q, ln_k0x0):
    """Kernel coefficients: U_mu(q + i w_m) (k0 x0)^(-i w_m), as a pair.

    ``ln_k0x0`` is log(k0 x0) — passed in log space because the phase
    omega * ln(k0 x0) reaches thousands of radians and needs the full f64
    log (callers derive it from an f64 array log).
    """
    m = jnp.fft.fftfreq(N) * N                      # signed integer freqs
    omega = 2.0 * jnp.pi * m / (N * dln)
    g1r, g1i = _loggamma_pair((mu + 1.0 + q) / 2.0 + 0 * omega, omega / 2.0)
    g2r, g2i = _loggamma_pair((mu + 1.0 - q) / 2.0 + 0 * omega, -omega / 2.0)
    er = q * np.log(2.0) + g1r - g2r
    ei = omega * np.log(2.0) + g1i - g2i - omega * ln_k0x0
    return _cexp((er, ei))


def _safe_q(mu, q, eps=1e-4):
    """Nudge the bias q off Gamma poles of U_mu ((mu+1+q)/2 = 0, -1, ...).

    The reference dodges the same pole by hand (plaw_fourier = -3 + 1e-4,
    Arico20.py:378-379); we automate it.
    """
    arg = (mu + 1.0 + q) / 2.0
    if arg <= 1e-8 and abs(arg - round(arg)) < eps:
        return q + eps
    return q


def fht(x, a, mu, q=0.0, kcrc=1.0):
    """Discrete Hankel transform  ã(k) = ∫ a(x) J_mu(k x) k dx.

    ``x`` must be log-uniform and increasing (static shape N). Returns
    (k, ã(k)) with k log-uniform, k_c x_c = kcrc.
    """
    N = x.shape[0]
    q = _safe_q(mu, q)
    # ALL log-space scalars come from an f64 array log: the FFTLog phase
    # omega * ln(k0 x0) (thousands of radians) amplifies any f32-grade
    # rounding to O(1e-6) errors in the kernel coefficients.
    lx = jnp.log(x)
    dln = (lx[-1] - lx[0]) / (N - 1)
    if isinstance(kcrc, (int, float)):
        ln_kcrc = np.log(kcrc)                   # host f64: exact
    else:
        ln_kcrc = jnp.log(jnp.reshape(kcrc, (1,)))[0]
    ln_k0x0 = ln_kcrc - lx[-1] + lx[0]
    j = jnp.arange(N)
    k = jnp.exp(ln_kcrc - lx[-1] + j * dln)

    Wc, Ws = _dft_mats(N)
    b = (a * jnp.exp(-q * (lx - lx[0]))).astype(jnp.float64)
    cr, ci = _dft_pair(b, None, Wc, Ws)
    dr, di = _cmul((cr / N, ci / N), _u_coefficients(N, dln, mu, q, ln_k0x0))
    out_re, _ = _dft_pair(dr, di, Wc, Ws)
    atilde = jnp.exp(-q * (ln_k0x0 + j * dln)) * out_re
    return k, atilde


def _log_resample(x_src, y_src, x_query):
    """Linear interpolation in log-x (values linear), zero outside."""
    lx = jnp.log(x_src)
    lq = jnp.log(x_query)
    y = jnp.interp(lq, lx, y_src, left=0.0, right=0.0)
    return y


def _padded_grid(r, pad_lo, pad_hi, n_per_decade):
    """Build a static padded log grid covering [r0*pad_lo, r1*pad_hi].

    Host-side helper (numpy): shapes must be static, so call with concrete
    pad factors. Returns the padded grid as a numpy array.
    """
    r0 = float(r[0]) * pad_lo
    r1 = float(r[-1]) * pad_hi
    n = int(np.ceil(np.log10(r1 / r0) * n_per_decade))
    # power-of-two-ish size for FFT efficiency
    n = int(2 ** np.ceil(np.log2(max(n, 32))))
    return np.geomspace(r0, r1, n)


# ---------------------------------------------------------------------------
# Physics-facing wrappers
# ---------------------------------------------------------------------------
def sph_fourier_3d(r, f, k_out, plaw=-2.0):
    """3D spherical Fourier transform F(k) = 4 pi ∫ r^2 f(r) j0(kr) dr.

    ``r`` log-uniform (static); result interpolated onto ``k_out``.
    ``plaw`` is the assumed power-law slope of f for de-biasing (the
    reference's ``plaw_fourier``; Base.py:126).
    """
    a = f * r ** 1.5
    q = 1.5 + plaw          # bias that flattens a(r) * r^{-q}
    k, at = fht(r, a, mu=0.5, q=q)
    F = (2.0 * jnp.pi) ** 1.5 * at / k ** 1.5
    return _log_resample(k, F, k_out)


def sph_inverse_3d(k, F, r_out, plaw=-2.0):
    """Inverse: f(r) = 1/(2 pi^2) ∫ k^2 F(k) j0(kr) dk."""
    return sph_fourier_3d(k, F, r_out, plaw=plaw) / (2.0 * jnp.pi) ** 3


def proj_fourier_2d(R, f, k_out, plaw=-2.0):
    """2D transform F(k) = 2 pi ∫ R f(R) J0(kR) dR (for projected profiles)."""
    a = f * R
    q = 1.5 + plaw        # empirically best bias; 1.0+plaw hits a Gamma pole
    k, at = fht(R, a, mu=0.0, q=q)
    F = 2.0 * jnp.pi * at / k
    return _log_resample(k, F, k_out)


def proj_inverse_2d(k, F, R_out, plaw=-2.0):
    """Inverse 2D: f(R) = 1/(2 pi)^2 * [2 pi ∫ k F(k) J0(kR) dk]."""
    return proj_fourier_2d(k, F, R_out, plaw=plaw) / (2.0 * jnp.pi) ** 2


def xi_from_pk(k, pk, r_out):
    """Matter correlation xi(r) = 1/(2 pi^2) ∫ k^2 P(k) j0(kr) dk."""
    return sph_inverse_3d(k, pk, r_out, plaw=-2.0)


def convolve_profile(r, f, window_fn, dim=3, plaw=-2.0):
    """Convolve a radial profile with an isotropic window W(k).

    Computes  FT^-1[ FT[f](k) * W(k) ]  with both transforms on the natural
    reciprocal log grids and opposite bias signs, so a unit window round
    trip is exact to floating-point (the identity-window property the
    reference's ConvolvedProfile is tested on, text_pixel_conv.py:13-26).

    ``r`` must be log-uniform; result is evaluated on the same ``r``.
    ``window_fn`` maps k -> W(k) (evaluated on the internal grid).
    dim=3: F = 4 pi ∫ r^2 f j0(kr) dr;  dim=2: F = 2 pi ∫ R f J0(kR) dR.
    """
    if dim == 3:
        mu, p = 0.5, 1.5
        fwd_const, inv_const = (2.0 * jnp.pi) ** 1.5, (2.0 * jnp.pi) ** -1.5
    else:
        mu, p = 0.0, 1.0
        fwd_const, inv_const = 2.0 * jnp.pi, (2.0 * jnp.pi) ** -1
    q = 1.5 + plaw        # bias; for dim=2, 1.0+plaw would hit a Gamma pole
    k, at = fht(r, f * r ** p, mu=mu, q=q)
    F = fwd_const * at / k ** p
    F = F * window_fn(k)
    x, bt = fht(k, F * k ** p, mu=mu, q=-q)
    return inv_const * bt / x ** p
