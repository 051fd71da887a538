"""Delta-Cl validation: baryonifying a painted mass shell suppresses the
angular power spectrum at small scales and preserves large scales — the
reference's examples/09_Reproduce_Schneider_deltaCls.ipynb workflow
(paint -> baryonify -> anafast ratio), self-contained via utils/sht.
"""

import numpy as np
import pytest

from baryonforge_tpu import Profiles, Runners, utils
from baryonforge_tpu import cosmo as bcosmo
from baryonforge_tpu.Profiles.BaryonCorrection import Baryonification2D
from baryonforge_tpu.utils import sht
from defaults import COSMO, COSMO_DICT, bpar_S19

RNG = np.random.default_rng(13)
NSIDE = 64
NPIX = 12 * NSIDE * NSIDE


@pytest.mark.slow
def test_baryonification_suppresses_cl():
    n = 120
    ra = RNG.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(RNG.uniform(-1, 1, n)))
    M = 10 ** RNG.uniform(14.0, 15.0, n)
    z = RNG.uniform(0.08, 0.15, n)
    cat = utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                     cosmo=COSMO_DICT)

    # paint the DMO mass shell
    tab = utils.TabulatedProfile(
        Profiles.DarkMatterOnly(**bpar_S19, proj_cutoff=100), COSMO)
    tab.setup_interpolator(z_min=0.05, z_max=0.3, N_samples_z=3,
                           M_min=5e13, M_max=3e15, N_samples_Mass=8,
                           R_min=1e-3, R_max=60, N_samples_R=64,
                           verbose=False)
    zero_shell = utils.LightconeShell(map=np.zeros(NPIX), cosmo=COSMO_DICT)
    mass_map = Runners.PaintProfilesShell(
        cat, zero_shell, epsilon_max=10, model=tab,
        include_pixel_size=True, halo_batch=32, verbose=False).process()
    mass_map = mass_map + mass_map.mean()     # uniform background

    # baryonify
    DMO = Profiles.DarkMatterOnly(**bpar_S19, proj_cutoff=100)
    DMB = Profiles.DarkMatterBaryon(**bpar_S19, proj_cutoff=100)
    model = Baryonification2D(DMO, DMB, COSMO, epsilon_max=20)
    model.setup_interpolator(z_min=0.05, z_max=0.3, N_samples_z=3,
                             M_min=5e13, M_max=3e15, N_samples_Mass=8,
                             R_min=1e-3, R_max=60, N_samples_R=64,
                             verbose=False)
    shell = utils.LightconeShell(map=mass_map, cosmo=COSMO_DICT)
    new_map = Runners.BaryonifyShell(cat, shell, epsilon_max=20,
                                     model=model, halo_batch=32,
                                     verbose=False).process()

    lmax = 3 * NSIDE - 1
    d0 = mass_map / mass_map.mean() - 1.0
    d1 = new_map / new_map.mean() - 1.0
    cl0 = sht.anafast(d0, lmax=lmax)
    cl1 = sht.anafast(d1, lmax=lmax)
    good = cl0 > 0
    ratio = np.where(good, cl1 / np.where(good, cl0, 1.0), 1.0)

    ell = np.arange(lmax + 1)
    lo = (ell >= 2) & (ell <= 10)
    hi = (ell >= 120) & (ell <= lmax)
    # large scales preserved to a few percent
    assert np.abs(np.mean(ratio[lo]) - 1) < 0.05, ratio[lo]
    # small scales suppressed (gas pushed out of halo centers). At
    # NSIDE=64 the pixels are ~1 deg so the accessible ells only graze
    # the suppression regime (measured ~2% at ell 100-190); the strong
    # quantitative pins live in test_deltapk / test_s19_published_curves.
    hi_mean = np.mean(ratio[hi])
    assert hi_mean < 0.99, f"no high-ell suppression: {hi_mean}"
    assert hi_mean > 0.85, f"suppression implausibly strong: {hi_mean}"
    # mass conservation already asserted inside process()


@pytest.mark.slow
def test_deltacl_limber_vs_s19_fig2():
    """Quantitative Delta-Cl against the digitized S19 Fig. 2 suppression
    via the thin-shell Limber mapping.

    Derivation: for a single thin shell at comoving distance chi_bar with
    width dchi << chi_bar, Limber gives
        Cl = integral dchi W(chi)^2 P_2D((l + 1/2)/chi) / chi^2
           ~ P((l + 1/2)/chi_bar) / (chi_bar^2 dchi),
    so the SAME scale-dependent suppression factor S(k) multiplies the
    baryonified and DMO spectra at k = (l + 1/2)/chi_bar and
        Cl_b / Cl_dmo (ell) = S(k = (l + 1/2)/chi_bar).
    The banded DeltaP(k) golden (test_deltapk_golden.py) pins S(k) to the
    digitized Fig. 2 to +-0.07; this test pins the projected pipeline
    (paint -> Baryonification2D shell displace -> anafast) to the same
    curve through the Limber map. Pipeline lives in utils/validation.py
    (shared with tools/parity.py, which writes PARITY.json).

    Calibration run (2026-08, NSIDE=256, ~93k halos): ratio/Fig2 =
    0.9671/0.9666 at k=0.7 h/Mpc, 0.9562/0.9415 at 1.0, 0.9511/0.9130 at
    1.4 — residuals +0.0005/+0.015/+0.038, growing toward small scales
    with the NSIDE=256 pixel smoothing, all inside the +-0.07 band the
    DeltaP(k) goldens themselves carry.
    """
    from baryonforge_tpu.utils import validation as V
    res = V.limber_shell_run(nside=256, verbose=True)
    # large scales: no suppression
    assert abs(res["lo_band"] - 1) < 0.03, res
    # Limber-mapped band comparison at k where the map resolves the
    # suppression (k <= ~1.5 h/Mpc at NSIDE=256)
    for row in res["rows"]:
        assert abs(row["resid"]) < 0.07, row


@pytest.mark.slow
def test_deltacl_limber_nside512_tightens():
    """The NSIDE=512 Limber point at the same k values: the k=1.4 h/Mpc residual must shrink below the NSIDE=256 value
    (+0.0381 in the 2026-08 calibration), confirming that residual is
    pixel smoothing — not physics — and protecting the headline parity
    margin. Calibration run (2026-08-19, NSIDE=512): residuals
    -0.0123/-0.0106/-0.0061 at k=0.7/1.0/1.4 — the k=1.4 point lands
    6x closer to the digitized curve once the pixel window resolves
    the suppression scale."""
    from baryonforge_tpu.utils import validation as V
    res = V.limber_shell_run(nside=512, verbose=True)
    assert abs(res["lo_band"] - 1) < 0.03, res
    for row in res["rows"]:
        assert abs(row["resid"]) < 0.07, row
    r14 = next(r for r in res["rows"] if r["k_h"] == 1.4)
    assert abs(r14["resid"]) < 0.0381, r14


@pytest.mark.slow
def test_deltacl_nside512():
    """Metric-scale Delta-Cl: NSIDE=512, lmax=768 via the bounded-memory
    blocked SHT (utils/sht.py). Calibration run (2026-08, lmax=1280):
    ratio 1.0000 at ell 2-10, 0.9966 at 20-100, 0.937 at 100-300,
    0.855 at 300-600, upturn beyond — the classic S19 Delta-Cl shape
    (reference examples/09)."""
    nside = 512
    npix = 12 * nside * nside
    rng = np.random.default_rng(13)
    n = 400
    cat = utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=10 ** rng.uniform(14.0, 15.0, n),
        z=rng.uniform(0.08, 0.15, n), cosmo=COSMO_DICT)

    tab = utils.TabulatedProfile(
        Profiles.DarkMatterOnly(**bpar_S19, proj_cutoff=100), COSMO)
    tab.setup_interpolator(z_min=0.05, z_max=0.3, N_samples_z=3,
                           M_min=5e13, M_max=3e15, N_samples_Mass=8,
                           R_min=1e-3, R_max=60, N_samples_R=64,
                           verbose=False)
    zero_shell = utils.LightconeShell(map=np.zeros(npix),
                                      cosmo=COSMO_DICT)
    mass_map = Runners.PaintProfilesShell(
        cat, zero_shell, epsilon_max=10, model=tab,
        include_pixel_size=True, halo_batch=64, verbose=False).process()
    mass_map = mass_map + mass_map.mean()

    DMO = Profiles.DarkMatterOnly(**bpar_S19, proj_cutoff=100)
    DMB = Profiles.DarkMatterBaryon(**bpar_S19, proj_cutoff=100)
    model = Baryonification2D(DMO, DMB, COSMO, epsilon_max=20)
    model.setup_interpolator(z_min=0.05, z_max=0.3, N_samples_z=3,
                             M_min=5e13, M_max=3e15, N_samples_Mass=8,
                             R_min=1e-3, R_max=60, N_samples_R=64,
                             verbose=False)
    shell = utils.LightconeShell(map=mass_map, cosmo=COSMO_DICT)
    new_map = Runners.BaryonifyShell(cat, shell, epsilon_max=20,
                                     model=model, halo_batch=64,
                                     verbose=False).process()

    lmax = 768
    d0 = mass_map / mass_map.mean() - 1.0
    d1 = new_map / new_map.mean() - 1.0
    cl0 = sht.anafast(d0, lmax=lmax)
    cl1 = sht.anafast(d1, lmax=lmax)
    ratio = cl1 / cl0
    ell = np.arange(lmax + 1)

    def band(lo, hi):
        return float(np.mean(ratio[(ell >= lo) & (ell <= hi)]))

    assert abs(band(2, 10) - 1) < 0.02
    assert 0.90 < band(100, 300) < 0.96
    assert 0.80 < band(300, 600) < 0.90
    assert band(100, 300) > band(300, 600)   # deepening toward the dip
