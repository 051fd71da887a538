"""First-principles validation pipelines pinning the framework to the
published Schneider+19 suppression curves.

The driver's primary metric names "map and ΔCl parity vs the CPU
reference" (BASELINE.json); these pipelines are the machinery behind the
nightly golden tests (tests/test_deltacl.py, tests/test_deltapk_golden.py)
AND behind ``tools/parity.py``, which writes the per-round ``PARITY.json``
artifact. Everything here is self-contained
synthetic-box / synthetic-shell physics:

* halos sampled from the Tinker08 mass function above the reference's
  10^12.8 Msun completeness mask (reference examples/10),
* truncated-NFW (S19 DarkMatter) profiles painted at their positions,
* the un-collapsed mass fraction added as a uniform background,
* baryonified with Baryonification2D/3D and compared against the
  digitized S19 Fig. 2 curves (tests/data/S19_Fig2_Scrapped.csv, vendored
  from the reference's examples directory),
* for shells, mapped through the thin-shell Limber relation
  Cl_b/Cl_dmo(ell) = S(k = (ell + 1/2)/chi_bar).

Reference workflows: examples/09_Reproduce_Schneider_deltaCls.ipynb and
examples/10_Reproduce_Schneider_deltaPk.ipynb.
"""

import csv
import os

import numpy as np

__all__ = ["fig2_curves", "limber_shell_run", "s19_box",
           "deltapk_s19_residuals", "tiled_vs_scatter_residual",
           "TNG_COSMO_DICT", "BPAR_S19_FIG2"]

# cosmology of reference examples/10 and /12 (TNG-like)
H_TNG = 0.6711
TNG_COSMO_DICT = dict(Omega_m=0.3175, Omega_b=0.049, h=H_TNG,
                      sigma8=0.82, n_s=0.9649, w0=-1.0)
# S19 defaults as set in reference examples/10 (tau=-inf zeroes their
# unused satellite term; A = 0.09/2 matches their high-mass behavior)
BPAR_S19_FIG2 = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / H_TNG,
                     mu_beta=0.4, eta=0.3, eta_delta=0.3, tau=-np.inf,
                     tau_delta=0, A=0.09 / 2, M1=2.5e11 / H_TNG,
                     epsilon_h=0.015, a=0.3, n=2, epsilon=4, p=0.3,
                     q=0.707, gamma=2, delta=7,
                     proj_cutoff=205 / H_TNG / 2)


def _default_fig2_csv():
    here = os.path.dirname(os.path.abspath(__file__))
    cands = [os.path.join(here, "..", "..", "tests", "data",
                          "S19_Fig2_Scrapped.csv"),
             os.path.join(os.getcwd(), "tests", "data",
                          "S19_Fig2_Scrapped.csv")]
    for c in cands:
        if os.path.exists(c):
            return c
    raise FileNotFoundError("S19_Fig2_Scrapped.csv not found; pass "
                            "csv_path explicitly")


def fig2_curves(csv_path=None):
    """Digitized S19 Fig. 2 suppression curves: {name: (k_h, ratio)}."""
    path = csv_path or _default_fig2_csv()
    with open(path) as f:
        header = [h.strip() for h in f.readline().split(",")[::2]]
        f.readline()
        rows = list(csv.reader(f))
    cols = {}
    for i, name in enumerate(header):
        x = np.array([float(r[2 * i]) for r in rows if r[2 * i]])
        y = np.array([float(r[2 * i + 1]) for r in rows if r[2 * i + 1]])
        o = np.argsort(x)
        cols[name] = (x[o], y[o])
    return cols


def _tinker_sample(rng, cosmo, a, volume, lgM_lo=12.8, lgM_hi=15.3):
    """Poisson-sample halo masses from the Tinker08 mass function above
    the reference's completeness cut (reference examples/10 mask)."""
    import jax.numpy as jnp
    from . import halomodel as hm
    lgM = np.linspace(lgM_lo, lgM_hi, 60)
    M_grid = 10 ** lgM
    dndlgM = np.asarray(hm.MassFuncTinker08()(cosmo, jnp.asarray(M_grid),
                                              a))
    counts = dndlgM * np.gradient(lgM) * volume
    ns = rng.poisson(counts)
    return np.repeat(M_grid, ns) * 10 ** rng.uniform(-0.02, 0.02,
                                                     int(ns.sum()))


def limber_shell_run(nside=256, k_eval_h=(0.7, 1.0, 1.4), seed=31,
                     csv_path=None, verbose=False):
    """Paint -> Baryonification2D shell displace -> anafast ratio,
    Limber-mapped to k and compared against the digitized S19 Fig. 2
    Mc1e14 curve.

    Returns a dict with ``rows`` = [{k_h, ell, ratio, fig2, resid}],
    ``lo_band`` (mean Cl ratio at ell 2-20, should be ~1) and ``meta``.
    Calibration (2026-08, nside=256, ~93k halos): ratio/Fig2 =
    0.9671/0.9666 at k=0.7 h/Mpc, 0.9562/0.9415 at 1.0, 0.9511/0.9130 at
    1.4 — residuals grow toward small scales with the pixel smoothing.
    """
    from .. import Profiles, Runners, utils
    from .. import cosmo as bcosmo
    from ..cosmo import core as _core
    from ..Profiles.BaryonCorrection import Baryonification2D
    from . import sht

    CD = dict(TNG_COSMO_DICT)
    H = CD["h"]
    COSMO = bcosmo.cosmology_from_dict(CD)
    BPAR = dict(BPAR_S19_FIG2)

    rng = np.random.default_rng(seed)
    z1, z2 = 0.10, 0.12
    a_of = lambda z: 1.0 / (1.0 + z)          # noqa: E731
    chi1 = float(np.asarray(
        _core.comoving_radial_distance(COSMO, a_of(z1))).ravel()[0])
    chi2 = float(np.asarray(
        _core.comoving_radial_distance(COSMO, a_of(z2))).ravel()[0])
    chi_bar = 0.5 * (chi1 + chi2)
    vol = 4.0 * np.pi / 3.0 * (chi2 ** 3 - chi1 ** 3)

    masses = _tinker_sample(rng, COSMO, a_of(0.11), vol)
    n = masses.size
    assert 30000 < n < 200000, n       # ~93k at the 10^12.8 cut
    # volume-weighted z inside the shell
    u = rng.uniform(0, 1, n)
    chis = (chi1 ** 3 + u * (chi2 ** 3 - chi1 ** 3)) ** (1.0 / 3.0)
    zs = np.interp(chis, [chi1, chi_bar, chi2], [z1, 0.11, z2])
    cat = utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=masses, z=zs, cosmo=CD)

    npix = 12 * nside * nside
    tab = utils.TabulatedProfile(Profiles.DarkMatter(**BPAR), COSMO)
    tab.setup_interpolator(z_min=0.08, z_max=0.14, N_samples_z=3,
                           z_linear_sampling=True,
                           M_min=3e12, M_max=5e15, N_samples_Mass=12,
                           R_min=1e-3, R_max=60, N_samples_R=64,
                           verbose=False)
    zero_shell = utils.LightconeShell(map=np.zeros(npix), cosmo=CD)
    mass_map = Runners.PaintProfilesShell(
        cat, zero_shell, epsilon_max=5, model=tab,
        include_pixel_size=True, halo_batch=256, verbose=False).process()
    # un-collapsed mass as a uniform background (Fig-2 box recipe)
    rho_m = float(_core.rho_x(COSMO, 1.0, species="matter",
                              is_comoving=True))
    M_tot = rho_m * vol
    frac = mass_map.sum() / M_tot
    assert 0.25 < frac < 0.55, frac
    mass_map = mass_map + (M_tot - mass_map.sum()) / npix

    DMO = Profiles.DarkMatterOnly(**BPAR)
    DMB = Profiles.DarkMatterBaryon(**BPAR)
    model = Baryonification2D(DMO, DMB, COSMO, epsilon_max=10)
    model.setup_interpolator(z_min=0.08, z_max=0.14, N_samples_z=3,
                             z_linear_sampling=True,
                             M_min=3e12, M_max=5e15, N_samples_Mass=12,
                             R_min=1e-3, R_max=60, N_samples_R=64,
                             verbose=False)
    shell = utils.LightconeShell(map=mass_map, cosmo=CD)
    new_map = Runners.BaryonifyShell(cat, shell, epsilon_max=10,
                                     model=model, halo_batch=256,
                                     verbose=False).process()

    k_max = max(k_eval_h)
    lmax = min(int(1.2 * (k_max * H * chi_bar)) + 16, 3 * nside - 1)
    d0 = mass_map / mass_map.mean() - 1.0
    d1 = new_map / new_map.mean() - 1.0
    cl0 = sht.anafast(d0, lmax=lmax)
    cl1 = sht.anafast(d1, lmax=lmax)
    ratio = cl1 / cl0
    ell = np.arange(lmax + 1)

    fig2 = fig2_curves(csv_path)["Mc1e14"]
    lo = (ell >= 2) & (ell <= 20)
    rows = []
    for kh in k_eval_h:
        l_c = kh * H * chi_bar - 0.5
        band = (ell >= 0.85 * l_c) & (ell <= 1.15 * l_c)
        got = float(np.mean(ratio[band]))
        want = float(np.interp(kh, *fig2))
        rows.append(dict(k_h=kh, ell=round(l_c, 1), ratio=round(got, 4),
                         fig2=round(want, 4),
                         resid=round(got - want, 4)))
        if verbose:
            print(f"deltaCl k={kh} h/Mpc ell~{l_c:.0f}: ours {got:.4f} "
                  f"Fig2 {want:.4f} diff {got - want:+.4f}")
    return dict(rows=rows, lo_band=round(float(np.mean(ratio[lo])), 4),
                meta=dict(nside=nside, n_halos=int(n),
                          chi_bar=round(chi_bar, 1), lmax=int(lmax)))


def s19_box(N=256, L=128.0, seed=123):
    """(catalog, painted DMO mass map): Tinker08-sampled halos with
    truncated-NFW profiles plus a uniform un-collapsed background — the
    synthetic stand-in for the reference's TNG300-3-Dark box."""
    from .. import Profiles, utils
    from .. import cosmo as bcosmo
    from ..Runners.Map2DRunner import PaintProfilesGrid

    CD = dict(TNG_COSMO_DICT)
    COSMO = bcosmo.cosmology_from_dict(CD)
    rng = np.random.default_rng(seed)
    masses = _tinker_sample(rng, COSMO, 1.0, L ** 3)
    n_halos = masses.size
    cat = utils.HaloNDCatalog(x=rng.uniform(0, L, n_halos),
                              y=rng.uniform(0, L, n_halos),
                              z=rng.uniform(0, L, n_halos),
                              M=masses, redshift=0.0, cosmo=CD)

    dmo_tab = utils.TabulatedProfile(
        Profiles.DarkMatter(**BPAR_S19_FIG2), COSMO)
    dmo_tab.setup_interpolator(z_min=0.0, z_max=0.05, N_samples_z=2,
                               z_linear_sampling=True,
                               M_min=3e12, M_max=5e15, N_samples_Mass=12,
                               R_min=1e-3, R_max=60, N_samples_R=64,
                               verbose=False)
    bins = (np.arange(N) + 0.5) * (L / N)
    gm0 = utils.GriddedMap(map=np.zeros((N, N, N)), bins=bins, cosmo=CD,
                           redshift=0.0)
    mass_map = PaintProfilesGrid(cat, gm0, epsilon_max=5, model=dmo_tab,
                                 include_pixel_size=True, halo_batch=64,
                                 verbose=False).process()
    rho_m = float(bcosmo.core.rho_x(COSMO, 1.0, species="matter",
                                    is_comoving=True))
    M_box = rho_m * L ** 3
    # sanity: a realistic collapsed fraction (calibration run: 0.407)
    assert 0.3 < mass_map.sum() / M_box < 0.5, mass_map.sum() / M_box
    return cat, mass_map + (M_box - mass_map.sum()) / N ** 3


def box_pk(field, L):
    """Isotropically binned P(k) of a cubic box (np.fft, host-side)."""
    N = field.shape[0]
    delta = field / field.mean() - 1.0
    fk = np.fft.rfftn(delta) * (L / N) ** 3
    p3 = np.abs(fk) ** 2 / L ** 3
    kf = 2 * np.pi / L
    kx = np.fft.fftfreq(N, 1.0 / N) * kf
    kz = np.fft.rfftfreq(N, 1.0 / N) * kf
    kk = np.sqrt(kx[:, None, None] ** 2 + kx[None, :, None] ** 2
                 + kz[None, None, :] ** 2)
    b = np.arange(0.5, N // 2) * kf
    w = np.digitize(kk.ravel(), b)
    c = np.bincount(w, minlength=b.size + 1)
    s = np.bincount(w, weights=p3.ravel(), minlength=b.size + 1)
    cen = np.concatenate([[0], b]) + kf / 2
    g = c > 0
    return cen[g], (s / np.maximum(c, 1))[g]


def box_suppression(cat, mass_map, DMO, DMB, eps_max, k_eval_h,
                    L=128.0, rdelta=False):
    """Baryonify the box with (DMO, DMB) and return the P(k) ratio at
    the requested k [h/Mpc]."""
    from .. import cosmo as bcosmo
    from .. import utils
    from ..Runners.Map2DRunner import BaryonifyGrid
    from ..Profiles.BaryonCorrection import Baryonification3D

    CD = dict(TNG_COSMO_DICT)
    H = CD["h"]
    COSMO = bcosmo.cosmology_from_dict(CD)
    N = mass_map.shape[0]
    model = Baryonification3D(DMO, DMB, COSMO, epsilon_max=eps_max)
    model.setup_interpolator(z_min=0.0, z_max=0.05, N_samples_z=2,
                             z_linear_sampling=True,
                             M_min=3e12, M_max=5e15, N_samples_Mass=12,
                             R_min=1e-4, R_max=300,
                             N_samples_R=2000 if rdelta else 500,
                             Rdelta_sampling=rdelta, verbose=False)
    bins = (np.arange(N) + 0.5) * (L / N)
    gm = utils.GriddedMap(map=mass_map, bins=bins, cosmo=CD, redshift=0.0)
    new_map = BaryonifyGrid(cat, gm, epsilon_max=eps_max, model=model,
                            halo_batch=64, verbose=False).process()
    k0, p0 = box_pk(mass_map, L)
    k1, p1 = box_pk(new_map, L)
    r = p1 / p0
    return [float(np.interp(kh * H, k0, r)) for kh in k_eval_h]


def deltapk_s19_residuals(csv_path=None, k_eval_h=(1.0, 3.0),
                          mc_keys=(("Mc1e14", 1e14 / H_TNG),
                                   ("Mc4e14", 4e14 / H_TNG)),
                          box=None, verbose=False):
    """S19 ΔP(k) vs the digitized Fig. 2 M_c curves. Returns rows
    [{curve, k_h, ratio, fig2, resid}]. Calibration (2026-08):
    ours/S19 = 0.940/0.942 and 0.806/0.831 at M_c=1e14/h;
    0.925/0.892 and 0.776/0.746 at 4e14/h."""
    from .. import Profiles

    cat, mass_map = box if box is not None else s19_box()
    curves = fig2_curves(csv_path)
    rows = []
    for key, M_c in mc_keys:
        par = dict(BPAR_S19_FIG2, M_c=M_c)
        r = box_suppression(cat, mass_map,
                            Profiles.DarkMatterOnly(**par),
                            Profiles.DarkMatterBaryon(**par),
                            eps_max=10, k_eval_h=list(k_eval_h))
        x, y = curves[key]
        for kh, ours in zip(k_eval_h, r):
            want = float(np.interp(kh, x, y))
            rows.append(dict(curve=key, k_h=kh, ratio=round(ours, 4),
                             fig2=round(want, 4),
                             resid=round(ours - want, 4)))
            if verbose:
                print(f"deltaPk {key} k={kh}: ours {ours:.4f} "
                      f"Fig2 {want:.4f} diff {ours - want:+.4f}")
    return rows


def tiled_vs_scatter_residual(nside=64, n_halos=300, seed=7):
    """Max per-pixel relative residual between the tiled (scatter-free)
    and the scatter baryonify paths on a random shell — the map-parity
    pin between the two independent phase-A/B engines."""
    import jax.numpy as jnp
    from .. import Profiles, Runners, utils
    from .. import cosmo as bcosmo
    from ..Profiles.BaryonCorrection import Baryonification2D

    CD = dict(TNG_COSMO_DICT)
    COSMO = bcosmo.cosmology_from_dict(CD)
    rng = np.random.default_rng(seed)
    cat = utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n_halos),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n_halos))),
        M=10 ** rng.uniform(13.5, 15.0, n_halos),
        z=rng.uniform(0.1, 0.4, n_halos), cosmo=CD)
    DMO = Profiles.DarkMatterOnly(**BPAR_S19_FIG2)
    DMB = Profiles.DarkMatterBaryon(**BPAR_S19_FIG2)
    model = Baryonification2D(DMO, DMB, COSMO, epsilon_max=20)
    model.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=4,
                             M_min=1e13, M_max=3e15, N_samples_Mass=8,
                             R_min=1e-3, R_max=50, N_samples_R=64,
                             verbose=False)
    npix = 12 * nside * nside
    raw = rng.exponential(1.0, npix)
    outs = {}
    for dep in ("auto", "scatter"):
        shell = utils.LightconeShell(map=raw.copy(), cosmo=CD)
        outs[dep] = Runners.BaryonifyShell(
            cat, shell, epsilon_max=20, model=model, halo_batch=64,
            deposit=dep, regrid="scatter", dtype=jnp.float32,
            verbose=False).process()
    scale = np.abs(outs["scatter"]).max()
    resid = np.abs(outs["auto"] - outs["scatter"]).max() / scale
    return dict(max_rel_residual=float(resid), nside=nside,
                n_halos=n_halos)
