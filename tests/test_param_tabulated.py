"""Per-halo property (p_keys) flows: ParamTabulatedProfile painting and
displacement tables with other_params, through the shell runners."""

import numpy as np
import jax.numpy as jnp
import pytest

from baryonforge_tpu import Profiles, Runners, utils
from baryonforge_tpu.Profiles.BaryonCorrection import Baryonification3D
from defaults import COSMO, COSMO_DICT, bpar_S19

RNG = np.random.default_rng(88)
NSIDE = 32
NPIX = 12 * NSIDE * NSIDE


def test_param_tabulated_profile_readout():
    # table over an extra 'epsilon' axis: readout must interpolate it
    prof = Profiles.DarkMatter(**{**bpar_S19})
    tab = utils.ParamTabulatedProfile(prof, COSMO)
    tab.setup_interpolator(z_min=0.1, z_max=0.4, N_samples_z=3,
                           M_min=1e13, M_max=1e15, N_samples_Mass=5,
                           R_min=1e-2, R_max=30, N_samples_R=32,
                           other_params={"epsilon": np.array([2.0, 4.0,
                                                              6.0])},
                           verbose=False)
    assert tab.p_keys == ["epsilon"]
    r = np.geomspace(0.05, 5, 8)
    lo = np.asarray(tab.real(COSMO, r, 1e14, 0.8, epsilon=2.0))
    hi = np.asarray(tab.real(COSMO, r, 1e14, 0.8, epsilon=6.0))
    mid = np.asarray(tab.real(COSMO, r, 1e14, 0.8, epsilon=4.0))
    assert not np.allclose(lo, hi)
    between = (np.minimum(lo, hi) - 1e-9 <= mid) \
        & (mid <= np.maximum(lo, hi) + 1e-9)
    assert between.mean() > 0.8      # mostly monotone in the extra param
    # missing key must be rejected
    with pytest.raises(AssertionError):
        tab.real(COSMO, r, 1e14, 0.8)


def _catalog_with_eps(n=16):
    return utils.HaloLightConeCatalog(
        ra=RNG.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(RNG.uniform(-1, 1, n))),
        M=10 ** RNG.uniform(13.5, 14.5, n),
        z=RNG.uniform(0.15, 0.35, n), cosmo=COSMO_DICT,
        epsilon=RNG.uniform(2.0, 6.0, n))


def test_paint_shell_with_p_keys():
    cat = _catalog_with_eps()
    prof = Profiles.DarkMatter(**{**bpar_S19}, proj_cutoff=100)
    tab = utils.ParamTabulatedProfile(prof, COSMO)
    tab.setup_interpolator(z_min=0.1, z_max=0.4, N_samples_z=3,
                           M_min=1e13, M_max=1e15, N_samples_Mass=5,
                           R_min=1e-3, R_max=60, N_samples_R=32,
                           other_params={"epsilon": np.array([2.0, 4.0,
                                                              6.0])},
                           verbose=False)
    shell = utils.LightconeShell(map=np.zeros(NPIX), cosmo=COSMO_DICT)
    out = Runners.PaintProfilesShell(cat, shell, epsilon_max=5, model=tab,
                                     halo_batch=4).process()
    assert np.all(np.isfinite(out)) and out.sum() > 0


def test_param_tabulated_halo_curves_match_readout():
    # the p_keys fast path: halo_curves + raw curve_lookup must reproduce
    # the full N-D readout (the curves collapse (z, M, p) with the same
    # multilinear weights; only the r-lerp association differs)
    prof = Profiles.DarkMatter(**{**bpar_S19}, proj_cutoff=100)
    tab = utils.ParamTabulatedProfile(prof, COSMO)
    tab.setup_interpolator(z_min=0.1, z_max=0.4, N_samples_z=3,
                           M_min=1e13, M_max=1e15, N_samples_Mass=5,
                           R_min=1e-2, R_max=30, N_samples_R=32,
                           other_params={"epsilon": np.array([2.0, 4.0,
                                                              6.0])},
                           verbose=False)
    assert tab.curves_are_log is False
    M = 10 ** RNG.uniform(13.2, 14.8, 6)
    a = 1.0 / (1.0 + RNG.uniform(0.12, 0.38, 6))
    eps = RNG.uniform(2.2, 5.8, 6)
    r = np.geomspace(0.05, 10, 12)
    curves, ln_r0, dlnr = tab.halo_curves(M, a, kind="projected",
                                          epsilon=eps)
    for i in range(6):
        fast = np.asarray(tab.curve_lookup(curves[i], ln_r0, dlnr,
                                           jnp.asarray(r))) / a[i]
        want = np.asarray(tab.projected(COSMO, r, M[i], a[i],
                                        epsilon=eps[i]))
        np.testing.assert_allclose(fast, want, rtol=1e-5, atol=1e-30)


def test_paint_p_keys_tiled_matches_scatter():
    # tiled == scatter for a ParamTabulatedProfile
    # paint (raw curves; the p_keys column collapses into the curves)
    cat = _catalog_with_eps(24)
    prof = Profiles.DarkMatter(**{**bpar_S19}, proj_cutoff=100)
    tab = utils.ParamTabulatedProfile(prof, COSMO)
    tab.setup_interpolator(z_min=0.1, z_max=0.4, N_samples_z=3,
                           M_min=1e13, M_max=1e15, N_samples_Mass=5,
                           R_min=1e-3, R_max=60, N_samples_R=32,
                           other_params={"epsilon": np.array([2.0, 4.0,
                                                              6.0])},
                           verbose=False)
    nside = 64
    shell = utils.LightconeShell(map=np.zeros(12 * nside * nside),
                                 cosmo=COSMO_DICT)
    kw = dict(epsilon_max=5, model=tab, halo_batch=8, verbose=False,
              include_pixel_size=True)
    out_s = Runners.PaintProfilesShell(cat, shell, deposit="scatter",
                                       **kw).process()
    out_t = Runners.PaintProfilesShell(cat, shell, deposit="tiles",
                                       **kw).process()
    assert out_t.sum() > 0
    np.testing.assert_allclose(out_t, out_s,
                               atol=2e-3 * np.abs(out_s).max(), rtol=2e-3)
    assert np.abs(out_t - out_s).sum() < 1e-3 * out_s.sum()


@pytest.mark.slow
def test_baryonify_p_keys_tiled_matches_scatter():
    # tiled == scatter for a p_keys displacement run
    n = 24
    cat = utils.HaloLightConeCatalog(
        ra=RNG.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(RNG.uniform(-1, 1, n))),
        M=10 ** RNG.uniform(13.8, 14.8, n),
        z=RNG.uniform(0.15, 0.35, n), cosmo=COSMO_DICT,
        theta_ej=RNG.uniform(3.0, 6.0, n))
    DMO = Profiles.DarkMatterOnly(**bpar_S19)
    DMB = Profiles.DarkMatterBaryon(**bpar_S19)
    model = Baryonification3D(DMO, DMB, COSMO, epsilon_max=20)
    model.setup_interpolator(z_min=0.1, z_max=0.4, N_samples_z=2,
                             M_min=1e13, M_max=1e15, N_samples_Mass=6,
                             R_min=1e-3, R_max=50, N_samples_R=48,
                             other_params={"theta_ej": np.array([3.0,
                                                                 6.0])},
                             verbose=False)
    # unit level: per-halo curves + lookup == displacement() readout
    M = np.asarray(cat.cat["M"], dtype=float)
    a = 1.0 / (1.0 + np.asarray(cat.cat["z"], dtype=float))
    te = np.asarray(cat.cat["theta_ej"], dtype=float)
    curves, ln_r0, dlnr = model.halo_curves(M, a, theta_ej=te)
    r = np.geomspace(0.05, 10, 12)
    for i in range(4):
        fast = np.asarray(model.curve_lookup(curves[i], float(ln_r0),
                                             float(dlnr), jnp.asarray(r)))
        want = np.asarray(model.displacement(r, M[i], a[i],
                                             theta_ej=te[i]))
        # r stays well inside eps_max * R here, so displacement()'s
        # eps_max zeroing (which curve_lookup leaves to the runner)
        # never triggers
        np.testing.assert_allclose(fast, want, rtol=1e-5, atol=1e-12)

    nside = 64
    raw = RNG.exponential(1.0, 12 * nside * nside)
    shell = utils.LightconeShell(map=raw, cosmo=COSMO_DICT)
    kw = dict(epsilon_max=20, model=model, halo_batch=8, verbose=False)
    out_s = Runners.BaryonifyShell(cat, shell, deposit="scatter",
                                   **kw).process()
    out_t = Runners.BaryonifyShell(cat, shell, deposit="tiles",
                                   **kw).process()
    np.testing.assert_allclose(out_t.sum(), raw.sum(), rtol=1e-10)
    scale = np.abs(out_s - raw).max()
    assert scale > 0, "displacement did nothing"
    np.testing.assert_allclose(out_t, out_s, atol=0.02 * scale)
    moved = np.abs(out_s - raw).sum()
    assert np.abs(out_t - out_s).sum() < 3e-3 * moved


@pytest.mark.slow
def test_baryonify_shell_with_p_keys():
    # sweep a gas parameter (theta_ej): other_params sets it on BOTH
    # models (reference semantics, BaryonCorrection.py:226-227), but only
    # the DMB model uses it, so the displacement varies with the per-halo
    # property value
    n = 10
    cat = utils.HaloLightConeCatalog(
        ra=RNG.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(RNG.uniform(-1, 1, n))),
        M=10 ** RNG.uniform(13.5, 14.5, n),
        z=RNG.uniform(0.15, 0.35, n), cosmo=COSMO_DICT,
        theta_ej=RNG.uniform(3.0, 6.0, n))
    DMO = Profiles.DarkMatterOnly(**bpar_S19)
    DMB = Profiles.DarkMatterBaryon(**bpar_S19)
    model = Baryonification3D(DMO, DMB, COSMO, epsilon_max=20)
    model.setup_interpolator(z_min=0.1, z_max=0.4, N_samples_z=2,
                             M_min=1e13, M_max=1e15, N_samples_Mass=4,
                             R_min=1e-3, R_max=50, N_samples_R=32,
                             other_params={"theta_ej": np.array([3.0,
                                                                 6.0])},
                             verbose=False)
    assert model.p_keys == ["theta_ej"]
    # the table must actually vary with the extra parameter
    assert not np.allclose(model.raw_input_d[..., 0],
                           model.raw_input_d[..., 1])
    raw = RNG.exponential(1.0, NPIX)
    shell = utils.LightconeShell(map=raw, cosmo=COSMO_DICT)
    out = Runners.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                                 halo_batch=4).process()
    np.testing.assert_allclose(out.sum(), raw.sum(), rtol=1e-8)
    assert not np.allclose(out, raw)
