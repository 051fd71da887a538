"""End-to-end shell tests (reference test_healpix.py analog, plus stronger
numeric checks: mass conservation, displacement-free identity, painting
against direct evaluation)."""

import numpy as np
import jax.numpy as jnp
import pytest

from baryonforge_tpu import Profiles, Runners, utils
from baryonforge_tpu.Profiles.BaryonCorrection import Baryonification2D
from baryonforge_tpu.ops import healpix as hpx
from defaults import COSMO, COSMO_DICT, bpar_S19

NSIDE = 64
NPIX = 12 * NSIDE * NSIDE
RNG = np.random.default_rng(11)


def _catalog(n=60):
    # uniform on the sphere (correct sin(dec) sampling, ref test_healpix)
    ra = RNG.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(RNG.uniform(-1, 1, n)))
    M = 10 ** RNG.uniform(13.5, 15.0, n)
    z = RNG.uniform(0.1, 0.4, n)
    return utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                      cosmo=COSMO_DICT)


def _displacement_model():
    DMO = Profiles.DarkMatterOnly(**bpar_S19, proj_cutoff=100)
    DMB = Profiles.DarkMatterBaryon(**bpar_S19, proj_cutoff=100)
    model = Baryonification2D(DMO, DMB, COSMO, epsilon_max=20)
    model.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=4,
                             M_min=1e13, M_max=3e15, N_samples_Mass=6,
                             R_min=1e-3, R_max=50, N_samples_R=48,
                             verbose=False)
    return model


MODEL = _displacement_model()
CATALOG = _catalog()


def test_baryonify_shell_mass_conservation():
    raw = RNG.exponential(1.0, NPIX)          # positive mass map
    shell = utils.LightconeShell(map=raw, cosmo=COSMO_DICT)
    runner = Runners.BaryonifyShell(CATALOG, shell, epsilon_max=20,
                                    model=MODEL, halo_batch=32)
    out = runner.process()
    assert out.shape == (NPIX,)
    np.testing.assert_allclose(out.sum(), raw.sum(), rtol=1e-8)
    # the field must actually change where halos displace mass
    assert not np.allclose(out, raw)


def test_baryonify_shell_negative_map_values():
    raw = RNG.normal(0.0, 1.0, NPIX)          # signed map (ref does this too)
    shell = utils.LightconeShell(map=raw, cosmo=COSMO_DICT)
    runner = Runners.BaryonifyShell(CATALOG, shell, epsilon_max=20,
                                    model=MODEL, halo_batch=32)
    out = runner.process()
    np.testing.assert_allclose(out.sum(), raw.sum(), rtol=1e-8, atol=1e-8)


def test_baryonify_zero_displacement_is_identity():
    # displacement table of zeros -> regrid must reproduce the map exactly
    class ZeroModel:
        p_keys = []

        def displacement(self, r, M, a):
            return jnp.zeros_like(jnp.asarray(r))

    raw = RNG.exponential(1.0, NPIX)
    shell = utils.LightconeShell(map=raw, cosmo=COSMO_DICT)
    runner = Runners.BaryonifyShell(CATALOG, shell, epsilon_max=20,
                                    model=ZeroModel(), halo_batch=32)
    out = runner.process()
    np.testing.assert_allclose(out, raw, rtol=1e-6, atol=1e-9)


def test_paint_profiles_shell():
    tab = utils.TabulatedProfile(Profiles.DarkMatterBaryon(
        **bpar_S19, proj_cutoff=100), COSMO)
    tab.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=4,
                           M_min=1e13, M_max=3e15, N_samples_Mass=6,
                           R_min=1e-3, R_max=60, N_samples_R=48,
                           verbose=False)
    shell = utils.LightconeShell(map=np.zeros(NPIX), cosmo=COSMO_DICT)
    runner = Runners.PaintProfilesShell(CATALOG, shell, epsilon_max=5,
                                        model=tab, halo_batch=32)
    out = runner.process()
    assert out.shape == (NPIX,)
    assert np.all(np.isfinite(out))
    assert out.sum() > 0          # something was painted
    # painted flux concentrates around halos: top 1% of pixels carry most
    frac = np.sort(out)[-NPIX // 100:].sum() / out.sum()
    assert frac > 0.5


def test_paint_single_halo_matches_direct_eval():
    # one halo at a known position: painted pixel values must equal the
    # profile evaluated at the pixel distances
    cat = utils.HaloLightConeCatalog(ra=[40.0], dec=[10.0], M=[1e15],
                                     z=[0.2], cosmo=COSMO_DICT)
    tab = utils.TabulatedProfile(Profiles.DarkMatterBaryon(
        **bpar_S19, proj_cutoff=100), COSMO)
    tab.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=4,
                           M_min=1e13, M_max=3e15, N_samples_Mass=6,
                           R_min=1e-3, R_max=60, N_samples_R=64,
                           verbose=False)
    shell = utils.LightconeShell(map=np.zeros(NPIX), cosmo=COSMO_DICT)
    out = Runners.PaintProfilesShell(cat, shell, epsilon_max=5,
                                     model=tab, halo_batch=4).process()

    from baryonforge_tpu.cosmo import core as ccore
    a = 1 / 1.2
    D = float(ccore.angular_diameter_distance(COSMO, a)[0])
    R = float(Runners.HealpixRunner._massdef.MassDef200c.get_radius(
        COSMO, 1e15, a))
    theta0, phi0 = np.radians(90 - 10.0), np.radians(40.0)
    vecs = np.asarray(hpx.pix2vec(NSIDE, jnp.arange(NPIX)))
    c = np.array([np.sin(theta0) * np.cos(phi0),
                  np.sin(theta0) * np.sin(phi0), np.cos(theta0)])
    r_sep = np.linalg.norm(vecs * D - c * D, axis=1)
    inside = r_sep <= (5 * R / D) * D  # epsilon_max * R (phys, small-angle)
    sel = np.where(out > 0)[0]
    assert len(sel) > 0
    expect = np.asarray(tab.projected(COSMO, r_sep[sel] / a, 1e15, a))
    np.testing.assert_allclose(out[sel], expect, rtol=1e-2)


def test_sparse_regrid_matches_dense():
    # the sparse (moved-pixels-only) regrid must agree with the dense one
    # and conserve mass; exercised directly at both dtypes
    from baryonforge_tpu.Runners.HealpixRunner import BaryonifyShell
    from functools import partial
    nside = 32
    npix = 12 * nside * nside
    rng = np.random.default_rng(5)
    po = np.zeros((npix, 2))
    sel = rng.random(npix) < 0.15
    po[sel] = (rng.random((sel.sum(), 2)) - 0.5) * 4e-3
    po = jnp.asarray(po)
    orig = jnp.asarray(rng.exponential(1.0, npix))
    p = jnp.arange(npix, dtype=jnp.int32)
    for rdt, rtol in ((jnp.float64, 1e-14), (jnp.float32, 1e-5)):
        th, ph = hpx.pix2ang(nside, p, rdt)
        ang = jnp.stack([th, ph], 1)
        dense = np.asarray(BaryonifyShell._phase_b(
            nside, npix, rdt, ang, po, orig))
        S = 1
        while S < sel.sum():
            S *= 2
        sparse = np.asarray(BaryonifyShell._phase_b_sparse(
            nside, npix, rdt, S, ang, po, orig))
        np.testing.assert_allclose(sparse, dense, rtol=rtol, atol=1e-12)
        np.testing.assert_allclose(sparse.sum(), np.asarray(orig).sum(),
                                   rtol=1e-6)
    # zero displacement through the sparse path is an exact identity
    th, ph = hpx.pix2ang(nside, p, jnp.float32)
    ang = jnp.stack([th, ph], 1)
    out0 = np.asarray(BaryonifyShell._phase_b_sparse(
        nside, npix, jnp.float32, 1, ang, jnp.zeros((npix, 2)), orig))
    assert np.array_equal(out0, np.asarray(orig, np.float32))


def test_chunked_regrid_matches_unchunked():
    # the source-chunked regrid (used at NSIDE>=2048 to bound HBM) must
    # match the single-pass result
    from baryonforge_tpu.Runners.HealpixRunner import BaryonifyShell
    nside = 32
    npix = 12 * nside * nside
    rng = np.random.default_rng(9)
    po = jnp.asarray((rng.random((npix, 2)) - 0.5) * 2e-3)
    orig = jnp.asarray(rng.exponential(1.0, npix))
    p = jnp.arange(npix, dtype=jnp.int32)
    th, ph = hpx.pix2ang(nside, p, jnp.float64)
    ang = jnp.stack([th, ph], 1)
    one = np.asarray(BaryonifyShell._phase_b(nside, npix, jnp.float64,
                                             ang, po, orig))
    many = np.asarray(BaryonifyShell._phase_b(nside, npix, jnp.float64,
                                              ang, po, orig,
                                              chunk_cap=npix // 6))
    np.testing.assert_allclose(many, one, rtol=1e-13, atol=1e-13)


def test_transfer_sparse_matches_dense_baryonify():
    """transfer='sparse' must return bit-for-bit the dense download, and
    the runner must record the compute/transfer timing split."""
    raw = RNG.exponential(1.0, NPIX)
    shell = utils.LightconeShell(map=raw, cosmo=COSMO_DICT)
    maps = {}
    for mode in ("dense", "sparse"):
        runner = Runners.BaryonifyShell(CATALOG, shell, epsilon_max=20,
                                        model=MODEL, halo_batch=32,
                                        transfer=mode)
        maps[mode] = runner.process()
        assert runner.timings["compute_s"] > 0
        assert runner.timings["transfer_s"] >= 0
    np.testing.assert_array_equal(maps["dense"], maps["sparse"])


def test_transfer_sparse_matches_dense_paint():
    tab = utils.TabulatedProfile(
        Profiles.Thermodynamic.Pressure(**bpar_S19, proj_cutoff=100),
        COSMO)
    tab.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=4,
                           M_min=1e13, M_max=3e15, N_samples_Mass=6,
                           R_min=1e-3, R_max=50, N_samples_R=48,
                           verbose=False)
    shell = utils.LightconeShell(map=np.zeros(NPIX), cosmo=COSMO_DICT)
    maps = {}
    for mode in ("dense", "sparse"):
        runner = Runners.PaintProfilesShell(CATALOG, shell,
                                            epsilon_max=5, model=tab,
                                            halo_batch=32, transfer=mode)
        maps[mode] = runner.process()
    np.testing.assert_array_equal(maps["dense"], maps["sparse"])


def test_scatter_buckets_with_equal_shapes_keep_their_windows():
    """Two size buckets whose padded batches share a shape (same halo
    count, same batch size) but not a disc window must not share a
    compiled kernel: the large discs would be cut to the small window.
    The scatter deposit must then agree with the tiled one."""
    n = 16
    ra = np.linspace(0, 337.5, n)
    dec = np.tile([-20.0, 20.0], n // 2)
    M = np.where(np.arange(n) % 2 == 0, 1e13, 2e15)
    cat = utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M,
                                     z=np.full(n, 0.2), cosmo=COSMO_DICT)
    raw = RNG.exponential(1.0, NPIX)
    outs = {}
    for dep in ("scatter", "auto"):
        shell = utils.LightconeShell(map=raw.copy(), cosmo=COSMO_DICT)
        outs[dep] = Runners.BaryonifyShell(
            cat, shell, epsilon_max=20, model=MODEL, halo_batch=8,
            n_size_buckets=2, deposit=dep, regrid="scatter",
            verbose=False).process()
    ref = outs["auto"]
    assert np.abs(outs["scatter"] - ref).max() / np.abs(ref).max() < 1e-3


def test_runner_follows_callers_default_device():
    """process() dispatches and fetches on worker threads; the caller's
    jax.default_device still decides where the runner's arrays live."""
    import jax
    dev = jax.devices()[1]
    shell = utils.LightconeShell(map=RNG.exponential(1.0, NPIX),
                                 cosmo=COSMO_DICT)
    runner = Runners.BaryonifyShell(CATALOG, shell, epsilon_max=20,
                                    model=MODEL, halo_batch=32,
                                    verbose=False)
    with jax.default_device(dev):
        out = runner.process()
    placed = [v for k, v in runner._compiled.items()
              if isinstance(k, tuple) and k[0] == "origmap"]
    assert placed and placed[0].devices() == {dev}
    np.testing.assert_allclose(out.sum(), np.asarray(shell.map).sum(),
                               rtol=1e-8)
