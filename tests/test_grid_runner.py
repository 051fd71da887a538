"""Grid runner tests: conservative deposit golden checks + end-to-end
baryonify/paint on 2D and 3D grids."""

import numpy as np
import jax.numpy as jnp
import pytest

from baryonforge_tpu import Profiles, utils
from baryonforge_tpu.Runners.Map2DRunner import (BaryonifyGrid,
                                                 PaintProfilesGrid)
from baryonforge_tpu.ops.scatter import deposit_2d, deposit_3d
from baryonforge_tpu.Profiles.BaryonCorrection import (Baryonification2D,
                                                       Baryonification3D)
from defaults import COSMO, COSMO_DICT, bpar_S19

RNG = np.random.default_rng(31)


# ---------------------------------------------------------------------------
# deposit kernels: golden values + conservation
# ---------------------------------------------------------------------------
def test_deposit_2d_integer_position():
    g = np.asarray(deposit_2d(jnp.zeros((4, 4)),
                              jnp.array([[1.0, 2.0]]), jnp.array([3.0])))
    assert g[1, 2] == 3.0 and g.sum() == 3.0


def test_deposit_2d_fractional():
    g = np.asarray(deposit_2d(jnp.zeros((4, 4)),
                              jnp.array([[0.25, 1.5]]), jnp.array([1.0])))
    # overlap areas: (0.75, 0.25) x (0.5, 0.5)
    np.testing.assert_allclose(g[0, 1], 0.375)
    np.testing.assert_allclose(g[0, 2], 0.375)
    np.testing.assert_allclose(g[1, 1], 0.125)
    np.testing.assert_allclose(g[1, 2], 0.125)
    np.testing.assert_allclose(g.sum(), 1.0)


def test_deposit_periodic_wrap():
    g = np.asarray(deposit_2d(jnp.zeros((4, 4)),
                              jnp.array([[3.5, -0.5]]), jnp.array([1.0])))
    np.testing.assert_allclose(g.sum(), 1.0)
    # wraps across both edges
    np.testing.assert_allclose(g[3, 3], 0.25)
    np.testing.assert_allclose(g[0, 3], 0.25)
    np.testing.assert_allclose(g[3, 0], 0.25)
    np.testing.assert_allclose(g[0, 0], 0.25)


def test_deposit_3d_conservation():
    pos = jnp.array(RNG.uniform(-5, 20, (50, 3)))
    vals = jnp.array(RNG.uniform(0, 2, 50))
    g = np.asarray(deposit_3d(jnp.zeros((8, 8, 8)), pos, vals))
    np.testing.assert_allclose(g.sum(), float(vals.sum()), rtol=1e-12)


# ---------------------------------------------------------------------------
# end-to-end grid runners
# ---------------------------------------------------------------------------
def _nd_catalog(n, L, is2D, redshift=0.2):
    xyz = dict(x=RNG.uniform(0, L, n), y=RNG.uniform(0, L, n))
    if not is2D:
        xyz["z"] = RNG.uniform(0, L, n)
    return utils.HaloNDCatalog(M=10 ** RNG.uniform(13.5, 14.8, n),
                               redshift=redshift, cosmo=COSMO_DICT, **xyz)


def _grid_map(N, L, is2D):
    shape = (N, N) if is2D else (N, N, N)
    bins = (np.arange(N) + 0.5) * (L / N)
    return utils.GriddedMap(map=RNG.exponential(1.0, shape), bins=bins,
                            cosmo=COSMO_DICT, redshift=0.2)


def _model_3d():
    DMO = Profiles.DarkMatterOnly(**bpar_S19)
    DMB = Profiles.DarkMatterBaryon(**bpar_S19)
    m = Baryonification3D(DMO, DMB, COSMO, epsilon_max=20)
    m.setup_interpolator(z_min=0.1, z_max=0.3, N_samples_z=2,
                         M_min=1e13, M_max=1e15, N_samples_Mass=5,
                         R_min=1e-3, R_max=50, N_samples_R=48,
                         verbose=False)
    return m


MODEL3D = _model_3d()


def test_baryonify_grid_3d_mass_conservation():
    gm = _grid_map(32, 256.0, is2D=False)
    cat = _nd_catalog(20, 256.0, is2D=False)
    out = BaryonifyGrid(cat, gm, epsilon_max=20, model=MODEL3D,
                        halo_batch=8).process()
    assert out.shape == gm.map.shape
    np.testing.assert_allclose(out.sum(), gm.map.sum(), rtol=1e-10)
    assert not np.allclose(out, gm.map)


def test_baryonify_grid_2d():
    DMO = Profiles.DarkMatterOnly(**bpar_S19, proj_cutoff=100)
    DMB = Profiles.DarkMatterBaryon(**bpar_S19, proj_cutoff=100)
    m2 = Baryonification2D(DMO, DMB, COSMO, epsilon_max=20)
    m2.setup_interpolator(z_min=0.1, z_max=0.3, N_samples_z=2,
                          M_min=1e13, M_max=1e15, N_samples_Mass=5,
                          R_min=1e-3, R_max=50, N_samples_R=48,
                          verbose=False)
    gm = _grid_map(64, 256.0, is2D=True)
    cat = _nd_catalog(16, 256.0, is2D=True)
    out = BaryonifyGrid(cat, gm, epsilon_max=20, model=m2,
                        halo_batch=8).process()
    np.testing.assert_allclose(out.sum(), gm.map.sum(), rtol=1e-10)


def test_paint_grid_3d_against_direct():
    # single halo, direct comparison of painted density values
    tab = utils.TabulatedProfile(Profiles.DarkMatter(**bpar_S19), COSMO)
    tab.setup_interpolator(z_min=0.1, z_max=0.3, N_samples_z=3,
                           M_min=1e13, M_max=1e15, N_samples_Mass=6,
                           R_min=1e-3, R_max=60, N_samples_R=64,
                           verbose=False)
    N, L = 32, 64.0
    bins = (np.arange(N) + 0.5) * (L / N)
    gm = utils.GriddedMap(map=np.zeros((N, N, N)), bins=bins,
                          cosmo=COSMO_DICT, redshift=0.2)
    cat = utils.HaloNDCatalog(x=[32.0], y=[32.0], z=[32.0], M=[1e14],
                              redshift=0.2, cosmo=COSMO_DICT)
    out = PaintProfilesGrid(cat, gm, epsilon_max=10, model=tab,
                            include_pixel_size=False,
                            halo_batch=2).process()
    a = 1 / 1.2
    xg, yg, zg = np.meshgrid(bins, bins, bins, indexing="ij")
    r = np.sqrt((xg - 32) ** 2 + (yg - 32) ** 2 + (zg - 32) ** 2)
    sel = out > 0
    assert sel.sum() > 100
    expect = np.asarray(tab.real(COSMO, r[sel].ravel(), 1e14, a))
    np.testing.assert_allclose(out[sel], expect, rtol=1e-2)


def test_paint_grid_2d_pixel_size_factor():
    tab = utils.TabulatedProfile(
        Profiles.DarkMatter(**bpar_S19, proj_cutoff=100), COSMO)
    tab.setup_interpolator(z_min=0.1, z_max=0.3, N_samples_z=3,
                           M_min=1e13, M_max=1e15, N_samples_Mass=5,
                           R_min=1e-3, R_max=60, N_samples_R=48,
                           verbose=False)
    gm = _grid_map(64, 256.0, is2D=True)
    cat = _nd_catalog(8, 256.0, is2D=True)
    out1 = PaintProfilesGrid(cat, gm, epsilon_max=5, model=tab,
                             include_pixel_size=False,
                             halo_batch=4).process()
    out2 = PaintProfilesGrid(cat, gm, epsilon_max=5, model=tab,
                             include_pixel_size=True,
                             halo_batch=4).process()
    np.testing.assert_allclose(out2, out1 * gm.res ** 2, rtol=1e-12)


def test_grid_buckets_with_equal_shapes_keep_their_cutouts():
    """Two size buckets whose padded batches share a shape but not a
    cutout size must not share a compiled kernel: the large halos would
    be displaced inside the small cutout. Far from the small halos, the
    two-bucket run must equal a run of the large halos alone."""
    gm = _grid_map(64, 256.0, is2D=False)
    x = np.array([30.0, 90.0, 150.0, 210.0])

    def cat(big_only):
        xs = x if big_only else np.concatenate([x, x])
        ys = np.full(4, 64.0) if big_only else np.repeat([64.0, 192.0], 4)
        M = np.full(4, 1e15) if big_only else np.repeat([1e15, 1e13], 4)
        return utils.HaloNDCatalog(x=xs, y=ys, z=np.full(xs.size, 128.0),
                                   M=M, redshift=0.2, cosmo=COSMO_DICT)

    both = BaryonifyGrid(cat(False), gm, epsilon_max=20, model=MODEL3D,
                         halo_batch=4, n_size_buckets=2).process()
    big = BaryonifyGrid(cat(True), gm, epsilon_max=20, model=MODEL3D,
                        halo_batch=4, n_size_buckets=1).process()
    half = slice(0, 32)                        # y < 128: large halos only
    assert not np.allclose(big[:, half], gm.map[:, half])
    np.testing.assert_allclose(both[:, half], big[:, half], rtol=0,
                               atol=1e-9 * np.abs(big).max())
