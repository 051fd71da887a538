"""Data-cache invalidation: runners key their prepared-batch / tile-bucket
/ uploaded-map / curve caches on CONTENT tokens, so in-place mutation of a
catalog or map between process() calls, or swapping the model on a live
runner, must give the same result as a freshly built runner (the
reference rebuilds everything per Runner construction,
HealpixRunner.py:235-373, so it has no such staleness surface)."""

import numpy as np
import pytest

from baryonforge_tpu import Profiles, Runners, utils
from baryonforge_tpu.Profiles.BaryonCorrection import Baryonification2D
from defaults import COSMO, COSMO_DICT, bpar_S19

NSIDE = 64
NPIX = 12 * NSIDE * NSIDE
RNG = np.random.default_rng(23)


def _catalog(n=40, seed=3):
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    M = 10 ** rng.uniform(13.5, 15.0, n)
    z = rng.uniform(0.1, 0.4, n)
    return utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                      cosmo=COSMO_DICT)


def _model():
    DMO = Profiles.DarkMatterOnly(**bpar_S19, proj_cutoff=100)
    DMB = Profiles.DarkMatterBaryon(**bpar_S19, proj_cutoff=100)
    model = Baryonification2D(DMO, DMB, COSMO, epsilon_max=20)
    model.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=3,
                             M_min=1e13, M_max=3e15, N_samples_Mass=5,
                             R_min=1e-3, R_max=50, N_samples_R=48,
                             verbose=False)
    return model


MODEL = _model()
RAW = RNG.exponential(1.0, NPIX)


def _runner(cat, shell):
    return Runners.BaryonifyShell(cat, shell, epsilon_max=20, model=MODEL,
                                  halo_batch=32, verbose=False)


def test_catalog_in_place_mutation_rekeys():
    cat = _catalog()
    shell = utils.LightconeShell(map=RAW.copy(), cosmo=COSMO_DICT)
    runner = _runner(cat, shell)
    out1 = runner.process()

    # mutate the catalog IN PLACE (same object identity, new content)
    cat.cat["ra"] = np.mod(cat.cat["ra"] + 40.0, 360.0)
    out2 = runner.process()

    fresh = _runner(_catalog(), utils.LightconeShell(map=RAW.copy(),
                                                     cosmo=COSMO_DICT))
    fresh.HaloLightConeCatalog.cat["ra"] = cat.cat["ra"]
    ref2 = fresh.process()

    assert not np.allclose(out2, out1)
    np.testing.assert_allclose(out2, ref2, rtol=1e-12, atol=1e-12)


def test_map_in_place_mutation_rekeys():
    cat = _catalog()
    other = RNG.exponential(2.0, NPIX)
    shell = utils.LightconeShell(map=RAW.copy(), cosmo=COSMO_DICT)
    runner = _runner(cat, shell)
    out1 = runner.process()

    shell.map[:] = other                    # in-place edit, same object
    out2 = runner.process()

    ref2 = _runner(_catalog(), utils.LightconeShell(
        map=other.copy(), cosmo=COSMO_DICT)).process()
    assert not np.allclose(out2, out1)
    np.testing.assert_allclose(out2, ref2, rtol=1e-12, atol=1e-12)


def test_model_swap_on_live_runner_rekeys():
    # serving pattern: same runner/geometry, new model curves. The old
    # model's table must not leak out of the prepared/curve caches.
    cat = _catalog()
    shell = utils.LightconeShell(map=RAW.copy(), cosmo=COSMO_DICT)
    runner = _runner(cat, shell)
    out1 = runner.process()

    import copy
    model2 = copy.copy(MODEL)
    vars(model2).pop("_bfg_token", None)    # fresh object, fresh token
    model2.raw_input_d = MODEL.raw_input_d * 0.5
    import jax.numpy as jnp
    model2._table = jnp.asarray(model2.raw_input_d)
    runner.model = model2
    out2 = runner.process()

    fresh = Runners.BaryonifyShell(
        _catalog(), utils.LightconeShell(map=RAW.copy(), cosmo=COSMO_DICT),
        epsilon_max=20, model=model2, halo_batch=32, verbose=False)
    ref2 = fresh.process()
    assert not np.allclose(out2, out1)
    np.testing.assert_allclose(out2, ref2, rtol=1e-12, atol=1e-12)


def test_table_rebuild_drops_identity_token():
    # setup_interpolator / load_table must pop the cache token so a live
    # runner re-prepares (object identity unchanged, content changed)
    import copy
    m = copy.copy(MODEL)
    vars(m).pop("_bfg_token", None)
    from baryonforge_tpu.Runners.HealpixRunner import object_token
    t1 = object_token(m)
    assert object_token(m) == t1            # stable while content fixed
    import tempfile, os
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.npz")
        m.save_table(path)
        m.load_table(path)
    assert object_token(m) != t1


def test_snapshot_catalog_in_place_mutation_rekeys():
    rng = np.random.default_rng(5)
    L, n_part, n_halo = 128.0, 3000, 25
    pos = rng.uniform(0, L, (n_part, 3))
    snap = utils.ParticleSnapshot(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                                  M=np.ones(n_part), L=L,
                                  cosmo=COSMO_DICT)
    hpos = rng.uniform(0, L, (n_halo, 3))
    M = 10 ** rng.uniform(13.5, 15.0, n_halo)
    cat = utils.HaloNDCatalog(x=hpos[:, 0], y=hpos[:, 1], z=hpos[:, 2],
                              M=M, redshift=0.25, cosmo=COSMO_DICT)
    runner = Runners.BaryonifySnapshot(cat, snap, epsilon_max=20,
                                       model=MODEL, verbose=False)
    out1 = runner.process()

    cat.cat["x"] = np.mod(cat.cat["x"] + 13.0, L)   # in-place move
    out2 = runner.process()

    cat_ref = utils.HaloNDCatalog(
        x=np.mod(hpos[:, 0] + 13.0, L), y=hpos[:, 1], z=hpos[:, 2],
        M=M, redshift=0.25, cosmo=COSMO_DICT)
    snap_ref = utils.ParticleSnapshot(x=pos[:, 0], y=pos[:, 1],
                                      z=pos[:, 2], M=np.ones(n_part), L=L,
                                      cosmo=COSMO_DICT)
    ref2 = Runners.BaryonifySnapshot(cat_ref, snap_ref, epsilon_max=20,
                                     model=MODEL,
                                     verbose=False).process()
    assert not np.allclose(np.stack([out2[c] for c in "xyz"]),
                           np.stack([out1[c] for c in "xyz"]))
    for c in "xyz":
        np.testing.assert_allclose(out2[c], ref2[c], rtol=1e-10,
                                   atol=1e-10)
