"""Benchmark: BaryonifyShell at NSIDE=1024 (the BASELINE.md primary metric).

Reference baseline: 18,512 halos in ~12-16 s on 1 CPU core with an S19
tabulated displacement (examples/04) => ~1,350 halos/s midpoint.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "halos/s", "vs_baseline": N/1350}

This module also holds the workload definition shared by ``chip_smoke.py``
and ``tools/``: the cosmology, the S19 parameters, the catalog draw and the
grids of the two tables. Tables are built in-process on the default device.
"""

import json
import os
import sys
import time

import numpy as np

H = 0.7
COSMO_DICT = dict(Omega_m=0.30, Omega_b=0.045, h=H, sigma8=0.8,
                  n_s=0.96, w0=-1.0)
BPAR = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / H, mu_beta=0.4,
            eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0,
            A=0.09 / 2, M1=2.5e11 / H, epsilon_h=0.015,
            a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2, delta=7)
# (z, M, R) grids of the S19 displacement table and the tSZ profile table
TABLE_GRID = dict(z_min=0.7, z_max=1.1, N_samples_z=8,
                  M_min=5e12, M_max=2e15, N_samples_Mass=20,
                  R_min=1e-3, R_max=60, N_samples_R=64)


def make_inputs(nside=1024, n_halos=18512, seed=7, map_dtype=np.float64):
    """The benchmark's halo catalog and shell: uniform sky positions,
    log-uniform masses in [1e13, 10^14.8], z in [0.8, 1.0], and an
    exponential random mass map."""
    from baryonforge_tpu import utils
    npix = 12 * nside * nside
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n_halos)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n_halos)))
    M = 10 ** rng.uniform(13.0, 14.8, n_halos)
    z = rng.uniform(0.8, 1.0, n_halos)
    cat = utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                     cosmo=COSMO_DICT)
    shell = utils.LightconeShell(
        map=rng.exponential(1.0, npix).astype(map_dtype), cosmo=COSMO_DICT)
    return cat, shell


def build_displacement_table(grid=None):
    """S19 ``Baryonification2D`` displacement table on ``TABLE_GRID``."""
    from baryonforge_tpu import Profiles
    from baryonforge_tpu import cosmo as bcosmo
    from baryonforge_tpu.Profiles.BaryonCorrection import Baryonification2D
    cosmo = bcosmo.cosmology_from_dict(COSMO_DICT)
    DMO = Profiles.DarkMatterOnly(**BPAR, proj_cutoff=100)
    DMB = Profiles.DarkMatterBaryon(**BPAR, proj_cutoff=100)
    model = Baryonification2D(DMO, DMB, cosmo, epsilon_max=20)
    model.setup_interpolator(**(grid or TABLE_GRID), verbose=False)
    return model


def build_tsz_table(grid=None):
    """tSZ pressure ``TabulatedProfile`` on ``TABLE_GRID``."""
    from baryonforge_tpu import Profiles, utils
    from baryonforge_tpu import cosmo as bcosmo
    cosmo = bcosmo.cosmology_from_dict(COSMO_DICT)
    tab = utils.TabulatedProfile(
        Profiles.Thermodynamic.ThermalSZ(
            Profiles.Thermodynamic.Pressure(**BPAR, proj_cutoff=100),
            proj_cutoff=100),
        cosmo)
    tab.setup_interpolator(**(grid or TABLE_GRID), verbose=False)
    return tab


def main():
    # persistent host-prep cache (tile binning; warmup amortization)
    os.environ.setdefault(
        "BFG_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bfg_cache"))
    import jax.numpy as jnp
    import baryonforge_tpu  # noqa: F401  (enables x64)
    from baryonforge_tpu import Runners

    n_halos = int(os.environ.get("BFG_BENCH_HALOS", 18512))
    nside = int(os.environ.get("BFG_BENCH_NSIDE", 1024))
    npix = 12 * nside * nside
    cat, shell = make_inputs(nside, n_halos)

    t0 = time.time()
    model = build_displacement_table()
    t_table = time.time() - t0
    print(f"# displacement table build: {t_table:.1f} s", file=sys.stderr)

    runner = Runners.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                                    halo_batch=4096, verbose=False,
                                    n_size_buckets=8,
                                    regrid_dtype=jnp.float32)

    # warmup: ahead-of-time compile of every kernel from a thread pool,
    # then one real call to flush the rest (persistent-cache hits)
    t0 = time.time()
    wrep = runner.warmup()
    t_aot = time.time() - t0
    out = runner.process()
    t_warm = time.time() - t0
    print(f"# warmup: {t_warm:.1f} s total ({t_aot:.1f} s concurrent AOT"
          f" of {wrep['n_compiles']} kernels, {wrep['n_failed']} failed;"
          f" rest = first full call)", file=sys.stderr)

    # device-only throughput: warm, fully-blocked per-phase times
    stage = runner.stencil_stage_times(nside, npix, jnp.float32)
    t_dev = (stage["phase_a_s"] + stage["combo_s"] + stage["finish_s"])
    dev_rate = n_halos / t_dev
    print(f"# device-only: {stage} -> {t_dev:.3f} s/call "
          f"= {dev_rate:.0f} halos/s", file=sys.stderr)

    # pipelined steady state: dispatch all repeats via process_async().
    # Call k's result download runs on a fetch thread while call k+1's
    # compute is dispatched, so the wall clock pays max(compute,
    # transfer) per call instead of their sum.
    n_rep = int(os.environ.get("BFG_BENCH_REPEATS", 8))
    t0 = time.time()
    futs = [runner.process_async() for _ in range(n_rep)]
    outs = [f.result() for f in futs]
    wall = time.time() - t0
    out = outs[-1]
    splits = [(f.timings.get("compute_s", float("nan")),
               f.timings.get("transfer_s", float("nan"))) for f in futs]
    compute_med = float(np.median([c for c, _ in splits]))
    transfer_med = float(np.median([t for _, t in splits]))
    print(f"# pipelined wall for {n_rep} calls: {wall:.2f} s", file=sys.stderr)
    print("# compute/transfer splits: "
          + str([f"{c:.2f}/{t:.2f}" for c, t in splits]), file=sys.stderr)

    if not np.isfinite(out).all():
        raise RuntimeError("non-finite pixels in the benchmark output")
    halos_per_s = n_halos * n_rep / wall
    baseline = 1350.0      # reference midpoint, 1 CPU core
    print(json.dumps({
        "metric": "baryonify_shell_nside1024_halos_per_s",
        "value": round(halos_per_s, 1),
        "unit": "halos/s",
        "vs_baseline": round(halos_per_s / baseline, 2),
        "pipelined_calls": n_rep,
        "wall_s": round(wall, 2),
        "compute_s_median": round(compute_med, 3),
        "transfer_s_median": round(transfer_med, 3),
        "splits_s": [[round(c, 2), round(t, 2)] for c, t in splits],
        "table_s": round(t_table, 1),
        "warmup_s": round(t_warm, 1),
        "warmup_aot_s": round(t_aot, 1),
        "n_compiles": wrep["n_compiles"],
        "transfer_mb": round(float(np.median(
            [f.timings.get("transfer_mb", 0.0) for f in futs])), 1),
        "link_mb_per_s": round(float(np.median(
            [f.timings.get("transfer_mb", 0.0)
             / max(f.timings.get("transfer_s", 1e-9), 1e-9)
             for f in futs])), 2),
        "device_s_per_call": round(t_dev, 3),
        "device_halos_per_s": round(dev_rate, 1),
        "device_vs_baseline": round(dev_rate / baseline, 2),
        "device_stage_s": stage,
    }))


if __name__ == "__main__":
    main()
