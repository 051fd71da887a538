"""BaryonifySnapshot throughput at >=1e6 particles.

Reference analog: BaryonForge's KDTree snapshot runner
(reference Runners/SnapshotRunner.py:176-275) loops halos on the host —
~1e3-1e4 halos/min at these densities. Here the native C++ cell list
builds per-halo neighbour lists once and the displacement sum runs as
bucketed fixed-shape device kernels.

Prints one JSON line with particles, halos, steady-state seconds and
halos/s.

Usage: python tools/snapshot_bench.py [--parts 1000000] [--halos 20000]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", type=int, default=1_000_000)
    ap.add_argument("--halos", type=int, default=20_000)
    ap.add_argument("--L", type=float, default=512.0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import baryonforge_tpu  # noqa: F401
    from baryonforge_tpu import Profiles, utils
    from baryonforge_tpu import cosmo as bcosmo
    from baryonforge_tpu.Profiles.BaryonCorrection import Baryonification3D
    from baryonforge_tpu.Runners.SnapshotRunner import BaryonifySnapshot

    h = 0.7
    cd = dict(Omega_m=0.30, Omega_b=0.045, h=h, sigma8=0.8,
              n_s=0.96, w0=-1.0)
    cosmo = bcosmo.cosmology_from_dict(cd)
    bpar = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / h, mu_beta=0.4,
                eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0,
                A=0.09 / 2, M1=2.5e11 / h, epsilon_h=0.015,
                a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2, delta=7)

    rng = np.random.default_rng(11)
    L = args.L
    snap = utils.ParticleSnapshot(
        x=rng.uniform(0, L, args.parts), y=rng.uniform(0, L, args.parts),
        z=rng.uniform(0, L, args.parts),
        M=np.ones(args.parts), L=L, cosmo=cd, redshift=0.2)
    cat = utils.HaloNDCatalog(
        x=rng.uniform(0, L, args.halos), y=rng.uniform(0, L, args.halos),
        z=rng.uniform(0, L, args.halos),
        M=10 ** rng.uniform(13.0, 14.8, args.halos),
        redshift=0.2, cosmo=cd)

    DMO = Profiles.DarkMatter(**bpar)
    DMB = Profiles.DarkMatter(**{**bpar, "epsilon": 2.0})
    model = Baryonification3D(DMO, DMB, cosmo, epsilon_max=20)
    t0 = time.time()
    model.setup_interpolator(z_min=0.1, z_max=0.3, N_samples_z=2,
                             M_min=5e12, M_max=2e15, N_samples_Mass=12,
                             R_min=1e-3, R_max=50, N_samples_R=48,
                             verbose=False)
    print(f"# table: {time.time()-t0:.1f} s", file=sys.stderr)

    runner = BaryonifySnapshot(cat, snap, epsilon_max=20, model=model,
                               verbose=False)
    t0 = time.time()
    out = runner.process()
    print(f"# warmup (incl. compile + cell list): {time.time()-t0:.1f} s",
          file=sys.stderr)
    times = []
    for _ in range(args.repeats):
        t0 = time.time()
        out = runner.process()
        times.append(time.time() - t0)
    for c in "xyz":
        assert np.isfinite(np.asarray(out[c])).all()
    best = min(times)
    print(json.dumps({
        "particles": args.parts, "halos": args.halos,
        "steady_s_best": round(best, 2),
        "steady_s_all": [round(t, 2) for t in times],
        "halos_per_s": round(args.halos / best, 1),
        "parts_per_s": round(args.parts / best, 1),
    }))


if __name__ == "__main__":
    main()
