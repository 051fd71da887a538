"""Example: multi-chip halo-parallel execution over a JAX device mesh
(the analog of the reference's joblib SplitJoinParallel,
utils/Parallelize.py:218-320).

The halo batch axis is sharded over the mesh's 'halos' axis with
jax.shard_map; per-device partial maps are psum-reduced. On a CPU
host this demos with 8 virtual devices:

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     python examples/13_multichip_sharding.py
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), '..'))

import numpy as np

import baryonforge_tpu  # noqa: F401
import jax
from baryonforge_tpu import Profiles, Runners, utils, parallel
from baryonforge_tpu import cosmo as bcosmo


def main(nside=32, n_halos=200):
    h = 0.7
    cosmo_dict = dict(Omega_m=0.30, Omega_b=0.045, h=h, sigma8=0.8,
                      n_s=0.96, w0=-1.0)
    cosmo = bcosmo.cosmology_from_dict(cosmo_dict)
    bpar = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / h, mu_beta=0.4,
                eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0,
                A=0.09 / 2, M1=2.5e11 / h, epsilon_h=0.015,
                a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2, delta=7)
    rng = np.random.default_rng(5)
    cat = utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n_halos),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n_halos))),
        M=10 ** rng.uniform(13.5, 14.5, n_halos),
        z=rng.uniform(0.15, 0.45, n_halos), cosmo=cosmo_dict)
    npix = 12 * nside * nside
    shell = utils.LightconeShell(map=np.zeros(npix), cosmo=cosmo_dict)

    tab = utils.TabulatedProfile(Profiles.DarkMatter(
        **bpar, proj_cutoff=100), cosmo)
    tab.setup_interpolator(z_min=0.1, z_max=0.5, N_samples_z=3,
                           M_min=1e13, M_max=1e15, N_samples_Mass=6,
                           R_min=1e-3, R_max=60, N_samples_R=48,
                           verbose=False)

    n_dev = len(jax.devices())
    print(f"devices: {n_dev} ({jax.devices()[0].platform})")

    runner = Runners.PaintProfilesShell(cat, shell, epsilon_max=5,
                                        model=tab, halo_batch=16,
                                        verbose=False)
    single = runner.process()

    # shard the halo axis over every available device
    split = parallel.SplitJoinParallel(runner,
                                       mesh=parallel.halo_mesh(n_dev))
    sharded = split.process()

    print("max |sharded - single| =",
          float(np.abs(sharded - single).max()))
    print("map sum:", float(sharded.sum()))


if __name__ == "__main__":
    main()
