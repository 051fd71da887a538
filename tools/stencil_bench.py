"""Stage-level timing of the stencil phase B at a given NSIDE.

The stencil's cost is halo-count independent (exclusion is geometric in
practice: hot tiles are rare even at 1e6-halo density), so a small
catalog warms the same phase-B kernels cheaply. Reports the two
dispatches separately: ``combo`` (hot-tile detect + 3x3 gather stencil
over all tiles) and ``finish`` (flat view + scatter complement over the
excluded tiles), warm (second of two runs), fully blocked.

Usage: python tools/stencil_bench.py [--nside 4096] [--halos 50000]
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
    ap.add_argument("--nside", type=int, default=4096)
    ap.add_argument("--halos", type=int, default=50_000)
    args = ap.parse_args()

    import jax.numpy as jnp
    import baryonforge_tpu  # noqa: F401
    from baryonforge_tpu import Runners
    import bench

    nside, n_halos = args.nside, args.halos
    npix = 12 * nside * nside
    cat, shell = bench.make_inputs(nside, n_halos, map_dtype=np.float32)
    model = bench.build_displacement_table()

    runner = Runners.BaryonifyShell(cat, shell, epsilon_max=20,
                                    model=model, halo_batch=8192,
                                    verbose=False, n_size_buckets=8,
                                    regrid_dtype=jnp.float32)
    t0 = time.time()
    runner.process()
    print(f"# warmup: {time.time()-t0:.1f} s", file=sys.stderr)

    res = {"nside": nside, "n_halos": n_halos}
    times = runner.stencil_stage_times(nside, npix, jnp.float32)
    res.update(times)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
