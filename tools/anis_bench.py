"""Anisotropic-paint throughput vs plain paint at NSIDE=1024.

The bar: Anis within ~2x of plain paint. Both runners use the
same tSZ TabulatedProfile (bench.py's grid) so the
comparison isolates the paint2 kernel cost (two log-curve lookups + one
exp per pair, plus the Mtot canvas pre-paint).

Usage: python tools/anis_bench.py [--nside 1024] [--halos 18512]
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
    ap.add_argument("--nside", type=int, default=1024)
    ap.add_argument("--halos", type=int, default=18512)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax.numpy as jnp
    import baryonforge_tpu  # noqa: F401
    from baryonforge_tpu import Runners
    import bench

    nside, n_halos = args.nside, args.halos
    cat, shell = bench.make_inputs(nside, n_halos, map_dtype=np.float32)
    shell.redshift = 0.9
    tab = bench.build_tsz_table()

    res = {"nside": nside, "n_halos": n_halos}

    kw = dict(epsilon_max=5, halo_batch=8192, verbose=False,
              n_size_buckets=8, regrid_dtype=jnp.float32)
    paint = Runners.PaintProfilesShell(cat, shell, model=tab, **kw)
    t0 = time.time()
    paint.process()
    print(f"# paint warmup: {time.time()-t0:.1f} s", file=sys.stderr)
    ts = []
    for _ in range(args.repeats):
        t0 = time.time()
        paint.process()
        ts.append((time.time() - t0, paint.timings["compute_s"]))
    i = int(np.argmin([t[0] for t in ts]))
    res["paint_e2e_s"] = round(ts[i][0], 2)
    res["paint_compute_s"] = round(ts[i][1], 2)

    anis = Runners.PaintProfilesAnisShell(
        cat, shell, model=tab, Tracer_model=tab, Mtot_model=tab,
        background_val=1.0, global_tracer_fraction=0.1, **kw)
    t0 = time.time()
    anis.process()
    print(f"# anis warmup: {time.time()-t0:.1f} s", file=sys.stderr)
    ts = []
    for _ in range(args.repeats):
        t0 = time.time()
        anis.process()
        ts.append((time.time() - t0, anis.timings.get("compute_s", 0.0),
                   anis.timings.get("transfer_s", 0.0)))
    i = int(np.argmin([t[0] for t in ts]))
    res["anis_e2e_s"] = round(ts[i][0], 2)
    res["anis_compute_s"] = round(ts[i][1], 2)
    res["anis_transfer_s"] = round(ts[i][2], 2)
    res["anis_over_paint"] = round(res["anis_e2e_s"]
                                   / max(res["paint_e2e_s"], 1e-9), 2)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
