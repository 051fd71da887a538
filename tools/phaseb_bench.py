"""Phase-B benchmark: stencil vs scatter regrid at a given NSIDE.

Times the two phase-B implementations on identical inputs (device-only,
no host transfers in the timed region), plus tiled phase A for context.

Usage:  python tools/phaseb_bench.py [--nside 1024] [--halos 18512]
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
    npix = 12 * nside * nside
    cat, shell = bench.make_inputs(nside, n_halos, map_dtype=np.float32)
    model = bench.build_displacement_table()

    rdt = jnp.float32
    runner = Runners.BaryonifyShell(cat, shell, epsilon_max=20,
                                    model=model, halo_batch=8192,
                                    verbose=False, n_size_buckets=8,
                                    regrid_dtype=rdt)
    out = runner.process()          # warmup: compiles + host prep caches
    assert np.isfinite(out).all()

    hkey = next(k for k in runner._compiled if k[0] == "hostprep")
    hd, extras, curve_meta = runner._compiled[hkey]
    orig_np = np.asarray(shell.map, dtype=np.float64)
    old_sum = orig_np.sum()
    orig_dev = runner._device_map(orig_np, rdt, old_sum)

    def best(f, n=args.repeats):
        ts = []
        for _ in range(n):
            t0 = time.time()
            r = f()
            r.block_until_ready()
            ts.append(time.time() - t0)
        return min(ts), r

    # phase A -> tiled acc (stencil input)
    t_acc, acc = best(lambda: runner._tiled_phase_a(
        hd, extras, curve_meta, nside, npix, return_acc=True))

    # phase A -> flat offsets (scatter input)
    t_flat, po = best(lambda: runner._tiled_phase_a(
        hd, extras, curve_meta, nside, npix))

    # stencil phase B (excl detection + 9-neighbour gather + complement)
    t_sten, _ = best(lambda: runner._regrid_stencil(
        nside, npix, rdt, acc, orig_dev, host_sum=old_sum))

    # scatter phase B (bilinear weights + 4*npix scatter-add)
    ang = runner._pixel_angles(nside, npix, rdt)
    t_scat, _ = best(lambda: runner._regrid(
        nside, npix, rdt, ang, po, orig_dev))

    print(json.dumps({
        "nside": nside, "n_halos": n_halos,
        "phase_a_tiled_acc_s": round(t_acc, 3),
        "phase_a_flat_s": round(t_flat, 3),
        "phase_b_stencil_s": round(t_sten, 3),
        "phase_b_scatter_s": round(t_scat, 3),
        "stencil_speedup": round(t_scat / t_sten, 2),
    }))


if __name__ == "__main__":
    main()
