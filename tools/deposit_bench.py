"""Throughput of the tiled deposit (ops/tiles.py phase A) on realistic
binned buckets, full-sweep vs pruned+windowed (refine_pairs).

Builds a random catalog, bins it to tiles exactly as the runner does,
and times the per-bucket deposit loop warm and fully blocked, for
displace and paint modes. Reports pair-evals/s.

Usage: python tools/deposit_bench.py [--nside 1024] [--halos 20000]
                                     [--nr 64] [--nc 16]
                                     [--paths full,windowed]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=1024)
    ap.add_argument("--halos", type=int, default=20000)
    ap.add_argument("--nr", type=int, default=64)
    ap.add_argument("--nc", type=int, default=24)
    ap.add_argument("--modes", default="displace,paint")
    ap.add_argument("--paths", default="full,windowed")
    ap.add_argument("--shape", default=None,
                    help="tiling as RBxK (default SkyTiling default)")
    ap.add_argument("--rad", default="0.2,2.0",
                    help="disc radius range in degrees (log-uniform)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--check", action="store_true",
                    help="compare windowed against full result")
    args = ap.parse_args()

    import jax.numpy as jnp
    from baryonforge_tpu.ops import tiles as T

    if args.shape:
        rb, kk = (int(x) for x in args.shape.lower().split("x"))
        tiling = T.SkyTiling(args.nside, ring_block=rb, seg_slots=kk)
    else:
        tiling = T.SkyTiling(args.nside)
    P = tiling.RB * tiling.K
    n, n_r = args.halos, args.nr
    rng = np.random.default_rng(0)

    u = rng.uniform(-1, 1, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    th = np.arccos(u)
    vh = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                   np.cos(th)], axis=1)
    # north-star-like disc radii (paint eps_max=5 is ~4x smaller: --rad)
    r_lo, r_hi = (float(x) for x in args.rad.split(","))
    radius = np.deg2rad(10 ** rng.uniform(np.log10(r_lo), np.log10(r_hi),
                                          n))
    chord_rad = 2 * np.sin(radius / 2)
    ln_r0 = float(np.log(1e-3))
    dlnr = np.log(60 / 1e-3) / (n_r - 1)
    inv = float(1.0 / dlnr)    # python float: jit traces it weak-typed
    D = rng.uniform(900, 1100, n)
    pack = dict(
        vh=jnp.asarray(vh),
        crit2=jnp.asarray(chord_rad ** 2, dtype=jnp.float32),
        lnDa=jnp.asarray(np.log(D), dtype=jnp.float32),
        afac=jnp.asarray(rng.uniform(0.4, 0.6, n), dtype=jnp.float32),
        invD=jnp.asarray(1.0 / D, dtype=jnp.float32),
        curves=jnp.asarray(rng.normal(0, 1, (n, n_r)).cumsum(1) * 1e-3,
                           dtype=jnp.float32))

    t_ids, h_ids = T.bin_halos_to_tiles(tiling, th, ph, radius)
    far, near = T.refine_pairs(tiling, t_ids, h_ids, vh, chord_rad,
                               inv_dlnr=inv, n_c=args.nc,
                               lnDa=np.log(D))
    n_all, n_far, n_near = t_ids.size, far[0].size, near[0].size
    print(f"# pairs: {n_all} binned, {n_all - n_far - n_near} pruned "
          f"({100 * (1 - (n_far + n_near) / n_all):.1f}%), "
          f"{n_far} far ({100 * n_far / (n_far + n_near):.1f}% of kept), "
          f"{n_near} near")

    full_buckets = T.bucket_tiles(t_ids, h_ids.astype(np.int64))
    far_b = T.bucket_tiles_binned(
        (far[0], far[1].astype(np.int64), far[2]),
        T.window_tags(inv, args.nc))
    win_buckets = far_b + T.bucket_tiles(near[0],
                                         near[1].astype(np.int64))
    # per-tile window classes: same rows/padding as full, narrower sweep
    kt = np.concatenate([far[0], near[0]])
    kh = np.concatenate([far[1], near[1]])
    cls = T.classify_tile_windows(tiling, kt, kh, vh, chord_rad,
                                  np.log(D), [(ln_r0, inv, n_r)])
    cls_buckets = T.bucket_tiles_classed(kt, kh.astype(np.int64), cls,
                                         (inv,))
    ncls = [int((cls == i).sum()) for i in range(5)]
    print(f"# class pair split (16/24/32/48/full): {ncls}")

    def npairs(buckets):
        return sum(b[0].size * b[1].shape[1] for b in buckets)

    results = {}
    for mode in args.modes.split(","):
        run = T.make_tile_deposit(tiling, n_r, mode=mode)
        far_full = [(t, h) for (t, h, _) in far_b]
        for path, buckets in (("full", full_buckets),
                              ("windowed", win_buckets),
                              ("classed", cls_buckets),
                              ("faronly-full", far_full),
                              ("faronly-win", far_b)):
            if path not in args.paths.split(","):
                continue

            def sweep():
                outs = []
                for b in buckets:
                    outs.append(run(b, pack, ln_r0, inv)[1])
                for o in outs:
                    o.block_until_ready()
                return outs

            outs = sweep()                   # compile + warm
            best = np.inf
            for _ in range(args.repeats):
                t0 = time.time()
                outs = sweep()
                best = min(best, time.time() - t0)
            pe = npairs(buckets) * P
            results[(mode, path)] = (best, buckets, outs)
            print(f"{mode:9s} {path:9s} "
                  f"nside={args.nside}: {best * 1e3:8.1f} ms  "
                  f"{pe / best / 1e9:6.2f} G pair-evals/s "
                  f"({npairs(buckets) / 1e6:.1f} M padded pairs)")
        if args.check and (mode, "full") in results:
            def tot(key):
                _, buckets, outs = results[key]
                trail = outs[0].shape[2:] if outs[0].ndim > 2 else ()
                acc = np.zeros((tiling.n_tiles, P) + trail, np.float64)
                for b, o in zip(buckets, outs):
                    np.add.at(acc, b[0], np.asarray(o, np.float64))
                return acc
            a = tot((mode, "full"))
            scale = np.abs(a).max() or 1.0
            for other in ("windowed", "classed"):
                if (mode, other) not in results:
                    continue
                b = tot((mode, other))
                print(f"          max |{other} - full| / max|full| = "
                      f"{np.abs(a - b).max() / scale:.3e}")


if __name__ == "__main__":
    main()
