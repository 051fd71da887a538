"""Host-side scan: padded-pair work (padded pairs x P) of the tiled
deposit for candidate SkyTiling shapes, at north-star halo populations.

The tile kernel's work is (padded (tile, halo) pairs) x (P pixels per
tile); for small discs (paint eps_max=5) most of a 16x32 tile is masked
waste. This tool reproduces the north-star catalog (seed 7) host-side and
reports the work term for several (ring_block, seg_slots) shapes, for the
paint (eps=5) and displace (eps=20) radius distributions — pure numpy,
no device.

Usage: python tools/tiling_scan.py [--nside 4096] [--halos 1000000]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=4096)
    ap.add_argument("--halos", type=int, default=1_000_000)
    ap.add_argument("--eps", default="5,20")
    ap.add_argument("--shapes", default="16x32,8x32,16x16,8x16,4x16,8x8")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from baryonforge_tpu import cosmo as bcosmo
    from baryonforge_tpu.cosmo import massdef as _md
    from baryonforge_tpu.ops import tiles as T

    cosmo = bcosmo.Cosmology(Omega_m=0.30, Omega_b=0.045, h=0.7,
                             sigma8=0.8, n_s=0.96, w0=-1.0)
    rng = np.random.default_rng(7)
    ra = rng.uniform(0, 360, args.halos)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, args.halos)))
    M = 10 ** rng.uniform(13.0, 14.8, args.halos)
    z = rng.uniform(0.8, 1.0, args.halos)
    a = 1.0 / (1.0 + z)
    R = np.asarray(_md.MassDef200c.get_radius(cosmo, M, a))
    from baryonforge_tpu.cosmo.core import angular_diameter_distance
    D = np.asarray(angular_diameter_distance(cosmo, a))
    theta = np.radians(90.0 - dec)
    phi = np.radians(ra)
    st = np.sin(theta)
    vh = np.stack([st * np.cos(phi), st * np.sin(phi),
                   np.cos(theta)], axis=1)

    for eps in [float(x) for x in args.eps.split(",")]:
        radius = R * eps / D
        chord_rad = 2.0 * np.sin(np.minimum(radius, np.pi) / 2.0)
        print(f"== eps_max={eps}: radius p50={np.median(radius):.4f} rad "
              f"p95={np.percentile(radius, 95):.4f}")
        for shp in args.shapes.split(","):
            rb, k = (int(x) for x in shp.split("x"))
            t0 = time.time()
            tiling = T.SkyTiling(args.nside, ring_block=rb, seg_slots=k)
            P = rb * k
            t_ids, h_ids = T.bin_halos_to_tiles(tiling, theta, phi,
                                                radius)
            far, near = T.refine_pairs(tiling, t_ids, h_ids, vh,
                                       chord_rad)
            kt = np.concatenate([far[0], near[0]])
            kh = np.concatenate([far[1], near[1]])
            buckets = T.bucket_tiles(kt, kh.astype(np.int64))
            padded = sum(b[0].size * b[1].shape[1] for b in buckets)
            kept = kt.size
            print(f"  {rb:2d}x{k:2d} (P={P:4d}, n_tiles={tiling.n_tiles}):"
                  f" kept {kept/1e6:7.2f}M pairs, padded"
                  f" {padded/1e6:7.2f}M ({padded/max(kept,1):.2f}x),"
                  f" work {padded*P/1e9:8.2f} G pix-evals,"
                  f" buckets {len(buckets)},"
                  f" host {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
