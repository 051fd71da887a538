"""Tile partition correctness: the tiling must be a disjoint cover of the
sphere with consistent forward (slot_pixels) and inverse (slot_index)
maps, and the halo binning must cover every tile a disc's pixels land in.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from baryonforge_tpu.ops import healpix as hpx
from baryonforge_tpu.ops.tiles import (SkyTiling, bin_halos_to_tiles,
                                       bucket_tiles)

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("nside", [8, 64, 128])
def test_partition_and_inverse(nside):
    import jax
    t = SkyTiling(nside, ring_block=8, seg_slots=18)
    npix = 12 * nside * nside

    # forward: enumerate every tile's slots (batched over tiles)
    pix_all, _, valid_all, _ = jax.vmap(t.slot_pixels)(
        jnp.asarray(t.tile_i0), jnp.asarray(t.tile_s),
        jnp.asarray(t.tile_S))
    cover = np.full(npix, -1, dtype=np.int64)
    for tid in range(t.n_tiles):
        pixv = np.asarray(pix_all[tid])[np.asarray(valid_all[tid])]
        assert np.all(cover[pixv] == -1), "tile overlap"
        cover[pixv] = tid
    assert np.all(cover >= 0), "tiles do not cover the sphere"

    # inverse: slot_index round trip for every pixel
    p = np.arange(npix)
    lin = np.asarray(t.slot_index(jnp.asarray(p)))
    assert lin.min() >= 0 and lin.max() < t.n_tiles * t.RB * t.K
    assert np.unique(lin).size == npix, "slot_index not injective"
    # the tile implied by the linear index matches the forward cover
    tid_of = lin // (t.RB * t.K)
    assert np.array_equal(tid_of, cover)


def test_slot_phi_matches_pix2ang():
    nside = 64
    t = SkyTiling(nside, ring_block=8, seg_slots=18)
    for tid in [0, t.n_tiles // 3, t.n_tiles - 1]:
        pix, phi, valid, theta_r = t.slot_pixels(
            jnp.asarray(t.tile_i0[tid]), jnp.asarray(t.tile_s[tid]),
            jnp.asarray(t.tile_S[tid]))
        v = np.asarray(valid)
        th_ref, ph_ref = hpx.pix2ang(nside, np.asarray(pix)[v])
        np.testing.assert_allclose(np.asarray(phi)[v], np.asarray(ph_ref),
                                   rtol=0, atol=1e-12)
        th_grid = np.broadcast_to(np.asarray(theta_r)[:, None],
                                  v.shape)[v]
        np.testing.assert_allclose(th_grid, np.asarray(th_ref), atol=1e-12)


def test_halo_binning_covers_disc_pixels():
    nside = 128
    t = SkyTiling(nside, ring_block=8, seg_slots=18)
    n = 60
    theta = np.arccos(RNG.uniform(-1, 1, n))
    phi = RNG.uniform(0, 2 * np.pi, n)
    radius = RNG.uniform(0.01, 0.3, n)
    # include pole-hugging halos
    theta[:4] = [0.005, 0.01, np.pi - 0.005, np.pi - 0.02]

    tiles, halos = bin_halos_to_tiles(t, theta, phi, radius)
    pair_set = set(zip(tiles.tolist(), halos.tolist()))

    # brute force: disc pixels via angular distance on all pixels
    npix = 12 * nside * nside
    th_p, ph_p = (np.asarray(x) for x in
                  hpx.pix2ang(nside, np.arange(npix)))
    vec_p = np.stack([np.sin(th_p) * np.cos(ph_p),
                      np.sin(th_p) * np.sin(ph_p), np.cos(th_p)], axis=1)
    lin = np.asarray(t.slot_index(jnp.asarray(np.arange(npix))))
    tile_of = lin // (t.RB * t.K)
    for h in range(n):
        vh = np.array([np.sin(theta[h]) * np.cos(phi[h]),
                       np.sin(theta[h]) * np.sin(phi[h]),
                       np.cos(theta[h])])
        cosd = vec_p @ vh
        inside = cosd >= np.cos(radius[h])
        for tid in np.unique(tile_of[inside]):
            assert (tid, h) in pair_set, (
                f"halo {h} disc touches tile {tid} but was not binned")


@pytest.mark.parametrize("nside,rb,k", [(64, 16, 32), (64, 8, 18),
                                        (128, 16, 32)])
def test_flat_view_matches_slot_index(nside, rb, k):
    """flat_view (belt transpose + cap gather) must equal the plain
    slot_index gather for every pixel."""
    import jax.numpy as jnp
    t = SkyTiling(nside, ring_block=rb, seg_slots=k)
    npix = 12 * nside * nside
    P = t.RB * t.K
    rng = np.random.default_rng(7)
    acc = jnp.asarray(rng.standard_normal((t.n_tiles, P, 2)))
    lin = np.asarray(t.slot_index(jnp.arange(npix, dtype=jnp.int32)))
    ref = np.asarray(acc).reshape(-1, 2)[lin]
    got = np.asarray(t.flat_view(acc))
    np.testing.assert_array_equal(got, ref)


def _paint_case(nside=32, n=24, n_r=16):
    """A tiling, its buckets and a paint-mode halo pack on random discs."""
    t = SkyTiling(nside, ring_block=8, seg_slots=18)
    theta = np.arccos(RNG.uniform(-1, 1, n))
    phi = RNG.uniform(0, 2 * np.pi, n)
    radius = RNG.uniform(0.05, 0.3, n)
    tiles, halos = bin_halos_to_tiles(t, theta, phi, radius)
    st, ct = np.sin(theta), np.cos(theta)
    vh = np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=1)
    host = dict(vh=vh, crit2=(2 * np.sin(radius / 2)) ** 2,
                lnDa=RNG.uniform(3, 5, n), afac=RNG.uniform(0.5, 2, n),
                curves=RNG.standard_normal((n, n_r)))
    pack = {k: jnp.asarray(v, dtype=jnp.float64 if k == "vh"
                           else jnp.float32) for k, v in host.items()}
    pack["invD"] = jnp.full(n, 1e-3, dtype=jnp.float32)
    return t, bucket_tiles(tiles, halos), host, pack


def test_tile_lookup_matches_numpy_lerp():
    """The tile kernel's per-pair curve lookup is exact linear
    interpolation: the paint sum of every slot equals a float64 numpy
    reference built from np.interp on the same pairs."""
    from baryonforge_tpu.ops.tiles import make_tile_deposit

    n_r, ln_r0, inv_dlnr = 16, 0.0, 4.0
    t, buckets, host, pack = _paint_case(n_r=n_r)
    run = make_tile_deposit(t, n_r, mode="paint")
    grid = np.arange(n_r)
    checked = 0
    for b in buckets:
        tids, out = run(b, pack, ln_r0, inv_dlnr)
        out = np.asarray(out)
        for row, (tid, hrow) in enumerate(zip(tids, b[1])):
            pix, _, valid, _ = t.slot_pixels(
                jnp.asarray(t.tile_i0[tid]), jnp.asarray(t.tile_s[tid]),
                jnp.asarray(t.tile_S[tid]))
            vp = np.asarray(hpx.pix2vec(t.nside, pix)).reshape(-1, 3)
            ref = np.zeros(vp.shape[0])
            for h in hrow[hrow >= 0]:
                chord2 = ((vp - host["vh"][h]) ** 2).sum(axis=1)
                x = (0.5 * np.log(np.maximum(chord2, 1e-30))
                     + host["lnDa"][h] - ln_r0) * inv_dlnr
                use = (x >= 0) & (x <= n_r - 1) & (chord2 <= host["crit2"][h])
                ref += np.where(use, np.interp(x, grid, host["curves"][h]),
                                0.0) * host["afac"][h]
            ref = np.where(np.asarray(valid).reshape(-1), ref, 0.0)
            np.testing.assert_allclose(out[row], ref, rtol=0,
                                       atol=2e-5 * max(1.0, np.abs(ref).max()))
            checked += int((ref != 0).sum())
    assert checked > 100


def test_tile_kernel_ignores_backend_name(monkeypatch):
    """The tile kernel takes no backend-dependent branch: the same
    inputs give the same sums whatever ``jax.default_backend()`` says."""
    import jax
    from baryonforge_tpu.ops.tiles import make_tile_deposit

    t, buckets, _, pack = _paint_case()
    outs = {}
    for name in ("cpu", "gpu", "tpu"):
        monkeypatch.setattr(jax, "default_backend", lambda n=name: n)
        run = make_tile_deposit(t, 16, mode="displace")
        outs[name] = [np.asarray(run(b, pack, 0.0, 4.0)[1])
                      for b in buckets]
    for name in ("gpu", "tpu"):
        for a, b in zip(outs[name], outs["cpu"]):
            np.testing.assert_array_equal(a, b)


def test_bucket_tiles_roundtrip():
    tiles = np.array([3, 3, 3, 7, 7, 9, 9, 9, 9, 9, 9, 9, 9, 9])
    halos = np.arange(tiles.size)
    buckets = bucket_tiles(tiles, halos, h_align=4)
    got = {}
    for tid_arr, hidx in buckets:
        for trow, hrow in zip(tid_arr, hidx):
            got[int(trow)] = sorted(int(x) for x in hrow if x >= 0)
    assert got == {3: [0, 1, 2], 7: [3, 4], 9: list(range(5, 14))}
