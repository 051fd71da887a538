"""Disjoint sky tiling for gather-style (scatter-free) HEALPix deposits.

The per-halo scatter-add of the baryonification hot loop (reference
per-halo loop: HealpixRunner.py:315-373) contends on shared pixels. This
module inverts the computation: instead of every halo scattering into its
disc pixels, the sphere is partitioned into static rectangular tiles
(ring blocks x phi sectors), halos are binned to the tiles their discs
overlap (host-side, cached), and one dense kernel per tile-bucket computes
every (pixel, halo) pair contribution with vectorized fma math — no
scatter at all. Tile outputs are written back as whole rows and the flat
map view is a single analytic-index gather.

Geometry notes (all closed-form, nothing tabulated):
  * tiles are addressed (block b, sector s); block b covers rings
    [1 + b*RB, 1 + (b+1)*RB); each ring's pixels split into S_b equal-phi
    sectors; a ring segment holds at most K slots (K chosen so
    nr_max/S_b <= K - 1).
  * slot (u, v) of tile (b, s): ring i = 1 + b*RB + u, j = j0(s) + v with
    j0(s) = ceil(s*nr/S - 0.5*shift) -- integer math, see _j0.
  * flat pixel -> (tile, slot) is likewise closed form (slot_index), so
    reassembly is a gather with computed indices, no stored permutation.

Pair math avoids catastrophic f32 cancellation by working in LOCAL tile
coordinates AND subtracting before squaring:
chord^2(p, h) = sum_i (dp_i - dh_i)^2 with dp = v_p - c_tile,
dh = v_h - c_tile (|d| <~ 0.1). The expanded |dp|^2 + |dh|^2 - 2 dp.dh
form cancels at sub-pixel separations (percent-level chord error at a
halo-center pixel); the difference form keeps relative error near
f32 eps * tile_size / chord.
"""

from functools import partial
import os
import numpy as np
import jax
import jax.numpy as jnp

from . import healpix as hpx


def _stencil_unroll(n):
    """Unroll factor of the stencil regrid's (du, dv) sweep loop.

    ``BFG_STENCIL_UNROLL``: an integer, or "full" (the default). Full
    unroll turns the sweep's dynamic-slice starts into constants, which
    lets XLA fuse the whole sweep; a partial factor trades run time for a
    smaller program and a faster compile. The default is not yet
    measured on the GPU.
    """
    v = os.environ.get("BFG_STENCIL_UNROLL", "full")
    if v == "full":
        return True
    try:
        k = int(v)
    except ValueError:
        return True
    return 1 if k <= 1 else min(k, n)

__all__ = ["SkyTiling", "bin_halos_to_tiles", "bucket_tiles",
           "refine_pairs"]


class SkyTiling:
    """Static tiling of a RING-ordered HEALPix sphere.

    Parameters
    ----------
    nside : int
    ring_block : rings per block (RB)
    seg_slots : slots per ring segment (K); the sector count is sized for
        the widest (equatorial) rings, S = ceil(4*nside / (K - 2)),
        uniformly across blocks (see __init__ for why), with belt-interior
        blocks tightened to S = 4*nside/K when that divides exactly.
    """

    def __init__(self, nside, ring_block=16, seg_slots=32):
        self.nside = int(nside)
        self.RB = int(ring_block)
        self.K = int(seg_slots)
        N = self.nside
        n_rings = 4 * N - 1
        self.n_blocks = -(-n_rings // self.RB)

        i0 = 1 + self.RB * np.arange(self.n_blocks)
        i_hi = np.minimum(i0 + self.RB - 1, n_rings)
        # Sector count S is sized for the 4N-pixel equatorial rings in
        # EVERY block (not per-block nr_max), deliberately: the stencil
        # regrid's vertical-neighbour gather requires the blocks above and
        # below a tile to share its S so neighbours are tile±S with
        # identical phi sectors (blocks where that fails fall back to the
        # scatter deposit). Polar-cap tiles are sparser than belt tiles as
        # a result; coverage stays exact. (The belt override below changes
        # S only on belt-interior blocks, in one contiguous run.)
        nr_max = np.full(self.n_blocks, 4 * N)
        self.S = np.maximum(1, -(-nr_max // (self.K - 2))).astype(np.int64)
        # belt-pure blocks (all rings in [N, 3N], nr = 4N = const): pick S
        # so segments are EXACTLY K pixels — then the tile-major layout of
        # those blocks is a pure transpose of flat ring order and the flat
        # view needs no gather there (flat_parts below)
        belt = (i0 >= N) & (i_hi <= 3 * N)
        if 4 * N % self.K == 0:
            self.S = np.where(belt, 4 * N // self.K, self.S)
        self._belt_exact = belt & (self.S * self.K == 4 * N)
        self.i0 = i0.astype(np.int64)
        self.tile_off = np.concatenate([[0], np.cumsum(self.S)])
        self.n_tiles = int(self.tile_off[-1])

        # per-tile host arrays
        self.tile_block = np.repeat(np.arange(self.n_blocks), self.S)
        self.tile_s = (np.arange(self.n_tiles)
                       - self.tile_off[self.tile_block])
        self.tile_i0 = self.i0[self.tile_block]
        self.tile_S = self.S[self.tile_block]

        # tile centers (unit vectors) + block theta ranges, for binning
        th_lo = _ring_theta_np(N, np.maximum(self.i0 - 0.5, 0.5))
        th_hi = _ring_theta_np(
            N, np.minimum(self.i0 + self.RB - 0.5, n_rings + 0.5))
        self.block_th_lo = th_lo
        self.block_th_hi = th_hi
        th_c = 0.5 * (th_lo + th_hi)[self.tile_block]
        ph_c = 2.0 * np.pi * (self.tile_s + 0.5) / self.tile_S
        st, ct = np.sin(th_c), np.cos(th_c)
        self.tile_center = np.stack(
            [st * np.cos(ph_c), st * np.sin(ph_c), ct], axis=1)

    @property
    def tile_crad(self):
        """Per-tile circumradius in CHORD units: an upper bound (f64
        exact + 1e-5 margin) on |v_pixel - tile_center| over the tile's
        valid slot pixel centers. Used by the pair pruning / windowed
        curve sweep (host classification and the device kernel must use
        the same bound). Computed lazily, cached on the instance."""
        if getattr(self, "_crad", None) is not None:
            return self._crad
        N, RB, K = self.nside, self.RB, self.K
        i = (self.tile_i0[:, None].astype(np.int64)
             + np.arange(RB, dtype=np.int64)[None, :])    # (n_tiles, RB)
        ok = (i >= 1) & (i <= 4 * N - 1)
        i_c = np.clip(i, 1, 4 * N - 1)
        north = i_c < N
        south = i_c > 3 * N
        nr = np.where(north, 4 * i_c,
                      np.where(south, 4 * (4 * N - i_c), 4 * N))
        sh = np.where(north | south, 1,
                      np.where((i_c - N) % 2 == 0, 1, 0))
        s = self.tile_s[:, None].astype(np.int64)
        S = self.tile_S[:, None].astype(np.int64)
        j0 = (2 * s * nr - sh * S + 2 * S - 1) // (2 * S)
        j1 = (2 * (s + 1) * nr - sh * S + 2 * S - 1) // (2 * S)
        seg = np.minimum(j1 - j0, K)
        ok &= seg > 0
        th_r = _ring_theta_np(N, i_c.astype(np.float64))
        dphi = 2.0 * np.pi / nr
        ph_c = 2.0 * np.pi * (self.tile_s + 0.5) / self.tile_S
        # ring-segment extreme pixel centers; max chord to the center is
        # attained at the larger |delta phi| endpoint on each ring
        phf = (j0 + 0.5 * sh) * dphi - ph_c[:, None]
        phl = (j0 + seg - 1 + 0.5 * sh) * dphi - ph_c[:, None]
        wrap = lambda a: np.abs(np.mod(a + np.pi, 2 * np.pi) - np.pi)
        dph = np.maximum(wrap(phf), wrap(phl))
        th_c = np.arccos(np.clip(self.tile_center[:, 2], -1, 1))
        cosd = (np.sin(th_r) * np.sin(th_c)[:, None] * np.cos(dph)
                + np.cos(th_r) * np.cos(th_c)[:, None])
        chord2 = np.where(ok, 2.0 - 2.0 * cosd, 0.0)
        self._crad = (np.sqrt(chord2.max(axis=1)) + 1e-5).astype(
            np.float64)
        return self._crad

    @property
    def center_sincos(self):
        """(n_tiles, 5) host f64: sin/cos of the tile-center colatitude
        and azimuth plus the raw azimuth,
        [sin th_c, cos th_c, sin ph_c, cos ph_c, ph_c] — consistent with
        ``tile_center``. Used by :meth:`slot_local` (which consumes the
        trailing ph_c as csc_t[4] for the wrapped azimuth offset)."""
        if getattr(self, "_csc", None) is None:
            th_c = np.arccos(np.clip(self.tile_center[:, 2], -1, 1))
            ph_c = 2.0 * np.pi * (self.tile_s + 0.5) / self.tile_S
            self._csc = np.stack([np.sin(th_c), np.cos(th_c),
                                  np.sin(ph_c), np.cos(ph_c), ph_c],
                                 axis=1)
        return self._csc

    def slot_local(self, i0_t, s_t, S_t, csc_t, dtype=jnp.float32,
                   tangent=False):
        """Tile-LOCAL slot geometry in ``dtype`` (f32): cheap and
        locally accurate.

        ``slot_pixels`` computes per-slot f64 sin/cos, ~the whole fixed
        cost of a small-H tile row. Here the only per-slot trig is f32
        on the SMALL azimuth offset ``d = phi - ph_c``: with per-tile
        f64 sin/cos of the center (``csc_t``) and per-ring f64
        differences, the local offset ``dp = v_pix - c`` comes out with
        absolute error ~eps_f32 * |dp| — better than computing f64
        positions and casting, at a fraction of the cost.

          A  = (sin th_r - sin th_c) - sin th_r * 2 sin^2(d/2)
          B  = sin th_r * sin d
          dp = (cph_c*A - sph_c*B,  sph_c*A + cph_c*B,
                cos th_r - cos th_c)

        With ``tangent=True`` also returns the pixel tangent basis
        (e_th, e_ph) and the projections a_th = dp.e_th, a_ph = dp.e_ph
        (the displace-mode split constants; computed product-of-smalls,
        no cancellation). Returns (dpT (3,P), valid (RB,K)[, e_thT,
        e_phT, a_th, a_ph])."""
        N = self.nside
        RB, K = self.RB, self.K
        P = RB * K
        u = jnp.arange(RB, dtype=jnp.int32)
        i = i0_t.astype(jnp.int32) + u
        ring_ok = (i >= 1) & (i <= 4 * N - 1)
        i_c = jnp.clip(i, 1, 4 * N - 1)
        _, nr, _, sh = hpx.ring_info(N, i_c, jnp.float64)
        sh_i = sh.astype(jnp.int32)
        S = S_t.astype(jnp.int32)
        s = s_t.astype(jnp.int32)
        j0 = (2 * s * nr - sh_i * S + 2 * S - 1) // (2 * S)
        j1 = (2 * (s + 1) * nr - sh_i * S + 2 * S - 1) // (2 * S)
        v = jnp.arange(K, dtype=jnp.int32)
        j = j0[:, None] + v[None, :]
        valid = (v[None, :] < (j1 - j0)[:, None]) & ring_ok[:, None]

        sthc, cthc, sphc, cphc = (csc_t[0], csc_t[1], csc_t[2],
                                  csc_t[3])                    # f64
        theta_r = hpx.ring_theta(N, i_c, jnp.float64)          # (RB,)
        sth_r = jnp.sin(theta_r)
        cth_r = jnp.cos(theta_r)
        dsin = (sth_r - sthc).astype(dtype)                    # (RB,)
        dcos = (cth_r - cthc).astype(dtype)
        sth32 = sth_r.astype(dtype)
        cth32 = cth_r.astype(dtype)

        # small azimuth offset, f64 int-grid math (no trig), wrapped
        dphi = 2.0 * jnp.pi / nr
        ph_c64 = csc_t[4]
        d = ((j.astype(jnp.float64) + 0.5 * sh[:, None])
             * dphi[:, None] - ph_c64)
        d = jnp.mod(d + jnp.pi, 2.0 * jnp.pi) - jnp.pi
        d32 = d.astype(dtype)                                  # (RB,K)

        s2 = jnp.sin(0.5 * d32)
        c2 = jnp.cos(0.5 * d32)
        sind = 2.0 * s2 * c2
        cosm1 = -2.0 * s2 * s2                                 # cos d - 1
        A = dsin[:, None] + sth32[:, None] * cosm1
        B = sth32[:, None] * sind
        sphc32 = jnp.asarray(sphc).astype(dtype)
        cphc32 = jnp.asarray(cphc).astype(dtype)
        dp = jnp.stack([cphc32 * A - sphc32 * B,
                        sphc32 * A + cphc32 * B,
                        jnp.broadcast_to(dcos[:, None], (RB, K))],
                       axis=0).reshape(3, P)
        if not tangent:
            return dp, valid
        cosd = 1.0 + cosm1
        sinp = sphc32 * cosd + cphc32 * sind                   # sin phi
        cosp = cphc32 * cosd - sphc32 * sind                   # cos phi
        e_th = jnp.stack([cth32[:, None] * cosp,
                          cth32[:, None] * sinp,
                          jnp.broadcast_to(-sth32[:, None], (RB, K))],
                         axis=0).reshape(3, P)
        e_ph = jnp.stack([-sinp, cosp, jnp.zeros_like(sinp)],
                         axis=0).reshape(3, P)
        a_th = (dp[0] * e_th[0] + dp[1] * e_th[1] + dp[2] * e_th[2])
        a_ph = (dp[0] * e_ph[0] + dp[1] * e_ph[1] + dp[2] * e_ph[2])
        return dp, valid, e_th, e_ph, a_th, a_ph

    # -- device-side closed-form geometry ------------------------------
    def slot_pixels(self, i0_t, s_t, S_t):
        """Per-slot (pix, phi, valid) for one tile; also per-ring
        (theta_r, sin, cos). All jnp, shapes (RB, K)."""
        N = self.nside
        RB, K = self.RB, self.K
        u = jnp.arange(RB, dtype=jnp.int32)
        i = i0_t.astype(jnp.int32) + u
        ring_ok = (i >= 1) & (i <= 4 * N - 1)
        i_c = jnp.clip(i, 1, 4 * N - 1)
        sp, nr, _, sh = hpx.ring_info(N, i_c, jnp.float64)
        sh_i = sh.astype(jnp.int32)
        S = S_t.astype(jnp.int32)
        s = s_t.astype(jnp.int32)
        j0 = (2 * s * nr - sh_i * S + 2 * S - 1) // (2 * S)
        j1 = (2 * (s + 1) * nr - sh_i * S + 2 * S - 1) // (2 * S)
        v = jnp.arange(K, dtype=jnp.int32)
        j = j0[:, None] + v[None, :]
        valid = (v[None, :] < (j1 - j0)[:, None]) & ring_ok[:, None]
        jw = jnp.where(j < nr[:, None], j, j - nr[:, None])
        pix = sp[:, None] + jw
        theta_r = hpx.ring_theta(N, i_c, jnp.float64)
        dphi = 2.0 * jnp.pi / nr
        phi = (jw.astype(jnp.float64) + 0.5 * sh[:, None]) * dphi[:, None]
        return pix, phi, valid, theta_r

    def slot_pix(self, i0_t, s_t, S_t):
        """Lean (pix, valid) of one tile's slots — int32 only (the full
        slot_pixels also builds f64 angles, which at NSIDE=4096 across
        all cap tiles is gigabytes of dead temporaries)."""
        N = self.nside
        RB, K = self.RB, self.K
        u = jnp.arange(RB, dtype=jnp.int32)
        i = i0_t.astype(jnp.int32) + u
        ring_ok = (i >= 1) & (i <= 4 * N - 1)
        i_c = jnp.clip(i, 1, 4 * N - 1)
        sp, nr, _, sh = hpx.ring_info(N, i_c, jnp.float32)
        sh_i = sh.astype(jnp.int32)
        S = S_t.astype(jnp.int32)
        s = s_t.astype(jnp.int32)
        j0 = (2 * s * nr - sh_i * S + 2 * S - 1) // (2 * S)
        j1 = (2 * (s + 1) * nr - sh_i * S + 2 * S - 1) // (2 * S)
        v = jnp.arange(K, dtype=jnp.int32)
        j = j0[:, None] + v[None, :]
        valid = (v[None, :] < (j1 - j0)[:, None]) & ring_ok[:, None]
        jw = jnp.where(j < nr[:, None], j, j - nr[:, None])
        return sp[:, None] + jw, valid

    def slot_index(self, p):
        """Flat RING pixel id -> linear slot index into the
        (n_tiles * RB * K) tile-major layout. Closed-form int math (jnp).

        int32 throughout (this runs once per map pixel); valid while
        npix and n_tiles*RB*K < 2^31, i.e. NSIDE <= 8192 with the default
        slot geometry. The cap-ring sqrt runs in f64 on the raw pixel id
        (exact for p < 2^52).
        """
        N = self.nside
        RB, K = self.RB, self.K
        p = jnp.asarray(p, dtype=jnp.int32)
        ncap = 2 * N * (N - 1)
        npx = 12 * N * N

        # ring i and in-ring index j (mirrors hpx.pix2ang int logic)
        pf = p.astype(jnp.float64)
        i_n = ((1 + jnp.sqrt(1.0 + 2.0 * pf)) / 2.0).astype(jnp.int32)
        i_n = jnp.where(2 * i_n * (i_n - 1) > p, i_n - 1, i_n)
        i_n = jnp.where(2 * i_n * (i_n + 1) <= p, i_n + 1, i_n)
        j_n = p - 2 * i_n * (i_n - 1)

        pe = p - ncap
        i_e = N + pe // (4 * N)
        j_e = pe % (4 * N)

        ps = (npx - 1) - p
        psf = ps.astype(jnp.float64)
        i_ss = ((1 + jnp.sqrt(1.0 + 2.0 * psf)) / 2.0).astype(jnp.int32)
        i_ss = jnp.where(2 * i_ss * (i_ss - 1) > ps, i_ss - 1, i_ss)
        i_ss = jnp.where(2 * i_ss * (i_ss + 1) <= ps, i_ss + 1, i_ss)
        j_s = 4 * i_ss - 1 - (ps - 2 * i_ss * (i_ss - 1))

        north = p < ncap
        south = p >= npx - ncap
        i = jnp.where(north, i_n, jnp.where(south, 4 * N - i_ss, i_e))
        j = jnp.where(north, j_n, jnp.where(south, j_s, j_e))
        nr = jnp.where(north, 4 * i_n,
                       jnp.where(south, 4 * i_ss, 4 * N))
        sh = jnp.where(north | south, 1,
                       jnp.where((i - N) % 2 == 0, 1, 0))

        b = (i - 1) // RB
        u = (i - 1) - b * RB
        S = jnp.asarray(self.S, dtype=jnp.int32)[b]
        off = jnp.asarray(self.tile_off[:-1], dtype=jnp.int32)[b]
        s = (2 * j + sh) * S // (2 * nr)
        j0 = (2 * s * nr - sh * S + 2 * S - 1) // (2 * S)
        v = j - j0
        return ((off + s) * RB + u) * K + v


    def tile_view(self, flat):
        """Inverse of :meth:`flat_view`: flat RING order -> tile-major
        (n_tiles, RB*K, ...). Belt-exact blocks are a pure reshape+
        transpose; cap tiles gather flat values at their analytic slot
        pixels (invalid slots read 0)."""
        N = self.nside
        RB, K = self.RB, self.K
        npix = 12 * N * N
        trail = flat.shape[1:]
        out = jnp.zeros((self.n_tiles, RB * K) + trail, dtype=flat.dtype)

        blocks = np.where(self._belt_exact)[0]
        cap_tiles = np.where(~self._belt_exact[self.tile_block])[0]
        if blocks.size:
            b0, b1 = int(blocks[0]), int(blocks[-1])
            ncap = 2 * N * (N - 1)
            ring0 = int(self.i0[b0])
            ring1 = int(self.i0[b1]) + RB - 1
            sp0 = ncap + (ring0 - N) * 4 * N
            sp1 = ncap + (ring1 + 1 - N) * 4 * N
            t0 = int(self.tile_off[b0])
            t1 = int(self.tile_off[b1 + 1])
            S = int(self.S[b0])
            NB = b1 - b0 + 1
            belt = flat[sp0:sp1].reshape((NB, RB, S, K) + trail)
            belt = jnp.swapaxes(belt, 1, 2).reshape(
                (t1 - t0, RB * K) + trail)
            out = out.at[t0:t1].set(belt)
        if cap_tiles.size:
            pix, valid = jax.vmap(self.slot_pix)(
                jnp.asarray(self.tile_i0[cap_tiles]),
                jnp.asarray(self.tile_s[cap_tiles]),
                jnp.asarray(self.tile_S[cap_tiles]))
            pixf = jnp.where(valid, pix, 0).reshape(cap_tiles.size, RB * K)
            vals = flat[pixf]
            mask = valid.reshape(cap_tiles.size, RB * K)
            vals = jnp.where(mask.reshape(mask.shape + (1,) * len(trail)),
                             vals, 0)
            out = out.at[jnp.asarray(cap_tiles)].set(vals)
        return out

    def flat_view(self, acc):
        """Tile-major accumulator (n_tiles, RB*K, ...) -> flat RING order
        (npix, ...).

        Belt-exact blocks (segments of exactly K pixels) reassemble with a
        pure transpose+reshape (memory-bandwidth); only the polar caps go
        through the computed-index gather (~1/3 of pixels).
        """
        N = self.nside
        RB, K = self.RB, self.K
        npix = 12 * N * N
        trail = acc.shape[2:]
        flat_slots = acc.reshape((self.n_tiles * RB * K,) + trail)

        blocks = np.where(self._belt_exact)[0]
        if blocks.size == 0:
            lin = self.slot_index(jnp.arange(npix, dtype=jnp.int32))
            return flat_slots[lin]
        b0, b1 = int(blocks[0]), int(blocks[-1])
        ncap = 2 * N * (N - 1)
        ring0 = int(self.i0[b0])
        ring1 = int(self.i0[b1]) + RB - 1
        sp0 = ncap + (ring0 - N) * 4 * N
        sp1 = ncap + (ring1 + 1 - N) * 4 * N
        t0 = int(self.tile_off[b0])
        t1 = int(self.tile_off[b1 + 1])
        S = int(self.S[b0])
        NB = b1 - b0 + 1

        belt = acc[t0:t1].reshape((NB, S, RB, K) + trail)
        belt = jnp.swapaxes(belt, 1, 2).reshape((sp1 - sp0,) + trail)
        head = flat_slots[self.slot_index(
            jnp.arange(sp0, dtype=jnp.int32))]
        tail = flat_slots[self.slot_index(
            jnp.arange(sp1, npix, dtype=jnp.int32))]
        return jnp.concatenate([head, belt, tail], axis=0)


def _ring_theta_np(N, i):
    """Host-side ring colatitude for (possibly fractional) ring index."""
    i = np.asarray(i, dtype=float)
    i_s = 4 * N - i
    th_n = 2.0 * np.arcsin(np.clip(i / (np.sqrt(6.0) * N), 0, 1))
    th_s = np.pi - 2.0 * np.arcsin(np.clip(i_s / (np.sqrt(6.0) * N), 0, 1))
    z_e = 4.0 / 3.0 - 2.0 * i / (3.0 * N)
    th_e = np.arccos(np.clip(z_e, -1, 1))
    return np.where(i < N, th_n, np.where(i > 3 * N, th_s, th_e))


def _ring_of_theta_np(N, theta):
    """Host-side ring_above + 1 style ring index of a colatitude."""
    theta = np.clip(theta, 0.0, np.pi)
    z = np.cos(theta)
    polar = np.abs(z) > 2.0 / 3.0
    rt6N = np.sqrt(6.0) * N
    irn = np.floor(rt6N * np.sin(0.5 * theta)).astype(np.int64)
    irs = np.floor(rt6N * np.cos(0.5 * theta)).astype(np.int64)
    ring_pol = np.where(z > 0, irn, 4 * N - irs - 1)
    ring_eq = np.floor(N * (2.0 - 1.5 * z)).astype(np.int64)
    return np.where(polar, ring_pol, ring_eq)


def bin_halos_to_tiles(tiling, theta, phi, radius, margin_pix=2.0):
    """Host-side: (tile_id, halo_id) pairs for every tile each halo's disc
    (angular radius ``radius``) may touch. Vectorized numpy; cached by the
    caller. ``margin_pix`` widens the phi window by that many pixel widths
    (slot centers vs disc edges)."""
    N = tiling.nside
    RB = tiling.RB
    theta = np.asarray(theta, float)
    phi = np.mod(np.asarray(phi, float), 2 * np.pi)
    radius = np.asarray(radius, float)
    n = theta.size

    # ring bracketing stays f64 (block membership must not flip); the
    # per-block window/trig math below runs in f32 and the pair indices
    # in int32 — at 1e6 halos / 25M pairs this host stage is memory-
    # traffic bound and the halved widths measured ~2x (margin_pix
    # absorbs the ~1e-7 rad f32 rounding)
    i_lo = np.clip(_ring_of_theta_np(N, theta - radius), 1, 4 * N - 1)
    i_hi = np.clip(_ring_of_theta_np(N, theta + radius) + 1, 1, 4 * N - 1)
    b_lo = ((i_lo - 1) // RB).astype(np.int32)
    b_hi = ((i_hi - 1) // RB).astype(np.int32)
    max_d = int((b_hi - b_lo).max()) + 1 if n else 0

    theta32 = theta.astype(np.float32)
    rad32 = radius.astype(np.float32)
    phi32 = phi.astype(np.float32)
    blk_lo32 = tiling.block_th_lo.astype(np.float32)
    blk_hi32 = tiling.block_th_hi.astype(np.float32)
    S_all = tiling.S.astype(np.int32)
    tile_off32 = tiling.tile_off.astype(np.int32)

    tiles_all, halos_all = [], []
    sin_r = np.sin(np.minimum(rad32, np.float32(0.5 * np.pi)))
    for d in range(max_d):
        b = b_lo + d
        act = b <= b_hi
        if not act.any():
            continue
        idx = np.where(act)[0].astype(np.int32)
        bb = b[idx]
        # effective theta band of the disc inside this block
        t_lo = np.maximum(theta32[idx] - rad32[idx], blk_lo32[bb])
        t_hi = np.minimum(theta32[idx] + rad32[idx], blk_hi32[bb])
        # widest phi need: smallest sin(theta) on the band edge (the band
        # cannot cross a pole without touching theta=0/pi)
        sin_min = np.minimum(np.sin(t_lo), np.sin(t_hi))
        # band containing the equator: sin >= sin(t_lo), fine as is
        touches_pole = (t_lo <= 1e-9) | (t_hi >= np.float32(np.pi) - 1e-6)
        w = np.where(
            (sin_min <= sin_r[idx]) | touches_pole, np.float32(np.pi),
            np.arcsin(np.clip(sin_r[idx]
                              / np.maximum(sin_min, np.float32(1e-12)),
                              0, 1)))
        # margin: a couple of pixel widths (sector boundaries vs centers)
        S = S_all[bb]
        dphi_sec = np.float32(2 * np.pi) / S
        w = np.minimum(w + np.float32(margin_pix * np.pi / (2.0 * N))
                       / np.maximum(sin_min, np.float32(1e-3)),
                       np.float32(np.pi))
        s_lo = np.floor((phi32[idx] - w) / dphi_sec).astype(np.int32)
        s_hi = np.floor((phi32[idx] + w) / dphi_sec).astype(np.int32)
        cnt = np.minimum(s_hi - s_lo + 1, S)
        # expand (halo, sector-range) -> pairs
        rep_h = np.repeat(idx, cnt)
        rep_b = np.repeat(bb, cnt)
        rep_s0 = np.repeat(s_lo, cnt)
        rep_S = np.repeat(S, cnt)
        csum = np.cumsum(cnt, dtype=np.int64)
        pos = (np.arange(csum[-1], dtype=np.int32)
               - np.repeat((csum - cnt).astype(np.int32), cnt))
        s = np.mod(rep_s0 + pos, rep_S)
        tiles_all.append(tile_off32[rep_b] + s)
        halos_all.append(rep_h)
    if not tiles_all:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    return np.concatenate(tiles_all), np.concatenate(halos_all)


def refine_pairs(tiling, tile_ids, halo_ids, vh, chord_rad,
                 inv_dlnr=None, n_c=24, lnDa=None):
    """Exact pair pruning + near/far sweep classification (host).

    ``bin_halos_to_tiles`` over-covers: it bins by the disc's
    theta-band x phi-window BOUNDING BOX, so corner tiles that the disc
    never touches still form pairs (the kernel then zeroes every pixel
    through the crit2 mask — pure waste, ~4/pi overhead for multi-tile
    discs). With per-tile circumradii the prune is exact: if
    ``dist(halo, tile_center) - crad(tile) > chord_rad(halo)`` no pixel
    of the tile can pass the kernel's ``chord2 <= crit2`` mask, so
    dropping the pair is value-identical.

    The same distances classify pairs for the WINDOWED curve sweep.
    The ln-radius budget a window of ``n_c`` cells can cover (after a
    4-cell bracket/rounding margin) is split half/half between the
    pair's own radial extent across the tile (``W``) and the radial
    spread allowed WITHIN one tile-row's halo group (``S``): "far"
    pairs (extent <= W) are assigned a radial bin of stride S, so every
    pair grouped into one (tile, bin) kernel row fits a SHARED n_c-wide
    window — the kernel then needs one scalar window start per row (a
    cheap min + dynamic_slice, no per-pair gather).

    Parameters
    ----------
    vh : (n_halos, 3) float array of halo unit vectors
    chord_rad : (n_halos,) max chord ``2 sin(radius/2)``
    inv_dlnr : scalar or sequence of scalars (paint2 passes both grids)
        or None to skip classification (everything "near").
    lnDa : (n_halos,) radial log offset ``ln(D * rscale / a)`` of the
        curve lookup (required for classification — the bin lives in
        the lookup's ln-r space).

    Returns ``(far, near)`` where ``far = (tile_ids, halo_ids, bins)``
    (``bins`` int64 radial bin per pair) and ``near = (tile_ids,
    halo_ids)``. Feed ``far`` to :func:`bucket_tiles_binned`.
    """
    crad = tiling.tile_crad.astype(np.float32)[tile_ids]
    d = (tiling.tile_center.astype(np.float32)[tile_ids]
         - np.asarray(vh, np.float32)[halo_ids])
    dcen = np.sqrt(np.einsum("ij,ij->i", d, d))
    lo = dcen - crad
    keep = lo <= np.asarray(chord_rad, np.float32)[halo_ids] + 1e-5
    tile_ids, halo_ids = tile_ids[keep], halo_ids[keep]
    if inv_dlnr is None or lnDa is None:
        return ((tile_ids[:0], halo_ids[:0],
                 np.zeros(0, np.int64)), (tile_ids, halo_ids))
    lo, dcen, crad = lo[keep], dcen[keep], crad[keep]
    inv = float(np.max(np.asarray(inv_dlnr, np.float64)))
    usable = (n_c - 4) / inv                     # ln-r units
    W = 0.5 * usable                             # pair extent budget
    S = usable - W                               # in-row spread budget
    ln_lo = np.log(np.maximum(lo, 1e-30))
    width = np.log(np.maximum(dcen + crad, 1e-30)) - ln_lo
    far = (lo > 0) & (width <= np.float32(W))
    y = ln_lo[far] + np.asarray(lnDa, np.float32)[halo_ids[far]]
    bins = np.floor(y / np.float32(S)).astype(np.int64)
    return ((tile_ids[far], halo_ids[far], bins),
            (tile_ids[~far], halo_ids[~far]))


def bucket_tiles_binned(far, n_c, h_align=8):
    """Group far pairs into windowed kernel buckets.

    ``far = (tile_ids, halo_ids, bins)`` from :func:`refine_pairs`.
    Rows are keyed by (tile, radial bin) so one tile may appear in
    several rows (the accumulator add handles duplicates); every bucket
    is tagged with the static window width ``n_c`` (or a tuple of
    widths for paint2's two grids). Returns the same
    ``(tids, hidx, n_c)`` tuples :func:`make_tile_deposit` consumes.
    """
    t, h, bins = far
    if t.size == 0:
        return []
    b0 = int(bins.min())
    NB = int(bins.max()) - b0 + 1
    key = t.astype(np.int64) * NB + (bins - b0)
    out = []
    for kt, kh in bucket_tiles(key, h, h_align=h_align):
        out.append(((kt.astype(np.int64) // NB).astype(np.int32), kh,
                    n_c))
    return out


def classify_tile_windows(tiling, tile_ids, halo_ids, vh, chord_rad,
                          lnDa, grids, classes=(16, 24, 32, 48),
                          slack=3.0):
    """Per-TILE static window classes for the windowed curve sweep.

    The (tile, radial-bin) far/near split (:func:`refine_pairs` +
    :func:`bucket_tiles_binned`) cuts sweep ops but FRAGMENTS rows:
    each tile's pairs scatter over several (far-bin, near) rows, and
    with per-tile counts of only a few pairs the h_align=8 padding more
    than eats the win (measured: 0.45M padded pairs vs 0.28M full at
    NSIDE=1024/20k halos). This classifier instead keeps every tile's
    pairs in ONE row — identical row membership and padding to the full
    sweep — and picks the narrowest static window class the WHOLE tile
    fits, so the sweep is strictly cheaper wherever a class applies.

    ``grids`` is a sequence of ``(ln_r0, inv_dlnr, n_r)`` lookup grids
    sharing the pair's ln-radius coordinate (paint2 passes two). For
    each tile the per-grid window start is predicted with the device
    kernel's own formula (``clo = clip(floor((y_min - ln_r0) * inv) -
    1, 0, n_r - n_c)`` with ``y_min = min ln(dcen - crad) + lnDa`` in
    the same f32 geometry), and a class ``C`` (expressed in
    coarsest-grid cells, the :func:`window_tags` convention) is
    eligible when every grid's used lookup range fits its window with
    ``slack`` cells to spare (host/device f32 rounding near the chord
    cancellation limit costs up to ~1.5 cells).

    Returns an int8 array over PAIRS: the index into ``classes`` of the
    tile's chosen class, or ``len(classes)`` for tiles that need the
    full sweep.
    """
    vh = np.asarray(vh, np.float32)
    crad = tiling.tile_crad.astype(np.float32)[tile_ids]
    d = tiling.tile_center.astype(np.float32)[tile_ids] - vh[halo_ids]
    dcen = np.sqrt(np.einsum("ij,ij->i", d, d))
    lnDa_p = np.asarray(lnDa, np.float32)[halo_ids]
    y_lo = np.log(np.maximum(dcen - crad, 1e-30)) + lnDa_p
    y_hi = np.log(dcen + crad) + lnDa_p

    order = np.argsort(tile_ids.astype(np.int64), kind="stable")
    ts = tile_ids[order]
    if ts.size == 0:
        return np.zeros(0, np.int8)
    bnd = np.empty(ts.size, dtype=bool)
    bnd[0] = True
    np.not_equal(ts[1:], ts[:-1], out=bnd[1:])
    starts = np.flatnonzero(bnd)
    t_min_lo = np.minimum.reduceat(y_lo[order], starts)
    t_max_hi = np.maximum.reduceat(y_hi[order], starts)

    grids = [(float(g[0]), float(g[1]), int(g[2])) for g in grids]
    maxinv = max(g[1] for g in grids)
    n_ut = starts.size
    cls_u = np.full(n_ut, len(classes), dtype=np.int8)
    for ci, C in enumerate(classes):
        ok = np.ones(n_ut, dtype=bool)
        for ln_r0, inv, nr in grids:
            nc = int(np.ceil((C - 4) / maxinv * inv)) + 4  # window_tags
            if nc >= nr:
                continue                   # whole grid fits the window
            X_lo = (t_min_lo - ln_r0) * inv
            X_hi = (t_max_hi - ln_r0) * inv
            a = np.clip(np.floor(X_lo) - 1, 0, nr - nc)
            ok &= np.minimum(X_hi, nr - 1) <= a + nc - 1 - slack
        assign = ok & (cls_u == len(classes))
        cls_u[assign] = ci
    # map per-tile class back to pairs (in the caller's pair order)
    tile_group = np.cumsum(bnd) - 1         # group id per sorted pair
    cls_pairs = np.empty(ts.size, np.int8)
    cls_pairs[order] = cls_u[tile_group]
    return cls_pairs


def bucket_tiles_classed(tile_ids, halo_ids, cls_pairs, invs,
                         classes=(16, 24, 32, 48), h_align=8,
                         min_frac=0.05):
    """Bucket pairs per tile-window class (:func:`classify_tile_windows`).

    Each class partition holds WHOLE tiles, so rows are the same
    per-tile halo lists the full sweep would build — just tagged with
    the class's static window width(s) from :func:`window_tags`. Pairs
    classed ``len(classes)`` get untagged full-sweep buckets.

    Classes holding fewer than ``min_frac`` of all pairs fold into the
    full sweep: each class partition costs ~2-3 extra kernel dispatches
    per call plus a compile variant, which a sliver of swept-op savings
    cannot repay.
    """
    cls_pairs = np.asarray(cls_pairs).copy()
    n_all = max(cls_pairs.size, 1)
    for ci in range(len(classes)):
        sel = cls_pairs == ci
        if 0 < sel.sum() < min_frac * n_all:
            cls_pairs[sel] = len(classes)
    out = []
    for ci, C in enumerate(classes):
        sel = cls_pairs == ci
        if not sel.any():
            continue
        tag = window_tags(invs, C)
        for t, h in bucket_tiles(tile_ids[sel], halo_ids[sel],
                                 h_align=h_align):
            out.append((t, h, tag))
    sel = cls_pairs == len(classes)
    if sel.any():
        out += bucket_tiles(tile_ids[sel], halo_ids[sel],
                            h_align=h_align)
    return out


def window_tags(invs, n_c=24):
    """Static window width(s) for the windowed sweep's far buckets.

    :func:`refine_pairs` budgets the shared ln-r window in the COARSEST
    grid's cells (``max(invs)``); each grid's own static width is that
    ln-r budget re-expressed in its cells plus the same 4-cell
    bracket/rounding margin. Returns a scalar for one grid, a tuple for
    paint2's two grids — the tag :func:`bucket_tiles_binned` attaches.
    """
    invs = tuple(float(v) for v in
                 np.atleast_1d(np.asarray(invs, np.float64)))
    usable = (n_c - 4) / max(invs)
    tags = tuple(int(np.ceil(usable * iv)) + 4 for iv in invs)
    return tags[0] if len(tags) == 1 else tags


def make_tile_deposit(tiling, n_r, mode="displace", dtype=jnp.float32,
                      h_chunk=64, t_chunk=256, log_curves=False,
                      mesh=None, mesh_axis="halos", n_r2=None):
    """Build the dense per-tile pair kernel (the scatter-free phase A).

    Returns ``run(bucket, halo_pack, extra) -> (tile_ids, out)`` where
    ``bucket = (tile_ids (T,), halo_idx (T, H)[, n_c])`` from
    :func:`bucket_tiles` (optionally tagged by :func:`refine_pairs`
    classification: a third element ``n_c`` selects the WINDOWED sweep,
    which evaluates only an ``n_c``-wide window of curve centers around
    the pair's radial range instead of all ``n_r`` — a ~(n_r/n_c)x cut
    of the dominant per-pair cost for far pairs) and ``halo_pack`` is a
    dict of (n_halos, ...) device arrays:

      vh      (n, 3)  halo unit vectors (f64; offsets from the tile
                      center are taken in f64, then cast to dtype)
      crit2   (n,)    squared max chord: (2 sin(radius/2))^2
      lnDa    (n,)    ln(D * rscale / a) -- radial log offset of the lookup
      afac    (n,)    multiplies the displacement (comoving -> physical: a)
      invD    (n,)    1 / D (angular diameter distance)
      curves  (n, n_r) per-halo displacement (or paint) curves
      ln_r0, inv_dlnr : scalars of the curve grid (python floats)

    mode="displace": out (T, RB*K, 2) tangent (d theta, sin-theta d phi)
    sums. mode="paint": out (T, RB*K) plain curve-value sums (afac is then
    the per-halo paint scale, e.g. 1/a or pixarea*D^2/a). mode="paint2":
    per-pair PRODUCT of two curve lookups (the anisotropic-paint weight
    ``painting * canvas``, reference HealpixRunner.py:487-640); the pack
    additionally carries ``curves2`` (n, n_r2) plus 0-d ``ln_r0_2`` /
    ``inv_dlnr_2`` grid scalars, and with ``log_curves`` the two log
    lookups share one exp.

    The per-pair chord is subtract-then-square fma math (cancellation-free
    at sub-pixel separations); everything else is fma-grade elementwise
    math too. No scatter anywhere.
    """
    nside = tiling.nside
    RB, K = tiling.RB, tiling.K
    P = RB * K
    tile_i0 = jnp.asarray(tiling.tile_i0, dtype=jnp.int32)
    tile_s = jnp.asarray(tiling.tile_s, dtype=jnp.int32)
    tile_S = jnp.asarray(tiling.tile_S, dtype=jnp.int32)
    tile_center = jnp.asarray(tiling.tile_center)          # (n_tiles, 3)
    center_csc = jnp.asarray(tiling.center_sincos)         # (n_tiles, 5)
    displace = mode == "displace"
    paint2 = mode == "paint2"
    if paint2:
        assert n_r2 is not None, "paint2 needs n_r2"
        # log_curves=True: product = exp(sum) (one exp per pair);
        # log_curves=False: plain product of two RAW lookups (p_keys /
        # ParamTabulatedProfile tables store raw, possibly signed values)
    # per-tile circumradius for the windowed sweep (lazy: only built
    # when a windowed bucket is dispatched)
    _crad_d = [None]

    def _crad_dev():
        # populated OUTSIDE any trace by _ensure_crad (array creation
        # inside a jit trace would cache a tracer -> leak across jits)
        return _crad_d[0]

    def _ensure_crad(n_c):
        if n_c is not None and _crad_d[0] is None:
            _crad_d[0] = jnp.asarray(
                np.asarray(tiling.tile_crad, dtype=np.dtype(dtype)))

    def one_tile(tid, hidx, pack, ln_r0, inv_dlnr, n_c=None):
        # ---- slot geometry: tile-LOCAL f32 (slot_local) — per-slot
        # f64 trig was ~the whole fixed cost of a small-H tile row; the
        # local form is cheaper AND more accurate for the dp offsets the
        # chord math consumes. a_th/a_ph = dp.e_th/dp.e_ph replace the old
        # -c.e_th/-c.e_ph split constants (identical analytically:
        # v_pix is orthogonal to its own tangent basis).
        c = tile_center[tid]                                # (3,) f64
        if displace:
            dpT, valid, e_thT, e_phT, a_th, a_ph = tiling.slot_local(
                tile_i0[tid], tile_s[tid], tile_S[tid], center_csc[tid],
                dtype=dtype, tangent=True)
        else:
            dpT, valid = tiling.slot_local(
                tile_i0[tid], tile_s[tid], tile_S[tid], center_csc[tid],
                dtype=dtype)

        # ---- halo-axis scan in chunks (bounds the (h, P) intermediates)
        n_h = hidx.shape[0]
        hc = min(h_chunk, n_h)
        hidx_c = hidx.reshape(n_h // hc, hc)

        def h_body(carry, hi):
            ok = hi >= 0
            hcl = jnp.maximum(hi, 0)
            # halo offset from the tile center, subtracted in f64 and
            # then cast: casting the unit vectors first would leave an
            # absolute error of ~eps_f32 in dh, which is a large relative
            # error on the chords of pixels next to a halo center
            dh = (pack["vh"][hcl] - c[None, :]).astype(dtype)   # (h, 3)
            # all (h, P), the big axis minor.
            # chord2 DIFFERENCES FIRST: the expanded nh2 + np2 - 2G form
            # cancels catastrophically in f32 at sub-pixel separations
            # (3% chord error at a halo-center pixel -> 3% paint error on
            # a steep profile); subtract-then-square keeps the relative
            # error at ~f32 eps * tile_size / chord.
            d0 = dh[:, 0:1] - dpT[0][None, :]
            d1 = dh[:, 1:2] - dpT[1][None, :]
            d2 = dh[:, 2:3] - dpT[2][None, :]
            chord2 = d0 * d0 + d1 * d1 + d2 * d2
            chord2 = jnp.maximum(chord2, 1e-30)
            lnr = 0.5 * jnp.log(chord2) + pack["lnDa"][hcl][:, None]
            x = (lnr - ln_r0) * inv_dlnr

            if n_c is not None:
                # WINDOWED sweep (far pairs): host grouping
                # (refine_pairs + bucket_tiles_binned) guarantees every
                # pair in this row fits one SHARED n_c-wide window of
                # curve centers, so the window start is a per-row
                # SCALAR: min over the row's halos of the pair's lower
                # radial bound (dist to tile center minus circumradius
                # — the same f32 geometry the host binned by; the
                # floor(-1) and the host's 4-cell slack absorb
                # rounding), and the curve slice is one cheap
                # dynamic_slice per halo chunk — no per-pair gather.
                dcen = jnp.sqrt(dh[:, 0] * dh[:, 0] + dh[:, 1] * dh[:, 1]
                                + dh[:, 2] * dh[:, 2])
                chmin = jnp.maximum(dcen - _crad_dev()[tid], 1e-20)
                ln_chmin = jnp.log(chmin) + pack["lnDa"][hcl]
                y_min = jnp.min(jnp.where(ok, ln_chmin, jnp.inf))

                def window(cv, g_ln_r0, g_inv, nr, nc):
                    clo = jnp.clip(
                        jnp.floor((y_min - g_ln_r0) * g_inv)
                        .astype(jnp.int32) - 1, 0, nr - nc)
                    return clo, jax.lax.dynamic_slice_in_dim(
                        cv, clo, nc, axis=1)

            def contract(cv, xx, nr):
                # exact linear interpolation of each pair's curve: gather
                # the bracketing centers. x outside [0, nr-1] clamps to
                # the end segment; the use mask below zeroes those pairs
                i = jnp.clip(xx.astype(jnp.int32), 0, nr - 2)
                t = xx - i.astype(dtype)
                v0 = jnp.take_along_axis(cv, i, axis=1)
                v1 = jnp.take_along_axis(cv, i + 1, axis=1)
                return v0 * (1.0 - t) + v1 * t

            if n_c is None:
                val = contract(pack["curves"][hcl], x, n_r)
            else:
                nc1, nc2 = (n_c if isinstance(n_c, tuple)
                            else (n_c, n_c))
                nc1 = min(nc1, n_r)
                nc2 = min(nc2, n_r2) if n_r2 is not None else nc2
                clo, cvw = window(pack["curves"][hcl], ln_r0, inv_dlnr,
                                  n_r, nc1)
                val = contract(cvw, x - clo.astype(dtype), nc1)
            use = ((x >= 0) & (x <= n_r - 1) & ok[:, None]
                   & (chord2 <= pack["crit2"][hcl][:, None]))
            if paint2:
                x2 = (lnr - pack["ln_r0_2"]) * pack["inv_dlnr_2"]
                if n_c is None:
                    v2 = contract(pack["curves2"][hcl], x2, n_r2)
                else:
                    clo2, cvw2 = window(pack["curves2"][hcl],
                                        pack["ln_r0_2"],
                                        pack["inv_dlnr_2"], n_r2,
                                        nc2)
                    v2 = contract(cvw2, x2 - clo2.astype(dtype), nc2)
                val = (val + v2) if log_curves else (val * v2)
                use = use & (x2 >= 0) & (x2 <= n_r2 - 1)
            if log_curves:           # paint curves store log values
                val = jnp.exp(val)
            d = jnp.where(use, val, 0.0) * pack["afac"][hcl][:, None]
            if displace:
                amp = d * jax.lax.rsqrt(chord2) * pack["invD"][hcl][:, None]
                gth = (dh[:, 0:1] * e_thT[0][None, :]
                       + dh[:, 1:2] * e_thT[1][None, :]
                       + dh[:, 2:3] * e_thT[2][None, :])
                gph = (dh[:, 0:1] * e_phT[0][None, :]
                       + dh[:, 1:2] * e_phT[1][None, :]
                       + dh[:, 2:3] * e_phT[2][None, :])
                s0, sth, sph = carry
                s0 = s0 + jnp.sum(amp, axis=0)
                sth = sth + jnp.sum(amp * gth, axis=0)
                sph = sph + jnp.sum(amp * gph, axis=0)
                return (s0, sth, sph), None
            s0, _, _ = carry
            return (s0 + jnp.sum(d, axis=0), s0, s0), None

        z = jnp.zeros(P, dtype=dtype)
        if mesh is not None:     # carry mixes with sharded inputs
            z = jax.lax.pcast(z, (mesh_axis,), to="varying")
        (s0, sth, sph), _ = jax.lax.scan(h_body, (z, z, z), hidx_c)
        if displace:
            out = jnp.stack([s0 * a_th - sth, s0 * a_ph - sph], axis=-1)
            vmask = valid.reshape(P)[:, None]
        else:
            out = s0
            vmask = valid.reshape(P)
        # dead slots (cap segments shorter than K) must hold EXACT zeros:
        # the stencil regrid reads neighbouring tiles' storage directly
        out = jnp.where(vmask, out, 0.0)
        return jnp.where(jnp.isfinite(out), out, 0.0)

    def make_run_all(n_c):
        def run_all(tid, hid, pack, ln_r0, inv_dlnr):
            # one dispatch: sequential lax.map over tile chunks (bounds
            # the (P, h) intermediates), vmap over tiles in each chunk
            def chunk(args):
                t, h = args
                return jax.vmap(lambda ti, hi: one_tile(
                    ti, hi, pack, ln_r0, inv_dlnr, n_c=n_c))(t, h)
            out = jax.lax.map(chunk, (tid, hid))
            return out.reshape((-1,) + out.shape[2:])
        return run_all

    # jit caches keyed by the static window width n_c (None = full
    # sweep); windowed buckets (refine_pairs "far" pairs) compile their
    # own kernel variant
    _jit_cache, _jit_into_cache = {}, {}

    if mesh is None:
        ndev = 1

        def _get_jitted(n_c):
            if n_c not in _jit_cache:
                _jit_cache[n_c] = jax.jit(make_run_all(n_c))
            return _jit_cache[n_c]

        # fused variant: deposit + accumulator add in ONE dispatch, with
        # the add INSIDE the chunk scan so the full (T_pad, P, 2) bucket
        # output (2.2 GB when one bucket spans most NSIDE=4096 tiles)
        # never materializes — peak extra memory is one (Tp, P, 2)
        # chunk. Padded rows (hid all -1) emit exact zeros, so adding
        # them to tile 0 (the tid pad value) is a value-level no-op;
        # donating the accumulator keeps it single-copy, and one
        # dispatch per bucket replaces three.
        def _get_jitted_into(n_c):
            if n_c not in _jit_into_cache:
                def run_all_into(acc, tid, hid, pack, ln_r0, inv_dlnr):
                    def body(a, args):
                        t, h = args
                        out = jax.vmap(lambda ti, hi: one_tile(
                            ti, hi, pack, ln_r0, inv_dlnr, n_c=n_c))(t, h)
                        return a.at[t].add(out.astype(a.dtype)), None
                    acc, _ = jax.lax.scan(body, acc, (tid, hid))
                    return acc
                _jit_into_cache[n_c] = jax.jit(run_all_into,
                                               donate_argnums=0)
            return _jit_into_cache[n_c]
    else:
        # tiles are disjoint: shard the chunk axis across devices with
        # NO collective (each device owns its chunks' output rows; the
        # caller's accumulator add handles any resharding)
        from jax.sharding import PartitionSpec as _PS

        ndev = mesh.devices.size

        def _get_jitted(n_c):
            if n_c not in _jit_cache:
                _jit_cache[n_c] = jax.jit(jax.shard_map(
                    make_run_all(n_c), mesh=mesh,
                    in_specs=(_PS(mesh_axis), _PS(mesh_axis), _PS(),
                              _PS(), _PS()),
                    out_specs=_PS(mesh_axis)))
            return _jit_cache[n_c]
    _dev_cache = {}

    def _bucket_on_device(bucket):
        tids_np, hidx_np = bucket[0], bucket[1]
        key = id(hidx_np)
        if key not in _dev_cache:
            if len(_dev_cache) >= 64:   # bound device-memory growth
                _dev_cache.clear()
            # pad/upload ONCE: repeated process() calls (and per-call
            # chunk loops) must not re-ship halo lists over the (slow)
            # host->device link
            T, H = hidx_np.shape
            Hp = (-(-H // 8) * 8 if H <= h_chunk
                  else -(-H // h_chunk) * h_chunk)
            Tp = min(t_chunk, max(8, T))
            nch = -(-(-(-T // Tp)) // ndev) * ndev   # ceil to ndev multiple
            hid = np.full((nch * Tp, Hp), -1, dtype=np.int32)
            hid[:T, :H] = hidx_np
            tid = np.zeros(nch * Tp, dtype=np.int32)
            tid[:T] = tids_np
            # hidx_np is stored to pin the object: the id()-key stays
            # valid for the cache entry's lifetime (a freed array's
            # address could otherwise be reused by a different catalog)
            _dev_cache[key] = (jnp.asarray(tid.reshape(nch, Tp)),
                               jnp.asarray(hid.reshape(nch, Tp, Hp)),
                               hidx_np)
        return _dev_cache[key]

    def _bucket_nc(bucket):
        # bucket = (tids, hidx[, n_c]); n_c is the static window width
        # (None = full n_r sweep; a tuple gives paint2's two widths)
        n_c = bucket[2] if len(bucket) > 2 else None
        if isinstance(n_c, tuple):
            if n_c[0] >= n_r and (n_r2 is None or n_c[1] >= n_r2):
                return None
            return n_c
        if n_c is not None and n_c >= n_r:
            n_c = None
        return n_c

    def run(bucket, pack, ln_r0, inv_dlnr):
        tids_np = bucket[0]
        tid_d, hid_d, _ = _bucket_on_device(bucket)
        n_c = _bucket_nc(bucket)
        _ensure_crad(n_c)
        out = _get_jitted(n_c)(tid_d, hid_d, pack, ln_r0, inv_dlnr)
        return tids_np, out[:tids_np.shape[0]]

    if mesh is None:
        def run_into(acc, bucket, pack, ln_r0, inv_dlnr):
            tid_d, hid_d, _ = _bucket_on_device(bucket)
            n_c = _bucket_nc(bucket)
            _ensure_crad(n_c)
            return _get_jitted_into(n_c)(
                acc, tid_d, hid_d, pack, ln_r0, inv_dlnr)
        run.into = run_into

    def warm_job(bucket, pack, ln_r0, inv_dlnr, acc_sds=None):
        """Zero-arg callable that AOT-compiles this bucket's kernel
        variant (``jit.lower(...).compile()``). The backend compile
        populates the persistent compilation cache, so the later real
        dispatch is a cache hit; ``warmup()`` runs many such jobs
        concurrently from a thread pool."""
        tid_d, hid_d, _ = _bucket_on_device(bucket)
        n_c = _bucket_nc(bucket)
        _ensure_crad(n_c)
        sds = lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)  # noqa: E731
        pack_s = {k: sds(v) for k, v in pack.items()}
        if mesh is None and acc_sds is not None:
            f = _get_jitted_into(n_c)
            args = (acc_sds, sds(tid_d), sds(hid_d), pack_s,
                    ln_r0, inv_dlnr)
        else:
            f = _get_jitted(n_c)
            args = (sds(tid_d), sds(hid_d), pack_s, ln_r0, inv_dlnr)
        return lambda: f.lower(*args).compile()
    run.warm_job = warm_job

    return run


def count_valid_slots(tiling, tids):
    """Host-side exact count of valid pixel slots in the given tiles
    (integer ring math only — mirrors ``SkyTiling.slot_pix``). Gives the
    static size for device-side compaction of scatter-source lists."""
    N = tiling.nside
    RB = tiling.RB
    i0 = tiling.tile_i0[tids].astype(np.int64)
    s = tiling.tile_s[tids].astype(np.int64)
    S = tiling.tile_S[tids].astype(np.int64)
    i = i0[:, None] + np.arange(RB, dtype=np.int64)[None, :]
    ring_ok = (i >= 1) & (i <= 4 * N - 1)
    i_c = np.clip(i, 1, 4 * N - 1)
    north = i_c < N
    south = i_c > 3 * N
    i_s = 4 * N - i_c
    nr = np.where(north, 4 * i_c, np.where(south, 4 * i_s, 4 * N))
    sh = np.where(north | south, 1, np.where((i_c - N) % 2 == 0, 1, 0))
    j0 = (2 * s[:, None] * nr - sh * S[:, None]
          + 2 * S[:, None] - 1) // (2 * S[:, None])
    j1 = (2 * (s[:, None] + 1) * nr - sh * S[:, None]
          + 2 * S[:, None] - 1) // (2 * S[:, None])
    seg = np.minimum(j1 - j0, tiling.K)
    return int(np.where(ring_ok, seg, 0).sum())


def bucket_tiles(tile_ids, halo_ids, n_buckets=4, h_align=8):
    """Group (tile, halo) pairs into per-tile halo lists, bucketed by list
    length so each bucket runs one static-shape kernel.

    Returns a list of (tiles (T,), halo_idx (T, H) int32 padded with -1).
    """
    # int32 keys: tile ids are < n_tiles << 2^31 and the stable radix
    # argsort runs ~2x faster on half-width keys (24.8M pairs at
    # NSIDE=4096/1e6 halos is a measured multi-minute host-prep stage)
    order = np.argsort(tile_ids.astype(np.int32), kind="stable")
    t_sorted = tile_ids[order]
    h_sorted = halo_ids[order]
    if t_sorted.size == 0:
        return []
    # np.unique would SORT AGAIN (it ignores existing order); the input
    # is already tile-sorted, so boundaries are just neighbour diffs
    bnd = np.empty(t_sorted.size, dtype=bool)
    bnd[0] = True
    np.not_equal(t_sorted[1:], t_sorted[:-1], out=bnd[1:])
    starts = np.flatnonzero(bnd)
    utiles = t_sorted[starts]
    counts = np.diff(np.append(starts, t_sorted.size))
    # bucket edges: geometric in count. x2 growth (not x4): at
    # NSIDE=4096/1e5 halos the x4 classes padded the kept pairs 2.36x
    # (a (8, 32] row pads to H=32) while x2 pads 1.39x for one extra
    # shape class per ~decade of counts — padding is pure waste, the
    # (h, P) kernel does full work on -1 slots. h_align=8 keeps the halo
    # axis a multiple of 8 (a register-shape choice not yet measured on
    # the GPU).
    cmax = int(counts.max())
    edges = [0]
    c = max(h_align, int(np.ceil(counts.min() / h_align) * h_align))
    while c < cmax:
        edges.append(c)
        c *= 2
    edges.append(cmax)
    buckets = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (counts > lo) & (counts <= hi)
        if not sel.any():
            continue
        T = int(sel.sum())
        H = int(np.ceil(hi / h_align) * h_align)
        hidx = np.full((T, H), -1, dtype=np.int32)
        st = starts[sel]
        ct = counts[sel]
        rows = np.repeat(np.arange(T), ct)
        cols = (np.arange(ct.sum())
                - np.repeat(np.concatenate([[0], np.cumsum(ct)[:-1]]), ct))
        src = np.repeat(st, ct) + cols      # vectorized run expansion
        hidx[rows, cols] = h_sorted[src].astype(np.int32)
        buckets.append((utiles[sel].astype(np.int32), hidx))
    return buckets


# ---------------------------------------------------------------------------
# Stencil phase B: the global regrid as a gather stencil over tiles.
#
# Almost every source pixel's displaced position stays within a couple of
# pixels of itself, so its 4-neighbour bilinear deposit can be computed from
# the TARGET side: each target pixel sums the exact healpy interp weights of
# the displaced sources in a small (ring, column) window around it — pure
# fma math, no scatter. Sources that CAN displace further (tiles whose max
# offset exceeds the window, detected on device) plus geometrically
# irregular regions (inner polar caps, sector-count transitions) fall back
# to the ordinary scatter deposit; dilation of the fallback set guarantees
# every (source, target) pair is handled exactly once.
# ---------------------------------------------------------------------------
def stencil_host_info(tiling, W=2, Wc=5, i_min=128):
    """Host precompute for the stencil regrid.

    Returns dict with per-tile neighbour table (n_tiles, 3, 3) int32
    (-1 where unusable), the geometric scatter-source mask D_geom
    (bad tiles dilated by one tile), and per-block offset thresholds for
    the device-side hot-tile test.
    """
    N = tiling.nside
    RB = tiling.RB
    nb = tiling.n_blocks
    n_rings = 4 * N - 1

    # block-level geometry flags
    i0 = tiling.i0
    i_hi = np.minimum(i0 + RB - 1, n_rings)
    blk_bad = (i0 < i_min) | (i_hi > n_rings + 1 - i_min)
    # the stencil's segment-placement select covers any seg in [Wc, K]:
    # the horizontal window [j0 - Wc, j0 + seg + Wc) is covered by the
    # left/center/right segments iff each neighbour segment is at least
    # Wc long (cap segments are nr/S ~ 4i/S pixels — far below K near
    # the poles, where tiles are scatter-routed)
    K = tiling.K
    nr_of0 = lambda i: np.where(i < N, 4 * i,
                                np.where(i > 3 * N, 4 * (4 * N - i),
                                         4 * N))
    i_lo_m = np.clip(i0 - W - 1, 1, n_rings)
    i_hi_m = np.clip(i_hi + W + 1, 1, n_rings)
    nr_min_m = np.minimum(nr_of0(i_lo_m), nr_of0(i_hi_m))
    seg_min = nr_min_m // np.maximum(tiling.S, 1)
    blk_bad |= seg_min < Wc
    # the slab window spans up to K + 2*Wc ring columns; rings shorter
    # than that would wrap a source into the window twice
    blk_bad |= nr_min_m < K + 2 * Wc
    S = tiling.S
    sameS_up = np.zeros(nb, bool)
    sameS_dn = np.zeros(nb, bool)
    sameS_up[1:] = S[1:] == S[:-1]
    sameS_dn[:-1] = S[:-1] == S[1:]

    tb = tiling.tile_block
    ts = tiling.tile_s
    tS = tiling.tile_S
    off = tiling.tile_off[:-1]

    nbr = np.full((tiling.n_tiles, 3, 3), -1, dtype=np.int32)
    for db in (-1, 0, 1):
        b2 = tb + db
        ok = (b2 >= 0) & (b2 < nb)
        if db == -1:
            ok &= sameS_up[tb]
        elif db == 1:
            ok &= sameS_dn[tb]
        for ds in (-1, 0, 1):
            s2 = np.mod(ts + ds, tS)
            tid2 = np.where(ok, off[np.clip(b2, 0, nb - 1)] + s2, -1)
            nbr[:, db + 1, ds + 1] = tid2

    tile_bad = blk_bad[tb]
    # a tile missing any neighbour cannot assemble a full slab: treat the
    # missing side's sources as absent (they are scatter-routed via the
    # dilated mask below), so only geometric badness matters here.
    D_geom = tile_bad.copy()
    for db in range(3):
        for ds in range(3):
            n_ids = nbr[:, db, ds]
            valid = n_ids >= 0
            # dilate: any tile neighbouring a bad tile joins D_geom
            bad_nbr = np.zeros_like(tile_bad)
            bad_nbr[valid] = tile_bad[n_ids[valid]]
            D_geom |= bad_nbr
            # a bad tile's neighbour entry pointing AT a bad tile is fine
    # tiles whose neighbour is missing while the geometry says it should
    # exist (S transition): their cross-boundary sources are unreachable;
    # scatter-route BOTH sides of such boundaries
    miss_up = (nbr[:, 0, 1] < 0) & (tb > 0)
    miss_dn = (nbr[:, 2, 1] < 0) & (tb < nb - 1)
    edge = miss_up | miss_dn
    D_geom |= edge
    for db in range(3):
        for ds in range(3):
            n_ids = nbr[:, db, ds]
            valid = n_ids >= 0
            e_nbr = np.zeros_like(edge)
            e_nbr[valid] = edge[n_ids[valid]]
            D_geom |= e_nbr

    # per-block hot thresholds: a source may move at most (W-1) ring
    # spacings vertically and (Wc-2) columns horizontally to stay inside
    # the stencil window (the -1/-2 absorb the interp bracket and cap
    # column drift)
    th_all = _ring_theta_np(N, np.arange(1, 4 * N))
    dth = np.diff(th_all)
    dth_blk = np.ones(nb) * dth.min()
    for b in range(nb):
        lo = max(int(i0[b]) - 2, 1) - 1
        hi = min(int(i_hi[b]) + 2, n_rings - 1)
        dth_blk[b] = dth[lo:hi].min() if hi > lo else dth.min()
    # smallest ring (largest dphi) in/adjacent to the block governs the
    # phi window; the smallest sin(theta) converts tangent-phi offsets
    i_lo2 = np.clip(i0 - 2, 1, n_rings)
    i_hi2 = np.clip(i_hi + 2, 1, n_rings)
    nr_of = lambda i: np.where(i < N, 4 * i,
                               np.where(i > 3 * N, 4 * (4 * N - i), 4 * N))
    nr_min = np.minimum(nr_of(i_lo2), nr_of(i_hi2))
    dphi_blk = 2.0 * np.pi / np.maximum(nr_min, 1)
    sin_min = np.minimum(np.sin(th_all[i_lo2 - 1]),
                         np.sin(th_all[i_hi2 - 1]))
    th_theta = (W - 1) * dth_blk
    # phi budget: (Wc - 3) columns (one for the interp bracket, one for
    # cap column drift, one for sector-start misalignment); stored as a
    # bound on the stored tangent-phi component |po_phi|
    th_phi = (Wc - 3) * dphi_blk * np.maximum(sin_min, 1e-12)

    return dict(nbr=nbr, D_geom=D_geom, th_theta=th_theta,
                th_phi=th_phi, sin_min=sin_min, W=W, Wc=Wc)


def make_stencil_regrid(tiling, rdt=jnp.float64, W=2, Wc=5, t_chunk=64,
                        mesh=None, mesh_axis="halos"):
    """Build the stencil-regrid kernel.

    Returns ``run(po_tiled, orig_tiled, excl) -> out_tiled`` where
    ``po_tiled`` is (n_tiles, RB*K, 2), ``orig_tiled`` (n_tiles, RB*K),
    ``excl`` (n_tiles,) bool marking scatter-routed SOURCE tiles, and
    ``out_tiled`` (n_tiles, RB*K) the stencil part of the regrid (the
    caller adds the scatter part of excl-tile sources separately).
    """
    N = tiling.nside
    RB, K = tiling.RB, tiling.K
    P = RB * K
    info = stencil_host_info(tiling, W=W, Wc=Wc)
    # (9, n_tiles): minor dim n_tiles keeps the literal free of layout
    # padding of a minor dim of 9
    nbr_d = jnp.asarray(info["nbr"].reshape(tiling.n_tiles, 9).T)
    tile_i0 = jnp.asarray(tiling.tile_i0, dtype=jnp.int32)
    tile_s = jnp.asarray(tiling.tile_s, dtype=jnp.int32)
    tile_S = jnp.asarray(tiling.tile_S, dtype=jnp.int32)
    M = W

    def row_geometry(i0_t, s_t, S_t):
        """Per-slab-row ring data, rows = i0_t - M .. i0_t + RB + M - 1.

        Returns also the left/right neighbour segment offsets needed to
        place their storage rows into the slab's continuous j-space
        (cap-block segments vary between K-2 and K, so the placement is
        per-row data).
        """
        r = i0_t + jnp.arange(-M, RB + M, dtype=jnp.int32)
        r_ok = (r >= 1) & (r <= 4 * N - 1)
        r_c = jnp.clip(r, 1, 4 * N - 1)
        sp, nr, _, sh = hpx.ring_info(N, r_c, jnp.float64)
        theta = hpx.ring_theta(N, r_c, jnp.float64).astype(rdt)
        sh_i = sh.astype(jnp.int32)
        S = S_t
        sm = jnp.mod(s_t - 1, S)
        sp1 = jnp.mod(s_t + 1, S)

        def j0_of(ss):
            return (2 * ss * nr - sh_i * S + 2 * S - 1) // (2 * S)

        j0c = j0_of(s_t)
        j1c = j0_of(s_t + 1)            # note: s_t+1 un-modded = j0c+seg
        segC = j1c - j0c
        # left segment length (mod nr handles the wrap at s=0)
        segL = jnp.mod(j0c - j0_of(sm), nr)
        # dphi/phi0 stay float64: the phi weight must be formed in
        # COLUMN units (see one_tile) and these feed the per-row scale /
        # offset of that coordinate
        dphi = 2.0 * jnp.pi / nr
        phi0 = (j0c.astype(jnp.float64)
                + 0.5 * sh.astype(jnp.float64)) * dphi
        return r_ok, theta, dphi, phi0, segC, segL

    def one_tile(tid, po_t, orig_t, excl):
        # po_t/orig_t stay in their flat (n_tiles, P, ...) layout;
        # reshaping the FULL buffers to (n_tiles, RB, K, ...) up front can
        # make XLA materialize padded copies — only the 9-tile gather
        # result is reshaped here
        parts = nbr_d[:, tid]                    # (9,)
        pvalid = parts >= 0
        pc = jnp.maximum(parts, 0)
        po9 = po_t[pc].reshape(3, 3, RB, K, 2)
        og9 = orig_t[pc].reshape(3, 3, RB, K)
        ex9 = (excl[pc] | ~pvalid).reshape(3, 3)
        og9 = jnp.where(ex9[:, :, None, None], 0.0, og9)
        ok9 = (~ex9)[:, :, None, None]

        r_ok, theta_r, dphi_r, phi0_r, segC, segL = row_geometry(
            tile_i0[tid], tile_s[tid], tile_S[tid])

        # vertical stack of storage rows (rings align across blocks)
        def vstack(col):
            po = jnp.concatenate([po9[0, col][RB - M:], po9[1, col],
                                  po9[2, col][:M]], axis=0)
            og = jnp.concatenate(
                [jnp.where(ok9[0, col], og9[0, col], 0.0)[RB - M:],
                 jnp.where(ok9[1, col], og9[1, col], 0.0),
                 jnp.where(ok9[2, col], og9[2, col], 0.0)[:M]], axis=0)
            return po, og                    # (RB+2M, K, ...)

        poL, ogL = vstack(0)
        poC, ogC = vstack(1)
        poR, ogR = vstack(2)

        # place the three segments into the slab's continuous j-space:
        # slab col q corresponds to j = j0c + (q - Wc). Center storage v
        # sits at q = Wc + v (valid v < segC). Left storage v sits at
        # q = Wc - segL + v (valid v < segL). Right storage v sits at
        # q = Wc + segC + v. segC/segL vary in {K-2..K}: select among the
        # three statically shifted placements.
        Q = K + 2 * Wc
        q = jnp.arange(Q, dtype=jnp.int32)

        def place(po_p, og_p, start, valid_len=None):
            """Shift each row's K storage slots to slab columns
            [start_r, start_r + K), exact for ANY per-row segment length
            (cap segments run from Wc up to K); optionally clip the part
            to its own valid slot range.

            Implemented as a one-hot compare + fma contraction over the
            K storage slots in place of a take_along_axis gather; which
            form is faster on the GPU is not yet measured."""
            if valid_len is not None:
                vmask = jnp.arange(K)[None, :] < valid_len[:, None]
                og_p = jnp.where(vmask, og_p, 0.0)
                po_p = jnp.where(vmask[:, :, None], po_p, 0.0)
            qv = jnp.arange(Q, dtype=jnp.int32)[None, :, None]
            vv = jnp.arange(K, dtype=jnp.int32)[None, None, :]
            sel = (qv == start[:, None, None] + vv)   # (rows, Q, K)
            og_out = jnp.sum(jnp.where(sel, og_p[:, None, :], 0.0),
                             axis=2)
            po_out = jnp.sum(jnp.where(sel[..., None],
                                       po_p[:, None, :, :], 0.0), axis=2)
            return og_out, po_out

        # left: start = Wc - segL, clip to its own segL slots
        ogLs, poLs = place(poL, ogL, Wc - segL, valid_len=segL)
        # center: fixed placement at Wc, clip to segC
        ogCs, poCs = place(poC, ogC, jnp.full_like(segC, Wc),
                           valid_len=segC)
        # right: start = Wc + segC; its dead slots are zero in the
        # accumulator (phase A masks invalid slots)
        ogRs, poRs = place(poR, ogR, Wc + segC)
        og_s = ogLs + ogCs + ogRs
        po_s = poLs + poCs + poRs                        # (rows, Q, 2)

        # source phi is carried as a COLUMN coordinate in the source
        # ring's own grid: c_src = v + offset/(sin * dphi). Absolute-phi
        # subtraction (O(2pi) values vs 2pi/nr spacings) turns f32
        # rounding into a ONE-SIDED weight gain under the max(0, .) clip
        # (a +1.8e-5 total-mass violation at NSIDE=4096); in
        # column units the zero-offset neighbour separation is an exact
        # integer.
        v = q - Wc
        sin_r = jnp.sin(theta_r)
        theta_src = theta_r[:, None] + po_s[:, :, 0].astype(rdt)
        sin_safe = jnp.where(sin_r > 1e-12, sin_r, 1.0)
        col_scale = (sin_safe * dphi_r.astype(rdt))
        c_src = (v[None, :].astype(rdt)
                 + po_s[:, :, 1].astype(rdt) / col_scale[:, None])
        val_src = jnp.where(r_ok[:, None], og_s.astype(rdt), 0.0)

        # per-target-row theta brackets
        th_t = theta_r[M:M + RB]                # (RB,)
        th_up = theta_r[M - 1:M + RB - 1]
        th_dn = theta_r[M + 1:M + RB + 1]
        dm = jnp.maximum(th_t - th_up, 1e-30)
        dp = jnp.maximum(th_dn - th_t, 1e-30)
        # per-target-row phi-grid relation to each source row, computed
        # in float64 and cast: r0 = column offset of the source ring's
        # grid origin in target columns (exactly 0 for same-nr rings),
        # rat = source/target column width ratio (exactly 1 for same nr)
        dphi_t = dphi_r[M:M + RB]                        # f64
        phi0_t = phi0_r[M:M + RB]                        # f64

        out = jnp.zeros((RB, K), dtype=rdt)
        if mesh is not None:
            # loop carry mixes with tid-derived (device-varying) values
            # under shard_map; mark it varying up front
            out = jax.lax.pcast(out, (mesh_axis,), to="varying")
        vt = jnp.arange(K, dtype=jnp.int32).astype(rdt)

        # (du, dv) stencil sweep as a fori_loop: a Python double loop
        # would emit (2M+1)*(2Wc+1) = 55 copies of the body regardless;
        # the loop form lets _stencil_unroll choose.
        nDU, nDV = 2 * M + 1, 2 * Wc + 1

        def sweep(it, acc):
            du = it // nDV                       # 0..2M  (= M + du_rel)
            dv = it - du * nDV                   # 0..2Wc (= Wc + dv_rel)
            p0s = jax.lax.dynamic_slice_in_dim(phi0_r, du, RB)
            d_s = jax.lax.dynamic_slice_in_dim(dphi_r, du, RB)
            r0 = ((p0s - phi0_t) / dphi_t).astype(rdt)   # (RB,)
            rat = (d_s / dphi_t).astype(rdt)             # (RB,)
            ts_ = jax.lax.dynamic_slice(theta_src, (du, dv), (RB, K))
            cs_ = jax.lax.dynamic_slice(c_src, (du, dv), (RB, K))
            vs_ = jax.lax.dynamic_slice(val_src, (du, dv), (RB, K))
            d = ts_ - th_t[:, None]
            wth = jnp.where(
                d <= 0, jnp.maximum(0.0, 1.0 + d / dm[:, None]),
                jnp.maximum(0.0, 1.0 - d / dp[:, None]))
            # source column in target units; |spacing| = 1 by
            # construction, no 2pi wrap needed (slab coordinates are
            # continuous across the ring seam)
            x = r0[:, None] + cs_ * rat[:, None] - vt[None, :]
            wph = jnp.maximum(0.0, 1.0 - jnp.abs(x))
            return acc + wth * wph * vs_

        out = jax.lax.fori_loop(0, nDU * nDV, sweep, out,
                                unroll=_stencil_unroll(nDU * nDV))
        return out.reshape(P)

    def run_all(tid, po_t, orig_t, excl):
        def chunk(t):
            return jax.vmap(lambda ti: one_tile(ti, po_t, orig_t,
                                                excl))(t)
        out = jax.lax.map(chunk, tid)
        return out.reshape(-1, P)

    if mesh is None:
        jitted = jax.jit(run_all)
        ndev = 1
    else:
        from jax.sharding import PartitionSpec as _PS
        ndev = mesh.devices.size
        jitted = jax.jit(jax.shard_map(
            run_all, mesh=mesh,
            in_specs=(_PS(mesh_axis), _PS(), _PS(), _PS()),
            out_specs=_PS(mesh_axis)))

    n_tiles = tiling.n_tiles
    Tp = min(t_chunk, n_tiles)
    nch = -(-(-(-n_tiles // Tp)) // ndev) * ndev
    tid_np = np.zeros(nch * Tp, dtype=np.int32)
    tid_np[:n_tiles] = np.arange(n_tiles)
    tid_d = jnp.asarray(tid_np.reshape(nch, Tp))

    def run(po_tiled, orig_tiled, excl):
        out = jitted(tid_d, po_tiled, orig_tiled, excl)
        return out[:n_tiles]

    return run, info
