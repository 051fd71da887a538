"""Particle snapshot runner: BaryonifySnapshot (2D/3D, periodic box).

Reference: Runners/SnapshotRunner.py. The per-halo KDTree query + Python
offset loop (reference SnapshotRunner.py:176-275) becomes: host-side
neighbour search (the in-repo native C++ periodic cell list in 3D, scipy
cKDTree in 2D) with counts-first bucketing — each bucket of halos is
padded only to ITS max neighbour count, not the global max — then a
device-side batched displacement + scatter-add over particles, optionally
sharded over a device mesh's 'halos' axis with a psum reduction (the
analog of SplitJoinParallel). Minimum-image convention
throughout.
"""

import hashlib

import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial import cKDTree

from ..cosmo import massdef as _massdef
from .HealpixRunner import object_token

__all__ = ["DefaultRunnerSnapshot", "BaryonifySnapshot"]


class DefaultRunnerSnapshot:
    """Shared state for snapshot runners (reference SnapshotRunner.py)."""

    def __init__(self, HaloNDCatalog, ParticleSnapshot, epsilon_max, model,
                 mass_def=_massdef.MassDef200c, verbose=True,
                 halo_batch=256, dtype=jnp.float32, n_size_buckets=4,
                 KDTree_kwargs=None, mesh=None):
        self.HaloNDCatalog = HaloNDCatalog
        self.ParticleSnapshot = ParticleSnapshot
        self.cosmo = HaloNDCatalog.cosmology
        self.model = model
        self.epsilon_max = epsilon_max
        self.mass_def = mass_def
        self.verbose = verbose
        self.halo_batch = halo_batch
        self.dtype = dtype
        self.n_size_buckets = n_size_buckets
        # device mesh with a 'halos' axis: halo batches shard across
        # devices, per-device partial offset accumulators psum-reduce
        self.mesh = mesh
        self._compiled = {}

        cols = ["x", "y"] if ParticleSnapshot.is2D else ["x", "y", "z"]
        self._coords = np.stack(
            [np.asarray(ParticleSnapshot.cat[c], dtype=float) for c in cols],
            axis=1)
        self._kdtree_kwargs = KDTree_kwargs or {}
        self._tree = None

    @property
    def tree(self):
        """Lazy scipy cKDTree (2D path / API parity; the 3D path uses the
        native cell list and never builds it)."""
        if self._tree is None:
            L = self.ParticleSnapshot.L
            self._tree = cKDTree(np.mod(self._coords, L), boxsize=L,
                                 **self._kdtree_kwargs)
        return self._tree

    def _model_p_keys(self):
        return list(vars(self.model).get("p_keys", []))

    def _catalog_token(self):
        """Content digest (hex) of the halo catalog. Keying data caches
        on id(cat) aliases once the old catalog is garbage collected and
        misses in-place mutation; the content hash closes both. Particle
        coords are copied at construction, so the snapshot needs no
        token (a new runner is required to change particles)."""
        return hashlib.blake2b(
            np.ascontiguousarray(self.HaloNDCatalog.cat).tobytes(),
            digest_size=16).hexdigest()

    def invalidate(self):
        """Drop the cached radii / neighbour batches (see
        DefaultRunner.invalidate; rarely needed — process() re-keys on a
        catalog content digest each call)."""
        for k in [k for k in self._compiled if isinstance(k, tuple)
                  and k and k[0] in ("snapradii", "snapbatches")]:
            del self._compiled[k]


class BaryonifySnapshot(DefaultRunnerSnapshot):
    """Displace particles around each halo
    (reference SnapshotRunner.py:162-275). Returns the new particle catalog
    (positions wrapped back into the box)."""

    def process(self):
        from ..cosmo.core import cosmology_from_dict
        cosmo = cosmology_from_dict(self.cosmo)

        snap = self.ParticleSnapshot
        L = snap.L
        is2D = snap.is2D
        ndim = 2 if is2D else 3
        n_part = len(snap.cat)
        coords = self._coords            # (n_part, ndim)

        cat = self.HaloNDCatalog.cat
        cat_tok = self._catalog_token()
        model_tok = object_token(self.model)
        a = 1.0 / (1.0 + self.HaloNDCatalog.redshift)
        M = np.asarray(cat["M"], dtype=float)
        rkey = ("snapradii", cat_tok, float(a), self.mass_def.name)
        if rkey not in self._compiled:
            R = np.asarray(jax.jit(lambda M, a: self.mass_def.get_radius(
                cosmo, M, a))(M, a))
            for k in [k for k in self._compiled if k[0] == "snapradii"]:
                del self._compiled[k]
            self._compiled[rkey] = R
        R = self._compiled[rkey]
        R_q = np.clip(self.epsilon_max * R / a, 0, L / 2)
        hcols = ["x", "y"] if is2D else ["x", "y", "z"]
        hpos = np.stack([np.asarray(cat[c], dtype=float) for c in hcols],
                        axis=1)
        keys = self._model_p_keys()
        extras = [np.asarray(cat[k], dtype=float) for k in keys]

        model = self.model
        dt = self.dtype
        # particle coords live on device once per runner: the compiled
        # step closes over them as a constant, so re-uploading them per
        # call (24 MB at 1e6 particles) would be pure host->device waste
        if getattr(self, "_coords_dev", None) is None:
            self._coords_dev = jnp.asarray(coords)
        coords_dev = self._coords_dev

        # curve fast path: collapse the model's
        # (z, M[, p_keys]) table axes to one radial curve per halo ONCE
        # (the snapshot is single-redshift, so z and the p_keys columns
        # are per-halo scalars), then the per-(halo, particle) readout
        # is a 1D log-uniform lerp instead of an N-D multilinear table
        # interpolation — the same fast path every shell runner uses
        # (HealpixRunner._halo_curve_arrays). Identical values: the
        # multilinear readout factorizes axis-by-axis.
        curve_meta = None
        if hasattr(model, "halo_curves"):
            ckey = ("snapcurves_jit", object_token(model))
            if ckey not in self._compiled:
                m = model
                if dt == jnp.float32 and hasattr(m, "with_dtype"):
                    m = m.with_dtype(dt)
                self._compiled[ckey] = jax.jit(
                    lambda M, a, pkw: (lambda c, l0, dl:
                                       (c.astype(dt), l0, dl))(
                        *m.halo_curves(M, a, **pkw)))
            pkw = {k: e for k, e in zip(keys, extras)}
            curves, ln_r0, dlnr = self._compiled[ckey](
                M, np.full_like(M, a), pkw)
            ln_r0, dlnr = float(ln_r0), float(dlnr)
            Rcom = R / a
            rscale = (1.0 / Rcom
                      if getattr(model, "Rdelta_sampling", False)
                      else np.ones_like(Rcom)).astype(np.float64)
            eps_edge = (self.epsilon_max * Rcom).astype(np.float64)
            curve_meta = (ln_r0, dlnr)

        # the per-halo curves enter the compiled step as ARGUMENTS (not
        # baked constants): a parameter sweep (same geometry, new model
        # curves) then reuses the compiled kernels AND the cached
        # neighbour batches with zero recompiles — the whole point of
        # the serving pattern
        cpack = ()
        if curve_meta is not None:
            npdt = np.dtype(dt)
            cpack = (curves, jnp.asarray(rscale.astype(npdt)),
                     jnp.asarray(eps_edge.astype(npdt)))

        def make_run(K):
            def one_halo(cpack, hp, M_h, valid_h, inds, nn, gid, *o_h):
                # inds: (K,) padded neighbour indices; nn true count;
                # gid the halo's global catalog index (curve row)
                p = coords_dev[inds]                    # (K, ndim)
                dx = p - hp[None, :]
                dx = jnp.where(dx > L / 2, dx - L, dx)  # min-image
                dx = jnp.where(dx < -L / 2, dx + L, dx)
                d = jnp.sqrt(jnp.sum(dx ** 2, axis=-1))
                d_safe = jnp.where(d > 0, d, 1.0)
                if curve_meta is not None:
                    from ..Profiles.BaryonCorrection import \
                        BaryonificationClass as _BC
                    ln_r0_, dlnr_ = curve_meta
                    d_l = jnp.where(d > 0, d, 1e-30).astype(dt)
                    off = _BC.curve_lookup(cpack[0][gid], ln_r0_, dlnr_,
                                           d_l * cpack[1][gid])
                    off = jnp.where(d.astype(dt) < cpack[2][gid],
                                    off, 0.0)
                else:
                    kw = {k: o for k, o in zip(keys, o_h)}
                    off = model.displacement(d, M_h, a, **kw)
                off = jnp.reshape(off, d.shape).astype(dt)
                off = jnp.where(jnp.isfinite(off), off, 0.0)
                vec = off[:, None] * (dx / d_safe[:, None]).astype(dt)
                m = (jnp.arange(K) < nn) & valid_h
                vec = jnp.where(m[:, None], vec, 0.0)
                inds = jnp.where(m, inds, n_part)       # dummy row
                return inds, vec

            def body(cpack, acc, batch):
                hp_b, M_b, valid_b, inds_b, nn_b, gid_b, *o_b = batch
                inds, vec = jax.vmap(
                    lambda *aa: one_halo(cpack, *aa))(
                    hp_b, M_b, valid_b, inds_b, nn_b, gid_b, *o_b)
                # FLAT accumulator (ndim*(n_part+1),): component c of
                # particle i lives at [c*(n_part+1) + i]: ndim 1-wide
                # scatters in place of one (n, ndim) row scatter, as in
                # HealpixRunner phase A.
                flat = inds.reshape(-1)
                idx = jnp.concatenate(
                    [flat + c * (n_part + 1) for c in range(ndim)])
                upd = jnp.concatenate(
                    [vec[..., c].reshape(-1) for c in range(ndim)])
                return acc.at[idx].add(upd), None

            def scan_all(acc_in, batch, cpack):
                acc_out, _ = jax.lax.scan(
                    lambda acc, b: body(cpack, acc, b), acc_in, batch)
                return acc_out
            return scan_all

        # ---- neighbour lists + device batches: built once, cached -----
        # The padded neighbour lists are the dominant per-call cost at
        # scale (host cell-list query + a ~100 MB host->device upload at
        # 1e6 particles / 20k halos) while the halo/particle GEOMETRY is
        # fixed per runner — only the model's curves change between
        # calls in a parameter sweep. So the batches are built and
        # uploaded once per (catalog, snapshot, epsilon_max) and reused
        # by every subsequent process() call (same pattern as the shell
        # runner's cached tile buckets).
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        bkey = ("snapbatches", cat_tok, n_part, float(np.sum(R_q)),
                self.n_size_buckets, self.halo_batch, ndev, tuple(keys))
        batches = self._compiled.get(bkey)
        if batches is None:
            # host-side neighbour COUNTS first (one cheap pass); the
            # padded index lists are built per count-bucket below, each
            # padded only to its own bucket max (a global-max pad would
            # let one dense halo inflate the (nq, pad) array for all)
            if not is2D:
                from .. import native
                counts = native.cell_query_counts(coords, L, hpos, R_q)
                neigh2d = None
            else:
                neigh2d = self.tree.query_ball_point(np.mod(hpos, L),
                                                     R_q)
                counts = np.array([len(x) for x in neigh2d],
                                  dtype=np.int64)
            if n_part >= np.iinfo(np.int32).max:
                # a stripped assert (python -O) would let int32 neighbour
                # indices wrap and scatter displacements silently wrong
                raise ValueError(
                    f"n_part={n_part} exceeds int32 neighbour indexing")
            # bucket halos by neighbour count; each bucket re-queries
            # the cell list with ITS OWN pad (counts are exact, so no
            # truncation)
            order = np.argsort(counts)
            splits = np.array_split(order,
                                    max(1, min(self.n_size_buckets,
                                               len(counts))))
            batches = []
            for idx in splits:
                if idx.size == 0:
                    continue
                K = max(int(counts[idx].max()), 1)
                if neigh2d is None:
                    from .. import native
                    inds_pad, _ = native.cell_query(coords, L,
                                                    hpos[idx],
                                                    R_q[idx], pad=K)
                    inds_pad = np.where(inds_pad < 0, n_part,
                                        inds_pad).astype(np.int32)
                else:
                    inds_pad = np.full((idx.size, K), n_part,
                                       dtype=np.int32)
                    for row, j in enumerate(idx):
                        inds_pad[row, :counts[j]] = neigh2d[j]
                # pad halo axis to batch multiples (and, sharded, to a
                # batch count divisible by the mesh size)
                B = max(1, min(self.halo_batch, 8_000_000 // K))
                nb = -(-idx.size // B)
                nb = -(-nb // ndev) * ndev
                pad = nb * B - idx.size

                def padb(x, fill=0.0):
                    shape = (pad,) + x.shape[1:]
                    return np.concatenate(
                        [x, np.full(shape, fill, dtype=x.dtype)]
                    ).reshape((nb, B) + x.shape[1:])

                batch = (jnp.asarray(padb(hpos[idx])),
                         jnp.asarray(padb(M[idx])),
                         jnp.asarray(np.concatenate(
                             [np.ones(idx.size, bool),
                              np.zeros(pad, bool)]).reshape(nb, B)),
                         jnp.asarray(padb(inds_pad,
                                          fill=np.int32(n_part))),
                         jnp.asarray(padb(counts[idx]
                                          .astype(np.int32))),
                         jnp.asarray(padb(idx.astype(np.int32))),
                         ) + tuple(jnp.asarray(padb(e[idx]))
                                   for e in extras)
                batches.append((K, nb, B, batch))
            for k in [k for k in self._compiled
                      if k[0] == "snapbatches" and k != bkey]:
                del self._compiled[k]     # bound device-memory growth
            self._compiled[bkey] = batches

        acc = jnp.zeros((ndim * (n_part + 1),), dtype=dt)
        for K, nb, B, batch in batches:
            scan_all = make_run(K)
            # the curve path takes the model's curves as ARGUMENTS (no
            # recompile on a model swap: only the static curve grid is
            # baked); the generic-displacement fallback bakes the
            # model's table as closure constants, so it keys on the
            # model identity token
            mkey = (("curves", curve_meta, int(curves.shape[1]))
                    if curve_meta is not None else ("model", model_tok))
            kkey = ("snapstep", K, nb, B, ndim, len(extras),
                    self.mesh is None, mkey)
            if kkey not in self._compiled:
                if self.mesh is None:
                    self._compiled[kkey] = jax.jit(scan_all,
                                                   donate_argnums=0)
                else:
                    # shard the batch axis over the mesh's 'halos' axis;
                    # each device scatters into a full-size local partial
                    # accumulator, psum at the end (SplitJoinParallel
                    # analog, reference utils/Parallelize.py:297-320)
                    from jax.sharding import PartitionSpec as P

                    def sharded(acc_in, batch, cpack):
                        z = jax.lax.pcast(
                            jnp.zeros_like(acc_in), ("halos",), to="varying")
                        z = scan_all(z, batch, cpack)
                        return acc_in + jax.lax.psum(z, "halos")

                    self._compiled[kkey] = jax.jit(jax.shard_map(
                        sharded, mesh=self.mesh,
                        in_specs=(P(), P("halos"), P()), out_specs=P()),
                        donate_argnums=0)
            acc = self._compiled[kkey](acc, batch, cpack)

        off_flat = np.asarray(acc, dtype=np.float64)

        new_cat = snap.cat.copy()
        for d_i, c in enumerate(hcols):
            new_cat[c] = (new_cat[c]
                          + off_flat[d_i * (n_part + 1):
                                     d_i * (n_part + 1) + n_part])
            new_cat[c] = np.where(new_cat[c] > L, new_cat[c] - L, new_cat[c])
            new_cat[c] = np.where(new_cat[c] < 0, new_cat[c] + L, new_cat[c])
        return new_cat
