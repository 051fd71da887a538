"""HEALPix shell runners: BaryonifyShell, PaintProfilesShell (+Anis).

Reference: Runners/HealpixRunner.py. The reference's per-halo Python hot
loop (HealpixRunner.py:315, ~1200-1500 halos/s on one core) is re-designed
as a fixed-shape batched pipeline:

  phase A (per halo, vmapped + scanned in batches, sharded over devices):
     static-shape disc query (ops.healpix.disc_candidates) -> displacement
     table readout -> TANGENT-ANGLE deltas (d theta, tangent-phi) ->
     masked scatter-add into a per-pixel (npix, 2) accumulator
  phase B (global regrid, one fused kernel over all pixels):
     theta/phi + accumulated deltas -> 4-neighbour bilinear weights ->
     weighted scatter-add of the original map (the numba kernel
     regrid_pixels_hpix, HealpixRunner.py:17-74, becomes one .at[].add)

Numerical note: accumulating angle-space deltas is first-order identical to
the reference's normalize(vec + offset) - vec (offsets are <~1e-3 rad;
differences are second order) and is inherently cancellation-free, so the
hot path runs in float32. Angle accumulation also cuts the scatter payload
from 3 to 2 components.

The mass-conservation tripwire (sum(new) == sum(old),
HealpixRunner.py:367-370) is kept as a host-side check.
"""

import hashlib
import itertools
import os
import time
from functools import partial
import numpy as np
import jax
import jax.numpy as jnp

from ..cosmo import core as _core
from ..cosmo import massdef as _massdef
from ..ops import healpix as hpx

__all__ = ["DefaultRunner", "BaryonifyShell", "PaintProfilesShell",
           "PaintProfilesAnisShell"]

_OBJ_TOKENS = itertools.count()


def object_token(obj):
    """GC-safe identity token for cache keys: a monotone counter stamped
    on the object. ``id()`` values recur once an object is garbage
    collected (the classic stale-cache aliasing), a counter attribute
    cannot — a new object at the same address simply lacks the attribute
    and receives a fresh count. Table-rebuilding methods
    (``setup_interpolator`` / ``load_table``) pop the attribute, so a
    model whose table content changed re-keys automatically."""
    tok = getattr(obj, "_bfg_token", None)
    if tok is None:
        tok = next(_OBJ_TOKENS)
        try:
            obj._bfg_token = tok
        except (AttributeError, TypeError):
            tok = ("id", id(obj))          # attr-less objects: best effort
    return tok


class DefaultRunner:
    """Shared state for shell runners (reference HealpixRunner.py:78-232)."""

    def __init__(self, HaloLightConeCatalog, LightconeShell, epsilon_max,
                 model, use_ellipticity=False,
                 mass_def=_massdef.MassDef200c, include_pixel_size=False,
                 verbose=True, halo_batch=4096, dtype=jnp.float32,
                 mesh=None, n_size_buckets=4, pixel_budget=4_000_000,
                 regrid_dtype=jnp.float64, deposit="auto",
                 regrid="auto", transfer="auto"):
        self.HaloLightConeCatalog = HaloLightConeCatalog
        self.LightconeShell = LightconeShell
        self.cosmo = HaloLightConeCatalog.cosmology
        self.model = model
        self.epsilon_max = epsilon_max
        self.mass_def = mass_def
        self.verbose = verbose
        self.include_pixel_size = include_pixel_size
        self.use_ellipticity = use_ellipticity
        self.halo_batch = halo_batch
        self.dtype = dtype
        # device mesh with a 'halos' axis: the halo-batch axis is sharded
        # across devices and per-device partial maps are psum-reduced —
        # the analog of the reference's SplitJoinParallel
        # (utils/Parallelize.py:218-320)
        self.mesh = mesh
        self.n_size_buckets = n_size_buckets
        self.pixel_budget = pixel_budget
        self.regrid_dtype = regrid_dtype
        # phase-A algorithm: "tiles" = scatter-free dense per-tile gather
        # (ops/tiles.py; needs per-halo curves), "scatter" = flat
        # .at[].add accumulation, "auto" = tiles when available
        self.deposit = deposit
        # phase-B algorithm: "stencil" = gather stencil over tiles with a
        # scatter fallback for hot/irregular tiles (single-device, tiled
        # phase A only), "scatter" = the chunked scatter regrid, "auto" =
        # stencil when available
        self.regrid = regrid
        # result-download strategy: "sparse" = download only the pixel
        # blocks the run actually changed (ops/transfer.py; lossless),
        # "dense" = plain np.asarray, "auto" = sparse when the map shape
        # allows it
        self.transfer = transfer
        # per-process() wall-time split, for diagnosable benchmarks:
        # {"compute_s": device work incl. host prep, "transfer_s":
        #  device->host download of the result map}
        self.timings = {}
        # compiled-kernel cache: closures are rebuilt on every process()
        # call, so jit identity alone would recompile each time; we key
        # compiled executables by static shape info instead
        self._compiled = {}
        if use_ellipticity:
            raise NotImplementedError(
                "use_ellipticity is not implemented for curved-sky runners")

    def build_Rmat(self, A, ref):
        """2x2 rotation matrix aligning vector ``A`` with ``ref``
        (API parity with reference HealpixRunner.py:180-208)."""
        A = np.asarray(A, dtype=float)
        ref = np.asarray(ref, dtype=float)
        A = A / np.linalg.norm(A)
        ref = ref / np.linalg.norm(ref)
        ang = np.arccos(np.clip(np.dot(A, ref), -1.0, 1.0))
        return np.array([[np.cos(ang), -np.sin(ang)],
                         [np.sin(ang), np.cos(ang)]])

    def coord_array(self, *args):
        """Flatten and column-stack coordinate arrays
        (reference HealpixRunner.py:212-232)."""
        return np.vstack([np.asarray(a).flatten() for a in args]).T

    # ---- content tokens for data-derived caches ----------------------
    # Caches used to key on id(catalog)/id(map), which (a) recurs after
    # garbage collection and (b) misses in-place mutation. Every
    # process() call refreshes these tokens (_refresh_tokens), so a
    # mutated catalog/map/model simply re-prepares.
    def _catalog_token(self):
        """Content digest (hex) of the halo catalog columns (~40 ms per
        1e6 halos — the structured array is one contiguous buffer)."""
        cat = self.HaloLightConeCatalog.cat
        return hashlib.blake2b(np.ascontiguousarray(cat).tobytes(),
                               digest_size=16).hexdigest()

    def _map_token(self):
        """Content digest (hex) of the shell map: exact float64 sum plus
        a 1/16-strided byte sample (hashing the full 0.8 GB NSIDE=4096
        buffer every call would cost ~1 s; the sample catches any
        realistic in-place edit, and mutations invisible to BOTH the sum
        and the sample can be forced out with :meth:`invalidate`)."""
        m = np.asarray(self.LightconeShell.map)
        dg = hashlib.blake2b(digest_size=16)
        dg.update(np.ascontiguousarray(m[::16]).tobytes())
        dg.update(repr((m.shape, str(m.dtype),
                        float(m.sum(dtype=np.float64)))).encode())
        return dg.hexdigest()

    def _refresh_tokens(self, need_map=True):
        self._cat_tok = self._catalog_token()
        self._model_tok = object_token(self.model)
        if need_map:
            self._map_tok = self._map_token()

    def invalidate(self):
        """Drop every data-derived cache (prepared halo batches, tile
        buckets, uploaded maps/curves, host prep). Compiled kernels are
        kept. Not normally needed: process() re-keys on content digests
        of the catalog and map and on the model's identity token each
        call; this is the escape hatch for mutations those tokens cannot
        see (e.g. a map edit invisible to both the sum and the strided
        sample of :meth:`_map_token`)."""
        drop = ("prepared", "tilebin", "tilepack", "hostprep", "origmap",
                "orighost", "origtiled_val", "snapbatches", "snapradii")
        for k in [k for k in self._compiled
                  if isinstance(k, tuple) and k and k[0] in drop]:
            del self._compiled[k]

    def _scan_accumulate(self, scan_fn, batches, acc_shape, acc_dtype,
                         extra_key=None):
        """Scan ``scan_fn`` over the batch axis, optionally sharded over
        the mesh's 'halos' axis with a psum reduction."""

        # the scan body's closure bakes the model's table as constants:
        # key on the model token so a swapped/rebuilt model recompiles
        # (extra_key lets callers add further baked-constant identities,
        # e.g. the Anis fallback's captured Mtot/orig device maps)
        key = (tuple((tuple(b.shape), str(b.dtype)) for b in batches),
               tuple(acc_shape), str(acc_dtype), self.mesh is None,
               self._model_tok, extra_key)
        if key not in self._compiled:
            def local(batches_local, varying=False):
                acc = jnp.zeros(acc_shape, dtype=acc_dtype)
                if varying:  # in shard_map the carry must be axis-varying
                    acc = jax.lax.pcast(acc, ("halos",), to="varying")
                acc, _ = jax.lax.scan(scan_fn, acc, batches_local)
                return acc

            if self.mesh is None:
                self._compiled[key] = jax.jit(local)
            else:
                from jax.sharding import PartitionSpec as P

                def sharded(batches_local):
                    return jax.lax.psum(local(batches_local, varying=True),
                                        "halos")

                self._compiled[key] = jax.jit(
                    jax.shard_map(sharded, mesh=self.mesh,
                                  in_specs=P("halos"), out_specs=P()))
        return self._compiled[key](batches)

    def _n_batch_multiple(self):
        return 1 if self.mesh is None else self.mesh.devices.size

    def _finish_map(self, out_dev, t_start, base_dev=None, base_host=None):
        """Record the compute/transfer wall-time split and download the
        result map (sparsely when possible)."""
        out_dev.block_until_ready()
        timings = {"compute_s": time.time() - t_start}
        t0 = time.time()
        out = self._fetch_map(out_dev, base_dev, base_host)
        timings["transfer_s"] = time.time() - t0
        timings["transfer_mb"] = round(
            getattr(self, "_last_fetch_mb", 0.0), 1)
        self.timings = timings
        return out

    def _fetch_executor(self):
        """Single-worker thread pool for overlapped result downloads."""
        ex = self._compiled.get("fetch_executor")
        if ex is None:
            from concurrent.futures import ThreadPoolExecutor
            ex = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="bfg-fetch")
            self._compiled["fetch_executor"] = ex
        return ex

    def _dispatch_executor(self):
        """Single-worker thread pool for the per-call compute dispatch.

        With a dedicated dispatch thread, process_async() returns
        immediately and N pipelined calls cost max(total dispatch, total
        fetch) instead of interleaving serially. Whether that still pays
        on the GPU, where dispatches do not block, is not yet
        measured."""
        ex = self._compiled.get("dispatch_executor")
        if ex is None:
            from concurrent.futures import ThreadPoolExecutor
            ex = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="bfg-dispatch")
            self._compiled["dispatch_executor"] = ex
        return ex

    def _async_via_dispatch(self, dispatch_fn):
        """Run ``dispatch_fn() -> Future`` on the dispatch thread and
        return a proxy Future that resolves with the inner (fetch)
        future's result — so compute dispatch AND result download both
        stay off the caller's thread. The caller's ``jax.default_device``
        (a thread-local setting) carries over to both threads."""
        from concurrent.futures import Future
        outer = Future()
        outer.timings = {}
        device = jax.config.jax_default_device

        def run():
            try:
                with jax.default_device(device):
                    inner = dispatch_fn()
            except BaseException as e:          # noqa: BLE001
                outer.set_exception(e)
                return

            def done(f):
                outer.timings.update(getattr(f, "timings", {}))
                exc = f.exception()
                if exc is not None:
                    outer.set_exception(exc)
                else:
                    outer.set_result(f.result())
            inner.add_done_callback(done)

        self._dispatch_executor().submit(run)
        return outer

    def _submit_fetch(self, out_dev, t_start, base_dev=None,
                      base_host=None, conserve_sum=None):
        """Fetch ``out_dev`` on a background thread; return a Future.

        This is what makes repeated ``process_async()`` calls PIPELINE:
        the device->host download of call k runs on the fetch thread
        while the main thread dispatches call k+1's compute — JAX
        releases the GIL during transfers, so steady-state wall time is
        max(compute, transfer) per call instead of their sum. The future
        resolves to the host map; its per-call wall-time split is
        attached as ``fut.timings`` once resolved (also mirrored to
        ``runner.timings``)."""
        timings = {}
        device = jax.config.jax_default_device

        def run():
            with jax.default_device(device):
                out = self._finish_map(out_dev, t_start, base_dev,
                                       base_host)
            timings.update(self.timings)
            if conserve_sum is not None:
                new_sum = float(out.sum())
                assert np.isclose(new_sum, conserve_sum), (
                    "ERROR in pixel regridding, sum(new_map) [%0.14e] != "
                    "sum(oldmap) [%0.14e]" % (new_sum, conserve_sum))
            return out

        fut = self._fetch_executor().submit(run)
        fut.timings = timings            # filled before the future resolves
        return fut

    @staticmethod
    def _done_future(value):
        from concurrent.futures import Future
        fut = Future()
        fut.set_result(value)
        fut.timings = {}
        return fut

    def _host_map(self, rdt):
        """The cached host-side cast matching ``_device_map``'s upload
        (filled by _device_map; None if not yet uploaded)."""
        return self._compiled.get(("orighost", self._map_tok, str(rdt)))

    def _fetch_map(self, new_dev, base_dev=None, base_host=None):
        """Download a result map, sparsely when possible (ops/transfer).

        ``base_dev``/``base_host`` are the device and host copies of the
        map the result should be diffed against (the uploaded original
        for baryonify; zeros — pass None — for paint)."""
        from ..ops.transfer import SparseMapFetcher, multistream_get
        npix = new_dev.shape[0]
        if base_dev is not None and base_host is None:
            self._last_fetch_mb = npix * new_dev.dtype.itemsize / 1e6
            return multistream_get(new_dev, np.float64)
        # block sized so the bitmap stays ~1e3-1e4 entries; any HEALPix
        # npix = 12*nside^2 with nside >= 8 divides by 768
        block = next((b for b in (4096, 768)
                      if npix % b == 0 and npix >= 64 * b), None)
        if self.transfer in ("auto", "sparse") and block:
            fkey = ("sparsefetch", npix, block)
            if fkey not in self._compiled:
                self._compiled[fkey] = SparseMapFetcher(npix, block=block)
            fx = self._compiled[fkey]
            out = fx.fetch(new_dev, base_dev, base_host)
            st = fx.last_stats
            dense = st["frac"] > fx.dense_threshold
            self._last_fetch_mb = (npix * new_dev.dtype.itemsize / 1e6
                                   if dense else st["mbytes"])
            return out
        self._last_fetch_mb = npix * new_dev.dtype.itemsize / 1e6
        return multistream_get(new_dev, np.float64)


    def _device_map(self, orig_map, rdt, host_sum):
        """Upload the shell map once per (content, dtype) and reuse the
        device copy: repeated baryonify/paint passes over the same shell
        are common. The map is shipped in the regrid dtype (the
        kernels consume ``orig.astype(rdt)`` anyway), halving the bytes in
        float32. Keyed by the map content token so mutated maps
        re-upload (see _map_token)."""
        key = ("origmap", self._map_tok, str(rdt))
        if key not in self._compiled:
            # drop stale uploads of other shells to cap device memory
            for k in [k for k in self._compiled
                      if k[0] in ("origmap", "orighost")]:
                del self._compiled[k]
            host = orig_map.astype(
                np.float64 if rdt == jnp.float64 else np.float32)
            # the host-side cast is kept for the sparse result download:
            # it is bitwise-identical to the device copy, so unchanged
            # blocks never cross the link (ops/transfer.py)
            self._compiled[("orighost",) + key[1:]] = host
            self._compiled[key] = jnp.asarray(host)
        return self._compiled[key]

    # ------------------------------------------------------------------
    def _host_halo_data(self, cosmo_jax):
        """Per-halo static data computed host-side (numpy f64).

        The two cosmology evaluations are jitted: op-by-op dispatch of
        their many small ops costs more than the math.
        """
        cat = self.HaloLightConeCatalog.cat
        z = np.asarray(cat["z"], dtype=float)
        assert z.max() <= 30, f"max(z) = {z.max()} exceeds the z<=30 assumption"
        M = np.asarray(cat["M"], dtype=float)
        a = 1.0 / (1.0 + z)
        jkey = ("hostprep_jit", self.mass_def.name)
        if jkey not in self._compiled:
            self._compiled[jkey] = jax.jit(lambda M, a: (
                self.mass_def.get_radius(cosmo_jax, M, a),
                _core.angular_diameter_distance(cosmo_jax, a)))
        R_dev, D_dev = self._compiled[jkey](M, a)
        R = np.asarray(R_dev)                                  # physical
        D = np.asarray(D_dev)
        theta = np.radians(90.0 - np.asarray(cat["dec"], dtype=float))
        phi = np.radians(np.asarray(cat["ra"], dtype=float))
        radius = R * self.epsilon_max / D
        return dict(M=M, z=z, a=a, R=R, D=D, theta=theta, phi=phi,
                    radius=radius)

    def _model_p_keys(self):
        return list(vars(self.model).get("p_keys", []))

    def _jit_halo_curves(self, model, kind=None):
        """(cached) jitted per-halo-curve builder. The table is read in
        its own dtype (f64) and the curves are cast to self.dtype INSIDE
        the jit: the readout runs once per halo, and an f32 readout
        biased painted maps by ~3e-5 of their total. Keyed by the model's
        identity token (so a swapped/rebuilt model recompiles, see
        object_token)."""
        dt = self.dtype
        key = ("halo_curves_jit", object_token(model), kind, str(dt))
        if key not in self._compiled:
            kw = {} if kind is None else {"kind": kind}

            def f(M, a, pkw):
                c, ln_r0, dlnr = model.halo_curves(M, a, **kw, **pkw)
                return c.astype(dt), ln_r0, dlnr

            self._compiled[key] = jax.jit(f)
        return self._compiled[key]

    def _jit_curves_raw(self, model):
        """(cached) jitted raw projected halo curves in the table's own
        dtype — the Anis paths clamp/cast in their curveclamp kernels.
        Keyed by the model identity token (see object_token)."""
        key = ("halo_curves_raw_jit", object_token(model))
        if key not in self._compiled:
            self._compiled[key] = jax.jit(
                lambda M, a, pkw: model.halo_curves(M, a,
                                                    kind="projected",
                                                    **pkw))
        return self._compiled[key]

    def _padded_batches(self, arrays, batch):
        """Stack per-halo arrays into (n_batches, batch) with zero padding
        (n_batches padded to a multiple of the mesh size when sharded);
        returns also the validity mask."""
        n = arrays[0].shape[0]
        nb = -(-n // batch)
        mult = self._n_batch_multiple()
        nb = -(-nb // mult) * mult
        pad = nb * batch - n
        out = []
        for x in arrays:
            xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:],
                                             dtype=x.dtype)])
            out.append(xp.reshape((nb, batch) + x.shape[1:]))
        valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
        return out, valid.reshape(nb, batch)

    def _bucketed_accumulate(self, make_body, hd, extras, acc_shape,
                             acc_dtype, NSIDE, extra_key=None):
        """Run the per-halo accumulation with halos bucketed by disc size.

        Static shapes force every halo in a batch to pay the largest disc's
        padding; bucketing by angular radius (quantiles) gives each bucket
        its own (K_ring, K_phi), cutting wasted gather/compute by ~the
        dynamic range of disc areas. Accumulators are summed across buckets
        (scatter-adds are order-independent in exact math; f32 rounding
        differences are negligible).

        ``make_body(K_ring, K_phi)`` must return the scan body over one
        padded halo batch.

        The grouped/padded device batches are cached keyed by the catalog
        object: repeated process() calls (parameter sweeps over the same
        halos) skip the host-side bucketing and the host->device batch
        upload entirely.
        """
        pkey = ("prepared", self._cat_tok, self._model_tok, NSIDE,
                hd["radius"].shape[0], float(hd["radius"].sum()),
                len(extras), self._n_batch_multiple())
        if pkey in self._compiled:
            prepared = self._compiled[pkey]
        else:
            prepared = self._prepare_groups(hd, extras, NSIDE)
            for k in [k for k in self._compiled if k[0] == "prepared"]:
                del self._compiled[k]
            self._compiled[pkey] = prepared

        acc_total = None
        for gi, (K_ring, K_phi, batches) in enumerate(prepared):
            if self.verbose:
                import sys as _sys
                import time as _time
                t0 = _time.time()
            body = make_body(K_ring, K_phi)
            # the window (K_ring, K_phi) is baked into the body: buckets
            # whose batches share shapes must not share a kernel
            acc = self._scan_accumulate(body, batches, acc_shape,
                                        acc_dtype,
                                        extra_key=(extra_key, K_ring, K_phi))
            if self.verbose:
                nb, bsz = batches[0].shape[:2]
                print(f"[baryonforge] bucket {gi + 1}/{len(prepared)}: "
                      f"window {K_ring}x{K_phi}, {nb}x{bsz} halos, "
                      f"{_time.time() - t0:.2f}s (incl. first-call "
                      f"compile)", file=_sys.stderr)
            acc_total = acc if acc_total is None else acc_total + acc
        return acc_total

    def _prepare_groups(self, hd, extras, NSIDE):
        """Host-side bucketing + padding + device upload (see
        _bucketed_accumulate)."""
        radius = hd["radius"]
        n = radius.shape[0]
        nbuck = max(1, min(self.n_size_buckets, n))

        # second bucketing axis: the disc's minimum sin(theta). Near-polar
        # rings force a phi window ~2-3x wider than the equatorial need,
        # and for an isotropic catalog only a few % of discs ever touch
        # them — giving those their own (wider) kernels lets everyone else
        # run with the tight window. The equatorial class (>~95% of halos)
        # keeps the radius quantile buckets; the two polar classes are each
        # a single bucket to bound kernel count (each static window shape
        # is a separate XLA compile).
        theta_c = hd["theta"]
        lo = np.minimum(np.sin(theta_c - radius), np.sin(theta_c + radius))
        pole = (theta_c - radius < 0) | (theta_c + radius > np.pi)
        smin = np.where(pole, 0.0, np.maximum(lo, 0.0))
        S_EQ = 0.25
        eq = smin >= S_EQ
        mid = (smin >= 0.05) & ~eq
        pol = smin < 0.05

        groups = []                      # (halo index array, sin_min band)
        order = np.argsort(radius[eq])
        for idx in np.array_split(np.where(eq)[0][order], nbuck):
            groups.append((idx, S_EQ))
        groups.append((np.where(mid)[0], 0.05))
        groups.append((np.where(pol)[0], 0.0))

        arrays = [hd["theta"], hd["phi"], hd["radius"], hd["M"], hd["a"],
                  hd["D"]]
        prepared = []
        for idx, s_th in groups:
            if idx.size == 0:
                continue
            r_max = float(radius[idx].max())
            K_ring, K_phi = hpx.disc_pad_sizes(NSIDE, r_max, s_th)
            K_phi = -(-K_phi // 4) * 4       # quantize: stable jit shapes
            K = K_ring * K_phi
            # even batch split: ceil-divide halos over the minimum number
            # of pixel_budget-sized batches (a lone ragged tail batch
            # would waste up to batch*K padded pixels)
            batch = int(np.clip(self.pixel_budget // K, 8, self.halo_batch))
            nb = -(-idx.size // batch)
            batch = max(8, (-(-idx.size // nb) + 7) // 8 * 8)
            sub = [a[idx].astype(np.float64) for a in arrays] \
                + [e[idx] for e in extras]
            batched, valid = self._padded_batches(sub, batch)
            batches = tuple([jnp.asarray(b) for b in batched[:6]]
                            + [jnp.asarray(valid)]
                            + [jnp.asarray(b) for b in batched[6:]])
            prepared.append((K_ring, K_phi, batches))
        return prepared

    # ------------------------------------------------------------------
    # Scatter-free phase A: dense per-tile (pixel, halo) pair math
    # (ops/tiles.py) in place of the per-halo scatter-add. Which engine
    # is faster on the GPU is not yet settled (ROADMAP queue 1, item 3).
    # ------------------------------------------------------------------
    def _tiles_available(self, curve_meta):
        """Tiled deposit needs per-halo curves (p_keys models use the
        scatter path). With a mesh, tiles shard over the chunk axis and
        phase B shards sources + psums (see ops/tiles.make_tile_deposit
        and _phase_b_mesh)."""
        if self.deposit == "scatter":
            return False
        return curve_meta is not None

    def _get_tiling(self, NSIDE, shape=None):
        """(cached) the SkyTiling; ``shape=(ring_block, seg_slots)``
        overrides the default 16x32 tile. The baryonify phases share ONE
        tiling (the stencil phase B consumes phase A's tile-major
        accumulator), but paint has no stencil coupling and may pick a
        finer tile when its discs are small (_paint_tiling)."""
        from ..ops import tiles as _tiles
        tkey = ("tiling", NSIDE, shape)
        if tkey not in self._compiled:
            kw = ({} if shape is None
                  else dict(ring_block=shape[0], seg_slots=shape[1]))
            self._compiled[tkey] = _tiles.SkyTiling(NSIDE, **kw)
        return self._compiled[tkey]

    def _paint_tiling(self, NSIDE, hd):
        """Tiling for the PAINT kernels. The tile kernel's work term is
        (padded (tile, halo) pairs) x (P pixels per tile): paint discs
        (eps_max ~ 5) are small against the default 16x32 tile
        (0.18 x 0.7 deg at NSIDE=4096), so most of each tile's P=512
        pixels are masked waste. A finer tile trades more (tile, halo)
        pairs for far fewer wasted pixel evals; at the north-star
        population (tools/tiling_scan.py) the 8x16 tile cuts the
        pixel-eval work ~3x for eps_max=5 discs. Its time on the GPU is
        not yet measured. ``BFG_PAINT_TILING``: "RBxK" forces a shape,
        "default" keeps the stencil tiling."""
        env = os.environ.get("BFG_PAINT_TILING", "auto")
        if env not in ("auto", "default", ""):
            rb, k = (int(x) for x in env.lower().split("x"))
            return self._get_tiling(NSIDE, (rb, k))
        if env == "auto":
            # median disc diameter under ~1.5 tile heights -> fine tile
            tile_th = 16.0 * np.pi / (4.0 * NSIDE)
            if float(np.median(hd["radius"])) * 2.0 < 1.5 * tile_th:
                return self._get_tiling(NSIDE, (8, 16))
        return self._get_tiling(NSIDE)

    def _get_tile_run(self, tiling, n_r, mode, log_curves=False,
                      n_r2=None):
        """(cached) the tile-deposit kernel factory output. Decoupled
        from the per-(catalog, model) data pack so warmup() can compile
        kernel variants before the curves exist, and so a model swap
        reuses the compiled kernels (shapes are model-independent)."""
        from ..ops import tiles as _tiles
        rkey = ("tilerun", tiling.nside, tiling.RB, tiling.K, n_r, mode,
                log_curves, n_r2, str(self.dtype), self.mesh is None)
        if rkey not in self._compiled:
            self._compiled[rkey] = _tiles.make_tile_deposit(
                tiling, n_r, mode=mode, dtype=self.dtype,
                log_curves=log_curves, mesh=self.mesh, n_r2=n_r2)
        return self._compiled[rkey]

    def _get_flat_gather(self, tiling, ndim):
        """(cached jit) tile-major accumulator -> flat RING order."""
        gkey = ("slotgather", tiling.nside, tiling.RB, tiling.K, ndim)
        if gkey not in self._compiled:
            self._compiled[gkey] = jax.jit(tiling.flat_view)
        return self._compiled[gkey]

    def _get_tile_buckets(self, tiling, hd, small, inv_dlnr=None,
                          lnDa=None, n_c=24, grids=None):
        """(cached) halo->tile binning for the non-``small`` halos.

        The bounding-box pairs from ``bin_halos_to_tiles`` are refined
        by ``ops.tiles.refine_pairs``: tiles provably outside a disc
        are dropped (exact, ~15-25% of pairs). With ``grids`` (a list
        of ``(ln_r0, inv_dlnr, n_r)`` per lookup grid — two for paint2)
        and ``lnDa`` given, each tile is then assigned the narrowest
        static curve-window CLASS its pairs fit
        (``ops.tiles.classify_tile_windows``): rows keep the exact
        per-tile membership and padding of the full sweep, but the
        kernel only sweeps the class's window width — strictly fewer
        ops wherever a class < n_r applies. Class buckets carry the
        static window width(s) as a third element (a tuple for
        paint2's two grids). ``BFG_TILE_WINDOW=0`` disables the class
        path (plain full sweep).

        The LEGACY (tile, radial-bin) far/near windowed split remains
        opt-in via ``BFG_WINDOWED=1``: it fragments each tile's pairs
        over several rows, and the h_align padding on the emptier rows
        eats the sweep win (NSIDE 4096 displace: 2.33 s full vs 3.38 s
        binned-windowed — tools/deposit_bench.py), which is what the
        per-tile class design fixes.

        When ``BFG_CACHE_DIR`` is set the refined buckets also persist
        to an npz keyed by a digest of (nside, positions, radii,
        inv_dlnr, lnDa, grids), so repeat processes (bench rounds,
        parameter sweeps over a fixed catalog) skip the multi-minute
        host binning of ~25M pairs at 1e6 halos (warmup amortization)."""
        import os
        from ..ops import tiles as _tiles
        mode = "plain"
        if (os.environ.get("BFG_WINDOWED", "0") == "1"
                and inv_dlnr is not None and lnDa is not None):
            mode = "binned"
        elif (os.environ.get("BFG_TILE_WINDOW", "1") != "0"
                and grids is not None and lnDa is not None):
            mode = "class"
        if mode != "binned":
            inv_dlnr = None
        if mode == "plain":
            lnDa = None
        radius = hd["radius"]
        invs = (None if inv_dlnr is None
                else tuple(np.atleast_1d(np.asarray(inv_dlnr,
                                                    np.float64))))
        grids_key = (None if mode != "class" else
                     tuple((round(float(g[0]), 9), round(float(g[1]), 9),
                            int(g[2])) for g in grids))
        inv_key = None if invs is None else tuple(np.round(invs, 9))
        # lnDa keyed by CONTENT: two different per-halo lnDa vectors with
        # equal sums (e.g. a non-uniform rscale change in a parameter
        # sweep) must not reuse window-classed buckets built for the
        # other — a mis-classed window silently zeroes far-field
        # contributions rather than erroring
        lnDa_key = None if lnDa is None else hashlib.blake2b(
            np.ascontiguousarray(np.asarray(lnDa, np.float64)).tobytes(),
            digest_size=8).hexdigest()
        bkey = ("tilebin", self._cat_tok, tiling.nside, tiling.RB,
                tiling.K, radius.shape[0], float(radius.sum()), inv_key,
                lnDa_key, n_c, grids_key)
        if bkey in self._compiled:
            return self._compiled[bkey]

        idx_big = np.where(~small)[0]
        cache_dir = os.environ.get("BFG_CACHE_DIR")
        path, buckets = None, None
        if cache_dir:
            dg = hashlib.blake2b(digest_size=16)
            dg.update(np.int64(tiling.nside).tobytes())
            dg.update(repr((tiling.RB, tiling.K, inv_key, lnDa_key, n_c,
                            grids_key)).encode())
            for arr in (hd["theta"][idx_big], hd["phi"][idx_big],
                        radius[idx_big]):
                dg.update(np.ascontiguousarray(arr).tobytes())
            os.makedirs(cache_dir, exist_ok=True)
            path = os.path.join(cache_dir,
                                f"tilebin3_{dg.hexdigest()}.npz")
            if os.path.exists(path):
                f = np.load(path)
                buckets = []
                for i in range(int(f["n_buckets"])):
                    c = tuple(int(v) for v in np.atleast_1d(f[f"c{i}"]))
                    if max(c) <= 0:
                        buckets.append((f[f"t{i}"], f[f"h{i}"]))
                    else:
                        buckets.append((f[f"t{i}"], f[f"h{i}"],
                                        c[0] if len(c) == 1 else c))
        if buckets is None:
            theta_b = hd["theta"][idx_big]
            phi_b = hd["phi"][idx_big]
            rad_b = radius[idx_big]
            t_ids, h_ids = _tiles.bin_halos_to_tiles(
                tiling, theta_b, phi_b, rad_b)
            st = np.sin(theta_b)
            vh = np.stack([st * np.cos(phi_b), st * np.sin(phi_b),
                           np.cos(theta_b)], axis=1)
            chord_rad = 2.0 * np.sin(np.minimum(rad_b, np.pi) / 2.0)
            lnDa_b = None if lnDa is None else np.asarray(
                lnDa, np.float64)[idx_big]
            far, near = _tiles.refine_pairs(
                tiling, t_ids, h_ids, vh, chord_rad,
                inv_dlnr=invs, n_c=n_c, lnDa=lnDa_b)
            buckets = []
            if far[0].size:
                buckets += _tiles.bucket_tiles_binned(
                    (far[0], idx_big[far[1]].astype(np.int64), far[2]),
                    _tiles.window_tags(invs, n_c))
            if mode == "class":
                tk, hk = near
                cls = _tiles.classify_tile_windows(
                    tiling, tk, hk, vh, chord_rad, lnDa_b, grids)
                buckets += _tiles.bucket_tiles_classed(
                    tk, idx_big[hk].astype(np.int64), cls,
                    tuple(float(g[1]) for g in grids))
            else:
                buckets += _tiles.bucket_tiles(
                    near[0], idx_big[near[1]].astype(np.int64))
            if path is not None:
                np.savez(path, n_buckets=len(buckets),
                         **{f"t{i}": b[0] for i, b in enumerate(buckets)},
                         **{f"h{i}": b[1] for i, b in enumerate(buckets)},
                         **{f"c{i}": np.atleast_1d(
                             np.asarray(b[2] if len(b) > 2 else 0))
                            for i, b in enumerate(buckets)})
        for k in [k for k in self._compiled if k[0] == "tilebin"]:
            del self._compiled[k]
        self._compiled[bkey] = buckets
        return self._compiled[bkey]

    def _tile_base_pack(self, hd, extra_lnscale=None):
        """Common per-halo device arrays for the tile kernels.

        Casts run in NUMPY before the upload: an eager on-device
        ``.astype`` is a separate compile and dispatch per shape;
        ``jnp.asarray`` of a host array is a pure device_put."""
        npdt = np.dtype(self.dtype)
        theta, phi, radius = hd["theta"], hd["phi"], hd["radius"]
        st, ct = np.sin(theta), np.cos(theta)
        vh = np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=1)
        sinr2 = 2.0 * np.sin(np.minimum(radius, np.pi) / 2.0)
        lnDa = np.log(hd["D"] / hd["a"])
        if extra_lnscale is not None:
            lnDa = lnDa + np.log(extra_lnscale)
        return dict(vh=jnp.asarray(vh),
                    crit2=jnp.asarray((sinr2 ** 2).astype(npdt)),
                    lnDa=jnp.asarray(lnDa.astype(npdt)),
                    invD=jnp.asarray((1.0 / hd["D"]).astype(npdt)))

    def _tile_flat_gather(self, tiling, npix, acc):
        """(cached jit) tile-major accumulator -> flat RING-pixel order."""
        return self._get_flat_gather(tiling, acc.ndim)(acc)

    def _small_disc_mask(self, hd, NSIDE):
        """Halos whose discs are so small (< ~9 px) that the reference's
        <4-pixel interp-neighbour fallback can trigger
        (HealpixRunner.py:332-334); routed through the scatter path."""
        pixarea = hpx.nside2pixarea(NSIDE)
        return np.pi * hd["radius"] ** 2 < 9.0 * pixarea


class BaryonifyShell(DefaultRunner):
    """Baryonify a lightcone shell (reference HealpixRunner.py:235-373).

    The input map must be a MASS map (zero pixels are empty). The model must
    expose ``displacement(r, M, a, **p_keys)`` as traceable jnp (a built
    Baryonification2D/3D table readout qualifies).
    """

    def _use_curves(self):
        """True when the model supports the fast per-halo-curve readout
        (precompute the (z, M[, p_keys]) interpolation once per halo;
        per-pixel work becomes a direct log-uniform 1D lerp). p_keys
        models qualify too: the per-halo property columns collapse into
        the curves (ops/interp.collapse_curves)."""
        return hasattr(self.model, "halo_curves")

    def _p_key_kwargs(self):
        """Per-halo property columns for the model's p_keys (f64 host)."""
        cat = self.HaloLightConeCatalog.cat
        return {k: np.asarray(cat[k], dtype=float)
                for k in self._model_p_keys()}

    def _halo_curve_arrays(self, hd):
        """Per-halo curve data: (curves, Rcom, rscale) arrays and
        (ln_r0, dlnr) scalars.

        ``curves`` stays a DEVICE array: it is computed on device and
        consumed on device ((n_halos, n_r) is 256 MB at 1e6 halos in f32,
        so a host round trip is not free).
        Scatter-path consumers that need host values slice the (small)
        subset they use first."""
        # jit (cached); the dtype cast happens inside the jit (see
        # _jit_halo_curves)
        curves, ln_r0, dlnr = self._jit_halo_curves(self.model)(
            hd["M"], hd["a"], self._p_key_kwargs())
        Rcom = hd["R"] / hd["a"]
        rscale = (1.0 / Rcom
                  if getattr(self.model, "Rdelta_sampling", False)
                  else np.ones_like(Rcom))
        return (curves, Rcom, rscale,
                float(ln_r0), float(dlnr))

    def _make_body_factory(self, NSIDE, npix, keys, curve_meta=None):
        """Closure factory for the phase-A scan body (per disc-pad size).

        ``curve_meta = (ln_r0, dlnr)`` switches the displacement readout to
        the per-halo-curve path; the batch then carries
        (curve, Rcom, rscale) as trailing per-halo arrays.
        """
        dt = self.dtype
        model = self.model
        if dt == jnp.float32 and hasattr(model, "with_dtype"):
            model = model.with_dtype(dt)   # f32 table readout on device
        eps_max = self.epsilon_max

        def make_body(K_ring, K_phi):
            def one_halo(theta_h, phi_h, rad_h, M_h, a_h, D_h, valid_h,
                         *o_h):
                # per-pixel tangent-angle displacement, accumulated as
                # (d theta, tangent-phi) 2-vectors: one fewer scatter
                # component than unit-vector deltas, and phase B avoids
                # vec2ang. First-order identical to the reference's
                # normalize(vec + o) - vec (offsets are <~1e-3 rad; the
                # difference is second order).
                (pix, cos_t, sin_t, dphi_pix, sinhd,
                 mask) = hpx.disc_candidates(NSIDE, theta_h, phi_h, rad_h,
                                             K_ring, K_phi, dt)
                # fallback: fewer than 4 disc pixels -> 4 interp neighbours
                # (reference HealpixRunner.py:332-334)
                count = jnp.sum(mask)
                pix4, _ = hpx.get_interp_weights(NSIDE, theta_h, phi_h, dt)
                t4, p4 = hpx.pix2ang(NSIDE, pix4, dt)
                use4 = count < 4
                pix = jnp.concatenate([pix, pix4])
                mask = jnp.concatenate([mask & ~use4,
                                        jnp.broadcast_to(use4, (4,))])
                cos_t = jnp.concatenate([cos_t, jnp.cos(t4)])
                sin_t = jnp.concatenate([sin_t, jnp.sin(t4)])
                dphi_pix = jnp.concatenate([dphi_pix, p4 - phi_h]) \
                    .astype(dt)
                ct0 = jnp.cos(theta_h).astype(dt)
                st0 = jnp.sin(theta_h).astype(dt)
                hav4 = (jnp.sin(0.5 * (t4 - theta_h)) ** 2
                        + jnp.sin(t4) * st0
                        * jnp.sin(0.5 * dphi_pix[-4:]) ** 2)
                sinhd = jnp.concatenate(
                    [sinhd, jnp.sqrt(jnp.clip(hav4, 0.0, 1.0))]).astype(dt)

                # chord distance on the unit sphere -> physical separation
                # (chord = 2 sin(d/2); haversine-based, f32-stable at
                # 1-pixel separations)
                chord = 2.0 * sinhd
                r_sep = chord * D_h.astype(dt)

                r_com = r_sep / a_h.astype(dt)
                if curve_meta is not None:
                    from ..Profiles.BaryonCorrection import \
                        BaryonificationClass as _BC
                    curve_h, Rcom_h, rscale_h = o_h[-3:]
                    ln_r0, dlnr = curve_meta
                    r_safe = jnp.where(r_com > 0, r_com, 1e-30)
                    d = _BC.curve_lookup(curve_h.astype(dt), ln_r0, dlnr,
                                         r_safe * rscale_h.astype(dt))
                    d = jnp.where(r_com < eps_max * Rcom_h.astype(dt),
                                  d, 0.0) * a_h.astype(dt)
                else:
                    kw = {k: o for k, o in zip(keys, o_h)}
                    d = model.displacement(r_com, M_h, a_h, **kw) * a_h
                d = jnp.reshape(d, r_sep.shape).astype(dt)
                d = jnp.where(jnp.isfinite(d), d, 0.0)

                # tangent components of o = (d/D) (vec - vec_h)/chord at
                # the pixel:  (vec - vec_h).e_theta = ct0 sin_t
                #                                     - st0 cos_t cos(dphi)
                #             (vec - vec_h).e_phi   = st0 sin(dphi)
                chord_safe = jnp.where(chord > 0, chord, 1.0)
                amp = d / (D_h.astype(dt) * chord_safe)
                t_th = amp * (ct0 * sin_t - st0 * cos_t
                              * jnp.cos(dphi_pix))
                t_ph = amp * (st0 * jnp.sin(dphi_pix))
                delta = jnp.stack([t_th, t_ph], axis=1)
                delta = jnp.where(jnp.isfinite(delta), delta, 0.0)

                m = (mask & valid_h)[:, None]
                delta = jnp.where(m, delta, 0.0)
                pix = jnp.where(mask & valid_h, pix, npix)   # dummy row
                return pix, delta

            def body(acc, batch):
                (theta_b, phi_b, rad_b, M_b, a_b, D_b, valid_b,
                 *extras_b) = batch
                pix, delta = jax.vmap(one_halo)(theta_b, phi_b, rad_b, M_b,
                                                a_b, D_b, valid_b,
                                                *extras_b)
                # the accumulator is FLAT (2*(npix+1),): theta components
                # at [pix], phi components at [npix+1+pix] — two 1-wide
                # scatters instead of one (n, 2) row scatter (a layout
                # choice not yet measured on the GPU).
                pixf = pix.reshape(-1)
                d = delta.reshape(-1, 2)
                idx = jnp.concatenate([pixf, pixf + (npix + 1)])
                upd = jnp.concatenate([d[:, 0], d[:, 1]])
                return acc.at[idx].add(upd), None
            return body

        return make_body

    def _tiled_phase_a(self, hd, extras, curve_meta, NSIDE, npix,
                       return_acc=False):
        from ..ops import tiles as _tiles

        tiling = self._get_tiling(NSIDE)
        curves, Rcom, rscale = extras[-3:]
        ln_r0, dlnr = curve_meta
        small = self._small_disc_mask(hd, NSIDE)
        buckets = self._get_tile_buckets(
            tiling, hd, small, inv_dlnr=1.0 / float(dlnr),
            lnDa=np.log(hd["D"] * np.asarray(rscale) / hd["a"]),
            grids=[(float(ln_r0), 1.0 / float(dlnr),
                    int(curves.shape[1]))])

        run = self._get_tile_run(tiling, int(curves.shape[1]), "displace")
        pkey = ("tilepack", "displace", self._cat_tok, self._model_tok)
        if pkey not in self._compiled:
            pack = self._tile_base_pack(hd, extra_lnscale=rscale)
            # numpy cast before upload; curves are already device-side
            # self.dtype (cast inside the halo_curves jit)
            pack["afac"] = jnp.asarray(
                hd["a"].astype(np.dtype(self.dtype)))
            pack["curves"] = curves
            for k in [k for k in self._compiled if k[0] == "tilepack"]:
                del self._compiled[k]
            self._compiled[pkey] = pack
        pack = self._compiled[pkey]

        P = tiling.RB * tiling.K
        acc = jnp.zeros((tiling.n_tiles, P, 2), dtype=self.dtype)
        run_into = getattr(run, "into", None)
        for bucket in buckets:
            if run_into is not None:
                # single dispatch per bucket: deposit + donated add fused
                acc = run_into(acc, bucket, pack,
                               float(ln_r0), 1.0 / float(dlnr))
                continue
            tids, out = run(bucket, pack, float(ln_r0), 1.0 / float(dlnr))
            # donate acc: at NSIDE=4096 it is a 2.2 GB buffer and an
            # undonated .at[].add doubles it per bucket
            akey = ("tileacc_add", acc.shape, tids.shape, out.shape,
                    str(self.dtype))
            if akey not in self._compiled:
                self._compiled[akey] = jax.jit(
                    lambda a, t, o: a.at[t].add(o.astype(a.dtype)),
                    donate_argnums=0)
            acc = self._compiled[akey](acc, jnp.asarray(tids), out)

        # small halos: old scatter path on just those (if any)
        acc_s = None
        if small.any():
            idx = np.where(small)[0]
            hd_s = {k: v[idx] for k, v in hd.items()}
            ex_s = [e[idx] for e in extras]
            make_body = self._make_body_factory(NSIDE, npix, [], curve_meta)
            acc_s = self._bucketed_accumulate(
                make_body, hd_s, ex_s, (2 * (npix + 1),), self.dtype, NSIDE)

        if return_acc:
            if acc_s is not None:
                # fused flat->(npix,2)->tile-view add, both args donated:
                # no standalone (npix, 2) intermediate survives the call
                # (1.6 GB at NSIDE=4096)
                vkey = ("tileview_po", NSIDE, acc.shape, str(acc.dtype))
                if vkey not in self._compiled:
                    def _add_small(a, s):
                        p = jnp.stack([s[:npix],
                                       s[npix + 1:2 * npix + 1]], axis=1)
                        return a + tiling.tile_view(p)
                    # only a aliases the output; s dies with the call
                    self._compiled[vkey] = jax.jit(_add_small,
                                                   donate_argnums=0)
                acc = self._compiled[vkey](acc, acc_s)
            return acc
        po = self._tile_flat_gather(tiling, npix, acc)
        if acc_s is not None:
            pkey2 = ("posmall_add", NSIDE, str(self.dtype))
            if pkey2 not in self._compiled:
                self._compiled[pkey2] = jax.jit(
                    lambda p, s: p + jnp.stack(
                        [s[:npix], s[npix + 1:2 * npix + 1]], axis=1),
                    donate_argnums=0)
            po = self._compiled[pkey2](po, acc_s)
        return po

    # ------------------------------------------------------------------
    # Stencil phase B (ops/tiles.make_stencil_regrid): the regrid as a
    # gather stencil over tiles; only tiles whose offsets exceed the
    # window (detected on device) or sit in geometrically irregular
    # regions fall back to the scatter deposit.
    # ------------------------------------------------------------------
    def _get_stencil_combo(self, NSIDE, rdt):
        """(cached) the fused hot-tile-detect + stencil jit; also fills
        the ("stencilinfo", NSIDE) host-info entry."""
        from ..ops import tiles as _tiles
        skey = ("stencilrun", NSIDE, str(rdt), self.mesh is None)
        if skey not in self._compiled:
            tiling = self._get_tiling(NSIDE)
            # mesh mode: the stencil's output tile axis shards across
            # devices (tiles are disjoint); po/orig inputs replicate
            run, info = _tiles.make_stencil_regrid(tiling, rdt=rdt,
                                                   mesh=self.mesh)
            tb = tiling.tile_block
            thth = jnp.asarray(info["th_theta"][tb])
            thph = jnp.asarray(info["th_phi"][tb])
            Dg = jnp.asarray(info["D_geom"])

            # hot-tile detection + stencil in ONE dispatch (run traces
            # through)
            def combo(a, og):
                excl = ((jnp.abs(a[:, :, 0]).max(axis=1) > thth)
                        | (jnp.abs(a[:, :, 1]).max(axis=1) > thph) | Dg)
                return run(a, og, excl), excl
            self._compiled[skey] = jax.jit(combo)
            self._compiled[("stencilinfo", NSIDE)] = info
        return self._compiled[skey]

    def _get_origtiled_jit(self, NSIDE, rdt):
        """(cached) jit casting + tiling the original map."""
        okey = ("origtiled", NSIDE, str(rdt))
        if okey not in self._compiled:
            tiling = self._get_tiling(NSIDE)
            self._compiled[okey] = jax.jit(
                lambda m: tiling.tile_view(m.astype(rdt)))
        return self._compiled[okey]

    def _regrid_stencil(self, NSIDE, npix, rdt, acc, orig_dev,
                        host_sum=0.0):
        combo = self._get_stencil_combo(NSIDE, rdt)
        okey_fn = self._get_origtiled_jit(NSIDE, rdt)
        # content-token-guarded like _device_map's 'origmap' key:
        # in-place map mutation between process() calls must not reuse a
        # stale tiled original
        otkey = ("origtiled_val", self._map_tok, str(rdt))
        if otkey not in self._compiled:
            for k in [k for k in self._compiled
                      if k[0] == "origtiled_val"]:
                del self._compiled[k]
            self._compiled[otkey] = okey_fn(orig_dev)
        orig_tiled = self._compiled[otkey]

        out_tiled, excl = combo(acc, orig_tiled)
        return self._stencil_complement(NSIDE, npix, rdt, acc, out_tiled,
                                        orig_tiled, excl)

    def _get_stencil_geo(self, NSIDE):
        """(cached) compact (tile*P + slot) list of the geometric tiles'
        VALID pixel slots, built on device (no big host upload: only the
        ~Tg tile ids cross the link; count is exact host math). Requires
        the ("stencilinfo", NSIDE) entry (_get_stencil_combo)."""
        from ..ops import tiles as _tiles
        tiling = self._get_tiling(NSIDE)
        P = tiling.RB * tiling.K
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        gkey = ("stencil_geo", NSIDE, ndev)
        if gkey not in self._compiled:
            info = self._compiled[("stencilinfo", NSIDE)]
            Dg_np = np.asarray(info["D_geom"])
            g_tids = np.where(Dg_np)[0].astype(np.int32)
            n_valid = _tiles.count_valid_slots(tiling, g_tids)
            n_pad = -(-n_valid // ndev) * ndev
            ti0 = jnp.asarray(tiling.tile_i0, dtype=jnp.int32)
            tss = jnp.asarray(tiling.tile_s, dtype=jnp.int32)
            tSS = jnp.asarray(tiling.tile_S, dtype=jnp.int32)

            def build(gt):
                _, valid = jax.vmap(lambda t: tiling.slot_pix(
                    ti0[t], tss[t], tSS[t]))(gt)
                sf = (gt[:, None] * P
                      + jnp.arange(P, dtype=jnp.int32)[None, :])
                idx, = jnp.nonzero(valid.reshape(-1), size=n_pad,
                                   fill_value=-1)
                return jnp.where(idx >= 0, sf.reshape(-1)[
                    jnp.maximum(idx, 0)], -1)

            self._compiled[gkey] = jax.jit(build)(jnp.asarray(g_tids))
        return self._compiled[gkey]

    def _get_stencil_geo_ang(self, NSIDE, rdt):
        """(cached) static per-source (pix, theta, phi) for the compact
        geometric-tile list: pure functions of the tiling, computed ONCE
        on device, so the f64 ring math (ring_info/ring_theta + divides)
        is not redone inside every call."""
        from ..ops import tiles as _tiles
        tiling = self._get_tiling(NSIDE)
        P = tiling.RB * tiling.K
        K = tiling.K
        N_ = tiling.nside
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        akey = ("stencil_geo_ang", NSIDE, str(rdt), ndev)
        if akey not in self._compiled:
            sf = self._get_stencil_geo(NSIDE)
            ti0 = jnp.asarray(tiling.tile_i0, dtype=jnp.int32)
            tss = jnp.asarray(tiling.tile_s, dtype=jnp.int32)
            tSS = jnp.asarray(tiling.tile_S, dtype=jnp.int32)

            def build(sf):
                # per-element ring math bit-identical to
                # SkyTiling.slot_pixels (see geo_pairs history)
                sfc = jnp.maximum(sf, 0)
                t = sfc // P
                rem = sfc - t * P
                u = rem // K
                v = rem - u * K
                i_c = jnp.clip(ti0[t] + u, 1, 4 * N_ - 1)
                sp, nr, _, sh = hpx.ring_info(N_, i_c, jnp.float64)
                sh_i = sh.astype(jnp.int32)
                S = tSS[t]
                s = tss[t]
                j0 = (2 * s * nr - sh_i * S + 2 * S - 1) // (2 * S)
                j = j0 + v
                jw = jnp.where(j < nr, j, j - nr)
                pix = sp + jw
                theta = hpx.ring_theta(N_, i_c, jnp.float64)
                phi = ((jw.astype(jnp.float64) + 0.5 * sh)
                       * (2.0 * jnp.pi / nr))
                return (pix.astype(jnp.int32), theta.astype(rdt),
                        phi.astype(rdt))

            self._compiled[akey] = jax.jit(build)(sf)
        return self._compiled[akey]

    def _stencil_complement(self, NSIDE, npix, rdt, acc, out_tiled,
                            orig_tiled, excl):
        """Scatter complement of the stencil: geometric tiles via a
        COMPACT static source list (the padded whole-tile form scattered
        27M slots for ~4M real pixels at NSIDE=4096 — 87% padding), hot
        tiles (rare) via the chunked whole-tile path. Fused with
        the tile->ring flat view into one dispatch; mesh mode shards the
        source axis and psums."""
        info = self._compiled[("stencilinfo", NSIDE)]
        Dg_np = np.asarray(info["D_geom"])
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        sf_c = self._get_stencil_geo(NSIDE)
        gpix, gth, gph = self._get_stencil_geo_ang(NSIDE, rdt)

        hot_ids = np.where(np.asarray(excl) & ~Dg_np)[0].astype(np.int32)
        Tc = 512
        nch = ndev
        while nch * Tc < hot_ids.size:
            nch *= 2
        has_hot = hot_ids.size > 0
        tids = np.full(nch * Tc, -1, dtype=np.int32)
        tids[:hot_ids.size] = hot_ids
        finish = self._get_stencil_finish(NSIDE, npix, rdt, has_hot, nch)
        return finish(acc, out_tiled, orig_tiled, sf_c, gpix, gth, gph,
                      jnp.asarray(tids.reshape(nch, Tc)))

    def _get_stencil_finish(self, NSIDE, npix, rdt, has_hot, nch):
        """(cached) the fused complement-scatter + flat-view jit."""
        tiling = self._get_tiling(NSIDE)
        P = tiling.RB * tiling.K
        ckey = ("stencil_compl", NSIDE, str(rdt), has_hot,
                nch if has_hot else 0)
        if ckey not in self._compiled:
            RB, K = tiling.RB, tiling.K
            N_ = tiling.nside
            ti0 = jnp.asarray(tiling.tile_i0, dtype=jnp.int32)
            tss = jnp.asarray(tiling.tile_s, dtype=jnp.int32)
            tSS = jnp.asarray(tiling.tile_S, dtype=jnp.int32)

            def geo_pairs(acc, orig_tiled, sf, gpix, gth, gph):
                """Weights for compact sources. The static per-source
                ring geometry (pix, theta, phi) arrives precomputed
                (_get_stencil_geo_ang) instead of the f64 ring math
                being redone per call."""
                ok = sf >= 0
                sfc = jnp.maximum(sf, 0)
                po = acc.reshape(-1, 2)[sfc]
                og = orig_tiled.reshape(-1)[sfc]
                cpix, cw = BaryonifyShell._weights_for(
                    NSIDE, rdt, gpix, po, gth, gph)
                val = jnp.where(ok, og, 0.0)
                cpix = jnp.where(ok[..., None], cpix, npix)
                return (cpix.reshape(-1),
                        (cw * val[..., None].astype(rdt)).reshape(-1))

            def pairs_for(acc, orig_tiled, tid_chunk):
                def one(tid):
                    ok = tid >= 0
                    t = jnp.maximum(tid, 0)
                    pix, phi, valid, theta_r = tiling.slot_pixels(
                        ti0[t], tss[t], tSS[t])
                    theta_p = jnp.broadcast_to(
                        theta_r[:, None], (RB, K)).astype(rdt)
                    po = acc[t].reshape(RB, K, 2)
                    og = orig_tiled[t].reshape(RB, K)
                    cpix, cw = BaryonifyShell._weights_for(
                        NSIDE, rdt, pix, po, theta_p, phi.astype(rdt))
                    m = valid & ok
                    val = jnp.where(m, og, 0.0)
                    cpix = jnp.where(m[..., None], cpix, npix)
                    return (cpix.reshape(-1),
                            (cw * val[..., None].astype(rdt)).reshape(-1))

                cpix, vals = jax.vmap(one)(tid_chunk)
                return cpix.reshape(-1), vals.reshape(-1)

            def scatter_all(out, acc, orig_tiled, sf, gpix, gth, gph,
                            tids):
                cpix, vals = geo_pairs(acc, orig_tiled, sf, gpix, gth,
                                       gph)
                out = out.at[cpix].add(vals)
                if has_hot:
                    def body(o, tid_chunk):
                        cpix, vals = pairs_for(acc, orig_tiled,
                                               tid_chunk)
                        return o.at[cpix].add(vals), None
                    out, _ = jax.lax.scan(body, out, tids)
                return out

            if self.mesh is None:
                def finish(acc, out_tiled, orig_tiled, sf, gpix, gth,
                           gph, tids):
                    out = jnp.concatenate(
                        [tiling.flat_view(out_tiled),
                         jnp.zeros(1, dtype=rdt)])
                    return scatter_all(out, acc, orig_tiled, sf, gpix,
                                       gth, gph, tids)[:npix]

                self._compiled[ckey] = jax.jit(finish)
            else:
                # mesh: shard the compact-source axis (incl. its static
                # geometry) and the hot-chunk axis; psum partial maps
                # (acc/orig/out_tiled replicate)
                from jax.sharding import PartitionSpec as _PS

                def local(acc, out_tiled, orig_tiled, sf_l, gpix_l,
                          gth_l, gph_l, tids_l):
                    z = jax.lax.pcast(jnp.zeros(npix + 1, dtype=rdt),
                                      ("halos",), to="varying")
                    z = scatter_all(z, acc, orig_tiled, sf_l, gpix_l,
                                    gth_l, gph_l, tids_l)
                    return (jax.lax.psum(z[:npix], "halos")
                            + tiling.flat_view(out_tiled))

                self._compiled[ckey] = jax.jit(jax.shard_map(
                    local, mesh=self.mesh,
                    in_specs=(_PS(), _PS(), _PS(), _PS("halos"),
                              _PS("halos"), _PS("halos"), _PS("halos"),
                              _PS("halos")),
                    out_specs=_PS()))
        return self._compiled[ckey]

    def stencil_stage_times(self, NSIDE, npix, rdt):
        """Warm, blocked per-dispatch timings of the stencil phase B
        (diagnostics; tools/stencil_bench.py). Requires a prior
        process() call (warm caches). Returns a dict of seconds."""
        self._refresh_tokens()
        hkey = next(k for k in self._compiled if k[0] == "hostprep")
        hd, extras, curve_meta = self._compiled[hkey]
        old_sum = float(np.asarray(self.LightconeShell.map,
                                   dtype=np.float64).sum())
        orig_dev = self._device_map(
            np.asarray(self.LightconeShell.map, np.float64), rdt, old_sum)
        out = {}
        for rep in range(2):
            t0 = time.time()
            acc = self._tiled_phase_a(hd, extras, curve_meta, NSIDE, npix,
                                      return_acc=True)
            acc.block_until_ready()
            out["phase_a_s"] = round(time.time() - t0, 3)
        # pieces of _regrid_stencil, timed per dispatch
        combo = self._compiled[("stencilrun", NSIDE, str(rdt),
                                self.mesh is None)]
        otkey = ("origtiled_val", self._map_tok, str(rdt))
        orig_tiled = self._compiled[otkey]
        for rep in range(2):
            t0 = time.time()
            out_tiled, excl = combo(acc, orig_tiled)
            jax.block_until_ready((out_tiled, excl))
            out["combo_s"] = round(time.time() - t0, 3)
        t0 = time.time()
        ids = np.where(np.asarray(excl))[0].astype(np.int32)
        out["excl_fetch_s"] = round(time.time() - t0, 3)
        out["excl_frac"] = round(float(len(ids)) / excl.shape[0], 4)
        for rep in range(2):
            t0 = time.time()
            nd = self._stencil_complement(NSIDE, npix, rdt, acc,
                                          out_tiled, orig_tiled, excl)
            nd.block_until_ready()
            out["finish_s"] = round(time.time() - t0, 3)
        return out

    @staticmethod
    def _phase_b(NSIDE, npix, rdt, ang_base, pix_offsets, orig,
                 chunk_cap=(1 << 24)):
        """Global regrid: one fused pass over the map. In float64 (default)
        the zero-displacement case is an exact identity; float32
        (regrid_dtype option) carries ~1e-4 weight noise — within the 1e-3
        map-parity budget.

        ``ang_base`` (pixel-center (theta, phi), shape (npix, 2)) is an
        ARGUMENT, not recomputed from iota inside the jit: a constant-only
        12M-element chain triggers pathological XLA constant folding at
        compile time.

        Sources are processed in <=2^24-pixel chunks via lax.scan: the
        weight computation materializes ~50 B/source of intermediates,
        which at NSIDE=4096 (201M pixels) would otherwise blow HBM.
        """
        n_chunks = 1
        while npix // n_chunks > chunk_cap or npix % n_chunks:
            n_chunks += 1
        C = npix // n_chunks

        def weights_chunk(start, po, ab):
            return BaryonifyShell._weights_chunk(NSIDE, rdt, start, po, ab)

        # accumulate in rdt: with f32 the summed-map error is ~1e-7
        # relative — far inside the reference's np.isclose conservation
        # tolerance (rtol 1e-5, HealpixRunner.py:370)
        if n_chunks == 1:
            cpix, cw = weights_chunk(0, pix_offsets, ang_base)
            new_map = jnp.zeros(npix, dtype=rdt)
            contrib = cw * orig.astype(rdt)[:, None]          # (npix, 4)
            return new_map.at[cpix.reshape(-1)].add(contrib.reshape(-1))

        def body(acc, i):
            start = i * C
            zero = jnp.zeros((), dtype=start.dtype)
            po = jax.lax.dynamic_slice(pix_offsets, (start, zero), (C, 2))
            ab = jax.lax.dynamic_slice(ang_base, (start, zero), (C, 2))
            og = jax.lax.dynamic_slice(orig, (start,), (C,))
            cpix, cw = weights_chunk(start, po, ab)
            contrib = cw * og.astype(rdt)[:, None]
            return acc.at[cpix.reshape(-1)].add(contrib.reshape(-1)), None

        acc = jnp.zeros(npix, dtype=rdt)
        acc, _ = jax.lax.scan(body, acc,
                              jnp.arange(n_chunks, dtype=jnp.int32))
        return acc

    @staticmethod
    def _phase_b_sparse(NSIDE, npix, rdt, S, ang_base, pix_offsets, orig):
        """Sparse regrid: scatter ONLY the pixels a halo actually displaced.

        The dense regrid scatters 4*npix updates. In a typical shell only
        a ~quarter of pixels sit inside any halo's displacement window:
        compact them with a static-size nonzero (S is a power-of-two bucket
        chosen on host from the moved count), scatter 4*S updates, and pass
        every untouched pixel through as an exact identity. Bitwise-matches
        the dense path up to scatter-order float association (~1e-7)."""
        moved = (pix_offsets[:, 0] != 0) | (pix_offsets[:, 1] != 0)
        idx = jnp.nonzero(moved, size=S, fill_value=npix)[0].astype(jnp.int32)
        valid = idx < npix
        idxc = jnp.minimum(idx, npix - 1)
        theta_p = ang_base[idxc, 0]
        phi_p = ang_base[idxc, 1]
        sin_t = jnp.sin(theta_p)
        sin_safe = jnp.where(sin_t > 1e-12, sin_t, 1.0)
        theta = theta_p + pix_offsets[idxc, 0].astype(rdt)
        phi = phi_p + pix_offsets[idxc, 1].astype(rdt) / sin_safe
        over = (theta < 0) | (theta > jnp.pi)
        theta = jnp.abs(theta)
        theta = jnp.where(theta > jnp.pi, 2 * jnp.pi - theta, theta)
        phi = jnp.where(over, phi + jnp.pi, phi)    # pole pass-through
        cpix, cw = hpx.get_interp_weights(NSIDE, theta, phi, rdt)
        src = orig.astype(rdt)[idxc] * valid.astype(rdt)
        cpix = jnp.where(valid[:, None], cpix, npix)        # guard row
        base = jnp.where(moved, rdt(0.0), orig.astype(rdt))
        base = jnp.concatenate([base, jnp.zeros(1, dtype=rdt)])
        out = base.at[cpix.reshape(-1)].add((cw * src[:, None]).reshape(-1))
        return out[:npix]

    @staticmethod
    def _weights_for(NSIDE, rdt, self_pix, po, theta_p, phi_p):
        """Displaced 4-neighbour (pixels, weights) for arbitrary sources
        identified by their own pixel ids ``self_pix``."""
        sin_t = jnp.sin(theta_p)
        sin_safe = jnp.where(sin_t > 1e-12, sin_t, 1.0)
        theta = theta_p + po[..., 0].astype(rdt)
        phi = phi_p + po[..., 1].astype(rdt) / sin_safe
        # reflect pole overshoots back into [0, pi]; a reflection passes
        # through the pole, so phi flips by pi (the reference's 3D-vector
        # normalize handles this implicitly, HealpixRunner.py:357-365)
        over = (theta < 0) | (theta > jnp.pi)
        theta = jnp.abs(theta)
        theta = jnp.where(theta > jnp.pi, 2 * jnp.pi - theta, theta)
        phi = jnp.where(over, phi + jnp.pi, phi)
        cpix, cw = hpx.get_interp_weights(NSIDE, theta, phi, rdt)
        # untouched pixels (zero offset) map to themselves EXACTLY — an
        # identity even in f32 where recomputed weights carry roundoff
        unmoved = ((po[..., 0] == 0) & (po[..., 1] == 0))[..., None]
        first = jnp.arange(4) == 0
        cpix = jnp.where(unmoved,
                         jnp.where(first, self_pix[..., None], 0), cpix)
        cw = jnp.where(unmoved,
                       jnp.where(first, rdt(1.0), rdt(0.0)), cw)
        return cpix, cw

    @staticmethod
    def _weights_chunk(NSIDE, rdt, start, po, ab):
        """Displaced 4-neighbour (pixels, weights) for one source chunk."""
        self_pix = start + jnp.arange(po.shape[0], dtype=jnp.int32)
        return BaryonifyShell._weights_for(NSIDE, rdt, self_pix, po,
                                           ab[:, 0], ab[:, 1])

    @staticmethod
    def _phase_b_mesh(NSIDE, npix, rdt, mesh, ang_base, pix_offsets, orig,
                      chunk_cap=(1 << 24)):
        """Mesh phase B: shard the source-pixel chunks across devices,
        each device scatters into a local full-size partial map, psum
        across the mesh at the end (the map-reduction pattern of the
        reference's SplitJoinParallel, utils/Parallelize.py:297-320)."""
        from jax.sharding import PartitionSpec as P

        ndev = mesh.devices.size
        n_chunks = ndev
        while npix // n_chunks > chunk_cap or npix % n_chunks:
            n_chunks += ndev
        C = npix // n_chunks
        k = n_chunks // ndev

        def local(po_l, ab_l, og_l):
            # po_l etc are this device's (k*C, ...) slab
            def body(acc, i):
                zero = jnp.zeros((), dtype=jnp.int32)
                po = jax.lax.dynamic_slice(po_l, (i * C, zero), (C, 2))
                ab = jax.lax.dynamic_slice(ab_l, (i * C, zero), (C, 2))
                og = jax.lax.dynamic_slice(og_l, (i * C,), (C,))
                start = (jax.lax.axis_index("halos") * k + i) * C
                cpix, cw = BaryonifyShell._weights_chunk(
                    NSIDE, rdt, start, po, ab)
                contrib = cw * og.astype(rdt)[:, None]
                return acc.at[cpix.reshape(-1)].add(
                    contrib.reshape(-1)), None

            # carry must be axis-varying inside shard_map (it mixes with
            # per-device slabs)
            acc = jax.lax.pcast(jnp.zeros(npix, dtype=rdt), ("halos",),
                                to="varying")
            acc, _ = jax.lax.scan(body, acc,
                                  jnp.arange(k, dtype=jnp.int32))
            return jax.lax.psum(acc, "halos")

        fn = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("halos"), P("halos"), P("halos")),
            out_specs=P()))
        return fn(pix_offsets, ang_base, orig)

    def _regrid(self, NSIDE, npix, rdt, ang_base, pix_offsets, orig_dev):
        """Dispatch dense vs sparse regrid on the moved-pixel count."""
        if self.mesh is not None:
            bkey = ("phase_b_mesh", NSIDE, npix, str(rdt),
                    self.mesh.devices.size)
            if bkey not in self._compiled:
                self._compiled[bkey] = partial(self._phase_b_mesh, NSIDE,
                                               npix, rdt, self.mesh)
            return self._compiled[bkey](ang_base, pix_offsets, orig_dev)
        ckey = ("moved_count", npix)
        if ckey not in self._compiled:
            self._compiled[ckey] = jax.jit(lambda po: (
                (po[:, 0] != 0) | (po[:, 1] != 0)).sum())
        count = int(np.asarray(self._compiled[ckey](pix_offsets)))
        S = 1
        while S < max(count, 1):
            S *= 2
        # sparse only pays at LOW occupancy: the static-size jnp.nonzero
        # compaction is itself a scatter, so the crossover is set near
        # 1/8 of the map moved (not yet measured on the GPU)
        if S * 8 <= npix and npix <= (1 << 25):
            bkey = ("phase_b_sparse", NSIDE, npix, str(rdt), S)
            if bkey not in self._compiled:
                self._compiled[bkey] = jax.jit(
                    partial(self._phase_b_sparse, NSIDE, npix, rdt, S))
        else:
            bkey = ("phase_b", NSIDE, npix, str(rdt))
            if bkey not in self._compiled:
                self._compiled[bkey] = jax.jit(
                    partial(self._phase_b, NSIDE, npix, rdt))
        return self._compiled[bkey](ang_base, pix_offsets, orig_dev)

    def _pixel_angles(self, NSIDE, npix, rdt):
        """Eagerly computed (and cached) pixel-center (theta, phi)."""
        key = ("pixang", NSIDE, str(rdt))
        if key not in self._compiled:
            p = jnp.arange(npix, dtype=jnp.int32)
            theta, phi = hpx.pix2ang(NSIDE, p, rdt)
            self._compiled[key] = jnp.stack([theta, phi], axis=1)
        return self._compiled[key]

    def process(self):
        return self.process_async().result()

    def process_async(self):
        """Dispatch the full baryonification and return a Future resolving
        to the host map. Repeated calls pipeline TWICE over: the compute
        dispatch runs on a dispatch thread (so this returns immediately)
        and call k's result
        download overlaps call k+1's compute (see _submit_fetch /
        _dispatch_executor)."""
        t_start = time.time()
        return self._async_via_dispatch(
            lambda: self._dispatch_process(t_start))

    def _dispatch_process(self, t_start):
        from ..cosmo.core import cosmology_from_dict
        cosmo = cosmology_from_dict(self.cosmo)
        self._refresh_tokens()

        orig_map = np.asarray(self.LightconeShell.map, dtype=np.float64)
        NSIDE = self.LightconeShell.NSIDE
        npix = orig_map.size
        if np.allclose(orig_map, 0):
            return self._done_future(orig_map)

        keys = self._model_p_keys()
        hkey = ("hostprep", self._cat_tok, self._model_tok)
        if hkey in self._compiled:
            hd, extras, curve_meta = self._compiled[hkey]
        else:
            hd = self._host_halo_data(cosmo)
            cat = self.HaloLightConeCatalog.cat
            extras = [np.asarray(cat[k], dtype=float) for k in keys]
            curve_meta = None
            if self._use_curves():
                curves, Rcom, rscale, ln_r0, dlnr = \
                    self._halo_curve_arrays(hd)
                extras = extras + [curves, Rcom, rscale]
                curve_meta = (ln_r0, dlnr)
            for k in [k for k in self._compiled if k[0] == "hostprep"]:
                del self._compiled[k]
            self._compiled[hkey] = (hd, extras, curve_meta)

        use_tiles = self._tiles_available(curve_meta)
        use_stencil = (use_tiles
                       and self.regrid in ("auto", "stencil"))
        rdt = self.regrid_dtype
        if use_stencil:
            old_sum = orig_map.sum()
            orig_dev = self._device_map(orig_map, rdt, old_sum)
            # pass acc ownership: _regrid_stencil frees it before the
            # memory-peak flat view (NSIDE=4096 works in ~2 GB buffers)
            new_dev = self._regrid_stencil(
                NSIDE, npix, rdt,
                self._tiled_phase_a(hd, extras, curve_meta, NSIDE, npix,
                                    return_acc=True),
                orig_dev, host_sum=old_sum)
            return self._submit_fetch(new_dev, t_start, orig_dev,
                                      self._host_map(rdt),
                                      conserve_sum=old_sum)

        if use_tiles:
            pix_offsets = self._tiled_phase_a(hd, extras, curve_meta,
                                              NSIDE, npix)
        else:
            make_body = self._make_body_factory(NSIDE, npix, keys,
                                                curve_meta)
            acc = self._bucketed_accumulate(
                make_body, hd, extras, (2 * (npix + 1),), self.dtype,
                NSIDE)
            pix_offsets = jnp.stack([acc[:npix],
                                     acc[npix + 1:2 * npix + 1]], axis=1)

        rdt = self.regrid_dtype
        ang_base = self._pixel_angles(NSIDE, npix, rdt)
        old_sum = orig_map.sum()
        orig_dev = self._device_map(orig_map, rdt, old_sum)
        # the scatter regrid touches every pixel with bilinear epsilons,
        # so the sparse diff usually degrades to a dense fetch here — the
        # fetcher's threshold fallback handles that
        return self._submit_fetch(
            self._regrid(NSIDE, npix, rdt, ang_base, pix_offsets,
                         orig_dev),
            t_start, orig_dev, self._host_map(rdt),
            conserve_sum=old_sum)

    def warmup(self, max_workers=16):
        """CONCURRENTLY pre-compile every kernel a process() call will
        dispatch, and pre-build the host/device data caches.

        Without it each kernel's first dispatch compiles serially. The
        compiles are independent, so they are issued from a thread pool
        while the host prepares the catalog; whether that shortens the
        cold start on the GPU is not yet measured. Kernels are compiled
        ahead-of-time (``jit.lower().compile()``), which populates the
        persistent compilation cache that the real dispatches then hit.

        Returns {"warmup_s", "n_compiles", "n_failed"}. Safe to skip —
        process() compiles lazily as before — and safe to call twice
        (warm kernels are cache hits). Single-device path only; mesh
        runs warm on first process().
        """
        from concurrent.futures import ThreadPoolExecutor
        from ..cosmo.core import cosmology_from_dict
        from ..ops.transfer import SparseMapFetcher, _split_fn, _N_STREAMS

        t0 = time.time()
        cosmo = cosmology_from_dict(self.cosmo)
        self._refresh_tokens()
        orig_map = np.asarray(self.LightconeShell.map, dtype=np.float64)
        NSIDE = self.LightconeShell.NSIDE
        npix = orig_map.size
        rdt = self.regrid_dtype
        dt = self.dtype
        sds = jax.ShapeDtypeStruct

        report = {"n_compiles": 0, "n_failed": 0}
        pool = ThreadPoolExecutor(max_workers=max_workers,
                                  thread_name_prefix="bfg-warm")
        futs = []
        log = os.environ.get("BFG_WARMUP_LOG", "1") != "0"

        def submit(name, fn):
            def timed():
                import sys as _sys
                t = time.time()
                try:
                    return fn()
                finally:
                    if log:
                        print(f"[bfg-warm] {name}: "
                              f"{time.time() - t:.1f}s "
                              f"(t+{time.time() - t0:.0f}s)",
                              file=_sys.stderr)
            futs.append((name, pool.submit(timed)))

        use_tiles = self._use_curves() and self.deposit != "scatter"
        use_stencil = (use_tiles and self.regrid in ("auto", "stencil")
                       and self.mesh is None)

        # ---- catalog-independent jobs first: these compile while the
        # host prepares halos and tile buckets below
        if use_stencil:
            tiling = self._get_tiling(NSIDE)
            P = tiling.RB * tiling.K
            acc_s = sds((tiling.n_tiles, P, 2), dt)
            og_s = sds((tiling.n_tiles, P), rdt)
            combo = self._get_stencil_combo(NSIDE, rdt)
            submit("stencil_combo",
                   lambda: combo.lower(acc_s, og_s).compile())
            # geo list + its static angles build sequentially in one job
            # (geo_ang depends on geo; a separate job would race it)
            submit("stencil_geo",
                   lambda: self._get_stencil_geo_ang(NSIDE, rdt))
            fin = self._get_stencil_finish(NSIDE, npix, rdt,
                                           has_hot=False, nch=1)
            ng = self._stencil_geo_size(NSIDE)
            sf_s = sds((ng,), jnp.int32)
            gpix_s = sds((ng,), jnp.int32)
            gang_s = sds((ng,), rdt)
            tids_s = sds((1, 512), jnp.int32)
            submit("stencil_finish",
                   lambda: fin.lower(acc_s, og_s, og_s, sf_s, gpix_s,
                                     gang_s, gang_s, tids_s).compile())
            ot = self._get_origtiled_jit(NSIDE, rdt)
            submit("origtiled",
                   lambda: ot.lower(sds((npix,), rdt)).compile())
            submit("acc_zeros",
                   lambda: jnp.zeros((tiling.n_tiles, P, 2),
                                     dt).block_until_ready())
            # sparse-fetch kernels (diff; the changed-block gather is
            # data-sized and compiles on first fetch)
            block = next((b for b in (4096, 768)
                          if npix % b == 0 and npix >= 64 * b), None)
            if self.transfer in ("auto", "sparse") and block:
                fkey = ("sparsefetch", npix, block)
                if fkey not in self._compiled:
                    self._compiled[fkey] = SparseMapFetcher(npix,
                                                            block=block)
                fx = self._compiled[fkey]
                m_s = sds((npix,), rdt)
                submit("fetch_diff",
                       lambda: fx._diff_fn(np.dtype(rdt), False)
                       .lower(m_s, m_s).compile())
            ns = min(_N_STREAMS, max(1, npix // (1 << 20)))
            if ns > 1:
                submit("xfer_split",
                       lambda: _split_fn(npix, np.dtype(rdt), ns)
                       .lower(sds((npix,), rdt)).compile())

        # ---- catalog-dependent prep (the serial prefix) -------------
        hkey = ("hostprep", self._cat_tok, self._model_tok)
        keys = self._model_p_keys()
        cat = self.HaloLightConeCatalog.cat
        curves_fut = None
        if hkey in self._compiled:
            hd, extras, curve_meta = self._compiled[hkey]
        else:
            hd = self._host_halo_data(cosmo)   # 1 serial compile
            pcols = [np.asarray(cat[k], dtype=float) for k in keys]
            if self._use_curves():
                pkw = {k: v for k, v in zip(keys, pcols)}
                jit_curves = self._jit_halo_curves(self.model)
                curves_fut = pool.submit(jit_curves, hd["M"], hd["a"],
                                         pkw)
                futs.append(("halo_curves", curves_fut))

        if use_tiles:
            # curve-grid scalars host-side (ln r axis of the table) so
            # binning + kernel warm jobs need not wait for the curves.
            # MUST match halo_curves bit-for-bit (the table's own f64
            # axis): another value would shift the bucket cache key and
            # could flip a marginal window class
            rr = np.asarray(getattr(self.model, "raw_input_r_range"))
            ln_r0 = float(rr[0])
            dlnr = float(rr[1] - rr[0])
            n_r = int(rr.size)
            Rcom = hd["R"] / hd["a"]
            rscale = (1.0 / Rcom
                      if getattr(self.model, "Rdelta_sampling", False)
                      else np.ones_like(Rcom))
            small = self._small_disc_mask(hd, NSIDE)
            tiling = self._get_tiling(NSIDE)
            buckets = self._get_tile_buckets(
                tiling, hd, small, inv_dlnr=1.0 / dlnr,
                lnDa=np.log(hd["D"] * np.asarray(rscale) / hd["a"]),
                grids=[(ln_r0, 1.0 / dlnr, n_r)])
            run = self._get_tile_run(tiling, n_r, "displace")
            n = hd["M"].shape[0]
            pack_sds = dict(vh=sds((n, 3), jnp.float64),
                            crit2=sds((n,), dt), lnDa=sds((n,), dt),
                            invD=sds((n,), dt), afac=sds((n,), dt),
                            curves=sds((n, n_r), dt))
            P = tiling.RB * tiling.K
            acc_s = sds((tiling.n_tiles, P, 2), dt)
            for i, b in enumerate(buckets):
                submit(f"bucket{i}",
                       run.warm_job(b, pack_sds, ln_r0, 1.0 / dlnr,
                                    acc_s))

        # ---- join + assemble the data caches the first process() uses
        report["n_compiles"] = len(futs)
        for name, f in futs:
            try:
                f.result()
            except Exception as e:              # noqa: BLE001
                report["n_failed"] += 1
                import warnings
                warnings.warn(f"warmup job {name} failed: {e!r}")
        pool.shutdown(wait=True)

        if curves_fut is not None and not curves_fut.exception():
            curves, ln_r0_a, dlnr_a = curves_fut.result()
            extras = pcols + [curves, Rcom, rscale]
            curve_meta = (float(ln_r0_a), float(dlnr_a))
            for k in [k for k in self._compiled if k[0] == "hostprep"]:
                del self._compiled[k]
            self._compiled[hkey] = (hd, extras, curve_meta)

        # upload the shell map now (first process() then skips the
        # 3-6 s/100 MB host->device transfer and the tiling exec)
        if use_stencil:
            old_sum = orig_map.sum()
            orig_dev = self._device_map(orig_map, rdt, old_sum)
            otkey = ("origtiled_val", self._map_tok, str(rdt))
            if otkey not in self._compiled:
                self._compiled[otkey] = self._get_origtiled_jit(
                    NSIDE, rdt)(orig_dev)

        report["warmup_s"] = round(time.time() - t0, 2)
        return report

    def _stencil_geo_size(self, NSIDE):
        """Host-side exact padded length of the compact geometric-tile
        source list (mirrors _get_stencil_geo without device work)."""
        from ..ops import tiles as _tiles
        info = self._compiled[("stencilinfo", NSIDE)]
        g_tids = np.where(np.asarray(info["D_geom"]))[0].astype(np.int32)
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        n_valid = _tiles.count_valid_slots(self._get_tiling(NSIDE),
                                           g_tids)
        return -(-n_valid // ndev) * ndev

    def build_step(self):
        """Return (fn, example_args): the full baryonification step as one
        pure jittable function (single-bucket phase A scan + phase B
        regrid). Used by __graft_entry__ for compile checks and by sharded
        execution paths."""
        from ..cosmo.core import cosmology_from_dict
        cosmo = cosmology_from_dict(self.cosmo)
        orig_map = np.asarray(self.LightconeShell.map, dtype=np.float64)
        NSIDE = self.LightconeShell.NSIDE
        npix = orig_map.size

        hd = self._host_halo_data(cosmo)
        keys = self._model_p_keys()
        cat = self.HaloLightConeCatalog.cat
        extras = [np.asarray(cat[k], dtype=float) for k in keys]

        K_ring, K_phi = hpx.disc_pad_sizes(NSIDE, float(hd["radius"].max()))
        body = self._make_body_factory(NSIDE, npix, keys)(K_ring, K_phi)
        arrays = [hd["theta"], hd["phi"], hd["radius"], hd["M"], hd["a"],
                  hd["D"]]
        batched, valid = self._padded_batches(
            [a.astype(np.float64) for a in arrays] + extras, self.halo_batch)
        batches = tuple([jnp.asarray(b) for b in batched[:6]]
                        + [jnp.asarray(valid)]
                        + [jnp.asarray(b) for b in batched[6:]])
        dt = self.dtype

        ang_base = self._pixel_angles(NSIDE, npix, self.regrid_dtype)

        def fn(batches, ang_base, orig):
            acc = jnp.zeros((2 * (npix + 1),), dtype=dt)
            acc, _ = jax.lax.scan(body, acc, batches)
            po = jnp.stack([acc[:npix], acc[npix + 1:2 * npix + 1]],
                           axis=1)
            return self._phase_b(NSIDE, npix, self.regrid_dtype,
                                 ang_base, po, orig)

        return fn, (batches, ang_base, jnp.asarray(orig_map))


class PaintProfilesShell(DefaultRunner):
    """Paint projected profiles onto a shell
    (reference HealpixRunner.py:376-483). The model's ``projected`` must be
    jnp-traceable (TabulatedProfile / ParamTabulatedProfile qualify)."""

    def process(self):
        return self.process_async().result()

    def process_async(self):
        """Dispatch the paint and return a Future resolving to the host
        map (repeated calls pipeline both the dispatch and the result
        download; see _submit_fetch / _dispatch_executor)."""
        t_start = time.time()
        return self._async_via_dispatch(
            lambda: self._dispatch_process(t_start))

    def _dispatch_process(self, t_start):
        return self._submit_fetch(self._paint_device(), t_start)

    def _paint_device(self):
        """Run the paint and return the DEVICE map (no host download).
        PaintProfilesAnisShell consumes its Mtot canvas this way, with
        no host round trip."""
        from ..cosmo.core import cosmology_from_dict
        cosmo = cosmology_from_dict(self.cosmo)
        self._refresh_tokens(need_map=False)   # paint ignores map values

        NSIDE = self.LightconeShell.NSIDE
        npix = 12 * NSIDE * NSIDE
        pixarea = hpx.nside2pixarea(NSIDE)

        keys = self._model_p_keys()
        dt = self.dtype
        model = self.model
        if dt == jnp.float32 and hasattr(model, "with_dtype"):
            model = model.with_dtype(dt)
        include_pix = self.include_pixel_size
        clog = getattr(model, "curves_are_log", False)

        # hostprep + per-halo curves are (catalog, model)-content
        # constants: cache them like BaryonifyShell._dispatch_process
        # does (no per-call M/a upload, R/D download or curve re-eval).
        hkey = ("hostprep", self._cat_tok, self._model_tok)
        if hkey in self._compiled:
            hd, extras, curve_meta = self._compiled[hkey]
        else:
            hd = self._host_halo_data(cosmo)
            cat = self.HaloLightConeCatalog.cat
            extras = [np.asarray(cat[k], dtype=float) for k in keys]

            # fast path: per-halo profile curves (Tabulated /
            # ParamTabulated — p_keys collapse into the curves,
            # ops/interp.collapse_curves); the constant (z, M[, p...])
            # axes are interpolated once per halo
            curve_meta = None
            if hasattr(model, "halo_curves"):
                # curves stay on device: (n_halos, n_r) is 256 MB at 1e6
                # halos in f32 (see _halo_curve_arrays)
                pkw = {k: e for k, e in zip(keys, extras)}
                curves, ln_r0, dlnr = self._jit_halo_curves(
                    self.model, kind="projected")(hd["M"], hd["a"], pkw)
                extras = extras + [curves]
                curve_meta = (float(ln_r0), float(dlnr))
            for k in [k for k in self._compiled if k[0] == "hostprep"]:
                del self._compiled[k]
            self._compiled[hkey] = (hd, extras, curve_meta)

        if self._tiles_available(curve_meta):
            return self._tiled_paint(hd, extras, curve_meta, NSIDE, npix,
                                     pixarea, log_curves=clog)

        def make_body(K_ring, K_phi):
            def one_halo(theta_h, phi_h, rad_h, M_h, a_h, D_h, valid_h,
                         *o_h):
                (pix, cos_t, sin_t, dphi_pix, sinhd,
                 mask) = hpx.disc_candidates(NSIDE, theta_h, phi_h, rad_h,
                                             K_ring, K_phi, dt)
                chord = 2.0 * sinhd
                r_sep = chord * D_h.astype(dt)
                r_com = r_sep / a_h.astype(dt)

                if curve_meta is not None:
                    from ..utils.Tabulate import TabulatedProfile as _TP
                    from ..Profiles.BaryonCorrection import \
                        BaryonificationClass as _BC
                    curve_h = o_h[-1]
                    ln_r0, dlnr = curve_meta
                    # log curves store log(Sigma * a) (exp inside the
                    # lookup); raw curves store Sigma * a directly —
                    # either way divide the a factor out
                    lookup = _TP.curve_lookup if clog else _BC.curve_lookup
                    paint = lookup(curve_h.astype(dt), ln_r0,
                                   dlnr, r_com) / a_h.astype(dt)
                else:
                    kw = {k: o for k, o in zip(keys, o_h)}
                    paint = model.projected(cosmo, r_com, M_h, a_h, **kw)
                paint = jnp.reshape(paint, r_sep.shape)
                paint = jnp.where(jnp.isfinite(paint), paint, 0.0)
                if include_pix:
                    paint = paint * (pixarea * D_h ** 2).astype(dt)
                paint = jnp.where(mask & valid_h, paint, 0.0)
                pix = jnp.where(mask & valid_h, pix, npix)
                return pix, paint

            def body(acc, batch):
                (theta_b, phi_b, rad_b, M_b, a_b, D_b, valid_b,
                 *extras_b) = batch
                pix, paint = jax.vmap(one_halo)(theta_b, phi_b, rad_b, M_b,
                                                a_b, D_b, valid_b,
                                                *extras_b)
                return acc.at[pix.reshape(-1)].add(
                    paint.reshape(-1).astype(acc.dtype)), None
            return body

        acc_dtype = (jnp.float32 if self.regrid_dtype == jnp.float32
                     else jnp.float64)
        acc = self._bucketed_accumulate(make_body, hd, extras, (npix + 1,),
                                        acc_dtype, NSIDE)
        # painted maps are zero outside halo discs: diff-vs-zero sparse
        # download (base None) happens in _dispatch_process
        return acc[:npix]

    def warmup(self, max_workers=16):
        """Concurrent ahead-of-time compile of the paint kernels — the
        same serial-first-touch fix as BaryonifyShell.warmup (which see
        for rationale). Single-device tiled path only; the scatter/mesh
        paths warm on first process(). Returns {"warmup_s",
        "n_compiles", "n_failed"}."""
        from concurrent.futures import ThreadPoolExecutor
        from ..cosmo.core import cosmology_from_dict
        from ..ops.transfer import SparseMapFetcher, _split_fn, _N_STREAMS

        t0 = time.time()
        report = {"n_compiles": 0, "n_failed": 0, "warmup_s": 0.0}
        model = self.model
        if not (hasattr(model, "halo_curves")
                and self.deposit != "scatter" and self.mesh is None):
            report["warmup_s"] = round(time.time() - t0, 2)
            return report
        cosmo = cosmology_from_dict(self.cosmo)
        self._refresh_tokens(need_map=False)
        NSIDE = self.LightconeShell.NSIDE
        npix = 12 * NSIDE * NSIDE
        dt = self.dtype
        sds = jax.ShapeDtypeStruct
        log_curves = getattr(model, "curves_are_log", False)
        # tiling choice depends on the disc radii (hd): compute the host
        # halo data first so warmup compiles the SAME kernels process()
        # will dispatch
        hd = self._host_halo_data(cosmo)
        tiling = self._paint_tiling(NSIDE, hd)
        P = tiling.RB * tiling.K

        pool = ThreadPoolExecutor(max_workers=max_workers,
                                  thread_name_prefix="bfg-warm")
        futs = []

        def submit(name, fn):
            futs.append((name, pool.submit(fn)))

        # catalog-independent jobs first
        acc_s = sds((tiling.n_tiles, P), dt)
        fg = self._get_flat_gather(tiling, 2)
        submit("flat_gather", lambda: fg.lower(acc_s).compile())
        submit("acc_zeros",
               lambda: jnp.zeros((tiling.n_tiles, P),
                                 dt).block_until_ready())
        block = next((b for b in (4096, 768)
                      if npix % b == 0 and npix >= 64 * b), None)
        if self.transfer in ("auto", "sparse") and block:
            fkey = ("sparsefetch", npix, block)
            if fkey not in self._compiled:
                self._compiled[fkey] = SparseMapFetcher(npix, block=block)
            fx = self._compiled[fkey]
            submit("fetch_diff0",
                   lambda: fx._diff_fn(np.dtype(dt), True)
                   .lower(sds((npix,), dt)).compile())
        ns = min(_N_STREAMS, max(1, npix // (1 << 20)))
        if ns > 1:
            submit("xfer_split",
                   lambda: _split_fn(npix, np.dtype(dt), ns)
                   .lower(sds((npix,), dt)).compile())

        # catalog-dependent prep (serial prefix; hd computed above)
        hkey = ("hostprep", self._cat_tok, self._model_tok)
        keys = self._model_p_keys()
        cat = self.HaloLightConeCatalog.cat
        pkw = {k: np.asarray(cat[k], dtype=float) for k in keys}
        curves_fut = None
        if hkey not in self._compiled:
            # NOTE: must call with self.model (not the with_dtype'd
            # local) to share the jit cache key with _paint_device
            curves_fut = pool.submit(
                self._jit_halo_curves(self.model, kind="projected"),
                hd["M"], hd["a"], pkw)
            futs.append(("halo_curves", curves_fut))
        rr = np.asarray(getattr(model, "raw_input_r_range"))
        ln_r0, dlnr, n_r = float(rr[0]), float(rr[1] - rr[0]), rr.size
        n = hd["M"].shape[0]
        ckey = ("curveclamp", (n, n_r), str(dt), log_curves)
        if ckey not in self._compiled:
            fix = ((lambda c: jnp.maximum(c, -80.0)) if log_curves
                   else (lambda c: jnp.where(jnp.isfinite(c), c, 0.0)))
            self._compiled[ckey] = jax.jit(lambda c: fix(c).astype(dt))
        cl = self._compiled[ckey]
        submit("curveclamp",
               lambda: cl.lower(sds((n, n_r), dt)).compile())
        small = np.zeros(n, dtype=bool)
        buckets = self._get_tile_buckets(
            tiling, hd, small, inv_dlnr=1.0 / dlnr,
            lnDa=np.log(hd["D"] / hd["a"]),
            grids=[(ln_r0, 1.0 / dlnr, int(n_r))])
        run = self._get_tile_run(tiling, int(n_r), "paint",
                                 log_curves=log_curves)
        pack_sds = dict(vh=sds((n, 3), jnp.float64), crit2=sds((n,), dt),
                        lnDa=sds((n,), dt), invD=sds((n,), dt),
                        afac=sds((n,), dt), curves=sds((n, n_r), dt))
        for i, b in enumerate(buckets):
            submit(f"bucket{i}",
                   run.warm_job(b, pack_sds, ln_r0, 1.0 / dlnr, acc_s))

        report["n_compiles"] = len(futs)
        for name, f in futs:
            try:
                f.result()
            except Exception as e:              # noqa: BLE001
                report["n_failed"] += 1
                import warnings
                warnings.warn(f"warmup job {name} failed: {e!r}")
        pool.shutdown(wait=True)

        # pre-fill the (catalog, model) hostprep cache the first
        # process() reads (same pattern as BaryonifyShell.warmup)
        if curves_fut is not None and not curves_fut.exception():
            curves, ln_r0_a, dlnr_a = curves_fut.result()
            extras = [pkw[k] for k in keys] + [curves]
            for k in [k for k in self._compiled if k[0] == "hostprep"]:
                del self._compiled[k]
            self._compiled[hkey] = (hd, extras,
                                    (float(ln_r0_a), float(dlnr_a)))

        report["warmup_s"] = round(time.time() - t0, 2)
        return report

    def _tiled_paint(self, hd, extras, curve_meta, NSIDE, npix, pixarea,
                     log_curves=True):
        """Scatter-free painting: dense per-tile pair sums (ops/tiles.py);
        returns the DEVICE map.

        Unlike the baryonify phase A there is no small-disc fallback in the
        reference paint loop (HealpixRunner.py:376-483), so every halo goes
        through the tiled kernel. ``log_curves`` marks the curve storage
        convention (log for TabulatedProfile, raw for ParamTabulated).
        """
        from ..ops import tiles as _tiles

        tiling = self._paint_tiling(NSIDE, hd)
        curves = extras[-1]
        ln_r0, dlnr = curve_meta
        small = np.zeros(hd["radius"].shape[0], dtype=bool)
        buckets = self._get_tile_buckets(
            tiling, hd, small, inv_dlnr=1.0 / float(dlnr),
            lnDa=np.log(hd["D"] / hd["a"]),
            grids=[(float(ln_r0), 1.0 / float(dlnr),
                    int(curves.shape[1]))])

        run = self._get_tile_run(tiling, int(curves.shape[1]), "paint",
                                 log_curves=log_curves)
        pkey = ("tilepack", "paint", self._cat_tok, self._model_tok,
                bool(self.include_pixel_size), log_curves)
        if pkey not in self._compiled:
            pack = self._tile_base_pack(hd)
            afac = 1.0 / hd["a"]            # curves store Sigma * a
            if self.include_pixel_size:
                afac = afac * pixarea * hd["D"] ** 2
            pack["afac"] = jnp.asarray(afac.astype(np.dtype(self.dtype)))
            # log curves: clamp -inf rows so exp(-80) reads as 0 without
            # NaN risk; raw curves: zero non-finite entries. (jitted:
            # curves live on device, and np.maximum would download them)
            ckey = ("curveclamp", curves.shape, str(self.dtype), log_curves)
            if ckey not in self._compiled:
                fix = ((lambda c: jnp.maximum(c, -80.0)) if log_curves
                       else (lambda c: jnp.where(jnp.isfinite(c), c, 0.0)))
                self._compiled[ckey] = jax.jit(
                    lambda c: fix(c).astype(self.dtype))
            pack["curves"] = self._compiled[ckey](jnp.asarray(curves))
            for k in [k for k in self._compiled if k[0] == "tilepack"]:
                del self._compiled[k]
            self._compiled[pkey] = pack
        pack = self._compiled[pkey]

        P = tiling.RB * tiling.K
        acc = jnp.zeros((tiling.n_tiles, P), dtype=self.dtype)
        run_into = getattr(run, "into", None)
        for bucket in buckets:
            if run_into is not None:
                # one dispatch per bucket (deposit + donated add fused)
                acc = run_into(acc, bucket, pack, float(ln_r0),
                               1.0 / float(dlnr))
                continue
            tids, out = run(bucket, pack, float(ln_r0), 1.0 / float(dlnr))
            acc = acc.at[jnp.asarray(tids)].add(out)
        return self._tile_flat_gather(tiling, npix, acc)


class PaintProfilesAnisShell(DefaultRunner):
    """Anisotropic painting: weight the painted profile by the per-pixel
    tracer mass fraction of an Mtot model plus a uniform background
    (reference HealpixRunner.py:487-640)."""

    def __init__(self, HaloLightConeCatalog, LightconeShell, epsilon_max,
                 model, Tracer_model, Mtot_model, background_val,
                 global_tracer_fraction, mass_def=_massdef.MassDef200c,
                 include_pixel_size=False, use_ellipticity=False,
                 verbose=True, halo_batch=4096, dtype=jnp.float32,
                 **runner_kwargs):
        self.Tracer_model = Tracer_model
        self.Mtot_model = Mtot_model
        self.background_val = background_val
        self.global_tracer_fraction = global_tracer_fraction
        # forward the full runner config (mesh, n_size_buckets,
        # pixel_budget, regrid_dtype, deposit, ...) by keyword so this
        # runner shards/tunes like its siblings
        super().__init__(HaloLightConeCatalog, LightconeShell, epsilon_max,
                         model, use_ellipticity=use_ellipticity,
                         mass_def=mass_def,
                         include_pixel_size=include_pixel_size,
                         verbose=verbose, halo_batch=halo_batch,
                         dtype=dtype, **runner_kwargs)

    def process(self):
        return self.process_async().result()

    def process_async(self):
        """Dispatch the anisotropic paint and return a Future resolving
        to the host map. The Mtot canvas stays ON DEVICE, the
        background mass-fraction term is fused into the final device
        kernel instead of host numpy at npix scale, the result rides the
        sparse fetcher with a compute/transfer timings split, and
        repeated calls pipeline like the sibling runners."""
        t_start = time.time()
        return self._async_via_dispatch(
            lambda: self._dispatch_process(t_start))

    def _mtot_runner(self):
        """(cached) nested total-mass paint runner — kept alive so its
        device caches (curves, packs, buckets) persist across calls."""
        mkey = ("anis_mtot_runner", object_token(self.Mtot_model))
        if mkey not in self._compiled:
            for k in [k for k in self._compiled
                      if k[0] == "anis_mtot_runner"]:
                del self._compiled[k]
            # forwards the full runner config (incl. mesh) so the canvas
            # paint is sharded/tiled exactly like a standalone paint
            self._compiled[mkey] = PaintProfilesShell(
                HaloLightConeCatalog=self.HaloLightConeCatalog,
                LightconeShell=self.LightconeShell,
                epsilon_max=self.epsilon_max, model=self.Mtot_model,
                include_pixel_size=True, mass_def=self.mass_def,
                verbose=self.verbose, halo_batch=self.halo_batch,
                dtype=self.dtype, mesh=self.mesh,
                n_size_buckets=self.n_size_buckets,
                pixel_budget=self.pixel_budget,
                regrid_dtype=self.regrid_dtype, deposit=self.deposit,
                transfer=self.transfer)
        return self._compiled[mkey]

    def _dispatch_process(self, t_start):
        from ..cosmo.core import cosmology_from_dict
        from ..utils.Tabulate import _get_parameter
        import warnings
        cosmo = cosmology_from_dict(self.cosmo)
        self._refresh_tokens()

        NSIDE = self.LightconeShell.NSIDE
        npix = 12 * NSIDE * NSIDE
        pixarea = hpx.nside2pixarea(NSIDE)

        # total-mass canvas, computed AND consumed on device
        mt_runner = self._mtot_runner()
        # re-point at the CURRENT data objects (the user may have swapped
        # them on this runner); content tokens re-derive inside
        mt_runner.HaloLightConeCatalog = self.HaloLightConeCatalog
        mt_runner.LightconeShell = self.LightconeShell
        Mtot_dev = mt_runner._paint_device()

        dL = 2 * _get_parameter(self.Mtot_model, "proj_cutoff")
        a_shell = 1.0 / (1.0 + self.LightconeShell.redshift)
        gkey = ("anis_geom", float(a_shell))
        if gkey not in self._compiled:
            # jit: these background-geometry evaluations chain dozens of
            # eager ops (distance quadrature)
            self._compiled[gkey] = jax.jit(lambda: (
                _core.angular_diameter_distance(cosmo, a_shell)[0],
                _core.rho_x(cosmo, a_shell, species="matter",
                            is_comoving=False)))
        dD, rho_m = (float(v) for v in self._compiled[gkey]())
        dV = pixarea * ((dD + dL) ** 3 - dD ** 3)
        skey = ("mapsum", npix, str(Mtot_dev.dtype))
        if skey not in self._compiled:
            self._compiled[skey] = jax.jit(
                lambda m: jnp.sum(m.astype(jnp.float64)))
        rho_halos = float(self._compiled[skey](Mtot_dev)) / (dV * npix)
        drho_m = float(np.clip(rho_m - rho_halos, 0, None))
        if self.verbose:
            print(f"Inputted halos contribute {100 * rho_halos / rho_m:0.2f}%"
                  " of the total matter density.")
        if rho_halos > rho_m:
            warnings.warn("halos contribute more mass than the mean matter "
                          "density allows; check Mtot_model / cosmology")
        bg_weight = self.background_val * self.global_tracer_fraction

        keys = self._model_p_keys()
        dt = self.dtype
        model, tracer = self.model, self.Tracer_model
        include_pix = self.include_pixel_size

        orig_map = np.asarray(self.LightconeShell.map, dtype=np.float64)
        old_sum = orig_map.sum()
        orig_dev = self._device_map(orig_map, jnp.float64, old_sum)

        # hostprep + per-halo curves are (catalog, models)-content
        # constants — cached like the sibling runners
        clog_p = getattr(model, "curves_are_log", False)
        clog_t = getattr(tracer, "curves_are_log", False)
        hkey = ("hostprep", self._cat_tok, self._model_tok,
                object_token(tracer))
        if hkey in self._compiled:
            hd, extras, pc, tc, curve_meta = self._compiled[hkey]
        else:
            hd = self._host_halo_data(cosmo)
            cat = self.HaloLightConeCatalog.cat
            extras = [np.asarray(cat[k], dtype=float) for k in keys]

            # fast path: per-halo profile curves for BOTH model and
            # tracer (Tabulated / ParamTabulated — p_keys collapse into
            # the curves) — per-pixel work becomes two 1D lerps instead
            # of two N-D table interpolations. The model's p_keys
            # columns flow to both models, matching the reference
            # (HealpixRunner.py:487-640 passes **o_j to Paint and
            # Tracer alike).
            curve_meta = pc = tc = None
            if (hasattr(model, "halo_curves")
                    and hasattr(tracer, "halo_curves")):
                pkw = {k: e for k, e in zip(keys, extras)}
                pc, ln_r0_p, dlnr_p = self._jit_curves_raw(model)(
                    hd["M"], hd["a"], pkw)
                tc, ln_r0_t, dlnr_t = self._jit_curves_raw(tracer)(
                    hd["M"], hd["a"], pkw)
                curve_meta = (float(ln_r0_p), float(dlnr_p),
                              float(ln_r0_t), float(dlnr_t))
            for k in [k for k in self._compiled if k[0] == "hostprep"]:
                del self._compiled[k]
            self._compiled[hkey] = (hd, extras, pc, tc, curve_meta)

        if curve_meta is not None and self._tiles_available(curve_meta):
            # tiled fast path: the halo sum
            # sum_h afac_h * painting_h(r) * canvas_h(r) runs through the
            # paint2 tile kernel (two curve lookups; log pairs share one
            # exp, raw pairs multiply); the per-pixel orig/Mtot weight AND
            # the uniform-background term fuse into one final kernel
            halo_sum = self._tiled_paint2(hd, pc, tc, curve_meta, NSIDE,
                                          npix, pixarea,
                                          log_pair=(clog_p, clog_t))
            fkey = ("anis_factor", NSIDE)
            if fkey not in self._compiled:
                def fin(hs, mt, og, add, bgw):
                    # mt arrives WITHOUT the uniform background; add it
                    # here (the reference's Mtot_map += dV*drho_m,
                    # HealpixRunner.py:573-582) and fold the background
                    # tracer term bgw * (add/mt) * og in the same pass
                    mt2 = mt.astype(jnp.float64) + add
                    good = mt2 > 0
                    base = jnp.where(good,
                                     hs.astype(jnp.float64) * og / mt2,
                                     0.0)
                    bg = jnp.where(good, add / mt2, 0.0) * og
                    return base + bgw * bg
                self._compiled[fkey] = jax.jit(fin)
            new_dev = self._compiled[fkey](halo_sum, Mtot_dev, orig_dev,
                                           dV * drho_m, bg_weight)
            # diff-vs-zero sparse fetch (dense fallback when the map is
            # mostly touched); timings split attached to the future
            return self._submit_fetch(new_dev, t_start)

        # ---- scatter fallback (models without curves) ----------------
        if curve_meta is not None:
            extras = extras + [np.asarray(pc), np.asarray(tc)]
        mt_add_key = ("anis_mt_add", npix)
        if mt_add_key not in self._compiled:
            self._compiled[mt_add_key] = jax.jit(
                lambda m, add: m.astype(jnp.float64) + add)
        Mtot_dev = self._compiled[mt_add_key](Mtot_dev, dV * drho_m)

        def make_body(K_ring, K_phi):
          def one_halo(theta_h, phi_h, rad_h, M_h, a_h, D_h, valid_h, *o_h):
            pix, mask = hpx.disc_pixels(NSIDE, theta_h, phi_h, rad_h,
                                        K_ring, K_phi, dt)
            vec = hpx.pix2vec(NSIDE, pix, dt)
            vec_h = jnp.stack([jnp.sin(theta_h) * jnp.cos(phi_h),
                               jnp.sin(theta_h) * jnp.sin(phi_h),
                               jnp.cos(theta_h)]).astype(dt)
            diff = (vec - vec_h[None, :]) * D_h
            r_sep = jnp.sqrt(jnp.sum(diff ** 2, axis=-1))

            if curve_meta is not None:
                from ..utils.Tabulate import TabulatedProfile as _TP
                from ..Profiles.BaryonCorrection import \
                    BaryonificationClass as _BC
                ln_r0_p, dlnr_p, ln_r0_t, dlnr_t = curve_meta
                r_com = r_sep / a_h.astype(dt)
                # curves store Sigma * a (log or raw per model): divide
                # the a factor out; lookup matches the storage convention
                lk_p = _TP.curve_lookup if clog_p else _BC.curve_lookup
                lk_t = _TP.curve_lookup if clog_t else _BC.curve_lookup
                painting = lk_p(o_h[-2].astype(dt), ln_r0_p,
                                dlnr_p, r_com) \
                    / a_h.astype(dt)
                canvas = lk_t(o_h[-1].astype(dt), ln_r0_t,
                              dlnr_t, r_com) / a_h.astype(dt)
            else:
                kw = {k: o for k, o in zip(keys, o_h)}
                painting = model.projected(cosmo, r_sep / a_h, M_h, a_h,
                                           **kw)
                canvas = tracer.projected(cosmo, r_sep / a_h, M_h, a_h,
                                          **kw)
            painting = jnp.where(jnp.isfinite(painting), painting, 0.0)
            canvas = jnp.where(jnp.isfinite(canvas), canvas, 0.0)
            mtot_px = Mtot_dev[jnp.clip(pix, 0, npix - 1)]
            mfrac = jnp.where(mtot_px > 0, canvas / mtot_px, 0.0)
            mfrac = mfrac * orig_dev[jnp.clip(pix, 0, npix - 1)]
            if include_pix:
                painting = painting * (pixarea * D_h ** 2)
            val = painting * mfrac
            val = jnp.where(mask & valid_h, val, 0.0)
            pix = jnp.where(mask & valid_h, pix, npix)
            return pix, val

          def body(acc, batch):
            (theta_b, phi_b, rad_b, M_b, a_b, D_b, valid_b,
             *extras_b) = batch
            pix, val = jax.vmap(one_halo)(theta_b, phi_b, rad_b, M_b,
                                          a_b, D_b, valid_b, *extras_b)
            return acc.at[pix.reshape(-1)].add(
                val.reshape(-1).astype(jnp.float64)), None
          return body

        # the body closure bakes Mtot_dev/orig_dev as jit constants:
        # their identities join the compile key
        acc = self._bucketed_accumulate(
            make_body, hd, extras, (npix + 1,), jnp.float64, NSIDE,
            extra_key=(self._map_tok, object_token(self.Mtot_model),
                       round(dV * drho_m, 12)))
        # background contribution, fused on device (Mtot_dev already
        # carries the uniform add): bgw * (dV*drho_m / Mtot) * orig
        bgkey = ("anis_bg", npix)
        if bgkey not in self._compiled:
            def add_bg(acc_map, mt, og, add, bgw):
                good = mt > 0
                bg = jnp.where(good, add / mt, 0.0) * og
                return acc_map + bgw * bg
            self._compiled[bgkey] = jax.jit(add_bg)
        new_dev = self._compiled[bgkey](acc[:npix], Mtot_dev, orig_dev,
                                        dV * drho_m, bg_weight)
        return self._submit_fetch(new_dev, t_start)

    def _tiled_paint2(self, hd, pc, tc, curve_meta, NSIDE, npix, pixarea,
                      log_pair=(True, True)):
        """Scatter-free anisotropic halo sum via the paint2 tile kernel:
        sum_h afac_h * painting_h(r) * canvas_h(r) per pixel (log pairs
        share one exp; raw/mixed pairs multiply, any log operand exp'd
        up-front). The caller applies the per-pixel orig/Mtot factor and
        the background term."""
        from ..ops import tiles as _tiles

        ln_r0_p, dlnr_p, ln_r0_t, dlnr_t = curve_meta
        tiling = self._paint_tiling(NSIDE, hd)
        dt = self.dtype
        small = np.zeros(hd["radius"].shape[0], dtype=bool)
        buckets = self._get_tile_buckets(
            tiling, hd, small,
            inv_dlnr=(1.0 / float(dlnr_p), 1.0 / float(dlnr_t)),
            lnDa=np.log(hd["D"] / hd["a"]),
            grids=[(float(ln_r0_p), 1.0 / float(dlnr_p),
                    int(pc.shape[1])),
                   (float(ln_r0_t), 1.0 / float(dlnr_t),
                    int(tc.shape[1]))])
        both_log = log_pair[0] and log_pair[1]

        pkey = ("tilepack", "paint2", self._cat_tok, self._model_tok,
                object_token(self.Tracer_model),
                bool(self.include_pixel_size), log_pair)
        if pkey not in self._compiled:
            pack = self._tile_base_pack(hd)
            # each curve stores Sigma * a -> divide both a factors out
            afac = 1.0 / hd["a"] ** 2
            if self.include_pixel_size:
                afac = afac * pixarea * hd["D"] ** 2
            pack["afac"] = jnp.asarray(afac).astype(dt)
            ckey = ("curveclamp2", pc.shape, tc.shape, str(dt), log_pair)
            if ckey not in self._compiled:
                def fix(c, is_log):
                    if both_log:         # kernel exps the sum
                        return jnp.maximum(c, -80.0)
                    # raw product mode: exp any log operand up front
                    c = jnp.exp(jnp.maximum(c, -80.0)) if is_log else c
                    return jnp.where(jnp.isfinite(c), c, 0.0)
                self._compiled[ckey] = jax.jit(
                    lambda a, b: (fix(a, log_pair[0]).astype(dt),
                                  fix(b, log_pair[1]).astype(dt)))
            pack["curves"], pack["curves2"] = self._compiled[ckey](
                jnp.asarray(pc), jnp.asarray(tc))
            pack["ln_r0_2"] = jnp.asarray(ln_r0_t, dtype=dt)
            pack["inv_dlnr_2"] = jnp.asarray(1.0 / dlnr_t, dtype=dt)
            for k in [k for k in self._compiled if k[0] == "tilepack"]:
                del self._compiled[k]
            self._compiled[pkey] = pack
        pack = self._compiled[pkey]
        run = self._get_tile_run(tiling, int(pc.shape[1]), "paint2",
                                 log_curves=both_log,
                                 n_r2=int(tc.shape[1]))

        P = tiling.RB * tiling.K
        acc = jnp.zeros((tiling.n_tiles, P), dtype=dt)
        run_into = getattr(run, "into", None)
        for bucket in buckets:
            if run_into is not None:
                acc = run_into(acc, bucket, pack, float(ln_r0_p),
                               1.0 / float(dlnr_p))
                continue
            tids, out = run(bucket, pack, float(ln_r0_p),
                            1.0 / float(dlnr_p))
            acc = acc.at[jnp.asarray(tids)].add(out)
        return self._tile_flat_gather(tiling, npix, acc)
