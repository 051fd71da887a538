"""Sparse device->host map fetch.

Downloading a full-sky map (50 MB at NSIDE=1024, 800 MB at NSIDE=4096)
can cost more than the device compute that produced it. Baryonification
only modifies pixels inside halo discs (typically 20-50% of the sky for
realistic catalogs): the stencil regrid
passes untouched tiles through bitwise, so ``new == orig`` exactly on
every unmodified pixel.

``SparseMapFetcher`` exploits that: it compares the result map against
the base map on device per fixed-size pixel block, downloads a tiny
per-block changed bitmap, then downloads only the changed blocks and
reconstructs the exact full map host-side from the (bitwise-identical)
host copy of the base map.  The result is bit-for-bit equal to a full
``np.asarray(new_dev)`` — this is a lossless transfer optimization, not
an approximation.

Fallback: when the changed fraction exceeds ``dense_threshold`` the full
map is fetched directly (the bitmap roundtrip already happened, but it
is ~0.1% of the map).

No analog exists in the reference (maps live host-side throughout;
reference Runners/HealpixRunner.py:235-373 never moves them).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["SparseMapFetcher", "multistream_get"]

# number of parallel download streams (whether more than one pays over
# the GPU's host link is not yet measured)
_N_STREAMS = max(1, int(os.environ.get("BFG_FETCH_STREAMS", "4")))
_SPLIT_JITS = {}
_STREAM_POOL = None


def _stream_pool():
    global _STREAM_POOL
    if _STREAM_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _STREAM_POOL = ThreadPoolExecutor(max_workers=_N_STREAMS,
                                          thread_name_prefix="bfg-xfer")
    return _STREAM_POOL


def _split_fn(n, dt, ns):
    """(cached) jit splitting a flat (n,) array into ns contiguous chunks
    (one dispatch, ns output buffers)."""
    key = (n, str(dt), ns)
    if key not in _SPLIT_JITS:
        C = n // ns

        def split(y):
            y = y.reshape(-1)
            outs = [jax.lax.dynamic_slice(y, (i * C,), (C,))
                    for i in range(ns - 1)]
            outs.append(jax.lax.dynamic_slice(y, ((ns - 1) * C,),
                                              (n - (ns - 1) * C,)))
            return tuple(outs)

        _SPLIT_JITS[key] = jax.jit(split)
    return _SPLIT_JITS[key]


def multistream_get(x, out_dtype=None):
    """``np.asarray(x)`` via parallel slice downloads.

    The device array is split into ``BFG_FETCH_STREAMS`` contiguous
    chunks in ONE dispatch and the chunks are fetched concurrently from
    a thread pool. Bit-exact: pure reshape/concat."""
    n = int(np.prod(x.shape))
    ns = min(_N_STREAMS, max(1, n // (1 << 20)))   # >=4 MB per stream
    if ns <= 1:
        out = np.asarray(x).reshape(-1)
    else:
        chunks = _split_fn(n, x.dtype, ns)(x)
        parts = list(_stream_pool().map(np.asarray, chunks))
        out = np.concatenate(parts)
    out = out.reshape(x.shape)
    return out.astype(out_dtype) if out_dtype is not None else out


def _bucket(n, step=256):
    """Round n up to a multiple of step (bounds jit specializations)."""
    return int(-(-n // step) * step)


class SparseMapFetcher:
    """Fetch a device map to host, transferring only changed blocks.

    Parameters
    ----------
    npix : map length (must be divisible by ``block``)
    block : pixels per block (default 4096 = 16 KB f32)
    dense_threshold : changed-block fraction above which a dense fetch
        is used instead
    """

    def __init__(self, npix, block=4096, dense_threshold=0.8):
        if npix % block:
            raise ValueError(f"npix={npix} not divisible by block={block}")
        self.npix = int(npix)
        self.block = int(block)
        self.nblk = self.npix // self.block
        self.dense_threshold = float(dense_threshold)
        self._jits = {}

    def _diff_fn(self, dt, vs_zero):
        key = ("diff", str(dt), vs_zero)
        if key not in self._jits:
            nblk, B = self.nblk, self.block

            def diff(new, base):
                return (new.reshape(nblk, B)
                        != base.reshape(nblk, B)).any(axis=1)

            def diff0(new):
                return (new.reshape(nblk, B) != 0).any(axis=1)

            self._jits[key] = jax.jit(diff0 if vs_zero else diff)
        return self._jits[key]

    def _gather_fn(self, dt, P):
        key = ("gather", str(dt), P)
        if key not in self._jits:
            nblk, B = self.nblk, self.block

            def gather(new, ids):
                return new.reshape(nblk, B)[ids]

            self._jits[key] = jax.jit(gather)
        return self._jits[key]

    def fetch(self, new_dev, base_dev=None, base_host=None,
              out_dtype=np.float64):
        """Return ``np.asarray(new_dev)`` as ``out_dtype``, cheaply.

        ``base_host`` must be the host array whose upload produced
        ``base_dev`` (bitwise-identical values, same dtype); pass both as
        None to diff against zeros (painting onto an empty map).
        """
        dt = new_dev.dtype
        if base_dev is None:
            changed = np.asarray(self._diff_fn(dt, True)(new_dev))
        else:
            changed = np.asarray(self._diff_fn(dt, False)(new_dev,
                                                          base_dev))
        ids = np.nonzero(changed)[0]
        n_changed = ids.size
        self.last_stats = {"n_changed": int(n_changed),
                           "frac": n_changed / self.nblk,
                           "mbytes": n_changed * self.block
                           * new_dev.dtype.itemsize / 1e6}
        if n_changed > self.dense_threshold * self.nblk:
            return multistream_get(new_dev, out_dtype)

        if base_host is None:
            out = np.zeros(self.npix, dtype=out_dtype)
        else:
            out = np.asarray(base_host, dtype=out_dtype).copy()
        if n_changed:
            P = _bucket(n_changed)
            ids_pad = np.zeros(P, dtype=np.int32)
            ids_pad[:n_changed] = ids
            vals = multistream_get(
                self._gather_fn(dt, P)(new_dev, jnp.asarray(ids_pad)))
            out.reshape(self.nblk, self.block)[ids] = \
                vals[:n_changed].astype(out_dtype)
        return out
