"""Native C++ kernels: CPU reference deposits + cell-list neighbour search.

Compiled on demand with g++ and bound via ctypes — the build image ships no
pybind11. The library is built with ``-march=native``, so its file name
carries a digest of the source and of the host CPU (:func:`host_key`): a
tree copied from another machine rebuilds from ``kernels.cpp`` instead of
loading a library built for a different instruction set. These provide:

  * independent cross-checks of the XLA scatter/deposit kernels
  * a CPU fall-back execution path
  * a periodic cell-list fixed-radius query (KDTree analog) producing the
    padded static-shape neighbour lists BaryonifySnapshot feeds the device
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import warnings

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "kernels.cpp")

_lib = None


def host_key():
    """Digest of what a ``-march=native`` build depends on: the source,
    the machine architecture and the CPU's model and feature flags."""
    dg = hashlib.blake2b(digest_size=8)
    with open(_SRC, "rb") as f:
        dg.update(f.read())
    dg.update(platform.machine().encode())
    try:
        with open("/proc/cpuinfo") as f:
            cpu = [ln for ln in f
                   if ln.startswith(("model name", "flags", "Features"))]
    except OSError:
        cpu = [platform.processor()]
    dg.update("".join(sorted(set(cpu))).encode())
    return dg.hexdigest()


def lib_path():
    """Where this host's build of the library lives."""
    return os.path.join(_HERE, f"_kernels-{host_key()}.so")


def _build(path):
    # build under a private name, then rename: concurrent importers
    # (test workers) never load a half-written library
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, path)


def get_lib():
    """Load (building if needed) the native kernel library, or None."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except Exception as e:          # no g++ / load failure: degrade
        warnings.warn(f"native kernels unavailable ({e}); "
                      "falling back to pure JAX/numpy paths")
        return None

    i64 = ctypes.c_int64
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.regrid_hpix.argtypes = [f64p, f64p, i64p, f64p, i64]
    lib.deposit_2d.argtypes = [f64p, f64p, f64p, i64, i64]
    lib.deposit_3d.argtypes = [f64p, f64p, f64p, i64, i64]
    lib.cell_query.argtypes = [f64p, i64, ctypes.c_double, f64p, f64p,
                               i64, ctypes.c_double, i64p, i64p, i64]
    _lib = lib
    return _lib


def _f64p(x):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i64p(x):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def regrid_hpix_cpu(npix, parent_vals, child_pix, child_weights):
    """CPU 4-neighbour redeposit (reference regrid_pixels_hpix semantics)."""
    lib = get_lib()
    parent_vals = np.ascontiguousarray(parent_vals, dtype=np.float64)
    child_pix = np.ascontiguousarray(child_pix, dtype=np.int64)
    child_weights = np.ascontiguousarray(child_weights, dtype=np.float64)
    hmap = np.zeros(npix, dtype=np.float64)
    if lib is None:
        np.add.at(hmap, child_pix.ravel(),
                  (child_weights * parent_vals[:, None]).ravel())
        return hmap
    lib.regrid_hpix(_f64p(hmap), _f64p(parent_vals), _i64p(child_pix),
                    _f64p(child_weights), len(parent_vals))
    return hmap


def deposit_2d_cpu(N, positions, values):
    lib = get_lib()
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    values = np.ascontiguousarray(values, dtype=np.float64)
    grid = np.zeros((N, N), dtype=np.float64)
    if lib is None:
        from ..ops.scatter import deposit_2d
        import jax.numpy as jnp
        return np.asarray(deposit_2d(jnp.zeros((N, N)),
                                     jnp.asarray(positions),
                                     jnp.asarray(values)))
    lib.deposit_2d(_f64p(grid), _f64p(positions), _f64p(values),
                   len(values), N)
    return grid


def deposit_3d_cpu(N, positions, values):
    lib = get_lib()
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    values = np.ascontiguousarray(values, dtype=np.float64)
    grid = np.zeros((N, N, N), dtype=np.float64)
    if lib is None:
        from ..ops.scatter import deposit_3d
        import jax.numpy as jnp
        return np.asarray(deposit_3d(jnp.zeros((N, N, N)),
                                     jnp.asarray(positions),
                                     jnp.asarray(values)))
    lib.deposit_3d(_f64p(grid), _f64p(positions), _f64p(values),
                   len(values), N)
    return grid


def cell_query_counts(positions, L, centers, radii):
    """Counts-only pass of the periodic fixed-radius neighbour search.

    Lets callers bucket queries by count and re-query each bucket with its
    own pad — a global-max pad would let one dense halo inflate the
    (nq, pad) index array for everyone."""
    lib = get_lib()
    positions = np.ascontiguousarray(np.mod(positions, L), dtype=np.float64)
    centers = np.ascontiguousarray(np.mod(centers, L), dtype=np.float64)
    radii = np.ascontiguousarray(radii, dtype=np.float64)
    nq = len(radii)
    counts = np.zeros(nq, dtype=np.int64)
    if lib is None:
        from scipy.spatial import cKDTree
        tree = cKDTree(positions, boxsize=L)
        lists = tree.query_ball_point(centers, radii)
        return np.array([len(x) for x in lists], dtype=np.int64)
    rmax = float(radii.max()) if nq else 1.0
    lib.cell_query(_f64p(positions), len(positions), L, _f64p(centers),
                   _f64p(radii), nq, rmax, _i64p(counts),
                   ctypes.cast(None, ctypes.POINTER(ctypes.c_int64)), 0)
    return counts


def cell_query(positions, L, centers, radii, pad=None):
    """Periodic fixed-radius neighbour search.

    positions: (n, 3); centers: (nq, 3); radii: (nq,).
    Returns (indices (nq, pad) int64, -1 padded; counts (nq,)).
    When pad is None, it is set to the max count (two-pass).
    """
    lib = get_lib()
    positions = np.ascontiguousarray(np.mod(positions, L), dtype=np.float64)
    centers = np.ascontiguousarray(np.mod(centers, L), dtype=np.float64)
    radii = np.ascontiguousarray(radii, dtype=np.float64)
    nq = len(radii)
    rmax = float(radii.max()) if nq else 1.0
    counts = np.zeros(nq, dtype=np.int64)
    if lib is None:
        from scipy.spatial import cKDTree
        tree = cKDTree(positions, boxsize=L)
        lists = tree.query_ball_point(centers, radii)
        counts = np.array([len(x) for x in lists], dtype=np.int64)
        pad = int(counts.max()) if pad is None else pad
        out = np.full((nq, pad), -1, dtype=np.int64)
        for q, lst in enumerate(lists):
            out[q, :min(len(lst), pad)] = lst[:pad]
        return out, counts

    lib.cell_query(_f64p(positions), len(positions), L, _f64p(centers),
                   _f64p(radii), nq, rmax, _i64p(counts),
                   ctypes.cast(None, ctypes.POINTER(ctypes.c_int64)), 0)
    if pad is None:
        pad = max(int(counts.max()), 1)
    out = np.full((nq, pad), -1, dtype=np.int64)
    lib.cell_query(_f64p(positions), len(positions), L, _f64p(centers),
                   _f64p(radii), nq, rmax, _i64p(counts), _i64p(out), pad)
    return out, counts
