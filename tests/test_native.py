"""Native C++ kernels: build, run, and cross-check against the XLA paths."""

import numpy as np
import jax.numpy as jnp
import pytest

from baryonforge_tpu import native
from baryonforge_tpu.ops.scatter import deposit_2d, deposit_3d

RNG = np.random.default_rng(55)


def test_native_builds():
    lib = native.get_lib()
    assert lib is not None, "g++ build of native kernels failed"


def test_native_rebuilds_for_another_host(tmp_path, monkeypatch):
    """A library built on another host (another key) is never loaded:
    the file name follows the source and the CPU, and a missing name is
    built from kernels.cpp."""
    src = tmp_path / "kernels.cpp"
    src.write_bytes(open(native._SRC, "rb").read())
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_lib", None)
    # a foreign build under the old fixed name and under another host key
    (tmp_path / "_kernels.so").write_bytes(b"not a library")
    (tmp_path / "_kernels-0000000000000000.so").write_bytes(b"foreign")
    key = native.host_key()
    assert key != "0000000000000000"
    assert native.lib_path() == str(tmp_path / f"_kernels-{key}.so")
    assert native.get_lib() is not None
    assert (tmp_path / f"_kernels-{key}.so").stat().st_size > 1000
    # another CPU, or an edited source, gives another name
    monkeypatch.setattr(native.platform, "machine", lambda: "other-arch")
    assert native.host_key() != key
    monkeypatch.undo()
    src.write_text(src.read_text() + "\n// edit\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    assert native.host_key() != key


def test_deposit_2d_native_vs_xla():
    N = 32
    pos = RNG.uniform(-10, 50, (500, 2))
    vals = RNG.uniform(0, 2, 500)
    cpu = native.deposit_2d_cpu(N, pos, vals)
    xla = np.asarray(deposit_2d(jnp.zeros((N, N)), jnp.asarray(pos),
                                jnp.asarray(vals)))
    np.testing.assert_allclose(cpu, xla, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cpu.sum(), vals.sum(), rtol=1e-12)


def test_deposit_3d_native_vs_xla():
    N = 16
    pos = RNG.uniform(-5, 30, (400, 3))
    vals = RNG.uniform(0, 2, 400)
    cpu = native.deposit_3d_cpu(N, pos, vals)
    xla = np.asarray(deposit_3d(jnp.zeros((N, N, N)), jnp.asarray(pos),
                                jnp.asarray(vals)))
    np.testing.assert_allclose(cpu, xla, rtol=1e-12, atol=1e-12)


def test_regrid_hpix_native():
    npix = 100
    vals = RNG.uniform(0, 1, 50)
    cpix = RNG.integers(0, npix, (50, 4))
    w = RNG.dirichlet(np.ones(4), 50)
    out = native.regrid_hpix_cpu(npix, vals, cpix, w)
    ref = np.zeros(npix)
    np.add.at(ref, cpix.ravel(), (w * vals[:, None]).ravel())
    np.testing.assert_allclose(out, ref, rtol=1e-12)
    np.testing.assert_allclose(out.sum(), vals.sum(), rtol=1e-12)


def test_cell_query_vs_kdtree():
    from scipy.spatial import cKDTree
    L = 100.0
    pos = RNG.uniform(0, L, (3000, 3))
    centers = RNG.uniform(0, L, (20, 3))
    radii = RNG.uniform(3, 12, 20)
    out, counts = native.cell_query(pos, L, centers, radii)
    tree = cKDTree(pos, boxsize=L)
    ref = tree.query_ball_point(centers, radii)
    for q in range(20):
        got = np.sort(out[q][out[q] >= 0])
        want = np.sort(ref[q])
        np.testing.assert_array_equal(got, want)
        assert counts[q] == len(want)
