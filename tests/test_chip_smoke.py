"""chip_smoke.py: its refusal to run without a GPU, and its phases at a tiny
size on the CPU (NSIDE=64, 200 halos, small table grids), so the control
flow and the comparisons run here. The full-size run needs a GPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402

SMALL_GRID = dict(bench.TABLE_GRID, N_samples_z=3, N_samples_Mass=6,
                  N_samples_R=32)
NSIDE, N_HALOS = 64, 200


@pytest.fixture(scope="module")
def tables():
    return chip_smoke.phase_tables(SMALL_GRID)


def _emitted(capsys):
    lines = capsys.readouterr().out.splitlines()
    return [json.loads(ln) for ln in lines if ln.strip()]


def test_smoke_refuses_a_cpu_default_device():
    """Without a GPU the script exits non-zero, quickly, and never prints
    the result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "not a GPU" in res.stderr


def test_smoke_phases_at_tiny_size(tables, capsys):
    import jax
    model, tab = tables
    cat, shell = bench.make_inputs(NSIDE, N_HALOS)
    checks = chip_smoke.Checks()
    runner = chip_smoke.phase_baryonify(model, cat, shell, checks)
    times = chip_smoke.phase_engines(runner, n=1)
    chip_smoke.phase_paint(tab, cat, shell, checks)
    chip_smoke.phase_backends(model, tab, jax.devices()[1], checks,
                              nside=NSIDE, n_halos=N_HALOS)
    out = _emitted(capsys)
    names = {o["check"] for o in out if "check" in o}
    assert names == {
        "baryonify_reference_mass", "baryonify_f32_mass",
        "baryonify_f32_pixels", "baryonify_f64_mass",
        "baryonify_f64_pixels", "paint_pixels", "paint_total",
        "backends_baryonify_pixels", "backends_baryonify_total",
        "backends_paint_pixels", "backends_paint_total"}
    assert checks.failed == []
    assert all(v > 0 for v in times.values())
    runs = [o for o in out if "runner" in o]
    assert len(runs) == 5
    assert all(o["cold_s"] > 0 and o["warm_s"] > 0 for o in runs)


def test_smoke_mesh_phase_at_tiny_size(tables, capsys):
    """The four-card phase on four virtual CPU devices."""
    import jax
    model, tab = tables
    cat, shell = bench.make_inputs(NSIDE, N_HALOS)
    checks = chip_smoke.Checks()
    chip_smoke.phase_mesh(model, tab, cat, shell, jax.devices()[:4],
                          checks)
    out = _emitted(capsys)
    assert checks.failed == []
    assert sum("check" in o for o in out) == 6
    assert [o for o in out if o.get("phase") == "mesh"][0][
        "peak_bytes_in_use"] == [None] * 4


def test_checks_record_failures_and_non_finite_values(capsys):
    checks = chip_smoke.Checks()
    assert checks("a", 1e-4, 1e-3)
    assert not checks("b", 2e-3, 1e-3)
    assert not checks("c", float("nan"), 1e-3)
    assert checks.failed == ["b", "c"]
    assert [o["ok"] for o in _emitted(capsys)] == [True, False, False]
    assert chip_smoke.rel_pixels(np.array([1.0, 2.0]),
                                 np.array([1.0, 4.0])) == 0.5


@pytest.mark.gpu
def test_smoke_phases_on_the_gpu(gpu_device, tables, capsys):
    """The one-card phases at NSIDE=256 on the GPU, against the CPU."""
    import jax
    model, tab = tables
    cat, shell = bench.make_inputs(256, 2000)
    checks = chip_smoke.Checks()
    chip_smoke.phase_baryonify(model, cat, shell, checks)
    chip_smoke.phase_paint(tab, cat, shell, checks)
    chip_smoke.phase_backends(model, tab, jax.devices("cpu")[0], checks)
    assert checks.failed == []
