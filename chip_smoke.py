"""Smoke test of the shell runners on the GPU.

Runs the README quickstart at the upstream notebook scale (NSIDE=1024 with
18,512 halos; ``bench.py``'s catalog, seed and table grids) through
``BaryonifyShell(...).process()`` and ``PaintProfilesShell(...).process()``
on the default device, and checks each result in the same process against
the plain reference engines (``deposit="scatter", regrid="scatter"`` with an
f64 regrid):

* baryonify, default engines, f32 regrid: mass <= 1e-6, pixels <= 1e-3
* baryonify, default engines, f64 regrid: mass <= 1e-12, pixels <= 1e-3
* paint, tiled against ``deposit="scatter"`` in f64: pixels <= 1e-3,
  total <= 1e-5
* the same code on the GPU and on the CPU backend (NSIDE=256, 2,000 halos):
  pixels <= 1e-5, totals <= 1e-6 (see ``phase_backends``)

"pixels" is ``max|out - ref| / max|ref|``; "mass" is
``|sum(out) - sum(in)| / sum(in)``. It also times the two table builds, the
cold (first, compiling) and warm calls of every runner, and phase A (tiles
against scatter) and phase B (stencil against scatter).

``--cards 4`` runs only the four-card phase: ``BaryonifyShell`` on a
``parallel.halo_mesh(4)`` (tiles with the stencil regrid, and tiles with
the scatter regrid, which is ``_phase_b_mesh``) and ``PaintProfilesShell``
through ``parallel.SplitJoinParallel``, each against the one-card result of
the same process: pixels <= 1e-5, mass <= 1e-6.

Every line of standard output but the last is one JSON object. The last,
printed only when every check passed, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script exits non-zero, with no such line, when the default device is
not a GPU or any phase fails.

Usage:
    python chip_smoke.py              # one card
    python chip_smoke.py --cards 4    # the mesh phase on four cards
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# per-pixel and total limits of the GPU-against-CPU comparison
BACKEND_PIX_TOL = 1e-5
BACKEND_SUM_TOL = 1e-6
# the four-card mesh against the one-card result (psum reduction order)
MESH_PIX_TOL = 1e-5
MESH_SUM_TOL = 1e-6


def emit(**kw):
    print(json.dumps(kw), flush=True)


class Checks:
    """Prints each number beside its limit and records the failures."""

    def __init__(self):
        self.failed = []

    def __call__(self, name, value, limit):
        value = float(value)
        ok = bool(np.isfinite(value) and value <= limit)
        emit(check=name, value=value, limit=limit, ok=ok)
        if not ok:
            self.failed.append(name)
        return ok


def rel_pixels(out, ref):
    """max|out - ref| / max|ref| (the statistic of
    ``utils.validation.tiled_vs_scatter_residual``)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def rel_sum(total, ref_total):
    return float(abs(float(total) - float(ref_total)) / abs(float(ref_total)))


def peak_bytes(devices):
    """``peak_bytes_in_use`` of each device (None where the backend keeps
    no statistics, as the CPU does)."""
    out = []
    for d in devices:
        st = d.memory_stats()
        out.append(None if st is None else int(st["peak_bytes_in_use"]))
    return out


def require_gpu(n_cards):
    """The default device must be a GPU, with ``n_cards`` of them."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: the default device is "
                 f"{devs[0].platform!r}, not a GPU")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: {n_cards} GPUs wanted, {len(devs)} found")
    return devs[:n_cards]


def card_info():
    """``nvidia-smi``'s name and power limit, one line per card."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]


def run_timed(runner, n_warm=3):
    """(out, cold_s, warm_s): the first ``process()`` (compiles) and the
    median of ``n_warm`` later ones. ``process()`` returns the host map,
    so every time is blocked."""
    t0 = time.perf_counter()
    out = runner.process()
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(n_warm):
        t0 = time.perf_counter()
        out = runner.process()
        warm.append(time.perf_counter() - t0)
    return out, cold, float(np.median(warm))


def blocked_median(fn, n):
    """Median wall time of ``n`` blocked calls of ``fn`` after one warm
    call (which compiles)."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_tables(grid=None):
    """Build the S19 displacement table and the tSZ profile table on the
    default device, timing each."""
    import bench
    t0 = time.perf_counter()
    model = bench.build_displacement_table(grid)
    t_disp = time.perf_counter() - t0
    t0 = time.perf_counter()
    tab = bench.build_tsz_table(grid)
    t_tsz = time.perf_counter() - t0
    emit(phase="tables", displacement_table_s=t_disp, tsz_table_s=t_tsz)
    return model, tab


def _baryonify(cat, shell, model, **kw):
    from baryonforge_tpu import Runners
    return Runners.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                                  halo_batch=4096, n_size_buckets=8,
                                  verbose=False, **kw)


def _paint(cat, shell, tab, **kw):
    from baryonforge_tpu import Runners
    return Runners.PaintProfilesShell(cat, shell, epsilon_max=5, model=tab,
                                      halo_batch=4096, n_size_buckets=8,
                                      verbose=False, **kw)


def phase_baryonify(model, cat, shell, checks):
    """Default engines (f32 and f64 regrid) against the scatter engines
    with an f64 regrid. Returns the f32 runner, warm, for the engine
    timings."""
    import jax.numpy as jnp
    in_sum = float(np.asarray(shell.map, np.float64).sum())

    ref_runner = _baryonify(cat, shell, model, deposit="scatter",
                            regrid="scatter", regrid_dtype=jnp.float64)
    ref, cold, warm = run_timed(ref_runner)
    del ref_runner
    emit(runner="BaryonifyShell", engines="scatter/scatter", regrid="f64",
         cold_s=cold, warm_s=warm)
    checks("baryonify_reference_mass", rel_sum(ref.sum(), in_sum), 1e-12)

    runner32 = _baryonify(cat, shell, model, regrid_dtype=jnp.float32)
    out, cold, warm = run_timed(runner32)
    emit(runner="BaryonifyShell", engines="tiles/stencil", regrid="f32",
         cold_s=cold, warm_s=warm)
    checks("baryonify_f32_mass", rel_sum(out.sum(), in_sum), 1e-6)
    checks("baryonify_f32_pixels", rel_pixels(out, ref), 1e-3)

    runner64 = _baryonify(cat, shell, model)
    out, cold, warm = run_timed(runner64)
    del runner64
    emit(runner="BaryonifyShell", engines="tiles/stencil", regrid="f64",
         cold_s=cold, warm_s=warm)
    checks("baryonify_f64_mass", rel_sum(out.sum(), in_sum), 1e-12)
    checks("baryonify_f64_pixels", rel_pixels(out, ref), 1e-3)
    return runner32


def phase_engines(runner, n=3):
    """Warm, blocked device times of phase A (tiles against scatter) and
    phase B (stencil against scatter) at the runner's shapes and regrid
    dtype. ``runner`` must have run ``process()``."""
    nside = runner.LightconeShell.NSIDE
    npix = 12 * nside * nside
    rdt = runner.regrid_dtype
    hkey = next(k for k in runner._compiled if k[0] == "hostprep")
    hd, extras, curve_meta = runner._compiled[hkey]
    orig = np.asarray(runner.LightconeShell.map, np.float64)
    old_sum = orig.sum()
    orig_dev = runner._device_map(orig, rdt, old_sum)
    ang_base = runner._pixel_angles(nside, npix, rdt)

    def tiles_a():
        return runner._tiled_phase_a(hd, extras, curve_meta, nside, npix,
                                     return_acc=True)

    def scatter_a():
        body = runner._make_body_factory(nside, npix, [], curve_meta)
        return runner._bucketed_accumulate(
            body, hd, extras, (2 * (npix + 1),), runner.dtype, nside)

    acc = tiles_a()
    offsets = runner._tiled_phase_a(hd, extras, curve_meta, nside, npix)
    times = dict(
        phase_a_tiles_s=blocked_median(tiles_a, n),
        phase_a_scatter_s=blocked_median(scatter_a, n),
        phase_b_stencil_s=blocked_median(
            lambda: runner._regrid_stencil(nside, npix, rdt, acc, orig_dev,
                                           host_sum=old_sum), n),
        phase_b_scatter_s=blocked_median(
            lambda: runner._regrid(nside, npix, rdt, ang_base, offsets,
                                   orig_dev), n))
    emit(phase="engines", nside=nside, regrid=np.dtype(rdt).name, **times)
    return times


def phase_paint(tab, cat, shell, checks):
    """Tiled paint (f32) against ``deposit="scatter"`` in f64. The scatter
    engine's f32 form measures its disc distances from absolute angles,
    which leaves it ~1e-3 (pixels) and ~1e-4 (total) off the exact sum:
    too coarse to be the reference."""
    import jax.numpy as jnp
    ref, cold, warm = run_timed(_paint(cat, shell, tab, deposit="scatter",
                                       dtype=jnp.float64))
    emit(runner="PaintProfilesShell", engines="scatter", dtype="f64",
         cold_s=cold, warm_s=warm)
    out, cold, warm = run_timed(_paint(cat, shell, tab))
    emit(runner="PaintProfilesShell", engines="tiles", cold_s=cold,
         warm_s=warm)
    checks("paint_pixels", rel_pixels(out, ref), 1e-3)
    checks("paint_total", rel_sum(out.sum(), ref.sum()), 1e-5)


def phase_backends(model, tab, other_device, checks, nside=256,
                   n_halos=2000):
    """The same runners, same inputs, on the default device and on
    ``other_device`` (the CPU backend on the card's host), each in its
    default configuration (f32 hot path, f64 regrid for baryonify).

    The two sides differ only where the backends round differently: libm
    transcendentals, the order in which atomics and reductions sum, and
    fusion. Each pixel is a sum of at most a few hundred f32 terms, which
    puts honest differences near 1e-6 of the map's maximum; the 1e-5
    limit keeps a 10x margin. A TF32 product (10-bit mantissa, ~1e-3) or
    a lost update lands 100x above it. An f32 regrid is not compared
    here: it derives bilinear weights from absolute angles, so one ulp of
    a position is ~2e-5 of a weight at NSIDE=256, and two correct
    backends differ by that much."""
    import jax
    import jax.numpy as jnp
    import bench
    cat, shell = bench.make_inputs(nside, n_halos)
    outs = {}
    for side, dev in (("default", jax.devices()[0]), ("other", other_device)):
        with jax.default_device(dev):
            b = _baryonify(cat, shell, model)
            runs = {"baryonify": b.process()}
            placed = b._device_map(np.asarray(shell.map, np.float64),
                                   jnp.float64, None)
            runs["paint"] = _paint(cat, shell, tab).process()
        if placed.devices() != {dev}:
            raise RuntimeError(f"the {side} run left its map on "
                               f"{placed.devices()}, not {dev}")
        outs[side] = runs
    for name in ("baryonify", "paint"):
        a, b = outs["default"][name], outs["other"][name]
        checks(f"backends_{name}_pixels", rel_pixels(a, b), BACKEND_PIX_TOL)
        checks(f"backends_{name}_total", rel_sum(a.sum(), b.sum()),
               BACKEND_SUM_TOL)


def phase_mesh(model, tab, cat, shell, devices, checks):
    """Four-card mesh runs against one-card runs of the same process."""
    import jax.numpy as jnp
    from baryonforge_tpu import parallel
    mesh = parallel.halo_mesh(len(devices))
    in_sum = float(np.asarray(shell.map, np.float64).sum())
    for regrid in ("stencil", "scatter"):
        kw = dict(regrid=regrid, regrid_dtype=jnp.float32)
        one = _baryonify(cat, shell, model, **kw).process()
        out, cold, warm = run_timed(_baryonify(cat, shell, model, mesh=mesh,
                                               **kw), n_warm=1)
        emit(runner="BaryonifyShell", engines=f"tiles/{regrid}",
             cards=len(devices), cold_s=cold, warm_s=warm)
        checks(f"mesh_baryonify_{regrid}_pixels", rel_pixels(out, one),
               MESH_PIX_TOL)
        checks(f"mesh_baryonify_{regrid}_mass", rel_sum(out.sum(), in_sum),
               MESH_SUM_TOL)
    one = _paint(cat, shell, tab).process()
    split = parallel.SplitJoinParallel(_paint(cat, shell, tab), mesh=mesh)
    out, cold, warm = run_timed(split, n_warm=1)
    emit(runner="PaintProfilesShell", engines="tiles",
         cards=len(devices), cold_s=cold, warm_s=warm)
    checks("mesh_paint_pixels", rel_pixels(out, one), MESH_PIX_TOL)
    checks("mesh_paint_total", rel_sum(out.sum(), one.sum()), MESH_SUM_TOL)
    peaks = peak_bytes(devices)
    emit(phase="mesh", peak_bytes_in_use=peaks)
    if any(p is not None and p <= 0 for p in peaks):
        checks.failed.append("mesh_device_idle")
        emit(check="mesh_device_idle", peak_bytes_in_use=peaks, ok=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    devices = require_gpu(args.cards)
    import jax
    emit(nvidia_smi=card_info())
    emit(jax=jax.__version__, platform=devices[0].platform,
         device_kind=devices[0].device_kind, count=len(devices))

    import bench
    import baryonforge_tpu  # noqa: F401  (x64, compile cache)
    checks = Checks()
    model, tab = phase_tables()
    emit(phase="tables", peak_bytes_in_use=peak_bytes(devices))
    cat, shell = bench.make_inputs()      # NSIDE=1024, 18,512 halos

    if args.cards > 1:
        phase_mesh(model, tab, cat, shell, devices, checks)
    else:
        runner = phase_baryonify(model, cat, shell, checks)
        emit(phase="baryonify", peak_bytes_in_use=peak_bytes(devices))
        phase_engines(runner)
        del runner
        emit(phase="engines", peak_bytes_in_use=peak_bytes(devices))
        phase_paint(tab, cat, shell, checks)
        emit(phase="paint", peak_bytes_in_use=peak_bytes(devices))
        phase_backends(model, tab, jax.devices("cpu")[0], checks)
        emit(phase="backends", peak_bytes_in_use=peak_bytes(devices))

    if checks.failed:
        emit(failed=checks.failed)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
