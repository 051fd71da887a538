"""Write PARITY.json — the per-round, machine-readable parity artifact.

BASELINE.json names "map and ΔCl parity vs the CPU reference" as the
primary metric. This tool runs the shared
validation pipelines (baryonforge_tpu/utils/validation.py — the same
code the nightly goldens assert on) and records:

* the Limber-mapped ΔCl ratios vs the digitized S19 Fig. 2 Mc1e14 curve
  (paint → Baryonification2D shell displace → anafast),
* the ΔP(k) residuals vs the Fig. 2 M_c curves (3D box pipeline),
* the max per-pixel relative residual between the tiled (scatter-free)
  and scatter baryonify engines.

Runs everything on the CPU backend (the table builds and the synthetic
boxes are host-scale work).

Usage:  python tools/parity.py [--nside 256] [--skip-deltapk]
                               [--skip-deltacl] [--out PARITY.json]
"""

import argparse
import json
import os
import subprocess
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=256)
    ap.add_argument("--nside512", action="store_true",
                    help="also run the NSIDE=512 Limber section (~25 min)")
    ap.add_argument("--skip-deltacl", action="store_true")
    ap.add_argument("--skip-deltapk", action="store_true")
    ap.add_argument("--skip-engines", action="store_true")
    ap.add_argument("--out", default=os.path.join(_REPO, "PARITY.json"))
    args = ap.parse_args()

    import baryonforge_tpu  # noqa: F401  (enables x64)
    from baryonforge_tpu.utils import validation as V

    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=_REPO, capture_output=True,
                             text=True).stdout.strip()
    except Exception:       # noqa: BLE001
        rev = ""
    out = {"date": time.strftime("%Y-%m-%d"), "git": rev,
           "band": 0.07,
           "note": ("parity pins vs the digitized S19 Fig. 2 curves "
                    "(tests/data/S19_Fig2_Scrapped.csv); pipelines in "
                    "baryonforge_tpu/utils/validation.py, asserted "
                    "nightly by tests/test_deltacl.py and "
                    "tests/test_deltapk_golden.py")}

    def emit():
        with open(args.out, "w") as f:
            f.write(json.dumps(out) + "\n")
        print(f"# wrote {args.out}", file=sys.stderr)

    if not args.skip_deltacl:
        t0 = time.time()
        out["deltacl_limber"] = V.limber_shell_run(nside=args.nside,
                                                   verbose=True)
        out["deltacl_limber"]["seconds"] = round(time.time() - t0, 1)
        emit()

    if args.nside512:
        t0 = time.time()
        sec = V.limber_shell_run(nside=512, verbose=True)
        sec["seconds"] = round(time.time() - t0, 1)
        sec["note"] = ("the k=1.4 residual must shrink vs NSIDE=256 "
                       "(pixel smoothing, not physics) — asserted by "
                       "tests/test_deltacl.py::"
                       "test_deltacl_limber_nside512_tightens")
        out["deltacl_limber_nside512"] = sec
        emit()

    if not args.skip_deltapk:
        t0 = time.time()
        out["deltapk_s19"] = {"rows": V.deltapk_s19_residuals(
            verbose=True)}
        out["deltapk_s19"]["seconds"] = round(time.time() - t0, 1)
        emit()

    if not args.skip_engines:
        t0 = time.time()
        out["tiled_vs_scatter"] = V.tiled_vs_scatter_residual()
        out["tiled_vs_scatter"]["seconds"] = round(time.time() - t0, 1)
        emit()

    emit()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
