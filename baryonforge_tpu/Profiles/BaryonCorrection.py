"""Displacement model: Baryonification2D / Baryonification3D.

Reference: Profiles/BaryonCorrection.py. The table build — the expensive
"init" of the whole pipeline (SURVEY.md §3.2) — is re-designed as
fixed-shape array programs:

  * enclosed-mass curves for all (z, M) at once (batched cumulative Simpson)
  * the reference's data-dependent monotonicity-masking while-loop
    (BaryonCorrection.py:243-304) becomes a fixed-shape masked PCHIP: points
    failing the monotonicity / finiteness / DMO!=DMB conditions are masked
    and the inversion interpolates across them (compress-to-front gather,
    ops/interp.masked_pchip_interp)
  * displacement d(r) = M_DMB^{-1}(M_DMO(r)) - r via two masked PCHIPs
  * broken rows (fewer than 5 usable points) default to d = 0, matching the
    reference's graceful-degradation policy (BaryonCorrection.py:297-304)

The readout is a pure jnp multilinear interpolation (vmap/jit/shard-safe) —
this is what the per-halo hot loop touches.
"""

import warnings
from itertools import product
import numpy as np
import jax
import jax.numpy as jnp

from ..cosmo import massdef as _massdef
from ..ops.integrate import cumulative_simpson_uniform
from ..ops.interp import (masked_pchip_interp, multilinear_interp,
                          collapse_curves as _collapse_curves)
from ..utils.Tabulate import _set_parameter

__all__ = ["BaryonificationClass", "Baryonification3D", "Baryonification2D"]


class BaryonificationClass:
    """Base displacement-function model (reference BaryonCorrection.py:15).

    Parameters mirror the reference: DMO/DMB profiles (cutoffs forced to
    1 Gpc), cosmology, epsilon_max (displacement zeroed beyond
    epsilon_max * R), mass definition, integration knobs.
    """

    def __init__(self, DMO, DMB, cosmo, epsilon_max=20,
                 mass_def=_massdef.MassDef200c,
                 r_min_int=1e-6, r_max_int=1000, N_int=500):
        self.DMO = DMO
        self.DMB = DMB
        self.DMO.set_parameter('cutoff', 1000)
        self.DMB.set_parameter('cutoff', 1000)

        self.cosmo = cosmo
        self.epsilon_max = epsilon_max
        self.mass_def = mass_def
        self.r_min_int = r_min_int
        self.r_max_int = r_max_int
        self.N_int = N_int

    # ------------------------------------------------------------------
    def get_masses(self, model, r, M, a):
        raise NotImplementedError("Implement a get_masses() method first")

    def _enclosed_mass_curve(self, model, r, M, a, projected):
        """Enclosed mass via cumulative Simpson on a padded log grid, with
        the reference's rho>0 masking + log-log PCHIP resampling
        (BaryonCorrection.py:499-578 / 615-694), fully batched over M."""
        r = np.asarray(r, dtype=float)
        r_min = min(float(r.min()), self.r_min_int)
        r_max = max(float(r.max()), self.r_max_int)
        # keep the grid as host numpy: the profile entry points derive
        # their integration grids from concrete r, and this function must
        # remain traceable in `a` (jit over redshift samples)
        r_int_np = np.geomspace(r_min / 1.2, r_max * 1.2, self.N_int)
        r_int = jnp.asarray(r_int_np)
        dlnr = float(np.log(r_int_np[1] / r_int_np[0]))

        M_use = jnp.atleast_1d(jnp.asarray(M, dtype=jnp.result_type(float)))
        if projected:
            dens = model.projected(self.cosmo, r_int_np, M_use, a) * a
            dens = jnp.atleast_2d(dens)
            intgd = 2 * jnp.pi * r_int ** 2 * dens * dlnr
        else:
            dens = model.real(self.cosmo, r_int_np, M_use, a)
            dens = jnp.atleast_2d(dens)
            intgd = 4 * jnp.pi * r_int ** 3 * dens * dlnr
        dens = jnp.where(dens < 0, 0.0, dens)
        intgd = jnp.where(intgd < 0, 0.0, intgd)

        M_enc = cumulative_simpson_uniform(intgd, dx=1.0, axis=-1) \
            + intgd[:, :1]
        lnr_int = jnp.log(r_int)
        lnr_out = jnp.log(jnp.asarray(r))

        valid = (dens > 0) & jnp.isfinite(M_enc) & (M_enc > 0)

        def row(mrow, vrow):
            return jnp.exp(masked_pchip_interp(
                lnr_int, jnp.log(jnp.where(vrow, mrow, 1.0)), vrow, lnr_out,
                min_pts=2))

        return jax.vmap(row)(M_enc, valid)            # (M, r); NaN outside

    # ------------------------------------------------------------------
    def setup_interpolator(self, z_min=1e-2, z_max=5, N_samples_z=30,
                           z_linear_sampling=False,
                           M_min=1e12, M_max=1e16, N_samples_Mass=30,
                           R_min=1e-3, R_max=1e2, N_samples_R=100,
                           Rdelta_min=1e-3, Rdelta_max=10,
                           Rdelta_sampling=False,
                           other_params=None, verbose=True):
        other_params = other_params or {}
        if z_min <= 0:
            assert z_linear_sampling, "need z_linear_sampling for z_min <= 0"

        M_range = np.geomspace(M_min, M_max, N_samples_Mass)
        r = np.geomspace(R_min, R_max, N_samples_R)
        z_range = (np.linspace(z_min, z_max, N_samples_z)
                   if z_linear_sampling
                   else np.geomspace(z_min, z_max, N_samples_z))
        a_range = 1.0 / (1.0 + z_range)
        self.p_keys = list(other_params.keys())
        p_vals = [np.asarray(other_params[k]) for k in self.p_keys]

        if Rdelta_sampling:
            rdelta_range = np.geomspace(Rdelta_min, Rdelta_max, N_samples_R)

        shape = [z_range.size, M_range.size, r.size] \
            + [v.size for v in p_vals]
        d_interp = np.zeros(shape)

        lnr = jnp.log(jnp.asarray(r))

        # param combos outer so each combo's jitted kernel (profile params
        # are trace-time constants) compiles once and sweeps all z fast
        combos = list(product(*[range(v.size) for v in p_vals])) or [()]
        for c in combos:
            for ki, key in enumerate(self.p_keys):
                _set_parameter(self.DMO, key, p_vals[ki][c[ki]])
                _set_parameter(self.DMB, key, p_vals[ki][c[ki]])

            @jax.jit
            def one_z(a_j):
                M_DMO = self._enclosed_mass_curve(
                    self.DMO, r, M_range, a_j, projected=self._projected)
                M_DMB = self._enclosed_mass_curve(
                    self.DMB, r, M_range, a_j, projected=self._projected)
                return _displacement_rows(lnr, M_DMO, M_DMB)

            for j in range(z_range.size):
                offset = np.asarray(one_z(a_range[j]))

                bad = ~np.isfinite(offset).any(axis=-1)
                offset = np.where(np.isfinite(offset), offset, 0.0)
                if bad.any() and verbose:
                    for i in np.where(bad)[0]:
                        warnings.warn(
                            f"Displacement for log10(M) = "
                            f"{np.log10(M_range[i]):.2f} partially failed; "
                            "affected radii default to d = 0.", UserWarning)

                if Rdelta_sampling:
                    for i in range(M_range.size):
                        Rdelta = float(self.mass_def.get_radius(
                            self.cosmo, M_range[i],
                            a_range[j])) / a_range[j]
                        offset[i] = np.interp(rdelta_range, r / Rdelta,
                                              offset[i])

                idx = tuple([j, slice(None), slice(None)] + list(c))
                d_interp[idx] = offset

        input_rad = np.log(r) if not Rdelta_sampling else np.log(rdelta_range)
        self.raw_input_d = d_interp
        self.raw_input_z_range = np.log(1 + z_range)
        self.raw_input_M_range = np.log(M_range)
        self.raw_input_r_range = input_rad
        for k, v in zip(self.p_keys, p_vals):
            setattr(self, f"raw_input_{k}_range", v)

        axes = [jnp.asarray(self.raw_input_z_range),
                jnp.asarray(self.raw_input_M_range),
                jnp.asarray(input_rad)] + [jnp.asarray(v) for v in p_vals]
        self._axes = tuple(axes)
        self._table = jnp.asarray(d_interp)
        self.Rdelta_sampling = Rdelta_sampling
        # new table content -> new identity token (runner cache re-key)
        vars(self).pop("_bfg_token", None)
        return self

    # ------------------------------------------------------------------
    def save_table(self, path):
        """Checkpoint the displacement table to ``path`` (.npz).

        The reference achieves persistence by keeping tables pickleable
        (destory_Pk, BaryonCorrection.py:316-328); here the table is plain
        arrays, saved/restored explicitly (SURVEY.md §5 checkpoint/resume).
        """
        extras = {f"p_{k}": getattr(self, f"raw_input_{k}_range")
                  for k in self.p_keys}
        np.savez(path, d=self.raw_input_d,
                 z_range=self.raw_input_z_range,
                 M_range=self.raw_input_M_range,
                 r_range=self.raw_input_r_range,
                 p_keys=np.array(self.p_keys, dtype=object),
                 Rdelta_sampling=np.array(self.Rdelta_sampling),
                 allow_pickle=True, **extras)

    def load_table(self, path):
        """Restore a table saved with :meth:`save_table`."""
        f = np.load(path, allow_pickle=True)
        self.raw_input_d = f["d"]
        self.raw_input_z_range = f["z_range"]
        self.raw_input_M_range = f["M_range"]
        self.raw_input_r_range = f["r_range"]
        self.p_keys = list(f["p_keys"])
        self.Rdelta_sampling = bool(f["Rdelta_sampling"])
        axes = [jnp.asarray(self.raw_input_z_range),
                jnp.asarray(self.raw_input_M_range),
                jnp.asarray(self.raw_input_r_range)]
        for k in self.p_keys:
            v = f[f"p_{k}"]
            setattr(self, f"raw_input_{k}_range", v)
            axes.append(jnp.asarray(v))
        self._axes = tuple(axes)
        self._table = jnp.asarray(self.raw_input_d)
        # new table content -> new identity token (runner cache re-key)
        vars(self).pop("_bfg_token", None)
        return self

    def with_dtype(self, dtype):
        """Shallow copy with the lookup table cast to ``dtype`` — the
        per-pixel readouts of the scatter path run in f32 (the table
        itself is built in f64)."""
        import copy
        new = copy.copy(self)
        new._axes = tuple(a.astype(dtype) for a in self._axes)
        new._table = self._table.astype(dtype)
        return new

    def _readout(self, r, M, a, **kwargs):
        dt = self._table.dtype
        r_use = jnp.atleast_1d(jnp.asarray(r, dtype=dt))
        M_use = jnp.atleast_1d(jnp.asarray(M, dtype=dt))
        nM, nr = M_use.size, r_use.size

        R = (self.mass_def.get_radius(self.cosmo, M_use, a) / a).astype(dt)
        lnr_in = jnp.log(r_use)[None, :] - (
            jnp.log(R)[:, None] if self.Rdelta_sampling else 0.0)

        cols = [jnp.broadcast_to(jnp.log(1.0 / jnp.asarray(a)).astype(dt),
                                 (nM, nr)).reshape(-1),
                jnp.broadcast_to(jnp.log(M_use)[:, None],
                                 (nM, nr)).reshape(-1),
                jnp.broadcast_to(lnr_in, (nM, nr)).reshape(-1)]
        for k in self.p_keys:
            cols.append(jnp.broadcast_to(
                jnp.asarray(kwargs[k], dtype=dt), (nM, nr)).reshape(-1))
        pts = jnp.stack(cols, axis=1)
        displ = multilinear_interp(self._axes, self._table, pts,
                                   fill_value=jnp.nan)
        displ = displ.reshape(nM, nr)
        displ = jnp.where(jnp.isfinite(displ), displ, 0.0)
        inside = r_use[None, :] < self.epsilon_max * R[:, None]
        displ = jnp.where(inside, displ, 0.0)

        if jnp.ndim(r) == 0:
            displ = jnp.squeeze(displ, axis=-1)
        if jnp.ndim(M) == 0:
            displ = jnp.squeeze(displ, axis=0)
        return displ

    def displacement(self, r, M, a, **kwargs):
        """Displacement d(r, M, a) in comoving Mpc (table readout only)."""
        if not hasattr(self, "_table"):
            raise NameError("No table. Run setup_interpolator() first")
        for k in self.p_keys:
            assert k in kwargs, f"need {k} as input (table built with it)"
        return self._readout(r, M, a, **kwargs)

    # per-halo curves are RAW displacement values (not log); runners pick
    # the matching lookup via this flag
    curves_are_log = False

    def halo_curves(self, M, a, **kwargs):
        """Per-halo displacement curves d_h(ln r) on the table's radial grid.

        Hot-path optimization: (z, M[, extras]) are constant per halo, so
        runners interpolate those axes ONCE here and then do a direct
        log-uniform 1D lookup per pixel (the radial grid is geomspace).
        Models built with ``other_params`` (p_keys) take the per-halo
        property columns as kwargs — the extra axes are scalars per halo,
        so the (z, M, p...) lookup still collapses to one curve per halo
        (reference Tabulate.py:395-730 keeps p_keys first-class in the
        same way).

        Returns (curves (n_halos, n_r), ln_r0, dlnr). Out-of-table rows
        are zero (matching the readout's NaN->0 policy). With
        ``Rdelta_sampling`` the radial coordinate is ln(r/R_Delta).
        """
        return _collapse_curves(self._table, self._axes, 2, M, a,
                                self.p_keys, kwargs, fill=0.0)

    @staticmethod
    def curve_lookup(curve, ln_r0, dlnr, r):
        """1D log-uniform lookup of a per-halo curve at radii ``r``
        (comoving Mpc; or r/R_Delta if the table is Rdelta-sampled).
        Zero outside the tabulated range."""
        n_r = curve.shape[-1]
        x = (jnp.log(jnp.maximum(r, 1e-30)) - ln_r0) / dlnr
        i = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n_r - 2)
        t = x - i
        # one slice-2 gather instead of two element gathers: the
        # bracketing samples are paired once per curve (static slices +
        # stack), not per lookup
        c2 = jnp.stack([curve[..., :-1], curve[..., 1:]], axis=-1)
        pair = c2[i]
        out = pair[..., 0] * (1 - t) + pair[..., 1] * t
        return jnp.where((x < 0) | (x > n_r - 1), 0.0, out)


def _displacement_rows(lnr, M_DMO, M_DMB):
    """d(r) = exp(pchipDMB^-1(pchipDMO(ln r))) - r per mass row, with the
    reference's masking rules (BaryonCorrection.py:243-304) in static shape:

      DMB rows keep points that are finite, strictly increasing (running-max
      test with the 1e-5 threshold) and distinct from DMO (>1e-6 in ln M);
      DMO rows analogous. Rows with <=5 usable points yield NaN (caller
      zeroes them with a warning).
    """
    r = jnp.exp(lnr)

    def row(ln_dmo, ln_dmb):
        fin_b = jnp.isfinite(ln_dmb)
        fin_o = jnp.isfinite(ln_dmo)
        neq = (jnp.abs(ln_dmb - ln_dmo) > 1e-6)

        # strictly-increasing selection via running max over selected pts:
        # a point is kept if it exceeds the running max of kept values by
        # >1e-5 (sequential definition -> associative scan on max)
        def scan_keep(ln_m, base_ok):
            safe = jnp.where(base_ok & jnp.isfinite(ln_m), ln_m, -jnp.inf)
            def f(carry, x):
                keep = x > carry + 1e-5
                new = jnp.where(keep, x, carry)
                return new, keep
            _, keep = jax.lax.scan(f, -jnp.inf, safe)
            return keep & base_ok

        mask_b = scan_keep(ln_dmb, fin_b & (neq | ~fin_o))
        mask_b = mask_b.at[0].set(True)
        mask_o = scan_keep(ln_dmo, fin_o & (neq | ~fin_b))

        # M_DMO(ln r) on the kept DMO points
        ln_MDMO_r = masked_pchip_interp(lnr, jnp.where(fin_o, ln_dmo, 0.0),
                                        mask_o, lnr, min_pts=5)
        # invert DMB: ln r as function of ln M on kept DMB points
        ln_rb = masked_pchip_interp(
            jnp.where(fin_b, ln_dmb, 0.0), lnr, mask_b, ln_MDMO_r, min_pts=5)
        d = jnp.exp(ln_rb) - r
        return jnp.where(jnp.isfinite(d), d, jnp.nan)

    return jax.vmap(row)(jnp.log(M_DMO), jnp.log(M_DMB))


class Baryonification3D(BaryonificationClass):
    """3D displacement: invert 3D enclosed-mass curves
    (reference BaryonCorrection.py:464-578)."""

    _projected = False

    def get_masses(self, model, r, M, a):
        out = self._enclosed_mass_curve(model, r, M, a, projected=False)
        return np.asarray(out)


class Baryonification2D(BaryonificationClass):
    """2D displacement: invert projected enclosed-mass curves
    M(<R) = ∫ 2 pi R Sigma(R) a dlnR (reference BaryonCorrection.py:581-694)."""

    _projected = True

    def get_masses(self, model, r, M, a):
        out = self._enclosed_mass_curve(model, r, M, a, projected=True)
        return np.asarray(out)
