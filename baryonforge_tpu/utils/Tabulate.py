"""Recursive parameter plumbing + tabulated profile adapters.

Analog of reference utils/Tabulate.py: ``_set_parameter``/``_get_parameter``
walk nested profile objects; ``TabulatedProfile`` / ``ParamTabulatedProfile``
precompute (z, M, r[, extra]) lookup tables evaluated as multilinear interps
on device; ``TabulatedCorrelation3D`` feeds the TwoHalo ``xi_mm`` hook.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.interp import multilinear_interp

__all__ = ["_set_parameter", "_get_parameter", "TabulatedProfile",
           "ParamTabulatedProfile", "TabulatedCorrelation3D"]


def _walk_profiles(obj, seen=None):
    """Yield obj and every nested Profile-like attribute (recursively)."""
    from ..Profiles.Base import Profile
    if seen is None:
        seen = set()
    if id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    for v in vars(obj).values():
        if isinstance(v, Profile):
            yield from _walk_profiles(v, seen)


def _set_parameter(obj, key, value):
    """Set ``key`` on obj and every nested profile that defines it
    (reference Tabulate.py:11-64)."""
    found = False
    for o in _walk_profiles(obj):
        if key in vars(o):
            setattr(o, key, value)
            found = True
    return found


def _get_parameter(obj, key):
    """Read ``key`` from obj or the first nested profile that has it."""
    for o in _walk_profiles(obj):
        if key in vars(o):
            return getattr(o, key)
    raise AttributeError(f"parameter {key} not found on {obj}")


class TabulatedProfile:
    """Precompute real & projected profiles on a (log1p z, logM, logr) grid.

    Mirrors reference Tabulate.py:99-392: stores log-space tables and reads
    out via multilinear interpolation (device-side, vmap/jit-safe).
    ``projected`` tables store Sigma * a (comoving projection factor),
    matching the reference.
    """

    def __init__(self, model, cosmo, mass_def=None):
        self.model = model
        self.cosmo = cosmo
        self.mass_def = mass_def if mass_def is not None else model.mass_def
        self.p_keys = []

    def setup_interpolator(self, z_min=1e-2, z_max=5, N_samples_z=30,
                           M_min=1e12, M_max=1e16, N_samples_Mass=30,
                           R_min=1e-3, R_max=1e2, N_samples_R=100,
                           z_linear_sampling=False, verbose=True,
                           other_params=None):
        assert other_params is None or len(other_params) == 0, \
            "use ParamTabulatedProfile for extra parameter axes"
        M_range = np.geomspace(M_min, M_max, N_samples_Mass)
        r = np.geomspace(R_min, R_max, N_samples_R)
        z_range = (np.linspace(z_min, z_max, N_samples_z) if z_linear_sampling
                   else np.geomspace(z_min, z_max, N_samples_z))

        interp3D = np.zeros([z_range.size, M_range.size, r.size])
        interp2D = np.zeros_like(interp3D)

        # one compiled kernel swept over z: op-by-op dispatch of the
        # profile math costs more than the math itself on an accelerator
        @jax.jit
        def one_z(a_j):
            return (self.model.real(self.cosmo, r, M_range, a_j),
                    self.model.projected(self.cosmo, r, M_range, a_j) * a_j)

        for j, z in enumerate(z_range):
            real, proj = one_z(1.0 / (1.0 + z))
            interp3D[j] = np.asarray(real)
            interp2D[j] = np.asarray(proj)

        self.raw_input_3D = np.log(interp3D)
        self.raw_input_2D = np.log(interp2D)
        self.raw_input_z_range = np.log(1 + z_range)
        self.raw_input_M_range = np.log(M_range)
        self.raw_input_r_range = np.log(r)
        self._axes = (jnp.asarray(self.raw_input_z_range),
                      jnp.asarray(self.raw_input_M_range),
                      jnp.asarray(self.raw_input_r_range))
        self._tab3D = jnp.asarray(self.raw_input_3D)
        self._tab2D = jnp.asarray(self.raw_input_2D)
        # new table content -> new identity token (runner cache re-key)
        vars(self).pop("_bfg_token", None)
        return self

    def _readout(self, table, r, M, a):
        r_use = jnp.atleast_1d(jnp.asarray(r, dtype=jnp.result_type(float)))
        M_use = jnp.atleast_1d(jnp.asarray(M, dtype=jnp.result_type(float)))
        z_in = jnp.log(1.0 / jnp.asarray(a))
        lnr = jnp.log(r_use)
        lnM = jnp.log(M_use)
        pts = jnp.stack([
            jnp.broadcast_to(z_in, (M_use.size, r_use.size)).reshape(-1),
            jnp.broadcast_to(lnM[:, None], (M_use.size, r_use.size)).reshape(-1),
            jnp.broadcast_to(lnr[None, :], (M_use.size, r_use.size)).reshape(-1),
        ], axis=1)
        out = jnp.exp(multilinear_interp(self._axes, table, pts))
        out = out.reshape(M_use.size, r_use.size)
        if jnp.ndim(r) == 0:
            out = jnp.squeeze(out, axis=-1)
        if jnp.ndim(M) == 0:
            out = jnp.squeeze(out, axis=0)
        return out

    def real(self, cosmo, r, M, a, **kwargs):
        return self._readout(self._tab3D, r, M, a)

    def projected(self, cosmo, r, M, a, **kwargs):
        # table stored Sigma * a; divide the factor back out
        return self._readout(self._tab2D, r, M, a) / a

    def with_dtype(self, dtype):
        """Shallow copy with tables cast to ``dtype`` (f32 hot path)."""
        import copy
        new = copy.copy(self)
        new._axes = tuple(ax.astype(dtype) for ax in self._axes)
        new._tab3D = self._tab3D.astype(dtype)
        new._tab2D = self._tab2D.astype(dtype)
        return new

    def save_table(self, path):
        """Checkpoint the profile tables to ``path`` (.npz); the reference
        relies on pickling instead (destory_Pk, Tabulate.py:276)."""
        np.savez(path, tab3D=self.raw_input_3D, tab2D=self.raw_input_2D,
                 z_range=self.raw_input_z_range,
                 M_range=self.raw_input_M_range,
                 r_range=self.raw_input_r_range)

    def load_table(self, path):
        """Restore tables saved with :meth:`save_table`."""
        f = np.load(path)
        self.raw_input_3D = f["tab3D"]
        self.raw_input_2D = f["tab2D"]
        self.raw_input_z_range = f["z_range"]
        self.raw_input_M_range = f["M_range"]
        self.raw_input_r_range = f["r_range"]
        self._axes = (jnp.asarray(self.raw_input_z_range),
                      jnp.asarray(self.raw_input_M_range),
                      jnp.asarray(self.raw_input_r_range))
        self._tab3D = jnp.asarray(self.raw_input_3D)
        self._tab2D = jnp.asarray(self.raw_input_2D)
        # new table content -> new identity token (runner cache re-key)
        vars(self).pop("_bfg_token", None)
        return self

    # curves are LOG values (tables store log; runners exp via curve_lookup)
    curves_are_log = True

    def halo_curves(self, M, a, kind="projected", **kwargs):
        """Per-halo log-profile curves on the radial grid: interpolate the
        constant (z, M) axes once per halo; per-pixel readout becomes a
        log-uniform 1D lookup (runner hot-path optimization).

        Returns (curves (n, n_r) of LOG values, ln_r0, dlnr). ``projected``
        curves are log(Sigma * a) — the runner divides the a factor out.
        Out-of-table (z, M) rows are -inf (reads exp to 0).
        """
        from ..ops.interp import collapse_curves
        assert not kwargs, "TabulatedProfile has no extra parameter axes"
        tab = self._tab2D if kind == "projected" else self._tab3D
        return collapse_curves(tab, self._axes, 2, M, a, [], {},
                               fill=-jnp.inf)

    @staticmethod
    def curve_lookup(curve, ln_r0, dlnr, r):
        """exp(log-curve) at radii r; zero outside the tabulated range."""
        n_r = curve.shape[-1]
        x = (jnp.log(jnp.maximum(r, 1e-30)) - ln_r0) / dlnr
        i = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n_r - 2)
        t = x - i
        # slice-2 pair gather (one gather per lookup; see
        # BaryonCorrection.curve_lookup)
        c2 = jnp.stack([curve[..., :-1], curve[..., 1:]], axis=-1)
        pair = c2[i]
        out = jnp.exp(pair[..., 0] * (1 - t) + pair[..., 1] * t)
        return jnp.where((x < 0) | (x > n_r - 1), 0.0, out)


class ParamTabulatedProfile:
    """Tabulated profile with arbitrary extra parameter axes
    (reference Tabulate.py:395-730). ``real/projected`` require the extra
    keys as kwargs; ``p_keys`` marks per-halo property dependence for
    Runners.
    """

    def __init__(self, model, cosmo, mass_def=None):
        self.model = model
        self.cosmo = cosmo
        self.mass_def = mass_def if mass_def is not None else model.mass_def
        self.p_keys = []

    def setup_interpolator(self, z_min=1e-2, z_max=5, N_samples_z=30,
                           M_min=1e12, M_max=1e16, N_samples_Mass=30,
                           R_min=1e-3, R_max=1e2, N_samples_R=100,
                           z_linear_sampling=False, other_params=None,
                           verbose=True):
        other_params = other_params or {}
        self.p_keys = list(other_params.keys())
        p_vals = [np.asarray(other_params[k]) for k in self.p_keys]

        M_range = np.geomspace(M_min, M_max, N_samples_Mass)
        r = np.geomspace(R_min, R_max, N_samples_R)
        z_range = (np.linspace(z_min, z_max, N_samples_z) if z_linear_sampling
                   else np.geomspace(z_min, z_max, N_samples_z))

        shape = [z_range.size, M_range.size, r.size] + [v.size for v in p_vals]
        tab3D = np.zeros(shape)
        tab2D = np.zeros(shape)

        from itertools import product
        combos = list(product(*[range(v.size) for v in p_vals])) or [()]
        for j, z in enumerate(z_range):
            a_j = 1.0 / (1.0 + z)
            for c in combos:
                for ki, k in enumerate(self.p_keys):
                    _set_parameter(self.model, k, p_vals[ki][c[ki]])
                idx = tuple([j, slice(None), slice(None)] + list(c))
                tab3D[idx] = np.asarray(
                    self.model.real(self.cosmo, r, M_range, a_j))
                tab2D[idx] = np.asarray(
                    self.model.projected(self.cosmo, r, M_range, a_j)) * a_j

        self.raw_input_z_range = np.log(1 + z_range)
        self.raw_input_M_range = np.log(M_range)
        self.raw_input_r_range = np.log(r)
        axes = [jnp.asarray(self.raw_input_z_range),
                jnp.asarray(self.raw_input_M_range),
                jnp.asarray(self.raw_input_r_range)]
        for k, v in zip(self.p_keys, p_vals):
            setattr(self, f"raw_input_{k}_range", v)
            axes.append(jnp.asarray(v))
        self._axes = tuple(axes)
        # store log with sign handling: these can be signed quantities;
        # keep raw values (no log) for robustness with extra axes
        self._tab3D = jnp.asarray(tab3D)
        self._tab2D = jnp.asarray(tab2D)
        # new table content -> new identity token (runner cache re-key)
        vars(self).pop("_bfg_token", None)
        return self

    def _readout(self, table, r, M, a, **kwargs):
        for k in self.p_keys:
            assert k in kwargs, f"must provide {k} (table was built with it)"
        r_use = jnp.atleast_1d(jnp.asarray(r, dtype=jnp.result_type(float)))
        M_use = jnp.atleast_1d(jnp.asarray(M, dtype=jnp.result_type(float)))
        n = M_use.size * r_use.size
        cols = [
            jnp.broadcast_to(jnp.log(1.0 / jnp.asarray(a)),
                             (M_use.size, r_use.size)).reshape(-1),
            jnp.broadcast_to(jnp.log(M_use)[:, None],
                             (M_use.size, r_use.size)).reshape(-1),
            jnp.broadcast_to(jnp.log(r_use)[None, :],
                             (M_use.size, r_use.size)).reshape(-1),
        ]
        for k in self.p_keys:
            cols.append(jnp.broadcast_to(jnp.asarray(kwargs[k], dtype=float),
                                         (n,)))
        pts = jnp.stack(cols, axis=1)
        out = multilinear_interp(self._axes, table, pts)
        out = out.reshape(M_use.size, r_use.size)
        if jnp.ndim(r) == 0:
            out = jnp.squeeze(out, axis=-1)
        if jnp.ndim(M) == 0:
            out = jnp.squeeze(out, axis=0)
        return out

    def real(self, cosmo, r, M, a, **kwargs):
        return self._readout(self._tab3D, r, M, a, **kwargs)

    def projected(self, cosmo, r, M, a, **kwargs):
        return self._readout(self._tab2D, r, M, a, **kwargs) / a

    # curves are RAW values (tables store raw — extra-axis quantities can
    # be signed, reference Tabulate.py:395-730 keeps them linear too)
    curves_are_log = False

    def halo_curves(self, M, a, kind="projected", **kwargs):
        """Per-halo RAW profile curves with the extra parameter axes
        (p_keys) collapsed at per-halo values — the p_keys fast path:
        per-pixel work becomes one log-uniform 1D lerp regardless of how
        many per-halo property axes the table carries.

        Returns (curves (n, n_r), ln_r0, dlnr); ``projected`` curves are
        Sigma * a (the runner divides the a factor out, matching
        :meth:`projected`). Out-of-table rows are zero.
        """
        from ..ops.interp import collapse_curves
        tab = self._tab2D if kind == "projected" else self._tab3D
        return collapse_curves(tab, self._axes, 2, M, a, self.p_keys,
                               kwargs, fill=0.0)

    @staticmethod
    def curve_lookup(curve, ln_r0, dlnr, r):
        """RAW-value 1D log-uniform lookup (zero outside the range)."""
        from ..Profiles.BaryonCorrection import BaryonificationClass
        return BaryonificationClass.curve_lookup(curve, ln_r0, dlnr, r)

    def with_dtype(self, dtype):
        """Shallow copy with tables cast to ``dtype`` (f32 hot path)."""
        import copy
        new = copy.copy(self)
        new._axes = tuple(ax.astype(dtype) for ax in self._axes)
        new._tab3D = self._tab3D.astype(dtype)
        new._tab2D = self._tab2D.astype(dtype)
        return new


class TabulatedCorrelation3D:
    """(z, r) table of the linear matter correlation, for the TwoHalo
    ``xi_mm`` hook (reference Tabulate.py:733-785)."""

    def __init__(self, cosmo, R_range=(1e-3, 3e2), N_samples_R=500,
                 z_range=(0.0, 6.0), N_samples_z=40):
        from ..cosmo import correlation_3d
        r = np.geomspace(R_range[0], R_range[1], N_samples_R)
        z = np.linspace(z_range[0], z_range[1], N_samples_z)
        tab = np.zeros([z.size, r.size])
        for j, zj in enumerate(z):
            tab[j] = np.asarray(correlation_3d(cosmo, r, a=1.0 / (1 + zj)))
        self._lnr = jnp.asarray(np.log(r))
        self._z = jnp.asarray(z)
        self._tab = jnp.asarray(tab)

    def __call__(self, r, a):
        z = 1.0 / jnp.asarray(a) - 1.0
        pts = jnp.stack([jnp.broadcast_to(z, jnp.shape(r)).reshape(-1),
                         jnp.log(jnp.asarray(r)).reshape(-1)], axis=1)
        out = multilinear_interp((self._z, self._lnr), self._tab, pts,
                                 fill_value=0.0)
        return out.reshape(jnp.shape(r))
