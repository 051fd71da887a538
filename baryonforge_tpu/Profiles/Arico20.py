"""Arico et al. 2020 (BACCO) baryonification family, in JAX.

Physics parity with reference Profiles/Arico20.py (citations per class).
Distinctives vs Schneider19: profiles truncated at R200c (r_max_int=10,
Arico20.py:38), Behroozi13/Kravtsov18 stellar fractions with hard-coded
calibration constants (Arico20.py:129-181), gas split into bound/ejected/
re-accreted components (Arico20.py:238-244), analytic NFW normalization,
and a polytropic pressure model (Arico20.py:1052-1174).

Vectorization notes: the reference's per-halo loops (BoundGas normalization,
ModifiedDarkMatter root-find, CollisionlessMatter relaxation) are replaced by
broadcasted per-halo log grids, a vmapped monotone root-find
(utils.misc.safe_Pchip_minimize), and a fixed-iteration vectorized
relaxation.
"""

import numpy as np
import jax
import jax.numpy as jnp

from .Base import Profile, hyper_params, sigmoid_cutoff, _atleast_1d_pair
from . import Schneider19 as S19
from .misc import Truncation, Zeros
from ..cosmo import core as _core
from ..cosmo import power as _power
from ..cosmo import massdef as _massdef
from ..cosmo import concentration as _conc
from ..ops.integrate import cumulative_simpson_uniform
from ..ops.interp import (pchip_derivatives, pchip_eval, cubic_spline_coeffs,
                          cubic_spline_derivative_eval, cubic_spline_eval)
from ..utils import constants as const
from ..utils.misc import safe_Pchip_minimize

__all__ = ['model_params', 'AricoProfiles', 'DarkMatter', 'TwoHalo',
           'Stars', 'BoundGasUntruncated', 'BoundGas', 'EjectedGas',
           'ReaccretedGas', 'Gas', 'ModifiedDarkMatter',
           'CollisionlessMatter', 'SatelliteStars', 'DarkMatterOnly',
           'DarkMatterBaryon', 'DarkMatterOnlywithLSS',
           'DarkMatterBaryonwithLSS', 'Pressure', 'NonThermalFrac',
           'ThermalPressure', 'Temperature', 'BoundGasDeprecated']

# parameter inventory mirrors reference Arico20.py:16-28
model_params = ['cdelta', 'a', 'n',
                'q', 'p',
                'cutoff', 'proj_cutoff',
                'theta_out', 'theta_inn', 'M_inn', 'M_c', 'mu', 'beta',
                'M_r', 'beta_r', 'eta', 'theta_rg', 'sigma_rg',
                'epsilon_hydro',
                'M1_0', 'alpha_g', 'epsilon_h',
                'M1_fsat', 'eps_fsat', 'alpha_fsat', 'delta_fsat',
                'gamma_fsat',
                'A_nt', 'alpha_nt',
                'mean_molecular_weight']

# Behroozi+2013 fitting-function calibration constants (Arico20.py:129-143)
_B13 = dict(M1_a=-1.793, M1_z=-0.251, eps_0=np.log10(0.023), eps_a=-0.006,
            eps_a2=-0.119, alpha_0=-1.779, alpha_a=0.731, delta_0=4.394,
            delta_a=2.608, delta_z=-0.043, gamma_0=0.547, gamma_a=1.319,
            gamma_z=0.279)


def _f_bar(cosmo):
    return cosmo.Omega_b / cosmo.Omega_m


class AricoProfiles(Profile):
    """Family base: Behroozi13 stellar fractions + bound/ejected/reaccreted
    gas split (reference Arico20.py:31-261)."""

    model_param_names = model_params
    hyper_param_names = hyper_params

    def __init__(self, r_max_int=10, **kwargs):
        super().__init__(**kwargs, r_max_int=r_max_int)

    def _get_gas_params(self, M, a, cosmo):
        beta = 3.0 - (self.M_inn / M) ** self.mu * jnp.ones_like(M)
        beta = jnp.clip(beta, -1, None)
        theta_out = self.theta_out * jnp.ones_like(M)
        theta_inn = self.theta_inn * jnp.ones_like(M)
        return beta[:, None], theta_out[:, None], theta_inn[:, None]

    def _behroozi_frac(self, M, a, M1_0, eps_fac=1.0, alpha_fac=1.0,
                       delta_fac=1.0, gamma_fac=1.0):
        B = _B13
        z = 1 / a - 1
        nu = jnp.exp(-4 * a ** 2)
        M1 = M1_0 * 10 ** ((B["M1_a"] * (a - 1) + B["M1_z"] * z) * nu)
        eps = 10 ** (B["eps_0"] + nu * (B["eps_a"] * (a - 1))
                     + B["eps_a2"] * (a - 1)) * eps_fac
        alpha = (B["alpha_0"] + nu * (B["alpha_a"] * (a - 1))) * alpha_fac
        delta = (B["delta_0"] + nu * (B["delta_a"] * (a - 1)
                                      + B["delta_z"] * z)) * delta_fac
        gamma = (B["gamma_0"] + nu * (B["gamma_a"] * (a - 1)
                                      + B["gamma_z"] * z)) * gamma_fac

        x = jnp.log10(M / M1)
        exp_term = jnp.exp(jnp.clip(10.0 ** (-x), None, 30.0))
        g_x = (-jnp.log10(10 ** (alpha * x) + 1)
               + delta * jnp.log10(1 + jnp.exp(x)) ** gamma / (1 + exp_term))
        g_0 = (-jnp.log10(2.0)
               + delta * jnp.log10(2.0) ** gamma / (1 + jnp.e))
        return eps * (M1 / M) * 10 ** (g_x - g_0)

    def _get_star_frac(self, M, a, cosmo, satellite=False):
        fCG = self._behroozi_frac(M, a, self.M1_0)
        fSG = self._behroozi_frac(M, a, self.M1_0 * self.M1_fsat,
                                  self.eps_fsat, self.alpha_fsat,
                                  self.delta_fsat, self.gamma_fsat)
        fb = _f_bar(cosmo)
        fCG = jnp.clip(fCG, 1e-10, fb)
        fSG = jnp.clip(fSG - jnp.clip(fCG + fSG - fb, 0, None), 0, None)
        return fSG if satellite else fCG

    def get_f_star(self, M_use, a, cosmo):
        return (self.get_f_star_cen(M_use, a, cosmo)
                + self.get_f_star_sat(M_use, a, cosmo))

    def get_f_star_cen(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo, satellite=False)

    def get_f_star_sat(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo, satellite=True)

    def _get_gas_frac(self, M, a, cosmo):
        """(f_bg, f_rg, f_eg) bound/reaccreted/ejected gas fractions
        (reference Arico20.py:238-244)."""
        f_str = self.get_f_star(M, a, cosmo)
        f_gas = jnp.clip(_f_bar(cosmo) - f_str, 1e-10, None)
        f_hg = f_gas / (1 + (self.M_c / M) ** self.beta)
        f_eg = f_gas - f_hg
        f_rg = jnp.clip(f_eg / (1 + (self.M_r / M) ** self.beta_r),
                        None, f_hg)
        f_bg = f_hg - f_rg
        return f_bg, f_rg, f_eg

    def get_f_gas(self, M, a, cosmo):
        f = self._get_gas_frac(M, a, cosmo)
        return f[0] + f[1] + f[2]


def _per_halo_loggrid(r_min, R, steps):
    t = jnp.linspace(0.0, 1.0, steps)
    return jnp.exp(jnp.log(r_min)
                   + (jnp.log(R)[:, None] - jnp.log(r_min)) * t[None, :])


class DarkMatter(AricoProfiles):
    """NFW truncated at R with ANALYTIC normalization
    (reference Arico20.py:264-331)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        c = self._get_concentration(cosmo, M_use, a)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        r_s = R / c
        norm = 4 * jnp.pi * r_s ** 3 * _massdef.nfw_mu(c)
        rho_c = (M_use / norm)[:, None]
        r_s = r_s[:, None]

        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        prof = rho_c / (r_use[None, :] / r_s
                        * (1 + r_use[None, :] / r_s) ** 2) * kfac
        return jnp.where(r_use[None, :] <= R[:, None], prof, 0.0)


class TwoHalo(S19.TwoHalo, AricoProfiles):
    """Same 2-halo term as Schneider19 (reference Arico20.py:334-335)."""
    model_param_names = model_params


class Stars(AricoProfiles):
    """Power-law x Gaussian stellar profile (reference Arico20.py:338-406)."""

    def __init__(self, r_min_int=1e-6, r_max_int=5, **kwargs):
        super().__init__(**{**kwargs, "r_min_int": r_min_int},
                         r_max_int=r_max_int)
        self.update_precision_fftlog(padding_lo_fftlog=1e-5,
                                     padding_hi_fftlog=1e5,
                                     plaw_fourier=-3 + 1e-4)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        f_cga = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        R_h = self.epsilon_h * R[:, None]

        r_int = jnp.geomspace(self.r_min_int, self.r_max_int, self.r_steps)
        shape_i = (1 / R_h / r_int[None, :] ** self.alpha_g
                   * jnp.exp(-(r_int[None, :] / 2 / R_h) ** 2))
        norm = jnp.trapezoid(4 * jnp.pi * r_int ** 2 * shape_i, r_int,
                             axis=-1)[:, None]
        prof = (f_cga * M_use[:, None] / R_h / r_use[None, :] ** self.alpha_g
                * jnp.exp(-(r_use[None, :] / 2 / R_h) ** 2) / norm)
        return prof


class BoundGasUntruncated(AricoProfiles):
    """Double-slope bound gas with a matched NFW tail outside R_ej
    (reference Arico20.py:409-515); per-halo normalization on [r_min, R]."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        f_bg = self._get_gas_frac(M_use, a, cosmo)[0][:, None]
        beta, theta_out, theta_inn = self._get_gas_params(M_use, a, cosmo)
        R_co = theta_inn * R[:, None]
        R_ej = theta_out * R[:, None]

        c = self._get_concentration(cosmo, M_use, a)
        r_s = (R / c)[:, None]
        # continuity constant matching GNFW to the NFW tail at R_ej
        y1 = ((1 + R_ej / R_co) ** -beta / 4 * (R_ej / r_s)
              * (1 + R_ej / r_s) ** 2)

        # per-halo normalization over [r_min_int, R_i]
        r_int = _per_halo_loggrid(self.r_min_int, R, self.r_steps)
        u_i = r_int / R_co
        v_i = r_int / R_ej
        shape_i = (1 + u_i) ** -beta / (1 + v_i ** 2) ** 2
        norm = jnp.trapezoid(4 * jnp.pi * r_int ** 2 * shape_i, r_int,
                             axis=-1)[:, None]

        u = r_use[None, :] / R_co
        v = r_use[None, :] / R_ej
        x = r_use[None, :] / r_s
        gnfw = (1 + u) ** -beta / (1 + v ** 2) ** 2
        nfw = y1 / x / (1 + x) ** 2
        prof = jnp.where(v <= 1, gnfw, nfw)
        prof = prof * f_bg * M_use[:, None] / norm
        return prof * sigmoid_cutoff(r_use[None, :], self.cutoff)


class BoundGas(BoundGasUntruncated):
    """Bound gas truncated at R (reference Arico20.py:518-556)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        trunc = Truncation(epsilon_trunc=1, mass_def=self.mass_def)
        return super()._real(cosmo, r_use, M_use, a) \
            * trunc._real(cosmo, r_use, M_use, a)


class EjectedGas(AricoProfiles):
    """Gaussian ejected gas with R_ej from the escape radius
    (reference Arico20.py:560-618)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        assert self.mass_def.rho_type == "critical", (
            "Escape radius needs a critical-overdensity mass definition")
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        f_eg = self._get_gas_frac(M_use, a, cosmo)[2][:, None]
        R_esc = 0.5 * jnp.sqrt(self.mass_def.Delta) * R
        R_ej = (self.eta * 0.75 * R_esc)[:, None]

        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        prof = (f_eg * M_use[:, None] / (2 * jnp.pi * R_ej ** 2) ** 1.5
                * jnp.exp(-(r_use[None, :] / R_ej) ** 2 / 2) * kfac)
        return prof


class ReaccretedGas(AricoProfiles):
    """Gaussian shell at theta_rg R with analytic erf normalization,
    zero beyond R (reference Arico20.py:622-688)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        f_rg = self._get_gas_frac(M_use, a, cosmo)[1][:, None]
        R_rg = (self.theta_rg * R)[:, None]
        S_rg = (self.sigma_rg * R)[:, None]
        Rc = R[:, None]

        t1 = 2 * jnp.sqrt(2 * jnp.pi) * (
            jnp.exp(-R_rg ** 2 / (2 * S_rg ** 2)) * R_rg
            - jnp.exp(-(R_rg - Rc) ** 2 / (2 * S_rg ** 2)) * (R_rg + Rc))
        t2 = 2 * jnp.pi * (R_rg ** 2 + S_rg ** 2) \
            * jax.scipy.special.erf(R_rg / (jnp.sqrt(2.0) * S_rg))
        t3 = -2 * jnp.pi * (R_rg ** 2 + S_rg ** 2) \
            * jax.scipy.special.erf((R_rg - Rc) / (jnp.sqrt(2.0) * S_rg))
        norm = t1 * S_rg + t2 + t3

        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        prof = (1 / jnp.sqrt(2 * jnp.pi * S_rg ** 2)
                * jnp.exp(-((r_use[None, :] - R_rg) / S_rg) ** 2 / 2))
        prof = prof * f_rg * M_use[:, None] / norm * kfac
        return jnp.where(r_use[None, :] <= Rc, prof, 0.0)


class Gas(AricoProfiles):
    """Composite BoundGas + EjectedGas + ReaccretedGas via profile algebra
    + delegation (reference Arico20.py:691-711)."""

    def __init__(self, **kwargs):
        self.myprof = (BoundGas(**kwargs) + EjectedGas(**kwargs)
                       + ReaccretedGas(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return self.myprof._real(cosmo, r_use, M_use, a)


class ModifiedDarkMatter(AricoProfiles):
    """DM adjusted for gas: NFW inside r_p, (rho_Gro - rho_BG) outside,
    zero beyond R; r_p from eq. A10 of arXiv:1911.08471 via a vmapped
    monotone root-find (reference Arico20.py:714-817)."""

    def __init__(self, gas=None, gravityonly=None, **kwargs):
        self.Gas = gas if gas is not None else BoundGas(**kwargs)
        self.GravityOnly = (gravityonly if gravityonly is not None
                            else DarkMatter(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        c = self._get_concentration(cosmo, M_use, a)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        r_s = (R / c)[:, None]
        fDM = 1 - _f_bar(cosmo)

        rp_grid = jnp.geomspace(self.r_min_int, self.r_max_int,
                                self.r_steps)
        # density at the halo boundary per halo (diagonal evaluation)
        pGro = jax.vmap(lambda Ri, Mi: self.GravityOnly._real(
            cosmo, Ri[None], Mi[None], a)[0, 0])(R, M_use)[:, None]
        pBG = jax.vmap(lambda Ri, Mi: self.Gas._real(
            cosmo, Ri[None], Mi[None], a)[0, 0])(R, M_use)[:, None]

        rpg = rp_grid[None, :]
        LHS = (rpg * (rpg + r_s) ** 2 * (pGro - pBG)
               * (jnp.log(1 + rpg / r_s) - 1 / (1 + r_s / rpg))
               + (pGro - pBG) / 3 * (R[:, None] ** 3 - rpg ** 3))
        RHS = (fDM * M_use / (4 * jnp.pi))[:, None]
        ln_rp = jax.vmap(lambda row: safe_Pchip_minimize(
            row, jnp.log(rp_grid)))(LHS - RHS)
        rp = jnp.exp(ln_rp)[:, None]

        rho_c = (pGro - pBG) * (rp / r_s) * (1 + rp / r_s) ** 2
        prof = rho_c / (r_use[None, :] / r_s) \
            / (1 + r_use[None, :] / r_s) ** 2
        prof = jnp.where(r_use[None, :] < rp, prof, pGro - pBG)
        prof = prof * sigmoid_cutoff(r_use[None, :], self.cutoff)
        return jnp.where(r_use[None, :] <= R[:, None], prof, 0.0)


class CollisionlessMatter(AricoProfiles):
    """Relaxed collisionless matter on per-halo grids to R200c, relaxation
    normalized to 1 at R and mass renormalized to f_clm M at R
    (reference Arico20.py:820-975). Vectorized fixed-iteration relaxation.
    """

    def __init__(self, gas=None, stars=None, darkmatter=None, max_iter=10,
                 reltol=1e-2, r_min_int=1e-8, r_max_int=10.0, r_steps=5000,
                 **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else ModifiedDarkMatter(**kwargs))
        self.Gas.set_parameter('cutoff', 1000)
        self.Stars.set_parameter('cutoff', 1000)
        self.DarkMatter.set_parameter('cutoff', 1000)
        self.max_iter = max_iter
        self.reltol = reltol
        super().__init__(**kwargs, r_min_int=r_min_int,
                         r_max_int=r_max_int, r_steps=r_steps)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        f_sg = self.get_f_star_sat(M_use, a, cosmo)[:, None]
        f_clm = (1 - _f_bar(cosmo)) + f_sg

        r_int = _per_halo_loggrid(self.r_min_int, R, self.r_steps)  # (M, L)
        lnr = jnp.log(r_int)
        dlnr = lnr[:, 1:2] - lnr[:, 0:1]

        def eval_rows(prof_obj):
            return jax.vmap(lambda rr, mm: prof_obj._real(
                cosmo, rr, mm[None], a)[0])(r_int, M_use)

        rho_i = eval_rows(self.DarkMatter)
        rho_cga = eval_rows(self.Stars)
        rho_gas = eval_rows(self.Gas.myprof
                            if isinstance(self.Gas, Gas) else self.Gas)

        dV = 4 * jnp.pi * r_int ** 3 * dlnr
        def cmass(rho):
            return (cumulative_simpson_uniform(dV * rho, dx=1.0, axis=-1)
                    + dV[:, :1] * rho[:, :1])
        M_i = cmass(rho_i)
        M_cga = cmass(rho_cga)
        M_gas = cmass(rho_gas)

        ln_Mi = jnp.log(M_i)
        ln_Mc = jnp.log(M_cga)
        ln_Mg = jnp.log(M_gas)
        d_nfw = jax.vmap(pchip_derivatives)(lnr, ln_Mi)
        d_cga = jax.vmap(pchip_derivatives)(lnr, ln_Mc)
        d_gas = jax.vmap(pchip_derivatives)(lnr, ln_Mg)

        def masked_eval(lnr_row, y_row, d_row, x_row, fill):
            out = jnp.exp(pchip_eval(lnr_row, y_row, d_row, x_row))
            inside = (x_row >= lnr_row[0]) & (x_row <= lnr_row[-1])
            return jnp.where(inside, out, fill)

        def body(_, zeta):
            ln_rf = lnr + jnp.log(zeta)
            Mc = jax.vmap(masked_eval)(lnr, ln_Mc, d_cga, ln_rf,
                                       M_cga[:, -1])
            Mg = jax.vmap(masked_eval)(lnr, ln_Mg, d_gas, ln_rf,
                                       M_gas[:, -1])
            M_f = f_clm * M_i + Mc + Mg
            znew = 1 + self.a * ((M_i / M_f) ** self.n - 1)
            # normalize zeta to 1 at R (last grid point; Arico20.py:920-923)
            return znew / znew[:, -1:]

        zeta = jax.lax.fori_loop(0, self.max_iter, body,
                                 jnp.ones_like(M_i))

        def shifted(lnr_row, yi, di, z_row):
            out = pchip_eval(lnr_row, yi, di, lnr_row - jnp.log(z_row))
            inside = ((lnr_row - jnp.log(z_row) >= lnr_row[0])
                      & (lnr_row - jnp.log(z_row) <= lnr_row[-1]))
            return jnp.where(inside, out, 0.0)

        ln_M_clm = jnp.log(f_clm) + jax.vmap(shifted)(lnr, ln_Mi, d_nfw,
                                                      zeta)
        # renormalize to f_clm * M at R (last point; Arico20.py:950-952)
        ln_M_clm = ln_M_clm + (jnp.log(f_clm * M_use[:, None])
                               - ln_M_clm[:, -1:])

        def density_row(lnr_row, lnM_row, r_out, R_i):
            d_spl = cubic_spline_coeffs(lnr_row, lnM_row)
            ln_r = jnp.log(r_out)
            logd = cubic_spline_derivative_eval(lnr_row, lnM_row, d_spl,
                                                ln_r)[0]
            ln_at = cubic_spline_eval(lnr_row, lnM_row, d_spl, ln_r)[0]
            rho = logd * jnp.exp(ln_at) / r_out / (4 * jnp.pi * r_out ** 2)
            inside = (ln_r >= lnr_row[0]) & (ln_r <= lnr_row[-1])
            rho = jnp.where(inside & (r_out <= R_i), rho, 0.0)
            return jnp.where(jnp.isfinite(rho), rho, 0.0)

        prof = jax.vmap(lambda lr, lm, Ri: density_row(lr, lm, r_use, Ri))(
            lnr, ln_M_clm, R)
        prof = jnp.clip(prof, 0.0, None)
        return prof * sigmoid_cutoff(r_use[None, :], self.cutoff)


class SatelliteStars(CollisionlessMatter):
    """CLM rescaled to the satellite fraction (reference Arico20.py:978)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        f_sg = self.get_f_star_sat(M_use, a, cosmo)[:, None]
        f_clm = (1 - _f_bar(cosmo)) + f_sg
        return super()._real(cosmo, r_use, M_use, a) * (f_sg / f_clm)


class DarkMatterOnly(DarkMatter):
    """= DarkMatter; Arico's DMO has no 2-halo (reference Arico20.py:993)."""


class DarkMatterBaryon(AricoProfiles):
    """Gas + Stars + CLM composite, no renormalization factor
    (reference Arico20.py:1000-1015)."""

    def __init__(self, gas=None, stars=None, collisionlessmatter=None,
                 **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.CollisionlessMatter = (collisionlessmatter
                                    if collisionlessmatter is not None
                                    else CollisionlessMatter(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return (self.Gas._real(cosmo, r_use, M_use, a)
                + self.Stars._real(cosmo, r_use, M_use, a)
                + self.CollisionlessMatter._real(cosmo, r_use, M_use, a))


class DarkMatterOnlywithLSS(AricoProfiles):
    """DarkMatter + TwoHalo (reference Arico20.py:1018-1032)."""

    def __init__(self, darkmatter=None, twohalo=None, **kwargs):
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return (self.DarkMatter._real(cosmo, r_use, M_use, a)
                + self.TwoHalo._real(cosmo, r_use, M_use, a))


class DarkMatterBaryonwithLSS(DarkMatterBaryon):
    """DMB + TwoHalo (reference Arico20.py:1035-1049)."""

    def __init__(self, gas=None, stars=None, collisionlessmatter=None,
                 darkmatter=None, twohalo=None, **kwargs):
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        super().__init__(gas=gas, stars=stars,
                         collisionlessmatter=collisionlessmatter, **kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return (super()._real(cosmo, r_use, M_use, a)
                + self.TwoHalo._real(cosmo, r_use, M_use, a))


class Pressure(AricoProfiles):
    """Polytropic effective-EoS pressure applied to all gas
    (reference Arico20.py:1052-1174): Gamma_eff from c * theta_out, P0 per
    eq. 5 of arXiv:2406.01672, output in CGS with the 1/a comoving factor.
    """

    def __init__(self, bound_gas_untruncated=None, gas=None, **kwargs):
        self.BoundGas = (bound_gas_untruncated
                         if bound_gas_untruncated is not None
                         else BoundGasUntruncated(**kwargs))
        self.Gas = gas if gas is not None else Gas(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        c = self._get_concentration(cosmo, M_use, a)[:, None]
        r_s = R[:, None] / c
        norm = 4 * jnp.pi * r_s ** 3 * _massdef.nfw_mu(c)
        rhoc = M_use[:, None] / norm

        xp = c * self.theta_out
        Geff = 1 + ((1 + xp) * jnp.log(1 + xp) - xp) \
            / ((1 + 3 * xp) * jnp.log(1 + xp))
        rho0 = self.BoundGas._real(cosmo, jnp.asarray([1e-10]), M_use, a)
        P0 = rhoc * r_s ** 2 / rho0 ** (Geff - 1) * (1 - 1 / Geff)
        P0 = P0 * 4 * jnp.pi * const.G
        # (Msun/Mpc) -> CGS (g/cm): pressure G rho^2 L^2 -> erg/cm^3
        P0 = P0 * const.Msun_to_g / const.Mpc_to_cm
        P0 = P0 / a

        rhoBG = self.BoundGas._real(cosmo, r_use, M_use, a)
        rhoG = self.Gas._real(cosmo, r_use, M_use, a)
        prof = P0 * rhoBG ** Geff
        prof = jnp.where(jnp.isfinite(prof), prof, 0.0)
        rhoBG = jnp.where(rhoBG > 0, rhoBG, jnp.inf)
        prof = rhoG * (prof / rhoBG)
        return prof * sigmoid_cutoff(r_use[None, :], self.cutoff)


class NonThermalFrac(AricoProfiles):
    """Green20 functional form with free amplitude A_nt (1+z)^alpha_nt;
    needs the M200m translation + peak height (reference Arico20.py:1177)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        z = 1 / a - 1
        conc = _conc.ConcentrationDiemer15(mass_def=self.mass_def)
        c_in = conc(cosmo, M_use, a)
        M200m, _ = _massdef.translate_mass(cosmo, M_use, a, c_in,
                                           self.mass_def,
                                           _massdef.MassDef200m)
        R200m = _massdef.MassDef200m.get_radius(cosmo, M200m, a) / a
        x = r_use[None, :] / R200m[:, None]
        nu_M = (1.686 / _power.sigmaM(cosmo, M200m, a))[:, None]
        b, cc, d, e, f = 0.719, 1.417, -0.166, 0.265, -2.116
        A = self.A_nt * (1 + z) ** self.alpha_nt
        nth = 1 - A * (1 + jnp.exp(-(x / b) ** cc)) \
            * (nu_M / 4.1) ** (d / (1 + (x / e) ** f))
        return jnp.clip(nth, 0.0, 1.0)


class ThermalPressure(AricoProfiles):
    """Pressure * (1 - NonThermalFrac) (reference Arico20.py:1246-1254)."""

    def __init__(self, **kwargs):
        self.Pressure = Pressure(**kwargs)
        self.NonThermalFrac = NonThermalFrac(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return (self.Pressure._real(cosmo, r_use, M_use, a)
                * (1 - self.NonThermalFrac._real(cosmo, r_use, M_use, a)))


class Temperature(AricoProfiles):
    """Ideal-gas temperature P/(n k_B) in K (reference Arico20.py:1257)."""

    def __init__(self, pressure=None, gas=None, **kwargs):
        self.Pressure = (pressure if pressure is not None
                         else ThermalPressure(**kwargs))
        self.Gas = gas if gas is not None else Gas(**kwargs)
        super().__init__(**kwargs)

    def _number_density(self, rho):
        # rho [Msun/Mpc^3] -> n [1/cm^3]
        return rho * const.Msun_to_g / const.Mpc_to_cm ** 3 \
            / (self.mean_molecular_weight * const.M_PROTON_CGS)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        P = self.Pressure._real(cosmo, r_use, M_use, a)
        n = self._number_density(self.Gas._real(cosmo, r_use, M_use, a))
        return jnp.where(n > 0, P / (n * const.K_BOLTZ_CGS), 0.0)

    def _projected(self, cosmo, r, M, a, **kw):
        P = self.Pressure._projected(cosmo, r, M, a, **kw)
        n = self._number_density(self.Gas._projected(cosmo, r, M, a, **kw))
        return jnp.where(n > 0, P / (n * const.K_BOLTZ_CGS), 0.0)


class BoundGasDeprecated(AricoProfiles):
    """Legacy hydrostatic/NFW-tail bound gas, kept for API compatibility
    (reference Arico20.py:1339-1440)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        f_cg = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        fb = _f_bar(cosmo)
        f_bg = ((fb - f_cg)
                / (1 + (self.M_c / M_use[:, None]) ** self.beta))

        c = self._get_concentration(cosmo, M_use, a)
        r_s = (R / c)[:, None]
        eps = self.epsilon_hydro
        ce = c / eps
        Geff = ((1 + 3 * ce) * jnp.log(1 + ce)
                / ((1 + ce) * jnp.log(1 + ce) - ce))[:, None]
        e5 = (c / eps)[:, None]
        y1 = (jnp.log(1 + e5) / e5) ** Geff * (e5 * (1 + e5) ** 2)

        r_int = jnp.geomspace(self.r_min_int, self.r_max_int, self.r_steps)
        x_i = r_int[None, :] / r_s
        u_i = (jnp.log(1 + x_i) / x_i) ** Geff
        v_i = y1 * (1 + x_i) ** -2 / x_i
        y_i = jnp.where(r_int[None, :] < R[:, None] / eps, u_i, v_i)
        y_i = jnp.where(r_int[None, :] > R[:, None], 0.0, y_i)
        norm = jnp.trapezoid(4 * jnp.pi * r_int ** 2 * y_i, r_int,
                             axis=-1)[:, None]

        x = r_use[None, :] / r_s
        u = (jnp.log(1 + x) / x) ** Geff
        v = y1 * (1 + x) ** -2 / x
        prof = jnp.where(r_use[None, :] < R[:, None] / eps, u, v)
        prof = jnp.where(r_use[None, :] > R[:, None], 0.0, prof)
        prof = f_bg * M_use[:, None] * prof / norm
        return prof * sigmoid_cutoff(r_use[None, :], self.cutoff)
