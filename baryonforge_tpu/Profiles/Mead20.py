"""Mead et al. 2020 (HMx) model family, in JAX.

Physics parity with reference Profiles/Mead20.py. Distinctives: Gaussian
stellar fraction in log10 M (Mead20.py:93-111), bound fraction
f_bnd = f_bar (M/M0)^beta / (1 + (M/M0)^beta) (Mead20.py:128), and the
concentration modification c -> c (1 + eps1 + (eps2 - eps1) f_bnd/f_bar)
(Mead20.py:138-159). Ships the six HMx T_AGN calibration dicts and the
``Tagn2pars`` interpolator (Mead20.py:1118-1218) — these are calibration
data reproduced as-is.
"""

import warnings
import numpy as np
import jax
import jax.numpy as jnp

from .Base import Profile, hyper_params, sigmoid_cutoff, _atleast_1d_pair
from . import Schneider19 as S19
from .misc import Zeros
from ..cosmo import massdef as _massdef
from ..cosmo import concentration as _conc
from ..ops import fftlog as _fftlog
from ..utils import constants as const
from ..utils.misc import safe_Pchip_minimize

__all__ = ['model_params', 'MeadProfiles', 'DarkMatter', 'TwoHalo',
           'CentralStars', 'SatelliteStars', 'Stars', 'DeltaStars',
           'BoundGas', 'EjectedGas', 'Gas', 'GasAddDiffuse',
           'CollisionlessMatter', 'DarkMatterOnly', 'DarkMatterBaryon',
           'DarkMatterBaryonAddDiffuse', 'DarkMatterOnlywithLSS',
           'DarkMatterBaryonwithLSS', 'Temperature', 'Pressure',
           'PressureAddDiffuse', 'Tagn2pars',
           'Params_TAGN_7p6_All', 'Params_TAGN_7p8_All',
           'Params_TAGN_8p0_All', 'Params_TAGN_7p6_MPr',
           'Params_TAGN_7p8_MPr', 'Params_TAGN_8p0_MPr']

model_params = ['cdelta', 'eps1', 'nu_eps1', 'eps2', 'cutoff', 'proj_cutoff',
                'p', 'q', 'M_0', 'beta', 'Gamma', 'nu_Gamma', 'eta_b',
                'A_star', 'nu_A_star', 'M_star', 'nu_M_star', 'sigma_star',
                'epsilon_h', 'eta', 'T_w', 'nu_T_w',
                'mean_molecular_weight', 'alpha']


def _f_bar(cosmo):
    return cosmo.Omega_b / cosmo.Omega_m


class MeadProfiles(Profile):
    """Family base: HMx fractions + concentration modification."""

    model_param_names = model_params
    hyper_param_names = hyper_params

    def _get_star_frac(self, M_use, a, cosmo):
        z = 1 / a - 1
        Astr = self.A_star + self.nu_A_star * z
        Mstr = self.M_star * jnp.exp(z * self.nu_M_star)
        f_str = Astr * jnp.exp(
            -(jnp.log10(M_use / Mstr) / self.sigma_star) ** 2 / 2)
        f_str = jnp.where(M_use > Mstr,
                          jnp.maximum(f_str, Astr / 3), f_str)
        fb = _f_bar(cosmo)
        f_bnd = fb * (M_use / self.M_0) ** self.beta \
            / (1 + (M_use / self.M_0) ** self.beta)
        f_sum = f_bnd + f_str
        f_str = jnp.where(f_sum > fb, f_str - (f_sum - fb), f_str)
        f_str = jnp.clip(f_str, 1e-10, None)
        f_cen = f_str * jnp.clip(
            jnp.where(M_use < Mstr, 1.0, (M_use / Mstr) ** self.eta), 0, 1)
        f_sat = f_str * jnp.clip(
            jnp.where(M_use < Mstr, 0.0,
                      1 - (M_use / Mstr) ** self.eta), 0, 1)
        return f_str, f_cen, f_sat

    def get_f_star(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo)[0]

    def get_f_star_cen(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo)[1]

    def get_f_star_sat(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo)[2]

    def _get_gas_frac(self, M_use, a, cosmo):
        f_str = self.get_f_star(M_use, a, cosmo)
        fb = _f_bar(cosmo)
        f_bnd = fb * (M_use / self.M_0) ** self.beta \
            / (1 + (M_use / self.M_0) ** self.beta)
        f_ej = fb - f_str - f_bnd
        return f_bnd, f_ej

    def get_f_gas(self, M_use, a, cosmo):
        f = self._get_gas_frac(M_use, a, cosmo)
        return f[0] + f[1]

    def _modify_concentration(self, cosmo, c, M, a):
        z = 1 / a - 1
        fb = _f_bar(cosmo)
        f_bnd = self._get_gas_frac(M, a, cosmo)[0]
        eps1 = self.eps1 + z * self.nu_eps1
        return c * (1 + eps1 + (self.eps2 - eps1) * f_bnd / fb)

    def _get_concentration(self, cosmo, M_use, a):
        """Duffy08 default (not Diemer15; Mead20.py:436-438)."""
        cdelta = getattr(self, "cdelta", None)
        if (cdelta is None) and (self.c_M_relation is None):
            rel = _conc.ConcentrationDuffy08(mass_def=self.mass_def)
        elif self.c_M_relation is not None:
            rel = self.c_M_relation
        else:
            rel = _conc.ConcentrationConstant(c=cdelta,
                                              mass_def=self.mass_def)
        c = rel(cosmo, M_use, a)
        return jnp.where(jnp.isfinite(c), c, 1.0)


class DarkMatter(MeadProfiles):
    """NFW truncated at R, analytic norm, UNMODIFIED concentration
    (reference Mead20.py:162-234)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        c = self._get_concentration(cosmo, M_use, a)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        r_s = R / c
        rho_c = (M_use / (4 * jnp.pi * r_s ** 3
                          * _massdef.nfw_mu(c)))[:, None]
        r_s = r_s[:, None]
        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        prof = rho_c / (r_use[None, :] / r_s
                        * (1 + r_use[None, :] / r_s) ** 2) * kfac
        return jnp.where(r_use[None, :] <= R[:, None], prof, 0.0)


class TwoHalo(S19.TwoHalo, MeadProfiles):
    """= S19 TwoHalo (reference Mead20.py:237-238)."""
    model_param_names = model_params


class CentralStars(MeadProfiles):
    """S19-style exponential with f_cen (reference Mead20.py:241-296)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.update_precision_fftlog(padding_lo_fftlog=1e-5,
                                     padding_hi_fftlog=1e5)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        f_cen = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        R_h = self.epsilon_h * R[:, None]
        return (f_cen * M_use[:, None] / (4 * jnp.pi ** 1.5 * R_h)
                / r_use[None, :] ** 2
                * jnp.exp(-(r_use[None, :] / 2 / R_h) ** 2))


class SatelliteStars(DarkMatter):
    """NFW rescaled by f_sat (reference Mead20.py:299-317)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        f_sat = self.get_f_star_sat(M_use, a, cosmo)[:, None]
        return super()._real(cosmo, r_use, M_use, a) * f_sat


class Stars(MeadProfiles):
    """CentralStars + SatelliteStars composite (reference Mead20.py:320)."""

    def __init__(self, **kwargs):
        self.myprof = CentralStars(**kwargs) + SatelliteStars(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return self.myprof._real(cosmo, r_use, M_use, a)


class DeltaStars(MeadProfiles):
    """Mead's exact delta-function stars: constant in Fourier space
    (reference Mead20.py:342-396)."""

    def _fourier(self, cosmo, k, M, a):
        k_use, M_use = _atleast_1d_pair(k, M)
        f_cen = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        return f_cen * M_use[:, None] * jnp.ones_like(k_use)[None, :]

    def _real(self, cosmo, r, M, a):
        # inverse transform of a constant: a delta function — represent it
        # numerically via the FFTLog round trip on a narrow Gaussian proxy
        r_use, M_use = _atleast_1d_pair(r, M)
        f_cen = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        sig = 1e-3
        gauss = jnp.exp(-r_use[None, :] ** 2 / (2 * sig ** 2)) \
            / (2 * jnp.pi * sig ** 2) ** 1.5
        return f_cen * M_use[:, None] * gauss


class BoundGas(MeadProfiles):
    """Komatsu-Seljak-like [ln(1+x)/x]^(1/(Gamma-1)) truncated at R,
    per-halo normalization, MODIFIED concentration
    (reference Mead20.py:398-485)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        z = 1 / a - 1
        c = self._get_concentration(cosmo, M_use, a)
        c = self._modify_concentration(cosmo, c, M_use, a)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        r_s = (R / c)[:, None]
        Geff = self.Gamma + self.nu_Gamma * z
        if isinstance(Geff, float) and Geff - 1 < 0.01:
            warnings.warn(f"Gamma = {Geff:0.4f} too close to 1")
        f_bnd = self._get_gas_frac(M_use, a, cosmo)[0][:, None]

        t = jnp.linspace(0.0, 1.0, self.r_steps)
        r_int = jnp.exp(jnp.log(self.r_min_int)
                        + (jnp.log(R)[:, None]
                           - jnp.log(self.r_min_int)) * t[None, :])
        x_i = r_int / r_s
        shape_i = (jnp.log(1 + x_i) / x_i) ** (1 / (Geff - 1))
        norm = jnp.trapezoid(4 * jnp.pi * r_int ** 2 * shape_i, r_int,
                             axis=-1)[:, None]

        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        x = r_use[None, :] / r_s
        prof = (jnp.log(1 + x) / x) ** (1 / (Geff - 1))
        prof = jnp.where(r_use[None, :] <= R[:, None], prof, 0.0)
        return prof * f_bnd * M_use[:, None] / norm * kfac


class EjectedGas(MeadProfiles):
    """Gaussian ejected gas; R_ej solved from the Maxwellian escape
    condition via a vmapped root-find (reference Mead20.py:488-558)."""

    def _r_ej(self, cosmo, M_use, a):
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        fb = _f_bar(cosmo)
        f_ej = self._get_gas_frac(M_use, a, cosmo)[1][:, None]
        R_esc = 0.5 * jnp.sqrt(200.0) * R[:, None]
        rgrid = jnp.geomspace(self.r_min_int, self.r_max_int, self.r_steps)
        arg = self.eta_b * R_esc / rgrid[None, :]
        term1 = 1 - jax.scipy.special.erf(arg / jnp.sqrt(2.0))
        term2 = jnp.sqrt(2 / jnp.pi) * arg * jnp.exp(-arg ** 2 / 2)
        diff = term1 + term2 - f_ej / fb
        ln_Rej = jax.vmap(lambda row: safe_Pchip_minimize(
            row, jnp.log(rgrid)))(diff)
        R_ej = jnp.exp(ln_Rej)[:, None]
        return jnp.where(f_ej > 0, R_ej, jnp.inf), f_ej

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        R_ej, f_ej = self._r_ej(cosmo, M_use, a)
        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        return (f_ej * M_use[:, None] / (2 * jnp.pi * R_ej ** 2) ** 1.5
                * jnp.exp(-(r_use[None, :] / R_ej) ** 2 / 2) * kfac)


class Gas(MeadProfiles):
    """BoundGas + EjectedGas composite (reference Mead20.py:561-616)."""

    def __init__(self, **kwargs):
        self.myprof = BoundGas(**kwargs) + EjectedGas(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return self.myprof._real(cosmo, r_use, M_use, a)


class GasAddDiffuse(MeadProfiles):
    """Bound gas + ejected gas as a CONSTANT in Fourier space:
    fourier = BG.fourier + f_ej M (reference Mead20.py:561-616)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.BG = BoundGas(**kwargs)

    def _fourier(self, cosmo, k, M, a):
        k_use, M_use = _atleast_1d_pair(k, M)
        f_ej = self._get_gas_frac(M_use, a, cosmo)[1][:, None]
        return (jnp.atleast_2d(self.BG.fourier(cosmo, k_use, M_use, a))
                + f_ej * M_use[:, None])

    def _real(self, cosmo, r, M, a):
        # real-space view: bound gas + uniform diffuse background is not
        # well defined as a 1-halo profile; mirror the bound part
        r_use, M_use = _atleast_1d_pair(r, M)
        return self.BG._real(cosmo, r_use, M_use, a)


class CollisionlessMatter(MeadProfiles):
    """NFW with MODIFIED concentration rescaled by (1 - f_bar); no
    relaxation iteration in HMx (reference Mead20.py:618-699)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        c = self._get_concentration(cosmo, M_use, a)
        c = self._modify_concentration(cosmo, c, M_use, a)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        r_s = R / c
        rho_c = M_use / (4 * jnp.pi * r_s ** 3 * _massdef.nfw_mu(c))
        rho_c = (rho_c * (1 - _f_bar(cosmo)))[:, None]
        r_s = r_s[:, None]
        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        prof = rho_c / (r_use[None, :] / r_s
                        * (1 + r_use[None, :] / r_s) ** 2) * kfac
        return jnp.where(r_use[None, :] <= R[:, None], prof, 0.0)


class DarkMatterOnly(DarkMatter):
    """= DarkMatter (reference Mead20.py:702)."""


class DarkMatterBaryon(MeadProfiles):
    """CLM + Stars + Gas with TwoHalo = Zeros (reference Mead20.py:705)."""

    def __init__(self, gas=None, stars=None, collisionlessmatter=None,
                 darkmatter=None, **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.TwoHalo = Zeros()
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.CollisionlessMatter = (collisionlessmatter
                                    if collisionlessmatter is not None
                                    else CollisionlessMatter(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return (self.CollisionlessMatter._real(cosmo, r_use, M_use, a)
                + self.Stars._real(cosmo, r_use, M_use, a)
                + self.Gas._real(cosmo, r_use, M_use, a))


class DarkMatterBaryonAddDiffuse(DarkMatterBaryon):
    """Fourier-space composite with the diffuse ejected-gas constant
    (reference Mead20.py:760-871)."""

    def __init__(self, gas=None, **kwargs):
        gas = gas if gas is not None else GasAddDiffuse(**kwargs)
        super().__init__(gas=gas, **kwargs)

    def _fourier(self, cosmo, k, M, a):
        k_use, M_use = _atleast_1d_pair(k, M)
        out = (jnp.atleast_2d(self.CollisionlessMatter.fourier(
                   cosmo, k_use, M_use, a))
               + jnp.atleast_2d(self.Stars.myprof.fourier(
                   cosmo, k_use, M_use, a))
               + jnp.atleast_2d(self.Gas._fourier(cosmo, k_use, M_use, a)))
        return out


class DarkMatterOnlywithLSS(MeadProfiles):
    """DarkMatter + TwoHalo."""

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
    """DMB + TwoHalo."""

    def __init__(self, twohalo=None, **kwargs):
        super().__init__(**kwargs)
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return (super()._real(cosmo, r_use, M_use, a)
                + self.TwoHalo._real(cosmo, r_use, M_use, a))


class Temperature(MeadProfiles):
    """T0 ln(1+x)/x with T0 = alpha E0/(3/2 k_B), E0 = G M mu m_p/(a R)
    (reference Mead20.py:874-946)."""

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        c = self._get_concentration(cosmo, M_use, a)
        c = self._modify_concentration(cosmo, c, M_use, a)
        R = self.mass_def.get_radius(cosmo, M_use, a) / a
        r_s = (R / c)[:, None]
        # E0 [erg] = G M mu m_p / (a R):  G M / R is Mpc^2/s^2 (G in
        # Mpc^3 Msun^-1 s^-2, M in Msun) -> cm^2/s^2 via Mpc_to_cm^2,
        # times mu m_p [g]
        E0 = (const.G * M_use / (a * R)) * const.Mpc_to_cm ** 2 \
            * (const.M_PROTON_CGS * self.mean_molecular_weight)
        T0 = self.alpha * E0 / (1.5 * const.K_BOLTZ_CGS)
        x = r_use[None, :] / r_s
        return T0[:, None] * jnp.log(1 + x) / x

    def projected(self, cosmo, r, M, a, **kw):
        # LOS-averaged: divide by 2 r_max (reference Mead20.py:940-946)
        r_max = self.padding_hi_proj * float(np.max(np.asarray(r)))
        if self.proj_cutoff is not None:
            r_max = self.proj_cutoff
        return super().projected(cosmo, r, M, a, **kw) / (2 * r_max)


class Pressure(MeadProfiles):
    """P = n_bnd T_bnd k_B + n_ej T_w e^(nu_Tw z) k_B
    (reference Mead20.py:950-1026)."""

    def __init__(self, boundgas=None, ejectedgas=None, temperature=None,
                 **kwargs):
        self.BoundGas = (boundgas if boundgas is not None
                         else BoundGas(**kwargs))
        self.EjectedGas = (ejectedgas if ejectedgas is not None
                           else EjectedGas(**kwargs))
        self.Temperature = (temperature if temperature is not None
                            else Temperature(**kwargs))
        super().__init__(**kwargs)

    def _n_cgs(self, rho):
        return rho * const.Msun_to_g / const.Mpc_to_cm ** 3 \
            / (self.mean_molecular_weight * const.M_PROTON_CGS)

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        z = 1 / a - 1
        T = self.Temperature._real(cosmo, r_use, M_use, a)
        n = self._n_cgs(self.BoundGas._real(cosmo, r_use, M_use, a))
        P1 = T * n * const.K_BOLTZ_CGS
        T_w = self.T_w * jnp.exp(self.nu_T_w * z)
        n2 = self._n_cgs(self.EjectedGas._real(cosmo, r_use, M_use, a))
        return P1 + T_w * n2 * const.K_BOLTZ_CGS


class PressureAddDiffuse(MeadProfiles):
    """Fourier-space pressure with the diffuse ejected term
    (reference Mead20.py:1029-1115)."""

    def __init__(self, pressure=None, **kwargs):
        self.Pressure = (pressure if pressure is not None
                         else Pressure(**kwargs, ejectedgas=Zeros()))
        if not isinstance(self.Pressure.EjectedGas, Zeros):
            warnings.warn("PressureAddDiffuse expects ejectedgas=Zeros() "
                          "to avoid double counting")
        super().__init__(**kwargs)

    def _fourier(self, cosmo, k, M, a):
        k_use, M_use = _atleast_1d_pair(k, M)
        z = 1 / a - 1
        P1 = jnp.atleast_2d(self.Pressure.fourier(cosmo, k_use, M_use, a))
        f_ej = self._get_gas_frac(M_use, a, cosmo)[1][:, None]
        T = self.T_w * jnp.exp(self.nu_T_w * z)
        n = (f_ej * M_use[:, None] * const.Msun_to_g
             / const.Mpc_to_cm ** 3
             / (self.mean_molecular_weight * const.M_PROTON_CGS))
        return P1 + T * n * const.K_BOLTZ_CGS

    def _real(self, cosmo, r, M, a):
        r_use, M_use = _atleast_1d_pair(r, M)
        return self.Pressure._real(cosmo, r_use, M_use, a)


# ---------------------------------------------------------------------------
# HMx T_AGN calibration dicts (Msun/h -> Msun at h = 0.7); calibration DATA
# reproduced from reference Mead20.py:1118-1196.
# ---------------------------------------------------------------------------
Params_TAGN_7p6_All = {'A_star': 0.0346, 'nu_A_star': -0.0092, 'M_star': 10 ** 12.5506 / 0.7, 'nu_M_star': -0.4615, 'eta': -0.497, 'eps1': 0.4021, 'nu_eps1': 0.0435, 'Gamma': 1.2763, 'nu_Gamma': -0.0554, 'M_0': 10 ** 13.0978 / 0.7, 'T_w': 10 ** 6.6762, 'nu_T_w': -0.5566, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 1}
Params_TAGN_7p8_All = {'A_star': 0.0342, 'nu_A_star': -0.0105, 'M_star': 10 ** 12.3715 / 0.7, 'nu_M_star': 0.0149, 'eta': -0.4052, 'eps1': 0.1236, 'nu_eps1': -0.0187, 'Gamma': 1.2956, 'nu_Gamma': -0.0937, 'M_0': 10 ** 13.4854 / 0.7, 'T_w': 10 ** 6.6545, 'nu_T_w': -0.3652, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 1}
Params_TAGN_8p0_All = {'A_star': 0.0321, 'nu_A_star': -0.0094, 'M_star': 10 ** 12.3032 / 0.7, 'nu_M_star': -0.0817, 'eta': -0.3443, 'eps1': -0.1158, 'nu_eps1': 0.1408, 'Gamma': 1.2861, 'nu_Gamma': -0.1382, 'M_0': 10 ** 14.1254 / 0.7, 'T_w': 10 ** 6.6615, 'nu_T_w': -0.0617, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 1}
Params_TAGN_7p6_MPr = {'A_star': 0.0348, 'nu_A_star': -0.0093, 'M_star': 10 ** 12.462 / 0.7, 'nu_M_star': -0.3664, 'eta': -0.3428, 'eps1': -0.10017, 'nu_eps1': -0.04559, 'Gamma': 1.16468, 'nu_Gamma': 0.0, 'M_0': 10 ** 13.19486 / 0.7, 'T_w': 10 ** 6.67618, 'nu_T_w': -0.55659, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 0.7642}
Params_TAGN_7p8_MPr = {'A_star': 0.033, 'nu_A_star': -0.0088, 'M_star': 10 ** 12.4479 / 0.7, 'nu_M_star': -0.3521, 'eta': -0.3556, 'eps1': -0.1065, 'nu_eps1': -0.1073, 'Gamma': 1.17702, 'nu_Gamma': 0.0, 'M_0': 10 ** 13.59369 / 0.7, 'T_w': 10 ** 6.65445, 'nu_T_w': -0.36515, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 0.8471}
Params_TAGN_8p0_MPr = {'A_star': 0.0309, 'nu_A_star': -0.0082, 'M_star': 10 ** 12.3923 / 0.7, 'nu_M_star': -0.3073, 'eta': -0.3505, 'eps1': -0.12533, 'nu_eps1': -0.01107, 'Gamma': 1.19657, 'nu_Gamma': 0.0, 'M_0': 10 ** 14.24798 / 0.7, 'T_w': 10 ** 6.66146, 'nu_T_w': -0.06167, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 1.0314}


def Tagn2pars(Tagn, mode='All'):
    """Linear / log-linear interpolation of the HMx calibrations in T_AGN
    (reference Mead20.py:1199-1218)."""
    assert isinstance(Tagn, (float, int)), "T_agn must be a number"
    Tagn_calib = np.array([7.6, 7.8, 8.0])
    log_keys = ['M_0', 'M_star', 'T_w']
    if mode == 'All':
        pars = [Params_TAGN_7p6_All, Params_TAGN_7p8_All,
                Params_TAGN_8p0_All]
    elif mode == 'MatterPressure':
        pars = [Params_TAGN_7p6_MPr, Params_TAGN_7p8_MPr,
                Params_TAGN_8p0_MPr]
    else:
        raise NotImplementedError(f"mode = {mode}: use 'All' or "
                                  "'MatterPressure'")
    out = {}
    for k in pars[0]:
        vals = np.array([p[k] for p in pars], dtype=float)
        if k in log_keys:
            vals = np.log10(vals)
        # linear interp with extrapolation
        coef = np.polyfit(Tagn_calib, vals, 1) if Tagn < 7.6 or Tagn > 8.0 \
            else None
        if coef is not None:
            v = np.polyval(coef, Tagn)
        else:
            v = np.interp(Tagn, Tagn_calib, vals)
        out[k] = float(10 ** v) if k in log_keys else float(v)
    return out
