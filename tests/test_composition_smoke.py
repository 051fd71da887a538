"""Wide-range smoke + shape contracts + profile-algebra identity
(reference tests/test_profiles_{dm,gas,star}.py, test_profile_composition.py,
test_twohalo_profiles.py, test_CLM_profiles.py, test_matter_profiles.py).

The reference smoke-tests every family over a in {0.1, 0.5, 1},
R in [1e-3, 1e3], M in [1e11, 1e16] and asserts output-dim contracts; its
composition test checks DMB - TwoHalo == DMB(twohalo=Zeros).
"""

import numpy as np
import pytest

from baryonforge_tpu import Profiles
from defaults import COSMO, bpar_S19

M = np.geomspace(1e11, 1e16, 4)
R = np.geomspace(1e-3, 1e3, 8)
K = np.geomspace(1e-3, 1e2, 8)

A20 = dict(cdelta=4, alpha_g=2, epsilon_h=0.015, M1_0=2.2e11 / 0.7,
           alpha_fsat=1, M1_fsat=1, delta_fsat=1, gamma_fsat=1,
           eps_fsat=1, M_c=1.2e14 / 0.7, eta=0.6, mu=0.31, beta=0.6,
           epsilon_hydro=np.sqrt(5), M_inn=3.3e13 / 0.7, M_r=1e16,
           beta_r=2, theta_inn=0.1, theta_out=3, theta_rg=0.3,
           sigma_rg=0.1, a=0.3, n=2, p=0.3, q=0.707,
           A_nt=0.495, alpha_nt=0.1, mean_molecular_weight=0.59)
S25 = dict(epsilon0=4, epsilon1=0.5, alpha_excl=0.4, p=0.3, q=0.707,
           M_c=1e15, mu=0.8, q0=0.075, q1=0.25, q2=0.7, nu_q0=0, nu_q1=1,
           nu_q2=0, nstep=1.5, theta_c=0.3, nu_theta_c=0.5, c_iga=0.1,
           nu_c_iga=1.5, r_min_iga=1e-3, alpha=1, gamma=1.5, delta=7,
           tau=-1.376, tau_delta=0, Mstar=3e11, Nstar=0.03, eta=0.1,
           eta_delta=0.22, epsilon_cga=0.03)


@pytest.mark.parametrize("prof", [
    Profiles.DarkMatter(**bpar_S19),
    Profiles.Gas(**bpar_S19),
    Profiles.Stars(**bpar_S19),
    Profiles.Arico20.Gas(**A20),
    Profiles.Arico20.Stars(**A20),
    Profiles.Arico20.DarkMatter(**A20),
    Profiles.Mead20.Gas(**Profiles.Mead20.Params_TAGN_7p8_All),
    Profiles.Mead20.Stars(**Profiles.Mead20.Params_TAGN_7p8_All),
    Profiles.Schneider25.HotGas(**S25),
    Profiles.Schneider25.Stars(**S25),
], ids=lambda p: type(p).__module__.split(".")[-1] + "." + type(p).__name__)
def test_wide_range_smoke(prof):
    for a in (0.1, 0.5, 1.0):
        x = np.asarray(prof.real(COSMO, R, M, a))
        assert x.shape == (len(M), len(R))
        assert np.isfinite(x).all()
    # dim contracts (reference test_profiles_gas.py:20-21)
    x = np.asarray(prof.real(COSMO, R, M[0], 0.5))
    assert x.shape == (len(R),)
    x = np.asarray(prof.real(COSMO, R[0], M[0], 0.5))
    assert x.shape == ()


def test_projected_fourier_smoke():
    for prof in (Profiles.Gas(**bpar_S19, proj_cutoff=100),
                 Profiles.Arico20.BoundGas(**A20, proj_cutoff=100)):
        p = np.asarray(prof.projected(COSMO, np.geomspace(0.01, 50, 6),
                                      M[-2], 0.5))
        assert np.isfinite(p).all() and (p > 0).any()
        f = np.asarray(prof.fourier(COSMO, K, M[-2], 0.5))
        assert np.isfinite(f).all()


def test_composition_identity():
    # DMB - TwoHalo == DMB(twohalo=Zeros) wherever the profile is not in
    # the hard exp-cutoff tail (the reference's rtol=1e-6/atol=inf check
    # is vacuous; we bound the relative error on the meaningful range)
    DMB = Profiles.DarkMatterBaryon(**bpar_S19)
    THL = Profiles.TwoHalo(**bpar_S19)
    MOD = Profiles.DarkMatterBaryon(**bpar_S19, twohalo=Profiles.Zeros())
    for a in (0.5, 1.0):
        A = np.asarray((DMB - THL).real(COSMO, R, M, a))
        B = np.asarray(MOD.real(COSMO, R, M, a))
        sel = np.abs(A) > 1e-8 * np.abs(A).max(axis=1, keepdims=True)
        np.testing.assert_allclose(B[sel], A[sel], rtol=1e-6)


def test_combined_fft_precision():
    # operator algebra must MERGE the operands' FFTLog precision
    # (reference utils/misc.py:68-126 + _fft_precision_logic at 261-336):
    # Stars demands padding 1e-5/1e5 against ringing, so adding an inert
    # Zeros() must not knock fourier() back to default padding
    from baryonforge_tpu.utils.misc import combine_fftpars

    S = Profiles.Stars(**bpar_S19)
    Z = Profiles.Zeros()
    comb = S + Z
    merged = combine_fftpars(S.precision_fftlog, Z.precision_fftlog)
    assert comb.precision_fftlog == merged
    assert comb.precision_fftlog["padding_lo_fftlog"] == \
        S.precision_fftlog["padding_lo_fftlog"]

    want = np.asarray(S.fourier(COSMO, K, M[-2], 0.5))
    got = np.asarray(comb.fourier(COSMO, K, M[-2], 0.5))
    np.testing.assert_allclose(got, want, rtol=1e-10)

    # update_precision_fftlog propagates into operands
    comb.update_precision_fftlog(n_per_decade=128)
    assert S.precision_fftlog["n_per_decade"] == 128


def test_twohalo_limits():
    # 2-halo term approaches mean matter density at large r
    from baryonforge_tpu.cosmo import core
    th = Profiles.TwoHalo(**bpar_S19)
    a = 0.5
    rho_m = float(core.rho_x(COSMO, a, "matter", is_comoving=True))
    v = np.asarray(th.real(COSMO, np.array([300.0]), 1e14, a)).ravel()
    np.testing.assert_allclose(v[0], rho_m, rtol=0.05)


def test_combined_hyper_params_take_superset():
    """Profile algebra merges integration knobs per the min/max table
    (reference utils/misc.py:261-336 policy): the combined profile's
    grid must cover BOTH operands' requirements, not silently keep
    operand A's."""
    A = Profiles.Gas(**bpar_S19, r_steps=100, r_min_int=1e-5,
                     r_max_int=100.0, n_per_decade_proj=8)
    B = Profiles.Stars(**bpar_S19, r_steps=400, r_min_int=1e-7,
                       r_max_int=500.0, n_per_decade_proj=16)
    C = A + B
    assert C.r_steps == 400
    assert C.r_min_int == 1e-7
    assert C.r_max_int == 500.0
    assert C.n_per_decade_proj == 16
    # reflected order takes the same superset
    D = B + A
    assert (D.r_steps, D.r_min_int, D.r_max_int) == (400, 1e-7, 500.0)
