"""Equation of state rho(S, T, p) following Jackett et al. (2006); a frozen
copy of the port's `core/eos.py` for the plain reference.

The 25-term rational polynomial of Jackett et al. (2006) (the one used by
SLIM / Thetis), and a cheap linear EOS.  rho' = rho - rho0 is the density
anomaly used by the internal pressure gradient r (paper eq. 8).
"""
from __future__ import annotations

import torch

RHO0 = 1025.0

# Jackett et al. (2006) coefficients (Table A1; rho in kg/m^3, T in deg C,
# S in psu, p in dbar).
_N0 = 9.9984085444849347e2
_N1 = 7.3471625860981584e0
_N2 = -5.3211231792841769e-2
_N3 = 3.6492439109814549e-4
_N4 = 2.5880571023991390e0
_N5 = -6.7168282786692355e-3
_N6 = 1.9203202055760151e-3
_N7 = 1.1798263740430364e-2
_N8 = 9.8920219266399117e-8
_N9 = 4.6996642771754730e-6
_N10 = -2.5862187075154352e-8
_N11 = -3.2921414007960662e-12

_D0 = 1.0
_D1 = 7.2815210113327091e-3
_D2 = -4.4787265461983921e-5
_D3 = 3.3851002965802430e-7
_D4 = 1.3651202389758572e-10
_D5 = 1.7632126669040377e-3
_D6 = -8.8066583251206474e-6
_D7 = -1.8832689434804897e-10
_D8 = 5.7463776745432097e-6
_D9 = 1.4716275472242334e-9
_D10 = 6.7103246285651894e-6
_D11 = -2.4461698007024582e-17
_D12 = -9.1534417604289062e-18


def rho_jackett(S: torch.Tensor, T: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
    """In-situ density (kg/m^3). p in dbar (~ depth in m)."""
    T2 = T * T
    sqrtS = torch.sqrt(torch.clamp(S, min=0.0))
    num = (_N0 + T * (_N1 + T * (_N2 + _N3 * T))
           + S * (_N4 + _N5 * T + _N6 * S)
           + p * (_N7 + _N8 * T2 + _N9 * S + p * (_N10 + _N11 * T2)))
    den = (_D0 + T * (_D1 + T * (_D2 + T * (_D3 + _D4 * T)))
           + S * (_D5 + T * (_D6 + _D7 * T2) + sqrtS * (_D8 + _D9 * T2))
           + p * (_D10 + p * T * (_D11 * T2 + _D12 * p)))
    return num / den


def rho_linear(S, T, p=None, *, alpha=0.2, beta=0.78, T0=10.0, S0=35.0):
    """Linear EOS: rho = rho0 - alpha (T-T0) + beta (S-S0)."""
    return RHO0 - alpha * (T - T0) + beta * (S - S0)


def rho_prime(S, T, p, kind: str = "jackett"):
    """Density anomaly rho' = rho - rho0."""
    if kind == "jackett":
        return rho_jackett(S, T, p) - RHO0
    elif kind == "linear":
        return rho_linear(S, T, p) - RHO0
    else:
        raise ValueError(kind)
