"""Henry's-law CO2 solubility with Sechenov salting-out correction.

Pure functions (jnp-traceable) so they can run inside jit-compiled time loops
— the 3D pore models re-evaluate the Sechenov-corrected CO2 Dirichlet value
every time step from the median ion concentrations (ref:
3D/MPNP_CO2ER_pore.py:70-93,815-838), which in this framework happens inside a
``lax.scan`` without host round-trips.

Physics (ref: 3D/MPNP_CO2ER_pore.py:70-93 and utilities/bulk_soln.py:32-54):
    ln K_H = 93.4517*(100/T) - 60.2409 + 23.3585*ln(T/100)
    h_CO2(T) = h_CO2_0 + h_CO2_T*(T - 298.15)
    log10([CO2]/[CO2]_0) = -sum_i (h_ion_i + h_CO2) * c_i[kmol/m^3]
    [CO2]_sat = f_CO2 * K_H * 1000 * 10^(-sechenov)   (mol/m^3)
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import jax.numpy as jnp
import numpy as np

from gmpnp.constants import (
    DEFAULT_PARAMS,
    ParameterSet,
)

Scalar = Union[float, jnp.ndarray]


def _xp(*values):
    """numpy for concrete host values, jnp for traced/device values.

    Host-side callers (model builds, the bulk equilibrator) stay on the
    host — a device round trip for a scalar costs more than the whole
    computation; in-scan callers pass tracers and get jnp."""
    import jax

    for v in values:
        if isinstance(v, jax.core.Tracer) or isinstance(v, jnp.ndarray):
            return jnp
    return np


def henry_K_CO2(temp: Scalar):
    """Henry's constant for CO2 (mol kg^-1 bar^-1 scale) as a function of T.

    [CO2]_aq,0 = K_H_CO2 * f_CO2.  ref: utilities/bulk_soln.py:40-41.
    """
    xp = _xp(temp)
    lnK = 93.4517 * (100.0 / temp) - 60.2409 + 23.3585 * xp.log(temp / 100.0)
    return xp.exp(lnK)


def co2_saturation_conc(
    temp: Scalar,
    fugacity_CO2: Scalar,
    conc_ions: Optional[Mapping[str, Scalar]] = None,
    params: ParameterSet = DEFAULT_PARAMS,
    h_sechenov: Optional[Mapping[str, float]] = None,
) -> jnp.ndarray:
    """Dissolved-CO2 saturation concentration in mol/m^3.

    Equivalent of the reference ``CO2_conc`` (utilities/bulk_soln.py:32-54,
    3D/MPNP_CO2ER_pore.py:70-93).

    Parameters
    ----------
    temp: temperature in K (may be traced).
    fugacity_CO2: CO2 fugacity in bar.
    conc_ions: mapping species-name -> concentration in mol/m^3 contributing
        to the salting-out sum.  Ions absent from the Sechenov table raise.
    h_sechenov: optional explicit Sechenov constants overriding the table
        (mapping name -> h_ion value, m^3/kmol).
    """
    if conc_ions is None:
        conc_ions = {}
    xp = _xp(temp, fugacity_CO2, *conc_ions.values())
    h_CO2 = params.sechenov_CO2_0 + params.sechenov_CO2_T * (temp - 298.15)

    sechenov = xp.asarray(0.0)
    for ion, conc in conc_ions.items():
        h_ion = (h_sechenov[ion] if h_sechenov is not None
                 else params.sechenov_ion[ion])
        # concentrations enter in kmol/m^3
        sechenov = sechenov + (h_ion + h_CO2) * (conc / 1000.0)

    K_H = henry_K_CO2(temp)
    return fugacity_CO2 * K_H * 1000.0 * 10.0 ** (-sechenov)


def equilibrium_gas_conc(
    gas: str,
    press_gas: Scalar,
    y_gas: Scalar,
    params: ParameterSet = DEFAULT_PARAMS,
) -> jnp.ndarray:
    """Equilibrium dissolved-gas concentration at a gas/electrolyte interface
    via the constant Henry coefficients table (mol/m^3).

    eq_conc = H_gas * P * y_gas * density_water.  ref: 3D/MPNP_CO2ER_pore.py:253-255.
    """
    H = params.henry_const[gas]
    return jnp.asarray(H * press_gas * y_gas * params.sys_params.density_e)
