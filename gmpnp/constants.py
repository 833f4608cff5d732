"""Physical constants and species parameter database.

Re-provides the content of the reference parameter stores
(``utilities/parameters.yaml`` and ``utilities/parameters_pore.yaml`` in
divyabohra/GMPNP) as typed Python structures, and a loader for user-supplied
YAML files that follow the same schema (``rate_constants``, ``diff_coef``,
``solv_size``, ``nat_const``, ``sechonov_const``, ``Henrys_const``,
``Hydration_number``, ``sys_params`` sections).

All values are SI unless noted.  Literature provenance as in the reference:
rate constants for the bicarbonate buffer system, diffusion coefficients and
solvated diameters from Marcus / d'Entremont, Sechenov constants from
Weisenberger & Schumpe.

Reference citations: utilities/parameters.yaml:1-66,
utilities/parameters_pore.yaml:1-87.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional


# ---------------------------------------------------------------------------
# Rate constants of the homogeneous buffer reactions
#     H2O        <=> H+ + OH-        (kw1 forward, kw2 backward)
#     HCO3- + OH- <=> CO32- + H2O    (ka1 forward, ka2 backward)
#     CO2 + OH-   <=> HCO3-          (kb1 forward, kb2 backward)
# ref: utilities/parameters.yaml:1-7
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RateConstants:
    kw1: float = 2.4e-2   # mol m^-3 s^-1
    kw2: float = 2.4e6    # mol^-1 m^3 s^-1
    ka1: float = 6.0e6    # mol^-1 m^3 s^-1
    ka2: float = 1.07e6   # s^-1
    kb1: float = 2.23     # mol^-1 m^3 s^-1
    kb2: float = 5.23e-5  # s^-1


# ---------------------------------------------------------------------------
# Natural constants.  ref: utilities/parameters.yaml:33-41
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NaturalConstants:
    F: float = 9.6485e4        # Faraday, C mol^-1
    e_0: float = 1.602e-19     # elementary charge, C
    N_A: float = 6.022e23      # Avogadro, mol^-1
    k_B: float = 1.38e-23      # Boltzmann, J K^-1
    R: float = 8.314           # gas constant, J K^-1 mol^-1
    eps_0: float = 8.85e-12    # vacuum permittivity, F m^-1
    eps_rel: float = 80.1      # relative permittivity of bulk water
    T: float = 298.15          # default temperature, K

    @property
    def thermal_voltage(self) -> float:
        return self.k_B * self.T / self.e_0


# Diffusion coefficients, m^2 s^-1.  ref: utilities/parameters.yaml:9-19 and
# utilities/parameters_pore.yaml:9-21 (adds CO, H2).
DIFF_COEF: Dict[str, float] = {
    "H": 9.311e-9,
    "OH": 5.273e-9,
    "CO2": 1.91e-9,
    "CO": 2.03e-9,
    "H2": 4.5e-9,
    "HCO3": 1.185e-9,
    "CO32": 0.923e-9,
    "K": 1.957e-9,
    "Na": 1.334e-9,
    "Li": 1.029e-9,
    "Cs": 2.06e-9,
    "Cl": 2.032e-9,
}

# Solvated diameters, m.  ref: utilities/parameters.yaml:21-31 and
# utilities/parameters_pore.yaml:23-35 (adds CO, H2; no solvation for neutrals).
SOLV_SIZE: Dict[str, float] = {
    "H": 0.56e-9,
    "OH": 0.6e-9,
    "CO2": 0.23e-9,
    "HCO3": 0.8e-9,
    "CO32": 0.788e-9,
    "CO": 0.113e-9,
    "H2": 0.074e-9,
    "K": 0.662e-9,
    "Cs": 0.658e-9,
    "Na": 0.716e-9,
    "Li": 0.764e-9,
    "Cl": 0.664e-9,
}

# Ionic charge numbers.  ref: 1D/MPNP_CO2ER_EDL.py:158, 3D/MPNP_CO2ER_pore.py:233-234
CHARGE: Dict[str, int] = {
    "H": 1,
    "OH": -1,
    "HCO3": -1,
    "CO32": -2,
    "CO2": 0,
    "CO": 0,
    "H2": 0,
    "K": 1,
    "Na": 1,
    "Li": 1,
    "Cs": 1,
    "Cl": -1,
}

# Cation hydration numbers (waters immobilized per ion), dimensionless.
# ref: utilities/parameters_pore.yaml:67-72 and 1D/MPNP_CO2ER_EDL.py:106-115
HYDRATION_NUMBER: Dict[str, float] = {
    "H": 10.0,
    "K": 4.0,
    "Cs": 3.0,
    "Na": 5.0,
    "Li": 5.0,
}

# Sechenov ("salting-out") model constants, m^3 kmol^-1.
# ref: utilities/parameters.yaml:54-66
SECHENOV_ION: Dict[str, float] = {
    "Li": 0.0754,
    "Na": 0.1143,
    "K": 0.0922,
    "Cl": 0.0318,
    "OH": 0.0839,
    "HCO3": 0.0967,
    "CO32": 0.1423,
    "H2PO4": 0.0906,
    "HPO4": 0.1499,
    "PO4": 0.2119,
}
SECHENOV_CO2_0: float = -0.0172
SECHENOV_CO2_T: float = -0.000338

# Henry's-law constants, mol kg^-1 bar^-1.  ref: utilities/parameters_pore.yaml:62-65
HENRY_CONST: Dict[str, float] = {
    "CO2": 0.034,
    "CO": 0.00095,
    "H2": 0.00078,
}


# ---------------------------------------------------------------------------
# Flow-cell system parameters for the 3D pore models.
# ref: utilities/parameters_pore.yaml:46-60
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SystemParams:
    T: float = 298.15             # K
    P: float = 1.0                # gas-chamber pressure, bar
    density_CO2: float = 1.784    # kg m^-3 at 1 atm, 298 K
    density_CO: float = 1.145     # kg m^-3
    density_H2: float = 0.0813    # kg m^-3
    M_CO2: float = 44.01e-3       # kg mol^-1
    viscosity_CO2: float = 14.7e-11  # atm s
    density_e: float = 997.0      # water density, kg m^-3
    viscosity_e: float = 0.89e-3  # water viscosity, kg m^-1 s^-1
    L_electrode: float = 1.5e-2   # m
    A_electrode: float = 2.25e-4  # m^2
    vel_e: float = 0.25e-6        # electrolyte flow, m^3 s^-1
    A_cross_e: float = 1.5e-4     # m^2
    L_cross_e: float = 1.0e-2     # m


L_DIFF_DEFAULT: float = 2.0e-4  # default diffusion length, m (parameters.yaml:43)

# Default bulk concentrations for 0.1 M KHCO3 (pH 6.85), 1 atm CO2, mol m^-3.
# ref: utilities/parameters.yaml:45-52
BULK_CONC_DEFAULT: Dict[str, float] = {
    "H": 1.4e-4,
    "OH": 7.1e-5,
    "CO2": 32.9,
    "HCO3": 100.0,
    "CO32": 4.0e-2,
    "K": 100.04,
    "Cl": 0.0,
}


@dataclass(frozen=True)
class ParameterSet:
    """A full parameter database, equivalent in content to one of the
    reference ``parameters*.yaml`` files.  Fields default to the shipped
    reference values; any of them can be overridden from a YAML file with the
    reference schema via :func:`load_parameters`."""

    rate_constants: RateConstants = field(default_factory=RateConstants)
    nat_const: NaturalConstants = field(default_factory=NaturalConstants)
    sys_params: SystemParams = field(default_factory=SystemParams)
    diff_coef: Dict[str, float] = field(default_factory=lambda: dict(DIFF_COEF))
    solv_size: Dict[str, float] = field(default_factory=lambda: dict(SOLV_SIZE))
    charge: Dict[str, int] = field(default_factory=lambda: dict(CHARGE))
    hydration_number: Dict[str, float] = field(
        default_factory=lambda: dict(HYDRATION_NUMBER))
    sechenov_ion: Dict[str, float] = field(default_factory=lambda: dict(SECHENOV_ION))
    sechenov_CO2_0: float = SECHENOV_CO2_0
    sechenov_CO2_T: float = SECHENOV_CO2_T
    henry_const: Dict[str, float] = field(default_factory=lambda: dict(HENRY_CONST))
    bulk_conc_default: Dict[str, float] = field(
        default_factory=lambda: dict(BULK_CONC_DEFAULT))
    L_diff_default: float = L_DIFF_DEFAULT

    # -- convenience accessors ------------------------------------------------
    def D(self, sp: str) -> float:
        return self.diff_coef[sp]

    def a(self, sp: str) -> float:
        return self.solv_size[sp]

    def z(self, sp: str) -> int:
        return self.charge[sp]

    def h_ion(self, sp: str) -> float:
        return self.sechenov_ion[sp]

    def w(self, sp: str) -> float:
        return self.hydration_number[sp]


DEFAULT_PARAMS = ParameterSet()


def _strip_prefix(d: Dict[str, float], prefix: str) -> Dict[str, float]:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def load_parameters(path: Optional[str] = None) -> ParameterSet:
    """Build a :class:`ParameterSet`, optionally overriding defaults from a
    YAML file following the reference schema (keys ``D_<sp>``, ``a_<sp>``,
    ``h_ion_<sp>``, ``w_<sp>``, ``H_<sp>``, sections as in
    utilities/parameters_pore.yaml)."""
    if path is None:
        return DEFAULT_PARAMS

    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    kw: Dict[str, object] = {}

    if "rate_constants" in raw:
        kw["rate_constants"] = RateConstants(**raw["rate_constants"])
    if "nat_const" in raw:
        nat = dict(raw["nat_const"])
        # 1D-style files carry T in nat_const; pore-style files in sys_params.
        defaults = dataclasses.asdict(NaturalConstants())
        defaults.update({k: v for k, v in nat.items() if k in defaults})
        kw["nat_const"] = NaturalConstants(**defaults)
    if "sys_params" in raw:
        sys_defaults = dataclasses.asdict(SystemParams())
        sys_defaults.update(
            {k: v for k, v in raw["sys_params"].items() if k in sys_defaults})
        kw["sys_params"] = SystemParams(**sys_defaults)
    if "diff_coef" in raw:
        d = dict(DIFF_COEF)
        d.update(_strip_prefix(raw["diff_coef"], "D_"))
        kw["diff_coef"] = d
    if "solv_size" in raw:
        d = dict(SOLV_SIZE)
        d.update(_strip_prefix(raw["solv_size"], "a_"))
        kw["solv_size"] = d
    if "Hydration_number" in raw:
        d = dict(HYDRATION_NUMBER)
        d.update(_strip_prefix(raw["Hydration_number"], "w_"))
        kw["hydration_number"] = d
    if "sechonov_const" in raw:  # keep the reference's spelling of the section
        sec = raw["sechonov_const"]
        d = dict(SECHENOV_ION)
        d.update(_strip_prefix(sec, "h_ion_"))
        kw["sechenov_ion"] = d
        if "h_CO2_0" in sec:
            kw["sechenov_CO2_0"] = sec["h_CO2_0"]
        if "h_CO2_T" in sec:
            kw["sechenov_CO2_T"] = sec["h_CO2_T"]
    if "Henrys_const" in raw:
        d = dict(HENRY_CONST)
        d.update(_strip_prefix(raw["Henrys_const"], "H_"))
        kw["henry_const"] = d
    if "bulk_conc_default" in raw:
        d = dict(BULK_CONC_DEFAULT)
        d.update(_strip_prefix(raw["bulk_conc_default"], "C0_"))
        kw["bulk_conc_default"] = d
    if "L_diff_default" in raw:
        kw["L_diff_default"] = raw["L_diff_default"]

    return ParameterSet(**kw)
