"""Electrolyte chemistry: buffer kinetics, gas solubility, bulk equilibration."""

from gmpnp.chem.henry import co2_saturation_conc, henry_K_CO2
from gmpnp.chem.reactions import buffer_rates, BufferKinetics
from gmpnp.chem.bulk import equilibrate_electrolyte, BulkSolution

__all__ = [
    "co2_saturation_conc",
    "henry_K_CO2",
    "buffer_rates",
    "BufferKinetics",
    "equilibrate_electrolyte",
    "BulkSolution",
]
