"""Chemistry layer tests: Henry/Sechenov, buffer rates, bulk equilibration.

The acceptance oracle for `equilibrate_electrolyte` is the set of
``bulk_soln_*KHCO3.yaml`` files shipped with the reference — our two-stage
integration must reproduce their values.
"""

import numpy as np
import pytest

from gmpnp.chem import (
    buffer_rates,
    co2_saturation_conc,
    equilibrate_electrolyte,
)
from gmpnp.chem.bulk import load_bulk_yaml
from gmpnp.chem.reactions import BufferKinetics
from gmpnp.constants import DEFAULT_PARAMS, DIFF_COEF, RateConstants


def test_henry_co2_no_ions():
    # hand-computed: lnK = 93.4517*(100/298.15) - 60.2409 + 23.3585*ln(2.9815)
    T = 298.15
    lnK = 93.4517 * (100 / T) - 60.2409 + 23.3585 * np.log(T / 100)
    expected = 1.0 * np.exp(lnK) * 1000.0
    got = float(co2_saturation_conc(T, 1.0))
    assert got == pytest.approx(expected, rel=1e-12)
    # physically ~34 mol/m^3 at 1 bar, 298 K
    assert 30.0 < got < 40.0


def test_sechenov_salting_out_reduces_solubility():
    T = 298.15
    base = float(co2_saturation_conc(T, 1.0))
    salted = float(co2_saturation_conc(
        T, 1.0, {"K": 1000.0, "HCO3": 1000.0}))
    assert salted < base
    # K+HCO3 at 1 kmol/m3: sechenov = (0.0922-0.0172) + (0.0967-0.0172) = 0.1545
    assert salted == pytest.approx(base * 10 ** (-0.1545), rel=1e-12)


def test_buffer_rates_match_reference_expressions():
    """R_i must equal the expressions at 1D/MPNP_CO2ER_EDL.py:383-410."""
    rng = np.random.default_rng(0)
    species = ("H", "OH", "HCO3", "CO32", "CO2", "K")
    c0 = {"H": 1.4e-4, "OH": 7.1e-5, "CO2": 34.06, "HCO3": 99.92,
          "CO32": 0.03994, "K": 100.0}
    L = 50e-6
    k = RateConstants()
    kin = BufferKinetics.build(species, c0, DIFF_COEF, L, k)
    u = rng.uniform(0.5, 2.0, size=(7, len(species)))
    R = np.asarray(kin(u))

    sr = {s: L**2 / (DIFF_COEF[s] * c0[s]) for s in species}
    uH, uOH, uHCO3, uCO32, uCO2 = (u[:, i] for i in range(5))
    # verbatim structure of the reference expressions
    R_H = -sr["H"] * (k.kw2 * (uH * c0["H"]) * (uOH * c0["OH"]) - k.kw1)
    R_OH = -sr["OH"] * (
        k.kw2 * (uH * c0["H"]) * (uOH * c0["OH"])
        + k.ka1 * (uOH * c0["OH"]) * (uHCO3 * c0["HCO3"])
        + k.kb1 * (uCO2 * c0["CO2"]) * (uOH * c0["OH"])
        - k.kw1 - k.ka2 * (uCO32 * c0["CO32"]) - k.kb2 * (uHCO3 * c0["HCO3"]))
    R_HCO3 = -sr["HCO3"] * (
        k.ka1 * (uOH * c0["OH"]) * (uHCO3 * c0["HCO3"])
        + k.kb2 * (uHCO3 * c0["HCO3"])
        - k.ka2 * (uCO32 * c0["CO32"])
        - k.kb1 * (uCO2 * c0["CO2"]) * (uOH * c0["OH"]))
    R_CO32 = -sr["CO32"] * (
        k.ka2 * (uCO32 * c0["CO32"])
        - k.ka1 * (uOH * c0["OH"]) * (uHCO3 * c0["HCO3"]))
    R_CO2 = -sr["CO2"] * (
        k.kb1 * (uCO2 * c0["CO2"]) * (uOH * c0["OH"])
        - k.kb2 * (uHCO3 * c0["HCO3"]))

    np.testing.assert_allclose(R[:, 0], R_H, rtol=1e-13)
    np.testing.assert_allclose(R[:, 1], R_OH, rtol=1e-13)
    np.testing.assert_allclose(R[:, 2], R_HCO3, rtol=1e-13)
    np.testing.assert_allclose(R[:, 3], R_CO32, rtol=1e-13)
    np.testing.assert_allclose(R[:, 4], R_CO2, rtol=1e-13)
    np.testing.assert_allclose(R[:, 5], 0.0, atol=0)


def test_carbon_conservation_in_0d_kinetics():
    from gmpnp.chem.reactions import kinetics_0d
    import jax.numpy as jnp

    y = jnp.array([97.0, 0.002, 1.1, 1.2])
    dy = kinetics_0d(y, RateConstants())
    # carbon: HCO3 + CO32 + CO2 conserved; second invariant HCO3 + OH + 2*CO32
    assert float(dy[0] + dy[2] + dy[3]) == pytest.approx(0.0, abs=1e-8)
    assert float(dy[0] + dy[1] + 2 * dy[2]) == pytest.approx(0.0, abs=1e-8)


@pytest.mark.parametrize("conc", [0.1, 0.5, 1.0])
def test_equilibrate_matches_reference_yaml(reference_utilities, conc):
    ref = load_bulk_yaml(str(reference_utilities / f"bulk_soln_{conc}KHCO3.yaml"))
    got = equilibrate_electrolyte(conc=conc, electrolyte="KHCO3")

    # stage-2 (post-CO2) values seed the 1D solvers — require tight agreement
    for sp in ("OH", "HCO3", "CO32", "CO2", "H"):
        assert got.post_CO2[sp] == pytest.approx(ref.post_CO2[sp], rel=2e-3), sp
    assert got.post_pH == pytest.approx(ref.post_pH, abs=1e-3)

    # stage-1 (pre-CO2) values seed the 3D solvers
    for sp in ("OH", "HCO3", "CO32", "CO2", "H"):
        assert got.pre_CO2[sp] == pytest.approx(ref.pre_CO2[sp], rel=2e-3), sp
    assert got.pre_pH == pytest.approx(ref.pre_pH, abs=1e-3)


def test_bulk_yaml_roundtrip(tmp_path):
    from gmpnp.chem.bulk import write_bulk_yaml

    sol = equilibrate_electrolyte(conc=0.1)
    p = tmp_path / "bulk_soln_0.1KHCO3.yaml"
    write_bulk_yaml(sol, str(p))
    back = load_bulk_yaml(str(p))
    assert back.post_CO2 == pytest.approx(sol.post_CO2)
    assert back.pre_pH == pytest.approx(sol.pre_pH)
