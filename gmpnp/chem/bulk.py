"""Bulk-electrolyte equilibrium chemistry (offline 0D pre-processor).

Re-provides ``utilities/bulk_soln.py`` of the reference: given electrolyte
type and concentration, integrate the buffer kinetics to (near-)equilibrium in
two stages — (1) electrolyte alone, (2) CO2-saturated at constant [CO2] given
by Henry + Sechenov — and return/persist the bulk concentrations that seed
every solver.

The reference script integrates with scipy's LSODA to tmax = 10 s (stage 1)
and 1e3–5e4 s (stage 2) (utilities/bulk_soln.py:121-127,182-198).  The
*shipped* YAML pre-CO2 blocks, however, sit at the exact closed-system
equilibrium (unreachable in 10 s — the CO2<->HCO3- leg relaxes on ~2e4 s), so
stage 1 defaults to an algebraic equilibrium solve, with the script-faithful
10 s snapshot available as ``stage1_protocol="reference_script"``.  Stage 2
follows the reference integration protocol (its values are genuine tmax
snapshots, reproduced here to ~1e-4 relative).

This is a host-side pre-processor: scipy LSODA is the right tool for a stiff
4-species 0D ODE; the results feed the device solvers as constants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from gmpnp.constants import DEFAULT_PARAMS, ParameterSet
from gmpnp.chem.henry import co2_saturation_conc

_KW = 1.0e-14  # water autoprotolysis constant (mol/L)^2


@dataclass(frozen=True)
class BulkSolution:
    """Result of the two-stage equilibration.

    ``pre_CO2`` / ``post_CO2``: species -> mol/m^3 (keys C0-less names),
    with pH fields; mirrors the structure of the reference's
    ``bulk_soln_*.yaml`` (bulk_conc_pre_CO2 / bulk_conc_post_CO2 blocks).
    """

    electrolyte: str
    conc_molar: float
    CO2_pressure: float
    pre_CO2: Dict[str, float]
    pre_pH: float
    post_CO2: Dict[str, float]
    post_pH: float

    def concentrations(self, stage: str = "post") -> Dict[str, float]:
        return dict(self.post_CO2 if stage == "post" else self.pre_CO2)

    def to_yaml_dict(self) -> Dict:
        """Emit the reference-compatible YAML structure
        (ref: utilities/bulk_soln.py:149-172,208-211)."""
        def block(conc, pH, extra):
            d = {
                "conc_electrolyte": self.conc_molar,
                "electrolyte": self.electrolyte,
                "final_pH": pH,
                "concentrations": {f"C0_{k}": v for k, v in conc.items()},
            }
            d.update(extra)
            return d

        return {
            "bulk_conc_pre_CO2": block(self.pre_CO2, self.pre_pH, {}),
            "bulk_conc_post_CO2": block(
                self.post_CO2, self.post_pH, {"CO2_pressure": self.CO2_pressure}),
        }


def _initial_composition(electrolyte: str, conc: float) -> Dict[str, float]:
    """Initial dissolved-species composition in mol/m^3 for supported
    electrolytes (ref: utilities/bulk_soln.py:78-107)."""
    c = conc * 1000.0  # M -> mol/m^3
    neutral_OH = 1.0e-7 * 1000.0
    if electrolyte == "KHCO3":
        return {"K": c, "HCO3": c, "OH": neutral_OH, "CO32": 0.0,
                "CO2": 0.0, "Cl": 0.0}
    if electrolyte == "KOH":
        return {"K": c, "HCO3": 0.0, "OH": c, "CO32": 0.0,
                "CO2": 0.0, "Cl": 0.0}
    if electrolyte == "K2CO3":
        return {"K": 2 * c, "HCO3": 0.0, "OH": neutral_OH, "CO32": c,
                "CO2": 0.0, "Cl": 0.0}
    if electrolyte == "KCl":
        return {"K": c, "HCO3": 0.0, "OH": neutral_OH, "CO32": 0.0,
                "CO2": 0.0, "Cl": c}
    raise ValueError(f"Electrolyte type {electrolyte!r} not supported")


def _pH_from_OH(c_OH: float) -> float:
    """pH from [OH-] in mol/m^3 via Kw (ref: utilities/bulk_soln.py:130)."""
    return float(-np.log10(_KW / (c_OH / 1000.0)))


def _integrate(rhs, y0, tmax, dt=1.0e-2, max_samples=200_000):
    """LSODA integration sampled like the reference (linspace with dt).

    The sample grid only selects output points; LSODA steps adaptively, so
    capping the sample count changes nothing but memory."""
    from scipy.integrate import odeint

    n = min(int(tmax / dt), max_samples)
    t = np.linspace(0.0, tmax, n)
    sol = odeint(rhs, y0, t)
    return sol[-1]


def _closed_system_equilibrium(init: Dict[str, float], k) -> np.ndarray:
    """Exact chemical equilibrium of the closed buffer system.

    Returns [HCO3, OH, CO32, CO2] in mol/m^3 satisfying
        ka1*HCO3*OH = ka2*CO32,   kb1*CO2*OH = kb2*HCO3,
    subject to the two reaction invariants fixed by the initial composition:
        C_T = HCO3 + CO32 + CO2          (carbon)
        A   = HCO3 + OH + 2*CO32         (base equivalents)

    The shipped reference YAMLs' ``bulk_conc_pre_CO2`` blocks sit at this
    equilibrium (the b-leg timescale 1/kb2 ≈ 1.9e4 s means a 10 s integration
    cannot reach it), so the algebraic solve is the faithful reproduction.
    """
    from scipy.optimize import brentq

    C_T = init["HCO3"] + init["CO32"] + init["CO2"]
    A = init["HCO3"] + init["OH"] + 2.0 * init["CO32"]

    if C_T <= 0.0:
        return np.array([0.0, A, 0.0, 0.0])

    K_a = k.ka1 / k.ka2   # m^3/mol
    K_b = k.kb1 / k.kb2   # m^3/mol

    def hco3_of(OH):
        return C_T / (1.0 + K_a * OH + 1.0 / (K_b * OH))

    def g(OH):
        h = hco3_of(OH)
        return h * (1.0 + 2.0 * K_a * OH) + OH - A

    # g is increasing in OH near the root; bracket between ~pure-CO2 acid
    # limit and all-base limit.
    lo, hi = 1e-20, max(A, 1.0)
    # expand hi until sign change (g(hi) > 0 eventually since OH term grows)
    while g(hi) < 0:
        hi *= 10.0
    OH = brentq(g, lo, hi, xtol=1e-30, rtol=1e-15, maxiter=200)
    HCO3 = hco3_of(OH)
    CO32 = K_a * HCO3 * OH
    CO2 = HCO3 / (K_b * OH)
    return np.array([HCO3, OH, CO32, CO2])


def equilibrate_electrolyte(
    conc: float = 0.1,
    electrolyte: str = "KHCO3",
    temp: float = 298.15,
    f_CO2: float = 1.0,
    params: ParameterSet = DEFAULT_PARAMS,
    stage2_tmax: Optional[float] = None,
    stage1_protocol: str = "equilibrium",
) -> BulkSolution:
    """Two-stage bulk equilibration (ref: utilities/bulk_soln.py, whole file).

    Stage 1: closed batch reactor.  ``stage1_protocol="equilibrium"``
    (default) solves the exact algebraic equilibrium, which is what the
    shipped ``bulk_soln_*.yaml`` pre-CO2 blocks contain;
    ``"reference_script"`` replicates the 10 s LSODA snapshot the shipped
    script (utilities/bulk_soln.py:122-127) would produce today.

    Stage 2: clamp [CO2] at the Henry/Sechenov saturation value and integrate
    for 1e3 s (conc <= 1 M), 1e4 s (<= 5 M) else 5e4 s.
    """
    k = params.rate_constants
    init = _initial_composition(electrolyte, conc)

    if stage1_protocol == "equilibrium":
        y_end = _closed_system_equilibrium(init, k)
    else:
        def rhs_stage1(y, t):
            C_HCO3, C_OH, C_CO32, C_CO2 = y
            r_a = k.ka1 * C_HCO3 * C_OH - k.ka2 * C_CO32
            r_b = k.kb1 * C_CO2 * C_OH - k.kb2 * C_HCO3
            return [r_b - r_a, -r_b - r_a, r_a, -r_b]

        y0 = [init["HCO3"], init["OH"], init["CO32"], init["CO2"]]
        y_end = _integrate(rhs_stage1, y0, tmax=10.0)

    pre_pH = _pH_from_OH(y_end[1])
    pre = {
        "H": float((10.0 ** (-pre_pH)) * 1000.0),
        "OH": float(y_end[1]),
        "HCO3": float(y_end[0]),
        "CO32": float(y_end[2]),
        "CO2": float(y_end[3]),
        "K": float(init["K"]),
        "Cl": float(init["Cl"]),
    }

    # Sechenov-capped CO2 saturation based on *initial* K/Cl and stage-1 ions
    # (ref: utilities/bulk_soln.py:57,137)
    ions = {"K": float(init["K"]), "HCO3": pre["HCO3"], "OH": pre["OH"],
            "CO32": pre["CO32"], "Cl": init["Cl"]}
    C_CO2_sat = float(co2_saturation_conc(temp, f_CO2, ions, params))

    # Stage 2: CO2 clamped at saturation.  The reference recomputes the
    # Sechenov cap inside the RHS with the same (stage-1) ion concentrations,
    # so the value is constant during integration (utilities/bulk_soln.py:57).
    def rhs_stage2(y, t):
        C_HCO3, C_OH, C_CO32 = y
        r_a = k.ka1 * C_HCO3 * C_OH - k.ka2 * C_CO32
        r_b = k.kb1 * C_CO2_sat * C_OH - k.kb2 * C_HCO3
        return [r_b - r_a, -r_b - r_a, r_a]

    # if stage-1 CO2 already exceeds saturation, restart stage 2 from the
    # initial composition (ref: utilities/bulk_soln.py:182-185)
    if pre["CO2"] > C_CO2_sat:
        y0_2 = [init["HCO3"], init["OH"], init["CO32"]]
    else:
        y0_2 = [pre["HCO3"], pre["OH"], pre["CO32"]]

    if stage2_tmax is None:
        stage2_tmax = 1.0e3 if conc <= 1 else (1.0e4 if conc <= 5 else 5.0e4)

    y2 = _integrate(rhs_stage2, y0_2, tmax=stage2_tmax)

    post_pH = _pH_from_OH(y2[1])
    # post-CO2 [CO2] reported at the *ion-free* Henry value
    # (ref: utilities/bulk_soln.py:206 calls CO2_conc(T, f_CO2) with no ions)
    post = {
        "H": float((10.0 ** (-post_pH)) * 1000.0),
        "OH": float(y2[1]),
        "HCO3": float(y2[0]),
        "CO32": float(y2[2]),
        "CO2": float(co2_saturation_conc(temp, f_CO2, {}, params)),
        "K": float(init["K"]),
        "Cl": float(init["Cl"]),
    }

    return BulkSolution(
        electrolyte=electrolyte,
        conc_molar=conc,
        CO2_pressure=f_CO2,
        pre_CO2=pre,
        pre_pH=pre_pH,
        post_CO2=post,
        post_pH=post_pH,
    )


# ---------------------------------------------------------------------------
# Loading bulk-solution data: either a reference-style YAML file or computed
# on the fly (and cached) by the equilibrator above.
# ---------------------------------------------------------------------------

_CACHE: Dict[tuple, BulkSolution] = {}


def get_bulk_solution(
    conc: float,
    electrolyte: str = "KHCO3",
    yaml_path: Optional[str] = None,
    params: ParameterSet = DEFAULT_PARAMS,
) -> BulkSolution:
    """Bulk solution record, from a YAML file if given else computed+cached."""
    if yaml_path is not None:
        return load_bulk_yaml(yaml_path)
    key = (round(conc, 12), electrolyte)
    if key not in _CACHE:
        _CACHE[key] = equilibrate_electrolyte(conc, electrolyte, params=params)
    return _CACHE[key]


def load_bulk_yaml(path: str) -> BulkSolution:
    """Read a reference-format ``bulk_soln_*.yaml``."""
    import yaml as _yaml

    with open(path) as f:
        raw = _yaml.safe_load(f)

    def parse(block):
        conc = {k[3:]: float(v)
                for k, v in block["concentrations"].items() if k.startswith("C0_")}
        return conc, float(block["final_pH"])

    pre, pre_pH = parse(raw["bulk_conc_pre_CO2"])
    post, post_pH = parse(raw["bulk_conc_post_CO2"])
    blk = raw["bulk_conc_post_CO2"]
    return BulkSolution(
        electrolyte=blk.get("electrolyte", "KHCO3"),
        conc_molar=float(blk.get("conc_electrolyte", 0.0)),
        CO2_pressure=float(blk.get("CO2_pressure", 1.0)),
        pre_CO2=pre,
        pre_pH=pre_pH,
        post_CO2=post,
        post_pH=post_pH,
    )


def write_bulk_yaml(sol: BulkSolution, path: str) -> None:
    import yaml as _yaml

    with open(path, "w") as f:
        _yaml.safe_dump(sol.to_yaml_dict(), f)
