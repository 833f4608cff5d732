"""1D planar reaction–diffusion model for CO2ER.

Re-implementation of the reference ``solve_rxn_diff``
(1D/rxn_diff_planar.py:87-492): transient backward-Euler solve of 5 neutral
transport species (H+, OH-, HCO3-, CO32-, CO2) on a graded unit-interval
mesh, Dirichlet bulk values at x=1, constant flux BCs for OH-/CO2 at the OHP
(x=0), homogeneous buffer kinetics; the monovalent cation is recovered post
hoc by electroneutrality (:423).

Scaling conventions follow the reference exactly: x by L_n, c_i by C0_i,
the shared dimensionless time step del_t = dt_phys / (L_n^2 / D_CO32)
(:152-159,200-206), reaction scaling L_n^2/(D_i C0_i).  Note the reference
weak form carries no per-species D_CO32/D_i factor on the time derivative —
each species effectively evolves in its own diffusion time (the ``scale()``
post-processor :54-65 confirms t_i = tau L_n^2/D_i); this quirk is
reproduced for parity since all runs target steady state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gmpnp.chem.reactions import BufferKinetics
from gmpnp.constants import ParameterSet
from gmpnp.fem import DirichletBC, FemSpace, WeakForm
from gmpnp.io import make_run_dir, save_metadata, save_npz
from gmpnp.models import base
from gmpnp.solve.timeloop import (
    LinearConfig,
    NewtonConfig,
    make_implicit_step,
    run_transient,
)

SPECIES = ("H", "OH", "HCO3", "CO32", "CO2")
IDX = {s: i for i, s in enumerate(SPECIES)}


def read_iv_data(filename):
    """CSV IV-curve reader: columns voltage, HCOO, CO, H2 partial currents
    (ref ``readIVdata``, 1D/rxn_diff_planar.py:70-84; kept for users driving
    the flux BCs from experimental IV data instead of --current_OHP_ss).

    Returns (volt, HCOO, CO, H2) as lists of floats.
    """
    import csv

    volt, HCOO, CO, H2 = [], [], [], []
    with open(filename) as f:
        for row in csv.reader(f):
            if not row:
                continue
            volt.append(float(row[0]))
            HCOO.append(float(row[1]))
            CO.append(float(row[2]))
            H2.append(float(row[3]))
    return volt, HCOO, CO, H2


@dataclass(frozen=True)
class RxnDiff1DConfig:
    # reference CLI flags (1D/rxn_diff_planar.py:495-552)
    concentration_KHCO3: float = 0.1
    H2_FE: float = 0.2
    L_n: float = 50.0e-6
    mesh_structure: str = "variable"
    current_OHP_ss: float = 10.0
    cation: str = "K"
    params_file: Optional[str] = None
    # reference hardcoded schedule (:200-206)
    total_sim_time: float = 10.0
    time_step: float = 2.0e-2
    # framework knobs
    quad_degree: int = 3
    # ref :329-341 tolerances.  stall_atol: with emulated f64 the
    # residual-evaluation noise floor of this system sits above the
    # reference's atol (~2.7e-6 at N=5991), so every warm step would burn
    # the full 100-iteration budget at the floor.  The stagnation exit
    # accepts a residual that has stopped improving below 1e-4
    # (solve.newton.newton_solve stall_atol); on real-f64 backends the
    # 1e-6 criterion should trigger first (ROADMAP Design 1: to be shown
    # on a GPU, then removed).
    newton: NewtonConfig = field(default_factory=lambda: NewtonConfig(
        max_iter=100, rtol=1.0e-6, atol=1.0e-6, stall_atol=1.0e-4))
    linear: LinearConfig = field(default_factory=lambda: LinearConfig(
        kind="tridiag_cr"))

    @property
    def identifier(self) -> str:
        return (f"H2_FE_{self.H2_FE}_current_{self.current_OHP_ss}"
                f"_L_n_{self.L_n}_cation_{self.cation}")


@dataclass
class RxnDiff1DProgram:
    config: RxnDiff1DConfig
    space: FemSpace
    form: WeakForm
    bc: DirichletBC
    mesh: "base.Mesh"
    params: ParameterSet
    initial_conc: Dict[str, float]
    diff_coeff: Dict[str, float]
    bulk_pH: float
    time_constant: float
    num_steps: int
    dt_scaled: float
    theta: Dict[str, float]

    def run(self, n_steps: Optional[int] = None):
        cfg = self.config
        n = self.num_steps if n_steps is None else n_steps
        step = make_implicit_step(
            self.space, self.form, cfg.newton, cfg.linear,
            bc_of_theta=lambda theta: self.bc)
        u0 = jnp.ones((self.space.num_vertices, len(SPECIES)))
        theta = {k: jnp.asarray(v) for k, v in self.theta.items()}
        (u_final, _), (u_hist, stats) = run_transient(
            step, (u0, None), n,
            theta_of_carry=lambda carry, i: theta)
        return u0, u_hist, stats


def build(cfg: RxnDiff1DConfig) -> RxnDiff1DProgram:
    params = base.load_params(cfg.params_file)
    bulk = base.load_bulk(cfg.concentration_KHCO3, params)
    conc = bulk.concentrations("post")
    initial_conc = {s: conc[s] for s in SPECIES}
    # cation (not solved) for post-hoc electroneutrality
    initial_conc[cfg.cation] = conc.get(cfg.cation, conc.get("K"))
    diff_coeff = {s: params.D(s) for s in SPECIES}
    diff_coeff[cfg.cation] = params.D(cfg.cation)

    # smallest diffusion coefficient sets the time constant (ref :152)
    time_constant = cfg.L_n ** 2 / diff_coeff["CO32"]
    dt_scaled = cfg.time_step / time_constant
    num_steps = int((cfg.total_sim_time / time_constant) / dt_scaled)

    kin = BufferKinetics.build(
        SPECIES, initial_conc, diff_coeff, cfg.L_n, params.rate_constants)

    # flux prefactors (ref :162-163)
    farad = params.nat_const.F
    J_OH_pref = cfg.L_n / (diff_coeff["OH"] * initial_conc["OH"] * farad)
    J_CO2_pref = cfg.L_n / (diff_coeff["CO2"] * initial_conc["CO2"] * farad)
    CO_FE = 1.0 - cfg.H2_FE
    J_CO2 = J_CO2_pref * cfg.current_OHP_ss * 0.5 * CO_FE
    J_OH = J_OH_pref * cfg.current_OHP_ss * (-1.0)

    mesh = base.interval_mesh_marked(cfg.mesh_structure, cfg.L_n)
    space = FemSpace.build(mesh, len(SPECIES), quad_degree=cfg.quad_degree)

    nf = len(SPECIES)

    def volume(u, gu, up, x, theta):
        R = kin(u)
        fval = (u - up) / theta["dt"] - R
        return fval, gu

    # DOLFIN's bare `ds` spans both endpoints (the Dirichlet rows at x=1
    # overwrite that side), ref :314 — register the flux on both markers.
    def flux(u, x, theta):
        g = jnp.zeros(nf)
        g = g.at[IDX["OH"]].set(theta["J_OH"])
        g = g.at[IDX["CO2"]].set(theta["J_CO2"])
        return g

    form = WeakForm(nf, volume, boundary={base.LEFT: flux, base.RIGHT: flux})

    right = base.right_boundary_vertices(mesh)
    bc = DirichletBC.from_vertex_sets(
        mesh.num_vertices, nf, [(right, i, 1.0) for i in range(nf)])

    theta = {"dt": dt_scaled, "J_OH": J_OH, "J_CO2": J_CO2}

    return RxnDiff1DProgram(
        config=cfg, space=space, form=form, bc=bc, mesh=mesh, params=params,
        initial_conc=initial_conc, diff_coeff=diff_coeff,
        bulk_pH=bulk.post_pH, time_constant=time_constant,
        num_steps=num_steps, dt_scaled=dt_scaled, theta=theta)


def scale_back(tau, C, species, initial_conc, diff_coeff, L_n):
    """Reference ``scale()`` (1D/rxn_diff_planar.py:54-65)."""
    t = tau * L_n ** 2 / diff_coeff[species]
    c = C * initial_conc[species]
    return t, c


def run(cfg: RxnDiff1DConfig, out_root: Optional[str] = None,
        write: bool = True, n_steps: Optional[int] = None,
        verbose: bool = False):
    """Full reference-parity run: transient solve + npz/metadata outputs
    (key sets match 1D/rxn_diff_planar.py:367-492)."""
    prog = build(cfg)
    u0, u_hist, stats = prog.run(n_steps=n_steps)
    if verbose:
        from gmpnp.utils import StepLogger
        StepLogger(every=max(1, u_hist.shape[0] // 50)).log_run(
            stats, dt_phys=cfg.time_step)
    n = u_hist.shape[0]

    # history arrays shaped like the reference accumulators: initial
    # ones-row prepended (ref :316-320 starts each array with np.ones)
    hist = np.concatenate(
        [np.asarray(u0)[None], np.asarray(u_hist)], axis=0)  # (n+1, N, f)
    T = (cfg.time_step * n) / prog.time_constant
    tau_array = np.linspace(0, T, n)

    coor_array = np.asarray(prog.mesh.points)
    unscaled = {s: hist[:, :, IDX[s]] for s in SPECIES}

    result = {
        "unscaled": unscaled,
        "tau_array": tau_array,
        "coor_array": coor_array,
        "stats": stats,
    }

    scaled = {}
    for s in SPECIES:
        t_s, c_s = scale_back(tau_array, unscaled[s], s,
                              prog.initial_conc, prog.diff_coeff, cfg.L_n)
        scaled[f"t_{s}"] = t_s
        scaled[f"c_{s}"] = c_s
    # electroneutrality cation (ref :423)
    c_cat = (scaled["c_HCO3"] + 2 * scaled["c_CO32"]
             + scaled["c_OH"] - scaled["c_H"])
    scaled["c_cat"] = c_cat
    result["scaled"] = scaled

    pH_OHP = -math.log10(scaled["c_H"][-1][0] / 1000.0)
    CO_FE = 1.0 - cfg.H2_FE
    CO2_surf_last = scaled["c_CO2"][-1][0]
    pH_overpotential = -0.059 * (prog.bulk_pH - pH_OHP) * 1.0e3
    CO2_overpotential = (0.059 / 2) * math.log10(
        prog.initial_conc["CO2"] / CO2_surf_last) * 1.0e3
    CO2_OHP_frac = CO2_surf_last / prog.initial_conc["CO2"]

    mesh_structure = cfg.mesh_structure
    if mesh_structure == "variable":
        mesh_structure += f"_{int(cfg.L_n * 1e6)}um"

    metadata = {
        "concentration_KHCO3": cfg.concentration_KHCO3,
        "L_n": cfg.L_n,
        "bulk_pH": prog.bulk_pH,
        "time_constant": prog.time_constant,
        "total_sim_time": cfg.total_sim_time,
        "time_step": cfg.time_step,
        "mesh_structure": mesh_structure,
        "H2_FE": cfg.H2_FE,
        "CO_FE": CO_FE,
        "current_OHP_ss": cfg.current_OHP_ss,
        "pH_OHP": pH_OHP,
        "pH_overpotential": pH_overpotential,
        "CO2_overpotential": CO2_overpotential,
        "CO2_OHP_frac": CO2_OHP_frac,
        # framework extras
        "newton_iters_total": int(np.asarray(stats.newton_iters).sum()),
        "all_steps_converged": bool(np.asarray(stats.converged).all()),
    }
    result["metadata"] = metadata

    if write:
        paths = make_run_dir(cfg.identifier, out_root=out_root)
        save_npz(paths.file("arrays_unscaled.npz"),
                 H=unscaled["H"], OH=unscaled["OH"], HCO3=unscaled["HCO3"],
                 CO32=unscaled["CO32"], CO2=unscaled["CO2"],
                 coor_array=coor_array, tau_array=tau_array)
        save_npz(paths.file("arrays_scaled.npz"),
                 x=coor_array * cfg.L_n, **scaled)
        save_metadata(paths.file("metadata.json"), metadata)
        result["run_dir"] = paths.run_dir

    return result
