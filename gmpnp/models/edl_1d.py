"""1D PNP / GMPNP electric-double-layer model for CO2ER — the flagship model.

Re-implementation of the reference ``solve_EDL``
(1D/MPNP_CO2ER_EDL.py:66-989): transient solve of 6 species (H+, OH-, HCO3-,
CO32-, CO2, monovalent cation) + electrostatic potential on an EDL-resolving
graded interval mesh.  Selectable physics:

- ``model='PNP'``   : Nernst–Planck + Poisson (ref :429-455)
- ``model='MPNP'``  : adds the finite-ion-size (steric) flux term
  u_i/(1 - sum_j a_j^3 N_A C0_j u_j) * sum_j a_j^3 N_A C0_j grad(u_j)
  (ref :457-595)

plus the concentration-dependent permittivity
eps(c) = eps_rel (55 - sum w_i c_i 1e-3)/55 + 6 (sum w_i c_i 1e-3)/55
(ref :412-421), staged dt schedule (:270-290), optional SUPG stabilization
for PNP (:597-714), and the adaptive H_OHP proton-current feedback
controller (:770-793) — all inside one jit-compiled lax.scan (the controller
is scan-carried state, the staged dt a traced per-step scalar).

Scalings (ref :173-205): x by L_n, concentrations by C0_i, potential by the
thermal voltage, time term (u-u_n)/(del_t * L_D) with L_D = L_debye/L_n and
del_t = dt_phys/time_constant, time_constant = L_debye*L_n/D_CO32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gmpnp.chem.reactions import BufferKinetics
from gmpnp.constants import ParameterSet
from gmpnp.fem import DirichletBC, FemSpace, WeakForm
from gmpnp.fem.projection import project_cellwise, project_gradient
from gmpnp.io import make_run_dir, save_metadata, save_npz
from gmpnp.models import base
from gmpnp.solve.timeloop import (
    LinearConfig,
    NewtonConfig,
    make_carried_step,
    make_implicit_step,
    make_recovering_carried_step,
    make_recovering_step,
    run_transient,
)

N_FIELDS = 7
P = 6  # potential field index


@dataclass(frozen=True)
class EDL1DConfig:
    # reference CLI flags (1D/MPNP_CO2ER_EDL.py:992-1103)
    concentration_elec: float = 0.1
    model: str = "MPNP"                # 'PNP' | 'MPNP'
    voltage_multiplier: float = -1.0   # in thermal voltages, at the OHP
    H2_FE: float = 0.2
    mesh_structure: str = "variable"
    current_OHP_ss: float = 10.0
    L_n: float = 50.0e-6
    stabilization: str = "N"           # 'Y' enables SUPG (PNP only)
    H_OHP: Optional[float] = None      # proton buildup target (controller)
    cation: str = "K"
    params_file: Optional[str] = None
    dry_run: bool = True
    # framework knobs
    steric_clip: float = 1.0e-6  # lower clamp on the MPNP steric denominator
    # (see models.pore_3d.Pore3DConfig.steric_clip; same conditioning guard)
    include_reactions: bool = True   # False: pure (M)PNP equilibrium studies
    quad_degree: int = 3
    faithful_supg: bool = True   # reproduce the grad(u_H) slip in the OH
                                 # SUPG row (ref :697); False corrects it
    # divergence recovery: retry a non-converged step with dt halved, up to
    # this many times (solve.timeloop.make_recovering_step).  None = auto:
    # 3 for full-length runs, 0 for dry runs (recovery is the production
    # default per SURVEY §5 — the reference dies on a diverged Newton,
    # 1D/MPNP_CO2ER_EDL.py has no recovery at all)
    dt_retries: Optional[int] = None
    # Armijo backtracking halvings per Newton iteration.  None = auto: 4
    # for full-length runs, 0 (reference-parity plain damped Newton) for
    # dry runs.  At V=-12.5 (the hardest published config) the cold start
    # diverges under plain Newton at EVERY dt down to dt/8 — dt cuts
    # alone cannot rescue it — while backtracking converges every step at
    # the reference schedule (3 dt retries alone go non-finite; 4
    # backtracking halvings + 3 retries converge every step).
    backtracking: Optional[int] = None
    newton: NewtonConfig = field(default_factory=lambda: NewtonConfig(
        max_iter=50, rtol=1.0e-4, atol=1.0e-4))  # ref :357-364
    linear: LinearConfig = field(default_factory=lambda: LinearConfig(
        kind="tridiag_cr"))

    @property
    def species(self) -> Tuple[str, ...]:
        return ("H", "OH", "HCO3", "CO32", "CO2", self.cation)

    @property
    def identifier(self) -> str:
        return (f"voltage_{self.voltage_multiplier}_H2_FE_{self.H2_FE}"
                f"_current_{self.current_OHP_ss}_H_OHP_{self.H_OHP}"
                f"_cation_{self.cation}")


@dataclass
class EDL1DProgram:
    config: EDL1DConfig
    space: FemSpace
    form: WeakForm
    bc: DirichletBC
    mesh: "base.Mesh"
    params: ParameterSet
    initial_conc: Dict[str, float]
    diff_coeff: Dict[str, float]
    bulk_pH: float
    L_debye: float
    thermal_voltage: float
    time_constant: float
    schedule: Dict[str, float]      # dt1, dt2, n1, n2 (scaled)
    J_pref: Dict[str, float]
    h_vert: jnp.ndarray             # projected cell diameters (SUPG)
    n_water: Dict[str, float]

    @property
    def tot_num_steps(self) -> int:
        return int(self.schedule["n1"] + self.schedule["n2"])

    def _theta_of_carry(self, carry, i):
        cfg = self.config
        u, chf = carry
        sch = self.schedule
        dt = jnp.where(i < sch["n1"], sch["dt1"], sch["dt2"])
        current = cfg.current_OHP_ss
        theta = {
            "dt": dt,
            "J_OH": -1.0 * self.J_pref["OH"] * current * (1.0 - chf),
            "J_H": self.J_pref["H"] * current * chf,
            "J_CO2": self.J_pref["CO2"] * current * 0.5 * (1.0 - cfg.H2_FE),
        }
        if self.form.n_aux:
            theta["_aux"] = self._supg_rho(u)
        return theta

    def _supg_rho(self, u_prev):
        """Per-vertex SUPG stabilization parameters rho_i from the previous
        potential (ref :650-685): projected |grad psi|, cell-Peclet switch."""
        cfg = self.config
        sp = self.space
        tol = 1.0e-14
        fact = 1.0
        gp = jnp.einsum("ca,cad->cd", u_prev[:, P][sp.cells], sp.gradN)
        norm_gp_cell = jnp.sqrt(jnp.sum(gp * gp, axis=1))
        norm_gp = project_cellwise(sp, norm_gp_cell)          # (N,)
        h = self.h_vert
        rho_small = fact ** 2 * h ** 2 / 4.0
        z = np.asarray([self.params.z(s) for s in cfg.species], np.float64)
        absz = jnp.abs(z)[None, :]                            # (1, 6)
        Pe = fact * h[:, None] * norm_gp[:, None] * absz / 2.0
        rho_large = fact * h[:, None] / jnp.maximum(
            2.0 * absz * norm_gp[:, None], 1e-300)
        rho = jnp.where(Pe > 1.0 + tol, rho_large, rho_small[:, None])
        return jnp.where(absz > 0, rho, 0.0)

    def _update_carry(self, chf, u_new, i):
        """H_OHP adaptive proton-current controller (ref :770-793)."""
        cfg = self.config
        if cfg.H_OHP is None:
            return chf
        H = cfg.H_OHP
        frac = u_new[0, 0]  # u_H at the OHP vertex (x=0)
        conds = [
            frac < 0,
            frac < (H - 0.05),
            frac < (H - 0.025),
            (frac > H) & (frac <= H + 0.4) & (chf <= 1.0),
            (frac > H + 0.4) & (chf <= 1.0),
        ]
        vals = [chf / 1.1, chf / 1.05, chf / 1.01, chf * 1.04, chf * 1.15]
        return jnp.select(conds, vals, chf)

    def run(self, n_steps: Optional[int] = None, record_stride: int = 1,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 1000):
        """record_stride bounds on-device history (the full run is 20,000
        steps, ref :270-290); checkpoint_dir enables chunked npz
        checkpointing with automatic resume (SURVEY §5)."""
        cfg = self.config
        n = self.tot_num_steps if n_steps is None else n_steps
        retries = cfg.dt_retries
        if retries is None:
            retries = 0 if cfg.dry_run else 3
        bt = cfg.backtracking
        if bt is None:
            bt = 0 if cfg.dry_run else 4
        newton = (_dc_replace(cfg.newton, backtracking=bt)
                  if bt != cfg.newton.backtracking else cfg.newton)
        carried = (cfg.linear.kind == "tridiag_cr"
                   and cfg.linear.refresh == "carried")
        prep_init = None
        if carried:
            # carried-factor chord Newton: the f64 CR factorization rides
            # the scan carry (solve.timeloop.make_carried_step) — warm
            # steps skip the per-iterate assemble+factor
            if retries > 0:
                step, prep_init = make_recovering_carried_step(
                    self.space, self.form, newton, cfg.linear,
                    bc_of_theta=lambda theta: self.bc, max_retries=retries)
            else:
                step, prep_init = make_carried_step(
                    self.space, self.form, newton, cfg.linear,
                    bc_of_theta=lambda theta: self.bc)
        elif retries > 0:
            step = make_recovering_step(
                self.space, self.form, newton, cfg.linear,
                bc_of_theta=lambda theta: self.bc, max_retries=retries)
        else:
            step = make_implicit_step(
                self.space, self.form, newton, cfg.linear,
                bc_of_theta=lambda theta: self.bc)
        u0 = jnp.concatenate(
            [jnp.ones((self.space.num_vertices, 6)),
             jnp.zeros((self.space.num_vertices, 1))], axis=1)
        chf0 = jnp.asarray(0.001 if cfg.H_OHP is not None else 0.0)
        if checkpoint_dir:
            from gmpnp.io.checkpoint import (
                TransientCheckpointer,
                run_transient_checkpointed,
            )
            state_init = None
            if carried:
                state_init = lambda carry, i: jax.jit(prep_init)(
                    carry[0], self._theta_of_carry(carry, jnp.asarray(i)))
            ckpt = TransientCheckpointer(checkpoint_dir, cfg=cfg)
            (u_final, chf), ys = run_transient_checkpointed(
                step, (u0, chf0), n, ckpt, chunk=checkpoint_every,
                theta_of_carry=self._theta_of_carry,
                update_carry=self._update_carry,
                step_state_init=state_init)
            ckpt.close()
            if ys is None:
                # resumed at the final step: return the
                # checkpointed final state as the single history record so
                # the writers rebuild the finished run's outputs cleanly
                return u0, np.asarray(u_final)[None], None, float(chf)
            u_hist, stats = ys
        elif carried:
            prep0 = jax.jit(prep_init)(
                u0, self._theta_of_carry((u0, chf0), jnp.asarray(0)))
            (u_final, chf, _), (u_hist, stats) = run_transient(
                step, (u0, chf0), n,
                theta_of_carry=self._theta_of_carry,
                update_carry=self._update_carry,
                record_stride=record_stride,
                step_state0=prep0)
        else:
            (u_final, chf), (u_hist, stats) = run_transient(
                step, (u0, chf0), n,
                theta_of_carry=self._theta_of_carry,
                update_carry=self._update_carry,
                record_stride=record_stride)
        return u0, u_hist, stats, float(chf)


def build(cfg: EDL1DConfig) -> EDL1DProgram:
    if cfg.model not in ("PNP", "MPNP"):
        raise ValueError(f"unknown model {cfg.model!r}")
    params = base.load_params(cfg.params_file)
    nat = params.nat_const
    bulk = base.load_bulk(cfg.concentration_elec, params)
    conc = bulk.concentrations("post")
    species = cfg.species
    initial_conc = {s: conc[s] if s in conc else conc["K"] for s in species}
    diff_coeff = {s: params.D(s) for s in species}

    # hydration numbers (ref :106-115: H=10, K=4, Li=5, Cs=3, Na=5)
    n_water = {"H": params.w("H"), cfg.cation: params.w(cfg.cation)}

    # Debye length from Boltzmann distribution (ref :173-176)
    L_debye = math.sqrt(
        (nat.eps_0 * nat.eps_rel * nat.k_B * nat.T)
        / (2 * nat.e_0 ** 2 * cfg.concentration_elec * 1.0e3 * nat.N_A))
    L_D = L_debye / cfg.L_n
    thermal_voltage = nat.k_B * nat.T / nat.e_0
    time_constant = L_debye * cfg.L_n / diff_coeff["CO32"]

    kin = BufferKinetics.build(
        species, initial_conc, diff_coeff, cfg.L_n, params.rate_constants)

    q = (nat.F ** 2 * cfg.L_n ** 2) / (nat.eps_0 * nat.R * nat.T)
    scale_vol = np.asarray(
        [params.a(s) ** 3 * initial_conc[s] * nat.N_A for s in species])
    z = np.asarray([params.z(s) for s in species], np.float64)
    c0 = np.asarray([initial_conc[s] for s in species])
    eps_rel = nat.eps_rel
    w_cat = n_water[cfg.cation]
    w_H = n_water["H"]
    C0_cat = initial_conc[cfg.cation]
    C0_H = initial_conc["H"]

    J_pref = {s: cfg.L_n / (diff_coeff[s] * initial_conc[s] * nat.F)
              for s in ("H", "OH", "CO2")}

    # time schedule (ref :256-290)
    if cfg.dry_run:
        dt1_phys, n1 = 1.0e-5, 100
        dt2_phys, n2 = 1.0e-5, 0
    else:
        dt1_phys, n1 = 1.0e-5, int(0.1 / 1.0e-5)         # 10,000 steps
        dt2_phys, n2 = 1.0e-3, int((10.1 - 0.1) / 1.0e-3)  # 10,000 steps
    schedule = {
        "dt1": dt1_phys / time_constant,
        "dt2": dt2_phys / time_constant,
        "n1": n1,
        "n2": n2,
    }

    mesh = base.interval_mesh_marked(cfg.mesh_structure, cfg.L_n)
    space = FemSpace.build(mesh, N_FIELDS, quad_degree=cfg.quad_degree)

    use_supg = (cfg.stabilization == "Y" and cfg.model == "PNP")
    use_steric = cfg.model == "MPNP"
    faithful = cfg.faithful_supg

    def eps_of(u):
        hyd = (w_cat * u[5] * C0_cat + w_H * u[0] * C0_H) * 1.0e-3
        return eps_rel * (55.0 - hyd) / 55.0 + 6.0 * hyd / 55.0

    include_R = cfg.include_reactions

    def volume_core(u, gu, up, aux, x, theta):
        R = kin(u[:6]) if include_R else jnp.zeros(6)
        fval_c = (u[:6] - up[:6]) / (theta["dt"] * L_D) - R
        # diffusion + migration (z=0 species lose the migration term)
        fgrad_c = gu[:6] + z[:, None] * u[:6, None] * gu[P][None, :]
        if use_steric:
            denom = 1.0 - jnp.sum(scale_vol * u[:6])
            if cfg.steric_clip:
                denom = jnp.maximum(denom, cfg.steric_clip)
            common = jnp.einsum("j,jd->d", scale_vol, gu[:6])
            fgrad_c = fgrad_c + (u[:6] / denom)[:, None] * common[None, :]
        if use_supg:
            # -rho_i z_i [ (u_i-u_n_i)/(dt L_D) + z_i grad(g_i).grad(p)
            #             + R_i ] grad(p) . grad(v_i)   (ref :689-714)
            rho = aux                          # (6,) at this quad point
            gsel = gu[:6]
            if faithful:
                # the reference's OH row differentiates u_H (ref :697)
                gsel = gsel.at[1].set(gu[0])
            strong = ((u[:6] - up[:6]) / (theta["dt"] * L_D)
                      + z * jnp.einsum("jd,d->j", gsel, gu[P]) + R)
            # cation row omits R (ref :710-713); R_cat == 0 anyway
            coeff = -1.0 * rho * z * strong
            fgrad_c = fgrad_c + coeff[:, None] * gu[P][None, :]
        fval_p = q * jnp.sum(z * c0 * u[:6])
        fgrad_p = -eps_of(u) * gu[P]
        fval = jnp.concatenate([fval_c, jnp.asarray([fval_p])])
        fgrad = jnp.concatenate([fgrad_c, fgrad_p[None, :]])
        return fval, fgrad

    if use_supg:
        volume = volume_core
        n_aux = 6
    else:
        def volume(u, gu, up, x, theta):
            return volume_core(u, gu, up, None, x, theta)
        n_aux = 0

    def flux(u, x, theta):
        g = jnp.zeros(N_FIELDS)
        g = g.at[0].set(theta["J_H"])
        g = g.at[1].set(theta["J_OH"])
        g = g.at[4].set(theta["J_CO2"])
        return g

    form = WeakForm(N_FIELDS, volume,
                    boundary={base.LEFT: flux, base.RIGHT: flux},
                    n_aux=n_aux)

    right = base.right_boundary_vertices(mesh)
    left = base.left_boundary_vertices(mesh)
    entries = [(right, i, 1.0) for i in range(6)]
    entries.append((right, P, 0.0))
    entries.append((left, P, cfg.voltage_multiplier))
    bc = DirichletBC.from_vertex_sets(mesh.num_vertices, N_FIELDS, entries)

    # SUPG geometric data: projected cell diameters (ref :599).  Computed
    # only when SUPG is active: it is a device computation and must not run
    # eagerly in every build.
    if use_supg:
        from gmpnp.mesh.core import cell_measures
        h_cells = jnp.asarray(cell_measures(mesh.points, mesh.cells))
        h_vert = np.asarray(project_cellwise(space, h_cells))
    else:
        h_vert = None

    return EDL1DProgram(
        config=cfg, space=space, form=form, bc=bc, mesh=mesh, params=params,
        initial_conc=initial_conc, diff_coeff=diff_coeff,
        bulk_pH=bulk.post_pH, L_debye=L_debye,
        thermal_voltage=thermal_voltage, time_constant=time_constant,
        schedule=schedule, J_pref=J_pref, h_vert=h_vert, n_water=n_water)


def scale_back(tau, C, species, initial_conc, diff_coeff, L_n, L_debye):
    """Reference ``scale()`` (1D/MPNP_CO2ER_EDL.py:51-63)."""
    t = tau * L_debye * L_n / diff_coeff[species]
    c = C * initial_conc[species]
    return t, c


def run(cfg: EDL1DConfig, out_root: Optional[str] = None,
        write: bool = True, n_steps: Optional[int] = None,
        verbose: bool = False, record_stride: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1000):
    """Full reference-parity run with npz/metadata outputs
    (key sets per 1D/MPNP_CO2ER_EDL.py:821-832,906-924,960-989).

    record_stride=None (default) bounds the recorded history to ~1000
    snapshots for long runs (base.auto_record_stride); pass 1 for the
    reference's record-every-step behavior."""
    prog = build(cfg)
    if record_stride is None:
        record_stride = base.auto_record_stride(
            n_steps if n_steps is not None else prog.tot_num_steps)
    u0, u_hist, stats, current_H_frac = prog.run(
        n_steps=n_steps, record_stride=record_stride,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
    if verbose and stats is not None:
        from gmpnp.utils import StepLogger
        StepLogger(every=max(1, u_hist.shape[0] // 50)).log_run(stats)
    n = u_hist.shape[0]
    sch = prog.schedule

    hist = np.concatenate([np.asarray(u0)[None], np.asarray(u_hist)], axis=0)
    species = cfg.species
    names = ["H", "OH", "HCO3", "CO32", "CO2", "cat"]
    unscaled = {nm: hist[:, :, i] for i, nm in enumerate(names)}
    unscaled["p"] = hist[:, :, P]

    # tau grid mirrors the reference staging (ref :807-815)
    n_req = n_steps if n_steps is not None else prog.tot_num_steps
    if record_stride == 1 and n == n_req:
        if n <= sch["n1"]:
            tau_array = np.linspace(0, n * sch["dt1"], n)
        else:
            T1 = sch["n1"] * sch["dt1"]
            n2 = n - sch["n1"]
            tau_1 = np.linspace(0, T1, sch["n1"])
            tau_2 = np.linspace(T1 + sch["dt2"], T1 + n2 * sch["dt2"], n2)
            tau_array = np.concatenate([tau_1, tau_2])
    else:
        # strided and/or resumed history: exact staged times of the
        # recorded absolute step indices
        offset = n_req - n * record_stride
        idx = offset + record_stride * np.arange(1, n + 1)
        tau_array = np.where(
            idx <= sch["n1"], idx * sch["dt1"],
            sch["n1"] * sch["dt1"] + (idx - sch["n1"]) * sch["dt2"])

    coor = np.asarray(prog.mesh.points)

    # electric field from the final potential (ref :802-805)
    p_final = jnp.asarray(hist[-1, :, P])
    field_values = np.asarray(project_gradient(prog.space, p_final, sign=-1.0))
    field_rescaled = field_values * prog.thermal_voltage / cfg.L_n
    field_OHP = float(field_rescaled[0, 0]) * 1.0e-9  # V/nm

    scaled = {}
    sp_of = {"H": "H", "OH": "OH", "HCO3": "HCO3", "CO32": "CO32",
             "CO2": "CO2", "cat": cfg.cation}
    for nm in names:
        t_s, c_s = scale_back(
            tau_array, unscaled[nm], sp_of[nm], prog.initial_conc,
            prog.diff_coeff, cfg.L_n, prog.L_debye)
        scaled[f"t_{nm}"] = t_s
        scaled[f"c_{nm}"] = c_s
    psi = unscaled["p"] * prog.thermal_voltage

    c_H, c_cat = scaled["c_H"], scaled["c_cat"]
    w_cat, w_H = prog.n_water[cfg.cation], prog.n_water["H"]
    eps_rel = prog.params.nat_const.eps_rel
    eps_rel_conc_ss = (eps_rel * (55 - (w_cat * c_cat + w_H * c_H) * 1e-3) / 55
                       + 6 * ((w_cat * c_cat + w_H * c_H) * 1e-3) / 55)
    eps_rel_OHP = float(eps_rel_conc_ss[-1][0])

    charge_density = (scaled["c_cat"][-1] - scaled["c_HCO3"][-1]
                      - 2 * scaled["c_CO32"][-1] - scaled["c_OH"][-1]
                      + scaled["c_H"][-1])

    pH_OHP = -math.log10(scaled["c_H"][-1][0] / 1000.0)
    potential_OHP = float(psi[-1][0])
    CO2_OHP_frac = scaled["c_CO2"][-1][0] / prog.initial_conc["CO2"]
    pH_overpotential = -0.059 * (prog.bulk_pH - pH_OHP) * 1.0e3
    CO2_overpotential = (0.059 / 2) * math.log10(1 / CO2_OHP_frac) * 1.0e3
    current_H = current_H_frac * cfg.current_OHP_ss

    mesh_structure = cfg.mesh_structure
    _, mesh_number = base.reference_1d_mesh_spec(cfg.L_n) \
        if mesh_structure == "variable" else (None, 1000)
    if mesh_structure == "variable":
        mesh_structure += f"_{int(cfg.L_n * 1e6)}um"

    metadata = {
        "concentration_elec": cfg.concentration_elec,
        "cation": cfg.cation,
        "model": cfg.model,
        "stabilization": cfg.stabilization,
        "voltage_multiplier": cfg.voltage_multiplier,
        "H2_FE": cfg.H2_FE,
        "L_n_EDL": cfg.L_n,
        "time_constant": prog.time_constant,
        "time_step": 1.0e-5,
        "total_sim_time": 1.0e-3 if cfg.dry_run else 10.1,
        "mesh_number": mesh_number,
        "mesh_structure": mesh_structure,
        "eps_rel_OHP": eps_rel_OHP,
        "field_OHP": field_OHP,
        "current_OHP_ss": cfg.current_OHP_ss,
        "current_H": current_H,
        "H_OHP_vs_bulk": cfg.H_OHP,
        "potential_OHP": potential_OHP,
        "pH_OHP": pH_OHP,
        "CO2_OHP_frac": CO2_OHP_frac,
        "pH_overpotential": pH_overpotential,
        "CO2_overpotential": CO2_overpotential,
        # framework extras (stats is None when a checkpointed run resumed
        # at completion: zero steps executed this invocation)
        "newton_iters_total": (
            int(np.asarray(stats.newton_iters).sum())
            if stats is not None else 0),
        "all_steps_converged": (
            bool(np.asarray(stats.converged).all())
            if stats is not None else True),
        "resumed_complete": stats is None,
        # divergence-recovery record: steps that needed a dt cut, and the
        # physical time actually advanced (sum of dt * dt_scale; equals the
        # schedule total when no cuts fired)
        "dt_cut_steps": (
            int((np.asarray(stats.dt_scale) < 1.0).sum())
            if stats is not None else 0),
    }

    result = {
        "unscaled": unscaled,
        "scaled": scaled,
        "psi": psi,
        "tau_array": tau_array,
        "coor_array": coor,
        "field_values": field_values,
        "field_values_rescaled": field_rescaled,
        "charge_density": charge_density,
        "eps_rel_conc_ss": eps_rel_conc_ss,
        "metadata": metadata,
        "stats": stats,
    }

    if write:
        paths = make_run_dir(cfg.identifier, out_root=out_root,
                             subdir=cfg.model)
        save_npz(paths.file("arrays_unscaled.npz"),
                 H=unscaled["H"], OH=unscaled["OH"], HCO3=unscaled["HCO3"],
                 CO32=unscaled["CO32"], CO2=unscaled["CO2"],
                 cat=unscaled["cat"], p=unscaled["p"], coor=coor,
                 tau=tau_array, field_values=field_values)
        save_npz(paths.file("arrays_scaled.npz"),
                 x=coor * cfg.L_n, psi=psi,
                 t_H=scaled["t_H"], c_H=scaled["c_H"],
                 t_OH=scaled["t_OH"], c_OH=scaled["c_OH"],
                 t_HCO3=scaled["t_HCO3"], c_HCO3=scaled["c_HCO3"],
                 t_CO32=scaled["t_CO32"], c_CO32=scaled["c_CO32"],
                 t_CO2=scaled["t_CO2"], c_CO2=scaled["c_CO2"],
                 t_cat=scaled["t_cat"], c_cat=scaled["c_cat"],
                 eps_rel=eps_rel_conc_ss, field_values=field_rescaled,
                 charge_density=charge_density)
        save_metadata(paths.file("metadata.json"), metadata)
        result["run_dir"] = paths.run_dir

    return result
