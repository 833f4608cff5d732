"""3D cylindrical-pore models for CO2ER: GMPNP and reaction–diffusion.

Re-implementation of the reference 3D solvers:

- GMPNP (``physics='GMPNP'``): 8 species (H+, OH-, HCO3-, CO32-, CO2, CO,
  H2, cat+) + potential, steric fluxes, eps(c) permittivity, wall-potential
  Dirichlet (3D/MPNP_CO2ER_pore.py:96-1085)
- reaction-diffusion (``physics='rxn_diff'``): the 7-species neutral
  comparison model (3D/rxn_diff_CO2ER_pore.py:95-784)

Shared behavior: Henry/Sechenov gas dissolution with the CO2 entry Dirichlet
value recomputed every step from median ion concentrations (Sechenov moving
BC, 3D/MPNP_CO2ER_pore.py:815-838 — a traced scalar here, no recompiles);
Sherwood mass-transfer Robin fluxes at the pore exit; roughness-divided wall
current; effective diffusivities D phi delta/tau^2 (:147-158).

**Orphaned-flux quirk.** In the published GMPNP script every boundary-flux
addition is a separate no-op statement (the ``+ J_... * v * ds`` lines sit
*after* the closing ``* dx`` of their F_i assignment: 3D/MPNP_CO2ER_pore.py
:560,:588,:616,:644,:671,:698,:724,:750), so the solve runs with *no*
Neumann terms — only the Dirichlet BCs drive it.  ``faithful=True``
(default) reproduces exactly that; ``faithful=False`` includes the fluxes as
the sibling rxn-diff script does (3D/rxn_diff_CO2ER_pore.py:480-513), which
is the stated intent of the docstring (:10-14).  The rxn-diff physics always
includes them.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gmpnp.chem.henry import co2_saturation_conc
from gmpnp.chem.reactions import BufferKinetics
from gmpnp.constants import ParameterSet
from gmpnp.fem import DirichletBC, FemSpace, WeakForm
from gmpnp.fem.projection import project_gradient
from gmpnp.io import make_run_dir, save_metadata, save_npz
from gmpnp.io.vtk import write_pvd, write_vtu
from gmpnp.mesh import cylinder_mesh, pore_boundary_markers, read_dolfin_xml
from gmpnp.models import base
from gmpnp.solve.timeloop import (
    LinearConfig,
    NewtonConfig,
    calibrate_refresh,
    make_carried_step,
    make_implicit_step,
    make_recovering_carried_step,
    make_recovering_step,
    run_transient,
)

S1, S2, S3 = 1, 2, 3  # entry, wall, exit markers (ref :377-379)

GAS_SPECIES = ("CO2", "CO", "H2")


@dataclass(frozen=True)
class Pore3DConfig:
    # reference CLI flags (3D/MPNP_CO2ER_pore.py:1088-1235 and the rxn-diff
    # sibling :787-942; rxn_diff ignores voltage_multiplier)
    physics: str = "GMPNP"             # 'GMPNP' | 'rxn_diff'
    concentration_elec: float = 1.0
    voltage_multiplier: float = -1.0
    H2_FE: float = 0.05
    current_rough: float = 3000.0      # A/m^2 on the rough electrode
    L: float = 100.0e-9
    R: float = 5.0e-9
    cation: str = "K"
    press_gas: float = 1.0             # bar
    pore_geom_multiplier: float = 1.0
    porosity_eff: float = 0.5
    tortuosity_eff: float = 1.5
    constrictivity_eff: float = 0.9
    params_file: Optional[str] = None
    y_CO2: float = 0.95
    electrolyte_flow_geom_multiplier: float = 1.0
    roughness_factor: float = 150.0
    # reference hardcoded schedule (ref :358-359)
    time_step: float = 1.0e-3
    total_sim_time: float = 1.0
    # framework knobs
    faithful: bool = True       # reproduce the orphaned-flux published solver
    steric_clip: float = 1.0e-6  # lower clamp on the steric denominator
    # 1 - sum_j a_j^3 N_A C0_j u_j.  Off-manifold Newton iterates can drive
    # it through zero; unclipped, the resulting ~1/denom^2 intermediates
    # overflow the f32 exponent range of an emulated-f64 backend (real f64
    # absorbs the excursion and Newton recovers — the reference depends on
    # exactly that, SURVEY.md §7 "steric term conditioning").  Converged states sit at denom ~ 0.5, so the clip is
    # inactive at any solution; 0 disables.
    quad_degree: int = 2
    mesh_resolution: Optional[Tuple[int, int]] = None  # (n_rings, n_layers)
    # divergence recovery: retry a non-converged step with dt halved, up to
    # this many times (solve.timeloop.make_recovering_step).  None = auto:
    # 3 for full-length runs (n_steps not overridden), 0 for short/debug
    # windows.  SURVEY §5: the reference has no recovery — a diverged
    # Newton kills the run and all results are lost.
    dt_retries: Optional[int] = None
    # staged first step(s): run the first ``dt_first_steps`` steps at
    # dt * ``dt_first_scale``, then the full reference dt — the 3D
    # application of the reference's own 1D staged-dt idea
    # (1D/MPNP_CO2ER_EDL.py:270-290).  Deep-voltage cold starts exceed
    # backward Euler's convergence basin at the full reference dt on the
    # shipped meshes (V<=-1.5 diverges at every Newton variant); taking
    # only the FIRST step reduced converges the whole transient —
    # dt/32 for V=-1.5/-2.0, dt/8 for V=-2.5 (docs/STATUS.md).  1.0 =
    # reference-parity unstaged start.
    dt_first_scale: float = 1.0
    dt_first_steps: int = 1
    newton: NewtonConfig = field(default_factory=lambda: NewtonConfig(
        max_iter=50, rtol=1.0e-4, atol=1.0e-4, relaxation=0.9))  # ref :789-799
    # Default: the z-slab block-banded direct solver (solve.slab) — the
    # MUMPS replacement (the reference's 3D solver choice,
    # 3D/MPNP_CO2ER_pore.py:787-799).  f32 block-Thomas factorization +
    # f64 GMRES polish; converges each Newton linear system in ~3-15 inner
    # iterations where block-Jacobi BiCGStab needs ~1e3.  BiCGStab/GMRES
    # with block-Jacobi or multicolor-SSOR preconditioning remain
    # available via config as matrix-free fallbacks.
    #
    # jac_dtype stays f64: the direction error of an f32-assembled
    # Jacobian scales with cond(J)*eps_f32 ~ 1e7 * 1e-7 = O(1), and the
    # first transient step then needs ~6x the Newton iterations (31 vs 5).
    linear: LinearConfig = field(default_factory=lambda: LinearConfig(
        kind="slab_direct", tol=1.0e-6, max_refine=40))

    @property
    def species(self) -> Tuple[str, ...]:
        if self.physics == "GMPNP":
            return ("H", "OH", "HCO3", "CO32", "CO2", "CO", "H2", self.cation)
        return ("H", "OH", "HCO3", "CO32", "CO2", "CO", "H2")

    @property
    def n_fields(self) -> int:
        return len(self.species) + (1 if self.physics == "GMPNP" else 0)

    @property
    def identifier(self) -> str:
        core = (f"L_{int(self.L * 1e9)}_R_{int(self.R * 1e9)}"
                f"_P_g_{self.press_gas}_D_eff_{self.pore_geom_multiplier}"
                f"_Re_{self.electrolyte_flow_geom_multiplier}"
                f"_rough_{self.roughness_factor}")
        if self.physics == "GMPNP":
            return f"v_{self.voltage_multiplier}_{core}"
        return core


def _load_pore_mesh(cfg: Pore3DConfig):
    """Reference mesh file (GMPNP_UTILITIES) if present, else our generator
    (seven reference meshes are missing blobs and must be regenerated)."""
    util = os.environ.get("GMPNP_UTILITIES")
    name = f"L_{int(cfg.L * 1e9)}_R_{int(cfg.R * 1e9)}.xml"
    if util and os.path.exists(os.path.join(util, name)):
        mesh = read_dolfin_xml(os.path.join(util, name))
    else:
        kw = {}
        if cfg.mesh_resolution is not None:
            kw = {"n_rings": cfg.mesh_resolution[0],
                  "n_layers": cfg.mesh_resolution[1]}
        mesh = cylinder_mesh(cfg.L, cfg.R, **kw)
    return pore_boundary_markers(mesh, cfg.L, cfg.R)


@dataclass
class Pore3DProgram:
    config: Pore3DConfig
    space: FemSpace
    form: WeakForm
    bc: DirichletBC
    mesh: "base.Mesh"
    params: ParameterSet
    bulk_conc: Dict[str, float]
    diff_coeff: Dict[str, float]
    diff_coeff_eff: Dict[str, float]
    time_constant: float
    dt_scaled: float
    num_steps: int
    thermal_voltage: float
    eq_conc: Dict[str, float]          # eq CO2/CO/H2 at S1 (mol/m^3)
    fugacity_CO2: float
    h_sechenov: Dict[str, float]
    s1_verts: np.ndarray
    current_planar: float
    idx: Dict[str, int]

    def _theta_of_carry(self, carry, i):
        """Per-step Sechenov CO2 Dirichlet value from the previous solution
        (ref :815-838; rxn-diff recovers the cation by electroneutrality,
        3D/rxn_diff_CO2ER_pore.py:556-568)."""
        cfg = self.config
        u, _ = carry
        idx = self.idx
        bc0 = self.bulk_conc
        med = lambda s: jnp.median(u[:, idx[s]]) * bc0[s]
        conc_ions = {
            "OH": med("OH"), "HCO3": med("HCO3"), "CO32": med("CO32")}
        if cfg.physics == "GMPNP":
            conc_ions[cfg.cation] = med(cfg.cation)
        else:
            conc_ions[cfg.cation] = (conc_ions["HCO3"]
                                     + 2 * conc_ions["CO32"]
                                     + conc_ions["OH"] - med("H"))
        # the model's own Sechenov table (cations absent from the reference
        # constant list, e.g. Cs, salt out with h_ion = 0 — the reference
        # itself would KeyError for those, 3D/MPNP_CO2ER_pore.py:210)
        h = dict(self.h_sechenov)
        h["CO2_0"] = self.params.sechenov_CO2_0
        h["CO2_T"] = self.params.sechenov_CO2_T
        eq_CO2 = co2_saturation_conc(
            self.params.sys_params.T, self.fugacity_CO2, conc_ions,
            self.params, h_sechenov=h)
        # staged first step(s): cfg.dt_first_scale on steps < dt_first_steps
        # (traced index — no recompilation per step; see Pore3DConfig).
        # Unstaged runs keep dt as the baked-in constant (bit-identical
        # programs to pre-staging builds).
        dt = self.dt_scaled
        if cfg.dt_first_scale != 1.0:
            dt = dt * jnp.where(jnp.asarray(i) < cfg.dt_first_steps,
                                cfg.dt_first_scale, 1.0)
        return {"dt": dt, "co2_s1": eq_CO2 / bc0["CO2"]}

    def _bc_of_theta(self, theta):
        return self.bc.set_value(self.s1_verts, self.idx["CO2"],
                                 theta["co2_s1"])

    def run(self, n_steps: Optional[int] = None,
            record_full: bool = True, record_stride: int = 1,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 100):
        """Run the transient.

        record_stride bounds the on-device history to every k-th step;
        checkpoint_dir enables chunked checkpointing with automatic
        resume from the latest step (SURVEY §5 checkpoint/resume — the
        reference loses everything on a crash because outputs are written
        only after the loop, 1D/MPNP_CO2ER_EDL.py:821).
        """
        cfg = self.config
        n = self.num_steps if n_steps is None else n_steps
        retries = cfg.dt_retries
        if retries is None:
            retries = 3 if n_steps is None else 0
        if cfg.linear.refresh == "auto":
            # resolve by measurement: carried vs exact is a regime-
            # dependent trade (wins 1.4-1.6x at R=5 block sizes, loses
            # 1.22x at R=10 — timeloop.calibrate_refresh)
            import dataclasses as _dc
            nf0, ns0 = cfg.n_fields, len(cfg.species)
            u0c = jnp.ones((self.space.num_vertices, nf0))
            if cfg.physics == "GMPNP":
                u0c = u0c.at[:, ns0].set(0.0)
            mode, times = calibrate_refresh(
                self.space, self.form, cfg.newton, cfg.linear,
                self._bc_of_theta, u0c, self._theta_of_carry)
            self.refresh_calibration = dict(times, mode=mode)
            cfg = _dc.replace(cfg, linear=_dc.replace(
                cfg.linear, refresh=mode))
        carried = (cfg.linear.kind == "slab_direct"
                   and cfg.linear.refresh == "carried")
        prep_init = None
        if carried:
            # carried-factor chord Newton: the slab factorization rides
            # the scan carry and refreshes lazily (timeloop.make_carried_
            # step) — skips assembly, equilibration and factorization on
            # settled steps
            if retries > 0:
                step, prep_init = make_recovering_carried_step(
                    self.space, self.form, cfg.newton, cfg.linear,
                    bc_of_theta=self._bc_of_theta, max_retries=retries)
            else:
                step, prep_init = make_carried_step(
                    self.space, self.form, cfg.newton, cfg.linear,
                    bc_of_theta=self._bc_of_theta)
        elif retries > 0:
            step = make_recovering_step(
                self.space, self.form, cfg.newton, cfg.linear,
                bc_of_theta=self._bc_of_theta, max_retries=retries)
        else:
            step = make_implicit_step(
                self.space, self.form, cfg.newton, cfg.linear,
                bc_of_theta=self._bc_of_theta)
        nf = cfg.n_fields
        ns = len(cfg.species)
        u0 = jnp.ones((self.space.num_vertices, nf))
        if cfg.physics == "GMPNP":
            u0 = u0.at[:, ns].set(0.0)   # potential starts grounded
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
            (u_final, _), ys = run_transient_checkpointed(
                step, (u0, jnp.asarray(0.0)), n, ckpt,
                chunk=checkpoint_every,
                theta_of_carry=self._theta_of_carry,
                step_state_init=state_init)
            ckpt.close()
            if ys is None:
                # resumed at the final step: no steps ran, so there are no
                # new stats; surface the checkpointed final state as the
                # single history record so output writers (final-state
                # fields, VTK, metadata) still produce the finished run's
                # results instead of crashing
                return u0, np.asarray(u_final)[None], None, u_final
        else:
            record = None if record_full else (
                lambda u, stats: (u[self.s1_verts[:1]], stats))
            carry0 = (u0, jnp.asarray(0.0))
            if carried:
                prep0 = jax.jit(prep_init)(
                    u0, self._theta_of_carry(carry0, jnp.asarray(0)))
                (u_final, _, _), ys = run_transient(
                    step, carry0, n,
                    theta_of_carry=self._theta_of_carry,
                    record=record, record_stride=record_stride,
                    step_state0=prep0)
            else:
                (u_final, _), ys = run_transient(
                    step, carry0, n,
                    theta_of_carry=self._theta_of_carry,
                    record=record, record_stride=record_stride)
        u_hist, stats = ys
        return u0, u_hist, stats, u_final


def build(cfg: Pore3DConfig) -> Pore3DProgram:
    if cfg.physics not in ("GMPNP", "rxn_diff"):
        raise ValueError(f"unknown physics {cfg.physics!r}")
    params = base.load_params(cfg.params_file)
    nat = params.nat_const
    sysp = params.sys_params
    species = cfg.species
    ns = len(species)
    nf = cfg.n_fields
    idx = {s: i for i, s in enumerate(species)}
    P = ns if cfg.physics == "GMPNP" else None

    # effective in-layer diffusivities (Brakel & Heertjes form, ref :147-158)
    diff_coeff = {s: params.D(s) for s in species}
    diff_coeff_eff = {
        s: (diff_coeff[s] * cfg.porosity_eff * cfg.constrictivity_eff
            * cfg.pore_geom_multiplier) / cfg.tortuosity_eff ** 2
        for s in species}

    # gas split at the CL/DM interface: 90% CO / 10% H2 of the non-CO2
    # fraction (ref :217-219)
    y_CO = 0.9 * (1.0 - cfg.y_CO2)
    y_H2 = 1.0 - cfg.y_CO2 - y_CO
    fugacity_CO2 = cfg.y_CO2 * cfg.press_gas

    bulk = base.load_bulk(cfg.concentration_elec, params)
    conc = bulk.concentrations("pre")   # 3D seeds from pre-CO2 (ref :236-238)
    bulk_conc = {s: conc.get(s, conc.get("K")) for s in species}

    # equilibrium dissolved-gas concentrations at S1 (ref :253-255)
    eq_conc = {
        "CO2": params.henry_const["CO2"] * cfg.press_gas * cfg.y_CO2
        * sysp.density_e,
        "CO": params.henry_const["CO"] * cfg.press_gas * y_CO
        * sysp.density_e,
        "H2": params.henry_const["H2"] * cfg.press_gas * y_H2
        * sysp.density_e,
    }
    # bulk CO/H2 assumed at 1% of the S1 equilibrium value (ref :257-259)
    bulk_conc["CO"] = 0.01 * eq_conc["CO"]
    bulk_conc["H2"] = 0.01 * eq_conc["H2"]

    time_constant = cfg.L ** 2 / diff_coeff_eff["CO32"]
    dt_scaled = cfg.time_step / time_constant
    num_steps = int(cfg.total_sim_time / cfg.time_step)

    kin = BufferKinetics.build(
        species, bulk_conc,
        {s: diff_coeff_eff[s] for s in species},
        cfg.L, params.rate_constants)

    q = (nat.F ** 2 * cfg.L ** 2) / (nat.eps_0 * nat.R * sysp.T)
    scale_vol = np.asarray(
        [params.a(s) ** 3 * bulk_conc[s] * nat.N_A for s in species])
    z = np.asarray([params.z(s) for s in species], np.float64)
    c0 = np.asarray([bulk_conc[s] for s in species])
    thermal_voltage = nat.k_B * sysp.T / nat.e_0

    J_pref = {s: cfg.L / (diff_coeff_eff[s] * bulk_conc[s]) for s in species}

    # Sherwood mass-transfer coefficients at the pore exit (ref :297-321;
    # note they use the *plain* diffusivities)
    Re = (sysp.density_e * (sysp.vel_e / sysp.A_cross_e) * sysp.L_electrode
          * cfg.electrolyte_flow_geom_multiplier) / sysp.viscosity_e
    k_elec = {}
    for s in species:
        Sc = sysp.viscosity_e / (sysp.density_e * diff_coeff[s])
        Sh = 1.017 * ((sysp.L_electrode * 2 / sysp.L_cross_e)
                      * Re * Sc) ** (1.0 / 3.0)
        k_elec[s] = (diff_coeff[s] / sysp.L_electrode) * Sh

    current_planar = cfg.current_rough / cfg.roughness_factor
    CO_FE = 1.0 - cfg.H2_FE
    wall_flux = {
        "CO2": (J_pref["CO2"] / nat.F) * current_planar * 0.5 * CO_FE,
        "CO": (J_pref["CO"] / nat.F) * current_planar * 0.5 * CO_FE * (-1.0),
        "H2": (J_pref["H2"] / nat.F) * current_planar * 0.5 * cfg.H2_FE
        * (-1.0),
        "OH": (J_pref["OH"] / nat.F) * current_planar * (-1.0),
    }
    exit_coeff = {s: J_pref[s] * k_elec[s] * bulk_conc[s] for s in species}
    if cfg.physics == "GMPNP":
        exit_species = species          # all 8 incl. cation (ref :484-499)
    else:
        exit_species = species          # 7, no cation solved (ref :432-446)

    if cfg.physics == "GMPNP":
        w_cat = params.w(cfg.cation)
        w_H = params.w("H")
        C0_cat = bulk_conc[cfg.cation]
        C0_H = bulk_conc["H"]
        eps_rel = nat.eps_rel
        cat_i = idx[cfg.cation]

    def volume(u, gu, up, x, theta):
        uc, guc, upc = u[:ns], gu[:ns], up[:ns]
        R = kin(uc)
        fval_c = (uc - upc) / theta["dt"] - R
        if cfg.physics == "GMPNP":
            fgrad_c = guc + z[:, None] * uc[:, None] * gu[P][None, :]
            denom = 1.0 - jnp.sum(scale_vol * uc)
            if cfg.steric_clip:
                denom = jnp.maximum(denom, cfg.steric_clip)
            common = jnp.einsum("j,jd->d", scale_vol, guc)
            fgrad_c = fgrad_c + (uc / denom)[:, None] * common[None, :]
            hyd = (w_cat * u[cat_i] * C0_cat + w_H * u[0] * C0_H) * 1.0e-3
            eps = eps_rel * (55.0 - hyd) / 55.0 + 6.0 * hyd / 55.0
            fval_p = q * jnp.sum(z * c0 * uc)
            fgrad_p = -eps * gu[P]
            fval = jnp.concatenate([fval_c, jnp.asarray([fval_p])])
            fgrad = jnp.concatenate([fgrad_c, fgrad_p[None, :]])
            return fval, fgrad
        return fval_c, guc

    boundary = {}
    include_fluxes = (cfg.physics == "rxn_diff") or (not cfg.faithful)
    if include_fluxes:
        def wall(u, x, theta):
            g = jnp.zeros(nf)
            for s in ("OH", "CO2", "CO", "H2"):
                g = g.at[idx[s]].set(wall_flux[s])
            return g

        def exit_(u, x, theta):
            g = jnp.zeros(nf)
            for s in exit_species:
                g = g.at[idx[s]].set(exit_coeff[s] * (u[idx[s]] - 1.0))
            return g

        boundary = {S2: wall, S3: exit_}

    form = WeakForm(nf, volume, boundary=boundary)

    mesh = _load_pore_mesh(cfg)
    space = FemSpace.build(mesh, nf, quad_degree=cfg.quad_degree)

    def marker_verts(m):
        return np.unique(mesh.facets[mesh.facet_markers == m].reshape(-1))

    s1_verts = marker_verts(S1)
    s2_verts = marker_verts(S2)
    s3_verts = marker_verts(S3)

    entries = []
    if cfg.physics == "GMPNP":
        # application order matters on shared rim vertices: the wall value
        # wins (ref bcs list :460-467, applied in order)
        entries += [(s1_verts, P, 0.0), (s3_verts, P, 0.0),
                    (s2_verts, P, cfg.voltage_multiplier)]
    entries += [
        (s1_verts, idx["CO2"], eq_conc["CO2"] / bulk_conc["CO2"]),
        (s1_verts, idx["CO"], eq_conc["CO"] / bulk_conc["CO"]),
        (s1_verts, idx["H2"], eq_conc["H2"] / bulk_conc["H2"]),
    ]
    bc = DirichletBC.from_vertex_sets(mesh.num_vertices, nf, entries)

    h_sechenov = {s: params.sechenov_ion.get(s, 0.0)
                  for s in ("OH", "HCO3", "CO32", cfg.cation)}

    return Pore3DProgram(
        config=cfg, space=space, form=form, bc=bc, mesh=mesh, params=params,
        bulk_conc=bulk_conc, diff_coeff=diff_coeff,
        diff_coeff_eff=diff_coeff_eff, time_constant=time_constant,
        dt_scaled=dt_scaled, num_steps=num_steps,
        thermal_voltage=thermal_voltage, eq_conc=eq_conc,
        fugacity_CO2=fugacity_CO2, h_sechenov=h_sechenov,
        s1_verts=s1_verts, current_planar=current_planar, idx=idx)


def scale_conc_time(C, grad_c, bulk, tau, D_eff, L):
    """Reference ``scale_conc_time`` (3D/MPNP_CO2ER_pore.py:56-67)."""
    c = C * bulk
    t = tau * (L ** 2) / D_eff
    grad_scaled = grad_c * bulk / L
    return c, t, grad_scaled


def _sharded_stats(st):
    """StepStats from a sharded stats tuple (4-tuple, or 5-tuple when
    dt-cut recovery is on — see shard.make_sharded_transient)."""
    from gmpnp.solve.timeloop import StepStats

    if len(st) == 5:
        iters, converged, resnorm, lin_iters, dt_scale = st
    else:
        iters, converged, resnorm, lin_iters = st
        dt_scale = jnp.ones_like(resnorm)
    return StepStats(newton_iters=iters, converged=converged,
                     residual_norm=resnorm, linear_iters=lin_iters,
                     dt_scale=dt_scale)


def _run_sharded(prog: Pore3DProgram, cfg: Pore3DConfig, shard: int,
                 n_steps: Optional[int], record_stride: int,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 100):
    """Sharded-transient analogue of Pore3DProgram.run: same
    (u0, u_hist, stats, u_final) contract, computed over a ``shard``-
    device z-slab mesh (parallel.shard).

    dt-cut recovery follows the single-device auto rule (cfg.dt_retries:
    3 for full-length runs, 0 for short windows).  checkpoint_dir
    enables chunked checkpointing with automatic resume: the
    transient runs in ``checkpoint_every``-step chunks, saving the
    GLOBAL (vertex-order) solution between chunks — checkpoints are
    therefore interchangeable with single-device ones (same layout; the
    carried SPIKE factorization is derived data and is rebuilt at each
    chunk start, exactly the resume policy of the single-device path).
    Chunked histories record every step (stride 1), matching
    run_transient_checkpointed."""
    import jax

    from gmpnp.parallel.shard import make_sharded_pore_transient

    devices = jax.devices()
    if len(devices) < shard:
        hint = ("; on the CPU backend, provision a virtual mesh with "
                "--xla_force_host_platform_device_count (tests/conftest.py)"
                if devices[0].platform == "cpu" else "")
        raise ValueError(
            f"shard={shard} needs {shard} jax devices, have "
            f"{len(devices)} ({devices[0].platform}){hint}")
    n = prog.num_steps if n_steps is None else n_steps
    if cfg.linear.refresh == "auto":
        # sharded runs resolve 'auto' statically to 'carried' (the
        # measured sharded production default — the distributed chord
        # keeps the SPIKE factors as carry leaves, parallel.shard);
        # the timed calibration of timeloop.calibrate_refresh targets
        # the single-device slab path where the regime split was seen
        import dataclasses as _dc
        cfg = _dc.replace(cfg, linear=_dc.replace(cfg.linear,
                                                  refresh="carried"))
    retries = cfg.dt_retries
    if retries is None:
        retries = 3 if n_steps is None else 0
    nf = cfg.n_fields
    ns = len(cfg.species)
    u0 = jnp.ones((prog.space.num_vertices, nf))
    if cfg.physics == "GMPNP":
        u0 = u0.at[:, ns].set(0.0)

    if checkpoint_dir is None:
        run_s, u0_sharded, _plan = make_sharded_pore_transient(
            prog, devices[:shard], n_steps=n,
            refresh=cfg.linear.refresh, record_stride=record_stride,
            max_retries=retries, krylov_tol=cfg.linear.tol)
        (u_final, _), (u_hist, st) = run_s(u0_sharded)
        return u0, u_hist, _sharded_stats(st), u_final

    from gmpnp.io.checkpoint import TransientCheckpointer

    ckpt = TransientCheckpointer(checkpoint_dir, cfg=cfg)
    try:
        start, u_cur, extra = 0, np.asarray(u0), 0.0
        latest = ckpt.latest()
        if latest is not None:
            start, carry = latest
            u_cur = np.asarray(carry[0])
            extra = carry[1]
        if start >= n:
            # resumed at completion: surface the final state as the single
            # history record (mirrors Pore3DProgram.run)
            return u0, np.asarray(u_cur)[None], None, jnp.asarray(u_cur)

        runs = {}       # chunk length -> (run, u_sharding, plan)
        hist_chunks, stat_chunks = [], []
        i = start
        while i < n:
            k = min(checkpoint_every, n - i)
            if k not in runs:
                run_k, u0_sh, plan = make_sharded_pore_transient(
                    prog, devices[:shard], n_steps=k,
                    refresh=cfg.linear.refresh, record_stride=1,
                    max_retries=retries, krylov_tol=cfg.linear.tol)
                runs[k] = (run_k, u0_sh.sharding, plan)
            run_k, sharding, plan = runs[k]
            u_sh = jax.device_put(
                jnp.asarray(plan.localize(u_cur)), sharding)
            # restored extra and the ABSOLUTE step index are threaded
            # into the chunk (traced args — no recompile per chunk), so
            # theta sees the same values as an unchunked run; mirrors
            # run_transient_checkpointed
            (u_fin, extra), (u_hist_k, st_k) = run_k(
                u_sh, float(np.asarray(extra)), i)
            u_cur = np.asarray(u_fin)
            hist_chunks.append(np.asarray(u_hist_k))
            stat_chunks.append(jax.tree.map(np.asarray, st_k))
            i += k
            ckpt.save(i, (u_cur, np.asarray(extra)))
        u_hist = np.concatenate(hist_chunks, axis=0)
        st = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0),
                          *stat_chunks)
        return u0, u_hist, _sharded_stats(st), jnp.asarray(u_cur)
    finally:
        ckpt.close()


def run(cfg: Pore3DConfig, out_root: Optional[str] = None,
        write: bool = True, n_steps: Optional[int] = None,
        write_vtk: bool = True, verbose: bool = False,
        record_stride: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 100,
        shard: Optional[int] = None):
    """Full reference-parity run (npz/metadata/VTK key sets per
    3D/MPNP_CO2ER_pore.py:862-1085 and 3D/rxn_diff_CO2ER_pore.py:602-784).

    record_stride=None (default) bounds the recorded history to ~1000
    snapshots for long runs (base.auto_record_stride); pass 1 for the
    reference's record-every-step behavior.

    shard=K runs the transient z-slab-sharded over the first K jax
    devices (parallel.shard.make_sharded_pore_transient: shard_map
    domain decomposition, ppermute halo exchange, distributed SPIKE
    direct solve, cfg.linear.refresh honored including 'carried') —
    the multi-chip production path, with identical output artifacts.
    The reference gets its multi-process parallelism from mpirun over
    PETSc/MUMPS-MPI (environment.yml:73-78); here one process drives
    the whole device mesh.  Sharded runs support checkpoint/resume
    (chunked, global-layout checkpoints interchangeable with the
    single-device path) and dt-cut recovery (cfg.dt_retries auto rule)."""
    prog = build(cfg)
    if record_stride is None:
        record_stride = base.auto_record_stride(
            n_steps if n_steps is not None else prog.num_steps)
    if checkpoint_dir is not None:
        # both checkpointed drivers (run_transient_checkpointed and the
        # chunked sharded loop) record every step inside chunks; keep the
        # time-axis bookkeeping consistent with the recorded rows
        record_stride = 1
    if shard is not None:
        u0, u_hist, stats, u_final = _run_sharded(
            prog, cfg, shard, n_steps=n_steps,
            record_stride=record_stride,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every)
    else:
        u0, u_hist, stats, u_final = prog.run(
            n_steps=n_steps, record_stride=record_stride,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every)
    if verbose and stats is not None:
        from gmpnp.utils import StepLogger
        StepLogger(every=max(1, u_hist.shape[0] // 50)).log_run(
            stats, dt_phys=cfg.time_step)
    n = u_hist.shape[0]
    ns = len(cfg.species)
    idx = prog.idx

    hist = np.concatenate([np.asarray(u0)[None], np.asarray(u_hist)], axis=0)
    names = ["H", "OH", "HCO3", "CO32", "CO2", "CO", "H2"]
    if cfg.physics == "GMPNP":
        names.append("cat")
    sp_of = {nm: (cfg.cation if nm == "cat" else nm) for nm in names}
    unscaled = {nm: hist[:, :, idx[sp_of[nm]]] for nm in names}

    n_req = n_steps if n_steps is not None else prog.num_steps
    if cfg.dt_first_scale != 1.0:
        # staged start: per-step advances differ, so the time axis is the
        # cumulative sum of actual scheduled dts at the recorded steps
        step_dt = np.full(n_req, prog.dt_scaled)
        step_dt[:min(cfg.dt_first_steps, n_req)] *= cfg.dt_first_scale
        cum = np.cumsum(step_dt)
        offset = n_req - n * record_stride
        tau_array = cum[offset + record_stride * np.arange(1, n + 1) - 1]
    elif record_stride == 1 and n == n_req:
        T = prog.dt_scaled * n
        tau_array = np.linspace(0, T, n)     # reference convention
    else:
        # strided and/or resumed history: exact absolute step times —
        # recorded row j is step  (n_req - n*stride) + (j+1)*stride
        offset = n_req - n * record_stride
        tau_array = prog.dt_scaled * (
            offset + record_stride * np.arange(1, n + 1))
    coor = np.asarray(prog.mesh.points)

    # final-state gradient projections (ref :884-909) — all fields in one
    # batched mass solve (single compiled program)
    from gmpnp.fem.projection import project_cellwise
    u_last = jnp.asarray(hist[-1])
    cols = [idx[sp_of[nm]] for nm in names]
    grads_cell = jnp.einsum("caf,cad->cfd",
                            u_last[:, cols][prog.space.cells],
                            prog.space.gradN)            # (C, k, dim)
    C = grads_cell.shape[0]
    proj = project_cellwise(prog.space, grads_cell.reshape(C, -1))
    proj = np.asarray(proj).reshape(prog.space.num_vertices, len(names), 3)
    grads = {nm: proj[:, i, :] for i, nm in enumerate(names)}

    scaled, grads_scaled, times = {}, {}, {}
    for nm in names:
        sp = sp_of[nm]
        c, t, gsc = scale_conc_time(
            unscaled[nm], grads[nm], prog.bulk_conc[sp], tau_array,
            prog.diff_coeff_eff[sp], cfg.L)
        scaled[f"c_{nm}"] = c
        times[f"t_{nm}"] = t
        grads_scaled[nm] = gsc

    CO2_min = float(hist[-1, :, idx["CO2"]].min())
    metadata = {
        "concentration_elec": cfg.concentration_elec,
        "cation": cfg.cation,
        "H2_FE": cfg.H2_FE,
        "L": cfg.L,
        "R": cfg.R,
        "time_step": cfg.time_step,
        "total_sim_time": cfg.total_sim_time,
        "porosity": cfg.porosity_eff,
        "tortuosity": cfg.tortuosity_eff,
        "constrictivity": cfg.constrictivity_eff,
        "y_CO2": cfg.y_CO2,
        "press_gas": cfg.press_gas,
        "pore_geom_multiplier": cfg.pore_geom_multiplier,
        "electrolyte_flow_geom_multiplier":
            cfg.electrolyte_flow_geom_multiplier,
        "eq_conc_CO": prog.eq_conc["CO"],
        "eq_conc_H2": prog.eq_conc["H2"],
        "current_planar": prog.current_planar,
        "CO2_min": CO2_min,
        # framework extras (stats is None when a checkpointed run resumed
        # at completion: zero steps executed this invocation)
        "newton_iters_total": (
            int(np.asarray(stats.newton_iters).sum())
            if stats is not None else 0),
        "linear_iters_total": (
            int(np.asarray(stats.linear_iters).sum())
            if stats is not None else 0),
        "all_steps_converged": (
            bool(np.asarray(stats.converged).all())
            if stats is not None else True),
        "resumed_complete": stats is None,
        "dt_cut_steps": (
            int((np.asarray(stats.dt_scale) < 1.0).sum())
            if stats is not None else 0),
        "dt_first_scale": cfg.dt_first_scale,
        "dt_first_steps": cfg.dt_first_steps,
        # divergence-triggered dt cuts advance less than the scheduled
        # dt; the recorded time axis stays nominal when any engaged
        # (the staged-start schedule IS reflected in tau_array)
        "times_nominal_dt_cuts": (
            stats is not None
            and bool((np.asarray(stats.dt_scale) < 1.0).any())),
    }
    if cfg.physics == "GMPNP":
        metadata["voltage_multiplier"] = cfg.voltage_multiplier
    if getattr(prog, "refresh_calibration", None):
        # refresh='auto': record which mode the timed calibration chose
        metadata["refresh_calibration"] = prog.refresh_calibration

    result = {
        "unscaled": unscaled,
        "scaled": scaled,
        "times": times,
        "grads": grads,
        "grads_scaled": grads_scaled,
        "tau_array": tau_array,
        "coor_array": coor,
        "metadata": metadata,
        "stats": stats,
    }

    psi = None
    field_values = None
    if cfg.physics == "GMPNP":
        P = ns
        unscaled["p"] = hist[:, :, P]
        psi = unscaled["p"] * prog.thermal_voltage
        field_values = np.asarray(project_gradient(
            prog.space, jnp.asarray(hist[-1, :, P]), sign=-1.0))
        result["psi"] = psi
        result["field_values"] = field_values

    if write:
        subdir = "pore" if cfg.physics == "GMPNP" else "pore_rxn_diff"
        paths = make_run_dir(cfg.identifier, out_root=out_root, subdir=subdir)

        unscaled_npz = {nm: unscaled[nm] for nm in names}
        unscaled_npz.update({f"{nm}_grad": grads[nm] for nm in names
                             if nm != "cat" or cfg.physics == "GMPNP"})
        unscaled_npz.update({"coor": coor, "tau": tau_array})
        if cfg.physics == "GMPNP":
            unscaled_npz.update({"p": unscaled["p"],
                                 "field_values": field_values})
        save_npz(paths.file("arrays_unscaled.npz"), **unscaled_npz)

        scaled_npz = {"coor_scaled": coor * cfg.L}
        for nm in names:
            scaled_npz[f"t_{nm}"] = times[f"t_{nm}"]
            scaled_npz[f"c_{nm}"] = scaled[f"c_{nm}"]
        scaled_npz.update({f"{nm}_grad": grads_scaled[nm] for nm in names})
        if cfg.physics == "GMPNP":
            c_H, c_cat = scaled["c_H"], scaled["c_cat"]
            w_cat = prog.params.w(cfg.cation)
            w_H = prog.params.w("H")
            eps_rel = prog.params.nat_const.eps_rel
            eps_ss = (eps_rel * (55 - (w_cat * c_cat + w_H * c_H) * 1e-3) / 55
                      + 6 * ((w_cat * c_cat + w_H * c_H) * 1e-3) / 55)
            charge_density = (scaled["c_cat"][-1] - scaled["c_HCO3"][-1]
                              - 2 * scaled["c_CO32"][-1]
                              - scaled["c_OH"][-1] + scaled["c_H"][-1])
            scaled_npz.update({
                "psi": psi,
                "eps_rel": eps_ss,
                "field_values": field_values * prog.thermal_voltage / cfg.L,
                "charge_density": charge_density,
            })
        else:
            scaled_npz["c_cat"] = (scaled["c_HCO3"] + 2 * scaled["c_CO32"]
                                   + scaled["c_OH"] - scaled["c_H"])
        save_npz(paths.file("arrays_scaled.npz"), **scaled_npz)
        save_metadata(paths.file("metadata.json"), metadata)

        if write_vtk:
            # final-state VTK per species (ref :862-880)
            vtk_fields = {nm: hist[-1, :, idx[sp_of[nm]]] for nm in names}
            if cfg.physics == "GMPNP":
                vtk_fields["p"] = hist[-1, :, ns]
            for nm, arr in vtk_fields.items():
                vtu = f"solution_{nm if nm != 'cat' else cfg.cation}.vtu"
                write_vtu(paths.file(vtu), prog.mesh.points,
                          prog.mesh.cells, {nm: arr})
                write_pvd(paths.file(vtu.replace(".vtu", ".pvd")), vtu)
        result["run_dir"] = paths.run_dir

    return result
