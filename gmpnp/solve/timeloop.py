"""Implicit time integration driver.

Backward-Euler transient as a ``lax.scan`` over steps, with a damped Newton
solve per step — the whole transient compiles to one XLA program (no host
round-trips, unlike the reference's Python time loop around
``solve(F==0, ...)``, 1D/rxn_diff_planar.py:324-362).

Data-dependent per-step behavior of the reference — staged dt schedules
(1D/MPNP_CO2ER_EDL.py:270-290), the H_OHP feedback controller (:770-793),
Sechenov Dirichlet updates (3D/MPNP_CO2ER_pore.py:815-838) — enters through
``theta``: a pytree of traced scalars produced per step by a model-supplied
carry update, so none of it triggers recompilation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gmpnp.fem.assembly import FemSpace
from gmpnp.fem.dirichlet import DirichletBC
from gmpnp.fem.forms import WeakForm
from gmpnp.solve.linear import (
    block_jacobi_preconditioner,
    block_tridiag_from_ell,
    block_tridiag_solve_cr,
    block_tridiag_solve_thomas,
    dense_solve,
    gmres,
    bicgstab,
    multicolor_ssor_preconditioner,
)
from gmpnp.solve.newton import newton_solve


@dataclass(frozen=True)
class NewtonConfig:
    """Mirror of the reference solver_parameters newton_solver blocks."""
    max_iter: int = 50
    rtol: float = 1.0e-4
    atol: float = 1.0e-4
    relaxation: float = 1.0
    # backtracking halvings per iteration (0 = plain damped Newton,
    # the dolfin-parity default; see solve.newton.newton_solve)
    backtracking: int = 0
    # backtracking acceptance rule: 0.0 = strict Armijo; g > 0 = accept
    # while ||r_try|| <= g*||r|| (non-monotone bounded growth — identical
    # to plain damped Newton on every step whose residual grows by < g,
    # halving only on genuine blow-ups; see solve.newton.newton_solve)
    bt_growth: float = 0.0
    # loop style: 'fori' (bounded fori_loop + lax.cond skip, the default)
    # or 'while'.  Under jax.vmap a lax.cond body is executed for
    # EVERY lane at EVERY trip (cond lowers to select), so a vmapped sweep
    # pays max_iter full Newton iterations per step; 'while' keeps the
    # batched trip count at max-over-lanes of the actual iterations.
    loop: str = "fori"
    # assemble the residual once per iteration by carrying it through the
    # loop (see solve.newton.newton_solve)
    carry_residual: bool = True
    # cap on ||du||_inf per Newton update (direction-preserving scaling;
    # see solve.newton.newton_solve du_max — an exponent-range guard that
    # never engages on healthy steps).  None disables.
    du_max: Optional[float] = 1.0e6
    # stagnation acceptance: exit converged when the residual has
    # stagnated (no >5% improvement for stall_iters consecutive
    # iterations) below this absolute bound — the PETSc SNES 'stol'
    # idea, for a tolerance that sits under the residual-evaluation noise
    # floor of an emulated-f64 backend (solve.newton.newton_solve
    # stall_atol).  None = off.
    stall_atol: Optional[float] = None
    stall_iters: int = 4


@dataclass(frozen=True)
class LinearConfig:
    """Linear-solver selection per model.

    kind: 'tridiag_cr' (1D direct, block cyclic reduction), 'tridiag_thomas'
    (1D oracle), 'dense' (small systems), 'slab_direct' (3D direct: z-slab
    block-banded mixed-precision factorization, the MUMPS replacement —
    solve.slab), 'gmres', 'bicgstab' (3D iterative fallbacks).
    """
    kind: str = "tridiag_cr"
    tol: float = 1.0e-8
    atol: float = 0.0
    restart: int = 30
    maxiter: int = 300
    precond: str = "block_jacobi"   # 'block_jacobi' | 'ssor'
    ssor_sweeps: int = 1
    # slab_direct: iterative-refinement budget (f64 polish of the f32
    # factorization) and an optional cap on slab count (None = bandwidth).
    # Inherited value, not yet measured on a GPU.
    max_refine: int = 40
    max_slabs: Optional[int] = None
    # slab_direct factorization algorithm: 'thomas' (sequential block-
    # Thomas scan — S sequential m x m inversions) or 'cr' (slab-granular
    # block cyclic reduction — ceil(log2 S) levels of BATCHED inversions;
    # ~3x the matmul FLOPs but each level's inverses run as one batched
    # jnp.linalg.inv instead of S sequential ones).  Inherited default,
    # not yet measured on a GPU.  See solve/slab.py slab_factor_cr.
    slab_mode: str = "thomas"
    # Jacobian refresh policy for slab_direct: 'iter' re-assembles and
    # re-factors at every Newton iterate (exact Newton, the DOLFIN-parity
    # default); 'step' factors ONCE per time step at the start iterate and
    # reuses the factorization for every Newton iteration of that step
    # (modified Newton), trading a few extra cheap iterations for
    # skipping the per-iteration assemble+equilibrate+relayout+factor
    # pipeline.  Convergence is still certified on the true f64
    # residual, so both policies converge to the same solution.
    # 'carried' extends 'step' ACROSS time steps: the factorization is
    # carried in the transient scan state and only rebuilt when a step's
    # Newton fails to converge with the stale factor, or converges but
    # needs more than ``refresh_iters`` iterations (chord/modified-Newton
    # with lazy refresh — the classical quasi-Newton transient recipe).
    # On the warm phase of a settled transient this skips the entire
    # assemble+equilibrate+relayout+factor pipeline.
    # Requires the stateful step built by ``make_carried_step``.
    refresh: str = "iter"
    # 'carried' only: refresh the factorization for the next step when
    # the current step converged but needed more than this many Newton
    # iterations with the stale factor
    refresh_iters: int = 8
    # 'carried' only: iteration budget of the stale (chord) attempt before
    # falling back to exact Newton.  A frozen-Jacobian iteration is only
    # locally convergent — on strongly state-dependent systems (measured:
    # the 3D rxn-diff pore on small meshes) it can diverge outright, so
    # the chord attempt gets a short leash and the fallback re-solves the
    # step with per-iterate re-factorization (identical to refresh='iter')
    chord_max_iter: int = 16
    # 'carried' only: inner GMRES tolerance for the chord directions.
    # The chord direction is already inexact (stale Jacobian), so
    # polishing it to the exact path's `tol` (1e-8, MUMPS parity) buys
    # nothing — its error is dominated by staleness, and Newton certifies
    # on the true residual regardless.  None = use `tol`.  The exact
    # fallback always solves to `tol`.
    chord_tol: Optional[float] = 1.0e-6
    # 'carried' + kind='slab_direct' only: precision of the chord-
    # direction linear solves.  'f32' runs the whole preconditioned GMRES
    # in native f32 (solve.slab.slab_apply_f32: f32 banded solve + an f32
    # block-ELL contraction at full precision).  The direction error
    # (~1e-5 relative) is dominated by the Jacobian staleness the chord
    # already tolerates, and Newton still certifies on the true f64
    # residual — so chord_dtype changes per-iterate directions, never the
    # accepted solutions.  The exact-Newton fallback always solves f64 to
    # `tol`.  1D (tridiag_cr) keeps its all-f64 cyclic reduction.
    chord_dtype: str = "f32"
    # 'carried' only: start each step's chord attempt from the decay-
    # scaled extrapolation u_prev + clip(rho * dt/dt_prev, 0, 1.5) * du,
    # where du = u_prev - u_prevprev and rho = ||du_n||/||du_{n-1}|| is
    # the observed per-step increment decay (raw linear extrapolation
    # overshoots rapidly-settling transients; the decay scaling predicts
    # ~u_prev there and the full increment under steady drift).  With
    # the models' ABSOLUTE Newton tolerance (atol=1e-4, reference
    # parity) a good prediction lets warm steps accept at entry — ONE
    # f64 residual evaluation and zero linear solves.  The exact-Newton
    # fallback still starts from the SAFE u_prev, so a bad prediction
    # costs a failed chord attempt, never a failed step.
    chord_predict: bool = True
    # Jacobian assembly precision: 'f32' evaluates element Jacobians in
    # float32 (inexact Newton; residuals and convergence checks stay f64).
    # A ~1e-7-relative Jacobian error is invisible at the reference's
    # 1e-4 Newton tolerances.
    jac_dtype: str = "f64"
    # inner-solve precision for the Krylov kinds (gmres, bicgstab): "f32"
    # runs the iteration in float32 on the block-Jacobi-equilibrated system
    # and returns the update in f64.  Inexact-Newton theory (and the
    # reference's 1e-4 Newton tolerances) only need ~1e-6 relative inner
    # accuracy, which f32 delivers.  The direct kinds ignore it.
    solve_dtype: str = "f64"        # 'f64' | 'f32'


class StepStats(NamedTuple):
    newton_iters: jnp.ndarray
    converged: jnp.ndarray
    residual_norm: jnp.ndarray
    linear_iters: jnp.ndarray
    # dt actually used / scheduled dt: 1.0 on the plain path; 0.5**k after
    # k divergence-triggered halvings by make_recovering_step
    dt_scale: Any = 1.0


_LINEAR_KINDS = ("tridiag_cr", "tridiag_thomas", "dense", "slab_direct",
                 "gmres", "bicgstab")


def _validate_linear_config(cfg: LinearConfig) -> None:
    """Fail fast on unrecognized string knobs (a typo like refresh='Step'
    would otherwise silently run exact Newton)."""
    if cfg.kind not in _LINEAR_KINDS:
        raise ValueError(
            f"unknown linear solver kind {cfg.kind!r}; one of {_LINEAR_KINDS}")
    if cfg.refresh not in ("iter", "step", "carried", "auto"):
        raise ValueError(f"refresh must be 'iter', 'step', 'carried' or "
                         f"'auto', got {cfg.refresh!r}")
    if cfg.slab_mode not in ("thomas", "cr"):
        raise ValueError(f"slab_mode must be 'thomas' or 'cr', got "
                         f"{cfg.slab_mode!r}")
    if cfg.precond not in ("block_jacobi", "ssor", "amg"):
        raise ValueError(f"precond must be 'block_jacobi', 'ssor' or "
                         f"'amg', got {cfg.precond!r}")
    if cfg.jac_dtype not in ("f32", "f64"):
        raise ValueError(f"jac_dtype must be 'f32' or 'f64', got "
                         f"{cfg.jac_dtype!r}")
    if cfg.solve_dtype not in ("f32", "f64"):
        raise ValueError(f"solve_dtype must be 'f32' or 'f64', got "
                         f"{cfg.solve_dtype!r}")
    if cfg.chord_dtype not in ("f32", "f64"):
        raise ValueError(f"chord_dtype must be 'f32' or 'f64', got "
                         f"{cfg.chord_dtype!r}")


def make_linear_solver(space: FemSpace, form: WeakForm, cfg: LinearConfig):
    """(bc, u_prev, theta) -> callable (u, r) -> (du, linear_iters)."""
    _validate_linear_config(cfg)
    if cfg.refresh == "carried":
        raise ValueError(
            "refresh='carried' carries the factorization across time steps "
            "and needs the stateful step protocol — build the step with "
            "make_carried_step (models wire this automatically)")
    if cfg.refresh == "auto":
        raise ValueError(
            "refresh='auto' must be resolved to a concrete mode before "
            "building a step — call calibrate_refresh (models wire this "
            "automatically in their run() paths)")
    slab_plan = None
    if cfg.kind == "slab_direct":
        from gmpnp.solve.slab import SlabPlan
        slab_plan = SlabPlan.build(
            np.asarray(space.adj), np.asarray(space.points)[:, -1],
            space.n_fields, np.asarray(space.diag_slot),
            max_slabs=cfg.max_slabs)
    amg_plan = None
    if cfg.precond == "amg" and cfg.kind in ("gmres", "bicgstab"):
        # aggregation structure depends only on the mesh graph: built once
        # per space, shared by every assembled matrix (solve.amg)
        from gmpnp.solve.amg import AMGPlan
        amg_plan = AMGPlan.build(np.asarray(space.adj), space.n_fields)

    def solver(bc: DirichletBC, u_prev, theta):
        aux = theta.get("_aux") if isinstance(theta, dict) else None

        def assemble(u, out_dtype):
            jdt = jnp.float32 if cfg.jac_dtype == "f32" else None
            ell_raw = space.jacobian(form, u, u_prev, theta, aux=aux,
                                     dtype=jdt)
            if jdt is not None:
                from gmpnp.fem.assembly import BlockELL
                ell_raw = BlockELL(ell_raw.adj,
                                   ell_raw.flat.astype(out_dtype),
                                   ell_raw.diag_slot)
            return bc.apply_to_jacobian(ell_raw)

        if cfg.kind == "slab_direct" and cfg.refresh == "step":
            # modified Newton: factor once at the step's start iterate
            # (identical to the first exact-Newton iterate, since Newton
            # starts at bc.project(u_prev)), reuse for all iterations
            from gmpnp.solve.slab import slab_apply, slab_prepare
            u0 = bc.project(u_prev)
            prep = slab_prepare(assemble(u0, u0.dtype), slab_plan,
                                mode=cfg.slab_mode)

            def lin_frozen(u, r):
                res = slab_apply(prep, r, slab_plan, tol=cfg.tol,
                                 max_refine=cfg.max_refine)
                return res.x, res.iters

            return lin_frozen

        def lin(u, r):
            jdt = jnp.float32 if cfg.jac_dtype == "f32" else None
            ell_raw = space.jacobian(form, u, u_prev, theta, aux=aux,
                                     dtype=jdt)
            if jdt is not None:
                # promote storage back to the solve dtype: values carry f32
                # accuracy (inexact Newton) but downstream iterations stay
                # numerically stable in f64
                from gmpnp.fem.assembly import BlockELL
                ell_raw = BlockELL(ell_raw.adj, ell_raw.flat.astype(r.dtype),
                                   ell_raw.diag_slot)
            ell = bc.apply_to_jacobian(ell_raw)
            zero = jnp.array(0, jnp.int32)
            if cfg.kind == "tridiag_cr":
                lo, di, up = block_tridiag_from_ell(ell)
                return block_tridiag_solve_cr(lo, di, up, r), zero
            if cfg.kind == "tridiag_thomas":
                lo, di, up = block_tridiag_from_ell(ell)
                return block_tridiag_solve_thomas(lo, di, up, r), zero
            if cfg.kind == "dense":
                return dense_solve(ell, r), zero
            if cfg.kind == "slab_direct":
                from gmpnp.solve.slab import slab_direct_solve
                res = slab_direct_solve(ell, r, slab_plan, tol=cfg.tol,
                                        max_refine=cfg.max_refine,
                                        mode=cfg.slab_mode)
                return res.x, res.iters
            out_dtype = r.dtype
            if cfg.solve_dtype == "f32":
                # equilibrate in f64 first: bake the block-Jacobi left
                # preconditioner into the matrix so every block row is O(1),
                # then run the Krylov iteration in native f32.  Without this
                # the raw system's ~1e8 row-scale range exceeds what f32
                # rounding can resolve and Newton diverges.
                from gmpnp.fem.assembly import BlockELL
                from gmpnp.solve.smallblock import block_inv
                Dinv = block_inv(ell.diag_blocks())
                ell = ell.scale_rows(Dinv)
                ell = BlockELL(ell.adj, ell.flat.astype(jnp.float32),
                               ell.diag_slot)
                r = jnp.einsum("nfg,ng->nf", Dinv, r).astype(jnp.float32)
            if cfg.precond == "ssor":
                pc = multicolor_ssor_preconditioner(
                    ell, space.colors, sweeps=cfg.ssor_sweeps)
            elif cfg.precond == "amg":
                from gmpnp.solve.amg import amg_preconditioner
                pc = amg_preconditioner(ell, amg_plan)
            else:
                pc = block_jacobi_preconditioner(ell)
            if cfg.kind == "gmres":
                res = gmres(ell.matvec, r, Minv=pc, tol=cfg.tol,
                            atol=cfg.atol, restart=cfg.restart,
                            maxiter=cfg.maxiter)
            elif cfg.kind == "bicgstab":
                res = bicgstab(ell.matvec, r, Minv=pc, tol=cfg.tol,
                               atol=cfg.atol, maxiter=cfg.maxiter)
            else:
                raise ValueError(f"unknown linear solver {cfg.kind!r}")
            return res.x.astype(out_dtype), res.iters

        return lin

    return solver


def make_implicit_step(
    space: FemSpace,
    form: WeakForm,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable[[Any], DirichletBC],
):
    """Build the per-step solve: (u_prev, theta) -> (u_new, StepStats)."""
    lin_builder = make_linear_solver(space, form, linear_cfg)

    def step(u_prev: jnp.ndarray, theta) -> Tuple[jnp.ndarray, StepStats]:
        bc = bc_of_theta(theta)
        aux = theta.get("_aux") if isinstance(theta, dict) else None

        def residual(u):
            return bc.apply_to_residual(
                space.residual(form, u, u_prev, theta, aux=aux), u)

        lin = lin_builder(bc, u_prev, theta)
        res = newton_solve(
            residual, lin, bc.project(u_prev),
            rtol=newton_cfg.rtol, atol=newton_cfg.atol,
            max_iter=newton_cfg.max_iter,
            relaxation=newton_cfg.relaxation,
            loop=newton_cfg.loop,
            backtracking=newton_cfg.backtracking,
            bt_growth=newton_cfg.bt_growth,
            carry_residual=newton_cfg.carry_residual,
            du_max=newton_cfg.du_max,
            stall_atol=newton_cfg.stall_atol,
            stall_iters=newton_cfg.stall_iters)
        stats = StepStats(
            newton_iters=res.iterations,
            converged=res.converged,
            residual_norm=res.residual_norm,
            linear_iters=res.linear_iters)
        return res.u, stats

    return step


class ChordCarry(NamedTuple):
    """Scan-carried state of the carried-factor chord Newton step.

    Opaque to callers (models/bench thread it through scans and rebuild
    it on checkpoint resume via ``prep_init`` — everything here is
    DERIVED data, never checkpointed):

    - ``prep``: the stale factorization (solve.slab.SlabPrepared for 3D,
      linear CRFactors for 1D);
    - ``du``: the previous accepted step's state increment u_n - u_{n-1}
      (zeros at init/resume — the first step simply predicts u_prev);
    - ``dt_prev``: the dt that produced ``du`` (for the extrapolation
      ratio under staged-dt schedules and recovery halvings);
    - ``du_nrm_prev``: ||u_{n-1} - u_{n-2}|| — the increment norm BEFORE
      ``du``, for the decay estimate rho = ||du||/du_nrm_prev.  Raw
      linear extrapolation overshoots on rapidly SETTLING transients
      (the cold-start equilibration jump of step 1 extrapolated into
      step 2 costs extra chord iterations); scaling by the observed
      geometric decay predicts ~u_prev when settling and the full
      increment when drifting steadily (and is self-consistent: an
      entry-accepted prediction yields du_new = rho*du exactly, keeping
      the estimate alive).
    """
    prep: Any
    du: jnp.ndarray
    dt_prev: jnp.ndarray
    du_nrm_prev: jnp.ndarray


def make_carried_step(
    space: FemSpace,
    form: WeakForm,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable[[Any], DirichletBC],
    dt_key: str = "dt",
):
    """Carried-factor transient step (``LinearConfig.refresh='carried'``).

    Returns ``(step, prep_init)`` where

        step: (u_prev, theta, carry) -> (u_new, StepStats, carry_new)
        prep_init: (u0, theta) -> ChordCarry

    The slab factorization (``solve.slab.SlabPrepared``) rides the
    transient scan carry instead of being rebuilt per Newton iterate
    ('iter') or per step ('step').  Each step first runs Newton against
    the carried (stale) factorization — a chord/modified-Newton iteration
    whose convergence is still certified on the true f64 residual, with
    an iteration budget of ``linear_cfg.chord_max_iter`` (a chord
    iteration is only locally convergent; the short leash bounds the
    wasted work when it stalls or diverges).  The factorization is
    rebuilt only when

    - the chord attempt does NOT converge within its budget: the step is
      then re-solved with EXACT Newton (per-iterate re-assembly and
      re-factorization, identical to refresh='iter' — so a carried
      transient converges whenever an exact-Newton transient does), and
      the factor is refreshed at the accepted state for the next step; or
    - it converges but needs more than ``linear_cfg.refresh_iters``
      iterations (the factor is refreshed at the accepted state for the
      NEXT step, without re-solving).

    On the warm phase of a settled transient (the reference's 3D pore
    run settles after step 1, 3D/MPNP_CO2ER_pore.py:783-858) this skips
    the whole assemble+equilibrate+relayout+factor pipeline, leaving
    only residual evaluations and banded applies.

    Two further warm-path reductions (round 3, both default-on):

    - ``linear_cfg.chord_predict``: the chord attempt starts from the
      decay-scaled extrapolation ``u_prev + clip(rho*dt/dt_prev) * du``
      carried in ``ChordCarry`` (rho = observed increment decay — see
      ChordCarry for why raw extrapolation loses).  Acceptance is
      ``||r|| < atol OR ||r|| < rtol*||r0||`` (DOLFIN parity):
      prediction can only shrink the required reduction (the rtol
      factor is fixed; the atol floor engages as r0 shrinks), and a
      step whose predicted entry residual is already below atol costs
      ONE f64 residual evaluation total.  The exact-Newton fallback
      always starts from the safe u_prev.
    - ``linear_cfg.chord_dtype='f32'`` (slab_direct only): chord
      directions solve in native f32 (solve.slab.slab_apply_f32) — the
      f32 banded apply plus an f32 block-ELL contraction inside an
      all-f32 GMRES.  Direction error (~1e-5) is
      dominated by the Jacobian staleness the chord already tolerates;
      convergence is still certified on the true f64 residual.

    NOTE: under ``jax.vmap`` the two ``lax.cond`` branches both execute
    for every lane (cond lowers to select), so vmapped sweeps would pay
    the refresh on every step; use host-chunked lanes (parallel.sweep)
    or refresh='iter' there.
    """
    _validate_linear_config(linear_cfg)
    if linear_cfg.kind not in ("slab_direct", "tridiag_cr"):
        raise ValueError(
            "make_carried_step requires a direct kind whose factorization "
            "can ride the carry ('slab_direct' for 3D, 'tridiag_cr' for "
            f"1D), got {linear_cfg.kind!r}")

    def assemble(u, u_prev, theta, bc):
        aux = theta.get("_aux") if isinstance(theta, dict) else None
        jdt = jnp.float32 if linear_cfg.jac_dtype == "f32" else None
        ell_raw = space.jacobian(form, u, u_prev, theta, aux=aux, dtype=jdt)
        if jdt is not None:
            from gmpnp.fem.assembly import BlockELL
            ell_raw = BlockELL(ell_raw.adj, ell_raw.flat.astype(u.dtype),
                               ell_raw.diag_slot)
        return bc.apply_to_jacobian(ell_raw)

    if linear_cfg.kind == "slab_direct":
        from gmpnp.solve.slab import SlabPlan, slab_apply, slab_prepare

        plan = SlabPlan.build(
            np.asarray(space.adj), np.asarray(space.points)[:, -1],
            space.n_fields, np.asarray(space.diag_slot),
            max_slabs=linear_cfg.max_slabs)

        def prep_of(u, u_prev, theta, bc):
            return slab_prepare(assemble(u, u_prev, theta, bc), plan,
                                mode=linear_cfg.slab_mode)
    else:
        # 1D: carry the all-f64 cyclic-reduction factorization (the chord
        # apply below is exact for the stale matrix, so chord quality is
        # governed by staleness alone)
        from gmpnp.solve.linear import block_tridiag_factor_cr

        def prep_of(u, u_prev, theta, bc):
            lo, di, up = block_tridiag_from_ell(
                assemble(u, u_prev, theta, bc))
            return block_tridiag_factor_cr(lo, di, up)

    def _dt_of(theta):
        if isinstance(theta, dict) and dt_key in theta:
            return jnp.asarray(theta[dt_key], jnp.float64)
        return jnp.asarray(1.0, jnp.float64)

    def prep_init(u0, theta):
        bc = bc_of_theta(theta)
        return ChordCarry(
            prep=prep_of(bc.project(u0), u0, theta, bc),
            du=jnp.zeros_like(u0),
            dt_prev=_dt_of(theta),
            du_nrm_prev=jnp.asarray(0.0, jnp.float64))

    # exact-Newton fallback: per-iterate assemble+factor, as refresh='iter'
    exact_lin_builder = make_linear_solver(
        space, form, dataclasses.replace(linear_cfg, refresh="iter"))

    def step(u_prev, theta, carry):
        prep = carry.prep
        bc = bc_of_theta(theta)
        aux = theta.get("_aux") if isinstance(theta, dict) else None

        def residual(u):
            return bc.apply_to_residual(
                space.residual(form, u, u_prev, theta, aux=aux), u)

        chord_tol = (linear_cfg.tol if linear_cfg.chord_tol is None
                     else linear_cfg.chord_tol)

        if linear_cfg.kind == "slab_direct":
            if linear_cfg.chord_dtype == "f32":
                # native-f32 chord directions: f32 banded solve + f32
                # block-ELL contraction inside an all-f32 GMRES.  The f32
                # Givens recursion stalls below ~1e-6 relative, so the
                # tolerance is floored there (direction quality is
                # staleness-dominated anyway; Newton certifies on the
                # true f64 residual).
                from gmpnp.solve.slab import slab_apply_f32
                tol32 = max(chord_tol, 1.0e-6)

                def lin_of(p):
                    def lin(u, r):
                        res = slab_apply_f32(
                            p, r, plan, tol=tol32,
                            max_refine=min(linear_cfg.max_refine, 16))
                        return res.x, res.iters
                    return lin
            else:
                def lin_of(p):
                    def lin(u, r):
                        res = slab_apply(p, r, plan, tol=chord_tol,
                                         max_refine=linear_cfg.max_refine)
                        return res.x, res.iters
                    return lin
        else:
            from gmpnp.solve.linear import block_tridiag_apply_cr

            def lin_of(p):
                def lin(u, r):
                    return (block_tridiag_apply_cr(p, r),
                            jnp.array(0, jnp.int32))
                return lin

        u0_safe = bc.project(u_prev)
        nrm_du = jnp.linalg.norm(carry.du)
        if linear_cfg.chord_predict:
            # decay-aware extrapolated start for the CHORD attempt only:
            # with the models' absolute Newton tolerance (atol=1e-4) a
            # good prediction lets warm steps accept at entry — one
            # residual evaluation, zero linear solves.  The increment is
            # scaled by the OBSERVED geometric decay rho = ||du_n|| /
            # ||du_{n-1}|| (raw linear extrapolation overshoots settling
            # transients — see ChordCarry) times the dt ratio (staged-dt
            # schedules), clipped; du=0 at init/resume predicts u_prev.
            dt = _dt_of(theta)
            rho = jnp.where(carry.du_nrm_prev > 0,
                            nrm_du / jnp.maximum(carry.du_nrm_prev, 1e-300),
                            0.0)
            ratio = jnp.where(carry.dt_prev > 0, dt / carry.dt_prev, 0.0)
            factor = jnp.clip(rho * ratio, 0.0, 1.5).astype(u_prev.dtype)
            u0_chord = bc.project(u_prev + factor * carry.du)
        else:
            u0_chord = u0_safe

        def run_newton(lin, max_iter, u0):
            return newton_solve(
                residual, lin, u0,
                rtol=newton_cfg.rtol, atol=newton_cfg.atol,
                max_iter=max_iter,
                relaxation=newton_cfg.relaxation,
                loop=newton_cfg.loop,
                backtracking=newton_cfg.backtracking,
                bt_growth=newton_cfg.bt_growth,
                carry_residual=newton_cfg.carry_residual,
                du_max=newton_cfg.du_max,
                stall_atol=newton_cfg.stall_atol,
                stall_iters=newton_cfg.stall_iters)

        res1 = run_newton(
            lin_of(prep),
            min(linear_cfg.chord_max_iter, newton_cfg.max_iter),
            u0_chord)

        def fresh(_):
            # exact-Newton re-solve from the SAFE start (a bad
            # extrapolation must never make the recovery path worse
            # than the pre-predictor behavior)
            res2 = run_newton(exact_lin_builder(bc, u_prev, theta),
                              newton_cfg.max_iter, u0_safe)
            return res2, prep_of(res2.u, u_prev, theta, bc)

        def keep(_):
            return res1, prep

        res, prep_used = jax.lax.cond(~res1.converged, fresh, keep, None)

        # proactive refresh for the NEXT step when the stale factor made
        # this (converged) step slow; the fresh branch above already
        # produced a fresh factorization, so only the keep path refreshes
        slow = res1.converged & (res1.iterations > linear_cfg.refresh_iters)
        prep_new = jax.lax.cond(
            slow, lambda _: prep_of(res.u, u_prev, theta, bc),
            lambda _: prep_used, None)

        stats = StepStats(
            newton_iters=res.iterations,
            converged=res.converged,
            residual_norm=res.residual_norm,
            linear_iters=res.linear_iters)
        carry_new = ChordCarry(prep=prep_new, du=res.u - u_prev,
                               dt_prev=_dt_of(theta),
                               du_nrm_prev=nrm_du)
        return res.u, stats, carry_new

    return step, prep_init


def make_retrying_step(
    step: Callable,
    max_retries: int = 3,
    dt_key: str = "dt",
):
    """Wrap a ``(u_prev, theta) -> (u_new, StepStats)`` step with
    divergence-triggered dt halving (SURVEY.md §5: the reference has no
    recovery — a diverged Newton kills the run and all results are lost).

    If the Newton solve does not converge, the step is retried with
    ``theta[dt_key]`` halved, up to ``max_retries`` times (dt/2, dt/4, ...).
    Returns ``(u_new, stats, dt_scale)`` where stats are those of the
    accepted attempt and the dt actually used is
    ``theta[dt_key] * dt_scale``.  Compiles the inner step once
    (lax.while_loop over attempts).

    NOTE: a successful retry advances physical time by less than the
    schedule's dt — callers that track absolute time must accumulate
    ``stats.dt_scale * theta[dt_key]`` rather than dt itself.
    """

    def retry_step(u_prev, theta):
        dt0 = jnp.asarray(theta[dt_key])  # models may carry dt as a float

        def attempt(k):
            th = dict(theta)
            th[dt_key] = dt0 * (0.5 ** k.astype(dt0.dtype))
            return step(u_prev, th)

        u1, st1 = attempt(jnp.asarray(0))

        def cond(state):
            k, u, st = state
            return (~st.converged) & (k < max_retries)

        def body(state):
            k, u, st = state
            u2, st2 = attempt(k + 1)
            return (k + 1, u2, st2)

        k, u, st = jax.lax.while_loop(cond, body, (jnp.asarray(0), u1, st1))
        return u, st, 0.5 ** k.astype(dt0.dtype)

    return retry_step


def make_recovering_step(
    space: FemSpace,
    form: WeakForm,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable[[Any], DirichletBC],
    max_retries: int = 3,
):
    """Production step with divergence recovery: ``make_implicit_step``
    wrapped in ``make_retrying_step``, with the accepted attempt's dt
    halving factor recorded in ``StepStats.dt_scale`` so transients track
    the physical time actually advanced.

    This is the default for full-length model runs (without it a diverged
    full-length run scans past the failure recording converged=False —
    the reference's failure mode with better logging).  Step signature
    matches make_implicit_step.
    """
    base = make_implicit_step(space, form, newton_cfg, linear_cfg,
                              bc_of_theta)
    retry = make_retrying_step(base, max_retries=max_retries)

    def step(u_prev, theta):
        u, st, scale = retry(u_prev, theta)
        return u, st._replace(dt_scale=scale)

    return step


def make_recovering_carried_step(
    space: FemSpace,
    form: WeakForm,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable[[Any], DirichletBC],
    max_retries: int = 3,
    dt_key: str = "dt",
):
    """Carried-factor step with divergence-triggered dt halving — the
    stateful analogue of ``make_recovering_step`` for
    ``LinearConfig.refresh='carried'``.

    Step signature: ``(u_prev, theta, prep) -> (u_new, stats, prep_new)``
    with ``stats.dt_scale`` recording the accepted halving factor.  Note
    the carried step already retries a non-converged attempt once with a
    fresh factorization at the SAME dt (make_carried_step); the dt
    halvings here engage only when even the fresh factor cannot converge
    the step.
    """
    base, prep_init = make_carried_step(space, form, newton_cfg,
                                        linear_cfg, bc_of_theta)

    def step(u_prev, theta, prep):
        dt0 = jnp.asarray(theta[dt_key])

        def attempt(k, p):
            th = dict(theta)
            th[dt_key] = dt0 * (0.5 ** k.astype(dt0.dtype))
            return base(u_prev, th, p)

        u1, st1, p1 = attempt(jnp.asarray(0), prep)

        def cond(state):
            k, u, st, p = state
            return (~st.converged) & (k < max_retries)

        def body(state):
            k, u, st, p = state
            th = dict(theta)
            th[dt_key] = dt0 * (0.5 ** (k + 1).astype(dt0.dtype))
            # rebuild the carried factorization at the HALVED dt: the
            # factor embeds dt, so a chord attempt against the un-halved
            # factor is a near-guaranteed miss that wastes a full chord
            # solve before the exact fallback.  prep_init
            # also zeroes du, so the retry's chord attempt starts from
            # the safe u_prev instead of extrapolating the failed
            # attempt's garbage increment.
            p = prep_init(u_prev, th)
            u2, st2, p2 = base(u_prev, th, p)
            return (k + 1, u2, st2, p2)

        k, u, st, p = jax.lax.while_loop(
            cond, body, (jnp.asarray(0), u1, st1, p1))
        return u, st._replace(dt_scale=0.5 ** k.astype(dt0.dtype)), p

    return step, prep_init


def run_transient(
    step: Callable,
    carry0,
    n_steps: int,
    update_carry: Optional[Callable] = None,
    theta_of_carry: Optional[Callable] = None,
    record: Optional[Callable] = None,
    jit: bool = True,
    record_stride: int = 1,
    step_state0=None,
):
    """Generic transient driver.

    carry = (u, extra); per step:
        theta = theta_of_carry(carry, step_index)
        u_new, stats = step(u, theta)
        extra_new = update_carry(extra, u_new, step_index)
        y = record(u_new, stats)

    Returns (final_carry, stacked_ys).

    ``record_stride=k`` bounds the recorded history to every k-th step
    (the reference vstacks every field at every step with unbounded
    memory, 1D/MPNP_CO2ER_EDL.py:757-763; SURVEY §5 asks for bounded
    history).  Implemented as a nested scan — the inner scan advances k
    steps, the outer scan emits one record per k — so the history buffer
    on device is n_steps/k, not n_steps.  Requires k | n_steps.

    ``step_state0`` opts into the STATEFUL step protocol (the carried
    slab factorization of ``make_carried_step``): the step is called as
    ``step(u, theta, state) -> (u_new, stats, state_new)`` and the state
    rides the scan carry.  The return becomes
    ``((u_final, extra_final, state_final), stacked_ys)`` — one extra
    carry element, so stateful callers unpack three.
    """
    if update_carry is None:
        update_carry = lambda extra, u, i: extra
    if theta_of_carry is None:
        theta_of_carry = lambda carry, i: None
    if record is None:
        record = lambda u, stats: (u, stats)

    stateful = step_state0 is not None

    def body(carry, i):
        if stateful:
            u, extra, st = carry
        else:
            u, extra = carry
        theta = theta_of_carry((u, extra), i)
        if stateful:
            u_new, stats, st_new = step(u, theta, st)
        else:
            u_new, stats = step(u, theta)
        extra_new = update_carry(extra, u_new, i)
        new_carry = ((u_new, extra_new, st_new) if stateful
                     else (u_new, extra_new))
        return new_carry, record(u_new, stats)

    if stateful:
        carry0 = (*carry0, step_state0)

    if record_stride <= 1:
        def run(carry0):
            return jax.lax.scan(body, carry0, jnp.arange(n_steps))
    else:
        k = record_stride
        if n_steps % k:
            raise ValueError(
                f"record_stride {k} must divide n_steps {n_steps}")

        # advance k steps per outer iteration, keep only the k-th record
        def outer_body(carry, j):
            def inner(carry, jj):
                new_carry, _ = body(carry, j * k + jj)
                return new_carry, None

            carry2, _ = jax.lax.scan(inner, carry, jnp.arange(k - 1))
            carry3, y = body(carry2, j * k + (k - 1))
            return carry3, y

        def run(carry0):
            return jax.lax.scan(outer_body, carry0,
                                jnp.arange(n_steps // k))

    if jit:
        run = jax.jit(run)
    return run(carry0)


def calibrate_refresh(
    space,
    form,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable,
    u0: jnp.ndarray,
    theta_of_carry: Callable,
    extra0=None,
    warm_steps: int = 2,
    probe_steps: int = 4,
    reps: int = 2,
):
    """Resolve ``LinearConfig.refresh='auto'`` by measurement.

    Carried-factor chord Newton vs exact Newton is a regime-dependent
    trade: where a settled transient needs very few exact iterations,
    chord attempts + refreshes can cost more than they save.  The winner
    depends on block size, mesh, physics and hardware — so it is picked
    per run, by running both compiled step programs on a WARM state and
    timing them.

    Protocol: advance ``warm_steps`` exact steps from ``u0`` (settles
    the cold-start spike so the measurement reflects the warm regime
    where a transient spends its life), then time ``probe_steps``-step
    windows of each program from that same warm state, best of ``reps``.
    The carried window includes its initial factorization — a slight
    bias against carried (production refactors rarer), acceptable at
    the 1.2x+ decision margins observed.

    Returns ``(mode, times)`` where mode is 'carried' or 'iter' and
    times records the measured window seconds.  Cost: three program
    compiles + (warm_steps + (2 + reps) * 2 * probe_steps) steps —
    amortized over production-length transients (the reference's 3D
    schedule is 1,000 steps, 3D/MPNP_CO2ER_pore.py:358-365).
    """
    import time as _time

    if linear_cfg.kind != "slab_direct":
        # auto only arbitrates the 3D slab path; 1D (tridiag_cr) takes
        # carried
        return "carried" if linear_cfg.kind == "tridiag_cr" else "iter", {}

    if extra0 is None:
        extra0 = jnp.asarray(0.0)
    lin_e = dataclasses.replace(linear_cfg, refresh="iter")
    step_e = make_implicit_step(space, form, newton_cfg, lin_e,
                                bc_of_theta=bc_of_theta)
    lin_c = dataclasses.replace(linear_cfg, refresh="carried")
    step_c, prep_init = make_carried_step(space, form, newton_cfg, lin_c,
                                          bc_of_theta=bc_of_theta)

    def win_exact(u):
        def body(carry, i):
            uu, extra = carry
            th = theta_of_carry((uu, extra), i)
            u2, st = step_e(uu, th)
            return (u2, extra), st.newton_iters

        (u2, _), it = jax.lax.scan(body, (u, extra0),
                                   jnp.arange(probe_steps))
        return u2, it

    def win_carried(u):
        th0 = theta_of_carry((u, extra0), jnp.asarray(0))
        prep0 = prep_init(u, th0)

        def body(carry, i):
            uu, extra, prep = carry
            th = theta_of_carry((uu, extra), i)
            u2, st, prep = step_c(uu, th, prep)
            return (u2, extra, prep), st.newton_iters

        (u2, _, _), it = jax.lax.scan(body, (u, extra0, prep0),
                                      jnp.arange(probe_steps))
        return u2, it

    we = jax.jit(win_exact).lower(u0).compile()
    u_warm = u0
    for _ in range(max(1, -(-warm_steps // probe_steps))):
        u_warm, _ = we(u_warm)
    jax.block_until_ready(u_warm)
    wc = jax.jit(win_carried).lower(u_warm).compile()

    def best_of(fn):
        fn(u_warm)                      # warm-up execution
        ts = []
        for _ in range(reps):
            t0 = _time.perf_counter()
            out, _ = fn(u_warm)
            jax.block_until_ready(out)
            ts.append(_time.perf_counter() - t0)
        return min(ts)

    t_c = best_of(wc)
    t_e = best_of(we)
    mode = "carried" if t_c <= t_e else "iter"
    return mode, {"carried_window_s": round(t_c, 4),
                  "iter_window_s": round(t_e, 4),
                  "probe_steps": probe_steps}
