"""Damped Newton with DOLFIN-compatible convergence semantics.

Replicates dolfin::NewtonSolver as configured by the reference's
``solver_parameters`` dicts (1D/MPNP_CO2ER_EDL.py:357-364,
3D/MPNP_CO2ER_pore.py:789-799):

- convergence test on the l2 norm of the BC-applied residual:
  converged iff ||r|| < atol  OR  ||r|| < rtol * ||r0||
  (checked on the initial residual and after every update);
- update u <- u - relaxation * du with J du = r;
- hard cap on iterations (`maximum_iterations`), non-convergence reported,
  not raised (the time driver decides what to do).

Implemented as a ``lax.while_loop`` so an entire transient — Newton inside
backward-Euler inside ``lax.scan`` — jit-compiles into one XLA program.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class NewtonResult(NamedTuple):
    u: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    residual_norm: jnp.ndarray
    initial_residual_norm: jnp.ndarray
    linear_iters: jnp.ndarray


def _l2(r):
    # Scale-safe l2: entries are pre-scaled by the max magnitude so the
    # squares cannot overflow during a divergence excursion.  A backend
    # that emulates f64 with f32 pairs keeps the f32 EXPONENT range
    # (~1e38), where a plain sum-of-squares of a transiently blown-up
    # Newton residual overflows; real-f64 backends absorb it.  Healthy
    # norms agree with the naive form to machine precision.
    amax = jnp.max(jnp.abs(r))
    scale = jnp.maximum(amax, 1e-30)   # representable in f32 exponents
    return scale * jnp.sqrt(jnp.sum((r / scale) ** 2))


def newton_solve(
    residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
    linear_solve_fn: Callable[[jnp.ndarray, jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]],
    u0: jnp.ndarray,
    rtol: float = 1e-4,
    atol: float = 1e-4,
    max_iter: int = 50,
    relaxation: float = 1.0,
    loop: str = "fori",
    backtracking: int = 0,
    bt_growth: float = 0.0,
    carry_residual: bool = True,
    du_max: float = 1.0e6,
    stall_atol: float = None,
    stall_iters: int = 4,
) -> NewtonResult:
    """Solve F(u) = 0.

    Parameters
    ----------
    residual_fn : u -> r (BC-applied residual, any shape)
    linear_solve_fn : (u, r) -> (du, linear_iters); assembles the Jacobian at
        u internally and solves J du = r.  ``linear_iters`` is 0 for direct
        solvers.
    u0 : initial iterate (should satisfy Dirichlet BCs for exact DOLFIN
        parity of the first residual norm).
    loop : "fori" (default) runs a bounded fori_loop whose body is skipped
        via lax.cond once converged — semantically identical to the "while"
        variant.
    backtracking : number of backtracking halvings to try per Newton
        iteration (0 = plain damped Newton, the reference-parity default;
        dolfin's NewtonSolver has no line search either).  With k > 0 the
        step length lambda is halved from ``relaxation`` up to k times until
        the acceptance test passes; if no lambda passes, the smallest trial
        step is taken anyway (bounded-effort globalization, SURVEY.md §5
        failure-recovery item).
    bt_growth : acceptance rule for backtracking trials.  0 (default) =
        strict Armijo: ||r(u - lambda du)|| <= (1 - 1e-4 lambda) ||r(u)||.
        g > 0 = NON-MONOTONE bounded growth: accept while
        ||r_try|| <= g ||r||.  Newton trajectories on stiff coupled systems
        routinely overshoot transiently — strict Armijo rejects those
        healthy steps and crawls at the minimum step length (a measured
        25-iteration stall on an EDL dry-run step that plain damped Newton
        finishes in 3), while the growth rule accepts exactly the plain
        damped-Newton step everywhere the residual grows by less than g,
        engaging the halvings only for genuine blow-ups (non-finite or
        >= g growth).  g ~ 4 is the production sweep default
        (parallel.sweep._sweep_newton).
    du_max : cap on the max-norm of a Newton update (the step is scaled,
        not truncated componentwise, so its direction is preserved).  A
        near-singular Jacobian during a divergence excursion can produce
        updates of 1e20+; real-f64 backends walk through and recover, but
        on an emulated-f64 backend (f32 exponent range) the next residual
        evaluation's products overflow.  1e6 is ~4 orders above any healthy update in this framework's
        scaled systems, so the cap never engages on convergent steps;
        None disables.
    stall_atol : stagnation acceptance (None = off).  A Newton iteration
        cannot reduce the residual below the NOISE of its own residual
        evaluations; with f64 emulated by f32 pairs (~48-bit mantissa)
        that floor sits ~1e2 above a real-f64 backend's, which can put
        a tolerance such as the reference's rxn-diff atol=1e-6 out of
        reach.  With stall_atol set, an iteration that has not improved its best
        residual by >5% for ``stall_iters`` consecutive iterations AND
        whose best residual is below stall_atol exits converged — the
        PETSc SNES 'stol' idea.  On real-f64 backends the normal
        criterion triggers first, so behavior there is unchanged.
    carry_residual : carry the residual *vector* through the loop so each
        Newton iteration assembles it exactly once (the post-update residual
        doubles as the next iteration's solve RHS).  Off (or with
        backtracking, which owns its own residual trials) the body
        recomputes the residual twice per iteration.
    """
    if loop not in ("fori", "while"):
        raise ValueError(f"loop must be 'fori' or 'while', got {loop!r}")
    r0 = residual_fn(u0)
    n0 = _l2(r0)

    def converged(rn, r0n):
        return (rn < atol) | (rn < rtol * r0n)

    carry_r = carry_residual and backtracking == 0
    stall = stall_atol is not None

    def step(state):
        if stall:
            state, best, ct = state[:-2], state[-2], state[-1]
        if carry_r:
            u, r, rn, it, lin = state
        else:
            u, rn, it, lin = state
            r = residual_fn(u)
        du, klin = linear_solve_fn(u, r)
        if du_max is not None:
            mag = jnp.max(jnp.abs(du))
            du = du * jnp.minimum(1.0, du_max / jnp.maximum(mag, 1e-30))
        if backtracking > 0:
            def try_lam(carry, lam):
                u_best, rn_best, accepted = carry
                u_try = u - lam * du
                rn_try = _l2(residual_fn(u_try))
                if bt_growth > 0.0:
                    # non-monotone bounded-growth acceptance (see docstring)
                    armijo = rn_try <= bt_growth * rn
                else:
                    armijo = rn_try <= (1.0 - 1e-4 * lam) * rn
                # first accepted lambda wins; otherwise keep the last
                # (smallest) trial as the fallback iterate
                take = (~accepted) & (armijo | (lam == lams[-1]))
                u_best = jnp.where(take, u_try, u_best)
                rn_best = jnp.where(take, rn_try, rn_best)
                return (u_best, rn_best, accepted | take), None

            lams = [relaxation * 0.5 ** k for k in range(backtracking + 1)]
            (u, rn_new, _), _ = jax.lax.scan(
                try_lam, (u, jnp.asarray(jnp.inf, rn.dtype), jnp.asarray(False)),
                jnp.asarray(lams, u.dtype))
            new = (u, rn_new, it + 1, lin + klin)
        else:
            u = u - relaxation * du
            r_new = residual_fn(u)
            rn_new = _l2(r_new)
            if carry_r:
                new = (u, r_new, rn_new, it + 1, lin + klin)
            else:
                new = (u, rn_new, it + 1, lin + klin)
        if stall:
            # stagnation tracking (see stall_atol): count consecutive
            # iterations with < 5% residual improvement over the best
            improved = rn_new < 0.95 * best
            new = (*new, jnp.minimum(best, rn_new),
                   jnp.where(improved, 0, ct + 1))
        return new

    zero = jnp.array(0, jnp.int32)
    if carry_r:
        init = (u0, r0, n0, zero, zero)
        rn_of = lambda s: s[2]
        it_of = lambda s: s[3]
    else:
        init = (u0, n0, zero, zero)
        rn_of = lambda s: s[1]
        it_of = lambda s: s[2]
    if stall:
        init = (*init, n0, zero)

    def done(state):
        c = converged(rn_of(state), n0)
        if stall:
            # residual stagnated at the evaluation-noise floor AND is
            # already below the loose absolute bound: no Newton method
            # can do better than the noise in its residual evaluations
            # (the PETSc SNES 'stol' idea)
            c = c | ((state[-1] >= stall_iters)
                     & (state[-2] < stall_atol))
        return c

    if loop == "while":
        def cond(state):
            return (~done(state)) & (it_of(state) < max_iter)

        out = jax.lax.while_loop(cond, step, init)
    else:
        def body(i, state):
            return jax.lax.cond(done(state), lambda s: s, step, state)

        out = jax.lax.fori_loop(0, max_iter, body, init)
    if stall:
        stalled_ok = (out[-1] >= stall_iters) & (out[-2] < stall_atol)
        out = out[:-2]
    else:
        stalled_ok = jnp.asarray(False)
    if carry_r:
        u, _, rn, it, lin = out
    else:
        u, rn, it, lin = out

    return NewtonResult(
        u=u,
        iterations=it,
        converged=converged(rn, n0) | stalled_ok,
        residual_norm=rn,
        initial_residual_norm=n0,
        linear_iters=lin,
    )
