"""Solver tests: block-tridiagonal direct solves (CR vs Thomas vs dense),
Krylov solvers vs scipy, Newton on manufactured nonlinear problems."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.fem import DirichletBC, FemSpace, WeakForm
from gmpnp.fem.assembly import BlockELL
from gmpnp.mesh import uniform_interval_mesh
from gmpnp.solve import (
    bicgstab,
    block_jacobi_preconditioner,
    block_tridiag_from_ell,
    block_tridiag_solve_cr,
    block_tridiag_solve_thomas,
    dense_solve,
    gmres,
    newton_solve,
)


def _random_block_tridiag(N, f, seed=0):
    rng = np.random.default_rng(seed)
    lower = rng.normal(size=(N, f, f)) * 0.2
    upper = rng.normal(size=(N, f, f)) * 0.2
    diag = rng.normal(size=(N, f, f)) * 0.2
    diag += 3.0 * np.eye(f)  # diagonally dominant
    lower[0] = 0.0
    upper[-1] = 0.0
    rhs = rng.normal(size=(N, f))
    return (jnp.asarray(lower), jnp.asarray(diag), jnp.asarray(upper),
            jnp.asarray(rhs))


def _tridiag_to_dense(lower, diag, upper):
    N, f, _ = diag.shape
    A = np.zeros((N * f, N * f))
    for i in range(N):
        A[i*f:(i+1)*f, i*f:(i+1)*f] = diag[i]
        if i > 0:
            A[i*f:(i+1)*f, (i-1)*f:i*f] = lower[i]
        if i < N - 1:
            A[i*f:(i+1)*f, (i+1)*f:(i+2)*f] = upper[i]
    return A


@pytest.mark.parametrize("N,f", [(5, 1), (17, 3), (64, 7), (100, 2)])
def test_block_tridiag_thomas_and_cr(N, f):
    lower, diag, upper, rhs = _random_block_tridiag(N, f)
    A = _tridiag_to_dense(np.asarray(lower), np.asarray(diag), np.asarray(upper))
    x_ref = np.linalg.solve(A, np.asarray(rhs).reshape(-1)).reshape(N, f)

    x_thomas = np.asarray(block_tridiag_solve_thomas(lower, diag, upper, rhs))
    np.testing.assert_allclose(x_thomas, x_ref, rtol=1e-9, atol=1e-10)

    x_cr = np.asarray(block_tridiag_solve_cr(lower, diag, upper, rhs))
    np.testing.assert_allclose(x_cr, x_ref, rtol=1e-9, atol=1e-10)


def test_tridiag_extraction_from_ell():
    """ELL from a real 1D assembly -> bands -> solve == dense solve."""
    m = uniform_interval_mesh(9)
    m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
    sp = FemSpace.build(m, 2, quad_degree=2)

    def vol(u, gu, up, x, th):
        return (u - up + u * u[::-1] * 0.1, gu * (1 + 0.05 * u[:, None]))

    form = WeakForm(2, vol)
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.uniform(0.8, 1.2, size=(m.num_vertices, 2)))
    ell = sp.jacobian(form, u, u, None)
    rhs = jnp.asarray(rng.normal(size=(m.num_vertices, 2)))

    lower, diag, upper = block_tridiag_from_ell(ell)
    x_band = np.asarray(block_tridiag_solve_cr(lower, diag, upper, rhs))
    x_dense = np.asarray(dense_solve(ell, rhs))
    np.testing.assert_allclose(x_band, x_dense, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("N,f", [(5, 1), (17, 3), (64, 7), (100, 2)])
def test_cr_factor_apply_equals_fused(N, f):
    """The factor/apply split reproduces the fused CR solve exactly
    (same algebra, inverses computed once per odd block)."""
    from gmpnp.solve import block_tridiag_apply_cr, block_tridiag_factor_cr

    lower, diag, upper, rhs = _random_block_tridiag(N, f)
    x_fused = np.asarray(block_tridiag_solve_cr(lower, diag, upper, rhs))
    fac = block_tridiag_factor_cr(lower, diag, upper)
    x_split = np.asarray(block_tridiag_apply_cr(fac, rhs))
    np.testing.assert_allclose(x_split, x_fused, rtol=1e-11, atol=1e-13)


def test_cr_factor_multiple_rhs_reuse():
    """One factorization serves many right-hand sides."""
    from gmpnp.solve import block_tridiag_apply_cr, block_tridiag_factor_cr

    lower, diag, upper, _ = _random_block_tridiag(23, 3, seed=5)
    A = _tridiag_to_dense(np.asarray(lower), np.asarray(diag),
                          np.asarray(upper))
    fac = block_tridiag_factor_cr(lower, diag, upper)
    rng = np.random.default_rng(11)
    for _ in range(3):
        rhs = rng.normal(size=(23, 3))
        x = np.asarray(block_tridiag_apply_cr(fac, jnp.asarray(rhs)))
        x_ref = np.linalg.solve(A, rhs.reshape(-1)).reshape(23, 3)
        np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-10)


def _random_sparse_system(N=40, f=3, seed=1):
    """Random diagonally-dominant BlockELL via a 1D assembly pattern."""
    m = uniform_interval_mesh(N)
    m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
    sp = FemSpace.build(m, f, quad_degree=2)
    form = WeakForm(f, lambda u, gu, up, x, th: (u * 3.0, gu))
    u = jnp.ones((m.num_vertices, f))
    ell = sp.jacobian(form, u, u, None)
    rng = np.random.default_rng(seed)
    b = jnp.asarray(rng.normal(size=(m.num_vertices, f)))
    return ell, b


def test_gmres_vs_dense():
    ell, b = _random_sparse_system()
    x_ref = np.asarray(dense_solve(ell, b))
    pc = block_jacobi_preconditioner(ell)
    res = gmres(ell.matvec, b, Minv=pc, tol=1e-10, restart=25, maxiter=500)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-8)


def test_bicgstab_vs_dense():
    ell, b = _random_sparse_system(seed=2)
    x_ref = np.asarray(dense_solve(ell, b))
    pc = block_jacobi_preconditioner(ell)
    res = bicgstab(ell.matvec, b, Minv=pc, tol=1e-10, maxiter=1000)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-8)


def test_gmres_unpreconditioned():
    ell, b = _random_sparse_system(seed=3)
    x_ref = np.asarray(dense_solve(ell, b))
    res = gmres(ell.matvec, b, tol=1e-10, restart=40, maxiter=2000)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# Newton
# ---------------------------------------------------------------------------

def test_newton_scalar_quadratic():
    """Newton on F(u) = u^2 - 2 elementwise (direct dense linear solve)."""
    def residual(u):
        return u * u - 2.0

    def lin(u, r):
        J = 2.0 * u
        return r / J, jnp.array(0, jnp.int32)

    u0 = jnp.full((5, 1), 3.0)
    res = newton_solve(residual, lin, u0, rtol=1e-14, atol=1e-14, max_iter=50)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.u), np.sqrt(2.0), rtol=1e-12)


def test_newton_fem_nonlinear_poisson():
    """-(u u')' = f on (0,1), u(0)=1, u(1)=2; manufactured u* = sqrt(1+3x).

    With u* = sqrt(1+3x): u u' = 3/2 => (u u')' = 0, so f = 0 and the PDE is
    -(u u')' = 0 with those BCs.
    """
    n = 64
    m = uniform_interval_mesh(n)
    m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
    sp = FemSpace.build(m, 1, quad_degree=3)
    form = WeakForm(1, lambda u, gu, up, x, th: (jnp.zeros(1), u[:, None] * gu))
    bc = DirichletBC.from_vertex_sets(
        m.num_vertices, 1, [(np.array([0]), 0, 1.0), (np.array([n]), 0, 2.0)])

    def residual(u):
        return bc.apply_to_residual(sp.residual(form, u, u, None), u)

    def lin(u, r):
        ell = bc.apply_to_jacobian(sp.jacobian(form, u, u, None))
        lo, di, up_ = block_tridiag_from_ell(ell)
        return block_tridiag_solve_cr(lo, di, up_, r), jnp.array(0, jnp.int32)

    u0 = bc.project(jnp.ones((m.num_vertices, 1)))
    res = newton_solve(residual, lin, u0, rtol=1e-12, atol=1e-12, max_iter=30)
    assert bool(res.converged)
    x = np.asarray(m.points[:, 0])
    exact = np.sqrt(1.0 + 3.0 * x)
    np.testing.assert_allclose(np.asarray(res.u)[:, 0], exact, atol=2e-4)


def test_newton_relaxation_and_iteration_count():
    def residual(u):
        return u - 5.0

    def lin(u, r):
        return r, jnp.array(0, jnp.int32)

    # relaxation 0.5 on a linear problem: error halves each iteration
    u0 = jnp.zeros((1,))
    res = newton_solve(residual, lin, u0, rtol=1e-10, atol=1e-10,
                      max_iter=100, relaxation=0.5)
    assert bool(res.converged)
    assert int(res.iterations) > 10  # geometric convergence, not 1 step
    np.testing.assert_allclose(float(res.u[0]), 5.0, rtol=1e-9)


def test_newton_reports_nonconvergence():
    def residual(u):
        return jnp.ones_like(u)  # never zero

    def lin(u, r):
        return jnp.zeros_like(r), jnp.array(0, jnp.int32)

    res = newton_solve(residual, lin, jnp.zeros((3,)), rtol=1e-12, atol=1e-12,
                      max_iter=7)
    assert not bool(res.converged)
    assert int(res.iterations) == 7


def test_newton_backtracking_globalizes_atan():
    """F(u) = atan(u) from u0 = 3: full Newton steps overshoot and diverge
    (|u| grows every iteration); Armijo backtracking recovers convergence.
    SURVEY.md §5 failure-recovery item."""
    def residual(u):
        return jnp.arctan(u)

    def lin(u, r):
        return r * (1.0 + u * u), jnp.array(0, jnp.int32)  # J^{-1} r exactly

    u0 = jnp.full((1,), 3.0)
    plain = newton_solve(residual, lin, u0, rtol=1e-12, atol=1e-12,
                         max_iter=8)
    assert not bool(plain.converged)
    assert float(jnp.abs(plain.u[0])) > 3.0  # genuinely diverging

    bt = newton_solve(residual, lin, u0, rtol=1e-12, atol=1e-12,
                      max_iter=25, backtracking=6)
    assert bool(bt.converged)
    np.testing.assert_allclose(float(bt.u[0]), 0.0, atol=1e-10)


def test_newton_backtracking_noop_when_full_step_good():
    """On a well-behaved problem backtracking accepts the full step and the
    iterate sequence matches plain Newton exactly (parity-safe default)."""
    def residual(u):
        return u * u - 2.0

    def lin(u, r):
        return r / (2.0 * u), jnp.array(0, jnp.int32)

    u0 = jnp.full((4,), 3.0)
    plain = newton_solve(residual, lin, u0, rtol=1e-14, atol=1e-14)
    bt = newton_solve(residual, lin, u0, rtol=1e-14, atol=1e-14,
                      backtracking=4)
    assert bool(bt.converged)
    assert int(bt.iterations) == int(plain.iterations)
    np.testing.assert_allclose(np.asarray(bt.u), np.asarray(plain.u),
                               rtol=1e-15)


def test_retrying_step_dt_cut():
    """make_retrying_step halves dt until the step converges; a step that
    needs dt <= dt0/4 succeeds on the third attempt with dt_scale 0.25."""
    from gmpnp.solve.timeloop import StepStats, make_retrying_step

    def step(u, theta):
        dt = theta["dt"]
        ok = dt <= 0.25 + 1e-12
        u_new = jnp.where(ok, u + dt, u)
        stats = StepStats(
            newton_iters=jnp.array(1, jnp.int32),
            converged=ok,
            residual_norm=jnp.where(ok, 1e-9, 1.0),
            linear_iters=jnp.array(0, jnp.int32))
        return u_new, stats

    retry = make_retrying_step(step, max_retries=3)
    u0 = jnp.zeros((2,))
    u1, stats, scale = jax.jit(retry)(u0, {"dt": jnp.asarray(1.0)})
    assert bool(stats.converged)
    np.testing.assert_allclose(float(scale), 0.25)
    np.testing.assert_allclose(np.asarray(u1), 0.25)

    # a hopeless step exhausts retries and reports non-convergence
    retry2 = make_retrying_step(step, max_retries=1)
    _, stats2, scale2 = jax.jit(retry2)(u0, {"dt": jnp.asarray(1.0)})
    assert not bool(stats2.converged)
    np.testing.assert_allclose(float(scale2), 0.5)


def test_newton_bt_growth_bounds_explosions():
    """Non-monotone bounded-growth backtracking (bt_growth > 0): the full
    Newton step for F(u) = u^2 - 4 from u0 = 0.1 lands at u ~ 20 (residual
    x100 — a genuine blow-up); the growth rule rejects it and halves into
    the basin, converging in fewer iterations than plain damped Newton
    climbing back down from the overshoot."""
    def residual(u):
        return u * u - 4.0

    def lin(u, r):
        return r / (2.0 * u), jnp.array(0, jnp.int32)

    u0 = jnp.full((1,), 0.1)
    plain = newton_solve(residual, lin, u0, rtol=1e-12, atol=1e-12,
                         max_iter=30)
    growth = newton_solve(residual, lin, u0, rtol=1e-12, atol=1e-12,
                          max_iter=30, backtracking=4, bt_growth=4.0)
    assert bool(plain.converged) and bool(growth.converged)
    np.testing.assert_allclose(float(growth.u[0]), 2.0, rtol=1e-10)
    assert int(growth.iterations) < int(plain.iterations)


def test_newton_bt_growth_matches_plain_when_healthy():
    """With bt_growth > 0 every step whose residual grows by < g accepts the
    full damped step, so on a healthy problem the iterate sequence (and
    iteration count) is identical to plain damped Newton — unlike strict
    Armijo, which can stall on mild transient overshoots."""
    def residual(u):
        return u * u - 2.0

    def lin(u, r):
        return r / (2.0 * u), jnp.array(0, jnp.int32)

    u0 = jnp.full((3,), 3.0)
    plain = newton_solve(residual, lin, u0, rtol=1e-13, atol=1e-13,
                         max_iter=40)
    growth = newton_solve(residual, lin, u0, rtol=1e-13, atol=1e-13,
                          max_iter=40, backtracking=4, bt_growth=4.0)
    assert int(growth.iterations) == int(plain.iterations)
    np.testing.assert_allclose(np.asarray(growth.u), np.asarray(plain.u),
                               rtol=1e-14, atol=0)


@pytest.mark.parametrize("loop", ["fori", "while"])
def test_newton_stagnation_exit(loop):
    """stall_atol: a residual that floors at evaluation noise (the
    emulated-f64 situation of BASELINE config 1) exits converged once
    stagnated below the bound
    instead of burning the whole iteration budget; a normally-converging
    solve is bit-identical with the knob on."""
    import jax.numpy as jnp

    from gmpnp.solve.newton import newton_solve

    def lin(u, r):
        return r / (2 * u), jnp.array(0, jnp.int32)

    def r_clean(u):
        return u ** 2 - 2.0

    a = newton_solve(r_clean, lin, jnp.ones(3) * 3, rtol=1e-12,
                     atol=1e-12, loop=loop)
    b = newton_solve(r_clean, lin, jnp.ones(3) * 3, rtol=1e-12,
                     atol=1e-12, loop=loop, stall_atol=1e-4)
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))
    assert int(a.iterations) == int(b.iterations)
    assert bool(b.converged)

    def r_noisy(u):   # deterministic pseudo-noise floor ~1e-5
        return u ** 2 - 2.0 + 1e-5 * jnp.sin(u * 1e8)

    plain = newton_solve(r_noisy, lin, jnp.ones(3) * 3, rtol=1e-12,
                         atol=1e-9, max_iter=50, loop=loop)
    stall = newton_solve(r_noisy, lin, jnp.ones(3) * 3, rtol=1e-12,
                         atol=1e-9, max_iter=50, loop=loop,
                         stall_atol=1e-3)
    assert not bool(plain.converged) and int(plain.iterations) == 50
    assert bool(stall.converged) and int(stall.iterations) < 20
    assert float(stall.residual_norm) < 1e-3
