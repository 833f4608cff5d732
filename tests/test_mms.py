"""Method-of-manufactured-solutions convergence tests.

The strongest discretization-correctness check available without a FEniCS
installation: solve a nonlinear PDE with a known exact solution and verify
the P1 L2 error decreases at ~O(h^2) under mesh refinement, through the
full assembly/Newton/Krylov stack.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.fem import DirichletBC, FemSpace, WeakForm
from gmpnp.mesh import cylinder_mesh, pore_boundary_markers, uniform_interval_mesh
from gmpnp.solve.timeloop import (
    LinearConfig,
    NewtonConfig,
    make_implicit_step,
    run_transient,
)


def _solve_nonlinear_poisson_1d(n):
    """-u'' + u^3 = f with u* = sin(pi x), Dirichlet both ends."""
    m = uniform_interval_mesh(n)
    m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
    sp = FemSpace.build(m, 1, quad_degree=4)

    def volume(u, gu, up, x, th):
        ustar = jnp.sin(jnp.pi * x[0])
        f = (jnp.pi ** 2) * ustar + ustar ** 3
        return (u ** 3 - f, gu)

    form = WeakForm(1, volume)
    bc = DirichletBC.from_vertex_sets(
        m.num_vertices, 1, [(np.array([0]), 0, 0.0), (np.array([n]), 0, 0.0)])
    step = make_implicit_step(
        sp, form, NewtonConfig(max_iter=30, rtol=1e-12, atol=1e-12),
        LinearConfig(kind="tridiag_cr"), bc_of_theta=lambda th: bc)
    u0 = jnp.zeros((m.num_vertices, 1))
    (_, _), (hist, stats) = run_transient(
        step, (u0, None), 1, theta_of_carry=lambda c, i: None)
    assert bool(np.asarray(stats.converged).all())
    u = np.asarray(hist[-1])[:, 0]
    x = np.asarray(m.points[:, 0])
    err = np.sqrt(np.mean((u - np.sin(np.pi * x)) ** 2))
    return err


def test_mms_1d_second_order_convergence():
    e1 = _solve_nonlinear_poisson_1d(16)
    e2 = _solve_nonlinear_poisson_1d(32)
    e3 = _solve_nonlinear_poisson_1d(64)
    # P1: O(h^2) L2 convergence => halving h quarters the error
    assert e1 / e2 > 3.3, (e1, e2)
    assert e2 / e3 > 3.3, (e2, e3)
    assert e3 < 2e-4


def _solve_mms_3d(n_layers):
    """-Laplace(u) + u^2 = f on the cylinder, u* = cos(pi z),
    grad(u*).n = 0 on the wall (radial) so only z-Dirichlet BCs needed."""
    L, R = 100e-9, 5e-9
    m = pore_boundary_markers(
        cylinder_mesh(L, R, n_rings=2, n_layers=n_layers), L, R)
    sp = FemSpace.build(m, 1, quad_degree=3)

    def volume(u, gu, up, x, th):
        us = jnp.cos(jnp.pi * x[2])
        f = (jnp.pi ** 2) * us + us ** 2
        return (u ** 2 - f, gu)

    form = WeakForm(1, volume)
    s1 = np.unique(m.facets[m.facet_markers == 1].reshape(-1))
    s3 = np.unique(m.facets[m.facet_markers == 3].reshape(-1))
    bc = DirichletBC.from_vertex_sets(
        m.num_vertices, 1, [(s1, 0, 1.0), (s3, 0, -1.0)])
    step = make_implicit_step(
        sp, form, NewtonConfig(max_iter=30, rtol=1e-11, atol=1e-11),
        LinearConfig(kind="bicgstab", tol=1e-12, maxiter=4000,
                     precond="ssor"),
        bc_of_theta=lambda th: bc)
    u0 = bc.project(jnp.ones((m.num_vertices, 1)))
    (_, _), (hist, stats) = run_transient(
        step, (u0, None), 1, theta_of_carry=lambda c, i: None)
    assert bool(np.asarray(stats.converged).all())
    u = np.asarray(hist[-1])[:, 0]
    z = np.asarray(m.points[:, 2])
    err = np.sqrt(np.mean((u - np.cos(np.pi * z)) ** 2))
    return err


def test_mms_3d_convergence():
    e1 = _solve_mms_3d(8)
    e2 = _solve_mms_3d(16)
    # z-refinement only (solution varies only in z): expect ~4x
    assert e1 / e2 > 3.0, (e1, e2)
    assert e2 < 5e-3
