"""Aggregation AMG preconditioner tests (solve.amg, the Hypre slot).

Checks, in order: the host-side structure (aggregation is a partition,
the Galerkin scatter reproduces the dense P^T A P), the device-side
cycle (V-cycle-preconditioned GMRES reaches tight tolerances in far
fewer iterations than block-Jacobi on a 3D FEM system), and the config
wiring (precond='amg' through make_linear_solver)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.fem import DirichletBC, FemSpace, WeakForm
from gmpnp.mesh import cylinder_mesh, uniform_interval_mesh
from gmpnp.solve import gmres
from gmpnp.solve.amg import (
    AMGPlan,
    aggregate_vertices,
    amg_preconditioner,
    galerkin_coarse,
)
from gmpnp.solve.linear import block_jacobi_preconditioner
from gmpnp.solve.timeloop import LinearConfig, make_linear_solver


def _poisson_system(mesh, f=3, shift=1.0):
    """Assembled Jacobian of an f-field reaction-diffusion form (SPD up to
    the Dirichlet row masking): flux = grad u, reaction = shift * u."""
    sp = FemSpace.build(mesh, f, quad_degree=2)
    form = WeakForm(f, lambda u, gu, up, x, th: (shift * u, gu))
    dirichlet_verts = np.unique(mesh.facets.reshape(-1))[:4]
    bc = DirichletBC.from_vertex_sets(
        mesh.num_vertices, f, [(dirichlet_verts, 0, 0.0)])
    u = jnp.ones((mesh.num_vertices, f))
    ell = bc.apply_to_jacobian(sp.jacobian(form, u, u, None))
    rng = np.random.default_rng(7)
    rhs = jnp.asarray(rng.normal(size=(mesh.num_vertices, f)))
    return sp, ell, rhs


def test_aggregation_is_a_partition():
    mesh = cylinder_mesh(50e-9, 5e-9, n_rings=2, n_layers=10)
    sp = FemSpace.build(mesh, 1, quad_degree=2)
    adj = np.asarray(sp.adj)
    agg, nagg = aggregate_vertices(adj)
    N = adj.shape[0]
    assert agg.min() == 0 and agg.max() == nagg - 1
    assert (agg >= 0).all()
    # plain aggregation coarsens by roughly the neighborhood size (a
    # distance-1 neighborhood in a 3D P1 graph is ~15-60 vertices)
    assert 2 <= nagg <= N // 2
    # every aggregate id is used
    assert len(np.unique(agg)) == nagg


def test_galerkin_matches_dense_triple_product():
    mesh = uniform_interval_mesh(40)
    mesh = mesh.with_markers(np.zeros(len(mesh.facets), dtype=np.int32))
    _, ell, _ = _poisson_system(mesh, f=2)
    plan = AMGPlan.build(np.asarray(ell.adj), 2, coarsest_dofs=8)
    lvl = plan.levels[0]

    coarse = galerkin_coarse(ell, lvl)
    N, f = mesh.num_vertices, 2
    # dense piecewise-constant prolongation
    P = np.zeros((N * f, lvl.nagg * f))
    for v in range(N):
        a = lvl.agg[v]
        P[v * f:(v + 1) * f, a * f:(a + 1) * f] = np.eye(f)
    want = P.T @ np.asarray(ell.to_dense()) @ P
    np.testing.assert_allclose(np.asarray(coarse.to_dense()), want,
                               rtol=1e-12, atol=1e-12)


def test_vcycle_beats_block_jacobi_on_3d_fem():
    mesh = cylinder_mesh(50e-9, 5e-9, n_rings=2, n_layers=14)
    mesh = mesh.with_markers(np.zeros(len(mesh.facets), dtype=np.int32))
    sp, ell, rhs = _poisson_system(mesh, f=3)

    # neighborhood aggregation coarsens ~40x per level on a 3D P1 graph;
    # a tiny coarsest target forces a genuinely multilevel hierarchy
    plan = AMGPlan.build(np.asarray(sp.adj), 3, coarsest_dofs=12)
    assert len(plan.levels) >= 2

    res_amg = gmres(ell.matvec, rhs, Minv=amg_preconditioner(ell, plan),
                    tol=1e-10, restart=40, maxiter=400)
    res_bj = gmres(ell.matvec, rhs, Minv=block_jacobi_preconditioner(ell),
                   tol=1e-10, restart=40, maxiter=400)
    assert bool(res_amg.converged)
    # correctness: both converged answers agree
    if bool(res_bj.converged):
        np.testing.assert_allclose(np.asarray(res_amg.x),
                                   np.asarray(res_bj.x),
                                   rtol=1e-6, atol=1e-8)
    # strength: AMG needs substantially fewer Krylov iterations
    assert int(res_amg.iters) < int(res_bj.iters) / 2, (
        int(res_amg.iters), int(res_bj.iters))
    # direct check against a dense solve
    x_ref = np.linalg.solve(np.asarray(ell.to_dense()),
                            np.asarray(rhs).reshape(-1))
    np.testing.assert_allclose(np.asarray(res_amg.x).reshape(-1), x_ref,
                               rtol=1e-6, atol=1e-8)


@pytest.mark.slow
def test_amg_precond_through_linear_config():
    mesh = uniform_interval_mesh(60)
    mesh = mesh.with_markers(np.zeros(len(mesh.facets), dtype=np.int32))
    f = 2
    sp = FemSpace.build(mesh, f, quad_degree=2)
    form = WeakForm(f, lambda u, gu, up, x, th: (u, gu))
    bc = DirichletBC.from_vertex_sets(
        mesh.num_vertices, f, [(np.array([0]), 0, 1.0)])
    cfg = LinearConfig(kind="gmres", precond="amg", tol=1e-10, maxiter=200)
    solver = make_linear_solver(sp, form, cfg)
    u = bc.project(jnp.ones((mesh.num_vertices, f)))
    lin = solver(bc, u, {})
    r = bc.apply_to_residual(sp.residual(form, u, u, None), u)
    du, iters = lin(u, r)
    ell = bc.apply_to_jacobian(sp.jacobian(form, u, u, None))
    want = np.linalg.solve(np.asarray(ell.to_dense()),
                           np.asarray(r).reshape(-1))
    np.testing.assert_allclose(np.asarray(du).reshape(-1), want,
                               rtol=1e-7, atol=1e-9)


def test_amg_rejected_for_unsupported_kind():
    mesh = uniform_interval_mesh(10)
    mesh = mesh.with_markers(np.zeros(len(mesh.facets), dtype=np.int32))
    sp = FemSpace.build(mesh, 1, quad_degree=2)
    form = WeakForm(1, lambda u, gu, up, x, th: (u, gu))
    with pytest.raises(ValueError, match="precond"):
        make_linear_solver(sp, form, LinearConfig(kind="gmres",
                                                  precond="amgX"))
