"""FEM core tests: quadrature exactness, assembly vs hand-computed matrices,
Jacobian consistency (jacfwd vs finite differences), Dirichlet masking.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.fem import DirichletBC, FemSpace, WeakForm
from gmpnp.fem.elements import (
    physical_gradients,
    simplex_quadrature,
)
from gmpnp.mesh import cylinder_mesh, pore_boundary_markers, uniform_interval_mesh
from gmpnp.mesh.core import facet_measures


# ---------------------------------------------------------------------------
# quadrature
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_quadrature_polynomial_exactness(dim, degree):
    rule = simplex_quadrature(dim, degree)
    assert rule.weights.sum() == pytest.approx(1.0, abs=1e-14)
    # integrate monomials x1^p over the reference simplex, p <= degree
    # exact: p! * 1! ... / (p + dim)! * dim!?  For simplex int x^p dV =
    # p! d! / (p+d)! * V with V = 1/d!  => int = p! / (p+d)!
    for p in range(degree + 1):
        exact = math.factorial(p) / math.factorial(p + dim)
        got = (rule.weights * rule.points[:, 0] ** p).sum() / math.factorial(dim)
        assert got == pytest.approx(exact, abs=1e-13), (dim, degree, p)


def test_physical_gradients_interval():
    m = uniform_interval_mesh(4)
    g = physical_gradients(m.points, m.cells)
    # each cell has length 0.25: grad N = [-4, +4]
    np.testing.assert_allclose(g[:, 0, 0], -4.0)
    np.testing.assert_allclose(g[:, 1, 0], 4.0)


def test_physical_gradients_partition_of_unity():
    m = cylinder_mesh(50e-9, 5e-9, n_rings=2, n_layers=4)
    g = physical_gradients(m.points, m.cells)
    # gradients of a partition of unity sum to zero
    np.testing.assert_allclose(g.sum(axis=1), 0.0, atol=1e-12)
    # linear reproduction: sum_a gradN_a x_a = I
    X = m.points[m.cells]
    I = np.einsum("cae,cad->ced", g, X)
    np.testing.assert_allclose(I, np.broadcast_to(np.eye(3), I.shape), atol=1e-10)


# ---------------------------------------------------------------------------
# assembly vs hand-computed matrices (1D)
# ---------------------------------------------------------------------------

def _mass_form():
    return WeakForm(1, lambda u, gu, up, x, th: (u, jnp.zeros((1, x.shape[0]))))


def _stiff_form():
    return WeakForm(1, lambda u, gu, up, x, th: (jnp.zeros(1), gu))


def test_mass_matrix_interval():
    n = 8
    m = uniform_interval_mesh(n)
    sp = FemSpace.build(m, 1, quad_degree=3)
    form = _mass_form()
    h = 1.0 / n

    u = jnp.asarray(np.random.default_rng(1).normal(size=(n + 1, 1)))
    r = sp.residual(form, u, u, None)

    # exact P1 mass matrix action
    M = np.zeros((n + 1, n + 1))
    for e in range(n):
        M[e:e+2, e:e+2] += h / 6.0 * np.array([[2, 1], [1, 2]])
    np.testing.assert_allclose(np.asarray(r)[:, 0], M @ np.asarray(u)[:, 0],
                               atol=1e-14)


def test_stiffness_matrix_interval():
    n = 8
    m = uniform_interval_mesh(n)
    sp = FemSpace.build(m, 1, quad_degree=3)
    form = _stiff_form()
    h = 1.0 / n

    u = jnp.asarray(np.random.default_rng(2).normal(size=(n + 1, 1)))
    r = sp.residual(form, u, u, None)

    K = np.zeros((n + 1, n + 1))
    for e in range(n):
        K[e:e+2, e:e+2] += 1.0 / h * np.array([[1, -1], [-1, 1]])
    np.testing.assert_allclose(np.asarray(r)[:, 0], K @ np.asarray(u)[:, 0],
                               atol=1e-12)


def test_volume_integral_cylinder():
    """residual of fval=1 sums to the domain volume (tet sanity)."""
    L, R = 50e-9, 5e-9
    m = cylinder_mesh(L, R, n_rings=3, n_layers=10)
    sp = FemSpace.build(m, 1, quad_degree=2)
    form = WeakForm(1, lambda u, gu, up, x, th: (jnp.ones(1), jnp.zeros((1, 3))))
    u = jnp.zeros((m.num_vertices, 1))
    r = sp.residual(form, u, u, None)
    from gmpnp.mesh.core import cell_measures
    assert float(r.sum()) == pytest.approx(
        cell_measures(m.points, m.cells).sum(), rel=1e-12)


def test_boundary_integral_wall_area():
    """g=1 on wall facets integrates to the marked wall area — the FEM-level
    version of the reference's mesh_tests.py check."""
    L, R = 50e-9, 5e-9
    m = pore_boundary_markers(cylinder_mesh(L, R, n_rings=3, n_layers=10), L, R)
    sp = FemSpace.build(m, 1, quad_degree=2)
    form = WeakForm(
        1,
        lambda u, gu, up, x, th: (jnp.zeros(1), jnp.zeros((1, 3))),
        boundary={2: lambda u, x, th: jnp.ones(1)},
    )
    u = jnp.zeros((m.num_vertices, 1))
    r = sp.residual(form, u, u, None)
    wall_area = facet_measures(m.points, m.facets)[m.facet_markers == 2].sum()
    assert float(r.sum()) == pytest.approx(wall_area, rel=1e-12)
    assert wall_area == pytest.approx(2 * math.pi * (R / L), rel=2e-2)


# ---------------------------------------------------------------------------
# Jacobian consistency
# ---------------------------------------------------------------------------

def _nonlinear_form(n_fields, dim):
    """A coupled nonlinear form exercising fval, fgrad, and Robin terms."""
    def volume(u, gu, up, x, th):
        fval = u * u[::-1] - up + 0.3 * jnp.sin(u)
        fgrad = gu * (1.0 + 0.1 * u[:, None] ** 2) + 0.05 * u.sum() * gu[::-1]
        return fval, fgrad

    def robin(u, x, th):
        return 0.7 * (u - 1.0) * u

    return WeakForm(n_fields, volume, boundary={0: robin})


@pytest.mark.parametrize("mesh_kind", ["interval", "cylinder"])
def test_jacobian_matches_autodiff_of_residual(mesh_kind):
    if mesh_kind == "interval":
        m = uniform_interval_mesh(6)
        # mark both endpoints with 0
        m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
        nf = 3
    else:
        L, R = 50e-9, 5e-9
        m = cylinder_mesh(L, R, n_rings=2, n_layers=3)
        m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
        nf = 2
    sp = FemSpace.build(m, nf, quad_degree=2)
    form = _nonlinear_form(nf, m.dim)

    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.uniform(0.5, 1.5, size=(m.num_vertices, nf)))
    up = jnp.asarray(rng.uniform(0.5, 1.5, size=(m.num_vertices, nf)))

    ell = sp.jacobian(form, u, up, None)
    J_dense = np.asarray(ell.to_dense())

    def flat_res(uflat):
        return sp.residual(form, uflat.reshape(u.shape), up, None).reshape(-1)

    J_ref = np.asarray(jax.jacfwd(flat_res)(u.reshape(-1)))
    np.testing.assert_allclose(J_dense, J_ref, atol=1e-11)


def test_matvec_agrees_with_dense():
    m = uniform_interval_mesh(5)
    m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
    sp = FemSpace.build(m, 2, quad_degree=2)
    form = _nonlinear_form(2, 1)
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.uniform(0.5, 1.5, size=(m.num_vertices, 2)))
    ell = sp.jacobian(form, u, u, None)
    x = jnp.asarray(rng.normal(size=(m.num_vertices, 2)))
    y1 = ell.matvec(x)
    y2 = (np.asarray(ell.to_dense()) @ np.asarray(x).reshape(-1)).reshape(y1.shape)
    np.testing.assert_allclose(np.asarray(y1), y2, atol=1e-12)


# ---------------------------------------------------------------------------
# Dirichlet
# ---------------------------------------------------------------------------

def test_dirichlet_rows():
    m = uniform_interval_mesh(5)
    m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
    sp = FemSpace.build(m, 2, quad_degree=2)
    form = _nonlinear_form(2, 1)
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.uniform(0.5, 1.5, size=(m.num_vertices, 2)))

    bc = DirichletBC.from_vertex_sets(
        m.num_vertices, 2, [(np.array([0]), 0, 2.5), (np.array([5]), 1, -1.0)])

    r = sp.residual(form, u, u, None)
    r_bc = bc.apply_to_residual(r, u)
    assert float(r_bc[0, 0]) == pytest.approx(float(u[0, 0]) - 2.5)
    assert float(r_bc[5, 1]) == pytest.approx(float(u[5, 1]) + 1.0)
    # unconstrained entries untouched
    assert float(r_bc[2, 0]) == pytest.approx(float(r[2, 0]))

    ell = bc.apply_to_jacobian(sp.jacobian(form, u, u, None))
    J = np.asarray(ell.to_dense())
    N = m.num_vertices
    row0 = J[0 * 2 + 0]  # vertex 0, field 0
    expected = np.zeros(N * 2)
    expected[0] = 1.0
    np.testing.assert_allclose(row0, expected, atol=1e-14)
    row5 = J[5 * 2 + 1]
    expected = np.zeros(N * 2)
    expected[5 * 2 + 1] = 1.0
    np.testing.assert_allclose(row5, expected, atol=1e-14)


def test_set_value_masked_equals_set_value():
    """DirichletBC.set_value_masked (scatter-free, vmap-safe) produces the
    same BC state as set_value for concrete and traced values."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gmpnp.fem import DirichletBC

    bc = DirichletBC.from_vertex_sets(
        10, 3, [(np.array([0, 3, 7]), 1, 2.5), (np.array([9]), 0, -1.0)])
    verts = np.array([3, 7, 9])
    a = bc.set_value(verts, 2, 0.75)
    b = bc.set_value_masked(verts, 2, 0.75)
    np.testing.assert_array_equal(np.asarray(a.mask), np.asarray(b.mask))
    np.testing.assert_allclose(np.asarray(a.values), np.asarray(b.values))

    # traced + vmapped values
    def vals(v):
        return bc.set_value_masked(verts, 2, v).values

    out = jax.vmap(vals)(jnp.asarray([0.5, -0.25]))
    ref0 = np.asarray(bc.set_value(verts, 2, 0.5).values)
    ref1 = np.asarray(bc.set_value(verts, 2, -0.25).values)
    np.testing.assert_allclose(np.asarray(out[0]), ref0)
    np.testing.assert_allclose(np.asarray(out[1]), ref1)


def test_arith_bc_equals_dirichlet_bc():
    """ArithDirichletBC (pure multiply-add application, the sweep form
    without a where/select blend) is semantically identical to
    DirichletBC on every operation."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gmpnp.fem import DirichletBC

    m = uniform_interval_mesh(7)
    m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
    sp = FemSpace.build(m, 2, quad_degree=2)
    form = _nonlinear_form(2, 1)
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.uniform(0.5, 1.5, size=(m.num_vertices, 2)))

    bc = DirichletBC.from_vertex_sets(
        m.num_vertices, 2,
        [(np.array([0]), 0, 2.5), (np.array([7]), 1, -1.0)])
    verts = np.array([0, 4])

    a = bc.set_value(verts, 1, 0.3)
    b = bc.arith().set_value_arith(verts, 1, 0.3)

    r = sp.residual(form, u, u, None)
    np.testing.assert_allclose(np.asarray(a.apply_to_residual(r, u)),
                               np.asarray(b.apply_to_residual(r, u)),
                               atol=1e-15)
    np.testing.assert_allclose(np.asarray(a.project(u)),
                               np.asarray(b.project(u)), atol=1e-15)
    Ja = a.apply_to_jacobian(sp.jacobian(form, u, u, None))
    Jb = b.apply_to_jacobian(sp.jacobian(form, u, u, None))
    np.testing.assert_allclose(np.asarray(Ja.to_dense()),
                               np.asarray(Jb.to_dense()), atol=1e-15)

    # vmapped per-lane value (the sweep's shape)
    def proj(v):
        return bc.arith().set_value_arith(verts, 1, v).project(u)

    out = jax.vmap(proj)(jnp.asarray([0.5, -0.25]))
    for i, v in enumerate([0.5, -0.25]):
        ref = np.asarray(bc.set_value(verts, 1, v).project(u))
        np.testing.assert_allclose(np.asarray(out[i]), ref, atol=1e-15)
