"""L2 projection onto P1 vertex fields.

Replaces FEniCS ``project(...)`` as used by the reference for cell-wise
quantities (|grad psi| and CellDiameter in the SUPG path,
1D/MPNP_CO2ER_EDL.py:599,650-653; field = project(-grad(u)) post-processing
:802-805; per-species gradient projections 3D/MPNP_CO2ER_pore.py:884-909).

For piecewise-constant integrands on P1 simplices the load vector is exact:
    b_a = sum_cells f_c * vol_c / (dim+1)
and the projection solves the consistent P1 mass system  M x = b  (CG — the
mass matrix is SPD and well-conditioned, a handful of iterations suffice).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gmpnp.fem.assembly import FemSpace


def mass_matvec(space: FemSpace, x: jnp.ndarray) -> jnp.ndarray:
    """y = M x for the scalar P1 consistent mass matrix, computed matrix-free
    from element mass blocks (exact for affine simplices)."""
    nv = space.cells.shape[1]
    # element mass matrix (nv, nv): vol * (1 + delta_ab) / ((nv)(nv+1))
    Me = (jnp.ones((nv, nv)) + jnp.eye(nv)) / (nv * (nv + 1.0))
    x_e = x[space.cells]                       # (C, nv, comps)
    y_e = jnp.einsum("ab,c,cbk->cak", Me, space.vols, x_e)
    y = jnp.zeros_like(x)
    return y.at[space.cells].add(y_e)


def project_cellwise(
    space: FemSpace,
    cell_values: jnp.ndarray,
    tol: float = 1e-12,
    maxiter: int = 200,
) -> jnp.ndarray:
    """L2-project piecewise-constant cell data (C,) or (C, k) onto P1
    vertex values (N,) or (N, k)."""
    squeeze = cell_values.ndim == 1
    f_c = cell_values[:, None] if squeeze else cell_values
    nv = space.cells.shape[1]
    # exact load vector for cellwise-constant f
    b_e = (space.vols[:, None] / nv)[:, None, :] * jnp.ones((1, nv, 1)) \
        * f_c[:, None, :]
    b = jnp.zeros((space.num_vertices, f_c.shape[1]), dtype=f_c.dtype)
    b = b.at[space.cells].add(b_e)
    x = _mass_cg(space, b, tol=tol, maxiter=maxiter)
    return x[:, 0] if squeeze else x


def project_gradient(
    space: FemSpace,
    u_vertex: jnp.ndarray,
    sign: float = 1.0,
    tol: float = 1e-12,
    maxiter: int = 200,
) -> jnp.ndarray:
    """Project ``sign * grad(u)`` of a P1 scalar field to a P1 vector field
    (N, dim) — the reference's ``field = project(-grad(u_np), W)``."""
    grads = jnp.einsum("ca,cad->cd", u_vertex[space.cells], space.gradN)
    return project_cellwise(space, sign * grads, tol=tol, maxiter=maxiter)


def _mass_cg(space: FemSpace, b: jnp.ndarray, tol: float, maxiter: int):
    """Conjugate gradients on the SPD mass system (multi-RHS)."""
    # Jacobi preconditioner: lumped mass (exact diagonal scaling surrogate)
    nv = space.cells.shape[1]
    lump = jnp.zeros(space.num_vertices, dtype=b.dtype)
    lump = lump.at[space.cells].add(
        jnp.broadcast_to((space.vols / nv)[:, None], space.cells.shape))
    Minv = 1.0 / lump

    def A(x):
        return mass_matvec(space, x)

    x = b * Minv[:, None]  # lumped-mass initial guess
    r = b - A(x)
    z = r * Minv[:, None]
    p = z
    rz = jnp.sum(r * z)
    bnorm = jnp.sqrt(jnp.sum(b * b))
    target = tol * jnp.maximum(bnorm, 1e-300)

    def cond(st):
        x, r, z, p, rz, it = st
        return (jnp.sqrt(jnp.sum(r * r)) > target) & (it < maxiter)

    def body(st):
        x, r, z, p, rz, it = st
        Ap = A(p)
        alpha = rz / jnp.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * Minv[:, None]
        rz_new = jnp.sum(r * z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, it + 1)

    x, *_ = jax.lax.while_loop(
        cond, body, (x, r, z, p, rz, jnp.array(0, jnp.int32)))
    return x
