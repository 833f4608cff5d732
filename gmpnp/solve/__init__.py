"""Solvers: sparse linear algebra + damped Newton.

Replacement for the PETSc SNES/KSP + MUMPS/UMFPACK stack the reference
leans on (SURVEY.md §2b): exact block-tridiagonal direct solves for 1D
(cyclic reduction, with a sequential Thomas scan as the oracle), preconditioned GMRES/BiCGStab for 3D, and a
``lax.while_loop`` Newton matching DOLFIN's convergence semantics.
"""

from gmpnp.solve.linear import (
    block_jacobi_preconditioner,
    block_tridiag_apply_cr,
    block_tridiag_factor_cr,
    block_tridiag_from_ell,
    block_tridiag_solve_cr,
    block_tridiag_solve_thomas,
    dense_solve,
    gmres,
    bicgstab,
)
from gmpnp.solve.newton import NewtonResult, newton_solve

__all__ = [
    "block_jacobi_preconditioner",
    "block_tridiag_apply_cr",
    "block_tridiag_factor_cr",
    "block_tridiag_from_ell",
    "block_tridiag_solve_cr",
    "block_tridiag_solve_thomas",
    "dense_solve",
    "gmres",
    "bicgstab",
    "NewtonResult",
    "newton_solve",
]
