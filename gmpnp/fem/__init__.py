"""Finite-element core: P1 simplicial elements, weak-form assembly, BCs.

This is the replacement for the reference's FEniCS stack
(FFC-generated element kernels + dolfin Assembler + DirichletBC; see
SURVEY.md §2b).  Weak forms are expressed as per-quadrature-point JAX
functions; element Jacobians come from ``jax.jacfwd`` of the local residual
(XLA is the "form compiler"); global assembly scatters into a block-ELL
sparse structure whose sparsity is precomputed host-side.
"""

from gmpnp.fem.elements import QuadratureRule, simplex_quadrature
from gmpnp.fem.forms import WeakForm
from gmpnp.fem.assembly import FemSpace, BlockELL
from gmpnp.fem.dirichlet import ArithDirichletBC, DirichletBC

__all__ = [
    "QuadratureRule",
    "simplex_quadrature",
    "WeakForm",
    "FemSpace",
    "BlockELL",
    "ArithDirichletBC",
    "DirichletBC",
]
