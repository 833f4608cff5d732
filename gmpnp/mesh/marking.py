"""Boundary marking with reference-equivalent semantics.

Replicates DOLFIN's ``SubDomain.mark`` on exterior facets: a facet receives a
marker iff *every* vertex of the facet satisfies the predicate; predicates
are applied in order, later marks overwriting earlier ones (the reference
marks entry=1, exit=3, wall=2 in that order, 3D/MPNP_CO2ER_pore.py:368-379).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

from gmpnp.mesh.core import Mesh

# DOLFIN's near(): |x - x0| <= tol (with exact-equality fallback)
def near(x: np.ndarray, x0: float, tol: float) -> np.ndarray:
    return np.abs(x - x0) <= tol


Predicate = Callable[[np.ndarray], np.ndarray]  # (V, dim) -> (V,) bool


def mark_boundary(
    mesh: Mesh,
    rules: Sequence[Tuple[int, Predicate]],
    default: int = 9999,
) -> Mesh:
    """Apply marking rules in order; returns mesh with facet_markers set.

    ``default`` mirrors the reference's ``set_all(9999)``
    (3D/MPNP_CO2ER_pore.py:369)."""
    assert mesh.facets is not None, "call with_boundary() first"
    F = mesh.facets
    markers = np.full(len(F), default, dtype=np.int32)
    for marker, pred in rules:
        ok = pred(mesh.points)  # (V,) bool per vertex
        facet_ok = np.all(ok[F], axis=1)
        markers[facet_ok] = marker
    return mesh.with_markers(markers)


def pore_boundary_markers(mesh: Mesh, L: float, R: float) -> Mesh:
    """The reference pore marking: S1 entry (z=0) -> 1, S3 exit (z=1) -> 3,
    S2 cylinder wall -> 2, applied in the reference's order so the wall rule
    wins on shared rim vertices (ref 3D/MPNP_CO2ER_pore.py:335-379).

    Tolerances replicate 3D/MPNP_CO2ER_pore.py:350-356: the wall test is on
    x^2 + y^2 vs (R/L)^2 with tol 5e-3 for the stubby (R in {5,50} nm,
    L = 10 nm) pores and 1e-3 otherwise.
    """
    aspect = R / L
    if (R == 5.0e-9 or R == 50.0e-9) and L == 10.0e-9:
        wall_tol = 5.0e-3
    else:
        wall_tol = 1.0e-3
    ztol = 1.0e-12

    rules = [
        (1, lambda p: near(p[:, 2], 0.0, ztol)),
        (3, lambda p: near(p[:, 2], 1.0, ztol)),
        (2, lambda p: near(p[:, 0] ** 2 + p[:, 1] ** 2, aspect ** 2, wall_tol)),
    ]
    return mark_boundary(mesh, rules)
