"""Mesh generators.

The reference ships pre-built meshes ("generated using a separate script",
1D/MPNP_CO2ER_EDL.py:14) and seven of its 3D meshes are missing blobs
(.MISSING_LARGE_BLOBS), so this framework carries its own generators:

- graded interval meshes reproducing the reference two-zone grading exactly
  (measured from the shipped files: 1000 cells of 0.1 nm covering the first
  100 nm adjacent to the OHP, then uniform coarse cells — 10 nm for
  L <= 50 um, 50 nm for the 200 um mesh),
- uniform interval meshes (``mesh_structure='uniform'``, 1000 cells,
  ref 1D/MPNP_CO2ER_EDL.py:227-228),
- structured tetrahedral cylinder meshes matching the reference geometry
  convention: x,y in the disc of radius R/L, z in [0,1]
  (ref 3D/MPNP_CO2ER_pore.py:329-356, utilities/L_<nm>_R_<nm>.xml).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from gmpnp.mesh.core import Mesh, fix_cell_orientation

# fine-zone parameters measured from the shipped reference meshes
_FINE_CELLS = 1000
_FINE_WIDTH_M = 100.0e-9     # first 100 nm resolved at 0.1 nm
_COARSE_DX_M = 10.0e-9       # 10 nm bulk cells (L <= 50 um)
_COARSE_DX_LARGE_M = 50.0e-9  # 50 nm bulk cells for the 200 um mesh


def reference_1d_mesh_spec(L_n: float) -> Tuple[str, int]:
    """(mesh_structure suffix, cell count) for a system size, replicating the
    lookup at 1D/MPNP_CO2ER_EDL.py:216-228."""
    L_um = int(round(L_n * 1.0e6))
    coarse_dx = _COARSE_DX_LARGE_M if L_um > 50 else _COARSE_DX_M
    n_coarse = int(round((L_n - _FINE_WIDTH_M) / coarse_dx))
    return f"variable_{L_um}um", _FINE_CELLS + n_coarse


def graded_interval_mesh(L_n: float, coarse_dx: Optional[float] = None) -> Mesh:
    """Two-zone graded unit-interval mesh (coordinates scaled by L_n).

    1000 cells at 0.1 nm physical spacing on [0, 100 nm], then uniform
    coarse cells to x = L_n.  Matches the shipped
    ``1D_variable_<L>um_mesh_<n>.xml.gz`` vertex sets bit-for-bit up to
    float roundoff.
    """
    if coarse_dx is None:
        L_um = L_n * 1.0e6
        coarse_dx = _COARSE_DX_LARGE_M if L_um > 50 else _COARSE_DX_M
    if L_n <= _FINE_WIDTH_M:
        raise ValueError("system size must exceed the 100 nm fine zone")

    break_scaled = _FINE_WIDTH_M / L_n
    n_coarse = int(round((L_n - _FINE_WIDTH_M) / coarse_dx))
    fine = np.linspace(0.0, break_scaled, _FINE_CELLS + 1)
    coarse = np.linspace(break_scaled, 1.0, n_coarse + 1)[1:]
    xs = np.concatenate([fine, coarse])
    return _interval_mesh_from_points(xs)


def uniform_interval_mesh(n_cells: int = 1000) -> Mesh:
    """Uniform unit-interval mesh (``mesh_structure='uniform'``)."""
    return _interval_mesh_from_points(np.linspace(0.0, 1.0, n_cells + 1))


def _interval_mesh_from_points(xs: np.ndarray) -> Mesh:
    pts = xs.astype(np.float64).reshape(-1, 1)
    n = len(xs) - 1
    cells = np.stack(
        [np.arange(n, dtype=np.int32), np.arange(1, n + 1, dtype=np.int32)],
        axis=1)
    return Mesh(points=pts, cells=cells).with_boundary()


# ---------------------------------------------------------------------------
# Cylinder (pore) meshes
# ---------------------------------------------------------------------------

def _disc_points(radius: float, n_rings: int) -> np.ndarray:
    """Hex-pattern disc point set: center + rings of 6j points."""
    pts = [(0.0, 0.0)]
    for j in range(1, n_rings + 1):
        r = radius * j / n_rings
        m = 6 * j
        for i in range(m):
            th = 2.0 * math.pi * i / m
            pts.append((r * math.cos(th), r * math.sin(th)))
    return np.asarray(pts, dtype=np.float64)


def _disc_triangulation(radius: float, n_rings: int) -> Tuple[np.ndarray, np.ndarray]:
    """Delaunay triangulation of the hex-pattern disc (convex => covers it)."""
    from scipy.spatial import Delaunay

    pts = _disc_points(radius, n_rings)
    tri = Delaunay(pts)
    return pts, tri.simplices.astype(np.int32)


def cylinder_mesh(
    L: float,
    R: float,
    n_rings: Optional[int] = None,
    n_layers: Optional[int] = None,
    target_h: Optional[float] = None,
) -> Mesh:
    """Structured tetrahedral mesh of the reference pore geometry.

    Coordinates are nondimensionalized by L: the cross-section is the disc
    x^2 + y^2 <= (R/L)^2 and z spans [0, 1] (ref naming/geometry convention
    3D/MPNP_CO2ER_pore.py:329-356; e.g. L_50_R_5.xml holds x,y in [-0.1,0.1]).

    Each prism of the extruded disc triangulation splits into 3 tets with
    face-consistent diagonals (min-vertex rule), so the mesh is conforming.

    Default resolution targets the shipped meshes' density (e.g. L_50_R_5:
    3,679 vertices / 17,297 tets).
    """
    aspect = R / L
    if target_h is None:
        # shipped meshes resolve the radius with ~4 cells and the length with
        # ~1/edge ~ 40-60 layers; aim for comparable element size
        target_h = max(aspect / 4.0, 1.0 / 64.0)
    if n_rings is None:
        n_rings = max(2, int(round(aspect / target_h)))
    if n_layers is None:
        n_layers = max(4, int(round(1.0 / target_h)))

    disc_pts, tris = _disc_triangulation(aspect, n_rings)
    nd = len(disc_pts)
    zs = np.linspace(0.0, 1.0, n_layers + 1)

    pts = np.empty((nd * (n_layers + 1), 3), dtype=np.float64)
    for k, z in enumerate(zs):
        pts[k * nd:(k + 1) * nd, :2] = disc_pts
        pts[k * nd:(k + 1) * nd, 2] = z

    tets = []
    for k in range(n_layers):
        lo = k * nd
        hi = (k + 1) * nd
        for (a, b, c) in tris:
            tets.extend(_split_prism(lo + a, lo + b, lo + c,
                                     hi + a, hi + b, hi + c))
    cells = np.asarray(tets, dtype=np.int32)
    cells = fix_cell_orientation(pts, cells)
    return Mesh(points=pts, cells=cells).with_boundary()


def _split_prism(a, b, c, a2, b2, c2):
    """Split prism (bottom a,b,c / top a2,b2,c2) into 3 tets with diagonals
    through each quad face's minimum-index vertex (Dompierre et al. rule),
    guaranteeing conformity with neighboring prisms."""
    # rotate so the bottom-min vertex is first (extrusion => bottom < top)
    verts = [(a, a2), (b, b2), (c, c2)]
    k = min(range(3), key=lambda i: verts[i][0])
    (a, a2), (b, b2), (c, c2) = verts[k:] + verts[:k]
    # faces (a,b,b2,a2) and (a,c,c2,a2) take diagonals a-b2 and a-c2;
    # face (b,c,c2,b2) takes the diagonal through min(b, c)
    if b < c:
        return [(a, b, c, c2), (a, b, c2, b2), (a, b2, c2, a2)]
    else:
        return [(a, b, c, b2), (a, b2, c, c2), (a, b2, c2, a2)]
