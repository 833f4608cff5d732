"""Mesh layer tests: readers, generators, marking, geometry.

Includes the generalization of the reference's only test artifact — the
cylinder-wall facet-area check of 3D/mesh_tests.py:80-85.
"""

import math
import os

import numpy as np
import pytest

from gmpnp.mesh import (
    Mesh,
    cell_measures,
    cylinder_mesh,
    facet_measures,
    graded_interval_mesh,
    pore_boundary_markers,
    read_dolfin_xml,
    reference_1d_mesh_spec,
    uniform_interval_mesh,
    write_dolfin_xml,
)
from gmpnp.mesh.core import (
    boundary_facets,
    reorder_by_coordinate,
    vertex_adjacency,
    vertex_cell_incidence,
)


# ---------------------------------------------------------------------------
# interval meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "L_um,expected_cells",
    [(1, 1090), (5, 1490), (10, 1990), (50, 5990), (200, 4998)])
def test_reference_mesh_spec_lookup(L_um, expected_cells):
    name, n = reference_1d_mesh_spec(L_um * 1e-6)
    assert name == f"variable_{L_um}um"
    assert n == expected_cells


@pytest.mark.parametrize("L_um", [1, 5, 10, 50, 200])
def test_graded_mesh_matches_reference_vertices(reference_utilities, L_um):
    _, n = reference_1d_mesh_spec(L_um * 1e-6)
    ref = read_dolfin_xml(
        str(reference_utilities / f"1D_variable_{L_um}um_mesh_{n}.xml.gz"))
    gen = graded_interval_mesh(L_um * 1e-6)
    assert gen.num_cells == ref.num_cells == n
    np.testing.assert_allclose(
        np.sort(gen.points[:, 0]), np.sort(ref.points[:, 0]), atol=1e-12)


def test_uniform_mesh():
    m = uniform_interval_mesh(1000)
    assert m.num_cells == 1000
    assert cell_measures(m.points, m.cells) == pytest.approx(1e-3)
    # boundary facets: the two endpoints
    assert len(m.facets) == 2
    endpoints = sorted(m.points[m.facets[:, 0], 0].tolist())
    assert endpoints == [0.0, 1.0]


def test_interval_mesh_total_length():
    m = graded_interval_mesh(1e-6)
    assert cell_measures(m.points, m.cells).sum() == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# DOLFIN XML round-trip & reference reading
# ---------------------------------------------------------------------------

def test_xml_roundtrip(tmp_path):
    m = uniform_interval_mesh(10)
    p = tmp_path / "m.xml.gz"
    write_dolfin_xml(m, str(p))
    back = read_dolfin_xml(str(p))
    np.testing.assert_allclose(back.points, m.points)
    np.testing.assert_array_equal(back.cells, m.cells)


def test_read_reference_3d_mesh(reference_utilities):
    m = read_dolfin_xml(str(reference_utilities / "L_50_R_5.xml"))
    assert m.dim == 3
    assert m.num_vertices == 3679
    assert m.num_cells == 17297
    vol = cell_measures(m.points, m.cells).sum()
    # cylinder volume pi*(R/L)^2*1, R/L = 0.1; tets approximate the circle
    assert vol == pytest.approx(math.pi * 0.01, rel=2e-2)
    assert (cell_measures(m.points, m.cells) > 0).all()


# ---------------------------------------------------------------------------
# cylinder generator + marking (generalizes 3D/mesh_tests.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,R", [(50e-9, 5e-9), (100e-9, 10e-9)])
def test_cylinder_mesh_geometry(L, R):
    m = cylinder_mesh(L, R)
    aspect = R / L
    r = np.hypot(m.points[:, 0], m.points[:, 1])
    assert r.max() == pytest.approx(aspect, rel=1e-12)
    assert m.points[:, 2].min() == 0.0 and m.points[:, 2].max() == 1.0
    vols = cell_measures(m.points, m.cells)
    assert (vols > 0).all()
    # total volume converges to pi*aspect^2 from below (inscribed polygon)
    assert vols.sum() == pytest.approx(math.pi * aspect ** 2, rel=5e-2)
    # conformity: every interior facet shared by exactly 2 cells is implied
    # by boundary extraction succeeding with a closed surface:
    fac, _ = boundary_facets(m.points, m.cells)
    # closed surface area ~ 2 discs + lateral surface
    area = facet_measures(m.points, fac).sum()
    expected = 2 * math.pi * aspect ** 2 + 2 * math.pi * aspect
    assert area == pytest.approx(expected, rel=5e-2)


def test_wall_area_marking_generated():
    """Equivalent of the reference mesh_tests.py: assemble the marked wall
    area and compare to 2*pi*(R/L) (ref 3D/mesh_tests.py:80-85)."""
    L, R = 50e-9, 5e-9
    m = pore_boundary_markers(cylinder_mesh(L, R), L, R)
    aspect = R / L
    areas = facet_measures(m.points, m.facets)
    wall = areas[m.facet_markers == 2].sum()
    # lateral surface of the inscribed prism -> 2*pi*r with polygon deficit
    assert wall == pytest.approx(2 * math.pi * aspect, rel=2e-2)
    entry = areas[m.facet_markers == 1].sum()
    exit_ = areas[m.facet_markers == 3].sum()
    assert entry == pytest.approx(math.pi * aspect ** 2, rel=2e-2)
    assert exit_ == pytest.approx(math.pi * aspect ** 2, rel=2e-2)
    # nothing unmarked
    assert (m.facet_markers != 9999).all()


def test_wall_area_marking_reference_mesh(reference_utilities):
    L, R = 50e-9, 5e-9
    m = read_dolfin_xml(str(reference_utilities / "L_50_R_5.xml"))
    m = pore_boundary_markers(m, L, R)
    aspect = R / L
    areas = facet_measures(m.points, m.facets)
    wall = areas[m.facet_markers == 2].sum()
    assert wall == pytest.approx(2 * math.pi * aspect, rel=2e-2)


# ---------------------------------------------------------------------------
# connectivity helpers
# ---------------------------------------------------------------------------

def test_vertex_incidence_and_adjacency():
    m = uniform_interval_mesh(4)
    inc_c, inc_l, counts = vertex_cell_incidence(m.cells, m.num_vertices)
    assert counts.tolist() == [1, 2, 2, 2, 1]
    adj, acounts = vertex_adjacency(m.cells, m.num_vertices)
    assert acounts.tolist() == [2, 3, 3, 3, 2]
    assert sorted(adj[2, :3].tolist()) == [1, 2, 3]


def test_reorder_by_coordinate():
    pts = np.array([[0.5], [0.0], [1.0]])
    cells = np.array([[1, 0], [0, 2]], dtype=np.int32)
    m = Mesh(points=pts, cells=cells).with_boundary()
    m2, perm = reorder_by_coordinate(m)
    assert m2.points[:, 0].tolist() == [0.0, 0.5, 1.0]
    # cells still connect the same physical segments
    segs = {tuple(sorted(m2.points[c, 0])) for c in m2.cells}
    assert segs == {(0.0, 0.5), (0.5, 1.0)}


def test_all_shipped_pore_meshes_read_and_mark(reference_utilities):
    """Every shipped 3D cylinder mesh reads, marks fully (set_all(9999)
    default never survives, ref 3D/MPNP_CO2ER_pore.py:369-379), and the wall
    integral matches the analytic lateral area for normal aspect ratios."""
    import glob
    import re

    files = sorted(glob.glob(str(reference_utilities / "L_*.xml")))
    assert len(files) >= 11
    for f in files:
        g = re.fullmatch(r"L_([\d.]+)_R_([\d.]+)",
                 os.path.basename(f)[:-4])
        L, R = float(g.group(1)) * 1e-9, float(g.group(2)) * 1e-9
        m = read_dolfin_xml(f)
        m = pore_boundary_markers(m, L, R)
        assert (m.facet_markers == 9999).sum() == 0, f
        aspect = R / L
        areas = facet_measures(m.points, m.facets)
        wall = areas[m.facet_markers == 2].sum()
        if aspect >= 0.08:  # wall tol doesn't leak onto the discs here
            assert wall == pytest.approx(2 * math.pi * aspect, rel=1e-2), f
            entry = areas[m.facet_markers == 1].sum()
            assert entry == pytest.approx(math.pi * aspect ** 2, rel=1e-2), f


def test_marking_tolerance_quirk_high_aspect(reference_utilities):
    """Faithful reference semantics: the wall predicate's ABSOLUTE 1e-3
    tolerance on x^2+y^2 vs (R/L)^2 (ref 3D/MPNP_CO2ER_pore.py:350-356)
    absorbs the entire entry/exit discs when (R/L)^2 < 1e-3 — for L_50_R_1
    every disc vertex satisfies |r^2 - 4e-4| <= 1e-3, and the wall rule is
    applied last, so entry (1) and exit (3) end up empty."""
    m = read_dolfin_xml(str(reference_utilities / "L_50_R_1.xml"))
    m = pore_boundary_markers(m, 50e-9, 1e-9)
    assert (m.facet_markers == 1).sum() == 0
    assert (m.facet_markers == 3).sum() == 0
    assert (m.facet_markers == 9999).sum() == 0
