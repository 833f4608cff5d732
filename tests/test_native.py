"""Native C++ mesh-engine bindings vs the pure-Python implementations."""

import gzip

import numpy as np
import pytest

from gmpnp import native
from gmpnp.mesh import cylinder_mesh, uniform_interval_mesh, write_dolfin_xml

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built")


def test_parse_dolfin_xml_roundtrip(tmp_path):
    m = cylinder_mesh(50e-9, 5e-9, n_rings=2, n_layers=4)
    p = tmp_path / "m.xml"
    write_dolfin_xml(m, str(p))
    pts, cells = native.parse_dolfin_xml(open(p, "rb").read())
    np.testing.assert_allclose(pts, m.points)
    np.testing.assert_array_equal(cells, m.cells)


def test_parse_reference_mesh(reference_utilities):
    from gmpnp.mesh import read_dolfin_xml

    # read_dolfin_xml routes through the native parser when available
    m = read_dolfin_xml(str(reference_utilities / "L_50_R_5.xml"))
    assert m.num_vertices == 3679
    assert m.num_cells == 17297

    raw = gzip.open(
        str(reference_utilities / "1D_variable_1um_mesh_1090.xml.gz"),
        "rb").read()
    pts, cells = native.parse_dolfin_xml(raw)
    assert pts.shape == (1091, 1)
    assert cells.shape == (1090, 2)


def test_boundary_facets_matches_python():
    from gmpnp.mesh.core import _cell_facets

    m = cylinder_mesh(50e-9, 5e-9, n_rings=2, n_layers=5)
    nat_f, nat_o = native.boundary_facets(m.cells)

    # pure-python oracle (copy of the fallback path)
    C, nv = m.cells.shape
    all_fac = _cell_facets(m.cells).reshape(C * nv, nv - 1)
    keys = np.sort(all_fac, axis=1)
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    neq_prev = np.ones(len(sk), dtype=bool)
    neq_prev[1:] = np.any(sk[1:] != sk[:-1], axis=1)
    neq_next = np.ones(len(sk), dtype=bool)
    neq_next[:-1] = neq_prev[1:]
    sel = order[neq_prev & neq_next]
    py_f = all_fac[sel]
    py_o = sel // nv

    def canon(f, o):
        key = [tuple(sorted(r)) + (c,) for r, c in zip(f, o)]
        return sorted(key)

    assert canon(nat_f, nat_o) == canon(py_f, py_o)


def test_adjacency_and_coloring():
    m = uniform_interval_mesh(20)
    offsets, cols = native.vertex_adjacency_csr(m.cells, m.num_vertices)
    # interior vertices have 3 neighbors (self + 2), ends have 2
    deg = np.diff(offsets)
    assert deg[0] == 2 and deg[-1] == 2
    assert (deg[1:-1] == 3).all()
    colors = native.greedy_color(offsets, cols, m.num_vertices)
    # valid coloring: no adjacent vertices share a color
    for v in range(m.num_vertices):
        for u in cols[offsets[v]:offsets[v + 1]]:
            if u != v:
                assert colors[u] != colors[v]


def test_coloring_valid_on_tet_mesh():
    m = cylinder_mesh(100e-9, 10e-9, n_rings=2, n_layers=6)
    offsets, cols = native.vertex_adjacency_csr(m.cells, m.num_vertices)
    colors = native.greedy_color(offsets, cols, m.num_vertices)
    for v in range(m.num_vertices):
        for u in cols[offsets[v]:offsets[v + 1]]:
            if u != v:
                assert colors[u] != colors[v]
