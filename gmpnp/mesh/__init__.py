"""Mesh layer: static-array meshes, DOLFIN-XML IO, generators, marking.

Replaces the reference's dolfin::Mesh C++ machinery with plain numpy arrays
(points f64[N,dim], cells i32[C,dim+1]) prepared host-side and consumed as
static constants by jit-compiled assembly.
"""

from gmpnp.mesh.core import Mesh, boundary_facets, cell_measures, facet_measures
from gmpnp.mesh.dolfin_xml import read_dolfin_xml, write_dolfin_xml
from gmpnp.mesh.generators import (
    graded_interval_mesh,
    uniform_interval_mesh,
    cylinder_mesh,
    reference_1d_mesh_spec,
)
from gmpnp.mesh.marking import mark_boundary, near, pore_boundary_markers

__all__ = [
    "Mesh",
    "boundary_facets",
    "cell_measures",
    "facet_measures",
    "read_dolfin_xml",
    "write_dolfin_xml",
    "graded_interval_mesh",
    "uniform_interval_mesh",
    "cylinder_mesh",
    "reference_1d_mesh_spec",
    "mark_boundary",
    "near",
    "pore_boundary_markers",
]
