"""Shared model scaffolding: mesh selection, bulk data, common scalings."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from gmpnp.chem.bulk import BulkSolution, get_bulk_solution
from gmpnp.constants import DEFAULT_PARAMS, ParameterSet, load_parameters
from gmpnp.mesh import (
    Mesh,
    graded_interval_mesh,
    read_dolfin_xml,
    reference_1d_mesh_spec,
    uniform_interval_mesh,
)
from gmpnp.mesh.core import reorder_by_coordinate
from gmpnp.mesh.marking import mark_boundary, near

#: marker ids for 1D meshes
LEFT, RIGHT = 1, 2


def load_params(params_file: Optional[str]) -> ParameterSet:
    """Load a ParameterSet; ``params_file`` may be a path, a bare name
    resolved against GMPNP_UTILITIES (reference-style ``--params_file``
    flag), or None for defaults."""
    if params_file is None or params_file in ("parameters", "parameters_pore"):
        return DEFAULT_PARAMS
    if os.path.exists(params_file):
        return load_parameters(params_file)
    util = os.environ.get("GMPNP_UTILITIES")
    if util:
        cand = os.path.join(util, params_file + ".yaml")
        if os.path.exists(cand):
            return load_parameters(cand)
    raise FileNotFoundError(f"parameters file {params_file!r} not found")


def load_bulk(conc: float, params: ParameterSet) -> BulkSolution:
    """Bulk-solution record: a reference-format YAML from GMPNP_UTILITIES if
    present (exact parity), else computed by the chem module."""
    util = os.environ.get("GMPNP_UTILITIES")
    if util:
        cand = os.path.join(util, f"bulk_soln_{conc}KHCO3.yaml")
        if os.path.exists(cand):
            return get_bulk_solution(conc, yaml_path=cand)
    return get_bulk_solution(conc, params=params)


def interval_mesh_marked(
    mesh_structure: str,
    L_n: float,
    uniform_cells: int = 1000,
) -> Mesh:
    """1D mesh per the reference lookup (1D/MPNP_CO2ER_EDL.py:216-234):
    reference XML file if GMPNP_UTILITIES has it, else our generator (bitwise
    the same grading).  Vertices sorted ascending; endpoints marked LEFT=1
    (OHP, x=0) / RIGHT=2 (bulk, x=1)."""
    mesh = None
    util = os.environ.get("GMPNP_UTILITIES")
    if mesh_structure == "variable":
        name, n = reference_1d_mesh_spec(L_n)
        if util:
            cand = os.path.join(util, f"1D_{name}_mesh_{n}.xml.gz")
            if os.path.exists(cand):
                mesh = read_dolfin_xml(cand)
        if mesh is None:
            mesh = graded_interval_mesh(L_n)
    elif mesh_structure == "uniform":
        mesh = uniform_interval_mesh(uniform_cells)
    else:
        raise ValueError(f"unknown mesh_structure {mesh_structure!r}")

    mesh, _ = reorder_by_coordinate(mesh, axis=0)
    tol = 1.0e-14  # ref: coordinate-comparison tolerance, rxn_diff_planar.py:97
    return mark_boundary(mesh, [
        (LEFT, lambda p: near(p[:, 0], 0.0, tol)),
        (RIGHT, lambda p: near(p[:, 0], 1.0, tol)),
    ])


def right_boundary_vertices(mesh: Mesh) -> np.ndarray:
    sel = mesh.facet_markers == RIGHT
    return np.unique(mesh.facets[sel].reshape(-1))


def left_boundary_vertices(mesh: Mesh) -> np.ndarray:
    sel = mesh.facet_markers == LEFT
    return np.unique(mesh.facets[sel].reshape(-1))


def auto_record_stride(n_steps: int, max_records: int = 1000) -> int:
    """Bounded-history default for full-length transients (SURVEY §5).

    The reference vstacks every field at every step with unbounded memory
    (1D/MPNP_CO2ER_EDL.py:757-763).  Here full-length CLI runs default to
    the smallest stride k dividing ``n_steps`` that keeps the recorded
    device history at or under ``max_records`` snapshots; callers wanting
    the reference's record-everything behavior pass record_stride=1
    explicitly.  (run_transient requires k | n_steps.)
    """
    if n_steps <= max_records:
        return 1
    import math
    for k in range(math.ceil(n_steps / max_records), n_steps + 1):
        if n_steps % k == 0:
            return k
    return n_steps
