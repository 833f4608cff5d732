"""Exact-data parity mode: with GMPNP_UTILITIES pointing at the reference
``utilities/`` directory, models load the *shipped* meshes, parameter YAMLs
and bulk-solution YAMLs instead of generated equivalents."""

import os

import numpy as np
import pytest

from gmpnp.chem.bulk import load_bulk_yaml


@pytest.fixture()
def util_env(reference_utilities, monkeypatch):
    monkeypatch.setenv("GMPNP_UTILITIES", str(reference_utilities))
    return reference_utilities


def test_rxn_diff_uses_reference_mesh_and_bulk(util_env):
    from gmpnp.models import rxn_diff_1d as rd

    prog = rd.build(rd.RxnDiff1DConfig(L_n=1.0e-6))
    # the shipped 1um mesh has 1091 vertices
    assert prog.space.num_vertices == 1091
    ref = load_bulk_yaml(str(util_env / "bulk_soln_0.1KHCO3.yaml"))
    # bulk concentrations must be the YAML values bit-for-bit
    for s in rd.SPECIES:
        assert prog.initial_conc[s] == ref.post_CO2[s]
    assert prog.bulk_pH == ref.post_pH


def test_pore_uses_reference_mesh_and_bulk(util_env):
    from gmpnp.models import pore_3d

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=50e-9, R=5e-9)
    prog = pore_3d.build(cfg)
    # the shipped L_50_R_5 mesh
    assert prog.space.num_vertices == 3679
    ref = load_bulk_yaml(str(util_env / "bulk_soln_1.0KHCO3.yaml"))
    for s in ("H", "OH", "HCO3", "CO32", "CO2"):
        assert prog.bulk_conc[s] == ref.pre_CO2[s]


def test_params_file_resolution(util_env):
    from gmpnp.models.base import load_params

    p = load_params("parameters_pore")     # bare name -> defaults
    assert p.henry_const["CO2"] == 0.034
    # explicit file from the reference directory
    p2 = load_params(str(util_env / "parameters_pore.yaml"))
    assert p2.rate_constants.kw2 == p.rate_constants.kw2
    assert p2.hydration_number["K"] == 4.0


def test_generated_equals_reference_mesh_solution(util_env, monkeypatch):
    """Same short transient on the shipped 1um mesh vs our generated mesh:
    identical grading => near-identical fields (vertex sets coincide)."""
    from gmpnp.models import rxn_diff_1d as rd

    prog_ref = rd.build(rd.RxnDiff1DConfig(L_n=1.0e-6))
    monkeypatch.delenv("GMPNP_UTILITIES")
    prog_gen = rd.build(rd.RxnDiff1DConfig(L_n=1.0e-6))

    np.testing.assert_allclose(
        np.asarray(prog_ref.mesh.points), np.asarray(prog_gen.mesh.points),
        atol=1e-12)

    _, h_ref, s_ref = prog_ref.run(n_steps=3)
    _, h_gen, s_gen = prog_gen.run(n_steps=3)
    # bulk data differs slightly (computed vs shipped yaml, ~1e-4):
    # solutions agree to that level
    np.testing.assert_allclose(
        np.asarray(h_ref[-1]), np.asarray(h_gen[-1]), rtol=2e-3)


def test_default_params_equal_reference_pore_yaml_everywhere(util_env):
    """DEFAULT_PARAMS must equal utilities/parameters_pore.yaml field for
    field (rate constants, diffusion coefficients, solvated sizes, charges,
    Sechenov/Henry tables, hydration numbers, sys_params; ref
    parameters_pore.yaml:1-86)."""
    from dataclasses import fields, is_dataclass

    from gmpnp.constants import DEFAULT_PARAMS, load_parameters

    ref = load_parameters(str(util_env / "parameters_pore.yaml"))

    def walk(a, b, path):
        if is_dataclass(a):
            for f in fields(a):
                walk(getattr(a, f.name), getattr(b, f.name),
                     path + "." + f.name)
        elif isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}[{k}]")
        else:
            assert a == b, (path, a, b)

    walk(DEFAULT_PARAMS, ref, "params")


def test_1d_parameters_yaml_loads_with_shared_fields(util_env):
    """The 1D utilities/parameters.yaml also loads; fields shared with the
    pore file agree with the defaults."""
    from gmpnp.constants import DEFAULT_PARAMS, load_parameters

    p = load_parameters(str(util_env / "parameters.yaml"))
    d = DEFAULT_PARAMS
    assert p.rate_constants == d.rate_constants
    for sp in ("K", "Na", "Li", "Cs", "H", "OH", "HCO3", "CO32", "CO2"):
        assert p.diff_coef[sp] == d.diff_coef[sp], sp
        assert p.solv_size[sp] == d.solv_size[sp], sp
    assert p.sechenov_ion == d.sechenov_ion
