"""End-to-end tests for the 1D reaction-diffusion model.

Validation layers:
1. diffusion-only sanity (no current, no reactions -> stays at bulk),
2. exact steady state for constant-flux pure diffusion (P1 is exact for
   linear profiles -> machine-precision check through the whole
   Newton/tridiag/scan stack),
3. independent scipy ``solve_bvp`` oracle for the full nonlinear steady
   state,
4. output-contract checks (npz/metadata key sets of the reference).
"""

import dataclasses

import numpy as np
import pytest

from gmpnp.models import rxn_diff_1d as rd


@pytest.fixture(scope="module")
def small_cfg():
    return rd.RxnDiff1DConfig(L_n=1.0e-6)


def test_zero_current_stays_at_equilibrium(small_cfg):
    """With no applied current the bulk solution is already (near) chemical
    equilibrium; concentrations must stay ~1 everywhere."""
    cfg = dataclasses.replace(small_cfg, current_OHP_ss=0.0)
    prog = rd.build(cfg)
    _, hist, stats = prog.run(n_steps=10)
    assert bool(np.asarray(stats.converged).all())
    # bulk values sit at a tmax-snapshot, not exact equilibrium: the slow
    # CO2<->HCO3 leg drifts slightly; tolerance reflects that physics.
    np.testing.assert_allclose(np.asarray(hist[-1]), 1.0, rtol=5e-3)


def test_constant_flux_linear_steady_state(small_cfg):
    """Disable kinetics: the steady state solves u'' = 0, u'(0) = J,
    u(1) = 1, i.e. exactly u = 1 + J (x - 1); P1 FEM reproduces linear
    solutions to machine precision."""
    prog = rd.build(small_cfg)
    # null the reaction coupling by zeroing the scaled rates
    kin_free_theta = dict(prog.theta)

    import jax.numpy as jnp
    from gmpnp.fem import WeakForm
    from gmpnp.solve.timeloop import make_implicit_step, run_transient

    nf = len(rd.SPECIES)

    def volume(u, gu, up, x, theta):
        return (u - up) / theta["dt"], gu

    def flux(u, x, theta):
        g = jnp.zeros(nf)
        g = g.at[rd.IDX["OH"]].set(theta["J_OH"])
        g = g.at[rd.IDX["CO2"]].set(theta["J_CO2"])
        return g

    form = WeakForm(nf, volume, boundary={1: flux, 2: flux})
    step = make_implicit_step(
        prog.space, form, prog.config.newton, prog.config.linear,
        bc_of_theta=lambda th: prog.bc)
    theta = {k: jnp.asarray(v) for k, v in kin_free_theta.items()}
    u0 = jnp.ones((prog.space.num_vertices, nf))
    # huge time steps converge to steady state quickly
    theta["dt"] = jnp.asarray(1.0e8)
    (_, _), (hist, stats) = run_transient(
        step, (u0, None), 3, theta_of_carry=lambda c, i: theta)
    assert bool(np.asarray(stats.converged).all())
    u = np.asarray(hist[-1])
    x = np.asarray(prog.mesh.points[:, 0])
    J_OH = float(theta["J_OH"])
    J_CO2 = float(theta["J_CO2"])
    np.testing.assert_allclose(u[:, rd.IDX["OH"]], 1 + J_OH * (x - 1),
                               rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(u[:, rd.IDX["CO2"]], 1 + J_CO2 * (x - 1),
                               rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(u[:, rd.IDX["H"]], 1.0, atol=1e-7)


def test_nonlinear_steady_state_vs_scipy_bvp(small_cfg):
    """Full model steady state vs an independent scipy solve_bvp oracle of
    the continuum equations  u_i'' + R_i(u) = 0,  u_i'(0) = J_i, u_i(1) = 1.
    """
    from scipy.integrate import solve_bvp

    prog = rd.build(small_cfg)
    # 50 steps = 1 s ~ 900 diffusion time constants for L=1um: fully steady
    _, hist, stats = prog.run(n_steps=50)
    assert bool(np.asarray(stats.converged).all())
    u_ss = np.asarray(hist[-1])           # (N, 5)
    xs = np.asarray(prog.mesh.points[:, 0])

    k = prog.params.rate_constants
    c0 = prog.initial_conc
    sr = {s: prog.config.L_n ** 2 / (prog.diff_coeff[s] * c0[s])
          for s in rd.SPECIES}

    def R(u):
        cH = u[0] * c0["H"]; cOH = u[1] * c0["OH"]
        cHCO3 = u[2] * c0["HCO3"]; cCO32 = u[3] * c0["CO32"]
        cCO2 = u[4] * c0["CO2"]
        r_w = k.kw2 * cH * cOH - k.kw1
        r_a = k.ka1 * cHCO3 * cOH - k.ka2 * cCO32
        r_b = k.kb1 * cCO2 * cOH - k.kb2 * cHCO3
        return np.array([
            -sr["H"] * r_w,
            -sr["OH"] * (r_w + r_a + r_b),
            -sr["HCO3"] * (r_a - r_b),
            -sr["CO32"] * (-r_a),
            -sr["CO2"] * r_b,
        ])

    J = np.zeros(5)
    J[rd.IDX["OH"]] = prog.theta["J_OH"]
    J[rd.IDX["CO2"]] = prog.theta["J_CO2"]

    def rhs(x, y):
        u, du = y[:5], y[5:]
        d2u = np.stack([-R(u[:, i]) for i in range(y.shape[1])], axis=1)
        return np.vstack([du, d2u])

    def bc_fn(ya, yb):
        return np.concatenate([ya[5:] - J, yb[:5] - 1.0])

    x_bvp = np.linspace(0, 1, 400)
    ufun = [np.interp(x_bvp, xs, u_ss[:, i]) for i in range(5)]
    dufun = [np.gradient(uf, x_bvp) for uf in ufun]
    y0 = np.vstack(ufun + dufun)
    sol = solve_bvp(rhs, bc_fn, x_bvp, y0, tol=1e-8, max_nodes=100000)
    assert sol.success

    # measured agreement ~2e-6 rel L2 (worst species); assert with margin
    u_oracle = sol.sol(xs)[:5].T
    for i, s in enumerate(rd.SPECIES):
        num = np.linalg.norm(u_ss[:, i] - u_oracle[:, i])
        den = np.linalg.norm(u_oracle[:, i])
        assert num / den < 1e-4, (s, num / den)


def test_run_outputs_reference_contract(small_cfg, tmp_path):
    res = rd.run(small_cfg, out_root=str(tmp_path), n_steps=3)
    import json
    import os

    run_dir = res["run_dir"]
    unscaled = np.load(os.path.join(run_dir, "arrays_unscaled.npz"))
    assert set(unscaled.files) == {
        "H", "OH", "HCO3", "CO32", "CO2", "coor_array", "tau_array"}
    assert unscaled["H"].shape[0] == 4  # initial row + 3 steps

    scaled = np.load(os.path.join(run_dir, "arrays_scaled.npz"))
    assert set(scaled.files) == {
        "x", "t_H", "c_H", "t_OH", "c_OH", "t_HCO3", "c_HCO3",
        "t_CO32", "c_CO32", "t_CO2", "c_CO2", "c_cat"}

    meta = json.load(open(os.path.join(run_dir, "metadata.json")))
    for key in ("concentration_KHCO3", "L_n", "bulk_pH", "time_constant",
                "total_sim_time", "time_step", "mesh_structure", "H2_FE",
                "CO_FE", "current_OHP_ss", "pH_OHP", "pH_overpotential",
                "CO2_overpotential", "CO2_OHP_frac"):
        assert key in meta, key
    assert meta["mesh_structure"] == "variable_1um"
    assert meta["all_steps_converged"]
