"""End-to-end tests for the 1D PNP/GMPNP EDL model.

Physics oracles:
- PNP equilibrium (zero current, reactions off) must satisfy the Boltzmann
  relation u_i = exp(-z_i psi) pointwise, and psi must match an independent
  scipy solve_bvp Poisson-Boltzmann solve with the same eps(c) model.
- MPNP equilibrium must satisfy the size-modified Boltzmann relation
  u_i (1 - S_bulk) = (1 - S(x)) exp(-z_i psi) with S = sum_j s_j u_j.
- The H_OHP controller update rule is checked branch by branch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.models import edl_1d


def equilibrium_cfg(model):
    return edl_1d.EDL1DConfig(
        L_n=1.0e-6, model=model, voltage_multiplier=-1.0,
        current_OHP_ss=0.0, include_reactions=False, dry_run=True)


def run_to_steady(prog, n_steps=60):
    """March with the dry-run dt then verify steadiness."""
    u0, hist, stats, _ = prog.run(n_steps=n_steps)
    assert bool(np.asarray(stats.converged).all())
    u = np.asarray(hist[-1])
    du = np.abs(u - np.asarray(hist[-2])).max()
    return u, du


@pytest.fixture(scope="module")
def pnp_steady():
    prog = edl_1d.build(equilibrium_cfg("PNP"))
    u, du = run_to_steady(prog)
    return prog, u, du


def test_pnp_equilibrium_boltzmann(pnp_steady):
    prog, u, du = pnp_steady
    psi = u[:, edl_1d.P]
    z = np.array([prog.params.z(s) for s in prog.config.species], float)
    # Boltzmann relation for charged species; tolerance set by Newton tol
    # (1e-4) and residual steadiness
    for i, s in enumerate(prog.config.species):
        expected = np.exp(-z[i] * psi)
        np.testing.assert_allclose(u[:, i], expected, rtol=2e-3, atol=2e-3)
    # double layer is thin: fields at x>10 Debye lengths are bulk
    xs = np.asarray(prog.mesh.points[:, 0])
    far = xs > 30 * prog.L_debye / prog.config.L_n
    np.testing.assert_allclose(u[far][:, :6], 1.0, atol=1e-3)
    np.testing.assert_allclose(psi[far], 0.0, atol=1e-3)


def test_pnp_equilibrium_vs_poisson_boltzmann_bvp(pnp_steady):
    """Potential profile vs independent scipy PB solve:
        -(eps(psi) psi')' = q sum z_i C0_i exp(-z_i psi),
    with the concentration-dependent permittivity of the reference
    (1D/MPNP_CO2ER_EDL.py:412-421)."""
    from scipy.integrate import solve_bvp

    prog, u, du = pnp_steady
    cfg = prog.config
    nat = prog.params.nat_const
    c0 = np.array([prog.initial_conc[s] for s in cfg.species])
    z = np.array([prog.params.z(s) for s in cfg.species], float)
    q = (nat.F ** 2 * cfg.L_n ** 2) / (nat.eps_0 * nat.R * nat.T)
    w_cat = prog.n_water[cfg.cation]
    w_H = prog.n_water["H"]
    C0_cat = prog.initial_conc[cfg.cation]
    C0_H = prog.initial_conc["H"]
    eps_rel = nat.eps_rel

    def eps_of(psi):
        uH = np.exp(-psi)
        ucat = np.exp(-psi)
        hyd = (w_cat * ucat * C0_cat + w_H * uH * C0_H) * 1e-3
        return eps_rel * (55 - hyd) / 55 + 6 * hyd / 55

    def deps_dpsi(psi):
        h = 1e-7
        return (eps_of(psi + h) - eps_of(psi - h)) / (2 * h)

    def rhs(x, y):
        psi, dpsi = y
        rho = (np.exp(-np.outer(z, psi)) * (z * c0)[:, None]).sum(0)
        # -(eps psi')' = q rho  =>  psi'' = -(q rho + eps' psi'^2-part)...
        # eps depends on psi: (eps(psi) psi')' = eps psi'' + deps/dpsi psi'^2
        d2psi = (-q * rho - deps_dpsi(psi) * dpsi ** 2) / eps_of(psi)
        return np.vstack([dpsi, d2psi])

    def bc(ya, yb):
        return np.array([ya[0] - cfg.voltage_multiplier, yb[0]])

    xs = np.asarray(prog.mesh.points[:, 0])
    x_bvp = np.linspace(0, 1, 3000) ** 3  # cluster near 0
    y0 = np.vstack([np.interp(x_bvp, xs, u[:, edl_1d.P]),
                    np.gradient(np.interp(x_bvp, xs, u[:, edl_1d.P]), x_bvp,
                                edge_order=1)])
    sol = solve_bvp(rhs, bc, x_bvp, y0, tol=1e-8, max_nodes=100000)
    assert sol.success
    psi_oracle = sol.sol(xs)[0]
    err = np.linalg.norm(u[:, edl_1d.P] - psi_oracle) / np.linalg.norm(
        psi_oracle)
    assert err < 5e-4, err


def test_mpnp_equilibrium_modified_boltzmann():
    prog = edl_1d.build(equilibrium_cfg("MPNP"))
    u, du = run_to_steady(prog)
    cfg = prog.config
    psi = u[:, edl_1d.P]
    z = np.array([prog.params.z(s) for s in cfg.species], float)
    nat = prog.params.nat_const
    s_vol = np.array([prog.params.a(s) ** 3 * prog.initial_conc[s] * nat.N_A
                      for s in cfg.species])
    S = u[:, :6] @ s_vol
    S_bulk = s_vol.sum()
    for i, s in enumerate(cfg.species):
        lhs = u[:, i] * (1 - S_bulk)
        rhs = (1 - S) * np.exp(-z[i] * psi)
        np.testing.assert_allclose(lhs, rhs, rtol=5e-3, atol=5e-3)
    # steric saturation: cation accumulation must stay below close packing
    assert S.max() < 1.0
    # MPNP caps the surface cation pile-up below the PNP Boltzmann value
    assert u[0, 5] < np.exp(-z[5] * psi[0])


def test_controller_update_rule():
    """Branch-by-branch check of the H_OHP controller
    (ref 1D/MPNP_CO2ER_EDL.py:770-793)."""
    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, H_OHP=1.1, dry_run=True)
    prog = edl_1d.build(cfg)

    def upd(chf, frac):
        u = jnp.zeros((prog.space.num_vertices, 7)).at[0, 0].set(frac)
        return float(prog._update_carry(jnp.asarray(chf), u, 0))

    H = 1.1
    assert upd(0.5, -0.2) == pytest.approx(0.5 / 1.1)      # negative H frac
    assert upd(0.5, H - 0.2) == pytest.approx(0.5 / 1.05)  # well below
    assert upd(0.5, H - 0.03) == pytest.approx(0.5 / 1.01) # slightly below
    assert upd(0.5, H + 0.2) == pytest.approx(0.5 * 1.04)  # above
    assert upd(0.5, H + 0.6) == pytest.approx(0.5 * 1.15)  # far above
    assert upd(1.5, H + 0.2) == pytest.approx(1.5)         # capped
    assert upd(0.5, H - 0.01) == pytest.approx(0.5)        # inside deadband


def test_dry_run_outputs_contract(tmp_path):
    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, dry_run=True)
    res = edl_1d.run(cfg, out_root=str(tmp_path), n_steps=3)
    import json
    import os

    run_dir = res["run_dir"]
    assert "/MPNP/" in run_dir.replace("\\", "/")
    unscaled = np.load(os.path.join(run_dir, "arrays_unscaled.npz"))
    assert set(unscaled.files) == {
        "H", "OH", "HCO3", "CO32", "CO2", "cat", "p", "coor", "tau",
        "field_values"}
    scaled = np.load(os.path.join(run_dir, "arrays_scaled.npz"))
    for k in ("x", "psi", "t_H", "c_H", "t_cat", "c_cat", "eps_rel",
              "field_values", "charge_density"):
        assert k in scaled.files, k
    meta = json.load(open(os.path.join(run_dir, "metadata.json")))
    for k in ("concentration_elec", "cation", "model", "stabilization",
              "voltage_multiplier", "H2_FE", "L_n_EDL", "time_constant",
              "time_step", "total_sim_time", "mesh_number", "mesh_structure",
              "eps_rel_OHP", "field_OHP", "current_OHP_ss", "current_H",
              "H_OHP_vs_bulk", "potential_OHP", "pH_OHP", "CO2_OHP_frac",
              "pH_overpotential", "CO2_overpotential"):
        assert k in meta, k
    assert meta["mesh_number"] == 1090


def test_supg_faithful_vs_corrected_both_run():
    for faithful in (True, False):
        cfg = edl_1d.EDL1DConfig(
            L_n=1.0e-6, model="PNP", stabilization="Y",
            faithful_supg=faithful, dry_run=True)
        prog = edl_1d.build(cfg)
        _, hist, stats, _ = prog.run(n_steps=3)
        assert bool(np.asarray(stats.converged).all())
        assert np.isfinite(np.asarray(hist)).all()


def test_steric_clip_inactive_at_benign_states():
    """The conditioning clamp (steric_clip) must not alter solutions on the
    Newton path — it only guards off-manifold iterates."""
    import dataclasses

    base = edl_1d.EDL1DConfig(L_n=1.0e-6, model="MPNP", dry_run=True)
    prog_a = edl_1d.build(base)
    prog_b = edl_1d.build(dataclasses.replace(base, steric_clip=0.0))
    _, ha, sa, _ = prog_a.run(n_steps=4)
    _, hb, sb, _ = prog_b.run(n_steps=4)
    assert bool(np.asarray(sa.converged).all())
    assert bool(np.asarray(sb.converged).all())
    np.testing.assert_allclose(np.asarray(ha), np.asarray(hb),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("vmult,ref_E,ref_eps", [
    (-5.0, -0.2524415478848975, 57.64572780716129),
    (-7.5, -0.4612956299192668, 50.16243860179017),
])
def test_parity_vs_reference_published_ohp_values(vmult, ref_E, ref_eps):
    """End-to-end parity against the reference's own published MPNP results:
    the OHP field and permittivity table hardcoded at 1D/Stern_CO2ER.py:66-68
    records the reference's converged MPNP outputs per voltage.  Our 100-step
    dry run on the 1um mesh reproduces them to ~1-2% (the residual gap is
    dry-run-vs-full-run steadiness and mesh/bulk-data differences)."""
    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, voltage_multiplier=vmult,
                             dry_run=True)
    res = edl_1d.run(cfg, write=False)
    m = res["metadata"]
    assert m["all_steps_converged"]
    assert m["field_OHP"] == pytest.approx(ref_E, rel=0.03)
    assert m["eps_rel_OHP"] == pytest.approx(ref_eps, rel=0.03)


def test_carried_factor_matches_exact_newton_1d():
    """1D carried mode (the f64 CR factorization riding the scan carry,
    solve.timeloop.make_carried_step kind='tridiag_cr') converges to the
    same per-step solutions as exact Newton at tight tolerances."""
    import dataclasses

    import numpy as np

    u_by_mode = {}
    for refresh in ("iter", "carried"):
        cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, dry_run=True)
        cfg = dataclasses.replace(
            cfg,
            newton=dataclasses.replace(cfg.newton, rtol=1e-9, atol=1e-9),
            linear=dataclasses.replace(cfg.linear, refresh=refresh))
        prog = edl_1d.build(cfg)
        _, hist, stats, _ = prog.run(n_steps=6)
        assert bool(np.asarray(stats.converged).all()), refresh
        u_by_mode[refresh] = np.asarray(hist[-1])
    a, b = u_by_mode["iter"], u_by_mode["carried"]
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert rel < 1e-7, rel
