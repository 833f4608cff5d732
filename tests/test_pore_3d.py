"""End-to-end tests for the 3D pore models (GMPNP + rxn-diff).

Validation layers:
1. exact linear-in-z steady profile through tet assembly + markers + Robin
   boundary Jacobians (machine precision),
2. Sechenov moving-BC semantics (unit check of the per-step theta),
3. cross-physics consistency: GMPNP at zero voltage approaches the neutral
   rxn-diff fields (the reference's stated comparison methodology,
   README.md:11),
4. faithful (orphaned-flux) vs corrected GMPNP differ as documented,
5. output contracts (npz/metadata/VTK).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.fem import DirichletBC, FemSpace, WeakForm
from gmpnp.mesh import cylinder_mesh, pore_boundary_markers
from gmpnp.models import pore_3d
from gmpnp.solve.timeloop import (
    LinearConfig,
    NewtonConfig,
    make_implicit_step,
    run_transient,
)

RES = (2, 10)  # small generated mesh for CI speed


def small_cfg(**kw):
    return pore_3d.Pore3DConfig(mesh_resolution=RES, **kw)


def test_linear_profile_with_robin_exit():
    """Steady diffusion: Dirichlet u=2 at S1 (z=0), Robin k(u-1) at S3
    (z=1), no wall flux => exact solution u = 2 + b z with b = -k/(1+k);
    P1 on the extruded tet mesh reproduces it to solver precision."""
    L, R = 100e-9, 5e-9
    mesh = pore_boundary_markers(cylinder_mesh(L, R, *RES), L, R)
    space = FemSpace.build(mesh, 1, quad_degree=2)
    k = 0.7

    form = WeakForm(
        1,
        lambda u, gu, up, x, th: ((u - up) / th["dt"], gu),
        boundary={pore_3d.S3: lambda u, x, th: k * (u - 1.0)},
    )
    s1 = np.unique(mesh.facets[mesh.facet_markers == pore_3d.S1].reshape(-1))
    bc = DirichletBC.from_vertex_sets(mesh.num_vertices, 1, [(s1, 0, 2.0)])
    step = make_implicit_step(
        space, form,
        NewtonConfig(max_iter=30, rtol=1e-12, atol=1e-12),
        LinearConfig(kind="bicgstab", tol=1e-12, maxiter=3000,
                     precond="ssor"),
        bc_of_theta=lambda th: bc)
    theta = {"dt": jnp.asarray(1e12)}
    u0 = jnp.ones((mesh.num_vertices, 1))
    (_, _), (hist, stats) = run_transient(
        step, (u0, None), 2, theta_of_carry=lambda c, i: theta)
    assert bool(np.asarray(stats.converged).all())
    u = np.asarray(hist[-1])[:, 0]
    zc = np.asarray(mesh.points[:, 2])
    b = -k / (1.0 + k)
    np.testing.assert_allclose(u, 2.0 + b * zc, atol=5e-9)


def test_sechenov_theta_update():
    prog = pore_3d.build(small_cfg(physics="GMPNP"))
    nf = prog.config.n_fields
    N = prog.space.num_vertices
    u_bulk = jnp.ones((N, nf))
    th0 = prog._theta_of_carry((u_bulk, None), 0)
    # at bulk concentrations the S1 value equals the Sechenov-capped
    # saturation over bulk CO2
    from gmpnp.chem.henry import co2_saturation_conc
    ions = {s: prog.bulk_conc[s] for s in ("OH", "HCO3", "CO32", "K")}
    expect = float(co2_saturation_conc(
        prog.params.sys_params.T, prog.fugacity_CO2, ions, prog.params))
    assert float(th0["co2_s1"]) == pytest.approx(
        expect / prog.bulk_conc["CO2"], rel=1e-12)

    # doubling the ion content salts CO2 out -> lower S1 value
    u_salty = u_bulk.at[:, prog.idx["OH"]].set(2.0) \
                    .at[:, prog.idx["HCO3"]].set(2.0) \
                    .at[:, prog.idx["CO32"]].set(2.0) \
                    .at[:, prog.idx["K"]].set(2.0)
    th1 = prog._theta_of_carry((u_salty, None), 0)
    assert float(th1["co2_s1"]) < float(th0["co2_s1"])


def test_cross_model_physical_direction():
    """GMPNP (corrected fluxes, grounded wall) and rxn-diff drive the same
    chemistry directions even though their fields differ quantitatively
    (GMPNP resolves a genuine space-charge transient the electroneutral
    model cannot; the reference positions these as comparison models,
    README.md:11)."""
    from gmpnp.solve.timeloop import LinearConfig

    n = 6
    # the corrected-flux GMPNP system needs the stronger SSOR preconditioner
    ssor = LinearConfig(kind="bicgstab", tol=1.0e-6, maxiter=2000,
                        precond="ssor")
    cfg_g = small_cfg(physics="GMPNP", voltage_multiplier=0.0,
                      faithful=False, linear=ssor)
    cfg_r = small_cfg(physics="rxn_diff", linear=ssor)
    prog_g = pore_3d.build(cfg_g)
    prog_r = pore_3d.build(cfg_r)
    _, hist_g, stats_g, _ = prog_g.run(n_steps=n)
    _, hist_r, stats_r, _ = prog_r.run(n_steps=n)
    assert bool(np.asarray(stats_g.converged).all())
    assert bool(np.asarray(stats_r.converged).all())
    for prog, hist in ((prog_g, hist_g), (prog_r, hist_r)):
        u = np.asarray(hist[-1])
        assert np.isfinite(u).all()
        idx = prog.idx
        # wall OH production raises OH above bulk everywhere
        assert u[:, idx["OH"]].min() > 1.0
        # water equilibrium depletes H+ correspondingly
        assert u[:, idx["H"]].max() < 1.0
        # CO/H2 produced at the wall: above their (1% of eq) bulk level
        assert u[:, idx["CO"]].min() >= 100.0 * (1 - 1e-9)
        assert u[:, idx["H2"]].min() >= 100.0 * (1 - 1e-9)
        # concentrations stay positive
        assert (u[:, :len(prog.config.species)] > 0).all()
    # the GMPNP space-charge transient pulls the interior potential negative
    P = len(cfg_g.species)
    ug = np.asarray(hist_g[-1])
    assert ug[:, P].min() < -0.1
    assert ug[:, P].max() <= 1e-9  # grounded boundaries are the maximum


def test_faithful_vs_corrected_differ():
    n = 4
    res = {}
    for faithful in (True, False):
        prog = pore_3d.build(small_cfg(physics="GMPNP", faithful=faithful))
        _, hist, stats, _ = prog.run(n_steps=n)
        assert bool(np.asarray(stats.converged).all())
        res[faithful] = np.asarray(hist[-1])
    # the OH wall flux only exists in corrected mode
    iOH = 1
    diff = np.abs(res[True][:, iOH] - res[False][:, iOH]).max()
    assert diff > 1e-3


@pytest.mark.parametrize("physics", ["GMPNP", "rxn_diff"])
def test_run_outputs_contract(tmp_path, physics):
    import json
    import os

    cfg = small_cfg(physics=physics)
    res = pore_3d.run(cfg, out_root=str(tmp_path), n_steps=2)
    run_dir = res["run_dir"]

    unscaled = np.load(os.path.join(run_dir, "arrays_unscaled.npz"))
    base_keys = {"H", "OH", "HCO3", "CO32", "CO2", "CO", "H2", "coor", "tau",
                 "H_grad", "OH_grad", "HCO3_grad", "CO32_grad", "CO2_grad",
                 "CO_grad", "H2_grad"}
    if physics == "GMPNP":
        base_keys |= {"cat", "cat_grad", "p", "field_values"}
    assert set(unscaled.files) == base_keys
    assert unscaled["H"].shape[0] == 3  # initial + 2 steps
    assert unscaled["H_grad"].shape[1] == 3  # vector components

    scaled = np.load(os.path.join(run_dir, "arrays_scaled.npz"))
    assert "coor_scaled" in scaled.files
    assert "c_cat" in scaled.files
    if physics == "GMPNP":
        for k in ("psi", "eps_rel", "field_values", "charge_density"):
            assert k in scaled.files, k

    meta = json.load(open(os.path.join(run_dir, "metadata.json")))
    for k in ("concentration_elec", "cation", "H2_FE", "L", "R", "time_step",
              "total_sim_time", "porosity", "tortuosity", "constrictivity",
              "y_CO2", "press_gas", "pore_geom_multiplier",
              "electrolyte_flow_geom_multiplier", "eq_conc_CO", "eq_conc_H2",
              "current_planar", "CO2_min"):
        assert k in meta, k
    if physics == "GMPNP":
        assert "voltage_multiplier" in meta

    # VTK exports
    vtu = [f for f in os.listdir(run_dir) if f.endswith(".vtu")]
    expected = 9 if physics == "GMPNP" else 7  # ref exports 9 fields incl. p
    assert len(vtu) == expected
    if physics == "GMPNP":
        assert "solution_p.vtu" in vtu
        assert "solution_K.vtu" in vtu


def test_carried_factor_matches_exact_newton():
    """refresh='carried' (chord Newton with a lazily-refreshed slab
    factorization riding the scan carry) converges to the same per-step
    solutions as exact Newton (refresh='iter'): both certify on the true
    f64 residual, so at tight Newton tolerances the final states agree
    far below the tolerance."""
    import dataclasses as dc

    newton = NewtonConfig(max_iter=50, rtol=1e-11, atol=1e-11,
                          relaxation=0.9)
    base_lin = LinearConfig(kind="slab_direct", tol=1e-12)
    u_by_mode = {}
    stats_by_mode = {}
    for refresh in ("iter", "carried"):
        cfg = small_cfg(physics="GMPNP", newton=newton,
                        linear=dc.replace(base_lin, refresh=refresh,
                                          refresh_iters=8))
        prog = pore_3d.build(cfg)
        _, hist, stats, u_final = prog.run(n_steps=4)
        assert bool(np.asarray(stats.converged).all()), refresh
        u_by_mode[refresh] = np.asarray(u_final)
        stats_by_mode[refresh] = stats
    a, b = u_by_mode["iter"], u_by_mode["carried"]
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert rel < 1e-8, rel


@pytest.mark.slow
def test_carried_chord_knob_combinations():
    """The carried-mode knobs (chord_dtype='f64', chord_predict=False —
    the conservative settings behind the f32+predictor defaults) each
    converge to the exact-Newton states at tight tolerances: the knobs
    change per-iterate directions and start iterates, never the accepted
    solutions (Newton certifies on the true f64 residual)."""
    import dataclasses as dc

    newton = NewtonConfig(max_iter=50, rtol=1e-11, atol=1e-11,
                          relaxation=0.9)
    base_lin = LinearConfig(kind="slab_direct", tol=1e-12)
    cfg = small_cfg(physics="GMPNP", newton=newton, linear=base_lin)
    prog = pore_3d.build(cfg)
    _, _, stats_ref, u_ref = prog.run(n_steps=3)
    assert bool(np.asarray(stats_ref.converged).all())
    u_ref = np.asarray(u_ref)

    for chord_dtype, predict in (("f64", False), ("f64", True)):
        cfg = small_cfg(
            physics="GMPNP", newton=newton,
            linear=dc.replace(base_lin, refresh="carried",
                              chord_dtype=chord_dtype,
                              chord_predict=predict))
        prog = pore_3d.build(cfg)
        _, _, stats, u = prog.run(n_steps=3)
        assert bool(np.asarray(stats.converged).all()), (chord_dtype,
                                                         predict)
        rel = (np.linalg.norm(np.asarray(u) - u_ref)
               / np.linalg.norm(u_ref))
        assert rel < 1e-8, (chord_dtype, predict, rel)


def test_chord_predictor_cuts_warm_iterations():
    """At the production tolerances (atol=1e-4, reference parity) the
    extrapolated chord start iterate never increases the total Newton
    work over a transient window: acceptance is ``||r|| < atol OR ||r||
    < rtol*||r0||``, and prediction can only shrink the required
    reduction (the rtol factor is fixed; the atol floor engages as the
    predicted entry residual shrinks)."""
    import dataclasses as dc

    lin = LinearConfig(kind="slab_direct", tol=1e-8, refresh="carried")
    iters = {}
    for predict in (False, True):
        cfg = small_cfg(
            physics="GMPNP",
            linear=dc.replace(lin, chord_predict=predict))
        prog = pore_3d.build(cfg)
        _, _, stats, _ = prog.run(n_steps=5)
        assert bool(np.asarray(stats.converged).all()), predict
        iters[predict] = int(np.asarray(stats.newton_iters).sum())
    assert iters[True] <= iters[False], iters


@pytest.mark.slow
def test_carried_factor_checkpoint_resume(tmp_path):
    """The carried factorization is derived data: a checkpointed carried
    run resumes from the checkpointed state (rebuilding the factor) and matches
    an uninterrupted carried run."""
    import dataclasses as dc

    newton = NewtonConfig(max_iter=50, rtol=1e-10, atol=1e-10,
                          relaxation=0.9)
    lin = LinearConfig(kind="slab_direct", tol=1e-12, refresh="carried")
    cfg = small_cfg(physics="GMPNP", newton=newton, linear=lin)

    prog = pore_3d.build(cfg)
    _, _, stats_a, u_a = prog.run(n_steps=4)

    ck = str(tmp_path / "ck")
    prog2 = pore_3d.build(cfg)
    _, _, _, _ = prog2.run(n_steps=2, checkpoint_dir=ck, checkpoint_every=2)
    # resume: same dir, extend to 4 steps (chunks of 2)
    prog3 = pore_3d.build(cfg)
    _, _, stats_b, u_b = prog3.run(n_steps=4, checkpoint_dir=ck,
                                   checkpoint_every=2)
    rel = (np.linalg.norm(np.asarray(u_a) - np.asarray(u_b))
           / np.linalg.norm(np.asarray(u_a)))
    assert rel < 1e-8, rel


@pytest.mark.slow
def test_carried_factor_with_recovery_converges():
    """make_recovering_carried_step: carried mode composes with dt-halving
    recovery; a plain run with retries enabled completes with dt_scale
    recorded (1.0 when no retry was needed)."""
    import dataclasses as dc

    lin = LinearConfig(kind="slab_direct", tol=1e-12, refresh="carried")
    cfg = small_cfg(physics="GMPNP", linear=lin, dt_retries=2)
    prog = pore_3d.build(cfg)
    _, _, stats, _ = prog.run(n_steps=3)
    assert bool(np.asarray(stats.converged).all())
    assert np.asarray(stats.dt_scale).shape == (3,)
    np.testing.assert_allclose(np.asarray(stats.dt_scale), 1.0)


def test_auto_refresh_resolves_and_converges():
    """refresh='auto': the run times a warm window of
    both the carried and exact step programs (timeloop.calibrate_refresh),
    resolves to a concrete mode, records the choice, and the transient
    converges like either hand-picked mode."""
    import dataclasses as dc

    cfg = small_cfg(physics="GMPNP",
                    linear=dc.replace(LinearConfig(kind="slab_direct"),
                                      refresh="auto"))
    prog = pore_3d.build(cfg)
    _, hist, stats, u_final = prog.run(n_steps=3)
    assert bool(np.asarray(stats.converged).all())
    cal = prog.refresh_calibration
    assert cal["mode"] in ("carried", "iter")
    assert cal["carried_window_s"] > 0 and cal["iter_window_s"] > 0
    assert np.isfinite(np.asarray(u_final)).all()


def test_dt_first_scale_staging(tmp_path):
    """First-class staged first step (the 3D form of
    the reference's 1D staged-dt schedule, 1D/MPNP_CO2ER_EDL.py:270-290):
    theta carries dt*scale for the first dt_first_steps steps and the
    full dt after; the output time axis reflects the actual schedule and
    metadata records the staging."""
    import jax.numpy as jnp

    cfg = small_cfg(physics="GMPNP", voltage_multiplier=-2.5,
                    dt_first_scale=0.125, dt_first_steps=2)
    prog = pore_3d.build(cfg)
    u0 = jnp.ones((prog.space.num_vertices, cfg.n_fields))
    u0 = u0.at[:, len(cfg.species)].set(0.0)
    th0 = prog._theta_of_carry((u0, 0.0), jnp.asarray(0))
    th1 = prog._theta_of_carry((u0, 0.0), jnp.asarray(1))
    th2 = prog._theta_of_carry((u0, 0.0), jnp.asarray(2))
    np.testing.assert_allclose(float(th0["dt"]), prog.dt_scaled * 0.125)
    np.testing.assert_allclose(float(th1["dt"]), prog.dt_scaled * 0.125)
    np.testing.assert_allclose(float(th2["dt"]), prog.dt_scaled)

    res = pore_3d.run(cfg, out_root=str(tmp_path), n_steps=4,
                      write_vtk=False)
    md = res["metadata"]
    assert md["dt_first_scale"] == 0.125 and md["dt_first_steps"] == 2
    assert md["all_steps_converged"]
    tau = res["tau_array"]
    d = prog.dt_scaled
    np.testing.assert_allclose(
        tau, [0.125 * d, 0.25 * d, 1.25 * d, 2.25 * d], rtol=1e-12)

    # unstaged default keeps the reference linspace convention untouched
    cfg0 = small_cfg(physics="GMPNP", voltage_multiplier=-2.5)
    res0 = pore_3d.run(cfg0, out_root=str(tmp_path), n_steps=4,
                       write_vtk=False)
    np.testing.assert_allclose(res0["tau_array"],
                               np.linspace(0, 4 * d, 4))
