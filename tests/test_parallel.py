"""Parallelism tests on the virtual 8-device CPU mesh.

- vmapped voltage sweeps reproduce per-voltage sequential runs exactly;
- the z-slab sharded 3D Newton step matches the single-device solve to
  solver tolerance (same mesh, same BCs, tight Newton/Krylov).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.models import edl_1d, pore_3d
from gmpnp.parallel.shard import (
    ZShardPlan,
    make_sharded_pore_transient,
    make_sharded_step,
)
from gmpnp.parallel.sweep import run_edl_voltage_sweep
from gmpnp.solve.timeloop import (
    LinearConfig,
    NewtonConfig,
    make_implicit_step,
)


def test_edl_voltage_sweep_matches_sequential():
    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, dry_run=True)
    voltages = [-0.5, -1.0, -2.0]
    hist_b, stats_b = run_edl_voltage_sweep(cfg, voltages, n_steps=3)
    assert hist_b.shape[0] == 3

    assert bool(np.asarray(stats_b.converged).all())
    for i, v in enumerate(voltages):
        cfg_v = dataclasses.replace(cfg, voltage_multiplier=v)
        prog = edl_1d.build(cfg_v)
        _, hist, stats, _ = prog.run(n_steps=3)
        # vmapped and sequential programs fuse differently; agreement is
        # at roundoff-accumulation level, not bitwise
        np.testing.assert_allclose(
            np.asarray(hist_b[i]), np.asarray(hist), rtol=1e-7, atol=1e-7)
        # sweeps default non-monotone bounded-growth backtracking ON
        # (parallel.sweep._sweep_newton).  On steps where no trial is
        # rejected the iterate sequence equals plain damped Newton, but
        # cold-start steps genuinely engage the halvings, and the vmapped
        # arith-BC program and the sequential baked-BC program sit on
        # opposite sides of the rejection threshold at roundoff — so
        # iteration counts agree only loosely; fields (above) and
        # convergence are the guarantees
        assert (np.abs(np.asarray(stats_b.newton_iters[i])
                       - np.asarray(stats.newton_iters)) <= 4).all()


@pytest.mark.parametrize("n_dev,sh_linear", [
    (2, "slab_direct"), (4, "slab_direct"), (8, "slab_direct"),
    (4, "bicgstab_jacobi")])
@pytest.mark.slow
def test_sharded_pore_step_matches_single_device(n_dev, sh_linear):
    devices = jax.devices()
    if len(devices) < n_dev:
        pytest.skip("needs virtual device mesh")

    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 16),
        newton=NewtonConfig(max_iter=50, rtol=1e-10, atol=1e-10,
                            relaxation=0.9),
        linear=LinearConfig(kind="bicgstab", tol=1e-10, maxiter=4000,
                            precond="block_jacobi"))
    prog = pore_3d.build(cfg)
    # generated extruded meshes are already z-sorted (layer by layer)
    z = np.asarray(prog.mesh.points[:, 2])
    assert (np.diff(z) >= -1e-15).all()

    nf = cfg.n_fields
    ns = len(cfg.species)
    N = prog.space.num_vertices
    theta = {"dt": jnp.asarray(prog.dt_scaled),
             "co2_s1": jnp.asarray(
                 prog.eq_conc["CO2"] / prog.bulk_conc["CO2"])}

    # --- single device reference step
    bc = prog._bc_of_theta(theta)
    step1 = make_implicit_step(prog.space, prog.form, cfg.newton, cfg.linear,
                               bc_of_theta=lambda th: bc)
    u0 = jnp.ones((N, nf)).at[:, ns].set(0.0)
    u_ref, stats_ref = step1(u0, theta)
    assert bool(stats_ref.converged)

    # --- sharded step
    mask = np.asarray(bc.mask)
    vals = np.asarray(bc.values)
    plan = ZShardPlan.build(prog.mesh, nf, n_dev, mask, vals,
                            quad_degree=cfg.quad_degree)
    step_sh, dev_mesh, u_shd = make_sharded_step(
        plan, prog.form, devices[:n_dev],
        newton_max_iter=50, newton_rtol=1e-10, newton_atol=1e-10,
        relaxation=0.9, krylov_tol=1e-10, krylov_maxiter=4000,
        linear=sh_linear)

    N_pad = plan.n_dev * plan.N_p
    u0_pad = jnp.zeros((N_pad, nf)).at[:N].set(u0)
    u0_sh = jax.device_put(u0_pad, u_shd)
    u_new, (iters, conv, rn, lin) = step_sh(u0_sh, u0_sh, theta)
    assert bool(conv)

    u_new = np.asarray(u_new)[:N]
    err = np.linalg.norm(u_new - np.asarray(u_ref)) / np.linalg.norm(
        np.asarray(u_ref))
    assert err < 1e-7, err
    if sh_linear == "slab_direct":
        # the distributed SPIKE direct solve is EXACT up to f32 rounding,
        # so the sharded inner solve sits in the same O(10)-iterations-
        # per-Newton regime as the single-device production solver at
        # EVERY device count — including halo ~ slab (the block-Jacobi
        # path needed thousands; one-level RAS degraded
        # 97->354->792 iters/Newton over 2/4/8 devices at fixed N)
        assert int(lin) < 60 * int(iters), (int(lin), int(iters))


@pytest.mark.slow
def test_sharded_two_steps_consistency():
    """Two consecutive sharded steps track the single-device transient."""
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs virtual device mesh")
    n_dev = 4
    cfg = pore_3d.Pore3DConfig(
        physics="rxn_diff", mesh_resolution=(2, 12),
        newton=NewtonConfig(max_iter=50, rtol=1e-9, atol=1e-9),
        linear=LinearConfig(kind="bicgstab", tol=1e-10, maxiter=4000,
                            precond="block_jacobi"))
    prog = pore_3d.build(cfg)
    nf = cfg.n_fields
    N = prog.space.num_vertices
    theta = {"dt": jnp.asarray(prog.dt_scaled),
             "co2_s1": jnp.asarray(
                 prog.eq_conc["CO2"] / prog.bulk_conc["CO2"])}
    bc = prog._bc_of_theta(theta)
    step1 = make_implicit_step(prog.space, prog.form, cfg.newton, cfg.linear,
                               bc_of_theta=lambda th: bc)
    u0 = jnp.ones((N, nf))
    u1, _ = step1(u0, theta)
    u2, _ = step1(u1, theta)

    mask = np.asarray(bc.mask)
    vals = np.asarray(bc.values)
    plan = ZShardPlan.build(prog.mesh, nf, n_dev, mask, vals,
                            quad_degree=cfg.quad_degree)
    step_sh, dev_mesh, u_shd = make_sharded_step(
        plan, prog.form, devices[:n_dev],
        newton_max_iter=50, newton_rtol=1e-9, newton_atol=1e-9,
        relaxation=1.0, krylov_tol=1e-10, krylov_maxiter=4000)
    N_pad = plan.n_dev * plan.N_p
    u0_pad = jnp.zeros((N_pad, nf)).at[:N].set(u0)
    u0_sh = jax.device_put(u0_pad, u_shd)
    u1_sh, _ = step_sh(u0_sh, u0_sh, theta)
    u2_sh, _ = step_sh(u1_sh, u1_sh, theta)

    err = np.linalg.norm(np.asarray(u2_sh)[:N] - np.asarray(u2)) \
        / np.linalg.norm(np.asarray(u2))
    assert err < 1e-6, err


@pytest.mark.slow
def test_sharded_pore_transient_reference_scale(reference_utilities,
                                                monkeypatch):
    """Sharded multi-step transient at the SHIPPED L_50_R_5 mesh (N=3679)
    on the virtual 8-device mesh == single-device transient, with the
    production slab-direct preconditioner and the moving Sechenov CO2
    Dirichlet lift (equivalence at N>=3679, O(10) inner iterations, a
    transient entry point).

    Gated behind GMPNP_SLOW_TESTS=1: the XLA:CPU x64 compile of the
    8-device shard_map GMRES at this mesh size runs tens of minutes on
    the single bench core — far past the suite budget.  Run solo:
    GMPNP_SLOW_TESTS=1 XLA_FLAGS=--xla_force_host_platform_device_count=8
    python -m pytest tests/test_parallel.py -k reference_scale
    (the recorded result lives in docs/STATUS.md round-3)."""
    if not os.environ.get("GMPNP_SLOW_TESTS"):
        pytest.skip("slow: set GMPNP_SLOW_TESTS=1 (see docstring)")
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs virtual device mesh")
    monkeypatch.setenv("GMPNP_UTILITIES", str(reference_utilities))

    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", L=50e-9, R=5e-9,
        newton=NewtonConfig(max_iter=50, rtol=1e-9, atol=1e-9,
                            relaxation=0.9))
    prog = pore_3d.build(cfg)
    N = prog.space.num_vertices
    assert N == 3679, "expected the shipped L_50_R_5 mesh"
    n_steps = 2

    # single-device reference (production slab_direct path, tight tols)
    _, _, stats1, u_ref = prog.run(n_steps=n_steps)

    run, u0_sh, plan = make_sharded_pore_transient(
        prog, devices[:8], n_steps=n_steps,
        krylov_tol=1e-10, krylov_maxiter=2000)
    (u_fin, _), (iters, conv, rn, lin) = run(u0_sh)
    assert bool(np.asarray(conv).all())

    u_fin = np.asarray(u_fin)[:N]
    err = np.linalg.norm(u_fin - np.asarray(u_ref)) / np.linalg.norm(
        np.asarray(u_ref))
    assert err < 1e-6, err
    # O(10) Krylov iterations per Newton iteration, not thousands
    assert int(np.asarray(lin).sum()) < 60 * max(
        1, int(np.asarray(iters).sum()))


def test_sharded_carried_transient_midscale_matches_single_device():
    """Mid-scale UNGATED sharded coverage: a 4-device
    carried-SPIKE transient with the moving Sechenov CO2 lift at N=1,517
    (the (3,40) generated cylinder — well beyond the toy halo~slab
    meshes) matches the single-device production transient.  The
    reference-scale N=3,679 version stays gated behind GMPNP_SLOW_TESTS
    (test_sharded_pore_transient_reference_scale); this one runs on
    every `pytest tests/`."""
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs virtual device mesh")
    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(3, 40),
        newton=NewtonConfig(max_iter=50, rtol=1e-9, atol=1e-9,
                            relaxation=0.9))
    prog = pore_3d.build(cfg)
    N = prog.space.num_vertices
    assert N == 1517
    n_steps = 2

    # single-device production path (slab_direct), tight tolerances
    _, _, stats1, u_ref = prog.run(n_steps=n_steps)

    run, u0_sh, plan = make_sharded_pore_transient(
        prog, devices[:4], n_steps=n_steps,
        krylov_tol=1e-10, krylov_maxiter=2000, refresh="carried")
    (u_fin, _), (iters, conv, rn, lin) = run(u0_sh)
    assert bool(np.asarray(conv).all()), np.asarray(rn)

    u_fin = np.asarray(u_fin)[:N]
    err = np.linalg.norm(u_fin - np.asarray(u_ref)) / np.linalg.norm(
        np.asarray(u_ref))
    assert err < 1e-6, err
    # distributed SPIKE keeps the O(10)-per-Newton inner-iteration regime
    assert int(np.asarray(lin).sum()) < 60 * max(
        1, int(np.asarray(iters).sum()))


def test_pore_voltage_cation_sweep():
    """BASELINE config-5 sweep API: voltage lanes vmapped per cached-compile
    cation; lanes must match independent runs."""
    from gmpnp.parallel.sweep import (
        run_pore_voltage_cation_sweep,
        run_pore_voltage_sweep,
    )

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", mesh_resolution=(2, 8))
    out = run_pore_voltage_cation_sweep(
        cfg, voltages=[-0.5, -1.5], cations=("K", "Cs"), n_steps=2)
    assert set(out) == {"K", "Cs"}
    for cat, (hist, stats) in out.items():
        assert hist.shape[0] == 2          # voltage lanes
        assert bool(np.asarray(stats.converged).all()), cat
    # cation change must actually change the physics
    dK = np.asarray(out["K"][0][-1])
    dCs = np.asarray(out["Cs"][0][-1])
    assert np.abs(dK - dCs).max() > 1e-6

    # lane 0 equals an independent single-voltage sweep run
    hist1, _ = run_pore_voltage_sweep(
        dataclasses.replace(cfg, cation="K"), [-0.5], n_steps=2)
    # lanes are converged only to the Krylov inner tolerance; that is the
    # reproducibility floor for cross-program comparison
    np.testing.assert_allclose(
        np.asarray(out["K"][0][0]), np.asarray(hist1[0]),
        rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("chunk", [1, 2, 0])
def test_edl_sweep_chunked_matches_vmap(chunk):
    """Chunked sweeps must match the full-vmap sweep lane for lane:
    chunk=k is lax.map over vmap-k batches, chunk=0 is HOST chunking (one
    compiled single-lane program executed per lane — the production
    large-mesh mode, parallel.sweep._auto_chunk).  3 lanes
    with chunk=2 also exercises the pad-and-drop path."""
    import dataclasses

    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, dry_run=True)
    voltages = [-0.5, -1.0, -2.0]
    hist_v, stats_v = run_edl_voltage_sweep(cfg, voltages, n_steps=3,
                                            chunk=len(voltages))
    hist_c, stats_c = run_edl_voltage_sweep(cfg, voltages, n_steps=3,
                                            chunk=chunk)
    assert hist_c.shape == hist_v.shape
    np.testing.assert_allclose(np.asarray(hist_c), np.asarray(hist_v),
                               rtol=1e-7, atol=1e-7)
    assert (np.abs(np.asarray(stats_c.newton_iters)
                   - np.asarray(stats_v.newton_iters)) <= 1).all()


def test_pore_sweep_carried_matches_iter():
    """refresh='carried' in the host-chunked production sweep (chunk=0)
    matches the exact-Newton sweep lane for lane; a chunked (vmapped)
    request downgrades to the stateless 'step' policy instead of
    erroring."""
    import dataclasses

    from gmpnp.parallel.sweep import run_pore_voltage_sweep

    # tight Newton tolerances: chord and exact Newton then converge to
    # the same per-step solutions (both certify on the true residual; at
    # the production 1e-4 tolerance they stop at different points INSIDE
    # the tolerance band, which is expected and not an error)
    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 8),
        newton=dataclasses.replace(
            pore_3d.Pore3DConfig(mesh_resolution=(2, 8)).newton,
            rtol=1e-11, atol=1e-11))
    cfg_c = dataclasses.replace(
        cfg, linear=dataclasses.replace(cfg.linear, refresh="carried"))
    voltages = [-0.5, -1.0]

    hist_i, stats_i = run_pore_voltage_sweep(cfg, voltages, n_steps=3,
                                             chunk=0)
    hist_c, stats_c = run_pore_voltage_sweep(cfg_c, voltages, n_steps=3,
                                             chunk=0)
    assert bool(np.asarray(stats_c.converged).all())
    np.testing.assert_allclose(np.asarray(hist_c[:, -1]),
                               np.asarray(hist_i[:, -1]),
                               rtol=5e-4, atol=1e-6)

    # vmapped chunk: downgrades to refresh='step', still converges
    hist_s, stats_s = run_pore_voltage_sweep(cfg_c, voltages, n_steps=2,
                                             chunk=2)
    assert bool(np.asarray(stats_s.converged).all())


@pytest.mark.slow
def test_sharded_step_refresh_matches_iter():
    """refresh='step' (one Jacobian assembly + SPIKE factorization per
    time step, chord Newton within the step) converges to the same
    solution as per-iterate refresh at tight tolerances."""
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs virtual device mesh")
    n_dev = 4
    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 16),
        newton=NewtonConfig(max_iter=50, rtol=1e-10, atol=1e-10,
                            relaxation=0.9))
    prog = pore_3d.build(cfg)
    nf, ns = cfg.n_fields, len(cfg.species)
    N = prog.space.num_vertices
    theta = {"dt": jnp.asarray(prog.dt_scaled),
             "co2_s1": jnp.asarray(
                 prog.eq_conc["CO2"] / prog.bulk_conc["CO2"])}
    bc = prog._bc_of_theta(theta)
    mask = np.asarray(bc.mask)
    vals = np.asarray(bc.values)
    plan = ZShardPlan.build(prog.mesh, nf, n_dev, mask, vals,
                            quad_degree=cfg.quad_degree)
    u0 = jnp.ones((N, nf)).at[:, ns].set(0.0)
    N_pad = plan.n_dev * plan.N_p
    u0_pad = jnp.zeros((N_pad, nf)).at[:N].set(u0)

    results = {}
    for refresh in ("iter", "step"):
        step_sh, dev_mesh, u_shd = make_sharded_step(
            plan, prog.form, devices[:n_dev],
            newton_max_iter=50, newton_rtol=1e-10, newton_atol=1e-10,
            relaxation=0.9, krylov_tol=1e-10, krylov_maxiter=4000,
            linear="slab_direct", refresh=refresh)
        u0_sh = jax.device_put(u0_pad, u_shd)
        u_new, (iters, conv, rn, lin) = step_sh(u0_sh, u0_sh, theta)
        assert bool(conv), refresh
        results[refresh] = (np.asarray(u_new)[:N], int(iters), int(lin))

    a, it_a, _ = results["iter"]
    b, it_b, _ = results["step"]
    err = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert err < 1e-7, err
    # chord may take a few more (cheap) iterations, never fewer
    assert it_b >= it_a


@pytest.mark.slow
def test_sharded_carried_transient_matches_iter():
    """refresh='carried' (the distributed carried-factor chord Newton:
    local Jacobian blocks + SPIKE factorization riding the transient
    scan carry, decay-aware start predictor at the jit level) converges
    to the per-iterate-refresh transient's states at tight tolerances —
    the knobs change directions and start iterates, never the accepted
    solutions."""
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs virtual device mesh")
    n_dev = 4
    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 16),
        newton=NewtonConfig(max_iter=50, rtol=1e-10, atol=1e-10,
                            relaxation=0.9))
    prog = pore_3d.build(cfg)

    results = {}
    for refresh in ("iter", "carried"):
        run, u0, plan = make_sharded_pore_transient(
            prog, devices[:n_dev], n_steps=3,
            krylov_tol=1e-10, krylov_maxiter=4000, refresh=refresh)
        (u_fin, _), (iters, conv, rn, lin) = run(u0)
        assert bool(np.asarray(conv).all()), (refresh, np.asarray(rn))
        results[refresh] = np.asarray(u_fin)

    a, b = results["iter"], results["carried"]
    err = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert err < 1e-7, err


@pytest.mark.slow
def test_run_sharded_full_outputs_match_single_device(tmp_path):
    """pore_3d.run(shard=2) — the CLI-exposed multi-chip production
    entry — produces the same artifact set (npz key sets, metadata,
    strided history) as the single-device run and matching fields to
    solver tolerance."""
    if len(jax.devices()) < 2:
        pytest.skip("needs virtual device mesh")
    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 8),
        newton=NewtonConfig(max_iter=50, rtol=1e-10, atol=1e-10,
                            relaxation=0.9))

    res_s = pore_3d.run(cfg, out_root=str(tmp_path / "s"), n_steps=4,
                        record_stride=2, shard=2)
    res_d = pore_3d.run(cfg, out_root=str(tmp_path / "d"), n_steps=4,
                        record_stride=2)

    assert set(res_s["unscaled"]) == set(res_d["unscaled"])
    for nm, a in res_d["unscaled"].items():
        b = res_s["unscaled"][nm]
        assert b.shape == a.shape, nm      # (1 + n/k, N) history rows
        err = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-300)
        assert err < 1e-7, (nm, err)
    assert bool(np.asarray(res_s["stats"].converged).all())
    md_s, md_d = res_s["metadata"], res_d["metadata"]
    assert set(md_s) == set(md_d)
    np.testing.assert_allclose(md_s["CO2_min"], md_d["CO2_min"],
                               rtol=1e-7)
    # both artifact trees fully written
    import glob
    for root in ("s", "d"):
        files = glob.glob(str(tmp_path / root / "**" / "arrays_unscaled.npz"),
                          recursive=True)
        assert files, root


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.slow
def test_sharded_step_ring_seam_matches_replicated(n_dev):
    """seam='ring' (distributed PCR seam solve — O(log n_dev) stored
    blocks per device) produces the same Newton step
    as the replicated reduced factorization: both are exact seam solves
    up to f32 rounding, so the preconditioned GMRES converges to the
    same solution with comparable iteration counts."""
    devices = jax.devices()
    if len(devices) < n_dev:
        pytest.skip("needs virtual device mesh")
    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 16),
        newton=NewtonConfig(max_iter=50, rtol=1e-10, atol=1e-10,
                            relaxation=0.9))
    prog = pore_3d.build(cfg)
    nf, ns = cfg.n_fields, len(cfg.species)
    N = prog.space.num_vertices
    theta = {"dt": jnp.asarray(prog.dt_scaled),
             "co2_s1": jnp.asarray(
                 prog.eq_conc["CO2"] / prog.bulk_conc["CO2"])}
    bc = prog._bc_of_theta(theta)
    plan = ZShardPlan.build(prog.mesh, nf, n_dev, np.asarray(bc.mask),
                            np.asarray(bc.values),
                            quad_degree=cfg.quad_degree)
    u0 = jnp.ones((N, nf)).at[:, ns].set(0.0)
    N_pad = plan.n_dev * plan.N_p
    u0_pad = jnp.zeros((N_pad, nf)).at[:N].set(u0)

    results = {}
    for seam in ("replicated", "ring"):
        step_sh, dev_mesh, u_shd = make_sharded_step(
            plan, prog.form, devices[:n_dev],
            newton_max_iter=50, newton_rtol=1e-10, newton_atol=1e-10,
            relaxation=0.9, krylov_tol=1e-10, krylov_maxiter=4000,
            linear="slab_direct", seam=seam)
        u0_sh = jax.device_put(u0_pad, u_shd)
        u_new, (iters, conv, rn, lin) = step_sh(u0_sh, u0_sh, theta)
        assert bool(conv), seam
        results[seam] = (np.asarray(u_new)[:N], int(iters), int(lin))

    a, it_a, lin_a = results["replicated"]
    b, it_b, lin_b = results["ring"]
    err = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert err < 1e-7, err
    # both seam solves are exact: same O(10)-per-Newton Krylov regime
    assert lin_b < 60 * max(1, it_b), (lin_b, it_b)


@pytest.mark.slow
def test_sharded_carried_ring_seam_transient():
    """The PCR seam factors ride the carried chord state as per-device
    leaves (carry_split seam='ring' path): a carried transient with
    seam='ring' matches the per-iterate-refresh transient."""
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs virtual device mesh")
    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 16),
        newton=NewtonConfig(max_iter=50, rtol=1e-10, atol=1e-10,
                            relaxation=0.9))
    prog = pore_3d.build(cfg)

    results = {}
    for refresh, seam in (("iter", "replicated"), ("carried", "ring")):
        run, u0, plan = make_sharded_pore_transient(
            prog, devices[:4], n_steps=3,
            krylov_tol=1e-10, krylov_maxiter=4000, refresh=refresh,
            seam=seam)
        (u_fin, _), (iters, conv, rn, lin) = run(u0)
        assert bool(np.asarray(conv).all()), (refresh, seam)
        results[refresh] = np.asarray(u_fin)

    a, b = results["iter"], results["carried"]
    err = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert err < 1e-7, err


def test_run_sharded_refuses_too_many_devices():
    cfg = pore_3d.Pore3DConfig(physics="GMPNP", mesh_resolution=(2, 8))
    with pytest.raises(ValueError, match="devices"):
        pore_3d.run(cfg, write=False, n_steps=2,
                    shard=len(jax.devices()) + 1)


@pytest.mark.slow
def test_run_sharded_kill_and_resume(tmp_path):
    """Sharded checkpoint/resume: a --shard 4 run
    killed after 2 of 4 steps and resumed produces the same artifacts as
    an uninterrupted sharded run.  Checkpoints hold the GLOBAL
    vertex-order state (interchangeable with single-device checkpoints);
    the SPIKE/chord factorization is derived data rebuilt at each chunk
    start."""
    if len(jax.devices()) < 4:
        pytest.skip("needs virtual device mesh")
    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 8),
        newton=NewtonConfig(max_iter=50, rtol=1e-10, atol=1e-10,
                            relaxation=0.9))
    ck = str(tmp_path / "ck")

    res_full = pore_3d.run(cfg, out_root=str(tmp_path / "full"),
                           n_steps=4, shard=4)
    # "killed" after one 2-step chunk (checkpoint saved), resumed to 4
    pore_3d.run(cfg, write=False, n_steps=2, shard=4,
                checkpoint_dir=ck, checkpoint_every=2)
    res_res = pore_3d.run(cfg, out_root=str(tmp_path / "res"),
                          n_steps=4, shard=4,
                          checkpoint_dir=ck, checkpoint_every=2)

    for nm, a in res_full["unscaled"].items():
        b = res_res["unscaled"][nm]
        # final states agree to solver reproducibility (the resumed run
        # re-factors at the chunk boundary; accepted states match within
        # Newton tolerance)
        np.testing.assert_allclose(b[-1], a[-1], rtol=1e-7, atol=1e-9)
    assert bool(np.asarray(res_res["stats"].converged).all())

    # resume-at-completion: exits cleanly surfacing the final state
    res_done = pore_3d.run(cfg, out_root=str(tmp_path / "done"),
                           n_steps=4, shard=4,
                           checkpoint_dir=ck, checkpoint_every=2)
    np.testing.assert_allclose(
        res_done["unscaled"]["CO2"][-1], res_res["unscaled"]["CO2"][-1],
        rtol=1e-12)


@pytest.mark.slow
def test_sharded_transient_dt_cut_recovery():
    """max_retries on the sharded transient: a dt too large for the
    cold start is halved per the retry rule and the transient completes
    converged, with stats.dt_scale recording the accepted halvings —
    the distributed form of make_retrying_step (SURVEY §5)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs virtual device mesh")
    import dataclasses

    cfg = pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 8),
        # V=-2.5 at 64x the reference dt: the sharded cold start fails
        # at the full dt and converges after one halving (probed on the
        # sharded path, round 4) — recovery must engage and carry on
        voltage_multiplier=-2.5, time_step=64.0e-3,
        newton=NewtonConfig(max_iter=12, rtol=1e-6, atol=1e-6,
                            relaxation=0.9))
    cfg = dataclasses.replace(cfg, dt_retries=4)
    u0, u_hist, stats, u_final = pore_3d._run_sharded(
        pore_3d.build(cfg), cfg, shard=2, n_steps=2, record_stride=1)
    conv = np.asarray(stats.converged)
    scale = np.asarray(stats.dt_scale)
    assert bool(conv.all()), (conv, scale)
    assert np.isfinite(np.asarray(u_final)).all()
    # the cold start must actually have engaged at least one halving —
    # otherwise this test is vacuous (tighten voltage if it ever is)
    assert scale.min() < 1.0, scale


def test_lane_per_device_sweep_matches_host_chunked():
    """Lane-per-device sweeps: the reference's real
    production mode — N independent jobs (README.md:37-39) — as one
    shard_map over a lane mesh, each device running its lanes via
    lax.map with no collectives.  Lanes must match the host-chunked
    single-lane program lane for lane."""
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs 4 virtual devices")
    from gmpnp.parallel.sweep import run_pore_voltage_sweep

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", mesh_resolution=(2, 8))
    voltages = [-0.25, -0.5, -0.75, -1.0, -1.25, -1.5, -0.4, -0.6][:8]
    n_dev = 8 if len(devices) >= 8 else 4
    voltages = voltages[:n_dev]
    hist_d, stats_d = run_pore_voltage_sweep(
        cfg, voltages, n_steps=2, devices=devices[:n_dev])
    hist_h, stats_h = run_pore_voltage_sweep(cfg, voltages, n_steps=2,
                                             chunk=0)
    assert hist_d.shape == hist_h.shape
    assert bool(np.asarray(stats_d.converged).all())
    np.testing.assert_allclose(np.asarray(hist_d), np.asarray(hist_h),
                               rtol=5e-4, atol=1e-6)
    # per-lane Newton iteration counts are NOT in lockstep across devices
    assert np.asarray(stats_d.newton_iters).shape == \
        np.asarray(stats_h.newton_iters).shape


def test_lane_per_device_rejects_ragged_lanes():
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs 4 virtual devices")
    from gmpnp.parallel.sweep import run_lanes_on_devices

    with pytest.raises(ValueError, match="multiple"):
        run_lanes_on_devices(lambda v: v, jnp.arange(3.0), devices[:4])
