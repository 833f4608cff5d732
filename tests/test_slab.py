"""Slab block-banded direct solver (solve.slab): relayout exactness vs the
dense matrix, factor/solve vs numpy, mixed-precision refinement to f64
accuracy on a real assembled pore Jacobian, and Newton-step equivalence
against the Krylov path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.fem import DirichletBC, FemSpace
from gmpnp.fem.assembly import BlockELL
from gmpnp.mesh import cylinder_mesh, pore_boundary_markers
from gmpnp.solve.slab import (
    SlabPlan,
    slab_direct_solve,
    slab_factor,
    slab_solve,
)


def _pore_space(n_fields=3, rings=2, layers=10):
    mesh = cylinder_mesh(100e-9, 10e-9, n_rings=rings, n_layers=layers)
    mesh = pore_boundary_markers(mesh, 100e-9, 10e-9)
    return FemSpace.build(mesh, n_fields, quad_degree=2)


def _random_ell(space, n_fields, seed=0, dtype=np.float64):
    """Random symmetric-pattern BlockELL on the space's sparsity with a
    dominant diagonal (zero blocks on padded self-slots, like assembly)."""
    rng = np.random.default_rng(seed)
    adj = np.asarray(space.adj)
    N, K = adj.shape
    f = n_fields
    blocks = rng.standard_normal((N, K, f, f)) * 0.1
    # zero padded duplicate slots, keep only the true diagonal slot
    dslot = np.asarray(space.diag_slot)
    for n in range(N):
        for k in range(K):
            if adj[n, k] == n and k != dslot[n]:
                blocks[n, k] = 0.0
    blocks[np.arange(N), dslot] += 3.0 * np.eye(f)
    return BlockELL.from_blocks(
        jnp.asarray(adj), jnp.asarray(blocks.astype(dtype)),
        jnp.asarray(dslot))


def test_slab_plan_bands_match_dense():
    space = _pore_space(n_fields=2)
    ell = _random_ell(space, 2, seed=1)
    N, f = space.num_vertices, 2
    plan = SlabPlan.build(np.asarray(space.adj),
                          np.asarray(space.points)[:, -1], f,
                          np.asarray(space.diag_slot))
    lo, di, up = plan.bands(ell, dtype=jnp.float64)

    # reconstruct the permuted dense matrix from the bands
    S, m = plan.S, plan.m
    big = np.zeros((S * m, S * m))
    for s in range(S):
        big[s*m:(s+1)*m, s*m:(s+1)*m] = np.asarray(di[s])
        if s > 0:
            big[s*m:(s+1)*m, (s-1)*m:s*m] = np.asarray(lo[s])
        if s < S - 1:
            big[s*m:(s+1)*m, (s+1)*m:(s+2)*m] = np.asarray(up[s])

    dense = np.asarray(ell.to_dense())          # (N*f, N*f), old ordering
    # permute dense into slab ordering
    dof_perm = (plan.perm[:, None] * f + np.arange(f)[None, :]).reshape(-1)
    valid = dof_perm < N * f
    P = np.nonzero(valid)[0]
    dp = dof_perm[valid]
    np.testing.assert_allclose(big[np.ix_(P, P)], dense[np.ix_(dp, dp)],
                               rtol=0, atol=1e-14)
    # padded rows are identity
    pad = np.nonzero(~valid)[0]
    for i in pad:
        row = big[i]
        assert row[i] == 1.0 and np.abs(row).sum() == 1.0


def test_slab_factor_solve_vs_numpy():
    rng = np.random.default_rng(3)
    S, m = 6, 24
    lo = rng.standard_normal((S, m, m)) * 0.1
    up = rng.standard_normal((S, m, m)) * 0.1
    di = rng.standard_normal((S, m, m)) * 0.1 + 4 * np.eye(m)
    lo[0] = 0.0
    up[-1] = 0.0
    d = rng.standard_normal((S, m))

    big = np.zeros((S * m, S * m))
    for s in range(S):
        big[s*m:(s+1)*m, s*m:(s+1)*m] = di[s]
        if s > 0:
            big[s*m:(s+1)*m, (s-1)*m:s*m] = lo[s]
        if s < S - 1:
            big[s*m:(s+1)*m, (s+1)*m:(s+2)*m] = up[s]
    x_ref = np.linalg.solve(big, d.reshape(-1)).reshape(S, m)

    factors = slab_factor(jnp.asarray(lo), jnp.asarray(di), jnp.asarray(up))
    x = np.asarray(slab_solve(factors, jnp.asarray(d)))
    np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-10)


def test_slab_solve_matrix_rhs():
    """slab_solve with a (S, m, k) matrix RHS equals k separate vector
    solves — the distributed SPIKE solver computes its spikes this way
    (parallel.shard: V = A^-1 [0;..;B_p], h columns at once)."""
    rng = np.random.default_rng(7)
    S, m, k = 5, 12, 4
    lo = rng.standard_normal((S, m, m)) * 0.1
    up = rng.standard_normal((S, m, m)) * 0.1
    di = rng.standard_normal((S, m, m)) * 0.1 + 4 * np.eye(m)
    lo[0] = 0.0
    up[-1] = 0.0
    D = rng.standard_normal((S, m, k))

    factors = slab_factor(jnp.asarray(lo), jnp.asarray(di), jnp.asarray(up))
    X = np.asarray(slab_solve(factors, jnp.asarray(D)))
    for j in range(k):
        xj = np.asarray(slab_solve(factors, jnp.asarray(D[:, :, j])))
        np.testing.assert_allclose(X[:, :, j], xj, rtol=1e-12, atol=1e-13)


def test_slab_direct_solve_f64_accuracy():
    """f32 factorization + f64 refinement reaches 1e-10 relative residual
    on a random banded system at condition ~1e4."""
    space = _pore_space(n_fields=3)
    f = 3
    ell = _random_ell(space, f, seed=5)
    # skew the row scales to exercise the equilibration
    N = space.num_vertices
    scale = 10.0 ** np.linspace(-2, 2, N)
    blocks4 = np.asarray(ell.blocks4()) * scale[:, None, None, None]
    ell = BlockELL.from_blocks(ell.adj, jnp.asarray(blocks4), ell.diag_slot)

    rng = np.random.default_rng(7)
    rhs = jnp.asarray(rng.standard_normal((N, f)))
    plan = SlabPlan.build(np.asarray(space.adj),
                          np.asarray(space.points)[:, -1], f,
                          np.asarray(space.diag_slot))
    res = jax.jit(
        lambda e, r: slab_direct_solve(e, r, plan, tol=1e-10))(ell, rhs)
    assert bool(res.converged), float(res.resnorm)

    x_ref = np.linalg.solve(np.asarray(ell.to_dense()),
                            np.asarray(rhs).reshape(-1)).reshape(N, f)
    err = np.abs(np.asarray(res.x) - x_ref).max() / np.abs(x_ref).max()
    assert err < 1e-8, err


def test_slab_apply_f32_direction_quality():
    """The native-f32 chord-direction solve (slab_apply_f32: f32 banded
    preconditioner + block-ELL contraction inside an all-f32 GMRES)
    reaches ~tol-quality directions on an equilibration-stressed system —
    accurate far beyond what a chord iteration needs (its error budget is
    Jacobian staleness, ~1e-2-level)."""
    from gmpnp.solve.slab import slab_apply_f32, slab_prepare

    space = _pore_space(n_fields=3)
    f = 3
    ell = _random_ell(space, f, seed=11)
    N = space.num_vertices
    scale = 10.0 ** np.linspace(-2, 2, N)
    blocks4 = np.asarray(ell.blocks4()) * scale[:, None, None, None]
    ell = BlockELL.from_blocks(ell.adj, jnp.asarray(blocks4), ell.diag_slot)

    rng = np.random.default_rng(13)
    rhs = jnp.asarray(rng.standard_normal((N, f)))
    plan = SlabPlan.build(np.asarray(space.adj),
                          np.asarray(space.points)[:, -1], f,
                          np.asarray(space.diag_slot))
    prep = slab_prepare(ell, plan)
    res = jax.jit(
        lambda p, r: slab_apply_f32(p, r, plan, tol=1e-5))(prep, rhs)
    assert res.x.dtype == rhs.dtype  # cast back to the caller's dtype

    x_ref = np.linalg.solve(np.asarray(ell.to_dense()),
                            np.asarray(rhs).reshape(-1)).reshape(N, f)
    err = (np.linalg.norm(np.asarray(res.x) - x_ref)
           / np.linalg.norm(x_ref))
    assert err < 1e-3, err


@pytest.mark.slow
def test_newton_step_slab_vs_bicgstab():
    """One implicit 3D GMPNP step with kind='slab_direct' matches the
    round-1 BiCGStab path to Krylov-tolerance accuracy."""
    from gmpnp.models import pore_3d
    from gmpnp.solve.timeloop import LinearConfig, make_implicit_step

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=100e-9, R=10e-9,
                               mesh_resolution=(2, 8))
    prog = pore_3d.build(cfg)
    nf, ns = cfg.n_fields, len(cfg.species)
    theta = {"dt": jnp.asarray(prog.dt_scaled),
             "co2_s1": jnp.asarray(prog.eq_conc["CO2"]
                                   / prog.bulk_conc["CO2"])}
    u0 = jnp.ones((prog.space.num_vertices, nf)).at[:, ns].set(0.0)

    step_k = make_implicit_step(
        prog.space, prog.form, cfg.newton,
        LinearConfig(kind="bicgstab", tol=1e-10, maxiter=20000),
        bc_of_theta=prog._bc_of_theta)
    step_d = make_implicit_step(
        prog.space, prog.form, cfg.newton,
        LinearConfig(kind="slab_direct", tol=1e-10),
        bc_of_theta=prog._bc_of_theta)

    u_k, st_k = jax.jit(step_k)(u0, theta)
    u_d, st_d = jax.jit(step_d)(u0, theta)
    assert bool(st_k.converged) and bool(st_d.converged)
    assert int(st_d.newton_iters) <= int(st_k.newton_iters)
    np.testing.assert_allclose(np.asarray(u_d), np.asarray(u_k),
                               rtol=2e-6, atol=2e-8)


@pytest.mark.slow
def test_newton_step_slab_vs_dense_1e8():
    """BASELINE.md parity bar: one implicit 3D GMPNP
    step solved with the production slab_direct path agrees with the
    dense-f64-direct oracle to <= 1e-8 relative L2 on every field, at
    production Newton tolerances (ref 3D/MPNP_CO2ER_pore.py:789-799)."""
    from gmpnp.models import pore_3d
    from gmpnp.solve.timeloop import LinearConfig, make_implicit_step

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=100e-9, R=10e-9,
                               mesh_resolution=(2, 8))
    prog = pore_3d.build(cfg)
    nf, ns = cfg.n_fields, len(cfg.species)
    theta = {"dt": jnp.asarray(prog.dt_scaled),
             "co2_s1": jnp.asarray(prog.eq_conc["CO2"]
                                   / prog.bulk_conc["CO2"])}
    u0 = jnp.ones((prog.space.num_vertices, nf)).at[:, ns].set(0.0)

    step_dense = make_implicit_step(
        prog.space, prog.form, cfg.newton, LinearConfig(kind="dense"),
        bc_of_theta=prog._bc_of_theta)
    step_slab = make_implicit_step(
        prog.space, prog.form, cfg.newton,
        LinearConfig(kind="slab_direct", tol=1e-12, max_refine=60),
        bc_of_theta=prog._bc_of_theta)

    u_ref, st_ref = jax.jit(step_dense)(u0, theta)
    u_s, st_s = jax.jit(step_slab)(u0, theta)
    assert bool(st_ref.converged) and bool(st_s.converged)

    a, b = np.asarray(u_s), np.asarray(u_ref)
    for f in range(nf):
        rel = (np.linalg.norm(a[:, f] - b[:, f])
               / max(np.linalg.norm(b[:, f]), 1e-30))
        assert rel <= 1e-8, (f, rel)


@pytest.mark.slow
def test_newton_step_frozen_factorization_refresh_step():
    """LinearConfig.refresh='step' (modified Newton: one factorization per
    time step, solve.slab.SlabPrepared) converges to the same solution as
    exact Newton — convergence is certified on the true f64 residual
    either way — within a few extra (cheap) iterations."""
    from gmpnp.models import pore_3d
    from gmpnp.solve.timeloop import LinearConfig, make_implicit_step

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=100e-9, R=10e-9,
                               mesh_resolution=(2, 8))
    prog = pore_3d.build(cfg)
    nf, ns = cfg.n_fields, len(cfg.species)
    theta = {"dt": jnp.asarray(prog.dt_scaled),
             "co2_s1": jnp.asarray(prog.eq_conc["CO2"]
                                   / prog.bulk_conc["CO2"])}
    u0 = jnp.ones((prog.space.num_vertices, nf)).at[:, ns].set(0.0)

    # tight Newton tolerance so both solutions approach the exact one and
    # the comparison is not dominated by the 1e-4 convergence envelope
    import dataclasses
    newton = dataclasses.replace(cfg.newton, rtol=1e-10, atol=1e-10,
                                 max_iter=100)
    step_exact = make_implicit_step(
        prog.space, prog.form, newton,
        LinearConfig(kind="slab_direct", tol=1e-10),
        bc_of_theta=prog._bc_of_theta)
    step_frozen = make_implicit_step(
        prog.space, prog.form, newton,
        LinearConfig(kind="slab_direct", tol=1e-10, refresh="step"),
        bc_of_theta=prog._bc_of_theta)

    # two consecutive time steps (the second starts from a physical state)
    u1_e, st1_e = jax.jit(step_exact)(u0, theta)
    u2_e, st2_e = jax.jit(step_exact)(u1_e, theta)
    u1_f, st1_f = jax.jit(step_frozen)(u0, theta)
    u2_f, st2_f = jax.jit(step_frozen)(u1_f, theta)

    assert bool(st1_e.converged) and bool(st2_e.converged)
    assert bool(st1_f.converged) and bool(st2_f.converged)
    # same nonlinear solution (both residuals driven to 1e-10)
    np.testing.assert_allclose(np.asarray(u1_f), np.asarray(u1_e),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(u2_f), np.asarray(u2_e),
                               rtol=1e-6, atol=1e-9)
    # bounded extra iteration cost (modified Newton converges linearly)
    assert int(st1_f.newton_iters) <= 8 * max(int(st1_e.newton_iters), 1)


def test_slab_factor_fused_matches_unfused():
    """slab_factor_fused (per-slab gather inside the elimination scan —
    the HBM-safe path) produces the same factors as bands() + slab_factor."""
    from gmpnp.solve.slab import slab_factor, slab_factor_fused

    space = _pore_space(n_fields=3)
    ell = _random_ell(space, 3, seed=7)
    plan = SlabPlan.build(np.asarray(space.adj),
                          np.asarray(space.points)[:, -1], 3,
                          np.asarray(space.diag_slot))
    lo, di, up = plan.bands(ell, dtype=jnp.float32)
    ref = slab_factor(lo, di, up)
    fused = slab_factor_fused(ell, plan)
    np.testing.assert_allclose(np.asarray(fused.Al), np.asarray(ref.Al),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(fused.Dinv), np.asarray(ref.Dinv),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fused.Cp), np.asarray(ref.Cp),
                               rtol=1e-5, atol=1e-6)


def test_slab_cr_matches_thomas_and_numpy():
    """Slab-granular block cyclic reduction (slab_factor_cr/slab_solve_cr)
    equals block-Thomas and the dense solve for every slab count parity
    (S odd/even/1/2) and for vector and matrix right-hand sides."""
    from gmpnp.solve.slab import slab_factor_cr, slab_solve_cr

    rng = np.random.default_rng(11)
    m = 16
    for S in (1, 2, 3, 6, 7, 22):
        lo = rng.standard_normal((S, m, m)) * 0.1
        up = rng.standard_normal((S, m, m)) * 0.1
        di = rng.standard_normal((S, m, m)) * 0.1 + 4 * np.eye(m)
        lo[0] = 0.0
        up[-1] = 0.0
        d = rng.standard_normal((S, m))

        big = np.zeros((S * m, S * m))
        for s in range(S):
            big[s*m:(s+1)*m, s*m:(s+1)*m] = di[s]
            if s > 0:
                big[s*m:(s+1)*m, (s-1)*m:s*m] = lo[s]
            if s < S - 1:
                big[s*m:(s+1)*m, (s+1)*m:(s+2)*m] = up[s]
        x_ref = np.linalg.solve(big, d.reshape(-1)).reshape(S, m)

        fac = slab_factor_cr(jnp.asarray(lo), jnp.asarray(di),
                             jnp.asarray(up))
        x = np.asarray(slab_solve_cr(fac, jnp.asarray(d)))
        np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-10,
                                   err_msg=f"S={S}")

        x_th = np.asarray(slab_solve(
            slab_factor(jnp.asarray(lo), jnp.asarray(di), jnp.asarray(up)),
            jnp.asarray(d)))
        np.testing.assert_allclose(x, x_th, rtol=1e-11, atol=1e-12,
                                   err_msg=f"S={S}")

        D = jnp.asarray(rng.standard_normal((S, m, 3)))
        X = np.asarray(slab_solve_cr(fac, D))
        for j in range(3):
            np.testing.assert_allclose(
                X[:, :, j], np.asarray(slab_solve_cr(fac, D[:, :, j])),
                rtol=1e-12, atol=1e-13, err_msg=f"S={S} col {j}")


def test_slab_direct_solve_cr_mode_assembled_jacobian():
    """mode='cr' end-to-end (equilibrate + f32 CR factorization + f64
    GMRES polish) reaches the same f64 accuracy as mode='thomas' on a
    real random-block system, and the timeloop knob validates."""
    space = _pore_space(n_fields=3)
    ell = _random_ell(space, 3, seed=5)
    plan = SlabPlan.build(np.asarray(space.adj),
                          np.asarray(space.points)[:, -1], 3,
                          np.asarray(space.diag_slot))
    rng = np.random.default_rng(5)
    rhs = jnp.asarray(rng.standard_normal((space.num_vertices, 3)))

    res_cr = slab_direct_solve(ell, rhs, plan, mode="cr")
    res_th = slab_direct_solve(ell, rhs, plan, mode="thomas")
    assert bool(res_cr.converged) and bool(res_th.converged)
    np.testing.assert_allclose(np.asarray(res_cr.x), np.asarray(res_th.x),
                               rtol=1e-8, atol=1e-10)

    from gmpnp.solve.timeloop import LinearConfig, _validate_linear_config
    _validate_linear_config(LinearConfig(kind="slab_direct", slab_mode="cr"))
    with pytest.raises(ValueError, match="slab_mode"):
        _validate_linear_config(
            LinearConfig(kind="slab_direct", slab_mode="CR"))
