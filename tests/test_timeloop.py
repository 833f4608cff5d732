"""Time-loop semantics: staged dt schedule, controller coupling, theta flow."""

import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.models import edl_1d


def test_staged_dt_schedule_values():
    """Non-dry-run schedule reproduces the reference staging
    (1D/MPNP_CO2ER_EDL.py:270-290): 10,000 steps of 1e-5 s then 10,000 of
    1e-3 s, switched by step index as a traced scalar."""
    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, dry_run=False)
    prog = edl_1d.build(cfg)
    sch = prog.schedule
    assert sch["n1"] == 10_000
    assert sch["n2"] == 10_000
    assert prog.tot_num_steps == 20_000
    np.testing.assert_allclose(
        sch["dt1"] * prog.time_constant, 1.0e-5, rtol=1e-12)
    np.testing.assert_allclose(
        sch["dt2"] * prog.time_constant, 1.0e-3, rtol=1e-12)

    u = jnp.ones((prog.space.num_vertices, 7))
    chf = jnp.asarray(0.0)
    th_early = prog._theta_of_carry((u, chf), jnp.asarray(0))
    th_late = prog._theta_of_carry((u, chf), jnp.asarray(sch["n1"]))
    assert float(th_early["dt"]) == pytest.approx(sch["dt1"])
    assert float(th_late["dt"]) == pytest.approx(sch["dt2"])


def test_dry_run_schedule():
    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, dry_run=True)
    prog = edl_1d.build(cfg)
    assert prog.tot_num_steps == 100   # ref :256-268
    np.testing.assert_allclose(
        prog.schedule["dt1"] * prog.time_constant, 1.0e-5, rtol=1e-12)


def test_controller_feeds_fluxes():
    """current_H_frac reshapes J_OH/J_H per the reference update (:789-793)."""
    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, H_OHP=1.1, dry_run=True)
    prog = edl_1d.build(cfg)
    u = jnp.ones((prog.space.num_vertices, 7))
    th0 = prog._theta_of_carry((u, jnp.asarray(0.0)), 0)
    th5 = prog._theta_of_carry((u, jnp.asarray(0.5)), 0)
    current = cfg.current_OHP_ss
    assert float(th0["J_H"]) == pytest.approx(0.0)
    assert float(th0["J_OH"]) == pytest.approx(
        -prog.J_pref["OH"] * current)
    assert float(th5["J_H"]) == pytest.approx(
        prog.J_pref["H"] * current * 0.5)
    assert float(th5["J_OH"]) == pytest.approx(
        -prog.J_pref["OH"] * current * 0.5)


def test_record_stride_matches_full_history():
    """record_stride=k keeps exactly every k-th state and the same final
    carry as the unstrided run (bounded-history item, SURVEY §5)."""
    import jax.numpy as jnp
    import numpy as np

    from gmpnp.solve.timeloop import StepStats, run_transient

    def step(u, theta):
        stats = StepStats(jnp.array(1, jnp.int32), jnp.asarray(True),
                          jnp.asarray(0.0), jnp.array(0, jnp.int32))
        return u * 1.5 + 1.0, stats

    u0 = jnp.ones((3,))
    (uf_full, _), (hist_full, _) = run_transient(step, (u0, None), 6)
    (uf_k, _), (hist_k, _) = run_transient(step, (u0, None), 6,
                                           record_stride=3)
    np.testing.assert_allclose(np.asarray(uf_k), np.asarray(uf_full))
    assert hist_k.shape[0] == 2
    np.testing.assert_allclose(np.asarray(hist_k),
                               np.asarray(hist_full)[[2, 5]])

    import pytest
    with pytest.raises(ValueError):
        run_transient(step, (u0, None), 7, record_stride=3)


def test_linear_config_validation():
    """Unrecognized string knobs fail fast instead of silently selecting a
    default path (refresh='Step' would otherwise run exact Newton)."""
    import pytest

    from gmpnp.solve.timeloop import LinearConfig, _validate_linear_config

    _validate_linear_config(LinearConfig())  # defaults are valid
    for bad in (dict(kind="nope"), dict(refresh="Step"),
                dict(slab_mode="lu"), dict(precond="ilu"),
                dict(jac_dtype="f16"), dict(solve_dtype="f16"),
                dict(chord_dtype="bf16")):
        with pytest.raises(ValueError):
            _validate_linear_config(LinearConfig(**bad))
    # every preconditioner is accepted on every backend
    for precond in ("block_jacobi", "ssor", "amg"):
        _validate_linear_config(LinearConfig(kind="gmres", precond=precond,
                                             solve_dtype="f32"))


def test_newton_loop_validation():
    import pytest

    from gmpnp.solve.newton import newton_solve

    with pytest.raises(ValueError):
        newton_solve(lambda u: u, lambda u, r: (r, 0),
                     jnp.ones(3), loop="While")


def test_auto_record_stride():
    from gmpnp.models.base import auto_record_stride

    assert auto_record_stride(100) == 1
    assert auto_record_stride(1000) == 1
    assert auto_record_stride(20000) == 20     # the EDL full schedule
    assert 20000 % auto_record_stride(20000) == 0
    k = auto_record_stride(1001)
    assert 1001 % k == 0 and 1001 // k <= 1000
    k = auto_record_stride(997)                # prime
    assert 997 % k == 0


def test_recovering_step_dt_scale():
    """make_recovering_step records the accepted dt halving in
    StepStats.dt_scale (recovery wired into production)."""
    from gmpnp.solve.timeloop import StepStats, make_retrying_step

    calls = []

    def step(u, theta):
        # diverges at the full dt, converges at dt/2 or smaller
        ok = theta["dt"] < 0.75
        stats = StepStats(jnp.array(1, jnp.int32), jnp.asarray(ok),
                          jnp.asarray(0.0), jnp.array(0, jnp.int32))
        return u + theta["dt"], stats

    retry = make_retrying_step(step, max_retries=3)
    u, st, scale = retry(jnp.ones(2), {"dt": jnp.asarray(1.0)})
    assert float(scale) == 0.5
    assert bool(st.converged)
    np.testing.assert_allclose(np.asarray(u), 1.5)
