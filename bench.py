"""Benchmark of the five BASELINE configs on a GPU.

BASELINE.json's configs (SURVEY.md §6, BASELINE.md):
  1. 1D reaction-diffusion planar    — 5 fields x 5,991 nodes x 500 steps
     (1D/rxn_diff_planar.py:169-206)
  2. 1D GMPNP EDL (flagship 1D)      — 7 fields x 1,091 nodes, dry-run
     window (1D/MPNP_CO2ER_EDL.py:216-290)
  3. Stern post-solve                — closed-form + ODE, 5 voltages
     (1D/Stern_CO2ER.py:179-180); host-side, recorded for completeness
  4. 3D rxn-diff pore at L_50_R_5    — 7 fields x 3,679 nodes
     (3D/rxn_diff_CO2ER_pore.py:287-323)
  5. 3D GMPNP pore                   — 9 fields + voltage sweep
     (3D/MPNP_CO2ER_pore.py:329-365).  Three geometries: the shipped
     L_50_R_5 (N=3,679; the headline), the shipped L_50_R_10 (N=5,411;
     the fattest shipped radius — config 5 as WRITTEN names L_100_R_10,
     a missing blob, so R=10 is the axis that must be exercised), and a
     regenerated L_100_R_10-equivalent cylinder (the missing blob
     rebuilt by mesh/generators.cylinder_mesh).

Protocol: AOT-compile, one warm-up execution, then the median of REPS
timed executions each ending in a value fetch — on both backends.  CPU
costs are cached in bench_cpu_baseline.json (not committed) keyed by
config+protocol version.  3D transients use an N_STEPS-step window; the 1D
configs run their full reference schedules.

Every 3D record carries two ratios:
  vs_baseline        = exact-Newton CPU / carried-chord GPU   (hardware
                       speedup x algorithmic improvement — the production
                       operating point)
  vs_baseline_exact  = exact-Newton CPU / exact-Newton GPU    (hardware
                       speedup, same algorithm both sides)
The field-parity claim is pinned to the exact-Newton program
(tests/test_slab.py::test_newton_step_slab_vs_dense_1e8).

Orchestration: the parent never initialises JAX.  ONE child process runs
the whole config queue on the GPU (one process per card), streaming a
BENCHCFG record line after EACH config; the parent enforces a global
wall-clock budget (GMPNP_BENCH_BUDGET_S, default 3600 s), kills the child
at the deadline, and ALWAYS prints the final JSON line with whatever was
measured.  The child refuses to run on anything but a GPU.

This file is brought up only as far as running on a GPU; cells, per-layer
times and peak rates are left to the benchmark rework (ROADMAP Speed 1-2).
"""

import json
import os
import sys
import time

import numpy as np

N_STEPS = 8
REPS = 3
VER = "v6"
HERE = os.path.dirname(os.path.abspath(__file__))
_CPU_CACHE = os.path.join(HERE, "bench_cpu_baseline.json")
os.environ.setdefault("GMPNP_UTILITIES", "/root/reference/utilities")

# (name, record key, min seconds of remaining budget to attempt).  Order is
# priority order: the headline first, then the remaining BASELINE configs,
# then the config-5 geometry/sweep axes.  Beyond-reference extras (xl,
# edl_sweep) run only when named explicitly.
CONFIGS = [
    ("pore", "pore3d", 240),
    ("rxn3d", "pore3d_rxndiff", 240),
    ("edl", "edl1d", 150),
    ("stern", "stern", 15),
    ("sweep", "pore3d_sweep", 300),
    ("pore_r10", "pore3d_r10", 300),
    ("pore_l100r10", "pore3d_l100r10", 300),
    ("sweep_r10", "pore3d_sweep_r10", 350),
    # rxn1d runs last (the slowest 1D record: the full 500-step schedule)
    ("rxn1d", "rxndiff1d", 500),
]
EXTRA_CONFIGS = [
    ("xl", "pore3d_gmpnp_xl", 500),
    ("edl_sweep", "edl1d_sweep", 300),
]
_KEY_OF = {n: k for n, k, _ in CONFIGS + EXTRA_CONFIGS}


def _scan_transient(prog, step, n_steps, carry_extra, update_carry=None):
    import jax
    import jax.numpy as jnp

    def run(u0):
        def body(carry, i):
            u, extra = carry
            th = prog._theta_of_carry((u, extra), i)
            u_new, st = step(u, th)
            if update_carry is not None:
                extra = update_carry(extra, u_new, i)
            return (u_new, extra), st.newton_iters

        (u, _), iters = jax.lax.scan(
            body, (u0, carry_extra), jnp.arange(n_steps))
        return u, iters

    return run


def _scan_transient_carried(prog, step, prep_init, n_steps, carry_extra):
    """Stateful-step variant: the slab factorization rides the scan carry
    (timeloop.make_carried_step — the fast 3D production mode)."""
    import jax
    import jax.numpy as jnp

    def run(u0):
        th0 = prog._theta_of_carry((u0, carry_extra), jnp.asarray(0))
        prep0 = prep_init(u0, th0)

        def body(carry, i):
            u, extra, prep = carry
            th = prog._theta_of_carry((u, extra), i)
            u_new, st, prep = step(u, th, prep)
            return (u_new, extra, prep), st.newton_iters

        (u, _, _), iters = jax.lax.scan(
            body, (u0, carry_extra, prep0), jnp.arange(n_steps))
        return u, iters

    return run


def _pore_run(prog, cfg, refresh):
    """Build the timed N_STEPS transient for a pore program: exact Newton
    (refresh='iter' — the reference MUMPS-semantics program, used as the
    single-CPU-core baseline AND for vs_baseline_exact on the accelerator)
    or the carried-factor production mode (refresh='carried')."""
    import dataclasses

    import jax.numpy as jnp

    if refresh == "carried":
        from gmpnp.solve.timeloop import make_carried_step

        lin = dataclasses.replace(cfg.linear, refresh="carried")
        step, prep_init = make_carried_step(
            prog.space, prog.form, cfg.newton, lin,
            bc_of_theta=prog._bc_of_theta)
        return _scan_transient_carried(prog, step, prep_init, N_STEPS,
                                       jnp.asarray(0.0))
    from gmpnp.solve.timeloop import make_implicit_step

    step = make_implicit_step(prog.space, prog.form, cfg.newton, cfg.linear,
                              bc_of_theta=prog._bc_of_theta)
    return _scan_transient(prog, step, N_STEPS, jnp.asarray(0.0))


def _pore_build(cfg, tag, refresh):
    import jax.numpy as jnp

    from gmpnp.models import pore_3d

    prog = pore_3d.build(cfg)
    nf, ns = cfg.n_fields, len(cfg.species)
    run = _pore_run(prog, cfg, refresh)
    u0 = jnp.ones((prog.space.num_vertices, nf))
    if cfg.physics == "GMPNP":
        u0 = u0.at[:, ns].set(0.0)
    mode = "slab-carried" if refresh == "carried" else "slab"
    key = f"{tag}/N{prog.space.num_vertices}/steps{N_STEPS}/{mode}/{VER}"
    return run, u0, key, N_STEPS


def _build_pore(refresh="carried"):
    from gmpnp.models import pore_3d

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=50e-9, R=5e-9)
    return _pore_build(cfg, "pore3d_gmpnp/L50R5", refresh)


def _build_pore_r10(refresh="carried"):
    """Config-5 radius axis: the shipped L_50_R_10.xml (N=5,411) — the
    fattest shipped radius.  R/L doubles vs the headline mesh, which
    grows the slab cross-section block size m (block-Thomas is O(S*m^3)).
    Ref: 3D/MPNP_CO2ER_pore.py:329-332; utilities/L_50_R_10.xml:3."""
    from gmpnp.models import pore_3d

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=50e-9, R=10e-9)
    return _pore_build(cfg, "pore3d_gmpnp/L50R10", refresh)


def _build_pore_l100r10(refresh="carried"):
    """BASELINE config 5 as WRITTEN: L_100_R_10 — a missing blob
    (.MISSING_LARGE_BLOBS:2) regenerated by the framework's cylinder
    generator at the shipped family's density (n_rings=4 like the
    same-aspect L_50_R_5, n_layers=59 -> N=3,660 vs its 3,679)."""
    from gmpnp.models import pore_3d

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=100e-9, R=10e-9,
                               mesh_resolution=(4, 59))
    return _pore_build(cfg, "pore3d_gmpnp_l100r10/gen4x59", refresh)


def _build_pore_xl(refresh="carried"):
    """Beyond-reference scale: 3D GMPNP at a generated 12,319-vertex
    cylinder mesh — 3.3x the shipped reference mesh's DoFs."""
    from gmpnp.models import pore_3d

    util = os.environ.pop("GMPNP_UTILITIES", None)   # force the generator
    try:
        cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=50e-9, R=5e-9,
                                   mesh_resolution=(6, 96))
        return _pore_build(cfg, "pore3d_gmpnp_xl/gen6x96", refresh)
    finally:
        if util is not None:
            os.environ["GMPNP_UTILITIES"] = util


def _build_rxn3d(refresh="carried"):
    """BASELINE config 4: 3D rxn-diff pore at the shipped L_50_R_5."""
    from gmpnp.models import pore_3d

    cfg = pore_3d.Pore3DConfig(physics="rxn_diff", L=50e-9, R=5e-9)
    return _pore_build(cfg, "pore3d_rxndiff/L50R5", refresh)


def _build_edl(refresh="carried"):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from gmpnp.models import edl_1d

    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, dry_run=True)
    prog = edl_1d.build(cfg)
    n = 100   # dry-run schedule length (ref 1D/MPNP_CO2ER_EDL.py:256-268)
    chf0 = jnp.asarray(0.001 if cfg.H_OHP is not None else 0.0)
    if refresh == "carried":
        from gmpnp.solve.timeloop import make_carried_step

        lin = dataclasses.replace(cfg.linear, refresh="carried")
        step, prep_init = make_carried_step(
            prog.space, prog.form, cfg.newton, lin,
            bc_of_theta=lambda theta: prog.bc)

        def run(u0):
            th0 = prog._theta_of_carry((u0, chf0), jnp.asarray(0))
            prep0 = prep_init(u0, th0)

            def body(carry, i):
                u, chf, prep = carry
                th = prog._theta_of_carry((u, chf), i)
                u_new, st, prep = step(u, th, prep)
                chf = prog._update_carry(chf, u_new, i)
                return (u_new, chf, prep), st.newton_iters

            (u, _, _), iters = jax.lax.scan(
                body, (u0, chf0, prep0), jnp.arange(n))
            return u, iters
    else:
        from gmpnp.solve.timeloop import make_implicit_step

        step = make_implicit_step(
            prog.space, prog.form, cfg.newton, cfg.linear,
            bc_of_theta=lambda theta: prog.bc)
        run = _scan_transient(prog, step, n, chf0,
                              update_carry=prog._update_carry)
    u0 = jnp.concatenate(
        [jnp.ones((prog.space.num_vertices, 6)),
         jnp.zeros((prog.space.num_vertices, 1))], axis=1)
    mode = "cr-carried" if refresh == "carried" else "cr"
    key = f"edl1d_gmpnp/1um/N{prog.space.num_vertices}/steps{n}/{mode}/{VER}"
    return run, u0, key, n


def _build_rxn1d():
    """BASELINE config 1: 1D rxn-diff planar, 50um mesh (N=5991), the FULL
    500-step schedule (dt=2e-2 s, T=10 s; 1D/rxn_diff_planar.py:169-206)."""
    import jax
    import jax.numpy as jnp

    from gmpnp.models import rxn_diff_1d
    from gmpnp.solve.timeloop import make_implicit_step

    cfg = rxn_diff_1d.RxnDiff1DConfig(L_n=50.0e-6)
    prog = rxn_diff_1d.build(cfg)
    n = prog.num_steps
    step = make_implicit_step(prog.space, prog.form, cfg.newton, cfg.linear,
                              bc_of_theta=lambda theta: prog.bc)

    def run(u0):
        def body(carry, i):
            u_new, st = step(carry, prog.theta)
            return u_new, st.newton_iters

        u, iters = jax.lax.scan(body, u0, jnp.arange(n))
        return u, iters

    u0 = jnp.ones((prog.space.num_vertices, 5))
    key = f"rxndiff1d/50um/N{prog.space.num_vertices}/steps{n}/cr/{VER}"
    return run, u0, key, n


def _rxn1d_record(accel, chunk=20, reps=2):
    """Config-1 record: the full 500-step schedule as HOST-CHUNKED
    dispatches of one compiled ``chunk``-step program (whether the chunking
    is still needed on a GPU is ROADMAP Design 6).  CPU baseline: the
    cached single-scan full schedule (identical math; chunking only
    changes dispatch granularity)."""
    import jax
    import jax.numpy as jnp

    from gmpnp.models import rxn_diff_1d
    from gmpnp.solve.timeloop import make_implicit_step

    cfg = rxn_diff_1d.RxnDiff1DConfig(L_n=50.0e-6)
    prog = rxn_diff_1d.build(cfg)
    n = prog.num_steps
    assert n % chunk == 0
    step = make_implicit_step(prog.space, prog.form, cfg.newton, cfg.linear,
                              bc_of_theta=lambda theta: prog.bc)

    def run_chunk(u0):
        def body(carry, i):
            u_new, st = step(carry, prog.theta)
            return u_new, (st.newton_iters, st.converged)

        return jax.lax.scan(body, u0, jnp.arange(chunk))

    u0 = jax.device_put(jnp.ones((prog.space.num_vertices, 5)), accel)
    compiled = jax.jit(run_chunk).lower(u0).compile()

    def schedule():
        u, iters, nonconv = u0, 0, 0
        for _ in range(n // chunk):
            u, (it, cv) = compiled(u)
            iters += int(np.asarray(it).sum())
            nonconv += int((~np.asarray(cv)).sum())
        chk = float(abs(u).sum())
        assert np.isfinite(chk), "non-finite rxn1d state"
        return iters, nonconv

    compiled(u0)                      # warm-up dispatch
    ts, n_newton, nonconv = [], 0, 0
    for _ in range(reps):
        t0 = time.perf_counter()
        n_newton, nonconv = schedule()
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))
    key = f"rxndiff1d/50um/N{prog.space.num_vertices}/steps{n}/cr/{VER}"
    rec = {
        "ms_per_step": round(t / n * 1e3, 3),
        "ms_per_newton_iter": round(t / max(n_newton, 1) * 1e3, 3),
        "newton_iters": n_newton,
        "nonconverged_steps": nonconv,
        "reps": reps,
        "key": key + f"/host-chunk{chunk}",
        "mesh_nodes": prog.space.num_vertices,
        "note": ("full reference schedule via host-chunked "
                 f"dispatches ({chunk} steps/dispatch)"),
    }
    try:
        run_full, args, key_cpu, _ = _build_rxn1d()
        t_cpu = _cpu_seconds(run_full, args, key_cpu)
        rec["vs_baseline"] = round(t_cpu / t, 3)
        rec["cpu_ms_per_step"] = round(t_cpu / n * 1e3, 3)
        rec["cpu_key"] = key_cpu
    except Exception as e:
        rec["cpu_error"] = f"{type(e).__name__}: {str(e)[:300]}"
    return rec


def _build_edl_sweep(lanes=8):
    """Config-2 production operating point: 8-lane vmapped voltage sweep
    of the 1D EDL dry-run window (the reference runs these as independent
    cluster jobs, README.md:37-39).  Backtracking is ON with the
    production sweep config (non-monotone bounded-growth acceptance,
    parallel.sweep._sweep_newton): the sweep spans the published voltage
    range down to V=-12.5, where plain damped Newton diverges from the
    cold start at every dt."""
    import jax
    import jax.numpy as jnp

    from gmpnp.models import edl_1d
    from gmpnp.parallel.sweep import _sweep_newton
    from gmpnp.solve.timeloop import make_implicit_step

    cfg = edl_1d.EDL1DConfig(L_n=1.0e-6, dry_run=True)
    prog = edl_1d.build(cfg)
    P = edl_1d.P
    left = np.unique(
        prog.mesh.facets[prog.mesh.facet_markers == 1].reshape(-1))
    newton = _sweep_newton(cfg.newton)
    step = make_implicit_step(
        prog.space, prog.form, newton, cfg.linear,
        bc_of_theta=lambda theta: prog.bc.arith().set_value_arith(
            left, P, theta["voltage"]))
    n = 100

    def run(u0v, voltages):
        def single(u0_l, voltage):
            def body(carry, i):
                u, chf = carry
                th = prog._theta_of_carry((u, chf), i)
                th["voltage"] = voltage
                u_new, st = step(u, th)
                chf = prog._update_carry(chf, u_new, i)
                return (u_new, chf), st.newton_iters

            (u, _), iters = jax.lax.scan(
                body, (u0_l, jnp.asarray(0.0)), jnp.arange(n))
            return u, iters

        return jax.vmap(single)(u0v, voltages)

    u0 = jnp.concatenate(
        [jnp.ones((prog.space.num_vertices, 6)),
         jnp.zeros((prog.space.num_vertices, 1))], axis=1)
    u0v = jnp.stack([u0] * lanes)
    volts = jnp.asarray(np.linspace(-1.0, -12.5, lanes))
    key = (f"edl1d_sweep/1um/N{prog.space.num_vertices}"
           f"/steps{n}x{lanes}/cr-btg4/{VER}")
    return run, (u0v, volts), key, n * lanes


def _pore_sweep_build(cfg, tag, lanes, refresh):
    """Host-chunked 3D voltage sweep (the production large-mesh mode,
    parallel.sweep._auto_chunk): ONE compiled single-lane program with
    the wall voltage and Sechenov CO2 value as traced arguments through
    the pure-arithmetic BC (fem.dirichlet.ArithDirichletBC), executed
    once per lane.  Lanes span the reference's 3D operating regime
    up to its default wall voltage (-1.0, 3D/MPNP_CO2ER_pore.py:98);
    beyond ~-1.5 the 3D cold start at the full reference dt exceeds
    backward Euler's convergence basin on the shipped meshes (see
    docs/STATUS.md round 3 — the reference would die identically)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from gmpnp.models import pore_3d
    from gmpnp.parallel.sweep import _sweep_newton

    prog = pore_3d.build(cfg)
    nf, ns = cfg.n_fields, len(cfg.species)
    s2 = np.unique(
        prog.mesh.facets[prog.mesh.facet_markers == pore_3d.S2].reshape(-1))

    def bc_of_theta(theta):
        bc = prog.bc.arith()
        bc = bc.set_value_arith(prog.s1_verts, prog.idx["CO2"],
                                theta["co2_s1"])
        return bc.set_value_arith(s2, ns, theta["voltage"])

    newton = _sweep_newton(cfg.newton)
    if refresh == "carried":
        from gmpnp.solve.timeloop import make_carried_step

        lin = dataclasses.replace(cfg.linear, refresh="carried")
        step_c, prep_init = make_carried_step(
            prog.space, prog.form, newton, lin, bc_of_theta=bc_of_theta)

        def single(u0_l, voltage):
            th0 = prog._theta_of_carry((u0_l, jnp.asarray(0.0)),
                                       jnp.asarray(0))
            th0["voltage"] = voltage
            prep0 = prep_init(u0_l, th0)

            def body(carry, i):
                u, extra, prep = carry
                th = prog._theta_of_carry((u, extra), i)
                th["voltage"] = voltage
                u_new, st, prep = step_c(u, th, prep)
                return (u_new, extra, prep), st.newton_iters

            (u, _, _), iters = jax.lax.scan(
                body, (u0_l, jnp.asarray(0.0), prep0), jnp.arange(N_STEPS))
            return u, iters
    else:
        from gmpnp.solve.timeloop import make_implicit_step

        step = make_implicit_step(prog.space, prog.form, newton, cfg.linear,
                                  bc_of_theta=bc_of_theta)

        def single(u0_l, voltage):
            def body(carry, i):
                u, extra = carry
                th = prog._theta_of_carry((u, extra), i)
                th["voltage"] = voltage
                u_new, st = step(u, th)
                return (u_new, extra), st.newton_iters

            (u, _), iters = jax.lax.scan(
                body, (u0_l, jnp.asarray(0.0)), jnp.arange(N_STEPS))
            return u, iters

    u0 = jnp.ones((prog.space.num_vertices, nf)).at[:, ns].set(0.0)
    volts = jnp.asarray(np.linspace(-0.25, -1.0, lanes))
    mode = "btg4-carried" if refresh == "carried" else "btg4"
    key = (f"{tag}/N{prog.space.num_vertices}"
           f"/steps{N_STEPS}x{lanes}/v0.25-1.0-{mode}/{VER}")
    return single, (u0, volts), key, prog.space.num_vertices


def _build_pore_sweep(lanes=4, refresh="carried"):
    """BASELINE config 5's sweep AT THE REFERENCE MESH (shipped L_50_R_5,
    N=3679).  NOTE the carried key below predates the tag refactor and is
    kept byte-identical so cached CPU baselines stay valid."""
    from gmpnp.models import pore_3d

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=50e-9, R=5e-9)
    return _pore_sweep_build(cfg, "pore3d_sweep/L50R5", lanes, refresh)


def _build_pore_sweep_r10(lanes=4, refresh="carried"):
    """Config-5 sweep on the R=10 axis: shipped L_50_R_10 (N=5,411)."""
    from gmpnp.models import pore_3d

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=50e-9, R=10e-9)
    return _pore_sweep_build(cfg, "pore3d_sweep/L50R10", lanes, refresh)


def _timed_sweep_host(single, u0, volts, device, reps=REPS):
    """Host-chunked sweep timing: AOT-compile the single-lane program
    once (voltage is a traced argument), then per rep execute every lane
    and fetch each lane's checksum; median over reps."""
    import jax

    u0d = jax.device_put(u0, device)
    voltsd = [jax.device_put(v, device) for v in np.asarray(volts)]
    compiled = jax.jit(single).lower(u0d, voltsd[0]).compile()
    n_newton = 0
    for v in voltsd:                       # warm-up, all lanes
        out, iters = compiled(u0d, v)
        chk = float(abs(out).sum())
        assert np.isfinite(chk), "non-finite sweep lane"
        n_newton += int(np.asarray(iters).sum())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for v in voltsd:
            out, iters = compiled(u0d, v)
            float(abs(out).sum())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.std(ts)), n_newton


def _timed_run(run, args, device, reps=REPS, warmup=True):
    """AOT compile on device; warm-up; median of reps (exec + fetch).

    warmup=False (offline CPU baselines of the R=10 configs only) skips
    the untimed warm-up execution: a CPU window at that block size runs
    ~20+ min and the backend has no device-warm-up effect to flush."""
    import jax

    if not isinstance(args, tuple):
        args = (args,)
    argsd = tuple(jax.device_put(a, device) for a in args)
    compiled = jax.jit(run).lower(*argsd).compile()
    n_newton = None
    if warmup:
        out, iters = compiled(*argsd)
        chk = float(abs(out).sum())
        assert np.isfinite(chk), "non-finite bench result"
        n_newton = int(np.asarray(iters).sum())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out, iters = compiled(*argsd)
        chk = float(abs(out).sum())
        ts.append(time.perf_counter() - t0)
    if n_newton is None:
        assert np.isfinite(chk), "non-finite bench result"
        n_newton = int(np.asarray(iters).sum())
    return float(np.median(ts)), float(np.std(ts)), n_newton


def _deadline_remaining():
    dl = float(os.environ.get("GMPNP_BENCH_DEADLINE", "0") or 0)
    if dl <= 0:
        return float("inf")
    return dl - time.time()


def _cpu_cache():
    if os.path.exists(_CPU_CACHE):
        try:
            return json.load(open(_CPU_CACHE))
        except Exception:
            pass
    return {}


def _cpu_store(key, t):
    cache = _cpu_cache()
    cache[key] = t
    with open(_CPU_CACHE, "w") as f:
        json.dump(cache, f, indent=1)


def _cpu_seconds(run, args, key, timed=_timed_run):
    """Same compiled program on the host CPU backend — SAME median-of-REPS
    protocol as the accelerator measurement (cached by key+version).

    An UNCACHED baseline is measured only when the budget clearly allows
    it (a cold exact-Newton CPU window at reference scale costs minutes);
    the cache is committed to the repo, so driver runs normally hit it."""
    import jax

    cache = _cpu_cache()
    if cache.get(key) is not None:
        return float(cache[key])
    if os.environ.get("GMPNP_BENCH_SKIP_UNCACHED_CPU"):
        raise RuntimeError(
            f"uncached CPU baseline {key!r} skipped "
            f"(GMPNP_BENCH_SKIP_UNCACHED_CPU; run `python bench.py "
            f"--cpu-baselines` on a quiet core)")
    if _deadline_remaining() < 900:
        raise RuntimeError(
            f"uncached CPU baseline {key!r} skipped under wall-clock "
            f"budget (run `python bench.py --cpu-baselines` offline)")
    cpu = jax.devices("cpu")[0]
    if timed is _timed_run:
        t, _, _ = timed(run, args, cpu, reps=REPS)
    else:
        single, (u0, volts) = args
        t, _, _ = timed(single, u0, volts, cpu)
    _cpu_store(key, t)
    return t


def _transient_record(build, per_key, accel, exact_build=None):
    """Time ``build()``'s program on the accelerator; if ``exact_build``
    is given, ALSO time its exact-Newton program on the accelerator
    (vs_baseline_exact) and use it as the single-CPU-core baseline (the
    reference MUMPS-semantics proxy — what FEniCS actually executes per
    Newton iterate).  Both ratios are recorded so the headline decomposes
    into hardware speedup x algorithmic improvement."""
    run, args, key, denom = build()
    t, t_std, n_newton = _timed_run(run, args, accel)
    rec = {
        per_key: round(t / denom * 1e3, 3),
        "ms_per_newton_iter": round(t / max(n_newton, 1) * 1e3, 3),
        "newton_iters": n_newton,
        "spread_ms": round(t_std / denom * 1e3, 3),
        "reps": REPS,
        "key": key,
    }
    t_exact = None
    if exact_build is not None:
        run_e, args_e, key_e, denom_e = exact_build()
        try:
            t_exact, _, n_e = _timed_run(run_e, args_e, accel)
            rec[f"exact_{per_key}"] = round(t_exact / denom_e * 1e3, 3)
            rec["exact_newton_iters"] = n_e
            rec["exact_key"] = key_e
        except Exception as e:
            rec["exact_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    if t_exact is not None:
        # what refresh='auto' (timeloop.calibrate_refresh) picks: the
        # faster of the two measured modes
        rec["auto_mode"] = "carried" if t <= t_exact else "iter"
        rec[f"auto_{per_key}"] = min(rec[per_key], rec[f"exact_{per_key}"])
    try:
        if exact_build is not None:
            t_cpu = _cpu_seconds(run_e, args_e, key_e)
            rec["cpu_key"] = key_e
            rec["cpu_protocol"] = ("exact-Newton program (reference "
                                   "MUMPS-semantics proxy) on one core")
            if t_exact is not None:
                rec["vs_baseline_exact"] = round(t_cpu / t_exact, 3)
                rec["vs_baseline_auto"] = round(t_cpu / min(t, t_exact), 3)
        else:
            t_cpu = _cpu_seconds(run, args, key)
        rec["vs_baseline"] = round(t_cpu / t, 3)
        rec[f"cpu_{per_key}"] = round(t_cpu / denom * 1e3, 3)
    except Exception as e:
        rec["cpu_error"] = f"{type(e).__name__}: {str(e)[:300]}"
    return rec


def _sweep_record(build, accel, lanes, cpu=True, cpu_note=None):
    """Sweep analogue of _transient_record: carried on the accelerator,
    exact-Newton on the accelerator (vs_baseline_exact) and on one CPU
    core (the baseline).  ``cpu=False`` skips the CPU baseline entirely
    (``cpu_note`` says why and where the comparable ratio lives)."""
    single, (u0, volts), key, N = build(lanes, "carried")
    lane_steps = lanes * N_STEPS
    t, t_std, n_newton = _timed_sweep_host(single, u0, volts, accel)
    rec = {
        "ms_per_lane_step": round(t / lane_steps * 1e3, 3),
        "ms_per_newton_iter": round(t / max(n_newton, 1) * 1e3, 3),
        "newton_iters": n_newton,
        "spread_ms": round(t_std / lane_steps * 1e3, 3),
        "reps": REPS,
        "key": key,
        "lanes": lanes,
        "mesh_nodes": N,
        "mode": "host-chunked (one compiled program, executed per lane; "
                "see _pore_sweep_build docstring)",
    }
    single_b, (u0_b, volts_b), key_b, _ = build(lanes, "iter")
    t_exact = None
    try:
        t_exact, _, n_e = _timed_sweep_host(single_b, u0_b, volts_b, accel)
        rec["exact_ms_per_lane_step"] = round(t_exact / lane_steps * 1e3, 3)
        rec["exact_newton_iters"] = n_e
        rec["exact_key"] = key_b
    except Exception as e:
        rec["exact_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    if t_exact is not None:
        rec["auto_mode"] = "carried" if t <= t_exact else "iter"
        rec["auto_ms_per_lane_step"] = min(rec["ms_per_lane_step"],
                                           rec["exact_ms_per_lane_step"])
    if not cpu:
        rec["cpu_skipped"] = cpu_note or "CPU baseline not measured"
        return rec
    try:
        t_cpu = _cpu_seconds(None, (single_b, (u0_b, volts_b)), key_b,
                             timed=_timed_sweep_host)
        rec["cpu_key"] = key_b
        rec["cpu_protocol"] = ("exact-Newton program (reference "
                               "MUMPS-semantics proxy) on one core")
        rec["vs_baseline"] = round(t_cpu / t, 3)
        rec["cpu_ms_per_lane_step"] = round(t_cpu / lane_steps * 1e3, 3)
        if t_exact is not None:
            rec["vs_baseline_exact"] = round(t_cpu / t_exact, 3)
            rec["vs_baseline_auto"] = round(t_cpu / min(t, t_exact), 3)
    except Exception as e:
        rec["cpu_error"] = f"{type(e).__name__}: {str(e)[:300]}"
    return rec


# per-Newton-iter CPU costs measured earlier in the same child run, used
# to DERIVE a CPU baseline for configs whose direct CPU measurement is
# intractable (the R=10 sweep: ~hours/core).  Key: config name ->
# (cpu_seconds_of_exact_window, exact_newton_iters_of_that_window).
_CPU_PER_ITER = {}


def _child_config(config: str, accel) -> dict:
    """Run one bench config in this process and return its record."""
    if config == "pore":
        rec = _transient_record(
            lambda: _build_pore("carried"), "ms_per_step", accel,
            exact_build=lambda: _build_pore("iter"))
        rec["mesh_nodes"] = 3679
        return rec

    if config == "pore_r10":
        rec = _transient_record(
            lambda: _build_pore_r10("carried"), "ms_per_step", accel,
            exact_build=lambda: _build_pore_r10("iter"))
        rec["mesh_nodes"] = 5411
        if (rec.get("cpu_ms_per_step") is not None
                and rec.get("exact_newton_iters")):
            # per-Newton-iter CPU cost at the R=10 block size, for the
            # sweep_r10 derived baseline.  Newton
            # iteration counts are those of the same exact program on
            # the accelerator window (deterministic solver semantics).
            _CPU_PER_ITER["r10"] = (
                rec["cpu_ms_per_step"] * N_STEPS / 1e3,
                rec["exact_newton_iters"])
        rec["note"] = ("shipped L_50_R_10.xml — fattest shipped radius; "
                       "stresses the slab block size m (O(S*m^3) factor "
                       "cost); the CPU baseline is cached at reps=2 "
                       "with warm-up (median of 2 timed windows)")
        return rec

    if config == "pore_l100r10":
        rec = _transient_record(
            lambda: _build_pore_l100r10("carried"), "ms_per_step", accel,
            exact_build=lambda: _build_pore_l100r10("iter"))
        rec["note"] = ("BASELINE config 5 as written: L_100_R_10 is a "
                       "missing reference blob (.MISSING_LARGE_BLOBS:2) "
                       "regenerated by mesh/generators.cylinder_mesh at "
                       "the shipped family's density")
        return rec

    if config == "xl":
        rec = _transient_record(
            lambda: _build_pore_xl("carried"), "ms_per_step", accel,
            exact_build=lambda: _build_pore_xl("iter"))
        rec["mesh_nodes"] = 12319
        rec["note"] = "beyond-reference scale: 3.3x the shipped mesh's DoFs"
        return rec

    if config == "rxn3d":
        rec = _transient_record(
            lambda: _build_rxn3d("carried"), "ms_per_step", accel,
            exact_build=lambda: _build_rxn3d("iter"))
        rec["mesh_nodes"] = 3679
        return rec

    if config == "edl":
        return _transient_record(
            lambda: _build_edl("carried"), "ms_per_step", accel,
            exact_build=lambda: _build_edl("iter"))

    if config == "rxn1d":
        return _rxn1d_record(accel)

    if config == "edl_sweep":
        lanes = 8
        rec = _transient_record(lambda: _build_edl_sweep(lanes),
                                "ms_per_lane_step", accel)
        rec["lanes"] = lanes
        return rec

    if config == "sweep":
        return _sweep_record(_build_pore_sweep, accel, lanes=4)

    if config == "sweep_r10":
        rec = _sweep_record(
            _build_pore_sweep_r10, accel, lanes=4, cpu=False,
            cpu_note=("exact-Newton CPU at the R=10 sweep scale runs "
                      "~hours on one core (the R=10 cross-section grows "
                      "the slab block m; block-Thomas is O(S*m^3)); the "
                      "R=10 hardware-vs-CPU ratio lives in the pore_r10 "
                      "single-config record"))
        rec["note"] = "config-5 sweep on the R=10 axis (shipped L_50_R_10)"
        if "r10" in _CPU_PER_ITER and rec.get("exact_newton_iters"):
            # derived CPU baseline: per-Newton-iter CPU cost from the
            # pore_r10 single-config measurement at the SAME mesh/block
            # size, times this sweep's exact-window iteration count
            cpu_s, iters = _CPU_PER_ITER["r10"]
            t_cpu_est = cpu_s / max(iters, 1) * rec["exact_newton_iters"]
            lane_steps = rec["lanes"] * N_STEPS
            rec["cpu_derived_ms_per_lane_step"] = round(
                t_cpu_est / lane_steps * 1e3, 3)
            rec["vs_baseline_derived"] = round(
                t_cpu_est * 1e3 / lane_steps / rec["ms_per_lane_step"], 3)
            if rec.get("exact_ms_per_lane_step"):
                rec["vs_baseline_exact_derived"] = round(
                    t_cpu_est * 1e3 / lane_steps
                    / rec["exact_ms_per_lane_step"], 3)
            rec["cpu_derived_protocol"] = (
                "iters x (CPU s/Newton-iter from the pore_r10 exact "
                "window at the same mesh)")
        return rec

    if config == "stern":
        # host-side post-solve (config 3): closed-form BDM + linear model
        # over the 5-voltage published table (1D/Stern_CO2ER.py:179-180)
        from gmpnp.models import stern

        t0 = time.perf_counter()
        out = stern.run(write=False, make_plots=False)
        dt = time.perf_counter() - t0
        return {"ms_total": round(dt * 1e3, 2), "voltages": len(out),
                "note": "host-side post-processor; no device path"}

    raise ValueError(config)


def _emit(obj):
    sys.stdout.write("BENCHCFG" + json.dumps(obj) + "\n")
    sys.stdout.flush()


def _child_main(names):
    """Run a queue of configs in ONE process on the GPU, emitting a
    BENCHCFG line per config as it completes so the parent loses nothing
    on a crash or deadline kill."""
    import jax

    from gmpnp.utils.compile_cache import setup_compile_cache

    accel = jax.devices()[0]
    if accel.platform != "gpu":
        sys.exit(f"bench.py: no GPU (default backend {accel.platform!r}); "
                 f"only --cpu-baselines runs without one")
    setup_compile_cache()
    _emit({"init": str(accel), "device_kind": accel.device_kind,
           "device_count": len(jax.devices())})

    min_attempt = {n: m for n, _, m in CONFIGS + EXTRA_CONFIGS}
    for name in names:
        remaining = _deadline_remaining()
        if remaining < min_attempt.get(name, 120):
            _emit({"name": name, "record": {
                "skipped": (f"wall-clock budget exhausted "
                            f"({remaining:.0f}s left)")}})
            continue
        t0 = time.time()
        try:
            rec = _child_config(name, accel)
        except Exception as e:
            rec = {"error": f"{type(e).__name__}: {str(e)[:400]}"}
        rec["wall_s"] = round(time.time() - t0, 1)
        _emit({"name": name, "record": rec})


def _measure_cpu_baselines(names):
    """Offline helper: populate bench_cpu_baseline.json for the given
    configs (run during the build round so driver-time bench runs always
    hit the cache)."""
    os.environ["GMPNP_BENCH_DEADLINE"] = "0"
    builders = {
        "pore": (lambda: _build_pore("iter"), _timed_run),
        "pore_r10": (lambda: _build_pore_r10("iter"), _timed_run),
        "pore_l100r10": (lambda: _build_pore_l100r10("iter"), _timed_run),
        "xl": (lambda: _build_pore_xl("iter"), _timed_run),
        "rxn3d": (lambda: _build_rxn3d("iter"), _timed_run),
        "edl": (lambda: _build_edl("iter"), _timed_run),
        "rxn1d": (_build_rxn1d, _timed_run),
        "edl_sweep": (lambda: _build_edl_sweep(8), _timed_run),
        "sweep": (lambda: _build_pore_sweep(4, "iter"), _timed_sweep_host),
        "sweep_r10": (lambda: _build_pore_sweep_r10(4, "iter"),
                      _timed_sweep_host),
    }
    import jax

    jax.config.update("jax_platforms", "cpu")
    cpu = jax.devices("cpu")[0]
    # r10's cross-section makes an exact-Newton CPU window long, so it
    # takes reps=2 WITH warm-up.  The r10 SWEEP stays unmeasured directly
    # (~hours/core) and instead carries a derived baseline (see
    # _child_config sweep_r10).
    reps_of = {"pore_r10": 2, "sweep_r10": 1}
    for name in names:
        build, timed = builders[name]
        out = build()
        reps = reps_of.get(name, REPS)
        if timed is _timed_run:
            run, args, key, _ = out
            if _cpu_cache().get(key) is not None:
                print(f"{name}: cached {key}")
                continue
            t, _, _ = _timed_run(run, args, cpu, reps=reps,
                                 warmup=(reps > 1))
        else:
            single, (u0, volts), key, _ = out
            if _cpu_cache().get(key) is not None:
                print(f"{name}: cached {key}")
                continue
            t, _, _ = _timed_sweep_host(single, u0, volts, cpu, reps=reps)
        _cpu_store(key, t)
        print(f"{name}: {key} = {t:.1f}s", flush=True)


def main():
    import subprocess
    import threading

    argv = sys.argv[1:]
    if argv and argv[0] == "--child":
        _child_main(argv[1].split(","))
        return
    if argv and argv[0] == "--cpu-baselines":
        _measure_cpu_baselines(argv[1:] or [n for n, _, _ in CONFIGS])
        return

    budget = float(os.environ.get("GMPNP_BENCH_BUDGET_S", "3600"))
    deadline = time.time() + budget
    names = [n for n, _, _ in CONFIGS]
    if argv:
        valid = dict((n, 1) for n, _, _ in CONFIGS + EXTRA_CONFIGS)
        unknown = [a for a in argv if a not in valid]
        if unknown:
            raise SystemExit(f"unknown configs {unknown}; choose from "
                             f"{sorted(valid)}")
        names = argv

    env = dict(os.environ)
    env["GMPNP_BENCH_DEADLINE"] = repr(deadline)
    extra = {}
    queue = list(names)
    # one child at a time: it is the only process that touches the card
    p = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         ",".join(queue)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    lines = []

    def _reader(stream, sink):
        for ln in stream:
            sink.append(ln)

    errs = []
    tout = threading.Thread(target=_reader, args=(p.stdout, lines))
    terr = threading.Thread(target=_reader, args=(p.stderr, errs))
    tout.start()
    terr.start()
    seen = 0
    while p.poll() is None and time.time() < deadline:
        time.sleep(1.0)
        if len(lines) > seen:       # progress note for log watchers
            for ln in lines[seen:]:
                if ln.startswith("BENCHCFG"):
                    sys.stderr.write("[bench] " + ln[len("BENCHCFG"):])
                    sys.stderr.flush()
            seen = len(lines)
    if p.poll() is None:
        p.kill()
    tout.join(timeout=10)
    terr.join(timeout=10)
    p.wait()
    for ln in lines:
        if not ln.startswith("BENCHCFG"):
            continue
        try:
            obj = json.loads(ln[len("BENCHCFG"):])
        except Exception:
            continue
        if "name" in obj:
            extra[_KEY_OF[obj["name"]]] = obj["record"]
            if obj["name"] in queue:
                queue.remove(obj["name"])
    if p.returncode != 0 and queue:
        # the child died mid-config without reporting it: charge the
        # crash to the config it was running
        tail = "".join(errs).strip().splitlines()[-3:]
        extra[_KEY_OF[queue.pop(0)]] = {
            "error": f"child rc={p.returncode}: {' | '.join(tail)[-400:]}"}
    for name in queue:
        extra.setdefault(_KEY_OF[name], {"skipped": "not run"})

    pore = extra.get("pore3d", {})
    full = {
        "metric": "pore3d_gmpnp_transient_step_L50R5",
        "value": pore.get("ms_per_step"),
        "unit": "ms/step",
        "vs_baseline": pore.get("vs_baseline"),
        "vs_baseline_exact": pore.get("vs_baseline_exact"),
        "budget_s": budget,
        "wall_s": round(time.time() - (deadline - budget), 1),
        "extra": extra,
    }
    if "error" in pore or pore.get("ms_per_step") is None:
        # consumers must be able to tell "failed" from "measured null"
        full["error"] = pore.get("error", "headline config not measured")
    # Full records (per-config keys, Newton counts, protocol notes) go to a
    # file (not committed); the FINAL stdout line is a compact summary
    # under 1,500 chars, so a reader that keeps only the tail of stdout
    # still gets the headline fields.
    with open(os.path.join(HERE, "bench_records.json"), "w") as f:
        json.dump(full, f, indent=1)

    def _compact(rec):
        c = {}
        for src, dst in (("ms_per_step", "ms"), ("ms_per_lane_step", "ms"),
                         ("ms_total", "ms"), ("exact_ms_per_step", "ms_exact"),
                         ("exact_ms_per_lane_step", "ms_exact"),
                         ("vs_baseline", "vs"),
                         ("vs_baseline_exact", "vs_exact")):
            if rec.get(src) is not None:
                c[dst] = rec[src]
        if "error" in rec:
            c["error"] = rec["error"][:90]
        elif "skipped" in rec:
            c["skipped"] = rec["skipped"][:60]
        return c

    out = dict(full)
    out["extra"] = {k: _compact(r) for k, r in extra.items()}
    out["records_file"] = "bench_records.json"
    line = json.dumps(out, separators=(",", ":"))
    if len(line) > 1500:        # never let the tail window truncate again
        out["extra"] = {k: v for k, v in out["extra"].items()
                        if "error" not in v and "skipped" not in v}
        line = json.dumps(out, separators=(",", ":"))
        assert len(line) <= 1500, f"final bench line {len(line)} chars"
    print(line)


if __name__ == "__main__":
    main()
