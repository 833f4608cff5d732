"""Bring-up check of the GMPNP solver stack on one NVIDIA GPU.

Runs the flagship transients through the entry points users call, on the
GPU, and compares each with the same program on the host CPU or with a
dense f64 solve.  Exits non-zero, without a result line, when JAX finds no
GPU or when any phase misses its limit.

    python chip_smoke.py          # one card: device, pore, pore-carried,
                                  # slab-vs-dense, edl
    python chip_smoke.py --four   # four cards: the z-slab-sharded pore and
                                  # the lane-per-device voltage sweep only

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import jax
import numpy as np

# Limits, each with its reason.  A comparison of two runs is made where
# both solve their linear systems to TIGHT_TOL: at the pore's own linear
# tol (1e-6) GMRES stops at an iterate that depends on rounding, Newton
# accepts any state whose residual is below atol=1e-4, and two correct
# runs then differ by ~1e-4 per field.  Such a comparison measures the
# stopping rule, not the device.
TIGHT_TOL = 1.0e-10
#  - GPU vs CPU, same f64 program, 3 exact-Newton steps: only summation
#    order, XLA's kernel choices and the f32 factor's rounding differ.
POR_GPU_VS_CPU = 1.0e-6
#  - a run at the production tolerances vs the same run at TIGHT_TOL: both
#    are within the Newton tolerance of one solution; this bound catches a
#    wrong answer, not rounding.
POR_PRODUCTION_VS_TIGHT = 1.0e-3
#  - f32-chord (carried) vs exact Newton, 8 steps, Newton and linear
#    tolerances both TIGHT_TOL: each accepts only on the true f64 residual.
POR_CARRIED_VS_EXACT = 1.0e-5
#  - mixed-precision slab solve (f32 factor, f64 GMRES to TIGHT_TOL) vs
#    dense f64 LU: the pore's linear tol, as an error bound.  A factor
#    computed in TF32 shows as many more GMRES iterations or none
#    converging.
SLAB_VS_DENSE = 1.0e-6
#  - 1D EDL, f64 block cyclic reduction on both devices.
EDL_GPU_VS_CPU = 1.0e-8
#  - four-card runs vs the one-card program at TIGHT_TOL: the distributed
#    SPIKE solve against the one-card slab solve; sweep lanes run the
#    one-lane program on their own card.
SHARD_VS_SINGLE = 1.0e-7

POR_STEPS = 3
CARRIED_STEPS = 8
SWEEP_VOLTS = (-0.25, -0.5, -0.75, -1.0)
SWEEP_STEPS = 2

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


class CompileClock:
    """Host time spent tracing, lowering and compiling: the union of JAX's
    compile-event spans (nested traces are counted once)."""

    def __init__(self):
        self.spans = []
        jax.monitoring.register_event_time_span_listener(self._on_span)

    def _on_span(self, event, start, end, **_):
        if event in _COMPILE_EVENTS:
            self.spans.append((start, end))

    def seconds_between(self, t0: float, t1: float) -> float:
        spans = sorted((max(s, t0), min(e, t1)) for s, e in self.spans
                       if e > t0 and s < t1)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in f64 (0 when both are zero)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    num = np.linalg.norm(a - b)
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return float(num / den)


def result_line(platform: str, kind: str, count: int) -> str:
    """The script's last line of standard output."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


class Smoke:
    def __init__(self):
        self.clock = CompileClock()
        self.failed = []            # names of the phases that failed

    def timed(self, label, fn, *args, **kwargs):
        """Run fn, print its wall time split into compile and run."""
        t0 = time.time()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        t1 = time.time()
        comp = self.clock.seconds_between(t0, t1)
        print(f"  {label}: wall {t1 - t0:.3f} s = compile {comp:.3f} s"
              f" + run {t1 - t0 - comp:.3f} s", flush=True)
        return out

    @staticmethod
    def check(failures, label, value, limit):
        ok = bool(np.isfinite(value)) and value <= limit
        print(f"  {label}: {value:.3e} (limit {limit:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(label)

    @staticmethod
    def require(failures, label, ok, detail=""):
        print(f"  {label}: {'ok' if ok else 'FAIL'} {detail}".rstrip(),
              flush=True)
        if not ok:
            failures.append(label)

    @staticmethod
    def peak_memory(device):
        stats = device.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        if peak is not None:
            print(f"  peak device memory: {peak / 2**30:.3f} GiB", flush=True)


def _phase(name):
    """Run a phase, print its time and verdict; a phase that misses a
    limit is recorded in ``sm.failed`` and the script exits non-zero after
    the remaining phases have run."""
    def deco(fn):
        def run(sm, *args, **kwargs):
            print(f"== phase {name}", flush=True)
            t0 = time.time()
            failures = []
            out = fn(sm, *args, failures=failures, **kwargs)
            print(f"== phase {name}: {time.time() - t0:.3f} s, "
                  f"{'FAILED ' + ', '.join(failures) if failures else 'ok'}",
                  flush=True)
            if failures:
                sm.failed.append(name)
            return out
        return run
    return deco


def _device_phase(n_cards: int):
    """Fail unless JAX's default backend is a GPU with ``n_cards`` cards;
    keep the CPU backend reachable for the reference runs."""
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (default backend is "
            f"{devices[0].platform!r}); this check runs only on the card")
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found "
                         f"{len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print("card:", smi.stdout.strip().splitlines()[0], flush=True)
    print("jax", jax.__version__, jax.devices(), flush=True)

    from gmpnp.utils.compile_cache import setup_compile_cache
    print("compile cache:", setup_compile_cache(), flush=True)
    return devices


def _pore_config(tight=False, **linear):
    """The generated L_50_R_5 GMPNP pore; ``tight`` solves the linear
    systems (and, with ``tight="newton"``, Newton too) to TIGHT_TOL."""
    from gmpnp.models import pore_3d
    from gmpnp.solve.timeloop import NewtonConfig

    cfg = pore_3d.Pore3DConfig(physics="GMPNP", L=50e-9, R=5e-9,
                               voltage_multiplier=-1.0)
    if tight:
        linear = {"tol": TIGHT_TOL, **linear}
    if tight == "newton":
        cfg = dataclasses.replace(cfg, newton=NewtonConfig(
            max_iter=50, rtol=TIGHT_TOL, atol=TIGHT_TOL, relaxation=0.9))
    if linear:
        cfg = dataclasses.replace(
            cfg, linear=dataclasses.replace(cfg.linear, **linear))
    return cfg


def _edl_config():
    from gmpnp.models import edl_1d

    return edl_1d.EDL1DConfig()


def _steps_summary(stats):
    newton = np.asarray(stats.newton_iters)
    lin = np.asarray(stats.linear_iters)
    conv = np.asarray(stats.converged)
    return newton, lin, conv


def _print_counts(label, stats):
    newton, lin, _ = _steps_summary(stats)
    print(f"  {label}: Newton/step {newton.tolist()} linear/step "
          f"{lin.tolist()}", flush=True)


@_phase("pore")
def phase_pore(sm: Smoke, failures):
    from gmpnp.models import pore_3d
    from gmpnp.solve.timeloop import make_implicit_step

    cfg = _pore_config()
    prog = sm.timed("build", pore_3d.build, cfg)
    print(f"  N={prog.space.num_vertices} vertices, {cfg.n_fields} fields "
          f"{cfg.species + ('p',)}, {prog.space.cells.shape[0]} tets",
          flush=True)

    # memory of one compiled implicit step
    step = make_implicit_step(prog.space, prog.form, cfg.newton, cfg.linear,
                              bc_of_theta=prog._bc_of_theta)
    u0 = np.ones((prog.space.num_vertices, cfg.n_fields))
    u0[:, len(cfg.species)] = 0.0
    theta = prog._theta_of_carry((u0, 0.0), 0)
    compiled = sm.timed("compile one step",
                        lambda: jax.jit(step).lower(u0, theta).compile())
    print(f"  step memory_analysis: {compiled.memory_analysis()}",
          flush=True)

    # the users' run, at the production tolerances
    _, _, st_p, u_p = sm.timed("gpu run, production tol (3 steps)",
                               prog.run, n_steps=POR_STEPS)
    # the same program solved to TIGHT_TOL, on the card and on the host
    _, _, st_g, u_g = sm.timed("gpu run, tight tol (3 steps)",
                               pore_3d.build(_pore_config(tight=True)).run,
                               n_steps=POR_STEPS)
    with jax.default_device(jax.devices("cpu")[0]):
        prog_c = pore_3d.build(_pore_config(tight=True))
        _, _, st_c, u_c = sm.timed("cpu run, tight tol (3 steps)",
                                   prog_c.run, n_steps=POR_STEPS)
    for label, st in (("gpu production", st_p), ("gpu tight", st_g),
                      ("cpu tight", st_c)):
        _print_counts(label, st)
        sm.require(failures, f"{label}: every step converged",
                   bool(np.asarray(st.converged).all()))
    sm.require(failures, "gpu vs cpu: identical Newton counts",
               np.array_equal(np.asarray(st_g.newton_iters),
                              np.asarray(st_c.newton_iters)))
    u_p, u_g, u_c = np.asarray(u_p), np.asarray(u_g), np.asarray(u_c)
    for j, name in enumerate(cfg.species + ("p",)):
        sm.check(failures, f"gpu vs cpu rel L2 [{name}]",
                 rel_l2(u_g[:, j], u_c[:, j]), POR_GPU_VS_CPU)
    sm.check(failures, "production vs tight tol rel L2",
             rel_l2(u_p, u_g), POR_PRODUCTION_VS_TIGHT)
    sm.peak_memory(jax.devices()[0])
    return prog


@_phase("pore-carried")
def phase_pore_carried(sm: Smoke, failures):
    from gmpnp.models import pore_3d

    runs = {}
    for label, cfg in (
            ("carried, production tol", _pore_config(refresh="carried")),
            ("carried, tight tol", _pore_config(tight="newton",
                                                refresh="carried")),
            ("exact, tight tol", _pore_config(tight="newton"))):
        _, _, st, u = sm.timed(f"{label} ({CARRIED_STEPS} steps)",
                               pore_3d.build(cfg).run, n_steps=CARRIED_STEPS)
        runs[label] = np.asarray(u)
        _print_counts(label, st)
        sm.require(failures, f"{label}: every step converged",
                   bool(np.asarray(st.converged).all()))
    exact = runs["exact, tight tol"]
    sm.check(failures, "carried vs exact rel L2 (tight tol)",
             rel_l2(runs["carried, tight tol"], exact), POR_CARRIED_VS_EXACT)
    sm.check(failures, "carried production vs exact tight rel L2",
             rel_l2(runs["carried, production tol"], exact),
             POR_PRODUCTION_VS_TIGHT)
    sm.peak_memory(jax.devices()[0])


@_phase("slab-vs-dense")
def phase_slab_vs_dense(sm: Smoke, prog, failures):
    import jax.numpy as jnp

    from gmpnp.solve.slab import SlabPlan, slab_direct_solve

    cfg = prog.config
    space = prog.space
    u0 = jnp.ones((space.num_vertices, cfg.n_fields))
    u0 = u0.at[:, len(cfg.species)].set(0.0)
    theta = prog._theta_of_carry((u0, jnp.asarray(0.0)), jnp.asarray(0))

    def system(u_prev, theta):
        bc = prog._bc_of_theta(theta)
        u = bc.project(u_prev)          # the first Newton iterate
        r = bc.apply_to_residual(
            space.residual(prog.form, u, u_prev, theta), u)
        J = bc.apply_to_jacobian(
            space.jacobian(prog.form, u, u_prev, theta))
        return J, r

    J, r = sm.timed("assemble", jax.jit(system), u0, theta)
    plan = SlabPlan.build(np.asarray(space.adj),
                          np.asarray(space.points)[:, -1], space.n_fields,
                          np.asarray(space.diag_slot))
    print(f"  slab plan: S={plan.S} slabs of m={plan.m} unknowns "
          f"(bandwidth {plan.bandwidth} vertices)", flush=True)
    n = r.size
    print(f"  dense system {n}x{n} f64 ({n * n * 8 / 2**30:.2f} GiB)",
          flush=True)
    x_d = sm.timed("dense f64 solve", jax.jit(
        lambda J, r: jnp.linalg.solve(J.to_dense(), r.reshape(-1))), J, r)
    res = sm.timed(f"slab_direct_solve to tol {TIGHT_TOL:.0e}", jax.jit(
        lambda J, r: slab_direct_solve(
            J, r, plan, tol=TIGHT_TOL, max_refine=cfg.linear.max_refine)),
        J, r)
    print(f"  slab GMRES iterations {int(res.iters)}, converged "
          f"{bool(res.converged)}", flush=True)
    sm.require(failures, "slab solve converged", bool(res.converged))
    sm.check(failures, "slab vs dense rel error",
             rel_l2(np.asarray(res.x).reshape(-1), x_d), SLAB_VS_DENSE)
    sm.peak_memory(jax.devices()[0])


@_phase("edl")
def phase_edl(sm: Smoke, failures):
    from gmpnp.models import edl_1d

    cfg = _edl_config()
    out_g = sm.timed("gpu run", edl_1d.run, cfg, write=False)
    with jax.default_device(jax.devices("cpu")[0]):
        out_c = sm.timed("cpu run", edl_1d.run, cfg, write=False)
    st = out_g["stats"]
    ng, lg, cg = _steps_summary(st)
    nc, _, cc = _steps_summary(out_c["stats"])
    fields = sorted(out_g["unscaled"])
    print(f"  N={out_g['unscaled']['H'].shape[1]} vertices, {len(ng)} steps;"
          f" Newton total gpu {int(ng.sum())} cpu {int(nc.sum())}",
          flush=True)
    sm.require(failures, "gpu steps converged", bool(cg.all()))
    sm.require(failures, "cpu steps converged", bool(cc.all()))
    fin_g = np.stack([out_g["unscaled"][k][-1] for k in fields], axis=1)
    fin_c = np.stack([out_c["unscaled"][k][-1] for k in fields], axis=1)
    sm.check(failures, "gpu vs cpu rel L2 (final state)",
             rel_l2(fin_g, fin_c), EDL_GPU_VS_CPU)
    sm.peak_memory(jax.devices()[0])


@_phase("four")
def phase_four(sm: Smoke, devices, failures):
    from gmpnp.models import pore_3d
    from gmpnp.parallel.sweep import run_pore_voltage_sweep

    cfg = _pore_config(tight=True)
    out_s = sm.timed("sharded run over 4 cards", pore_3d.run, cfg, shard=4,
                     write=False, write_vtk=False, n_steps=POR_STEPS)
    prog = pore_3d.build(cfg)
    _, _, st_1, u_1 = sm.timed("one-card run", prog.run, n_steps=POR_STEPS)
    print(f"  N={prog.space.num_vertices}", flush=True)
    for label, st in (("sharded", out_s["stats"]), ("one-card", st_1)):
        _print_counts(label, st)
        sm.require(failures, f"{label}: every step converged",
                   bool(np.asarray(st.converged).all()))
    names = ["H", "OH", "HCO3", "CO32", "CO2", "CO", "H2", "cat", "p"]
    u_s = np.stack([out_s["unscaled"][k][-1] for k in names], axis=1)
    sm.check(failures, "sharded vs one-card rel L2", rel_l2(u_s, u_1),
             SHARD_VS_SINGLE)

    volts = np.asarray(SWEEP_VOLTS)
    hist_d, st_d = sm.timed(
        "sweep, one lane per card", run_pore_voltage_sweep, cfg, volts,
        n_steps=SWEEP_STEPS, devices=devices[:4])
    hist_1, st_1 = sm.timed(
        "sweep, lanes in turn on one card", run_pore_voltage_sweep, cfg,
        volts, n_steps=SWEEP_STEPS, chunk=0)
    print(f"  sweep Newton/lane/step per-card "
          f"{np.asarray(st_d.newton_iters).tolist()}, one-card "
          f"{np.asarray(st_1.newton_iters).tolist()}", flush=True)
    sm.require(failures, "sweep lanes converged",
               bool(np.asarray(st_d.converged).all()
                    and np.asarray(st_1.converged).all()))
    hist_d, hist_1 = np.asarray(hist_d), np.asarray(hist_1)
    for i, v in enumerate(volts):
        sm.check(failures, f"sweep lane V={v} per-card vs one-card rel L2",
                 rel_l2(hist_d[i, -1], hist_1[i, -1]), SHARD_VS_SINGLE)
    sm.peak_memory(devices[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase (sharded pore and "
                         "lane-per-device sweep)")
    args = ap.parse_args(argv)

    n_cards = 4 if args.four else 1
    devices = _device_phase(n_cards)
    sm = Smoke()
    t0 = time.time()
    if args.four:
        phase_four(sm, devices)
    else:
        prog = phase_pore(sm)
        phase_pore_carried(sm)
        phase_slab_vs_dense(sm, prog)
        phase_edl(sm)
    print(f"total {time.time() - t0:.1f} s", flush=True)
    if sm.failed:
        print(f"chip_smoke: failed phases: {', '.join(sm.failed)}",
              file=sys.stderr, flush=True)
        return 1
    d = jax.devices()[0]
    print(result_line(d.platform, d.device_kind, len(jax.devices())),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
