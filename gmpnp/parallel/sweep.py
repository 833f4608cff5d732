"""Vmapped parameter sweeps.

The reference's production parallelism is many independent cluster jobs over
CLI flags (README.md:37-39).  Here a sweep is one batched solve: the swept
scalar (voltage multiplier, applied current, ...) enters the step only
through traced ``theta`` values / Dirichlet values, so ``jax.vmap`` turns
the whole transient into a single XLA program with a leading batch axis (and
with a device mesh, sweeps can additionally be spread over devices).

Cation sweeps change compile-time constants (diffusivities, ion sizes), so
they run as an outer Python loop over at most four cached compilations, each
vmapped over the voltage axis.

Sweeps CHUNK the lane axis (``chunk`` parameter, auto by default): vmap
batches lanes while a single lane is small; large meshes run HOST-chunked,
one compiled single-lane program executed per lane (see _auto_chunk).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from gmpnp.models import edl_1d, pore_3d
from gmpnp.solve.timeloop import make_implicit_step


def _auto_chunk(lanes: int, num_vertices: int) -> int:
    """Lanes per batched chunk (0 = host-chunked, see _run_lanes).

    Batching lanes wins only while one lane leaves the device
    underused; batched lanes also run in Newton lockstep (the slowest
    lane sets every lane's trip count).  So meshes of 2,000 vertices or
    more run HOST-chunked: one compiled single-lane program (the voltage
    is a traced argument), executed once per lane; smaller meshes vmap
    every lane.  The 2,000-vertex threshold is inherited and not yet
    measured on a GPU (ROADMAP Speed 7).
    """
    return lanes if num_vertices < 2000 else 0


def _run_lanes(single, volts, chunk: int):
    """Run ``single(voltage) -> ys`` over all sweep lanes.

    chunk >= lanes: one vmapped program.  1 <= chunk < lanes: lax.map
    over vmap-``chunk`` batches in one program (lanes padded to a chunk
    multiple with the last voltage, pad dropped).  chunk == 0: HOST
    chunking — jit ``single`` once (the voltage is a traced argument, so
    all lanes share the compile) and execute per lane, stacking on host
    (see _auto_chunk).
    """
    lanes = volts.shape[0]
    if chunk == 0:
        fn = jax.jit(single)
        outs = [fn(v) for v in volts]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
    if chunk >= lanes:
        return jax.jit(jax.vmap(single))(volts)
    if chunk == 1:
        return jax.jit(lambda v: jax.lax.map(single, v))(volts)
    pad = (-lanes) % chunk
    volts_p = jnp.concatenate([volts, jnp.broadcast_to(volts[-1:], (pad,))])

    def mapped(vc):
        ys = jax.lax.map(lambda v: jax.vmap(single)(v), vc)
        return jax.tree.map(
            lambda a: a.reshape((-1,) + tuple(a.shape[2:])), ys)

    ys = jax.jit(mapped)(volts_p.reshape(-1, chunk))
    return jax.tree.map(lambda a: a[:lanes], ys)


def run_lanes_on_devices(single, volts, devices=None, lane_axis="lanes"):
    """Lane-per-device sweep: the reference's ACTUAL production mode — N
    independent cluster jobs over CLI flags (README.md:37-39) — mapped
    onto a device mesh.  Each device runs its share of lanes inside one
    ``shard_map`` over a 1-D lane mesh; there are no collectives, so the
    lanes are exactly as independent as the reference's jobs (ICI stays
    idle) and per-device Newton trip counts are NOT in lockstep.

    Local lanes run via ``lax.map`` (a scan, not a vmap), so the full
    single-lane program — including the carried mode's lax.cond refresh
    branches, which vmap would force both sides of every step (see
    run_pore_voltage_sweep) — executes unchanged per lane.

    ``single(voltage) -> ys`` is the same single-lane closure the
    host-chunked path uses; lanes must be a multiple of the device count.
    Validated lanes == host-sequential on the virtual CPU mesh
    (tests/test_parallel.py) and by __graft_entry__.dryrun_multichip.
    """
    from jax.sharding import Mesh, PartitionSpec

    devices = jax.devices() if devices is None else list(devices)
    n_dev = len(devices)
    lanes = volts.shape[0]
    if lanes % n_dev:
        raise ValueError(
            f"{lanes} lanes must be a multiple of {n_dev} devices "
            f"(pad the sweep or pass fewer devices)")
    mesh = Mesh(np.asarray(devices), (lane_axis,))
    spec = PartitionSpec(lane_axis)

    def local(v_local):
        return jax.lax.map(single, v_local)

    fn = jax.shard_map(local, mesh=mesh, in_specs=spec, out_specs=spec,
                       check_vma=False)
    return jax.jit(fn)(volts)


def _sweep_newton(newton):
    """Sweep variant of the Newton config: a vmapped ``lax.cond`` executes
    its body for every lane at every trip (it lowers to a select), so the
    'fori' loop style pays max_iter full Newton iterations per step in a
    batched sweep.  'while' keeps the batched trip count at the max over
    lanes of the actual iteration counts.

    NOTE: the sweep entry points FORCE loop='while' regardless of the
    caller's NewtonConfig.loop — the fori+cond form is never the right
    program under vmap.

    Sweeps also default backtracking ON (4 halvings, non-monotone
    bounded-growth acceptance, bt_growth=10) when the caller left
    ``backtracking=0``: a sweep spans the published voltage range from
    one cold start, and at reference mesh sizes plain damped Newton
    converges only the shallow lanes (at the shipped N=3,679 3D mesh,
    V=-1.5 oscillates through the whole iteration budget and deeper
    lanes go non-finite; the 1D V=-12.5 lane diverges at every dt).  The growth rule accepts exactly the plain
    damped-Newton step on every iteration whose residual grows by < 10x
    — steps with no rejection keep the plain iterate sequence bit-for-
    bit — and engages the halvings only on genuine blow-ups (strict
    Armijo instead stalls ~8x on healthy steps whose full Newton step is
    a mild transient overshoot; measured EDL dry-run overshoots reach
    ~5x, while a V=-12.5 blow-up multiplies the residual by orders of
    magnitude within one iteration).  Pass a nonzero backtracking to
    control the rule explicitly."""
    if newton.backtracking == 0:
        newton = dataclasses.replace(newton, backtracking=4, bt_growth=10.0)
    return dataclasses.replace(newton, loop="while")


def run_edl_voltage_sweep(
    cfg: "edl_1d.EDL1DConfig",
    voltages: Sequence[float],
    n_steps: Optional[int] = None,
    chunk: Optional[int] = None,
    devices: Optional[Sequence] = None,
):
    """Batched 1D EDL solve over OHP voltage multipliers.

    chunk: lanes vmapped per batch (None = auto, see _auto_chunk;
    remaining chunks run sequentially via lax.map in the same program).
    devices: run lane-per-device over a device mesh instead
    (run_lanes_on_devices).
    Returns (u_hist (V, steps, N, 7), stats batched over V).
    """
    prog = edl_1d.build(cfg)
    n = prog.tot_num_steps if n_steps is None else n_steps
    P = edl_1d.P

    left = np.unique(
        prog.mesh.facets[prog.mesh.facet_markers == 1].reshape(-1))

    # per-lane Dirichlet values enter via the pure-arithmetic BC
    # (fem.dirichlet.ArithDirichletBC)
    step = make_implicit_step(
        prog.space, prog.form, _sweep_newton(cfg.newton), cfg.linear,
        bc_of_theta=lambda theta: prog.bc.arith().set_value_arith(
            left, P, theta["voltage"]))

    def single(voltage):
        u0 = jnp.concatenate(
            [jnp.ones((prog.space.num_vertices, 6)),
             jnp.zeros((prog.space.num_vertices, 1))], axis=1)
        chf0 = jnp.asarray(0.001 if cfg.H_OHP is not None else 0.0)

        def body(carry, i):
            u, chf = carry
            theta = prog._theta_of_carry((u, chf), i)
            theta["voltage"] = voltage
            u_new, stats = step(u, theta)
            chf = prog._update_carry(chf, u_new, i)
            return (u_new, chf), (u_new, stats)

        (_, chf), ys = jax.lax.scan(body, (u0, chf0), jnp.arange(n))
        return ys

    volts = jnp.asarray(voltages, jnp.float64)
    if devices is not None and len(devices) > 1:
        return run_lanes_on_devices(single, volts, devices)
    if chunk is None:
        chunk = _auto_chunk(len(voltages), prog.space.num_vertices)
    return _run_lanes(single, volts, chunk)


def run_pore_voltage_sweep(
    cfg: "pore_3d.Pore3DConfig",
    voltages: Sequence[float],
    n_steps: Optional[int] = None,
    chunk: Optional[int] = None,
    devices: Optional[Sequence] = None,
):
    """Batched 3D GMPNP pore solve over wall voltage multipliers — the
    BASELINE config-5 sweep (voltage x cation; cation varies via an outer
    loop, see module docstring).

    The wall potential enters only through a Dirichlet value, so each sweep
    member shares one compiled program.

    devices: run lane-per-device over these jax devices instead of
    chunking on one device (run_lanes_on_devices — the multi-GPU mode;
    lanes must divide evenly).
    """
    assert cfg.physics == "GMPNP"
    prog = pore_3d.build(cfg)
    n = prog.num_steps if n_steps is None else n_steps
    ns = len(cfg.species)
    nf = cfg.n_fields

    s2 = np.unique(
        prog.mesh.facets[prog.mesh.facet_markers == pore_3d.S2].reshape(-1))

    def bc_of_theta(theta):
        # pure-arithmetic per-lane BC values (see run_edl_voltage_sweep)
        bc = prog.bc.arith()
        bc = bc.set_value_arith(prog.s1_verts, prog.idx["CO2"],
                                theta["co2_s1"])
        return bc.set_value_arith(s2, ns, theta["voltage"])

    if chunk is None:
        chunk = _auto_chunk(len(voltages), prog.space.num_vertices)

    lane_per_device = devices is not None and len(devices) > 1
    lin = cfg.linear
    carried = lin.kind == "slab_direct" and lin.refresh == "carried"
    if carried and chunk != 0 and not lane_per_device:
        # vmapped lanes execute BOTH branches of the carried mode's
        # lax.cond refreshes every step (cond lowers to select under
        # vmap) — downgrade to the stateless once-per-step policy, which
        # keeps most of the win and stays vmap-benign.  Lane-per-device
        # lanes run under lax.map (a scan), where cond stays cond, so
        # they keep the full carried machinery.
        lin = dataclasses.replace(lin, refresh="step")
        carried = False

    if carried:
        from gmpnp.solve.timeloop import make_carried_step

        step_c, prep_init = make_carried_step(
            prog.space, prog.form, _sweep_newton(cfg.newton), lin,
            bc_of_theta=bc_of_theta)

        def single(voltage):
            u0 = jnp.ones((prog.space.num_vertices, nf)).at[:, ns].set(0.0)
            th0 = prog._theta_of_carry((u0, jnp.asarray(0.0)),
                                       jnp.asarray(0))
            th0["voltage"] = voltage
            prep0 = prep_init(u0, th0)

            def body(carry, i):
                u, extra, prep = carry
                theta = prog._theta_of_carry((u, extra), i)
                theta["voltage"] = voltage
                u_new, stats, prep = step_c(u, theta, prep)
                return (u_new, extra, prep), (u_new, stats)

            _, ys = jax.lax.scan(body, (u0, jnp.asarray(0.0), prep0),
                                 jnp.arange(n))
            return ys
    else:
        step = make_implicit_step(
            prog.space, prog.form, _sweep_newton(cfg.newton), lin,
            bc_of_theta=bc_of_theta)

        def single(voltage):
            u0 = jnp.ones((prog.space.num_vertices, nf)).at[:, ns].set(0.0)

            def body(carry, i):
                u, extra = carry
                theta = prog._theta_of_carry((u, extra), i)
                theta["voltage"] = voltage
                u_new, stats = step(u, theta)
                return (u_new, extra), (u_new, stats)

            _, ys = jax.lax.scan(body, (u0, jnp.asarray(0.0)),
                                 jnp.arange(n))
            return ys

    volts = jnp.asarray(voltages, jnp.float64)
    if lane_per_device:
        return run_lanes_on_devices(single, volts, devices)
    return _run_lanes(single, volts, chunk)


def run_pore_voltage_cation_sweep(
    cfg: "pore_3d.Pore3DConfig",
    voltages: Sequence[float],
    cations: Sequence[str] = ("K",),
    n_steps: Optional[int] = None,
    chunk: Optional[int] = None,
) -> Dict[str, tuple]:
    """voltage x cation sweep: vmapped voltages inside a cached-compile
    cation loop (cation changes baked constants)."""
    out = {}
    for cat in cations:
        c = dataclasses.replace(cfg, cation=cat)
        out[cat] = run_pore_voltage_sweep(c, voltages, n_steps=n_steps,
                                          chunk=chunk)
    return out
