"""CLI for the 3D GMPNP pore model.

Flags mirror 3D/MPNP_CO2ER_pore.py:1088-1235.
"""

import argparse

from gmpnp.models import pore_3d
from gmpnp.utils.compile_cache import setup_compile_cache


def add_common_pore_args(p):
    p.add_argument("--concentration_elec", type=float, default=1.0)
    p.add_argument("--H2_FE", type=float, default=0.05)
    p.add_argument("--current_rough", type=float, default=3000.0,
                   help="steady state current in A/m2 (300 mA/cm2)")
    p.add_argument("--L", type=float, default=100e-9, help="cylinder length")
    p.add_argument("--R", type=float, default=5e-9, help="cylinder radius")
    p.add_argument("--cation", type=str, default="K")
    p.add_argument("--porosity_eff", type=float, default=0.5)
    p.add_argument("--tortuosity_eff", type=float, default=1.5)
    p.add_argument("--constrictivity_eff", type=float, default=0.9)
    p.add_argument("--press_gas", type=float, default=1.0)
    p.add_argument("--pore_geom_multiplier", type=float, default=1.0)
    p.add_argument("--electrolyte_flow_geom_multiplier", type=float,
                   default=1.0)
    p.add_argument("--params_file", type=str, default="parameters_pore")
    p.add_argument("--y_CO2", type=float, default=0.95)
    p.add_argument("--roughness_factor", type=float, default=150.0)
    p.add_argument("--out_root", type=str, default=None)
    p.add_argument("--n_steps", type=int, default=None,
                   help="override number of time steps (debug)")
    p.add_argument("--mesh_resolution", type=int, nargs=2, default=None,
                   metavar=("RINGS", "LAYERS"),
                   help="generated-mesh resolution override (debug scale)")
    p.add_argument("--record_stride", type=int, default=None,
                   help="record every k-th step; default bounds the "
                        "history to ~1000 snapshots (pass 1 to record "
                        "every step like the reference)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="chunked checkpointing; resumes from the "
                        "latest step in this directory if present")
    p.add_argument("--checkpoint_every", type=int, default=100)
    p.add_argument("--dt_retries", type=int, default=None,
                   help="divergence recovery: retry a non-converged step "
                        "with dt halved up to K times (default: 3 for "
                        "full-length runs, 0 with --n_steps)")
    p.add_argument("--dt_first_scale", type=float, default=None,
                   help="staged first step(s): run the first "
                        "--dt_first_steps steps at dt * this factor "
                        "(deep-voltage cold starts: 1/32 unlocks V<=-2.0, "
                        "1/8 unlocks V=-2.5 on the shipped mesh — the 3D "
                        "form of the reference's 1D staged-dt schedule, "
                        "1D/MPNP_CO2ER_EDL.py:270-290; default 1.0 = "
                        "reference-parity unstaged)")
    p.add_argument("--dt_first_steps", type=int, default=None,
                   help="how many leading steps --dt_first_scale applies "
                        "to (default 1)")
    p.add_argument("--newton_backtracking", type=int, default=None,
                   help="backtracking halvings per Newton iteration "
                        "(default 0 = reference-parity damped Newton)")
    p.add_argument("--newton_bt_growth", type=float, default=None,
                   help="backtracking acceptance rule: 0 = strict Armijo "
                        "(default), g > 0 = accept while the residual grows "
                        "by < g (non-monotone; the production sweep rule, "
                        "solve.newton.newton_solve)")
    p.add_argument("--shard", type=int, default=None, metavar="K",
                   help="run z-slab-sharded over the first K jax devices "
                        "(shard_map domain decomposition + distributed "
                        "SPIKE solve — the multi-chip production path; "
                        "replaces the reference's mpirun/PETSc layer). "
                        "Identical outputs incl. checkpoint/resume "
                        "(--checkpoint_dir) and dt-cut recovery")
    p.add_argument("--linear_refresh", type=str, default=None,
                   choices=("iter", "step", "carried", "auto"),
                   help="slab-factorization refresh policy: 'iter' = exact "
                        "Newton, re-factor every iterate (reference-parity "
                        "default); 'step' = once per time step; 'carried' = "
                        "carry across steps with lazy refresh (chord Newton "
                        "— solve.timeloop.make_carried_step); "
                        "'auto' = time both on a warm window at startup and "
                        "pick the winner (solve.timeloop.calibrate_refresh)")


def build_parser():
    p = argparse.ArgumentParser(description="experiment parameters")
    p.add_argument("--voltage_multiplier", type=float, default=-1.0)
    p.add_argument("--corrected_fluxes", action="store_true",
                   help="include the wall/exit Neumann fluxes the published "
                        "script orphans (see models.pore_3d docstring)")
    add_common_pore_args(p)
    return p


def config_from_args(args, physics):
    kw = dict(
        physics=physics,
        concentration_elec=args.concentration_elec,
        H2_FE=args.H2_FE,
        current_rough=args.current_rough,
        L=args.L,
        R=args.R,
        cation=args.cation,
        press_gas=args.press_gas,
        pore_geom_multiplier=args.pore_geom_multiplier,
        porosity_eff=args.porosity_eff,
        tortuosity_eff=args.tortuosity_eff,
        constrictivity_eff=args.constrictivity_eff,
        params_file=(None if args.params_file == "parameters_pore"
                     else args.params_file),
        y_CO2=args.y_CO2,
        electrolyte_flow_geom_multiplier=args.electrolyte_flow_geom_multiplier,
        roughness_factor=args.roughness_factor,
    )
    if getattr(args, "mesh_resolution", None):
        kw["mesh_resolution"] = tuple(args.mesh_resolution)
    if getattr(args, "dt_retries", None) is not None:
        kw["dt_retries"] = args.dt_retries
    if getattr(args, "dt_first_scale", None) is not None:
        kw["dt_first_scale"] = args.dt_first_scale
    if getattr(args, "dt_first_steps", None) is not None:
        kw["dt_first_steps"] = args.dt_first_steps
    if physics == "GMPNP":
        kw["voltage_multiplier"] = args.voltage_multiplier
        kw["faithful"] = not args.corrected_fluxes
    cfg = pore_3d.Pore3DConfig(**kw)
    newton_kw = {}
    if getattr(args, "newton_backtracking", None) is not None:
        newton_kw["backtracking"] = args.newton_backtracking
    if getattr(args, "newton_bt_growth", None) is not None:
        newton_kw["bt_growth"] = args.newton_bt_growth
    if newton_kw:
        import dataclasses
        cfg = dataclasses.replace(cfg, newton=dataclasses.replace(
            cfg.newton, **newton_kw))
    if getattr(args, "linear_refresh", None):
        import dataclasses
        cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh=args.linear_refresh))
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_compile_cache()
    cfg = config_from_args(args, "GMPNP")
    res = pore_3d.run(cfg, out_root=args.out_root, n_steps=args.n_steps,
                      record_stride=args.record_stride,
                      checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      shard=args.shard)
    print(res["run_dir"])
    return res


if __name__ == "__main__":
    main()
