"""CLI for the 1D PNP/GMPNP EDL model.

Flags mirror 1D/MPNP_CO2ER_EDL.py:992-1103 (including the reference's
``--dry_run`` smoke mode, :1094-1101).
"""

import argparse

from gmpnp.models import edl_1d
from gmpnp.utils.compile_cache import setup_compile_cache


def _bool(v):
    """Y/N flag parser matching the reference CLI convention
    (1D/MPNP_CO2ER_EDL.py --dry_run Y/N).  Round-3 regression: 'N' was
    not in the falsey set, so ``--dry_run N`` silently stayed a dry run
    (and dry runs default to zero divergence retries)."""
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y", "t"):
        return True
    if s in ("false", "0", "no", "n", "f", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected Y/N boolean, got {v!r}")


def build_parser():
    p = argparse.ArgumentParser(description="experiment parameters")
    p.add_argument("--concentration_elec", type=float, default=0.1)
    p.add_argument("--model", type=str, default="MPNP", help="PNP/MPNP")
    p.add_argument("--voltage_multiplier", type=float, default=-1.0,
                   help="thermal-voltage multiplier at the OHP")
    p.add_argument("--mesh_structure", type=str, default="variable")
    p.add_argument("--H2_FE", type=float, default=0.2)
    p.add_argument("--current_OHP_ss", type=float, default=10.0)
    p.add_argument("--L_n", type=float, default=50.0e-6)
    p.add_argument("--stabilization", type=str, default="N", help="SUPG Y/N")
    p.add_argument("--H_OHP", type=float, default=None,
                   help="proton buildup target at the OHP (None/1.1/2.0)")
    p.add_argument("--cation", type=str, default="K", help="K/Cs/Li/Na")
    p.add_argument("--params_file", type=str, default="parameters")
    p.add_argument("--dry_run", type=_bool, default=True,
                   help="100-step smoke run")
    p.add_argument("--out_root", type=str, default=None)
    p.add_argument("--n_steps", type=int, default=None,
                   help="override number of time steps (debug)")
    p.add_argument("--record_stride", type=int, default=None,
                   help="record every k-th step; default bounds the "
                        "history to ~1000 snapshots (pass 1 to record "
                        "every step like the reference)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="chunked checkpointing; resumes from the "
                        "latest step in this directory if present")
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--dt_retries", type=int, default=None,
                   help="divergence recovery: retry a non-converged step "
                        "with dt halved up to K times (default: 3 for "
                        "full-length runs, 0 for --dry_run)")
    p.add_argument("--newton_backtracking", type=int, default=None,
                   help="backtracking halvings per Newton iteration "
                        "(default: auto — 4 for full-length runs, 0 = "
                        "reference-parity damped Newton for --dry_run; "
                        "plain Newton cannot start the V=-12.5 config)")
    p.add_argument("--newton_bt_growth", type=float, default=None,
                   help="backtracking acceptance rule: 0 = strict Armijo "
                        "(default), g > 0 = accept while the residual grows "
                        "by < g (non-monotone; the production sweep rule, "
                        "solve.newton.newton_solve)")
    p.add_argument("--linear_refresh", type=str, default=None,
                   choices=("iter", "step", "carried"),
                   help="factorization refresh policy: 'iter' = exact "
                        "Newton (reference-parity default); 'carried' = "
                        "carry the CR factorization across steps with lazy "
                        "refresh (chord Newton, the fast production mode; "
                        "solve.timeloop.make_carried_step)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_compile_cache()
    cfg = edl_1d.EDL1DConfig(
        concentration_elec=args.concentration_elec,
        model=args.model,
        voltage_multiplier=args.voltage_multiplier,
        H2_FE=args.H2_FE,
        mesh_structure=args.mesh_structure,
        current_OHP_ss=args.current_OHP_ss,
        L_n=args.L_n,
        stabilization=args.stabilization,
        H_OHP=args.H_OHP,
        cation=args.cation,
        params_file=(None if args.params_file == "parameters"
                     else args.params_file),
        dry_run=args.dry_run,
        dt_retries=args.dt_retries,
    )
    if args.newton_backtracking is not None:
        import dataclasses
        cfg = dataclasses.replace(
            cfg, backtracking=args.newton_backtracking)
    if args.newton_bt_growth is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, newton=dataclasses.replace(
            cfg.newton, bt_growth=args.newton_bt_growth))
    if args.linear_refresh:
        import dataclasses
        cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh=args.linear_refresh))
    res = edl_1d.run(cfg, out_root=args.out_root, n_steps=args.n_steps,
                     record_stride=args.record_stride,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every)
    print(res["run_dir"])
    return res


if __name__ == "__main__":
    main()
