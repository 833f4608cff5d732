"""CLI for the Stern-layer post-solve.

Flags mirror 1D/Stern_CO2ER.py:185-203.  The reference ignores the CLI
voltage/field/eps values in favor of its hardcoded OHP_dict sweep
(:179-180); ``--sweep`` (default, matching that behavior) runs the table,
``--no-sweep`` solves the single supplied case.
"""

import argparse

from gmpnp.models import stern
from gmpnp.utils.compile_cache import setup_compile_cache


def build_parser():
    p = argparse.ArgumentParser(description="experiment parameters")
    p.add_argument("--voltage_scaled_OHP", type=float, default=-2.5)
    p.add_argument("--model", type=str, default="BDM",
                   help="BDM/Stern_linear")
    p.add_argument("--field_OHP", type=float, default=-0.5,
                   help="electric field at the OHP in V/nm")
    p.add_argument("--eps_rel_OHP", type=float, default=80.0)
    p.add_argument("--arg_order", type=str, default="reference",
                   help="reference/corrected (BDM permittivity order)")
    p.add_argument("--sweep", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run the hardcoded OHP-results voltage sweep")
    p.add_argument("--plots", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="write V_x.png/field_x.png (ref writes them always)")
    p.add_argument("--out_root", type=str, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_compile_cache()
    if args.sweep:
        out = stern.run(model=args.model, out_root=args.out_root,
                        arg_order=args.arg_order, make_plots=args.plots)
    else:
        table = {args.voltage_scaled_OHP: {
            "E": args.field_OHP, "eps": args.eps_rel_OHP}}
        out = stern.run(model=args.model, ohp_results=table,
                        out_root=args.out_root, arg_order=args.arg_order,
                        make_plots=args.plots)
    for v, res in out.items():
        print(v, res.get("run_dir", ""), "V_electrode =",
              res["voltage_electrode"])
    return out


if __name__ == "__main__":
    main()
