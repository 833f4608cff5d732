"""CLI for the bulk-electrolyte equilibration pre-processor.

Re-provides utilities/bulk_soln.py (which had its inputs hardcoded at
module level, :72-76) as a proper CLI; writes the reference-format
``bulk_soln_<conc><electrolyte>.yaml``.
"""

import argparse
import os

from gmpnp.chem.bulk import equilibrate_electrolyte, write_bulk_yaml
from gmpnp.utils.compile_cache import setup_compile_cache


def build_parser():
    p = argparse.ArgumentParser(description="bulk electrolyte equilibration")
    p.add_argument("--conc", type=float, default=0.1,
                   help="electrolyte concentration in M")
    p.add_argument("--electrolyte", type=str, default="KHCO3",
                   help="KHCO3/KOH/K2CO3/KCl")
    p.add_argument("--temp", type=float, default=298.15)
    p.add_argument("--f_CO2", type=float, default=1.0,
                   help="CO2 pressure in bar")
    p.add_argument("--stage1_protocol", type=str, default="equilibrium",
                   help="equilibrium/reference_script")
    p.add_argument("--out_dir", type=str, default=".")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_compile_cache()
    sol = equilibrate_electrolyte(
        conc=args.conc, electrolyte=args.electrolyte, temp=args.temp,
        f_CO2=args.f_CO2, stage1_protocol=args.stage1_protocol)
    path = os.path.join(
        args.out_dir, f"bulk_soln_{args.conc}{args.electrolyte}.yaml")
    write_bulk_yaml(sol, path)
    print(path)
    print("pre-CO2 pH", sol.pre_pH, " post-CO2 pH", sol.post_pH)
    return sol


if __name__ == "__main__":
    main()
