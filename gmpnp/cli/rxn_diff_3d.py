"""CLI for the 3D reaction-diffusion pore model.

Flags mirror 3D/rxn_diff_CO2ER_pore.py:787-942 (no voltage multiplier).
"""

import argparse

from gmpnp.cli.pore_3d import add_common_pore_args, config_from_args
from gmpnp.models import pore_3d
from gmpnp.utils.compile_cache import setup_compile_cache


def build_parser():
    p = argparse.ArgumentParser(description="experiment parameters")
    add_common_pore_args(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_compile_cache()
    cfg = config_from_args(args, "rxn_diff")
    res = pore_3d.run(cfg, out_root=args.out_root, n_steps=args.n_steps,
                      record_stride=args.record_stride,
                      checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      shard=args.shard)
    print(res["run_dir"])
    return res


if __name__ == "__main__":
    main()
