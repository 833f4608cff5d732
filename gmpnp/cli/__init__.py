"""Command-line entrypoints mirroring the reference scripts' argparse flags.

    python -m gmpnp.cli.edl_1d       ~  python 1D/MPNP_CO2ER_EDL.py
    python -m gmpnp.cli.rxn_diff_1d  ~  python 1D/rxn_diff_planar.py
    python -m gmpnp.cli.stern        ~  python 1D/Stern_CO2ER.py
    python -m gmpnp.cli.pore_3d      ~  python 3D/MPNP_CO2ER_pore.py
    python -m gmpnp.cli.rxn_diff_3d  ~  python 3D/rxn_diff_CO2ER_pore.py
    python -m gmpnp.cli.bulk_soln    ~  python utilities/bulk_soln.py
    python -m gmpnp.cli.mesh_tests   ~  python 3D/mesh_tests.py
    python -m gmpnp.cli.sweep        (framework extra: vmapped sweeps)

Flag names and defaults track the reference CLIs (cited per module); the
hardcoded machine-specific basepaths are replaced by ``--out_root`` /
``GMPNP_OUT`` and ``GMPNP_UTILITIES``.
"""
