"""Parallelism: vmapped parameter sweeps + shard_map domain decomposition.

The reference's two parallelism modes (SURVEY.md §2c) map as:
- parameter-sweep parallelism (independent cluster jobs over CLI flags,
  README.md:37-39)  ->  ``sweep``: vmapped batched solves
- latent MPI domain decomposition (FEniCS/PETSc/METIS under mpirun)
  ->  ``shard``: z-slab partition of the pore over a jax.sharding.Mesh with
      ppermute halo exchange and psum reductions over ICI
"""

from gmpnp.parallel.sweep import (
    run_edl_voltage_sweep,
    run_lanes_on_devices,
    run_pore_voltage_sweep,
)
from gmpnp.parallel.shard import (
    SlabPrecondPlan,
    ZShardPlan,
    make_sharded_pore_transient,
    make_sharded_step,
    make_sharded_transient,
)

__all__ = [
    "run_edl_voltage_sweep",
    "run_lanes_on_devices",
    "run_pore_voltage_sweep",
    "SlabPrecondPlan",
    "ZShardPlan",
    "make_sharded_pore_transient",
    "make_sharded_step",
    "make_sharded_transient",
]
