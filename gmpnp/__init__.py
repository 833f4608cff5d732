"""gmpnp — a JAX framework for generalized modified Poisson–Nernst–Planck
(GMPNP) electrochemistry simulations, run on NVIDIA GPUs.

This package re-provides, from scratch in JAX/XLA, the full capability set of
the reference GMPNP application (divyabohra/GMPNP): coupled multi-species ion
transport + electrostatics + finite-ion-size (steric) effects + bicarbonate
buffer chemistry for CO2 electroreduction, in 1D planar (EDL) and 3D
cylindrical-pore geometries — plus the finite-element machinery the reference
inherited from FEniCS/PETSc/MUMPS (meshing, assembly, Newton, sparse linear
algebra, distribution), rebuilt as jit-compiled JAX with ``jax.sharding``-based
parallelism.

Layout
------
- ``constants``  : physical constants / species database (ref: utilities/parameters*.yaml)
- ``chem``       : homogeneous buffer kinetics, Henry/Sechenov gas solubility,
                   0D bulk-electrolyte equilibration (ref: utilities/bulk_soln.py)
- ``mesh``       : mesh data structures, DOLFIN-XML readers, graded-interval and
                   cylinder tet generators, boundary marking
- ``fem``        : P1 finite elements, weak-form kernels, assembly, Dirichlet BCs
- ``solve``      : Newton, block-tridiagonal direct solves, the z-slab direct
                   solver, GMRES/BiCGStab + preconditioners
- ``models``     : the five reference models as first-class configs
- ``parallel``   : vmapped parameter sweeps, shard_map domain decomposition
- ``io``         : npz/metadata/VTK writers, checkpointing
"""

__version__ = "0.1.0"

import jax as _jax

# Accuracy parity with the reference (FEniCS/PETSc runs in double precision)
# demands f64.  This must happen before any arrays are created.
_jax.config.update("jax_enable_x64", True)

# NOTE on matmul precision: f64 dots are full f64 on every backend, but a
# float32 dot at default precision may run in TF32 on a GPU.  The f32 code
# paths (the slab factorization, the chord solve, the sharded SPIKE solve,
# f32 GMRES, f32 element Jacobians) request full precision at their call
# sites instead of through a global override.
