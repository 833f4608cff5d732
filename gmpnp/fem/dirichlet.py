"""Dirichlet boundary conditions via row masking.

Replaces dolfin::DirichletBC application (row replacement in the Newton
system).  The constrained residual entry becomes ``u - value`` and the
Jacobian row becomes the identity row, which reproduces DOLFIN's
NonlinearVariationalSolver behavior exactly: the Newton update drives the
constrained dof to its value in one step and keeps it there.

Masks are static (sparsity-defining); values may be traced scalars so that
per-step BC updates (the Sechenov CO2 Dirichlet value,
3D/MPNP_CO2ER_pore.py:835-838) never trigger recompilation.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gmpnp.fem.assembly import BlockELL


class DirichletBC(NamedTuple):
    mask: jnp.ndarray    # (N, fields) bool — constrained dofs
    values: jnp.ndarray  # (N, fields) — target values (entries off-mask ignored)

    @staticmethod
    def from_vertex_sets(
        num_vertices: int,
        n_fields: int,
        entries: Sequence[Tuple[np.ndarray, int, float]],
    ) -> "DirichletBC":
        """Build from (vertex_ids, field, value) triples."""
        mask = np.zeros((num_vertices, n_fields), dtype=bool)
        vals = np.zeros((num_vertices, n_fields))
        for verts, fld, val in entries:
            mask[verts, fld] = True
            vals[verts, fld] = val
        # host numpy: embedded as constants at trace time (no device round
        # trips during lowering); traced updates go through set_value
        return DirichletBC(mask, vals)

    def with_values(self, values: jnp.ndarray) -> "DirichletBC":
        """Replace the value array (e.g. traced per-step updates)."""
        return DirichletBC(self.mask, values)

    def set_value(self, verts, fld: int, value) -> "DirichletBC":
        """Functionally update the value on a vertex set (traced-safe)."""
        vals = jnp.asarray(self.values)
        return DirichletBC(self.mask, vals.at[verts, fld].set(value))

    def set_value_masked(self, verts, fld: int, value) -> "DirichletBC":
        """Scatter-free ``set_value``: the vertex set is baked into a host
        one-hot mask and the traced scalar enters by elementwise blend.
        Equivalent to set_value, without a scatter under ``jax.vmap``
        over ``value``; ``verts`` must be concrete."""
        onehot = np.zeros(np.shape(self.mask), dtype=bool)
        onehot[np.asarray(verts), fld] = True
        vals = jnp.where(jnp.asarray(onehot), value,
                         jnp.asarray(self.values))
        return DirichletBC(self.mask, vals)

    def arith(self) -> "ArithDirichletBC":
        """Arithmetic-blend view of this BC (see ArithDirichletBC)."""
        return ArithDirichletBC(
            self.mask, np.asarray(self.mask, np.float64),
            jnp.asarray(self.values))

    def apply_to_residual(self, r: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        return jnp.where(self.mask, u - self.values, r)

    def apply_to_jacobian(self, J: BlockELL) -> BlockELL:
        """Zero constrained rows and place 1 on their diagonal entries."""
        N, f, Kf = J.flat.shape
        row_mask = self.mask[:, :, None]                # (N, f, 1)
        flat = jnp.where(row_mask, 0.0, J.flat)
        # constrained (n, r): set flat[n, r, diag_slot[n]*f + r] = 1
        rows = jnp.arange(N)[:, None]
        rr = jnp.broadcast_to(jnp.arange(f)[None, :], (N, f))
        cols = J.diag_slot[:, None] * f + rr
        vals = jnp.where(self.mask, 1.0,
                         flat[rows, rr, cols])
        flat = flat.at[rows, rr, cols].set(vals)
        return BlockELL(adj=J.adj, flat=flat, diag_slot=J.diag_slot)

    def project(self, u: jnp.ndarray) -> jnp.ndarray:
        """Force constrained dofs to their values."""
        return jnp.where(self.mask, self.values, u)


class ArithDirichletBC(NamedTuple):
    """Dirichlet BC applied by pure arithmetic blends — no ``select``.

    Same semantics as :class:`DirichletBC` (mask is 0/1 so the blends are
    exact), but the traced/batched BC value never flows through a
    ``jnp.where`` or a scatter.  It exists because per-lane Dirichlet
    values in vmapped sweeps once faulted an earlier backend when they
    reached a fused select/scatter composition; whether a GPU needs it is
    open (ROADMAP Design 6).  Multiply-add lowers to plain elementwise
    kernels.

    ``mask`` (bool) is kept for the Jacobian row rewrite, which only
    depends on static sparsity, never on the (possibly batched) values.
    """

    mask: jnp.ndarray    # (N, fields) bool, static
    maskf: jnp.ndarray   # (N, fields) f64 0/1, static host constant
    values: jnp.ndarray  # (N, fields), possibly traced / vmap-batched

    def set_value_arith(self, verts, fld: int, value) -> "ArithDirichletBC":
        """Blend a (possibly traced, possibly vmapped) scalar onto a static
        vertex set via multiply-add on a host one-hot — scatter/select-free
        and safe under ``jax.vmap`` over ``value``.

        The blended values are wrapped in ``lax.optimization_barrier``,
        which keeps XLA from fusing the value-blend into downstream
        consumers (that fusion once faulted an earlier backend; ROADMAP
        Design 6).  The barrier only forces the (N, f) blend to
        materialize; it is semantically the identity.
        """
        onehot = np.zeros(np.shape(self.mask), dtype=np.float64)
        onehot[np.asarray(verts), fld] = 1.0
        vals = self.values * (1.0 - onehot) + value * onehot
        vals = jax.lax.optimization_barrier(vals)
        return ArithDirichletBC(self.mask, self.maskf, vals)

    def apply_to_residual(self, r: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        return r + self.maskf * ((u - self.values) - r)

    def apply_to_jacobian(self, J: BlockELL) -> BlockELL:
        return DirichletBC(self.mask, self.values).apply_to_jacobian(J)

    def project(self, u: jnp.ndarray) -> jnp.ndarray:
        return u + self.maskf * (self.values - u)
