"""Aggregation-based algebraic multigrid preconditioner (the Hypre slot).

Fills SURVEY.md §2b's optional AMG-class preconditioner slot (reference:
Hypre available to PETSc via environment.yml:41, never explicitly
selected by the scripts) with a batched design in the style of Notay's
AGMG (plain aggregation + Galerkin coarse operators + Krylov
acceleration) rather than a translation of Hypre's C machinery:

- ALL sparsity structure is computed ONCE per mesh on the host
  (:class:`AMGPlan`): greedy vertex aggregation per level, the coarse
  block-ELL adjacency it induces, and a flat scatter table mapping every
  fine block (row, slot) to its coarse destination.  Structure depends
  only on the mesh graph, never on matrix values, so it is shared by
  every Newton iteration and every time step.
- Per-matrix VALUES are pure batched device ops (:func:`amg_prepare`):
  the Galerkin product RAP with piecewise-constant (unsmoothed)
  aggregation collapses to ONE ``segment_sum`` of the fine blocks per
  level — O(N*K) work, cheap enough to rebuild at every Newton iterate.
  No sparse-matrix-times-sparse-matrix machinery is needed, which is the
  point of choosing plain aggregation on this hardware: smoothed
  aggregation's triple product is gather/scatter-bound, while this
  formulation is a single sorted reduction like the assembly kernel.
- The cycle (:func:`amg_vcycle`) uses damped block-Jacobi smoothing
  (batched (f, f) solves — the block analogue of Hypre's
  default hybrid smoothers, chosen over Gauss-Seidel for its
  order-independence under XLA), piecewise-constant restriction
  (``segment_sum``) / prolongation (gather), and a dense factorized
  coarsest solve.

The coarsest-level dense solve is an LU factorization in the solve
dtype.

Used as ``LinearConfig(kind='gmres'|'bicgstab', precond='amg')``.
Production 3D solves default to the slab-direct factorization
(solve.slab) which replaced long Krylov loops outright; AMG is the
matrix-free-friendly alternative for meshes beyond the slab solver's
banded assumptions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gmpnp.fem.assembly import BlockELL
from gmpnp.solve.smallblock import block_inv


def aggregate_vertices(adj: np.ndarray) -> Tuple[np.ndarray, int]:
    """Greedy root aggregation of a padded adjacency graph.

    Pass 1 sweeps vertices in order; a vertex whose whole neighborhood is
    unaggregated becomes the root of a new aggregate containing that
    neighborhood.  Pass 2 attaches each leftover vertex to the aggregate
    most represented among its neighbors.  Returns ((N,) int32 aggregate
    ids, n_aggregates).  Aggregates are vertex-connected by construction,
    diameter <= 4 — the standard plain-aggregation coarsening (coarsening
    ratio ~ 2**dim .. 3**dim on P1 meshes).
    """
    N, _ = adj.shape
    agg = np.full(N, -1, dtype=np.int32)
    nagg = 0
    for v in range(N):
        if agg[v] != -1:
            continue
        nbrs = np.unique(adj[v])
        if (agg[nbrs] == -1).all():
            agg[nbrs] = nagg
            nagg += 1
    for v in range(N):
        if agg[v] != -1:
            continue
        cand = agg[np.unique(adj[v])]
        cand = cand[cand >= 0]
        if len(cand):
            agg[v] = np.bincount(cand).argmax()
        else:                                   # isolated vertex
            agg[v] = nagg
            nagg += 1
    return agg, nagg


def _coarse_graph(adj: np.ndarray, agg: np.ndarray, nagg: int):
    """Coarse padded adjacency induced by aggregation.

    Returns (coarse_adj (Nc, Kc) int32 sorted rows padded with the row
    id, coarse_diag_slot (Nc,) int32, scatter (N*K,) int32 mapping each
    fine block slot to its flat coarse destination row*Kc + slot).
    """
    N, K = adj.shape
    rows = agg[np.repeat(np.arange(N), K)]
    cols = agg[adj.reshape(-1)]
    neighbors = [set() for _ in range(nagg)]
    for a, b in zip(rows, cols):
        neighbors[a].add(b)
    for a in range(nagg):
        neighbors[a].add(a)
    Kc = max(len(s) for s in neighbors)
    coarse_adj = np.empty((nagg, Kc), dtype=np.int32)
    for a in range(nagg):
        lst = sorted(neighbors[a])
        # pad with the row id; pad slots receive zero blocks (nothing
        # scatters to them beyond genuine (a, a) edges at the diag slot)
        coarse_adj[a] = np.pad(lst, (0, Kc - len(lst)),
                               constant_values=a)[:Kc]
    coarse_diag_slot = np.argmax(
        coarse_adj == np.arange(nagg)[:, None], axis=1).astype(np.int32)
    # position of each coarse column within its row (rows are sorted over
    # the genuine prefix; searchsorted per row)
    slot = np.empty(N * K, dtype=np.int32)
    for i, (a, b) in enumerate(zip(rows, cols)):
        slot[i] = int(np.searchsorted(coarse_adj[a], b))
    scatter = rows.astype(np.int64) * Kc + slot
    return coarse_adj, coarse_diag_slot, scatter.astype(np.int32)


class AMGLevelPlan(NamedTuple):
    """Host-built static structure of one coarsening step."""
    agg: np.ndarray             # (N,) fine-vertex -> coarse-vertex
    nagg: int
    scatter: np.ndarray         # (N*K,) flat coarse block destination
    coarse_adj: np.ndarray      # (Nc, Kc)
    coarse_diag_slot: np.ndarray


class AMGPlan(NamedTuple):
    levels: Tuple[AMGLevelPlan, ...]

    @staticmethod
    def build(adj: np.ndarray, n_fields: int,
              coarsest_dofs: int = 600, max_levels: int = 10) -> "AMGPlan":
        """Coarsen the vertex graph until the coarsest dense system is
        below ``coarsest_dofs`` unknowns (n_fields per coarse vertex)."""
        adj = np.asarray(adj)
        levels = []
        while (len(levels) < max_levels
               and adj.shape[0] * n_fields > coarsest_dofs):
            agg, nagg = aggregate_vertices(adj)
            if nagg >= adj.shape[0]:            # no progress (tiny graph)
                break
            coarse_adj, cds, scatter = _coarse_graph(adj, agg, nagg)
            levels.append(AMGLevelPlan(agg=agg, nagg=nagg, scatter=scatter,
                                       coarse_adj=coarse_adj,
                                       coarse_diag_slot=cds))
            adj = coarse_adj
        return AMGPlan(levels=tuple(levels))


def galerkin_coarse(ell: BlockELL, lvl: AMGLevelPlan) -> BlockELL:
    """A_c = P^T A P for piecewise-constant P: every fine block A[v, k]
    lands whole on coarse block (agg[v], agg[adj[v, k]]) — one flat
    segment_sum.  Padded fine slots hold zero blocks and sum benignly
    into coarse diagonals."""
    N, K, f, _ = ell.shape4
    Nc = lvl.nagg
    Kc = lvl.coarse_adj.shape[1]
    fine = ell.blocks4().reshape(N * K, f * f)
    coarse = jax.ops.segment_sum(fine, jnp.asarray(lvl.scatter),
                                 num_segments=Nc * Kc)
    return BlockELL.from_blocks(jnp.asarray(lvl.coarse_adj),
                                coarse.reshape(Nc, Kc, f, f),
                                jnp.asarray(lvl.coarse_diag_slot))


class AMGLevelValues(NamedTuple):
    ell: BlockELL
    Dinv: jnp.ndarray           # (N, f, f) inverse diagonal blocks


class AMGValues(NamedTuple):
    levels: Tuple[AMGLevelValues, ...]
    coarsest_lu: Tuple[jnp.ndarray, jnp.ndarray]   # LU of the bottom


def amg_prepare(ell: BlockELL, plan: AMGPlan) -> AMGValues:
    """Compute the level values for one matrix: Galerkin coarse operators
    (one segment_sum per level), block-diagonal inverses, and the LU of
    the coarsest dense system."""
    levels = []
    cur = ell
    for lvl in plan.levels:
        levels.append(AMGLevelValues(
            ell=cur, Dinv=block_inv(cur.diag_blocks())))
        cur = galerkin_coarse(cur, lvl)
    # the coarsest LU runs in f64 whatever the level dtype: it is small,
    # and an f32 factorization could run its products in TF32 on a GPU
    dense = cur.to_dense().astype(jnp.float64)
    lu, piv = jax.scipy.linalg.lu_factor(dense)
    return AMGValues(levels=tuple(levels), coarsest_lu=(lu, piv))


def _smooth(ell: BlockELL, Dinv, r, z, omega, sweeps):
    """Damped block-Jacobi: z <- z + omega * Dinv (r - A z)."""
    for i in range(sweeps):
        resid = r if z is None else r - ell.matvec(z)
        upd = omega * jnp.einsum("nfg,ng->nf", Dinv, resid)
        z = upd if z is None else z + upd
    return z


def amg_vcycle(vals: AMGValues, plan: AMGPlan, r: jnp.ndarray,
               omega: float = 0.67, pre: int = 1, post: int = 1
               ) -> jnp.ndarray:
    """One V(pre, post)-cycle applied to residual r; returns z ~ A^{-1} r.

    The recursion depth is static (len(plan.levels)), so the whole cycle
    unrolls into one XLA program of batched matvecs + segment_sums.
    """
    f = r.shape[-1]

    def cyc(i, r_i):
        if i == len(plan.levels):
            lu, piv = vals.coarsest_lu
            x = jax.scipy.linalg.lu_solve(
                (lu, piv), r_i.reshape(-1).astype(lu.dtype))
            return x.astype(r_i.dtype).reshape(r_i.shape)
        lv, st = vals.levels[i], plan.levels[i]
        z = _smooth(lv.ell, lv.Dinv, r_i, None, omega, pre)
        r_c = jax.ops.segment_sum(r_i - lv.ell.matvec(z),
                                  jnp.asarray(st.agg),
                                  num_segments=st.nagg)
        z = z + cyc(i + 1, r_c)[jnp.asarray(st.agg)]
        return _smooth(lv.ell, lv.Dinv, r_i, z, omega, post)

    return cyc(0, r)


def amg_preconditioner(ell: BlockELL, plan: AMGPlan,
                       omega: float = 0.67, pre: int = 1, post: int = 1
                       ) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """M^{-1} z = one V-cycle on the given matrix; z, out: (N, f).

    Same call contract as :func:`solve.linear.block_jacobi_preconditioner`.
    """
    vals = amg_prepare(ell, plan)

    def apply(r):
        return amg_vcycle(vals, plan, r, omega=omega, pre=pre, post=post)

    return apply
