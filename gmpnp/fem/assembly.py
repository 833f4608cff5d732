"""Global assembly: residual vectors and block-ELL Jacobians.

Replaces the dolfin::Assembler element loop + PETSc matrix scatter
(SURVEY.md §2b).  All connectivity/geometry tables are precomputed host-side
in numpy (static constants under jit); the per-element work is pure JAX,
vmapped over elements, with the element Jacobian obtained by ``jax.jacfwd``
of the local residual.

Sparse storage is block-ELL ("padded CSR"): per mesh vertex a fixed-width,
sorted neighbor list (padded with self-loops) and per neighbor an
(n_fields x n_fields) dense block.  This keeps every shape static, makes the
matvec a gather + batched small matmul, and holds the entire Jacobian of
the reference workloads (<= ~40 MB) comfortably in device memory.
"""

from __future__ import annotations

import contextlib

from dataclasses import dataclass
from functools import partial
from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gmpnp.fem.elements import (
    physical_gradients,
    simplex_quadrature,
)
from gmpnp.fem.forms import WeakForm
from gmpnp.mesh.core import (
    Mesh,
    cell_measures,
    facet_measures,
    vertex_adjacency,
)


class BlockELL(NamedTuple):
    """Block sparse matrix in ELL format.

    adj : (N, K) int32 neighbor ids (sorted, padded with the row vertex)
    flat : (N, f, K*f) float: flat[n, r, k*f + c] = block[n, k][r, c].
        This is the operand layout of the batched-matmul matvec (one
        long trailing axis instead of trailing (f, f) = (9, 9) dims).
    diag_slot : (N,) int32 position of the diagonal block within each row
    """

    adj: jnp.ndarray
    flat: jnp.ndarray
    diag_slot: jnp.ndarray

    @property
    def n_fields(self) -> int:
        return self.flat.shape[1]

    @property
    def K(self) -> int:
        return self.flat.shape[2] // self.flat.shape[1]

    @property
    def shape4(self):
        N, f, Kf = self.flat.shape
        return (N, Kf // f, f, f)

    @staticmethod
    def from_blocks(adj, blocks4, diag_slot) -> "BlockELL":
        """Build from (N, K, f, f) block layout (tests / interop)."""
        N, K, f, _ = blocks4.shape
        flat = jnp.swapaxes(blocks4, 1, 2).reshape(N, f, K * f)
        return BlockELL(adj=adj, flat=flat, diag_slot=diag_slot)

    def blocks4(self) -> jnp.ndarray:
        """(N, K, f, f) view (a relayout copy)."""
        N, f, Kf = self.flat.shape
        K = Kf // f
        return jnp.swapaxes(self.flat.reshape(N, f, K, f), 1, 2)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y[n] = sum_k block[n,k] @ x[adj[n,k]];  x, y: (N, f) — one
        batched dot_general (batch n, contraction over flattened (k, g))."""
        N, f, Kf = self.flat.shape
        xg = x[self.adj].reshape(N, Kf)               # (N, K*g)
        return jax.lax.dot_general(
            self.flat, xg,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=x.dtype)

    def diag_blocks(self) -> jnp.ndarray:
        """(N, f, f) diagonal blocks."""
        N, f, Kf = self.flat.shape
        idx = (self.diag_slot[:, None, None] * f
               + jnp.arange(f)[None, None, :])        # (N, 1, f)
        return jnp.take_along_axis(
            self.flat, jnp.broadcast_to(idx, (N, f, f)), axis=2)

    def scale_rows(self, Dinv: jnp.ndarray) -> "BlockELL":
        """Left-multiply every block row by (N, f, f) matrices (block-row
        equilibration): new[n, r, :] = sum_s Dinv[n, r, s] flat[n, s, :]."""
        flat = jnp.einsum("nrs,nsk->nrk", Dinv, self.flat)
        return BlockELL(adj=self.adj, flat=flat, diag_slot=self.diag_slot)

    def to_dense(self) -> jnp.ndarray:
        """(N*f, N*f) dense matrix — tests / small direct solves only."""
        N, K, f, _ = self.shape4
        blocks4 = self.blocks4()
        rows = jnp.repeat(jnp.arange(N), K)
        cols = self.adj.reshape(-1)
        dense = jnp.zeros((N, f, N, f), dtype=self.flat.dtype)
        # padded slots alias the diagonal with zero blocks: scatter-add safe
        dense = dense.at[rows, :, cols, :].add(
            blocks4.reshape(N * K, f, f))
        return dense.reshape(N * f, N * f)


def _facet_tables(mesh: Mesh, quad_deg: int):
    """Per-marker facet tables: (nodes, measures, shape, weights, xq)."""
    assert mesh.facets is not None
    dim = mesh.dim
    fdim = dim - 1
    out: Dict[int, dict] = {}
    markers = np.unique(mesh.facet_markers)
    if fdim == 0:
        shape = np.ones((1, 1))
        w = np.ones(1)
        pts = np.zeros((1, 0))
    else:
        rule = simplex_quadrature(fdim, quad_deg)
        shape, w, pts = rule.shape, rule.weights, rule.points
    for m in markers:
        sel = mesh.facet_markers == m
        fnodes = mesh.facets[sel]
        fmeas = facet_measures(mesh.points, fnodes)
        X = mesh.points[fnodes]  # (F, fnv, dim)
        xq = np.einsum("qa,fad->fqd", shape, X)
        out[int(m)] = dict(
            nodes=fnodes.astype(np.int32),
            meas=fmeas,
            shape=shape,
            weights=w,
            xq=xq,
        )
    return out


def _sorted_segment_tables(dest: np.ndarray, n_dest: int):
    """Host-side tables for the gather/cumsum segment reduction.

    Returns (order, start, end) int32 such that segment i's values are
    ``values[order[start[i]:end[i]]]``.  Replaces scatter-add in global
    assembly with a sorted gather+cumsum+prefix-diff, which is pure dense
    work.
    """
    dest = np.asarray(dest).reshape(-1)
    order = np.argsort(dest, kind="stable")
    sorted_dest = dest[order]
    idx = np.arange(n_dest)
    start = np.searchsorted(sorted_dest, idx, side="left")
    end = np.searchsorted(sorted_dest, idx, side="right")
    return (order.astype(np.int32), start.astype(np.int32),
            end.astype(np.int32))


def _segment_reduce(values: jnp.ndarray, order, start, end) -> jnp.ndarray:
    """values (M, d) -> (n_dest, d): per-segment sums via sorted gather +
    cumulative sum + prefix difference (no scatter; deterministic order).
    Segments with start == end yield exact zeros."""
    v = values[order]
    cum = jnp.cumsum(v, axis=0)
    cum = jnp.concatenate(
        [jnp.zeros((1,) + v.shape[1:], v.dtype), cum], axis=0)
    return cum[end] - cum[start]


def _slot_table(cells: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """slot[c, a, b] = index of cells[c,b] within adj[cells[c,a]]."""
    C, nv = cells.shape
    rows = cells[:, :, None].repeat(nv, axis=2)      # (C, nv, nv)
    cols = cells[:, None, :].repeat(nv, axis=1)      # (C, nv, nv)
    row_adj = adj[rows]                              # (C, nv, nv, K)
    slot = np.argmax(row_adj == cols[..., None], axis=-1)
    assert (np.take_along_axis(row_adj, slot[..., None], -1)[..., 0]
            == cols).all(), "adjacency table missing an entry"
    return slot.astype(np.int32)


def _node_slot(nodes: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """slot[i, a, b] for facet node tuples (same as _slot_table)."""
    return _slot_table(nodes, adj)


@dataclass(frozen=True)
class FemSpace:
    """Precomputed multi-field P1 space over a mesh.

    The jnp arrays here are closed over by jit-compiled residual/Jacobian
    functions; everything is static-shaped.
    """

    n_fields: int
    num_vertices: int
    dim: int
    cells: jnp.ndarray          # (C, nv)
    vols: jnp.ndarray           # (C,)
    gradN: jnp.ndarray          # (C, nv, dim)
    Nq: jnp.ndarray             # (Q, nv)
    wq: jnp.ndarray             # (Q,)
    xq: jnp.ndarray             # (C, Q, dim)
    adj: jnp.ndarray            # (N, K)
    diag_slot: jnp.ndarray      # (N,)
    slot: jnp.ndarray           # (C, nv, nv)
    facet_tabs: tuple           # ((marker, dict), ...) static ordering
    points: jnp.ndarray         # (N, dim) vertex coords
    colors: np.ndarray = None   # (N,) greedy vertex coloring (host-side)
    # sorted-segment tables (host-side int32) for scatter-free assembly:
    # volume residual reduces (C*nv, f) onto vertices, volume Jacobian
    # reduces (C*nv*nv, f*f) onto (vertex, adjacency-slot) block ids
    res_tables: tuple = None    # (order, start, end) over dest = cells
    jac_tables: tuple = None    # (order, start, end) over dest = row*K+slot

    @staticmethod
    def build(mesh: Mesh, n_fields: int, quad_degree: int = 3,
              facet_quad_degree: int = 2) -> "FemSpace":
        dim = mesh.dim
        rule = simplex_quadrature(dim, quad_degree)
        vols = cell_measures(mesh.points, mesh.cells)
        gradN = physical_gradients(mesh.points, mesh.cells)
        X = mesh.points[mesh.cells]                       # (C, nv, dim)
        xq = np.einsum("qa,cad->cqd", rule.shape, X)
        adj, _ = vertex_adjacency(mesh.cells, mesh.num_vertices)
        diag_slot = np.argmax(adj == np.arange(len(adj))[:, None], axis=1)
        slot = _slot_table(mesh.cells, adj)
        colors = None
        try:
            from gmpnp import native
            csr = native.vertex_adjacency_csr(mesh.cells, mesh.num_vertices)
            if csr is not None:
                colors = native.greedy_color(*csr, mesh.num_vertices)
        except Exception:
            colors = None
        if colors is None:
            from gmpnp.solve.linear import greedy_vertex_coloring
            colors = greedy_vertex_coloring(adj)

        # NOTE: all static tables stay host-side numpy.  Under jit they are
        # embedded as program constants directly; storing them as device
        # arrays would force a device->host fetch per table at every
        # lowering.
        K = adj.shape[1]
        ftabs = []
        for m, t in sorted(_facet_tables(mesh, facet_quad_degree).items()):
            t = dict(t)
            t["slot"] = _node_slot(t["nodes"], adj)
            # sorted-segment tables reducing this marker's facet Jacobians
            # onto (vertex, adjacency-slot) block ids — same machinery as
            # the volume reduction.  (A 2D flat.at[rows, cols].add scatter
            # here once miscompiled on an earlier backend when fused with
            # the volume assembly; ROADMAP Design 6.)
            fjac_dest = (t["nodes"][:, :, None].astype(np.int64) * K
                         + t["slot"]).reshape(-1)
            t["jac_tables"] = _sorted_segment_tables(
                fjac_dest, mesh.num_vertices * K)
            ftabs.append((m, {k: np.asarray(v) if not isinstance(v, tuple)
                              else v for k, v in t.items()}))
        res_tables = _sorted_segment_tables(
            mesh.cells.reshape(-1), mesh.num_vertices)
        jac_dest = (mesh.cells[:, :, None].astype(np.int64) * K
                    + slot).reshape(-1)          # (C*nv*nv,)
        jac_tables = _sorted_segment_tables(
            jac_dest, mesh.num_vertices * K)

        return FemSpace(
            n_fields=n_fields,
            num_vertices=mesh.num_vertices,
            dim=dim,
            cells=np.asarray(mesh.cells),
            vols=np.asarray(vols),
            gradN=np.asarray(gradN),
            Nq=np.asarray(rule.shape),
            wq=np.asarray(rule.weights),
            xq=np.asarray(xq),
            adj=np.asarray(adj),
            diag_slot=np.asarray(diag_slot.astype(np.int32)),
            slot=np.asarray(slot),
            facet_tabs=tuple(ftabs),
            points=np.asarray(mesh.points),
            colors=colors,
            res_tables=res_tables,
            jac_tables=jac_tables,
        )

    # -- local kernels -------------------------------------------------------

    def _local_volume_residual(self, form: WeakForm, u_e, u_prev_e,
                               gradN_c, vol_c, xq_c, theta, aux_e=None):
        """Element residual (nv, fields) for one element."""
        # grad u (fields, dim): constant over the P1 element
        grad_u = jnp.einsum("af,ad->fd", u_e, gradN_c)

        def at_q(Nq_q, x_q):
            u_q = Nq_q @ u_e           # (fields,)
            up_q = Nq_q @ u_prev_e
            if form.n_aux:
                aux_q = Nq_q @ aux_e
                fval, fgrad = form.volume(u_q, grad_u, up_q, aux_q, x_q, theta)
            else:
                fval, fgrad = form.volume(u_q, grad_u, up_q, x_q, theta)
            # (nv, fields): fval tested with N_a, fgrad with grad N_a
            return (jnp.outer(Nq_q, fval)
                    + jnp.einsum("ad,fd->af", gradN_c, fgrad))

        contrib = jax.vmap(at_q)(self.Nq, xq_c)      # (Q, nv, fields)
        return vol_c * jnp.einsum("q,qaf->af", self.wq, contrib)

    def _local_facet_residual(self, fn, u_f, meas_f, shape, weights,
                              xq_f, theta):
        """Facet residual (fnv, fields) for one boundary facet."""
        def at_q(Nq_q, x_q):
            u_q = Nq_q @ u_f
            g = fn(u_q, x_q, theta)
            return jnp.outer(Nq_q, g)

        contrib = jax.vmap(at_q)(shape, xq_f)
        return meas_f * jnp.einsum("q,qaf->af", weights, contrib)

    # -- global assembly -----------------------------------------------------

    def residual(self, form: WeakForm, u, u_prev, theta,
                 aux=None) -> jnp.ndarray:
        """Assembled residual (N, fields); ``aux`` (N, n_aux) when the form
        declares auxiliary fields."""
        u_e = u[self.cells]            # (C, nv, fields)
        up_e = u_prev[self.cells]
        if form.n_aux:
            aux_e = aux[self.cells]
            r_e = jax.vmap(
                lambda ue, upe, ax, g, v, x: self._local_volume_residual(
                    form, ue, upe, g, v, x, theta, ax)
            )(u_e, up_e, aux_e, self.gradN, self.vols, self.xq)
        else:
            r_e = jax.vmap(
                lambda ue, upe, g, v, x: self._local_volume_residual(
                    form, ue, upe, g, v, x, theta)
            )(u_e, up_e, self.gradN, self.vols, self.xq)
        # scatter-free reduction onto vertices (sorted gather + cumsum)
        C, nv = self.cells.shape
        r = _segment_reduce(
            r_e.reshape(C * nv, self.n_fields), *self.res_tables)

        for marker, tab in self.facet_tabs:
            fn = form.boundary.get(marker)
            if fn is None:
                continue
            u_f = u[tab["nodes"]]
            rf = jax.vmap(
                lambda uf, mf, xf: self._local_facet_residual(
                    fn, uf, mf, tab["shape"], tab["weights"], xf, theta)
            )(u_f, tab["meas"], tab["xq"])
            r = r.at[tab["nodes"]].add(rf)
        return r

    #: elements per chunk for Jacobian assembly.  jacfwd's tangent-expanded
    #: intermediates are O(chunk * (nv*f)^2 * quad); computed for all
    #: elements at once they reach GBs (x sweep lanes under vmap), so
    #: lax.map over fixed-size chunks caps the footprint while keeping each
    #: chunk fully batched.  The value is inherited and not yet measured on
    #: a GPU, where it splits the pore's ~11.5k tets into ~90 sequential
    #: chunks (ROADMAP Speed 3).
    jac_chunk: int = 128

    def _chunked_map(self, fn, args, n_items):
        """lax.map of a vmapped kernel over fixed-size chunks of the leading
        axis (padded; caller slices back to n_items)."""
        chunk = min(self.jac_chunk, n_items)
        n_chunks = -(-n_items // chunk)
        pad = n_chunks * chunk - n_items

        def pad0(a):
            if pad == 0:
                return a
            return jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)

        args_c = [pad0(a).reshape((n_chunks, chunk) + a.shape[1:])
                  for a in args]
        out = jax.lax.map(lambda xs: jax.vmap(fn)(*xs), tuple(args_c))
        return out.reshape((n_chunks * chunk,) + out.shape[2:])[:n_items]

    def _scatter_tables(self, nodes, slot):
        """Precompute flat scatter indices for element/facet Jacobians.

        For item i with local vertices nodes[i] and slot table slot[i,a,b],
        the flattened local Jacobian entry (a, b, r, c) lands at
        flat-1D index  r*(K*f) + slot*f + c  of row nodes[i, a].
        Returns (rows (I, nv*nv*f*f), cols (same)) int32 numpy arrays.
        """
        f = self.n_fields
        K = self.adj.shape[1]
        I, nv = nodes.shape
        r_idx = np.arange(f)[:, None]
        c_idx = np.arange(f)[None, :]
        # (I, nv, nv, f, f)
        cols = (r_idx[None, None, None] * (K * f)
                + slot[:, :, :, None, None] * f
                + c_idx[None, None, None])
        rows = np.broadcast_to(
            nodes[:, :, None, None, None], cols.shape)
        return (rows.reshape(I, -1).astype(np.int32),
                cols.reshape(I, -1).astype(np.int32))

    def jacobian(self, form: WeakForm, u, u_prev, theta, aux=None,
                 dtype=None) -> BlockELL:
        """Assembled Jacobian dF/du as BlockELL (aux never differentiated).

        ``dtype=jnp.float32`` evaluates the element Jacobians in f32
        (inexact Newton: a ~1e-7-relative Jacobian perturbation does not
        change Newton's convergence at the reference's 1e-4 tolerances;
        the residual stays f64).  The element Jacobians are flattened to
        (C, nv*nv*f*f) before the reduction, so large temporaries keep a
        single long trailing axis."""
        f = self.n_fields
        N = self.num_vertices
        K = self.adj.shape[1]
        nv = self.cells.shape[1]
        C = self.cells.shape[0]

        def cast(a):
            a = jnp.asarray(a)
            return a.astype(dtype) if dtype is not None else a

        if dtype is not None:
            # cast traced theta scalars too, and trace the element kernels
            # under disable_x64 so the forms' numpy-f64 closure constants
            # canonicalize to f32 instead of promoting the math back to f64
            theta = jax.tree.map(
                lambda a: (jnp.asarray(a).astype(dtype)
                           if jnp.issubdtype(jnp.asarray(a).dtype,
                                             jnp.floating)
                           else a), theta)
            # full-f32 dots: a float32 contraction may otherwise run in
            # TF32 on a GPU
            def trace_ctx():
                stack = contextlib.ExitStack()
                stack.enter_context(jax.enable_x64(False))
                stack.enter_context(jax.default_matmul_precision("highest"))
                return stack
        else:
            trace_ctx = contextlib.nullcontext

        if form.n_aux:
            def local_jac(ue, upe, ax, g, v, x):
                fn = lambda uu: self._local_volume_residual(
                    form, uu, upe, g, v, x, theta, ax)
                J = jax.jacfwd(fn)(ue)             # (nv, f, nv, f)
                return jnp.transpose(J, (0, 2, 1, 3)).reshape(-1)

            with trace_ctx():
                J_e = self._chunked_map(
                    local_jac,
                    [cast(u[self.cells]), cast(u_prev[self.cells]),
                     cast(aux[self.cells]), cast(self.gradN),
                     cast(self.vols), cast(self.xq)], C)
        else:
            def local_jac(ue, upe, g, v, x):
                fn = lambda uu: self._local_volume_residual(
                    form, uu, upe, g, v, x, theta)
                J = jax.jacfwd(fn)(ue)             # (nv, f, nv, f)
                return jnp.transpose(J, (0, 2, 1, 3)).reshape(-1)

            with trace_ctx():
                J_e = self._chunked_map(
                    local_jac,
                    [cast(u[self.cells]), cast(u_prev[self.cells]),
                     cast(self.gradN), cast(self.vols), cast(self.xq)], C)

        # scatter-free block reduction: J_e rows are laid out (a, b, r, c)
        # per element, matching the (c, a, b) destination ordering of
        # jac_tables; reduce to (N*K) f x f blocks, then relayout to the
        # BlockELL flat form.  The reduction always runs in the solve
        # dtype: its cumsum prefixes grow ~1e5x the entries, and in f32
        # the prefix differences lose ~5 digits (measured 2.6e-5 relative
        # error) — only the element kernels gain from f32.
        blocks = _segment_reduce(
            J_e.astype(u.dtype).reshape(C * nv * nv, f * f),
            *self.jac_tables)

        for marker, tab in self.facet_tabs:
            fn = form.boundary.get(marker)
            if fn is None:
                continue

            def local_fjac(uf, mf, xf):
                f_res = lambda uu: self._local_facet_residual(
                    fn, uu, mf, tab["shape"], tab["weights"], xf, theta)
                J = jax.jacfwd(f_res)(uf)
                return jnp.transpose(J, (0, 2, 1, 3)).reshape(-1)

            # facet Jacobians stay f64 regardless of ``dtype``: they are
            # tiny (boundary facets only) and the boundary-flux closures
            # mix f64 constants that break mixed-precision tracing.
            # Reduced scatter-free onto the same (vertex, slot) block ids
            # as the volume terms (see the facet tables in build).
            Jf = jax.vmap(local_fjac)(u[tab["nodes"]], tab["meas"],
                                      tab["xq"])
            Fc, fnv = tab["nodes"].shape
            blocks = blocks + _segment_reduce(
                Jf.astype(u.dtype).reshape(Fc * fnv * fnv, f * f),
                *tab["jac_tables"])

        flat = (blocks.reshape(N, K, f, f)
                .swapaxes(1, 2).reshape(N, f * K * f))
        return BlockELL(adj=self.adj, flat=flat.reshape(N, f, K * f),
                        diag_slot=self.diag_slot)
