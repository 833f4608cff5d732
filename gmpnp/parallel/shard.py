"""Z-slab domain decomposition of the 3D pore solve over a device mesh.

The replacement for the MPI/METIS distributed-memory path latent in the
reference stack (environment.yml:73-75; never exercised by the scripts):
the cylinder is slab-partitioned along z across devices inside a
``jax.sharding.Mesh``; every assembly/matvec does one ``ppermute`` halo
gather and one ``ppermute`` spill reduction; Krylov/Newton
reductions are ``psum``.  The entire Newton step runs inside a single
``shard_map``-wrapped jit.

Partitioning scheme (host-side, ZShardPlan.build):
- vertices sorted by z and split into equal contiguous blocks of N_p
  (zero-padded to n_dev * N_p);
- an element is owned by the device owning its minimum vertex; since slabs
  are contiguous in z, every element's vertices then live in
  [own block, own block + H) where H is the (exact, precomputed) maximum
  overshoot — the right halo width;
- boundary facets follow the same ownership rule.

SPMD step primitives:
- halo_gather:  u_ext = [u_own ; first H rows of right neighbor]
- spill_reduce: fold contributions accumulated for halo rows back onto
  their owner (left-shift ppermute + add)
- Dirichlet row masking happens post-reduction on the owner, which is
  exactly equivalent to the single-device row replacement.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from functools import partial
from typing import Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gmpnp.fem.assembly import _segment_reduce, _sorted_segment_tables
from gmpnp.fem.elements import physical_gradients, simplex_quadrature
from gmpnp.fem.forms import WeakForm
from gmpnp.solve.slab import (
    _HI,
    SlabFactors,
    _mm,
    slab_factor,
    slab_solve,
)
from gmpnp.solve.smallblock import block_inv
from gmpnp.mesh.core import (
    Mesh as FemMesh,
    cell_measures,
    facet_measures,
)


@dataclass(frozen=True)
class ZShardPlan:
    """Host-side partition tables.  All per-device arrays carry a leading
    n_dev axis and are fed to shard_map with in_specs P('z')."""

    n_dev: int
    n_fields: int
    N: int              # true vertex count
    N_p: int            # owned vertices per device (padded)
    H: int              # right-halo width
    # per-device element tables, shape (n_dev, C_p, ...)
    cells_l: np.ndarray     # extended-local vertex ids, (n_dev, C_p, nv)
    vols: np.ndarray        # (n_dev, C_p); padding elements have vol 0
    gradN: np.ndarray       # (n_dev, C_p, nv, dim)
    # quadrature (shared)
    Nq: np.ndarray
    wq: np.ndarray
    # per-device boundary facet tables per marker:
    # dict marker -> (nodes_l (n_dev, F_p, fnv), meas (n_dev, F_p), shape, w)
    facets: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    # Dirichlet data over owned nodes, (n_dev, N_p, f)
    bc_mask: np.ndarray
    bc_vals: np.ndarray
    # owned-node validity (padding rows false), (n_dev, N_p)
    valid: np.ndarray
    # z-sort permutation: plan vertex i is original vertex perm[i] (identity
    # when the mesh is already sorted, e.g. generated cylinder meshes)
    perm: np.ndarray

    def localize(self, u: np.ndarray) -> np.ndarray:
        """(N, ...) original vertex order -> (n_dev*N_p, ...) plan order,
        zero-padded."""
        u = np.asarray(u)
        out = np.zeros((self.n_dev * self.N_p,) + u.shape[1:], u.dtype)
        out[: self.N] = u[self.perm]
        return out

    def globalize(self, u_pad) -> np.ndarray:
        """(n_dev*N_p, ...) plan order -> (N, ...) original vertex order."""
        u_pad = np.asarray(u_pad)
        out = np.empty((self.N,) + u_pad.shape[1:], u_pad.dtype)
        out[self.perm] = u_pad[: self.N]
        return out

    @staticmethod
    def build(mesh: FemMesh, n_fields: int, n_dev: int,
              bc_mask: np.ndarray, bc_vals: np.ndarray,
              quad_degree: int = 2):
        """bc_mask/vals are global (N, f) in the mesh's vertex order.

        The z-slab partition needs vertices numbered ascending in the last
        coordinate; the SHIPPED reference meshes are not (their DOLFIN-XML
        ordering has z-bandwidth ~N/2, which round-3 found silently
        produced halo = slab and crashed XLA:CPU at N=3530).  The plan
        therefore z-sorts internally and records ``perm``; use
        ``localize``/``globalize`` to move between orderings."""
        z = mesh.points[:, -1]
        if np.any(np.diff(z) < 0):
            perm = np.argsort(z, kind="stable")
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            mesh = _dc_replace(
                mesh,
                points=mesh.points[perm],
                cells=inv[mesh.cells].astype(np.int32),
                facets=(inv[mesh.facets].astype(np.int32)
                        if mesh.facets is not None else None),
            )
            bc_mask = np.asarray(bc_mask)[perm]
            bc_vals = np.asarray(bc_vals)[perm]
        else:
            perm = np.arange(mesh.num_vertices)
        dim = mesh.dim
        nv = dim + 1
        N = mesh.num_vertices
        N_p = -(-N // n_dev)
        N_pad = N_p * n_dev

        cells = mesh.cells.astype(np.int64)
        owner = cells.min(axis=1) // N_p
        block_end = (owner + 1) * N_p
        overshoot = cells.max(axis=1) - (block_end - 1)
        H = max(1, int(np.maximum(overshoot, 0).max()))
        if H > N_p:
            raise ValueError(
                f"halo width {H} exceeds slab size {N_p}: too many devices "
                f"for this mesh ({N} vertices, {n_dev} devices)")

        vols_g = cell_measures(mesh.points, mesh.cells)
        gradN_g = physical_gradients(mesh.points, mesh.cells)
        rule = simplex_quadrature(dim, quad_degree)

        C_p = max(int((owner == p).sum()) for p in range(n_dev))
        cells_l = np.zeros((n_dev, C_p, nv), dtype=np.int32)
        vols = np.zeros((n_dev, C_p))
        gradN = np.zeros((n_dev, C_p, nv, dim))
        for p in range(n_dev):
            sel = np.nonzero(owner == p)[0]
            k = len(sel)
            cells_l[p, :k] = cells[sel] - p * N_p
            vols[p, :k] = vols_g[sel]
            gradN[p, :k] = gradN_g[sel]

        # boundary facets by the same ownership rule
        facets = {}
        if mesh.facets is not None and len(mesh.facets):
            fdim = dim - 1
            if fdim == 0:
                fshape = np.ones((1, 1))
                fw = np.ones(1)
            else:
                frule = simplex_quadrature(fdim, quad_degree)
                fshape, fw = frule.shape, frule.weights
            for m in np.unique(mesh.facet_markers):
                fsel = mesh.facets[mesh.facet_markers == m].astype(np.int64)
                fmeas_g = facet_measures(mesh.points, fsel)
                fowner = fsel.min(axis=1) // N_p
                over = fsel.max(axis=1) - ((fowner + 1) * N_p - 1)
                assert int(np.maximum(over, 0).max(initial=0)) <= H
                F_p = max(1, max(int((fowner == p).sum())
                                 for p in range(n_dev)))
                fn = np.zeros((n_dev, F_p, fsel.shape[1]), dtype=np.int32)
                fm = np.zeros((n_dev, F_p))
                for p in range(n_dev):
                    s = np.nonzero(fowner == p)[0]
                    fn[p, :len(s)] = fsel[s] - p * N_p
                    fm[p, :len(s)] = fmeas_g[s]
                facets[int(m)] = (fn, fm, fshape, fw)

        def pad_nodes(arr, fill=0.0):
            out = np.full((N_pad,) + arr.shape[1:], fill, dtype=arr.dtype)
            out[:N] = arr
            return out.reshape((n_dev, N_p) + arr.shape[1:])

        valid = pad_nodes(np.ones(N, dtype=bool), False)
        return ZShardPlan(
            n_dev=n_dev, n_fields=n_fields, N=N, N_p=N_p, H=H,
            cells_l=cells_l, vols=vols, gradN=gradN,
            Nq=rule.shape, wq=rule.weights,
            facets=facets,
            bc_mask=pad_nodes(np.asarray(bc_mask).astype(bool), False),
            bc_vals=pad_nodes(np.asarray(bc_vals).astype(np.float64)),
            valid=valid,
            perm=perm,
        )


@dataclass(frozen=True)
class SlabPrecondPlan:
    """Host-side tables for the DISTRIBUTED z-slab direct solver (SPIKE).

    Distributes the production slab solver (solve.slab — the MUMPS-slot
    replacement) across the device mesh as an EXACT f32 direct solve of
    the full Newton system, used as the preconditioner of the sharded
    f64 GMRES (the same mixed-precision recipe as the single-chip
    slab_direct path, so the sharded inner solve converges in the same
    O(10)-iteration regime regardless of device count).

    Why exact and not Schwarz: one-level RAS (round-3 first cut) has no
    global coarse coupling, so its iteration count grows with device
    count — measured 97/354/792 Krylov iterations per Newton at
    n_dev=2/4/8 on a fixed N=1517 mesh (the Poisson field is globally
    elliptic; every seam truncation is felt everywhere).  The SPIKE
    factorization removes the seams instead of approximating them.

    Algorithm (classic SPIKE / block cyclic reduction over device
    blocks; each Newton iteration):

    1. every device assembles its owned-rows block-banded Jacobian from
       its element AND boundary-facet blocks (scatter-free sorted-segment
       reduction over this plan's tables), row-replaces Dirichlet rows,
       equilibrates with the exact spill-reduced block diagonal, and
       factors it with f32 block-Thomas (solve.slab) — all
       devices in parallel;
    2. the seam coupling blocks B_p (own last rows -> right neighbor's
       head columns) and C_p (own head rows -> left neighbor's tail
       columns; assembled by the LEFT neighbor's elements and exchanged
       one ppermute right) are restricted to the static interface
       windows of ``h_v`` vertices (h_v = element bandwidth >= halo) and
       turned into spikes V_p = A_p^{-1} B_p, W_p = A_p^{-1} C_p by the
       factored local solve with h_v*f simultaneous RHS columns;
    3. the interface unknowns y_p (tail window of device p) and z_{p+1}
       (head window of device p+1) close a block-tridiagonal REDUCED
       system of n_dev-1 seam blocks of size 2*h_v*f, built replicated
       from one all_gather of the four spike tip blocks per device and
       factored once per Newton iteration (again solve.slab);
    4. each application then costs one local banded solve, one
       all_gather of the two interface RHS windows, one replicated
       reduced solve, and two (S, m, h) spike corrections — and returns
       the EXACT (up to f32) solution of the full distributed system.

    Layout: extended positions 0..(S+1)*m_v; local vertex id r maps to
    position r for owned rows (padding positions N_p..S*m_v are identity
    rows inside the last owned slab) and to S*m_v + (r - N_p) for
    halo rows.  ``m_v`` is chosen with m_v >= bw + pad so that EVERY
    element coupling lands within one slab of its row (|band| <= 1) —
    including owned-row -> halo-column couplings across the padding
    gap.  That same inequality places the tail interface window
    [N_p - h_v, N_p) entirely inside the last slab.
    """

    S: int           # owned slabs per device (assembly space has S+1)
    m_v: int         # vertices per slab
    f: int
    N_p: int
    h_v: int         # interface window width in vertices (= bandwidth)
    pad: int         # identity padding rows inside the last slab
    # per-device sorted-segment tables over extended band destinations
    # (element pair blocks first, then facet pair blocks per marker in
    # ``facet_markers`` order — the runtime concatenates values the same
    # way)
    facet_markers: Tuple[int, ...]
    order: np.ndarray   # (n_dev, n_pairs) int32
    start: np.ndarray   # (n_dev, (S+1)*m_v*3*m_v) int32
    end: np.ndarray     # (n_dev, (S+1)*m_v*3*m_v) int32
    # owned-position coverage: True = some element assembles this row
    # (own elements or left-neighbor spill); uncovered -> identity row
    cover: np.ndarray   # (n_dev, (S+1)*m_v) bool

    @property
    def m(self) -> int:
        return self.m_v * self.f

    @property
    def h(self) -> int:
        return self.h_v * self.f

    @staticmethod
    def build(plan: ZShardPlan,
              facet_markers: Sequence[int] = ()) -> "SlabPrecondPlan":
        n_dev, N_p, f = plan.n_dev, plan.N_p, plan.n_fields
        cells_l = np.asarray(plan.cells_l)          # (n_dev, C_p, nv)
        n_dev_, C_p, nv = cells_l.shape
        facet_markers = tuple(sorted(facet_markers))

        # local bandwidth over element couplings; m_v >= bw makes the
        # extended system block tridiagonal in slabs (solve.slab)
        span = cells_l.max(axis=2) - cells_l.min(axis=2)    # (n_dev, C_p)
        bw = max(1, int(span.max(initial=0)))
        if bw > N_p:
            raise ValueError(
                f"element bandwidth {bw} exceeds slab size {N_p}: too "
                f"many devices for this mesh")
        m_v = min(max(bw, 1), N_p)
        S = max(-(-N_p // m_v), 1)
        m_v = min(max(-(-N_p // S), bw), N_p)
        # m_v < bw silently drops couplings from the band (N_p=162,
        # bw=36 would round m_v down to 33); SPIKE further needs
        # m_v >= bw + pad so couplings that jump the padding gap into the
        # halo slab stay within |band| <= 1 and the tail interface
        # window stays inside the last slab
        while S * m_v - N_p > m_v - bw:
            m_v += 1
            S = max(-(-N_p // m_v), 1)
        pad = S * m_v - N_p
        assert 0 <= pad <= m_v - bw and m_v <= N_p
        E = (S + 1) * m_v
        n_dest = E * 3 * m_v

        cover = np.zeros((n_dev, E), bool)
        vols = np.asarray(plan.vols)                        # (n_dev, C_p)

        def pos_of(idx):
            return np.where(idx < N_p, idx, S * m_v + (idx - N_p))

        for p in range(n_dev):
            c = cells_l[p].astype(np.int64)
            real = vols[p] > 0                              # padding cells
            cov = np.unique(c[real])
            cover[p, pos_of(cov)] = True
            # own rows also covered via the left neighbor's spill
            # exchange (element owner = min-vertex device and span <= bw
            # <= m_v, so no device beyond the left neighbor contributes)
            if p > 0:
                cl = cells_l[p - 1].astype(np.int64)
                spill = np.unique(cl[vols[p - 1] > 0])
                spill = spill[spill >= N_p] - N_p
                cover[p, spill[spill < N_p]] = True

        def pair_dest(c):
            """(n, k) node tuples -> flat band destinations for every
            (row, col) node pair, matching the runtime value order
            J[n, a, b] -> (row c[a], col c[b])."""
            k = c.shape[1]
            r = np.repeat(c[:, :, None], k, 2).reshape(-1)
            q = np.repeat(c[:, None, :], k, 1).reshape(-1)
            pr, pq = pos_of(r), pos_of(q)
            s_r, i_r = pr // m_v, pr % m_v
            s_q, i_q = pq // m_v, pq % m_v
            band = s_q - s_r
            assert (np.abs(band) <= 1).all(), "band overflow: bad m_v"
            return (s_r * m_v + i_r) * (3 * m_v) + (band + 1) * m_v + i_q

        # element pair blocks first, then facet pair blocks per marker —
        # facet Jacobians INCLUDED so the f32 factorization is the exact
        # (rounded) inverse of the Krylov operator, not a perturbation
        n_pairs = C_p * nv * nv + sum(
            plan.facets[mk][0].shape[1] * plan.facets[mk][0].shape[2] ** 2
            for mk in facet_markers)
        orders = np.zeros((n_dev, n_pairs), np.int32)
        starts = np.zeros((n_dev, n_dest), np.int32)
        ends = np.zeros((n_dev, n_dest), np.int32)
        for p in range(n_dev):
            dest = [pair_dest(cells_l[p].astype(np.int64))]
            for mk in facet_markers:
                fn = np.asarray(plan.facets[mk][0][p]).astype(np.int64)
                dest.append(pair_dest(fn))
            o, st, en = _sorted_segment_tables(
                np.concatenate(dest), n_dest)
            orders[p], starts[p], ends[p] = o, st, en
        return SlabPrecondPlan(S=S, m_v=m_v, f=f, N_p=N_p, h_v=bw, pad=pad,
                               facet_markers=facet_markers,
                               order=orders, start=starts, end=ends,
                               cover=cover)


def make_sharded_step(
    plan: ZShardPlan,
    form: WeakForm,
    mesh_devices,
    newton_max_iter: int = 50,
    newton_rtol: float = 1.0e-4,
    newton_atol: float = 1.0e-4,
    relaxation: float = 0.9,
    krylov_tol: float = 1.0e-6,
    krylov_maxiter: int = 2000,
    krylov_restart: int = 30,
    axis_name: str = "z",
    linear: str = "slab_direct",
    refresh: str = "iter",
    chord_max_iter: int = 16,
    refresh_iters: int = 8,
    bc_lifts: Optional[Sequence[Tuple[np.ndarray, str]]] = None,
    seam: str = "replicated",
    jit: bool = True,
):
    """Build a sharded implicit step.

    Returns (step_fn, device_mesh, u_sharding) with
    ``step_fn(u_sharded (n_dev*N_p, f), up_sharded, theta) -> (u_new,
    (iters, converged, resnorm, lin_iters))`` running damped Newton fully
    inside one shard_map.

    linear: 'slab_direct' (default) runs distributed f64 CGS2-GMRES
    preconditioned by the EXACT f32 distributed SPIKE direct solve of
    the banded Jacobian (per-device block-Thomas factorizations + a
    replicated reduced seam system; see SlabPrecondPlan) — the
    distributed form of the production solve.slab solver, with
    device-count-independent O(10) inner iterations; 'bicgstab_jacobi'
    keeps the round-1 block-Jacobi BiCGStab.

    refresh: 'iter' (default) re-assembles the Jacobian and re-factors
    at every Newton iterate (exact Newton); 'step' assembles + factors
    ONCE at the step's start iterate and reuses both for the whole step
    (modified/chord Newton, certified on the true residual) — the
    distributed analogue of LinearConfig.refresh='step', skipping the
    dominant assembly+factorization work on every iteration after the
    first (tests/test_parallel.py::test_sharded_step_refresh_matches_iter).
    'carried' extends 'step' ACROSS time steps (the distributed
    LinearConfig.refresh='carried'): the local Jacobian blocks + SPIKE
    factorization ride the transient scan carry, the chord attempt gets
    ``chord_max_iter`` iterations, non-convergence falls back to exact
    Newton from the safe previous state (re-factoring the carry), and a
    converged-but-slow step (> ``refresh_iters`` iterations) refreshes
    proactively.  With refresh='carried' the return is a 4-TUPLE
    ``(step, prep_init, dev_mesh, u_sharding)`` with the stateful
    protocol ``step(u_start, u_prev, theta, carry) -> (u_new, stats,
    carry_new)`` and ``prep_init(u0, u0, theta) -> carry`` (the carry is
    opaque; make_sharded_transient threads it and adds the decay-aware
    start predictor).  Requires linear='slab_direct'.

    bc_lifts: optional static (N_pad, f) one-hot masks paired with theta
    keys; per step the Dirichlet VALUES become
    ``vals*(1-onehot) + theta[key]*onehot`` (pure arithmetic — the
    vmap/sweep-safe BC formulation, fem.dirichlet.ArithDirichletBC), which
    is how the moving Sechenov CO2 Dirichlet value
    (3D/MPNP_CO2ER_pore.py:815-838) enters the sharded transient without
    recompilation.
    """
    if linear not in ("slab_direct", "bicgstab_jacobi"):
        raise ValueError(f"unknown sharded linear solver {linear!r}; "
                         f"'slab_direct' or 'bicgstab_jacobi'")
    if refresh not in ("iter", "step", "carried"):
        # 'step' freezes the Jacobian + SPIKE factorization at the step's
        # start iterate (modified/chord Newton) — one assembly and one
        # distributed factorization per time step instead of per Newton
        # iteration.  'carried' extends 'step' ACROSS steps: the local
        # Jacobian blocks + SPIKE factorization ride the transient scan
        # carry and refresh lazily (the distributed analogue of
        # LinearConfig.refresh='carried'); requires linear='slab_direct'
        # and the stateful step protocol (make_sharded_step returns a
        # 4-tuple with a prep_init, see below).
        raise ValueError(f"refresh must be 'iter', 'step' or 'carried', "
                         f"got {refresh!r}")
    if refresh == "carried" and linear != "slab_direct":
        raise ValueError("refresh='carried' requires linear='slab_direct' "
                         "(the carried state is the SPIKE factorization)")
    if seam not in ("replicated", "ring"):
        # 'replicated': the reduced block-tridiagonal seam system is
        # all_gathered and factored identically on every device — O(n_dev)
        # (2h)^2 blocks per device.  'ring': the seam system stays
        # distributed one block-row per device and is solved by parallel
        # cyclic reduction over the device ring — O(log n_dev) blocks per
        # device, removing the n_dev^2 aggregate memory term.
        raise ValueError(f"seam must be 'replicated' or 'ring', got "
                         f"{seam!r}")
    n_dev, N_p, H, nf = plan.n_dev, plan.N_p, plan.H, plan.n_fields
    if linear == "slab_direct":
        active_markers = sorted(
            mk for mk in plan.facets if form.boundary.get(mk) is not None)
        pp = SlabPrecondPlan.build(plan, facet_markers=active_markers)
    else:
        pp = None
    bc_lifts = list(bc_lifts or [])
    lift_keys = [k for _, k in bc_lifts]
    dev_mesh = Mesh(np.array(mesh_devices).reshape(n_dev), (axis_name,))
    u_sharding = NamedSharding(dev_mesh, P(axis_name))

    fwd_perm = [(p, p - 1) for p in range(1, n_dev)]   # halo gather (recv
                                                       # right nbr's head)
    bwd_perm = [(p, p + 1) for p in range(n_dev - 1)]  # spill reduce

    def halo_gather(u_loc):
        recv = jax.lax.ppermute(u_loc[:H], axis_name, fwd_perm)
        return jnp.concatenate([u_loc, recv], axis=0)

    def spill_reduce(r_ext):
        own, spill = r_ext[:N_p], r_ext[N_p:]
        recv = jax.lax.ppermute(spill, axis_name, bwd_perm)
        return own.at[:H].add(recv)

    def pdot(a, b):
        return jax.lax.psum(jnp.sum(a * b), axis_name)

    def pnorm(a):
        return jnp.sqrt(pdot(a, a))

    def _ring_shift(x, dist, fill):
        """Per-device value of ``x`` at ring position idx+dist, replaced
        by ``fill`` where idx+dist falls outside [0, n_dev) — ppermute is
        cyclic, but the seam chain is a LINE, so wraparound neighbors
        must act as identity/zero rows."""
        perm = [(j, (j - dist) % n_dev) for j in range(n_dev)]
        got = jax.lax.ppermute(x, axis_name, perm)
        idx = jax.lax.axis_index(axis_name)
        ok = (idx + dist >= 0) & (idx + dist < n_dev)
        return jnp.where(ok, got, fill)

    _pcr_rounds = max(1, int(np.ceil(np.log2(max(n_dev, 2)))))

    def _pcr_factor(Dp, Lp, Up):
        """Distributed parallel-cyclic-reduction factorization of the
        seam block-tridiagonal system, one (2h,2h) block-row per device
        (out-of-range neighbors are identity rows, so the line system
        embeds in the ring).  Per round k (distance d=2^k) each row
        eliminates its +-d neighbors:
            alpha = -L @ Dinv_{i-d},  beta = -U @ Dinv_{i+d}
            D' = D + alpha U_{i-d} + beta L_{i+d}
            L' = alpha L_{i-d},       U' = beta U_{i+d}
        After ceil(log2(n_dev)) rounds the system is block-diagonal.
        Stores (alphas, betas, Dinv_final): O(log n_dev) blocks/device vs
        the replicated factor's O(n_dev)."""
        f32 = Dp.dtype
        eye2 = jnp.eye(Dp.shape[0], dtype=f32)
        alphas, betas = [], []
        d = 1
        for _ in range(_pcr_rounds):
            Dinv = jnp.linalg.inv(Dp)
            Dinv_l = _ring_shift(Dinv, -d, eye2)
            Dinv_r = _ring_shift(Dinv, +d, eye2)
            Ll, Ul = _ring_shift(Lp, -d, 0.0), _ring_shift(Up, -d, 0.0)
            Lr, Ur = _ring_shift(Lp, +d, 0.0), _ring_shift(Up, +d, 0.0)
            alpha = -_mm(Lp, Dinv_l)
            beta = -_mm(Up, Dinv_r)
            Dp = Dp + _mm(alpha, Ul) + _mm(beta, Lr)
            Lp = _mm(alpha, Ll)
            Up = _mm(beta, Ur)
            alphas.append(alpha)
            betas.append(beta)
            d *= 2
        return (jnp.stack(alphas), jnp.stack(betas), jnp.linalg.inv(Dp))

    def _pcr_solve(red, b):
        """RHS sweep of the stored PCR elimination + final diagonal solve."""
        alphas, betas, Dinv_fin = red
        d = 1
        for k in range(_pcr_rounds):
            bl = _ring_shift(b, -d, 0.0)
            br = _ring_shift(b, +d, 0.0)
            b = b + _mm(alphas[k], bl) + _mm(betas[k], br)
            d *= 2
        return _mm(Dinv_fin, b)

    Nq = jnp.asarray(plan.Nq)
    wq = jnp.asarray(plan.wq)

    def local_residual_ext(u_ext, up_ext, theta, cells, vols, gradN,
                           facets):
        """Element + facet assembly into the extended index space."""
        u_e = u_ext[cells]
        up_e = up_ext[cells]

        def elem(ue, upe, g, v):
            grad_u = jnp.einsum("af,ad->fd", ue, g)

            def at_q(Nq_q):
                u_q = Nq_q @ ue
                up_q = Nq_q @ upe
                fval, fgrad = form.volume(u_q, grad_u, up_q, None, theta)
                return (jnp.outer(Nq_q, fval)
                        + jnp.einsum("ad,fd->af", g, fgrad))

            contrib = jax.vmap(at_q)(Nq)
            return v * jnp.einsum("q,qaf->af", wq, contrib)

        r_e = jax.vmap(elem)(u_e, up_e, gradN, vols)
        r_ext = jnp.zeros((N_p + H, nf), u_ext.dtype)
        r_ext = r_ext.at[cells].add(r_e)

        for m, (fn_nodes, fmeas, fshape, fw) in facets.items():
            bfn = form.boundary.get(m)
            if bfn is None:
                continue
            fshape_j = np.asarray(fshape)
            fw_j = np.asarray(fw)
            u_f = u_ext[fn_nodes]

            def facet(uf, meas):
                def at_q(Nq_q):
                    g = bfn(Nq_q @ uf, None, theta)
                    return jnp.outer(Nq_q, g)
                contrib = jax.vmap(at_q)(fshape_j)
                return meas * jnp.einsum("q,qaf->af", fw_j, contrib)

            rf = jax.vmap(facet)(u_f, fmeas)
            r_ext = r_ext.at[fn_nodes].add(rf)
        return r_ext

    def local_jacobian(u_ext, up_ext, theta, cells, vols, gradN, facets):
        """Per-element Jacobian blocks in the extended space (not reduced:
        the matvec spills instead)."""
        def elem_jac(ue, upe, g, v):
            def local(uu):
                grad_u = jnp.einsum("af,ad->fd", uu, g)

                def at_q(Nq_q):
                    u_q = Nq_q @ uu
                    up_q = Nq_q @ upe
                    fval, fgrad = form.volume(u_q, grad_u, up_q, None, theta)
                    return (jnp.outer(Nq_q, fval)
                            + jnp.einsum("ad,fd->af", g, fgrad))

                contrib = jax.vmap(at_q)(Nq)
                return v * jnp.einsum("q,qaf->af", wq, contrib)

            J = jax.jacfwd(local)(ue)       # (nv, f, nv, f)
            return jnp.transpose(J, (0, 2, 1, 3))

        J_e = jax.vmap(elem_jac)(u_ext[cells], up_ext[cells], gradN, vols)

        J_f = {}
        for m, (fn_nodes, fmeas, fshape, fw) in facets.items():
            bfn = form.boundary.get(m)
            if bfn is None:
                continue
            fshape_j = np.asarray(fshape)
            fw_j = np.asarray(fw)

            def facet_jac(uf, meas):
                def local(uu):
                    def at_q(Nq_q):
                        g = bfn(Nq_q @ uu, None, theta)
                        return jnp.outer(Nq_q, g)
                    contrib = jax.vmap(at_q)(fshape_j)
                    return meas * jnp.einsum("q,qaf->af", fw_j, contrib)

                J = jax.jacfwd(local)(uf)
                return jnp.transpose(J, (0, 2, 1, 3))

            J_f[m] = jax.vmap(facet_jac)(u_ext[fn_nodes], fmeas)
        return J_e, J_f

    def make_matvec(J_e, J_f, cells, facets, ident_rows):
        """Distributed matvec with identity action on masked rows
        (Dirichlet + padding), equivalent to single-device row
        replacement."""
        def matvec(x_loc):
            x_ext = halo_gather(x_loc)
            x_e = x_ext[cells]                       # (C, nv, f)
            y_e = jnp.einsum("cabfg,cbg->caf", J_e, x_e)
            y_ext = jnp.zeros((N_p + H, nf), x_loc.dtype)
            y_ext = y_ext.at[cells].add(y_e)
            for m, Jf in J_f.items():
                fn_nodes = facets[m][0]
                x_f = x_ext[fn_nodes]
                y_f = jnp.einsum("cabfg,cbg->caf", Jf, x_f)
                y_ext = y_ext.at[fn_nodes].add(y_f)
            y = spill_reduce(y_ext)
            return jnp.where(ident_rows, x_loc, y)
        return matvec

    def diag_blocks_reduced(J_e, J_f, cells, facets, ident_rows):
        """Exact owned diagonal blocks (spill-reduced) for block-Jacobi."""
        nv = cells.shape[1]
        D_ext = jnp.zeros((N_p + H, nf, nf))
        for a in range(nv):
            D_ext = D_ext.at[cells[:, a]].add(J_e[:, a, a])
        for m, Jf in J_f.items():
            fn_nodes = facets[m][0]
            for a in range(fn_nodes.shape[1]):
                D_ext = D_ext.at[fn_nodes[:, a]].add(Jf[:, a, a])
        own, spill = D_ext[:N_p], D_ext[N_p:]
        recv = jax.lax.ppermute(spill, axis_name, bwd_perm)
        D = own.at[:H].add(recv)
        eye = jnp.eye(nf)
        D = jnp.where(ident_rows[:, :, None] & (eye[None] > 0), 1.0, D)
        D = jnp.where(ident_rows[:, :, None] & (eye[None] == 0), 0.0, D)
        return block_inv(D)

    def build_spike_prep(J_e, J_f, Dinv_blocks, ident_rows,
                         order_t, start_t, end_t, cover_t):
        """Distributed SPIKE direct factorization of the full Newton
        system (see SlabPrecondPlan): per-device f32 block-Thomas
        factorization of the owned band (elements + facets, sorted-
        segment reduction, no scatter), seam blocks exchanged one
        ppermute right, spikes by the factored local solve with h RHS
        columns, and a replicated reduced block-tridiagonal seam system
        built from one all_gather of the spike tips.  Returns the
        reusable prep tuple consumed by ``spike_apply`` — exact up to
        f32 rounding, so sharded GMRES iterations stay O(10) regardless
        of device count.  Splitting prep from apply lets refresh='step'
        /'carried' factor once per step / per refresh and reuse it
        (the distributed analogue of solve.slab.slab_prepare)."""
        S, m_v, m, h, pad = pp.S, pp.m_v, pp.m, pp.h, pp.pad
        f = nf
        f32 = jnp.float32
        ring_r = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        wlo = (m_v - pad - pp.h_v) * f     # tail interface window start

        # --- band assembly from element + facet blocks (value order
        #     matches SlabPrecondPlan.build's destination order)
        vals = [J_e.reshape(-1, f * f)]
        for mk in pp.facet_markers:
            vals.append(J_f[mk].reshape(-1, f * f))
        bsum = _segment_reduce(jnp.concatenate(vals, axis=0),
                               order_t, start_t, end_t)
        B4 = bsum.reshape(S + 1, m_v, 3 * m_v, f, f)

        # Seam exchange in RAW values (the receiver applies its own row
        # replacement and equilibration):
        # - halo-row band 0 -> right: completes the receiver's head
        #   diagonal (the last device's halo is padding, so the ring
        #   wraparound to device 0 carries zeros)
        # - halo-row band -1 -> right: C_p, the receiver's head rows
        #   coupling to THIS device's tail columns
        mid = slice(m_v, 2 * m_v)
        recv_diag = jax.lax.ppermute(B4[S, :, mid], axis_name, ring_r)
        C4 = jax.lax.ppermute(B4[S, :, :m_v], axis_name, ring_r)
        B4 = B4[:S].at[0, :, mid].add(recv_diag)

        # --- identity rows: Dirichlet + invalid + uncovered + pad gap.
        # Row-replace BEFORE equilibrating: Dinv_blocks is the inverse of
        # the ROW-REPLACED diagonal, so equilibrating the raw band would
        # mix the ORIGINAL ident rows of A (which the Krylov system
        # replaced with identity) into non-ident rows — an inconsistent
        # system (this ordering is exact to 1e-14, 3e-8 in f32).
        identp = (ident_rows | (~cover_t[:N_p])[:, None])
        if pad:
            identp = jnp.concatenate(
                [identp, jnp.ones((pad, f), bool)], axis=0)
        identp4 = identp.reshape(S, m_v, f)
        diag_onehot = np.zeros((m_v, 3 * m_v))
        diag_onehot[np.arange(m_v), m_v + np.arange(m_v)] = 1.0
        B4 = jnp.where(identp4[:, :, None, :, None], 0.0, B4)
        B4 = B4 + (identp4[:, :, None, :, None]
                   * diag_onehot[None, :, :, None, None]
                   * jnp.eye(f)[None, None, None])
        # C rows follow the receiver's own head-slab ident mask
        C4 = jnp.where(identp4[0][:, None, :, None], 0.0, C4)

        # --- block-row equilibration (keeps the f32 bands well ranged,
        #     solve.slab.slab_prepare)
        Dv = Dinv_blocks
        if pad:
            Dv = jnp.concatenate(
                [Dv, jnp.broadcast_to(jnp.eye(f), (pad, f, f))], axis=0)
        Dv = Dv.reshape(S, m_v, f, f)
        B4 = jnp.einsum("sirt,sijtg->sijrg", Dv, B4)
        C4 = jnp.einsum("irt,ijtg->ijrg", Dv[0], C4)

        B = B4.transpose(0, 1, 3, 2, 4).reshape(S, m, 3 * m).astype(f32)
        lower, diag, upper = B[:, :, :m], B[:, :, m:2 * m], B[:, :, 2 * m:]
        # the seam blocks leave the local factorization: B_p = last
        # slab's halo coupling restricted to the neighbor's head window
        # (halo width <= bandwidth = h_v); C_p's nonzero columns sit in
        # the sender's tail window [wlo, wlo+h) by the same bound
        Bp = upper[S - 1, :, :h]
        upper = upper.at[S - 1].set(0.0)
        Cm = C4.transpose(0, 2, 1, 3).reshape(m, m).astype(f32)
        Cw = Cm[:, wlo:wlo + h]
        factors = slab_factor(lower, diag, upper)

        # --- spikes: V = A^-1 [0;...;0; Bp], W = A^-1 [Cw; 0;...;0]
        V = slab_solve(factors,
                       jnp.zeros((S, m, h), f32).at[S - 1].set(Bp))
        W = slab_solve(factors,
                       jnp.zeros((S, m, h), f32).at[0].set(Cw))

        if n_dev > 1 and seam == "ring":
            # seam block-row p = [y_p ; z_{p+1}] OWNED by device p
            # (p < n_dev-1; the last device holds an identity pad row),
            # built with ONE ppermute from the right neighbor instead of
            # an all_gather, then factored by distributed parallel cyclic
            # reduction over the device ring (_pcr_factor): O(log n_dev)
            # (2h)^2 blocks per device vs the replicated O(n_dev) — the
            # seam-memory scaling wall removed
            V1, W1 = V[0, :h], W[0, :h]
            VS, WS = V[S - 1, wlo:wlo + h], W[S - 1, wlo:wlo + h]
            nbr = _ring_shift(jnp.stack([V1, W1]), +1, 0.0)
            V1r, W1r = nbr[0], nbr[1]
            idx = jax.lax.axis_index(axis_name)
            is_seam = idx < n_dev - 1
            eye2 = jnp.eye(2 * h, dtype=f32)
            Dp = eye2.at[:h, h:].set(VS).at[h:, :h].set(W1r)
            Lp = jnp.zeros((2 * h, 2 * h), f32).at[:h, :h].set(WS)
            Up = jnp.zeros((2 * h, 2 * h), f32).at[h:, h:].set(V1r)
            Dp = jnp.where(is_seam, Dp, eye2)
            Lp = jnp.where(is_seam, Lp, 0.0)
            Up = jnp.where(is_seam, Up, 0.0)
            red_factors = _pcr_factor(Dp, Lp, Up)
        elif n_dev > 1:
            # reduced block-tridiagonal seam system over interface pairs
            # U_p = [y_p ; z_{p+1}] (y = tail window of device p, z =
            # head window of device p+1), replicated from the spike tips
            V1, W1 = V[0, :h], W[0, :h]
            VS, WS = V[S - 1, wlo:wlo + h], W[S - 1, wlo:wlo + h]
            tips = jax.lax.all_gather(
                jnp.stack([V1, VS, W1, WS]), axis_name)  # (n_dev,4,h,h)
            V1g, VSg, W1g, WSg = (tips[:, 0], tips[:, 1],
                                  tips[:, 2], tips[:, 3])
            nseam = n_dev - 1
            eye_h = jnp.eye(h, dtype=f32)
            Dred = (jnp.zeros((nseam, 2 * h, 2 * h), f32)
                    .at[:, :h, :h].set(eye_h).at[:, h:, h:].set(eye_h)
                    .at[:, :h, h:].set(VSg[:-1])
                    .at[:, h:, :h].set(W1g[1:]))
            Lred = jnp.zeros((nseam, 2 * h, 2 * h), f32).at[
                :, :h, :h].set(WSg[:-1])
            Ured = jnp.zeros((nseam, 2 * h, 2 * h), f32).at[
                :, h:, h:].set(V1g[1:])
            red_factors = slab_factor(Lred, Dred, Ured)
        else:
            red_factors = None

        return (Dinv_blocks, factors, V, W, red_factors)

    def spike_apply(prep, rr):
        """One distributed SPIKE direct solve with a prepared
        factorization (see build_spike_prep)."""
        Dinv_blocks, factors, V, W, red_factors = prep
        S, m_v, m, h, pad = pp.S, pp.m_v, pp.m, pp.h, pp.pad
        f = nf
        f32 = jnp.float32
        wlo = (m_v - pad - pp.h_v) * f

        b = jnp.einsum("nfg,ng->nf", Dinv_blocks, rr)
        if pad:
            b = jnp.concatenate(
                [b, jnp.zeros((pad, f), b.dtype)], axis=0)
        g = slab_solve(factors, b.reshape(S, m).astype(f32))
        if n_dev > 1 and seam == "ring":
            # distributed PCR seam solve: rhs row p = [gS_p ; g1_{p+1}]
            # assembled with one ppermute; the elimination sweep runs
            # O(log n_dev) ppermute rounds and the final seam solution
            # stays one row per device
            idx = jax.lax.axis_index(axis_name)
            is_seam = idx < n_dev - 1
            g1r = _ring_shift(g[0, :h], +1, 0.0)
            rhs = jnp.where(is_seam,
                            jnp.concatenate([g[S - 1, wlo:wlo + h], g1r]),
                            0.0)
            Urow = _pcr_solve(red_factors, rhs)      # own [y_p ; z_{p+1}]
            y_prev = _ring_shift(Urow, -1, 0.0)[:h]  # left seam's y part
            z_next = jnp.where(is_seam, Urow[h:], 0.0)
            g = (g - jnp.einsum("smh,h->sm", W, y_prev, precision=_HI)
                 - jnp.einsum("smh,h->sm", V, z_next, precision=_HI))
        elif n_dev > 1:
            idx = jax.lax.axis_index(axis_name)
            gtips = jax.lax.all_gather(
                jnp.stack([g[S - 1, wlo:wlo + h], g[0, :h]]),
                axis_name)                           # (n_dev, 2, h)
            rhs_red = jnp.concatenate(
                [gtips[:-1, 0], gtips[1:, 1]], axis=-1)
            U = slab_solve(red_factors, rhs_red)     # (nseam, 2h)
            y_prev = jnp.where(
                idx > 0, U[jnp.maximum(idx - 1, 0), :h], 0.0)
            z_next = jnp.where(
                idx < n_dev - 1,
                U[jnp.minimum(idx, n_dev - 2), h:], 0.0)
            g = (g - jnp.einsum("smh,h->sm", W, y_prev, precision=_HI)
                 - jnp.einsum("smh,h->sm", V, z_next, precision=_HI))
        return g.reshape(S * m_v, f)[:N_p].astype(rr.dtype)

    def carry_split(J_e, J_f, prep):
        """Flatten the carried chord state (local Jacobian blocks + SPIKE
        factorization) into (per-device leaves, replicated leaves).  With
        seam='replicated' the reduced seam factorization is identical on
        every device after the all_gather and travels as the replicated
        part; with seam='ring' the PCR factors are per-device rows and
        travel with the device leaves."""
        Dinv_b, factors, V, W, red = prep
        dev = ((J_e,) + tuple(J_f[m] for m in active_markers)
               + (Dinv_b, factors.Dinv, factors.Cp, factors.Al, V, W))
        if red is None:
            rep = ()
        elif seam == "ring":
            dev = dev + tuple(red)
            rep = ()
        else:
            rep = tuple(red)
        return dev, rep

    def carry_join(dev, rep):
        J_e = dev[0]
        nfm = len(active_markers)
        J_f = {m: dev[1 + i] for i, m in enumerate(active_markers)}
        tail = dev[1 + nfm:]
        if seam == "ring" and n_dev > 1:
            Dinv_b, fD, fC, fA, V, W, ra, rb, rdf = tail
            red = (ra, rb, rdf)
        else:
            Dinv_b, fD, fC, fA, V, W = tail
            red = SlabFactors(*rep) if rep else None
        return J_e, J_f, (Dinv_b, SlabFactors(fD, fC, fA), V, W, red)

    def bicgstab_sharded(matvec, Minv_apply, b):
        # guards sized for an emulated-f64 exponent range (f32): 1e-300
        # would underflow to 0 there and produce NaN storms
        TINY = 1e-30
        guard = lambda x: jnp.where(jnp.abs(x) < TINY, TINY, x)
        x = jnp.zeros_like(b)
        r = b - matvec(x)
        rhat = r
        target = jnp.maximum(krylov_tol * pnorm(b), TINY)

        def cond(st):
            x, r, p_, v, rho, alpha, omega, it = st
            rn = pnorm(r)
            healthy = (jnp.isfinite(rn) & jnp.isfinite(rho)
                       & jnp.isfinite(omega)
                       & (jnp.abs(rho) > TINY) & (jnp.abs(omega) > TINY)
                       & (rn < 1e12))   # emulated-f64 overflow horizon
            return (rn > target) & (it < krylov_maxiter) & healthy

        def body(st):
            x, r, p_, v, rho, alpha, omega, it = st
            rho_new = pdot(rhat, r)
            beta = (rho_new / guard(rho)) * (alpha / guard(omega))
            p_ = r + beta * (p_ - omega * v)
            phat = Minv_apply(p_)
            v = matvec(phat)
            alpha = rho_new / guard(pdot(rhat, v))
            s = r - alpha * v
            shat = Minv_apply(s)
            t = matvec(shat)
            omega = pdot(t, s) / guard(pdot(t, t))
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            return (x, r, p_, v, rho_new, alpha, omega, it + 1)

        zeros = jnp.zeros_like(b)
        one = jnp.asarray(1.0, b.dtype)
        st = jax.lax.while_loop(
            cond, body,
            (x, r, zeros, zeros, one, one, one, jnp.array(0, jnp.int32)))
        return st[0], st[-1]

    def gmres_sharded(matvec, Minv_apply, b):
        """Right-preconditioned restarted GMRES (CGS2 + Givens), every
        reduction a psum — the distributed twin of solve.linear.gmres.

        BiCGStab breaks down under the f32 slab-direct preconditioner on
        the real GMPNP Jacobians (scipy BiCGStab with the identical f32
        banded apply stalls at 5e-1 relative error while GMRES converges
        to 3e-11) — the same reason the single-device
        production path polishes its f32 factorization with f64 GMRES,
        not refinement (solve/slab.py slab_direct_solve).  The Arnoldi
        basis is distributed: each device holds its (restart+1, N_p*f)
        rows; dots/norms psum over the mesh axis.
        """
        TINY = 1e-30
        nloc = b.size
        dtype = b.dtype
        shape = b.shape
        bflat = b.reshape(-1)
        mv = lambda v: matvec(v.reshape(shape)).reshape(-1)
        pc = lambda v: Minv_apply(v.reshape(shape)).reshape(-1)
        pvdot = lambda a, c: jax.lax.psum(a @ c, axis_name)
        pvnorm = lambda v: jnp.sqrt(jax.lax.psum(v @ v, axis_name))

        bnorm = pvnorm(bflat)
        target = jnp.maximum(krylov_tol * bnorm, TINY)
        m = krylov_restart

        def cycle(state):
            x, _, total_it, _ = state
            r = bflat - mv(x)
            beta = pvnorm(r)
            V = jnp.zeros((m + 1, nloc), dtype).at[0].set(
                r / jnp.maximum(beta, TINY))
            H = jnp.zeros((m + 1, m), dtype)
            cs = jnp.zeros(m, dtype)
            sn = jnp.zeros(m, dtype)
            g = jnp.zeros(m + 1, dtype).at[0].set(beta)

            def arnoldi_step(j, carry):
                V, H, cs, sn, g, done, k = carry

                def do(carry):
                    V, H, cs, sn, g, done, k = carry
                    w = mv(pc(V[j]))
                    # CGS2: rows of V beyond j are zero -> no masking
                    h1 = jax.lax.psum(V @ w, axis_name)
                    w = w - h1 @ V
                    h2 = jax.lax.psum(V @ w, axis_name)
                    w = w - h2 @ V
                    hcol = h1 + h2
                    hlast = pvnorm(w)
                    hcol = hcol.at[j + 1].set(hlast)
                    V2 = V.at[j + 1].set(w / jnp.maximum(hlast, TINY))

                    def rot(i, hc):
                        hi, hip = hc[i], hc[i + 1]
                        upd = jnp.where(
                            i < j,
                            jnp.array([cs[i] * hi + sn[i] * hip,
                                       -sn[i] * hi + cs[i] * hip]),
                            jnp.array([hi, hip]))
                        return hc.at[i].set(upd[0]).at[i + 1].set(upd[1])

                    hcol = jax.lax.fori_loop(0, m, rot, hcol)
                    denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                    c = jnp.where(denom > 0,
                                  hcol[j] / jnp.maximum(denom, TINY), 1.0)
                    s = jnp.where(denom > 0,
                                  hcol[j + 1] / jnp.maximum(denom, TINY),
                                  0.0)
                    hcol = hcol.at[j].set(
                        c * hcol[j] + s * hcol[j + 1]).at[j + 1].set(0.0)
                    cs2 = cs.at[j].set(c)
                    sn2 = sn.at[j].set(s)
                    gj = g[j]
                    g2 = g.at[j].set(c * gj).at[j + 1].set(-s * gj)
                    H2 = H.at[:, j].set(hcol[:m + 1])
                    done2 = jnp.abs(g2[j + 1]) <= target
                    return (V2, H2, cs2, sn2, g2, done2, k + 1)

                return jax.lax.cond(done, lambda c: c, do,
                                    (V, H, cs, sn, g, done, k))

            V, H, cs, sn, g, done, k = jax.lax.fori_loop(
                0, m, arnoldi_step,
                (V, H, cs, sn, g, beta <= target, jnp.array(0, jnp.int32)))

            # back-substitute H[:k,:k] y = g[:k]; k is traced -> identity-
            # pad the unused rows/cols (replicated small dense work)
            used = jnp.arange(m) < k
            Hsq = jnp.where(used[None, :] & used[:, None], H[:m, :m],
                            jnp.eye(m, dtype=dtype))
            gv = jnp.where(used, g[:m], 0.0)

            def back(i, y):
                i = m - 1 - i
                yi = (gv[i] - Hsq[i] @ y) / Hsq[i, i]
                return y.at[i].set(yi)

            y = jax.lax.fori_loop(0, m, back, jnp.zeros(m, dtype))
            x_new = x + pc(V[:m].T @ y)
            rnorm = pvnorm(bflat - mv(x_new))
            return (x_new, rnorm, total_it + k, rnorm <= target)

        def cond(state):
            _, rnorm, total_it, conv = state
            return (~conv) & (total_it < krylov_maxiter) & jnp.isfinite(rnorm)

        # init rnorm = bnorm (NOT inf: the isfinite health guard in cond
        # must not reject the first cycle)
        init = (jnp.zeros(nloc, dtype), bnorm,
                jnp.array(0, jnp.int32), jnp.asarray(False))
        x, rnorm, iters, conv = jax.lax.while_loop(cond, cycle, init)
        return x.reshape(shape), iters

    def step_local(u_loc, up_loc, theta, cells, vols, gradN, bc_mask,
                   bc_vals, valid, *rest):
        # rebuild the facets dict from flattened per-marker arrays
        facets = {}
        it = iter(rest)
        for m, (_, _, fshape, fw) in sorted(plan.facets.items()):
            fn = next(it)
            fm = next(it)
            facets[m] = (fn, fm, fshape, fw)
        if pp is not None:
            (order_t, start_t, end_t, cover_t) = (
                next(it), next(it), next(it), next(it))
        # per-step Dirichlet VALUE updates as arithmetic lifts (traced
        # theta scalars; no scatter/select touches them).  The barrier
        # keeps XLA from fusing the blend into downstream kernels (see
        # fem.dirichlet.ArithDirichletBC.set_value_arith)
        for key in lift_keys:
            oh = next(it)
            bc_vals = jax.lax.optimization_barrier(
                bc_vals * (1.0 - oh) + theta[key] * oh)
        if refresh == "carried":
            # carried chord state: appended as two pytree args (per-
            # device leaves, replicated seam factorization)
            carry_dev, carry_rep = next(it), next(it)

        ident_rows = bc_mask | (~valid)[:, None]

        def residual(u_loc):
            u_ext = halo_gather(u_loc)
            up_ext = halo_gather(up_loc)
            r = spill_reduce(local_residual_ext(
                u_ext, up_ext, theta, cells, vols, gradN, facets))
            r = jnp.where(bc_mask, u_loc - bc_vals, r)
            return jnp.where(valid[:, None], r, 0.0)

        u0 = jnp.where(bc_mask, bc_vals, u_loc)

        def run_newton(u_init, solve_of=None, solve_fixed=None,
                       max_iter=newton_max_iter):
            """Damped Newton from ``u_init`` with DOLFIN-parity
            acceptance against u_init's own entry residual
            (rn < atol OR rn < rtol * n0)."""
            r0l = residual(u_init)
            n0l = pnorm(r0l)

            def convl(rn):
                return (rn < newton_atol) | (rn < newton_rtol * n0l)

            def condl(st):
                u, r, rn, itn, lin = st
                return (~convl(rn)) & (itn < max_iter)

            def bodyl(st):
                u, r, rn, itn, lin = st
                solve = (solve_fixed if solve_fixed is not None
                         else solve_of(u))
                du, klin = solve(r)
                u = u - relaxation * du
                r = residual(u)
                return (u, r, pnorm(r), itn + 1, lin + klin)

            u, r, rn, itn, lin = jax.lax.while_loop(
                condl, bodyl,
                (u_init, r0l, n0l, jnp.array(0, jnp.int32),
                 jnp.array(0, jnp.int32)))
            return u, rn, itn, lin, convl(rn)

        def linear_solve_at(u):
            """Assemble the local Jacobian at ``u`` and return the sharded
            linear solver r -> (du, krylov_iters)."""
            u_ext = halo_gather(u)
            up_ext = halo_gather(up_loc)
            J_e, J_f = local_jacobian(
                u_ext, up_ext, theta, cells, vols, gradN, facets)
            mv = make_matvec(J_e, J_f, cells, facets, ident_rows)
            Minv = diag_blocks_reduced(J_e, J_f, cells, facets, ident_rows)
            if pp is not None:
                prep = build_spike_prep(
                    J_e, J_f, Minv, ident_rows, order_t, start_t, end_t,
                    cover_t)
                # f64 GMRES over the f32 SPIKE direct apply — BiCGStab
                # breaks down under an f32-quality preconditioner on
                # these Jacobians (see gmres_sharded docstring)
                return lambda rr: gmres_sharded(
                    mv, lambda r2: spike_apply(prep, r2), rr)
            Minv_apply = lambda rr: jnp.einsum("nfg,ng->nf", Minv, rr)
            return lambda rr: bicgstab_sharded(mv, Minv_apply, rr)

        if refresh != "carried":
            # refresh='step': one Jacobian assembly + SPIKE factorization
            # at the step's start iterate, reused by every Newton
            # iteration (modified/chord Newton — the distributed analogue
            # of LinearConfig.refresh='step'; convergence is still
            # certified on the true residual).  XLA hoists the frozen
            # factors out of the while_loop as loop constants.
            if refresh == "step":
                u, rn, iters, lin, conv = run_newton(
                    u0, solve_fixed=linear_solve_at(u0))
            else:
                u, rn, iters, lin, conv = run_newton(
                    u0, solve_of=linear_solve_at)
            return u, (iters, conv, rn, lin)

        # ---- refresh='carried': the distributed carried-factor chord
        # Newton (solve.timeloop.make_carried_step semantics).  The chord
        # attempt runs against the CARRIED Jacobian + SPIKE factorization
        # (u_loc may be a predictor-extrapolated start — the transient
        # passes it; u0 projects it onto the Dirichlet values); on non-
        # convergence the step re-solves with exact Newton from the SAFE
        # previous state and refreshes the carry at the accepted state.
        # Both lax.cond predicates are psum-reduced norms — replicated,
        # so every device takes the same branch and the collectives
        # inside the branches stay coherent.
        J_e_c, J_f_c, prep_c = carry_join(carry_dev, carry_rep)
        mv_c = make_matvec(J_e_c, J_f_c, cells, facets, ident_rows)
        u1, rn1, it1, lin1, conv1 = run_newton(
            u0,
            solve_fixed=lambda rr: gmres_sharded(
                mv_c, lambda r2: spike_apply(prep_c, r2), rr),
            max_iter=min(chord_max_iter, newton_max_iter))

        u0_safe = jnp.where(bc_mask, bc_vals, up_loc)

        def build_carry_at(u):
            u_ext = halo_gather(u)
            up_ext = halo_gather(up_loc)
            J_e2, J_f2 = local_jacobian(u_ext, up_ext, theta, cells,
                                        vols, gradN, facets)
            Dinv2 = diag_blocks_reduced(J_e2, J_f2, cells, facets,
                                        ident_rows)
            prep2 = build_spike_prep(J_e2, J_f2, Dinv2, ident_rows,
                                     order_t, start_t, end_t, cover_t)
            return carry_split(J_e2, J_f2, prep2)

        def fresh(_):
            u2, rn2, it2, lin2, conv2 = run_newton(
                u0_safe, solve_of=linear_solve_at)
            return (u2, rn2, it2, lin2, conv2, build_carry_at(u2))

        def keep(_):
            return (u1, rn1, it1, lin1, conv1, (carry_dev, carry_rep))

        u, rn, iters, lin, conv, carry_used = jax.lax.cond(
            ~conv1, fresh, keep, None)

        # proactive refresh for the NEXT step when the stale factor made
        # this (converged) step slow; the fresh branch already refreshed
        slow = conv1 & (it1 > refresh_iters)
        carry_new = jax.lax.cond(
            slow, lambda _: build_carry_at(u), lambda _: carry_used, None)
        return u, (iters, conv, rn, lin), carry_new

    rest_flat = []
    rest_specs = []
    for m, (fn, fm, fshape, fw) in sorted(plan.facets.items()):
        rest_flat += [np.asarray(fn), np.asarray(fm)]
        rest_specs += [P(axis_name), P(axis_name)]
    if pp is not None:
        rest_flat += [pp.order, pp.start, pp.end, pp.cover]
        rest_specs += [P(axis_name)] * 4
    for oh, _key in bc_lifts:
        oh = np.asarray(oh, np.float64)
        assert oh.shape == (n_dev * N_p, nf), (
            f"bc_lift onehot must be padded to ({n_dev * N_p}, {nf})")
        rest_flat.append(oh.reshape(n_dev, N_p, nf))
        rest_specs.append(P(axis_name))

    base_in_specs = (P(axis_name), P(axis_name), P(), P(axis_name),
                     P(axis_name), P(axis_name), P(axis_name),
                     P(axis_name), P(axis_name), *rest_specs)
    if refresh == "carried":
        # carry: (per-device leaves, replicated seam factorization)
        sharded = jax.shard_map(
            step_local,
            mesh=dev_mesh,
            in_specs=base_in_specs + (P(axis_name), P()),
            out_specs=(P(axis_name), (P(), P(), P(), P()),
                       (P(axis_name), P())),
            check_vma=False,
        )

        def prep_local(u_loc, up_loc, theta, cells, vols, gradN, bc_mask,
                       bc_vals, valid, *rest):
            """Assemble + factor the chord state at the (projected)
            start state — the distributed prep_init."""
            facets = {}
            it = iter(rest)
            for m, (_, _, fshape, fw) in sorted(plan.facets.items()):
                fn = next(it)
                fm = next(it)
                facets[m] = (fn, fm, fshape, fw)
            (order_t, start_t, end_t, cover_t) = (
                next(it), next(it), next(it), next(it))
            for key in lift_keys:
                oh = next(it)
                bc_vals = jax.lax.optimization_barrier(
                    bc_vals * (1.0 - oh) + theta[key] * oh)
            ident_rows = bc_mask | (~valid)[:, None]
            u0 = jnp.where(bc_mask, bc_vals, u_loc)
            u_ext = halo_gather(u0)
            up_ext = halo_gather(up_loc)
            J_e, J_f = local_jacobian(u_ext, up_ext, theta, cells, vols,
                                      gradN, facets)
            Dinv = diag_blocks_reduced(J_e, J_f, cells, facets, ident_rows)
            prep = build_spike_prep(J_e, J_f, Dinv, ident_rows,
                                    order_t, start_t, end_t, cover_t)
            return carry_split(J_e, J_f, prep)

        prep_sharded = jax.shard_map(
            prep_local,
            mesh=dev_mesh,
            in_specs=base_in_specs,
            out_specs=(P(axis_name), P()),
            check_vma=False,
        )
    else:
        sharded = jax.shard_map(
            step_local,
            mesh=dev_mesh,
            in_specs=base_in_specs,
            out_specs=(P(axis_name), (P(), P(), P(), P())),
            check_vma=False,
        )

    cells_flat = np.asarray(plan.cells_l).reshape(n_dev * plan.cells_l.shape[1], -1)
    vols_flat = np.asarray(plan.vols).reshape(-1)
    gradN_flat = np.asarray(plan.gradN).reshape(
        (n_dev * plan.gradN.shape[1],) + plan.gradN.shape[2:])
    bc_mask_flat = np.asarray(plan.bc_mask).reshape(n_dev * N_p, nf)
    bc_vals_flat = np.asarray(plan.bc_vals).reshape(n_dev * N_p, nf)
    valid_flat = np.asarray(plan.valid).reshape(n_dev * N_p)
    rest_flat = [a.reshape((-1,) + tuple(a.shape[2:])) for a in rest_flat]

    if refresh == "carried":
        def step(u_shard, up_shard, theta, carry):
            return sharded(u_shard, up_shard, theta, cells_flat,
                           vols_flat, gradN_flat, bc_mask_flat,
                           bc_vals_flat, valid_flat, *rest_flat,
                           carry[0], carry[1])

        def prep_init(u_shard, up_shard, theta):
            return prep_sharded(u_shard, up_shard, theta, cells_flat,
                                vols_flat, gradN_flat, bc_mask_flat,
                                bc_vals_flat, valid_flat, *rest_flat)

        if jit:
            step = jax.jit(step)
            prep_init = jax.jit(prep_init)
        return step, prep_init, dev_mesh, u_sharding

    def step(u_shard, up_shard, theta):
        return sharded(u_shard, up_shard, theta, cells_flat, vols_flat,
                       gradN_flat, bc_mask_flat, bc_vals_flat, valid_flat,
                       *rest_flat)

    if jit:
        step = jax.jit(step)
    return step, dev_mesh, u_sharding


def make_sharded_transient(
    plan: ZShardPlan,
    form: WeakForm,
    mesh_devices,
    n_steps: int,
    theta_of_carry: Optional[Callable] = None,
    theta: Optional[dict] = None,
    record_stride: Optional[int] = None,
    **step_kwargs,
):
    """Multi-step sharded transient: ``lax.scan`` of the sharded implicit
    step, the whole transient one jit-compiled SPMD program.

    theta_of_carry(carry, i) -> theta computes per-step traced scalars
    from the GLOBAL (sharded) solution array — e.g. the Sechenov CO2
    Dirichlet value from solution medians — mirroring the single-device
    run_transient protocol; pass a static ``theta`` instead for frozen
    coefficients.  Per-step Dirichlet value updates enter via
    ``bc_lifts`` (see make_sharded_step).

    Returns (run, dev_mesh, u_sharding) with
    ``run(u0_sharded) -> ((u_final, extra), stats_stacked)``.

    ``record_stride=k`` additionally records the (sharded, plan-order)
    solution every k-th step — the distributed form of run_transient's
    bounded-history recording (nested scan: the device history buffer is
    n_steps/k rows, never n_steps; requires k | n_steps).  The return
    becomes ``((u_final, extra), (u_hist, stats_strided))`` with u_hist
    of shape (n_steps//k, n_dev*N_p, f); like the single-device driver,
    the stats ys are then also every k-th step's.

    ``max_retries=K`` (default 0) adds divergence-triggered dt halving —
    the distributed form of timeloop.make_retrying_step (SURVEY §5: the
    reference has no recovery; a diverged Newton kills the run).  A
    non-converged step is retried from the SAFE previous state with
    ``theta['dt']`` halved, up to K times; the per-step stats tuple gains
    a fifth element ``dt_scale`` (the accepted halving factor — callers
    tracking absolute time must accumulate dt*dt_scale).  The convergence
    flag driving the retry loop is a psum-reduced (replicated) scalar, so
    every device takes the same branch and the collectives inside the
    retried step stay coherent.
    """
    refresh = step_kwargs.get("refresh", "iter")
    chord_predict = step_kwargs.pop("chord_predict", True)
    max_retries = step_kwargs.pop("max_retries", 0)
    if record_stride is not None:
        if record_stride < 1:
            raise ValueError(f"record_stride must be >= 1, got "
                             f"{record_stride}")
        if n_steps % record_stride:
            raise ValueError(f"record_stride {record_stride} must divide "
                             f"n_steps {n_steps}")

    def _scan_steps(body, carry0, u_of):
        """scan ``body(c, i) -> (c_new, stats)`` over n_steps; with
        record_stride, emit (u_of(c), stats) every k-th step via the
        nested-scan bounded-history pattern (solve.timeloop.run_transient)."""
        k = record_stride
        if k is None:
            return jax.lax.scan(body, carry0, jnp.arange(n_steps))
        if k == 1:
            def body_rec(c, i):
                c2, st = body(c, i)
                return c2, (u_of(c2), st)
            return jax.lax.scan(body_rec, carry0, jnp.arange(n_steps))

        def outer(c, j):
            def inner(ci, jj):
                c2, _ = body(ci, j * k + jj)
                return c2, None

            c2, _ = jax.lax.scan(inner, c, jnp.arange(k - 1))
            c3, st = body(c2, j * k + (k - 1))
            return c3, (u_of(c3), st)

        return jax.lax.scan(outer, carry0, jnp.arange(n_steps // k))

    if theta_of_carry is None:
        _theta = dict(theta or {})
        theta_of_carry = lambda carry, i: _theta

    if refresh == "carried":
        # distributed carried-factor chord Newton: the local Jacobian
        # blocks + SPIKE factorization ride the scan carry (refreshed
        # lazily inside the step), and the decay-aware predictor of
        # solve.timeloop.make_carried_step runs at the jit level — the
        # extrapolated start is plain sharded arithmetic, XLA inserts
        # the psum for the norm.
        step_raw, prep_init, dev_mesh, u_sharding = make_sharded_step(
            plan, form, mesh_devices, jit=False, **step_kwargs)

        def _dt_of(th):
            if isinstance(th, dict) and "dt" in th:
                return jnp.asarray(th["dt"], jnp.float64)
            return jnp.asarray(1.0, jnp.float64)

        def run(u0_shard, extra0=0.0, step_offset=0):
            # extra0/step_offset are traced: chunked checkpoint resume
            # (models/pore_3d._run_sharded) passes the restored carry
            # scalar and the absolute step index so theta (dt staging,
            # controllers) sees the same values as an unchunked run —
            # mirroring run_transient_checkpointed —
            # without recompiling per chunk.
            off = jnp.asarray(step_offset)
            ex0 = jnp.asarray(extra0, jnp.float64)
            th0 = theta_of_carry((u0_shard, ex0), off)
            chord0 = prep_init(u0_shard, u0_shard, th0)
            zero = jnp.asarray(0.0, jnp.float64)

            def body(c, i):
                u, extra, chord, du, dt_prev, nrm_prev = c
                th = theta_of_carry((u, extra), i + off)
                nrm_du = jnp.linalg.norm(du)
                if chord_predict:
                    # rho = observed increment decay (see timeloop.
                    # ChordCarry: raw extrapolation overshoots settling
                    # transients); du = 0 at init predicts u itself
                    rho = jnp.where(
                        nrm_prev > 0,
                        nrm_du / jnp.maximum(nrm_prev, 1e-300), 0.0)
                    ratio = jnp.where(dt_prev > 0,
                                      _dt_of(th) / dt_prev, 0.0)
                    factor = jnp.clip(rho * ratio, 0.0, 1.5)
                    u_start = u + factor * du
                else:
                    u_start = u
                u_new, stats, chord = step_raw(u_start, u, th, chord)
                if max_retries > 0:
                    dt0 = _dt_of(th)

                    def cond(s):
                        k, _, st, _ = s
                        return (~st[1]) & (k < max_retries)

                    def retry(s):
                        k, _u, _st, ch = s
                        th_k = dict(th)
                        th_k["dt"] = dt0 * (0.5 ** (k + 1).astype(dt0.dtype))
                        # retry from the safe previous state, no
                        # predictor.  The chord carry is REBUILT at the
                        # halved dt first: the carried factorization
                        # embeds dt, so a chord attempt against the
                        # un-halved factor is near-guaranteed to miss
                        # and would waste a full chord solve before the
                        # exact fallback
                        ch_k = prep_init(u, u, th_k)
                        u2, st2, ch2 = step_raw(u, u, th_k, ch_k)
                        return (k + 1, u2, st2, ch2)

                    k, u_new, stats, chord = jax.lax.while_loop(
                        cond, retry,
                        (jnp.asarray(0), u_new, stats, chord))
                    stats = (*stats, 0.5 ** k.astype(dt0.dtype))
                return ((u_new, extra, chord, u_new - u, _dt_of(th),
                         nrm_du), stats)

            (u_fin, extra, _, _, _, _), ys = _scan_steps(
                body,
                (u0_shard, ex0, chord0,
                 jnp.zeros_like(u0_shard), zero, zero),
                u_of=lambda c: c[0])
            return (u_fin, extra), ys

        return jax.jit(run), dev_mesh, u_sharding

    step_raw, dev_mesh, u_sharding = make_sharded_step(
        plan, form, mesh_devices, jit=False, **step_kwargs)

    def _dt_of(th):
        if isinstance(th, dict) and "dt" in th:
            return jnp.asarray(th["dt"], jnp.float64)
        return jnp.asarray(1.0, jnp.float64)

    def run(u0_shard, extra0=0.0, step_offset=0):
        off = jnp.asarray(step_offset)

        def body(carry, i):
            u, extra = carry
            th = theta_of_carry((u, extra), i + off)
            u_new, stats = step_raw(u, u, th)
            if max_retries > 0:
                dt0 = _dt_of(th)

                def cond(s):
                    k, _, st = s
                    return (~st[1]) & (k < max_retries)

                def retry(s):
                    k, _u, _st = s
                    th_k = dict(th)
                    th_k["dt"] = dt0 * (0.5 ** (k + 1).astype(dt0.dtype))
                    u2, st2 = step_raw(u, u, th_k)
                    return (k + 1, u2, st2)

                k, u_new, stats = jax.lax.while_loop(
                    cond, retry, (jnp.asarray(0), u_new, stats))
                stats = (*stats, 0.5 ** k.astype(dt0.dtype))
            return (u_new, extra), stats

        return _scan_steps(body,
                           (u0_shard, jnp.asarray(extra0, jnp.float64)),
                           u_of=lambda c: c[0])

    return jax.jit(run), dev_mesh, u_sharding


def make_sharded_pore_transient(
    prog,
    mesh_devices,
    n_steps: Optional[int] = None,
    **kwargs,
):
    """Production sharded 3D pore transient from a built Pore3DProgram:
    z-slab domain decomposition + per-device slab-direct preconditioning +
    the moving Sechenov CO2 Dirichlet BC as an arithmetic lift.

    Returns (run, u0_sharded, plan) with ``run(u0) -> ((u_final, _),
    stats)``; ``u_final`` is (N, f) in the ORIGINAL mesh vertex order
    (the plan z-sorts shipped meshes internally; ``run`` globalizes the
    final state back).  With ``record_stride=k`` the stats ys become
    ``(u_hist, stats)`` where u_hist is (n_steps//k, N, f) host-side
    history in the original vertex order (globalized row by row after
    the fetch — the device buffer stays in plan order).
    """
    cfg = prog.config
    nf = cfg.n_fields
    ns = len(cfg.species)
    N = prog.space.num_vertices
    n_dev = len(mesh_devices)
    n = prog.num_steps if n_steps is None else n_steps

    mask = np.asarray(prog.bc.mask)
    vals = np.asarray(prog.bc.values)
    plan = ZShardPlan.build(prog.mesh, nf, n_dev, mask, vals,
                            quad_degree=cfg.quad_degree)

    oh = np.zeros((N, nf))
    oh[prog.s1_verts, prog.idx["CO2"]] = 1.0
    oh = plan.localize(oh)

    def theta_of_carry(carry, i):
        # u[:N] holds every true vertex (padding rows are the tail of the
        # last device); the Sechenov update only takes per-field medians,
        # which are permutation-invariant, so plan order is fine
        u, _ = carry
        return prog._theta_of_carry((u[:N], None), i)

    kwargs.setdefault("relaxation", cfg.newton.relaxation)
    kwargs.setdefault("newton_max_iter", cfg.newton.max_iter)
    kwargs.setdefault("newton_rtol", cfg.newton.rtol)
    kwargs.setdefault("newton_atol", cfg.newton.atol)
    run_pad, dev_mesh, u_sharding = make_sharded_transient(
        plan, prog.form, mesh_devices, n,
        theta_of_carry=theta_of_carry,
        bc_lifts=[(oh, "co2_s1")],
        **kwargs)

    u0 = np.ones((N, nf))
    if cfg.physics == "GMPNP":
        u0[:, ns] = 0.0
    u0 = jax.device_put(jnp.asarray(plan.localize(u0)), u_sharding)

    def run(u0_sharded, extra0=0.0, step_offset=0):
        (u_fin, extra), ys = run_pad(u0_sharded, extra0, step_offset)
        if kwargs.get("record_stride") is not None:
            u_hist_pad, stats = ys
            u_hist = np.stack([plan.globalize(r)
                               for r in np.asarray(u_hist_pad)])
            ys = (u_hist, stats)
        return (jnp.asarray(plan.globalize(u_fin)), extra), ys

    return run, u0, plan
