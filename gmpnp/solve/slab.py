"""Z-slab block-banded direct solver — the MUMPS replacement.

The reference solves every 3D Newton linear system with the MUMPS sparse
direct solver (3D/MPNP_CO2ER_pore.py:787-799).  Preconditioned BiCGStab
*converges* on these systems but needs O(10^3) Krylov iterations per
Newton step on the coupled 9-field systems (condition ~1e6) — thousands
of latency-bound sparse matvecs.  This module is the direct answer:

- vertices are ordered along the pore axis (z); for a P1 tet mesh the
  adjacency bandwidth under that ordering is a couple of mesh layers
  (measured: 171 of 3679 vertices for the shipped L_50_R_5.xml), so with
  uniform contiguous slabs of ``m_v >= bandwidth`` vertices the coupled
  system is *block tridiagonal* in (m_v * n_fields)-sized dense blocks;
- the BlockELL Jacobian is relaid into those dense bands by one static
  pure-gather (no scatter);
- the block-tridiagonal system is factored by a block-Thomas
  forward-elimination ``lax.scan`` whose per-slab work is m x m matmuls
  and one m x m inverse;
- factorization runs in float32 on a block-row-equilibrated system, and
  the solution is polished back to f64 accuracy by GMRES against the f64
  BlockELL matvec, preconditioned by the f32 factorization.

This is the mixed-precision direct-solver recipe of production sparse
solvers (f32 factorization + f64 refinement): dense batched matmuls,
static shapes, one sequential scan of length S ~ 20-30.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gmpnp.fem.assembly import BlockELL
from gmpnp.solve.smallblock import block_inv

# All slab-path matmuls run at HIGHEST precision, and every m x m inverse
# gets one Newton-Schulz refinement pass.  A float32 dot at default
# precision may run in TF32 on a GPU (about three decimal digits), and
# the elimination recurrence compounds that per-level error over 2S scan
# steps, so the factor/solve sweeps request full-f32 matmuls explicitly.
# One Newton-Schulz step X <- X(2I - AX) squares the inverse's residual.
_HI = jax.lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=_HI)


def _inv_refined(A: jnp.ndarray, steps: int = 1) -> jnp.ndarray:
    """Batched (..., m, m) inverse: jnp.linalg.inv + Newton-Schulz."""
    X = jnp.linalg.inv(A)
    eye = jnp.eye(A.shape[-1], dtype=A.dtype)
    for _ in range(steps):
        X = _mm(X, 2.0 * eye - _mm(A, X))
    return X


@dataclass(frozen=True)
class SlabPlan:
    """Host-side static tables for the slab relayout.

    perm[new] = old vertex id (ascending z); the padded tail maps to a
    sentinel row.  ``gidx`` maps every entry of the dense band tensor
    (S, m, 3m) to an element of the flattened (padded) BlockELL value
    array, or to the trailing zero sentinel.
    """

    S: int                  # number of slabs
    m_v: int                # vertices per slab
    f: int                  # fields per vertex
    N: int                  # true vertex count
    bandwidth: int          # adjacency bandwidth under the ordering
    perm: np.ndarray        # (S*m_v,) old vertex id per new position (pad: N)
    iperm: np.ndarray       # (N,) new position per old vertex id
    # block-level gather map: band block (s, i, j3) <- ELL block n*K + k
    # (sentinel N*K -> zero block).  Block granularity keeps the table at
    # ~(S*m_v*3*m_v)*4 bytes — f*f=81x smaller than a scalar-level map,
    # small enough to embed as a program constant.
    bidx: np.ndarray        # (S, m_v, 3*m_v) int32
    pad_eye: Tuple[np.ndarray, np.ndarray, np.ndarray]  # identity rows (s,i,j)

    @property
    def m(self) -> int:
        return self.m_v * self.f

    @staticmethod
    def build(adj: np.ndarray, order_coord: np.ndarray, n_fields: int,
              diag_slot: np.ndarray,
              max_slabs: Optional[int] = None) -> "SlabPlan":
        """adj: (N, K) padded sorted neighbor table (fem.FemSpace.adj);
        order_coord: (N,) coordinate to sort by (z for the pore, x for 1D);
        diag_slot: (N,) position of the self entry in each adjacency row."""
        adj = np.asarray(adj)
        N, K = adj.shape
        f = n_fields

        perm_n = np.argsort(np.asarray(order_coord), kind="stable")
        iperm = np.empty(N, dtype=np.int64)
        iperm[perm_n] = np.arange(N)

        bw = int(np.abs(iperm[adj] - iperm[np.arange(N)][:, None]).max())
        m_v = max(bw, 1)
        if max_slabs is not None:
            m_v = max(m_v, -(-N // max_slabs))
        S = max(-(-N // m_v), 1)
        # even out slab sizes — but never below the bandwidth, or in-band
        # couplings would be silently dropped by the |band|<=1 filter
        # below
        m_v = max(-(-N // S), bw, 1)
        S = -(-N // m_v)
        N_pad = S * m_v
        m = m_v * f

        perm = np.concatenate(
            [perm_n, np.full(N_pad - N, N, dtype=np.int64)])

        # --- block gather map: band block (s, i, (b+1)*m_v + pj) <- ELL
        #     block n*K + k for n = perm[s*m_v+i], j = adj[n, k],
        #     b = slab(j) - s, pj = pos(j) in its slab.
        bidx = np.full((S, m_v, 3 * m_v), N * K, dtype=np.int64)
        nn = np.arange(N)
        s_of = iperm // m_v            # (N,)
        p_of = iperm % m_v
        diag_slot = np.asarray(diag_slot)
        for k in range(K):
            nj = adj[:, k]
            # skip padded duplicate self-slots (zero blocks aliasing the
            # diagonal): only the true diag_slot entry carries the diagonal
            keep = (nj != nn) | (k == diag_slot)
            band = s_of[nj] - s_of
            keep &= np.abs(band) <= 1   # guaranteed by m_v >= bw
            idx = np.nonzero(keep)[0]
            if len(idx) == 0:
                continue
            bidx[s_of[idx], p_of[idx],
                 (band[idx] + 1) * m_v + p_of[nj[idx]]] = idx * K + k

        # identity rows for the padded tail
        pad_pos = np.arange(N, N_pad)
        ps = pad_pos // m_v
        pi = (pad_pos % m_v)[:, None] * f + np.arange(f)[None, :]
        ps = np.repeat(ps, f)
        pi = pi.reshape(-1)
        pj = m + pi  # diagonal band, same in-block index

        return SlabPlan(
            S=S, m_v=m_v, f=f, N=N, bandwidth=bw,
            perm=perm, iperm=iperm,
            bidx=bidx.astype(np.int32),
            pad_eye=(ps.astype(np.int32), pi.astype(np.int32),
                     pj.astype(np.int32)))

    # -- vector relayout ---------------------------------------------------

    def to_slabs(self, x: jnp.ndarray) -> jnp.ndarray:
        """(N, f) -> (S, m) in slab ordering (padded tail = 0)."""
        xp = jnp.concatenate(
            [x, jnp.zeros((1, self.f), x.dtype)], axis=0)    # sentinel row
        return xp[self.perm].reshape(self.S, self.m)

    def from_slabs(self, xs: jnp.ndarray) -> jnp.ndarray:
        """(S, m) -> (N, f) in original vertex ordering."""
        flat = xs.reshape(self.S * self.m_v, self.f)
        return flat[self.iperm]

    def bands(self, ell: BlockELL, dtype=jnp.float32) -> Tuple[jnp.ndarray,
                                                               jnp.ndarray,
                                                               jnp.ndarray]:
        """Relayout a BlockELL matrix into (lower, diag, upper) dense bands
        of shape (S, m, m) each, in ``dtype`` — one block-level pure gather
        followed by a dense transpose (no scatter)."""
        N, K, f, _ = ell.shape4
        blk = ell.blocks4().astype(dtype).reshape(N * K, f, f)
        blk = jnp.concatenate([blk, jnp.zeros((1, f, f), dtype)], axis=0)
        B4 = blk[self.bidx]                       # (S, m_v, 3m_v, f, f)
        m = self.m
        B = B4.transpose(0, 1, 3, 2, 4).reshape(self.S, m, 3 * m)
        ps, pi, pj = self.pad_eye
        if len(ps):
            B = B.at[ps, pi, pj].set(1.0)
        return B[:, :, :m], B[:, :, m:2 * m], B[:, :, 2 * m:]


class SlabFactors(NamedTuple):
    Dinv: jnp.ndarray   # (S, m, m) inverses of the eliminated diagonals
    Cp: jnp.ndarray     # (S, m, m) Dinv @ upper
    Al: jnp.ndarray     # (S, m, m) original lower band


def _band_of_slab_fn(ell: BlockELL, plan: SlabPlan, dtype=jnp.float32):
    """Closure s -> (lower, diag, upper) bands of slab ``s``, each (m, m).

    Gathering per slab (instead of materializing the full
    (S, m_v, 3m_v, f, f) band tensor up front) keeps the peak temporary
    at one slab's bands per lane, which matters for vmapped sweeps."""
    N, K, f, _ = ell.shape4
    m, m_v = plan.m, plan.m_v
    blk = ell.blocks4().astype(dtype).reshape(N * K, f, f)
    blk = jnp.concatenate([blk, jnp.zeros((1, f, f), dtype)], axis=0)
    bidx = jnp.asarray(plan.bidx)                 # (S, m_v, 3m_v) int32
    # identity rows (diagonal band) for the padded tail of the last slab
    eye_band = jnp.concatenate(
        [jnp.zeros((m, m), dtype), jnp.eye(m, dtype=dtype),
         jnp.zeros((m, m), dtype)], axis=1)       # (m, 3m)

    def band_of_slab(s):
        B4 = blk[bidx[s]]                         # (m_v, 3m_v, f, f)
        B = B4.transpose(0, 2, 1, 3).reshape(m, 3 * m)
        row_v = s * m_v + jnp.arange(m_v, dtype=jnp.int32)
        is_pad = jnp.repeat(row_v >= plan.N, f)   # (m,)
        B = jnp.where(is_pad[:, None], eye_band, B)
        return B[:, :m], B[:, m:2 * m], B[:, 2 * m:]

    return band_of_slab


def slab_factor_fused(ell: BlockELL, plan: SlabPlan,
                      dtype=jnp.float32) -> SlabFactors:
    """Band relayout fused into the block-Thomas elimination scan (see
    ``_band_of_slab_fn`` for why the gather happens per scan step)."""
    m, S = plan.m, plan.S
    band_of_slab = _band_of_slab_fn(ell, plan, dtype)

    def fwd(Cp_prev, s):
        A, Bd, C = band_of_slab(s)
        denom = Bd - _mm(A, Cp_prev)
        Dinv = _inv_refined(denom)
        Cp = _mm(Dinv, C)
        return Cp, (Dinv, Cp, A)

    _, (Dinvs, Cps, Als) = jax.lax.scan(
        fwd, jnp.zeros((m, m), dtype), jnp.arange(S, dtype=jnp.int32))
    return SlabFactors(Dinv=Dinvs, Cp=Cps, Al=Als)


def slab_factor(lower: jnp.ndarray, diag: jnp.ndarray,
                upper: jnp.ndarray) -> SlabFactors:
    """Block-Thomas forward elimination: one lax.scan over slabs, each step
    two m x m matmuls + one m x m inverse."""
    m = diag.shape[1]
    dtype = diag.dtype

    def fwd(Cp_prev, inp):
        A, B, C = inp
        denom = B - _mm(A, Cp_prev)
        Dinv = _inv_refined(denom)
        Cp = _mm(Dinv, C)
        return Cp, (Dinv, Cp)

    _, (Dinvs, Cps) = jax.lax.scan(
        fwd, jnp.zeros((m, m), dtype), (lower, diag, upper))
    return SlabFactors(Dinv=Dinvs, Cp=Cps, Al=lower)


def slab_solve(factors: SlabFactors, d: jnp.ndarray) -> jnp.ndarray:
    """Solve with precomputed factors; d, result: (S, m) — or (S, m, k)
    for k simultaneous right-hand sides (the distributed SPIKE solver's
    spike computation, parallel.shard).  Two scans of matrix-(multi)vector
    products per RHS."""
    Dinvs, Cps, Al = factors
    dtype = d.dtype

    def fwd(dp_prev, inp):
        Dinv, A, di = inp
        dp = _mm(Dinv, di - _mm(A, dp_prev))
        return dp, dp

    _, dps = jax.lax.scan(fwd, jnp.zeros(d.shape[1:], dtype), (Dinvs, Al, d))

    def bwd(x_next, inp):
        Cp, dp = inp
        x = dp - _mm(Cp, x_next)
        return x, x

    _, xs = jax.lax.scan(bwd, jnp.zeros(d.shape[1:], dtype), (Cps, dps),
                         reverse=True)
    return xs


class CRLevel(NamedTuple):
    """One elimination level of the slab-granular block cyclic reduction.

    Odd-position slabs of this level are eliminated; even positions form
    the next (coarser) level.  ``L``/``U`` act on the even positions in
    the downward RHS pass; ``invBo``/``Ao``/``Co`` reconstruct the odd
    solutions in the upward pass."""

    invBo: jnp.ndarray   # (n_odd, m, m) inverses of the odd diagonals
    L: jnp.ndarray       # (n_even, m, m) A_even @ invBo[left]  (row 0 = 0)
    U: jnp.ndarray       # (n_even, m, m) C_even @ invBo[right] (pad = 0)
    Ao: jnp.ndarray      # (n_odd, m, m) original odd lower band
    Co: jnp.ndarray      # (n_odd, m, m) original odd upper band


class CRFactors(NamedTuple):
    levels: tuple        # fine-to-coarse CRLevel records
    root_inv: jnp.ndarray   # (m, m) inverse of the final single block


def _cr_level(A: jnp.ndarray, B: jnp.ndarray, C: jnp.ndarray):
    """One block-cyclic-reduction elimination step on (S, m, m) bands.

    Returns the level record plus the (ceil(S/2), m, m) bands of the
    Schur complement on the even positions.  All inversions in the level
    are BATCHED (n_odd at once) — the whole point vs block-Thomas, whose
    S inversions are sequential through the elimination recurrence.

    Odd S is padded to even with a decoupled identity row (A=C=0, B=I)
    at the (odd) tail position, and odd/even blocks are de-interleaved
    with a contiguous reshape."""
    S, m = A.shape[0], A.shape[1]
    if S % 2 == 1:   # pad: x_pad = d_pad, fully decoupled
        eye = jnp.eye(m, dtype=A.dtype)[None]
        zpad = jnp.zeros((1, m, m), A.dtype)
        A = jnp.concatenate([A, zpad], axis=0)
        B = jnp.concatenate([B, eye], axis=0)
        C = jnp.concatenate([C, zpad], axis=0)
        S += 1
    h = S // 2
    A2e = A.reshape(h, 2, m, m)
    B2e = B.reshape(h, 2, m, m)
    C2e = C.reshape(h, 2, m, m)
    Ae, Ao = A2e[:, 0], A2e[:, 1]
    Be, Bo = B2e[:, 0], B2e[:, 1]
    Ce, Co = C2e[:, 0], C2e[:, 1]
    invBo = _inv_refined(Bo)
    zero = jnp.zeros((1, m, m), A.dtype)

    # L_j = A[2j] @ invBo[j-1]  (j >= 1; slab 0 has no left neighbor)
    L = jnp.concatenate([zero, _mm(Ae[1:], invBo[:h - 1])], axis=0)
    # U_j = C[2j] @ invBo[j]    (the padded tail's Ce row is zero)
    U = _mm(Ce, invBo)

    Co_prev = jnp.concatenate([zero, Co[:h - 1]], axis=0)    # C[2j-1]
    B2 = Be - _mm(L, Co_prev) - _mm(U, Ao)
    A2 = -jnp.concatenate([zero, _mm(L[1:], Ao[:h - 1])], axis=0)
    C2 = -_mm(U, Co)
    return CRLevel(invBo=invBo, L=L, U=U, Ao=Ao, Co=Co), (A2, B2, C2)


def slab_factor_cr(lower: jnp.ndarray, diag: jnp.ndarray,
                   upper: jnp.ndarray) -> CRFactors:
    """Block cyclic reduction over slabs: ceil(log2 S) levels of BATCHED
    m x m inversions and matmuls instead of block-Thomas's S sequential
    inversions.

    ~3x the matmul FLOPs of Thomas, but every inversion at a level runs
    as one batched ``jnp.linalg.inv`` instead of S dependent ones.  Same
    recurrence the 1D direct solver uses per-vertex (solve/linear.py
    block CR), lifted to slab granularity."""
    levels = []
    A, B, C = lower, diag, upper
    while A.shape[0] > 1:
        lvl, (A, B, C) = _cr_level(A, B, C)
        levels.append(lvl)
    return CRFactors(levels=tuple(levels), root_inv=_inv_refined(B[0]))


def slab_factor_cr_fused(ell: BlockELL, plan: SlabPlan,
                         dtype=jnp.float32) -> CRFactors:
    """Band relayout (per-slab gather, see ``_band_of_slab_fn``) followed
    by the cyclic-reduction factorization."""
    band_of_slab = _band_of_slab_fn(ell, plan, dtype)
    lo, di, up = jax.lax.map(band_of_slab,
                             jnp.arange(plan.S, dtype=jnp.int32))
    # barrier: keeps the band gather and the CR level kernels in separate
    # fusions (a fused form once miscompiled on an earlier backend; kept
    # until it is re-tested, ROADMAP Design 6)
    lo, di, up = jax.lax.optimization_barrier((lo, di, up))
    return slab_factor_cr(lo, di, up)


def slab_solve_cr(factors: CRFactors, d: jnp.ndarray) -> jnp.ndarray:
    """Solve with a CR factorization; d, result: (S, m) or (S, m, k).

    2*ceil(log2 S) batched stages vs block-Thomas's 2S sequential scan
    steps — the same FLOPs, far fewer serialization points."""
    vec = d.ndim == 2
    if vec:
        d = d[..., None]
    stack = []
    for lvl in factors.levels:
        S_l = d.shape[0]
        if S_l % 2 == 1:
            d = jnp.concatenate(
                [d, jnp.zeros((1,) + d.shape[1:], d.dtype)], axis=0)
        h = d.shape[0] // 2
        d2 = d.reshape(h, 2, *d.shape[1:])
        de, do = d2[:, 0], d2[:, 1]
        zero = jnp.zeros((1,) + d.shape[1:], d.dtype)
        do_prev = jnp.concatenate([zero, do[:h - 1]], axis=0)
        stack.append((do, S_l))
        d = de - _mm(lvl.L, do_prev) - _mm(lvl.U, do)
    x = _mm(factors.root_inv, d[0])[None]         # (1, m, k)
    for lvl, (do, S_l) in zip(reversed(factors.levels), reversed(stack)):
        h = do.shape[0]
        zero = jnp.zeros((1,) + x.shape[1:], x.dtype)
        xe_next = jnp.concatenate([x[1:], zero], axis=0)
        xo = _mm(lvl.invBo, do - _mm(lvl.Ao, x) - _mm(lvl.Co, xe_next))
        x = jnp.stack([x, xo], axis=1).reshape(2 * h, *x.shape[1:])
        if S_l % 2 == 1:
            x = x[:S_l]
    return x[..., 0] if vec else x


class SlabSolveResult(NamedTuple):
    x: jnp.ndarray
    resnorm: jnp.ndarray
    iters: jnp.ndarray        # refinement passes used
    converged: jnp.ndarray


class SlabPrepared(NamedTuple):
    """Equilibrated system + f32 factorization, reusable across solves.

    Splitting prepare from apply lets a modified-Newton time step factor
    once (at the step's start iterate) and reuse the factorization for
    every Newton iteration (LinearConfig.refresh='step')."""
    ell_eq: BlockELL          # equilibrated matrix (f64)
    Dinv0: jnp.ndarray        # (N, f, f) block-row scaling
    factors: object           # f32 SlabFactors (Thomas) or CRFactors


def slab_prepare(ell: BlockELL, plan: SlabPlan,
                 mode: str = "thomas") -> SlabPrepared:
    """Equilibrate in f64, relayout to bands, factor in f32.

    mode='thomas': sequential block-Thomas scan (S sequential m x m
    inversions); mode='cr': slab-granular block cyclic reduction (batched
    inversions, ceil(log2 S) levels) — see slab_factor_cr."""
    Dinv0 = block_inv(ell.diag_blocks())
    ell_eq = ell.scale_rows(Dinv0)
    factor = slab_factor_cr_fused if mode == "cr" else slab_factor_fused
    return SlabPrepared(ell_eq=ell_eq, Dinv0=Dinv0,
                        factors=factor(ell_eq, plan))


def slab_apply(
    prep: SlabPrepared,
    rhs: jnp.ndarray,
    plan: SlabPlan,
    tol: float = 1.0e-8,
    max_refine: int = 40,
) -> SlabSolveResult:
    """Solve ``ell @ x = rhs`` with a prepared factorization (see
    slab_direct_solve for the algorithm)."""
    from gmpnp.solve.linear import gmres

    out_dtype = rhs.dtype
    b = jnp.einsum("nfg,ng->nf", prep.Dinv0, rhs)
    solver = (slab_solve_cr if isinstance(prep.factors, CRFactors)
              else slab_solve)

    def solve32(r64):
        ds = plan.to_slabs(r64.astype(jnp.float32))
        xs = solver(prep.factors, ds)
        return plan.from_slabs(xs).astype(out_dtype)

    res = gmres(prep.ell_eq.matvec, b, Minv=solve32, tol=tol,
                restart=min(max_refine, 30), maxiter=max_refine)
    return SlabSolveResult(x=res.x, resnorm=res.resnorm, iters=res.iters,
                           converged=res.converged)


def block_ell_contract(blocks: jnp.ndarray, xg: jnp.ndarray) -> jnp.ndarray:
    """``(N, K, f, f) x (N, K, f) -> (N, f)``: the block-ELL matvec on
    neighbour values already gathered (``xg = x[adj]``).  XLA fuses the
    gather and the K reduction; full precision, since a float32 einsum may
    otherwise run in TF32 on a GPU."""
    return jnp.einsum("nkfg,nkg->nf", blocks, xg, precision=_HI)


def slab_apply_f32(
    prep: SlabPrepared,
    rhs: jnp.ndarray,
    plan: SlabPlan,
    tol: float = 1.0e-5,
    max_refine: int = 16,
) -> SlabSolveResult:
    """Chord-direction solve of ``ell @ x = rhs`` in NATIVE f32.

    The carried-mode chord directions (LinearConfig.refresh='carried',
    chord_dtype='f32') do not need slab_apply's f64 polish: their error
    is dominated by Jacobian STALENESS (the factorization is frozen from
    an earlier state), and Newton certifies convergence on the true f64
    residual regardless.  The whole preconditioned GMRES runs in f32: the
    block-Thomas/CR banded solve, the block-ELL contraction (an einsum
    that XLA fuses with the neighbour gather), and f32 Givens/CGS2, all
    under ``default_matmul_precision('highest')`` (a TF32 dot would stall
    GMRES around 1e-3).

    The equilibrated system is well-ranged for f32 (every block row is
    O(1) after the f64 block-Jacobi scaling baked into ``prep``), and the
    returned direction is exact-to-f32 of the STALE system: a chord
    iteration with it converges whenever the f64-direction chord does,
    within ~1 extra iteration (direction error ~1e-5 relative vs the
    staleness error it already tolerates).

    Casts/relayouts of the carried matrix happen OUTSIDE the GMRES loop
    (once per time step trace); each iteration is gather + contract.
    """
    from gmpnp.solve.linear import gmres

    out_dtype = rhs.dtype
    with jax.default_matmul_precision("highest"):
        Dinv32 = prep.Dinv0.astype(jnp.float32)
        b = jnp.einsum("nfg,ng->nf", Dinv32, rhs.astype(jnp.float32))
        # hoisted once per step: f32 cast + (N, f, K*f) -> (N, K, f, f)
        N, f, Kf = prep.ell_eq.flat.shape
        K = Kf // f
        blocks32 = jnp.swapaxes(
            prep.ell_eq.flat.astype(jnp.float32).reshape(N, f, K, f), 1, 2)
        adj = prep.ell_eq.adj
        solver = (slab_solve_cr if isinstance(prep.factors, CRFactors)
                  else slab_solve)

        def mv(x32):
            return block_ell_contract(blocks32, x32[adj])

        def pc(r32):
            return plan.from_slabs(solver(prep.factors, plan.to_slabs(r32)))

        res = gmres(mv, b, Minv=pc, tol=tol,
                    restart=min(max_refine, 16), maxiter=max_refine)
    return SlabSolveResult(x=res.x.astype(out_dtype), resnorm=res.resnorm,
                           iters=res.iters, converged=res.converged)


def slab_direct_solve(
    ell: BlockELL,
    rhs: jnp.ndarray,
    plan: SlabPlan,
    tol: float = 1.0e-8,
    max_refine: int = 40,
    mode: str = "thomas",
) -> SlabSolveResult:
    """Mixed-precision direct solve of ``ell @ x = rhs``.

    1. block-row equilibration in f64 (every block row scaled by the
       inverse of its diagonal block — keeps the f32 bands well ranged);
    2. f32 band relayout + block-Thomas factorization;
    3. the f32 factorization is used as a *preconditioner* for f64 GMRES
       on the equilibrated system.  Plain Richardson refinement stalls on
       the GMPNP Jacobians (cond x eps_f32 > 1 — measured: residual
       plateaus at ~1e-2 relative); preconditioned GMRES converges as
       long as the f32 solve is a decent approximate inverse, typically
       in a handful of iterations.  ``iters`` reports GMRES iterations
       (each = one f32 banded solve + one f64 matvec).
    """
    return slab_apply(slab_prepare(ell, plan, mode=mode), rhs, plan,
                      tol=tol, max_refine=max_refine)
