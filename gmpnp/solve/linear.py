"""Sparse linear solvers on block structures.

- 1D coupled P1 systems are block-tridiagonal (f x f blocks): solved
  *exactly* by block cyclic reduction (log2 N batched levels)
  or a sequential block-Thomas scan (oracle/fallback).  This replaces the
  UMFPACK direct solves DOLFIN uses for the reference's 1D models
  (SURVEY.md §2b).
- 3D systems use restarted GMRES or BiCGStab with block-Jacobi
  preconditioning over the BlockELL matvec, replacing MUMPS
  (3D/MPNP_CO2ER_pore.py:787-799).  The backward-Euler shift keeps the
  systems well-conditioned enough for Newton-grade tolerances.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from gmpnp.fem.assembly import BlockELL
from gmpnp.solve.smallblock import (
    block_inv, block_solve, range_clamp, triangular_solve_upper)


# ---------------------------------------------------------------------------
# Block tridiagonal (1D direct)
# ---------------------------------------------------------------------------

def block_tridiag_from_ell(ell: BlockELL) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Extract (lower, diag, upper) block bands from a BlockELL matrix whose
    mesh vertices are sorted along the line (adjacency {n-1, n, n+1}).

    Returns arrays (N, f, f); lower[0] and upper[N-1] are zero.
    """
    N, K, f, _ = ell.shape4
    assert K <= 3, "not a tridiagonal pattern"

    def slot_block(slot):
        # gather block `slot[n]` from the flat (N, f, K*f) layout
        idx = (slot[:, None, None] * f + jnp.arange(f)[None, None, :])
        return jnp.take_along_axis(
            ell.flat, jnp.broadcast_to(idx, (N, f, f)), axis=2)

    rows = jnp.arange(N)
    diag = slot_block(ell.diag_slot)
    low_slot = jnp.clip(ell.diag_slot - 1, 0, K - 1)
    up_slot = jnp.clip(ell.diag_slot + 1, 0, K - 1)
    lower = slot_block(low_slot)
    upper = slot_block(up_slot)
    lower = jnp.where((rows > 0)[:, None, None], lower, 0.0)
    upper = jnp.where((rows < N - 1)[:, None, None], upper, 0.0)
    return lower, diag, upper


def block_tridiag_solve_thomas(lower, diag, upper, rhs):
    """Sequential block-Thomas algorithm via lax.scan (exact; oracle path).

    lower/diag/upper: (N, f, f); rhs: (N, f).  Returns x: (N, f).
    """
    N, f, _ = diag.shape

    def fwd(carry, inp):
        Cp_prev, dp_prev = carry
        A, B, C, d = inp
        denom = B - A @ Cp_prev
        dinv = block_inv(denom)
        Cp = dinv @ C
        dp = dinv @ (d - A @ dp_prev)
        return (Cp, dp), (Cp, dp)

    init = (jnp.zeros((f, f), diag.dtype), jnp.zeros((f,), diag.dtype))
    _, (Cps, dps) = jax.lax.scan(fwd, init, (lower, diag, upper, rhs))

    def bwd(x_next, inp):
        Cp, dp = inp
        x = dp - Cp @ x_next
        return x, x

    _, xs = jax.lax.scan(bwd, jnp.zeros((f,), diag.dtype),
                         (Cps, dps), reverse=True)
    return xs


def block_tridiag_solve_cr(lower, diag, upper, rhs):
    """Block cyclic reduction: exact direct solve in log2(N) fully-batched
    levels — each level is a set of small batched matmuls/solves, unlike
    the inherently sequential Thomas recursion.  Factors once and applies
    (``block_tridiag_factor_cr`` + ``block_tridiag_apply_cr``), so every
    odd block is inverted once: the unrolled levels are most of the 1D
    step's program, and its size sets the GPU compile time.
    """
    return block_tridiag_apply_cr(
        block_tridiag_factor_cr(lower, diag, upper), rhs)


class _CRLevel(NamedTuple):
    """Per-level factors of a block-cyclic-reduction factorization.

    h = m/2 rows at this level; alpha/gamma reduce the rhs downward,
    A_od/C_od/Binv_od back-substitute the odd rows upward.  Binv_od is
    shared between the reduction (left/right neighbor inverses) and the
    back-substitution, so the factorization inverts each odd block ONCE
    (the fused solve_cr inverts every odd block twice per level).
    """
    alpha: jnp.ndarray    # (h, f, f)  A_even @ inv(B_leftodd)
    gamma: jnp.ndarray    # (h, f, f)  C_even @ inv(B_rightodd)
    A_od: jnp.ndarray     # (h, f, f)  odd rows' lower band
    C_od: jnp.ndarray     # (h, f, f)  odd rows' upper band
    Binv_od: jnp.ndarray  # (h, f, f)  inverse of odd rows' diagonal


class CRFactors(NamedTuple):
    levels: Tuple[_CRLevel, ...]
    Binv_top: jnp.ndarray   # (f, f) inverse of the final 1x1-block system


def block_tridiag_factor_cr(lower, diag, upper) -> CRFactors:
    """Factorization half of block cyclic reduction: everything that
    depends only on the matrix.  Same reduction as
    ``block_tridiag_solve_cr``; splitting factor from apply lets one
    factorization serve many right-hand sides — in particular the
    factorization carried across time steps by the 1D chord Newton
    (``timeloop.make_carried_step``).
    """
    dtype = diag.dtype
    N, f, _ = diag.shape
    M = 1
    while M < N:
        M *= 2
    n_pad = M - N
    if n_pad:
        eye = jnp.broadcast_to(jnp.eye(f, dtype=dtype), (n_pad, f, f))
        zed = jnp.zeros((n_pad, f, f), dtype)
        lower = jnp.concatenate([lower, zed])
        diag = jnp.concatenate([diag, eye])
        upper = jnp.concatenate([upper, zed])

    A, B, C = lower, diag, upper
    eye1 = jnp.eye(f, dtype=dtype)[None]
    zed1 = jnp.zeros((1, f, f), dtype)
    levels = []
    while A.shape[0] > 1:
        ev = jnp.arange(0, A.shape[0], 2)
        od = ev + 1
        A_od, B_od, C_od = A[od], B[od], C[od]
        Binv_od = block_inv(B_od)
        # even row 2j's left odd neighbor is 2j-1 (ghost identity at j=0),
        # its right odd neighbor is 2j+1.  Level products are range-clamped
        # against emulated-f64 exponent overflow (smallblock.RANGE_LIM);
        # Newton certifies every direction on the true f64 residual.
        Binv_left = jnp.concatenate([eye1, Binv_od[:-1]])
        alpha = range_clamp(A[ev] @ Binv_left)
        gamma = range_clamp(C[ev] @ Binv_od)
        levels.append(_CRLevel(alpha, gamma, A_od, C_od, Binv_od))
        A_left = jnp.concatenate([zed1, A_od[:-1]])
        C_left = jnp.concatenate([zed1, C_od[:-1]])
        A = range_clamp(-alpha @ A_left)
        B = range_clamp(B[ev] - alpha @ C_left - gamma @ A_od)
        C = range_clamp(-gamma @ C_od)
    return CRFactors(levels=tuple(levels), Binv_top=block_inv(B[0]))


def block_tridiag_apply_cr(factors: CRFactors, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve with a prepared CR factorization.  rhs: (N, f) in the
    factorization's dtype (padded rows solve to 0 exactly)."""
    N, f = rhs.shape
    M = 2 ** len(factors.levels)
    D = rhs
    if M > N:
        D = jnp.concatenate([D, jnp.zeros((M - N, f), rhs.dtype)])
    zv1 = jnp.zeros((1, f), rhs.dtype)

    odd_rhs = []
    for lev in factors.levels:
        D_ev, D_od = D[0::2], D[1::2]
        odd_rhs.append(D_od)
        D_left = jnp.concatenate([zv1, D_od[:-1]])
        D = range_clamp(
            D_ev
            - jnp.einsum("nij,nj->ni", lev.alpha, D_left)
            - jnp.einsum("nij,nj->ni", lev.gamma, D_od))

    x = (factors.Binv_top @ D[0])[None]               # (1, f)
    for lev, D_od in zip(reversed(factors.levels), reversed(odd_rhs)):
        x_even = x
        x_right = jnp.concatenate([x_even[1:], zv1])
        r_od = range_clamp(
            D_od
            - jnp.einsum("nij,nj->ni", lev.A_od, x_even)
            - jnp.einsum("nij,nj->ni", lev.C_od, x_right))
        x_odd = range_clamp(
            jnp.einsum("nij,nj->ni", lev.Binv_od, r_od))
        m = 2 * x_even.shape[0]
        x = jnp.stack([x_even, x_odd], axis=1).reshape(m, f)
    return x[:N]


# ---------------------------------------------------------------------------
# Preconditioners
# ---------------------------------------------------------------------------

def block_jacobi_preconditioner(ell: BlockELL) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """M^{-1} z with M = block diagonal of the matrix; z, out: (N, f)."""
    Dinv = block_inv(ell.diag_blocks())

    def apply(z):
        return jnp.einsum("nfg,ng->nf", Dinv, z)

    return apply


def greedy_vertex_coloring(adj: "np.ndarray") -> "np.ndarray":
    """Host-side greedy graph coloring of the (padded) adjacency table.

    Adjacent vertices get different colors, so a Gauss-Seidel sweep can
    update each color as one batched, order-independent operation — the
    parallel replacement for the inherently sequential GS recursion.
    Returns (N,) int32 colors.
    """
    import numpy as _np

    N = adj.shape[0]
    colors = _np.full(N, -1, dtype=_np.int32)
    for v in range(N):
        used = set(colors[u] for u in adj[v] if u != v and colors[u] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def multicolor_ssor_preconditioner(
    ell: BlockELL,
    colors: jnp.ndarray,
    sweeps: int = 1,
    omega: float = 1.0,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Block-SSOR preconditioner via multicolor sweeps.

    M = (D/w + L) (D/w)^{-1} (D/w + U); application solves the two
    triangular block systems by sweeping the colors forward then backward —
    each color is one batched block solve (all rows of a color are mutually
    non-adjacent).  Much stronger than block-Jacobi on the reference's
    3D coupled systems (condition ~1e6+) at ~2 matvecs per application.

    ``colors`` comes from :func:`greedy_vertex_coloring` (host-side, once
    per mesh).
    """
    import numpy as _np

    N, K, f, _ = ell.shape4
    colors_np = _np.asarray(colors)
    nc = int(colors_np.max()) + 1
    color_lists = []
    maxlen = max((colors_np == c).sum() for c in range(nc))
    for c in range(nc):
        verts = _np.nonzero(colors_np == c)[0]
        # pad with the first vertex of the color: the padded rows compute
        # the identical update value, so the duplicate scatter is benign
        pad = _np.full(maxlen - len(verts), verts[0], dtype=_np.int64)
        color_lists.append(_np.concatenate([verts, pad]))

    D = ell.diag_blocks() / omega
    Dinv = block_inv(D)
    # off-diagonal part: zero the diagonal block inside the flat layout
    rows2 = jnp.arange(N)[:, None]
    rr = jnp.broadcast_to(jnp.arange(f)[None, :], (N, f))
    dcols = ell.diag_slot[:, None] * f + jnp.arange(f)[None, :]
    offflat = ell.flat
    for c in range(f):
        offflat = offflat.at[rows2[:, 0], :, ell.diag_slot * f + c].set(0.0)

    def offdiag_rows(z, verts):
        """sum_k offblocks[v,k] z[adj[v,k]] for a vertex set — batched
        dot_general on the flat layout."""
        blk = offflat[verts]            # (M, f, K*f)
        zg = z[ell.adj[verts]].reshape(len(verts), K * f)
        return jax.lax.dot_general(
            blk, zg, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=z.dtype)

    def sweep(z, r, order):
        for c in order:
            verts = color_lists[c]
            rhs = r[verts] - offdiag_rows(z, verts)
            znew = jnp.einsum("mfg,mg->mf", Dinv[verts], rhs)
            z = z.at[verts].set(znew)
        return z

    def ssor_solve(r):
        # forward: (D/w + L)^{-1} r  -> scale by D/w -> backward (D/w + U)^{-1}
        z = sweep(jnp.zeros_like(r), r, range(nc))
        z = jnp.einsum("nfg,ng->nf", D, z)
        return sweep(jnp.zeros_like(r), z, range(nc - 1, -1, -1))

    def apply(r):
        z = ssor_solve(r)
        for _ in range(sweeps - 1):   # extra sweeps = stationary iteration
            z = z + ssor_solve(r - ell.matvec(z))
        return z

    return apply


# ---------------------------------------------------------------------------
# Krylov solvers
# ---------------------------------------------------------------------------

class KrylovResult(NamedTuple):
    x: jnp.ndarray
    resnorm: jnp.ndarray
    iters: jnp.ndarray
    converged: jnp.ndarray


_HI = jax.lax.Precision.HIGHEST

# Breakdown guard magnitude.  A backend that emulates f64 with float32 pairs
# keeps ~f32 exponent range — constants like 1e-300 silently underflow to 0
# there and turn breakdown guards into divisions by zero.  1e-30 is
# representable on every backend and far below any legitimate quantity in
# the scaled systems this framework solves.
_TINY = 1e-30


def _guard(x):
    """Replace ~zero denominators with a representable tiny value."""
    return jnp.where(jnp.abs(x) < _TINY, _TINY, x)


def _norm(v):
    return jnp.sqrt(jnp.sum(v * v))


def gmres(
    matvec: Callable,
    b: jnp.ndarray,
    Minv: Optional[Callable] = None,
    x0: Optional[jnp.ndarray] = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 30,
    maxiter: int = 300,
) -> KrylovResult:
    """Right-preconditioned restarted GMRES with Givens-rotation residual
    tracking.  Operates on arbitrarily-shaped pytree-free arrays (flattened
    internally).  Stops when ||r|| <= max(tol*||b||, atol).
    """
    shape = b.shape
    n = b.size
    dtype = b.dtype
    bflat = b.reshape(-1)
    if Minv is None:
        Minv = lambda z: z
    mv = lambda v: matvec(v.reshape(shape)).reshape(-1)
    pc = lambda v: Minv(v.reshape(shape)).reshape(-1)

    x = jnp.zeros(n, dtype) if x0 is None else x0.reshape(-1)
    bnorm = _norm(bflat)
    target = jnp.maximum(jnp.maximum(tol * bnorm, atol), _TINY)
    m = restart

    def cycle(state):
        x, _, total_it, _ = state
        r = bflat - mv(x)
        beta = _norm(r)

        V = jnp.zeros((m + 1, n), dtype).at[0].set(r / jnp.maximum(beta, _TINY))
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def arnoldi_step(j, carry):
            V, H, cs, sn, g, done, k = carry

            def do(carry):
                V, H, cs, sn, g, done, k = carry
                w = mv(pc(V[j]))
                # classical Gram-Schmidt with one re-orthogonalization
                # (CGS2): two (m+1, n) matmuls instead of m+1 sequential
                # masked dot/axpy pairs.  Rows of V beyond j are zero, so
                # no masking is needed, and CGS2 is as orthogonal as MGS
                # in practice.  Full precision: an f32 iteration would
                # otherwise orthogonalize in TF32 on a GPU.
                h1 = jnp.matmul(V, w, precision=_HI)
                w = w - jnp.matmul(h1, V, precision=_HI)
                h2 = jnp.matmul(V, w, precision=_HI)
                w = w - jnp.matmul(h2, V, precision=_HI)
                hcol = h1 + h2
                hlast = _norm(w)
                hcol = hcol.at[j + 1].set(hlast)
                V = V.at[j + 1].set(w / jnp.maximum(hlast, _TINY))
                # apply previous Givens rotations to the new column
                def rot(i, hc):
                    hi, hip = hc[i], hc[i + 1]
                    upd = jnp.where(
                        i < j,
                        jnp.array([cs[i] * hi + sn[i] * hip,
                                   -sn[i] * hi + cs[i] * hip]),
                        jnp.array([hi, hip]))
                    return hc.at[i].set(upd[0]).at[i + 1].set(upd[1])
                hcol = jax.lax.fori_loop(0, m, rot, hcol)
                # new rotation annihilating hcol[j+1]
                denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                c = jnp.where(denom > 0, hcol[j] / jnp.maximum(denom, _TINY), 1.0)
                s = jnp.where(denom > 0, hcol[j + 1] / jnp.maximum(denom, _TINY), 0.0)
                hcol = hcol.at[j].set(c * hcol[j] + s * hcol[j + 1]).at[j + 1].set(0.0)
                cs2 = cs.at[j].set(c)
                sn2 = sn.at[j].set(s)
                gj = g[j]
                g2 = g.at[j].set(c * gj).at[j + 1].set(-s * gj)
                H2 = H.at[:, j].set(hcol[:m + 1])
                done2 = jnp.abs(g2[j + 1]) <= target
                return (V, H2, cs2, sn2, g2, done2, k + 1)

            return jax.lax.cond(done, lambda c: c, do,
                                (V, H, cs, sn, g, done, k))

        V, H, cs, sn, g, done, k = jax.lax.fori_loop(
            0, m, arnoldi_step,
            (V, H, cs, sn, g, beta <= target, jnp.array(0, jnp.int32)))

        # solve the triangular system H[:k,:k] y = g[:k] (k unknown at trace
        # time -> mask): use full m x m with identity padding on unused rows.
        used = jnp.arange(m) < k
        Hsq = H[:m, :m]
        Hsq = jnp.where(used[None, :] & used[:, None], Hsq,
                        jnp.eye(m, dtype=dtype))
        gv = jnp.where(used, g[:m], 0.0)
        y = triangular_solve_upper(Hsq, gv)
        dx = pc(jnp.matmul(V[:m].T, y, precision=_HI))
        x_new = x + dx
        rnorm = _norm(bflat - mv(x_new))
        return (x_new, rnorm, total_it + k, rnorm <= target)

    def cond(state):
        _, rnorm, total_it, conv = state
        return (~conv) & (total_it < maxiter)

    init = (x, jnp.asarray(jnp.inf, dtype), jnp.array(0, jnp.int32),
            jnp.asarray(False))
    x, rnorm, iters, conv = jax.lax.while_loop(cond, cycle, init)
    return KrylovResult(x.reshape(shape), rnorm, iters, conv)


def bicgstab(
    matvec: Callable,
    b: jnp.ndarray,
    Minv: Optional[Callable] = None,
    x0: Optional[jnp.ndarray] = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 500,
) -> KrylovResult:
    """Preconditioned BiCGStab (right preconditioning)."""
    shape = b.shape
    dtype = b.dtype
    bflat = b.reshape(-1)
    if Minv is None:
        Minv = lambda z: z
    mv = lambda v: matvec(v.reshape(shape)).reshape(-1)
    pc = lambda v: Minv(v.reshape(shape)).reshape(-1)

    x = jnp.zeros_like(bflat) if x0 is None else x0.reshape(-1)
    r = bflat - mv(x)
    rhat = r
    bnorm = _norm(bflat)
    target = jnp.maximum(jnp.maximum(tol * bnorm, atol), _TINY)

    def cond(st):
        x, r, p, v, rho, alpha, omega, it = st
        rn = _norm(r)
        # stop on convergence, budget, Lanczos breakdown, non-finite state,
        # or runaway transients: BiCGStab excursions are unbounded, and on
        # an emulated-f64 backend (f32 exponent range) values past ~1e38
        # do not overflow cleanly to inf — cap well below that
        healthy = (jnp.isfinite(rn) & jnp.isfinite(rho) & jnp.isfinite(omega)
                   & (jnp.abs(rho) > _TINY) & (jnp.abs(omega) > _TINY)
                   & (rn < 1e12))
        return (rn > target) & (it < maxiter) & healthy

    def body(st):
        x, r, p, v, rho, alpha, omega, it = st
        rho_new = jnp.dot(rhat, r)
        beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
        p = r + beta * (p - omega * v)
        phat = pc(p)
        v = mv(phat)
        alpha = rho_new / _guard(jnp.dot(rhat, v))
        s = r - alpha * v
        shat = pc(s)
        t = mv(shat)
        omega = jnp.dot(t, s) / _guard(jnp.dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, it + 1)

    zeros = jnp.zeros_like(bflat)
    one = jnp.asarray(1.0, dtype)
    st = jax.lax.while_loop(
        cond, body, (x, r, zeros, zeros, one, one, one,
                     jnp.array(0, jnp.int32)))
    x, r, *_, it = st
    rnorm = _norm(r)
    return KrylovResult(x.reshape(shape), rnorm, it, rnorm <= target)


def dense_solve(ell: BlockELL, rhs: jnp.ndarray) -> jnp.ndarray:
    """Direct dense solve (tests / small systems).

    Tests and small systems only; production paths use the
    tridiagonal/slab/Krylov solvers."""
    N, _, f, _ = ell.shape4
    x = jnp.linalg.solve(ell.to_dense(), rhs.reshape(-1))
    return x.reshape(N, f)
