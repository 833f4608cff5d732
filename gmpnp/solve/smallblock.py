"""Batched small-block dense linear algebra in pure arithmetic.

Gauss-Jordan elimination with partial pivoting for the f64
field-coupling blocks (f x f with f <= 9), using only elementwise ops,
selects and single-row slices: batch-parallel, it needs no LU kernel
from the backend.  Whether it beats
``jnp.linalg.inv`` on a GPU is open (ROADMAP Design 2).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# Exponent-range guard for backends that emulate f64 with float32 pairs,
# which keep ~f32 EXPONENT range (~1e+-38): a near-singular block during a
# Newton excursion can push a pivot inverse past it.  It engages on every
# backend (ROADMAP Design 1).  Every factorization magnitude is clamped to +-RANGE_LIM and pivots are
# floored at RANGE_FLOOR, so no product of two clamped quantities (times
# block size <= 16) can reach 1e38: 1e16 * 1e16 * 16 ~ 1.6e33.  Both
# bounds sit ~1e6+ beyond any legitimate quantity in this framework's
# scaled systems, so healthy solves are numerically unchanged; where a
# clamp does engage, the direction is certified downstream (Newton
# accepts on the true f64 residual; the mixed-precision direct paths
# additionally polish with f64 GMRES, correcting any clamped pivot).
RANGE_LIM = 1.0e16
RANGE_FLOOR = 1.0e-16


def range_clamp(x: jnp.ndarray, lim: float = RANGE_LIM) -> jnp.ndarray:
    """Clamp magnitudes into an emulated-f64 exponent budget."""
    return jnp.clip(x, -lim, lim)


def _floor_pivot(pivval: jnp.ndarray) -> jnp.ndarray:
    """Push a ~zero pivot to +-RANGE_FLOOR, keeping its sign (sign(0)
    counts as +)."""
    neg = pivval < 0
    floored = jnp.where(neg, -RANGE_FLOOR, RANGE_FLOOR)
    return jnp.where(jnp.abs(pivval) < RANGE_FLOOR, floored, pivval)


def block_inv(A: jnp.ndarray) -> jnp.ndarray:
    """Batched inverse of (..., f, f) via Gauss-Jordan with partial
    pivoting.  f is static and small (<= ~16).

    The f elimination steps run as one ``lax.fori_loop`` rather than f
    unrolled copies: the 1D cyclic reduction inverts a batch per level,
    and an unrolled body per call made its program, and its GPU compile,
    several times larger.
    """
    f = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(f, dtype=A.dtype), A.shape)
    aug = jnp.concatenate([range_clamp(A), eye], axis=-1)   # (..., f, 2f)
    rows = jnp.arange(f, dtype=jnp.int32)
    # strictly-lower-triangular mask: lt[i, j] = i < j
    lt = (rows[:, None] < rows[None, :]).astype(A.dtype)
    eye_ij = rows[:, None] == rows[None, :]

    def eliminate(k, aug):
        # partial pivot: largest |entry| in column k among rows >= k.  The
        # pivot row is a ONE-HOT vector h (first occurrence of the max), so
        # the row swap k <-> p is a select-built permutation applied by a
        # multiply-reduce, with no integer gather.
        col = jnp.abs(lax.dynamic_index_in_dim(aug, k, axis=-1,
                                               keepdims=False))
        col = jnp.where(rows >= k, col, -jnp.inf)
        mx = jnp.max(col, axis=-1, keepdims=True)
        is_mx = col == mx
        # first occurrence of the max: no is_mx strictly before j
        before = jnp.sum(is_mx[..., :, None].astype(A.dtype) * lt, axis=-2)
        h = is_mx & (before == 0)
        # perm[i, j] = h[j]        if i == k      (row k receives row p)
        #            = (j == k)    if h[i]        (row p receives row k)
        #            = (i == j)    otherwise
        is_k = rows == k
        perm = jnp.where(is_k[:, None], h[..., None, :],
                         jnp.where(h[..., :, None], is_k[None, :], eye_ij))
        aug = jnp.sum(perm.astype(aug.dtype)[..., :, :, None]
                      * aug[..., None, :, :], axis=-2)
        # normalize pivot row, eliminate everywhere else.  The pivot is
        # floored and the row/update magnitudes clamped so near-singular
        # blocks stay inside the emulated-f64 exponent range (see the
        # RANGE_LIM note above).
        rowk = lax.dynamic_index_in_dim(aug, k, axis=-2)      # (..., 1, 2f)
        pivval = _floor_pivot(
            lax.dynamic_index_in_dim(rowk, k, axis=-1))       # (..., 1, 1)
        rowk = range_clamp(rowk / pivval)
        factors = lax.dynamic_index_in_dim(aug, k, axis=-1)   # (..., f, 1)
        aug = range_clamp(aug - factors * rowk)
        # restore the (zeroed) pivot row as the normalized row
        return jnp.where(is_k[:, None], rowk, aug)

    aug = lax.fori_loop(0, f, eliminate, aug)
    return aug[..., :, f:]


def block_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched solve A x = b for (..., f, f) blocks.

    b: (..., f) or (..., f, k).  Uses the explicit GJ inverse — for the
    tiny, backward-Euler-shifted blocks of this framework the
    inverse-multiply is accurate to ~1e-14 relative and batches better
    than a triangular-solve chain.
    """
    Ainv = block_inv(A)
    if b.ndim == A.ndim - 1:
        return jnp.einsum("...ij,...j->...i", Ainv, b)
    return Ainv @ b


def triangular_solve_upper(R: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Back-substitution for a single upper-triangular system (m static).

    Unrolled in place of jax.scipy.linalg.solve_triangular."""
    m = R.shape[-1]
    x = jnp.zeros_like(g)
    for i in range(m - 1, -1, -1):
        resid = g[i] - jnp.dot(R[i, :], x)
        x = x.at[i].set(resid / R[i, i])
    return x
