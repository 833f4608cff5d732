"""Small-block Gauss-Jordan routines vs numpy LAPACK."""

import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.solve.smallblock import (
    block_inv,
    block_solve,
    triangular_solve_upper,
)


@pytest.mark.parametrize("f", [1, 2, 3, 7, 9])
def test_block_inv_random(f):
    rng = np.random.default_rng(f)
    A = rng.normal(size=(50, f, f))
    A += 2.0 * np.eye(f)
    got = np.asarray(block_inv(jnp.asarray(A)))
    ref = np.linalg.inv(A)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-11)


def test_block_inv_needs_pivoting():
    # zero leading pivot forces a row swap
    A = np.array([[[0.0, 1.0], [1.0, 0.0]],
                  [[1e-14, 1.0], [1.0, 1.0]]])
    got = np.asarray(block_inv(jnp.asarray(A)))
    ref = np.linalg.inv(A)
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8)


def test_block_inv_badly_scaled():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(20, 9, 9))
    scales = 10.0 ** rng.uniform(-6, 6, size=(20, 9))
    A = A * scales[:, :, None]
    A += np.eye(9) * scales[:, :, None] * 3
    got = np.asarray(block_inv(jnp.asarray(A)))
    err = np.abs(got @ A - np.eye(9)).max()
    assert err < 1e-8, err


def test_block_solve():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(30, 5, 5)) + 3 * np.eye(5)
    b = rng.normal(size=(30, 5))
    got = np.asarray(block_solve(jnp.asarray(A), jnp.asarray(b)))
    ref = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-11)


def test_triangular_solve_upper():
    rng = np.random.default_rng(7)
    m = 25
    R = np.triu(rng.normal(size=(m, m))) + 3 * np.eye(m)
    g = rng.normal(size=m)
    got = np.asarray(triangular_solve_upper(jnp.asarray(R), jnp.asarray(g)))
    ref = np.linalg.solve(R, g)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
