"""The f32 block-ELL contraction of the carried-mode chord solve
(solve.slab.block_ell_contract) against f64 references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.solve.slab import block_ell_contract


def _random_ell(n_fields, seed, scale=1.0, diag_shift=0.0):
    """Random BlockELL on the pore mesh's adjacency (f32 blocks)."""
    from gmpnp.fem import FemSpace
    from gmpnp.fem.assembly import BlockELL
    from gmpnp.mesh import cylinder_mesh, pore_boundary_markers

    mesh = cylinder_mesh(100e-9, 10e-9, n_rings=2, n_layers=8)
    mesh = pore_boundary_markers(mesh, 100e-9, 10e-9)
    space = FemSpace.build(mesh, n_fields, quad_degree=2)
    rng = np.random.default_rng(seed)
    adj = np.asarray(space.adj)
    N, K = adj.shape
    blocks = (rng.normal(size=(N, K, n_fields, n_fields)) * scale)
    dslot = np.asarray(space.diag_slot)
    blocks[np.arange(N), dslot] += diag_shift * np.eye(n_fields)
    ell = BlockELL.from_blocks(jnp.asarray(adj),
                               jnp.asarray(blocks.astype(np.float32)),
                               jnp.asarray(dslot))
    return space, ell, rng


@pytest.mark.parametrize("N,K,f", [(50, 4, 3), (2501, 15, 9)])
def test_contract_matches_numpy_f64(N, K, f):
    """f32 operands, summed in f32: each output sums K*f products, so the
    error is bounded by ~K*f*eps32 times the sum of |terms|."""
    rng = np.random.default_rng(N + K + f)
    blocks = rng.normal(size=(N, K, f, f)).astype(np.float32)
    xg = rng.normal(size=(N, K, f)).astype(np.float32)
    got = np.asarray(block_ell_contract(jnp.asarray(blocks),
                                        jnp.asarray(xg)))
    b64, x64 = blocks.astype(np.float64), xg.astype(np.float64)
    ref = np.einsum("nkfg,nkg->nf", b64, x64)
    bound = K * f * np.finfo(np.float32).eps * np.einsum(
        "nkfg,nkg->nf", np.abs(b64), np.abs(x64))
    assert got.dtype == np.float32
    assert np.all(np.abs(got - ref) <= bound)


def test_contract_equals_blockell_matvec():
    """The chord matvec (relayout to (N, K, f, f) + gather + contract)
    equals BlockELL.matvec on the same f32 matrix."""
    _, ell, rng = _random_ell(3, seed=11)
    x = jnp.asarray(rng.normal(size=(ell.adj.shape[0], 3)).astype(np.float32))
    got = np.asarray(block_ell_contract(ell.blocks4(), x[ell.adj]))
    ref = np.asarray(ell.matvec(x))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_f32_chord_gmres_matches_f64_solve():
    """slab_apply_f32 (f32 banded preconditioner + f32 GMRES over the
    contraction) solves a block-diagonally dominant system to its f32
    tolerance: the result agrees with the f64 dense solve to ~1e-5."""
    from gmpnp.fem.assembly import BlockELL
    from gmpnp.solve.slab import SlabPlan, slab_apply_f32, slab_prepare

    space, ell32, rng = _random_ell(3, seed=13, scale=0.05, diag_shift=2.0)
    ell = BlockELL(ell32.adj, ell32.flat.astype(jnp.float64),
                   ell32.diag_slot)
    N = ell.adj.shape[0]
    plan = SlabPlan.build(np.asarray(space.adj),
                          np.asarray(space.points)[:, -1], 3,
                          np.asarray(space.diag_slot))
    b = jnp.asarray(rng.normal(size=(N, 3)))
    res = slab_apply_f32(slab_prepare(ell, plan), b, plan, tol=1e-6)
    ref = np.linalg.solve(np.asarray(ell.to_dense()),
                          np.asarray(b).reshape(-1)).reshape(N, 3)
    assert bool(res.converged)
    assert res.x.dtype == jnp.float64
    rel = np.linalg.norm(np.asarray(res.x) - ref) / np.linalg.norm(ref)
    assert rel < 1e-5, rel


@pytest.mark.gpu
def test_contract_full_precision_on_card(gpu_device):
    """On the card the f32 contraction keeps full f32 precision (a TF32
    product would err by ~1e-3 relative)."""
    rng = np.random.default_rng(7)
    blocks = rng.normal(size=(2501, 15, 9, 9)).astype(np.float32)
    xg = rng.normal(size=(2501, 15, 9)).astype(np.float32)
    got = np.asarray(jax.jit(block_ell_contract)(
        jax.device_put(blocks, gpu_device), jax.device_put(xg, gpu_device)))
    ref = np.einsum("nkfg,nkg->nf", blocks.astype(np.float64),
                    xg.astype(np.float64))
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-6, rel
