"""Tests for logging, profiling, checkpoint/resume, and VTK output."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest

from gmpnp.utils import PhaseTimer, StepLogger


class FakeStats:
    def __init__(self, n):
        self.newton_iters = np.full(n, 3)
        self.converged = np.array([True] * (n - 1) + [False])
        self.residual_norm = np.full(n, 1e-5)
        self.linear_iters = np.full(n, 40)


def test_step_logger(tmp_path):
    buf = io.StringIO()
    nd = str(tmp_path / "steps.ndjson")
    logger = StepLogger(stream=buf, ndjson_path=nd, every=2)
    summary = logger.log_run(FakeStats(5), dt_phys=1e-3)
    assert summary["steps"] == 5
    assert summary["newton_iters_total"] == 15
    assert not summary["all_converged"]
    assert summary["diverged_steps"] == [4]
    lines = open(nd).read().strip().split("\n")
    assert len(lines) == 5
    assert "DIVERGED" in buf.getvalue() or "WARNING" in buf.getvalue()


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.counts["a"] == 2
    assert "a" in t.report()


def test_checkpoint_resume(tmp_path):
    from gmpnp.io.checkpoint import (
        TransientCheckpointer,
        run_transient_checkpointed,
    )

    # simple linear step: u <- u + 1, extra counts steps
    def step(u, theta):
        return u + 1.0, {"it": jnp.asarray(1)}

    carry0 = (jnp.zeros((4, 2)), jnp.asarray(0.0))

    ck1 = TransientCheckpointer(str(tmp_path / "ck"), cfg={"model": "toy"})
    carry, ys = run_transient_checkpointed(step, carry0, 10, ck1, chunk=4)
    u_final, extra = carry
    np.testing.assert_allclose(np.asarray(u_final), 10.0)
    ck1.close()

    # resume: latest checkpoint is at step 10 -> nothing to do, final kept
    ck2 = TransientCheckpointer(str(tmp_path / "ck"), cfg={"model": "toy"})
    carry2, _ = run_transient_checkpointed(step, carry0, 10, ck2, chunk=4)
    np.testing.assert_allclose(np.asarray(carry2[0]), 10.0)

    # extend the run: resumes from 10, adds 5 more
    carry3, _ = run_transient_checkpointed(step, carry0, 15, ck2, chunk=4)
    np.testing.assert_allclose(np.asarray(carry3[0]), 15.0)
    ck2.close()

    # config change is rejected
    ck3 = TransientCheckpointer(str(tmp_path / "ck"), cfg={"model": "other"})
    with pytest.raises(ValueError):
        run_transient_checkpointed(step, carry0, 10, ck3, chunk=4)
    ck3.close()


def test_vtu_readable_by_reference_tools(tmp_path):
    """VTU output parses as valid XML with consistent sizes."""
    import xml.etree.ElementTree as ET

    from gmpnp.io.vtk import write_pvd, write_vtu
    from gmpnp.mesh import cylinder_mesh

    m = cylinder_mesh(50e-9, 5e-9, n_rings=2, n_layers=4)
    p = tmp_path / "f.vtu"
    write_vtu(str(p), m.points, m.cells, {"c": np.ones(m.num_vertices)})
    tree = ET.parse(str(p))
    piece = tree.find(".//Piece")
    assert int(piece.get("NumberOfPoints")) == m.num_vertices
    assert int(piece.get("NumberOfCells")) == m.num_cells
    write_pvd(str(tmp_path / "f.pvd"), "f.vtu")
    ET.parse(str(tmp_path / "f.pvd"))
