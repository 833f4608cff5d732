"""Golden-snapshot regression tests for short transients of every model.

The snapshots live in tests/goldens/ (committed); regenerate deliberately
with GMPNP_REGEN_GOLDENS=1 after an intentional numerical change.
Tolerance 1e-7 relative: loose enough for cross-platform XLA fusion
differences, tight enough to catch any real numerical regression.
"""

import os

import numpy as np
import pytest

from gmpnp.testing import GoldenFile, field_summary, rel_l2

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _check(name, data, rtol=1e-7):
    g = GoldenFile(os.path.join(GOLDEN_DIR, name), rtol=rtol)
    msg = g.check(data)
    assert msg is None, msg


def test_rel_l2():
    a = np.ones((4, 2))
    b = np.ones((4, 2)) * 1.001
    assert rel_l2(a, b) == pytest.approx(0.001 / 1.001, rel=1e-6)


def test_golden_rxn_diff_1d():
    from gmpnp.models import rxn_diff_1d as rd

    prog = rd.build(rd.RxnDiff1DConfig(L_n=1.0e-6))
    _, hist, stats = prog.run(n_steps=5)
    assert bool(np.asarray(stats.converged).all())
    _check("rxn_diff_1d_5steps.json", {
        "fields": field_summary(np.asarray(hist[-1]), rd.SPECIES),
        "newton_iters": int(np.asarray(stats.newton_iters).sum()),
    })


def test_golden_edl_1d_mpnp():
    from gmpnp.models import edl_1d

    prog = edl_1d.build(edl_1d.EDL1DConfig(L_n=1.0e-6, dry_run=True))
    _, hist, stats, _ = prog.run(n_steps=5)
    assert bool(np.asarray(stats.converged).all())
    names = list(prog.config.species) + ["p"]
    _check("edl_1d_mpnp_5steps.json", {
        "fields": field_summary(np.asarray(hist[-1]), names),
        "newton_iters": int(np.asarray(stats.newton_iters).sum()),
    })


def test_golden_pore_3d_gmpnp():
    from gmpnp.models import pore_3d

    prog = pore_3d.build(pore_3d.Pore3DConfig(
        physics="GMPNP", mesh_resolution=(2, 10)))
    _, hist, stats, _ = prog.run(n_steps=3)
    assert bool(np.asarray(stats.converged).all())
    names = list(prog.config.species) + ["p"]
    # 3D fields are converged only to the Krylov inner tolerance (1e-6
    # relative per solve -> ~1e-4 field reproducibility across binaries)
    _check("pore_3d_gmpnp_3steps.json", {
        "fields": field_summary(np.asarray(hist[-1]), names),
    }, rtol=5e-4)


def test_golden_pore_3d_rxn_diff():
    from gmpnp.models import pore_3d

    prog = pore_3d.build(pore_3d.Pore3DConfig(
        physics="rxn_diff", mesh_resolution=(2, 10)))
    _, hist, stats, _ = prog.run(n_steps=3)
    assert bool(np.asarray(stats.converged).all())
    _check("pore_3d_rxn_diff_3steps.json", {
        "fields": field_summary(np.asarray(hist[-1]), prog.config.species),
    }, rtol=5e-4)


def test_golden_stern():
    from gmpnp.models import stern

    out = stern.run(write=False)
    data = {str(v): {"voltage_electrode": r["voltage_electrode"],
                     "field_surf": r["field_surf"]}
            for v, r in out.items()}
    _check("stern_sweep.json", data, rtol=1e-12)
