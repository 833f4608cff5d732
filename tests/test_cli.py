"""CLI smoke tests: flags parse, runs execute, outputs land."""

import json
import os

import numpy as np
import pytest


def test_rxn_diff_1d_cli(tmp_path, monkeypatch):
    from gmpnp.cli import rxn_diff_1d as cli

    # tiny run: patch the schedule via config default? Use the real CLI with
    # L_n=1um but limit steps by patching run
    import gmpnp.models.rxn_diff_1d as model

    orig = model.run
    monkeypatch.setattr(model, "run",
                        lambda cfg, out_root=None, **kw: orig(
                            cfg, out_root=out_root, n_steps=2))
    res = cli.main(["--L_n", "1e-6", "--out_root", str(tmp_path)])
    assert os.path.exists(os.path.join(res["run_dir"], "metadata.json"))


def test_edl_cli_dry_run(tmp_path, monkeypatch):
    from gmpnp.cli import edl_1d as cli
    import gmpnp.models.edl_1d as model

    orig = model.run
    monkeypatch.setattr(model, "run",
                        lambda cfg, out_root=None, **kw: orig(
                            cfg, out_root=out_root, n_steps=2))
    res = cli.main(["--L_n", "1e-6", "--model", "PNP",
                    "--voltage_multiplier", "-2.0",
                    "--out_root", str(tmp_path)])
    meta = json.load(open(os.path.join(res["run_dir"], "metadata.json")))
    assert meta["model"] == "PNP"
    assert meta["voltage_multiplier"] == -2.0


def test_stern_cli(tmp_path):
    from gmpnp.cli import stern as cli

    out = cli.main(["--out_root", str(tmp_path)])
    assert len(out) == 5


def test_pore_cli(tmp_path, monkeypatch):
    from gmpnp.cli import pore_3d as cli
    import gmpnp.models.pore_3d as model

    orig_build = model.build

    def small_build(cfg):
        import dataclasses
        return orig_build(dataclasses.replace(cfg, mesh_resolution=(2, 8)))

    monkeypatch.setattr(model, "build", small_build)
    res = cli.main(["--out_root", str(tmp_path), "--n_steps", "2"])
    assert "voltage_multiplier" in json.load(
        open(os.path.join(res["run_dir"], "metadata.json")))


def test_rxn_diff_3d_cli(tmp_path, monkeypatch):
    from gmpnp.cli import rxn_diff_3d as cli
    import gmpnp.models.pore_3d as model

    orig_build = model.build

    def small_build(cfg):
        import dataclasses
        return orig_build(dataclasses.replace(cfg, mesh_resolution=(2, 8)))

    monkeypatch.setattr(model, "build", small_build)
    res = cli.main(["--out_root", str(tmp_path), "--n_steps", "2"])
    meta = json.load(open(os.path.join(res["run_dir"], "metadata.json")))
    # rxn-diff metadata has no voltage key (ref 3D/rxn_diff_CO2ER_pore.py)
    assert "voltage_multiplier" not in meta
    assert "CO2_min" in meta


def test_bulk_soln_cli(tmp_path):
    from gmpnp.cli import bulk_soln as cli

    sol = cli.main(["--conc", "0.1", "--out_dir", str(tmp_path)])
    assert os.path.exists(tmp_path / "bulk_soln_0.1KHCO3.yaml")
    assert 6.5 < sol.post_pH < 7.2


def test_mesh_tests_cli():
    from gmpnp.cli import mesh_tests as cli

    wall, entry, exit_ = cli.main(["--L", "50e-9", "--R", "5e-9"])
    import math
    assert wall == pytest.approx(2 * math.pi * 0.1, rel=5e-2)


def test_iv_reader(tmp_path):
    from gmpnp.models.rxn_diff_1d import read_iv_data

    p = tmp_path / "iv.csv"
    p.write_text("-1.0,0.1,0.5,0.2\n-1.5,0.2,0.9,0.4\n")
    volt, HCOO, CO, H2 = read_iv_data(str(p))
    assert volt == [-1.0, -1.5]
    assert CO == [0.5, 0.9]


@pytest.mark.slow
def test_pore_cli_kill_and_resume(tmp_path):
    """Checkpointed CLI run killed after 2 steps and resumed to 4 produces
    the same final fields as an uninterrupted 4-step run (checkpointing
    wired into the CLIs)."""
    from gmpnp.cli import pore_3d as cli

    common = ["--L", "100e-9", "--R", "10e-9", "--mesh_resolution", "2", "8",
              "--out_root"]
    ck = str(tmp_path / "ckpt")

    # uninterrupted reference run
    res_full = cli.main(common + [str(tmp_path / "full"), "--n_steps", "4"])

    # "killed" after 2 steps (checkpoint saved), then resumed to 4
    cli.main(common + [str(tmp_path / "part"), "--n_steps", "2",
                       "--checkpoint_dir", ck, "--checkpoint_every", "2"])
    res_res = cli.main(common + [str(tmp_path / "resumed"), "--n_steps", "4",
                                 "--checkpoint_dir", ck,
                                 "--checkpoint_every", "2"])

    a = np.load(os.path.join(res_full["run_dir"], "arrays_unscaled.npz"))
    b = np.load(os.path.join(res_res["run_dir"], "arrays_unscaled.npz"))
    for k in a:
        np.testing.assert_allclose(b[k][-1], a[k][-1], rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.slow
def test_pore_cli_resume_at_completion(tmp_path):
    """Re-invoking a FINISHED checkpointed run must exit cleanly and rewrite
    the finished run's outputs — not crash on stats=None (a
    resume-at-completion returns stats=None)."""
    from gmpnp.cli import pore_3d as cli

    common = ["--L", "100e-9", "--R", "10e-9", "--mesh_resolution", "2", "8",
              "--out_root"]
    ck = str(tmp_path / "ckpt")

    res1 = cli.main(common + [str(tmp_path / "first"), "--n_steps", "4",
                              "--checkpoint_dir", ck,
                              "--checkpoint_every", "2"])
    # nothing left to do: the natural "is it done?" re-invocation
    res2 = cli.main(common + [str(tmp_path / "again"), "--n_steps", "4",
                              "--checkpoint_dir", ck,
                              "--checkpoint_every", "2"])

    meta2 = json.load(open(os.path.join(res2["run_dir"], "metadata.json")))
    assert meta2["resumed_complete"] is True
    assert meta2["all_steps_converged"] is True

    a = np.load(os.path.join(res1["run_dir"], "arrays_unscaled.npz"))
    b = np.load(os.path.join(res2["run_dir"], "arrays_unscaled.npz"))
    for k in ("H", "OH", "CO2", "p"):
        np.testing.assert_allclose(b[k][-1], a[k][-1], rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.slow
def test_edl_cli_resume_at_completion(tmp_path):
    """Same regression for the 1D EDL CLI (models/edl_1d.py:461)."""
    from gmpnp.cli import edl_1d as cli

    common = ["--L_n", "1e-6", "--model", "PNP",
              "--n_steps", "3", "--out_root"]
    ck = str(tmp_path / "ckpt")

    res1 = cli.main(common + [str(tmp_path / "first"),
                              "--checkpoint_dir", ck,
                              "--checkpoint_every", "3"])
    res2 = cli.main(common + [str(tmp_path / "again"),
                              "--checkpoint_dir", ck,
                              "--checkpoint_every", "3"])

    meta2 = json.load(open(os.path.join(res2["run_dir"], "metadata.json")))
    assert meta2["resumed_complete"] is True

    a = np.load(os.path.join(res1["run_dir"], "arrays_unscaled.npz"))
    b = np.load(os.path.join(res2["run_dir"], "arrays_unscaled.npz"))
    for k in ("H", "OH", "p"):
        np.testing.assert_allclose(b[k][-1], a[k][-1], rtol=1e-10,
                                   atol=1e-12)


def test_pore_cli_record_stride(tmp_path):
    from gmpnp.cli import pore_3d as cli

    res = cli.main(["--L", "100e-9", "--R", "10e-9",
                    "--mesh_resolution", "2", "8",
                    "--out_root", str(tmp_path), "--n_steps", "4",
                    "--record_stride", "2"])
    a = np.load(os.path.join(res["run_dir"], "arrays_unscaled.npz"))
    for k in ("H", "OH", "HCO3", "CO32", "CO2", "CO", "H2", "cat", "p"):
        assert a[k].shape[0] == 3   # u0 + 2 recorded states
        assert np.isfinite(a[k]).all()
    assert a["tau"].shape[0] == 2


def test_edl_cli_yn_flag_parsing():
    """Regression (round 3): '--dry_run N' must parse False.  The original
    _bool treated 'N' as truthy, so the V=-12.5 full-length recovery run
    silently executed the 100-step dry-run schedule with zero dt retries
    (dry runs default to no recovery)."""
    from gmpnp.cli import edl_1d as cli

    p = cli.build_parser()
    assert p.parse_args(["--dry_run", "N"]).dry_run is False
    assert p.parse_args(["--dry_run", "n"]).dry_run is False
    assert p.parse_args(["--dry_run", "Y"]).dry_run is True
    assert p.parse_args(["--dry_run", "y"]).dry_run is True
    assert p.parse_args(["--dry_run", "false"]).dry_run is False
    with pytest.raises(SystemExit):
        p.parse_args(["--dry_run", "maybe"])


def test_newton_recovery_flags_thread_into_config():
    """--newton_backtracking / --newton_bt_growth reach NewtonConfig."""
    from gmpnp.cli.pore_3d import build_parser, config_from_args

    args = build_parser().parse_args(
        ["--newton_backtracking", "4", "--newton_bt_growth", "10.0"])
    cfg = config_from_args(args, "GMPNP")
    assert cfg.newton.backtracking == 4
    assert cfg.newton.bt_growth == 10.0


def test_linear_refresh_flag_threads_into_config():
    """--linear_refresh reaches LinearConfig (carried production mode)."""
    from gmpnp.cli.pore_3d import build_parser, config_from_args

    args = build_parser().parse_args(["--linear_refresh", "carried"])
    cfg = config_from_args(args, "GMPNP")
    assert cfg.linear.refresh == "carried"
    # default stays reference-parity exact Newton
    cfg0 = config_from_args(build_parser().parse_args([]), "GMPNP")
    assert cfg0.linear.refresh == "iter"
