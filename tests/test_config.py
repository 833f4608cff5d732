"""Typed config tree: YAML round-trip + overrides + nested solver blocks."""

import pytest

from gmpnp.config import dump_config, load_config
from gmpnp.models.edl_1d import EDL1DConfig
from gmpnp.models.pore_3d import Pore3DConfig


def test_yaml_roundtrip(tmp_path):
    cfg = Pore3DConfig(voltage_multiplier=-3.0, cation="Cs", faithful=False)
    p = tmp_path / "run.yaml"
    dump_config(cfg, str(p))
    back = load_config(Pore3DConfig, str(p))
    assert back == cfg


def test_overrides_and_nested(tmp_path):
    cfg = load_config(
        EDL1DConfig, None,
        {"voltage_multiplier": -7.5,
         "newton": {"max_iter": 10, "relaxation": 0.8}})
    assert cfg.voltage_multiplier == -7.5
    assert cfg.newton.max_iter == 10
    assert cfg.newton.relaxation == 0.8
    # untouched nested fields keep defaults
    assert cfg.newton.rtol == 1.0e-4


def test_unknown_key_rejected():
    with pytest.raises(KeyError):
        load_config(EDL1DConfig, None, {"voltage_multiplyer": -1.0})


def test_yaml_plus_override(tmp_path):
    p = tmp_path / "base.yaml"
    p.write_text("voltage_multiplier: -2.0\ncation: Li\n")
    cfg = load_config(EDL1DConfig, str(p), {"cation": "Na"})
    assert cfg.voltage_multiplier == -2.0
    assert cfg.cation == "Na"
