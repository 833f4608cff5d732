"""The host-side parts of chip_smoke.py (the GPU phases run only on a card)."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

_PATH = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rel_l2(chip_smoke):
    b = np.arange(1.0, 7.0).reshape(2, 3)
    assert chip_smoke.rel_l2(b, b) == 0.0
    a = b + 1e-3 * np.array([[1.0, 0, 0], [0, 0, 0]])
    assert chip_smoke.rel_l2(a, b) == pytest.approx(1e-3 / np.linalg.norm(b))
    assert chip_smoke.rel_l2(np.zeros(3), np.zeros(3)) == 0.0
    assert chip_smoke.rel_l2(np.ones(3), np.zeros(3)) == float("inf")


def test_result_line(chip_smoke):
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_refuses_cpu(chip_smoke, capsys):
    """With no GPU the script stops before any phase and prints no result."""
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
