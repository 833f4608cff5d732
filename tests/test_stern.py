"""Stern post-solve tests: closed form vs scipy odeint of the reference ODE,
linear model algebra, sweep outputs."""

import numpy as np
import pytest

from gmpnp.models import stern


def _odeint_reference(voltage_scaled_OHP, field_OHP, eps_rel_OHP,
                      swapped=True):
    """Replicate the reference integration (1D/Stern_CO2ER.py:82-98):
    odeint of  y2' = -y2 (ea - eb) / (x (ea - eb) + ea L)  with
    (ea, eb) = (6.0, eps_rel_OHP) in the shipped (swapped-args) call."""
    from scipy.integrate import odeint

    nat = stern.DEFAULT_OHP_RESULTS  # unused; constants below
    thermal_voltage = 1.38e-23 * 298.15 / 1.602e-19
    L = stern.L_STERN
    if swapped:
        ea, eb = stern.EPS_SURFACE, eps_rel_OHP
    else:
        ea, eb = eps_rel_OHP, stern.EPS_SURFACE

    def rhs(Y, x):
        y1, y2 = Y
        return [y2, -y2 * (ea - eb) / (x * (ea - eb) + ea * L)]

    dx = 1.0e-11
    x = np.linspace(0, -L, abs(int(-L / dx)))
    y0 = [voltage_scaled_OHP * thermal_voltage, -field_OHP]
    sol = odeint(rhs, y0, x, rtol=1e-12, atol=1e-14)
    return x, sol


@pytest.mark.parametrize("arg_order", ["reference", "corrected"])
def test_bdm_closed_form_matches_odeint(arg_order):
    v, E, eps = -5.0, -0.2524415478848975, 57.64572780716129
    cfg = stern.SternConfig(voltage_scaled_OHP=v, field_OHP=E,
                            eps_rel_OHP=eps, arg_order=arg_order)
    res = stern.solve_stern(cfg)
    x_ref, sol = _odeint_reference(v, E, eps,
                                   swapped=(arg_order == "reference"))
    np.testing.assert_allclose(res["x"], x_ref)
    np.testing.assert_allclose(res["potential"], sol[:, 0], rtol=1e-9)
    np.testing.assert_allclose(res["field"], -sol[:, 1], rtol=1e-9)


def test_linear_model():
    v, E = -2.5, -0.08
    cfg = stern.SternConfig(voltage_scaled_OHP=v, field_OHP=E,
                            model="Stern_linear")
    res = stern.solve_stern(cfg)
    thermal_voltage = 1.38e-23 * 298.15 / 1.602e-19
    v_ohp = v * thermal_voltage
    # electrode potential: v_OHP + field * L (nm units, ref :139)
    assert res["voltage_electrode"] == pytest.approx(
        v_ohp + E * stern.L_STERN * 1e9)
    # potential profile linear with slope -field
    x = res["x_scaled"]
    np.testing.assert_allclose(res["potential"], -E * x + v_ohp)


def test_sweep_outputs(tmp_path):
    out = stern.run(out_root=str(tmp_path), write=True)
    assert set(out.keys()) == set(stern.DEFAULT_OHP_RESULTS.keys())
    import os
    for v, res in out.items():
        d = res["run_dir"]
        assert os.path.exists(os.path.join(d, "metadata.txt"))
        assert os.path.exists(os.path.join(d, f"stern_unscaled_BDM{v}.npz"))
        assert os.path.exists(os.path.join(d, f"stern_scaled_BDM{v}.npz"))
        # reference writes the profile plots per run (ref :118-136)
        assert os.path.exists(os.path.join(d, "V_x.png"))
        assert os.path.exists(os.path.join(d, "field_x.png"))
        txt = open(os.path.join(d, "metadata.txt")).read()
        assert "voltage at the electrode" in txt
        # negative applied potential: electrode more negative than OHP in
        # magnitude terms (field continues the drop through the layer)
        assert res["voltage_electrode"] < 0


def test_more_negative_voltage_gives_larger_drop():
    out = stern.run(write=False)
    drops = {v: abs(r["voltage_electrode"] - r["voltage_OHP"])
             for v, r in out.items()}
    vs = sorted(drops)            # -12.5 ... -2.5
    vals = [drops[v] for v in vs]
    assert vals == sorted(vals, reverse=True)
