"""The f32 dense fixedpoint smoother, port against reference, on the stiff
Brusselator row of ``chip_smoke.py`` (``experiments/4_brusselator/
dense_ts1_tpu.py``: N = 2, TS1, nu 4, rtol 1e-5, dt0 0.01, tspan (0, 10),
5 checkpoints; u0 (1 + 0.02 N(0, 1)) from numpy seed 0, the first 256 rows,
which are the lanes that ``chip_smoke.py`` samples).

The row's gate (RMSE < 10 rtol, every lane < 20 rtol, against
LSODA(rtol = atol = 1e-10)) holds for the filtered checkpoint values of both
packages in f32.  The smoothed values (the solvers' first output) miss the
lane gate on some lanes by orders of magnitude, in the reference's f32
``engine="xla"`` as in the port's f32 twin: the backward conditionals that
the fixedpoint step accumulates in f32 carry large gains on this stiff
problem, and the backward pass multiplies the filter's f32 error by them.
Which lanes miss moves with the last ulp (the reference's jitted CPU code,
the twin and the card's kernel each miss on other rows of the sample), so
the tests hold the two packages to the same kind of miss, not to the same
rows; in f64 the port's smoothed values meet the gate on every row that
missed in either package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import batched_dense as jbd
from odecheckpts_tpu import problems as jp
from odecheckpts_torch import batched as tb
from odecheckpts_torch import problems as tp

RTOL = 1e-5
SAMPLE = 256
SAVE_AT = np.linspace(0.0, 10.0, 5)
RMSE_GATE, LANE_GATE = 10.0, 20.0  # in units of rtol


def _truth(rows):
    """LSODA(rtol = atol = 1e-10) at the checkpoints, as the reference's
    experiment computes it (``dense_ts1_tpu.py:36-59``)."""
    import scipy.integrate

    n = 2
    c = 1.0 / 50.0 * (n + 1) ** 2

    def vf(_t, y):
        u, v = y[:n], y[n:]
        u_ = np.concatenate([[1.0], u, [1.0]])
        v_ = np.concatenate([[3.0], v, [3.0]])
        cu = u_[:-2] - 2.0 * u_[1:-1] + u_[2:]
        cv = v_[:-2] - 2.0 * v_[1:-1] + v_[2:]
        return np.concatenate([1.0 + u**2 * v - 4.0 * u + c * cu, 3.0 * u - u**2 * v + c * cv])

    return np.stack([
        scipy.integrate.solve_ivp(vf, (SAVE_AT[0], SAVE_AT[-1]), row, t_eval=SAVE_AT,
                                  rtol=1e-10, atol=1e-10, method="LSODA").y.T
        for row in rows
    ])


def _lane_errors(u, truth):
    """Per-lane RMSE over the checkpoints, in units of rtol."""
    return np.sqrt(np.mean((np.asarray(u, np.float64) - truth) ** 2, axis=(1, 2))) / RTOL


@pytest.fixture(scope="module")
def row():
    vf, (y0,), _, params = tp.brusselator(2)
    jvf, _, _, _ = jp.brusselator(2, laplacian="slices")
    rng = np.random.default_rng(0)
    u0s = (y0.numpy()[None] * (1.0 + 0.02 * rng.standard_normal((SAMPLE, 4)))).astype(np.float32)
    truth = _truth(u0s.astype(np.float64))
    save_at = SAVE_AT.astype(np.float32)
    ref = jbd.solve_save_at_batched_dense(
        jvf, jnp.asarray(u0s), (), save_at=jnp.asarray(save_at), dt0=0.01,
        tols=jnp.full((SAMPLE,), RTOL, jnp.float32), engine="xla", correction="ts1",
        lanes=SAMPLE)
    port = tb.solve_save_at_batched(
        vf, torch.tensor(u0s), params, save_at=save_at, dt0=0.01,
        tols=torch.full((SAMPLE,), RTOL), correction="ts1", implementation="dense")
    out = {"reference": tuple(np.asarray(x) for x in ref),
           "port": tuple(x.numpy() for x in port)}
    assert out["reference"][0].dtype == out["port"][0].dtype == np.float32
    missed = sorted(set().union(*(
        np.nonzero(_lane_errors(o[0], truth) >= LANE_GATE)[0].tolist() for o in out.values())))
    port64 = tb.solve_save_at_batched(
        vf, torch.tensor(u0s[missed], dtype=torch.float64), params, save_at=SAVE_AT, dt0=0.01,
        tols=torch.full((len(missed),), RTOL, dtype=torch.float64), correction="ts1",
        implementation="dense")
    return {"truth": truth, "missed": missed, "port64": tuple(x.numpy() for x in port64), **out}


@pytest.mark.parametrize("package", ["reference", "port"])
def test_f32_filtered_values_meet_the_row_gate(row, package):
    _, u_f, n = row[package]
    lanes = _lane_errors(u_f, row["truth"])
    rmse = np.sqrt(np.mean((u_f.astype(np.float64) - row["truth"]) ** 2)) / RTOL
    assert rmse < RMSE_GATE and np.max(lanes) < LANE_GATE
    assert np.mean(n[:, -1]) > 100  # the stiff row: ~130 accepted steps a lane


@pytest.mark.parametrize("package", ["reference", "port"])
def test_f32_smoothed_values_miss_the_lane_gate_in_both_packages(row, package):
    u_s, u_f, _ = row[package]
    lanes = _lane_errors(u_s, row["truth"])
    assert np.all(np.isfinite(u_s))
    # the miss is the backward pass's: the last checkpoint is the filtered value
    np.testing.assert_array_equal(u_s[:, -1], u_f[:, -1])
    assert np.sum(lanes >= LANE_GATE) >= 3, np.sort(lanes)[-5:]
    assert np.max(lanes) >= 100.0, np.max(lanes)


def test_f64_smoothed_values_meet_the_gate_on_the_missed_rows(row):
    u_s, u_f, _ = row["port64"]
    truth = row["truth"][row["missed"]]
    assert len(row["missed"]) >= 6  # rows missed by either package
    assert np.max(_lane_errors(u_s, truth)) < LANE_GATE
    assert np.max(_lane_errors(u_f, truth)) < LANE_GATE
