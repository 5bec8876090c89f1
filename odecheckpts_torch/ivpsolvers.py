"""Solver construction: prior, correction, strategy, calibration (PyTorch
counterpart of ``odecheckpts_tpu.ivpsolvers``).

Ported so far: the IBM prior on the isotropic, the dense and the blockdiag
backend, the TS0 and TS1 corrections, the filter, smoother and fixedpoint
strategies, the none and the dynamic calibration, and the single-solve
building blocks ``linearize`` / ``error_and_scale`` / ``correct`` on the
isotropic backend (the fixed-grid solves of ``ivpsolve`` and
``parallel_time``).  Every config object is a frozen dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import ssm as ssm_lib


def prior_ibm(*, num_derivatives: int, ode_shape: tuple, implementation: str = "isotropic"):
    """nu-times integrated Wiener process prior on the chosen SSM backend."""
    return ssm_lib.choose(
        implementation, ode_shape=ode_shape, num_derivatives=num_derivatives
    )


#: Default local-error calibration per error unit (see the reference module
#: for how these were measured).
ERROR_CALIBRATION = {"qoi": 10.0, "residual": 1.0}
ERROR_CALIBRATION_TS1_QOI = 20.0


def default_error_calibration(method: str, error_unit: str) -> float:
    if method == "ts1" and error_unit == "qoi":
        return ERROR_CALIBRATION_TS1_QOI
    return ERROR_CALIBRATION[error_unit]


@dataclasses.dataclass(frozen=True)
class Correction:
    method: str
    ode_order: int
    error_unit: str = "qoi"
    error_calibration: float = None

    @property
    def calibration_factor(self) -> float:
        if self.error_calibration is not None:
            return float(self.error_calibration)
        return default_error_calibration(self.method, self.error_unit)


def _correction(method, ode_order, error_unit, error_calibration):
    if ode_order != 1:
        raise NotImplementedError(
            "ode_order != 1 is not ported yet: ROADMAP queue 1 item 5"
        )
    if error_unit not in ("qoi", "residual"):
        raise ValueError(f"error_unit must be 'qoi' or 'residual', got {error_unit!r}")
    return Correction(method, ode_order, error_unit, error_calibration)


def correction_ts0(*, ode_order: int = 1, error_unit: str = "qoi",
                   error_calibration: float = None) -> Correction:
    """Zeroth-order Taylor linearization (EK0) on derivative ``ode_order``."""
    return _correction("ts0", ode_order, error_unit, error_calibration)


def correction_ts1(*, ode_order: int = 1, error_unit: str = "qoi",
                   error_calibration: float = None) -> Correction:
    """First-order Taylor linearization (EK1): the observation carries the
    vector field's Jacobian (``odecheckpts_tpu/ivpsolvers.py:102-110``).
    Requires the dense backend (see ``Strategy``)."""
    return _correction("ts1", ode_order, error_unit, error_calibration)


FILTER, SMOOTHER, FIXEDPOINT = "filter", "smoother", "fixedpoint"


@dataclasses.dataclass(frozen=True)
class Strategy:
    ssm: Any
    correction: Correction
    kind: str

    def __post_init__(self):
        if self.correction.method == "ts1" and self.ssm.name != "dense":
            raise ValueError("correction_ts1 requires the dense backend")

    @property
    def needs_reversal(self) -> bool:
        return self.kind != FILTER


def strategy_filter(prior, correction: Correction) -> Strategy:
    """Forward-only estimation: marginals at steps, O(1) state."""
    return Strategy(prior, correction, FILTER)


def strategy_smoother(prior, correction: Correction) -> Strategy:
    """Store a backward transition per step: O(#steps) memory dense output."""
    return Strategy(prior, correction, SMOOTHER)


def strategy_fixedpoint(prior, correction: Correction) -> Strategy:
    """The paper's fixed-point smoother: backward transitions are composed
    between checkpoints inside the forward pass (O(#checkpoints) memory)."""
    return Strategy(prior, correction, FIXEDPOINT)


NONE, DYNAMIC, MLE = "none", "dynamic", "mle"


@dataclasses.dataclass(frozen=True)
class Solver:
    strategy: Strategy
    calibration: str

    @property
    def ssm(self):
        return self.strategy.ssm

    def initial_condition(self, tcoeffs, output_scale):
        """Exact (zero-covariance) initial state from Taylor coefficients."""
        rv = self.ssm.stack_tcoeffs(tcoeffs)
        scale = torch.as_tensor(output_scale, dtype=rv.mean.dtype, device=rv.mean.device)
        return rv, scale


def solver(strategy: Strategy) -> Solver:
    """Uncalibrated solver: the prior output scale is used as given."""
    return Solver(strategy, NONE)


def solver_dynamic(strategy: Strategy) -> Solver:
    """Per-step (quasi-MLE) output-scale calibration."""
    return Solver(strategy, DYNAMIC)


def solver_mle(strategy: Strategy) -> Solver:
    """Global MLE calibration, applied post hoc to the posterior: not ported."""
    raise NotImplementedError(
        "solver_mle (post-hoc rescaling of the posterior) is not ported yet: "
        "ROADMAP queue 1 item 2"
    )


def _isotropic_only(ssm, what):
    if ssm.name != "isotropic":
        raise NotImplementedError(
            f"{what} on the {ssm.name} backend (h_q_unit / h_l_rows / correct_affine, the "
            "blockdiag single-solve methods) is not ported yet: ROADMAP queue 1 item 3"
        )


def linearize(strategy: Strategy, vf, m_pred, t):
    """Residual ``z = u^(o) - vf(u, ..., u^(o-1), t)`` of the ODE constraint
    at the predicted mean, and the Jacobians (TS0: none).  ``m_pred`` may
    carry leading batch axes if ``vf`` takes them."""
    ssm = strategy.ssm
    o = strategy.correction.ode_order
    if strategy.correction.method != "ts0":
        raise NotImplementedError(
            "the TS1 linearization of a single solve (Jacobians by torch.func.jacfwd) comes "
            "with the dense adapter: ROADMAP queue 1 item 3"
        )
    args = tuple(ssm.select_deriv(m_pred, i) for i in range(o))
    z = ssm.select_deriv(m_pred, o) - vf(*args, t=t)
    return z, ()


def error_and_scale(strategy: Strategy, z, jacobians, cache):
    """Per-step MLE output scale (sigma-hat) and local error estimate."""
    del jacobians
    ssm = strategy.ssm
    _isotropic_only(ssm, "error_and_scale")
    return ssm.error_and_scale_deriv(
        z, cache, strategy.correction.ode_order, unit=strategy.correction.error_unit
    )


def correct(strategy: Strategy, rv_pred, z, jacobians):
    """Square-root correction of the predicted state on the ODE constraint."""
    del jacobians
    ssm = strategy.ssm
    _isotropic_only(ssm, "correct")
    return ssm.correct_deriv(rv_pred, z, strategy.correction.ode_order)
