"""Solver construction: prior, correction, strategy, calibration (PyTorch
counterpart of ``odecheckpts_tpu.ivpsolvers``).

Ported so far: the IBM prior on the isotropic, the dense and the blockdiag
backend, the TS0 and TS1 corrections, the filter, smoother and fixedpoint
strategies and dynamic calibration -- the configurations of the batched
paths.  Every config object is a frozen
dataclass.
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
            "ode_order != 1 is not ported yet: ROADMAP queue 1 item 3a"
        )
    if error_unit != "qoi":
        raise NotImplementedError(
            f"error_unit={error_unit!r} is not ported yet: ROADMAP queue 1 item 3a"
        )
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


DYNAMIC = "dynamic"


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


def solver_dynamic(strategy: Strategy) -> Solver:
    """Per-step (quasi-MLE) output-scale calibration."""
    return Solver(strategy, DYNAMIC)
