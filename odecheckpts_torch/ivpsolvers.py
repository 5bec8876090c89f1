"""Solver construction: prior, correction, strategy, calibration (PyTorch
counterpart of ``odecheckpts_tpu.ivpsolvers``).

The IBM prior on the isotropic, the dense and the blockdiag backend, the TS0
and TS1 corrections, the filter, smoother and fixedpoint strategies, the
none, dynamic and MLE calibrations, and the single-solve building blocks
``linearize`` / ``error_and_scale`` / ``correct`` that every solve driver of
``ivpsolve`` and ``parallel_time`` runs.  Every config object is a frozen
dataclass.  Not ported: ``ode_order`` other than 1 (ROADMAP queue 1 item 5).
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
    """Global MLE output-scale calibration, applied post hoc to the posterior
    (``ivpsolve._maybe_rescale``)."""
    return Solver(strategy, MLE)


def _call_vf(vf, args, t):
    """``vf(*args, t=t)`` on arguments with leading batch axes: ``vf`` is the
    one-IVP function (arguments (d,)), mapped over the batch by
    ``torch.func.vmap``, with ``t`` a scalar or of the batch shape."""
    batch = args[0].shape[:-1]
    if not batch:
        return vf(*args, t=t)
    flat = [a.reshape((-1, a.shape[-1])) for a in args]
    t_flat = torch.as_tensor(t, dtype=args[0].dtype, device=args[0].device).expand(batch)
    out = torch.func.vmap(lambda *a: vf(*a[:-1], t=a[-1]))(*flat, t_flat.reshape(-1))
    return out.reshape(batch + out.shape[1:])


def _jacobians(vf, args, t):
    """The (..., d, d) Jacobians of ``vf`` in each of its state arguments,
    by ``torch.func.jacfwd``, mapped over the batch axes; in the state's
    dtype (forward-mode tangents of a vector field with Python-float
    parameters come out in float64 for float32 inputs)."""
    batch = args[0].shape[:-1]
    dtype = args[0].dtype
    t = torch.as_tensor(t, dtype=dtype, device=args[0].device)
    out = []
    for k in range(len(args)):
        jac_k = torch.func.jacfwd(lambda *a: vf(*a[:-1], t=a[-1]), argnums=k)
        if batch:
            # forward-mode duals need inputs that own their memory (no expanded views)
            flat = [a.reshape((-1, a.shape[-1])).contiguous() for a in args]
            jac = torch.func.vmap(jac_k)(*flat, t.expand(batch).reshape(-1).contiguous())
            jac = jac.reshape(batch + jac.shape[1:])
        else:
            jac = jac_k(*(a.contiguous() for a in args), t)
        out.append(jac.to(dtype))
    return tuple(out)


def linearize(strategy: Strategy, vf, m_pred, t):
    """Residual ``z = u^(o) - vf(u, ..., u^(o-1), t)`` of the ODE constraint
    at the predicted mean, and (TS1) the vector field's Jacobians.
    ``m_pred`` may carry leading batch axes: ``vf`` is the one-IVP function
    and is mapped over them (``_call_vf``)."""
    ssm = strategy.ssm
    o = strategy.correction.ode_order
    args = tuple(ssm.select_deriv(m_pred, i) for i in range(o))
    z = ssm.select_deriv(m_pred, o) - _call_vf(vf, args, t)
    if strategy.correction.method == "ts0":
        return z, ()
    return z, _jacobians(vf, args, t)


def error_and_scale(strategy: Strategy, z, jacobians, cache):
    """Local error estimate and per-step MLE output scale (sigma-hat)."""
    ssm = strategy.ssm
    o = strategy.correction.ode_order
    unit = strategy.correction.error_unit
    if ssm.name in ("isotropic", "blockdiag"):
        return ssm.error_and_scale_deriv(z, cache, o, unit=unit)
    h_q = ssm.h_q_unit(cache, o, jacobians)
    return ssm.error_and_scale(z, h_q, cache, unit=unit)


def correct(strategy: Strategy, rv_pred, z, jacobians):
    """Square-root correction of the predicted state on the ODE constraint."""
    ssm = strategy.ssm
    o = strategy.correction.ode_order
    if ssm.name in ("isotropic", "blockdiag"):
        return ssm.correct_deriv(rv_pred, z, o)
    h_l = ssm.h_l_rows(rv_pred.cholesky, o, jacobians)
    return ssm.correct_affine(rv_pred, z, h_l)
