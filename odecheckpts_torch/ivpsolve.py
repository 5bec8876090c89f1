"""Adaptive-solve state, step-size control and checkpoint interpolation
(PyTorch counterpart of the parts of ``odecheckpts_tpu.ivpsolve`` that the
batched solver runs), and the fixed-grid solve ``solve_fixed_grid``,
sequential or parallel in time (``parallel_time``).

Every field of ``_State`` may carry a leading batch dimension: the JAX
package maps one-IVP functions over the ensemble, the port writes the
batch dimension out and selects branches per lane with ``torch.where``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import ivpsolvers
from .ssm.base import Conditional, MarkovSeq, Normal, Solution


@dataclasses.dataclass(frozen=True)
class Control:
    """Proportional-integral step-size controller (clipped power law)."""

    safety: float = 0.95
    factor_min: float = 0.2
    factor_max: float = 10.0
    power_integral: float = 0.3
    power_proportional: float = 0.4


class _State(NamedTuple):
    t: torch.Tensor
    rv: Normal
    bwd: Optional[Conditional]  # fixedpoint: accumulated since the last checkpoint
    scale_step: torch.Tensor  # output scale used in the last accepted step
    t_prev: torch.Tensor  # interpolate_from
    rv_prev: Normal
    bwd_prev: Optional[Conditional]
    dt: torch.Tensor
    errn_prev: torch.Tensor
    num_steps: torch.Tensor
    mle_ssq: torch.Tensor


def _tree_select(pred, a, b):
    """Leafwise ``where(pred, a, b)``; ``pred`` holds the batch shape and is
    broadcast against the trailing axes of every leaf."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*(_tree_select(pred, x, y) for x, y in zip(a, b)))
    extra = max(a.dim(), b.dim()) - pred.dim()
    return torch.where(pred.reshape(pred.shape + (1,) * extra), a, b)


def _expand(tree, batch):
    if isinstance(tree, tuple):
        return type(tree)(*(_expand(x, batch) for x in tree))
    return tree.expand(tuple(batch) + tree.shape)


def _interpolate_at(strategy, state: _State, t):
    """Emit the solution at checkpoint ``t`` (``t_prev <= t <= state.t``)
    and rewire the state for the next interval.

    Per lane: if the last accepted step landed exactly on ``t`` the state
    itself is emitted; otherwise the direct (unpreconditioned) extrapolation
    interpolates.  Both branches are computed and selected per lane.
    Near-degenerate sub-intervals snap to identity conditionals.

    The fixedpoint strategy emits the conditional back to the previous
    checkpoint (``compose(bwd_prev, b1)``), the smoother the one-step
    conditional ``b1``; a strategy without reversal (filter) carries and
    emits no conditionals (``odecheckpts_tpu/ivpsolve.py:231-294``).
    """
    ssm = strategy.ssm
    fixedpoint = strategy.kind == ivpsolvers.FIXEDPOINT
    needs_rev = strategy.needs_reversal
    dtype, device = state.rv.mean.dtype, state.rv.mean.device
    t = torch.as_tensor(t, dtype=dtype, device=device)
    eps_soft = float(torch.finfo(dtype).eps) ** 0.75
    thresh = eps_soft * torch.clamp(torch.abs(t), min=1.0)
    t_b = t.expand_as(state.t)
    ident_b = (_expand(ssm.identity_conditional(dtype, device), state.t.shape)
               if needs_rev else None)

    # branch 1: the state sits exactly on the checkpoint
    emit_exact = (state.rv, state.bwd)
    new_exact = state._replace(
        bwd=ident_b, t_prev=state.t, rv_prev=state.rv, bwd_prev=ident_b
    )

    # branch 2: interpolate inside the last accepted step
    one = torch.ones_like(state.t)
    dt1_raw = t_b - state.t_prev
    close1 = dt1_raw <= thresh
    dt1 = torch.where(close1, one, dt1_raw)
    exact = state.t == t_b
    if not needs_rev:
        rv_t, _ = ssm.extrapolate_direct(state.rv_prev, dt1, state.scale_step, False)
        rv_t = _tree_select(close1, state.rv_prev, rv_t)
        new_interp = state._replace(t_prev=t_b, rv_prev=rv_t)
        emit = (_tree_select(exact, emit_exact[0], rv_t), None)
        return emit, _tree_select(exact, new_exact, new_interp)
    rv_t, b1 = ssm.extrapolate_direct(state.rv_prev, dt1, state.scale_step, True)
    rv_t = _tree_select(close1, state.rv_prev, rv_t)
    b1 = _tree_select(close1, ident_b, b1)
    emit_cond = ssm.compose(state.bwd_prev, b1) if fixedpoint else b1

    dt2_raw = state.t - t_b
    close2 = dt2_raw <= thresh
    dt2 = torch.where(close2, one, dt2_raw)
    _, b2 = ssm.extrapolate_direct(rv_t, dt2, state.scale_step, True)
    b2 = _tree_select(close2, ident_b, b2)
    new_interp = state._replace(bwd=b2, t_prev=t_b, rv_prev=rv_t, bwd_prev=ident_b)

    emit = (
        _tree_select(exact, emit_exact[0], rv_t),
        _tree_select(exact, emit_exact[1], emit_cond),
    )
    return emit, _tree_select(exact, new_exact, new_interp)


def _tree_prepend(first, rest):
    """Leafwise ``cat([first[None], rest])`` over (named) tuples of tensors."""
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_tree_prepend(f, r) for f, r in zip(first, rest)))
    return torch.cat([first[None], rest])


def _tree_stack(items):
    """Stack a list of equal (named) tuples of tensors along a new axis 0."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_tree_stack([x[i] for x in items]) for i in range(len(first))))
    return torch.stack(items)


def _validate_increasing(ts, name):
    """Misuse guard on a grid's values (one host read for a device tensor)."""
    arr = ts.detach().cpu().numpy() if isinstance(ts, torch.Tensor) else np.asarray(ts)
    if arr.ndim != 1 or arr.size == 0:
        raise ValueError(f"{name} must be a non-empty 1-D array")
    if arr.size > 1 and not np.all(np.diff(arr) > 0):
        raise ValueError(f"{name} must be strictly increasing")


def _check_calibration(solver):
    if solver.calibration not in (ivpsolvers.NONE, ivpsolvers.DYNAMIC):
        raise NotImplementedError(
            f"calibration={solver.calibration!r}: the post-hoc MLE rescaling of the posterior "
            "is not ported yet: ROADMAP queue 1 item 2"
        )


def solve_adaptive_parallel_in_time(*args, **kwargs):
    """Adaptive grid discovery followed by a parallel-in-time pass on the
    discovered grid (``odecheckpts_tpu/ivpsolve.py:569-647``): not ported."""
    raise NotImplementedError(
        "solve_adaptive_parallel_in_time needs the adaptive single-solve loop (adaptive, "
        "_make_step, solve_adaptive_save_every_step_bounded), which is not ported yet: ROADMAP "
        "queue 1 item 2; solve_fixed_grid(parallel=True) takes a grid that is known"
    )


def solve_fixed_grid(
    vf, init, *, grid, solver, parallel=False, iterations=8, window=16,
    form="cov", warmstart=None, damping=0.0, precondition=True,
    deviation=True, fallback_rtol=1.0, time_shard=None, combine_engine=None,
    iteration_tol=None, return_diagnostics=False,
):
    """Non-adaptive solve on a user grid (any strategy); ``vf(u, t=t)``.

    Counterpart of ``odecheckpts_tpu.ivpsolve.solve_fixed_grid``: the same
    ``Solution`` layout, with the filter / smoother / fixedpoint strategies
    and the none / dynamic calibrations on the isotropic backend.  The solve
    runs on the device of ``init``'s tensors, in their dtype.  The
    sequential pass is a Python loop over the grid (one step's small ops per
    iteration).  ``parallel=True`` runs the forward pass parallel in time:
    windows of ``window`` steps as associative scans with ``iterations``
    linearization sweeps each (``parallel_time.solve_fixed_grid_parallel``;
    ``combine_engine="cuda"`` runs each level of the window's prefix as the
    hand-written kernel ``kernels.pit_combine``)."""
    if parallel:
        from . import parallel_time

        return parallel_time.solve_fixed_grid_parallel(
            vf, init, grid=grid, solver=solver, iterations=iterations,
            window=window, form=form, warmstart=warmstart, damping=damping,
            precondition=precondition, deviation=deviation,
            fallback_rtol=fallback_rtol, time_shard=time_shard,
            combine_engine=combine_engine, iteration_tol=iteration_tol,
            return_diagnostics=return_diagnostics,
        )
    if form != "cov" or warmstart is not None or damping != 0.0 or (
        time_shard is not None or combine_engine is not None
        or iteration_tol is not None
    ):
        raise ValueError(
            "form/warmstart/damping/time_shard/combine_engine/iteration_tol "
            "configure the parallel-in-time sweep and have no effect when "
            "parallel=False; pass parallel=True or drop them (got "
            f"form={form!r}, warmstart={warmstart!r}, damping={damping!r}, "
            f"time_shard={time_shard!r}, combine_engine={combine_engine!r}, "
            f"iteration_tol={iteration_tol!r})."
        )
    _check_calibration(solver)
    ssm = solver.ssm
    strategy = solver.strategy
    rv0, scale0 = init
    dtype, device = rv0.mean.dtype, rv0.mean.device
    _validate_increasing(grid, "grid")
    grid = torch.as_tensor(grid, dtype=dtype, device=device)
    scale_none = ssm.promote_output_scale(scale0).to(dtype=dtype, device=device)
    tiny = torch.tensor(float(torch.finfo(dtype).tiny) ** 0.5, dtype=dtype, device=device)
    dynamic = solver.calibration == ivpsolvers.DYNAMIC

    ts, dts = grid[1:], torch.diff(grid)
    rv, rvs, conds, scales = rv0, [], [], []
    for t_new, dt in zip(ts.unbind(0), dts.unbind(0)):
        m_pred, cache = ssm.extrapolate_mean(rv.mean, dt)
        z, jacs = ivpsolvers.linearize(strategy, vf, m_pred, t_new)
        sigma, _err = ivpsolvers.error_and_scale(strategy, z, jacs, cache)
        scale = torch.maximum(sigma, tiny) if dynamic else scale_none
        rv_pred, bwd = ssm.extrapolate_cov(rv, m_pred, cache, scale, strategy.needs_reversal)
        rv, _obs = ivpsolvers.correct(strategy, rv_pred, z, jacs)
        rvs.append(rv)
        conds.append(bwd)
        scales.append(scale)

    rvs = _tree_prepend(rv0, _tree_stack(rvs)) if rvs else _tree_stack([rv0])
    scales = torch.stack([scale_none, *scales])
    if strategy.needs_reversal:
        ident = ssm.identity_conditional(dtype, device)
        conds = _tree_prepend(ident, _tree_stack(conds)) if conds else _tree_stack([ident])
    else:
        conds = None
    return Solution(
        t=grid,
        u=ssm.qoi(rvs.mean),
        u_std=ssm.qoi_std(rvs),
        output_scale=scales,
        marginals=None,
        posterior=MarkovSeq(rvs, conds, ssm=ssm),
        num_steps=torch.arange(len(grid), dtype=torch.int32, device=device),
        ssm=ssm,
    )
