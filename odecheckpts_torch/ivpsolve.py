"""Adaptive-solve state, step-size control and checkpoint interpolation
(PyTorch counterpart of the parts of ``odecheckpts_tpu.ivpsolve`` that the
batched driver runs).

Every field of ``_State`` may carry a leading batch dimension: the JAX
package maps one-IVP functions over the ensemble, the port writes the
batch dimension out and selects branches per lane with ``torch.where``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import ivpsolvers
from .ssm.base import Conditional, Normal


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
