"""Batched SAVE-EVERY-STEP adaptive solver (bounded, smoother-capable;
PyTorch counterpart of ``odecheckpts_tpu.batched_everystep``).

Attempt-aligned emission: the number of accepted steps differs per lane, so
the driver runs a fixed ``max_steps`` attempts and emits one slot per
attempt:

* a slot holds (t, posterior, one-step backward conditional, accepted);
  rejected and frozen slots emit an identity conditional, which is neutral
  under backward composition, so one masked backward sweep smooths the whole
  ragged ensemble without compaction;
* the slot index is the attempt counter, shared by every lane, so nothing is
  scattered per lane;
* lanes that reach ``t1`` freeze inside the step, so their remaining slots
  are invalid.

Engines: ``"cuda"`` launches kernel K7 (``kernels.step_everystep_attempt``,
one attempt of ``batched.StepLL`` with the smoother or the filter strategy)
exactly ``max_steps`` times with no host sync between launches, since the
loop length is fixed; ``"torch"`` runs the twin.  Every attempt's state goes
through device memory anyway to append its slot, so an interval kernel has
nothing to keep on chip: ``engine="cuda-loop"`` is refused.

Strategies: ``"smoother"`` (per-step backward conditionals and the masked
backward marginals) and ``"filter"`` (no backward pass).  The fixedpoint
strategy accumulates between checkpoints: it is a save_at concept and is
refused.

Ported configuration: isotropic backend, TS0, ``ode_order=1``, dynamic
calibration, ``error_unit="qoi"``, ``num_derivatives`` in {2, 3, 4}.
Everything else raises ``NotImplementedError`` naming ROADMAP queue 1 item 5.

Memory: a slot keeps the posterior (n d + n^2 floats a lane), the
conditional (2 n^2 + n d) and the time: 106 floats a lane at nu = 4, d = 3,
and a byte for the accept flag, so 256 slots of 32,768 lanes hold 3.6 GB.  The slots
stay where the step wrote them (lanes-last, one tensor per slot and array):
the outputs are built as (K + 1, d, B) stacks and returned as batch-major
views, and the backward sweep reads each slot through a view.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import batched, ivpsolvers, kernels, rounded
from .ivpsolve import _interpolate_at, _tree_select
from .ssm.base import Conditional, Normal

ENGINES = ("cuda", "torch")


class EveryStepSolution(NamedTuple):
    """Attempt-aligned bounded ensemble solution (batch-major).

    ``t``, ``u``, ``u_std`` and ``valid`` have a slot axis of length
    ``max_steps + 1`` (slot 0 is the initial condition); slots with
    ``valid == False`` are rejected attempts, freezes after ``t1``, or the
    overshoot slot, and must be ignored (``compact`` drops them).  The
    terminal state at exactly ``t1`` is returned separately (``u_t1`` and
    ``u_std_t1`` are already smoothed: the terminal filtering and smoothing
    marginals coincide).
    """

    t: torch.Tensor  # (B, K+1)
    u: torch.Tensor  # (B, K+1, d) filtered means at the slots
    u_std: torch.Tensor  # (B, K+1, d)
    valid: torch.Tensor  # (B, K+1) bool
    num_steps: torch.Tensor  # (B,) accepted steps
    u_t1: torch.Tensor  # (B, d)
    u_std_t1: torch.Tensor  # (B, d)
    marginal_u: Optional[torch.Tensor]  # (B, K+1, d) smoothed means (smoother)
    marginal_u_std: Optional[torch.Tensor]  # (B, K+1, d)


def compact(sol: EveryStepSolution, lane: int):
    """Host-side compaction of one lane (the output length depends on the
    data): its valid slots as numpy arrays."""
    idx = np.flatnonzero(sol.valid[lane].cpu().numpy())
    take = lambda x: None if x is None else x[lane].cpu().numpy()[idx]  # noqa: E731
    return {
        "t": take(sol.t),
        "u": take(sol.u),
        "u_std": take(sol.u_std),
        "marginal_u": take(sol.marginal_u),
        "marginal_u_std": take(sol.marginal_u_std),
    }


def _slot(x):
    """A lanes-last (a, b, B) slot array as a batch-leading (B, a, b) view."""
    return torch.movedim(x, -1, 0)


def solve_every_step_batched(
    vf,
    u0s,
    params,
    *,
    t0,
    t1,
    dt0,
    tols,
    max_steps: int,
    num_derivatives=4,
    strategy="smoother",
    calibration="dynamic",
    atol_factor=1e-3,
    engine="cuda",
    hbm_budget="auto",
    ode_order=1,
    correction="ts0",
    error_unit="qoi",
    error_calibration=None,
) -> EveryStepSolution:
    """Bounded save-every-step adaptive solve for an IVP ensemble
    (``odecheckpts_tpu/batched_everystep.py:92-356``).

    Same step and controller as ``batched.solve_save_at_batched`` (isotropic
    backend).  ``u0s``: (B, d); ``tols``: (B,) on the same device.
    ``max_steps`` bounds the attempts (accepted and rejected); a lane that
    needs more ends short of ``t1`` (``t[lane, valid].max() < t1`` and
    ``u_t1`` extrapolated), so size it from the tolerance.
    """
    if strategy not in ("smoother", "filter"):
        raise ValueError(
            "save-every-step supports strategy 'smoother' or 'filter'; fixedpoint "
            f"accumulation is a save_at concept (got {strategy!r})"
        )
    if engine not in ENGINES:
        raise ValueError(
            f"save-every-step engines: {ENGINES} (one kernel per attempt, the plain-torch "
            "twin); every slot goes through device memory, so the interval kernel of "
            f"engine 'cuda-loop' has nothing to gain (got {engine!r})"
        )
    batched._check_config(
        strategy=strategy, calibration=calibration, ode_order=ode_order,
        correction=correction, error_unit=error_unit, implementation="isotropic",
        num_derivatives=num_derivatives, strategies=("smoother", "filter"),
    )
    if isinstance(u0s, tuple):
        (u0s,) = u0s
    b, d = u0s.shape
    dtype, device = u0s.dtype, u0s.device
    nu = num_derivatives
    n = nu + 1
    # the slots are the save_at driver's per-checkpoint stacks, max_steps + 1 of them
    batched.check_hbm_budget(
        b, d, num_derivatives=nu, num_save_at=max_steps + 1, dtype=dtype,
        budget=hbm_budget, device=device,
    )
    ssm = ivpsolvers.prior_ibm(num_derivatives=nu, ode_shape=(d,))
    corr = ivpsolvers.correction_ts0(error_calibration=error_calibration)
    strat = {"filter": ivpsolvers.strategy_filter,
             "smoother": ivpsolvers.strategy_smoother}[strategy](ssm, corr)
    needs_rev = strat.needs_reversal
    span = torch.as_tensor([t0, t1], dtype=dtype, device=device)
    state, rv0, inputs = batched.initial_state(
        vf, u0s, params, save_at=span, dt0=dt0, tols=tols, num_derivatives=nu,
        atol_factor=atol_factor, strategy=strategy)
    step = batched.make_step_ll(vf, params, nu=nu, d=d,
                                error_calibration=corr.calibration_factor, dtype=dtype,
                                strategy=strategy)
    attempt = kernels.step_everystep_attempt if engine == "cuda" else kernels.attempt_plain
    t1_row = span[1].expand(1, b).contiguous()

    # -- max_steps attempts, one slot each; no host sync inside the loop
    eye = torch.eye(n, dtype=dtype, device=device)[:, :, None]
    zero = torch.zeros((), dtype=dtype, device=device)
    ts, means, chols, accs, conds = [], [], [], [], []
    for _ in range(max_steps):
        t_old = state[0]
        state = attempt(step, state, t1_row, **inputs)
        acc = state[0] > t_old  # (1, B)
        ts.append(state[0])
        means.append(state[1])
        chols.append(state[2])
        accs.append(acc)
        if needs_rev:
            # identity conditional at rejected slots
            conds.append((torch.where(acc, state[3], eye), torch.where(acc, state[4], zero),
                          torch.where(acc, state[5], zero)))
    (rv_e, cond_e), gen = _interpolate_at(
        strat, batched._state_to_generic(state, needs_rev), span[1])

    # -- outputs: (K + 1, ., B) stacks, returned as batch-major views
    t_slots = torch.cat(ts) if ts else torch.zeros((0, b), dtype=dtype, device=device)
    acc_slots = torch.cat(accs) if accs else torch.zeros((0, b), dtype=torch.bool, device=device)
    valid = acc_slots & (t_slots < span[1])  # the t1 / overshoot slot is the terminal
    t_all = torch.cat([span[0].expand(1, b), t_slots])
    valid_all = torch.cat([torch.ones((1, b), dtype=torch.bool, device=device), valid])

    def qoi_std_ll(chol):  # (n, n, B) -> (d, B), as ssm.qoi_std
        return rounded.sqrt(torch.sum(chol[0] ** 2, dim=0))[None].expand(d, b)

    u_all = torch.stack([ssm.qoi(rv0.mean).transpose(0, 1)] + [m[0] for m in means])
    u_std_all = torch.stack([ssm.qoi_std(rv0).transpose(0, 1)] + [qoi_std_ll(c) for c in chols])

    marg_u = marg_std = None
    if needs_rev:
        # masked backward sweep over the slots, batched over the lanes.  The
        # carry is the smoothing marginal at the latest valid slot not yet
        # emitted; cond_e maps x(t1) to x(last valid slot)
        carry = ssm.marginalize(rv_e, cond_e)
        marg_u = torch.empty((max_steps + 1, d, b), dtype=dtype, device=device)
        marg_std = torch.empty_like(marg_u)
        for k in reversed(range(max_steps)):
            marg_u[k + 1] = ssm.qoi(carry.mean).transpose(0, 1)
            marg_std[k + 1] = ssm.qoi_std(carry).transpose(0, 1)
            g, m, l = conds[k]
            nxt = ssm.marginalize(carry, Conditional(_slot(g), Normal(_slot(m), _slot(l))))
            carry = _tree_select(valid[k], nxt, carry)
        marg_u[0] = ssm.qoi(carry.mean).transpose(0, 1)  # the initial condition's marginal
        marg_std[0] = ssm.qoi_std(carry).transpose(0, 1)
        marg_u, marg_std = marg_u.permute(2, 0, 1), marg_std.permute(2, 0, 1)

    return EveryStepSolution(
        t=t_all.transpose(0, 1),
        u=u_all.permute(2, 0, 1),
        u_std=u_std_all.permute(2, 0, 1),
        valid=valid_all.transpose(0, 1),
        num_steps=gen.num_steps,
        u_t1=ssm.qoi(rv_e.mean),
        u_std_t1=ssm.qoi_std(rv_e),
        marginal_u=marg_u,
        marginal_u_std=marg_std,
    )
