"""Adaptive and fixed-grid IVP solve drivers (PyTorch counterpart of
``odecheckpts_tpu.ivpsolve``).

* ``solve_adaptive_save_at``: the paper's driver, O(#checkpoints) memory:
  per checkpoint the PI-controlled accept/reject loop, then the
  interpolation at the checkpoint;
* ``solve_adaptive_terminal_values`` (O(1) memory),
  ``solve_adaptive_save_every_step`` (every accepted step, one IVP) and its
  bounded form ``solve_adaptive_save_every_step_bounded`` (a fixed number of
  attempts, masked; ``compact_bounded_solution`` drops the masked entries);
* ``solve_adaptive_parallel_in_time``: grid discovery by the bounded filter,
  then ``solve_fixed_grid(parallel=True)`` on the discovered grid;
* ``solve_fixed_grid``: a user grid, sequential or parallel in time
  (``parallel_time``).

Every field of ``_State`` may carry leading batch dimensions: the JAX
package maps one-IVP functions over an ensemble, the port writes the batch
dimensions out (``init``'s tensors carry them; ``atol`` / ``rtol`` are
scalars or of the batch shape) and selects per lane with ``torch.where``.
Each accept/reject loop runs through ``control_flow.while_loop``: by
default a Python loop with one host read per attempt (whether any lane still
runs), under ``control_flow.overwrite_with_bounded`` a loop of at most
``max_steps`` attempts per checkpoint interval (for reverse-mode gradients);
finished lanes are frozen by ``_tree_select``.  As in the reference, the
step-size controller is not differentiated (``_control_factor``).
The vector field is the one-IVP function ``vf(*u, t=t)``; ``ivpsolvers``
maps it over the batch.  A solve runs on the device of ``init``'s tensors,
in their dtype, with float32 products at full precision (no TF32).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from . import control_flow, ivpsolvers, rounded
from .stats import _tree_map
from .ssm.base import Conditional, MarkovSeq, Normal, Solution


@dataclasses.dataclass(frozen=True)
class Control:
    """Proportional-integral step-size controller (clipped power law)."""

    safety: float = 0.95
    factor_min: float = 0.2
    factor_max: float = 10.0
    power_integral: float = 0.3
    power_proportional: float = 0.4


def control_proportional_integral(**kwargs) -> Control:
    return Control(**kwargs)


def control_integral(**kwargs) -> Control:
    """Classic I-controller (no proportional term)."""
    return Control(power_integral=1.0, power_proportional=0.0, **kwargs)


def _control_factor(ctrl: Control, errn, errn_prev, error_order: int):
    # step-size control is a discrete decision: the reference stops its
    # gradient (reverse mode through errn**-n1 near a zero error norm is inf)
    errn, errn_prev = errn.detach(), errn_prev.detach()
    n1 = ctrl.power_integral / error_order
    n2 = ctrl.power_proportional / error_order
    factor = ctrl.safety * rounded.pow(errn, -n1) * rounded.pow(errn_prev / errn, n2)
    factor = torch.where(torch.isfinite(factor), factor, torch.full_like(factor, ctrl.factor_min))
    return torch.clamp(factor, ctrl.factor_min, ctrl.factor_max)


@dataclasses.dataclass(frozen=True)
class AdaptiveSolver:
    solver: Any
    atol: Any
    rtol: Any
    control: Control


def adaptive(solver, *, atol=1e-4, rtol=1e-2, control: Optional[Control] = None):
    """Wrap a solver in PI-controlled adaptive step selection; ``atol`` and
    ``rtol`` are scalars or tensors of the ensemble's batch shape."""
    if control is None:
        control = control_proportional_integral()
    return AdaptiveSolver(solver, atol, rtol, control)


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


_tree_select = control_flow.tree_select


def _expand(tree, batch):
    if isinstance(tree, tuple):
        return type(tree)(*(_expand(x, batch) for x in tree))
    return tree.expand(tuple(batch) + tree.shape)


def _finfo(dtype, attr):
    """``np.finfo(dtype).<attr>`` as a numpy scalar of ``dtype`` (powers of
    it then round in ``dtype``, as the reference's do)."""
    return getattr(np.finfo(torch.empty((), dtype=dtype).numpy().dtype), attr)


def _dt_floor(ssm, dtype):
    """Smallest dt whose preconditioner stays in the normal range (dt^(nu +
    1/2) must not underflow)."""
    return float(_finfo(dtype, "tiny") ** (1.0 / (ssm.num_derivatives + 1.5)))


def _tolerance(x, like):
    """A tolerance against (..., d) values: a Python number as it is, a tensor
    of the batch shape with a trailing axis."""
    if isinstance(x, (int, float)):
        return x
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)[..., None]


def _sum_last(x):
    """Sum over the last (small) axis in order."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _init_state(asolver: AdaptiveSolver, init, t0, dt0) -> _State:
    """The adaptive state at ``t0``; the batch shape is that of ``init``'s
    mean broadcast with the tolerances'."""
    ssm = asolver.solver.ssm
    rv0, scale0 = init
    dtype, device = rv0.mean.dtype, rv0.mean.device
    ident1 = ssm.identity_conditional(dtype, device)  # one IVP's shapes
    batch = rv0.mean.shape[: rv0.mean.dim() - ident1.noise.mean.dim()]
    for tol in (asolver.atol, asolver.rtol):
        if not isinstance(tol, (int, float)):
            batch = torch.broadcast_shapes(batch, torch.as_tensor(tol).shape)
    rv0 = Normal(*(x.expand(batch + one.shape)
                   for x, one in zip(rv0, (ident1.noise.mean, ident1.noise.cholesky))))
    scale0 = ssm.promote_output_scale(torch.as_tensor(scale0, dtype=dtype, device=device))
    scale0 = scale0.expand(batch + ssm.promote_output_scale(torch.ones((), dtype=dtype)).shape)

    def full(value, dt=dtype):
        return torch.as_tensor(value, dtype=dt, device=device).expand(batch)

    ident = (_expand(ssm.identity_conditional(dtype, device), batch)
             if asolver.solver.strategy.needs_reversal else None)
    return _State(
        t=full(t0), rv=rv0, bwd=ident, scale_step=scale0, t_prev=full(t0), rv_prev=rv0,
        bwd_prev=ident, dt=full(dt0), errn_prev=full(1.0),
        num_steps=full(0, torch.int32), mle_ssq=torch.zeros_like(scale0),
    )


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


def _make_step(vf, asolver: AdaptiveSolver, scale_fixed, dt_max=None):
    """One accept/reject attempt of every lane (``odecheckpts_tpu/ivpsolve.py:
    153-228``), including the forced acceptance once ``dt`` falls below
    ``4 eps max(|t|, 1)``; ``dt_max`` bounds the step."""
    solver = asolver.solver
    strategy = solver.strategy
    ssm = strategy.ssm
    ctrl = asolver.control
    error_order = ssm.num_derivatives + 1
    fixedpoint = strategy.kind == ivpsolvers.FIXEDPOINT
    kappa = strategy.correction.calibration_factor
    dynamic = solver.calibration == ivpsolvers.DYNAMIC

    def step(s: _State) -> _State:
        dtype = s.dt.dtype
        dt = torch.clamp(s.dt, min=_dt_floor(ssm, dtype))
        if dt_max is not None:
            dt = torch.minimum(dt, dt_max)
        t_new = s.t + dt
        m_pred, cache = ssm.extrapolate_mean(s.rv.mean, dt)
        z, jacs = ivpsolvers.linearize(strategy, vf, m_pred, t_new)
        sigma, err = ivpsolvers.error_and_scale(strategy, z, jacs, cache)

        u_pred = ssm.qoi(m_pred)
        atol, rtol = _tolerance(asolver.atol, u_pred), _tolerance(asolver.rtol, u_pred)
        q = err / (atol + rtol * torch.abs(u_pred))
        e2 = _sum_last(q * q)
        errn = kappa * rounded.sqrt(e2 / torch.full_like(e2, q.shape[-1]))

        if dynamic:
            scale = torch.maximum(sigma, torch.full_like(sigma, float(_finfo(dtype, "tiny") ** 0.5)))
        else:
            scale = ssm.promote_output_scale(
                torch.as_tensor(scale_fixed, dtype=dtype, device=s.dt.device))
        rv_pred, bwd_step = ssm.extrapolate_cov(s.rv, m_pred, cache, scale,
                                                strategy.needs_reversal)
        rv_cor, _obs = ivpsolvers.correct(strategy, rv_pred, z, jacs)
        if strategy.needs_reversal:
            bwd_new = ssm.compose(s.bwd, bwd_step) if fixedpoint else bwd_step
        else:
            bwd_new = None

        factor = _control_factor(ctrl, errn, s.errn_prev, error_order)
        dt_next = dt * factor
        if dt_max is not None:
            dt_next = torch.minimum(dt_next, dt_max)
        # forced acceptance once dt underflows the local time resolution: the
        # loop stays total on pathological vector fields
        dt_stall = (4.0 * float(_finfo(dtype, "eps"))) * torch.clamp(torch.abs(s.t), min=1.0)
        accept = (errn <= 1.0) | (dt <= dt_stall)

        accepted = _State(
            t=t_new, rv=rv_cor, bwd=bwd_new, scale_step=scale, t_prev=s.t, rv_prev=s.rv,
            bwd_prev=s.bwd, dt=dt_next,
            errn_prev=torch.maximum(errn, torch.full_like(errn, float(_finfo(dtype, "tiny")))),
            num_steps=s.num_steps + 1, mle_ssq=s.mle_ssq + sigma * sigma,
        )
        return _tree_select(accept, accepted, s._replace(dt=dt_next))

    return step


def _run_until(step, state: _State, t_end) -> _State:
    """Attempts until every lane has reached ``t_end`` (``control_flow.
    while_loop``, as ``odecheckpts_tpu/ivpsolve.py:391`` and ``:430``); a
    finished lane is frozen."""
    return control_flow.while_loop(lambda s: s.t < t_end, step, state)


def _mle_factor(state: _State):
    n = torch.clamp(state.num_steps, min=1).to(state.mle_ssq.dtype)
    n = n.reshape(n.shape + (1,) * (state.mle_ssq.dim() - n.dim()))
    return rounded.sqrt(state.mle_ssq / n)


def _maybe_rescale(solver, state: _State, solution: Solution) -> Solution:
    """MLE calibration: every covariance factor of the solution times the
    running-MLE output scale (the RMS of the accepted steps' sigmas)."""
    if solver.calibration != ivpsolvers.MLE:
        return solution
    ssm = solver.ssm
    factor = _mle_factor(state)
    post = solution.posterior
    init = Normal(post.init.mean, ssm.rescale_cholesky(post.init.cholesky, factor))
    cond = post.conditional
    if cond is not None:
        cond = Conditional(cond.matrix, Normal(
            cond.noise.mean, ssm.rescale_cholesky(cond.noise.cholesky, factor)))
    marg = solution.marginals
    if marg is not None:
        marg = Normal(marg.mean, ssm.rescale_cholesky(marg.cholesky, factor))
    # one factor per lane (isotropic, dense) or per lane and dimension (blockdiag)
    factor_u = factor if factor.dim() > state.num_steps.dim() else factor[..., None]
    return dataclasses.replace(
        solution, posterior=MarkovSeq(init, cond, ssm=ssm), marginals=marg,
        u_std=solution.u_std * factor_u,
        output_scale=factor.expand(solution.output_scale.shape),
    )


def _full_precision(fn):
    """Run the solve with full-precision float32 products (no TF32 on the
    card): the solver's small covariance algebra is latency-bound, and
    reduced-precision products corrupt the error estimates.  The caller's
    setting is restored afterwards."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        before = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(before)

    wrapped.__full_precision__ = True
    return wrapped


def _solution(ssm, t, rvs, conds, nsteps, scales):
    return Solution(t=t, u=ssm.qoi(rvs.mean), u_std=ssm.qoi_std(rvs), output_scale=scales,
                    marginals=None, posterior=MarkovSeq(rvs, conds, ssm=ssm),
                    num_steps=nsteps, ssm=ssm)


def _span(t0, t1, like):
    return torch.as_tensor(t1 - t0, dtype=like.dtype, device=like.device)


@_full_precision
def solve_adaptive_save_at(vf, init, *, save_at, dt0, adaptive_solver):
    """Adaptive solve with O(#save_at) memory (the paper's driver).

    Returns a ``Solution`` on the ``save_at`` grid: ``u``, ``u_std`` and the
    posterior stacked over the checkpoints on the leading axis, then the
    batch axes (for the fixedpoint strategy the conditionals map each
    checkpoint back to the previous one); ``num_steps`` the accepted steps
    up to each checkpoint."""
    asolver = adaptive_solver
    solver = asolver.solver
    ssm = solver.ssm
    strategy = solver.strategy
    rv0, scale0 = init
    _validate_increasing(save_at, "save_at")
    save_at = torch.as_tensor(save_at, dtype=rv0.mean.dtype, device=rv0.mean.device)
    state = state0 = _init_state(asolver, init, save_at[0], dt0)
    step = _make_step(vf, asolver, scale0, dt_max=save_at[-1] - save_at[0])
    emits = [(state0.rv, state0.bwd, torch.zeros_like(state0.num_steps), state0.scale_step)]
    for t_next in save_at[1:].unbind(0):
        state = _run_until(step, state, t_next)
        (rv_e, cond_e), state = _interpolate_at(strategy, state, t_next)
        emits.append((rv_e, cond_e, state.num_steps, state.scale_step))
    rvs, conds, nsteps, scales = (_tree_stack([e[i] for e in emits]) for i in range(4))
    return _maybe_rescale(solver, state, _solution(ssm, save_at, rvs, conds, nsteps, scales))


@_full_precision
def solve_adaptive_terminal_values(vf, init, *, t0, t1, dt0, adaptive_solver):
    """Adaptive solve keeping only the terminal state (O(1) memory)."""
    asolver = adaptive_solver
    solver = asolver.solver
    rv0, scale0 = init
    state = _init_state(asolver, init, t0, dt0)
    step = _make_step(vf, asolver, scale0, dt_max=_span(t0, t1, rv0.mean))
    state = _run_until(step, state, t1)
    (rv_e, cond_e), state = _interpolate_at(solver.strategy, state, t1)
    t = torch.as_tensor(t1, dtype=rv0.mean.dtype, device=rv0.mean.device)
    sol = _solution(solver.ssm, t, rv_e, cond_e, state.num_steps, state.scale_step)
    return _maybe_rescale(solver, state, sol)


@_full_precision
def solve_adaptive_save_every_step(vf, init, *, t0, t1, dt0, adaptive_solver):
    """Adaptive solve storing every accepted step (O(#steps) memory) of ONE
    IVP: the output length is the IVP's own step count, so an ensemble
    takes ``solve_adaptive_save_every_step_bounded`` (and
    ``compact_bounded_solution`` per lane).  The last entry is the solution
    interpolated at ``t1``."""
    asolver = adaptive_solver
    solver = asolver.solver
    rv0, scale0 = init
    state = _init_state(asolver, init, t0, dt0)
    if state.t.dim():
        raise ValueError(
            "solve_adaptive_save_every_step solves one IVP (its output has the IVP's own "
            f"length); got the batch shape {tuple(state.t.shape)}: use "
            "solve_adaptive_save_every_step_bounded for an ensemble")
    step = _make_step(vf, asolver, scale0, dt_max=_span(t0, t1, rv0.mean))
    t1_f = float(t1)
    emits = [(state.t, state.rv, state.bwd, state.num_steps, state.scale_step)]
    t_now = float(state.t)
    while t_now < t1_f:
        state = step(state)
        t_new = float(state.t)  # the attempt's one host read
        if t_now < t_new <= t1_f:
            emits.append((state.t, state.rv, state.bwd, state.num_steps, state.scale_step))
        t_now = t_new
    if t_now > t1_f:
        (rv_e, cond_e), state = _interpolate_at(solver.strategy, state, t1_f)
        emits.append((state.t_prev, rv_e, cond_e, state.num_steps, state.scale_step))
    ts, rvs, conds, nsteps, scales = (_tree_stack([e[i] for e in emits]) for i in range(5))
    return _maybe_rescale(solver, state, _solution(solver.ssm, ts, rvs, conds, nsteps, scales))


@_full_precision
def solve_adaptive_save_every_step_bounded(vf, init, *, t0, t1, dt0, adaptive_solver,
                                           max_steps: int):
    """Save-every-step with a fixed number of attempts, ``max_steps``.

    The outputs have ``max_steps + 1`` entries on the leading axis (then the
    batch axes): entry k is the state after attempt k, rejected attempts and
    attempts past ``t1`` repeat the state and are marked invalid.  Returns
    ``(solution, (valid, (rv_t1, cond_t1)))`` with the solution interpolated
    at ``t1`` beside it.  Attempts after every lane has finished are not
    computed (their entries repeat the final state)."""
    asolver = adaptive_solver
    solver = asolver.solver
    rv0, scale0 = init
    state = state0 = _init_state(asolver, init, t0, dt0)
    step = _make_step(vf, asolver, scale0, dt_max=_span(t0, t1, rv0.mean))
    emits = [(state0.t, state0.rv, state0.bwd, torch.zeros_like(state0.num_steps),
              state0.scale_step, torch.ones_like(state0.t, dtype=torch.bool))]
    for _ in range(max_steps):
        running = state.t < t1
        new = _tree_select(running, step(state), state) if bool(torch.any(running)) else state
        accepted = (new.t > state.t) & (new.t <= t1)
        state = new
        emits.append((new.t, new.rv, new.bwd, new.num_steps, new.scale_step, accepted))
    (rv_e, cond_e), final = _interpolate_at(solver.strategy, state, t1)
    ts, rvs, conds, nsteps, scales, valid = (_tree_stack([e[i] for e in emits])
                                             for i in range(6))
    sol = _solution(solver.ssm, ts, rvs, conds, nsteps, scales)
    return _maybe_rescale(solver, final, sol), (valid, (rv_e, cond_e))


def compact_bounded_solution(solution: Solution, valid) -> Solution:
    """Drop the masked entries of one IVP's bounded save-every-step solution
    (``valid`` of shape (max_steps + 1,)): what the eager driver would have
    stored, without its interpolated last entry."""
    valid = torch.as_tensor(valid)
    if valid.dim() != 1:
        raise ValueError(
            f"compact_bounded_solution takes one IVP's valid mask, got the shape "
            f"{tuple(valid.shape)}: compact each lane of an ensemble on its own")
    idx = torch.nonzero(valid.to(solution.t.device))[:, 0]

    def take(x):
        return None if x is None else _tree_map(lambda y: y[idx], x)

    post = solution.posterior
    return dataclasses.replace(
        solution, t=take(solution.t), u=take(solution.u), u_std=take(solution.u_std),
        output_scale=take(solution.output_scale),
        posterior=MarkovSeq(take(post.init), take(post.conditional), ssm=post.ssm),
        num_steps=take(solution.num_steps),
    )


@_full_precision
def solve_adaptive_parallel_in_time(
    vf, init, *, t0, t1, dt0, adaptive_solver, max_steps,
    iterations=12, window=16, form="sqrt", warmstart="discovery",
    damping=0.0, precondition=True, iteration_tol=1e-8,
    combine_engine=None, return_diagnostics=False,
):
    """Adaptive parallel-in-time solve of one IVP: grid discovery, then a
    parallel-in-time solve on the discovered grid.

    The discovery pass is ``solve_adaptive_save_every_step_bounded`` with the
    filter strategy (the controller sees the same error estimates as with
    ``adaptive_solver``'s strategy, so the grid is that solver's adaptive
    grid); then ``solve_fixed_grid(parallel=True)`` re-solves on the accepted
    grid with the solver as given.  ``warmstart="discovery"`` linearizes every
    step at the discovery pass's filtered mean extrapolated one step
    (``l_k = Phi_k m_{k-1}``); any ``solve_fixed_grid`` warm start passes
    through.  ``combine_engine="cuda"`` runs every level of the window
    prefix as one launch of the kernel K8 (``kernels.pit_combine``)."""
    solver = adaptive_solver.solver
    strat_f = ivpsolvers.strategy_filter(solver.ssm, solver.strategy.correction)
    solver_f = (ivpsolvers.solver_dynamic(strat_f)
                if solver.calibration == ivpsolvers.DYNAMIC else ivpsolvers.solver(strat_f))
    asolver_f = adaptive(solver_f, atol=adaptive_solver.atol, rtol=adaptive_solver.rtol,
                         control=adaptive_solver.control)
    sol_f, (valid, _tail) = solve_adaptive_save_every_step_bounded(
        vf, init, t0=t0, t1=t1, dt0=dt0, adaptive_solver=asolver_f, max_steps=max_steps)
    if valid.dim() != 1:
        raise ValueError("solve_adaptive_parallel_in_time solves one IVP (the grid is its own)")
    valid_np = valid.cpu().numpy()
    ts = sol_f.t.cpu().numpy()[valid_np]
    t1_f = float(t1)
    if ts[-1] < t1_f:
        ts = np.concatenate([ts, [t1_f]])
    grid = torch.as_tensor(ts, dtype=sol_f.t.dtype, device=sol_f.t.device)
    if isinstance(warmstart, str) and warmstart == "discovery":
        means_f = sol_f.posterior.init.mean[valid.to(sol_f.t.device)]
        warmstart = solver.ssm.extrapolate_mean(means_f[: len(ts) - 1], torch.diff(grid))[0]
    return solve_fixed_grid(
        vf, init, grid=grid, solver=solver, parallel=True, iterations=iterations,
        window=window, form=form, warmstart=warmstart, damping=damping,
        precondition=precondition, iteration_tol=iteration_tol,
        combine_engine=combine_engine, return_diagnostics=return_diagnostics,
    )


@_full_precision
def solve_fixed_grid(
    vf, init, *, grid, solver, parallel=False, iterations=8, window=16,
    form="cov", warmstart=None, damping=0.0, precondition=True,
    deviation=True, fallback_rtol=1.0, time_shard=None, combine_engine=None,
    iteration_tol=None, return_diagnostics=False,
):
    """Non-adaptive solve on a user grid (any strategy); ``vf(u, t=t)``.

    Counterpart of ``odecheckpts_tpu.ivpsolve.solve_fixed_grid``: the same
    ``Solution`` layout, with the filter / smoother / fixedpoint strategies
    and the none / dynamic / MLE calibrations on every backend.  The solve
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
    mle_ssq = torch.zeros_like(scale_none)  # per dimension on blockdiag, as its sigma
    for t_new, dt in zip(ts.unbind(0), dts.unbind(0)):
        m_pred, cache = ssm.extrapolate_mean(rv.mean, dt)
        z, jacs = ivpsolvers.linearize(strategy, vf, m_pred, t_new)
        sigma, _err = ivpsolvers.error_and_scale(strategy, z, jacs, cache)
        scale = torch.maximum(sigma, tiny) if dynamic else scale_none
        rv_pred, bwd = ssm.extrapolate_cov(rv, m_pred, cache, scale, strategy.needs_reversal)
        rv, _obs = ivpsolvers.correct(strategy, rv_pred, z, jacs)
        mle_ssq = mle_ssq + sigma * sigma
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
    num_steps = torch.arange(len(grid), dtype=torch.int32, device=device)
    sol = _solution(ssm, grid, rvs, conds, num_steps, scales)
    state_like = _State(t=grid[-1], rv=rv, bwd=None, scale_step=scales[-1], t_prev=grid[-1],
                        rv_prev=rv, bwd_prev=None, dt=dts[-1], errn_prev=None,
                        num_steps=num_steps[-1], mle_ssq=mle_ssq)
    return _maybe_rescale(solver, state_like, sol)
