"""Posterior statistics over backward Markov sequences (PyTorch counterpart
of ``odecheckpts_tpu.stats``): backward marginals, joint samples, the
marginal likelihood of observations and off-grid smoothing marginals.

Sequences are stacked over time on the leading axis; any further leading
axes (an ensemble) broadcast through the SSM's methods.  A Python loop
replaces ``lax.scan``; the parallel forms run the reference's associative
scan (``parallel_time._associative_scan``) in plain torch.  Products and
roots go through ``rounded`` inside the SSM methods.
"""

from __future__ import annotations

import torch

from .control_flow import tree_select
from .ssm.base import Conditional, MarkovSeq, Normal


def _tree_map(fn, tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    return fn(tree)


def markov_select_terminal(posterior: MarkovSeq) -> MarkovSeq:
    """Keep the terminal Gaussian and the N-1 backward conditionals (entry 0
    of the stack is the unused identity at t0)."""
    init = _tree_map(lambda x: x[-1], posterior.init)
    conds = _tree_map(lambda x: x[1:], posterior.conditional)
    return MarkovSeq(init=init, conditional=conds, ssm=posterior.ssm)


def _cumulative_conditionals(ssm, cond: Conditional) -> Conditional:
    """C_k = cond_k o cond_{k+1} o ... o cond_{N-1} for every k, by the
    reference's associative scan over the time axis (its combine order)."""
    from .parallel_time import _associative_scan

    def combine(later, current):  # current o later, in the flipped order
        c = ssm.compose(Conditional(current[0], Normal(*current[1:])),
                        Conditional(later[0], Normal(*later[1:])))
        return (c.matrix, c.noise.mean, c.noise.cholesky)

    flat = tuple(torch.flip(x, (0,)) for x in (cond.matrix, cond.noise.mean,
                                               cond.noise.cholesky))
    out = tuple(torch.flip(x, (0,)) for x in _associative_scan(combine, flat))
    return Conditional(out[0], Normal(*out[1:]))


def markov_marginals(seq: MarkovSeq, *, reverse: bool = True, parallel: bool = False) -> Normal:
    """Marginals of all non-terminal states by backward marginalization,
    stacked in forward-time order over checkpoints 0..N-2
    (``odecheckpts_tpu/stats.py:47-85``).

    ``parallel=True`` composes the conditionals into the cumulative
    conditionals C_k = cond_k o cond_{k+1} o ... o cond_{N-1} by the port's
    associative scan (``parallel_time._associative_scan``, the reference's
    combine order) and marginalizes the terminal Gaussian through each."""
    if not reverse:
        raise NotImplementedError("forward-time marginals are not defined here")
    ssm = seq.ssm
    if parallel:
        cumulative = _cumulative_conditionals(ssm, seq.conditional)
        num = cumulative.matrix.shape[0]
        init = _tree_map(lambda x: x.expand(num, *x.shape), seq.init)
        return ssm.marginalize(init, cumulative)
    num = seq.conditional.matrix.shape[0]
    rv = seq.init
    out = [None] * num
    for k in reversed(range(num)):
        rv = ssm.marginalize(rv, _tree_map(lambda x, k=k: x[k], seq.conditional))
        out[k] = rv
    return Normal(
        torch.stack([r.mean for r in out]), torch.stack([r.cholesky for r in out])
    )


def _insert_axes(x, count):
    """``x`` with ``count`` axes of length 1 after its leading (time) axis."""
    return x.reshape(x.shape[:1] + (1,) * count + x.shape[1:])


def markov_sample(key, seq: MarkovSeq, *, shape=(), reverse: bool = True,
                  parallel: bool = False):
    """Joint posterior samples along the Markov sequence
    (``odecheckpts_tpu/stats.py:89-159``).

    ``key`` is a ``torch.Generator`` on the sequence's device, or the base
    noise ``(eps_init, eps_steps)`` itself, of the shapes the reference
    draws: ``shape + init.mean.shape`` and ``(N - 1,) + shape + batch +
    ssm.base_shape()`` (JAX and torch share no random numbers, so a
    comparison passes the reference's noise).
    Returns ``(qoi, samples), (qoi_terminal, sample_terminal)``: ``samples``
    is ``shape + (N - 1,) + batch + base`` in forward-time order over
    checkpoints 0..N-2, the terminal pieces belong at the end.

    ``parallel=True`` folds each step's noise into its offset
    (``d_k + L_k xi_k``) and composes the resulting affine maps by an
    associative scan over the time axis (log depth), then maps the
    terminal sample through every cumulative map."""
    if not reverse:
        raise NotImplementedError
    ssm = seq.ssm
    shape = tuple(shape)
    mean = seq.init.mean
    num = seq.conditional.matrix.shape[0]
    if isinstance(key, torch.Generator):
        batch = mean.shape[: mean.dim() - len(ssm.base_shape())]
        eps_init = torch.randn(shape + mean.shape, generator=key, dtype=mean.dtype,
                               device=mean.device)
        eps_steps = torch.randn((num,) + shape + tuple(batch) + ssm.base_shape(),
                                generator=key, dtype=mean.dtype, device=mean.device)
    else:
        eps_init, eps_steps = (torch.as_tensor(e, dtype=mean.dtype, device=mean.device)
                               for e in key)

    sample_terminal = ssm.transform_base(seq.init, eps_init)
    cond = seq.conditional
    if parallel:
        # the conditionals gain the sample axes after time, so that each
        # offset broadcasts against its own noise
        matrix = _insert_axes(cond.matrix, len(shape))
        noise_chol = _insert_axes(cond.noise.cholesky, len(shape))
        zeros_state = torch.zeros_like(mean)
        offsets = ssm.conditional_sample(
            Conditional(matrix, Normal(_insert_axes(cond.noise.mean, len(shape)), noise_chol)),
            zeros_state, eps_steps)
        conds_sampled = Conditional(matrix, Normal(offsets, torch.zeros_like(noise_chol)))
        cumulative = _cumulative_conditionals(ssm, conds_sampled)
        zeros_base = torch.zeros(ssm.base_shape(), dtype=mean.dtype, device=mean.device)
        samples = ssm.conditional_sample(cumulative, sample_terminal, zeros_base)
    else:
        x = sample_terminal
        out = [None] * num
        for k in reversed(range(num)):
            x = ssm.conditional_sample(_tree_map(lambda y, k=k: y[k], cond), x, eps_steps[k])
            out[k] = x
        samples = torch.stack(out)
    samples = torch.movedim(samples, 0, len(shape))
    qoi = ssm.qoi_from_sample(samples)
    qoi_terminal = ssm.qoi_from_sample(sample_terminal)
    return (qoi, samples), (qoi_terminal, sample_terminal)


def log_marginal_likelihood(data, *, standard_deviation, posterior: MarkovSeq):
    """Gaussian log-marginal likelihood of observations of the qoi
    (``odecheckpts_tpu/stats.py:162-188``): a backward square-root Kalman
    pass along the Markov chain (observe, condition, marginalize).

    ``data``: (N, *batch, d) observations at the posterior's N checkpoints
    (time-leading, as the solution holds them); ``standard_deviation``: a
    scalar, (N,) or (N, *batch).  Returns the log-likelihood of the batch
    shape."""
    ssm = posterior.ssm
    like = posterior.init.mean
    data = torch.as_tensor(data, dtype=like.dtype, device=like.device)
    num = data.shape[0]
    std = torch.as_tensor(standard_deviation, dtype=like.dtype, device=like.device)
    std = std.expand(num) if std.dim() == 0 else std
    seq = markov_select_terminal(posterior)

    ll_terminal, rv = ssm.condition_qoi(seq.init, data[-1], std[-1])
    lls = [None] * (num - 1)
    for k in reversed(range(num - 1)):
        rv_prev = ssm.marginalize(rv, _tree_map(lambda x, k=k: x[k], seq.conditional))
        lls[k], rv = ssm.condition_qoi(rv_prev, data[k], std[k])
    return ll_terminal + torch.stack(lls).sum(0) if lls else ll_terminal


def offgrid_marginals_searchsorted(*, ts, solution, solver):
    """Smoothing marginals at off-grid times by searchsorted interpolation
    (``odecheckpts_tpu/stats.py:191-236``).

    Takes a save-every-step smoother solution of one IVP; every ``ts`` must
    lie in the open interior of the solved span.  For tau in (t_k, t_k+1):
    extrapolate the filtering marginal at t_k to tau, reverse-extrapolate
    tau -> t_k+1 to get p(x(tau) | x(t_k+1)), and marginalize it against the
    smoothing marginal at t_k+1.  Sub-intervals below eps^(3/4) snap to the
    grid state with the grad-safe double ``where``.  Returns ``(qoi,
    marginals)`` with the times on the leading axis."""
    del solver
    ssm = solution.ssm
    posterior = solution.posterior
    grid = solution.t
    dtype, device = grid.dtype, grid.device

    marg_rest = markov_marginals(markov_select_terminal(posterior))
    terminal = _tree_map(lambda x: x[-1:], posterior.init)
    smoothing = Normal(*(torch.cat([a, b]) for a, b in zip(marg_rest, terminal)))

    tau = torch.as_tensor(ts, dtype=dtype, device=device)
    idx = torch.clamp(torch.searchsorted(grid, tau), 1, grid.shape[0] - 1)
    rv_f = _tree_map(lambda x: x[idx - 1], posterior.init)
    ms = _tree_map(lambda x: x[idx], smoothing)
    scale = solution.output_scale[idx]
    eps_soft = float(torch.finfo(dtype).eps) ** 0.75
    thresh = eps_soft * torch.clamp(torch.abs(tau), min=1.0)
    one = torch.ones_like(tau)
    close1 = tau - grid[idx - 1] <= thresh
    close2 = grid[idx] - tau <= thresh
    dt1 = torch.where(close1, one, tau - grid[idx - 1])
    dt2 = torch.where(close2, one, grid[idx] - tau)
    rv_tau, _ = ssm.extrapolate_direct(rv_f, dt1, scale, False)
    rv_tau = tree_select(close1, rv_f, rv_tau)
    _, bwd = ssm.extrapolate_direct(rv_tau, dt2, scale, True)
    smoothed = ssm.marginalize(ms, bwd)
    marginals = tree_select(close2, ms, smoothed)
    return ssm.qoi(marginals.mean), marginals
