"""Posterior statistics over backward Markov sequences (PyTorch counterpart
of the sequential parts of ``odecheckpts_tpu.stats``).

Sequences are stacked over time on the leading axis; any further leading
axes (an ensemble) broadcast through the SSM's methods.  A Python loop
replaces ``lax.scan``.
"""

from __future__ import annotations

import torch

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
        from .parallel_time import _associative_scan

        def combine(later, current):  # current o later, in the flipped order
            c = ssm.compose(Conditional(current[0], Normal(*current[1:])),
                            Conditional(later[0], Normal(*later[1:])))
            return (c.matrix, c.noise.mean, c.noise.cholesky)

        cond = seq.conditional
        flat = tuple(torch.flip(x, (0,)) for x in (cond.matrix, cond.noise.mean,
                                                   cond.noise.cholesky))
        cumulative = tuple(torch.flip(x, (0,)) for x in _associative_scan(combine, flat))
        num = cumulative[0].shape[0]
        init = _tree_map(lambda x: x.expand(num, *x.shape), seq.init)
        return ssm.marginalize(init, Conditional(cumulative[0], Normal(*cumulative[1:])))
    num = seq.conditional.matrix.shape[0]
    rv = seq.init
    out = [None] * num
    for k in reversed(range(num)):
        rv = ssm.marginalize(rv, _tree_map(lambda x, k=k: x[k], seq.conditional))
        out[k] = rv
    return Normal(
        torch.stack([r.mean for r in out]), torch.stack([r.cholesky for r in out])
    )
