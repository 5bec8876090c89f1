"""Posterior statistics over backward Markov sequences (PyTorch counterpart
of the sequential parts of ``odecheckpts_tpu.stats``).

Sequences are stacked over time on the leading axis; any further leading
axes (an ensemble) broadcast through the SSM's methods.  A Python loop
replaces ``lax.scan``.
"""

from __future__ import annotations

import torch

from .ssm.base import MarkovSeq, Normal


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


def markov_marginals(seq: MarkovSeq) -> Normal:
    """Marginals of all non-terminal states by backward marginalization,
    stacked in forward-time order over checkpoints 0..N-2."""
    ssm = seq.ssm
    num = seq.conditional.matrix.shape[0]
    rv = seq.init
    out = [None] * num
    for k in reversed(range(num)):
        rv = ssm.marginalize(rv, _tree_map(lambda x, k=k: x[k], seq.conditional))
        out[k] = rv
    return Normal(
        torch.stack([r.mean for r in out]), torch.stack([r.cholesky for r in out])
    )
