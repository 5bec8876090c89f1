"""Overridable control flow for the adaptive solve loops (PyTorch counterpart
of ``odecheckpts_tpu.control_flow``).

Every accept/reject loop of the port (``ivpsolve``'s adaptive drivers and
``rk``) runs through ``while_loop``.  Its ``cond`` returns a bool tensor of
the batch shape (one entry per lane) and ``body`` takes effect only where
it is true: a finished lane is frozen, as ``vmap`` of ``lax.while_loop``
freezes it in the reference.

* The default loop runs until no lane is left, with one host read per
  attempt (whether any lane still runs).
* ``bounded_while_loop`` runs at most ``max_steps`` attempts per call (the
  reference's ``lax.scan`` of a masked body).  It leaves early once no lane
  runs: the reference's remaining iterations are masked no-ops, so the
  values and the gradients are the same.  With ``remat`` each attempt runs
  under ``torch.utils.checkpoint``, so the autograd tape keeps the
  attempt's inputs instead of its intermediates.
* ``overwrite_with_bounded(max_steps, remat)`` installs the bounded loop
  for the solves inside a ``with`` block; that is how ``train.fit``
  differentiates the adaptive solve.

``counters`` holds, since the last ``reset_counters()``, the attempts that
the loops ran (``"attempts"``) and the lanes a bounded loop left still
running at its bound (``"capped_lanes"``): a lane there did not reach its
loop's end time, and its solution is not the solve's.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import checkpoint

counters = {"attempts": 0, "capped_lanes": 0}


def reset_counters():
    """Set ``counters`` to 0."""
    for key in counters:
        counters[key] = 0


def tree_select(pred, a, b):
    """Leafwise ``where(pred, a, b)`` over (named) tuples of tensors (``None``
    leaves stay ``None``); ``pred`` holds the batch shape and is broadcast
    against the trailing axes of every leaf."""
    if a is None:
        return None
    if isinstance(a, tuple):
        items = [tree_select(pred, x, y) for x, y in zip(a, b)]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    extra = max(a.dim(), b.dim()) - pred.dim()
    return torch.where(pred.reshape(pred.shape + (1,) * extra), a, b)


def _masked_body(cond_fun, body_fun, state, running=None):
    """One attempt, applied where ``running`` (``cond_fun(state)`` if not
    given) is true."""
    if running is None:
        running = cond_fun(state)
    return tree_select(running, body_fun(state), state)


def _default_while_loop(cond_fun, body_fun, init_val):
    """Attempts until ``cond_fun`` is false in every lane; one host read per
    attempt."""
    state = init_val
    running = cond_fun(state)
    while bool(torch.any(running)):
        state = _masked_body(cond_fun, body_fun, state, running)
        counters["attempts"] += 1
        running = cond_fun(state)
    return state


_WHILE_LOOP_STACK = [_default_while_loop]


def while_loop(cond_fun, body_fun, init_val):
    """The solvers' internal while loop (the default loop unless a
    ``context_overwrite_while_loop`` block installed another)."""
    return _WHILE_LOOP_STACK[-1](cond_fun, body_fun, init_val)


@contextlib.contextmanager
def context_overwrite_while_loop(fn):
    """Replace the solvers' internal while loop inside the ``with`` block
    (for example by a bounded loop, for reverse-mode gradients)."""
    _WHILE_LOOP_STACK.append(fn)
    try:
        yield
    finally:
        _WHILE_LOOP_STACK.pop()


def bounded_while_loop(cond_fun, body_fun, init_val, *, max_steps: int, remat: bool = True):
    """``while_loop`` with at most ``max_steps`` attempts.

    Equal to the unbounded loop whenever no lane needs more than
    ``max_steps`` attempts; otherwise the lanes still running at the bound
    keep their state there and are counted in ``counters["capped_lanes"]``.
    ``remat`` recomputes each attempt in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    intermediates on the tape."""
    state = init_val
    for _ in range(max_steps):
        running = cond_fun(state)
        if not bool(torch.any(running)):
            return state
        if remat and torch.is_grad_enabled():
            state = checkpoint(_masked_body, cond_fun, body_fun, state, use_reentrant=False)
        else:
            state = _masked_body(cond_fun, body_fun, state, running)
        counters["attempts"] += 1
    counters["capped_lanes"] += int(torch.count_nonzero(cond_fun(state)))
    return state


def overwrite_with_bounded(max_steps: int, remat: bool = True):
    """Context manager: run the solves inside it with the bounded loop."""
    return context_overwrite_while_loop(
        functools.partial(bounded_while_loop, max_steps=max_steps, remat=remat))
