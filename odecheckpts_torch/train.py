"""Parameter estimation for ODEs through the posterior marginal likelihood
(PyTorch counterpart of ``odecheckpts_tpu.train``).

* ``Observations`` holds the data on the solve's ``save_at`` grid;
* ``nlml(solve, observations, u0=)`` builds ``loss(theta)``, the negative
  log-marginal likelihood of the data under a ``facade.solve`` closure;
* ``gradient_step`` is one optimizer step; ``fit`` runs ``num_steps`` of
  them, with the adaptive solve under ``control_flow.overwrite_with_bounded``
  when ``max_solver_steps`` is set, and resumes from ``checkpoint_dir``.

``theta`` is a tensor or nested lists / tuples / dicts of tensors (such as
a list of ``(w, b)`` layers).  A ``torch.optim`` optimizer takes optax's
place: ``fit`` takes a factory of it, ``optimizer(params)`` (for example
``functools.partial(torch.optim.Adam, lr=3e-3)``), and builds it on leaf
copies of ``theta0``'s tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import checkpointing, control_flow, stats


class Observations(NamedTuple):
    """Noisy trajectory observations on the solver's save_at grid.

    ``ts``: (T,) observation times (the grid the solve closure was built
    with).  ``ys``: (T,), (T, d) or, for an ensemble, (T, ..., d) observed
    values.  ``noise_std``: a scalar or (T,) observation noise standard
    deviation."""

    ts: torch.Tensor
    ys: torch.Tensor
    noise_std: torch.Tensor | float


def nlml(solve: Callable, observations: Observations, *, u0, output_scale=1.0):
    """``loss(theta) = -log p(ys | theta)`` from a ``facade.solve``-style
    closure ``solve(u0, theta, output_scale=)`` whose aux dict holds the
    posterior (``info["solution"].posterior``).  For an ensemble (``u0``
    with batch axes) the loss is the mean over the lanes."""
    like = torch.as_tensor(u0[0])
    ys = torch.as_tensor(observations.ys, dtype=like.dtype, device=like.device)
    if ys.dim() == 1:
        ys = ys[:, None]
    num = len(observations.ts)
    std = torch.as_tensor(observations.noise_std, dtype=like.dtype, device=like.device)
    std = std.expand(num)

    def loss_fn(theta):
        _u, info = solve(u0, theta, output_scale=output_scale)
        lml = stats.log_marginal_likelihood(ys, standard_deviation=std,
                                            posterior=info["solution"].posterior)
        return -torch.mean(lml)

    return loss_fn


def _flatten(tree):
    """The tensors of a nested list / tuple / dict, in order, and a function
    that rebuilds the nesting from such a list."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(x) for x in tree]
    else:
        raise TypeError(f"theta holds a {type(tree).__name__}; expected tensors")
    sizes = [len(leaves) for leaves, _ in parts]

    def unflatten(leaves):
        out, at = [], 0
        for (_, rebuild), size in zip(parts, sizes):
            out.append(rebuild(leaves[at:at + size]))
            at += size
        if keys is not None:
            return dict(zip(keys, out))
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)

    return [leaf for leaves, _ in parts for leaf in leaves], unflatten


def gradient_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, theta):
    """One optimizer step: ``step() -> loss`` evaluates ``loss_fn(theta)``,
    back-propagates into ``theta``'s tensors (the optimizer's parameters)
    and updates them in place; returns the loss before the update."""

    def step():
        optimizer.zero_grad(set_to_none=True)
        value = loss_fn(theta)
        value.backward()
        optimizer.step()
        return value.detach()

    return step


def fit(
    loss_fn: Callable,
    theta0,
    optimizer: Callable,
    *,
    num_steps: int,
    max_solver_steps: Optional[int] = None,
    callback: Optional[Callable[[int, float], None]] = None,
    checkpoint_dir=None,
    checkpoint_every: int = 50,
):
    """Run ``num_steps`` optimizer steps on ``loss_fn``; returns ``(theta,
    losses)`` with ``theta`` detached in ``theta0``'s nesting.

    ``optimizer(params)`` builds the ``torch.optim`` optimizer on leaf
    copies of ``theta0``'s tensors (``theta0`` itself is not changed).
    With ``max_solver_steps`` the steps run under
    ``control_flow.overwrite_with_bounded(max_solver_steps)`` (each attempt
    recomputed in the backward pass), so that the adaptive solve inside
    ``loss_fn`` is reverse-differentiable.  Ctrl-C ends the loop and keeps
    the progress so far.  ``checkpoint_dir`` saves ``{"theta", "opt_state", "losses"}``
    every ``checkpoint_every`` steps and on Ctrl-C; a rerun with the same
    directory restores the newest step (the optimizer's state included) and
    continues: ``num_steps`` counts the total steps."""
    leaves, unflatten = _flatten(theta0)
    params = [leaf.detach().clone().requires_grad_(True) for leaf in leaves]
    opt = optimizer(params)
    losses: list[float] = []
    start = 0
    if checkpoint_dir is not None:
        state = checkpointing.restore(checkpoint_dir, map_location=params[0].device)
        if state is not None:
            saved, _ = _flatten(state["theta"])
            with torch.no_grad():
                for p, v in zip(params, saved, strict=True):
                    p.copy_(v)
            opt.load_state_dict(state["opt_state"])
            losses = [float(v) for v in state["losses"]]
            start = state["step"]

    def theta():
        return unflatten([p.detach().clone() for p in params])

    def save(i):
        checkpointing.save(checkpoint_dir, i, {
            "theta": theta(), "opt_state": opt.state_dict(),
            "losses": torch.tensor(losses, dtype=torch.float64)})

    step = gradient_step(loss_fn, opt, unflatten(params))

    def run():
        try:
            for i in range(start, num_steps):
                losses.append(float(step()))
                if callback is not None:
                    callback(i, losses[-1])
                if checkpoint_dir is not None and (i + 1) % checkpoint_every == 0:
                    save(i + 1)
        except KeyboardInterrupt:
            if checkpoint_dir is not None and losses:
                save(len(losses))

    if max_solver_steps is not None:
        with control_flow.overwrite_with_bounded(max_steps=max_solver_steps):
            run()
    else:
        run()
    return theta(), losses
