"""Carry problem parameters and solver state between the JAX reference and
the port as numpy arrays.

The problems have no learned weights; what both packages must share to
compute the same thing are the vector-field parameters and the lanes-last
solver state: 17 arrays for the f32 engines (layout in
``batched.NUM_STATE``: (n, d, B) means and (n, n, B) factors on the
isotropic engine, (nd, B) means and (nd, nd, B) factors on the dense one,
(n, d, B) means, (n, n, d, B) factors and (d, B) ``scale`` and ``mle`` rows
on the blockdiag one), 12 for the df32 engine (``batched_hi.NUM_STATE_HI``;
pairs travel as their two halves).  ``state_layout`` tells the four apart by
shape.  ``to_torch``
turns nested tuples of numpy arrays or floats (a state, or the parameters
``(-2, 1.25, -0.5)`` as 0-dim tensors) into tensors on a device,
``to_numpy`` turns nested tuples of tensors back.

The fixed-grid path carries an initial condition, a ``Solution`` with its
``MarkovSeq`` stacks, parallel-in-time filtering elements and a diagnostics
dict: ``init_to_torch``, ``solution_to_numpy``, ``elements_to_torch`` /
``elements_to_numpy`` (step-leading numpy on the outside, step-leading or
lanes-last tensors inside) and ``diagnostics_to_numpy`` carry those.

Learned weights (the training path) are nested lists, tuples and dicts of
arrays, such as a list of ``(w, b)`` layers: ``params_to_torch`` and
``params_to_numpy`` carry them across with their nesting.
"""

from __future__ import annotations

import numpy as np
import torch

from .ssm.base import Normal


def _rebuild(tree, items):
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def to_torch(tree, *, device="cpu"):
    """Nested tuples of numpy arrays / floats -> the same nesting of tensors
    (copies, dtypes kept)."""
    if isinstance(tree, tuple):
        return _rebuild(tree, [to_torch(x, device=device) for x in tree])
    return torch.tensor(np.asarray(tree), device=device)


def to_numpy(tree):
    """Nested tuples of tensors -> the same nesting of numpy arrays."""
    if isinstance(tree, tuple):
        return _rebuild(tree, [to_numpy(x) for x in tree])
    return tree.detach().cpu().numpy()


# position of each array of a lanes-last state -> its kind: a (1, B) row, a
# mean, a factor (gains share the factors' shape), a per-dimension row
# ((d, B) on the blockdiag engine, (1, B) elsewhere)
_KINDS = {
    17: "r m f f m f c r m f f m f r r r c",  # batched.NUM_STATE
    12: "r r m m f r f m m r r r",  # batched_hi.NUM_STATE_HI
}


def state_layout(state):
    """``"isotropic"``, ``"dense"``, ``"blockdiag"`` or ``"df32"`` for a
    lanes-last state, from the number of arrays and their shapes; raises
    ``ValueError`` on anything else."""
    kinds = _KINDS.get(len(state), "").split()
    if not kinds:
        raise ValueError(
            f"expected a lanes-last state of {tuple(_KINDS)} arrays, got {len(state)}"
        )
    shapes = [tuple(np.shape(x)) for x in state]
    mean = shapes[kinds.index("m")]  # (n, d, B) or, dense, (nd, B)
    factor = shapes[kinds.index("f")]
    blockdiag = len(state) == 17 and len(mean) == 3 and len(factor) == 4
    want = {"r": (1, mean[-1]), "m": mean, "f": (mean[0], mean[0], mean[-1]),
            "c": (1, mean[-1])}
    if blockdiag:
        want["f"] = (mean[0], mean[0], mean[1], mean[2])
        want["c"] = (mean[1], mean[2])
    bad = [i for i, (k, s) in enumerate(zip(kinds, shapes)) if s != want[k]]
    layouts = {(17, 3): "isotropic", (17, 2): "dense", (12, 3): "df32"}
    if bad or (len(state), len(mean)) not in layouts:
        raise ValueError(f"the shapes {shapes} fit no state layout (arrays {bad} are off)")
    return "blockdiag" if blockdiag else layouts[len(state), len(mean)]


def _check_state(state):
    state_layout(state)


def state_to_torch(state, *, device="cpu"):
    """A lanes-last state (17 or 12 arrays, see ``state_layout``), given as
    numpy arrays, on ``device``."""
    _check_state(state)
    return to_torch(tuple(state), device=device)


def state_to_numpy(state):
    """A lanes-last state (17 or 12 arrays) back to numpy arrays."""
    _check_state(state)
    return to_numpy(tuple(state))


def init_to_torch(init, *, device="cpu"):
    """``((mean, cholesky), output_scale)`` as numpy arrays (the reference's
    ``solver.initial_condition``) -> ``(Normal, scale)`` tensors on ``device``,
    dtypes kept."""
    (mean, chol), scale = init
    return Normal(*to_torch((mean, chol), device=device)), to_torch(scale, device=device)


def solution_to_numpy(sol):
    """A fixed-grid ``Solution`` as a dict of numpy arrays: ``t``, ``u``,
    ``u_std``, ``output_scale``, the stacked marginals ``mean`` / ``cholesky``
    and, for a strategy with reversal, the stacked backward conditionals
    ``cond_matrix`` / ``cond_mean`` / ``cond_cholesky`` (else None)."""
    out = {k: to_numpy(getattr(sol, k)) for k in ("t", "u", "u_std", "output_scale")}
    out["mean"], out["cholesky"] = to_numpy(tuple(sol.posterior.init))
    cond = sol.posterior.conditional
    out["cond_matrix"] = None if cond is None else to_numpy(cond.matrix)
    out["cond_mean"] = None if cond is None else to_numpy(cond.noise.mean)
    out["cond_cholesky"] = None if cond is None else to_numpy(cond.noise.cholesky)
    return out


def _check_elements(els):
    if len(els) != 5:
        raise ValueError(f"a filtering element is (A, b, U, eta, Z), got {len(els)} arrays")


def elements_to_torch(els, *, lanes_last=False, device="cpu"):
    """Step-leading numpy elements ((P, m, m), (P, m, c), ...) -> tensors on
    ``device``, step-leading or (``lanes_last``) with the step axis last and
    contiguous, as ``pit_fused`` and the kernel take them."""
    _check_elements(els)
    out = to_torch(tuple(els), device=device)
    if lanes_last:
        out = tuple(torch.movedim(x, 0, -1).contiguous() for x in out)
    return out


def elements_to_numpy(els, *, lanes_last=False):
    """Element tensors (step-leading, or lanes-last if ``lanes_last``) back
    to step-leading numpy arrays."""
    _check_elements(els)
    if lanes_last:
        els = tuple(torch.movedim(x, -1, 0) for x in els)
    return to_numpy(tuple(els))


def diagnostics_to_numpy(diag):
    """The diagnostics dict of ``solve_fixed_grid(parallel=True,
    return_diagnostics=True)``: tensors to numpy arrays, ints kept."""
    return {k: to_numpy(v) if isinstance(v, torch.Tensor) else v for k, v in diag.items()}


def params_to_torch(params, *, device="cpu"):
    """Nested lists / tuples / dicts of numpy arrays or floats (the reference's
    parameter pytree, e.g. a list of ``(w, b)`` layers) -> the same nesting of
    tensors on ``device`` (copies, dtypes kept)."""
    if isinstance(params, dict):
        return {k: params_to_torch(v, device=device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        items = [params_to_torch(x, device=device) for x in params]
        return items if isinstance(params, list) else _rebuild(params, items)
    return torch.tensor(np.asarray(params), device=device)


def params_to_numpy(params):
    """The inverse of ``params_to_torch``: the same nesting of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        items = [params_to_numpy(x) for x in params]
        return items if isinstance(params, list) else _rebuild(params, items)
    return params.detach().cpu().numpy()
