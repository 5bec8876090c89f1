"""Carry problem parameters and solver state between the JAX reference and
the port as numpy arrays.

The problems have no learned weights; what both packages must share to
compute the same thing are the vector-field parameters and the lanes-last
solver state: 17 arrays for the f32 engine (layout in
``batched.NUM_STATE``), 12 for the df32 engine (``batched_hi.NUM_STATE_HI``;
pairs travel as their two halves).  ``to_torch``
turns nested tuples of numpy arrays or floats (a state, or the parameters
``(-2, 1.25, -0.5)`` as 0-dim tensors) into tensors on a device,
``to_numpy`` turns nested tuples of tensors back.
"""

from __future__ import annotations

import numpy as np
import torch


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


_STATE_LENGTHS = (17, 12)  # batched.NUM_STATE, batched_hi.NUM_STATE_HI


def _check_state(state):
    if len(state) not in _STATE_LENGTHS:
        raise ValueError(
            f"expected a lanes-last state of {_STATE_LENGTHS} arrays, got {len(state)}"
        )


def state_to_torch(state, *, device="cpu"):
    """A lanes-last state (17 or 12 arrays), given as numpy arrays, on
    ``device``."""
    _check_state(state)
    return to_torch(tuple(state), device=device)


def state_to_numpy(state):
    """A lanes-last state (17 or 12 arrays) back to numpy arrays."""
    _check_state(state)
    return to_numpy(tuple(state))
