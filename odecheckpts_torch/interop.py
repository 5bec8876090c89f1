"""Carry problem parameters and solver state between the JAX reference and
the port as numpy arrays.

The problems have no learned weights; what both packages must share to
compute the same thing are the vector-field parameters and the 17-array
lanes-last solver state (layout in ``batched.NUM_STATE``).  ``to_torch``
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


def _check_state(state):
    if len(state) != 17:
        raise ValueError(f"expected the 17-array lanes-last state, got {len(state)}")


def state_to_torch(state, *, device="cpu"):
    """The 17-array lanes-last state, given as numpy arrays, on ``device``."""
    _check_state(state)
    return to_torch(tuple(state), device=device)


def state_to_numpy(state):
    """The 17-array lanes-last state back to numpy arrays."""
    _check_state(state)
    return to_numpy(tuple(state))
