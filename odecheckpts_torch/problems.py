"""Initial value problems (PyTorch counterpart of ``odecheckpts_tpu.problems``).

Same contract as the reference: ``problem() -> (vf, u0_tuple, time_span,
args)``, with vector fields taking the state positionally and keyword-only
``t`` and ``p``.  Vector fields are written row-wise, so they apply to a
(d,) state and to a lanes-last (d, B) ensemble alike.

A vector field that the hand-written kernel can run carries the name of its
device functor in ``vf.device_functor`` (see ``csrc/step_ll.cu``); the
parameters ``p`` are passed to that functor as kernel arguments.
"""

from __future__ import annotations

import torch


def rigid_body(*, time_span=(0.0, 10.0)):
    """Euler's equations of a free rigid body (u0=(1, 0, 0.9),
    p=(-2, 1.25, -0.5))."""

    def vf(u, *, t, p):
        p1, p2, p3 = p
        return torch.stack([p1 * u[1] * u[2], p2 * u[0] * u[2], p3 * u[0] * u[1]])

    vf.device_functor = "rigid_body"
    u0 = torch.tensor([1.0, 0.0, 0.9], dtype=torch.float64)
    return vf, (u0,), tuple(time_span), (-2.0, 1.25, -0.5)
