"""Initial value problems (PyTorch counterpart of ``odecheckpts_tpu.problems``).

Same contract as the reference: ``problem() -> (vf, u0_tuple, time_span,
args)``, with vector fields taking the state positionally and keyword-only
``t`` and ``p``.  Vector fields are written row-wise, so they apply to a
(d,) state and to a lanes-last (d, B) ensemble alike.

A vector field that the hand-written kernels can run carries the name of its
device functor in ``vf.device_functor`` (see ``csrc/step_ll.cu`` and
``csrc/step_hi.cu``).  The parameters ``p`` of a plain vector field are
passed to that functor as kernel arguments; a pair vector field carries its
own in ``vf_df.params``.
"""

from __future__ import annotations

import torch

from . import df32 as df


def rigid_body(*, time_span=(0.0, 10.0)):
    """Euler's equations of a free rigid body (u0=(1, 0, 0.9),
    p=(-2, 1.25, -0.5))."""

    def vf(u, *, t, p):
        p1, p2, p3 = p
        return torch.stack([p1 * u[1] * u[2], p2 * u[0] * u[2], p3 * u[0] * u[1]])

    vf.device_functor = "rigid_body"
    u0 = torch.tensor([1.0, 0.0, 0.9], dtype=torch.float64)
    return vf, (u0,), tuple(time_span), (-2.0, 1.25, -0.5)


def rigid_body_df(params=(-2.0, 1.25, -0.5)):
    """Rigid body in compensated (hi, lo) pair arithmetic, lanes-last
    (counterpart of ``odecheckpts_tpu/problems.py:46-77``).

    ``vf_df(args, t)`` takes ``args = ((u_hi, u_lo),)`` with (d, B) halves
    and returns the (hi, lo) pair of f(u); ``t`` is unused.  The parameters
    (-2, 1.25, -0.5) are dyadic, hence exact in f32.
    """
    p1, p2, p3 = (float(p) for p in params)

    def vf_df(args, t):
        ((uh, ul),) = args

        def row(i):
            return uh[i : i + 1], ul[i : i + 1]

        y0, y1, y2 = row(0), row(1), row(2)
        f0 = df.mul1(df.mul(y1, y2), p1)
        f1 = df.mul1(df.mul(y0, y2), p2)
        f2 = df.mul1(df.mul(y0, y1), p3)
        return (
            torch.cat([f0[0], f1[0], f2[0]], dim=0),
            torch.cat([f0[1], f1[1], f2[1]], dim=0),
        )

    vf_df.device_functor = "rigid_body_df"
    vf_df.params = (p1, p2, p3)
    return vf_df
