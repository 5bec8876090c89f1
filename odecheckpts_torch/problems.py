"""Initial value problems (PyTorch counterpart of ``odecheckpts_tpu.problems``).

Same contract as the reference: ``problem() -> (vf, u0_tuple, time_span,
args)``, with vector fields taking the state positionally and keyword-only
``t`` and ``p``.  Vector fields are written row-wise, so they apply to a
(d,) state and to a lanes-last (d, B) ensemble alike.

A vector field that the hand-written kernels can run carries the name of its
device functor in ``vf.device_functor`` (see ``csrc/step_ll.cuh``,
``csrc/step_hi.cuh``, ``csrc/step_dense.cuh`` and ``csrc/step_bd.cuh``).  The parameters ``p`` of
a plain vector field are passed to that functor as kernel arguments, unless
the vector field names its own in ``vf.device_params`` (a tuple, or a
function of ``p``); a pair vector field carries its own in ``vf_df.params``.

``vf.jac(u, t=, p=)`` where present is the hand-derived Jacobian
``J[r, c] = d f_r / d u_c`` as a (d, d, ...) tensor, written in the order
of operations of the functor's ``jac`` in the kernel source; the dense
engine's TS1 correction uses it (``batched_dense``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import df32 as df


def logistic():
    """du/dt = a u (1 - u / K), u0 = 0.1 on (0, 2.5), a = K = 1."""

    def vf(u, *, t, p):
        a, k = p
        return a * u * (1.0 - u / k)

    u0 = torch.tensor([0.1], dtype=torch.float64)
    return vf, (u0,), (0.0, 2.5), (1.0, 1.0)


def rigid_body(*, time_span=(0.0, 10.0)):
    """Euler's equations of a free rigid body (u0=(1, 0, 0.9),
    p=(-2, 1.25, -0.5))."""

    def vf(u, *, t, p):
        p1, p2, p3 = p
        return torch.stack([p1 * u[1] * u[2], p2 * u[0] * u[2], p3 * u[0] * u[1]])

    def jac(u, *, t, p):
        p1, p2, p3 = p
        zero = torch.zeros_like(u[0])
        return torch.stack([
            torch.stack([zero, p1 * u[2], p1 * u[1]]),
            torch.stack([p2 * u[2], zero, p2 * u[0]]),
            torch.stack([p3 * u[1], p3 * u[0], zero]),
        ])

    vf.device_functor = "rigid_body"
    vf.jac = jac
    u0 = torch.tensor([1.0, 0.0, 0.9], dtype=torch.float64)
    return vf, (u0,), tuple(time_span), (-2.0, 1.25, -0.5)


#: Per-component scale of ``rigid_body_anisotropic``: the third component
#: lives 4 decades above the others.
ANISOTROPIC_SCALE = (1.0, 1.0, 1e4)


def rigid_body_anisotropic(*, time_span=(0.0, 50.0), scale=ANISOTROPIC_SCALE):
    """The rigid body in rescaled coordinates z = scale * y with
    ``scale = (1, 1, s3)`` (``experiments/6_tpu_batched_sweep/
    blockdiag_tpu.py:36-53``): one shared output scale misfits the third
    component by ``log10(s3)`` decades, which is what the blockdiag backend's
    per-dimension scales are for.

    The device functor ``"rigid_body_anisotropic"`` takes
    ``(p1, p2, s3 * p3, s3)`` as its kernel arguments: ``vf.device_params``
    maps the parameters ``p`` to them (the product is formed once, in
    Python, as the vector field forms it).
    """
    s1, s2, s3 = (float(c) for c in scale)
    if (s1, s2) != (1.0, 1.0):
        raise NotImplementedError(
            "rigid_body_anisotropic rescales the third component only, as the "
            "reference's experiment does"
        )
    params = (-2.0, 1.25, -0.5)

    def vf(u, *, t, p):
        p1, p2, p3 = p
        # divide by a tensor: torch turns division by a Python scalar into a
        # multiplication by its reciprocal, which rounds differently
        w = u[2] / torch.full_like(u[2], s3)
        return torch.stack([p1 * u[1] * w, p2 * u[0] * w, (s3 * p3) * u[0] * u[1]])

    vf.device_functor = "rigid_body_anisotropic"
    vf.device_params = lambda p: (p[0], p[1], s3 * p[2], s3)
    u0 = torch.tensor([1.0, 0.0, 0.9], dtype=torch.float64) * torch.tensor(
        [s1, s2, s3], dtype=torch.float64)
    return vf, (u0,), tuple(time_span), params


def brusselator(N, t0=0.0, tmax=10.0, laplacian="slices"):
    """Brusselator method-of-lines PDE with state dimension 2N
    (counterpart of ``odecheckpts_tpu/problems.py:150-194``).

    Only the ``laplacian="slices"`` form is ported: the band of the
    Laplacian by axis-0 slices, which broadcasts over a trailing lane axis,
    so ``vf`` takes (2N,) states and (2N, B) ensembles alike.  The kernels'
    functor ``"brusselator"`` is instantiated for N = 2 and takes the
    diffusion constant ``c = (N + 1)^2 / 50`` as its kernel argument
    (``vf.device_params``).
    """
    if laplacian != "slices":
        raise NotImplementedError(
            f"laplacian={laplacian!r} is not ported (the 'slices' form computes the "
            "same band): ROADMAP queue 1 item 5"
        )
    const = 1.0 / 50.0 * (N + 1) ** 2

    def vf(y, *, t=None, p=(), n=N, c=const):
        u, v = y[:n], y[n:]
        ones = torch.ones_like(u[:1])
        u_ = torch.cat([ones, u, ones], dim=0)
        v_ = torch.cat([3.0 * ones, v, 3.0 * ones], dim=0)
        conv_u = u_[:-2] - 2.0 * u_[1:-1] + u_[2:]
        conv_v = v_[:-2] - 2.0 * v_[1:-1] + v_[2:]
        u_new = 1.0 + u * u * v - 4.0 * u + c * conv_u
        v_new = 3.0 * u - u * u * v + c * conv_v
        return torch.cat([u_new, v_new], dim=0)

    def jac(y, *, t=None, p=(), n=N, c=const):
        # the terms of forward-mode differentiation of vf, in its order
        u, v = y[:n], y[n:]
        zero = torch.zeros_like(u[0])
        cc = torch.full_like(u[0], c)
        rows = [[zero] * (2 * n) for _ in range(2 * n)]
        for i in range(n):
            two_uv = (2.0 * u[i]) * v[i]
            uu = u[i] * u[i]
            rows[i][i] = (two_uv - 4.0) - 2.0 * c
            rows[i][n + i] = uu
            rows[n + i][i] = 3.0 - two_uv
            rows[n + i][n + i] = -uu - 2.0 * c
            for j in (i - 1, i + 1):
                if 0 <= j < n:
                    rows[i][j] = cc
                    rows[n + i][n + j] = cc
        return torch.stack([torch.stack(r) for r in rows])

    vf.device_functor = "brusselator"
    vf.device_params = (const,)
    vf.jac = jac
    x0 = torch.linspace(0.0, 1.0, N, dtype=torch.float64)
    y0 = torch.cat([torch.sin(2.0 * math.pi * x0) + 1.0,
                    torch.full((N,), 3.0, dtype=torch.float64)])
    return vf, (y0,), (t0, tmax), ()


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


def neural_ode_mlp(*, layer_sizes: tuple):
    """Tanh MLP vector field ``f(u, t) = mlp(params, [u, t])`` for neural-ODE
    training (counterpart of ``odecheckpts_tpu/problems.py:208-234``).

    The parameters are ``(params,)`` with ``params`` a list of ``(w, b)``
    float64 tensors, ``w`` (fan_in, fan_out) and ``b`` (fan_out,), drawn
    from N(0, 1 / fan_in) with numpy's generator of seed 0 (the reference
    draws its own with ``jax.random``; ``interop.params_to_torch`` carries
    those across).  ``vf`` is the one-IVP function: (d,) states."""

    def mlp(params, inputs):
        for w, b in params:
            outputs = inputs @ w + b
            inputs = torch.tanh(outputs)
        return outputs

    def vf(u, *, t, p):
        t = torch.as_tensor(t, dtype=u.dtype, device=u.device)
        return mlp(*p, torch.cat([u, t.reshape(1)]))

    u0 = torch.tensor([0.1], dtype=torch.float64)
    rng = np.random.default_rng(0)
    params = []
    sizes = list(layer_sizes)
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        scale = 1.0 / math.sqrt(1.0 * fan_in)
        w = torch.tensor(scale * rng.standard_normal((fan_in, fan_out)))
        b = torch.tensor(scale * rng.standard_normal(fan_out))
        params.append((w, b))
    return vf, (u0,), (0.0, 1.0), (params,)
