"""Isotropic square-root state-space backend (PyTorch counterpart of
``odecheckpts_tpu.ssm.isotropic``).

One shared (n, n) covariance factor across all d ODE dimensions; the mean
is laid out (n, d).  Every method broadcasts over leading batch dimensions:
a mean is (..., n, d), a factor (..., n, n), and ``dt`` / ``output_scale``
carry the batch shape alone.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import linalg, prior, rounded
from .base import Conditional, Normal


@dataclasses.dataclass(frozen=True)
class IsotropicSSM:
    num_derivatives: int
    ode_shape: tuple

    name = "isotropic"

    @property
    def n(self):
        return self.num_derivatives + 1

    @property
    def d(self):
        (d,) = self.ode_shape
        return d

    def stack_tcoeffs(self, tcoeffs):
        """Zero-covariance state from n Taylor coefficients, each (..., d)."""
        if len(tcoeffs) != self.n:
            raise ValueError(
                f"expected {self.n} Taylor coefficients, got {len(tcoeffs)}"
            )
        mean = torch.stack(list(tcoeffs), dim=-2)
        chol = mean.new_zeros(mean.shape[:-2] + (self.n, self.n))
        return Normal(mean, chol)

    def promote_output_scale(self, scale):
        return torch.as_tensor(scale)

    def qoi(self, mean):
        return mean[..., 0, :]

    def select_deriv(self, mean, i):
        return mean[..., i, :]

    def qoi_std(self, rv):
        """Marginal standard deviation of the solution, (..., d): the shared
        factor's first row norm for every dimension."""
        s = rounded.sqrt(torch.sum(rv.cholesky[..., 0, :] ** 2, dim=-1))
        return s[..., None].expand(rv.mean.shape[:-2] + (self.d,))

    def _system(self, like):
        return prior.system_matrices(
            self.num_derivatives, dtype=like.dtype, device=like.device
        )

    def extrapolate_mean(self, mean, dt):
        """Predicted mean in preconditioned coordinates and the cache
        ``(p, p_inv)`` that ``extrapolate_cov`` and the error estimate reuse."""
        a, _ = self._system(mean)
        p, p_inv = prior.preconditioner(dt, self.num_derivatives)
        m_pred = p[..., :, None] * rounded.matmul(a, p_inv[..., :, None] * mean)
        return m_pred, (p, p_inv)

    def extrapolate_cov(self, rv, m_pred, cache, output_scale, reversal):
        """Predicted factor (and, with ``reversal``, the backward conditional)
        of the preconditioned transition; one QR either way."""
        a, l_q = self._system(rv.mean)
        p, p_inv = cache
        l_bar = p_inv[..., :, None] * rv.cholesky
        a_l = rounded.matmul(a, l_bar)
        l_q_scaled = output_scale[..., None, None] * l_q
        if not reversal:
            l_pred_bar = linalg.chol_from_stack(
                a_l.transpose(-1, -2), l_q_scaled.transpose(-1, -2)
            )
            return Normal(m_pred, p[..., :, None] * l_pred_bar), None
        l_pred_bar, gain_bar, l_bwd_bar = linalg.revert_markov(a_l, l_q_scaled, l_bar)
        l_pred = p[..., :, None] * l_pred_bar
        gain = (p[..., :, None] * gain_bar) * p_inv[..., None, :]
        noise_mean = rv.mean - rounded.matmul(gain, m_pred)
        bwd = Conditional(gain, Normal(noise_mean, p[..., :, None] * l_bwd_bar))
        return Normal(m_pred, l_pred), bwd

    def extrapolate_direct(self, rv, dt, output_scale, reversal):
        """Extrapolation in unpreconditioned coordinates (interpolation path).

        Same semantics as the preconditioned extrapolation, formed from
        ``Phi(dt)`` and ``chol(Q(dt)) = P Lq`` so that no ``P^{-1}`` appears.
        """
        phi = prior.phi_direct(dt, self.num_derivatives)
        p, _ = prior.preconditioner(dt, self.num_derivatives)
        _, l_q = self._system(rv.mean)
        q_chol = output_scale[..., None, None] * (p[..., :, None] * l_q)
        m_pred = rounded.matmul(phi, rv.mean)
        a_l = rounded.matmul(phi, rv.cholesky)
        if not reversal:
            l_pred = linalg.chol_from_stack(a_l.transpose(-1, -2), q_chol.transpose(-1, -2))
            return Normal(m_pred, l_pred), None
        l_pred, gain, l_bwd = linalg.revert_markov(a_l, q_chol, rv.cholesky)
        noise_mean = rv.mean - rounded.matmul(gain, m_pred)
        return Normal(m_pred, l_pred), Conditional(gain, Normal(noise_mean, l_bwd))

    def error_and_scale_deriv(self, z, cache, o, unit="qoi"):
        """Local MLE output scale and error estimate from the TS0 residual
        ``z`` (..., d): ``sigma = ||z|| / (s_unit sqrt(d))`` with
        ``s_unit = p_o ||Lq[o, :]||``; the error in solution units
        (``unit="qoi"``: ``sigma p_0 ||Lq[0, :]||``) or in residual units
        (``sigma s_unit``), broadcast to (..., d)."""
        _, l_q = self._system(z)
        p, _ = cache
        s_unit = p[..., o] * rounded.sqrt(torch.sum(l_q[o, :] ** 2))
        sigma = rounded.sqrt(torch.sum(z**2, dim=-1)) / (s_unit * math.sqrt(1.0 * self.d))
        if unit == "residual":
            err = sigma * s_unit
        else:
            err = sigma * p[..., 0] * rounded.sqrt(torch.sum(l_q[0, :] ** 2))
        return sigma, err[..., None].expand(err.shape + (self.d,))

    def correct_deriv(self, rv, z, o):
        """Exact constraint update on the o-th derivative (TS0): the rank-1
        factor update ``L - (c / s^2) l_obs`` with ``c = Sigma e_o``; returns
        the corrected state and the observed ``Normal(z, s)``."""
        l = rv.cholesky
        l_obs = l[..., o, :]
        s2 = torch.sum(l_obs**2, dim=-1)
        s = rounded.sqrt(s2)
        crosscov = rounded.matmul(l, l_obs[..., None])
        gain = crosscov[..., 0] / s2[..., None]
        mean = rv.mean - gain[..., :, None] * z[..., None, :]
        chol = l - gain[..., :, None] * l_obs[..., None, :]
        return Normal(mean, chol), Normal(z, s)

    def identity_conditional(self, dtype, device=None):
        eye = torch.eye(self.n, dtype=dtype, device=device)
        noise = Normal(
            torch.zeros((self.n, self.d), dtype=dtype, device=device),
            torch.zeros((self.n, self.n), dtype=dtype, device=device),
        )
        return Conditional(eye, noise)

    def marginalize(self, rv, cond):
        mean = rounded.matmul(cond.matrix, rv.mean) + cond.noise.mean
        chol = linalg.chol_from_stack(
            rounded.matmul(cond.matrix, rv.cholesky).transpose(-1, -2),
            cond.noise.cholesky.transpose(-1, -2),
        )
        return Normal(mean, chol)

    def compose(self, outer, inner):
        """Conditional composition: outer(inner(x)), both backward-in-time."""
        matrix = rounded.matmul(outer.matrix, inner.matrix)
        mean = rounded.matmul(outer.matrix, inner.noise.mean) + outer.noise.mean
        chol = linalg.chol_from_stack(
            rounded.matmul(outer.matrix, inner.noise.cholesky).transpose(-1, -2),
            outer.noise.cholesky.transpose(-1, -2),
        )
        return Conditional(matrix, Normal(mean, chol))
