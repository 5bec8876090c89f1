"""Block-diagonal square-root state-space backend (PyTorch counterpart of
``odecheckpts_tpu/ssm/blockdiag.py``).

One independent (n, n) covariance factor and one output scale per ODE
dimension: the factorization for systems whose components live at very
different magnitudes.  TS0 corrections only.  Layout: mean (..., d, n),
factor (..., d, n, n), output scale (..., d); ``dt`` carries the batch shape
alone.  Every method broadcasts over leading batch dimensions; products go
through ``rounded`` (the same sums on every host).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import linalg, prior, rounded
from .base import Conditional, Normal


def _mv(matrix, vec):
    """(..., d, n, n) @ (..., d, n) -> (..., d, n)."""
    return rounded.matmul(matrix, vec[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class BlockDiagSSM:
    num_derivatives: int
    ode_shape: tuple

    name = "blockdiag"

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
        coeffs = [torch.as_tensor(c) for c in tcoeffs]
        coeffs = [c.expand(c.shape[:-1] + (self.d,)) for c in coeffs]
        mean = torch.stack(coeffs, dim=-1)  # (..., d, n)
        chol = mean.new_zeros(mean.shape + (self.n,))
        return Normal(mean, chol)

    def promote_output_scale(self, scale):
        """One scale per ODE dimension from a scale of the batch shape."""
        scale = torch.as_tensor(scale)
        return scale[..., None].expand(scale.shape + (self.d,))

    def qoi(self, mean):
        return mean[..., :, 0]

    def qoi_from_sample(self, sample):
        return sample[..., :, 0]

    def select_deriv(self, mean, i):
        return mean[..., :, i]

    def qoi_std(self, rv):
        """Marginal standard deviation of the solution, (..., d)."""
        return rounded.sqrt(torch.sum(rv.cholesky[..., :, 0, :] ** 2, dim=-1))

    def _system(self, like):
        return prior.system_matrices(
            self.num_derivatives, dtype=like.dtype, device=like.device
        )

    def extrapolate_mean(self, mean, dt):
        """Predicted mean in preconditioned coordinates and the cache
        ``(p, p_inv)``, each (..., n), shared by the d dimensions."""
        a, _ = self._system(mean)
        p, p_inv = prior.preconditioner(dt, self.num_derivatives)
        m_pred = p[..., None, :] * _mv(a, p_inv[..., None, :] * mean)
        return m_pred, (p, p_inv)

    def extrapolate_cov(self, rv, m_pred, cache, output_scale, reversal):
        """Predicted factors (and, with ``reversal``, the backward
        conditionals) of the preconditioned transition, per dimension with
        that dimension's output scale."""
        a, l_q = self._system(rv.mean)
        p, p_inv = cache
        p_c, p_inv_c = p[..., None, :, None], p_inv[..., None, :, None]
        l_bar = p_inv_c * rv.cholesky  # (..., d, n, n)
        a_l = rounded.matmul(a, l_bar)
        l_q_scaled = output_scale[..., :, None, None] * l_q
        if not reversal:
            l_pred_bar = linalg.chol_from_stack(a_l.transpose(-1, -2),
                                                l_q_scaled.transpose(-1, -2))
            return Normal(m_pred, p_c * l_pred_bar), None
        l_pred_bar, gain_bar, l_bwd_bar = linalg.revert_markov(a_l, l_q_scaled, l_bar)
        gain = (p_c * gain_bar) * p_inv[..., None, None, :]
        noise_mean = rv.mean - _mv(gain, m_pred)
        bwd = Conditional(gain, Normal(noise_mean, p_c * l_bwd_bar))
        return Normal(m_pred, p_c * l_pred_bar), bwd

    def extrapolate_direct(self, rv, dt, output_scale, reversal):
        """Extrapolation in unpreconditioned coordinates (interpolation
        path), per dimension: ``Phi(dt)`` and ``chol(Q(dt)) = P Lq`` times
        that dimension's output scale."""
        phi = prior.phi_direct(dt, self.num_derivatives)[..., None, :, :]
        p, _ = prior.preconditioner(dt, self.num_derivatives)
        _, l_q = self._system(rv.mean)
        q_chol = output_scale[..., :, None, None] * (p[..., :, None] * l_q)[..., None, :, :]
        m_pred = _mv(phi, rv.mean)
        a_l = rounded.matmul(phi, rv.cholesky)
        if not reversal:
            l_pred = linalg.chol_from_stack(a_l.transpose(-1, -2), q_chol.transpose(-1, -2))
            return Normal(m_pred, l_pred), None
        l_pred, gain, l_bwd = linalg.revert_markov(a_l, q_chol, rv.cholesky)
        noise_mean = rv.mean - _mv(gain, m_pred)
        return Normal(m_pred, l_pred), Conditional(gain, Normal(noise_mean, l_bwd))

    def error_and_scale_deriv(self, z, cache, o, unit="qoi"):
        """Per-dimension MLE scales ``sigma_i = |z_i| / s_unit`` and error
        estimates in solution units (``unit="qoi"``) or residual units, each
        (..., d)."""
        _, l_q = self._system(z)
        p, _ = cache
        s_unit = p[..., o, None] * rounded.sqrt(torch.sum(l_q[o, :] ** 2))
        sigma = torch.abs(z) / s_unit
        if unit == "residual":
            return sigma, sigma * s_unit
        return sigma, sigma * p[..., 0, None] * rounded.sqrt(torch.sum(l_q[0, :] ** 2))

    def correct_deriv(self, rv, z, o):
        """Exact constraint update on the o-th derivative (TS0), per
        dimension: the rank-1 factor update of the isotropic backend (none in
        a dimension whose variance underflowed: ``linalg.rank1_gain``)."""
        l = rv.cholesky  # (..., d, n, n)
        l_obs = l[..., :, o, :]  # (..., d, n)
        s2 = torch.sum(l_obs**2, dim=-1)
        s = rounded.sqrt(s2)
        gain = linalg.rank1_gain(_mv(l, l_obs), s2)
        mean = rv.mean - gain * z[..., :, None]
        chol = l - gain[..., :, :, None] * l_obs[..., :, None, :]
        return Normal(mean, chol), Normal(z, s)

    def identity_conditional(self, dtype, device=None):
        eye = torch.eye(self.n, dtype=dtype, device=device).expand(self.d, self.n, self.n)
        noise = Normal(
            torch.zeros((self.d, self.n), dtype=dtype, device=device),
            torch.zeros((self.d, self.n, self.n), dtype=dtype, device=device),
        )
        return Conditional(eye, noise)

    def marginalize(self, rv, cond):
        mean = _mv(cond.matrix, rv.mean) + cond.noise.mean
        chol = linalg.chol_from_stack(
            rounded.matmul(cond.matrix, rv.cholesky).transpose(-1, -2),
            cond.noise.cholesky.transpose(-1, -2),
        )
        return Normal(mean, chol)

    def compose(self, outer, inner):
        """Conditional composition: outer(inner(x)), both backward-in-time."""
        matrix = rounded.matmul(outer.matrix, inner.matrix)
        mean = _mv(outer.matrix, inner.noise.mean) + outer.noise.mean
        chol = linalg.chol_from_stack(
            rounded.matmul(outer.matrix, inner.noise.cholesky).transpose(-1, -2),
            outer.noise.cholesky.transpose(-1, -2),
        )
        return Conditional(matrix, Normal(mean, chol))

    def condition_qoi(self, rv, data, obs_std):
        """Observe ``data = qoi(x) + N(0, obs_std^2 I_d)``: a Potter update per
        dimension; returns the Gaussian log-likelihood of ``data`` (summed
        over the dimensions) and the conditioned state.  ``obs_std`` is a
        scalar or of the batch shape."""
        l = rv.cholesky
        l0 = l[..., :, 0, :]  # (..., d, n)
        std = torch.as_tensor(obs_std, dtype=l.dtype, device=l.device)[..., None]
        s2 = torch.sum(l0**2, dim=-1) + std**2
        s = rounded.sqrt(s2)
        crosscov = _mv(l, l0)
        gain = crosscov / s2[..., :, None]
        resid = rv.mean[..., :, 0] - data
        mean = rv.mean - gain * resid[..., :, None]
        beta = (1.0 / (s * (s + std)))[..., :, None, None]
        chol = l - beta * crosscov[..., :, :, None] * l0[..., :, None, :]
        loglik = torch.sum(
            -0.5 * resid**2 / s2 - rounded.log(s) - 0.5 * math.log(2.0 * math.pi), dim=-1
        )
        return loglik, Normal(mean, chol)

    def base_shape(self):
        return (self.d, self.n)

    def transform_base(self, rv, xi):
        return rv.mean + _mv(rv.cholesky, xi)

    def conditional_sample(self, cond, x, xi):
        return _mv(cond.matrix, x) + cond.noise.mean + _mv(cond.noise.cholesky, xi)

    def rescale_cholesky(self, tree_chol, factor):
        """Factors times the per-dimension output scales ``factor`` (..., d)."""
        return tree_chol * factor[..., :, None, None]
