"""Dense square-root state-space backend (PyTorch counterpart of
``odecheckpts_tpu/ssm/dense.py``).

Full (n*d, n*d) covariance factor, the backend that TS1 needs for d > 1.
Layout: derivative-major flat state ``x = (u^(0), ..., u^(nu))`` with each
``u^(i)`` a d-block, so ``x[i*d + k] = u^(i)_k``.  The IBM transition is
``kron(A, I_d)``, applied block-row-wise.  Every method broadcasts over
leading batch dimensions: a mean is (..., nd), a factor (..., nd, nd), and
``dt`` / ``output_scale`` carry the batch shape alone.  Products go through
``rounded`` (the same sums on every host).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import linalg, prior, rounded
from .base import Conditional, Normal


def _mv(matrix, vec):
    """(..., k, l) @ (..., l) -> (..., k)."""
    return rounded.matmul(matrix, vec[..., None])[..., 0]


def _div(x, c):
    """x / c for a Python constant c, divided by a tensor (torch multiplies by
    the reciprocal of a scalar divisor on CUDA)."""
    return x / torch.full_like(x, c)


@dataclasses.dataclass(frozen=True)
class DenseSSM:
    num_derivatives: int
    ode_shape: tuple

    name = "dense"

    @property
    def n(self):
        return self.num_derivatives + 1

    @property
    def d(self):
        (d,) = self.ode_shape
        return d

    @property
    def ndim(self):
        return self.n * self.d

    def stack_tcoeffs(self, tcoeffs):
        """Zero-covariance state from n Taylor coefficients, each (..., d)."""
        if len(tcoeffs) != self.n:
            raise ValueError(
                f"expected {self.n} Taylor coefficients, got {len(tcoeffs)}"
            )
        coeffs = [torch.as_tensor(c) for c in tcoeffs]
        coeffs = [c.expand(c.shape[:-1] + (self.d,)) for c in coeffs]
        mean = torch.cat(coeffs, dim=-1)
        chol = mean.new_zeros(mean.shape[:-1] + (self.ndim, self.ndim))
        return Normal(mean, chol)

    def promote_output_scale(self, scale):
        return torch.as_tensor(scale)

    def qoi(self, mean):
        return mean[..., : self.d]

    def qoi_from_sample(self, sample):
        return sample[..., : self.d]

    def qoi_std(self, rv):
        """Marginal standard deviation of the solution, (..., d)."""
        return rounded.sqrt(torch.sum(rv.cholesky[..., : self.d, :] ** 2, dim=-1))

    def select_deriv(self, mean, i):
        return mean[..., i * self.d : (i + 1) * self.d]

    def _system(self, like):
        return prior.system_matrices(
            self.num_derivatives, dtype=like.dtype, device=like.device
        )

    def _precond(self, dt):
        """``(repeat(p, d), repeat(1/p, d))``, each (..., nd)."""
        p, p_inv = prior.preconditioner(dt, self.num_derivatives)
        return (torch.repeat_interleave(p, self.d, dim=-1),
                torch.repeat_interleave(p_inv, self.d, dim=-1))

    def _apply_a(self, a, x, matrix: bool):
        """kron(A, I_d) @ x for x of shape (..., nd) or, if matrix, (..., nd, m);
        ``a`` is (n, n) or carries the batch shape, (..., n, n)."""
        if matrix:
            lead, m = x.shape[:-2], x.shape[-1]
            out = rounded.matmul(a, x.reshape(lead + (self.n, self.d * m)))
            return out.reshape(out.shape[:-2] + (self.ndim, m))
        lead = x.shape[:-1]
        out = rounded.matmul(a, x.reshape(lead + (self.n, self.d)))
        return out.reshape(out.shape[:-2] + (self.ndim,))

    def _kron_eye(self, m):
        """kron(m, I_d) for (..., n, n) ``m``, formed as jnp.kron forms it."""
        eye = torch.eye(self.d, dtype=m.dtype, device=m.device)
        out = m[..., :, None, :, None] * eye[:, None, :]
        return out.reshape(m.shape[:-2] + (self.ndim, self.ndim))

    def extrapolate_mean(self, mean, dt):
        """Predicted mean in preconditioned coordinates and the cache
        ``(p, p_inv)``, each (..., nd)."""
        a, _ = self._system(mean)
        p, p_inv = self._precond(dt)
        m_pred = p * self._apply_a(a, p_inv * mean, matrix=False)
        return m_pred, (p, p_inv)

    def extrapolate_cov(self, rv, m_pred, cache, output_scale, reversal):
        """Predicted factor (and, with ``reversal``, the backward conditional)
        of the preconditioned transition; one QR either way."""
        a, l_q = self._system(rv.mean)
        p, p_inv = cache
        scale = torch.as_tensor(output_scale, dtype=rv.mean.dtype, device=rv.mean.device)
        l_bar = p_inv[..., :, None] * rv.cholesky
        a_l = self._apply_a(a, l_bar, matrix=True)
        l_q_scaled = self._kron_eye(scale[..., None, None] * l_q)
        if not reversal:
            l_pred_bar = linalg.chol_from_stack(a_l.transpose(-1, -2),
                                                l_q_scaled.transpose(-1, -2))
            return Normal(m_pred, p[..., :, None] * l_pred_bar), None
        l_pred_bar, gain_bar, l_bwd_bar = linalg.revert_markov(a_l, l_q_scaled, l_bar)
        l_pred = p[..., :, None] * l_pred_bar
        gain = (p[..., :, None] * gain_bar) * p_inv[..., None, :]
        noise_mean = rv.mean - _mv(gain, m_pred)
        bwd = Conditional(gain, Normal(noise_mean, p[..., :, None] * l_bwd_bar))
        return Normal(m_pred, l_pred), bwd

    def extrapolate_direct(self, rv, dt, output_scale, reversal):
        """Extrapolation in unpreconditioned coordinates (interpolation path):
        ``Phi(dt)`` and ``chol(Q(dt)) = P Lq``, both kron I_d."""
        phi = prior.phi_direct(dt, self.num_derivatives)
        p_scal, _ = prior.preconditioner(dt, self.num_derivatives)
        _, l_q = self._system(rv.mean)
        scale = torch.as_tensor(output_scale, dtype=rv.mean.dtype, device=rv.mean.device)
        q_chol = self._kron_eye(scale[..., None, None] * (p_scal[..., :, None] * l_q))
        m_pred = self._apply_a(phi, rv.mean, matrix=False)
        a_l = self._apply_a(phi, rv.cholesky, matrix=True)
        if not reversal:
            l_pred = linalg.chol_from_stack(a_l.transpose(-1, -2), q_chol.transpose(-1, -2))
            return Normal(m_pred, l_pred), None
        l_pred, gain, l_bwd = linalg.revert_markov(a_l, q_chol, rv.cholesky)
        noise_mean = rv.mean - _mv(gain, m_pred)
        return Normal(m_pred, l_pred), Conditional(gain, Normal(noise_mean, l_bwd))

    def h_q_unit(self, cache, o, jacobians):
        """(..., d, nd) factor ``H Q_unit^{1/2}`` of the local residual model;
        ``jacobians``: (..., d, d) Jacobians of the vector field in each of
        the first ``o`` derivatives (none for TS0).  Block j of the row is
        ``p_o Lq[o, j] I - sum_k p_k Lq[k, j] J_k``."""
        p, _ = cache
        _, l_q = self._system(p)
        p_scal = p[..., :: self.d]  # p for each derivative index, (..., n)
        eye = torch.eye(self.d, dtype=p.dtype, device=p.device)
        blocks = p_scal[..., o, None, None, None] * l_q[o, :, None, None] * eye
        for k, jac in enumerate(jacobians):
            blocks = blocks - (p_scal[..., k, None, None, None] * l_q[k, :, None, None]
                               * jac[..., None, :, :])
        # blocks (..., n, d, d), blocks[j] = column block j
        return blocks.transpose(-3, -2).reshape(blocks.shape[:-3] + (self.d, self.ndim))

    def error_and_scale(self, z, h_q, cache, unit="qoi"):
        """``sigma = sqrt(z^T S^{-1} z / d)`` with ``S = (H Q^{1/2})(H Q^{1/2})^T``,
        and the step-control error: the calibrated process-noise std of the
        u-components (``unit="qoi"``, ``sigma p_0 ||Lq[0, :]||`` for every
        component) or ``sigma sqrt(diag S)`` (``unit="residual"``)."""
        p, _ = cache
        _, l_q = self._system(p)
        r_s = linalg.qr_r(h_q.transpose(-1, -2))  # (..., d, d) upper, R^T R = S
        white = linalg.tri_solve_lower(r_s.transpose(-1, -2), z[..., None])
        sigma = rounded.sqrt(_div(torch.sum(white**2, dim=(-2, -1)), self.d))
        if unit == "residual":
            return sigma, sigma[..., None] * rounded.sqrt(torch.sum(r_s**2, dim=-2))
        err_u = sigma * p[..., 0] * rounded.sqrt(torch.sum(l_q[0, :] ** 2))
        return sigma, err_u[..., None].expand(err_u.shape + (self.d,))

    def correct_affine(self, rv, z, h_l):
        """Noise-free affine correction given ``h_l = H @ L`` and residual z."""
        l_obs, gain, l_cor = linalg.revert_observation(rv.cholesky, h_l)
        return Normal(rv.mean - _mv(gain, z), l_cor), Normal(z, l_obs)

    def h_l_rows(self, chol, o, jacobians):
        """H @ L for H = E_o - sum_k J_k E_k (the TS0 / TS1 observation)."""
        d = self.d
        h_l = chol[..., o * d : (o + 1) * d, :]
        for k, jac in enumerate(jacobians):
            h_l = h_l - rounded.matmul(jac, chol[..., k * d : (k + 1) * d, :])
        return h_l

    def identity_conditional(self, dtype, device=None):
        eye = torch.eye(self.ndim, dtype=dtype, device=device)
        noise = Normal(
            torch.zeros((self.ndim,), dtype=dtype, device=device),
            torch.zeros((self.ndim, self.ndim), dtype=dtype, device=device),
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
        """Observe ``data = qoi(x) + N(0, obs_std^2 I_d)`` by one QR
        (``linalg.revert_observation``); returns the Gaussian log-likelihood
        of ``data`` and the conditioned state.  ``obs_std`` is a scalar or of
        the batch shape."""
        l = rv.cholesky
        h_l = l[..., : self.d, :]
        std = torch.as_tensor(obs_std, dtype=l.dtype, device=l.device)
        l_noise = std[..., None, None] * torch.eye(self.d, dtype=l.dtype, device=l.device)
        l_obs, gain, l_cor = linalg.revert_observation(l, h_l, l_noise)
        resid = rv.mean[..., : self.d] - data
        mean = rv.mean - _mv(gain, resid)
        white = linalg.tri_solve_lower(l_obs, resid[..., None])[..., 0]
        loglik = (
            -0.5 * torch.sum(white**2, dim=-1)
            - linalg.tri_logdet(l_obs)
            - 0.5 * self.d * math.log(2.0 * math.pi)
        )
        return loglik, Normal(mean, l_cor)

    def base_shape(self):
        return (self.ndim,)

    def transform_base(self, rv, xi):
        return rv.mean + _mv(rv.cholesky, xi)

    def conditional_sample(self, cond, x, xi):
        return _mv(cond.matrix, x) + cond.noise.mean + _mv(cond.noise.cholesky, xi)

    def rescale_cholesky(self, tree_chol, factor):
        """Factors times the output-scale ``factor`` (of the batch shape)."""
        return tree_chol * factor[..., None, None]
