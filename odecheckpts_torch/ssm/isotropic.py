"""Isotropic square-root state-space backend (PyTorch counterpart of
``odecheckpts_tpu.ssm.isotropic``).

One shared (n, n) covariance factor across all d ODE dimensions; the mean
is laid out (n, d).  Every method broadcasts over leading batch dimensions:
a mean is (..., n, d), a factor (..., n, n), and ``dt`` / ``output_scale``
carry the batch shape alone.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import linalg, prior
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

    def qoi(self, mean):
        return mean[..., 0, :]

    def qoi_std(self, rv):
        """Marginal standard deviation of the solution, (..., d): the shared
        factor's first row norm for every dimension."""
        s = torch.sqrt(torch.sum(rv.cholesky[..., 0, :] ** 2, dim=-1))
        return s[..., None].expand(rv.mean.shape[:-2] + (self.d,))

    def _system(self, like):
        return prior.system_matrices(
            self.num_derivatives, dtype=like.dtype, device=like.device
        )

    def extrapolate_direct(self, rv, dt, output_scale, reversal):
        """Extrapolation in unpreconditioned coordinates (interpolation path).

        Same semantics as the preconditioned extrapolation, formed from
        ``Phi(dt)`` and ``chol(Q(dt)) = P Lq`` so that no ``P^{-1}`` appears.
        """
        phi = prior.phi_direct(dt, self.num_derivatives)
        p, _ = prior.preconditioner(dt, self.num_derivatives)
        _, l_q = self._system(rv.mean)
        q_chol = output_scale[..., None, None] * (p[..., :, None] * l_q)
        m_pred = phi @ rv.mean
        a_l = phi @ rv.cholesky
        if not reversal:
            l_pred = linalg.chol_from_stack(a_l.transpose(-1, -2), q_chol.transpose(-1, -2))
            return Normal(m_pred, l_pred), None
        l_pred, gain, l_bwd = linalg.revert_markov(a_l, q_chol, rv.cholesky)
        noise_mean = rv.mean - gain @ m_pred
        return Normal(m_pred, l_pred), Conditional(gain, Normal(noise_mean, l_bwd))

    def identity_conditional(self, dtype, device=None):
        eye = torch.eye(self.n, dtype=dtype, device=device)
        noise = Normal(
            torch.zeros((self.n, self.d), dtype=dtype, device=device),
            torch.zeros((self.n, self.n), dtype=dtype, device=device),
        )
        return Conditional(eye, noise)

    def marginalize(self, rv, cond):
        mean = cond.matrix @ rv.mean + cond.noise.mean
        chol = linalg.chol_from_stack(
            (cond.matrix @ rv.cholesky).transpose(-1, -2),
            cond.noise.cholesky.transpose(-1, -2),
        )
        return Normal(mean, chol)

    def compose(self, outer, inner):
        """Conditional composition: outer(inner(x)), both backward-in-time."""
        matrix = outer.matrix @ inner.matrix
        mean = outer.matrix @ inner.noise.mean + outer.noise.mean
        chol = linalg.chol_from_stack(
            (outer.matrix @ inner.noise.cholesky).transpose(-1, -2),
            outer.noise.cholesky.transpose(-1, -2),
        )
        return Conditional(matrix, Normal(mean, chol))
