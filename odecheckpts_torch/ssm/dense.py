"""Dense square-root state-space backend (PyTorch counterpart of
``odecheckpts_tpu/ssm/dense.py:27-221``).

Full (n*d, n*d) covariance factor, the backend that TS1 needs for d > 1.
Layout: derivative-major flat state ``x = (u^(0), ..., u^(nu))`` with each
``u^(i)`` a d-block, so ``x[i*d + k] = u^(i)_k``.  The IBM transition is
``kron(A, I_d)``, applied by reshape and einsum.

Ported: what the batched dense driver calls between kernel launches (state
construction, the unpreconditioned extrapolation of the interpolation, the
conditionals of the smoothing pass).  Every method broadcasts over leading
batch dimensions: a mean is (..., nd), a factor (..., nd, nd), and ``dt`` /
``output_scale`` carry the batch shape alone.  The generic single-solve
corrections (``h_q_unit``, ``error_and_scale``, ``correct_affine``,
``h_l_rows``, ``condition_qoi``) are ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import linalg, prior
from .base import Conditional, Normal


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

    def qoi(self, mean):
        return mean[..., : self.d]

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
            xr = x.reshape(lead + (self.n, self.d, m))
            out = torch.einsum("...ij,...jdm->...idm", a, xr)
            return out.reshape(out.shape[:-3] + (self.ndim, m))
        lead = x.shape[:-1]
        xr = x.reshape(lead + (self.n, self.d))
        out = torch.einsum("...ij,...jd->...id", a, xr)
        return out.reshape(out.shape[:-2] + (self.ndim,))

    def _kron_eye(self, m):
        """kron(m, I_d) for (..., n, n) ``m``, formed as jnp.kron forms it."""
        eye = torch.eye(self.d, dtype=m.dtype, device=m.device)
        out = m[..., :, None, :, None] * eye[:, None, :]
        return out.reshape(m.shape[:-2] + (self.ndim, self.ndim))

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
        noise_mean = rv.mean - (gain @ m_pred[..., None])[..., 0]
        return Normal(m_pred, l_pred), Conditional(gain, Normal(noise_mean, l_bwd))

    def identity_conditional(self, dtype, device=None):
        eye = torch.eye(self.ndim, dtype=dtype, device=device)
        noise = Normal(
            torch.zeros((self.ndim,), dtype=dtype, device=device),
            torch.zeros((self.ndim, self.ndim), dtype=dtype, device=device),
        )
        return Conditional(eye, noise)

    def marginalize(self, rv, cond):
        mean = (cond.matrix @ rv.mean[..., None])[..., 0] + cond.noise.mean
        chol = linalg.chol_from_stack(
            (cond.matrix @ rv.cholesky).transpose(-1, -2),
            cond.noise.cholesky.transpose(-1, -2),
        )
        return Normal(mean, chol)

    def compose(self, outer, inner):
        """Conditional composition: outer(inner(x)), both backward-in-time."""
        matrix = outer.matrix @ inner.matrix
        mean = (outer.matrix @ inner.noise.mean[..., None])[..., 0] + outer.noise.mean
        chol = linalg.chol_from_stack(
            (outer.matrix @ inner.noise.cholesky).transpose(-1, -2),
            outer.noise.cholesky.transpose(-1, -2),
        )
        return Conditional(matrix, Normal(mean, chol))
