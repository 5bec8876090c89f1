"""Block-diagonal square-root state-space backend (PyTorch counterpart of
``odecheckpts_tpu/ssm/blockdiag.py``).

One independent (n, n) covariance factor and one output scale per ODE
dimension: the factorization for systems whose components live at very
different magnitudes.  TS0 corrections only.  Layout: mean (..., d, n),
factor (..., d, n, n), output scale (..., d); ``dt`` carries the batch shape
alone.  Every method broadcasts over leading batch dimensions.

Ported: what the batched blockdiag driver and the generic stack between
kernel launches call (state construction, the unpreconditioned
extrapolation of the interpolation, the conditionals of the smoothing
pass).  The generic single-solve surface (``extrapolate_mean`` / ``_cov``,
``error_and_scale_deriv``, ``correct_deriv``, ``condition_qoi``, sampling)
is ROADMAP queue 1 item 3.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import linalg, prior
from .base import Conditional, Normal


def _mv(matrix, vec):
    """(..., d, n, n) @ (..., d, n) -> (..., d, n)."""
    return (matrix @ vec[..., None])[..., 0]


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

    def _system(self, like):
        return prior.system_matrices(
            self.num_derivatives, dtype=like.dtype, device=like.device
        )

    def extrapolate_direct(self, rv, dt, output_scale, reversal):
        """Extrapolation in unpreconditioned coordinates (interpolation
        path), per dimension: ``Phi(dt)`` and ``chol(Q(dt)) = P Lq`` times
        that dimension's output scale."""
        phi = prior.phi_direct(dt, self.num_derivatives)[..., None, :, :]
        p, _ = prior.preconditioner(dt, self.num_derivatives)
        _, l_q = self._system(rv.mean)
        q_chol = output_scale[..., :, None, None] * (p[..., :, None] * l_q)[..., None, :, :]
        m_pred = _mv(phi, rv.mean)
        a_l = phi @ rv.cholesky
        if not reversal:
            l_pred = linalg.chol_from_stack(a_l.transpose(-1, -2), q_chol.transpose(-1, -2))
            return Normal(m_pred, l_pred), None
        l_pred, gain, l_bwd = linalg.revert_markov(a_l, q_chol, rv.cholesky)
        noise_mean = rv.mean - _mv(gain, m_pred)
        return Normal(m_pred, l_pred), Conditional(gain, Normal(noise_mean, l_bwd))

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
            (cond.matrix @ rv.cholesky).transpose(-1, -2),
            cond.noise.cholesky.transpose(-1, -2),
        )
        return Normal(mean, chol)

    def compose(self, outer, inner):
        """Conditional composition: outer(inner(x)), both backward-in-time."""
        matrix = outer.matrix @ inner.matrix
        mean = _mv(outer.matrix, inner.noise.mean) + outer.noise.mean
        chol = linalg.chol_from_stack(
            (outer.matrix @ inner.noise.cholesky).transpose(-1, -2),
            outer.noise.cholesky.transpose(-1, -2),
        )
        return Conditional(matrix, Normal(mean, chol))
