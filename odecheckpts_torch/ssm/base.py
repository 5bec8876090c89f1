"""Gaussian containers in square-root form (PyTorch counterpart of
``odecheckpts_tpu.ssm.base``).

``NamedTuple``s of tensors take the place of the JAX pytrees; every field
may carry leading batch (and time) dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch


class Normal(NamedTuple):
    """Gaussian in square-root form: ``cov = cholesky @ cholesky.T``."""

    mean: torch.Tensor
    cholesky: torch.Tensor


class Conditional(NamedTuple):
    """Affine Gaussian conditional ``x | y ~ N(matrix @ y + noise.mean, noise.cov)``."""

    matrix: torch.Tensor
    noise: Normal


class MarkovSeq(NamedTuple):
    """Backward Markov representation of the posterior.

    ``init`` is the Gaussian at the last time point (or a stack of
    per-checkpoint Gaussians before ``stats.markov_select_terminal``);
    ``conditional`` holds the backward transitions stacked over time on the
    leading axis.  ``ssm`` is the backend that interprets them.
    """

    init: Normal
    conditional: Optional[Conditional]
    ssm: Any = None


@dataclasses.dataclass
class Solution:
    """Result of an IVP solve on a grid: times ``t`` (T,), the solution ``u``
    (T, d) and its marginal standard deviation ``u_std``, the output scale
    used at every step, the posterior as a ``MarkovSeq`` stacked over the
    grid (entry 0 of the conditionals is the identity at t0), and the step
    counts."""

    t: torch.Tensor
    u: torch.Tensor
    u_std: torch.Tensor
    output_scale: torch.Tensor
    marginals: Optional[Normal]
    posterior: MarkovSeq
    num_steps: torch.Tensor
    ssm: Any = None
