"""SSM backends in square-root form (PyTorch counterpart of
``odecheckpts_tpu.ssm``).  The isotropic, the dense and the blockdiag backend
are ported."""

from .base import Conditional, MarkovSeq, Normal  # noqa: F401
from .blockdiag import BlockDiagSSM  # noqa: F401
from .dense import DenseSSM  # noqa: F401
from .isotropic import IsotropicSSM  # noqa: F401

_BACKENDS = {
    "isotropic": IsotropicSSM,
    "dense": DenseSSM,
    "blockdiag": BlockDiagSSM,
    # the d = 1 case of the per-dimension backend, as in the reference
    "scalar": BlockDiagSSM,
}


def choose(implementation: str, *, ode_shape: tuple, num_derivatives: int):
    """Return the backend value for ``implementation``."""
    if implementation in _BACKENDS:
        return _BACKENDS[implementation](
            num_derivatives=num_derivatives, ode_shape=tuple(ode_shape)
        )
    raise ValueError(
        f"unknown implementation {implementation!r}; available: {sorted(_BACKENDS)}"
    )
