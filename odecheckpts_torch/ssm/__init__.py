"""SSM backends in square-root form (PyTorch counterpart of
``odecheckpts_tpu.ssm``).  Only the isotropic backend is ported so far."""

from .base import Conditional, MarkovSeq, Normal  # noqa: F401
from .isotropic import IsotropicSSM  # noqa: F401

_NOT_PORTED = {
    "dense": "ROADMAP queue 1 item 6 (TS1 and the dense backend)",
    "blockdiag": "ROADMAP queue 1 item 7 (blockdiag)",
    "scalar": "ROADMAP queue 1 item 7 (blockdiag)",
}


def choose(implementation: str, *, ode_shape: tuple, num_derivatives: int):
    """Return the backend value for ``implementation``."""
    if implementation == "isotropic":
        return IsotropicSSM(num_derivatives=num_derivatives, ode_shape=tuple(ode_shape))
    if implementation in _NOT_PORTED:
        raise NotImplementedError(
            f"implementation={implementation!r} is not ported yet: "
            f"{_NOT_PORTED[implementation]}"
        )
    raise ValueError(
        f"unknown implementation {implementation!r}; "
        f"available: {sorted(['isotropic', *_NOT_PORTED])}"
    )
