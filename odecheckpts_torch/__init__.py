"""PyTorch/CUDA port of ``odecheckpts_tpu``: adaptive probabilistic ODE
solvers with fixed memory requirements, for one NVIDIA H100.

The JAX package ``odecheckpts_tpu`` stays the reference; module names here
mirror it.  Ported so far: the f32 work-precision path of the batched solver
(``batched.solve_save_at_batched``) with its hand-written CUDA kernel
(``kernels.step_ll_interval``, source ``csrc/step_ll.cu``) and the generic
stack it runs between kernel launches.  This package never imports JAX.
"""

from . import (  # noqa: F401
    batched,
    harness,
    interop,
    ivpsolve,
    ivpsolvers,
    kernels,
    linalg,
    prior,
    problems,
    ssm,
    stats,
    taylor,
)
