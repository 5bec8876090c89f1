"""PyTorch/CUDA port of ``odecheckpts_tpu``: adaptive probabilistic ODE
solvers with fixed memory requirements, for one NVIDIA H100.

The JAX package ``odecheckpts_tpu`` stays the reference; module names here
mirror it.  Ported so far: the whole work-precision surface of the batched
solvers, rtol 1e-1..1e-9: the f32 engine (``batched.solve_save_at_batched``,
kernels K1 and K3) with the generic stack it runs between kernel launches,
the df32 engine (``batched_hi.make_hi_solver``, kernels K2 and K4), the
step-count bucketing and the precision-routed driver
(``batched_hi.make_routed_solver``); the dense TS1 / TS0 engine
(``batched_dense``, kernel K5), the blockdiag engine (``batched_blockdiag``,
kernel K6) and the save-every-step engine (``batched_everystep``, kernel K7);
the fixed-grid solve of one IVP, sequential or parallel in time
(``ivpsolve.solve_fixed_grid``, ``parallel_time``, ``pit_fused``, kernel K8)
and the standalone kernels K9 (``batched_qr``) and K10 / K11 (``qr_packing``);
the training path, on no kernel: gradients through the adaptive solve under
the bounded loop (``control_flow``), the marginal likelihood and sampling
(``stats``), the Runge-Kutta baselines (``rk``), the solve factories
(``facade``), ``train`` and ``checkpointing``.
The kernels are hand-written CUDA (``csrc/``, wrappers in ``kernels``).  This
package never imports JAX.
"""

from . import (  # noqa: F401
    batched,
    batched_blockdiag,
    batched_dense,
    batched_everystep,
    batched_hi,
    batched_qr,
    checkpointing,
    control_flow,
    df32,
    facade,
    harness,
    interop,
    ivpsolve,
    ivpsolvers,
    kernels,
    linalg,
    parallel_time,
    pit_fused,
    prior,
    problems,
    qr_packing,
    rk,
    ssm,
    stats,
    taylor,
    train,
)
