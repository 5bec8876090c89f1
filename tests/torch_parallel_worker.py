"""One rank of the multi-process CPU tests of ``odecheckpts_torch.parallel``
and of ``time_shard`` (``tests/test_torch_parallel.py``,
``tests/test_torch_time_shard.py``).  Imports no JAX: the tests import its
input builders, and the ranks run it as a script.

    python tests/torch_parallel_worker.py SUITE RANK WORLD STORE_FILE OUT_DIR

joins a gloo world of WORLD ranks through the file store STORE_FILE (no
port to race for), runs every check of SUITE ("batch" or "time" on the
CPU; "cuda": K1, K2 and K8 under sharding, every rank on card 0) and writes
``OUT_DIR/<SUITE>_rank<RANK>.npz``.  ``spawn`` starts the
ranks and ``collect`` waits for them and reads what they wrote.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from odecheckpts_torch import (  # noqa: E402
    batched, batched_hi, control_flow, ivpsolve, ivpsolvers, parallel, problems, taylor,
)
from odecheckpts_torch.ssm.base import Normal  # noqa: E402

RIGID_SAVE_AT = np.linspace(0.0, 10.0, 5)
HI_SAVE_AT = np.linspace(0.0, 5.0, 3)
DP_SAVE_AT = np.linspace(0.0, 1.5, 4)
DP_A_TRUE = 1.3
DP_THETA0 = 0.9
DP_LR = 0.2
DP_MAX_STEPS = 128
# the time-sharded cases: (grid points, solve options); the first is the
# reference's own (tests/test_parallel_in_time.py:636-664), whose windows all
# fall back to the sequential filter on this coarse grid; on the others the
# windows converge, so the distributed scan makes the answer
TIME_CASES = {
    "reference": (33, dict(window=16, iterations=6)),
    "converging": (65, dict(window=32, iterations=4, warmstart="rk")),
    "converging_sqrt_ll": (65, dict(window=32, iterations=4, warmstart="rk", form="sqrt",
                                    combine_engine="ll")),
}


def logistic_batch(batch=8):
    """The batched logistic ensemble of ``tests/test_parallel.py:47-71``."""
    u0s = np.linspace(0.05, 0.6, batch)[:, None]
    tols = np.tile([1e-4, 1e-6], batch // 2)
    return u0s, tols


def rigid_ensemble(batch, seed=0, tols=(1e-4, 1e-6)):
    """u0 (1 + 0.05 N(0, 1)) from numpy ``seed``, float64; tolerances cycled."""
    rng = np.random.default_rng(seed)
    u0s = np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((batch, 3)))
    return u0s, np.resize(np.asarray(tols), batch)


def dp_data(batch):
    """u0 in [0.1, 0.4], the logistic's exact values at rate ``DP_A_TRUE``
    on ``DP_SAVE_AT`` (``tests/test_parallel.py:84-100``): (B, 1), (B, T, 1)."""
    u0s = np.linspace(0.1, 0.4, batch)[:, None]
    c = (1.0 - u0s) / u0s
    ys = 1.0 / (1.0 + c * np.exp(-DP_A_TRUE * DP_SAVE_AT[None, :]))
    return u0s, ys[:, :, None]


def dp_vf(u, *, t, p):
    return p * u * (1.0 - u)


def dp_step(mesh, axis):
    """The dp train step (ts0-2, tol 1e-5) with ``torch.optim.Adam(lr=DP_LR)``."""
    import functools

    return parallel.build_dp_train_step(
        "ts0-2", dp_vf, np.zeros(1), DP_SAVE_AT, dt0=0.1, atol=1e-5, rtol=1e-5,
        optimizer=functools.partial(torch.optim.Adam, lr=DP_LR), mesh=mesh, axis=axis)


def dp_two_steps(mesh, axis, batch):
    """Two dp steps from ``DP_THETA0``: losses, the summed gradient of the
    first and the parameters after each."""
    u0s, ys = (torch.tensor(x) for x in dp_data(batch))
    step = dp_step(mesh, axis)
    with control_flow.overwrite_with_bounded(max_steps=DP_MAX_STEPS):
        theta1, opt, loss1 = step(torch.tensor(DP_THETA0, dtype=torch.float64), None, u0s, ys)
        grad1 = opt.param_groups[0]["params"][0].grad.clone()
        theta2, opt, loss2 = step(theta1, opt, u0s, ys)
    return {"dp_loss1": loss1.numpy(), "dp_grad1": grad1.numpy(), "dp_theta1": theta1.numpy(),
            "dp_loss2": loss2.numpy(), "dp_theta2": theta2.numpy()}


def fixed_grid_problem(num):
    """``tests/test_parallel_in_time.py``'s ``_fixed_grid_setup("dynamic",
    num)`` in the port, float64: (vf, init, grid, solver)."""
    vf, u0s, tspan, params = problems.rigid_body()

    def vf_p(u, *, t):
        return vf(u, t=t, p=params)

    prior = ivpsolvers.prior_ibm(num_derivatives=3, ode_shape=(3,))
    solver = ivpsolvers.solver_dynamic(
        ivpsolvers.strategy_filter(prior, ivpsolvers.correction_ts0()))
    tcoeffs = taylor.odejet_padded_scan(lambda u: vf_p(u, t=tspan[0]), u0s, num=3)
    rv, scale = solver.initial_condition(tcoeffs, 1.0)
    init = (Normal(rv.mean.double(), rv.cholesky.double()), scale.double())
    grid = torch.linspace(*tspan, num, dtype=torch.float64)
    return vf_p, init, grid, solver


def time_solve(case, time_shard=None):
    """One ``TIME_CASES`` solve, parallel in time, with its diagnostics."""
    num, options = TIME_CASES[case]
    vf, init, grid, solver = fixed_grid_problem(num)
    return ivpsolve.solve_fixed_grid(vf, init, grid=grid, solver=solver, parallel=True,
                                     time_shard=time_shard, return_diagnostics=True, **options)


def _raises(fn):
    try:
        fn()
    except ValueError as err:
        return str(err)
    return ""


def run_batch(mesh):
    """The sharded ensemble solves and the dp step on this world."""
    out = {}
    lvf, _, _, lparams = problems.logistic()
    solve_batch = parallel.build_batched_solve("ts0-3", lvf, np.zeros(1),
                                               np.linspace(0.0, 2.5, 5), dt0=0.1)
    u0s, tols = logistic_batch(16)
    u, steps = parallel.shard_batched_solve(solve_batch, mesh)(
        (torch.tensor(u0s),), lparams, torch.tensor(tols))
    out.update(batched_u=u.numpy(), batched_steps=steps.numpy())

    vf, _, _, params = problems.rigid_body()
    fused = parallel.shard_fused_solve(vf, params, save_at=RIGID_SAVE_AT, dt0=0.1, mesh=mesh,
                                       engine="torch")
    for name, lanes in (("fused", 8), ("fused_uneven", 2 * mesh.size() + 1)):
        u0s, tols = rigid_ensemble(lanes)
        for key, x in zip(("u", "uf", "n"), fused(torch.tensor(u0s), torch.tensor(tols))):
            out[f"{name}_{key}"] = x.numpy()

    for name, dtype, rtol, lanes in (("hi32", torch.float32, 1e-7, 2 * mesh.size()),
                                     ("hi64", torch.float64, 1e-6, 2 * mesh.size() + 1)):
        solve = batched_hi.make_hi_solver(vf, params, save_at=HI_SAVE_AT, dt0=0.1,
                                          vf_df=problems.rigid_body_df(params), engine="torch",
                                          dtype=dtype, shard_mesh=mesh)
        u0s, _ = rigid_ensemble(lanes)
        (us_hi, us_lo), (uf_hi, uf_lo), n = solve(torch.tensor(u0s, dtype=torch.float32),
                                                  torch.full((lanes,), rtol, dtype=dtype))
        for key, x in zip(("us_hi", "us_lo", "uf_hi", "uf_lo", "n"),
                          (us_hi, us_lo, uf_hi, uf_lo, n)):
            out[f"{name}_{key}"] = x.numpy()

    from torch.distributed.device_mesh import DeviceMesh

    dp_mesh = DeviceMesh(mesh.device_type, mesh.mesh, mesh_dim_names=("dp",))
    out.update(dp_two_steps(dp_mesh, "dp", 2 * mesh.size()))
    out["uneven_shard_error"] = _raises(lambda: parallel.shard_along(
        torch.zeros(2 * mesh.size() + 1), mesh))
    return out


def run_time(mesh):
    """The time-sharded cases and the two refusals on this world."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh_t = DeviceMesh(mesh.device_type, mesh.mesh, mesh_dim_names=("t",))
    out = {}
    for case in TIME_CASES:
        sol, diag = time_solve(case, time_shard=(mesh_t, "t"))
        out.update({f"{case}_u": sol.u.numpy(), f"{case}_u_std": sol.u_std.numpy(),
                    f"{case}_diverged": diag["window_diverged"].numpy()})
    vf, init, grid, solver = fixed_grid_problem(33)
    out["window_error"] = _raises(lambda: ivpsolve.solve_fixed_grid(
        vf, init, grid=grid, solver=solver, parallel=True, window=2 * mesh.size() + 1,
        time_shard=(mesh_t, "t")))
    out["sequential_error"] = _raises(lambda: ivpsolve.solve_fixed_grid(
        vf, init, grid=grid, solver=solver, time_shard=(mesh_t, "t")))
    out["counts"] = np.array([parallel.COUNTS["gathers"], parallel.COUNTS["all_reduces"]])
    return out


CUDA_DEVICE = "cuda:0"  # every rank of the "cuda" suite shares this card
CUDA_LANES = 4_096
CUDA_PIT_POINTS = 513
CUDA_PIT = dict(window=256, form="sqrt", iterations=2, warmstart="rk:16", fallback_rtol=None)


def cuda_fused(mesh=None):
    """K1 (``engine="cuda-loop"``) on rigid-body lanes at rtol 1e-3 / 1e-4,
    sharded over ``mesh`` (None: the unsharded engine)."""
    vf, _, _, params = problems.rigid_body()
    kw = dict(save_at=RIGID_SAVE_AT, dt0=0.1, engine="cuda-loop")
    if mesh is None:
        return lambda u, t: batched.solve_save_at_batched(vf, u, params, tols=t, **kw)
    return parallel.shard_fused_solve(vf, params, mesh=mesh, **kw)


def cuda_hi(mesh=None):
    """K2 (``engine="cuda-loop"``) on the hi channel, f32 pairs."""
    vf, _, _, params = problems.rigid_body()
    return batched_hi.make_hi_solver(vf, params, save_at=HI_SAVE_AT, dt0=0.1,
                                     vf_df=problems.rigid_body_df(params), engine="cuda-loop",
                                     shard_mesh=mesh)


def cuda_inputs(device):
    u0s, tols = rigid_ensemble(CUDA_LANES, tols=(1e-3, 1e-4))
    return (torch.tensor(u0s, dtype=torch.float32, device=device),
            torch.tensor(tols, dtype=torch.float32, device=device),
            torch.full((CUDA_LANES,), 1e-7, dtype=torch.float32, device=device))


def cuda_pit(dtype, device, engine, time_shard=None):
    """The fixed-grid solve of ``CUDA_PIT_POINTS`` points in ``dtype`` on the
    card, parallel in time with ``engine``: (u, u_std)."""
    vf, init, grid, solver = fixed_grid_problem(CUDA_PIT_POINTS)
    init = (Normal(init[0].mean.to(device, dtype), init[0].cholesky.to(device, dtype)),
            init[1].to(device, dtype))
    sol = ivpsolve.solve_fixed_grid(vf, init, grid=grid.to(device, dtype), solver=solver,
                                    parallel=True, combine_engine=engine, time_shard=time_shard,
                                    **CUDA_PIT)
    return sol.u, sol.u_std


def run_cuda(mesh):
    """K1, K2 and K8 under sharding on card 0, with each kernel's launches on
    this rank."""
    from torch.distributed.device_mesh import DeviceMesh

    from odecheckpts_torch import kernels

    device = torch.device(CUDA_DEVICE)
    u0s, tols, tols_hi = cuda_inputs(device)
    out = {}
    for name, kernel, run in (
            ("k1", "step_ll_interval", lambda: cuda_fused(mesh)(u0s, tols)),
            ("k2", "step_hi_interval", lambda: cuda_hi(mesh)(u0s, tols_hi))):
        before = kernels.LAUNCHES[kernel]
        u_s, _uf, n = run()
        u_s = batched_hi.combine64(u_s) if name == "k2" else u_s
        out.update({f"{name}_u": u_s.cpu().numpy(), f"{name}_n": n.cpu().numpy(),
                    f"{name}_launches": kernels.LAUNCHES[kernel] - before})
    mesh_t = DeviceMesh(mesh.device_type, mesh.mesh, mesh_dim_names=("t",))
    for label, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        before = kernels.LAUNCHES["pit_combine"]
        u, u_std = cuda_pit(dtype, device, "cuda", time_shard=(mesh_t, "t"))
        out[f"pit_{label}_launches"] = kernels.LAUNCHES["pit_combine"] - before
        u_ll, u_std_ll = cuda_pit(dtype, device, "ll", time_shard=(mesh_t, "t"))
        out.update({f"pit_{label}_u": u.cpu().numpy(), f"pit_{label}_u_std": u_std.cpu().numpy(),
                    f"pit_{label}_u_ll": u_ll.cpu().numpy(),
                    f"pit_{label}_u_std_ll": u_std_ll.cpu().numpy()})
    return out


def spawn(suite, world, tmp_path):
    """Start the ``world`` ranks of ``suite`` in the background; returns a
    handle for ``collect``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    store = tmp_path / f"{suite}_{world}.store"
    procs = parallel.start_ranks(lambda rank: [sys.executable, __file__, suite, str(rank),
                                               str(world), str(store), str(tmp_path)],
                                 world, env=env)
    return suite, world, tmp_path, procs


def collect(handle, timeout=300):
    """Wait for the ranks of ``spawn``; every rank's arrays, by rank.  Raises
    with a rank's output if it failed."""
    suite, world, tmp_path, procs = handle
    parallel.wait_ranks(procs, timeout)
    return [dict(np.load(tmp_path / f"{suite}_rank{r}.npz")) for r in range(world)]


def main(suite, rank, world, store, out_dir):
    torch.set_num_threads(1)
    # ranks that share card 0 run gloo: NCCL takes one rank a card
    device = {"cuda": CUDA_DEVICE}.get(suite, "cpu")
    mesh = parallel.init_distributed(device=device, backend="gloo", init_method=f"file://{store}",
                                     world_size=int(world), rank=int(rank))
    out = {"batch": run_batch, "time": run_time, "cuda": run_cuda}[suite](mesh)
    np.savez(Path(out_dir) / f"{suite}_rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
