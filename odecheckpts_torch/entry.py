"""Driver entry points: the single-device forward solve and the multi-device
dry run (counterpart of ``__graft_entry__.py``).

``entry()`` returns the flagship forward solve: a fixedpoint
(O(#checkpoints)-memory) PI-adaptive probabilistic solve of an ensemble of
rigid-body IVPs, with its example inputs.

``dryrun_multichip(n)`` starts ``n`` ranks, one process each, and runs on
them: one data-parallel training step (per-rank negative log-marginal
likelihood gradients through the adaptive solve, one ``all_reduce``, an Adam
step), the sharded fused engine (K1), the df32 engine (K2), the dense (K5),
blockdiag (K6) and save-every-step (K7) engines through
``shard_engine_solve``, uneven shards, and the time-sharded parallel-in-time
solve (K8).  On "cuda" the ranks take one card each over NCCL; on "cpu" they
run gloo and the kernels' plain versions.  The dense engine runs nu = 4 (the
reference's dry run takes nu = 2; K5 is instantiated at nu = 4 only), and
the time-sharded solve runs in float64, held to 1e-10 (the reference's dry
run compares float32 solves to 1e-5: the explicit distributed prefix here
combines in another order than GSPMD's, and on 4 ranks its unconverged
float32 sweeps land 8e-6 from the unsharded ones).

Run: ``python -m odecheckpts_torch.entry [--ranks N] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(u0s, tols) -> (u, num_steps)`` solves a
    batch of 8 rigid-body IVPs (ts0-4, 5 checkpoints, float32) on one device;
    the example inputs are on ``device``."""
    from . import parallel, problems

    vf, (u0,), tspan, params = problems.rigid_body()
    save_at = np.linspace(*tspan, num=5, dtype=np.float32)
    solve_batch = parallel.build_batched_solve("ts0-4", vf, np.zeros(3, np.float32), save_at,
                                               dt0=0.1)

    def fn(u0s, tols):
        return solve_batch((u0s,), params, tols)

    batch = 8
    u0 = u0.to(device=device, dtype=torch.float32)
    u0s = u0[None].repeat(batch, 1) * torch.linspace(0.9, 1.1, batch, device=device)[:, None]
    tols = torch.full((batch,), 1e-4, dtype=torch.float32, device=device)
    return fn, (u0s, tols)


def _check(name, ok, detail):
    if not ok:
        raise AssertionError(f"dryrun_multichip: {name} failed: {detail}")


def _dryrun_rank(mesh, device):
    """One rank's part of ``dryrun_multichip`` on ``mesh`` (axis "batch")."""
    import functools

    from torch.distributed.device_mesh import DeviceMesh

    from . import (batched, batched_blockdiag, batched_dense, batched_everystep, batched_hi,
                   control_flow, ivpsolve, ivpsolvers, parallel, problems, taylor)
    from .ssm.base import Normal

    n = mesh.size()
    rank = torch.distributed.get_rank()
    on_card = device.type == "cuda"
    log = print if rank == 0 else (lambda *a, **k: None)

    # one data-parallel training step on the logistic ensemble
    def vf_logistic(u, *, t, p):
        return p * u * (1.0 - u)

    save_at = np.linspace(0.0, 1.0, 3)
    batch = 2 * n
    u0s = torch.linspace(0.1, 0.4, batch, dtype=torch.float64, device=device)[:, None]
    c = (1.0 - u0s) / u0s
    ys = 1.0 / (1.0 + c * torch.exp(-1.3 * torch.as_tensor(save_at, device=device)))[:, :, None]
    dp = DeviceMesh(mesh.device_type, mesh.mesh, mesh_dim_names=("dp",))
    step = parallel.build_dp_train_step(
        "ts0-2", vf_logistic, np.zeros(1), save_at, dt0=0.1, atol=1e-4, rtol=1e-4,
        optimizer=functools.partial(torch.optim.Adam, lr=0.1), mesh=dp, axis="dp")
    with control_flow.overwrite_with_bounded(max_steps=64):
        theta, _opt, loss = step(torch.tensor(0.9, dtype=torch.float64, device=device), None,
                                 u0s, ys)
    _check("dp train step", bool(torch.isfinite(loss)), float(loss))
    log(f"dryrun_multichip({n}): dp train step ok, loss={float(loss):.3f}", flush=True)

    # the fused engines on the rigid-body ensemble, sharded along "dp"
    vf, (u0,), tspan, params = problems.rigid_body()
    save_at = np.linspace(*tspan, num=3).astype(np.float32)
    b = 2 * n
    u0s = u0.to(device=device, dtype=torch.float32)[None].repeat(b, 1)
    tols = torch.full((b,), 1e-3, dtype=torch.float32, device=device)
    kw = dict(save_at=save_at, dt0=0.1, mesh=dp, axis="dp")
    fused = parallel.shard_fused_solve(vf, params, engine="cuda-loop", **kw)
    u_k, _uf, n_k = fused(u0s, tols)
    u_t, _uf, n_t = parallel.shard_fused_solve(vf, params, engine="torch", **kw)(u0s, tols)
    _check("sharded fused engine", bool(torch.all(torch.isfinite(u_k))) and torch.equal(u_k, u_t)
           and torch.equal(n_k, n_t), "K1 against its twin")
    log(f"dryrun_multichip({n}): sharded fused engine (K1) ok, u shape {tuple(u_k.shape)}",
        flush=True)

    solve_hi = batched_hi.make_hi_solver(vf, params, save_at=save_at, dt0=0.1,
                                         vf_df=problems.rigid_body_df(params), shard_mesh=dp,
                                         shard_axis="dp")
    (us_hi, _us_lo), _uf, _n = solve_hi(u0s, torch.full((b,), 1e-6, device=device))
    _check("sharded df32 engine", bool(torch.all(torch.isfinite(us_hi))), tuple(us_hi.shape))
    log(f"dryrun_multichip({n}): sharded df32 engine (K2) ok, u shape {tuple(us_hi.shape)}",
        flush=True)

    engines = {
        "dense (K5)": lambda u, t: batched_dense.solve_save_at_batched_dense(
            vf, u, params, save_at=save_at, dt0=0.1, tols=t, num_derivatives=4),
        "blockdiag (K6)": lambda u, t: batched_blockdiag.solve_save_at_batched_blockdiag(
            vf, u, params, save_at=save_at, dt0=0.1, tols=t, num_derivatives=2),
        "every-step (K7)": lambda u, t: batched_everystep.solve_every_step_batched(
            vf, u, params, t0=float(tspan[0]), t1=float(tspan[0]) + 1.0, dt0=0.1, tols=t,
            max_steps=64, num_derivatives=2),
    }
    for name, local in engines.items():
        out = parallel.shard_engine_solve(local, dp, "dp")(u0s, tols)
        u = out.u[:, 0] if name.startswith("every") else out[0]  # slot 0 = t0, always live
        _check(f"sharded {name} engine", bool(torch.all(torch.isfinite(u))), tuple(u.shape))
        log(f"dryrun_multichip({n}): sharded {name} engine ok, u shape {tuple(u.shape)}",
            flush=True)

    # uneven shards: 2n + 3 lanes are padded, solved, sliced back, and equal
    # the unsharded engine lane for lane
    b_odd = 2 * n + 3
    u0s_odd = u0.to(device=device, dtype=torch.float32)[None].repeat(b_odd, 1)
    u0s_odd = u0s_odd * torch.linspace(0.95, 1.05, b_odd, device=device)[:, None]
    tols_odd = torch.full((b_odd,), 1e-3, dtype=torch.float32, device=device)
    u_odd, _uf, _n = fused(u0s_odd, tols_odd)
    u_ref, _uf, _n = batched.solve_save_at_batched(vf, u0s_odd, params, save_at=save_at,
                                                   dt0=0.1, tols=tols_odd)
    _check("uneven shards", u_odd.shape[0] == b_odd and torch.equal(u_odd, u_ref),
           tuple(u_odd.shape))
    log(f"dryrun_multichip({n}): uneven shards (batch {b_odd} on {n} ranks) ok", flush=True)

    # parallel in time with every window sharded along its step axis
    def vf_t(u, *, t):
        return vf(u, t=t, p=params)

    prior = ivpsolvers.prior_ibm(num_derivatives=3, ode_shape=(3,))
    solver = ivpsolvers.solver_dynamic(
        ivpsolvers.strategy_filter(prior, ivpsolvers.correction_ts0()))
    tcoeffs = taylor.odejet_padded_scan(lambda u: vf_t(u, t=tspan[0]), (u0,), num=3)
    rv, scale = solver.initial_condition(tcoeffs, 1.0)
    init = (Normal(rv.mean.to(device, torch.float64), rv.cholesky.to(device, torch.float64)),
            scale.to(device, torch.float64))
    grid = torch.linspace(tspan[0], tspan[1] / 10.0, 2 * n + 1, dtype=torch.float64,
                          device=device)
    mesh_t = DeviceMesh(mesh.device_type, mesh.mesh, mesh_dim_names=("t",))
    pit = dict(grid=grid, solver=solver, parallel=True, iterations=4, window=2 * n, form="sqrt",
               combine_engine="cuda" if on_card else "ll")
    sol_ref = ivpsolve.solve_fixed_grid(vf_t, init, **pit)
    sol_sh = ivpsolve.solve_fixed_grid(vf_t, init, **pit, time_shard=(mesh_t, "t"))
    # the sharded prefix combines in another order: float64 to the reference's
    # bound for time_shard (tests/test_parallel_in_time.py:636-664)
    close = torch.allclose(sol_sh.u, sol_ref.u, rtol=1e-10, atol=1e-12)
    _check("time-sharded parallel in time", close,
           float(torch.max(torch.abs(sol_sh.u - sol_ref.u))))
    log(f"dryrun_multichip({n}): time-sharded parallel-in-time (K8) ok, "
        f"u shape {tuple(sol_sh.u.shape)}", flush=True)


def _rank_main(store, world, rank, device):
    from . import parallel

    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
    mesh = parallel.init_distributed(device=str(device), init_method=f"file://{store}",
                                     world_size=world, rank=rank)
    try:
        _dryrun_rank(mesh, device)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 1200.0) -> None:
    """Start ``n_devices`` ranks (one process each: NCCL over one card each
    on "cuda", gloo on "cpu") and run ``_dryrun_rank`` on them; prints rank
    0's report and raises ``RuntimeError`` if a rank fails."""
    from . import parallel

    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = parallel.start_ranks(
            lambda r: [sys.executable, "-m", __spec__.name, "--rank", str(r), "--ranks",
                       str(n_devices), "--store", store, "--device", device], n_devices)
        print(parallel.wait_ranks(procs, timeout)[0], end="", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.store, args.ranks, args.rank, args.device)
        return
    fn, example = entry(args.device)
    u, num_steps = fn(*example)
    print("entry:", tuple(u.shape), tuple(num_steps.shape), flush=True)
    ranks = args.ranks if args.ranks is not None else (
        torch.cuda.device_count() if args.device == "cuda" else 2)
    dryrun_multichip(ranks, device=args.device)


if __name__ == "__main__":
    main()
