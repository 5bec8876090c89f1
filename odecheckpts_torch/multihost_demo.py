"""Multi-process distributed demo: ``parallel.init_distributed`` end to end on
the CPU (counterpart of ``experiments/multihost_demo.py``).

Two local processes stand in for two hosts: each joins a gloo world through
``init_distributed(...)``, builds its local rows of the ensemble, one gather
assembles the global batch on every rank, and the sharded fused solve
(``parallel.shard_fused_solve``, the twin of K1 on CPU tensors) runs on it;
every rank checks that its global result is finite.

Run: ``python -m odecheckpts_torch.multihost_demo`` (the parent spawns the
workers and prints ``ALL OK`` when both succeed).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path


def worker(store: str, num_processes: int, process_id: int) -> None:
    import numpy as np
    import torch

    from . import parallel, problems

    torch.set_num_threads(1)
    mesh = parallel.init_distributed(device="cpu", init_method=f"file://{store}",
                                     world_size=num_processes, rank=process_id)
    group = parallel.AxisGroup(mesh, "batch")
    vf, (u0,), _tspan, params = problems.rigid_body()
    save_at = np.linspace(0.0, 10.0, 3)
    solve = parallel.shard_fused_solve(vf, params, save_at=save_at, dt0=0.1, mesh=mesh,
                                       axis="batch", engine="torch")

    # each process contributes its local rows; one gather makes the global
    # batch (the multi-host input idiom)
    rows_local = u0.to(torch.float32).repeat(2, 1) * (1.0 + 0.01 * process_id)
    tols_local = torch.full((2,), 1e-3, dtype=torch.float32)
    u0s, tols = group.gather(rows_local), group.gather(tols_local)

    u_s, _u_f, _n = solve(u0s, tols)
    finite = bool(torch.all(torch.isfinite(u_s)))
    if u_s.shape != (2 * num_processes, len(save_at), 3) or not finite:
        raise SystemExit(f"process {process_id}: bad sharded result {tuple(u_s.shape)}")
    print(f"process {process_id}/{num_processes}: global batch {u0s.shape[0]}, "
          f"sharded fused solve ok", flush=True)
    torch.distributed.destroy_process_group()


def parent(num_processes: int, timeout: float = 600.0) -> None:
    from . import parallel

    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = parallel.start_ranks(
            lambda i: [sys.executable, "-m", __spec__.name, "--worker", "--store", store,
                       "--num-processes", str(num_processes), "--process-id", str(i)],
            num_processes)
        for log in parallel.wait_ranks(procs, timeout):
            print(log, end="", flush=True)
    print(f"ALL OK: {num_processes} processes, gloo on the CPU")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--store", default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.store, args.num_processes, args.process_id)
    else:
        parent(args.num_processes)


if __name__ == "__main__":
    main()
