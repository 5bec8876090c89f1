"""Accepted steps of the JAX reference on experiment 4's batched Brusselator
(a helper of the port's records, not a test module: pytest collects no
test from it).

The reference's df32 solver (``odecheckpts_tpu.batched_hi.make_hi_solver``,
``engine="xla"``, jitted on the CPU) on ``problems.brusselator(N,
laplacian="slices")``: save_at ``linspace(0, 10, 5)``, dt0 1e-5, TS0(4),
fixedpoint, on the first ``--lanes`` rows of the port's ensemble
(``experiments/4_brusselator/batched_torch.py``: u0 (1 + 0.01 N(0, 1))
from ``numpy.random.default_rng(0)``, rounded to float32 once).  Prints one
JSON line: each lane's accepted steps at every checkpoint after the first,
and the seconds of the jitted solve (compile included).

    python tests/torch_reference_steps.py --N 32 --tol 1e-7 --lanes 2
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--lanes", type=int, default=2)
    args = ap.parse_args()

    import sys

    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from odecheckpts_tpu import batched_hi, problems

    d = 2 * args.N
    rng = np.random.default_rng(0)
    vf, (y0,), _, _ = problems.brusselator(args.N, laplacian="slices")
    y0s = (np.asarray(y0, np.float64)[None]
           * (1.0 + 0.01 * rng.standard_normal((args.lanes, d)))).astype(np.float32)
    tols = np.full((args.lanes,), args.tol, np.float32)
    t0 = time.perf_counter()
    solve = batched_hi.make_hi_solver(vf, (), save_at=np.linspace(0.0, 10.0, 5), dt0=1e-5,
                                      engine="xla")
    _, _, n = solve(jnp.asarray(y0s), tols)
    n = np.asarray(n)
    print(json.dumps({"N": args.N, "tol": args.tol, "lanes": args.lanes, "engine": "xla",
                      "platform": "cpu", "steps_at_checkpoints": n.T.tolist(),
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
