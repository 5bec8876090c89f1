"""The JAX reference's f32 solves without the compiler's rewrites of their
arithmetic (a helper of the port's tests, not a test module: pytest
collects no test from it).

Jitted on the CPU, XLA rewrites the reference's f32 arithmetic: its
algebraic simplifier turns a division by a constant into a multiplication by
the rounded reciprocal, and LLVM contracts multiply-adds into FMA on hosts
that have it.  Op by op (``jax.disable_jit``) neither happens: every
operation rounds on its own, as in the port's twin and in its kernels (built
with ``-fmad=false``).  That difference is not noise everywhere: the f32
fixedpoint smoother at rtol 1e-6 meets checkpoints just above
``_interpolate_at``'s snap threshold, where the emitted conditional's
entries cancel, and there the rewritten arithmetic lands nearer the exact
result than the plain one, in the port as in the reference run op by op
(``test_torch_smoothing.py::test_f32_smoothing_tail_is_the_uncontracted_references``).

Op by op, a whole solve takes minutes.  ``FLAGS`` give the op-by-op
arithmetic at jit speed: no algebraic simplifier, and code for AVX, which
has no FMA instruction to contract into.  They take effect only before
JAX's backend starts, so ``solve`` runs the reference in a subprocess, and
there it first checks the premise: one jitted attempt of the reference's
step equals the same attempt op by op, every array bit for bit.

Run as a script, it counts the f32 smoothing tail on a perturbed ensemble
at rtol 1e-6 (the port's twin, and the reference jitted under whatever
``XLA_FLAGS`` the caller sets, or op by op with ``--op-by-op``), each
against the reference's f64 solve of the widened inputs:

    XLA_FLAGS="--xla_cpu_max_isa=AVX" python tests/torch_uncontracted.py \
        --lanes 4096 --seed 2 --checkpoints 9
"""

import argparse
import concurrent.futures
import functools
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

FLAGS = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"
ROOT = Path(__file__).resolve().parents[1]
# the tail ensemble: perturbed rigid bodies at rtol 1e-6 in f32, checkpoints
# every 0.625 on (0, 10): a checkpoint that falls just above the snap
# threshold eps^0.75 max(|t|, 1) after a lane's last step is the event, and
# more, later checkpoints meet it more often
TAIL_LANES, TAIL_RTOL, TAIL_SEED, TAIL_SAVE_AT = 1024, 1e-6, 4, 17

_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from odecheckpts_tpu import batched as jb, problems as jp

data = np.load(sys.argv[1])
vf, _, _, params = jp.rigid_body()


def vfb(args, t):
    return vf(*args, t=t[0], p=params)


step = jb.make_step_ll(vfb, nu=4, d=3, error_calibration=10.0)
state = tuple(jnp.asarray(data[f"state{i}"]) for i in range(17))
extra = tuple(jnp.asarray(data[f"extra{i}"]) for i in range(6))
jitted = jax.jit(step)(state, *extra)
with jax.disable_jit():
    op_by_op = step(state, *extra)
out = {"premise": np.array([np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
                            for a, b in zip(jitted, op_by_op)])}
for k in range(int(data["runs"])):
    u_s, u_f, n = jb.solve_save_at_batched(
        vf, jnp.asarray(data[f"u0s{k}"]), params, save_at=jnp.asarray(data[f"save_at{k}"]),
        dt0=0.1, tols=jnp.asarray(data[f"tols{k}"]), engine="xla")
    out[f"u_s{k}"], out[f"u_f{k}"], out[f"n{k}"] = (np.asarray(x) for x in (u_s, u_f, n))
np.savez(sys.argv[2], **out)
"""


def solve(runs, state, extra):
    """The reference's f32 solves (``engine="xla"``, rigid body, dt0 0.1)
    under ``FLAGS``: ``runs`` is a list of ``(u0s, tols, save_at)`` numpy
    arrays; ``state`` and ``extra`` are a lanes-last f32 state (17 arrays at
    nu = 4) and its 6 kernel inputs, from which one attempt checks the
    premise.  Returns ``(premise, [(u_s, u_f, nsteps), ...])``: ``premise``
    holds, per state array, whether the jitted attempt equals the op-by-op
    attempt bit for bit."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} {FLAGS}".strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.npz", Path(tmp) / "out.npz"
        arrays = {"runs": np.array(len(runs))}
        for k, (u0s, tols, save_at) in enumerate(runs):
            arrays.update({f"u0s{k}": u0s, f"tols{k}": tols, f"save_at{k}": save_at})
        arrays.update({f"state{i}": np.asarray(x) for i, x in enumerate(state)})
        arrays.update({f"extra{i}": np.asarray(x) for i, x in enumerate(extra)})
        np.savez(src, **arrays)
        proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(src), str(dst)], env=env,
                              cwd=ROOT, capture_output=True, text=True, timeout=900, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"the reference's solve under {FLAGS} failed:\n{proc.stderr[-4000:]}")
        out = np.load(dst)
        return out["premise"], [tuple(out[f"{x}{k}"] for x in ("u_s", "u_f", "n"))
                                for k in range(len(runs))]


def ensemble(lanes, seed, tols):
    """f32 rigid-body initial values u0 (1 + 0.05 N(0, 1)) from numpy
    ``seed`` and the tolerances ``tols`` repeated over the lanes."""
    rng = np.random.default_rng(seed)
    u0s = np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((lanes, 3)))
    return u0s.astype(np.float32), np.tile(np.asarray(tols), lanes // len(tols)).astype(np.float32)


def _premise_state():
    """A mid-interval lanes-last f32 state (nu = 4, 16 lanes: the port's
    Taylor init and 20 attempts of its twin) and its 6 kernel inputs."""
    import torch

    from odecheckpts_torch import batched as tb, interop, kernels, problems as tp

    u0s, tols = ensemble(16, 5, (1e-2, 1e-4, 1e-6, 1e-3))
    save_at = np.linspace(0.0, 10.0, 5).astype(np.float32)
    vf, _, _, params = tp.rigid_body()
    state, _, inputs = tb.initial_state(vf, torch.tensor(u0s), params, save_at=save_at, dt0=0.1,
                                        tols=torch.tensor(tols), num_derivatives=4)
    step = tb.make_step_ll(vf, params, nu=4, d=3, error_calibration=10.0)
    t_next = torch.full((1, 16), float(save_at[1]))
    for _ in range(20):
        state = kernels.attempt_plain(step, state, t_next, **inputs)
    extra = (t_next,) + tuple(inputs[k] for k in ("atol", "rtol", "dt_max", "dt_floor",
                                                   "tiny_scale"))
    return interop.state_to_numpy(state), tuple(x.numpy() for x in extra)


@functools.lru_cache(maxsize=None)
def tail_distances():
    """The tail ensemble's smoothed values against the reference's f64 solve
    of the widened inputs, per lane (``torch_f64_judge.lane_distances``):
    the port's twin (``"port"``), the reference under ``FLAGS``
    (``"uncontracted"``) and jitted as it is (``"contracted"``); and whether
    the premise held."""
    import torch_f64_judge as judge

    u0s, tols = ensemble(TAIL_LANES, TAIL_SEED, (TAIL_RTOL,))
    save_at = np.linspace(0.0, 10.0, TAIL_SAVE_AT).astype(np.float32)
    # the subprocess runs while this process solves the same lanes
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(solve, [(u0s, tols, save_at)], *_premise_state())
        values, truth = _tail_here(u0s, tols, save_at)
        premise, [(plain, _, _)] = pending.result()
    values["uncontracted"] = plain
    return premise, {k: judge.lane_distances(v, truth, lane_axis=0) for k, v in values.items()}


def _tail_here(u0s, tols, save_at, op_by_op=False):
    """The port's twin and the reference jitted as it is (``op_by_op``:
    under ``jax.disable_jit``), in f32, and the reference's f64 solve of the
    widened inputs, on the tail ensemble."""
    import jax
    import jax.numpy as jnp
    import torch

    from odecheckpts_torch import batched as tb, interop, problems as tp
    from odecheckpts_tpu import batched as jb, problems as jp

    jvf, _, _, jparams = jp.rigid_body()
    assert jax.config.jax_enable_x64

    def reference(dtype):
        return np.asarray(jb.solve_save_at_batched(
            jvf, jnp.asarray(u0s.astype(dtype)), jparams,
            save_at=jnp.asarray(save_at.astype(dtype)), dt0=0.1,
            tols=jnp.asarray(tols.astype(dtype)), engine="xla")[0])

    truth = reference(np.float64)
    with jax.disable_jit(op_by_op):
        ref32 = reference(np.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as fast here, and no cores spent spinning
    try:
        port = tb.solve_save_at_batched(
            tp.rigid_body()[0], torch.tensor(u0s), interop.to_torch(tuple(jp.rigid_body()[3])),
            save_at=save_at, dt0=0.1, tols=torch.tensor(tols), engine="cuda-loop")[0].numpy()
    finally:
        torch.set_num_threads(threads)
    return {"port": port, "contracted": ref32}, truth


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lanes", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoints", type=int, default=5)
    parser.add_argument("--op-by-op", action="store_true",
                        help="the reference's f32 solve under jax.disable_jit")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    u0s, tols = ensemble(args.lanes, args.seed, (TAIL_RTOL,))
    save_at = np.linspace(0.0, 10.0, args.checkpoints).astype(np.float32)
    values, truth = _tail_here(u0s, tols, save_at, args.op_by_op)
    limits = (1e-5, 1e-4, 2e-4, 3e-4, 5e-4, 1e-3)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} op_by_op={args.op_by_op} "
          f"lanes={args.lanes} seed={args.seed} checkpoints={args.checkpoints}")
    for name, key in (("reference f32", "contracted"), ("port twin f32", "port")):
        err = np.max(np.abs(values[key].astype(np.float64) - truth), axis=(1, 2))
        counts = ", ".join(f"> {x:g}: {int(np.sum(err > x))}" for x in limits)
        print(f"{name}: smoothed misses {counts}; worst {float(np.max(err)):.6g}")


if __name__ == "__main__":
    main()
