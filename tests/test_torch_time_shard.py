"""Port tests of ``time_shard`` (the parallel-in-time fixed-grid solve with
every window sharded along its step axis) on 2 and 4 gloo ranks, against
the port's and the reference's unsharded solves, in float64.

The cases are ``tests/torch_parallel_worker.TIME_CASES``: the reference's
own (``tests/test_parallel_in_time.py:636-664``: rigid body, 33 points,
window 16, 6 sweeps; on this coarse grid every window falls back to the
sequential filter, in both packages) and two on which the windows converge
(65 points, window 32, RK warm start, 4 sweeps; covariance form, and the
sqrt form with the lanes-last "ll" prefix), where the distributed scan
makes the answer.  Bounds, the reference's: values to rtol 1e-10, standard
deviations to 1e-8 (the ranks combine the prefix in another order).  Each
world is one spawn (``tests/torch_parallel_worker.py``), started with the
module and run while the references compile.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as worker
from torch.distributed.device_mesh import DeviceMesh

from odecheckpts_tpu import ivpsolve as jivpsolve
from odecheckpts_tpu import ivpsolvers as jsolvers
from odecheckpts_tpu import problems as jproblems
from odecheckpts_tpu import taylor as jtaylor
from odecheckpts_torch import parallel

WORLDS = (2, 4)
# the cases held against the reference too (one JAX compile of ~30 s each);
# the sqrt "ll" case against the port's unsharded solve, whose prefix
# test_torch_parallel_time.py holds against the reference's
REFERENCE_CASES = ("reference", "converging")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's ranks' arrays, by world size, read when first asked for."""
    handles = {n: worker.spawn("time", n, tmp_path_factory.mktemp(f"time{n}")) for n in WORLDS}
    got = {}

    def result(n):
        if n not in got:
            got[n] = worker.collect(handles[n])
        return got[n]

    yield result
    for n in WORLDS:
        result(n)  # never leave the ranks running


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's unsharded solve of ``case``, jitted: (u, u_std)."""
    num, options = worker.TIME_CASES[case]
    vf, u0s, tspan, params = jproblems.rigid_body()

    def vf_p(u, *, t):
        return vf(u, t=t, p=params)

    prior = jsolvers.prior_ibm(num_derivatives=3, ode_shape=(3,))
    solver = jsolvers.solver_dynamic(jsolvers.strategy_filter(prior, jsolvers.correction_ts0()))
    tcoeffs = jtaylor.odejet_padded_scan(lambda u: vf_p(u, t=tspan[0]), u0s, num=3)
    init = solver.initial_condition(tcoeffs, 1.0)
    grid = jnp.linspace(*tspan, num=num)
    sol = jax.jit(lambda: jivpsolve.solve_fixed_grid(vf_p, init, grid=grid, solver=solver,
                                                     parallel=True, **options))()
    return np.asarray(sol.u), np.asarray(sol.u_std)


@functools.lru_cache(maxsize=None)
def _unsharded(case):
    sol, diag = worker.time_solve(case)
    return sol.u.numpy(), sol.u_std.numpy(), diag["window_diverged"].numpy()


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("case", list(worker.TIME_CASES))
@pytest.mark.parametrize("n", WORLDS)
def test_time_shard_matches_the_unsharded_solves(worlds, n, case):
    u, u_std, diverged = _unsharded(case)
    if case in REFERENCE_CASES:
        _close((u, u_std), _reference(case))
    out = worlds(n)
    for key in ("u", "u_std", "diverged"):
        for rank in out[1:]:  # every rank returns the whole solution
            np.testing.assert_array_equal(rank[f"{case}_{key}"], out[0][f"{case}_{key}"])
    got = (out[0][f"{case}_u"], out[0][f"{case}_u_std"])
    np.testing.assert_array_equal(out[0][f"{case}_diverged"], diverged)
    assert bool(diverged.all()) == (case == "reference"), diverged
    _close(got, (u, u_std))
    if case in REFERENCE_CASES:
        _close(got, _reference(case))


@pytest.mark.parametrize("n", WORLDS)
def test_time_shard_refuses_a_window_the_ranks_do_not_divide(worlds, n):
    out = worlds(n)
    assert f"not a multiple of the {n} ranks" in str(out[0]["window_error"])
    gathers, all_reduces = out[0]["counts"]
    assert gathers > 0 and all_reduces > 0


def test_time_shard_rejected_on_sequential_path(worlds):
    """The reference's ``test_time_shard_rejected_on_sequential_path``."""
    assert "time_shard" in str(worlds(2)[0]["sequential_error"])
    with pytest.raises(ValueError, match="time_shard takes a 1-D"):
        worker.time_solve("converging", time_shard=(object(), "t"))


def test_time_shard_on_a_world_of_one_is_the_unsharded_solve():
    mesh = parallel.init_distributed(device="cpu")
    mesh_t = DeviceMesh("cpu", mesh.mesh, mesh_dim_names=("t",))
    for case in worker.TIME_CASES:
        sol, _diag = worker.time_solve(case, time_shard=(mesh_t, "t"))
        u, u_std, _ = _unsharded(case)
        assert torch.equal(sol.u, torch.tensor(u)) and torch.equal(sol.u_std, torch.tensor(u_std))
