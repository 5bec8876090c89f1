"""Port tests of ``odecheckpts_torch.parallel``, ``make_hi_solver(shard_mesh=)``,
and the rest of ``harness``, against the JAX reference on the CPU.

The multi-device cases run in ONE spawn of two gloo ranks a module
(``tests/torch_parallel_worker.py``, which imports no JAX; a file store, so
xdist workers never race for a port).  The ranks start when the first test
that needs them starts, and run while that test computes its references.
Tolerances: the sharded solves equal the port's unsharded ones bit for bit
(an IVP lane's arithmetic does not depend on the other lanes); the port's
unsharded f64 solves equal the reference's at ``test_torch_batched.py``'s
tolerances (identical step counts, values to rtol 1e-9; df32 pairs in f64 to
1e-12); the dp step's loss and gradient equal the one-process step on the
whole batch to 1e-12 relative (another summation order) and
``jax.value_and_grad`` of the reference's loss to 1e-10.
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as worker

from odecheckpts_tpu import batched as jbatched
from odecheckpts_tpu import batched_hi as jbatched_hi
from odecheckpts_tpu import control_flow as jcontrol_flow
from odecheckpts_tpu import facade as jfacade
from odecheckpts_tpu import harness as jharness
from odecheckpts_tpu import parallel as jparallel
from odecheckpts_tpu import problems as jproblems
from odecheckpts_tpu import stats as jstats
from odecheckpts_torch import batched, batched_hi, harness, parallel, problems

@pytest.fixture(scope="module")
def world():
    """A world of one in this process (gloo, an in-process store)."""
    return parallel.init_distributed(device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' arrays (rank order), read when first asked for."""
    handle = worker.spawn("batch", 2, tmp_path_factory.mktemp("batch"))
    got = []

    def result():
        if not got:
            got.append(worker.collect(handle))
        return got[0]

    yield result
    result()  # never leave the ranks running


def _same_on_every_rank(out, key):
    for rank in out[1:]:
        np.testing.assert_array_equal(rank[key], out[0][key])
    return out[0][key]


def _logistic_exact(ts, u0, a=1.0):
    c = (1.0 - u0) / u0
    return 1.0 / (1.0 + c * np.exp(-a * np.asarray(ts)))


@functools.lru_cache(maxsize=None)
def _reference_batched_fn():
    """The reference's ``build_batched_solve`` (logistic, ts0-3), jitted once."""
    vf, (u0,), tspan, params = jproblems.logistic()
    save_at = jnp.linspace(*tspan, num=5)
    solve = jparallel.build_batched_solve("ts0-3", vf, u0, save_at, dt0=0.1)
    return jax.jit(lambda a, b: solve(a, params, b))


def _reference_batched(batch, tol):
    u0s, tols = worker.logistic_batch(batch)
    tols = np.full(batch, tol) if tol is not None else tols
    u, steps = _reference_batched_fn()((jnp.asarray(u0s),), jnp.asarray(tols))
    return np.asarray(u), np.asarray(steps)


def _port_batched(batch, tol):
    vf, _, tspan, params = problems.logistic()
    solve = parallel.build_batched_solve("ts0-3", vf, np.zeros(1), np.linspace(*tspan, 5),
                                         dt0=0.1)
    u0s, tols = worker.logistic_batch(batch)
    tols = np.full(batch, tol) if tol is not None else tols
    u, steps = solve((torch.tensor(u0s),), params, torch.tensor(tols))
    return u.numpy(), steps.numpy()


@pytest.mark.parametrize("tol", [1e-5, 1e-7])
def test_build_batched_solve_matches_reference_and_closed_form(tol):
    """At tol 1e-5 the lanes take the reference's steps exactly and agree to
    1e-10.  At 1e-7 the step-size controller amplifies the last bit: the
    reference's vmapped solve and its one-lane solves differ by up to 9
    steps a lane (6%), so the steps are held to the reference's own bound
    for two layouts of one solve (rtol 0.06, ``tests/test_parallel.py:62``),
    the values to the solve's tolerance and to the closed form at 1e-4 (the
    reference's own test, ``tests/test_parallel.py:24``)."""
    u, steps = _port_batched(16, tol)
    u_j, steps_j = _reference_batched(16, tol)
    assert u.shape == (16, 5, 1) and steps.shape == (16,)
    if tol == 1e-5:
        np.testing.assert_array_equal(steps, steps_j)
        np.testing.assert_allclose(u, u_j, rtol=1e-10, atol=0)
    else:
        np.testing.assert_allclose(steps, steps_j, rtol=0.06)
        np.testing.assert_allclose(u, u_j, rtol=tol, atol=0)
    u0s, _ = worker.logistic_batch(16)
    for i in range(16):
        np.testing.assert_allclose(u[i, :, 0], _logistic_exact(np.linspace(0, 2.5, 5),
                                                               u0s[i, 0]), rtol=1e-4)
    assert steps.min() > 0


def test_init_distributed_makes_a_world_of_one(world):
    assert world.mesh_dim_names == ("batch",) and world.size() == 1
    assert world.device_type == "cpu"
    assert torch.distributed.get_backend() == "gloo"
    assert parallel.init_distributed(device="cpu").size() == 1  # the group is reused
    with pytest.raises(ValueError, match="DeviceMesh"):
        parallel.shard_engine_solve(lambda u, t: u, object())
    with pytest.raises(ValueError, match="axis 'dp'"):
        parallel.shard_engine_solve(lambda u, t: u, world, "dp")


def test_two_ranks_shard_batched_solve(ranks):
    u_j, steps_j = _reference_batched(16, None)
    u, steps = _port_batched(16, None)
    out = ranks()
    np.testing.assert_array_equal(_same_on_every_rank(out, "batched_u"), u)
    np.testing.assert_array_equal(_same_on_every_rank(out, "batched_steps"), steps)
    np.testing.assert_array_equal(steps, steps_j)
    np.testing.assert_allclose(u, u_j, rtol=1e-9, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _reference_fused(lanes):
    vf, _, _, params = jproblems.rigid_body()
    u0s, tols = worker.rigid_ensemble(lanes)
    out = jax.jit(lambda u, t: jbatched.solve_save_at_batched(
        vf, u, params, save_at=jnp.asarray(worker.RIGID_SAVE_AT), dt0=0.1, tols=t,
        engine="xla"))(jnp.asarray(u0s), jnp.asarray(tols))
    return tuple(np.asarray(x) for x in out)


def _port_fused(lanes):
    vf, _, _, params = problems.rigid_body()
    u0s, tols = worker.rigid_ensemble(lanes)
    out = batched.solve_save_at_batched(vf, torch.tensor(u0s), params,
                                        save_at=worker.RIGID_SAVE_AT, dt0=0.1,
                                        tols=torch.tensor(tols), engine="torch")
    return tuple(x.numpy() for x in out)


def test_two_ranks_shard_fused_solve(ranks):
    want_j = _reference_fused(8)
    want = _port_fused(8)
    out = ranks()
    for key, w, wj in zip(("u", "uf", "n"), want, want_j):
        np.testing.assert_array_equal(_same_on_every_rank(out, f"fused_{key}"), w)
        if key == "n":
            np.testing.assert_array_equal(w, wj)
        else:
            np.testing.assert_allclose(w, wj, rtol=1e-9, atol=1e-12)


def test_uneven_batch_is_padded_and_sliced_back(ranks):
    """2 world + 1 lanes: padded with the loosest lane, solved, sliced back;
    equal to the unsharded solve and lane for lane to the 8-lane batch's."""
    lanes = 5
    want = _port_fused(lanes)
    out = ranks()
    whole = _same_on_every_rank(out, "fused_u")
    for key, w in zip(("u", "uf", "n"), want):
        got = _same_on_every_rank(out, f"fused_uneven_{key}")
        assert got.shape[0] == lanes
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(out[0]["fused_uneven_u"], whole[:lanes])
    assert "does not divide" in str(out[0]["uneven_shard_error"])


def _hi_solver(dtype, **kw):
    vf, _, _, params = problems.rigid_body()
    return batched_hi.make_hi_solver(vf, params, save_at=worker.HI_SAVE_AT, dt0=0.1,
                                     vf_df=problems.rigid_body_df(params), engine="torch",
                                     dtype=dtype, **kw)


def test_sharded_hi_solver_equals_unsharded(ranks, world):
    """``make_hi_solver(shard_mesh=)``: bit for bit with the unsharded
    solve (``tests/test_parallel.py:153``), in f32 pairs on 4 lanes and in
    f64 pairs on 5 (uneven); the f64 pairs against the reference's xla
    engine as ``test_torch_batched_hi.py`` holds them."""
    vf, _, _, params = jproblems.rigid_body()
    u0s, _ = worker.rigid_ensemble(5)
    u0s32 = u0s.astype(np.float32)
    want_j = jbatched_hi.make_hi_solver(
        vf, params, save_at=jnp.asarray(worker.HI_SAVE_AT), dt0=0.1, engine="xla", lanes=8,
        dtype=jnp.float64, vf_df=jproblems.rigid_body_df(params))(jnp.asarray(u0s32),
                                                                  np.full(5, 1e-6))
    out = ranks()
    keys = ("us_hi", "us_lo", "uf_hi", "uf_lo", "n")
    for name, dtype, rtol, lanes in (("hi32", torch.float32, 1e-7, 4),
                                     ("hi64", torch.float64, 1e-6, 5)):
        (us, uf, n) = _hi_solver(dtype)(torch.tensor(u0s32[:lanes]),
                                       torch.full((lanes,), rtol, dtype=dtype))
        for key, w in zip(keys, (*us, *uf, n)):
            np.testing.assert_array_equal(_same_on_every_rank(out, f"{name}_{key}"), w.numpy())
        # a world of one takes the same path with one block
        (us1, _uf1, n1) = _hi_solver(dtype, shard_mesh=world)(
            torch.tensor(u0s32[:lanes]), torch.full((lanes,), rtol, dtype=dtype))
        assert torch.equal(us1[0], us[0]) and torch.equal(us1[1], us[1]) and torch.equal(n1, n)
    (us_j, uf_j, n_j) = want_j
    np.testing.assert_array_equal(out[0]["hi64_n"], np.asarray(n_j))
    for key, w in zip(keys[:4], (*us_j, *uf_j)):
        np.testing.assert_allclose(out[0][f"hi64_{key}"], np.asarray(w), rtol=1e-12, atol=1e-15)


def _reference_dp_loss_and_grad(batch):
    """``jax.value_and_grad`` of the reference's dp loss
    (``odecheckpts_tpu/parallel.py:220-231``) on the whole batch."""
    def vf(u, *, t, p):
        return p * u * (1.0 - u)

    u0s, ys = worker.dp_data(batch)
    save_at = jnp.asarray(worker.DP_SAVE_AT)
    solve = jfacade.solve("ts0-2", vf, jnp.asarray(u0s[0]), save_at, dt0=0.1, atol=1e-5,
                          rtol=1e-5, calibrate="none")

    def loss(theta):
        def one(u0, y):
            _u, aux = solve((u0,), theta)
            return -jstats.log_marginal_likelihood(
                y, standard_deviation=1e-2 * jnp.ones(len(save_at)),
                posterior=aux["solution"].posterior)

        return jnp.sum(jax.vmap(one)(jnp.asarray(u0s), jnp.asarray(ys)))

    with jcontrol_flow.overwrite_with_bounded(max_steps=worker.DP_MAX_STEPS):
        value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(worker.DP_THETA0))
    return float(value), float(grad)


def test_dp_train_step(ranks, world):
    """Replicas equal bit for bit; loss and gradient those of the one-process
    step on the whole batch (1e-12) and of the reference (1e-10); the
    parameter moves toward the true rate (``tests/test_parallel.py:102``)."""
    from torch.distributed.device_mesh import DeviceMesh

    batch = 4
    loss_j, grad_j = _reference_dp_loss_and_grad(batch)
    one = worker.dp_two_steps(DeviceMesh("cpu", world.mesh, mesh_dim_names=("dp",)), "dp",
                              batch)
    out = ranks()
    got = {k: _same_on_every_rank(out, k) for k in one}
    for k in ("dp_loss1", "dp_grad1", "dp_loss2"):
        np.testing.assert_allclose(got[k], one[k], rtol=1e-12, atol=0)
    np.testing.assert_allclose(got["dp_loss1"], loss_j, rtol=1e-10, atol=0)
    np.testing.assert_allclose(got["dp_grad1"], grad_j, rtol=1e-10, atol=0)
    assert np.isfinite(got["dp_loss2"])
    assert abs(float(got["dp_theta2"]) - worker.DP_A_TRUE) < abs(worker.DP_THETA0
                                                                  - worker.DP_A_TRUE)


def test_replicate_and_shard_along_on_a_world_of_one(world):
    tree = {"a": torch.arange(4.0), "b": (torch.ones(2, 3, dtype=torch.bool), 7)}
    rep = parallel.replicate(tree, world)
    assert torch.equal(rep["a"], tree["a"]) and torch.equal(rep["b"][0], tree["b"][0])
    assert rep["b"][1] == 7 and rep["b"][0].dtype == torch.bool
    assert torch.equal(parallel.shard_along(tree, world)["a"], tree["a"])


def test_workprec_batched_reports_the_sweep():
    vf, _, tspan, params = problems.logistic()
    solve = parallel.build_batched_solve("ts0-3", vf, np.zeros(1), np.linspace(*tspan, 5),
                                         dt0=0.1)
    u0s, tols = worker.logistic_batch(4)
    rec = parallel.workprec_batched(solve, (torch.tensor(u0s),), params, torch.tensor(tols))
    assert rec["batch"] == 4 and rec["wall_s"] > 0 and rec["solves_per_s"] > 0
    assert rec["total_steps"] == int(_port_batched(4, None)[1].sum())
    assert tuple(rec["u"].shape) == (4, 5, 1)


# -- harness -------------------------------------------------------------------


def test_workprec_schema_equals_the_reference():
    def fun_t(tol):
        u = torch.tensor([1.0, 2.0], dtype=torch.float64) * (1.0 + tol)
        return u, {"u0_solve": torch.zeros(3)}

    def fun_j(tol):
        u = jnp.asarray([1.0, 2.0]) * (1.0 + tol)
        return u, {"u0_solve": jnp.zeros(3)}

    args = [1e-2, 1e-3]
    expected = torch.tensor([1.0, 2.0], dtype=torch.float64)
    got = harness.workprec(fun_t, precision_fun=harness.rmse_absolute(expected),
                           timeit_fun=harness.timeit_fun(2))(args)
    want = jharness.workprec(fun_j, precision_fun=jharness.rmse_absolute(jnp.asarray([1.0, 2.0])),
                             timeit_fun=jharness.timeit_fun(2))(args)
    assert list(got) == list(want)
    assert got["list_of_args"] == want["list_of_args"]
    for key in ("length_of_longest_vector", "work_min", "work_mean", "work_std", "precision"):
        assert tuple(got[key].shape) == np.shape(want[key]), key
    np.testing.assert_array_equal(got["length_of_longest_vector"].numpy(),
                                  np.asarray(want["length_of_longest_vector"]))
    np.testing.assert_allclose(got["precision"].numpy(), np.asarray(want["precision"]),
                               rtol=1e-12)


def test_nan_guard_and_debug_nans_raise():
    guarded = harness.nan_guard(lambda x: (x, torch.log(x)), name="log")
    assert torch.equal(guarded(torch.ones(2))[1], torch.zeros(2))
    with pytest.raises(FloatingPointError, match="output 1 of log"):
        guarded(torch.tensor([1.0, -1.0]))
    x = torch.tensor([1.0, 0.0])
    with harness.debug_nans():
        y = torch.exp(x)  # finite: no error
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x - 1.0)  # log(-1) = nan, log(0) = -inf
    with harness.debug_nans(enable=False):
        assert bool(torch.isnan(torch.log(x - 1.0))[1])
    assert bool(torch.isnan(torch.log(x - 1.0))[1])  # the mode is gone after the scope
    assert torch.equal(y, torch.exp(x))


def test_nbytes_of_tree_matches_the_reference():
    trees = (
        (np.zeros((3, 2), np.float64), np.zeros(4, np.float64)),
        (np.zeros(5, np.float32), np.zeros((2, 2), np.float32)),
        (np.zeros(5, np.float32), np.zeros(3, np.float64)),
        (np.zeros(5, np.int32), np.zeros(3, np.float32)),
    )
    for tree in trees:
        got = harness.nbytes_of_tree({"a": [torch.tensor(tree[0])], "b": torch.tensor(tree[1])})
        want = jharness.nbytes_of_tree({"a": [jnp.asarray(tree[0])], "b": jnp.asarray(tree[1])})
        assert got == want, tree


def test_timers_memory_stats_and_profiler(tmp_path):
    calls = []

    def fun():
        calls.append(1)
        return torch.ones(3)

    assert len(harness.timeit_fun(3)(fun)) == 3 and len(calls) == 4  # one warm-up
    assert harness.runtime_min(fun, num_runs=2) >= 0.0
    seconds, out = harness.jit_and_time(fun)()
    assert seconds >= 0.0 and torch.equal(out, torch.ones(3))
    seconds, out = harness.timed_cold(lambda a: a * 2, torch.ones(2))
    assert seconds >= 0.0 and torch.equal(out, 2 * torch.ones(2))
    stats = harness.device_memory_stats()
    assert stats == {"cpu": None} or all("free" in v for v in stats.values())
    with harness.profiler_trace(str(tmp_path / "trace")):
        with harness.annotate("span"):
            torch.ones(8).sum()
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert '"span"' in text
