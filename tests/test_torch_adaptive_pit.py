"""Port differential tests of the adaptive parallel-in-time solve
(``ivpsolve.solve_adaptive_parallel_in_time``) and of the dense and blockdiag
adapters of ``parallel_time`` against the JAX reference, in float64; the
block-axis form of K8 on the card.

The adaptive solve discovers its grid with the bounded filter.  The two
packages' accepted times drift apart by about 1e-8 relative over the steps
(the controller reads an error estimate whose last bits are rounding, see
``test_torch_adaptive``), as the reference drifts from itself under a
one-ulp change of u0, so the adaptive solves are compared loosely; on one
shared grid the adapters agree to
rtol 1e-9 (observed 1e-13).  At mu = 10 the reference's parallel solve
lands within only 1e-8 (values) and 2e-5 (stds) of its own sequential
solve on this grid, and the port's as near, so the two are no closer.
Sizes are cut for the reference's compile time (a dense parallel-in-time
program compiles for about 25 s on one core): the
Van der Pol system (mu = 1, d = 2) at nu = 2 on the dense backend, the
rigid body at nu = 2 on blockdiag, 17 grid points in windows of 4, iterated
to 1e-10.
"""

import functools

import numpy as np
import pytest
import torch

from odecheckpts_torch import interop, kernels, pit_fused
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import taylor as ttaylor

try:
    import jax.numpy as jnp

    from odecheckpts_tpu import ivpsolve as jivpsolve
    from odecheckpts_tpu import ivpsolvers as jsolvers
    from odecheckpts_tpu import problems as jproblems
    from odecheckpts_tpu import taylor as jtaylor
except ImportError:  # a machine with the card and no JAX runs the card-only tests at the end
    jnp = jproblems = None

MU = 1.0


def _vdp(lib):
    stack = torch.stack if lib is tproblems else jnp.stack

    def vf(y, *, t):
        return stack([y[1], MU * ((1.0 - y[0] ** 2) * y[1]) - y[0]])

    return vf, np.array([2.0, 0.0])


def _rigid(lib):
    vf_p, (u0,), _, params = lib.rigid_body()
    return (lambda u, *, t: vf_p(u, t=t, p=params)), np.asarray(u0)


def _solver(lib, impl, method, nu, d, kind="smoother"):
    prior = lib.prior_ibm(num_derivatives=nu, ode_shape=(d,), implementation=impl)
    corr = lib.correction_ts0() if method == "ts0" else lib.correction_ts1()
    return lib.solver_dynamic(getattr(lib, f"strategy_{kind}")(prior, corr))


@functools.lru_cache(maxsize=None)
def _setup(problem, impl, method, nu, kind="smoother"):
    """Both packages' vf, init and solver; the reference's Taylor init as
    numpy arrays for both."""
    make = {"vdp": _vdp, "rigid": _rigid}[problem]
    (jvf, u0), (tvf, _) = make(jproblems), make(tproblems)
    d = len(u0)
    jsolver = _solver(jsolvers, impl, method, nu, d, kind)
    tsolver = _solver(tsolvers, impl, method, nu, d, kind)
    tc = jtaylor.odejet_padded_scan(lambda u: jvf(u, t=0.0), (jnp.asarray(u0),), num=nu)
    jinit = jsolver.initial_condition(tc, 1.0)
    as_np = ((np.asarray(jinit[0].mean), np.asarray(jinit[0].cholesky)), np.asarray(jinit[1]))
    return (jvf, jinit, jsolver), (tvf, interop.init_to_torch(as_np), tsolver)


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _gram(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x @ np.swapaxes(x, -1, -2)


FIXED = dict(parallel=True, window=4, iterations=8, iteration_tol=1e-10, form="sqrt",
             return_diagnostics=True)
GRID = np.linspace(0.0, 1.0, 17)


@pytest.mark.parametrize("problem,impl,method,nu", [
    ("vdp", "dense", "ts1", 2), ("rigid", "blockdiag", "ts0", 2)])
def test_parallel_adapters_match_reference(problem, impl, method, nu):
    """The dense (TS1, Jacobians in H) and blockdiag (a block axis, one chain
    per dimension) adapters, smoother strategy, ``combine_engine="ll"`` (the
    lanes-last prefix; on blockdiag with its block axis), against the
    reference on one grid: values, stacked means, scales, stds, Grams and
    the backward gains to rtol 1e-9; no window falls back in either."""
    (jvf, jinit, jsolver), (tvf, tinit, tsolver) = _setup(problem, impl, method, nu)
    jsol, jd = jivpsolve.solve_fixed_grid(jvf, jinit, grid=jnp.asarray(GRID), solver=jsolver,
                                          combine_engine="ll", **FIXED)
    tsol, td = tivpsolve.solve_fixed_grid(tvf, tinit, grid=GRID, solver=tsolver,
                                          combine_engine="ll", **FIXED)
    assert not np.any(np.asarray(jd["window_diverged"])) and not bool(torch.any(
        td["window_diverged"]))
    for got, want in ((tsol.u, jsol.u), (tsol.posterior.init.mean, jsol.posterior.init.mean),
                      (tsol.u_std, jsol.u_std), (tsol.output_scale, jsol.output_scale),
                      (_gram(tsol.posterior.init.cholesky), _gram(jsol.posterior.init.cholesky)),
                      (tsol.posterior.conditional.matrix, jsol.posterior.conditional.matrix)):
        _close(got, want, 1e-9)
    assert tsol.output_scale.shape == jsol.output_scale.shape


def test_blockdiag_prefix_engines_agree():
    """Blockdiag's step-leading associative scan (engine None) and its
    lanes-last Kogge-Stone prefix on (m, m, d, P) (engine "ll") reach the
    same solve: values rtol 1e-9, scales rtol 1e-6."""
    _, (tvf, tinit, tsolver) = _setup("rigid", "blockdiag", "ts0", 2)
    sols = [tivpsolve.solve_fixed_grid(tvf, tinit, grid=GRID, solver=tsolver,
                                       combine_engine=engine, **FIXED)[0]
            for engine in (None, "ll")]
    _close(sols[1].u, sols[0].u.numpy(), 1e-9)
    _close(sols[1].output_scale, sols[0].output_scale.numpy(), 1e-6)


def test_adaptive_parallel_in_time_matches_reference():
    """Rigid body on (0, 3), nu = 3, smoother, rtol 1e-6, the discovery warm
    start and the default sweep control.  The discovered grids differ as the
    reference differs from itself: a one-ulp change of u0 moves its own
    accepted times by up to 6e-5 over these ~214 steps (the controller reads
    an error estimate whose last bits are rounding).  So: grid lengths within
    2%, every time within 1e-3 (absolute, of a span of 3), and the two
    solutions at t1 within 1e-5 relative (each is within a few rtol of the
    truth); no window falls back in either."""
    (jvf, jinit, jsolver), (tvf, tinit, tsolver) = _setup("rigid", "isotropic", "ts0", 3)
    kw = dict(t0=0.0, t1=3.0, dt0=0.1, max_steps=256, window=8, return_diagnostics=True)
    jsol, jd = jivpsolve.solve_adaptive_parallel_in_time(
        jvf, jinit, adaptive_solver=jivpsolve.adaptive(jsolver, atol=1e-8, rtol=1e-6), **kw)
    tsol, td = tivpsolve.solve_adaptive_parallel_in_time(
        tvf, tinit, adaptive_solver=tivpsolve.adaptive(tsolver, atol=1e-8, rtol=1e-6), **kw)
    jt, tt = np.asarray(jsol.t), tsol.t.numpy()
    assert abs(len(tt) - len(jt)) <= 0.02 * len(jt) and len(tt) > 100
    n = min(len(tt), len(jt))
    np.testing.assert_allclose(tt[:n], jt[:n], rtol=0, atol=1e-3)
    assert tt[-1] == jt[-1] == 3.0
    _close(tsol.u[-1], jsol.u[-1], 1e-5)
    assert not bool(torch.any(td["window_diverged"])) and not np.any(np.asarray(
        jd["window_diverged"]))


@pytest.mark.parametrize("problem,impl,method,engine,rtol,kind", [
    ("rigid", "isotropic", "ts0", None, 1e-4, "smoother"),
    ("vdp", "dense", "ts1", "ll", 1e-4, "smoother"),
    ("rigid", "blockdiag", "ts0", "ll", 1e-6, "filter")])
def test_adaptive_parallel_in_time_matches_sequential_resolve(problem, impl, method, engine,
                                                              rtol, kind):
    """Torch form of the reference's test of the same name, on every
    backend: the discovered grid is the eager adaptive every-step grid (rtol
    1e-9; one package, one arithmetic), and the parallel re-solve matches
    the sequential fixed-grid solve on that grid (rtol 5e-5, atol 1e-7).
    Blockdiag at rtol 1e-6 (at 1e-4 a dimension's sigma is rounding noise,
    ROADMAP section 3) and with the filter strategy: the discovery pass is a
    filter, and blockdiag's error estimate carries the last bit by which the
    smoother's reverted factors differ from the filter's into its grid."""
    _, (tvf, tinit, tsolver) = _setup(problem, impl, method, 3, kind)
    t1, dt0 = {"isotropic": (6.0, 0.1), "dense": (1.0, 0.01), "blockdiag": (3.0, 0.1)}[impl]
    asolver = tivpsolve.adaptive(tsolver, atol=1e-3 * rtol, rtol=rtol)
    sol_par = tivpsolve.solve_adaptive_parallel_in_time(
        tvf, tinit, t0=0.0, t1=t1, dt0=dt0, adaptive_solver=asolver, max_steps=1024,
        iterations=12, window=8, form="sqrt", warmstart="rk", combine_engine=engine)
    sol_seq = tivpsolve.solve_adaptive_save_every_step(
        tvf, tinit, t0=0.0, t1=t1, dt0=dt0, adaptive_solver=asolver)
    np.testing.assert_allclose(sol_par.t.numpy(), sol_seq.t.numpy(), rtol=1e-9)
    sol_fix = tivpsolve.solve_fixed_grid(tvf, tinit, grid=sol_par.t, solver=tsolver)
    np.testing.assert_allclose(sol_par.u.numpy(), sol_fix.u.numpy(), rtol=5e-5, atol=1e-7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pit_combine_k8_with_a_block_axis_matches_its_twin(cuda_device, dtype, m):
    """K8 on (m, m, d, P) operands (the blockdiag adapter's, c = 1, d = 3):
    one launch on the folded lanes, equal bit for bit to the twin
    ``pit_fused.combine_sqrt_ll`` on the block-axis operands, twice."""
    rng = np.random.default_rng(m)
    shapes = ((m, m, 3, 500), (m, 1, 3, 500), (m, m, 3, 500), (m, 1, 3, 500), (m, m, 3, 500))
    e_i, e_j = (tuple(torch.tensor(rng.standard_normal(s), dtype=dtype, device=cuda_device)
                      for s in shapes) for _ in range(2))
    before = kernels.LAUNCHES["pit_combine"]
    got = kernels.pit_combine(e_i, e_j)
    again = kernels.pit_combine(e_i, e_j)
    assert kernels.LAUNCHES["pit_combine"] == before + 2
    want = pit_fused.combine_sqrt_ll(e_i, e_j)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape
        assert torch.equal(g, w) and torch.equal(a, w)


@pytest.mark.cuda
def test_blockdiag_adaptive_pit_on_the_card_equals_the_twin_engine(cuda_device):
    """The blockdiag adaptive parallel-in-time solve with
    ``combine_engine="cuda"`` (K8 with its block axis) gives the "ll" solve's
    every output bit for bit, and launches K8."""
    tvf, u0 = _rigid(tproblems)
    tsolver = _solver(tsolvers, "blockdiag", "ts0", 3, 3)
    u0 = torch.tensor(u0, dtype=torch.float64, device=cuda_device)
    init = tsolver.initial_condition(
        ttaylor.odejet_padded_scan(lambda u: tvf(u, t=0.0), (u0,), num=3), 1.0)
    kw = dict(t0=0.0, t1=3.0, dt0=0.1, max_steps=512, window=8,
              adaptive_solver=tivpsolve.adaptive(tsolver, atol=1e-8, rtol=1e-6))
    before = kernels.LAUNCHES["pit_combine"]
    got = tivpsolve.solve_adaptive_parallel_in_time(tvf, init, combine_engine="cuda", **kw)
    assert kernels.LAUNCHES["pit_combine"] > before
    want = tivpsolve.solve_adaptive_parallel_in_time(tvf, init, combine_engine="ll", **kw)
    for g, w in ((got.u, want.u), (got.u_std, want.u_std),
                 (got.posterior.init.cholesky, want.posterior.init.cholesky)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_dense_adapter_with_the_cuda_engine_raises_k8s_own_error(cuda_device):
    """The dense adapter's elements have m = n d (15 for the rigid body at
    nu = 4), outside K8's built m: ``combine_engine="cuda"`` raises K8's
    ``ValueError``, with no fallback (ROADMAP section 2)."""
    tvf, u0 = _rigid(tproblems)
    tsolver = _solver(tsolvers, "dense", "ts0", 4, 3)
    u0 = torch.tensor(u0, dtype=torch.float64, device=cuda_device)
    init = tsolver.initial_condition(
        ttaylor.odejet_padded_scan(lambda u: tvf(u, t=0.0), (u0,), num=4), 1.0)
    grid = torch.linspace(0.0, 1.0, 9, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="built for"):
        tivpsolve.solve_fixed_grid(tvf, init, grid=grid, solver=tsolver, parallel=True,
                                   form="sqrt", window=8, combine_engine="cuda")
