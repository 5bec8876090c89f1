"""Port differential tests: the blockdiag path (``ssm.blockdiag``, the
anisotropic rigid body, the twin of K6, the batched blockdiag driver) against
the JAX reference.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances and why:

* ``ssm.blockdiag``, the checkpoint interpolation and the smoothing pass on
  the blockdiag layout, in f64: rtol 1e-12 of each array's largest entry
  (same algorithm, reassociated sums only).
* The anisotropic vector field against the reference experiment's
  ``_vf_scaled``: bit for bit in f32 and f64 (the same operations in the
  same order).
* One attempt of ``StepBD`` against ``make_step_bd_ll`` run op by op
  (``jax.disable_jit``), all 17 arrays, from the initial state and from a
  mid-interval state with random backward conditionals.  f64: rtol 1e-12 of
  each array's largest entry.  f32: the twin sums the observation row in the
  order 0..n-1 where the reference calls ``jnp.sum``, and a few primitives
  round the last bit differently, so single entries differ by an ulp or two
  before the per-dimension residual ``z_i = u'_i - f_i(u)`` cancels.  The
  blockdiag step divides ``|z_i|`` by a unit scale to get that dimension's
  sigma, so where one ``z_i`` is almost all cancellation (the rigid body's
  second component starts at exactly 0) an ulp in the prediction moves that
  dimension's sigma, scale, factor and the step's error norm by a large
  relative amount, in the reference as in the twin.  So the f32 bound is
  set by the reference's own f64 attempt on the same (exactly widened)
  inputs: per array, the twin is within 64 ulp (of the largest entry) of the
  reference's f32 attempt, or no farther from it than that attempt is from
  the f64 one (measured on these states: 3 ulp).  On the card the kernel is
  held to the twin bit for bit.
* Whole solves in f64 against ``solve_save_at_batched(implementation=
  "blockdiag", engine="xla")``: at tolerances 1e-6..3e-8 identical per-lane
  step counts and values within rtol 1e-10.  At tolerances 1e-4..1e-5 the
  engine amplifies the last bit through that same noise-dominated sigma:
  the reference moves against itself when u0 changes by one ulp (per-lane
  step counts change by up to 7%, values move by up to ~1e-5 of the scale),
  so there the port is held to the reference within 20% in step counts and
  the tolerance itself in values (measured: 7% and 0.06 tol), and the test
  shows the reference's own movement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import batched as jb
from odecheckpts_tpu import batched_blockdiag as jbd
from odecheckpts_tpu import ivpsolve as jivpsolve
from odecheckpts_tpu import ivpsolvers as jsolvers
from odecheckpts_tpu import problems as jp
from odecheckpts_tpu import stats as jstats
from odecheckpts_tpu.ssm.base import Conditional as JCond
from odecheckpts_tpu.ssm.base import MarkovSeq as JSeq
from odecheckpts_tpu.ssm.base import Normal as JNormal
from odecheckpts_torch import batched as tb
from odecheckpts_torch import batched_blockdiag as tbd
from odecheckpts_torch import interop, kernels
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import problems as tp
from odecheckpts_torch import stats as tstats
from odecheckpts_torch.ssm.base import Conditional as TCond
from odecheckpts_torch.ssm.base import MarkovSeq as TSeq
from odecheckpts_torch.ssm.base import Normal as TNormal

NP = {"f64": np.float64, "f32": np.float32}
TORCH = {"f64": torch.float64, "f32": torch.float32}
INPUT_NAMES = ("atol", "rtol", "dt_max", "dt_floor", "tiny_scale")
NU, D, B = 4, 3, 6
N = NU + 1
S3 = 1e4


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


def _close_tree(got, want, rtol=1e-12):
    for g, w in zip(jax.tree.leaves(interop.to_numpy(tuple(got))), jax.tree.leaves(tuple(want))):
        _close(g, w, rtol)


# ---------------------------------------------------------------------------
# ssm.blockdiag


def _ssms():
    j = jsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,), implementation="blockdiag")
    t = tsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,), implementation="blockdiag")
    return j, t


def _normal(rng, lead=(B,)):
    return (rng.standard_normal(lead + (D, N)), np.tril(rng.standard_normal(lead + (D, N, N))))


def _cond(rng, lead=(B,)):
    mat = np.triu(rng.standard_normal(lead + (D, N, N))) + np.eye(N)
    return (mat,) + _normal(rng, lead)


def _jn(x):
    return JNormal(*(jnp.asarray(a) for a in x))


def _tn(x):
    return TNormal(*(torch.tensor(a) for a in x))


def _jc(x):
    return JCond(jnp.asarray(x[0]), _jn(x[1:]))


def _tc(x):
    return TCond(torch.tensor(x[0]), _tn(x[1:]))


@pytest.mark.parametrize("reversal", [True, False])
def test_blockdiag_extrapolate_direct_matches_jax(reversal):
    jssm, tssm = _ssms()
    rng = np.random.default_rng(0)
    rv = _normal(rng)
    dt = rng.uniform(1e-3, 1.0, B)
    scale = rng.uniform(0.1, 3.0, (B, D))  # one output scale per dimension
    want = jax.vmap(lambda r, d, s: jssm.extrapolate_direct(r, d, s, reversal))(
        _jn(rv), jnp.asarray(dt), jnp.asarray(scale))
    got = tssm.extrapolate_direct(_tn(rv), torch.tensor(dt), torch.tensor(scale), reversal)
    assert got[0].mean.shape == (B, D, N) and got[0].cholesky.shape == (B, D, N, N)
    _close_tree(got[0], want[0])
    if reversal:
        _close_tree(got[1], want[1])
    else:
        assert got[1] is None


@pytest.mark.parametrize("op", ["marginalize", "compose", "identity_conditional"])
def test_blockdiag_conditionals_match_jax(op):
    jssm, tssm = _ssms()
    rng = np.random.default_rng(1)
    cond = _cond(rng)
    if op == "marginalize":
        other = _normal(rng)
        want = jax.vmap(jssm.marginalize)(_jn(other), _jc(cond))
        got = tssm.marginalize(_tn(other), _tc(cond))
    elif op == "compose":
        other = _cond(rng)
        want = jax.vmap(jssm.compose)(_jc(cond), _jc(other))
        got = tssm.compose(_tc(cond), _tc(other))
    else:
        want = jssm.identity_conditional(jnp.float64)
        got = tssm.identity_conditional(torch.float64)
        assert got.matrix.shape == (D, N, N) and got.noise.mean.shape == (D, N)
    _close_tree(got, want)


def test_blockdiag_stack_tcoeffs_qoi_and_output_scale_match_jax():
    jssm, tssm = _ssms()
    rng = np.random.default_rng(2)
    tco = [rng.standard_normal((B, D)) for _ in range(N)]
    want = jax.vmap(jssm.stack_tcoeffs)([jnp.asarray(c) for c in tco])
    got = tssm.stack_tcoeffs([torch.tensor(c) for c in tco])
    assert got.mean.shape == (B, D, N)
    _close_tree(got, want)
    _close(tssm.qoi(got.mean).numpy(), jssm.qoi(want.mean))
    scale = rng.uniform(0.5, 2.0, B)
    _close(tssm.promote_output_scale(torch.tensor(scale)).numpy(),
           jax.vmap(jssm.promote_output_scale)(jnp.asarray(scale)))
    with pytest.raises(ValueError, match="Taylor"):
        tssm.stack_tcoeffs([torch.tensor(c) for c in tco[:-1]])
    assert tsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,),
                              implementation="blockdiag").name == "blockdiag"


def _states(rng, t_ckpt):
    """Lane 0 sits exactly on the checkpoint (the `exact` branch); lane 1
    lands within the snap threshold; the rest interpolate."""
    t = t_ckpt + rng.uniform(0.05, 0.5, B)
    t[0] = t_ckpt
    t_prev = t_ckpt - rng.uniform(0.05, 0.5, B)
    t_prev[1] = t_ckpt - 1e-14
    fields = dict(
        t=t, rv=_normal(rng), bwd=_cond(rng), scale_step=rng.uniform(0.1, 3.0, (B, D)),
        t_prev=t_prev, rv_prev=_normal(rng), bwd_prev=_cond(rng),
        dt=rng.uniform(0.01, 0.1, B), errn_prev=rng.uniform(0.1, 1.0, B),
        num_steps=np.arange(B, dtype=np.int32), mle_ssq=rng.uniform(0, 1, (B, D)),
    )
    wrap_j = {"rv": _jn, "rv_prev": _jn, "bwd": _jc, "bwd_prev": _jc}
    wrap_t = {"rv": _tn, "rv_prev": _tn, "bwd": _tc, "bwd_prev": _tc}
    js = jivpsolve._State(**{k: wrap_j.get(k, jnp.asarray)(v) for k, v in fields.items()})
    ts = tivpsolve._State(**{k: wrap_t.get(k, torch.tensor)(v) for k, v in fields.items()})
    return js, ts


def test_interpolate_at_on_the_blockdiag_layout_matches_jax():
    jssm, tssm = _ssms()
    jstrat = jsolvers.strategy_fixedpoint(jssm, jsolvers.correction_ts0())
    tstrat = tsolvers.strategy_fixedpoint(tssm, tsolvers.correction_ts0())
    js, ts = _states(np.random.default_rng(3), 2.5)
    want = jax.vmap(lambda s: jivpsolve._interpolate_at(jstrat, s, 2.5))(js)
    got = tivpsolve._interpolate_at(tstrat, ts, 2.5)
    _close_tree(got[0], want[0])  # the emitted marginal and conditional
    _close_tree(got[1], want[1])  # the rewired state


def test_markov_marginals_on_the_blockdiag_layout_match_jax():
    jssm, tssm = _ssms()
    rng = np.random.default_rng(4)
    steps = 4  # time on the leading axis, ensemble on the next
    init = _normal(rng, (steps + 1, B))
    conds = _cond(rng, (steps + 1, B))
    jseq = JSeq(_jn(init), _jc(conds), ssm=jssm)
    want = jax.vmap(
        lambda s: jstats.markov_marginals(jstats.markov_select_terminal(s)),
        in_axes=(JSeq(JNormal(1, 1), JCond(1, JNormal(1, 1)), ssm=jssm),), out_axes=1,
    )(jseq)
    tseq = TSeq(_tn(init), _tc(conds), ssm=tssm)
    got = tstats.markov_marginals(tstats.markov_select_terminal(tseq))
    assert got.mean.shape == (steps, B, D, N) and got.cholesky.shape == (steps, B, D, N, N)
    _close_tree(got, want)


# ---------------------------------------------------------------------------
# the anisotropic rigid body


def _jvf_scaled(u, *, t, p):
    """The reference experiment's vector field
    (``experiments/6_tpu_batched_sweep/blockdiag_tpu.py:39-53``)."""
    p1, p2, p3 = p
    return jnp.stack([p1 * u[1] * (u[2] / S3), p2 * u[0] * (u[2] / S3), S3 * p3 * u[0] * u[1]])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_anisotropic_rigid_body_matches_the_reference_experiment(dtype):
    vf, (y0,), span, params = tp.rigid_body_anisotropic()
    np.testing.assert_array_equal(y0.numpy(), np.array([1.0, 0.0, 0.9]) * np.array([1, 1, S3]))
    assert span == (0.0, 50.0) and params == (-2.0, 1.25, -0.5)
    assert vf.device_functor == "rigid_body_anisotropic"
    assert vf.device_params(params) == (-2.0, 1.25, -5000.0, 1e4)
    rng = np.random.default_rng(5)
    y = (y0.numpy()[:, None] * (1.0 + rng.standard_normal((3, 7)))).astype(NP[dtype])
    got = vf(torch.tensor(y), t=0.0, p=params).numpy()
    want = np.asarray(_jvf_scaled(jnp.asarray(y), t=0.0, p=params))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="third component"):
        tp.rigid_body_anisotropic(scale=(2.0, 1.0, 1e4))


# ---------------------------------------------------------------------------
# one attempt of the twin of K6 against make_step_bd_ll


def _problem(name):
    if name == "anisotropic":
        vf, (y0,), _, params = tp.rigid_body_anisotropic()
        return _jvf_scaled, vf, y0.numpy(), params, 0.01
    jvf, _, _, _ = jp.rigid_body()
    vf, (y0,), _, params = tp.rigid_body()
    return jvf, vf, y0.numpy(), params, 0.1


def _jax_step(jvf, params):
    return jbd.make_step_bd_ll(lambda args, t: jvf(*args, t=t[0], p=params), nu=NU, d=D)


def _with_backward(state, seed=7):
    """``state`` with random backward conditionals: within the first interval
    they are exactly zero (the Taylor init has zero covariance, so the gains
    are 0), which would leave the fixedpoint accumulation untested."""
    rng = np.random.default_rng(seed)
    out = list(state)
    n, _, d, b = out[3].shape
    for i in (3, 10):
        out[i] = np.eye(n)[:, :, None, None] + 0.3 * rng.standard_normal((n, n, d, b)) / np.sqrt(n)
    for i in (4, 11):
        out[i] = rng.standard_normal((n, d, b))
    for i in (5, 12):
        out[i] = 0.3 * rng.standard_normal((n, n, d, b)) * np.tril(np.ones((n, n)))[:, :, None, None]
    return tuple(x.astype(state[1].dtype) for x in out)


def _bd_start(problem, dtype, batch=8, warm_steps=12):
    """The port's Taylor-initialized blockdiag state, and one advanced by the
    twin ``warm_steps`` attempts with random backward conditionals, as numpy
    arrays; and the kernel inputs."""
    _, vf, y0, params, dt0 = _problem(problem)
    rng = np.random.default_rng(6)
    u0s = (y0[None] * (1.0 + 0.05 * rng.standard_normal((batch, D)))).astype(NP[dtype])
    tols = np.geomspace(1e-3, 1e-6, batch).astype(NP[dtype])
    save_at = np.linspace(0.0, 10.0, 5).astype(NP[dtype])
    state, _, inputs = tbd.initial_state(vf, torch.tensor(u0s), params, save_at=save_at,
                                         dt0=dt0, tols=torch.tensor(tols))
    step = tbd.make_step_bd(vf, params, nu=NU, d=D, dtype=TORCH[dtype])
    t_next = torch.full((1, batch), float(save_at[1]), dtype=TORCH[dtype])
    mid = state
    for _ in range(warm_steps):
        mid = kernels.attempt_plain(step, mid, t_next, **inputs)
    extra = (t_next,) + tuple(inputs[k] for k in INPUT_NAMES)
    mid = _with_backward(interop.state_to_numpy(mid))
    return step, interop.state_to_numpy(state), mid, interop.to_numpy(extra)


def _run_jax(jstep, start, extra, dtype=None):
    cast = (lambda x: jnp.asarray(x)) if dtype is None else (lambda x: jnp.asarray(x, dtype))
    with jax.disable_jit():
        out = jstep(tuple(cast(x) for x in start), *(cast(x) for x in extra))
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("problem", ["anisotropic", "rigid_body"])
def test_one_attempt_matches_jax_make_step_bd_ll(problem, dtype):
    jvf, _, _, params, _ = _problem(problem)
    step, init, mid, extra = _bd_start(problem, dtype)
    assert init[2].shape == (N, N, D, 8) and init[6].shape == (D, 8) and init[16].shape == (D, 8)
    jstep = _jax_step(jvf, params)
    for start in (init, mid):
        want = _run_jax(jstep, start, extra)
        got = interop.state_to_numpy(step(interop.state_to_torch(start), *interop.to_torch(extra)))
        assert int(np.sum(got[0] != start[0])) > 0  # some lanes accepted
        ref64 = _run_jax(jstep, start, extra, jnp.float64) if dtype == "f32" else None
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.dtype == w.dtype
            if dtype == "f64":
                _close(g, w, 1e-12)
                continue
            r = ref64[i]
            if not np.all(np.isfinite(r)):
                continue
            direct, own = np.max(np.abs(g - w)), np.max(np.abs(w - r))
            ulp = float(np.spacing(np.float32(np.max(np.abs(r)))))
            assert direct <= max(own, 64.0 * ulp), (i, direct, own, ulp)


# ---------------------------------------------------------------------------
# whole solves in f64


def _solve_both(problem, u0s, tols, save_at):
    jvf, vf, _, params, dt0 = _problem(problem)
    want = jb.solve_save_at_batched(
        jvf, jnp.asarray(u0s), params, save_at=jnp.asarray(save_at), dt0=dt0,
        tols=jnp.asarray(tols), engine="xla", implementation="blockdiag", lanes=len(tols))
    got = tb.solve_save_at_batched(
        vf, torch.tensor(u0s), params, save_at=save_at, dt0=dt0, tols=torch.tensor(tols),
        implementation="blockdiag", engine="cuda-loop")
    return tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want)


def _ensemble(problem, batch, seed):
    _, _, y0, _, _ = _problem(problem)
    rng = np.random.default_rng(seed)
    return y0[None] * (1.0 + 0.05 * rng.standard_normal((batch, D)))


@pytest.mark.parametrize("problem", ["anisotropic", "rigid_body"])
def test_blockdiag_solve_matches_jax_at_tight_tolerances(problem):
    u0s = _ensemble(problem, 4, seed=0)
    tols = np.array([1e-6, 3e-7, 1e-7, 3e-8])
    (u_t, uf_t, n_t), (u_j, uf_j, n_j) = _solve_both(problem, u0s, tols, np.linspace(0, 10, 5))
    assert u_t.shape == u_j.shape == (4, 5, D) and n_t.shape == n_j.shape == (4, 5)
    assert np.all(n_j[:, -1] > 300)
    np.testing.assert_array_equal(n_t, n_j)
    scale = np.max(np.abs(u_j), axis=(0, 1))  # per component: the third is 1e4 larger
    np.testing.assert_allclose(uf_t / scale, uf_j / scale, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(u_t / scale, u_j / scale, rtol=1e-10, atol=1e-10)


def test_blockdiag_at_loose_tolerances_moves_with_the_last_bit_in_the_reference_too():
    problem = "anisotropic"
    u0s = _ensemble(problem, 4, seed=1)
    tols = np.array([1e-4, 3e-5, 1e-5, 1e-4])
    save_at = np.linspace(0, 10, 5)
    (u_t, _, n_t), (u_j, _, n_j) = _solve_both(problem, u0s, tols, save_at)
    _, (u_p, _, n_p) = _solve_both(problem, np.nextafter(u0s, np.inf), tols, save_at)
    scale = np.max(np.abs(u_j), axis=(0, 1))
    own = np.max(np.abs(u_p - u_j) / scale, axis=(1, 2))  # the reference under a 1-ulp change
    port = np.max(np.abs(u_t - u_j) / scale, axis=(1, 2))
    # one ulp in u0 (2e-16) moves the reference by many orders more than that
    assert np.max(own) > 1e-9 or np.any(n_p != n_j), (own, n_p, n_j)
    assert np.all(port < tols), (port, own)
    np.testing.assert_allclose(n_t[:, -1], n_j[:, -1], rtol=0.2)


def test_blockdiag_torch_engine_and_attempt_engine_give_the_loop_engines_outputs():
    problem = "anisotropic"
    _, vf, _, params, dt0 = _problem(problem)
    u0s = torch.tensor(_ensemble(problem, 4, seed=2).astype(np.float32))
    tols = torch.tensor([1e-3, 1e-4, 1e-5, 1e-3])
    kw = dict(save_at=np.linspace(0, 4, 3), dt0=dt0, tols=tols, implementation="blockdiag")
    u_s, u_f, n = tb.solve_save_at_batched(vf, u0s, params, engine="torch", **kw)
    assert u_s.shape == u_f.shape == (4, 3, D) and n.shape == (4, 3) and n.dtype == torch.int32
    assert bool(torch.all(torch.isfinite(u_s))) and int(n[:, -1].min()) > 0
    torch.testing.assert_close(u_s[:, -1], u_f[:, -1], rtol=0, atol=0)  # the terminal marginal
    for engine in ("cuda-loop", "cuda"):  # both run the twin on CPU tensors
        again = tb.solve_save_at_batched(vf, u0s, params, engine=engine, **kw)
        for a, b in zip(again, (u_s, u_f, n)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dispatch


def _rigid_inputs():
    vf, (y0,), _, params = tp.rigid_body()
    rng = np.random.default_rng(2)
    u0s = (y0.numpy()[None] * (1.0 + 0.05 * rng.standard_normal((4, 3)))).astype(np.float32)
    return vf, params, torch.tensor(u0s), torch.full((4,), 1e-3)


def test_blockdiag_reaches_the_blockdiag_engine_and_refuses_ts1(monkeypatch):
    vf, params, u0s, tols = _rigid_inputs()
    calls = []
    real = tbd.solve_save_at_batched_blockdiag
    monkeypatch.setattr(tbd, "solve_save_at_batched_blockdiag",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    u_s, _, n = tb.solve_save_at_batched(vf, u0s, params, save_at=np.linspace(0, 2, 3), dt0=0.1,
                                         tols=tols, implementation="blockdiag")
    assert len(calls) == 1 and calls[0]["engine"] == "cuda-loop"
    assert u_s.shape == (4, 3, 3) and int(n[:, -1].min()) > 0
    with pytest.raises(ValueError, match="ts0"):
        tb.solve_save_at_batched(vf, u0s, params, save_at=np.linspace(0, 2, 3), dt0=0.1,
                                 tols=tols, implementation="blockdiag", correction="ts1")
    with pytest.raises(MemoryError):
        tb.solve_save_at_batched(vf, u0s, params, save_at=np.linspace(0, 2, 3), dt0=0.1,
                                 tols=tols, implementation="blockdiag", hbm_budget=1024)


@pytest.mark.parametrize("option, item", [
    (dict(strategy="filter"), "item 5"),
    (dict(strategy="smoother"), "item 5"),
    (dict(calibration="none"), "item 5"),
    (dict(ode_order=2), "item 5"),
    (dict(error_unit="residual"), "item 5"),
    (dict(num_derivatives=5), "num_derivatives"),
])
def test_unported_blockdiag_options_name_their_roadmap_item(option, item):
    vf, params, u0s, tols = _rigid_inputs()
    with pytest.raises(NotImplementedError, match=item):
        tb.solve_save_at_batched(vf, u0s, params, save_at=np.linspace(0, 10, 5), dt0=0.1,
                                 tols=tols, implementation="blockdiag", **option)
    with pytest.raises(ValueError, match="cuda-loop"):
        tb.solve_save_at_batched(vf, u0s, params, save_at=np.linspace(0, 10, 5), dt0=0.1,
                                 tols=tols, implementation="blockdiag", engine="pallas")


# ---------------------------------------------------------------------------
# interop


def test_interop_carries_the_blockdiag_state_and_tells_layouts_apart():
    _, init, mid, _ = _bd_start("anisotropic", "f32", batch=4, warm_steps=2)
    assert interop.state_layout(init) == interop.state_layout(mid) == "blockdiag"
    back = interop.state_to_numpy(interop.state_to_torch(mid))
    for a, b in zip(back, mid):
        np.testing.assert_array_equal(a, b)
    # a JAX state goes through the port's twin and comes back as numpy arrays
    jvf, _, _, params, _ = _problem("anisotropic")
    step = tbd.make_step_bd(tp.rigid_body_anisotropic()[0], params, nu=NU, d=D)
    extra = (np.full((1, 4), 2.5, np.float32), np.full((1, 4), 1e-6, np.float32),
             np.full((1, 4), 1e-3, np.float32), np.full((1, 4), 10.0, np.float32),
             np.full((1, 4), 1e-7, np.float32), np.full((1, 4), 1e-19, np.float32))
    out = interop.state_to_numpy(step(interop.state_to_torch(tuple(jnp.asarray(x) for x in init)),
                                      *interop.to_torch(extra)))
    assert interop.state_layout(out) == "blockdiag"
    iso = list(init)
    for i in (2, 3, 5, 9, 10, 12):
        iso[i] = np.zeros((5, 5, 4), np.float32)
    iso[6] = iso[16] = np.zeros((1, 4), np.float32)
    assert interop.state_layout(tuple(iso)) == "isotropic"
    bad = list(init)
    bad[6] = np.zeros((1, 4), np.float32)  # a (1, B) scale row on (n, n, d, B) factors
    with pytest.raises(ValueError, match="layout"):
        interop.state_to_torch(tuple(bad))
