"""Port differential tests of the second-order and stiff scalar slice: the
problems ``three_body_restricted``, ``pleiades_2nd``, ``pleiades_1st`` and
``van_der_pol``, Taylor init with two initial arrays, the generic adaptive
save_at with ``ode_order=2`` (TS0 isotropic, TS1 dense), the fused f32 twin
(``batched.StepLL``: ``ode_order=2``, TS1 at d = 1, the filter strategy, the
residual error unit) and the df32 twin (``batched_hi.StepHi``, the same
branches), the bucketed solver on tuple state and the facade, each against
the JAX reference on the same numpy inputs.

Tolerances and why:

* Vector fields: float64, rtol 1e-14 (the Pleiades' ``** 1.5`` is a libm
  power in each package; the others are the same operations).
* Taylor coefficients with two initial arrays (nested ``torch.func.jvp``
  against JAX's ``jet``): float64, rtol 1e-12 of each coefficient's scale.
* One attempt in float32, op by op (``jax.disable_jit``): every array equal
  bit for bit but the next step (XLA's CPU f32 ``exp`` / ``log``, within 4
  ulp) and factor entries whose squares XLA flushes as subnormal (within an
  ulp of the lane's largest entry).
* Whole solves in float64 (generic, fused twins, df32 twin in f64 pairs,
  facade): per-lane step counts equal and values within rtol 1e-10.  The
  tolerances and spans are those at which both packages are well
  conditioned: the reference's float64 ``exp`` is XLA's own approximation
  (it differs from libm's, and from PyTorch's, on about 14% of arguments),
  so the PI controllers' next steps differ by an ulp now and then, and
  where the step sequence is sensitive that moves step counts.  The
  reference moves as far against itself: on Van der Pol at mu = 10 over
  (0, 2) its own step counts change under a one-ulp change of u0 at tol
  <= 4e-6 (239 -> 238, 310 -> 312, 413 -> 406 at tol 2.5e-6..1e-7), and
  the port's differ from it by 1-4 steps at tol 1e-5..1e-8 on the
  three-body problem over (0, 5) and on Van der Pol over (0, 2).
* Bucketing and the engines on CPU tensors: bit for bit (the same arithmetic,
  lanes independent).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import batched as jb
from odecheckpts_tpu import batched_hi as jhi
from odecheckpts_tpu import facade as jfacade
from odecheckpts_tpu import ivpsolve as jivpsolve
from odecheckpts_tpu import ivpsolvers as jsolvers
from odecheckpts_tpu import problems as jp
from odecheckpts_tpu import taylor as jtaylor
from odecheckpts_torch import batched as tb
from odecheckpts_torch import batched_hi as th
from odecheckpts_torch import facade as tfacade
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import problems as tp
from odecheckpts_torch import taylor as ttaylor

INPUT_NAMES = ("atol", "rtol", "dt_max", "dt_floor", "tiny_scale")
CHOL, DT = 2, 13  # indices in the 17-array state (batched.NUM_STATE)
F32_ULPS = 4
MU = 10.0
RTOL = 1e-10


def _problems(name):
    """(JAX vf, port vf, JAX initial tuple) of a second-order problem."""
    if name == "van_der_pol":
        (jvf, u0, _), (tvf, _, _) = jp.van_der_pol(MU), tp.van_der_pol(MU)
    elif name == "three_body":
        (jvf, u0, _), (tvf, _, _) = jp.three_body_restricted(), tp.three_body_restricted()
    else:
        (jvf, u0, _), (tvf, _, _) = jp.pleiades_2nd(), tp.pleiades_2nd()
    return jvf, tvf, tuple(np.asarray(u, np.float64) for u in u0)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("name", ["three_body", "pleiades_2nd", "pleiades_1st", "van_der_pol"])
def test_vector_fields_match_jax(name):
    rng = np.random.default_rng(0)
    if name == "pleiades_1st":
        (jvf, (u0,), _, _), (tvf, (tu0,), _, _) = jp.pleiades_1st(), tp.pleiades_1st()
        assert np.array_equal(tu0.numpy(), np.asarray(u0))
        y = np.asarray(u0) * (1.0 + 0.1 * rng.standard_normal(u0.shape))
        _close(tvf(torch.tensor(y), t=0.0).numpy(), jvf(jnp.asarray(y), t=0.0), 1e-14)
        return
    jvf, tvf, u0 = _problems(name)
    port_u0 = {"three_body": tp.three_body_restricted, "pleiades_2nd": tp.pleiades_2nd,
               "van_der_pol": tp.van_der_pol}[name]()[1]
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(port_u0, u0))
    args = [u[:, None] * (1.0 + 0.1 * rng.standard_normal((u.shape[0], 5))) + 0.01
            * rng.standard_normal((u.shape[0], 5)) for u in u0]
    want = np.stack([np.asarray(jvf(*(jnp.asarray(a[:, i]) for a in args), t=0.0))
                     for i in range(5)], axis=-1)
    # row-wise: the port takes the (d, 5) lanes-last ensemble in one call
    got = tvf(*(torch.tensor(a) for a in args), t=0.0).numpy()
    _close(got, want, 1e-14)


@pytest.mark.parametrize("entry", ["odejet_unroll", "odejet_padded_scan"])
@pytest.mark.parametrize("name", ["van_der_pol", "three_body"])
def test_taylor_two_inits_match_jax(name, entry):
    jvf, tvf, u0 = _problems(name)
    num = 4 + 1 - 2
    want = getattr(jtaylor, entry)(lambda *y: jvf(*y, t=0.0), tuple(map(jnp.asarray, u0)),
                                   num=num)
    got = getattr(ttaylor, entry)(lambda *y: tvf(*y, t=0.0), tuple(map(torch.tensor, u0)),
                                  num=num)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-12)


# -- the generic adaptive save_at (the oracle of the fused engines) -----------

GENERIC = {  # name -> (implementation, correction, strategy, tol, save_at, dt0)
    "three_body": ("isotropic", "ts0", "fixedpoint", 1e-5, np.linspace(0.0, 5.0, 4), 0.01),
    "van_der_pol": ("dense", "ts1", "filter", 1e-4, np.linspace(0.0, 2.0, 4), 0.01),
    "pleiades": ("isotropic", "ts0", "fixedpoint", 1e-5, np.linspace(0.0, 3.0, 4), 0.01),
}


def _generic_solver(lib, name, nu=4):
    impl, corr, strat, tol, _, _ = GENERIC[name]
    d = {"three_body": 2, "van_der_pol": 1, "pleiades": 14}[name]
    prior = lib.prior_ibm(num_derivatives=nu, ode_shape=(d,), implementation=impl)
    correction = getattr(lib, f"correction_{corr}")(ode_order=2)
    return lib.solver_dynamic(getattr(lib, f"strategy_{strat}")(prior, correction))


@pytest.mark.parametrize("name", sorted(GENERIC))
def test_generic_save_at_matches_jax(name):
    """One IVP through ``ivpsolve.solve_adaptive_save_at`` with
    ``ode_order=2`` in each package: equal step counts, values rtol 1e-10."""
    jvf, tvf, u0 = _problems(name)
    *_, tol, save_at, dt0 = GENERIC[name]
    nu = 4

    jsolver = _generic_solver(jsolvers, name, nu)

    @jax.jit
    def jsolve():
        tc = jtaylor.odejet_padded_scan(lambda *y: jvf(*y, t=0.0), tuple(map(jnp.asarray, u0)),
                                        num=nu - 1)
        init = jsolver.initial_condition(tc, 1.0)
        sol = jivpsolve.solve_adaptive_save_at(
            jvf, init, save_at=jnp.asarray(save_at), dt0=dt0,
            adaptive_solver=jivpsolve.adaptive(jsolver, atol=1e-3 * tol, rtol=tol))
        return sol.u, sol.num_steps

    tsolver = _generic_solver(tsolvers, name, nu)
    tc = ttaylor.odejet_padded_scan(lambda *y: tvf(*y, t=0.0), tuple(map(torch.tensor, u0)),
                                    num=nu - 1)
    sol = tivpsolve.solve_adaptive_save_at(
        tvf, tsolver.initial_condition(tc, 1.0), save_at=save_at, dt0=dt0,
        adaptive_solver=tivpsolve.adaptive(tsolver, atol=1e-3 * tol, rtol=tol))
    u_j, n_j = jsolve()
    np.testing.assert_array_equal(sol.num_steps.numpy(), np.asarray(n_j))
    _close(sol.u.numpy(), u_j)


# -- the fused f32 twin --------------------------------------------------------

ATTEMPTS = {  # case -> (problem, StepLL options)
    "o2_fixedpoint": ("three_body", dict(strategy="fixedpoint")),
    "o2_filter_residual": ("three_body", dict(strategy="filter", error_unit="residual")),
    "ts1_filter": ("van_der_pol", dict(strategy="filter", correction="ts1")),
    "ts1_fixedpoint_residual": ("van_der_pol", dict(correction="ts1", error_unit="residual")),
}


def _ensemble(name, batch, seed=4):
    """A perturbed (positions, velocities) ensemble from numpy."""
    _, _, u0 = _problems(name)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((batch, u0[0].shape[0]))
    scale = 1e-2 if name == "van_der_pol" else 1e-6
    return (u0[0][None] * (1.0 + scale * noise), u0[1][None] + 0.1 * scale * noise)


def _jax_step(name, options):
    jvf, _, _ = _problems(name)
    d = 1 if name == "van_der_pol" else 2
    return jb.make_step_ll(lambda args, t: jvf(*args, t=t[0]), nu=4, d=d, ode_order=2,
                           **options)


@pytest.mark.parametrize("case", sorted(ATTEMPTS))
def test_one_attempt_matches_jax_op_by_op(case):
    """Float32: the twin's attempt from a mid-interval state (the port's
    Taylor init advanced by 12 of the twin's attempts) equals the
    reference's ``make_step_ll`` run op by op, every array bit for bit but
    two, where the reference's CPU arithmetic is not IEEE float32: the next
    step ``dt`` takes XLA's f32 ``exp`` and ``log`` (approximations; the twin
    takes them correctly rounded, within 4 ulp of each other), and XLA
    flushes subnormal squares in the QR, which moves factor entries far
    below the lane's largest (``chol`` within one ulp of that)."""
    name, options = ATTEMPTS[case]
    _, tvf, _ = _problems(name)
    batch = 16
    u0s = tuple(torch.tensor(u, dtype=torch.float32) for u in _ensemble(name, batch))
    tols = torch.tensor(np.geomspace(1e-2, 1e-5, batch), dtype=torch.float32)
    save_at = np.asarray([0.0, 1.0], np.float32)
    strategy = options.get("strategy", "fixedpoint")
    state, _, inputs = tb.initial_state(tvf, u0s, (), save_at=save_at, dt0=0.01, tols=tols,
                                        strategy=strategy, ode_order=2)
    d = u0s[0].shape[1]
    step = tb.make_step_ll(tvf, (), nu=4, d=d, ode_order=2, dtype=torch.float32, **options)
    extra = (torch.full((1, batch), 1.0),) + tuple(inputs[k] for k in INPUT_NAMES)
    for _ in range(12):
        state = step(state, *extra)
    got = step(state, *extra)
    with jax.disable_jit():
        want = _jax_step(name, options)(tuple(jnp.asarray(x.numpy()) for x in state),
                                        *(jnp.asarray(x.numpy()) for x in extra))
    assert int(torch.sum(got[0] != state[0])) > 0  # some lanes accepted
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if i == DT:  # exp and log: XLA's CPU f32 approximations
            np.testing.assert_allclose(g, w, rtol=F32_ULPS * 2.0**-23, atol=0)
        elif i == CHOL:  # entries whose squares the reference flushes
            lane = np.max(np.abs(w), axis=(0, 1))
            assert np.all(np.abs(g - w) <= 2.0**-23 * lane), f"array {i}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"array {i}")


FUSED = {  # case -> (problem, solve options, save_at, tols)
    "three_body": ("three_body", dict(), np.linspace(0.0, 5.0, 4), [1e-4, 1e-5, 1e-6, 1e-5]),
    "vdp_ts1_filter": ("van_der_pol", dict(correction="ts1", strategy="filter"),
                       np.linspace(0.0, 1.0, 3), [1e-5, 1e-5, 3e-5, 1e-4]),
    "vdp_ts1_filter_residual": ("van_der_pol", dict(correction="ts1", strategy="filter",
                                                    error_unit="residual"),
                                np.linspace(0.0, 1.0, 3), [1e-2, 1e-3, 1e-2, 1e-3]),
}


@functools.lru_cache(maxsize=None)
def _fused_jax(case):
    name, options, save_at, tols = FUSED[case]
    jvf, _, _ = _problems(name)
    u0s = _ensemble(name, len(tols))
    out = jax.jit(lambda u, t: jb.solve_save_at_batched(
        jvf, u, (), save_at=save_at, dt0=0.01, tols=t, engine="xla", ode_order=2,
        **options))(tuple(map(jnp.asarray, u0s)), jnp.asarray(tols))
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_twin_matches_jax_xla_engine(case):
    """Float64: ``solve_save_at_batched(engine="torch")`` against the
    reference's ``engine="xla"`` (the same lanes-last step without Pallas):
    equal per-lane step counts, smoothed and filtered values rtol 1e-10."""
    name, options, save_at, tols = FUSED[case]
    _, tvf, _ = _problems(name)
    u0s = tuple(map(torch.tensor, _ensemble(name, len(tols))))
    u_s, u_f, n = tb.solve_save_at_batched(tvf, u0s, (), save_at=save_at, dt0=0.01,
                                           tols=torch.tensor(tols), engine="torch",
                                           ode_order=2, **options)
    j_s, j_f, j_n = _fused_jax(case)
    np.testing.assert_array_equal(n.numpy(), j_n)
    _close(u_s.numpy(), j_s)
    _close(u_f.numpy(), j_f)
    if options.get("strategy") == "filter":
        assert torch.equal(u_s, u_f)


def test_engines_and_buckets_on_tuple_state_agree():
    """The engines on CPU tensors run the same twin, and
    ``make_bucketed_solver`` on (positions, velocities) gives the unbucketed
    per-lane results bit for bit (``tests/test_batched.py:309, 334``)."""
    name, options, save_at, _ = FUSED["vdp_ts1_filter"]
    _, tvf, _ = _problems(name)
    tols = torch.tensor([1e-4, 1e-5, 1e-3, 3e-5, 1e-4, 1e-3], dtype=torch.float64)
    u0s = tuple(map(torch.tensor, _ensemble(name, 6, seed=7)))
    kw = dict(save_at=save_at[:3], dt0=0.01, ode_order=2, **options)
    ref = tb.solve_save_at_batched(tvf, u0s, (), tols=tols, engine="torch", **kw)
    for engine in ("cuda-loop", "cuda"):
        out = tb.solve_save_at_batched(tvf, u0s, (), tols=tols, engine=engine, **kw)
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), engine
    (u_b, uf_b, n_b), bucket_max = tb.solve_save_at_bucketed(tvf, u0s, (), tols=tols,
                                                            num_buckets=4, **kw)
    assert torch.equal(u_b, ref[0]) and torch.equal(uf_b, ref[1]) and torch.equal(n_b, ref[2])
    assert len(bucket_max) == 4
    with pytest.raises(ValueError, match="2 initial arrays"):
        tb.solve_save_at_batched(tvf, u0s[0], (), tols=tols, **kw)


# -- the df32 twin -------------------------------------------------------------

HI = {  # case -> (problem, options, save_at, tols)
    "three_body": ("three_body", dict(), np.linspace(0.0, 2.0, 3), [1e-5, 1e-6, 1e-5, 1e-6]),
    # tests/test_batched_hi.py:214: mu = 10, TS1 filter
    "vdp_ts1_filter": ("van_der_pol", dict(correction="ts1", strategy="filter"),
                       np.linspace(0.0, 1.0, 3), [1e-5, 1e-5, 3e-5, 1e-4]),
    "vdp_ts1_residual": ("van_der_pol", dict(correction="ts1", error_unit="residual"),
                         np.linspace(0.0, 0.6, 3), [1e-2, 1e-3, 1e-2, 1e-3]),
}


@pytest.mark.parametrize("case", sorted(HI))
def test_hi_twin_matches_jax_in_f64_pairs(case):
    """``make_hi_solver(dtype=float64)`` (the df32 algorithm on f64 pairs,
    the reference's oracle mode) with ``ode_order=2``: equal per-lane step
    counts, pair-combined values rtol 1e-10."""
    name, options, save_at, tols = HI[case]
    jvf, tvf, _ = _problems(name)
    u0s = _ensemble(name, len(tols))
    jsolve = jhi.make_hi_solver(jvf, (), save_at=save_at, dt0=0.01, engine="xla",
                                dtype=jnp.float64, ode_order=2, **options)
    j_s, j_f, j_n = jsolve(u0s, np.asarray(tols))
    tsolve = th.make_hi_solver(tvf, (), save_at=save_at, dt0=0.01, engine="torch",
                               dtype=torch.float64, ode_order=2, **options)
    t_s, t_f, t_n = tsolve(tuple(map(torch.tensor, u0s)), torch.tensor(tols))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    _close(th.combine64(t_s).numpy(), jhi.combine64(j_s))
    _close(th.combine64(t_f).numpy(), jhi.combine64(j_f))


def test_hi_taylor_init_and_functor_names():
    """``_taylor_init_f64(ode_order=2)`` against the reference's (rtol
    1e-14), and ``wrap_vf_plain`` names the hi-channel functor of a vector
    field that has one."""
    jvf, tvf, _ = _problems("three_body")
    u0s = _ensemble("three_body", 3)
    j_hi, j_lo = jhi._taylor_init_f64(jvf, u0s, (), 0.0, nu=4, ode_order=2)
    t_hi, t_lo = th._taylor_init_f64(tvf, tuple(map(torch.tensor, u0s)), (), 0.0, nu=4,
                                     ode_order=2)
    _close(t_hi.double().numpy() + t_lo.double().numpy(),
           j_hi.astype(np.float64) + j_lo.astype(np.float64), 1e-14)
    assert th.wrap_vf_plain(tvf, ()).device_functor == "three_body_restricted_hi"
    vdp = tp.van_der_pol(3.0)[0]
    assert th.wrap_vf_plain(vdp, ()).params == (3.0,)
    assert not hasattr(th.wrap_vf_plain(tp.pleiades_2nd()[0], ()), "device_functor")
    with pytest.raises(NotImplementedError, match="d=1"):
        th.make_step_hi(th.wrap_vf_plain(tvf, ()), nu=4, d=2, correction="ts1")


# -- the facade ----------------------------------------------------------------


def test_facade_second_order_matches_jax():
    """``facade.solve("ts0-4", ode_order=2)`` on the three-body problem and
    ``solve_rk("tsit5", ode_order=2)`` on the Pleiades' first-order
    reduction (the positions of the 28-dim state), float64: values rtol
    1e-10, equal RK step counts."""
    jvf, (u0, du0), _ = jp.three_body_restricted()
    tvf, _, _ = tp.three_body_restricted()
    save_at = np.linspace(0.0, 3.0, 4)
    kw = dict(dt0=0.01, atol=1e-8, rtol=1e-5, ode_order=2)
    want, _ = jax.jit(lambda: jfacade.solve("ts0-4", jvf, u0, jnp.asarray(save_at), **kw)(
        (u0, du0), ()))()
    got, aux = tfacade.solve("ts0-4", tvf, u0, save_at, **kw)(
        (torch.tensor(np.asarray(u0)), torch.tensor(np.asarray(du0))), ())
    _close(got.numpy(), want)
    assert aux["u0_solve"].shape == (4, 2)

    jvf1, (y0,), _, _ = jp.pleiades_1st()
    tvf1, _, _, _ = tp.pleiades_1st()
    save_at = np.linspace(0.0, 1.0, 3)
    kw = dict(dt0=0.01, atol=1e-8, rtol=1e-8, ode_order=2)
    want, jaux = jax.jit(lambda: jfacade.solve_rk("tsit5", jvf1, y0, jnp.asarray(save_at),
                                                  **kw)((y0,), ()))()
    got, aux = tfacade.solve_rk("tsit5", tvf1, y0, save_at, **kw)(
        (torch.tensor(np.asarray(y0)),), ())
    assert got.shape == (3, 14)
    _close(got.numpy(), want)
    assert int(aux["num_steps"]) == int(jaux["num_steps"])
