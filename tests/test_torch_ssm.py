"""Port differential tests: isotropic SSM, checkpoint interpolation and the
smoothing pass against the JAX reference, in f64 at rtol 1e-12.

The reference maps one IVP at a time (``jax.vmap``); the port broadcasts
over a leading batch dimension, and ``jax.lax.cond`` under vmap becomes a
per-lane ``torch.where`` over both branches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import ivpsolve as jivpsolve
from odecheckpts_tpu import ssm as jssm_mod
from odecheckpts_tpu import ivpsolvers as jsolvers
from odecheckpts_tpu import stats as jstats
from odecheckpts_tpu.ssm.base import Conditional as JCond
from odecheckpts_tpu.ssm.base import MarkovSeq as JSeq
from odecheckpts_tpu.ssm.base import Normal as JNormal
from odecheckpts_torch import interop
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import ssm as tssm_mod
from odecheckpts_torch import stats as tstats
from odecheckpts_torch.ssm.base import Conditional as TCond
from odecheckpts_torch.ssm.base import MarkovSeq as TSeq
from odecheckpts_torch.ssm.base import Normal as TNormal

NU, D, B = 4, 3, 6
N = NU + 1


def _ssms():
    j = jsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,))
    t = tsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,))
    return j, t


def _close(got, want):
    for g, w in zip(jax.tree.leaves(interop.to_numpy(tuple(got))), jax.tree.leaves(tuple(want))):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12 * np.max(np.abs(w)))


def _normal(rng, lead=(B,)):
    return (rng.standard_normal(lead + (N, D)), np.tril(rng.standard_normal(lead + (N, N))))


def _cond(rng, lead=(B,)):
    mat = np.triu(rng.standard_normal(lead + (N, N))) + np.eye(N)
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
def test_extrapolate_direct_matches_jax(reversal):
    jssm, tssm = _ssms()
    rng = np.random.default_rng(0)
    rv = _normal(rng)
    dt = rng.uniform(1e-3, 1.0, B)
    scale = rng.uniform(0.1, 3.0, B)
    want = jax.vmap(lambda r, d, s: jssm.extrapolate_direct(r, d, s, reversal))(
        _jn(rv), jnp.asarray(dt), jnp.asarray(scale))
    got = tssm.extrapolate_direct(_tn(rv), torch.tensor(dt), torch.tensor(scale), reversal)
    _close(got[0], want[0])
    if reversal:
        _close(got[1], want[1])
    else:
        assert got[1] is None


@pytest.mark.parametrize("op", ["marginalize", "compose"])
def test_marginalize_and_compose_match_jax(op):
    jssm, tssm = _ssms()
    rng = np.random.default_rng(1)
    cond = _cond(rng)
    if op == "marginalize":
        other = _normal(rng)
        want = jax.vmap(jssm.marginalize)(_jn(other), _jc(cond))
        got = tssm.marginalize(_tn(other), _tc(cond))
    else:
        other = _cond(rng)
        want = jax.vmap(jssm.compose)(_jc(cond), _jc(other))
        got = tssm.compose(_tc(cond), _tc(other))
    _close(got, want)


def _states(rng, t_ckpt):
    """Lane 0 sits exactly on the checkpoint (the `exact` branch); lane 1
    lands within the snap threshold; the rest interpolate."""
    t = t_ckpt + rng.uniform(0.05, 0.5, B)
    t[0] = t_ckpt
    t_prev = t_ckpt - rng.uniform(0.05, 0.5, B)
    t_prev[1] = t_ckpt - 1e-14
    fields = dict(
        t=t, rv=_normal(rng), bwd=_cond(rng), scale_step=rng.uniform(0.1, 3.0, B),
        t_prev=t_prev, rv_prev=_normal(rng), bwd_prev=_cond(rng),
        dt=rng.uniform(0.01, 0.1, B), errn_prev=rng.uniform(0.1, 1.0, B),
        num_steps=np.arange(B, dtype=np.int32), mle_ssq=rng.uniform(0, 1, B),
    )
    wrap_j = {"rv": _jn, "rv_prev": _jn, "bwd": _jc, "bwd_prev": _jc}
    wrap_t = {"rv": _tn, "rv_prev": _tn, "bwd": _tc, "bwd_prev": _tc}
    js = jivpsolve._State(**{k: wrap_j.get(k, jnp.asarray)(v) for k, v in fields.items()})
    ts = tivpsolve._State(**{k: wrap_t.get(k, torch.tensor)(v) for k, v in fields.items()})
    return js, ts


def test_interpolate_at_matches_jax_on_both_branches():
    jssm, tssm = _ssms()
    jstrat = jsolvers.strategy_fixedpoint(jssm, jsolvers.correction_ts0())
    tstrat = tsolvers.strategy_fixedpoint(tssm, tsolvers.correction_ts0())
    rng = np.random.default_rng(2)
    t_ckpt = 2.5
    js, ts = _states(rng, t_ckpt)
    want = jax.vmap(lambda s: jivpsolve._interpolate_at(jstrat, s, t_ckpt))(js)
    got = tivpsolve._interpolate_at(tstrat, ts, t_ckpt)
    _close(got[0], want[0])  # the emitted marginal and conditional
    _close(got[1], want[1])  # the rewired state


def test_markov_marginals_matches_jax():
    jssm, tssm = _ssms()
    rng = np.random.default_rng(3)
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
    assert got.mean.shape == (steps, B, N, D)
    _close(got, want)


@pytest.mark.parametrize("steps", [5, 6])
@pytest.mark.parametrize("parallel", [False, True])
def test_markov_marginals_keywords_match_jax(parallel, steps):
    """``reverse`` and ``parallel`` as in the reference: the associative scan
    over conditional composition gives the reference's marginals in f64, on
    an odd and an even number of conditionals."""
    jssm, tssm = _ssms()
    rng = np.random.default_rng(5)
    init = _normal(rng, (steps + 1, B))
    conds = _cond(rng, (steps + 1, B))
    jseq = JSeq(_jn(init), _jc(conds), ssm=jssm)
    want = jax.vmap(
        lambda s: jstats.markov_marginals(jstats.markov_select_terminal(s), parallel=parallel),
        in_axes=(JSeq(JNormal(1, 1), JCond(1, JNormal(1, 1)), ssm=jssm),), out_axes=1,
    )(jseq)
    tseq = tstats.markov_select_terminal(TSeq(_tn(init), _tc(conds), ssm=tssm))
    got = tstats.markov_marginals(tseq, reverse=True, parallel=parallel)
    assert got.mean.shape == (steps, B, N, D)
    _close(got, want)
    with pytest.raises(NotImplementedError, match="forward-time"):
        tstats.markov_marginals(tseq, reverse=False, parallel=parallel)


def test_choose_scalar_is_the_blockdiag_backend_as_in_the_reference():
    got = tssm_mod.choose("scalar", ode_shape=(1,), num_derivatives=NU)
    want = jssm_mod.choose("scalar", ode_shape=(1,), num_derivatives=NU)
    assert type(got).__name__ == type(want).__name__ == "BlockDiagSSM"
    assert isinstance(got, tssm_mod.BlockDiagSSM)
    assert (got.n, got.d) == (N, 1)
    with pytest.raises(ValueError, match="available"):
        tssm_mod.choose("diagonal", ode_shape=(1,), num_derivatives=NU)
