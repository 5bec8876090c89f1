"""Port differential tests: prior and Taylor init against the JAX reference.

IBM constants must be equal exactly; preconditioner and phi_direct within
1e-14; Taylor coefficients (nested forward-mode derivatives in the port,
``jet`` in the reference) within rtol 1e-12 in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import prior as jprior
from odecheckpts_tpu import problems as jproblems
from odecheckpts_tpu import taylor as jtaylor
from odecheckpts_torch import prior as tprior
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import taylor as ttaylor

NUS = [2, 3, 4, 5]


@pytest.mark.parametrize("nu", NUS)
def test_ibm_constants_equal_exactly(nu):
    for got, want in zip(tprior._ibm_constants_f64(nu), jprior._ibm_constants_f64(nu)):
        np.testing.assert_array_equal(got, want)
    a_t, lq_t = tprior.system_matrices(nu, dtype=torch.float64)
    a_j, lq_j = jprior.system_matrices(nu, jnp.float64)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(lq_t.numpy(), np.asarray(lq_j))


@pytest.mark.parametrize("nu", NUS)
def test_preconditioner_and_phi_direct_match_jax(nu):
    dts = np.geomspace(1e-6, 3.0, 7)
    p_t, pinv_t = tprior.preconditioner(torch.tensor(dts), nu)
    phi_t = tprior.phi_direct(torch.tensor(dts), nu)
    for k, dt in enumerate(dts):
        p_j, pinv_j = jprior.preconditioner(jnp.asarray(dt), nu)
        phi_j = jprior.phi_direct(jnp.asarray(dt), nu)
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j), rtol=1e-14, atol=0)
        np.testing.assert_allclose(pinv_t[k].numpy(), np.asarray(pinv_j), rtol=1e-14, atol=0)
        np.testing.assert_allclose(phi_t[k].numpy(), np.asarray(phi_j), rtol=1e-14, atol=0)


def _logistic_torch(u, *, t, p):
    a, k = p
    return a * u * (1.0 - u / k)


@pytest.mark.parametrize("problem", ["rigid_body", "logistic"])
def test_odejet_padded_scan_matches_jet(problem):
    rng = np.random.default_rng(3)
    num = 4
    if problem == "rigid_body":
        jvf, (u0,), _, params = jproblems.rigid_body()
        tvf = tproblems.rigid_body()[0]
        inits = np.asarray(u0)[:, None] * (1 + 0.05 * rng.standard_normal((3, 6)))
    else:
        jvf, (u0,), _, params = jproblems.logistic()
        tvf = _logistic_torch
        inits = rng.uniform(0.05, 0.9, size=(1, 6))
    # the reference maps one IVP at a time; the port takes (d, B) at once
    want = jax.vmap(
        lambda u: jnp.stack(jtaylor.odejet_padded_scan(
            lambda y: jvf(y, t=0.0, p=params), (u,), num=num)),
        in_axes=1, out_axes=-1,
    )(jnp.asarray(inits))
    got = ttaylor.odejet_padded_scan(
        lambda y: tvf(y, t=0.0, p=params), (torch.tensor(inits),), num=num
    )
    assert len(got) == num + 1
    np.testing.assert_allclose(
        torch.stack(got).numpy(), np.asarray(want), rtol=1e-12,
        atol=1e-12 * np.max(np.abs(np.asarray(want))),
    )
