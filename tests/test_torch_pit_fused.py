"""Port differential tests of ``pit_fused`` (the lanes-last sqrt combine, the
Kogge-Stone prefix, the element build and the window marginals) and of the
plain version of kernel K8 against the JAX reference.

Random elements are made with numpy from a seed and handed to both packages.
In f64 A, b and eta must agree to atol 1e-11 (1e-9 through a prefix, whose
levels compound the rounding); U and Z are compared through their Grams (the
QRs fix no column signs).  K8's plain version is held against the
reference's ``engine="pallas"`` in interpret mode in f32 at atol 1e-3, the
reference's own gate for that engine
(``tests/test_pit_fused.py::test_prefix_scan_pallas_interpret_matches_xla``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import parallel_time as jpt
from odecheckpts_tpu import pit_fused as jpf
from odecheckpts_torch import interop, kernels
from odecheckpts_torch import parallel_time as tpt
from odecheckpts_torch import pit_fused as tpf


def _random_elements(seed, p, m, c, dtype=np.float64):
    """p arbitrary sqrt elements, step-leading (the combine is defined for
    any factors: its Grams I + M M^T are always invertible)."""
    rng = np.random.default_rng(seed)
    shapes = ((p, m, m), (p, m, c), (p, m, m), (p, m, c), (p, m, m))
    return tuple(rng.standard_normal(s).astype(dtype) for s in shapes)


def _gram(x):
    return np.einsum("...ik,...jk->...ij", x, x)


def _assert_elements_match(got, want, atol):
    """A, b, eta entry by entry; U, Z through their Grams."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    for idx in (0, 1, 3):
        np.testing.assert_allclose(got[idx], want[idx], rtol=0, atol=atol)
    for idx in (2, 4):
        np.testing.assert_allclose(_gram(got[idx]), _gram(want[idx]), rtol=0, atol=atol)


def _jll(els):
    return tuple(jnp.moveaxis(jnp.asarray(e), 0, -1) for e in els)


def _jfrom_ll(els):
    return tuple(np.moveaxis(np.asarray(e), -1, 0) for e in els)


@pytest.mark.parametrize("m,c", [(4, 3), (5, 1), (3, 2)])
def test_combine_sqrt_ll_matches_reference(m, c):
    e_i, e_j = _random_elements(0, 7, m, c), _random_elements(1, 7, m, c)
    want = _jfrom_ll(jpf.combine_sqrt_ll(_jll(e_i), _jll(e_j)))
    got = interop.elements_to_numpy(
        tpf.combine_sqrt_ll(interop.elements_to_torch(e_i, lanes_last=True),
                            interop.elements_to_torch(e_j, lanes_last=True)),
        lanes_last=True)
    _assert_elements_match(got, want, atol=1e-11)
    # and the step-leading combine of parallel_time, batched over the steps
    got_steps = interop.elements_to_numpy(
        tpt._combine_sqrt(interop.elements_to_torch(e_i), interop.elements_to_torch(e_j)))
    want_steps = jax.vmap(jpt._combine_sqrt)(tuple(map(jnp.asarray, e_i)),
                                             tuple(map(jnp.asarray, e_j)))
    _assert_elements_match(got_steps, want_steps, atol=1e-11)


@pytest.mark.parametrize("p", [1, 2, 5, 11])
def test_prefix_scan_sqrt_matches_reference(p):
    els = _random_elements(10 + p, p, 3, 1)
    want = jpf.prefix_scan_sqrt(tuple(map(jnp.asarray, els)), engine="xla")
    got = interop.elements_to_numpy(tpf.prefix_scan_sqrt(interop.elements_to_torch(els)))
    _assert_elements_match(got, want, atol=1e-9)
    # the Kogge-Stone prefix equals the odd / even scan of step-leading elements
    scan = interop.elements_to_numpy(
        tpt._associative_scan(tpt._combine_sqrt, interop.elements_to_torch(els)))
    _assert_elements_match(scan, want, atol=1e-9)


def test_identity_element_is_neutral():
    els = _random_elements(3, 5, 4, 2)
    ident = tpf.identity_element_ll(4, 2, 5, torch.float64)
    for got, want in zip(ident, jpf.identity_element_ll(4, 2, 5, jnp.float64)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    els_ll = interop.elements_to_torch(els, lanes_last=True)
    left = interop.elements_to_numpy(tpf.combine_sqrt_ll(ident, els_ll), lanes_last=True)
    right = interop.elements_to_numpy(tpf.combine_sqrt_ll(els_ll, ident), lanes_last=True)
    _assert_elements_match(left, els, atol=1e-12)
    _assert_elements_match(right, els, atol=1e-12)


def _build_inputs(seed, p, m, r, c):
    rng = np.random.default_rng(seed)
    phi = np.triu(rng.standard_normal((m, m, p))) + np.eye(m)[..., None]
    qc = np.tril(rng.standard_normal((m, m, p)), 0) * 0.3 + np.eye(m)[..., None]
    h = rng.standard_normal((r, m, p))
    v = rng.standard_normal((r, c, p))
    drift = rng.standard_normal((m, c, p))
    return phi, qc, h, v, drift


@pytest.mark.parametrize("with_drift", [False, True])
def test_element_sqrt_ll_matches_reference(with_drift):
    phi, qc, h, v, drift = _build_inputs(20, 6, 4, 1, 3)
    if not with_drift:
        drift = None
    want = jpf.element_sqrt_ll(*(None if x is None else jnp.asarray(x)
                                 for x in (phi, qc, h, v, drift)))
    got = tpf.element_sqrt_ll(*(None if x is None else torch.tensor(x)
                                for x in (phi, qc, h, v, drift)))
    _assert_elements_match(_jfrom_ll(tuple(g.numpy() for g in got)), _jfrom_ll(want), atol=1e-11)
    # the step-leading build of parallel_time gives the same elements
    steps = tpt._element_sqrt(*(None if x is None else torch.movedim(torch.tensor(x), -1, 0)
                                for x in (phi, qc, h, v, drift)))
    _assert_elements_match(interop.elements_to_numpy(steps), _jfrom_ll(want), atol=1e-11)


def test_marginal_sqrt_ll_matches_reference():
    els = _random_elements(30, 6, 4, 3)
    rng = np.random.default_rng(31)
    m0c, w0 = rng.standard_normal((4, 3)), np.tril(rng.standard_normal((4, 4)))
    jmean, jchol = jpf.marginal_sqrt_ll(_jll(els), jnp.asarray(m0c), jnp.asarray(w0))
    tmean, tchol = tpf.marginal_sqrt_ll(interop.elements_to_torch(els, lanes_last=True),
                                        torch.tensor(m0c), torch.tensor(w0))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=0, atol=1e-11)
    np.testing.assert_allclose(_gram(np.moveaxis(tchol.numpy(), -1, 0)),
                               _gram(np.moveaxis(np.asarray(jchol), -1, 0)), rtol=0, atol=1e-11)
    smean, schol = tpt._marginal_from_prefix_sqrt(interop.elements_to_torch(els),
                                                  torch.tensor(m0c), torch.tensor(w0))
    np.testing.assert_allclose(smean.numpy(), np.moveaxis(np.asarray(jmean), -1, 0),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(_gram(schol.numpy()),
                               _gram(np.moveaxis(np.asarray(jchol), -1, 0)), rtol=0, atol=1e-11)


def test_pit_combine_plain_matches_the_pallas_engine_in_interpret_mode():
    # f32: the interpreted Mosaic kernel and the plain version order the QR
    # and solve reductions differently, so O(1) random elements agree to a few
    # hundred ulp (the reference's own gate, atol 1e-3)
    els = _random_elements(7, 5, 3, 1, np.float32)
    want = jpf.prefix_scan_sqrt(tuple(map(jnp.asarray, els)), engine="pallas", interpret=True)
    els_ll = interop.elements_to_torch(els, lanes_last=True)
    ident = tpf.identity_element_ll(3, 1, 5, torch.float32)
    pre, s = els_ll, 1
    while s < 5:  # the Kogge-Stone levels on the wrapper of K8 (its plain version on the CPU)
        shifted = tuple(torch.cat([i[..., :s], x[..., : 5 - s]], dim=-1)
                        for x, i in zip(pre, ident))
        new = kernels.pit_combine(shifted, pre)
        keep = torch.arange(5) >= s
        pre = tuple(torch.where(keep, n, o) for n, o in zip(new, pre))
        s *= 2
    assert pre[0].dtype == torch.float32
    _assert_elements_match(interop.elements_to_numpy(pre, lanes_last=True), want, atol=1e-3)
    same = tpf.prefix_scan_sqrt_ll(els_ll, engine="torch")
    for a, b in zip(pre, same):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_combine_sqrt_ll_takes_a_block_axis_between_matrix_and_lanes():
    nb, p, m, c = 3, 5, 4, 1
    e_i, e_j = _random_elements(40, nb * p, m, c), _random_elements(41, nb * p, m, c)

    def blocked(els):  # (nb p, m, r) -> (m, r, nb, p)
        return tuple(torch.tensor(e).reshape(nb, p, m, -1).permute(2, 3, 0, 1).contiguous()
                     for e in els)

    got = tpf.combine_sqrt_ll(blocked(e_i), blocked(e_j))
    flat = tuple(g.permute(2, 3, 0, 1).reshape(nb * p, m, -1).numpy() for g in got)
    want = interop.elements_to_numpy(
        tpf.combine_sqrt_ll(interop.elements_to_torch(e_i, lanes_last=True),
                            interop.elements_to_torch(e_j, lanes_last=True)), lanes_last=True)
    for g, w in zip(flat, want):
        np.testing.assert_array_equal(g, w)
    ident = tpf.identity_element_ll(m, c, p, torch.float64, extra=(nb,))
    assert ident[0].shape == (m, m, nb, p) and ident[1].shape == (m, c, nb, p)


def test_the_cuda_engine_raises_without_a_card_and_the_wrapper_counts_no_launch():
    els_ll = interop.elements_to_torch(_random_elements(50, 4, 4, 3), lanes_last=True)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tpf.prefix_scan_sqrt_ll(els_ll, engine="cuda")
    with pytest.raises(ValueError, match="engine"):
        tpf.prefix_scan_sqrt_ll(els_ll, engine="pallas")
    before = kernels.LAUNCHES["pit_combine"]
    got = kernels.pit_combine(els_ll, els_ll)  # CPU tensors: the plain version
    assert kernels.LAUNCHES["pit_combine"] == before
    for g, w in zip(got, kernels.pit_combine_plain(els_ll, els_ll)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    meta = tuple(x.to("meta") for x in els_ll)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pit_combine(meta, meta)
    with pytest.raises(ValueError, match="five arrays"):
        kernels.pit_combine(els_ll[:4], els_ll)


def test_associative_scan_keeps_the_reference_combine_order():
    # composition of affine maps x -> a x + b, elementwise and sensitive to the
    # order of combination: the same odd / even recursion gives the bits of
    # jax.lax.associative_scan (run op by op, so nothing is contracted)
    rng = np.random.default_rng(60)

    def compose(earlier, later):
        return later[0] * earlier[0], later[0] * earlier[1] + later[1]

    for num in (1, 2, 3, 8, 13):
        a, b = rng.standard_normal((num, 4)), rng.standard_normal((num, 4))
        with jax.disable_jit():
            want = jax.lax.associative_scan(compose, (jnp.asarray(a), jnp.asarray(b)))
        got = tpt._associative_scan(compose, (torch.tensor(a), torch.tensor(b)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        acc_a, acc_b, seq = a[0], b[0], [(a[0], b[0])]
        for k in range(1, num):
            acc_a, acc_b = a[k] * acc_a, a[k] * acc_b + b[k]
            seq.append((acc_a, acc_b))
        np.testing.assert_allclose(got[1].numpy(), np.stack([x[1] for x in seq]),
                                   rtol=1e-10, atol=1e-12)
