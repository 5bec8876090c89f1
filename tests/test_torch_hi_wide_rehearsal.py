"""The block body of K2 wide and K4 wide (``odecheckpts_torch/csrc/
step_hi_wide.cuh``), compiled for the CPU and held against the twin bit for
bit.

The two sources of the wide forms (``step_hi_wide.cu``,
``step_hi_wide_attempt.cu``) are compiled with ``g++ -O1
-ffp-contract=off`` (every operation rounded on its own, as nvcc's
``-fmad=false``) against ``torch_cuda_shim.SHIM``, a stand-in for
``cuda_runtime.h`` (blocks in turn, a block's threads as ``std::thread``s,
barriers and shuffles through ``std::barrier``s, dynamic shared memory a
buffer per block).  The triple-chevron launches are rewritten to the shim's
launch; the sources are otherwise as built for the card.

Each case runs the C entries through ctypes on a few lanes of experiment
4's kind of ensemble (``problems.brusselator(N)`` after the f64 Taylor
init, tolerances 1e-5 to 1e-9 across the lanes) and requires every output
array to equal ``kernels.step_hi_wide_interval_plain`` (40 attempts) or
``kernels.step_hi_wide_attempt_plain`` (one attempt, and 40 chained) bit
for bit.  d = 8 is a block of one warp (the controller shares warp 0), d =
64 one of two.  Skips only where ``g++`` is absent.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cuda_shim as shim

from odecheckpts_torch import batched_hi, kernels, problems

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
SOURCES = ("step_hi_wide.cu", "step_hi_wide_attempt.cu")
LANES = 3
ATTEMPTS = 40


def _with_dynamic_smem(source):
    assert "extern __shared__ float smem[];" in source, "no dynamic shared memory found"
    return source


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    lib = shim.build(CSRC, SOURCES, tmp_path_factory.mktemp("hi_wide_rehearsal"),
                     "hi_wide_rehearsal", edit=_with_dynamic_smem)
    if lib is None:
        pytest.skip("g++ is not on PATH: the CPU rehearsal of the wide block body needs it")
    return lib


def _start(N, nu, batch=LANES):
    """Experiment 4's kind of ensemble after the f64 Taylor init, toward t =
    2.5 (as ``tests/test_torch_kernels.py``'s card cases)."""
    vf, (y0,), _, _ = problems.brusselator(N)
    rng = np.random.default_rng(7)
    y0s = y0.numpy()[None] * (1.0 + 0.01 * rng.standard_normal((batch, 2 * N)))
    tols = torch.tensor(np.geomspace(1e-5, 1e-9, batch), dtype=torch.float32)
    save_at = np.linspace(0.0, 10.0, 5).astype(np.float32)
    state, inputs = batched_hi.initial_state(
        vf, torch.tensor(y0s.astype(np.float32)), (), save_at=save_at, dt0=1e-5, tols=tols,
        num_derivatives=nu)
    step = batched_hi.make_step_hi(batched_hi.wrap_vf_plain(vf, ()), nu=nu, d=2 * N)
    return step, tuple(x.contiguous() for x in state), torch.full((1, batch), 2.5), inputs


def _run(lib, kernel, step, state, t_next, inputs, max_attempts=None):
    """The C entry of ``kernel`` on CPU tensors, packed as
    ``kernels._launch`` packs them."""
    extra = (t_next, inputs["atol"], inputs["rtol"], inputs["dt_max"], inputs["dt_floor"],
             inputs["tiny_scale"])
    ins = [x.contiguous() for x in (*state, *extra)]
    outs = tuple(torch.empty_like(x) for x in state)
    ins_ptr = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    outs_ptr = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    consts = np.ascontiguousarray(step.packed_constants())
    fn = getattr(lib, f"odeckpt_{kernel}_brusselator_hi")
    head = [ctypes.c_int(step.nu), ctypes.c_void_p(ctypes.addressof(ins_ptr)),
            ctypes.c_void_p(ctypes.addressof(outs_ptr)), ctypes.c_void_p(consts.ctypes.data),
            ctypes.c_longlong(state[0].shape[-1]), ctypes.c_int(step.d)]
    if max_attempts is not None:
        head.append(ctypes.c_int(max_attempts))
    (c,) = step.functor_params
    rc = fn(*head, ctypes.c_float(c), ctypes.c_int(0), ctypes.c_void_p(0))
    assert rc == 0
    return outs


def _assert_same_bits(got, want, where):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert same, f"{where}: array {i} differs, max |diff| {float((g - w).abs().max())}"


@pytest.mark.parametrize("nu", [4, 5])
@pytest.mark.parametrize("N", [4, 32])
def test_hi_wide_interval_body_matches_the_twin_bit_for_bit(rehearsal, N, nu):
    """K2 wide's source, 40 attempts a lane, against the twin's loop."""
    step, state, t_next, inputs = _start(N, nu)
    want = kernels.step_hi_wide_interval_plain(step, state, t_next, max_attempts=ATTEMPTS,
                                               **inputs)
    got = _run(rehearsal, "step_hi_wide_interval", step, state, t_next, inputs,
               max_attempts=ATTEMPTS)
    _assert_same_bits(got, want, f"K2 wide, d = {2 * N}, nu = {nu}")
    accepted = (want[11] - state[11])[0]
    assert float(accepted.max()) > 1  # the covariance work ran


@pytest.mark.parametrize("nu", [4, 5])
@pytest.mark.parametrize("N", [4, 32])
def test_hi_wide_attempt_body_matches_the_twin_bit_for_bit(rehearsal, N, nu):
    """K4 wide's source: one attempt, then 40 chained, against the twin's
    attempt."""
    step, state, t_next, inputs = _start(N, nu)
    k_state = p_state = state
    for k in range(ATTEMPTS):
        k_state = _run(rehearsal, "step_hi_wide_attempt", step, k_state, t_next, inputs)
        p_state = kernels.step_hi_wide_attempt_plain(step, p_state, t_next, **inputs)
        _assert_same_bits(k_state, p_state, f"K4 wide, d = {2 * N}, nu = {nu}, attempt {k}")
    assert float((p_state[11] - state[11]).max()) > 1
