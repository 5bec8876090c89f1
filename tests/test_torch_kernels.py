"""The K1 kernel wrapper's contract, and K1 against its twin on the card.

This file imports no JAX, so the tests that need the card run where only
the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

On a machine without a CUDA device those tests skip.  Kernel and twin are
compared at rtol 1e-5: both round every f32 operation on its own (the kernel
is built with ``-fmad=false``), so they are expected to agree to a few ulp.
"""

import numpy as np
import pytest
import torch

from odecheckpts_torch import batched, kernels, problems

INPUT_NAMES = ("atol", "rtol", "dt_max", "dt_floor", "tiny_scale")


def _start(nu, *, batch=64, warm_steps=20, device="cpu", kappa=10.0):
    """A mid-solve lanes-last f32 state, advanced by the twin from the Taylor
    init; returns (step, state, t_next, inputs)."""
    rng = np.random.default_rng(5)
    u0s = np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((batch, 3)))
    tols = np.geomspace(1e-1, 1e-5, batch)
    save_at = np.linspace(0.0, 10.0, 5).astype(np.float32)
    vf, _, _, params = problems.rigid_body()
    state, _, inputs = batched.initial_state(
        vf, torch.tensor(u0s, dtype=torch.float32, device=device), params,
        save_at=save_at, dt0=0.1, tols=torch.tensor(tols, dtype=torch.float32, device=device),
        num_derivatives=nu,
    )
    step = batched.make_step_ll(vf, params, nu=nu, d=3, error_calibration=kappa)
    t_next = torch.full((1, batch), float(save_at[1]), device=device)
    for _ in range(warm_steps):
        state = step(state, t_next, *(inputs[k] for k in INPUT_NAMES))
    return step, state, t_next, inputs


def test_wrapper_runs_the_plain_version_on_cpu_and_refuses_other_devices():
    step, state, t_next, inputs = _start(2)
    before = kernels.LAUNCHES["step_ll_interval"]
    got = kernels.step_ll_interval(step, state, t_next, max_attempts=3, **inputs)
    want = kernels.step_ll_interval_plain(step, state, t_next, max_attempts=3, **inputs)
    assert kernels.LAUNCHES["step_ll_interval"] == before  # no kernel ran
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    meta = tuple(x.to("meta") for x in state)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.step_ll_interval(step, meta, t_next.to("meta"), max_attempts=1,
                                 **{k: v.to("meta") for k, v in inputs.items()})


def test_plain_interval_stops_at_the_checkpoint_and_at_the_attempt_cap():
    step, state, t_next, inputs = _start(3, warm_steps=0)
    capped = kernels.step_ll_interval_plain(step, state, t_next, max_attempts=5, **inputs)
    assert float(torch.max(capped[15])) <= 5
    done = kernels.step_ll_interval_plain(step, state, t_next, max_attempts=100_000, **inputs)
    assert bool(torch.all(done[0] >= t_next))
    again = kernels.step_ll_interval_plain(step, done, t_next, max_attempts=100_000, **inputs)
    for g, w in zip(again, done):  # lanes at the checkpoint are frozen
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_packed_constants_match_the_kernel_layout():
    vf, _, _, params = problems.rigid_body()
    step = batched.make_step_ll(vf, params, nu=3, d=3, error_calibration=20.0)
    c = step.packed_constants()
    assert c.dtype == np.float32 and c.shape == (71,)  # sizeof(Consts) / 4
    a, lq = c[:25].reshape(5, 5), c[25:50].reshape(5, 5)
    np.testing.assert_array_equal(a[:4, :4], np.float32(step.a_rows))
    np.testing.assert_array_equal(lq[:4, :4], np.float32(step.lq_rows))
    assert np.all(a[4] == 0) and np.all(lq[:, 4] == 0)
    assert c[63] == np.float32(20.0)  # kappa


def test_parse_ptxas_reads_registers_and_spills_per_nu():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116step_ll_intervalILi4ENS_9RigidBodyEEEvNS_4ArgsE' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_116step_ll_intervalILi4ENS_9RigidBodyEEEvNS_4ArgsE",
        "    544 bytes stack frame, 1060 bytes spill stores, 660 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers, 544 bytes cumulative stack size",
    ])
    assert kernels.parse_ptxas(log) == {
        4: {"stack": 544, "spill_stores": 1060, "spill_loads": 660, "registers": 255}
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("max_attempts", [1, 100_000])
@pytest.mark.parametrize("nu", [2, 3, 4])
def test_kernel_matches_twin_on_the_card(cuda_device, nu, max_attempts):
    step, state, t_next, inputs = _start(nu, batch=1000, device=cuda_device)
    before = kernels.LAUNCHES["step_ll_interval"]
    got = kernels.step_ll_interval(step, state, t_next, max_attempts=max_attempts, **inputs)
    assert kernels.LAUNCHES["step_ll_interval"] == before + 1
    want = kernels.step_ll_interval_plain(step, state, t_next, max_attempts=max_attempts,
                                          **inputs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kernel_wrapper_checks_its_inputs(cuda_device):
    step, state, t_next, inputs = _start(2, batch=256, warm_steps=0, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        kernels.step_ll_interval(step, tuple(x.double() for x in state), t_next.double(),
                                 max_attempts=1, **{k: v.double() for k, v in inputs.items()})
    with pytest.raises(ValueError, match="contiguous"):
        bad = (state[0],) + (state[1].transpose(0, 1).contiguous().transpose(0, 1),) + state[2:]
        kernels.step_ll_interval(step, bad, t_next, max_attempts=1, **inputs)
