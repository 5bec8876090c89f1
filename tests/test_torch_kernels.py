"""The kernel wrappers' contract (K1-K7), and each kernel (K1-K11) against
its twin or plain version on the card.

This file imports no JAX, so the tests that need the card run where only
the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

On a machine without a CUDA device those tests skip.  K1-K8 are held to
their twins or plain versions bit for bit (every operation rounds on its own
in both: the kernels are built with ``-fmad=false``), each launch made twice
and required identical (races show as run-to-run differences).
"""

import numpy as np
import pytest
import torch

from odecheckpts_torch import (batched, batched_blockdiag, batched_dense, batched_hi, kernels,
                               problems)

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
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115step_hi_attemptILi5ENS_11RigidBodyDfEEEvNS_6ArgsHiENS_8ConstsHiET0_l'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_115step_hi_attemptILi5ENS_11RigidBodyDfEEEvNS_6ArgsHiENS_8ConstsHiET0_l",
        "    600 bytes stack frame, 948 bytes spill stores, 1028 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers, 600 bytes cumulative stack size",
    ])
    assert kernels.parse_ptxas(log) == {
        "step_ll_interval": {
            4: {"stack": 544, "spill_stores": 1060, "spill_loads": 660, "registers": 255}},
        "step_hi_attempt": {
            5: {"stack": 600, "spill_stores": 948, "spill_loads": 1028, "registers": 255}},
    }


def _start_hi(nu, *, batch=64, warm_steps=30, device="cpu", vf_df=None):
    """A mid-solve 12-array df32 state toward t = 10, advanced by the twin
    from ``batched_hi.initial_state``; returns (step, state, t_next, inputs)."""
    rng = np.random.default_rng(6)
    u0s = np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((batch, 3)))
    tols = torch.tensor(np.geomspace(1e-5, 1e-9, batch), dtype=torch.float32, device=device)
    vf, _, _, params = problems.rigid_body()
    save_at = np.linspace(0.0, 40.0, 5).astype(np.float32)
    state, inputs = batched_hi.initial_state(vf, torch.tensor(u0s, device=device), params,
                                             save_at=save_at, dt0=0.1, tols=tols,
                                             num_derivatives=nu)
    step = batched_hi.make_step_hi(vf_df or problems.rigid_body_df(), nu=nu, d=3,
                                   error_calibration=5.0)
    t_next = torch.full((1, batch), float(save_at[1]), device=device)
    for _ in range(warm_steps):
        state = kernels.attempt_plain(step, state, t_next, **inputs)
    return step, state, t_next, inputs


@pytest.mark.parametrize("kernel", ["step_ll_attempt", "step_hi_interval", "step_hi_attempt"])
def test_new_wrappers_run_the_plain_version_on_cpu(kernel):
    if kernel == "step_ll_attempt":
        step, state, t_next, inputs = _start(2)
    else:
        step, state, t_next, inputs = _start_hi(4, batch=8, warm_steps=3)
    kw = dict(max_attempts=3) if kernel.endswith("interval") else {}
    before = dict(kernels.LAUNCHES)
    got = getattr(kernels, kernel)(step, state, t_next, **inputs, **kw)
    want = getattr(kernels, kernel + "_plain")(step, state, t_next, **inputs, **kw)
    assert kernels.LAUNCHES == before  # no kernel ran
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_plain_hi_interval_lands_every_lane_on_the_checkpoint():
    step, state, t_next, inputs = _start_hi(4, batch=8, warm_steps=0)
    done = kernels.step_hi_interval_plain(step, state, t_next, max_attempts=100_000, **inputs)
    assert bool(torch.all(done[0] == t_next)) and bool(torch.all(done[1] == 0))
    assert not bool(torch.any(kernels.active_hi(done, t_next)))
    again = kernels.step_hi_interval_plain(step, done, t_next, max_attempts=100_000, **inputs)
    for g, w in zip(again, done):  # lanes at the checkpoint are frozen
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # a hi word on the checkpoint with a negative lo word is still short of it
    short = (t_next.clone(), torch.full_like(t_next, -1e-7)) + done[2:]
    assert bool(torch.all(kernels.active_hi(short, t_next)))


def test_packed_constants_of_the_df32_step_match_the_kernel_layout():
    step = batched_hi.make_step_hi(problems.rigid_body_df(), nu=4, d=3, error_calibration=2.0)
    c = step.packed_constants()
    assert c.dtype == np.float32 and c.shape == (97,)  # sizeof(ConstsHi) / 4
    a, lq = c[:36].reshape(6, 6), c[36:72].reshape(6, 6)
    np.testing.assert_array_equal(a[:5, :5], np.float32(step.a_rows))
    np.testing.assert_array_equal(lq[:5, :5], np.float32(step.lq_rows))
    assert np.all(a[5] == 0) and np.all(lq[:, 5] == 0)
    assert c[87] == np.float32(2.0)  # kappa
    assert c[95] == np.float32(1e-5) and c[96] == np.float32(2.0**-43)  # tiny_frac, stall


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("max_attempts", [1, 100_000])
@pytest.mark.parametrize("nu", [2, 3, 4])
def test_kernel_matches_twin_on_the_card(cuda_device, nu, max_attempts):
    step, state, t_next, inputs = _start(nu, batch=1000, device=cuda_device)
    before = kernels.LAUNCHES["step_ll_interval"]
    got = kernels.step_ll_interval(step, state, t_next, max_attempts=max_attempts, **inputs)
    assert kernels.LAUNCHES["step_ll_interval"] == before + 1
    again = kernels.step_ll_interval(step, state, t_next, max_attempts=max_attempts, **inputs)
    want = kernels.step_ll_interval_plain(step, state, t_next, max_attempts=max_attempts,
                                          **inputs)
    torch.cuda.synchronize()
    _assert_same_bits(got, again, want)


@pytest.mark.cuda
def test_kernel_wrapper_checks_its_inputs(cuda_device):
    step, state, t_next, inputs = _start(2, batch=256, warm_steps=0, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        kernels.step_ll_interval(step, tuple(x.double() for x in state), t_next.double(),
                                 max_attempts=1, **{k: v.double() for k, v in inputs.items()})
    with pytest.raises(ValueError, match="contiguous"):
        bad = (state[0],) + (state[1].transpose(0, 1).contiguous().transpose(0, 1),) + state[2:]
        kernels.step_ll_interval(step, bad, t_next, max_attempts=1, **inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("nu", [2, 4])
def test_attempt_kernel_k3_matches_twin_on_the_card(cuda_device, nu):
    step, state, t_next, inputs = _start(nu, batch=1000, device=cuda_device)
    before = kernels.LAUNCHES["step_ll_attempt"]
    got = kernels.step_ll_attempt(step, state, t_next, **inputs)
    assert kernels.LAUNCHES["step_ll_attempt"] == before + 1
    again = kernels.step_ll_attempt(step, state, t_next, **inputs)
    want = kernels.step_ll_attempt_plain(step, state, t_next, **inputs)
    torch.cuda.synchronize()
    _assert_same_bits(got, again, want)


def _assert_same_bits(first, second, want):
    """Two launches' outputs equal to each other and to the plain version's,
    bit for bit (NaN where NaN)."""
    for a, b, w in zip(first, second, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(a, w, rtol=0, atol=0, equal_nan=True)


def _start_ragged(nu, *, device, functor="rigid_body", special=True, nan_time=False,
                  batch=1001, warm_steps=20):
    """K1's and K3's ragged case: ``batch`` lanes (not a whole number of
    blocks) whose tolerances span rtol 1e-1 to 1e-4, advanced by the twin
    toward the first checkpoint; with ``special``, a NaN lane and two lanes
    at or past the checkpoint, with ``nan_time`` also a lane whose time is
    NaN (neither active nor frozen: the plain interval loop steps it while
    other lanes are active, the kernel's per-lane loop does not,
    csrc/step_ll.cu)."""
    if functor == "rigid_body":
        vf, (y0,), _, params = problems.rigid_body()
    else:
        vf, (y0,), _, params = problems.rigid_body_anisotropic(scale=(1.0, 1.0, 1e4))
    rng = np.random.default_rng(8)
    u0s = y0.numpy()[None] * (1.0 + 0.05 * rng.standard_normal((batch, 3)))
    tols = torch.tensor(np.geomspace(1e-1, 1e-4, batch), dtype=torch.float32, device=device)
    save_at = np.linspace(0.0, 10.0, 5).astype(np.float32)
    state, _, inputs = batched.initial_state(
        vf, torch.tensor(u0s, dtype=torch.float32, device=device), params, save_at=save_at,
        dt0=0.1, tols=tols, num_derivatives=nu)
    step = batched.make_step_ll(vf, params, nu=nu, d=3, error_calibration=3.0)
    t_next = torch.full((1, batch), float(save_at[1]), device=device)
    for _ in range(warm_steps):
        state = kernels.attempt_plain(step, state, t_next, **inputs)
    state = [x.clone() for x in state]
    if not special:
        return step, tuple(state), t_next, inputs
    state[1][:, :, 3] = float("nan")
    if nan_time:
        state[0][:, 7] = float("nan")
    state[0][:, 10] = t_next[:, 10]
    state[0][:, 11] = t_next[:, 11] + 1.0
    return step, tuple(state), t_next, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["step_ll_interval-1", "step_ll_interval-40",
                                    "step_ll_interval-100000", "step_ll_attempt",
                                    "step_ll_interval-40-anisotropic"])
@pytest.mark.parametrize("nu", [2, 3, 4])
def test_f32_kernels_k1_k3_ragged_and_repeatable_on_the_card(cuda_device, nu, kernel):
    """K1 and K3 on 1,001 lanes at rtol 1e-1..1e-4 (lanes of one block end
    their interval at very different attempts), below the whole interval
    with a NaN lane and two lanes at or past the checkpoint (a NaN lane
    would hold the plain version's loop to the cap), K3 also with a lane
    whose time is NaN:
    equal to the plain version bit for bit, and two launches equal to each
    other; K1 also on the anisotropic rigid body, the blockdiag row's
    isotropic foil."""
    name, _, rest = kernel.partition("-")
    cap, _, functor = rest.partition("-")
    step, state, t_next, inputs = _start_ragged(
        nu, device=cuda_device, special=cap != "100000", nan_time=name == "step_ll_attempt",
        functor="rigid_body_anisotropic" if functor == "anisotropic" else "rigid_body")
    kw = dict(max_attempts=int(cap)) if cap else {}
    want = getattr(kernels, name + "_plain")(step, state, t_next, **inputs, **kw)
    before = kernels.LAUNCHES[name]
    first = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    second = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    assert kernels.LAUNCHES[name] == before + 2
    torch.cuda.synchronize()
    _assert_same_bits(first, second, want)
    steps = (want[15] - state[15])[0]
    if cap == "100000":
        assert bool(torch.all(want[0] >= t_next))
        assert float(steps.max()) > 2 * float(steps.min())  # lanes end far apart
    elif cap == "40":  # lanes of one block accepted different numbers of attempts
        assert float(steps.min()) < float(steps.max()) <= 40


@pytest.mark.cuda
def test_df32_kernels_refuse_a_vector_field_without_device_functor(cuda_device):
    vf, _, _, params = problems.rigid_body()
    step, state, t_next, inputs = _start_hi(
        4, batch=128, warm_steps=0, device=cuda_device,
        vf_df=batched_hi.wrap_vf_plain(vf, params))
    for fn, kw in ((kernels.step_hi_interval, dict(max_attempts=1)),
                   (kernels.step_hi_attempt, {})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(step, state, t_next, **inputs, **kw)
    step = batched_hi.make_step_hi(problems.rigid_body_df(), nu=4, d=3, error_calibration=5.0)
    with pytest.raises(ValueError, match="float32"):
        kernels.step_hi_attempt(step, tuple(x.double() for x in state), t_next.double(),
                                **{k: v.double() for k, v in inputs.items()})


@pytest.mark.parametrize("nu", [4, 5])
def test_hi_geometry_is_a_thread_per_lane(nu):
    """K2's and K4's launch geometry, the same in both forms: one thread per
    IVP lane, blocks of 128 lanes (lanes.cuh), no shared memory."""
    assert kernels.hi_geometry(nu) == {"threads_per_lane": 1, "lanes_per_block": 128,
                                       "threads_per_block": 128, "smem_bytes": 0}


def test_hi_geometry_refuses_an_nu_that_is_not_built():
    with pytest.raises(ValueError, match="nu = 4 and 5"):
        kernels.hi_geometry(3)
    with pytest.raises(ValueError, match="not K2 or K4"):
        kernels.step_hi_geometry("step_bd_interval")


@pytest.mark.parametrize("nu", [2, 3, 4])
def test_ll_geometry_is_a_thread_per_lane_that_fits_the_card(nu):
    """K1's and K3's launch geometry, the same in both forms: one thread per
    IVP lane, blocks of 128 lanes (lanes.cuh), the lane's five
    previous arrays (2 n d + 3 n^2 floats) in shared memory, two blocks of
    which fit an SM; K7 takes no shared memory: what its attempt does not
    read is copied from the input after the attempt (step_ll.cuh)."""
    g = kernels.ll_geometry(nu)
    n = nu + 1
    assert g == {"threads_per_lane": 1, "lanes_per_block": 128, "threads_per_block": 128,
                 "smem_bytes": 4 * 128 * (6 * n + 3 * n * n)}
    assert 2 * g["smem_bytes"] <= kernels.SMEM_PER_BLOCK
    assert kernels.ll_geometry(4)["smem_bytes"] == 53_760
    assert kernels.everystep_geometry(nu) == {**g, "smem_bytes": 0}


def test_ll_geometry_refuses_an_nu_or_kernel_that_is_not_built():
    with pytest.raises(ValueError, match="nu in"):
        kernels.ll_geometry(5)
    with pytest.raises(ValueError, match="nu in"):
        kernels.everystep_geometry(1)
    with pytest.raises(ValueError, match="not K1 or K3"):
        kernels.step_ll_geometry("step_hi_interval")
    with pytest.raises(ValueError, match="smoother or the filter"):
        kernels.step_everystep_geometry(4, "fixedpoint")


def test_parse_ptxas_reads_k1_k3_entries_with_shared_memory():
    def entry(name, regs, smem):
        return [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 0 barriers, {smem} bytes smem, "
            "704 bytes cmem[0]",
        ]

    log = "\n".join(
        entry("_ZN12_GLOBAL__N_116step_ll_intervalILi4ENS_9RigidBodyEEEvNS_4ArgsENS_6"
              "ConstsET0_li", 200, 0)
        + entry("_ZN12_GLOBAL__N_116step_ll_intervalILi3ENS_14RigidBodyAnisoEEEvNS_4ArgsENS_6"
                "ConstsET0_li", 180, 0)
        + entry("_ZN12_GLOBAL__N_115step_ll_attemptILi2ENS_9RigidBodyEEEvNS_4ArgsENS_6"
                "ConstsET0_l", 120, 16)
    )
    props = lambda regs, smem: {"stack": 0, "spill_stores": 0, "spill_loads": 0,  # noqa: E731
                                "registers": regs, "smem": smem}
    assert kernels.parse_ptxas(log) == {
        "step_ll_interval": {4: props(200, 0), "3/RigidBodyAniso": props(180, 0)},
        "step_ll_attempt": {2: props(120, 16)},
    }


def test_parse_ptxas_reads_k2_k4_entries():
    def entry(name, regs, spills, stack):
        return [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    {stack} bytes stack frame, {spills[0]} bytes spill stores, "
            f"{spills[1]} bytes spill loads",
            f"ptxas info    : Used {regs} registers, 920 bytes cmem[0]",
        ]

    log = "\n".join(
        entry("_ZN12_GLOBAL__N_116step_hi_intervalILi4ENS_11RigidBodyDfEEEvNS_6ArgsHiENS_8"
              "ConstsHiET0_li", 255, (216, 224), 152)
        + entry("_ZN12_GLOBAL__N_115step_hi_attemptILi5ENS_11RigidBodyDfEEEvNS_6ArgsHiENS_8"
                "ConstsHiET0_l", 255, (948, 1028), 600)
    )
    assert kernels.parse_ptxas(log) == {
        "step_hi_interval": {4: {"stack": 152, "spill_stores": 216, "spill_loads": 224,
                                 "registers": 255}},
        "step_hi_attempt": {5: {"stack": 600, "spill_stores": 948, "spill_loads": 1028,
                                "registers": 255}},
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["step_hi_interval-1", "step_hi_interval-40",
                                    "step_hi_interval-100000", "step_hi_attempt"])
@pytest.mark.parametrize("nu", [4, 5])
def test_df32_kernels_k2_k4_match_twin_on_the_card(cuda_device, nu, kernel):
    """K2 and K4 on 1,001 lanes (not a whole number of blocks) whose
    tolerances span rtol 1e-5 to 1e-9, so that the lanes of one block end
    their interval at very different attempts: equal to the plain version
    (one attempt of the unchanged twin, or its loop) bit for bit, and two
    launches on one input equal to each other (races show as run-to-run
    differences)."""
    step, state, t_next, inputs = _start_hi(nu, batch=1001, device=cuda_device)
    name, _, cap = kernel.partition("-")
    kw = dict(max_attempts=int(cap)) if cap else {}
    want = getattr(kernels, name + "_plain")(step, state, t_next, **inputs, **kw)
    before = kernels.LAUNCHES[name]
    first = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    second = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    assert kernels.LAUNCHES[name] == before + 2
    torch.cuda.synchronize()
    for a, b, w in zip(first, second, want):  # bit for bit
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(a, w, rtol=0, atol=0, equal_nan=True)
    steps = (want[11] - state[11])[0]
    if cap == "100000":
        assert bool(torch.all(want[0] == t_next))
        assert float(steps.max()) > 2 * float(steps.min())  # lanes end far apart
    elif cap == "40":  # lanes that rejected attempts beside lanes that accepted all
        assert float(steps.min()) < 40 and float(steps.max()) == 40


def _random_backward(state, rng, device):
    """``state`` with random backward conditionals of the state's own shapes
    (isotropic (n, n, B) or blockdiag (n, n, d, B) factors): within the first
    interval they are exactly zero, which would leave the fixedpoint
    accumulation out."""
    out = list(state)
    n = out[3].shape[0]
    lead = (n, n) + (1,) * (out[3].dim() - 2)
    for i in (3, 10):
        out[i] = np.eye(n).reshape(lead) + 0.3 * rng.standard_normal(out[i].shape) / np.sqrt(n)
    for i in (4, 11):
        out[i] = rng.standard_normal(out[i].shape)
    for i in (5, 12):
        out[i] = 0.3 * rng.standard_normal(out[i].shape) * np.tril(np.ones((n, n))).reshape(lead)
    for i in (3, 4, 5, 10, 11, 12):
        out[i] = torch.tensor(out[i], dtype=torch.float32, device=device)
    return tuple(out)


def _start_dense(problem, correction, *, batch=64, warm_steps=10, device="cpu", tol_lo=1e-6):
    """A lanes-last state of the dense engine (K5), advanced by the twin from
    the Taylor init toward the first checkpoint (with random backward
    conditionals if advanced at all), tolerances geometric from 1e-3 to
    ``tol_lo``; returns (step, state, t_next, inputs)."""
    if problem == "brusselator":
        vf, (y0,), _, params = problems.brusselator(2)
        dt0 = 0.01
    else:
        vf, (y0,), _, params = problems.rigid_body()
        dt0 = 0.1
    d = y0.shape[0]
    rng = np.random.default_rng(7)
    u0s = y0.numpy()[None] * (1.0 + 0.02 * rng.standard_normal((batch, d)))
    tols = torch.tensor(np.geomspace(1e-3, tol_lo, batch), dtype=torch.float32, device=device)
    save_at = np.linspace(0.0, 10.0, 5).astype(np.float32)
    state, _, inputs = batched.initial_state(
        vf, torch.tensor(u0s, dtype=torch.float32, device=device), params, save_at=save_at,
        dt0=dt0, tols=tols, implementation="dense")
    step = batched_dense.make_step_dense(vf, params, nu=4, d=d, correction=correction)
    t_next = torch.full((1, batch), float(save_at[1]), device=device)
    for _ in range(warm_steps):
        state = kernels.attempt_plain(step, state, t_next, **inputs)
    if warm_steps:
        state = _random_backward(state, rng, device)
    return step, state, t_next, inputs


@pytest.mark.parametrize("kernel", ["step_dense_interval", "step_dense_attempt"])
def test_dense_wrappers_run_the_plain_version_on_cpu_and_refuse_other_devices(kernel):
    step, state, t_next, inputs = _start_dense("brusselator", "ts1", batch=8, warm_steps=3)
    kw = dict(max_attempts=3) if kernel.endswith("interval") else {}
    before = dict(kernels.LAUNCHES)
    got = getattr(kernels, kernel)(step, state, t_next, **inputs, **kw)
    want = getattr(kernels, kernel + "_plain")(step, state, t_next, **inputs, **kw)
    assert kernels.LAUNCHES == before  # no kernel ran
    assert [tuple(x.shape) for x in got] == [tuple(s) for s in step.state_shapes(8)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    meta = tuple(x.to("meta") for x in state)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, kernel)(step, meta, t_next.to("meta"), **kw,
                                 **{k: v.to("meta") for k, v in inputs.items()})


def test_plain_dense_interval_lands_every_lane_on_the_checkpoint():
    step, state, t_next, inputs = _start_dense("rigid_body", "ts1", batch=8, warm_steps=0)
    capped = kernels.step_dense_interval_plain(step, state, t_next, max_attempts=2, **inputs)
    assert float(torch.max(capped[15])) <= 2
    done = kernels.step_dense_interval_plain(step, state, t_next, max_attempts=100_000, **inputs)
    assert bool(torch.all(done[0] >= t_next))
    again = kernels.step_dense_attempt(step, done, t_next, **inputs)
    for g, w in zip(again, done):  # lanes at the checkpoint are frozen
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_packed_constants_of_the_dense_step_match_the_kernel_layout():
    vf, _, _, params = problems.brusselator(2)
    step = batched_dense.make_step_dense(vf, params, nu=4, d=4, correction="ts1")
    c = step.packed_constants()
    assert c.dtype == np.float32 and c.shape == (71,)  # sizeof(Consts) / 4, NMAX = 5
    a, lq = c[:25].reshape(5, 5), c[25:50].reshape(5, 5)
    np.testing.assert_array_equal(a, np.float32(step.a_rows))
    np.testing.assert_array_equal(lq, np.float32(step.lq_rows))
    np.testing.assert_array_equal(c[50:55], np.float32(step.lq_norms))
    np.testing.assert_array_equal(c[55:60], np.float32(step.inv_fact))
    assert c[62] == np.float32(2.0)  # sqrt(d)
    assert c[63] == np.float32(20.0)  # kappa: the TS1 default
    assert step.functor_params == (np.float32(0.18),)  # c = (N + 1)^2 / 50


def test_parse_ptxas_reads_the_dense_entries():
    def entry(name, regs, stack, stores, loads):
        return [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    {stack} bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 0 barriers, {stack} bytes cumulative "
            "stack size",
        ]

    log = "\n".join(
        entry("_ZN12_GLOBAL__N_119step_dense_intervalILi4ELb1ENS_11BrusselatorILi2EEEEEvNS_4"
              "ArgsENS_6ConstsET1_li", 128, 23000, 40, 44)
        + entry("_ZN12_GLOBAL__N_118step_dense_attemptILi4ELb0ENS_9RigidBodyEEEvNS_4ArgsENS_6"
                "ConstsET1_l", 96, 17000, 0, 0)
        + entry("_ZN12_GLOBAL__N_116step_ll_intervalILi3ENS_9RigidBodyEEEvNS_4ArgsE",
                255, 112, 224, 112)
    )
    assert kernels.parse_ptxas(log) == {
        "step_dense_interval": {"4/ts1/Brusselator": {
            "stack": 23000, "spill_stores": 40, "spill_loads": 44, "registers": 128}},
        "step_dense_attempt": {"4/ts0/RigidBody": {
            "stack": 17000, "spill_stores": 0, "spill_loads": 0, "registers": 96}},
        "step_ll_interval": {3: {
            "stack": 112, "spill_stores": 224, "spill_loads": 112, "registers": 255}},
    }


@pytest.mark.parametrize("nd, d", [(20, 4), (15, 3)])
def test_dense_geometry_fits_a_block_and_covers_whole_sectors(nd, d):
    """K5's tiles (step_dense.cuh) at both functors' sizes: one warp a lane;
    the attempt form, whose time is its state's bytes, at least 8 lanes, so a
    tile's run of one element fills a 32-byte sector; the interval form, which
    moves its state once per launch, small enough that two blocks share an
    SM's 233,472 bytes; the defaults and the largest tile fit the H100's
    232,448 bytes a block; a lane's slice holds its whole 17-array state."""
    attempt = kernels.dense_geometry(nd, d, kernel="step_dense_attempt")
    interval = kernels.dense_geometry(nd, d, kernel="step_dense_interval")
    assert attempt["lanes_per_block"] >= 8 and interval["lanes_per_block"] >= 4
    assert 2 * (interval["smem_bytes"] + 1024) <= 233_472
    for g in (attempt, interval, kernels.dense_geometry(nd, d, kernels.DENSE_LANES_MAX)):
        assert g["threads_per_lane"] == 32 and g["threads_per_block"] == 32 * g["lanes_per_block"]
        assert g["smem_bytes"] <= kernels.SMEM_PER_BLOCK == 232_448
        assert g["threads_per_block"] <= 1024
    assert kernels.dense_lane_floats(nd, d) >= 4 * nd * nd + 4 * nd + 7  # state read twice
    assert attempt["smem_bytes"] == (219_520 if nd == 20 else 127_552)  # 256 + 12 * 18,272


def test_dense_geometry_entry_refuses_other_kernels_and_tiles():
    with pytest.raises(ValueError, match="not a form of K5"):
        kernels.step_dense_geometry("step_ll_interval", 4)
    with pytest.raises(ValueError, match="lanes_per_block"):
        kernels.step_dense_geometry("step_dense_interval", 4, lanes_per_block=13)


def test_parse_ptxas_reads_a_k5_entry_with_shared_memory():
    name = ("_ZN12_GLOBAL__N_118step_dense_attemptILi4ELb1ENS_11BrusselatorILi2EEEEEvNS_4"
            "ArgsENS_6ConstsET1_l")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 126 registers, used 1 barriers, 16 bytes smem, 648 bytes cmem[0]",
    ])
    assert kernels.parse_ptxas(log) == {"step_dense_attempt": {"4/ts1/Brusselator": {
        "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 126, "smem": 16}}}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["step_dense_interval-1", "step_dense_interval-100000",
                                    "step_dense_attempt"])
@pytest.mark.parametrize("correction", ["ts1", "ts0"])
@pytest.mark.parametrize("problem", ["brusselator", "rigid_body"])
def test_dense_kernels_k5_match_twin_on_the_card(cuda_device, problem, correction, kernel):
    step, state, t_next, inputs = _start_dense(problem, correction, batch=1000,
                                               device=cuda_device)
    name, _, cap = kernel.partition("-")
    kw = dict(max_attempts=int(cap)) if cap else {}
    before = kernels.LAUNCHES[name]
    got = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    assert kernels.LAUNCHES[name] == before + 1
    want = getattr(kernels, name + "_plain")(step, state, t_next, **inputs, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):  # bit for bit
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if cap == "100000":
        assert bool(torch.all(got[0] >= t_next))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [0, 1, 3, 5])
@pytest.mark.parametrize("kernel", ["step_dense_interval-40", "step_dense_attempt"])
@pytest.mark.parametrize("problem", ["brusselator", "rigid_body"])
def test_dense_kernels_k5_ragged_wide_tolerances_and_repeatable_on_the_card(
        cuda_device, problem, kernel, lanes):
    """K5 on 1,001 lanes (no tile divides it) whose tolerances span 1e-3 to
    1e-7, so that lanes of one block end at very different attempts (the
    interval form stops at 40, where the loosest lanes have reached the
    checkpoint and the tightest have not); at the default tile (0) and
    others: equal to the twin, and two launches on one input equal to each
    other (races show as run-to-run differences)."""
    step, state, t_next, inputs = _start_dense(problem, "ts1", batch=1001, device=cuda_device,
                                               tol_lo=1e-7)
    name, _, cap = kernel.partition("-")
    kw = dict(max_attempts=int(cap)) if cap else {}
    d = step.d
    kernels.step_dense_geometry(name, d, True, lanes)
    try:
        first = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
        second = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    finally:
        kernels.step_dense_geometry(name, d, True, 0)
    want = getattr(kernels, name + "_plain")(step, state, t_next, **inputs, **kw)
    torch.cuda.synchronize()
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    if cap:
        steps = (first[15] - state[15])[0]
        assert float(steps.max()) > 2 * float(steps.min())  # lanes end far apart


@pytest.mark.cuda
def test_dense_kernels_refuse_a_vector_field_without_device_functor(cuda_device):
    step, state, t_next, inputs = _start_dense("rigid_body", "ts1", batch=128, warm_steps=0,
                                               device=cuda_device)
    vf, _, _, params = problems.rigid_body()
    bare = batched_dense.make_step_dense(lambda y, *, t, p: vf(y, t=t, p=p), params, nu=4, d=3)
    for fn, kw in ((kernels.step_dense_interval, dict(max_attempts=1)),
                   (kernels.step_dense_attempt, {})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(bare, state, t_next, **inputs, **kw)
    with pytest.raises(ValueError, match="float32"):
        kernels.step_dense_attempt(step, tuple(x.double() for x in state), t_next.double(),
                                   **{k: v.double() for k, v in inputs.items()})


# ---------------------------------------------------------------------------
# K6 (blockdiag, interval and attempt form) and K7 (save every step)


def _start_bd(problem, nu, *, batch=64, warm_steps=20, device="cpu", tol_hi=1e-2, tol_lo=1e-6):
    """A lanes-last state of the blockdiag engine (K6), advanced by the twin
    from the Taylor init toward the first checkpoint (with random backward
    conditionals if advanced at all), tolerances geometric from ``tol_hi`` to
    ``tol_lo``; returns (step, state, t_next, inputs)."""
    if problem == "anisotropic":
        vf, (y0,), _, params = problems.rigid_body_anisotropic()
        dt0 = 0.01
    else:
        vf, (y0,), _, params = problems.rigid_body()
        dt0 = 0.1
    rng = np.random.default_rng(8)
    u0s = y0.numpy()[None] * (1.0 + 0.05 * rng.standard_normal((batch, 3)))
    tols = torch.tensor(np.geomspace(tol_hi, tol_lo, batch), dtype=torch.float32, device=device)
    save_at = np.linspace(0.0, 10.0, 5).astype(np.float32)
    state, _, inputs = batched_blockdiag.initial_state(
        vf, torch.tensor(u0s, dtype=torch.float32, device=device), params, save_at=save_at,
        dt0=dt0, tols=tols, num_derivatives=nu)
    step = batched_blockdiag.make_step_bd(vf, params, nu=nu, d=3)
    t_next = torch.full((1, batch), float(save_at[1]), device=device)
    for _ in range(warm_steps):
        state = kernels.attempt_plain(step, state, t_next, **inputs)
    if warm_steps:
        state = _random_backward(state, rng, device)
    return step, state, t_next, inputs


def _start_everystep(strategy, nu, *, batch=64, warm_steps=20, device="cpu"):
    """A lanes-last state of the save-every-step driver (K7), advanced by the
    twin with ``strategy`` from the Taylor init toward t1 = 10 (contiguous:
    the twin's gains are transposed views); returns (step, state, t1,
    inputs)."""
    rng = np.random.default_rng(9)
    u0s = np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((batch, 3)))
    tols = torch.tensor(np.geomspace(1e-1, 1e-5, batch), dtype=torch.float32, device=device)
    vf, _, _, params = problems.rigid_body()
    state, _, inputs = batched.initial_state(
        vf, torch.tensor(u0s, dtype=torch.float32, device=device), params,
        save_at=np.array([0.0, 10.0], np.float32), dt0=0.1, tols=tols, num_derivatives=nu,
        strategy=strategy)
    step = batched.make_step_ll(vf, params, nu=nu, d=3, strategy=strategy)
    t1 = torch.full((1, batch), 10.0, device=device)
    for _ in range(warm_steps):
        state = kernels.attempt_plain(step, state, t1, **inputs)
    return step, tuple(x.contiguous() for x in state), t1, inputs


@pytest.mark.parametrize("kernel", ["step_bd_interval", "step_bd_attempt",
                                    "step_everystep_attempt"])
def test_k6_k7_wrappers_run_the_plain_version_on_cpu_and_refuse_other_devices(kernel):
    if kernel == "step_everystep_attempt":
        step, state, t_next, inputs = _start_everystep("smoother", 4, batch=8, warm_steps=3)
    else:
        step, state, t_next, inputs = _start_bd("anisotropic", 4, batch=8, warm_steps=3)
    kw = dict(max_attempts=3) if kernel.endswith("interval") else {}
    before = dict(kernels.LAUNCHES)
    got = getattr(kernels, kernel)(step, state, t_next, **inputs, **kw)
    want = getattr(kernels, kernel + "_plain")(step, state, t_next, **inputs, **kw)
    assert kernels.LAUNCHES == before  # no kernel ran
    assert [tuple(x.shape) for x in got] == [tuple(s) for s in step.state_shapes(8)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    meta = tuple(x.to("meta") for x in state)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, kernel)(step, meta, t_next.to("meta"), **kw,
                                 **{k: v.to("meta") for k, v in inputs.items()})


def test_plain_bd_interval_lands_every_lane_on_the_checkpoint():
    step, state, t_next, inputs = _start_bd("rigid_body", 4, batch=8, warm_steps=0)
    assert state[2].shape == (5, 5, 3, 8) and state[6].shape == (3, 8)
    capped = kernels.step_bd_interval_plain(step, state, t_next, max_attempts=2, **inputs)
    assert float(torch.max(capped[15])) <= 2
    done = kernels.step_bd_interval_plain(step, state, t_next, max_attempts=100_000, **inputs)
    assert bool(torch.all(done[0] >= t_next))
    again = kernels.step_bd_attempt(step, done, t_next, **inputs)
    for g, w in zip(again, done):  # lanes at the checkpoint are frozen
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_everystep_attempt_refuses_the_fixedpoint_strategy():
    step, state, t1, inputs = _start_everystep("smoother", 2, batch=8, warm_steps=0)
    fixedpoint = batched.make_step_ll(step.vf, step.params, nu=2, d=3)
    with pytest.raises(ValueError, match="step_ll_attempt"):
        kernels.step_everystep_attempt(fixedpoint, state, t1, **inputs)
    with pytest.raises(ValueError, match="strategy"):
        batched.make_step_ll(step.vf, step.params, nu=2, d=3, strategy="fixed")


def test_packed_constants_and_functor_parameters_of_the_blockdiag_step():
    vf, _, _, params = problems.rigid_body_anisotropic()
    step = batched_blockdiag.make_step_bd(vf, params, nu=4, d=3)
    c = step.packed_constants()
    assert c.dtype == np.float32 and c.shape == (71,)  # sizeof(Consts) / 4, NMAX = 5
    np.testing.assert_array_equal(c[:25].reshape(5, 5), np.float32(step.a_rows))
    assert c[63] == np.float32(10.0)  # kappa: the TS0 default
    assert step.functor_params == (-2.0, 1.25, -5000.0, 1e4)  # p1, p2, s3 * p3, s3
    assert step.device_functor == "rigid_body_anisotropic"
    assert kernels._num_params("step_bd_attempt", "rigid_body") == 4
    assert kernels._num_params("step_ll_interval", "rigid_body_anisotropic") == 4
    assert len(kernels._argtypes("step_bd_interval", "rigid_body")) == 12
    assert len(kernels._argtypes("step_everystep_attempt", "rigid_body")) == 11
    assert len(kernels._argtypes("step_ll_interval", "rigid_body")) == 11


def test_parse_ptxas_reads_the_blockdiag_and_everystep_entries():
    def entry(name, regs, stack):
        return [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    {stack} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 0 barriers, {stack} bytes cumulative "
            "stack size",
        ]

    log = "\n".join(
        entry("_ZN12_GLOBAL__N_116step_bd_intervalILi4ENS_14RigidBodyAnisoEEEvNS_4ArgsENS_6"
              "ConstsET0_li", 128, 3000)
        + entry("_ZN12_GLOBAL__N_115step_bd_attemptILi2ENS_9RigidBodyEEEvNS_4ArgsENS_6ConstsET0_l",
                96, 900)
        + entry("_ZN12_GLOBAL__N_122step_everystep_attemptILi4ELi1ENS_9RigidBodyEEEvNS_4ArgsENS_6"
                "ConstsET1_l", 255, 400)
        + entry("_ZN12_GLOBAL__N_122step_everystep_attemptILi3ELi2ENS_9RigidBodyEEEvNS_4ArgsENS_6"
                "ConstsET1_l", 200, 0)
    )
    props = lambda regs, stack: {"stack": stack, "spill_stores": 0, "spill_loads": 0,  # noqa: E731
                                 "registers": regs}
    assert kernels.parse_ptxas(log) == {
        "step_bd_interval": {"4/RigidBodyAniso": props(128, 3000)},
        "step_bd_attempt": {"2/RigidBody": props(96, 900)},
        "step_everystep_attempt": {"4/smoother": props(255, 400), "3/filter": props(200, 0)},
    }


@pytest.mark.parametrize("functor", ["rigid_body", "rigid_body_anisotropic"])
@pytest.mark.parametrize("nu", [2, 3, 4])
def test_bd_geometry_fits_a_block_in_whole_warps(nu, functor):
    """K6's tile (step_bd.cuh), the same in both forms and for both functors
    (d = 3): a block is 32 lanes in d whole warps, and its shared memory
    fits the H100's 232,448 bytes a block and the launch bounds' 4 tiles an
    SM of 233,472 bytes: the tile's exchange buffer and each thread's
    channel's mean, chol, bwdG, bwd_m and bwd_L (2n + 3n^2 floats) and its
    lane's 6 inputs."""
    d = kernels._FUNCTORS[("step_bd_interval", functor)][1]
    assert d == kernels._FUNCTORS[("step_bd_attempt", functor)][1] == 3
    n = nu + 1
    g = kernels.bd_geometry(nu, d)
    assert g["threads_per_block"] % 32 == 0 and g["threads_per_block"] <= 128
    assert (g["threads_per_lane"], g["lanes_per_block"]) == (3, 32)
    assert g["threads_per_block"] == g["threads_per_lane"] * g["lanes_per_block"]
    assert g["smem_bytes"] <= kernels.SMEM_PER_BLOCK == 232_448
    assert 4 * (g["smem_bytes"] + 1024) <= 233_472
    assert g["smem_bytes"] == 4 * (2 * 2 * 3 * 32 + (2 * n + 3 * n * n + 6) * 96)


def test_bd_geometry_entry_refuses_other_kernels_and_functors():
    with pytest.raises(ValueError, match="not a form of K6"):
        kernels.step_bd_geometry("step_dense_interval")
    with pytest.raises(ValueError, match="device functor"):
        kernels.step_bd_geometry("step_bd_attempt", functor="brusselator")


def test_parse_ptxas_reads_k6_entries_with_shared_memory():
    def entry(name, regs, smem):
        return [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers, {smem} bytes smem, "
            "656 bytes cmem[0]",
        ]

    log = "\n".join(
        entry("_ZN12_GLOBAL__N_116step_bd_intervalILi4ENS_14RigidBodyAnisoEEEvNS_4ArgsENS_6"
              "ConstsET0_li", 168, 1536)
        + entry("_ZN12_GLOBAL__N_115step_bd_attemptILi3ENS_9RigidBodyEEEvNS_4ArgsENS_6"
                "ConstsET0_l", 120, 1536)
    )
    props = lambda regs, smem: {"stack": 0, "spill_stores": 0, "spill_loads": 0,  # noqa: E731
                                "registers": regs, "smem": smem}
    assert kernels.parse_ptxas(log) == {
        "step_bd_interval": {"4/RigidBodyAniso": props(168, 1536)},
        "step_bd_attempt": {"3/RigidBody": props(120, 1536)},
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["step_bd_interval-1", "step_bd_interval-40",
                                    "step_bd_interval-100000", "step_bd_attempt"])
@pytest.mark.parametrize("nu", [2, 3, 4])
@pytest.mark.parametrize("problem", ["anisotropic", "rigid_body"])
def test_blockdiag_kernels_k6_match_twin_on_the_card(cuda_device, problem, nu, kernel):
    """K6 on 1,001 lanes (not a whole number of 32-lane tiles) whose
    tolerances span 1e-3 to 1e-7, so that lanes of one block end their
    interval at very different attempts (at 40 attempts the loosest have
    reached the checkpoint and the tightest have not): equal to the twin bit
    for bit, and two launches on one input equal to each other (races show
    as run-to-run differences)."""
    step, state, t_next, inputs = _start_bd(problem, nu, batch=1001, device=cuda_device,
                                            tol_hi=1e-3, tol_lo=1e-7)
    name, _, cap = kernel.partition("-")
    kw = dict(max_attempts=int(cap)) if cap else {}
    want = getattr(kernels, name + "_plain")(step, state, t_next, **inputs, **kw)
    before = kernels.LAUNCHES[name]
    first = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    second = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    assert kernels.LAUNCHES[name] == before + 2
    torch.cuda.synchronize()
    for a, b, w in zip(first, second, want):  # bit for bit
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(a, w, rtol=0, atol=0, equal_nan=True)
    steps = (want[15] - state[15])[0]
    if cap == "100000":
        assert bool(torch.all(want[0] >= t_next))
        assert float(steps.max()) > 2 * float(steps.min())  # lanes end far apart
    elif cap == "40":
        assert float(steps.min()) < 40 and float(steps.max()) == 40


@pytest.mark.cuda
@pytest.mark.parametrize("warm_steps", [0, 20])
@pytest.mark.parametrize("nu", [2, 3, 4])
@pytest.mark.parametrize("strategy", ["smoother", "filter"])
def test_everystep_kernel_k7_matches_twin_on_the_card(cuda_device, strategy, nu, warm_steps):
    step, state, t1, inputs = _start_everystep(strategy, nu, batch=1000, warm_steps=warm_steps,
                                               device=cuda_device)
    before = kernels.LAUNCHES["step_everystep_attempt"]
    got = kernels.step_everystep_attempt(step, state, t1, **inputs)
    assert kernels.LAUNCHES["step_everystep_attempt"] == before + 1
    want = kernels.step_everystep_attempt_plain(step, state, t1, **inputs)
    torch.cuda.synchronize()
    assert int(torch.sum(want[0] != state[0])) > 0  # some lanes accepted
    for g, w in zip(got, want):  # bit for bit
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nu", [2, 3, 4])
@pytest.mark.parametrize("strategy", ["smoother", "filter"])
def test_everystep_kernel_k7_ragged_and_repeatable_on_the_card(cuda_device, strategy, nu):
    """K7 on 1,001 lanes (not a whole number of blocks) at tol 1e-1..1e-5,
    mid-solve, with a NaN lane, a lane whose time is NaN and two lanes at or
    past t1 (frozen): accepted lanes take the new arrays, rejected and
    frozen ones pass the input's through (store_attempt's two branches in
    one block); equal to the twin bit for bit, and two launches equal."""
    step, state, t1, inputs = _start_everystep(strategy, nu, batch=1001, warm_steps=20,
                                               device=cuda_device)
    state = [x.clone() for x in state]
    state[1][:, :, 3] = float("nan")
    state[0][:, 7] = float("nan")
    state[0][:, 10] = t1[:, 10]
    state[0][:, 11] = t1[:, 11] + 1.0
    state = tuple(state)
    want = kernels.step_everystep_attempt_plain(step, state, t1, **inputs)
    before = kernels.LAUNCHES["step_everystep_attempt"]
    first = kernels.step_everystep_attempt(step, state, t1, **inputs)
    second = kernels.step_everystep_attempt(step, state, t1, **inputs)
    assert kernels.LAUNCHES["step_everystep_attempt"] == before + 2
    torch.cuda.synchronize()
    _assert_same_bits(first, second, tuple(x.contiguous() for x in want))
    accepted = int(torch.sum(want[15] != state[15]))
    assert 0 < accepted < 1001 - 3  # both branches of store_attempt ran


@pytest.mark.cuda
def test_k6_k7_refuse_a_vector_field_without_device_functor(cuda_device):
    step, state, t_next, inputs = _start_bd("rigid_body", 4, batch=128, warm_steps=0,
                                            device=cuda_device)
    vf, _, _, params = problems.rigid_body()
    bare_vf = lambda y, *, t, p: vf(y, t=t, p=p)  # noqa: E731
    bare = batched_blockdiag.make_step_bd(bare_vf, params, nu=4, d=3)
    for fn, kw in ((kernels.step_bd_interval, dict(max_attempts=1)), (kernels.step_bd_attempt, {})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(bare, state, t_next, **inputs, **kw)
    step, state, t1, inputs = _start_everystep("filter", 4, batch=128, warm_steps=0,
                                               device=cuda_device)
    bare = batched.make_step_ll(bare_vf, params, nu=4, d=3, strategy="filter")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.step_everystep_attempt(bare, state, t1, **inputs)


def _elements_ll(seed, p, m, c, dtype, device):
    rng = np.random.default_rng(seed)
    shapes = ((m, m, p), (m, c, p), (m, m, p), (m, c, p), (m, m, p))
    return tuple(torch.tensor(rng.standard_normal(s), dtype=dtype, device=device) for s in shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [1024, 1000])
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("m", [3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pit_combine_k8_matches_its_plain_version_on_the_card(cuda_device, dtype, m, c, pairs):
    """K8 on random elements, the first lanes identity elements (what the
    prefix's shift feeds it) and one lane NaN: equal to the plain version
    bit for bit, and two launches equal (the team's race check)."""
    e_i = _elements_ll(70, pairs, m, c, dtype, cuda_device)
    e_j = _elements_ll(71, pairs, m, c, dtype, cuda_device)
    e_i = tuple(x.clone() for x in e_i)
    e_i[0][:, :, :7] = torch.eye(m, dtype=dtype, device=cuda_device)[..., None]
    for x in e_i[1:]:
        x[..., :7] = 0.0
    for x in e_j:
        x[..., 9] = float("nan")
    before = kernels.LAUNCHES["pit_combine"]
    got = kernels.pit_combine(e_i, e_j)
    again = kernels.pit_combine(e_i, e_j)
    assert kernels.LAUNCHES["pit_combine"] == before + 2
    want = kernels.pit_combine_plain(e_i, e_j)
    torch.cuda.synchronize()
    _assert_same_bits(got, again, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m, c", [(3, 1), (4, 3), (5, 3)])
def test_pit_combine_geometry_is_a_team_of_eight_a_pair(m, c, dtype):
    """K8's launch geometry (pit_combine.cuh): 8 threads a pair in two halves
    of 4, a block of 8 pairs in two warps (the R1 halves, the R2 halves);
    each pair's slice of shared memory holds the ten operands, the two
    halves' scratch (product, (2m, m) column list, factor, right solve) and
    A_j U_i, at a stride of 4 more than a multiple of 32 scalars (element
    k + member of a warp's pairs in 32 different banks)."""
    g = kernels.pit_combine_geometry(m, c, dtype)
    size = 8 if dtype == torch.float64 else 4
    scalars = 2 * (3 * m * m + 2 * m * c) + 2 * (m * m + 2 * m * m + m * m + m * m) + m * m
    stride = g["smem_bytes"] // (8 * size)
    assert (g["threads_per_pair"], g["pairs_per_block"], g["threads_per_block"]) == (8, 8, 64)
    assert g["smem_bytes"] == 8 * size * stride and stride % 32 == 4
    assert scalars <= stride < scalars + 32
    assert g["smem_bytes"] <= 48 * 1024  # static shared memory
    assert kernels.pit_combine_geometry(5, 3, torch.float64)["smem_bytes"] == 33_024


def test_pit_combine_geometry_refuses_what_is_not_built():
    with pytest.raises(ValueError, match="built for"):
        kernels.pit_combine_geometry(6, 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        kernels.pit_combine_geometry(4, 3, torch.float16)
    with pytest.raises(ValueError, match="built for"):
        kernels.step_pit_combine_geometry(4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("m", [3, 4, 5])
def test_pit_combine_k8_geometry_on_the_card(cuda_device, m, c, dtype):
    """The geometry that K8's C entry reports is the Python mirror's and a
    block fits an SM; the fixed-grid path's instantiation (m = 4, c = 3)
    keeps no local memory (no spills, no stack)."""
    g = kernels.step_pit_combine_geometry(m, c, dtype)
    assert {k: g[k] for k in kernels.pit_combine_geometry(m, c, dtype)} == \
        kernels.pit_combine_geometry(m, c, dtype)
    assert g["blocks_per_sm"] >= 1
    if (m, c) == (4, 3):
        assert g["local_bytes"] == 0


@pytest.mark.cuda
def test_pit_combine_k8_refuses_what_it_is_not_built_for(cuda_device):
    els = _elements_ll(72, 8, 6, 1, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="built for"):
        kernels.pit_combine(els, els)
    els = _elements_ll(72, 8, 4, 3, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="not contiguous"):
        kernels.pit_combine(tuple(x.transpose(0, 1) if x.shape[0] == x.shape[1] else x
                                  for x in els), els)
    with pytest.raises(ValueError, match="float32 or float64"):
        kernels.pit_combine(tuple(x.half() for x in els), tuple(x.half() for x in els))
    # a block axis folds into the lanes only as a view of contiguous operands
    blocked = tuple(x.reshape(x.shape[0], x.shape[1], 2, 4) for x in els)
    with pytest.raises(ValueError, match="not contiguous"):
        kernels.pit_combine(tuple(x.transpose(2, 3) for x in blocked), blocked)
    with pytest.raises(ValueError, match="block axis"):
        kernels.pit_combine(tuple(x[..., None] for x in blocked), blocked)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(130, 10, 5), (128, 6, 6), (64, 4, 2), (1000, 6, 3),
                                   (1000, 8, 4), (1000, 12, 6)])
def test_batched_qr_k9_matches_its_plain_version_on_the_card(cuda_device, shape):
    from odecheckpts_torch import batched_qr

    x = torch.tensor(np.random.default_rng(73).standard_normal(shape), dtype=torch.float32,
                     device=cuda_device)
    before = kernels.LAUNCHES["batched_qr_r"]
    got = batched_qr.batched_qr_r(x)
    assert kernels.LAUNCHES["batched_qr_r"] == before + 1
    want = kernels.batched_qr_r_plain(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # bit for bit
    ref = batched_qr.batched_qr_r_reference(x)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-5)  # the reference's gate
    with pytest.raises(ValueError, match="built for"):
        batched_qr.batched_qr_r(x[:, :3, :2])


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("size", [10, 8, 6])
@pytest.mark.parametrize("variant", ["cols", "masked"])
def test_qr_packing_k10_k11_match_their_plain_versions_on_the_card(cuda_device, variant, size,
                                                                   iters):
    from odecheckpts_torch import qr_packing

    x = torch.tensor(np.random.default_rng(74).standard_normal((size, size, 1000)),
                     dtype=torch.float32, device=cuda_device)
    name = f"qr_packing_{variant}"
    before = kernels.LAUNCHES[name]
    got = qr_packing.bench_kernel(variant, size, size, iters)(x)
    assert kernels.LAUNCHES[name] == before + 1
    want = getattr(kernels, name + "_plain")(x, iters)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # bit for bit


@pytest.mark.cuda
def test_qr_packing_main_runs_the_reference_size_on_the_card(cuda_device):
    from odecheckpts_torch import qr_packing

    out = qr_packing.main(batch=8192, iters=20, nu=4, device=cuda_device)
    assert (out["m"], out["n"]) == (10, 10) and len(out["rows"]) == 2
    assert all(row["ms"] > 0 for row in out["rows"]) and out["packed_over_cols"] > 0
