"""The prior-order sweep on the port (``experiments/6_tpu_batched_sweep/
order_sweep_torch.py``) and what it needs of the df32 kernels: K2 and K4 at
nu = 6.

This file imports no JAX (the differential tests of the df32 twin at nu = 6
against the JAX package are in ``tests/test_torch_batched_hi.py``), so the
card-only cases run where only the port is installed:

    python -m pytest --noconftest tests/test_torch_order_sweep.py -m cuda

CPU checks:

* the runner on the twins (``--device cpu --engine torch``) at 16 lanes, 8
  of them against LSODA: one row of each band, (nu 2, rtol 1e-1) in f32 and
  (nu 6, rtol 1e-6) in df32, pass ``order_sweep.py``'s gates with its row
  keys, and nothing is written.  The nu = 6 row's mean accepted steps are
  the reference's flat count: within 10% of the committed TPU row's
  (``data_order_sweep.json``, 4,050.9; the lanes differ, the JAX package's
  own solver takes 3,771-4,239 on four lanes);
* the constant layout: ``ConstsHiN`` (``csrc/step_hi.cuh``) parsed from
  the header holds at ``NMAX_HI`` as many floats as
  ``StepHi.packed_constants()`` of the rigid body at nu = 4, 5, 6, and at
  the wide body's own ``NMAX_WIDE`` (``csrc/step_hi_wide.cuh``) as many as
  that of a row functor at nu = 4, 5; the wide body's ``LaneWide`` as many
  as ``kernels.HI_WIDE_LANE_FLOATS``;
* nu = 6 on the wide forms raises ``NotImplementedError`` naming ROADMAP
  queue 1 item 2 before any launch;
* K2's and K4's sources (``step_hi.cu``, ``step_hi_attempt.cu``) compiled
  with g++ against ``torch_cuda_shim`` (every operation rounded on its own)
  equal the twin bit for bit at nu = 6 (skips where g++ is absent).

On the card K2 and K4 at nu = 6 equal the twin bit for bit on a ragged
batch of 1,001 lanes (rtol 1e-5..1e-9), each launch made twice and required
identical.
"""

import ctypes
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cuda_shim as shim

from odecheckpts_torch import batched_hi, kernels, problems

ROOT = Path(__file__).resolve().parents[1]
SWEEP = ROOT / "experiments" / "6_tpu_batched_sweep"
CSRC = Path(kernels.__file__).resolve().parent / "csrc"


def _runner():
    spec = importlib.util.spec_from_file_location("order_sweep_torch",
                                                  SWEEP / "order_sweep_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_runner_gates_one_row_of_each_band_on_the_cpu_and_writes_nothing():
    runner = _runner()
    committed = json.loads((SWEEP / "data_order_sweep.json").read_text())["results"]
    before = runner.OUT.read_bytes() if runner.OUT.exists() else None
    rows = runner.main(["--device", "cpu", "--engine", "torch", "--batch", "16", "--sample", "8",
                        "--orders", "6", "--rtols", "1e-6", "--orders-f32", "2",
                        "--rtols-f32", "1e-1"])
    assert (runner.OUT.read_bytes() if runner.OUT.exists() else None) == before
    assert [(r["dtype"], r["nu"], r["rtol"]) for r in rows] == [("float32", 2, 1e-1),
                                                                ("df32", 6, 1e-6)]
    for row in rows:
        assert set(committed[0]) <= set(row)
        assert row["gate_ok"] and row["finite"] and row["capped_lanes"] == 0
        assert row["batch"] == 16 and row["engine"] == "torch" and row["launches"] == {}
        assert row["rmse"] < 3 * row["rtol"] and row["rmse_max_lane"] < 6 * row["rtol"]
    (tpu,) = [r for r in committed if (r["dtype"], r["nu"], r["rtol"]) == ("df32", 6, 1e-6)]
    assert abs(rows[1]["mean_steps"] / tpu["mean_steps"] - 1.0) < 0.1


def test_runner_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _runner().main(["--batch", "4"])


def _struct_floats(text, name, consts):
    """Floats (4-byte members) of ``struct name`` in a header, its array
    extents evaluated with ``consts``; nested structs by their own size."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    total = 0
    for kind, decl in re.findall(r"^\s*(float|int|StepWide) ([^;]+);", body, re.M):
        size = _struct_floats(text, kind, consts) if kind == "StepWide" else 1
        for member in decl.split(","):
            extents = re.findall(r"\[([^\]]+)\]", member)
            count = int(np.prod([eval(e, {}, dict(consts)) for e in extents]))  # noqa: S307
            total += count * size
    return total


def test_constant_and_wide_lane_layouts_match_the_headers():
    hi = (CSRC / "step_hi.cuh").read_text()
    wide = (CSRC / "step_hi_wide.cuh").read_text()
    nmax_hi = int(re.search(r"constexpr int NMAX_HI = (\d+);", hi).group(1))
    nmax_wide = int(re.search(r"constexpr int NMAX_WIDE = (\d+);", wide).group(1))
    consts = {"NMAX_WIDE": nmax_wide, "NN_WIDE": nmax_wide**2}
    assert nmax_hi == max(batched_hi.SUPPORTED_NU) + 1 == 7
    assert nmax_wide == max(kernels.HI_WIDE_NU) + 1 == 6
    row = batched_hi.wrap_vf_plain(problems.brusselator(4)[0], ())
    for nmax, vf_df, nus, header in ((nmax_hi, problems.rigid_body_df(), batched_hi.SUPPORTED_NU,
                                      hi),
                                     (nmax_wide, row, kernels.HI_WIDE_NU, wide)):
        n_consts = _struct_floats(hi, "ConstsHiN", {"NMAX": nmax})
        assert f"== {n_consts} * sizeof(float)" in header
        for nu in nus:
            step = batched_hi.StepHi(vf_df, nu=nu, d=3 if nmax == nmax_hi else 8,
                                     error_calibration=2.0)
            c = step.packed_constants()
            assert c.dtype == np.float32 and len(c) == n_consts == 2 * nmax * (nmax + 1) + 15
            a = c[: nmax**2].reshape(nmax, nmax)
            np.testing.assert_array_equal(a[: nu + 1, : nu + 1], np.float32(step.a_rows))
            assert np.all(a[nu + 1 :] == 0) and np.all(a[:, nu + 1 :] == 0)
    n_lane = _struct_floats(wide, "LaneWide", consts)
    assert n_lane == kernels.HI_WIDE_LANE_FLOATS == 363
    assert f"WIDE_LANE_FLOATS = {n_lane};" in wide
    assert kernels.hi_wide_geometry(5, 128)["smem_bytes"] == 2_988


def test_wide_forms_refuse_nu_6_before_any_launch():
    vf_df = batched_hi.wrap_vf_plain(problems.brusselator(4)[0], ())
    step = batched_hi.make_step_hi(vf_df, nu=6, d=8)
    for kernel in ("step_hi_wide_interval", "step_hi_wide_attempt"):
        with pytest.raises(NotImplementedError, match=r"built for nu in \(4, 5\).*"
                                                      r"ROADMAP queue 1 item 2$"):
            kernels._variant_flags(kernel, "brusselator_hi", step)
    with pytest.raises(ValueError, match="nu = 4 and 5"):
        kernels.hi_wide_geometry(6, 64)
    # K2 and K4 take nu = 6 on the rigid body
    rigid = batched_hi.make_step_hi(problems.rigid_body_df(), nu=6, d=3)
    assert kernels._variant_flags("step_hi_interval", "rigid_body_df", rigid) == ()
    assert kernels.hi_geometry(6)["threads_per_lane"] == 1


def _start(nu, *, batch, warm_steps=30, device="cpu"):
    """A mid-solve df32 state toward t = 10 from the f64 Taylor init,
    tolerances geometric from 1e-5 to 1e-9 across the lanes (as
    ``tests/test_torch_kernels.py``'s card cases)."""
    rng = np.random.default_rng(6)
    u0s = np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((batch, 3)))
    tols = torch.tensor(np.geomspace(1e-5, 1e-9, batch), dtype=torch.float32, device=device)
    vf, _, _, params = problems.rigid_body()
    save_at = np.linspace(0.0, 40.0, 5).astype(np.float32)
    state, inputs = batched_hi.initial_state(vf, torch.tensor(u0s, device=device), params,
                                             save_at=save_at, dt0=0.1, tols=tols,
                                             num_derivatives=nu)
    step = batched_hi.make_step_hi(problems.rigid_body_df(), nu=nu, d=3, error_calibration=5.0)
    t_next = torch.full((1, batch), float(save_at[1]), device=device)
    for _ in range(warm_steps):
        state = kernels.attempt_plain(step, state, t_next, **inputs)
    return step, tuple(x.contiguous() for x in state), t_next, inputs


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    lib = shim.build(CSRC, ("step_hi.cu", "step_hi_attempt.cu"),
                     tmp_path_factory.mktemp("hi_rehearsal"), "hi_rehearsal")
    if lib is None:
        pytest.skip("g++ is not on PATH: the CPU rehearsal of K2's and K4's sources needs it")
    return lib


def _run_rehearsal(lib, kernel, step, state, t_next, inputs, max_attempts=None):
    """The C entry of ``kernel`` on CPU tensors, packed as
    ``kernels._launch`` packs them."""
    extra = (t_next, inputs["atol"], inputs["rtol"], inputs["dt_max"], inputs["dt_floor"],
             inputs["tiny_scale"])
    ins = [x.contiguous() for x in (*state, *extra)]
    outs = tuple(torch.empty_like(x) for x in state)
    ins_ptr = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    outs_ptr = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    consts = np.ascontiguousarray(step.packed_constants())
    head = [ctypes.c_int(step.nu), ctypes.c_void_p(ctypes.addressof(ins_ptr)),
            ctypes.c_void_p(ctypes.addressof(outs_ptr)), ctypes.c_void_p(consts.ctypes.data),
            ctypes.c_longlong(state[0].shape[-1])]
    if max_attempts is not None:
        head.append(ctypes.c_int(max_attempts))
    params = [ctypes.c_float(float(p)) for p in step.functor_params]
    rc = getattr(lib, f"odeckpt_{kernel}_rigid_body_df")(*head, *params, ctypes.c_int(0),
                                                         ctypes.c_void_p(0))
    assert rc == 0
    return outs


@pytest.mark.parametrize("kernel", ["step_hi_interval-1", "step_hi_interval-40",
                                    "step_hi_attempt"])
def test_k2_k4_sources_at_nu_6_match_the_twin_under_gxx(rehearsal, kernel):
    step, state, t_next, inputs = _start(6, batch=37)
    name, _, cap = kernel.partition("-")
    kw = dict(max_attempts=int(cap)) if cap else {}
    want = getattr(kernels, name + "_plain")(step, state, t_next, **inputs, **kw)
    got = _run_rehearsal(rehearsal, name, step, state, t_next, inputs, **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), f"{kernel}: array {i}"
    steps = (want[11] - state[11])[0]
    if cap == "40":  # lanes that rejected attempts beside lanes that accepted all
        assert float(steps.min()) < 40 and float(steps.max()) == 40


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["step_hi_interval-1", "step_hi_interval-40",
                                    "step_hi_interval-100000", "step_hi_attempt"])
def test_k2_k4_at_nu_6_match_the_twin_on_a_ragged_batch_on_the_card(cuda_device, kernel):
    """K2 and K4 at nu = 6 on 1,001 lanes (not a whole number of blocks)
    whose tolerances span rtol 1e-5 to 1e-9: equal to the plain version bit
    for bit, and two launches on one input equal to each other."""
    step, state, t_next, inputs = _start(6, batch=1001, device=cuda_device)
    name, _, cap = kernel.partition("-")
    kw = dict(max_attempts=int(cap)) if cap else {}
    want = getattr(kernels, name + "_plain")(step, state, t_next, **inputs, **kw)
    before = kernels.LAUNCHES[name]
    first = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    second = getattr(kernels, name)(step, state, t_next, **inputs, **kw)
    assert kernels.LAUNCHES[name] == before + 2
    torch.cuda.synchronize()
    for a, b, w in zip(first, second, want):  # bit for bit
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(a, w, rtol=0, atol=0, equal_nan=True)
    steps = (want[11] - state[11])[0]
    if cap == "100000":
        assert bool(torch.all(want[0] == t_next))
        # lanes of one block end hundreds of attempts apart; at nu = 6 the
        # step counts hardly depend on rtol (the reference's own behaviour),
        # so the spread is narrower than at nu = 4, 5 (633-951 on an H100)
        assert float(steps.max()) > 1.3 * float(steps.min())
    elif cap == "40":  # lanes that rejected attempts beside lanes that accepted all
        assert float(steps.min()) < 40 and float(steps.max()) == 40


@pytest.mark.cuda
def test_wide_wrappers_refuse_nu_6_on_the_card(cuda_device):
    """The wrapper raises before the C switch (which would return
    cudaErrorInvalidValue), and no launch is counted."""
    N, batch = 4, 8
    vf, (y0,), _, _ = problems.brusselator(N)
    y0s = torch.tensor(np.tile(y0.numpy(), (batch, 1)).astype(np.float32), device=cuda_device)
    solve = batched_hi.make_hi_solver(vf, (), save_at=np.linspace(0.0, 1.0, 3), dt0=1e-5,
                                      num_derivatives=6)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        solve(y0s, torch.full((batch,), 1e-6, device=cuda_device))
    assert kernels.LAUNCHES == before
