"""K10 and K11 (``odecheckpts_torch/csrc/qr_packing.cu``), compiled for the
CPU and held against their plain versions bit for bit.

The source is compiled with ``g++ -O1 -ffp-contract=off`` against
``torch_cuda_shim.SHIM`` (a team's shuffles between two waits at its warp's
barrier, every thread of a block a ``std::thread``), once as built for the
card (teams of 1 and ``kernels.QR_PACKING_TEAM`` threads a lane) and once
for each other team width the design was measured at, 2 and 8
(``-DQR_PACKING_TEAM``).  Each case runs both C entries through ctypes with
its team on a ragged batch of 37 lanes (a block and a part of one at every
width but 1) at every built (m, n) and 1 and 3 QRs, and requires each
output to equal ``kernels.qr_packing_cols_plain`` /
``qr_packing_masked_plain`` bit for bit; a team the library was not built
for is refused.  Skips only where ``g++`` is absent.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cuda_shim as shim

from odecheckpts_torch import kernels

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
LANES = 37
TEAMS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """team width -> the library that runs it."""
    libs = {}
    for team in (None, 2, 8):
        name = f"qr_packing_{team or 'card'}"
        flags = () if team is None else (f"-DQR_PACKING_TEAM={team}",)
        lib = shim.build(CSRC, ("qr_packing.cu",), tmp_path_factory.mktemp(name), name,
                         flags=flags)
        if lib is None:
            pytest.skip("g++ is not on PATH: the CPU rehearsal of K10 and K11 needs it")
        libs[team] = lib
    libs[1] = libs[kernels.QR_PACKING_TEAM] = libs.pop(None)
    return libs


def _run(lib, kernel, x, iters, team):
    out = torch.empty_like(x)
    fn = getattr(lib, f"odeckpt_{kernel}")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    m, n, batch = x.shape
    rc = fn(m, n, iters, team, x.data_ptr(), out.data_ptr(), batch, 0, None)
    return rc, out


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("shape", kernels.QR_PACKING_SHAPES)
@pytest.mark.parametrize("kernel", ["qr_packing_cols", "qr_packing_masked"])
def test_qr_packing_source_matches_its_plain_version_bit_for_bit(rehearsal, kernel, shape,
                                                                   iters, team):
    m, n = shape
    x = torch.tensor(np.random.default_rng(75).standard_normal((m, n, LANES)),
                     dtype=torch.float32)
    rc, got = _run(rehearsal[team], kernel, x, iters, team)
    assert rc == 0
    want = getattr(kernels, kernel + "_plain")(x, iters)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        f"{kernel} {shape} iters {iters} team {team}: max |diff| "
        f"{float((got - want).abs().max())}")
    unbuilt = 2 if team != 2 else 8
    assert _run(rehearsal[team], kernel, x, iters, unbuilt)[0] != 0
