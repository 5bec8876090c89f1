"""The port's driver entry points on the CPU: ``odecheckpts_torch.entry``
(the single-device forward solve, and the multi-device dry run on two gloo
ranks) and ``odecheckpts_torch.multihost_demo``.  Each multi-process case
is one spawn of two ranks; neither imports JAX."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from odecheckpts_torch import entry

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def test_entry_solves_on_the_requested_device():
    fn, (u0s, tols) = entry.entry(device="cpu")
    assert u0s.device.type == "cpu" and u0s.dtype == torch.float32
    u, num_steps = fn(u0s, tols)
    assert tuple(u.shape) == (8, 5, 3) and tuple(num_steps.shape) == (8,)
    assert bool(torch.all(torch.isfinite(u))) and int(num_steps.min()) > 0


def test_dryrun_multichip_on_two_cpu_ranks():
    """Every part of the dry run passes on two gloo ranks (the kernels'
    plain versions on CPU tensors): the dp step, the sharded K1, K2, K5, K6
    and K7 engines, uneven shards and the time-sharded solve."""
    proc = subprocess.run([sys.executable, "-m", "odecheckpts_torch.entry", "--device", "cpu",
                           "--ranks", "2"], capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for part in ("dp train step ok", "(K1) ok", "(K2) ok", "dense (K5) engine ok",
                 "blockdiag (K6) engine ok", "every-step (K7) engine ok", "uneven shards",
                 "time-sharded parallel-in-time (K8) ok"):
        assert part in proc.stdout, (part, proc.stdout)


def test_dryrun_refuses_more_cards_than_there_are():
    with pytest.raises(RuntimeError, match="need 64 CUDA devices"):
        entry.dryrun_multichip(64)


def test_multihost_demo_prints_all_ok():
    proc = subprocess.run([sys.executable, "-m", "odecheckpts_torch.multihost_demo"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT, env=ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ALL OK" in proc.stdout and proc.stdout.count("sharded fused solve ok") == 2
