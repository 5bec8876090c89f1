"""Measurement helpers (PyTorch counterpart of the parts of
``odecheckpts_tpu.harness`` that the port uses)."""

from __future__ import annotations

import math

import torch


def rmse_absolute(expected):
    expected = torch.as_tensor(expected)

    def rmse(received):
        err = torch.abs(expected - torch.as_tensor(received, dtype=expected.dtype))
        return torch.linalg.norm(err) / math.sqrt(err.numel())

    return rmse


def device_sync(tree):
    """Wait for the current CUDA device to finish the work queued so far and
    return ``tree``; end every timed region with this.  A no-op when CUDA was
    never used in the process."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return tree
