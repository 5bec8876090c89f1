"""Measurement helpers (PyTorch counterpart of ``odecheckpts_tpu.harness``).

* ``workprec``            -- parameter -> (work, precision) sweeps, the
  reference's record schema (``run_simple.py:208-215``)
* ``rmse_absolute``       -- RMSE against a reference trajectory
* ``timeit_fun``          -- warm-up + ``timeit.repeat`` protocol
* ``jit_and_time``        -- warm-started wall clock (a warm-up call, then a
  timed call; PyTorch has nothing to compile)
* ``runtime_min``         -- min-of-R protocol
* ``timed_cold``          -- one call from an emptied allocator cache
* ``nbytes_of_tree``      -- bytes of a tree's tensors raveled to one dtype
* ``device_memory_stats`` -- free / total bytes and allocator statistics per
  CUDA device
* ``debug_nans`` / ``nan_guard`` -- raise on non-finite values
* ``profiler_trace`` / ``annotate`` -- ``torch.profiler`` trace and spans
"""

from __future__ import annotations

import contextlib
import math
import os
import statistics
import time
import timeit
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode


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


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def timeit_fun(repeats: int = 3) -> Callable:
    def timer(fun, /):
        _ = fun()  # warm-up
        return list(timeit.repeat(fun, number=1, repeat=repeats))

    return timer


def runtime_min(function: Callable, num_runs: int = 3) -> float:
    cts = []
    for _ in range(num_runs):
        t0 = time.perf_counter()
        device_sync(function())
        cts.append(time.perf_counter() - t0)
    return min(cts)


def jit_and_time(fun: Callable) -> Callable:
    """Warm-started wall-clock timing of a thunk: ``fun_wrapped()`` calls it
    once, then times a second call; returns (runtime_seconds, output)."""

    def fun_wrapped():
        device_sync(fun())
        t0 = time.perf_counter()
        out = device_sync(fun())
        return time.perf_counter() - t0, out

    return fun_wrapped


def timed_cold(fun: Callable, *args, **kwargs):
    """One call's wall clock from an emptied CUDA allocator cache (the
    allocation profile of a cold solve, as the memory-scaling experiment
    wants it); returns (seconds, output)."""
    device_sync(None)
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = device_sync(fun(*args, **kwargs))
    return time.perf_counter() - t0, out


def nbytes_of_tree(tree) -> int:
    """Bytes of every tensor of ``tree`` raveled into one vector of their
    promoted dtype (``jax.flatten_util.ravel_pytree``'s ``nbytes``)."""
    leaves = [torch.as_tensor(x) for x in _leaves(tree)]
    if not leaves:
        return 0
    dtype = leaves[0].dtype
    for x in leaves[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return sum(x.numel() for x in leaves) * dtype.itemsize


def device_memory_stats():
    """Per CUDA device: free and total bytes (``torch.cuda.mem_get_info``)
    and the caching allocator's ``memory_stats``; ``{"cpu": None}`` without
    a card."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {"free": free, "total": total, **torch.cuda.memory_stats(i)}
    return out


def workprec(fun, *, precision_fun: Callable, timeit_fun: Callable) -> Callable:
    """Turn param -> (solution, aux) into params -> work-precision records,
    the reference's schema (``run_simple.py:208-215``): list_of_args /
    length_of_longest_vector / work_min / work_mean / work_std /
    precision."""

    def parameter_list_to_workprecision(list_of_args, /):
        works_min, works_mean, works_std = [], [], []
        precisions, lengths = [], []
        for arg in list_of_args:
            sol, aux = fun(arg)
            precisions.append(float(precision_fun(sol)))
            lengths.append(len(aux["u0_solve"]))
            times = timeit_fun(lambda: device_sync(fun(arg)[0]))  # noqa: B023
            works_min.append(min(times))
            works_mean.append(statistics.mean(times))
            works_std.append(statistics.stdev(times) if len(times) > 1 else 0.0)
        return {
            "list_of_args": list_of_args,
            "length_of_longest_vector": torch.tensor(lengths),
            "work_min": torch.tensor(works_min, dtype=torch.float64),
            "work_mean": torch.tensor(works_mean, dtype=torch.float64),
            "work_std": torch.tensor(works_std, dtype=torch.float64),
            "precision": torch.tensor(precisions, dtype=torch.float64),
        }

    return parameter_list_to_workprecision


def _check_finite(leaves, where):
    for i, leaf in enumerate(leaves):
        if (leaf.is_floating_point() or leaf.is_complex()) and not bool(
                torch.all(torch.isfinite(leaf))):
            raise FloatingPointError(f"non-finite values in output {i} of {where}")


class debug_nans(TorchDispatchMode):
    """Context: raise ``FloatingPointError`` at the first operation whose
    floating output holds a non-finite value (``jax_debug_nans``' semantics;
    ``torch.autograd.detect_anomaly`` checks the backward pass only).  Every
    operation in the scope is checked, at one host read each."""

    def __init__(self, enable: bool = True):
        super().__init__()
        self.enable = enable

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.enable:
            _check_finite(_leaves(out), func)
        return out


def nan_guard(fn, name: str = "function"):
    """Wrap ``fn``: raise ``FloatingPointError`` if any floating output
    tensor holds a non-finite value."""

    def guarded(*args, **kwargs):
        out = fn(*args, **kwargs)
        _check_finite(_leaves(out), name)
        return out

    return guarded


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Context: a ``torch.profiler`` trace of the region (host, and the card
    where there is one), written to ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span in the profiler timeline."""
    return torch.profiler.record_function(name)
