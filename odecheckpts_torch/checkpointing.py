"""Training-state checkpoints and resume (PyTorch counterpart of
``odecheckpts_tpu.checkpointing``).

A checkpoint is one ``torch.save`` file ``step_<n>.pt`` under a directory,
holding a dict such as ``train.fit``'s ``{"theta", "opt_state", "losses"}``
(``opt_state`` an optimizer's ``state_dict()``).  Each save is written to a
temporary name and then renamed with ``os.replace``, so a crash never leaves
a half-written latest step; ``max_to_keep`` prunes the oldest steps.
``latest_step`` / ``restore`` find and load the newest step.
"""

from __future__ import annotations

import os
import pathlib
import re
from typing import Any, Optional

import torch

_STEP_RE = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory) -> list[tuple[int, pathlib.Path]]:
    directory = pathlib.Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for child in directory.iterdir():
        m = _STEP_RE.match(child.name)
        if m and child.is_file():
            out.append((int(m.group(1)), child))
    return sorted(out)


def latest_step(directory) -> Optional[int]:
    """The largest saved step number under ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1][0] if steps else None


def save(directory, step: int, state: Any, *, max_to_keep: Optional[int] = 3):
    """Write ``state`` (tensors, numbers, strings and their lists, tuples and
    dicts) as step ``step``, then keep only the newest ``max_to_keep`` steps
    (all with None).  Returns the file's path."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"step_{step}.pt"
    tmp = directory / f".step_{step}.pt.tmp{os.getpid()}"
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    if max_to_keep is not None:
        steps = _steps(directory)
        for _n, old in steps[: max(0, len(steps) - max_to_keep)]:
            old.unlink(missing_ok=True)
    return path


def restore(directory, step: Optional[int] = None, *, map_location=None) -> Optional[dict]:
    """Load step ``step`` (the latest by default) onto ``map_location`` (where
    it was saved by default), with ``"step"`` added; None if nothing was
    saved.  A step that is not there raises ``FileNotFoundError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = pathlib.Path(directory) / f"step_{step}.pt"
    state = torch.load(path, map_location=map_location, weights_only=True)
    state["step"] = step
    return state
