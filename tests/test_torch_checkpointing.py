"""The port's training-state checkpoints and resume (``checkpointing`` and
``train.fit(checkpoint_dir=)``), on the cases of
``tests/test_checkpointing.py``: a ``fit`` interrupted at step k and rerun
with the same directory reproduces the uninterrupted run exactly, because
the optimizer's state round-trips, not just the parameters.
"""

import functools
import os

import numpy as np
import pytest
import torch

from odecheckpts_torch import checkpointing, train

ADAM = functools.partial(torch.optim.Adam, lr=0.1)


def _quadratic_loss():
    target = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)

    def loss_fn(theta):
        return torch.sum((theta["w"] - target) ** 2) + theta["b"] ** 2

    theta0 = {"w": torch.zeros(3, dtype=torch.float64), "b": torch.tensor(1.0, dtype=torch.float64)}
    return loss_fn, theta0


def test_save_restore_roundtrip(tmp_path):
    w = torch.arange(3.0, requires_grad=True)
    opt = torch.optim.Adam([w], lr=1e-2)
    w.sum().backward()
    opt.step()
    state = {"theta": {"w": torch.arange(3.0), "b": torch.tensor(2.0)},
             "opt_state": opt.state_dict(), "losses": torch.tensor([3.0, 2.0])}
    checkpointing.save(tmp_path, 7, state)
    assert checkpointing.latest_step(tmp_path) == 7
    restored = checkpointing.restore(tmp_path)
    assert restored["step"] == 7
    np.testing.assert_allclose(restored["theta"]["w"], np.arange(3.0))
    np.testing.assert_allclose(restored["losses"], [3.0, 2.0])
    saved = state["opt_state"]["state"][0]
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(restored["opt_state"]["state"][0][key], saved[key])
    # no temporary file is left beside the checkpoint
    assert sorted(os.listdir(tmp_path)) == ["step_7.pt"]


def test_max_to_keep_prunes_old_steps(tmp_path):
    for step in (1, 2, 3, 4):
        checkpointing.save(tmp_path, step, {"x": torch.ones(2)}, max_to_keep=2)
    assert checkpointing.latest_step(tmp_path) == 4
    assert checkpointing.restore(tmp_path, step=3) is not None
    with pytest.raises(FileNotFoundError):
        checkpointing.restore(tmp_path, step=1)


def test_restore_empty_dir_returns_none(tmp_path):
    assert checkpointing.restore(tmp_path / "nothing") is None
    assert checkpointing.latest_step(tmp_path / "nothing") is None


def test_a_failed_save_keeps_the_latest_step(tmp_path):
    """A save that fails while writing leaves the previous step whole (the
    write goes to a temporary name, renamed only once complete)."""
    checkpointing.save(tmp_path, 1, {"x": torch.ones(2)})

    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError("cannot write")

    with pytest.raises(Exception):
        checkpointing.save(tmp_path, 2, {"x": Unpicklable()})
    assert checkpointing.latest_step(tmp_path) == 1
    assert sorted(os.listdir(tmp_path)) == ["step_1.pt"]
    assert torch.equal(checkpointing.restore(tmp_path)["x"], torch.ones(2))


def test_fit_resume_matches_uninterrupted_run(tmp_path):
    loss_fn, theta0 = _quadratic_loss()
    theta_full, losses_full = train.fit(loss_fn, theta0, ADAM, num_steps=20)

    ckpt = tmp_path / "run"
    # phase 1: stops after 10 steps, checkpointing every 5
    train.fit(loss_fn, theta0, ADAM, num_steps=10, checkpoint_dir=ckpt, checkpoint_every=5)
    assert checkpointing.latest_step(ckpt) == 10
    # phase 2: the same call with the full num_steps resumes at step 10
    theta_b, losses_b = train.fit(loss_fn, theta0, ADAM, num_steps=20, checkpoint_dir=ckpt,
                                  checkpoint_every=5)
    assert len(losses_b) == 20
    np.testing.assert_allclose(losses_b, losses_full, rtol=1e-12)
    for key in theta_full:
        np.testing.assert_allclose(theta_b[key].numpy(), theta_full[key].numpy(), rtol=1e-12)


def test_fit_resume_restores_optimizer_state_not_just_theta(tmp_path):
    """Adam's moment buffers must survive the round trip: restarting with a
    fresh optimizer state from the checkpointed theta gives a different
    trajectory."""
    loss_fn, theta0 = _quadratic_loss()
    _theta_full, losses_full = train.fit(loss_fn, theta0, ADAM, num_steps=20)

    ckpt = tmp_path / "run"
    train.fit(loss_fn, theta0, ADAM, num_steps=10, checkpoint_dir=ckpt, checkpoint_every=10)
    state = checkpointing.restore(ckpt)
    _theta_c, losses_c = train.fit(loss_fn, state["theta"], ADAM, num_steps=10)
    assert not np.allclose(losses_c, losses_full[10:], rtol=1e-6)
    _theta_d, losses_d = train.fit(loss_fn, theta0, ADAM, num_steps=20, checkpoint_dir=ckpt)
    np.testing.assert_allclose(losses_d[10:], losses_full[10:], rtol=1e-12)
