"""The port's f32 fixedpoint smoothing against the JAX reference, judged by
the reference's f64 solve.

At rtol 1e-6 a checkpoint that falls just above ``_interpolate_at``'s snap
threshold eps^0.75 max(|t|, 1) after a lane's last step emits a conditional
that amplifies the roundoff of the f32 state, and there an f32 smoothed
value can miss by far more than the tolerance.  Which lanes meet that is a
matter of roundoff too: it moves the last step.  The reference jitted on
the CPU hides most of the tail: LLVM contracts its multiply-adds into FMA.
Without the contraction (``torch_uncontracted``: the reference jitted so
that it equals its op-by-op arithmetic bit for bit, every operation rounded
on its own, as in the port's twin and in its kernels, built with
``-fmad=false``) the reference has the tail as the port does: the port's
tail is the arithmetic, not a port fault.  The port's CPU arithmetic and
the uncontracted reference's are the same on every host, so are the counts.

This file imports JAX; it runs on the CPU (under a minute).
"""

import numpy as np

import torch_uncontracted as uncontracted

FACTORS = (10, 100, 300)  # of rtol: the misses counted


def test_f32_smoothing_tail_is_the_uncontracted_references():
    """On 1,024 perturbed rigid bodies at rtol 1e-6 with 17 checkpoints, the
    smoothed values that miss the f64 solve by more than 10, 100 and 300
    rtol: the port's count at most 1.5 times the uncontracted reference's
    plus 5 at each; the uncontracted reference has the tail (at least 10
    misses over 100 rtol), and the reference jitted as it is (FMA-contracted)
    a quarter of it or less."""
    premise, distances = uncontracted.tail_distances()
    assert premise.all(), f"jitted under {uncontracted.FLAGS}, the step is not op by op: {premise}"
    counts = {k: [int(np.sum(v > f * uncontracted.TAIL_RTOL)) for f in FACTORS]
              for k, v in distances.items()}
    port, plain, fma = counts["port"], counts["uncontracted"], counts["contracted"]
    assert plain[1] >= 10, counts
    assert 4 * fma[1] <= plain[1], counts
    assert all(p <= 1.5 * u + 5 for p, u in zip(port, plain)), counts
