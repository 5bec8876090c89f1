"""The f64 judge of the port's f32 results (a helper of the port's tests,
not a test module: pytest collects no test from it).

An f32 result of the port is first held against the reference's f32 result
at the test's tolerance, lane by lane.  A lane that misses is judged by the
reference's f64 result on the exactly widened inputs: the port's distance to
it may be no more than ``FACTOR`` (2) times the reference's own f32
distance, or within the tolerance.

Why: the reference's f32 results depend on the host.  On a lane whose state
is ill-conditioned (a cancelling residual, a near-singular QR) two f32
evaluations that round in another order land far apart, and which one lands
nearer the exact result is not the port's doing; XLA's CPU backend, for
one, contracts multiply-adds into FMA on hosts that have them, and PyTorch's
vectorized CPU exp, log and sqrt differ by instruction set.  There an
f32-against-f32 comparison measures the host.  Judged by f64, an f32 result
is as good as the reference's own, or it is a fault.

The reference's own f32 distance on such a lane is one draw of roundoff:
on an AMD EPYC host with AVX-512 the port's distance is up to 5.9 times the
reference's one draw in ``test_torch_dense.py``'s TS1 attempts and 3.2
times in ``test_torch_everystep.py``'s, while over the reference's attempts
from the same state with its mean moved by one ulp (8 draws, each against
its own f64 result) the reference lands as far as the port or farther
(0.58-0.99 times the port's distance there).  So where one draw does not
decide, ``draws`` supplies those nudged draws and the reference's own
distance is the largest of them.  A lane where every draw of the reference
is within 1e-5 of f64 is held within 2e-5 of f64 or the tolerance: the
``*_catches_seeded_faults`` tests seed a fault of 5e-5 of the array's
largest entry there.

A distance is per lane: the lane's largest deviation over the largest
entry of the array's f64 result (or of the lane's own, with ``lane_scale``).
"""

import numpy as np

FACTOR = 2.0
# one-ulp nudges of the start state's mean from which the reference's own
# f32 distance is drawn (numpy seed NUDGE_SEED)
NUDGES = 8
NUDGE_SEED = 123


def _per_lane_max(x, lane_axis):
    x = np.moveaxis(x, lane_axis, -1)
    return np.max(x.reshape(-1, x.shape[-1]), axis=0)


def lane_distances(x, ref, lane_axis=-1, lane_scale=False):
    """Per lane: the largest deviation of ``x`` from ``ref`` over the largest
    absolute entry of ``ref``, or of the lane's part of ``ref`` with
    ``lane_scale`` (NaN where ``x`` is NaN and ``ref`` is not)."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    tiny = np.finfo(np.float64).tiny
    if lane_scale:
        scale = np.maximum(_per_lane_max(np.abs(ref), lane_axis), tiny)
    else:
        scale = max(float(np.max(np.abs(ref))), tiny)
    return _per_lane_max(np.abs(x - ref), lane_axis) / scale


def _lanes_close(g, w, rtol, atol, lane_axis):
    close = (np.abs(g - w) <= atol + rtol * np.abs(w)) | (np.isnan(g) & np.isnan(w))
    return _per_lane_max(~close, lane_axis) == 0


def assert_as_accurate_as_reference(got, want, ref, rtol, *, atol=None, lane_axis=-1,
                                    lane_scale=False, draws=None, what="array"):
    """Every lane of ``got`` (the port, f32) within ``rtol`` of ``want`` (the
    reference, f32) and ``atol`` (default: ``rtol`` times the largest entry
    of ``want``), or no farther from ``ref`` (the reference in f64) than
    ``FACTOR`` times the reference's own f32 distance, or ``rtol``
    (``lane_distances`` with ``lane_scale``).  The reference's own distance
    is ``want``'s, or with ``draws`` (a callable returning pairs of the
    reference's f32 and f64 results on nudged inputs, called only where
    ``want`` alone does not decide) the largest of ``want``'s and theirs."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape == np.shape(ref), (what, g.shape, w.shape, np.shape(ref))
    atol = rtol * np.max(np.abs(w)) if atol is None else atol
    missed = ~_lanes_close(g, w, rtol, atol, lane_axis)
    if not np.any(missed):
        return
    port = lane_distances(g, ref, lane_axis, lane_scale)
    own = lane_distances(w, ref, lane_axis, lane_scale)
    bad = missed & ~(port <= np.maximum(FACTOR * own, rtol))
    if np.any(bad) and draws is not None:
        for w_k, r_k in draws():
            own = np.maximum(own, lane_distances(w_k, r_k, lane_axis, lane_scale))
        bad = missed & ~(port <= np.maximum(FACTOR * own, rtol))
    assert not np.any(bad), (
        f"{what}: lanes {np.flatnonzero(bad).tolist()} of the port are farther from the "
        f"reference's f64 result ({port[bad]}) than {FACTOR} times the reference's own f32 "
        f"result ({own[bad]}) and than {rtol}")


def nudged_means(state, mean_index=1, count=NUDGES, seed=NUDGE_SEED):
    """``count`` copies of the f32 ``state`` (a tuple of arrays) whose mean
    (array ``mean_index``) has each entry moved by -1, 0 or +1 ulp."""
    rng = np.random.default_rng(seed)
    x = np.asarray(state[mean_index])
    up, down = np.nextafter(x, x.dtype.type(np.inf)), np.nextafter(x, x.dtype.type(-np.inf))
    out = []
    for _ in range(count):
        sign = rng.integers(-1, 2, x.shape)
        mean = np.where(sign > 0, up, np.where(sign < 0, down, x))
        out.append(tuple(state[:mean_index]) + (mean,) + tuple(state[mean_index + 1:]))
    return out


def assert_same_accepted(got_t, want_t, start_t):
    """The port and the reference accepted the same lanes: a lane's time
    moved in both or in neither."""
    got, want = np.asarray(got_t) != np.asarray(start_t), np.asarray(want_t) != np.asarray(start_t)
    assert np.array_equal(got, want), (
        f"accepted lanes differ: port {np.flatnonzero(got).tolist()}, "
        f"reference {np.flatnonzero(want).tolist()}")
    assert np.any(got), "no lane accepted"


def shifted_lane(x, lane, lane_axis=-1, by=5e-5):
    """A seeded fault: ``x`` with ``by`` times its largest entry added to
    every entry of one lane (a fault of ``by`` in the tests' measure)."""
    out = np.array(x, copy=True)
    idx = [slice(None)] * out.ndim
    idx[lane_axis] = lane
    out[tuple(idx)] = out[tuple(idx)] + out.dtype.type(by * np.max(np.abs(out)))
    return out


def off_by_one(x, lane_axis=-1):
    """A seeded fault: every lane of ``x`` takes its neighbour's values (an
    index off by one)."""
    return np.roll(np.asarray(x), 1, axis=lane_axis)


def well_conditioned_lane(want, ref, lane_axis=-1, bound=1e-5, draws=()):
    """A lane where the reference's f32 result, and each of its ``draws``
    (pairs of f32 and f64 results), is within ``bound`` of its f64 result,
    and whose largest entry is the largest of such lanes: a fault there must
    not hide in f32 noise."""
    own = lane_distances(want, ref, lane_axis)
    for w_k, r_k in draws:
        own = np.maximum(own, lane_distances(w_k, r_k, lane_axis))
    mag = _per_lane_max(np.abs(np.asarray(ref, np.float64)), lane_axis)
    candidates = np.flatnonzero(own <= bound)
    assert candidates.size, f"no lane of the reference's f32 result is within {bound} of f64"
    return int(candidates[np.argmax(mag[candidates])])
