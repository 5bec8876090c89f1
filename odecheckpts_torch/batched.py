"""Batched fixed-memory adaptive solver with the whole accept/reject loop of a
checkpoint interval in one kernel (PyTorch counterpart of
``odecheckpts_tpu.batched``).

The isotropic TS0 fixedpoint step is written *lanes-last*: every array
carries the IVP-ensemble axis as its last dimension.  ``StepLL`` is that step
in plain vectorized torch ops (the "twin"); ``kernels.step_ll_interval``
runs a whole checkpoint interval of it as the hand-written CUDA kernel
``csrc/step_ll.cu``.  Between intervals the driver runs the generic stack:
it converts the state to batch-leading tensors, interpolates at the
checkpoint, and converts back.  After the last interval it runs the
smoothing pass.

Ported configuration: isotropic backend, TS0, ``ode_order=1``, fixedpoint,
dynamic calibration, ``error_unit="qoi"``, any error calibration (kappa),
``num_derivatives`` in {2, 3, 4}.  Everything else raises
``NotImplementedError`` naming the ROADMAP item that ports it.

``engine="cuda"`` runs the per-attempt kernel K3 (``kernels.step_ll_attempt``)
under a host loop instead; ``make_bucketed_solver`` sorts a mixed-tolerance
ensemble into buckets.  The df32 engine is ``batched_hi``, the dense one
``batched_dense``, the blockdiag one ``batched_blockdiag``; the
save-every-step driver on ``StepLL``'s smoother and filter strategies is
``batched_everystep``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import ivpsolvers, kernels, prior, rounded, stats, taylor
from .ivpsolve import Control, _expand, _interpolate_at, _State
from .ssm.base import Conditional, MarkovSeq, Normal

# state tuple layout (all lanes-last):
#   0 t (1,B)        1 mean (n,d,B)    2 chol (n,n,B)
#   3 bwdG (n,n,B)   4 bwd_m (n,d,B)   5 bwd_L (n,n,B)
#   6 scale (1,B)    7 t_prev (1,B)    8 mean_prev      9 chol_prev
#   10 bwdG_prev     11 bwd_m_prev     12 bwd_L_prev
#   13 dt (1,B)      14 errn_prev (1,B) 15 nsteps (1,B) float  16 mle (1,B)
NUM_STATE = 17
SUPPORTED_NU = (2, 3, 4)


def _constants(nu):
    a, l_q, _ = prior._ibm_constants_f64(nu)
    return (
        [[float(x) for x in row] for row in np.asarray(a)],
        [[float(x) for x in row] for row in np.asarray(l_q)],
        [float(np.linalg.norm(np.asarray(l_q)[k, :])) for k in range(nu + 1)],
        [1.0 / math.factorial(nu - i) for i in range(nu + 1)],
    )


def _rowsum(x):
    """Sum over the leading (row) axis in row order, keeping it as size 1."""
    acc = x[0:1]
    for r in range(1, x.shape[0]):
        acc = acc + x[r : r + 1]
    return acc


def _qr_r_cols(cols, m, n_reflect, eps):
    """Householder QR on a column list: ``cols`` is (c, m, B), column c at
    ``cols[c]`` (or (c, m, d, B): one QR per channel and lane).  The first ``min(n_reflect, m - 1)`` reflections are applied
    to every later column; with ``n_reflect = c`` the columns come out upper
    triangular in their first min(m, c) rows.  No rescaling and no sign
    normalization: this is the kernels' QR, not ``linalg.qr_r``."""
    rows = torch.arange(m, device=cols.device).reshape((m,) + (1,) * (cols.dim() - 2))
    cols = cols.clone()
    for j in range(min(n_reflect, m - 1)):
        col = cols[j]
        below = (rows >= j).to(cols.dtype)
        is_j = (rows == j).to(cols.dtype)
        colm = col * below
        norm2 = _rowsum(colm * colm)
        norm = rounded.sqrt(norm2 + eps)
        head = _rowsum(colm * is_j)
        one = torch.ones_like(head)
        sign = torch.where(head >= 0, one, -one)
        alpha = -sign * norm
        v = colm - is_j * alpha
        vnorm2 = norm2 + alpha * alpha - 2.0 * head * alpha
        safe = vnorm2 > eps
        inv = torch.where(
            safe, torch.full_like(vnorm2, 2.0) / torch.where(safe, vnorm2, one),
            torch.zeros_like(vnorm2),
        )
        rest = cols[j:]
        coeff = v[0] * rest[:, 0]
        for r in range(1, m):
            coeff = coeff + v[r] * rest[:, r]
        cols[j:] = rest - (inv * v)[None] * coeff[:, None]
    return cols


def _tri_solve_upper_ll(r, b, n):
    """Solve R X = B for upper-triangular (n, n, B) R and (n, n, B) B (or
    (n, n, d, B) each: one solve per channel and lane).

    Directions whose diagonal is below eps^2 are zeroed: after the per-lane
    normalization the columns are O(1), so such a diagonal carries no
    information and the bounded limit of the gain there is zero.
    """
    eps2 = float(torch.finfo(r.dtype).eps) ** 2
    rows = [None] * n
    for i in reversed(range(n)):
        acc = b[i]
        for j in range(i + 1, n):
            acc = acc - r[i][j][None] * rows[j]
        d = r[i][i]
        ok = torch.abs(d) > eps2
        d_safe = torch.where(ok, d, torch.ones_like(d))
        rows[i] = torch.where(ok[None], acc / d_safe[None], torch.zeros_like(acc))
    return torch.stack(rows, dim=0)


def _const_matmul(a_rows, x):
    """(n, n) matrix of Python constants times an (n, ..., B) stack, skipping
    zero entries and multiplications by one."""
    out = []
    for row in a_rows:
        acc = None
        for j, c in enumerate(row):
            if c == 0.0:
                continue
            term = x[j] if c == 1.0 else c * x[j]
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else torch.zeros_like(x[0]))
    return torch.stack(out, dim=0)


def _matmul_ll(a, b, n):
    """(n, n, B) @ (n, k, B) batched over lanes (and over any axes between,
    as (n, n, d, B) @ (n, k, d, B)), summed in column order."""
    out = a[:, 0:1] * b[0:1]
    for j in range(1, n):
        out = out + a[:, j : j + 1] * b[j : j + 1]
    return out


class _StepConstants:
    """The constants of a lanes-last step, each a Python float rounded to
    ``dtype`` once, so the twin and the kernel (which receives the same
    rounded values in its parameter bank, see ``_pack``) do the same
    arithmetic."""

    def __init__(self, *, nu, d, error_calibration, control, dtype):
        self.nu, self.d, self.dtype = nu, d, dtype
        self.control = ctrl = control or Control()
        rnd = (lambda x: float(np.float32(x))) if dtype == torch.float32 else float
        self.rnd = rnd
        a_rows, lq_rows, lq_norms, inv_fact = _constants(nu)
        self.a_rows = [[rnd(c) for c in row] for row in a_rows]
        self.lq_rows = [[rnd(c) for c in row] for row in lq_rows]
        self.lq_norms = [rnd(c) for c in lq_norms]
        self.inv_fact = [rnd(c) for c in inv_fact]
        self.max_lq = rnd(max(abs(c) for row in lq_rows for c in row))
        self.a_inf_norm = rnd(max(1.0, max(sum(abs(c) for c in row) for row in a_rows)))
        self.sqrt_d = rnd(math.sqrt(1.0 * d))
        self.kappa = rnd(float(error_calibration))
        self.neg_n1 = rnd(-ctrl.power_integral / (nu + 1.0))
        self.n2 = rnd(ctrl.power_proportional / (nu + 1.0))
        self.safety = rnd(ctrl.safety)
        self.factor_min = rnd(ctrl.factor_min)
        self.factor_max = rnd(ctrl.factor_max)
        fi = torch.finfo(dtype)
        self.big = rnd(float(fi.max) ** 0.4)
        self.clip = rnd(1e30)
        self.tiny = float(fi.tiny)
        self._lq = {}

    def _pack(self, nmax, extra):
        """Constant buffer: A and Lq padded to (nmax, nmax), ||Lq[k, :]||,
        1/(nu-i)! padded to nmax, then the scalars in ``extra``."""
        n = self.nu + 1
        a = np.zeros((nmax, nmax))
        lq = np.zeros((nmax, nmax))
        a[:n, :n] = self.a_rows
        lq[:n, :n] = self.lq_rows
        pad = [0.0] * (nmax - n)
        return np.array(
            list(a.ravel()) + list(lq.ravel())
            + self.lq_norms + pad + self.inv_fact + pad + list(extra),
            dtype=np.float32,
        )

    def _lq_const(self, like):
        key = (like.device, like.dtype)
        if key not in self._lq:
            self._lq[key] = torch.tensor(
                self.lq_rows, dtype=like.dtype, device=like.device
            )[:, :, None]
        return self._lq[key]

    def _precond(self, dt):
        """The (1, B) rows p_i = sqrt(dt) dt^(nu-i) / (nu-i)!."""
        n = self.nu + 1
        pows = [None] * n
        pows[self.nu] = torch.ones_like(dt)
        for i in reversed(range(self.nu)):
            pows[i] = pows[i + 1] * dt
        sq = rounded.sqrt(dt)
        return [sq * pows[i] * self.inv_fact[i] for i in range(n)]


STRATEGIES = ("fixedpoint", "smoother", "filter")


def functor_params(vf, params):
    """The kernel arguments of ``vf``'s device functor: ``vf.device_params``
    (a tuple, or a function of the parameters) where the vector field names
    its own, else the parameters themselves."""
    device_params = getattr(vf, "device_params", params)
    return tuple(device_params(params) if callable(device_params) else device_params)


class StepLL(_StepConstants):
    """One lanes-last adaptive attempt of the isotropic TS0 solver with
    dynamic calibration: the plain-torch twin of the K1 and K3 kernels
    (``strategy="fixedpoint"``) and of K7 (``"smoother"``, ``"filter"``).

    The fixedpoint strategy accumulates the backward conditional since the
    last checkpoint; the smoother keeps the one-step conditional of the
    attempt; the filter runs no reversal (a (2n, n) QR gives the predicted
    factor, and the backward arrays pass through unchanged).

    Every constant is a Python float, rounded to ``dtype`` once (see
    ``_StepConstants``).  Sums over the small row axes run in the
    reference's order.
    """

    def __init__(self, vf, params, *, nu, d, error_calibration, control=None,
                 dtype=torch.float32, strategy="fixedpoint"):
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
        self.strategy = strategy
        if nu not in SUPPORTED_NU:
            raise NotImplementedError(
                f"num_derivatives={nu} is not ported yet (the kernel is "
                f"instantiated for {SUPPORTED_NU}): ROADMAP queue 1 item 5"
            )
        super().__init__(nu=nu, d=d, error_calibration=error_calibration,
                         control=control, dtype=dtype)
        self.vf, self.params = vf, params
        self.four_eps = 4.0 * float(torch.finfo(dtype).eps)
        self.device_functor = getattr(vf, "device_functor", None)
        self.functor_params = functor_params(vf, params)

    def packed_constants(self):
        """The kernel's constant buffer (layout of ``Consts`` in step_ll.cu)."""
        return self._pack(max(SUPPORTED_NU) + 1, [
            self.max_lq, self.a_inf_norm, self.sqrt_d, self.kappa, self.neg_n1,
            self.n2, self.safety, self.factor_min, self.factor_max, self.big,
            self.clip,
        ])

    def state_shapes(self, batch):
        """Shapes of the 17 state arrays (layout above ``NUM_STATE``)."""
        n, d, b = self.nu + 1, self.d, batch
        row, nd, nn = (1, b), (n, d, b), (n, n, b)
        return [row, nd, nn, nn, nd, nn, row, row, nd, nn, nn, nd, nn, row, row, row, row]

    def __call__(self, state, t_next, atol, rtol, dt_max, dt_floor, tiny_scale):
        (t, mean, chol, bwdG, bwd_m, bwd_L, scale, t_prev, mean_prev, chol_prev,
         bwdG_prev, bwd_m_prev, bwd_L_prev, dt_st, errn_prev, nsteps, mle) = state
        nu, d = self.nu, self.d
        n = nu + 1

        dt = torch.minimum(torch.maximum(dt_st, dt_floor), dt_max)
        p = self._precond(dt)
        p_arr = torch.cat(p, dim=0)  # (n, B)
        t_new = t + dt

        # -- extrapolate the mean: m_pred = P A P^-1 m
        m_bar = mean / p_arr[:, None, :]
        m_pred = p_arr[:, None, :] * _const_matmul(self.a_rows, m_bar)

        # -- TS0 residual on the first derivative
        u_pred = m_pred[0]
        z = m_pred[1] - self.vf(m_pred[0], t=t_new[0], p=self.params)

        # -- local scale and error (solution units)
        s_unit = p[1] * self.lq_norms[1]
        zz = z[0:1] * z[0:1]
        q = atol + rtol * torch.abs(u_pred[0:1])
        tol_acc = torch.reciprocal(q * q)
        for i in range(1, d):
            zz = zz + z[i : i + 1] * z[i : i + 1]
            q = atol + rtol * torch.abs(u_pred[i : i + 1])
            tol_acc = tol_acc + torch.reciprocal(q * q)
        sigma = rounded.sqrt(zz) / (s_unit * self.sqrt_d)
        err_u = sigma * (p[0] * self.lq_norms[0])
        # divide by a tensor: torch turns division by a Python scalar into a
        # multiplication by its reciprocal, which rounds differently
        errn = self.kappa * err_u * rounded.sqrt(tol_acc / torch.full_like(tol_acc, d))

        # finite ceiling: an overflowed attempt must give a large-but-finite scale
        sigma_safe = torch.where(
            torch.isfinite(sigma), sigma, torch.full_like(sigma, self.big)
        )
        new_scale = torch.clamp(torch.maximum(sigma_safe, tiny_scale), max=self.big)

        # -- extrapolate the covariance with reversal, preconditioned coords
        l_bar = torch.clamp(chol / p_arr[:, None, :], -self.clip, self.clip)
        # per-lane magnitude normalization of the QR blocks
        mag = new_scale * self.max_lq
        for c in range(n):
            mag = torch.maximum(mag, torch.amax(torch.abs(l_bar[c]), dim=0, keepdim=True))
        mag = torch.maximum(mag * self.a_inf_norm, tiny_scale)
        inv_mag = torch.reciprocal(mag)
        l_bar_n = l_bar * inv_mag[None]
        a_l = _const_matmul(self.a_rows, l_bar_n)
        lq_scaled = (new_scale * inv_mag)[None] * self._lq_const(dt)
        magb = mag[None]

        if self.strategy == "filter":
            # no reversal: the predicted factor from a (2n, n) QR
            cols = torch.stack(
                [torch.cat([a_l[c], lq_scaled[c]], dim=0) for c in range(n)]
            )
            cols = _qr_r_cols(cols, 2 * n, n, self.tiny)
            l_pred = p_arr[:, None, :] * cols[:, :n] * magb
        else:
            # revert QR of X = [[ (A Lbar)^T, Lbar^T ], [ Lq^T, 0 ]]: column
            # c < n is [a_l[c]; lq_scaled[c]], column n+c is [l_bar_n[c]; 0]
            zero = torch.zeros_like(a_l[0])
            cols = torch.stack(
                [torch.cat([a_l[c], lq_scaled[c]], dim=0) for c in range(n)]
                + [torch.cat([l_bar_n[c], zero], dim=0) for c in range(n)]
            )
            cols = _qr_r_cols(cols, 2 * n, 2 * n, self.tiny)  # cols[c][r] = R[r][c]
            l_pred_bar = cols[:n, :n] * magb
            r_yy = cols[:n, :n].transpose(0, 1)
            r_yx = cols[n:, :n].transpose(0, 1)
            g_bar = _tri_solve_upper_ll(r_yy, r_yx, n).transpose(0, 1)
            l_bwd_bar = cols[n:, n:] * magb
            l_pred = p_arr[:, None, :] * l_pred_bar
            gain = p_arr[:, None, :] * g_bar / p_arr[None, :, :]
            bwd_L_step = p_arr[:, None, :] * l_bwd_bar
            bwd_m_step = mean - _matmul_ll(gain, m_pred, n)

        # -- TS0 correction (rank-1 update on the observation row)
        l_obs = l_pred[1]
        m2 = torch.abs(l_obs[0:1])
        for i in range(1, n):
            m2 = torch.maximum(m2, torch.abs(l_obs[i : i + 1]))
        m2 = torch.maximum(m2, tiny_scale)
        l_obs_n = l_obs / m2
        s2 = l_obs_n[0:1] * l_obs_n[0:1]
        for i in range(1, n):
            s2 = s2 + l_obs_n[i : i + 1] * l_obs_n[i : i + 1]
        s2 = s2 + self.tiny  # a fully cancelled innovation gives a zero gain
        crosscov = _matmul_ll(l_pred, l_obs_n[:, None, :], n)
        gc = crosscov / s2[None]
        g_corr = gc / m2[None]
        mean_cor = m_pred - g_corr * z[None]
        chol_cor = l_pred - gc * l_obs_n[None]

        # -- the backward conditional the attempt leaves behind
        if self.strategy == "filter":
            bwdG_new, bwd_m_new, bwd_L_new = bwdG, bwd_m, bwd_L
        elif self.strategy == "smoother":
            bwdG_new, bwd_m_new, bwd_L_new = gain, bwd_m_step, bwd_L_step
        else:  # fixedpoint accumulation
            bwdG_new = _matmul_ll(bwdG, gain, n)
            bwd_m_new = _matmul_ll(bwdG, bwd_m_step, n) + bwd_m
            mag_g = tiny_scale
            for c in range(n):
                mag_g = torch.maximum(mag_g, torch.amax(torch.abs(bwdG[c]), dim=0, keepdim=True))
            inv_g = torch.reciprocal(mag_g)
            m1 = _matmul_ll(bwdG * inv_g[None], bwd_L_step, n)
            bl_g = bwd_L * inv_g[None]
            t3 = tiny_scale
            for c in range(n):
                t3 = torch.maximum(t3, torch.amax(torch.abs(m1[c]), dim=0, keepdim=True))
                t3 = torch.maximum(t3, torch.amax(torch.abs(bl_g[c]), dim=0, keepdim=True))
            inv3 = torch.reciprocal(t3)
            cols2 = torch.stack(
                [torch.cat([m1[c] * inv3, bl_g[c] * inv3], dim=0) for c in range(n)]
            )
            cols2 = _qr_r_cols(cols2, 2 * n, n, self.tiny)
            bwd_L_new = (cols2[:, :n] * t3[None]) * mag_g[None]

        # -- PI control
        errn_s = torch.clamp(errn, min=self.tiny)
        factor = self.safety * rounded.exp(
            self.neg_n1 * rounded.log(errn_s)
            + self.n2 * (rounded.log(errn_prev) - rounded.log(errn_s))
        )
        factor = torch.where(
            torch.isfinite(factor), factor, torch.full_like(factor, self.factor_min)
        )
        dt_next = torch.minimum(
            dt * torch.clamp(factor, self.factor_min, self.factor_max), dt_max
        )

        dt_stall = self.four_eps * torch.clamp(torch.abs(t), min=1.0)
        frozen = t >= t_next
        accept = ((errn <= 1.0) | (dt <= dt_stall)) & ~frozen
        upd = ~frozen

        def sel(new, old, mask=accept):
            return torch.where(mask, new, old)  # (1, B) broadcasts on the lanes

        return (
            sel(t_new, t),
            sel(mean_cor, mean),
            sel(chol_cor, chol),
            sel(bwdG_new, bwdG),
            sel(bwd_m_new, bwd_m),
            sel(bwd_L_new, bwd_L),
            sel(new_scale, scale),
            sel(t, t_prev),
            sel(mean, mean_prev),
            sel(chol, chol_prev),
            sel(bwdG, bwdG_prev),
            sel(bwd_m, bwd_m_prev),
            sel(bwd_L, bwd_L_prev),
            sel(dt_next, dt_st, mask=upd),
            sel(errn_s, errn_prev),
            sel(nsteps + 1.0, nsteps),  # accepted steps only
            sel(mle + sigma * sigma, mle),
        )


def make_step_ll(vf, params, *, nu, d, error_calibration=None, control=None,
                 dtype=torch.float32, strategy="fixedpoint"):
    """The twin of K1 and K3 (or, with ``strategy`` "smoother" or "filter",
    of K7) for ``vf`` (row-wise, see ``problems``)."""
    if error_calibration is None:
        error_calibration = ivpsolvers.default_error_calibration("ts0", "qoi")
    return StepLL(vf, params, nu=nu, d=d, error_calibration=error_calibration,
                  control=control, dtype=dtype, strategy=strategy)


def _state_to_generic(state, needs_rev=True):
    """Lanes-last tuple -> batch-leading ``_State`` (any layout: the lane
    axis moves from last to first).  Without reversal (filter) the state
    carries no backward conditionals."""

    def t3(x):  # (a, b, B) -> (B, a, b)
        return torch.movedim(x, -1, 0)

    def t1(x):  # (1, B) -> (B,)
        return x[0]

    if needs_rev:
        bwd = Conditional(t3(state[3]), Normal(t3(state[4]), t3(state[5])))
        bwd_prev = Conditional(t3(state[10]), Normal(t3(state[11]), t3(state[12])))
    else:
        bwd = bwd_prev = None
    return _State(
        t=t1(state[0]),
        rv=Normal(t3(state[1]), t3(state[2])),
        bwd=bwd,
        scale_step=t1(state[6]),
        t_prev=t1(state[7]),
        rv_prev=Normal(t3(state[8]), t3(state[9])),
        bwd_prev=bwd_prev,
        dt=t1(state[13]),
        errn_prev=t1(state[14]),
        num_steps=t1(state[15]).to(torch.int32),
        mle_ssq=t1(state[16]),
    )


def _generic_to_state(s: _State, dtype, needs_rev=True):
    """Batch-leading ``_State`` -> lanes-last tuple; without reversal the
    backward arrays are zeros."""

    def t3(x):
        return torch.movedim(x, 0, -1).contiguous()

    def t1(x):
        return x[None].to(dtype).contiguous()

    if needs_rev:
        bparts = (t3(s.bwd.matrix), t3(s.bwd.noise.mean), t3(s.bwd.noise.cholesky))
        bprev = (t3(s.bwd_prev.matrix), t3(s.bwd_prev.noise.mean),
                 t3(s.bwd_prev.noise.cholesky))
    else:
        z_g, z_m = torch.zeros_like(t3(s.rv.cholesky)), torch.zeros_like(t3(s.rv.mean))
        bparts = bprev = (z_g, z_m, z_g)
    return (
        t1(s.t),
        t3(s.rv.mean),
        t3(s.rv.cholesky),
        *bparts,
        t1(s.scale_step),
        t1(s.t_prev),
        t3(s.rv_prev.mean),
        t3(s.rv_prev.cholesky),
        *bprev,
        t1(s.dt),
        t1(s.errn_prev),
        t1(s.num_steps),
        t1(s.mle_ssq),
    )


def estimate_solve_bytes(batch, d, *, num_derivatives=4, num_save_at=5,
                         dtype=torch.float32):
    """Predict the peak device-memory footprint of ``solve_save_at_batched``
    (conservative upper bound: the lanes-last state and the per-checkpoint
    stacks, times 3 for copies and temporaries, times 2 for 8-byte dtypes)."""
    n = num_derivatives + 1
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_lane_state = 4 * n * d + 6 * n * n + 7
    per_lane_stack = num_save_at * (2 * (n * d) + 3 * (n * n) + 1)
    factor = 3 * (2 if itemsize >= 8 else 1)
    return int(batch) * itemsize * factor * (per_lane_state + per_lane_stack)


def _device_budget_bytes(device, default=8 * 1024**3):
    """Free device memory on a CUDA device; ``default`` elsewhere (CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return default


def check_hbm_budget(batch, d, *, num_derivatives=4, num_save_at=5,
                     dtype=torch.float32, budget="auto", device="cpu"):
    """Raise before launching a solve whose working set cannot fit."""
    if budget is None:
        return
    need = estimate_solve_bytes(
        batch, d, num_derivatives=num_derivatives, num_save_at=num_save_at,
        dtype=dtype,
    )
    have = _device_budget_bytes(device) if budget == "auto" else int(budget)
    if need > have:
        max_batch = max(1, int(batch) * have // max(need, 1))
        raise MemoryError(
            f"batched solve needs ~{need / 1e9:.2f} GB but only "
            f"{have / 1e9:.2f} GB of device memory is available "
            f"(batch={batch}, d={d}, nu={num_derivatives}, T={num_save_at}, "
            f"dtype={dtype}). Reduce the batch to <= ~{max_batch}."
        )


_NOT_PORTED = "is not ported yet: ROADMAP queue 1 item 5"
ENGINES = ("cuda-loop", "cuda", "torch")


def _check_engine(engine):
    if engine not in ENGINES:
        raise ValueError(
            f"engine={engine!r}: the port's engines are {ENGINES} (one kernel "
            "per interval, one kernel per attempt, the plain-torch twin)"
        )


def _check_config(*, strategy, calibration, ode_order, correction, error_unit,
                  implementation, num_derivatives, supported_nu=SUPPORTED_NU,
                  corrections=("ts0",), implementations=("isotropic",),
                  strategies=("fixedpoint",)):
    for name, value, ported in (
        ("strategy", strategy, strategies),
        ("calibration", calibration, ("dynamic",)),
        ("ode_order", ode_order, (1,)),
        ("correction", correction, corrections),
        ("error_unit", error_unit, ("qoi",)),
        ("implementation", implementation, implementations),
    ):
        if value not in ported:
            raise NotImplementedError(f"{name}={value!r} {_NOT_PORTED}")
    if num_derivatives not in supported_nu:
        raise NotImplementedError(
            f"num_derivatives={num_derivatives} {_NOT_PORTED} (the kernels "
            f"are instantiated for {supported_nu})"
        )


def interval_fn(engine, interval_kernel, attempt_kernel, active):
    """The per-checkpoint-interval call of an engine: the interval kernel
    (``"cuda-loop"``), the attempt kernel under a host loop (``"cuda"``; one
    device sync per attempt), or the twin under the same loop (``"torch"``).
    """
    if engine == "cuda-loop":
        return interval_kernel
    attempt = attempt_kernel if engine == "cuda" else kernels.attempt_plain

    def run(step, state, t_next, *, max_attempts, **inputs):
        return kernels.attempt_loop(attempt, active, step, state, t_next,
                                    max_attempts=max_attempts, **inputs)

    return run


def initial_state(vf, u0s, params, *, save_at, dt0, tols, num_derivatives=4,
                  atol_factor=1e-3, implementation="isotropic", strategy="fixedpoint"):
    """Taylor-initialized lanes-last state and the per-lane kernel inputs.

    Returns ``(state0, rv0, inputs)`` where ``inputs`` is the dict of (1, B)
    tensors ``atol, rtol, dt_max, dt_floor, tiny_scale`` and ``rv0`` is the
    batch-leading initial ``Normal``.  ``implementation`` is the SSM backend
    whose layout the state takes: "isotropic" ((n, d, B) means, (n, n, B)
    factors) or "dense" ((nd, B) means, (nd, nd, B) factors); the blockdiag
    layout is ``batched_blockdiag.initial_state``.  With
    ``strategy="filter"`` the backward arrays are zeros.
    """
    s0, rv0, inputs = initial_generic(
        vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols,
        num_derivatives=num_derivatives, atol_factor=atol_factor,
        implementation=implementation, strategy=strategy)
    return _generic_to_state(s0, u0s.dtype, s0.bwd is not None), rv0, inputs


def initial_generic(vf, u0s, params, *, save_at, dt0, tols, num_derivatives=4,
                    atol_factor=1e-3, implementation="isotropic", strategy="fixedpoint"):
    """``initial_state`` before the layout conversion: the batch-leading
    ``_State`` at ``save_at[0]``, ``rv0`` and the kernel inputs.  The
    blockdiag backend gets one output scale and one ``mle_ssq`` per
    dimension."""
    b, d = u0s.shape
    dtype, device = u0s.dtype, u0s.device
    nu = num_derivatives
    save_at = torch.as_tensor(save_at, dtype=dtype, device=device)
    ssm = ivpsolvers.prior_ibm(num_derivatives=nu, ode_shape=(d,),
                               implementation=implementation)
    make_strategy = {"fixedpoint": ivpsolvers.strategy_fixedpoint,
                     "smoother": ivpsolvers.strategy_smoother,
                     "filter": ivpsolvers.strategy_filter}[strategy]
    strat = make_strategy(ssm, ivpsolvers.correction_ts0())
    solver_cfg = ivpsolvers.solver_dynamic(strat)

    # Taylor init of the whole ensemble at once: the row-wise vector field
    # takes (d, B) states
    tco = taylor.odejet_padded_scan(
        lambda y: vf(y, t=save_at[0], p=params), (u0s.T,), num=nu
    )
    rv0, _ = solver_cfg.initial_condition([c.T for c in tco], 1.0)

    ident_b = (_expand(ssm.identity_conditional(dtype, device), (b,))
               if strat.needs_reversal else None)
    full = lambda v: torch.full((b,), v, dtype=dtype, device=device)  # noqa: E731
    scale0 = full(1.0)
    if implementation == "blockdiag":
        scale0 = ssm.promote_output_scale(scale0)
    s0 = _State(
        t=save_at[0].expand(b),
        rv=rv0,
        bwd=ident_b,
        scale_step=scale0,
        t_prev=save_at[0].expand(b),
        rv_prev=rv0,
        bwd_prev=ident_b,
        dt=full(dt0),
        errn_prev=full(1.0),
        num_steps=torch.zeros((b,), dtype=torch.int32, device=device),
        mle_ssq=torch.zeros_like(scale0),
    )
    tiny = float(torch.finfo(dtype).tiny)
    row = lambda v: torch.full((1, b), v, dtype=dtype, device=device)  # noqa: E731
    inputs = dict(
        atol=(atol_factor * tols)[None, :].to(dtype).contiguous(),
        rtol=tols[None, :].to(dtype).contiguous(),
        dt_max=(save_at[-1] - save_at[0]).expand(1, b).contiguous(),
        dt_floor=row(tiny ** (1.0 / (nu + 1.5))),
        tiny_scale=row(tiny**0.5),
    )
    return s0, rv0, inputs


def solve_save_at_batched(
    vf,
    u0s,
    params,
    *,
    save_at,
    dt0,
    tols,
    num_derivatives=4,
    strategy="fixedpoint",
    calibration="dynamic",
    atol_factor=1e-3,
    engine="cuda-loop",
    hbm_budget="auto",
    ode_order=1,
    correction="ts0",
    error_unit="qoi",
    error_calibration=None,
    max_attempts=100_000,
    implementation="isotropic",
):
    """Batched fixed-memory adaptive solve, one kernel per checkpoint interval.

    ``u0s``: (B, d) tensor; ``tols``: (B,) relative tolerances on the same
    device; ``save_at``: the T checkpoint times.  ``engine="cuda-loop"``
    launches the K1 kernel once per interval; ``engine="cuda"`` launches K3
    once per attempt under a host loop that runs while any lane is short of
    the checkpoint (``odecheckpts_tpu/batched.py:895-897, 919-935``).  Both
    run the plain twin on CPU tensors.  ``engine="torch"`` runs the twin on
    any device.  ``max_attempts`` bounds the attempts per lane and interval.

    ``implementation="blockdiag"`` goes to the blockdiag engine
    ``batched_blockdiag.solve_save_at_batched_blockdiag`` (kernel K6; TS0
    only); ``correction="ts1"`` with d > 1, or ``implementation="dense"``,
    goes to the dense engine ``batched_dense.solve_save_at_batched_dense``
    (kernel K5), as in the reference (``odecheckpts_tpu/batched.py:765-793``).

    Returns ``(u_smooth (B, T, d), u_filt (B, T, d), num_steps (B, T))``.
    """
    if implementation == "blockdiag":
        from .batched_blockdiag import solve_save_at_batched_blockdiag

        if correction == "ts1":
            raise ValueError("blockdiag supports ts0 corrections only")
        return solve_save_at_batched_blockdiag(
            vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols,
            num_derivatives=num_derivatives, strategy=strategy,
            calibration=calibration, atol_factor=atol_factor, engine=engine,
            hbm_budget=hbm_budget, ode_order=ode_order, error_unit=error_unit,
            error_calibration=error_calibration, max_attempts=max_attempts,
        )
    d = (u0s[0] if isinstance(u0s, tuple) else u0s).shape[-1]
    if implementation == "dense" or (correction == "ts1" and d > 1):
        from .batched_dense import solve_save_at_batched_dense

        return solve_save_at_batched_dense(
            vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols,
            num_derivatives=num_derivatives, strategy=strategy,
            calibration=calibration, atol_factor=atol_factor, engine=engine,
            hbm_budget=hbm_budget, ode_order=ode_order, correction=correction,
            error_unit=error_unit, error_calibration=error_calibration,
            max_attempts=max_attempts,
        )
    _check_config(
        strategy=strategy, calibration=calibration, ode_order=ode_order,
        correction=correction, error_unit=error_unit,
        implementation=implementation, num_derivatives=num_derivatives,
    )
    _check_engine(engine)
    if isinstance(u0s, tuple):
        (u0s,) = u0s
    b, d = u0s.shape
    dtype, device = u0s.dtype, u0s.device
    nu = num_derivatives
    save_at = torch.as_tensor(save_at, dtype=dtype, device=device)
    check_hbm_budget(
        b, d, num_derivatives=nu, num_save_at=len(save_at), dtype=dtype,
        budget=hbm_budget, device=device,
    )
    ssm = ivpsolvers.prior_ibm(num_derivatives=nu, ode_shape=(d,))
    strat = ivpsolvers.strategy_fixedpoint(
        ssm, ivpsolvers.correction_ts0(error_calibration=error_calibration)
    )
    step = make_step_ll(
        vf, params, nu=nu, d=d, error_calibration=strat.correction.calibration_factor,
        dtype=dtype,
    )
    state, rv0, inputs = initial_state(
        vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols,
        num_derivatives=nu, atol_factor=atol_factor,
    )
    interval = interval_fn(engine, kernels.step_ll_interval, kernels.step_ll_attempt,
                           kernels.active_ll)
    return solve_intervals(interval, step, state, rv0, inputs, strat=strat,
                           save_at=save_at, max_attempts=max_attempts)


_CONVERT = (_state_to_generic, _generic_to_state)


def advance_checkpoint(interval, step, state, t_next, inputs, *, strat, max_attempts,
                       convert=_CONVERT):
    """One checkpoint of ``solve_intervals``: ``interval`` advances the
    lanes-last ``state`` to ``t_next`` (a 0-d tensor), then the generic stack
    interpolates at it.  Returns ``((rv, cond), state, num_steps)``: the
    filtered marginal and the backward conditional at the checkpoint, the
    state the next interval starts from, and the accepted steps so far.
    ``convert`` is the layout's ``(state_to_generic, generic_to_state)``."""
    to_generic, to_state = convert
    b = state[0].shape[-1]
    state = interval(step, state, t_next.expand(1, b).contiguous(), max_attempts=max_attempts,
                     **inputs)
    out, gen = _interpolate_at(strat, to_generic(state), t_next)
    return out, to_state(gen, state[0].dtype), gen.num_steps


def solve_intervals(interval, step, state, rv0, inputs, *, strat, save_at, max_attempts,
                    convert=_CONVERT):
    """The checkpoint loop and the smoothing pass of the batched drivers.

    Per checkpoint: ``interval`` advances the lanes-last ``state`` (see
    ``interval_fn``), then the generic stack interpolates at the checkpoint
    on batch-leading tensors (``_state_to_generic`` and ``_generic_to_state``
    move the lane axis and serve the isotropic and the dense layout alike;
    the blockdiag driver passes its own pair as ``convert``).
    After the last one, the backward pass over the checkpoints gives the
    smoothed means.  Returns ``(u_smooth, u_filt, num_steps)``.
    """
    ssm = strat.ssm
    b = state[0].shape[-1]
    dtype, device = state[0].dtype, state[0].device
    rvs, conds, nsteps = [], [], []
    for t_next in save_at[1:]:
        (rv_e, cond_e), state, n = advance_checkpoint(
            interval, step, state, t_next, inputs, strat=strat, max_attempts=max_attempts,
            convert=convert)
        rvs.append(rv_e)
        conds.append(cond_e)
        nsteps.append(n)

    def stack(items):  # list over T-1 checkpoints -> (T-1, B, ...) tree
        first = items[0]
        if isinstance(first, tuple):
            return type(first)(*(stack([it[i] for it in items]) for i in range(len(first))))
        return torch.stack(items)

    rvs, conds = stack(rvs), stack(conds)
    u_filt = torch.cat([ssm.qoi(rv0.mean)[:, None], ssm.qoi(rvs.mean).transpose(0, 1)], dim=1)
    nsteps = torch.cat(
        [torch.zeros((b, 1), dtype=torch.int32, device=device), torch.stack(nsteps, dim=1)],
        dim=1,
    )

    # smoothed means: backward pass over the checkpoints, batched over lanes
    ident = _expand(ssm.identity_conditional(dtype, device), (1, b))
    init_stack = Normal(
        torch.cat([rv0.mean[None], rvs.mean]), torch.cat([rv0.cholesky[None], rvs.cholesky])
    )
    conds_full = Conditional(
        torch.cat([ident.matrix, conds.matrix]),
        Normal(torch.cat([ident.noise.mean, conds.noise.mean]),
               torch.cat([ident.noise.cholesky, conds.noise.cholesky])),
    )
    seq = stats.markov_select_terminal(MarkovSeq(init_stack, conds_full, ssm=ssm))
    margs = stats.markov_marginals(seq)
    mean = torch.cat([margs.mean, init_stack.mean[-1:]])  # (T, B, ...)
    u_smooth = ssm.qoi(mean).transpose(0, 1)
    return u_smooth, u_filt, nsteps


def _host_rtols(tols):
    """(B,) tolerances as a numpy array on the host."""
    if isinstance(tols, torch.Tensor):
        return tols.detach().cpu().numpy()
    return np.asarray(tols)


def make_bucketed_solver(vf, params, *, save_at, dt0, num_buckets=4, **solve_kwargs):
    """Mixed-tolerance step-count bucketing (counterpart of
    ``odecheckpts_tpu/batched.py:980-1061``): lanes sorted by tolerance,
    loosest first, are solved in ``num_buckets`` buckets of (nearly) equal
    size, so a bucket of loose lanes does not wait for the tightest lane.

    Host-side only: the closure holds the configuration, and each bucket is
    one ``solve_save_at_batched`` call.  The reference pads the batch to a
    multiple of ``num_buckets`` so that its buckets share one compiled
    program; the port runs eagerly and splits unevenly instead.

    Returns ``solve(u0s, tols) -> ((u_s, u_f, nsteps), bucket_max_steps)``;
    per-lane results equal those of one unbucketed solve (lanes are
    independent).
    """

    def solve(u0s, tols):
        if isinstance(u0s, tuple):
            (u0s,) = u0s
        tols_np = _host_rtols(tols)
        tols = torch.as_tensor(tols, dtype=u0s.dtype, device=u0s.device)
        b = tols_np.shape[0]
        nb = max(1, min(num_buckets, b))
        order = np.argsort(tols_np, kind="stable")[::-1]  # loosest first
        chunks = np.array_split(order, nb)
        outs = []
        for idx in chunks:
            idx_t = torch.as_tensor(idx.copy(), device=u0s.device)
            outs.append(solve_save_at_batched(
                vf, u0s[idx_t], params, save_at=save_at, dt0=dt0, tols=tols[idx_t],
                **solve_kwargs,
            ))
        inv = np.empty(b, dtype=np.int64)
        inv[np.concatenate(chunks)] = np.arange(b)
        inv_t = torch.as_tensor(inv, device=u0s.device)
        u_s, u_f, nsteps = (torch.cat([o[i] for o in outs])[inv_t] for i in range(3))
        bucket_max_steps = [int(torch.max(o[2][:, -1])) for o in outs]
        return (u_s, u_f, nsteps), bucket_max_steps

    return solve


def solve_save_at_bucketed(vf, u0s, params, *, save_at, dt0, tols, num_buckets=4,
                           **solve_kwargs):
    """One-shot convenience wrapper around :func:`make_bucketed_solver`."""
    solve = make_bucketed_solver(vf, params, save_at=save_at, dt0=dt0,
                                 num_buckets=num_buckets, **solve_kwargs)
    return solve(u0s, tols)
