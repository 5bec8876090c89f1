"""High-precision batched solver with df32 means (PyTorch counterpart of
``odecheckpts_tpu.batched_hi``).

The tight band of the work-precision bench (rtol 1e-5..1e-9) needs more
than f32's 2^-24: the solution mean, the time axis and the TS0 residual
z = u' - f(u) are carried as compensated (hi, lo) f32 pairs (``df32``,
~2^-48 relative), while covariance factors, gains and step control stay in
plain f32.  Checkpoints are hit by clamping dt onto them, and the fixedpoint
smoother runs in increment form (``odecheckpts_tpu/batched_hi.py:1-35`` has
the derivation).

``StepHi`` is the lanes-last attempt in plain vectorized torch ops (the
twin); ``kernels.step_hi_interval`` (K2) runs a whole checkpoint interval of
it as the hand-written CUDA kernel ``csrc/step_hi.cu`` and
``kernels.step_hi_attempt`` (K4) one attempt.  ``make_hi_solver`` drives
them; ``make_routed_solver`` sends loose lanes to the f32 engine of
``batched`` and tight lanes here.

Ported configuration: isotropic TS0, ``ode_order=1``, fixedpoint, dynamic
calibration, ``error_unit="qoi"``, any error calibration (kappa),
``num_derivatives`` in {4, 5}, f32 pairs (``dtype=torch.float32``) and the
f64-pair ("double-double") oracle mode (``dtype=torch.float64``, plain
versions only).  Everything else raises ``NotImplementedError`` naming the
ROADMAP item that ports it.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import batched, ivpsolvers, kernels, taylor
from . import df32 as df
from .batched import _const_matmul, _matmul_ll, _tri_solve_upper_ll

# state tuple layout (all lanes-last):
#   0 t_hi (1,B)       1 t_lo (1,B)
#   2 mean_hi (n,d,B)  3 mean_lo (n,d,B)
#   4 chol (n,n,B)     5 scale (1,B)
#   6 G_acc (n,n,B)    7 msp_hi (n,d,B)   8 msp_lo (n,d,B)
#   9 dt (1,B)        10 errn_prev (1,B) 11 nsteps (1,B)
NUM_STATE_HI = 12
SUPPORTED_NU = (4, 5)

# df32 pair precision (the stall floor on the compensated time axis)
_EPS_DF32 = 2.0**-45


def _qr_r_cols_partial(cols, m, n_reflect):
    """First ``n_reflect`` Householder reflections of the column-list QR,
    applied to all columns (``odecheckpts_tpu/batched_hi.py:70-100``): rows
    0..n_reflect-1 of every column are final, which is all of R_yy and R_yx
    that the df32 step needs.  ``cols`` is (c, m, B)."""
    return batched._qr_r_cols(cols, m, n_reflect, torch.finfo(cols.dtype).tiny)


def _taylor_extrap_df(mean, dt, nu):
    """Mean extrapolation in real coordinates with pair coefficients
    (``odecheckpts_tpu/batched_hi.py:103-133``): m_i + sum_k c_k m_{i+k},
    c_k = dt^k / k!.  ``mean`` is an (n, d, B) pair, ``dt`` (1, B)."""
    hi, lo = mean
    n = nu + 1
    c = [None] * n  # c[k] = dt^k / k! as a pair; c[0] unused
    c[1] = (dt, torch.zeros_like(dt))
    for k in range(2, n):
        c[k] = df.div1(df.mul1(c[k - 1], dt), float(k))
    out_hi, out_lo = [], []
    for i in range(n):
        acc = (hi[i], lo[i])
        for k in range(1, n - i):
            acc = df.add(acc, df.mul((hi[i + k], lo[i + k]), c[k]))
        out_hi.append(acc[0])
        out_lo.append(acc[1])
    return torch.stack(out_hi, dim=0), torch.stack(out_lo, dim=0)


class StepHi(batched._StepConstants):
    """One lanes-last df32 attempt (``odecheckpts_tpu/batched_hi.py:136-398``,
    the TS0 fixedpoint dynamic "qoi" branch): the plain-torch twin of the K2
    and K4 kernels.

    ``vf_df(args, t)`` takes ``args = ((u_hi, u_lo),)`` with (d, B) halves
    and a (hi, lo) time pair and returns the (hi, lo) pair of f(u).  Steps
    clamp to ``t_next``: an accepted clamped step snaps the time axis to
    exactly ``t_next`` and leaves the controller state untouched.  Constants
    are rounded to ``dtype`` once (``batched._StepConstants``); every
    division is by a tensor and every square by a product.
    """

    def __init__(self, vf_df, *, nu, d, error_calibration, control=None,
                 dtype=torch.float32):
        if nu not in SUPPORTED_NU:
            raise NotImplementedError(
                f"num_derivatives={nu} is not ported to the df32 engine yet (the "
                f"kernel is instantiated for {SUPPORTED_NU}): ROADMAP queue 1 item 5"
            )
        super().__init__(nu=nu, d=d, error_calibration=error_calibration,
                         control=control, dtype=dtype)
        self.vf_df = vf_df
        self.tiny_frac = self.rnd(1e-5)
        self.stall = self.rnd(4.0 * _EPS_DF32)
        self.device_functor = getattr(vf_df, "device_functor", None)
        self.functor_params = getattr(vf_df, "params", None)

    def packed_constants(self):
        """The kernel's constant buffer (layout of ``ConstsHi`` in step_hi.cuh)."""
        return self._pack(max(SUPPORTED_NU) + 1, [
            self.max_lq, self.a_inf_norm, self.sqrt_d, self.kappa, self.neg_n1,
            self.n2, self.safety, self.factor_min, self.factor_max, self.big,
            self.clip, self.tiny_frac, self.stall,
        ])

    def state_shapes(self, batch):
        """Shapes of the 12 state arrays (layout above ``NUM_STATE_HI``)."""
        n, d, b = self.nu + 1, self.d, batch
        row, nd, nn = (1, b), (n, d, b), (n, n, b)
        return [row, row, nd, nd, nn, row, nn, nd, nd, row, row, row]

    def __call__(self, state, t_next, atol, rtol, dt_max, dt_floor, tiny_scale):
        (t_hi, t_lo, mean_hi, mean_lo, chol, scale,
         g_acc, msp_hi, msp_lo, dt_st, errn_prev, nsteps) = state
        nu, d = self.nu, self.d
        n = nu + 1

        # remainder to the checkpoint on the compensated time axis
        s, e = df.two_sum(t_next, -t_hi)
        rem = torch.maximum(s + (e - t_lo), torch.zeros_like(s))
        frozen = rem <= 0.0
        dt_prop = torch.minimum(torch.maximum(dt_st, dt_floor), dt_max)
        clamped = rem <= dt_prop
        # mean path: the exact remainder; covariance path: floored
        dt_mean = torch.minimum(dt_prop, rem)
        tiny = clamped & (rem <= self.tiny_frac * dt_max)
        dt = torch.maximum(dt_mean, dt_floor)

        p = self._precond(dt)
        p_arr = torch.cat(p, dim=0)  # (n, B)
        pb = p_arr[:, None, :]
        t_new = df.add1((t_hi, t_lo), dt_mean)

        # -- extrapolate the mean in pairs (real coordinates)
        m_pred_hi, m_pred_lo = _taylor_extrap_df((mean_hi, mean_lo), dt_mean, nu)

        # -- TS0 residual on the first derivative, in pairs
        u_pred = m_pred_hi[0]  # (d, B), hi only: error weights
        fx = self.vf_df(((m_pred_hi[0], m_pred_lo[0]),), t_new)
        z_hi, z_lo = df.sub((m_pred_hi[1], m_pred_lo[1]), fx)

        # -- local scale and error (f32: only steers the controller)
        s_unit = p[1] * self.lq_norms[1]
        zz = z_hi[0:1] * z_hi[0:1]
        q = atol + rtol * torch.abs(u_pred[0:1])
        tol_acc = torch.reciprocal(q * q)
        for i in range(1, d):
            zz = zz + z_hi[i : i + 1] * z_hi[i : i + 1]
            q = atol + rtol * torch.abs(u_pred[i : i + 1])
            tol_acc = tol_acc + torch.reciprocal(q * q)
        sigma = torch.sqrt(zz) / (s_unit * self.sqrt_d)
        err_u = sigma * (p[0] * self.lq_norms[0])
        errn = self.kappa * err_u * torch.sqrt(tol_acc / torch.full_like(tol_acc, d))

        sigma_safe = torch.where(
            torch.isfinite(sigma), sigma, torch.full_like(sigma, self.big)
        )
        new_scale = torch.clamp(torch.maximum(sigma_safe, tiny_scale), max=self.big)

        # -- extrapolate the covariance (f32) with reversal
        l_bar = torch.clamp(chol / pb, -self.clip, self.clip)
        mag = new_scale * self.max_lq
        for c in range(n):
            mag = torch.maximum(mag, torch.amax(torch.abs(l_bar[c]), dim=0, keepdim=True))
        mag = torch.maximum(mag * self.a_inf_norm, tiny_scale)
        inv_mag = torch.reciprocal(mag)
        l_bar_n = l_bar * inv_mag[None]
        a_l = _const_matmul(self.a_rows, l_bar_n)
        lq_scaled = (new_scale * inv_mag)[None] * self._lq_const(dt)
        magb = mag[None]

        zero = torch.zeros_like(a_l[0])
        cols = torch.stack(
            [torch.cat([a_l[c], lq_scaled[c]], dim=0) for c in range(n)]
            + [torch.cat([l_bar_n[c], zero], dim=0) for c in range(n)]
        )
        cols = _qr_r_cols_partial(cols, 2 * n, n)  # rows < n of cols[c] are R[:, c]
        r_yy = cols[:n, :n].transpose(0, 1)
        r_yx = cols[n:, :n].transpose(0, 1)
        l_pred = pb * cols[:n, :n] * magb
        g_bar = _tri_solve_upper_ll(r_yy, r_yx, n).transpose(0, 1)
        gain = pb * g_bar / p_arr[None, :, :]

        # -- TS0 correction (rank-1 update), mean in pairs
        l_obs = l_pred[1]  # (n, B)
        m2 = torch.abs(l_obs[0:1])
        for i in range(1, n):
            m2 = torch.maximum(m2, torch.abs(l_obs[i : i + 1]))
        m2 = torch.maximum(m2, tiny_scale)
        l_obs_n = l_obs / m2
        s2 = l_obs_n[0:1] * l_obs_n[0:1]
        for i in range(1, n):
            s2 = s2 + l_obs_n[i : i + 1] * l_obs_n[i : i + 1]
        s2 = s2 + self.tiny  # a fully cancelled innovation gives a zero gain
        crosscov = _matmul_ll(l_pred, l_obs_n[:, None, :], n)  # (n, 1, B)
        gc = crosscov / s2[None]
        g_corr = gc / m2[None]
        corr_term = df.mul1((z_hi[None], z_lo[None]), g_corr)
        mean_cor = df.sub((m_pred_hi, m_pred_lo), corr_term)
        chol_cor = l_pred - gc * l_obs_n[None]

        # -- fixedpoint accumulation, increment form (O(local error) terms)
        diff = -(g_corr * z_hi[None])
        incr = _matmul_ll(g_acc, _matmul_ll(gain, diff, n), n)
        msp_new = df.add1((msp_hi, msp_lo), incr)
        g_acc_new = _matmul_ll(g_acc, gain, n)

        # -- PI control
        errn_s = torch.clamp(errn, min=self.tiny)
        factor = self.safety * torch.exp(
            self.neg_n1 * torch.log(errn_s)
            + self.n2 * (torch.log(errn_prev) - torch.log(errn_s))
        )
        factor = torch.where(
            torch.isfinite(factor), factor, torch.full_like(factor, self.factor_min)
        )
        dt_next = torch.minimum(
            dt * torch.clamp(factor, self.factor_min, self.factor_max), dt_max
        )

        dt_stall = self.stall * torch.clamp(torch.abs(t_hi), min=1.0)
        # tiny remainder steps force-accept (truncation error ~rem^(nu+1))
        accept = ((errn <= 1.0) | (dt <= dt_stall) | tiny) & ~frozen
        snap = accept & clamped
        full = accept & ~tiny  # tiny steps freeze covariance and accumulation

        def sel(mask, new, old):
            return torch.where(mask, new, old)  # (1, B) broadcasts on the lanes

        return (
            sel(accept, torch.where(snap, t_next, t_new[0]), t_hi),
            sel(accept, torch.where(snap, torch.zeros_like(t_lo), t_new[1]), t_lo),
            sel(accept, torch.where(tiny, m_pred_hi, mean_cor[0]), mean_hi),
            sel(accept, torch.where(tiny, m_pred_lo, mean_cor[1]), mean_lo),
            sel(full, chol_cor, chol),
            sel(full, new_scale, scale),
            sel(full, g_acc_new, g_acc),
            sel(full, msp_new[0], msp_hi),
            sel(full, msp_new[1], msp_lo),
            sel(frozen | snap, dt_st, dt_next),
            sel(accept & ~snap, errn_s, errn_prev),
            sel(full, nsteps + 1.0, nsteps),  # accepted non-tiny steps only
        )


def make_step_hi(vf_df, *, nu, d, strategy="fixedpoint", calibration="dynamic",
                 control=None, ode_order=1, correction="ts0", error_unit="qoi",
                 error_calibration=None, dtype=torch.float32):
    """The twin of K2 and K4 for the pair vector field ``vf_df``."""
    batched._check_config(
        strategy=strategy, calibration=calibration, ode_order=ode_order,
        correction=correction, error_unit=error_unit, implementation="isotropic",
        num_derivatives=nu, supported_nu=SUPPORTED_NU,
    )
    if error_calibration is None:
        error_calibration = ivpsolvers.default_error_calibration(correction, error_unit)
    return StepHi(vf_df, nu=nu, d=d, error_calibration=error_calibration,
                  control=control, dtype=dtype)


def _taylor_init_f64(vf, u0s, params, t0, *, nu, split_dtype=torch.float32):
    """Taylor-mode initial means in float64, split into a (hi, lo) pair of
    ``split_dtype`` (``odecheckpts_tpu/batched_hi.py:401-430``).

    Runs on the device of ``u0s`` (B, d): the reference ran it on the host
    CPU only because its TPU has no f64 units; the algorithm is the same.
    Returns (B, n, d) halves; in f64-pair mode the lo half is zero."""
    u = u0s.to(torch.float64)
    tco = taylor.odejet_padded_scan(lambda y: vf(y, t=t0, p=params), (u.T,), num=nu)
    m0 = torch.stack(tco, dim=0).movedim(-1, 0).contiguous()  # (B, n, d)
    if split_dtype == torch.float64:
        return m0, torch.zeros_like(m0)
    hi = m0.to(split_dtype)
    return hi, (m0 - hi.to(torch.float64)).to(split_dtype)


def _state_from_means(m0_hi, m0_lo, tols, *, save_at, dt0, atol_factor, dtype):
    """The 12-array state at save_at[0] from (B, n, d) initial mean halves,
    and the (1, B) kernel inputs (``odecheckpts_tpu/batched_hi.py:498-561``)."""
    b, n, _ = m0_hi.shape
    nu, device = n - 1, m0_hi.device

    def full(v):
        return torch.full((1, b), v, dtype=dtype, device=device)

    mean_hi = m0_hi.movedim(0, -1).contiguous()  # (n, d, B)
    mean_lo = m0_lo.movedim(0, -1).contiguous()
    eye = torch.eye(n, dtype=dtype, device=device)[:, :, None].expand(n, n, b).contiguous()
    state = (
        full(float(save_at[0])), full(0.0), mean_hi, mean_lo,
        torch.zeros((n, n, b), dtype=dtype, device=device), full(1.0),
        eye, mean_hi, mean_lo, full(dt0), full(1.0), full(0.0),
    )
    tols = torch.as_tensor(tols, device=device).to(dtype)
    tiny = float(torch.finfo(dtype).tiny)
    inputs = dict(
        atol=(atol_factor * tols)[None, :].contiguous(),
        rtol=tols[None, :].contiguous(),
        dt_max=full(float(save_at[-1] - save_at[0])),
        dt_floor=full(tiny ** (1.0 / (nu + 1.5))),
        tiny_scale=full(tiny**0.5),
    )
    return state, inputs


def initial_state(vf, u0s, params, *, save_at, dt0, tols, num_derivatives=4,
                  atol_factor=1e-3, dtype=torch.float32):
    """Taylor-initialized 12-array df32 state at ``save_at[0]`` and the dict of
    (1, B) kernel inputs ``atol, rtol, dt_max, dt_floor, tiny_scale``
    (counterpart of ``batched.initial_state``).  ``save_at`` is a numpy
    array of the solver's dtype."""
    m0_hi, m0_lo = _taylor_init_f64(vf, u0s, params, float(save_at[0]), nu=num_derivatives,
                                    split_dtype=dtype)
    return _state_from_means(m0_hi, m0_lo, tols, save_at=save_at, dt0=dt0,
                             atol_factor=atol_factor, dtype=dtype)


def wrap_vf_plain(vf, params):
    """Pair vector field that evaluates ``vf`` on the hi channel only
    (``odecheckpts_tpu/batched_hi.py:433-444``); accurate to about
    rtol 1e-7.  It has no device functor: only the twin runs it, and the
    kernel wrappers raise ``NotImplementedError`` on CUDA tensors."""

    def vf_df(args, t):
        fx = vf(*(a[0] for a in args), t=t[0][0], p=params)
        return fx, torch.zeros_like(fx)

    return vf_df


def _check_options(*, shard_mesh, engine, dtype):
    if shard_mesh is not None:
        raise NotImplementedError(
            "shard_mesh is not ported yet: ROADMAP queue 1 item 8 (multi-device)"
        )
    batched._check_engine(engine)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")


def make_hi_solver(
    vf,
    params,
    *,
    save_at,
    dt0,
    vf_df=None,
    num_derivatives=4,
    strategy="fixedpoint",
    calibration="dynamic",
    atol_factor=1e-3,
    engine="cuda-loop",
    control=None,
    hbm_budget="auto",
    ode_order=1,
    correction="ts0",
    error_unit="qoi",
    error_calibration=None,
    dtype=torch.float32,
    shard_mesh=None,
    max_attempts=100_000,
):
    """Build ``solve(u0s, tols) -> ((us_hi, us_lo), (uf_hi, uf_lo), nsteps)``
    (``odecheckpts_tpu/batched_hi.py:447-722``).

    ``u0s`` is a (B, d) tensor (any float dtype), ``tols`` (B,) relative
    tolerances; outputs are (B, T, d) pairs on the device of ``u0s`` and
    (B, T) int32 step counts.  ``save_at`` values should be exact in f32.
    ``engine="cuda-loop"`` launches K2 once per checkpoint interval,
    ``engine="cuda"`` K4 once per attempt under a host loop that runs while
    any lane is short of the checkpoint; both run the twin on CPU tensors.
    ``engine="torch"`` runs the twin on any device.  ``dtype=torch.float64``
    runs the same algorithm on f64 pairs (double-double), the oracle mode;
    the kernels take f32 only.  ``vf_df=None`` evaluates ``vf`` on the hi
    channel (``wrap_vf_plain``; twin only).  The f64 Taylor init runs per
    call, memoized for the latest ensemble by content hash.  Combine outputs
    with ``combine64``.
    """
    batched._check_config(
        strategy=strategy, calibration=calibration, ode_order=ode_order,
        correction=correction, error_unit=error_unit, implementation="isotropic",
        num_derivatives=num_derivatives, supported_nu=SUPPORTED_NU,
    )
    _check_options(shard_mesh=shard_mesh, engine=engine, dtype=dtype)
    nu = num_derivatives
    n = nu + 1
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    save_at_np = np.asarray(save_at, np_dtype)
    vf_df_ = vf_df if vf_df is not None else wrap_vf_plain(vf, params)
    interval = batched.interval_fn(engine, kernels.step_hi_interval,
                                   kernels.step_hi_attempt, kernels.active_hi)
    steps = {}  # d -> twin, holding its constants for the kernels

    def get_step(d):
        if d not in steps:
            steps[d] = make_step_hi(
                vf_df_, nu=nu, d=d, strategy=strategy, calibration=calibration,
                control=control, ode_order=ode_order, correction=correction,
                error_unit=error_unit, error_calibration=error_calibration, dtype=dtype,
            )
        return steps[d]

    def device_solve(m0_hi, m0_lo, tols):
        b, _, d = m0_hi.shape
        device = m0_hi.device
        step = get_step(d)
        state, inputs = _state_from_means(m0_hi, m0_lo, tols, save_at=save_at_np, dt0=dt0,
                                          atol_factor=atol_factor, dtype=dtype)
        mean_hi, mean_lo, eye = state[2], state[3], state[6]

        def full(v):
            return torch.full((1, b), v, dtype=dtype, device=device)

        emits = []
        for t_next in save_at_np[1:]:
            state = interval(step, state, full(float(t_next)), max_attempts=max_attempts,
                             **inputs)
            (t_hi, t_lo, m_hi, m_lo, chol, scale, g_acc, msp_hi, msp_lo, dt_st,
             errn_prev, nsteps) = state
            emits.append((m_hi, m_lo, msp_hi, msp_lo, g_acc, nsteps))
            # fixedpoint reset: the next interval accumulates from this checkpoint
            state = (t_hi, t_lo, m_hi, m_lo, chol, scale, eye, m_hi, m_lo, dt_st,
                     errn_prev, nsteps)
        mf_hi, mf_lo, msp_hi_s, msp_lo_s, g_s, nsteps_s = (
            torch.stack([e[i] for e in emits]) for i in range(6)
        )

        uf_hi = torch.cat([mean_hi[None, 0], mf_hi[:, 0]])  # (T, d, B)
        uf_lo = torch.cat([mean_lo[None, 0], mf_lo[:, 0]])
        nsteps_out = torch.cat([torch.zeros_like(nsteps_s[:1]), nsteps_s])[:, 0]  # (T, B)

        # backward recursion over the checkpoint intervals, increment form:
        # m_s(k) = msp(k) + G(k) (m_s(k+1) - m_f(k+1))
        carry = (mf_hi[-1], mf_lo[-1])
        smoothed = [None] * len(emits)
        for k in reversed(range(len(emits))):
            delta = df.sub(carry, (mf_hi[k], mf_lo[k]))[0]  # small, f32
            carry = df.add1((msp_hi_s[k], msp_lo_s[k]), _matmul_ll(g_s[k], delta, n))
            smoothed[k] = carry
        us_hi = torch.cat([torch.stack([m[0][0] for m in smoothed]), mf_hi[-1:, 0]])
        us_lo = torch.cat([torch.stack([m[1][0] for m in smoothed]), mf_lo[-1:, 0]])

        def bt(x):  # (T, d, B) -> (B, T, d)
            return x.movedim(-1, 0)

        return (
            (bt(us_hi), bt(us_lo)),
            (bt(uf_hi), bt(uf_lo)),
            nsteps_out.movedim(-1, 0).to(torch.int32),
        )

    init_cache = {}  # the latest ensemble's f64 Taylor init, by content hash

    def solve(u0s, tols):
        if isinstance(u0s, tuple):
            (u0s,) = u0s
        b, d = u0s.shape
        device = u0s.device
        batched.check_hbm_budget(
            b, d, num_derivatives=nu, num_save_at=len(save_at_np), dtype=torch.float32,
            budget=hbm_budget, device=device,
        )
        h = hashlib.sha1()
        h.update(f"{tuple(u0s.shape)} {u0s.dtype} {device}".encode())
        h.update(np.ascontiguousarray(u0s.detach().cpu().numpy()).tobytes())
        key = h.hexdigest()
        if key not in init_cache:
            init_cache.clear()  # hold one ensemble
            init_cache[key] = _taylor_init_f64(vf, u0s, params, float(save_at_np[0]), nu=nu,
                                               split_dtype=dtype)
        return device_solve(*init_cache[key], tols)

    return solve


def solve_save_at_hi(vf, u0s, params, *, save_at, dt0, tols, **kwargs):
    """One-shot convenience wrapper around :func:`make_hi_solver`."""
    return make_hi_solver(vf, params, save_at=save_at, dt0=dt0, **kwargs)(u0s, tols)


def combine64(pair):
    """Collapse an (hi, lo) output pair to float64."""
    return pair[0].to(torch.float64) + pair[1].to(torch.float64)


def make_routed_solver(vf, params, *, save_at, dt0, vf_df=None, rtol_split=1e-5,
                       num_buckets_f32=4, engine="cuda-loop", **solve_kwargs):
    """Precision-routed mixed-tolerance driver
    (``odecheckpts_tpu/batched_hi.py:736-811``): lanes with
    rtol >= ``rtol_split`` go to the f32 engine through the bucketing of
    ``batched.make_bucketed_solver``, tighter lanes to the df32 engine.  The
    split 1e-5 is where the f32 engine's accuracy floor stops clearing a
    10x-rtol gate on the bench problem.  ``engine`` selects the kernels of
    both sub-solvers (K1 and K2 for ``"cuda-loop"``, K3 and K4 for
    ``"cuda"``).

    Returns ``solve(u0s, tols) -> (u64, nsteps)``: the (B, T, d) float64
    smoothed solution (f32 lanes upcast, df32 lanes pair-combined) and the
    (B, T) step counts, on the device of ``u0s``.
    """
    lo_solve = batched.make_bucketed_solver(
        vf, params, save_at=save_at, dt0=dt0, num_buckets=num_buckets_f32,
        engine=engine, **solve_kwargs,
    )
    hi_solve = make_hi_solver(vf, params, save_at=save_at, dt0=dt0, vf_df=vf_df,
                              engine=engine, **solve_kwargs)

    def solve(u0s, tols):
        if isinstance(u0s, tuple):
            (u0s,) = u0s
        device = u0s.device
        tols_np = batched._host_rtols(tols)
        tols = torch.as_tensor(tols, device=device)
        # compare in the tolerances' own precision, as the reference does
        loose = tols_np >= tols_np.dtype.type(rtol_split)
        b, d = u0s.shape
        u64 = torch.zeros((b, len(save_at), d), dtype=torch.float64, device=device)
        nsteps = torch.zeros((b, len(save_at)), dtype=torch.int64, device=device)
        for mask, run in ((loose, "lo"), (~loose, "hi")):
            idx = torch.as_tensor(np.nonzero(mask)[0], device=device)
            if idx.numel() == 0:
                continue
            if run == "lo":
                (u_s, _uf, n), _ = lo_solve(u0s[idx], tols[idx])
                u64[idx] = u_s.to(torch.float64)
            else:
                us, _uf, n = hi_solve(u0s[idx], tols[idx])
                u64[idx] = combine64(us)
            nsteps[idx] = n.to(torch.int64)
        return u64, nsteps

    return solve
