"""Batched fixed-memory adaptive solver on the BLOCK-DIAGONAL covariance
backend (PyTorch counterpart of ``odecheckpts_tpu.batched_blockdiag``).

The blockdiag backend keeps one independent (n, n) square-root factor and
one output scale per ODE dimension (``ssm/blockdiag``): the factorization
for systems whose components live at very different magnitudes, where one
shared isotropic scale misfits some of them by decades.  TS0 only (TS1
needs cross-derivative covariance, the dense backend).

Lanes-last layout (B = lane axis); the per-dimension channels are an extra
axis ``d`` before the lanes on every covariance array:

* means and backward noise means ``(n, d, B)`` (as on the isotropic engine);
* covariance factors and gains ``(n, n, d, B)``;
* output scale, sigma and mle ``(d, B)``;
* time, dt, errn ``(1, B)``: the accept decision and the step size are per
  lane, shared by that IVP's d channels: the error norm reduces over d
  before the controller sees it.

The state tuple matches ``batched.NUM_STATE`` field for field, with these
shapes.  ``StepBD`` is the plain-torch twin of kernel K6;
``kernels.step_bd_interval`` runs a whole checkpoint interval of it as the
CUDA kernel ``csrc/step_bd.cu`` and ``kernels.step_bd_attempt`` one attempt
(``csrc/step_bd_attempt.cu``).  The checkpoint loop and the smoothing pass
are ``batched.solve_intervals`` on ``ssm/blockdiag``.

Ported configuration: fixedpoint, dynamic calibration, ``ode_order=1``,
``error_unit="qoi"``, ``num_derivatives`` in {2, 3, 4}.  Everything else
raises ``NotImplementedError`` naming ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import torch

from . import batched, ivpsolvers, kernels, rounded
from .batched import _const_matmul, _matmul_ll, _qr_r_cols, _tri_solve_upper_ll
from .ivpsolve import _State
from .ssm.base import Conditional, Normal

SUPPORTED_NU = (2, 3, 4)  # K6 is instantiated for these


def _mv(a, v, n):
    """(n, n, d, B) @ (n, d, B) -> (n, d, B), summed in column order."""
    return _matmul_ll(a, v[:, None], n)[:, 0]


def _rowmax(x):
    """NaN-propagating maximum of |x| over the leading (row) axis."""
    return torch.amax(torch.abs(x), dim=0)


class StepBD(batched._StepConstants):
    """One lanes-last adaptive attempt of the blockdiag TS0 fixedpoint solver
    with dynamic calibration: the twin of K6
    (``odecheckpts_tpu/batched_blockdiag.py:55-261``).

    Per channel the covariance arithmetic is the isotropic step's with that
    channel's own scale; the channels meet in the vector field, in the error
    norm (summed over d in the order 0..d-1) and in dt and accept.  Constants
    are Python floats rounded to ``dtype`` once; sums over the small row axes
    run in the order 0..n-1, which the kernel repeats.
    """

    def __init__(self, vf, params, *, nu, d, error_calibration, control=None,
                 dtype=torch.float32):
        super().__init__(nu=nu, d=d, error_calibration=error_calibration,
                         control=control, dtype=dtype)
        self.vf, self.params = vf, params
        self.four_eps = 4.0 * float(torch.finfo(dtype).eps)
        self.device_functor = getattr(vf, "device_functor", None)
        self.functor_params = batched.functor_params(vf, params)

    def packed_constants(self):
        """The kernel's constant buffer (layout of ``Consts`` in step_ll.cuh)."""
        return self._pack(max(batched.SUPPORTED_NU) + 1, [
            self.max_lq, self.a_inf_norm, self.sqrt_d, self.kappa, self.neg_n1,
            self.n2, self.safety, self.factor_min, self.factor_max, self.big,
            self.clip,
        ])

    def state_shapes(self, batch):
        """Shapes of the 17 state arrays (layout above ``batched.NUM_STATE``)."""
        n, d, b = self.nu + 1, self.d, batch
        row, ch, nd, nn = (1, b), (d, b), (n, d, b), (n, n, d, b)
        return [row, nd, nn, nn, nd, nn, ch, row, nd, nn, nn, nd, nn, row, row, row, ch]

    def __call__(self, state, t_next, atol, rtol, dt_max, dt_floor, tiny_scale):
        (t, mean, chol, bwdG, bwd_m, bwd_L, scale, t_prev, mean_prev, chol_prev,
         bwdG_prev, bwd_m_prev, bwd_L_prev, dt_st, errn_prev, nsteps, mle) = state
        nu, d = self.nu, self.d
        n = nu + 1

        dt = torch.minimum(torch.maximum(dt_st, dt_floor), dt_max)
        p = self._precond(dt)
        p_arr = torch.cat(p, dim=0)  # (n, B)
        p_m, p_c = p_arr[:, None, :], p_arr[:, None, None, :]
        t_new = t + dt

        # -- extrapolate the mean (as on the isotropic engine)
        m_bar = mean / p_m
        m_pred = p_m * _const_matmul(self.a_rows, m_bar)

        # -- TS0 residual, per-dimension sigma, one error norm per lane
        u_pred = m_pred[0]
        z = m_pred[1] - self.vf(m_pred[0], t=t_new[0], p=self.params)
        s_unit = p[1] * self.lq_norms[1]
        sigma = torch.abs(z) / s_unit  # (d, B)
        err_u = sigma * (p[0] * self.lq_norms[0])
        tol_w = atol + rtol * torch.abs(u_pred)
        q = err_u[0:1] / tol_w[0:1]
        e2 = q * q
        for r in range(1, d):
            q = err_u[r : r + 1] / tol_w[r : r + 1]
            e2 = e2 + q * q
        # divide by a tensor: torch turns division by a Python scalar into a
        # multiplication by its reciprocal, which rounds differently
        errn = self.kappa * rounded.sqrt(e2 / torch.full_like(e2, d))

        sigma_safe = torch.where(torch.isfinite(sigma), sigma, torch.full_like(sigma, self.big))
        new_scale = torch.clamp(torch.maximum(sigma_safe, tiny_scale), max=self.big)  # (d, B)

        # -- extrapolate the covariance with reversal, per channel
        l_bar = torch.clamp(chol / p_c, -self.clip, self.clip)
        mag = new_scale * self.max_lq
        for c in range(n):
            mag = torch.maximum(mag, _rowmax(l_bar[c]))
        mag = torch.maximum(mag * self.a_inf_norm, tiny_scale)
        inv_mag = torch.reciprocal(mag)
        l_bar_n = l_bar * inv_mag[None, None]
        a_l = _const_matmul(self.a_rows, l_bar_n)
        lq_scaled = (new_scale * inv_mag)[None, None] * self._lq_const(dt)[..., None]
        magb = mag[None, None]

        zero = torch.zeros_like(a_l[0])
        cols = torch.stack(
            [torch.cat([a_l[c], lq_scaled[c]], dim=0) for c in range(n)]
            + [torch.cat([l_bar_n[c], zero], dim=0) for c in range(n)]
        )
        cols = _qr_r_cols(cols, 2 * n, 2 * n, self.tiny)  # cols[c][r] = R[r][c]
        r_yy = cols[:n, :n].transpose(0, 1)
        r_yx = cols[n:, :n].transpose(0, 1)
        g_bar = _tri_solve_upper_ll(r_yy, r_yx, n).transpose(0, 1)
        l_pred = p_c * (cols[:n, :n] * magb)
        gain = p_c * g_bar / p_arr[None, :, None, :]
        bwd_L_step = p_c * (cols[n:, n:] * magb)
        bwd_m_step = mean - _mv(gain, m_pred, n)

        # -- TS0 correction: rank-1 update per channel
        l_obs = l_pred[1]  # (n, d, B): row 1 of each factor
        m2 = torch.maximum(_rowmax(l_obs), tiny_scale)  # (d, B)
        l_obs_n = l_obs / m2[None]
        s2 = l_obs_n[0] * l_obs_n[0]
        for i in range(1, n):
            s2 = s2 + l_obs_n[i] * l_obs_n[i]
        s2 = s2 + self.tiny
        crosscov = _mv(l_pred, l_obs_n, n)
        gc = crosscov / s2[None]
        g_corr = gc / m2[None]
        mean_cor = m_pred - g_corr * z[None]
        chol_cor = l_pred - gc[:, None] * l_obs_n[None, :]

        # -- fixedpoint accumulation per channel
        bwdG_new = _matmul_ll(bwdG, gain, n)
        bwd_m_new = _mv(bwdG, bwd_m_step, n) + bwd_m
        mag_g = tiny_scale * torch.ones_like(mag)
        for c in range(n):
            mag_g = torch.maximum(mag_g, _rowmax(bwdG[c]))
        inv_g = torch.reciprocal(mag_g)
        m1 = _matmul_ll(bwdG * inv_g[None, None], bwd_L_step, n)
        bl_g = bwd_L * inv_g[None, None]
        t3 = tiny_scale * torch.ones_like(mag)
        for c in range(n):
            t3 = torch.maximum(t3, _rowmax(m1[c]))
            t3 = torch.maximum(t3, _rowmax(bl_g[c]))
        inv3 = torch.reciprocal(t3)[None]
        cols2 = torch.stack(
            [torch.cat([m1[c] * inv3, bl_g[c] * inv3], dim=0) for c in range(n)]
        )
        cols2 = _qr_r_cols(cols2, 2 * n, n, self.tiny)
        bwd_L_new = (cols2[:, :n] * t3[None, None]) * mag_g[None, None]

        # -- PI control and accept (as on the isotropic engine)
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


def _check_config(*, strategy, calibration, ode_order, error_unit, num_derivatives):
    try:
        batched._check_config(
            strategy=strategy, calibration=calibration, ode_order=ode_order,
            correction="ts0", error_unit=error_unit, implementation="blockdiag",
            num_derivatives=num_derivatives, supported_nu=SUPPORTED_NU,
            implementations=("blockdiag",),
        )
    except NotImplementedError as e:
        raise NotImplementedError(f"{e} (on the blockdiag engine, item 5)") from None


def make_step_bd(vf, params, *, nu, d, strategy="fixedpoint", calibration="dynamic",
                 ode_order=1, error_unit="qoi", error_calibration=None, control=None,
                 dtype=torch.float32):
    """The twin of K6 for ``vf`` (row-wise, see ``problems``); the
    counterpart of ``make_step_bd_ll``."""
    _check_config(strategy=strategy, calibration=calibration, ode_order=ode_order,
                  error_unit=error_unit, num_derivatives=nu)
    if error_calibration is None:
        error_calibration = ivpsolvers.default_error_calibration("ts0", error_unit)
    return StepBD(vf, params, nu=nu, d=d, error_calibration=error_calibration,
                  control=control, dtype=dtype)


def _generic_to_state_bd(s: _State, dtype):
    """Batch-leading blockdiag ``_State`` (mean (B, d, n), factors
    (B, d, n, n), scale (B, d)) -> lanes-last tuple."""

    def tm(x):  # (B, d, n) -> (n, d, B)
        return x.permute(2, 1, 0).contiguous()

    def tc(x):  # (B, d, n, n) -> (n, n, d, B)
        return x.permute(2, 3, 1, 0).contiguous()

    def ts(x):  # (B, d) -> (d, B)
        return x.transpose(0, 1).to(dtype).contiguous()

    def t1(x):  # (B,) -> (1, B)
        return x[None].to(dtype).contiguous()

    return (
        t1(s.t),
        tm(s.rv.mean),
        tc(s.rv.cholesky),
        tc(s.bwd.matrix), tm(s.bwd.noise.mean), tc(s.bwd.noise.cholesky),
        ts(s.scale_step),
        t1(s.t_prev),
        tm(s.rv_prev.mean),
        tc(s.rv_prev.cholesky),
        tc(s.bwd_prev.matrix), tm(s.bwd_prev.noise.mean), tc(s.bwd_prev.noise.cholesky),
        t1(s.dt),
        t1(s.errn_prev),
        t1(s.num_steps),
        ts(s.mle_ssq),
    )


def _state_to_generic_bd(state):
    """Lanes-last blockdiag tuple -> batch-leading ``_State`` (views)."""

    def tm(x):  # (n, d, B) -> (B, d, n)
        return x.permute(2, 1, 0)

    def tc(x):  # (n, n, d, B) -> (B, d, n, n)
        return x.permute(3, 2, 0, 1)

    def ts(x):  # (d, B) -> (B, d)
        return x.transpose(0, 1)

    def t1(x):
        return x[0]

    return _State(
        t=t1(state[0]),
        rv=Normal(tm(state[1]), tc(state[2])),
        bwd=Conditional(tc(state[3]), Normal(tm(state[4]), tc(state[5]))),
        scale_step=ts(state[6]),
        t_prev=t1(state[7]),
        rv_prev=Normal(tm(state[8]), tc(state[9])),
        bwd_prev=Conditional(tc(state[10]), Normal(tm(state[11]), tc(state[12]))),
        dt=t1(state[13]),
        errn_prev=t1(state[14]),
        num_steps=t1(state[15]).to(torch.int32),
        mle_ssq=ts(state[16]),
    )


CONVERT = (_state_to_generic_bd, _generic_to_state_bd)


def initial_state(vf, u0s, params, *, save_at, dt0, tols, num_derivatives=4,
                  atol_factor=1e-3):
    """Taylor-initialized lanes-last blockdiag state, ``rv0`` and the kernel
    inputs (``batched.initial_state`` on this layout)."""
    s0, rv0, inputs = batched.initial_generic(
        vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols,
        num_derivatives=num_derivatives, atol_factor=atol_factor,
        implementation="blockdiag")
    return _generic_to_state_bd(s0, u0s.dtype), rv0, inputs


def solve_save_at_batched_blockdiag(
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
    error_unit="qoi",
    error_calibration=None,
    max_attempts=100_000,
):
    """Batched fixed-memory adaptive solve on the blockdiag backend
    (``odecheckpts_tpu/batched_blockdiag.py:346-564``).

    Same contract as ``batched.solve_save_at_batched``: ``u0s`` (B, d),
    ``tols`` (B,), returns ``(u_smooth (B, T, d), u_filt (B, T, d),
    num_steps (B, T))``; per-dimension output scales and covariance factors,
    TS0 only.  ``engine="cuda-loop"`` launches K6's interval form once per
    checkpoint interval, ``engine="cuda"`` K6's attempt form once per attempt
    under the host loop, ``engine="torch"`` runs the twin; the kernel engines
    run the twin on CPU tensors.  The vector field needs a device functor for
    the kernel engines (``problems.rigid_body``,
    ``problems.rigid_body_anisotropic``).
    """
    setup = setup_blockdiag(
        vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols,
        num_derivatives=num_derivatives, strategy=strategy, calibration=calibration,
        atol_factor=atol_factor, engine=engine, hbm_budget=hbm_budget, ode_order=ode_order,
        error_unit=error_unit, error_calibration=error_calibration,
    )
    return batched.solve_intervals(
        setup["interval"], setup["step"], setup["state"], setup["rv0"], setup["inputs"],
        strat=setup["strat"], save_at=setup["save_at"], max_attempts=max_attempts,
        convert=CONVERT)


def setup_blockdiag(vf, u0s, params, *, save_at, dt0, tols, num_derivatives=4,
                    strategy="fixedpoint", calibration="dynamic", atol_factor=1e-3,
                    engine="cuda-loop", hbm_budget="auto", ode_order=1, error_unit="qoi",
                    error_calibration=None):
    """Everything ``solve_save_at_batched_blockdiag`` builds before its
    checkpoint loop, as a dict: ``interval`` (the engine's interval
    function), ``step``, ``state`` and ``rv0`` (the Taylor init), ``inputs``,
    ``strat`` and ``save_at``.  ``batched.advance_checkpoint`` with
    ``convert=CONVERT`` runs one checkpoint of it."""
    _check_config(strategy=strategy, calibration=calibration, ode_order=ode_order,
                  error_unit=error_unit, num_derivatives=num_derivatives)
    batched._check_engine(engine)
    if isinstance(u0s, tuple):
        (u0s,) = u0s
    b, d = u0s.shape
    dtype, device = u0s.dtype, u0s.device
    nu = num_derivatives
    save_at = torch.as_tensor(save_at, dtype=dtype, device=device)
    # the reference's admission check, called as it calls it (n*d in place of d)
    batched.check_hbm_budget(
        b, (nu + 1) * d, num_derivatives=nu, num_save_at=len(save_at), dtype=dtype,
        budget=hbm_budget, device=device,
    )
    ssm = ivpsolvers.prior_ibm(num_derivatives=nu, ode_shape=(d,), implementation="blockdiag")
    strat = ivpsolvers.strategy_fixedpoint(
        ssm, ivpsolvers.correction_ts0(error_calibration=error_calibration))
    step = make_step_bd(vf, params, nu=nu, d=d,
                        error_calibration=strat.correction.calibration_factor, dtype=dtype)
    state, rv0, inputs = initial_state(
        vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols, num_derivatives=nu,
        atol_factor=atol_factor)
    interval = batched.interval_fn(engine, kernels.step_bd_interval,
                                   kernels.step_bd_attempt, kernels.active_ll)
    return {"interval": interval, "step": step, "state": state, "rv0": rv0,
            "inputs": inputs, "strat": strat, "save_at": save_at}
